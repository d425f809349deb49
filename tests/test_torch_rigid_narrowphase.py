"""The port's grid-rigid narrowphase and warm-start lookup against lpe_tpu.

- ``ops/rigid_kernels.narrowphase_plain`` (the plain version of the CUDA
  kernel) against lpe_tpu's Pallas kernel in interpret mode and against its
  vmapped XLA pair (``sat_contact`` + ``_pair_contacts``), on random
  convex-polygon rows, at the tolerances of tests/test_pallas_rigid.py;
- ``systems/rigid/solver.match_warm_impulses`` against lpe_tpu's, bitwise;
- on a card, the CUDA kernel against the plain version on the same rows.

The module imports no jax at the top, so the CUDA case runs where the
kernels run (jax is not needed there):

    python -m pytest --noconftest tests/test_torch_rigid_narrowphase.py -m cuda
"""
import numpy as np
import pytest
import torch

from lpe_tpu_torch.ops import rigid_kernels as RK
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

V, N = 8, 257                   # odd N: not a multiple of any block


def _random_polys(n, V, seed, spread=1.0):
    """tests/test_pallas_rigid.py's generator, in numpy: convex CCW rings
    of 3..V vertices at random positions and angles."""
    rng = np.random.default_rng(seed)
    nv = rng.integers(3, V + 1, n)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, V)), axis=1)
    rad = rng.uniform(0.2, 0.6, (n, V))
    verts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    vm = np.arange(V)[None, :] < nv[:, None]
    verts = np.where(vm[..., None], verts, 0.0)
    return dict(pos=rng.uniform(-spread, spread, (n, 2)).astype(np.float32),
                angle=rng.uniform(0, 2 * np.pi, n).astype(np.float32),
                verts=verts.astype(np.float32), nverts=nv.astype(np.int32),
                vmask=vm)


def _torch_args(sa, sb, device):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return [t(s[k]) for s in (sa, sb)
            for k in ("pos", "angle", "verts", "nverts")]


def _assert_like_pallas_test(got, ref):
    """The checks and tolerances of test_pallas_rigid.py:52-65: hit equal;
    on hit rows normal and depth within 1e-5 and the contact mask equal;
    on valid contacts points and depths within 1e-4."""
    hit_k, nrm_k, pen_k, pts_k, pens_k, cval_k = got
    hit_x, nrm_x, pen_x, pts_x, pens_x, cval_x = ref
    np.testing.assert_array_equal(hit_k, hit_x)
    h = np.asarray(hit_x)
    assert h.any() and (~h).any()                   # both regimes exercised
    np.testing.assert_allclose(nrm_k[h], nrm_x[h], atol=1e-5)
    np.testing.assert_allclose(pen_k[h], pen_x[h], atol=1e-5)
    np.testing.assert_array_equal(cval_k[h], cval_x[h])
    cv = np.asarray(cval_x) & h[:, None]
    assert cv.any()
    np.testing.assert_allclose(pts_k[cv], pts_x[cv], atol=1e-4)
    np.testing.assert_allclose(pens_k[cv], pens_x[cv], atol=1e-4)


@pytest.fixture(scope="module")
def jax_rows():
    """lpe_tpu's two narrowphases on the rows of both spreads."""
    import jax
    import jax.numpy as jnp
    from lpe_tpu.ops.pallas_rigid import make_narrowphase
    from lpe_tpu.systems.rigid import geometry as geo
    from lpe_tpu.systems.rigid.pipeline import _pair_contacts

    narrow = make_narrowphase(V, interpret=True)
    out = {}
    for spread in (0.3, 1.5):
        sa = _random_polys(N, V, seed=1, spread=spread)
        sb = _random_polys(N, V, seed=2, spread=spread)

        def j(s):
            return dict(pos=jnp.asarray(s["pos"]),
                        angle=jnp.asarray(s["angle"]),
                        verts=jnp.asarray(s["verts"]),
                        nverts=jnp.asarray(s["nverts"]),
                        vmask=jnp.asarray(s["vmask"]),
                        is_circle=jnp.zeros(N, bool),
                        radius=jnp.zeros(N, jnp.float32))

        ja, jb = j(sa), j(sb)
        hit, nrm, pen = jax.vmap(
            lambda a, b: geo.sat_contact(a, b, any_circle=False))(ja, jb)
        pts, pens, cval = jax.vmap(
            lambda a, b, n_, p_: _pair_contacts(a, b, n_, p_, 2))(
                ja, jb, nrm, pen)
        xla = tuple(np.asarray(x) for x in (hit, nrm, pen, pts, pens, cval))
        pallas = tuple(np.asarray(x) for x in narrow(ja, jb))
        out[spread] = (sa, sb, xla, pallas)
    return out


@pytest.mark.parametrize("spread", [0.3, 1.5])
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_pair"])
def test_plain_narrowphase_matches_lpe_tpu(jax_rows, spread, reference):
    sa, sb, xla, pallas = jax_rows[spread]
    RK.reset_counters()
    got = RK.narrowphase(*_torch_args(sa, sb, "cpu"))
    assert RK.narrowphase.plain_calls == 1 and RK.narrowphase.launches == 0
    got = tuple(x.numpy() for x in got)
    _assert_like_pallas_test(got, pallas if reference == "pallas_interpret"
                             else xla)
    if reference == "pallas_interpret":
        # the kernel contract: contact masks carry the hit (oka / okb)
        np.testing.assert_array_equal(got[5], pallas[5])


def test_xla_geometry_path_matches_lpe_tpu(jax_rows):
    """The plain geometry path the ``narrowphase_backend="xla"`` grid
    pipeline calls: sat_contact then _pair_contacts, contact masks without
    the hit, as lpe_tpu's XLA pair gives them. The same rows with every
    third one a circle through ``sat_contact(any_circle=True)``, and the
    polygon rows' manifolds at C = 3, against lpe_tpu's (hits and masks
    equal; depths and points 1e-5, normals 1e-4 where a circle takes part,
    as in tests/test_torch_list_rigid.py)."""
    import jax
    import jax.numpy as jnp
    from lpe_tpu.systems.rigid import geometry as jgeo
    from lpe_tpu.systems.rigid.pipeline import _pair_contacts as jpc
    from lpe_tpu_torch.systems.rigid import geometry as geo
    from lpe_tpu_torch.systems.rigid.pipeline import _pair_contacts
    jsat = jax.jit(jax.vmap(lambda a, b: jgeo.sat_contact(a, b, True)))
    jpc3 = jax.jit(jax.vmap(lambda a, b, n_, p_: jpc(a, b, n_, p_, 3)))
    for spread in (0.3, 1.5):
        sa, sb, xla, _ = jax_rows[spread]
        ta, tb = ({k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
                  for s in (sa, sb))
        hit, nrm, pen = geo.sat_contact(ta, tb, any_circle=False)
        pts, pens, cval = _pair_contacts(ta, tb, nrm, pen, 2)
        got = tuple(x.numpy() for x in (hit, nrm, pen, pts, pens, cval))
        _assert_like_pallas_test(got, xla)
        np.testing.assert_array_equal(got[5], xla[5])
        # C = 3 on the polygon rows: lpe_tpu's manifold, third row empty
        pts3, pens3, cval3 = _pair_contacts(ta, tb, nrm, pen, 3)
        polys = dict(is_circle=np.zeros(N, bool),
                     radius=np.zeros(N, np.float32))
        j3 = [np.asarray(x) for x in jpc3(
            *({k: jnp.asarray(v) for k, v in dict(t, **polys).items()}
              for t in (sa, sb)),
            jnp.asarray(xla[1]), jnp.asarray(xla[2]))]
        v = j3[2] & xla[0][:, None]
        np.testing.assert_array_equal(cval3.numpy(), j3[2])
        assert not j3[2][:, 2].any() and v[:, 0].any()
        np.testing.assert_allclose(pts3.numpy()[v], j3[0][v], atol=1e-5)
        np.testing.assert_allclose(pens3.numpy()[v], j3[1][v], atol=1e-5)
        # circles: every third row of A and every fifth of B
        cir = {}
        for name, s_, step in (("a", sa, 3), ("b", sb, 5)):
            c = dict(s_, is_circle=np.arange(N) % step == 0,
                     radius=np.full(N, 0.3, np.float32))
            c["nverts"] = np.where(c["is_circle"], 0, c["nverts"]) \
                .astype(np.int32)
            c["vmask"] = np.arange(V)[None, :] < c["nverts"][:, None]
            cir[name] = c
        ca, cb = ({k: torch.from_numpy(np.asarray(v)) for k, v in c.items()}
                  for c in (cir["a"], cir["b"]))
        hit, nrm, pen = geo.sat_contact(ca, cb, any_circle=True)
        jhit, jnrm, jpen = (np.asarray(x) for x in jsat(
            *({k: jnp.asarray(v) for k, v in c.items()}
              for c in (cir["a"], cir["b"]))))
        np.testing.assert_array_equal(hit.numpy(), jhit)
        anyc = cir["a"]["is_circle"] | cir["b"]["is_circle"]
        assert (jhit & anyc).any()
        np.testing.assert_allclose(pen.numpy(), jpen, atol=1e-5)
        for rows, atol in ((jhit & ~anyc, 1e-5), (jhit & anyc, 1e-4)):
            np.testing.assert_allclose(nrm.numpy()[rows], jnrm[rows],
                                       atol=atol)


def _warm_inputs(seed, P=300, C=2):
    """Cached manifolds near the new ones: some points within the 1e-3
    tolerance, some out of it, some slots swapped, some normals turned past
    the 0.95 cosine."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (P, C, 2)).astype(np.float32)
    jitter = rng.choice([2e-4, 5e-4, 3e-3], (P, C, 1)) \
        * rng.normal(size=(P, C, 2))
    cpt = (pts + jitter).astype(np.float32)
    swap = rng.uniform(size=P) < 0.3
    cpt[swap] = cpt[swap][:, ::-1]
    a = rng.uniform(0, 2 * np.pi, P)
    da = rng.choice([0.0, 0.1, 0.5], P)
    nrm = np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)
    cn = np.stack([np.cos(a + da), np.sin(a + da)], -1).astype(np.float32)
    cln = rng.uniform(0, 2, (P, C)).astype(np.float32)
    clt = rng.uniform(-1, 1, (P, C)).astype(np.float32)
    ok = rng.uniform(size=P) < 0.9
    return pts, nrm, cpt, cn, cln, clt, ok


@pytest.mark.parametrize("slot_fallback", [True, False])
def test_match_warm_impulses_bitwise(slot_fallback):
    import jax.numpy as jnp
    from lpe_tpu.systems.rigid.solver import match_warm_impulses as jmatch
    from lpe_tpu_torch.systems.rigid.solver import match_warm_impulses
    args = _warm_inputs(seed=3)
    ref = jmatch(*(jnp.asarray(a) for a in args), tol=1e-3,
                 slot_fallback=slot_fallback)
    got = match_warm_impulses(*(torch.from_numpy(a) for a in args),
                              tol=1e-3, slot_fallback=slot_fallback)
    n_zero = 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        n_zero += int((np.asarray(r) == 0).sum())
    assert 0 < n_zero < 2 * args[4].size          # both outcomes present


# a grid of 3 x 3 cells of KB slots with the rigid tick's six row classes
# (same cell, E, SW, S, SE, big), their row counts, and NBIG big bodies
KB, NBIG = 6, 3
LAYOUT = ((6, 0, 0, False), (3, 1, 0, False), (2, -1, 1, False),
          (3, 0, 1, False), (2, 1, 1, False), (3, 0, 0, True))


def _random_grid(device, nbx=3, seed=4):
    """narrowphase_grid's arguments: random polygons in the slots of nbx x
    nbx cells and NBIG big ones, random slots for every row."""
    NC, R = nbx * nbx, sum(c[0] for c in LAYOUT)
    body = _random_polys(NC * KB + NBIG, V, seed, spread=0.3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    g = [t(body[k][:NC * KB].reshape((NC, KB) + body[k].shape[1:]))
         for k in ("pos", "angle", "verts", "nverts")]
    b = [t(body[k][NC * KB:]) for k in ("pos", "angle", "verts", "nverts")]
    rng = np.random.default_rng(seed)
    ka = rng.integers(0, KB, (NC, R)).astype(np.int32)
    kb = np.concatenate([rng.integers(0, NBIG if big else KB, (NC, rows))
                         for rows, _, _, big in LAYOUT], 1).astype(np.int32)
    return (*g, *b, t(ka), t(kb)), dict(nbx=nbx, layout=LAYOUT)


def test_grid_passes_fit_shared_memory():
    """The staging passes of csrc/narrowphase_grid.cu: RIGID_STACKS 10k
    (KB = 48, V = 7, four big walls) stages all five regions at once; cells
    too large for that take several passes, each within a block's shared
    memory; a cell that cannot fit with one partner is refused."""
    stacks = ((48, 0, 0, False), (24, 1, 0, False), (16, -1, 1, False),
              (24, 0, 1, False), (16, 1, 1, False), (16, 0, 0, True))
    assert RK.grid_passes(48, 4, 7, stacks) == ([6], 5 * 48 + 4)
    ends, nsb = RK.grid_passes(256, 64, 16, stacks)
    assert ends[-1] == 6 and len(ends) > 1
    assert nsb * (16 * 16 + 24) <= RK.SMEM_MAX
    assert ends == sorted(set(ends))
    with pytest.raises(ValueError, match="shared memory"):
        RK.grid_passes(500, 4, 16, stacks)


def test_cpu_grid_narrowphase_takes_its_plain_version():
    """On CPU tensors narrowphase_grid runs its plain version: the rows of
    grid_rows through narrowphase_plain, and their side positions."""
    args, kw = _random_grid("cpu")
    RK.reset_counters()
    got = RK.narrowphase_grid(*args, **kw)
    assert RK.narrowphase_grid.plain_calls == 1
    assert RK.narrowphase_grid.launches == 0
    a, b = RK.grid_rows(*args, **kw)
    want = (*RK.narrowphase_plain(*a, *b), a[0], b[0])
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    assert got[0].any() and (~got[0]).any()


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.is_floating_point() else t


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rows", "grid", "grid_in_passes",
                                  "grid_bands"])
def test_cuda_narrowphase_matches_plain(form, monkeypatch):
    """The CUDA kernels against their plain versions on the same rows, on
    the card: hit and contact masks equal, the rest within the tolerances
    of test_pallas_rigid.py (both round alike, so the error is ~0). The
    row form on random rows; the grid form on a random grid, staging
    every class at once and, with the shared memory a block may have cut
    down, in several passes; its side positions equal the plain
    version's. The grid form on y-row bands of a 4 x 4 grid (2 and 4
    bands, ``grid_band``: a band's rows and the row below them): each
    band's outputs equal its plain version's and the whole grid's kernel
    outputs for those rows, to the bit, every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    if form == "grid_bands":
        args, kw = _random_grid("cuda", nbx=4)
        nbx, R = kw["nbx"], args[8].shape[1]
        whole = RK.narrowphase_grid(*args, **kw)
        for D in (2, 4):
            rows = nbx // D
            for i in range(D):
                band = RK.grid_band(args, nbx=nbx, r0=i * rows, rows=rows)
                RK.reset_counters()
                got = RK.narrowphase_grid(*band, **kw)
                torch.cuda.synchronize()
                assert RK.narrowphase_grid.launches == 1
                ref = RK.narrowphase_grid_plain(*band, **kw)
                cut = slice(i * rows * nbx * R, (i + 1) * rows * nbx * R)
                for g, r, w in zip(got, ref, whole):
                    assert g.shape[0] == rows * nbx * R
                    assert torch.equal(_bits(g), _bits(r))
                    assert torch.equal(_bits(g), _bits(w[cut]))
        return
    if form != "rows":
        if form == "grid_in_passes":    # own cell + one partner a pass
            monkeypatch.setattr(RK, "SMEM_MAX", 2 * KB * (16 * V + 24))
            assert len(RK.grid_passes(KB, NBIG, V, LAYOUT)[0]) > 2
        args, kw = _random_grid("cuda")
        RK.reset_counters()
        got = RK.narrowphase_grid(*args, **kw)
        torch.cuda.synchronize()
        assert RK.narrowphase_grid.launches == 1
        ref = RK.narrowphase_grid_plain(*args, **kw)
        got = tuple(x.cpu().numpy() for x in got)
        ref = tuple(x.cpu().numpy() for x in ref)
        _assert_like_pallas_test(got[:6], ref[:6])
        np.testing.assert_array_equal(got[5], ref[5])
        np.testing.assert_array_equal(got[6:], ref[6:])
        return
    for spread in (0.3, 1.5):
        sa = _random_polys(N, V, seed=1, spread=spread)
        sb = _random_polys(N, V, seed=2, spread=spread)
        RK.reset_counters()
        got = RK.narrowphase(*_torch_args(sa, sb, "cuda"))
        torch.cuda.synchronize()
        assert RK.narrowphase.launches == 1
        ref = RK.narrowphase_plain(*_torch_args(sa, sb, "cuda"))
        got = tuple(x.cpu().numpy() for x in got)
        ref = tuple(x.cpu().numpy() for x in ref)
        _assert_like_pallas_test(got, ref)
        np.testing.assert_array_equal(got[5], ref[5])
    with pytest.raises(ValueError, match="V=17"):
        RK.narrowphase(*_torch_args(_random_polys(4, 17, 1),
                                    _random_polys(4, 17, 2), "cuda"))
