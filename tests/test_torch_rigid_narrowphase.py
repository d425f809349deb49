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
    the hit, as lpe_tpu's XLA pair gives them."""
    from lpe_tpu_torch.systems.rigid import geometry as geo
    from lpe_tpu_torch.systems.rigid.pipeline import _pair_contacts
    for spread in (0.3, 1.5):
        sa, sb, xla, _ = jax_rows[spread]
        ta, tb = ({k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
                  for s in (sa, sb))
        hit, nrm, pen = geo.sat_contact(ta, tb, any_circle=False)
        pts, pens, cval = _pair_contacts(ta, tb, nrm, pen, 2)
        got = tuple(x.numpy() for x in (hit, nrm, pen, pts, pens, cval))
        _assert_like_pallas_test(got, xla)
        np.testing.assert_array_equal(got[5], xla[5])
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            geo.sat_contact(ta, tb, any_circle=True)
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            _pair_contacts(ta, tb, nrm, pen, 3)


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


@pytest.mark.cuda
def test_cuda_narrowphase_matches_plain():
    """The CUDA kernel against its plain version on the same rows, on the
    card: hit and contact masks equal, the rest within the tolerances of
    test_pallas_rigid.py (both round alike, so the error is ~0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
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
