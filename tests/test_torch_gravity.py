"""The port's N-body gravity against lpe_tpu's (``lpe_tpu/systems/
barnes_hut.py``, ``lpe_tpu/ops/pm_gravity.py``) on seeded inputs, on the
CPU, and the port's own P3M accuracy gates against an exact float64 sum.

Tolerances (float32 sums in another order):
- direct sum: per body |da| <= 1e-5 |a_jax| (observed <= 1.2e-6);
- the gravity step, both branches: max |dv| <= 1e-4 of the largest |dv|
  (observed <= 1.1e-6);
- PP correction without overflow: |df| <= 1e-5 of the largest |f| (observed
  <= 8.2e-8).
The port's own gates, against float64: the clustered blob's p95 0.60%
(gate 1%); the uniform blob's median 0.11% and p95 0.88% (gates 0.5% and
1.5%).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lpe_tpu_torch.ops import pm_gravity as TP
from lpe_tpu_torch.systems import barnes_hut as TB
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

UNI = 1e10


def _bodies(n=300, seed=0):
    """Seeded bodies with out-of-bounds sources, boundary bodies and
    sub-threshold masses, and their source and receiver masks."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, UNI, (n, 2)).astype(np.float32)
    pos[:10] = rng.uniform(-5e9, -1e9, (10, 2))         # out of bounds
    mass = rng.uniform(1e18, 1e22, n).astype(np.float32)
    mass[10:20] = 10.0                                   # below 1e3
    bnd = np.zeros(n, bool)
    bnd[20:30] = True
    inb = (pos >= 0).all(1) & (pos < UNI).all(1)
    return pos, mass, inb & ~bnd & (mass >= 1e3), ~bnd


def test_direct_sum_matches_lpe_tpu():
    from lpe_tpu.systems.barnes_hut import _direct_sum_accel
    pos, mass, src, rcv = _bodies()
    soft2 = 1e6 ** 2
    chunk = 128                       # n = 300 > chunk: three row blocks
    want = np.asarray(_direct_sum_accel(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(src),
        jnp.asarray(rcv), soft2, chunk), np.float64)
    got = TB._direct_sum_accel(
        torch.from_numpy(pos), torch.from_numpy(mass),
        torch.from_numpy(src), torch.from_numpy(rcv), soft2,
        chunk).double().numpy()
    d = np.linalg.norm(got - want, axis=1)
    assert (d <= 1e-5 * np.linalg.norm(want, axis=1)).all()
    assert (got[~rcv] == 0).all() and (np.abs(got[rcv]) > 0).all()


def _blob(n=400, seed=0, cluster=False):
    """``tests/test_barnes_hut.py``'s blob: uniform, or half of it in
    tight clumps."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(2e9, 8e9, (n, 2))
    if cluster:
        centers = pts[: n // 8]
        pts[n // 2:] = centers[rng.integers(0, len(centers), n // 2)] \
            + rng.normal(0.0, 2.5e7, (n // 2, 2))
    return [dict(pos=(float(x), float(y)), mass=1e20) for x, y in pts]


def _scenes(ents, soft=1e6, **bh):
    """The same bodies as a scene of each package (bitwise equal)."""
    import lpe_tpu.core.config as JC
    from lpe_tpu.scene import SceneBuilder as JSB
    import lpe_tpu_torch.core.config as TC
    from lpe_tpu_torch.scene import SceneBuilder as TSB
    out = []
    for C, SB, kw in ((JC, JSB, {}), (TC, TSB, dict(device="cpu"))):
        cfg = C.ScenarioSystemConfig(
            shared=C.SharedSystemConfig(universe_size_m=UNI,
                                        gravitational_softener=soft),
            barnes_hut=C.BarnesHutConfig(**bh))
        b = SB("t")
        for e in ents:
            b.add(**e)
        out.append(b.finalize(cfg, **kw))
    return out


def _dv_both(ents, **bh):
    from lpe_tpu.systems.barnes_hut import make_barnes_hut
    js, ts = _scenes(ents, **bh)
    vj = np.asarray(jax.jit(make_barnes_hut(js.spec, js.cfg))(
        js.state).bodies.vel, np.float64) - np.asarray(js.state.bodies.vel)
    step = TB.make_barnes_hut(ts.spec, ts.cfg, device="cpu")
    vt = (step(ts.state).bodies.vel.double() -
          ts.state.bodies.vel.double()).numpy()
    return vj, vt, step


@pytest.mark.parametrize("case", [
    ("direct", False, {}),
    ("direct", True, {}),
    ("p3m", False, dict(pm_grid=256)),
    ("p3m", True, dict(pm_grid=256)),
    ("p3m", False, dict(p3m_max_per_cell=16)),     # pm_grid 1024
], ids=["direct", "direct_clustered", "p3m256", "p3m256_clustered",
        "p3m1024"])
def test_barnes_hut_step_matches_lpe_tpu(case):
    branch, cluster, bh = case
    if branch == "p3m":
        bh = dict(bh, direct_sum_max_bodies=1)
    vj, vt, step = _dv_both(_blob(cluster=cluster, seed=int(cluster)), **bh)
    assert step.use_pm == (branch == "p3m")
    assert (step.pp is None) == (branch == "direct")
    assert np.abs(vt - vj).max() <= 1e-4 * np.abs(vj).max()


def _pp_pair(n_bodies, max_per_cell, grid=64):
    from lpe_tpu.ops.pm_gravity import make_pp_correction as jpp
    args = (UNI, grid, 1e6, 8.0, max_per_cell)
    return jpp(*args, n_bodies=n_bodies), \
        TP.make_pp_correction(*args, n_bodies=n_bodies)


@pytest.mark.parametrize("m,n_bodies", [(1, None), (2, 2000)])
def test_pp_correction_matches_lpe_tpu(m, n_bodies):
    """At m = 1 (K = 16) and m = 2 (n_bodies = 2000 sizes 16x16 cells of
    K = 24), 300 uniform bodies, no cell overflowing."""
    jpp, tpp = _pp_pair(n_bodies, 16)
    assert (tpp.K, tpp.subdivision, tpp.ncells) == \
        (jpp.K, jpp.subdivision, jpp.ncells)
    assert tpp.subdivision == m
    rng = np.random.default_rng(m)
    pos = rng.uniform(0, UNI, (300, 2)).astype(np.float32)
    mass = rng.uniform(1e18, 1e20, 300).astype(np.float32)
    assert jpp.overflow_fraction(pos) == 0.0
    assert tpp.overflow_fraction(torch.from_numpy(pos)) == 0.0
    want = np.asarray(jpp(jnp.asarray(pos), jnp.asarray(mass)), np.float64)
    got = tpp(torch.from_numpy(pos), torch.from_numpy(mass)).double().numpy()
    assert (np.abs(want) > 0).mean() > 0.9
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pp_overflowing_clump_keeps_first_k_by_index():
    """``tests/test_barnes_hut.py``'s clump of 500 bodies around one
    point: K, subdivision, ncells and overflow_fraction equal lpe_tpu's;
    the port corrects exactly the first K bodies by index of each cell
    (lpe_tpu's unstable sort may keep others)."""
    rc = 8.0 * UNI / 1024
    rng = np.random.default_rng(3)
    pos = (np.full((500, 2), 0.5 * UNI) +
           rng.normal(0, 0.05 * rc, (500, 2))).astype(np.float32)
    mass = np.ones((500,), np.float32)
    for n_bodies, mpc in ((None, 8), (10 * 128 * 128, 8),
                          (30 * 128 * 128, 64)):
        jpp, tpp = _pp_pair(n_bodies, mpc, grid=1024)
        assert (tpp.K, tpp.subdivision, tpp.ncells) == \
            (jpp.K, jpp.subdivision, jpp.ncells)
        assert tpp.overflow_fraction(torch.from_numpy(pos)) == \
            jpp.overflow_fraction(pos)
    jpp, tpp = _pp_pair(None, 8, grid=1024)
    assert jpp.overflow_fraction(pos) > 0.5
    cid = tpp.cells_of(torch.from_numpy(pos)).numpy()
    kept = np.zeros(500, bool)
    for c in np.unique(cid):
        kept[np.flatnonzero(cid == c)[:tpp.K]] = True
    f = tpp(torch.from_numpy(pos), torch.from_numpy(mass)).numpy()
    assert np.array_equal(np.abs(f).sum(1) > 0, kept)
    # the subdivided grid gives two bodies rc/4 apart the m = 1 force
    p2 = np.array([[0.5 * UNI, 0.5 * UNI], [0.5 * UNI + rc / 4, 0.5 * UNI]],
                  np.float32)
    m2 = torch.ones(2)
    sub = _pp_pair(30 * 128 * 128, 64, grid=1024)[1]
    assert sub.subdivision == 2
    f1 = tpp(torch.from_numpy(p2), m2).numpy()
    f2 = sub(torch.from_numpy(p2), m2).numpy()
    assert np.allclose(f1, f2, rtol=1e-5) and np.abs(f1).max() > 0


@pytest.mark.parametrize("n,cap,heavy", [(50, 4, [3, 7, 8, 20, 21, 40]),
                                         (50, 16, [0, 49]),
                                         (10, 16, [2, 5, 9])])
def test_heavy_selection_matches_nonzero(n, cap, heavy):
    mask = np.zeros(n, bool)
    mask[heavy] = True
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=cap,
                                  fill_value=n)[0])
    got = TP.heavy_indices(torch.from_numpy(mask), cap).numpy()
    assert np.array_equal(got, want)


def _exact_dv(sc):
    """Velocity change of one gravity tick by a float64 direct sum over
    the same sources (the reference's rules)."""
    from lpe_tpu_torch.core.constants import REAL_G
    b = sc.state.bodies
    pos = b.pos.double().numpy()
    mass = b.mass.double().numpy()
    act, bnd = b.active.numpy(), b.boundary.numpy()
    size = sc.cfg.shared.universe_size_m
    inb = (pos >= 0).all(1) & (pos < size).all(1)
    src = act & ~bnd & inb & (mass >= sc.cfg.barnes_hut.small_mass_threshold)
    soft2 = sc.cfg.shared.gravitational_softener ** 2
    d = pos[None, :, :] - pos[:, None, :]
    d2 = (d ** 2).sum(-1) + soft2
    np.fill_diagonal(d2, np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):  # padding at 0
        w = np.where(src[None, :], mass[None, :], 0.0) / (d2 * np.sqrt(d2))
    acc = REAL_G * (w[..., None] * d).sum(1)
    return acc * sc.cfg.shared.seconds_per_tick * (act & ~bnd)[:, None]


def _p3m_err(ents, soft=1e6, **bh):
    """Per-body relative error of the port's P3M tick against _exact_dv."""
    ts = _scenes(ents, soft=soft, direct_sum_max_bodies=1, **bh)[1]
    step = TB.make_barnes_hut(ts.spec, ts.cfg, device="cpu")
    assert step.use_pm
    dv = (step(ts.state).bodies.vel.double() -
          ts.state.bodies.vel.double()).numpy()
    ex = _exact_dv(ts)
    act = ts.state.bodies.active.numpy()
    return (np.linalg.norm((dv - ex)[act], axis=1) /
            np.maximum(np.linalg.norm(ex[act], axis=1), 1e-30))


def test_pm_far_field_matches_direct_sum():
    """``test_barnes_hut.py``'s gate, against float64: the uniform blob at
    pm_grid 1024, K = 16."""
    err = _p3m_err(_blob(), pm_grid=1024, p3m_max_per_cell=16)
    assert np.median(err) < 0.005
    assert np.percentile(err, 95) < 0.015


def test_p3m_accuracy_gate_clustered():
    """The P3M accuracy gate: p95 relative error under 1% on the clustered
    blob at the default BarnesHutConfig, against float64."""
    err = _p3m_err(_blob(n=600, cluster=True, seed=7))
    assert np.percentile(err, 95) < 0.01


def test_pm_heavy_body_is_exact():
    """A heavy central body bypasses the mesh: its pull under P3M equals
    the exact sum to float precision."""
    ents = [dict(pos=(5e9, 5e9), mass=1e33), dict(pos=(6e9, 5e9), mass=1e3)]
    ts = _scenes(ents, soft=0.0, direct_sum_max_bodies=1,
                 heavy_threshold=1e30)[1]
    step = TB.make_barnes_hut(ts.spec, ts.cfg, device="cpu")
    dv = (step(ts.state).bodies.vel.double() -
          ts.state.bodies.vel.double()).numpy()
    assert np.allclose(dv[1], _exact_dv(ts)[1], rtol=1e-5)


def test_galaxy_takes_p3m_with_lpe_tpus_pp_sizing():
    """The branch the card takes for bench.py's galaxy (1M bodies),
    without building the scene: P3M, and a PP correction of K = 46 on the
    m = 2 grid, equal to the one lpe_tpu's make_barnes_hut builds."""
    from lpe_tpu.ops.pm_gravity import make_pp_correction as jpp
    from lpe_tpu.scenarios import keplerian_disk as jkd
    from lpe_tpu_torch.scenarios import keplerian_disk as tkd
    n = 1_000_000
    cfg = tkd.make_config(tkd.KeplerianDiskConfig(particle_count=n))
    jcfg = jkd.make_config(jkd.KeplerianDiskConfig(particle_count=n))
    assert repr(cfg) == repr(jcfg)
    cap = -(-n // 128) * 128
    spec = types.SimpleNamespace(capacity=cap, max_nonboundary_mass=1e36)
    step = TB.make_barnes_hut(spec, cfg, device="cpu")
    bh, sh = jcfg.barnes_hut, jcfg.shared
    assert step.use_pm and cap > bh.direct_sum_max_bodies
    ref = jpp(sh.universe_size_m, bh.pm_grid, sh.gravitational_softener,
              bh.p3m_cutoff_cells, bh.p3m_max_per_cell, n_bodies=cap)
    assert (step.pp.K, step.pp.subdivision) == (46, 2)
    assert (step.pp.K, step.pp.subdivision, step.pp.ncells) == \
        (ref.K, ref.subdivision, ref.ncells)


def test_system_off_when_all_masses_small():
    ents = [dict(pos=(1e9, 1e9), mass=10.0), dict(pos=(2e9, 1e9), mass=20.0)]
    ts = _scenes(ents)[1]
    assert TB.make_barnes_hut(ts.spec, ts.cfg, device="cpu") is None


def _layout_scene(kind, m):
    """(pp, pos, mass) of one layout case: ``edges`` (bodies in the grid's
    corner and edge cells, a crowded corner past K, bodies outside the
    universe and on its far edge, the rest uniform), ``clump`` (the
    500-body clump of test_pp_overflowing_clump_keeps_first_k_by_index)
    or ``empty`` (every body outside the universe)."""
    rng = np.random.default_rng(11 + m)
    if kind == "clump":
        sizing = (None, 8) if m == 1 else (30 * 128 * 128, 64)
        pp = _pp_pair(*sizing, grid=1024)[1]
        rc = 8.0 * UNI / 1024
        pos = (np.full((500, 2), 0.5 * UNI) +
               rng.normal(0, 0.05 * rc, (500, 2))).astype(np.float32)
    else:
        pp = _pp_pair(None if m == 1 else 2000, 16)[1]
        w = pp.grid.ccell
        pos = rng.uniform(0, UNI, (400, 2))
        corners = np.array([[0.5, 0.5], [pp.grid.nc - 0.5, 0.5],
                            [0.5, pp.grid.nc - 0.5],
                            [pp.grid.nc - 0.5, pp.grid.nc - 0.5]])
        pos[:40] = corners[np.arange(40) % 4] * w + \
            rng.uniform(-0.4, 0.4, (40, 2)) * w
        pos[40:80] = rng.uniform(0, 0.9 * w, (40, 2))      # past K
        pos[80:100, 0] = rng.uniform(0, 0.5 * w, 20)        # left edge
        pos[100:110] = rng.uniform(-0.5 * UNI, -1.0, (10, 2))
        pos[110:115] = UNI                                  # outside
        pos[115:120, 1] = 1.5 * UNI
        if kind == "empty":
            pos = pos - 2.0 * UNI
        pos = pos.astype(np.float32)
    mass = rng.uniform(1e18, 1e20, len(pos)).astype(np.float32)
    return pp, pos, mass


@pytest.mark.parametrize("kind", ["edges", "clump", "empty"])
@pytest.mark.parametrize("m", [1, 2])
def test_pp_layout_rows_are_each_receivers_runs(kind, m):
    """The compact cell-sorted layout the PP kernel reads (``pp_layout``,
    built by the card path's code): cstart is the exclusive scan of
    min(count, K); the rows hold exactly the residents (the first K by
    index of each cell) with their x, y, m and body index; and for each
    receiver's cell, the runs of cells cx-m .. cx+m of rows cy-m .. cy+m
    (the kernel reads each as one contiguous run of rows) hold the
    residents of its (2m+1)^2 neighbour cells in (dy, dx, rank) order,
    at the grid's edges and corners, in an overflowing cell, with bodies
    outside the universe and on an empty grid."""
    pp, pos, mass = _layout_scene(kind, m)
    g = pp.grid
    assert g.m == m
    nc, K = g.nc, g.K
    rows, body, cstart = (t.numpy() for t in pp.layout(
        torch.from_numpy(pos), torch.from_numpy(mass)))
    cid = pp.cells_of(torch.from_numpy(pos)).numpy()
    res = {c: np.flatnonzero(cid == c)[:K] for c in np.unique(cid)
           if c < nc * nc}
    cnt = np.zeros(nc * nc, np.int64)
    for c, b in res.items():
        cnt[c] = len(b)
    assert cstart.dtype == np.int32 and body.dtype == np.int32
    assert np.array_equal(cstart, np.concatenate([[0], np.cumsum(cnt)]))
    R = int(cstart[-1])
    assert rows.shape == (len(pos) + 1, 4) and body.shape == (len(pos) + 1,)
    if kind == "empty":
        assert R == 0 and not res
        return
    if kind != "clump":
        assert cnt.max() == K and (cid == nc * nc).sum() >= 20
        assert all(cnt[c] > 0 for c in (0, nc - 1, nc * (nc - 1),
                                        nc * nc - 1))
    else:
        assert (cid < nc * nc).sum() > R          # the clump overflows
    b = body[:R]
    assert np.array_equal(rows[:R, 0], pos[b, 0])
    assert np.array_equal(rows[:R, 1], pos[b, 1])
    assert np.array_equal(rows[:R, 2], mass[b])
    assert (rows[:R, 3] == 0).all()
    for c, own in res.items():
        assert np.array_equal(b[cstart[c]:cstart[c + 1]], own)
        cy, cx = divmod(c, nc)
        want, got = [], []
        for y in range(max(cy - m, 0), min(cy + m + 1, nc)):
            lo, hi = max(cx - m, 0), min(cx + m + 1, nc)
            got.append(b[cstart[y * nc + lo]:cstart[y * nc + hi]])
            want += [res.get(y * nc + x, np.zeros(0, np.int64))
                     for x in range(lo, hi)]
        assert np.array_equal(np.concatenate(got), np.concatenate(want))
