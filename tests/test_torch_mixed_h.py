"""Mixed per-particle smoothing lengths in the port (reference: fluid.cpp:293
gathers h per particle; fluid_kernels.metal:362-396 takes each pair at
h-bar = (h_i + h_j) / 2): the fluid tick's mixed-h chain (migrate_h ->
density_h -> EOS -> force_h -> second kick -> coupling, resident; density_h
+ force_h, scatter), the kernels' plain versions on the CPU, against
lpe_tpu's XLA pair passes (``pair_backend="xla"``, where lpe_tpu sends
mixed h) and against the float64 oracle.

Tolerances:
- port against lpe_tpu, the blob: tests/test_torch_fluid_split.py's
  (positions atol 1e-5, velocities atol 3e-4, densities rtol 1e-5);
- the mixed-h dam with its tank walls and a dynamic box, 2 ticks: a stiff
  scene (the two h give neighbouring particles different densities, so
  the column bursts: |v| up to 14.0 m/s and moves of 0.195 m after 2
  ticks). Like test_torch_fluid_split.py's mid-row wall it is held to
  that file's STIFF tolerances (positions atol 2e-4, velocities atol
  3e-2, densities rtol 5e-4), the walls to atol 1e-5 and the box's
  velocity and spin changes to rtol 2e-3 + atol 1e-5 (assert_fluid_close's
  rule for a light rigid). lpe_tpu's own response to one float32 ulp on
  every initial liquid position, over seeds 0-2 (``nudged``): positions
  2.15e-5 to 3.48e-5 m, velocities 1.27e-2 to 1.30e-2 m/s, densities
  3.03e-4 to 6.22e-4, rigid velocities 2.12e-5 to 2.87e-5 m/s; the port's
  gaps are 1.56e-5 m, 1.30e-2 m/s, 2.13e-4 and 1.96e-5 m/s (CPU);
- against the float64 oracle: tests/test_sph.py's (density rtol 2e-4,
  positions atol 5e-6);
- the uniform limit (test_sph.py's scene: all h equal but one far
  particle's): the h chain against the uniform path, positions atol 1e-6;
- the plain kernels against a float64 pair sum: density rtol 1e-5,
  forces within 1e-5 of their scale (float32 pair sums of ~20 terms).
"""
import importlib
import math

import numpy as np
import pytest
import torch

from test_torch_fluid_slice import to_port
from test_torch_fluid_split import (STIFF, assert_bodies_close, liquid,
                                    with_fluid)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL_H = 0.04     # test_sph.py _mixed_h_scene's smaller smoothing length


def _pkg(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    return m("core.config"), m("core.constants"), m("scene").SceneBuilder


def _finalize(pkg, b, cfg):
    return b.finalize(cfg) if pkg == "lpe_tpu" else \
        b.finalize(cfg, device="cpu")


def mixed_blob(pkg, n=48, universe=1.5, seed=4):
    """tests/test_sph.py's _mixed_h_scene through ``pkg``'s SceneBuilder."""
    cfgm, C, SceneBuilder = _pkg(pkg)
    cfg = cfgm.ScenarioSystemConfig(
        shared=cfgm.SharedSystemConfig(universe_size_m=universe),
        fluid=cfgm.FluidConfig())
    rng = np.random.default_rng(seed)
    b = SceneBuilder("mixed_h")
    for k in range(n):
        b.add(pos=tuple(rng.uniform(universe * 0.35, universe * 0.65, 2)),
              vel=tuple(rng.uniform(-0.3, 0.3, 2)),
              mass=0.005, phase=int(C.Phase.LIQUID), radius=0.02,
              smoothing_length=SMALL_H if k % 2 else 0.065)
    return _finalize(pkg, b, cfg)


def mixed_dam(pkg, n=1000, seed=0):
    """build_dam_break(n)'s layout and tank walls, odd-indexed liquid
    particles at h = SMALL_H (the rest at the config's 0.05), and one
    dynamic box (0.5 kg) across the column's right edge, through ``pkg``'s
    SceneBuilder."""
    cfgm, C, SceneBuilder = _pkg(pkg)
    walls = importlib.import_module(f"{pkg}.scenarios.simple_fluid")
    poly = importlib.import_module(f"{pkg}.math.polygon")
    scale = math.sqrt(n / 20000.0)
    size = 6.0 * scale
    shared = cfgm.SharedSystemConfig(
        universe_size_m=size, meters_per_pixel=size / C.SCREEN_LENGTH,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
        grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50)
    cfg = cfgm.ScenarioSystemConfig(shared=shared, rigid=cfgm.RigidBodyConfig(
        broadphase=cfgm.BroadphaseConfig(max_pairs=8)))
    rng = np.random.default_rng(seed)
    b = SceneBuilder(f"MIXED_H_DAM_{n}")
    walls.add_tank_walls(b, size, 0.05 * scale, 1e30, 0.0, 0.0)
    x_min, x_max = 0.16 * scale, size * 0.35
    y_min, y_max = size * 0.2, size - 0.16 * scale
    spacing = math.sqrt((x_max - x_min) * (y_max - y_min) / n)
    mass = 0.005 * (spacing / 0.0742) ** 2
    verts = poly.build_regular_polygon(4, 0.06)
    b.add(pos=(x_max, 0.75 * size), mass=0.5, phase=int(C.Phase.SOLID),
          shape_kind=int(C.ShapeKind.POLYGON), radius=0.06, verts=verts,
          inertia=poly.calculate_polygon_inertia(verts, 0.5))
    n_cols = int((x_max - x_min) / spacing)
    for k in range(n):
        row, col = divmod(k, n_cols)
        x = x_min + (col + 0.5) * spacing + rng.uniform(-0.05, 0.05) * spacing
        y = y_max - (row + 0.5) * spacing + rng.uniform(-0.05, 0.05) * spacing
        b.add(pos=(x, y), mass=mass, phase=int(C.Phase.LIQUID),
              shape_kind=int(C.ShapeKind.CIRCLE), radius=0.02,
              static_friction=0.0, dynamic_friction=0.0,
              smoothing_length=SMALL_H if k % 2 else 0.0)
    return _finalize(pkg, b, cfg)


def uniform_limit_scenes():
    """tests/test_sph.py:649-680: a 40-particle blob, and the same blob
    with one particle of h 0.06 far outside its support (the mixed-h
    path)."""
    import test_sph as T
    from lpe_tpu.core.config import (FluidConfig, ScenarioSystemConfig,
                                     SharedSystemConfig)
    from lpe_tpu.core.constants import Phase
    from lpe_tpu.scene import SceneBuilder
    sc_u = T._blob_scene(n=40, vmax=0.3, seed=9)
    cfg = ScenarioSystemConfig(
        shared=SharedSystemConfig(universe_size_m=1.5), fluid=FluidConfig())
    rng = np.random.default_rng(9)
    b = SceneBuilder("blob")
    for _ in range(40):
        b.add(pos=tuple(rng.uniform(1.5 * 0.3, 1.5 * 0.7, 2)),
              vel=tuple(rng.uniform(-0.3, 0.3, 2)),
              mass=0.005, phase=int(Phase.LIQUID), radius=0.02)
    b.add(pos=(0.06, 0.06), vel=(0.0, 0.0), mass=0.005,
          phase=int(Phase.LIQUID), radius=0.02, smoothing_length=0.06)
    return sc_u, b.finalize(cfg)


def run_jax(sc, ticks, **fluid_kw):
    import jax
    from lpe_tpu.state import to_numpy
    from lpe_tpu.systems.fluid import make_fluid
    step = jax.jit(make_fluid(sc.spec, with_fluid(sc.cfg, pair_backend="xla",
                                                  **fluid_kw)))
    s = sc.state
    for _ in range(ticks):
        s = step(s)
    return to_numpy(s)


def run_port(spec, cfg, state, ticks, **fluid_kw):
    from lpe_tpu_torch.systems.fluid import make_fluid
    step = make_fluid(spec, with_fluid(cfg, **fluid_kw), device="cpu")
    for _ in range(ticks):
        state = step(state)
    return state


@pytest.fixture(scope="module")
def jax_runs():
    """lpe_tpu's runs, each made once for the module."""
    made = {}

    def get(key, make):
        if key not in made:
            made[key] = make()
        return made[key]
    return get


def test_scenes_built_by_both_packages_agree():
    """The port's SceneBuilder gives lpe_tpu's scene to the bit."""
    from lpe_tpu_torch.convert import state_to_numpy
    from test_torch_app import _assert_same_bits, _leaves
    for make in (mixed_blob, mixed_dam):
        sc_j, sc_t = make("lpe_tpu"), make("lpe_tpu_torch")
        spec, _, state = to_port(sc_j)
        assert sc_t.spec == spec and not spec.liquid_h_uniform
        _assert_same_bits(_leaves(state_to_numpy(sc_t.state)),
                          _leaves(state_to_numpy(state)))


@pytest.mark.parametrize("residency", ["on", "off"])
def test_blob_matches_lpe_tpu_and_oracle(jax_runs, residency):
    from lpe_tpu_torch.oracle.sph_numpy import SphOracle
    sc = mixed_blob("lpe_tpu")
    spec, cfg, state = to_port(sc)
    want = jax_runs(("blob", residency),
                    lambda: run_jax(sc, 1, residency=residency))
    got = run_port(spec, cfg, mixed_blob("lpe_tpu_torch").state, 1,
                   residency=residency)
    assert_bodies_close(spec, got, want)
    liq = spec.liquid_slice
    b = state.bodies
    fc = cfg.fluid
    o = SphOracle(h=fc.grid.smoothing_length, rest_density=fc.rest_density,
                  stiffness=fc.stiffness, viscosity=fc.viscosity,
                  universe=cfg.shared.universe_size_m,
                  margin=cfg.boundary.margin_pixels
                  * cfg.shared.meters_per_pixel)
    o.hs = b.h.numpy()[liq].astype(np.float64)
    p1, _, rho1, _ = o.tick(*(v.numpy()[liq].astype(np.float64)
                              for v in (b.pos, b.vel, b.mass)))
    pg, _, rg = liquid(got, spec)
    np.testing.assert_allclose(rg, rho1, rtol=2e-4)
    np.testing.assert_allclose(pg, p1, rtol=0, atol=5e-6)
    # particles of both h had pair partners (density above the self term
    # m * 4 / (pi h^2))
    hs = b.h.numpy()[liq]
    paired = rg > 1.001 * 0.005 * 4.0 / (math.pi * hs.astype(np.float64) ** 2)
    assert paired[hs < 0.05].sum() >= 5 and paired[hs > 0.05].sum() >= 5


@pytest.mark.parametrize("residency", ["on", "off"])
def test_uniform_limit_matches_uniform_path(residency):
    """All h equal but one far particle's: the mixed-h chain (a grid
    sized by h = 0.06) gives the uniform path's positions (atol 1e-6, as
    lpe_tpu's test)."""
    from lpe_tpu_torch.ops import sph_kernels as SK
    sc_u, sc_m = uniform_limit_scenes()
    SK.reset_counters()
    s_m = run_port(*to_port(sc_m), 1, residency=residency)
    assert SK.density_h.plain_calls == SK.force_h.plain_calls == 10
    assert SK.density.plain_calls == SK.pair_sweep.plain_calls == 0
    s_u = run_port(*to_port(sc_u), 1, residency=residency)
    lm = sc_m.spec.liquid_start
    np.testing.assert_allclose(
        s_m.bodies.pos.numpy()[lm:lm + 40],
        s_u.bodies.pos.numpy()[sc_u.spec.liquid_slice], rtol=0, atol=1e-6)
    SK.reset_counters()


def test_mixed_dam_with_rigids_matches_lpe_tpu(jax_runs):
    """The mixed-h dam with its tank walls and a dynamic box, 2 ticks,
    against lpe_tpu's resident mixed-h run, which couples in dense XLA
    (every particle against every rigid): the port's S-slot raster must
    find every candidate, so the cells couple and none overflows S."""
    from lpe_tpu_torch.core.telemetry import (assert_no_saturation,
                                              capacity_report)
    from lpe_tpu_torch.systems.fluid import make_fluid
    sc = mixed_dam("lpe_tpu")
    spec, cfg, state = to_port(sc)
    assert_no_saturation(capacity_report(state, spec, cfg))
    fl = make_fluid(spec, cfg, device="cpu")
    cells, dynamic = fl.coupled_cells(state)
    assert cells > 0 and dynamic > 0
    want = jax_runs("dam", lambda: run_jax(sc, 2, residency="on"))
    got = run_port(spec, cfg, state, 2)
    assert_no_saturation(capacity_report(got, spec, cfg))
    ns = spec.liquid_start
    wall = state.bodies.mass.numpy()[:ns] > 1e29
    assert wall.sum() == 4 and (~wall).sum() == 1
    for f in ("vel", "omega"):
        g = getattr(got.bodies, f).numpy()[:ns]
        w = getattr(want.bodies, f)[:ns]
        old = getattr(state.bodies, f).numpy()[:ns]
        np.testing.assert_allclose(g[wall], w[wall], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[~wall] - old[~wall],
                                   w[~wall] - old[~wall], rtol=2e-3,
                                   atol=1e-5)
        # the box felt the fluid
        assert np.abs(g[~wall] - old[~wall]).max() > 1e-3
    (pg, vg, rg), (pw, vw, rw) = liquid(got, spec), liquid(want, spec)
    assert np.isfinite(pg).all()
    np.testing.assert_allclose(pg, pw, rtol=0, atol=STIFF["pos"])
    np.testing.assert_allclose(vg, vw, rtol=0, atol=STIFF["vel"])
    np.testing.assert_allclose(rg, rw, rtol=STIFF["rho"])


def _random_grid(K=8, rows=8, W=16, nx=12, cell=0.1, fill=0.4, seed=0):
    """An ST10 [rows, 10, K, W] of particles in their cells (gmin -2),
    each of h 0.04 or 0.05, random velocities and accelerations."""
    rng = np.random.default_rng(seed)
    ST = np.zeros((rows, 10, K, W), np.float32)
    for p in range(1, rows - 1):
        for c in range(1, nx + 1):
            for k in range(rng.binomial(K, fill)):
                ST[p, 0, k, c] = (c - 3 + rng.uniform(0.01, 0.99)) * cell
                ST[p, 1, k, c] = (p - 3 + rng.uniform(0.01, 0.99)) * cell
                ST[p, 2:6, k, c] = rng.uniform(-2, 2, 4)
                ST[p, 6:9, k, c] = (0.005, 1 + p * 1000 + c * 10 + k, 1.0)
                ST[p, 9, k, c] = 0.04 if rng.uniform() < 0.5 else 0.05
    mk = dict(nx=nx, half_dt=0.5 / 1200, sub_dt=1 / 1200, lim=0.045,
              cell=cell, eps=1e-6, gmin=-2)
    return torch.from_numpy(ST), mk


def test_plain_kernels_against_float64():
    """migrate_h_plain carries h and equals migrate_plain on planes 0-8 to
    the bit; density_h_plain and force_h_plain against a float64 sum over
    every pair of particles (the 3x3 cells hold every pair within h-bar)."""
    from lpe_tpu_torch.ops import sph_kernels as SK
    ST, mk = _random_grid()
    M = SK.migrate_h_plain(ST, **mk)
    M9 = SK.migrate_plain(ST[:, :9].contiguous(), **mk)
    assert M.shape[1] == 10
    assert torch.equal(M[:, :9].view(torch.int32), M9.view(torch.int32))
    occ = M[:, SK.M9_OCC] > 0
    # h moved with its particle's id
    ids = ST[:, SK.ST_ID][ST[:, SK.ST_OCC] > 0]
    hs = ST[:, SK.ST_H][ST[:, SK.ST_OCC] > 0]
    order = torch.argsort(M[:, SK.M9_ID][occ])
    back = torch.argsort(ids)
    assert torch.equal(M[:, SK.M10_H][occ][order], hs[back])
    x, y, vx, vy, m, _, _, _, _, h = M.unbind(1)
    occf = occ.to(torch.float32)
    D5 = torch.stack([x, y, m, occf, h], 1)
    rho = SK.density_h_plain(D5)
    rp = torch.nn.functional.pad(rho, (0, 0, 0, 0, 1, 1))
    p = torch.clamp(200.0 * (rp - 0.5), min=0.0)
    kw = dict(viscosity=0.03, min_d2=1e-14, min_rho=1e-12)
    fx, fy = SK.force_h_plain(torch.stack([x, y, vx, vy, m, rp, p, occf, h],
                                          1), **kw)
    # float64 over all pairs
    sel = occ.clone()
    sel[0] = sel[-1] = False
    P = {k: v[sel].double().numpy()
         for k, v in dict(x=x, y=y, vx=vx, vy=vy, m=m, h=h).items()}
    d = np.stack([P["x"][:, None] - P["x"][None], P["y"][:, None]
                  - P["y"][None]])
    r2 = (d * d).sum(0)
    hb = 0.5 * (P["h"][:, None] + P["h"][None])
    w = np.where(r2 < hb * hb, 4 / (math.pi * hb ** 8) * (hb * hb - r2) ** 3,
                 0.0)
    rho64 = (w * P["m"][None]).sum(1)
    np.testing.assert_allclose(rho[sel[1:-1]].numpy(), rho64, rtol=1e-5)
    pr = np.maximum(200.0 * (rho64 - 0.5), 0.0)
    r = np.sqrt(np.maximum(r2, 1e-30))
    ok = (r2 < hb * hb) & ~np.eye(len(r2), dtype=bool)
    term = pr[:, None] / rho64[:, None] ** 2 + pr[None] / rho64[None] ** 2
    fp = -P["m"][None] * term * (-30 / (math.pi * hb ** 5)) * (hb - r) ** 2
    fv = 0.03 * P["m"][None] * (40 / (math.pi * hb ** 5)) * (hb - r) \
        / rho64[None]
    f64 = [np.where(ok, fp * d[a] / r - fv * (P[v][:, None] - P[v][None]),
                    0.0).sum(1) for a, v in ((0, "vx"), (1, "vy"))]
    scale = max(np.abs(f).max() for f in f64)
    for got, want in zip((fx, fy), f64):
        np.testing.assert_allclose(got[sel[1:-1]].numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
    assert int(sel.sum()) > 100 and scale > 1.0


@pytest.mark.parametrize("fluid_kw,want", [
    (dict(), ("migrate_h", "density_h", "force_h", "coupling")),
    (dict(pair_backend="sweep"),
     ("migrate_h", "density_h", "force_h", "coupling")),
    (dict(pair_backend="pallas"),
     ("migrate_h", "density_h", "force_h", "coupling")),
    (dict(residency="off"), ("density_h", "force_h")),
])
def test_mixed_h_dispatch(fluid_kw, want):
    """A mixed-h scene takes the mixed-h chain whatever pair_backend says:
    the plain calls of a tick on the CPU, the decision KernelOp makes on
    the card too."""
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.systems import build_run_fn
    sc = mixed_dam("lpe_tpu_torch", n=300)
    cfg = with_fluid(sc.cfg, **fluid_kw)
    SK.reset_counters()
    s = build_run_fn(sc.spec, cfg, ticks=1, device="cpu")(sc.state)
    calls = {op.name: op.plain_calls for op in SK.OPS if op.plain_calls}
    SK.reset_counters()
    n = cfg.fluid.num_sub_steps
    assert calls == dict.fromkeys(want, n)
    assert bool(torch.isfinite(s.bodies.pos).all())


def test_run_fn_block_and_checkpoints(tmp_path):
    """build_run_fn(ticks=3), whose grid (and h plane) stays resident
    across the block, against three build_tick_fn ticks, at
    test_torch_run_fn.py's tolerances; then a mixed-h checkpoint loads in
    both packages to the bit."""
    from lpe_tpu.io.checkpoint import load_state as jload
    from lpe_tpu.io.checkpoint import save_state as jsave
    from lpe_tpu.state import to_numpy
    from lpe_tpu_torch.convert import state_to_numpy
    from lpe_tpu_torch.io import checkpoint as TC
    from lpe_tpu_torch.systems import build_run_fn, build_tick_fn
    from test_torch_app import _assert_same_bits, _leaves
    sc = mixed_dam("lpe_tpu_torch", n=300)
    run = build_run_fn(sc.spec, sc.cfg, ticks=3, device="cpu")
    assert run.systems["fluid"].grid_build is not None
    tick = build_tick_fn(sc.spec, sc.cfg, device="cpu")
    a = run(sc.state)
    b = tick(tick(tick(sc.state)))
    liq = sc.spec.liquid_slice
    pa, pb = a.bodies.pos.numpy()[liq], b.bodies.pos.numpy()[liq]
    assert np.isfinite(pa).all() and np.abs(pa - sc.state.bodies.pos.numpy()
                                            [liq]).max() > 1e-4
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.bodies.vel.numpy()[liq],
                               b.bodies.vel.numpy()[liq], rtol=0, atol=3e-3)
    np.testing.assert_allclose(a.bodies.density.numpy()[liq],
                               b.bodies.density.numpy()[liq], rtol=1e-4)
    assert torch.equal(a.bodies.h, sc.state.bodies.h)
    TC.save_state(str(tmp_path / "t.npz"), a)
    got = jload(str(tmp_path / "t.npz"))
    _assert_same_bits(_leaves(to_numpy(got)), _leaves(state_to_numpy(a)))
    jsave(str(tmp_path / "j.npz"), got)
    _assert_same_bits(_leaves(state_to_numpy(
        TC.load_state(str(tmp_path / "j.npz"), device="cpu"))),
        _leaves(state_to_numpy(a)))
    assert len(np.unique(np.asarray(got.bodies.h)[liq])) == 2
