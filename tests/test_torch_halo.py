"""The port's multi-device fluid (``lpe_tpu_torch.parallel``: row bands with
a one-row halo exchange; bands on CPU devices here) against lpe_tpu's
(``lpe_tpu.parallel``, shard_map over the conftest's 8 virtual CPU
devices) and against the port's single-device split tick.

Tolerances are tests/test_halo.py's: the halo density at rtol 1e-4 of the
brute-force sum (and of lpe_tpu's), a tick or a block at |dpos| < 5e-4 m and
|dvel| < 5e-3 m/s. Against the port's single-device split tick a liquid with
no rigid is equal to the bit in every liquid field: every band runs the
single-device kernels on the same slots in the same order; only the rigids'
force sums reassociate (a sum a band, then the bands in order), held to
1e-6 of the largest.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_fluid_slice import blob_scene, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from lpe_tpu_torch.ops import sph_kernels as SK
from lpe_tpu_torch.parallel import BandMesh, make_mesh

POS, VEL = 5e-4, 5e-3             # tests/test_halo.py:96-100


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def with_fluid(cfg, **kw):
    return cfg.replace(fluid=dataclasses.replace(cfg.fluid, **kw))


def port_split(sc, **kw):
    """(spec, cfg, state) of the port, carried across from a lpe_tpu scene,
    on the split resident chain (the band path's engine)."""
    spec, cfg, state = to_port(sc)
    return spec, with_fluid(cfg, pair_backend="pallas", residency="on",
                            **kw), state


def run(tick, state, ticks):
    for _ in range(ticks):
        state = tick(state)
    return state


def gaps(a, b, rows):
    """max |dpos| and |dvel| of the bodies ``rows`` of two states."""
    pa, pb = np.asarray(a.bodies.pos)[rows], np.asarray(b.bodies.pos)[rows]
    va, vb = np.asarray(a.bodies.vel)[rows], np.asarray(b.bodies.vel)[rows]
    assert np.isfinite(pa).all() and np.isfinite(va).all()
    return float(np.abs(pa - pb).max()), float(np.abs(va - vb).max())


# ---------------------------------------------------------------------------
# migrate with a row offset, and the exchange
# ---------------------------------------------------------------------------

def random_st(ny=16, nx=12, K=4, W=16, cell=0.1, sub_dt=0.01, seed=0):
    """A seeded ST grid [ny+2, 9, K, W] with ~40% of the interior slots
    occupied, each particle inside its cell and moving up to the drift
    clamp (0.45 cell) a sub-step, so that many cross a cell row."""
    rng = np.random.default_rng(seed)
    rows = ny + 2
    st = np.zeros((rows, 9, K, W), np.float32)
    occ = rng.random((ny, K, nx)) < 0.4
    r, k, c = np.nonzero(occ)
    gmin = -2
    st[r + 1, SK.ST_X, k, c + 1] = (c + gmin + rng.random(r.size)) * cell
    st[r + 1, SK.ST_Y, k, c + 1] = (r + gmin + rng.random(r.size)) * cell
    vmax = 0.45 * cell / sub_dt
    for f in (SK.ST_VX, SK.ST_VY):
        st[r + 1, f, k, c + 1] = rng.uniform(-vmax, vmax, r.size)
    for f in (SK.ST_AX, SK.ST_AY):
        st[r + 1, f, k, c + 1] = rng.uniform(-50, 50, r.size)
    st[r + 1, SK.ST_M, k, c + 1] = 0.005
    st[r + 1, SK.ST_ID, k, c + 1] = np.arange(1, r.size + 1)
    st[r + 1, SK.ST_OCC, k, c + 1] = 1.0
    consts = dict(nx=nx, half_dt=0.5 * sub_dt, sub_dt=sub_dt,
                  lim=0.45 * cell, cell=cell, eps=1e-6, gmin=gmin)
    return torch.from_numpy(st), consts


@pytest.mark.parametrize("D", [2, 4])
def test_band_migrate_equals_whole_grid(D):
    """migrate's plain version on band blocks (a band's rows and the
    neighbours' edge rows, as the exchange leaves them) equals the whole
    grid's interior rows to the bit, with particles crossing the bands."""
    ST, consts = random_st()
    rows = ST.shape[0]
    ny = rows - 2
    band = ny // D
    whole = SK.migrate_plain(ST, **consts)
    # the exchange builds the blocks' halo rows from empty ones
    blocks = [torch.nn.functional.pad(ST[1 + i * band:1 + (i + 1) * band],
                                      (0, 0, 0, 0, 0, 0, 1, 1))
              for i in range(D)]
    moved = cpu_mesh(D).exchange(blocks)
    assert moved == 2 * (D - 1) * ST[0].numel() * 4
    crossed = 0
    for i, blk in enumerate(blocks):
        assert torch.equal(blk, ST[i * band:i * band + band + 2])
        got = SK.migrate_plain(blk, row_off=i * band, ny=ny, **consts)
        want = whole[i * band + 1:i * band + band + 1]
        assert torch.equal(got[1:-1], want)
        assert not got[0].any() and not got[-1].any()
        # particles that came from the neighbours' rows
        ids = set(got[1:-1, SK.M9_ID][got[1:-1, SK.M9_OCC] > 0].tolist())
        own = set(blk[1:-1, SK.ST_ID][blk[1:-1, SK.ST_OCC] > 0].tolist())
        crossed += len(ids - own)
    assert crossed > 0
    for bad in (dict(row_off=-1, ny=ny), dict(row_off=0, ny=band - 1)):
        with pytest.raises(ValueError, match="not in a grid"):
            SK.migrate_plain(blocks[-1], **bad, **consts)


# ---------------------------------------------------------------------------
# make_halo_density
# ---------------------------------------------------------------------------

def test_halo_density_matches_lpe_tpu_and_brute_force():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from lpe_tpu.parallel.halo import make_halo_density as jax_halo
    from lpe_tpu_torch.parallel.halo import make_halo_density
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest)")
    ny, nx, K, h = 16, 16, 4, 0.05
    nxp = nx + 2
    rng = np.random.default_rng(0)
    x = np.zeros((ny, K, nxp), np.float32)
    y, m, occ = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    pts = []
    for _ in range(120):
        r, k, c = rng.integers(0, ny), rng.integers(0, K), \
            rng.integers(1, nxp - 1)
        if occ[r, k, c]:
            continue
        px, py = (c - 1 + rng.random()) * h, (r + rng.random()) * h
        x[r, k, c], y[r, k, c], m[r, k, c], occ[r, k, c] = px, py, 0.005, 1
        pts.append((r, k, c, px, py))
    want = np.asarray(jax_halo(ny, nx, K, h, Mesh(
        np.array(jax.devices()[:8]), ("data",)))(
            *(jnp.asarray(a) for a in (x, y, m, occ))))
    mesh = cpu_mesh(8)
    band = ny // 8
    split = [[torch.from_numpy(a[i * band:(i + 1) * band]) for i in range(8)]
             for a in (x, y, m, occ)]
    got = torch.cat(make_halo_density(ny, nx, K, h, mesh)(*split)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    poly6 = 4.0 / (np.pi * h ** 8)
    for r, k, c, px, py in pts[:40]:
        expect = sum(0.005 * poly6 * (h * h - d2) ** 3
                     for r2, k2, c2, qx, qy in pts
                     for d2 in [(px - qx) ** 2 + (py - qy) ** 2]
                     if d2 < h * h and abs(r2 - r) <= 1 and abs(c2 - c) <= 1)
        assert np.isclose(got[r, k, c], expect, rtol=1e-4), (r, k, c)
    assert got[occ == 0].max() == 0.0


# ---------------------------------------------------------------------------
# the band tick and block against lpe_tpu and against the single device
# ---------------------------------------------------------------------------

def simple_fluid_jax():
    from lpe_tpu.core.constants import SimulationType
    from lpe_tpu.scenarios import create_scenario
    from lpe_tpu.scenarios.simple_fluid import SimpleFluidConfig
    sc = create_scenario(SimulationType.SIMPLE_FLUID, seed=3,
                         ec=SimpleFluidConfig(fluid_particle_count=200))
    sc.cfg = sc.cfg.replace(fluid=dataclasses.replace(
        sc.cfg.fluid, pair_backend="xla", residency="on", num_sub_steps=5))
    return sc


def polygons_jax(n=150, sub_steps=4):
    from lpe_tpu.core.constants import SimulationType
    from lpe_tpu.scenarios import create_scenario
    from lpe_tpu.scenarios.fluid_and_polygons import FluidAndPolygonsConfig
    sc = create_scenario(SimulationType.FLUID_AND_POLYGONS, seed=1,
                         ec=FluidAndPolygonsConfig(fluid_particle_count=n))
    sc.cfg = sc.cfg.replace(fluid=dataclasses.replace(
        sc.cfg.fluid, pair_backend="xla", residency="on",
        num_sub_steps=sub_steps))
    return sc


def port_scene(sc):
    from lpe_tpu_torch.scene import Scene
    spec, cfg, state = port_split(sc)
    return Scene(state=state, spec=spec, cfg=cfg)


def test_band_tick_matches_lpe_tpu():
    """Three ticks of SIMPLE_FLUID 200 (5 sub-steps) through the port's
    build_sharded_tick at 8 bands against lpe_tpu's step_halo at 8
    devices (its XLA pair passes)."""
    from lpe_tpu.parallel import sharded as jsh
    from lpe_tpu.state import to_numpy
    from lpe_tpu_torch.parallel.sharded import (build_sharded_tick,
                                                shard_state)
    jsc = simple_fluid_jax()
    jmesh = jsh.make_mesh(8)
    want = to_numpy(run(jsh.build_sharded_tick(jsc, jmesh),
                        jsh.shard_state(jmesh, jsc.state), 3))
    sc = port_scene(jsc)
    mesh = cpu_mesh(8)
    tick = build_sharded_tick(sc, mesh)
    assert tick.systems["fluid"].mesh is mesh
    got = run(tick, shard_state(mesh, sc.state), 3)
    dp, dv = gaps(got, want, sc.spec.liquid_slice)
    assert dp < POS and dv < VEL, (dp, dv)


@pytest.mark.parametrize("scene,bands", [("simple_fluid", 8),
                                         ("blob_no_rigid", 4)])
def test_band_tick_matches_single_device(scene, bands):
    """The band tick against the port's single-device split tick: a liquid
    with no rigid to the bit in every liquid field; SIMPLE_FLUID, whose
    tank walls couple, at the halo tolerances (its liquid is equal to the
    bit too)."""
    from lpe_tpu_torch.systems import build_tick_fn
    jsc = simple_fluid_jax() if scene == "simple_fluid" else \
        blob_scene(n=200, seed=3, walls=False)
    spec, cfg, state = port_split(jsc, num_sub_steps=5)
    assert (spec.liquid_start == 0) == (scene == "blob_no_rigid")
    want = run(build_tick_fn(spec, cfg, device="cpu"), state, 3)
    tick = build_tick_fn(spec, cfg, device="cpu",
                         fluid_mesh=cpu_mesh(bands))
    got = run(tick, state, 3)
    assert tick.systems["fluid"].halo_stats["copies"] == \
        3 * 5 * 3 * 2 * (bands - 1)
    liq = spec.liquid_slice
    for f in ("pos", "vel", "density", "pressure"):
        assert torch.equal(getattr(got.bodies, f)[liq],
                           getattr(want.bodies, f)[liq]), f
    dp, dv = gaps(got, want, slice(None))
    assert dp < POS and dv < VEL, (dp, dv)


@pytest.fixture(scope="module")
def polygon_blocks():
    """FLUID_AND_POLYGONS 150, 4 sub-steps: 3 ticks of lpe_tpu's
    build_sharded_run at 8 devices, its single-device tick, and the
    port's build_sharded_run at 8 bands twice."""
    import jax
    from lpe_tpu.parallel import sharded as jsh
    from lpe_tpu.state import to_numpy
    from lpe_tpu.systems import build_tick_fn as jax_tick
    from lpe_tpu_torch.parallel.sharded import build_sharded_run, shard_state
    jsc = polygons_jax()
    jmesh = jsh.make_mesh(8)
    jblock = to_numpy(jsh.build_sharded_run(jsc, jmesh, ticks=3)(
        jsh.shard_state(jmesh, jsc.state)))
    jone = to_numpy(run(jax_tick(jsc.spec, jsc.cfg, donate=False),
                        jsc.state, 3))
    jax.clear_caches()
    sc = port_scene(jsc)
    mesh = cpu_mesh(8)
    block = build_sharded_run(sc, mesh, ticks=3)
    return dict(sc=sc, jax_block=jblock, jax_tick=jone,
                runs=[block(shard_state(mesh, sc.state)) for _ in range(2)])


@pytest.mark.parametrize("against", ["jax_block", "jax_tick"])
def test_band_block_matches_lpe_tpu(polygon_blocks, against):
    """build_sharded_run (the bands resident across a 3-tick block, with
    two-way coupling into the polygons and boundary and gravity on the
    band blocks) against lpe_tpu's banded block and its single-device
    ticks, over every active body."""
    sc = polygon_blocks["sc"]
    got = polygon_blocks["runs"][0]
    assert int(got.tick) == 3
    act = np.asarray(sc.state.bodies.active)
    dp, dv = gaps(got, polygon_blocks[against], act)
    assert dp < POS and dv < VEL, (dp, dv)


def test_band_block_is_deterministic(polygon_blocks):
    a, b = polygon_blocks["runs"]
    for f in ("pos", "vel", "angle", "omega", "density", "pressure"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f)), f


def test_band_coupling_forces_match_single_device():
    """30 ticks of the fluid step and the boundary on the walled blob with
    three polygons in it (test_torch_fluid_slice.py's; the rigids stay
    where they are, so they couple every tick) at 4 bands. Each tick
    starts the rigids at rest, so the velocity and spin the tick writes
    back are its force sums (a band's sums, then the bands' in band
    order) over mass and inertia, times the damping: they are finite,
    every rigid takes nonzero ones, and they are within 1e-6 of the
    largest of the single-device step's (the sums reassociate); the
    states within the halo tolerances."""
    from lpe_tpu_torch.systems import simple
    from lpe_tpu_torch.systems.fluid import make_fluid
    spec, cfg, state = port_split(blob_scene(n=200, seed=3, polygons=True),
                                  num_sub_steps=4)
    one = make_fluid(spec, cfg, device="cpu")
    bands = make_fluid(spec, cfg, device="cpu", mesh=cpu_mesh(4))
    boundary = simple.make_boundary(spec, cfg)
    nr = spec.liquid_start

    def at_rest(s):
        b = s.bodies
        vel, omega = b.vel.clone(), b.omega.clone()
        vel[:nr] = 0.0
        omega[:nr] = 0.0
        return s.replace(bodies=b.replace(vel=vel, omega=omega))

    s1 = s4 = state
    total = torch.zeros(nr)
    for _ in range(30):
        s1, s4 = one(at_rest(s1)), bands(at_rest(s4))
        w1 = (s1.bodies.vel[:nr, 0], s1.bodies.vel[:nr, 1],
              s1.bodies.omega[:nr])
        w4 = (s4.bodies.vel[:nr, 0], s4.bodies.vel[:nr, 1],
              s4.bodies.omega[:nr])
        for k, a, b in zip(("Fx", "Fy", "Tq"), w1, w4):
            assert bool(torch.isfinite(b).all()), k
            scale = float(a.abs().max())
            assert float((b - a).abs().max()) <= 1e-6 * scale, k
            total += b.abs()
        s1, s4 = boundary(s1), boundary(s4)
    assert bool((total > 0).all()), total
    dp, dv = gaps(s4, s1, slice(None))
    assert dp < POS and dv < VEL, (dp, dv)


def stacked_polygons_jax(seed=3, nx=12, ny=10, per=3):
    """A universe of 1.5 m with a floor wall, 120 small polygons in 10
    rows of 12 (every 5 cm, radius 1.5 cm) and ``per`` liquid particles
    around each, at rest: every cell row of the polygons holds 12 coupling
    candidates."""
    from lpe_tpu.core.config import (FluidConfig, ScenarioSystemConfig,
                                     SharedSystemConfig)
    from lpe_tpu.core.constants import Phase, ShapeKind
    from lpe_tpu.math.polygon import (build_regular_polygon,
                                      calculate_polygon_inertia)
    from lpe_tpu.scene import SceneBuilder
    universe = 1.5
    cfg = ScenarioSystemConfig(
        shared=SharedSystemConfig(universe_size_m=universe),
        fluid=FluidConfig())
    rng = np.random.default_rng(seed)
    b = SceneBuilder("stacked_polygons")
    b.add_wall(universe / 2, 0.05, universe / 2, 0.04)
    centres = [(0.45 + 0.05 * i, 0.4 + 0.05 * j)
               for j in range(ny) for i in range(nx)]
    for k, (x, y) in enumerate(centres):
        verts = build_regular_polygon(4 + k % 3, 0.015)
        b.add(pos=(x, y), mass=0.5, phase=int(Phase.SOLID),
              shape_kind=int(ShapeKind.POLYGON), radius=0.015, verts=verts,
              inertia=calculate_polygon_inertia(verts, 0.5))
    for x, y in centres:
        for _ in range(per):
            b.add(pos=(x + rng.uniform(-0.02, 0.02),
                       y + rng.uniform(-0.02, 0.02)),
                  mass=0.005, phase=int(Phase.LIQUID), radius=0.02)
    return b.finalize(cfg)


@pytest.mark.parametrize("bands", [2, 3, 4, 7, 8])
def test_band_tick_with_saturated_coupling_windows(bands):
    """With the coupling's sorted window capped at 64 candidates
    (``coupling_window_rows``) below the 12 a cell row of stacked
    polygons, a row's window keeps only the candidates of the lowest
    buckets from its chunk's origin. One fluid step in 2, 3 and 4 bands
    (none of whose first rows starts a chunk of COUPLE_CHUNK_ROWS) equals
    the single device's in every liquid field to the bit: a band row's
    window starts at its whole-grid chunk's origin. From its band's own
    origin, as lpe_tpu's step_halo takes it (sph.py:856), the saturated
    windows keep other candidates and the liquid's velocities differ by
    tens of m/s."""
    from lpe_tpu_torch.core import constants as C
    from lpe_tpu_torch.systems.fluid import make_fluid
    spec, cfg, state = port_split(stacked_polygons_jax(), num_sub_steps=4,
                                  coupling_window_rows=64)
    one = make_fluid(spec, cfg, device="cpu")
    banded = make_fluid(spec, cfg, device="cpu", mesh=cpu_mesh(bands))
    assert banded.band_rows % C.COUPLE_CHUNK_ROWS != 0
    want, got = one(state), banded(state)
    liq = spec.liquid_slice
    assert float((want.bodies.vel[liq] - state.bodies.vel[liq]).abs()
                 .max()) > 1.0                        # the polygons couple
    for f in ("pos", "vel", "density", "pressure"):
        assert torch.equal(getattr(got.bodies, f)[liq],
                           getattr(want.bodies, f)[liq]), f


def test_dryrun_tracers_cross_bands():
    from lpe_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(4, device="cpu")
    assert out["list_rigid"]["shards"] == 4
    assert out["list_rigid"]["copies"] > 0
    assert out["crossings"] > 0
    assert sum(n > 0 for n in out["occupancy"]) >= 2
    assert out["dpos"] < POS and out["dvel"] < VEL
    assert out["galaxy_rel_dpos"] == 0.0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mixed_h", "one_band", "entity"])
def test_single_device_dispatch(case):
    """Mixed h with a mesh runs unsharded; a mesh of one device and a
    partition other than auto/halo take the single-device fluid on the
    mesh's lead device."""
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems.fluid import make_fluid
    sc = create_scenario("SIMPLE_FLUID", seed=0, device="cpu")
    if case == "mixed_h":
        spec = dataclasses.replace(sc.spec, liquid_h_uniform=False)
        fl = make_fluid(spec, sc.cfg, device="cpu", mesh=cpu_mesh(2))
    else:
        if case == "entity":
            sc.cfg = with_fluid(sc.cfg, partition="entity")
        fl = build_sharded_tick(
            sc, cpu_mesh(1 if case == "one_band" else 2)).systems["fluid"]
    assert callable(fl.grid_build) and not hasattr(fl, "mesh")
    assert fl.grid_build(sc.state)["x"].device.type == "cpu"


def test_band_step_dispatch():
    """With a mesh the band step runs whatever residency and pair_backend
    say, and its hooks take the list of band blocks."""
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems.fluid import make_fluid
    sc = create_scenario("SIMPLE_FLUID", seed=0, device="cpu")
    mesh = cpu_mesh(3)
    for kw in ({}, dict(residency="off"), dict(pair_backend="sweep")):
        fl = make_fluid(sc.spec, with_fluid(sc.cfg, **kw), device="cpu",
                        mesh=mesh)
        assert fl.mesh is mesh
        blocks = fl.grid_build(sc.state)
        assert len(blocks) == 3
        assert {tuple(b["x"].shape) for b in blocks} == \
            {(fl.band_rows + 2, blocks[0]["x"].shape[1],
              blocks[0]["x"].shape[2])}
        # every liquid particle is in exactly one band's interior
        n = sum(int(b["occ"][1:-1].sum()) for b in blocks)
        assert n == sc.spec.n_liquid


def test_make_mesh_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA cards"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        make_mesh()
    mesh = make_mesh(2, devices=["cpu"] * 3)
    assert isinstance(mesh, BandMesh) and mesh.size == 2


def test_state_stays_on_the_lead_device():
    from lpe_tpu_torch.parallel.sharded import shard_state, state_shardings
    from lpe_tpu_torch.scenarios import create_scenario
    sc = create_scenario("SIMPLE_FLUID", seed=0, device="cpu")
    mesh = cpu_mesh(4)
    sh = state_shardings(mesh, sc.state)
    assert sh.bodies.pos == mesh.lead and sh.tick == mesh.lead
    st = shard_state(mesh, sc.state)
    assert torch.equal(st.bodies.pos, sc.state.bodies.pos)
