"""Entity sharding over a band mesh (``lpe_tpu_torch.parallel.sharded``):
gravity split by receiver blocks and the grid rigid pipeline in y-row
bands, on CPU meshes (``make_mesh(devices=["cpu"] * D)``), against the
port's single device and against lpe_tpu's ``build_sharded_tick`` on the
conftest's 8 virtual CPU devices.

Tolerances:

- gravity (the direct sum and the P3M step with its PP correction): equal
  to the single device to the bit. A block, or a PP pass, is the same op
  on the same shape on every device, so each body's sum keeps its order.
  The blocks are made small here (``DIRECT_BLOCK_ELEMS``,
  ``PP_BAND_ELEMS``), for both runs alike, so that the 2,000-body galaxy
  has many of them to split;
- the grid rigid pipeline in bands against the port's single device: to
  the bit (every op is per cell or per row; a band's scatters reduce over
  the same rows of the same cells). Held to the bit, which is stronger
  than lpe_tpu's tolerances below;
- against lpe_tpu's sharded tick: tests/test_parallel.py:100-112's, pos
  atol 1e-5 m, vel and omega 1e-4. lpe_tpu's rebuild orders a cell's
  bodies with an unstable sort, the port's with a stable one (see
  tests/test_torch_grid_rigid.py), so each tick starts lpe_tpu from the
  port's state with the port's grid tables (fresh warm starts after a
  rebuild), on which lpe_tpu's guard holds;
- RANDOM_POLYGONS (the list pipeline, its narrowphase and solver rows in
  8 shards) against lpe_tpu's sharded tick: tests/test_parallel.py:38-52's,
  pos 1e-5 m, vel 1e-4 m/s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpe_tpu_torch.convert import state_to_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TICKS = 3
GRID_BANDS = (2, 4, 8)
RIGID_TOL = {"pos": 1e-5, "vel": 1e-4, "omega": 1e-4}


def cpu_mesh(n):
    from lpe_tpu_torch.parallel import make_mesh
    return make_mesh(devices=["cpu"] * n)


def bits_equal(a, b):
    """Equal shapes and equal bits (NaN where the other has the same
    NaN)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def run(tick, state, ticks=TICKS):
    out = []
    for _ in range(ticks):
        state = tick(state)
        out.append(state)
    return out


# ---------------------------------------------------------------------------
# gravity: receiver blocks over the mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def galaxy():
    from lpe_tpu_torch.scenarios.bench_scenes import build_galaxy
    return build_galaxy(2000, seed=0, device="cpu")


@pytest.mark.parametrize("D", [2, 3, 8])
@pytest.mark.parametrize("branch", ["direct", "p3m"])
def test_gravity_split_equals_single_device(galaxy, branch, D, monkeypatch):
    """build_galaxy(2000) on the direct sum and on P3M (PP on): one tick
    over D devices equals the single device's to the bit, with the work
    in more than one run of blocks."""
    from lpe_tpu_torch.ops import pm_gravity as PM
    from lpe_tpu_torch.parallel import split_runs
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    from lpe_tpu_torch.scene import Scene
    from lpe_tpu_torch.systems import barnes_hut as BH
    from lpe_tpu_torch.systems import build_tick_fn
    monkeypatch.setattr(BH, "DIRECT_BLOCK_ELEMS", 1 << 15)   # 128 rows
    monkeypatch.setattr(PM, "PP_BAND_ELEMS", 1 << 13)
    cfg = galaxy.cfg
    if branch == "p3m":
        cfg = cfg.replace(barnes_hut=dataclasses.replace(
            cfg.barnes_hut, direct_sum_max_bodies=1))
    sc = Scene(state=galaxy.state, spec=galaxy.spec, cfg=cfg)
    single = build_tick_fn(sc.spec, cfg, device="cpu")
    tick = build_sharded_tick(sc, cpu_mesh(D))
    step = tick.systems["barnes_hut"]
    assert step.use_pm == (branch == "p3m")
    assert step.devices is not None and len(step.devices) == D
    assert single.systems["barnes_hut"].devices is None
    n = sc.spec.capacity
    if branch == "p3m":
        assert step.pp is not None
        blocks = -(-n // max(1, PM.PP_BAND_ELEMS // step.pp.K))
    else:
        blocks = -(-n // step.chunk)
    assert len(split_runs(list(range(blocks)), step.devices)) == \
        min(D, blocks) > 1
    want, got = single(sc.state), tick(sc.state)
    assert bool(torch.isfinite(got.bodies.vel).all())
    assert not torch.equal(got.bodies.vel, sc.state.bodies.vel)
    for f in ("pos", "vel"):
        assert bits_equal(getattr(got.bodies, f), getattr(want.bodies, f)), f


def test_split_runs_are_contiguous_and_whole():
    from lpe_tpu_torch.parallel import split_runs
    starts = list(range(0, 1000, 128))                     # 8 blocks
    for D in (1, 2, 3, 8, 11):
        runs = split_runs(starts, list(range(D)))
        assert [a for _, r in runs for a in r] == starts
        assert [d for d, _ in runs] == sorted(d for d, _ in runs)
        sizes = [len(r) for _, r in runs]
        assert max(sizes) - min(sizes) <= 1 and len(runs) == min(D, 8)


# ---------------------------------------------------------------------------
# the grid rigid pipeline in y-row bands
# ---------------------------------------------------------------------------

def _jax_shard_grid():
    """lpe_tpu's SHARD_GRID scene (tests/test_parallel.py:66-104), as
    that test builds it."""
    from lpe_tpu.core import constants as C
    from lpe_tpu.core.config import (BroadphaseConfig, RigidBodyConfig,
                                     ScenarioSystemConfig,
                                     SharedSystemConfig)
    from lpe_tpu.math.polygon import (build_random_convex_polygon,
                                      calculate_polygon_inertia)
    from lpe_tpu.scene import SceneBuilder
    size = 3.0
    cfg = ScenarioSystemConfig(
        shared=SharedSystemConfig(
            universe_size_m=size, meters_per_pixel=size / C.SCREEN_LENGTH,
            seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
            grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50),
        rigid=RigidBodyConfig(
            broadphase=BroadphaseConfig(max_pairs=4096,
                                        persist_slack_m=0.04),
            grid_pipeline="on"))
    rng = np.random.default_rng(2)
    b = SceneBuilder("SHARD_GRID")
    for wall in ((0.0, size / 2, 0.05, size / 2),
                 (size, size / 2, 0.05, size / 2),
                 (size / 2, 0.0, size / 2, 0.05),
                 (size / 2, size, size / 2, 0.05)):
        b.add_wall(*wall)
    for _ in range(96):
        sz = rng.uniform(0.05, 0.12)
        verts = build_random_convex_polygon(rng, sz)
        mass = max(0.1, rng.normal(1.0, 0.1))
        b.add(pos=(rng.uniform(size * 0.1, size * 0.9),
                   rng.uniform(size * 0.1, size * 0.9)),
              vel=(rng.uniform(-1, 1), rng.uniform(-1, 1)),
              mass=mass, phase=int(C.Phase.SOLID),
              shape_kind=int(C.ShapeKind.POLYGON), radius=sz, verts=verts,
              inertia=calculate_polygon_inertia(verts, mass),
              omega=rng.uniform(-1, 1))
    return b.finalize(cfg)


@pytest.fixture(scope="module")
def grid():
    """The port's SHARD_GRID scene and its single-device trajectory."""
    from lpe_tpu_torch.parallel.dryrun import shard_grid_scene
    from lpe_tpu_torch.systems import build_tick_fn
    sc = shard_grid_scene("cpu")
    tick = build_tick_fn(sc.spec, sc.cfg, device="cpu")
    return dict(sc=sc, states=[sc.state] + run(tick, sc.state),
                rebuilds=tick.systems["rigid"].rebuilds)


def test_shard_grid_scene_is_lpe_tpus(grid):
    """The port's SHARD_GRID builder gives lpe_tpu's state to the bit; the
    grid divides into 2, 4 and 8 bands."""
    from lpe_tpu.state import to_numpy
    from lpe_tpu_torch.systems.rigid.grid_pipeline import grid_dims
    js = _jax_shard_grid()
    a, b = state_to_numpy(grid["sc"].state), to_numpy(js.state)
    for part in ("bodies", None):
        x, y = (a.bodies, b.bodies) if part else (a, b)
        for f in dataclasses.fields(x):
            if f.name == "bodies":
                continue
            u, v = getattr(x, f.name), np.asarray(getattr(y, f.name))
            assert u.dtype == v.dtype and np.array_equal(u, v,
                                                         equal_nan=True), \
                f.name
    nbx = grid_dims(grid["sc"].spec, grid["sc"].cfg)["nbx"]
    assert all(nbx % D == 0 for D in GRID_BANDS)


@pytest.mark.parametrize("D", GRID_BANDS)
def test_grid_bands_equal_single_device(grid, D):
    """3 ticks in D y-row bands equal the single device's to the bit in
    every body and grid field, the exchanges carried increments across
    band edges (candidate rows of the S/SW/SE classes in a band's last
    row), and the guard read the host once a tick."""
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    from lpe_tpu_torch.systems.rigid.grid_pipeline import OFFS, grid_dims
    sc = grid["sc"]
    tick = build_sharded_tick(sc, cpu_mesh(D))
    step = tick.systems["rigid"]
    assert step.bands == D and step.mesh is not None
    RK.reset_counters()
    got = run(tick, sc.state)
    assert RK.narrowphase_grid.plain_calls == D * TICKS
    assert RK.narrowphase_grid.launches == 0
    assert step.guard_reads == TICKS
    assert step.rebuilds == grid["rebuilds"] >= 1
    for g, w in zip(got, grid["states"][1:]):
        for name in ("pos", "vel", "angle", "omega"):
            assert bits_equal(getattr(g.bodies, name),
                              getattr(w.bodies, name)), name
        for f in dataclasses.fields(g):
            if f.name != "bodies":
                assert bits_equal(getattr(g, f.name), getattr(w, f.name)), \
                    f.name
    # rows that pair a band's last cell row with the next band's first
    gd = grid_dims(sc.spec, sc.cfg)
    nbx, caps = gd["nbx"], gd["caps"]
    valid = got[-1].rg_valid.reshape(nbx, nbx, -1)
    last = [(i + 1) * nbx // D - 1 for i in range(D)]
    base, cross = 0, 0
    for (dx, dy), cap in zip(OFFS, caps):
        if dy == 1:
            cross += int(valid[last, :, base:base + cap].sum())
        base += cap
    assert cross > 0
    assert step.halo_stats["copies"] > 0 and step.halo_stats["bytes"] > 0


@pytest.mark.parametrize("D", [3, 1])
def test_grid_dispatch_single_device(grid, D):
    """A mesh whose size does not divide the cell rows, and a mesh of one
    device, run the single-device pipeline (lpe_tpu replicates the rg_*
    leaves then); gravity is split only over more than one device."""
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    from lpe_tpu_torch.systems.rigid.grid_pipeline import grid_dims
    sc = grid["sc"]
    assert grid_dims(sc.spec, sc.cfg)["nbx"] % 3 != 0
    tick = build_sharded_tick(sc, cpu_mesh(D))
    step = tick.systems["rigid"]
    assert step.bands == 1 and step.mesh is None
    out = tick(sc.state)
    assert step.halo_stats == dict(bytes=0, copies=0, split_bytes=0)
    assert bits_equal(out.bodies.pos, grid["states"][1].bodies.pos)


@pytest.mark.parametrize("D", GRID_BANDS)
def test_band_narrowphase_rows_equal_whole_grid(grid, D):
    """narrowphase_grid_plain on each band's rows (``grid_band``: the
    band's grids and the row below them) equals the whole grid's outputs
    for those rows, to the bit, every row (candidate or not)."""
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.systems import build_tick_fn
    sc = grid["sc"]
    step = build_tick_fn(sc.spec, sc.cfg, device="cpu").systems["rigid"]
    nargs, kw, valid = step.narrowphase_args(grid["states"][1])
    nbx, R = kw["nbx"], valid.shape[1]
    whole = RK.narrowphase_grid(*nargs, **kw)
    rows = nbx // D
    for i in range(D):
        band = RK.grid_band(nargs, nbx=nbx, r0=i * rows, rows=rows)
        assert band[0].shape[0] == (rows + 1) * nbx
        got = RK.narrowphase_grid_plain(*band, **kw)
        cut = slice(i * rows * nbx * R, (i + 1) * rows * nbx * R)
        for g, w in zip(got, whole):
            assert bits_equal(g, w[cut])
    assert int(valid.sum()) > 0


def _to_jax(js0, st):
    """lpe_tpu's state with every leaf from the port's numpy state."""
    b = js0.bodies.replace(**{
        f.name: jnp.asarray(getattr(st.bodies, f.name))
        for f in dataclasses.fields(st.bodies)})
    return js0.replace(bodies=b, **{
        f.name: jnp.asarray(getattr(st, f.name))
        for f in dataclasses.fields(st) if f.name != "bodies"})


@pytest.fixture(scope="module")
def jax_grid(grid):
    """lpe_tpu's sharded tick on 8 CPU devices from each port state of the
    single-device trajectory, with the port's grid tables of the tick
    (fresh warm starts where the port rebuilt): lpe_tpu's state after each
    tick, and whether its guard held."""
    from lpe_tpu.parallel.sharded import (build_sharded_tick, make_mesh,
                                          shard_state)
    from lpe_tpu.state import to_numpy
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest)")
    js = _jax_shard_grid()
    mesh = make_mesh(8)
    tick = build_sharded_tick(js, mesh)
    tables = ("rg_flat", "rg_table", "rg_ka", "rg_kb", "rg_valid",
              "rg_verts", "rg_nverts", "rg_radius", "rg_iscirc", "rg_invm",
              "rg_invi", "bp_anchor_pos", "bp_anchor_ang")
    out = []
    states = [state_to_numpy(s) for s in grid["states"]]
    for before, after in zip(states, states[1:]):
        carried = {f: getattr(after, f) for f in tables}
        if not np.array_equal(after.bp_anchor_pos, before.bp_anchor_pos):
            carried.update(
                rg_warm_n=np.zeros_like(before.rg_warm_n),
                rg_warm_t=np.zeros_like(before.rg_warm_t),
                rg_warm_pt=np.full_like(before.rg_warm_pt, 1e30),
                rg_warm_nrm=np.zeros_like(before.rg_warm_nrm))
        start = dataclasses.replace(before, **carried)
        want = to_numpy(tick(shard_state(mesh, _to_jax(js.state, start))))
        out.append((want, np.array_equal(np.asarray(want.bp_anchor_pos),
                                          after.bp_anchor_pos)))
    return out


@pytest.mark.parametrize("D", GRID_BANDS)
def test_grid_bands_match_lpe_tpus_sharded_tick(grid, jax_grid, D):
    """Each of the 3 ticks in D bands against lpe_tpu's sharded tick on 8
    devices from the same state and tables, at test_parallel's
    tolerances."""
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    tick = build_sharded_tick(grid["sc"], cpu_mesh(D))
    assert tick.systems["rigid"].bands == D
    for before, (want, held) in zip(grid["states"], jax_grid):
        assert held                       # lpe_tpu's guard did not rebuild
        got = state_to_numpy(tick(before))
        for f, atol in RIGID_TOL.items():
            np.testing.assert_allclose(getattr(got.bodies, f),
                                       np.asarray(getattr(want.bodies, f)),
                                       rtol=0, atol=atol, err_msg=f)


def test_list_pipeline_matches_lpe_tpus_sharded_tick():
    """RANDOM_POLYGONS (the rigid list pipeline, split in 8 shards) over
    an 8-device CPU mesh, 3 ticks, against lpe_tpu's sharded tick on its 8
    devices: tests/test_parallel.py:38-52."""
    from lpe_tpu.parallel.sharded import build_sharded_tick as jsharded
    from lpe_tpu.parallel.sharded import make_mesh as jmesh
    from lpe_tpu.parallel.sharded import shard_state as jshard
    from lpe_tpu.scenarios import create_scenario as jcreate
    from lpe_tpu.state import to_numpy
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    from lpe_tpu_torch.scenarios import create_scenario
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest)")
    js = jcreate("RANDOM_POLYGONS", seed=1)
    ts = create_scenario("RANDOM_POLYGONS", seed=1, device="cpu")
    mesh = jmesh(8)
    jt = jsharded(js, mesh)
    tick = build_sharded_tick(ts, cpu_mesh(8))
    assert not hasattr(tick.systems["rigid"], "bands")   # not the grid
    assert tick.systems["rigid"].shards == 8
    s_j, s_t = jshard(mesh, js.state), ts.state
    for _ in range(TICKS):
        s_j, s_t = jt(s_j), tick(s_t)
    want, got = to_numpy(s_j), state_to_numpy(s_t)
    np.testing.assert_allclose(got.bodies.pos, np.asarray(want.bodies.pos),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.bodies.vel, np.asarray(want.bodies.vel),
                               rtol=0, atol=1e-4)
