"""The port's grid-resident rigid pipeline and its scenes against lpe_tpu.

The scene is the 96-polygon grid scene of tests/test_pallas_rigid.py:68-106
(built in both packages from one seed). lpe_tpu assigns grid slots with an
unstable argsort, which on the CPU does not keep body order within a cell;
the port's sort is stable. Slot order decides which body of a same-cell
pair is side A (whose face is the reference face of the manifold), so the
two packages agree on the SETS of bodies and candidate pairs, not on their
slots, and a rebuild may give a pair the other manifold. Hence:

- (a) after the first rebuild the per-cell body sets and the per-class
  candidate pair sets are equal, in a scene that saturates no capacity;
- (b) carried across with lpe_tpu's tables, a tick on the reuse branch
  agrees per body at 1e-5 (pos, angle) and 1e-4 (vel, omega); and a
  rebuild tick of the port, replayed by lpe_tpu with the port's own
  tables, agrees at the same tolerances;
- (c) over 12 ticks (11 of them rebuild) positions agree within
  lpe_tpu's own response to a change of slot order: the spread of its
  trajectory when the scene's bodies are added in another order.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from lpe_tpu_torch.convert import spec_from_dict, state_from_numpy, \
    state_to_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_BODIES, SIZE, TICKS = 96, 3.0, 12
PERM_SEEDS = (0, 1, 2)
OFFS = ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1), (0, 0))
CLASSES = ("same", "E", "SW", "S", "SE", "big")


def _grid_scene(pkg, perm=None, backend="auto", circles=0):
    """test_pallas_rigid.py's scene in package ``pkg`` ("jax" or "torch"):
    four walls and 96 random convex polygons (bodies added in the order
    ``perm``), grid pipeline on. ``circles`` adds that many circle solids."""
    if pkg == "jax":
        from lpe_tpu.core import config as cm, constants as C
        from lpe_tpu.math import polygon as poly
        from lpe_tpu.scene import SceneBuilder
        fin = {}
    else:
        from lpe_tpu_torch.core import config as cm, constants as C
        from lpe_tpu_torch.math import polygon as poly
        from lpe_tpu_torch.scene import SceneBuilder
        fin = dict(device="cpu")
    cfg = cm.ScenarioSystemConfig(
        shared=cm.SharedSystemConfig(
            universe_size_m=SIZE, meters_per_pixel=SIZE / C.SCREEN_LENGTH,
            seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
            grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50),
        rigid=cm.RigidBodyConfig(
            broadphase=cm.BroadphaseConfig(max_pairs=4096,
                                           persist_slack_m=0.04),
            grid_pipeline="on", narrowphase_backend=backend))
    rng = np.random.default_rng(7)
    b = SceneBuilder("NPHASE")
    for wall in ((0.0, SIZE / 2, 0.05, SIZE / 2),
                 (SIZE, SIZE / 2, 0.05, SIZE / 2),
                 (SIZE / 2, 0.0, SIZE / 2, 0.05),
                 (SIZE / 2, SIZE, SIZE / 2, 0.05)):
        b.add_wall(*wall)
    bodies = []
    for _ in range(N_BODIES):
        sz = rng.uniform(0.05, 0.12)
        verts = poly.build_random_convex_polygon(rng, sz)
        mass = max(0.1, rng.normal(1.0, 0.1))
        bodies.append(dict(
            pos=(rng.uniform(SIZE * 0.1, SIZE * 0.9),
                 rng.uniform(SIZE * 0.1, SIZE * 0.9)),
            vel=(rng.uniform(-1, 1), rng.uniform(-1, 1)),
            mass=mass, phase=int(C.Phase.SOLID),
            shape_kind=int(C.ShapeKind.POLYGON), radius=sz, verts=verts,
            inertia=poly.calculate_polygon_inertia(verts, mass),
            omega=rng.uniform(-1, 1)))
    for i in (range(N_BODIES) if perm is None else perm):
        b.add(**bodies[i])
    for k in range(circles):
        b.add(pos=(1.0 + 0.3 * k, 1.5), mass=1.0, phase=int(C.Phase.SOLID),
              shape_kind=int(C.ShapeKind.CIRCLE), radius=0.08, inertia=0.01)
    return b.finalize(cfg, **fin)


def _np(state):
    from lpe_tpu.state import to_numpy
    return to_numpy(state)


@pytest.fixture(scope="module")
def ref():
    """lpe_tpu's runs of the scene: the state before each of the first
    TICKS ticks and after the last, the final positions of the scene with
    its bodies added in other orders, and the scene itself."""
    from lpe_tpu.systems import build_tick_fn
    sc = _grid_scene("jax")
    tick = build_tick_fn(sc.spec, sc.cfg, donate=False)
    s, states = sc.state, [_np(sc.state)]
    for _ in range(TICKS):
        s = tick(s)
        states.append(_np(s))
    perm_pos = []
    for seed in PERM_SEEDS:
        perm = np.random.default_rng(seed).permutation(N_BODIES)
        sp = _grid_scene("jax", perm=perm)
        # one spec (the tick function is specialized on it) for every order
        assert dataclasses.replace(sp.spec, name="x") == \
            dataclasses.replace(sc.spec, name="x")
        s = sp.state
        for _ in range(TICKS):
            s = tick(s)
        p = np.asarray(s.bodies.pos)[4:4 + N_BODIES]
        back = np.empty_like(p)
        back[perm] = p
        perm_pos.append(back)
    return dict(sc=sc, states=states, perm_pos=perm_pos)


@pytest.fixture(scope="module")
def port():
    """The port's scene, its tick on the CPU and its first tick's state."""
    from lpe_tpu_torch.systems import build_tick_fn
    sc = _grid_scene("torch")
    tick = build_tick_fn(sc.spec, sc.cfg, device="cpu")
    return dict(sc=sc, tick=tick, tick1=tick(sc.state))


def _rebuilt(states, t):
    """Whether lpe_tpu's tick t rebuilt its grid (anchors moved)."""
    return not np.array_equal(np.asarray(states[t + 1].bp_anchor_pos),
                              np.asarray(states[t].bp_anchor_pos))


def _sets(st, gd, S, big_idx):
    """Per-cell body-id sets and per-class candidate pair sets of a state's
    grid tables (slots mapped to body ids through rg_table)."""
    NC, KB, nbx = gd["NC"], gd["KB"], gd["nbx"]
    table = np.asarray(st.rg_table).reshape(NC, KB)
    cells = [frozenset(int(i) for i in table[c] if i < S) for c in range(NC)]
    ka, kb = np.asarray(st.rg_ka), np.asarray(st.rg_kb)
    valid = np.asarray(st.rg_valid)
    pairs, base = {}, 0
    for name, (dx, dy), cap in zip(CLASSES, OFFS, gd["caps"]):
        found = set()
        for c, r in zip(*np.nonzero(valid[:, base:base + cap])):
            a = int(table[c, ka[c, base + r]])
            if name == "big":
                b = int(big_idx[kb[c, base + r]])
            else:
                cy, cx = divmod(int(c), nbx)
                b = int(table[(cy + dy) * nbx + cx + dx, kb[c, base + r]])
            assert a < S and b < S
            found.add(frozenset((a, b)) if name == "same" else (a, b))
        pairs[name] = found
        base += cap
    return cells, pairs


def test_first_rebuild_has_lpe_tpus_cells_and_pairs(ref, port):
    from lpe_tpu.core import telemetry as jtel
    from lpe_tpu_torch.core import telemetry as ttel
    from lpe_tpu_torch.systems.rigid.grid_pipeline import grid_dims
    sc_j, sc_t = ref["sc"], port["sc"]
    # no capacity saturates, in either package's reckoning
    rep_j = jtel.capacity_report(ref["states"][0], sc_j.spec, sc_j.cfg)
    rep_t = ttel.capacity_report(sc_t.state, sc_t.spec, sc_t.cfg)
    assert rep_t == rep_j
    jtel.assert_no_saturation(rep_j)
    ttel.assert_no_saturation(rep_t)
    assert set(rep_t) == {"rigid_grid_slots", "rigid_grid_rows"}
    gd = grid_dims(sc_t.spec, sc_t.cfg)
    S, big = sc_t.spec.n_solid, sc_t.spec.solid_big_idx
    cj, pj = _sets(ref["states"][1], gd, S, big)
    ct, pt = _sets(state_to_numpy(port["tick1"]), gd, S, big)
    assert ct == cj
    assert sum(len(c) for c in ct) == N_BODIES
    assert pt == pj
    assert min(len(pt[k]) for k in ("same", "E", "SW", "S", "SE")) > 0
    # the port's own slot order: ascending body ids in every cell
    table = state_to_numpy(port["tick1"]).rg_table.reshape(gd["NC"],
                                                          gd["KB"])
    for row in table:
        ids = row[row < S]
        assert np.all(np.diff(ids) > 0)


def _assert_bodies_close(out, want, what):
    errs = {}
    for f, atol in (("pos", 1e-5), ("angle", 1e-5), ("vel", 1e-4),
                    ("omega", 1e-4)):
        a = getattr(out.bodies, f)
        b = np.asarray(getattr(want.bodies, f))
        errs[f] = float(np.abs(a - b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=f"{what}: {f}")
    return errs


def test_reuse_tick_matches_lpe_tpu(ref, port):
    """lpe_tpu's state, tables and anchors carried into the port; one tick
    in both on the reuse branch (the first tick lpe_tpu does not rebuild
    on)."""
    states = ref["states"]
    t = next(t for t in range(1, TICKS) if not _rebuilt(states, t))
    tick = port["tick"]
    step = tick.systems["rigid"]
    before = step.rebuilds
    out = state_to_numpy(tick(state_from_numpy(states[t], "cpu")))
    assert step.rebuilds == before                    # the guard held
    _assert_bodies_close(out, states[t + 1], f"tick {t + 1}")
    for f in ("rg_flat", "rg_table", "rg_ka", "rg_kb", "rg_valid",
              "bp_anchor_pos", "bp_anchor_ang"):
        np.testing.assert_array_equal(getattr(out, f),
                                      np.asarray(getattr(states[t + 1], f)))
    for f in ("rg_warm_n", "rg_warm_t", "rg_warm_pt", "rg_warm_nrm"):
        np.testing.assert_allclose(getattr(out, f),
                                   np.asarray(getattr(states[t + 1], f)),
                                   rtol=0, atol=1e-5, err_msg=f)


def test_rebuild_tick_replayed_by_lpe_tpu(ref, port):
    """The port's first tick rebuilds its grid. lpe_tpu, given the port's
    tables and anchors (so that its guard holds) and the fresh warm caches a
    rebuild starts from, replays the rigid step on its reuse branch: the two
    agree per body."""
    import jax.numpy as jnp
    from lpe_tpu.systems.rigid import make_rigid as jmake
    from lpe_tpu_torch.systems.rigid import make_rigid
    sc_j, sc_t = ref["sc"], port["sc"]
    step = make_rigid(sc_t.spec, sc_t.cfg, device="cpu")
    out = state_to_numpy(step(sc_t.state))
    assert step.rebuilds == 1
    carried = {f: jnp.asarray(getattr(out, f)) for f in (
        "rg_flat", "rg_table", "rg_ka", "rg_kb", "rg_valid", "rg_verts",
        "rg_nverts", "rg_radius", "rg_iscirc", "rg_invm", "rg_invi",
        "bp_anchor_pos", "bp_anchor_ang")}
    s0 = sc_j.state
    carried.update(rg_warm_n=jnp.zeros_like(s0.rg_warm_n),
                   rg_warm_t=jnp.zeros_like(s0.rg_warm_t),
                   rg_warm_pt=jnp.full_like(s0.rg_warm_pt, 1e30),
                   rg_warm_nrm=jnp.zeros_like(s0.rg_warm_nrm))
    want = _np(jax.jit(jmake(sc_j.spec, sc_j.cfg))(s0.replace(**carried)))
    np.testing.assert_array_equal(np.asarray(want.bp_anchor_pos),
                                  out.bp_anchor_pos)   # no rebuild there
    _assert_bodies_close(out, want, "rebuild tick")
    assert int(out.rg_valid.sum()) > 0


def test_twelve_ticks_within_lpe_tpus_slot_order_response(ref, port):
    """12 ticks from the scene. lpe_tpu's own trajectory moves by up to
    `spread` when its bodies are added in another order (the slot order of
    its rebuilds changes); the port's slot order is another such order, so
    it is held to that spread (and never looser than 2e-2). The
    ``narrowphase_backend="xla"`` tick (the plain path, not the wrapper)
    gives the bits of the default one."""
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.systems import build_run_fn, build_tick_fn
    states = ref["states"]
    want = np.asarray(states[-1].bodies.pos)[4:4 + N_BODIES]
    spread = max(float(np.abs(p - want).max()) for p in ref["perm_pos"])
    assert 2e-3 < spread < 2e-2
    sx = _grid_scene("torch", backend="xla")
    RK.reset_counters()
    tick1 = build_tick_fn(sx.spec, sx.cfg, device="cpu")(sx.state)
    for op in RK.OPS:
        assert op.plain_calls == op.launches == 0
    np.testing.assert_array_equal(tick1.bodies.pos.numpy(),
                                  port["tick1"].bodies.pos.numpy())
    sc = port["sc"]
    s = build_run_fn(sc.spec, sc.cfg, ticks=TICKS, device="cpu")(sc.state)
    assert RK.narrowphase_grid.plain_calls == TICKS
    assert RK.narrowphase_grid.launches == 0
    assert RK.narrowphase.plain_calls == RK.narrowphase.launches == 0
    got = s.bodies.pos.numpy()[4:4 + N_BODIES]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=spread)
    assert sum(_rebuilt(states, t) for t in range(TICKS)) >= TICKS - 2


@pytest.mark.parametrize("n", [1100, 10000])
def test_rigid_stacks_scene_is_lpe_tpus(n):
    """build_rigid_stacks gives lpe_tpu's spec and state bitwise, grid
    tables included; at 10000 bodies the grid has the sizes of the bench's
    rigid config (576 cells of 48 slots, 144 rows a cell)."""
    from lpe_tpu.scenarios.bench_scenes import build_rigid_stacks as jbuild
    from lpe_tpu_torch.scenarios.bench_scenes import build_rigid_stacks
    from lpe_tpu_torch.state import Bodies, SimState
    from lpe_tpu_torch.systems.rigid.grid_pipeline import grid_dims
    js, ts = jbuild(n, seed=0), build_rigid_stacks(n, seed=0, device="cpu")
    assert dataclasses.asdict(ts.spec) == dataclasses.asdict(
        spec_from_dict(dataclasses.asdict(js.spec)))
    assert ts.cfg == ts.cfg.replace() and repr(ts.cfg) == repr(js.cfg)
    jn, tn = _np(js.state), state_to_numpy(ts.state)
    for cls, a, b in ((Bodies, tn.bodies, jn.bodies), (SimState, tn, jn)):
        for f in dataclasses.fields(cls):
            if f.name == "bodies":
                continue
            u, v = getattr(a, f.name), np.asarray(getattr(b, f.name))
            assert u.dtype == v.dtype and u.shape == v.shape, f.name
            assert np.array_equal(u, v, equal_nan=True), f.name
    gd = grid_dims(ts.spec, ts.cfg)
    assert gd is not None and gd["nbig"] == 4
    if n == 10000:
        assert (gd["nbx"], gd["NC"], gd["KB"], gd["caps"], gd["R"]) == \
            (24, 576, 48, (48, 24, 16, 24, 16, 16), 144)
        assert ts.spec.n_solid == 10004 and ts.spec.max_solid_verts == 7
        assert not ts.spec.any_rigid_circle


def test_big_scene_dispatch_takes_the_kernel_wrapper():
    """Above broadphase.dense_max_solids (1024) solids the rigid system is
    the grid pipeline, and its narrowphase goes through the grid kernel's
    wrapper (``narrowphase_grid``, which reads the body grids by slot on
    the card), which takes the plain version for CPU tensors."""
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.scenarios.bench_scenes import build_rigid_stacks
    from lpe_tpu_torch.systems import build_tick_fn
    sc = build_rigid_stacks(1100, seed=0, device="cpu")
    assert sc.spec.n_solid > sc.cfg.rigid.broadphase.dense_max_solids
    tick = build_tick_fn(sc.spec, sc.cfg, device="cpu")
    step = tick.systems["rigid"]
    assert step.guard_reads == 0
    RK.reset_counters()
    s = tick(sc.state)
    assert (step.guard_reads, step.rebuilds) == (1, 1)
    assert RK.narrowphase_grid.plain_calls == 1
    assert RK.narrowphase_grid.launches == 0
    assert RK.narrowphase.plain_calls == RK.narrowphase.launches == 0
    assert int(s.rg_valid.sum()) > 0
    assert bool(torch.isfinite(s.bodies.pos).all())


def _old_row_gathers(nargs, nbx, layout):
    """The rows' shapes as the rigid tick gathered them before the grid
    narrowphase read the grids itself: per class, side A's slots selected
    from the grids, side B's from the grids rolled by the class's offset
    (or from the big bodies), then the classes concatenated. Returns the
    row-form narrowphase's arguments."""
    g_pos, g_ang, g_verts, g_nverts, b_pos, b_ang, b_verts, b_nv, ka, kb = \
        nargs
    keys = ("pos", "angle", "verts", "nverts")
    own = dict(zip(keys, (g_pos, g_ang, g_verts, g_nverts)))
    big = dict(zip(keys, (b_pos, b_ang, b_verts, b_nv)))

    def sel(grid, k):
        idx = k.long().reshape(k.shape + (1,) * (grid.dim() - 2))
        return grid.gather(1, idx.expand(k.shape + grid.shape[2:]))

    def roll(g, dx, dy):
        g2 = g.reshape((nbx, nbx) + g.shape[1:])
        return torch.roll(g2, (-dy, -dx), dims=(0, 1)).reshape(g.shape)

    sa, sb = {k: [] for k in keys}, {k: [] for k in keys}
    base = 0
    for rows, dx, dy, is_big in layout:
        a_, b_ = ka[:, base:base + rows], kb[:, base:base + rows]
        for k in keys:
            sa[k].append(sel(own[k], a_))
            sb[k].append(big[k][b_.long()] if is_big
                         else sel(roll(own[k], dx, dy), b_))
        base += rows
    return [torch.cat(side[k], 1).reshape((-1,) + own[k].shape[2:])
            for side in (sa, sb) for k in keys]


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _rigid_stacks_1100():
    from lpe_tpu_torch.scenarios.bench_scenes import build_rigid_stacks
    return build_rigid_stacks(1100, seed=0, device="cpu")


@pytest.mark.parametrize("scene", ["rigid_stacks_1100", "grid96"])
def test_grid_narrowphase_plain_equals_the_old_row_gathers(scene, port):
    """narrowphase_grid's plain version (rigid_kernels.grid_rows, then
    narrowphase_plain) gives, bit for bit, what narrowphase_plain gave on
    the rows the tick gathered by class before (rolled grids, slot
    selects, concatenation): its row inputs, its six results and the rows'
    side-A and side-B positions, on every row, valid or not."""
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.systems import build_tick_fn
    sc = _rigid_stacks_1100() if scene == "rigid_stacks_1100" else \
        port["sc"]
    step = build_tick_fn(sc.spec, sc.cfg, device="cpu").systems["rigid"]
    nargs, kw, valid = step.narrowphase_args(sc.state)
    assert valid.shape == nargs[-1].shape and int(valid.sum()) > 0
    old = _old_row_gathers(nargs, **kw)
    a, b = RK.grid_rows(*nargs, **kw)
    assert all(_same_bits(u, v) for u, v in zip((*a, *b), old))
    got = RK.narrowphase_grid_plain(*nargs, **kw)
    want = (*RK.narrowphase_plain(*old), old[0], old[4])
    assert len(got) == len(want) == 8
    assert all(_same_bits(u, v) for u, v in zip(got, want))
    assert int(got[0].sum()) > 0                    # some rows hit


def test_cpu_tick_auto_equals_xla_bit_for_bit():
    """A RIGID_STACKS 1100 tick with narrowphase_backend="auto" (the
    kernel wrapper, whose plain version runs on the CPU) and one with "xla"
    (the plain geometry path) give the same state, every field, bit for
    bit."""
    import dataclasses as dc
    from lpe_tpu_torch.systems import build_run_fn
    sc = _rigid_stacks_1100()
    assert sc.cfg.rigid.narrowphase_backend == "auto"
    xla = sc.cfg.replace(rigid=dc.replace(sc.cfg.rigid,
                                          narrowphase_backend="xla"))
    outs = [build_run_fn(sc.spec, cfg, ticks=1, device="cpu")(sc.state)
            for cfg in (sc.cfg, xla)]
    n = 0
    for u, v in ((outs[0], outs[1]), (outs[0].bodies, outs[1].bodies)):
        for f in dc.fields(u):
            x, y = getattr(u, f.name), getattr(v, f.name)
            if isinstance(x, torch.Tensor):
                assert _same_bits(x, y), f.name
                n += 1
    assert n > 20 and int(outs[0].rg_valid.sum()) > 0


def test_circle_grid_scene_is_refused():
    """The grid scene with two circle solids, which the grid pipeline once
    refused: it now takes the plain geometry path (circle SAT, then the
    list pipeline's manifolds) in place of the kernel, as lpe_tpu takes
    its XLA path. lpe_tpu's first tick (a rebuild) carried into the port,
    the next tick (the guard holds) in both agrees per body at (b)'s
    tolerances, with circles among the candidate pairs; the kernel
    wrapper is not called."""
    from lpe_tpu.systems.rigid import make_rigid as jmake
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.systems import build_tick_fn
    from lpe_tpu_torch.systems.rigid.grid_pipeline import grid_dims
    js, ts = _grid_scene("jax", circles=2), _grid_scene("torch", circles=2)
    assert ts.spec.any_rigid_circle
    jstep = jax.jit(jmake(js.spec, js.cfg))
    s1 = jstep(js.state)
    want = _np(jstep(s1))
    tick = build_tick_fn(ts.spec, ts.cfg, device="cpu")
    step = tick.systems["rigid"]
    RK.reset_counters()
    out = state_to_numpy(step(state_from_numpy(_np(s1), "cpu")))
    assert step.rebuilds == 0                         # the guard held
    assert all(op.launches == op.plain_calls == 0 for op in RK.OPS)
    _assert_bodies_close(out, want, "circle scene tick 2")
    S = ts.spec.n_solid
    circles = set(range(S - 2, S))
    _, pairs = _sets(want, grid_dims(ts.spec, ts.cfg), S,
                     ts.spec.solid_big_idx)
    assert any(circles & set(p) for c in pairs.values() for p in c)
