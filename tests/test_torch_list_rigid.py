"""The port's rigid list pipeline (lpe_tpu_torch/systems/rigid/pipeline.py,
solver.py and the GJK/EPA/circle geometry) against lpe_tpu's, on the CPU.

Inputs are made from a seed with numpy and carried across with
``lpe_tpu_torch.convert``. Tolerances:

- each stage on the same rows:
  - GJK: hits equal, simplices within 1e-5;
  - EPA: valid bits equal on the rows GJK hit; depths and normals within
    5e-4 (the JAX package's EPA-vs-SAT tolerance,
    tests/test_geometry_sat.py:76) on the pairs whose EPA converges (two
    polygons). A row GJK missed leaves a collinear simplex, whose cross
    product is 0 here and a rounding residue in lpe_tpu on the CPU (XLA
    fuses its multiply-subtract), so EPA's "degenerate" test differs
    there; such a row never makes a contact (the pipeline ANDs EPA's bit
    with the hit);
  - SAT with circles: hits equal, depths within 1e-5, normals within 1e-5
    on polygon pairs and 1e-4 where a circle takes part (the
    circle-polygon closed form divides by the centre's distance to the
    boundary, which magnifies the centre's rounding);
  - the manifolds at C = 2 and 3: contact masks equal, points and depths
    within 1e-5;
  - the dense broadphase's pairs equal, in lpe_tpu's order; the grid
    broadphase's pair set equal (lpe_tpu sorts a cell's bodies
    unstably);
  - the warm-start hash equal on ids up to 2^20;
  - the solvers' velocities and positions within 1e-5 on the same rows;
- whole scenes over 3 ticks through ``build_run_fn``: per body pos 1e-5,
  angle 1e-5, vel and omega 1e-4 (tests/test_torch_grid_rigid.py);
- two-way coupling into dynamic rigids (the coupled dam, 2000 particles
  and 8 pentagons, carried across 10 ticks into its spill, one tick): the
  fluid at tests/test_torch_fluid_slice.py's tolerances (positions 1e-5,
  velocities 3e-3, density rtol 1e-4), the rigids' positions within
  1e-5, and their velocity, spin and angle changes within 2e-3 of
  lpe_tpu's change plus 1e-5 (that file's tolerance for a light polygon
  pushed by the fluid: its forces are sums over many particles, which the
  two packages associate differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpe_tpu_torch.convert import spec_from_dict, state_from_numpy, \
    state_to_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

V, N = 8, 257


def _rows(seed, spread):
    """N random rows of convex CCW polygons of 3..V vertices, 30% of them
    circles (no vertices), at random positions and angles."""
    rng = np.random.default_rng(seed)
    nv = rng.integers(3, V + 1, N)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (N, V)), axis=1)
    rad = rng.uniform(0.2, 0.6, (N, V))
    circ = rng.uniform(size=N) < 0.3
    nv = np.where(circ, 0, nv).astype(np.int32)
    vm = np.arange(V)[None, :] < nv[:, None]
    verts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    verts = np.where(vm[..., None], verts, 0.0)
    return dict(pos=rng.uniform(-spread, spread, (N, 2)).astype(np.float32),
                angle=rng.uniform(0, 2 * np.pi, N).astype(np.float32),
                verts=verts.astype(np.float32), nverts=nv, vmask=vm,
                is_circle=circ,
                radius=rng.uniform(0.2, 0.6, N).astype(np.float32))


def _jax(s):
    return {k: jnp.asarray(v) for k, v in s.items()}


def _torch(s):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in s.items()}


@pytest.fixture(scope="module")
def ref():
    """lpe_tpu's geometry stages on the rows (compiled once)."""
    from lpe_tpu.systems.rigid import geometry as jgeo
    from lpe_tpu.systems.rigid.pipeline import _pair_contacts as jpc
    sa, sb = _rows(1, 0.5), _rows(2, 0.5)
    ja, jb = _jax(sa), _jax(sb)
    gjk = jax.jit(jax.vmap(lambda a, b: jgeo.gjk(a, b)))
    epa = jax.jit(jax.vmap(lambda a, b, s: jgeo.epa(a, b, s)))
    sat = jax.jit(jax.vmap(lambda a, b: jgeo.sat_contact(a, b, True)))
    hit, simplex = gjk(ja, jb)
    out = dict(sa=sa, sb=sb, gjk=(hit, simplex),
               epa=epa(ja, jb, simplex), sat=sat(ja, jb))
    n = out["sat"][1]
    for C in (2, 3):
        out["pc", C] = jax.jit(jax.vmap(
            lambda a, b, n_, p_, C=C: jpc(a, b, n_, p_, C)))(
                ja, jb, n, out["sat"][2])
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                else v) for k, v in out.items()}


def test_gjk_matches_lpe_tpu(ref):
    from lpe_tpu_torch.systems.rigid import geometry as geo
    hit, simplex = geo.gjk(_torch(ref["sa"]), _torch(ref["sb"]))
    jhit, jsimplex = ref["gjk"]
    np.testing.assert_array_equal(hit.numpy(), jhit)
    assert jhit.any() and (~jhit).any()
    np.testing.assert_allclose(simplex.numpy(), jsimplex, rtol=0, atol=1e-5)


def test_epa_matches_lpe_tpu(ref):
    from lpe_tpu_torch.systems.rigid import geometry as geo
    jhit, jsimplex = ref["gjk"]
    valid, nrm, pen = geo.epa(_torch(ref["sa"]), _torch(ref["sb"]),
                              torch.from_numpy(jsimplex.copy()))
    jvalid, jnrm, jpen = ref["epa"]
    np.testing.assert_array_equal(valid.numpy()[jhit], jvalid[jhit])
    # two polygons: EPA converges to a face of the Minkowski difference
    polys = jhit & jvalid & ~ref["sa"]["is_circle"] & ~ref["sb"]["is_circle"]
    assert polys.sum() > 20
    np.testing.assert_allclose(pen.numpy()[polys], jpen[polys], rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(nrm.numpy()[polys], jnrm[polys], rtol=0,
                               atol=5e-4)


def test_sat_contact_with_circles_matches_lpe_tpu(ref):
    from lpe_tpu_torch.systems.rigid import geometry as geo
    hit, nrm, pen = geo.sat_contact(_torch(ref["sa"]), _torch(ref["sb"]),
                                    any_circle=True)
    jhit, jnrm, jpen = ref["sat"]
    np.testing.assert_array_equal(hit.numpy(), jhit)
    cir = ref["sa"]["is_circle"] | ref["sb"]["is_circle"]
    assert (jhit & cir).sum() > 20 and (jhit & ~cir).sum() > 20
    for rows, atol in ((jhit & ~cir, 1e-5), (jhit & cir, 1e-4)):
        np.testing.assert_allclose(nrm.numpy()[rows], jnrm[rows], rtol=0,
                                   atol=atol)
    np.testing.assert_allclose(pen.numpy(), jpen, rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [2, 3])
def test_pair_contacts_matches_lpe_tpu(ref, C):
    from lpe_tpu_torch.systems.rigid.pipeline import _pair_contacts
    _, jnrm, jpen = ref["sat"]
    pts, pens, valid = _pair_contacts(
        _torch(ref["sa"]), _torch(ref["sb"]), torch.from_numpy(jnrm),
        torch.from_numpy(jpen), C)
    jpts, jpens, jvalid = ref["pc", C]
    assert pts.shape == (N, C, 2)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    v = jvalid & ref["sat"][0][:, None]
    assert v[:, 0].sum() > 50 and v[:, 1].any()
    np.testing.assert_allclose(pts.numpy()[v], jpts[v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(pens.numpy()[v], jpens[v], rtol=0, atol=1e-5)


def test_warm_hash_matches_lpe_tpu():
    """lpe_tpu's int32 hash (pipeline.py:382-386) wraps on multiply; the
    port's takes the low 32 bits in int64: equal on ids up to 2^20 and on
    the -1 of an empty slot."""
    from lpe_tpu_torch.systems.rigid.pipeline import warm_hash
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.integers(-1, 1 << 20, 20000), [-1, 0, 1 << 20]])
    b = np.concatenate([rng.integers(-1, 1 << 20, 20000), [-1, 0, 1 << 20]])
    a, b = a.astype(np.int32), b.astype(np.int32)
    for H in (16, 1 << 14, 1 << 20):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        want = ((ja * jnp.int32(-1640531535) ^ jb) * jnp.int32(40503)) & \
            jnp.int32(H - 1)
        got = warm_hash(torch.from_numpy(a), torch.from_numpy(b), H)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _solver_rows(seed, S=40, R=300):
    """Random contact rows among S bodies: ids with ia < ib, unit-ish
    normals, points near the bodies, a validity mask, warm impulses;
    bodies 0-3 have infinite mass (walls)."""
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, S - 1, R)
    ib = np.minimum(ia + rng.integers(1, 6, R), S - 1)
    pos = rng.uniform(0, 3, (S, 2))
    f = np.float32
    n = rng.normal(size=(R, 2))
    return dict(
        pos=pos.astype(f), vel=rng.normal(size=(S, 2)).astype(f),
        omega=rng.normal(size=S).astype(f),
        angle=rng.uniform(0, 6, S).astype(f),
        inv_m=np.where(np.arange(S) < 4, 0, rng.uniform(0.5, 2, S)).astype(f),
        inv_i=np.where(np.arange(S) < 4, 0, rng.uniform(1, 50, S)).astype(f),
        ia=ia.astype(np.int32), ib=ib.astype(np.int32),
        n=(n * rng.uniform(0.5, 2, (R, 1))).astype(f),
        pt=(pos[ia] + rng.normal(scale=0.1, size=(R, 2))).astype(f),
        pen=rng.uniform(0, 0.02, R).astype(f),
        valid=rng.uniform(size=R) < 0.8,
        ln0=rng.uniform(0, 0.5, R).astype(f),
        lt0=rng.uniform(-0.1, 0.1, R).astype(f))


@pytest.mark.parametrize("stages", [(1, 0), (3, 0), (3, 1)])
def test_solvers_match_lpe_tpu(stages):
    """solve_velocity and solve_position on the same rows, at the default
    stages=1, and staged (3 segments) with and without the synchronous
    friction update."""
    from lpe_tpu.core import config as jcfg
    from lpe_tpu.systems.rigid import solver as jsolver
    from lpe_tpu_torch.core import config as tcfg
    from lpe_tpu_torch.systems.rigid import solver
    r = _solver_rows(3)
    nb, fs = stages
    cfgs = [(m.ContactSolverConfig(stages=nb, friction_stages=fs),
             m.PositionSolverConfig(stages=nb)) for m in (jcfg, tcfg)]
    J, T = ({k: jnp.asarray(v) for k, v in r.items()},
            {k: torch.from_numpy(v) for k, v in r.items()})
    vel_args = ("pos", "vel", "omega", "inv_m", "inv_i", "ia", "ib", "n",
                "pt", "valid", "ln0", "lt0")
    pos_args = ("pos", "angle", "inv_m", "inv_i", "ia", "ib", "n", "pt",
                "pen", "valid")
    want = jax.jit(lambda *a: jsolver.solve_velocity(*a, cfgs[0][0]))(
        *(J[k] for k in vel_args))
    got = solver.solve_velocity(*(T[k] for k in vel_args), cfgs[1][0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    assert np.abs(np.asarray(want[0]) - r["vel"]).max() > 0.1
    want = jax.jit(lambda *a: jsolver.solve_position(*a, cfgs[0][1]))(
        *(J[k] for k in pos_args))
    got = solver.solve_position(*(T[k] for k in pos_args), cfgs[1][1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    assert np.abs(np.asarray(want[0]) - r["pos"]).max() > 1e-4


def _port(sc):
    from test_torch_fluid_slice import port_cfg
    from lpe_tpu.state import to_numpy
    return (spec_from_dict(dataclasses.asdict(sc.spec)), port_cfg(sc.cfg),
            state_from_numpy(to_numpy(sc.state), "cpu"))


def _random_polygons(n=30, **kw):
    from lpe_tpu.scenarios.random_polygons import RandomPolygonsConfig, build
    return build(seed=0, ec=RandomPolygonsConfig(particle_count=n, **kw))


def _with_broadphase(sc, **kw):
    bp = dataclasses.replace(sc.cfg.rigid.broadphase, **kw)
    rigid = dataclasses.replace(sc.cfg.rigid, broadphase=bp,
                                grid_pipeline="off")
    return dataclasses.replace(sc, cfg=sc.cfg.replace(rigid=rigid))


def _one_step(sc):
    """One rigid step of each package from the scene's state."""
    from lpe_tpu.state import to_numpy
    from lpe_tpu.systems.rigid import make_rigid as jmake
    from lpe_tpu_torch.systems.rigid import make_rigid
    spec, cfg, state = _port(sc)
    return (to_numpy(jax.jit(jmake(sc.spec, sc.cfg))(sc.state)),
            state_to_numpy(make_rigid(spec, cfg, device="cpu")(state)))


def test_dense_broadphase_pairs_in_lpe_tpus_order():
    """RANDOM_POLYGONS (104 solids, the dense matrix): the candidate pairs a
    step stores for the warm start are lpe_tpu's, in its order."""
    from lpe_tpu.scenarios import create_scenario
    want, got = _one_step(create_scenario("RANDOM_POLYGONS", seed=0))
    for f in ("warm_ia", "warm_ib"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)))
    assert (got.warm_ia >= 0).sum() >= 10


def test_grid_broadphase_pair_sets_match_lpe_tpu():
    """The list pipeline's uniform-grid broadphase (RANDOM_POLYGONS 60,
    dense_max_solids 16 so that it runs): the same candidate pair set as
    lpe_tpu's, whose unstable sort may order a cell's bodies otherwise."""
    sc = _with_broadphase(_random_polygons(60), dense_max_solids=16)
    want, got = _one_step(sc)

    def pairs(s):
        ia, ib = np.asarray(s.warm_ia), np.asarray(s.warm_ib)
        return {(int(a), int(b)) for a, b in zip(ia, ib) if a >= 0}
    assert pairs(got) == pairs(want)
    assert len(pairs(want)) >= 10


def _ticks_both(sc, ticks, fluid=False):
    """``ticks`` ticks of the scene through each package's build_run_fn
    (lpe_tpu's fluid on its resident XLA path)."""
    from lpe_tpu.state import to_numpy
    from lpe_tpu.systems import build_run_fn as jrun
    from lpe_tpu_torch.systems import build_run_fn
    from test_torch_fluid_slice import xla_resident
    spec, cfg, state = _port(sc)
    run = build_run_fn(spec, cfg, ticks=ticks, device="cpu")
    jcfg = xla_resident(sc.cfg) if fluid else sc.cfg
    want = to_numpy(jrun(sc.spec, jcfg, ticks=ticks, donate=False)(
        sc.state))
    return want, state_to_numpy(run(state)), run


def _assert_solids_close(got, want, S):
    for f, atol in (("pos", 1e-5), ("angle", 1e-5), ("vel", 1e-4),
                    ("omega", 1e-4)):
        np.testing.assert_allclose(getattr(got.bodies, f)[:S],
                                   np.asarray(getattr(want.bodies, f))[:S],
                                   rtol=0, atol=atol, err_msg=f)


@pytest.mark.parametrize("scene", ["polygons", "circles_and_polygons",
                                   "polygons_slack"])
def test_list_pipeline_ticks_match_lpe_tpu(scene):
    """3 ticks of RANDOM_POLYGONS cut to 30 bodies through its config:
    polygons; 40% circles; and with the persistence guard
    (persist_slack_m 0.04), whose host read the port counts."""
    sc = _random_polygons(
        30, **({"circles_fraction": 0.4} if scene.startswith("circ") else {}))
    if scene.endswith("slack"):
        sc = _with_broadphase(sc, persist_slack_m=0.04)
    want, got, run = _ticks_both(sc, 3)
    S = sc.spec.n_solid
    _assert_solids_close(got, want, S)
    moved = np.abs(np.asarray(want.bodies.vel)[:S]
                   - np.asarray(sc.state.bodies.vel)[:S]).max()
    assert moved > 0.1
    assert (np.asarray(want.warm_ia) >= 0).sum() > 0
    step = run.systems["rigid"]
    assert step.guard_reads == (3 if scene.endswith("slack") else 0)
    if scene.endswith("slack"):
        np.testing.assert_array_equal(got.bp_ia, np.asarray(want.bp_ia))


def test_galton_board_ticks_match_lpe_tpu():
    """GALTON_BOARD (circle balls on circle pegs between polygon walls),
    3 ticks: the circle-circle closed form and the circle-polygon
    manifolds of a whole scene."""
    from lpe_tpu.scenarios import create_scenario
    sc = create_scenario("GALTON_BOARD", seed=0)
    want, got, _ = _ticks_both(sc, 3)
    _assert_solids_close(got, want, sc.spec.n_solid)
    assert (np.asarray(want.warm_ia) >= 0).sum() > 50


def test_coupled_dam_two_way_coupling_matches_lpe_tpu():
    """The coupled dam (2000 particles, 8 pentagons) carried across after
    10 ticks of lpe_tpu, when its spill has reached the pentagons; one
    tick in each package. The fluid pushes the dynamic rigids (their
    velocities leave free fall) and the port agrees on both sides."""
    from lpe_tpu.scenarios.bench_scenes import build_coupled_dam
    from lpe_tpu.systems import build_run_fn as jrun
    from test_torch_fluid_slice import xla_resident
    sc = build_coupled_dam(2000, 8)
    s10 = jrun(sc.spec, xla_resident(sc.cfg), ticks=10, donate=False)(
        sc.state)
    sc10 = dataclasses.replace(sc, state=s10)
    want, got, run = _ticks_both(sc10, 1, fluid=True)
    spec = sc.spec
    cells, dynamic = run.systems["fluid"].coupled_cells(
        state_from_numpy(jax.tree.map(np.asarray, s10), "cpu"))
    assert dynamic > 10 and cells > dynamic
    old = s10.bodies
    liq = spec.liquid_slice
    np.testing.assert_allclose(got.bodies.pos[liq],
                               np.asarray(want.bodies.pos)[liq], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.bodies.vel[liq],
                               np.asarray(want.bodies.vel)[liq], rtol=0,
                               atol=3e-3)
    np.testing.assert_allclose(got.bodies.density[liq],
                               np.asarray(want.bodies.density)[liq],
                               rtol=1e-4)
    S = spec.n_solid
    dyn = ~np.asarray(old.boundary)[:S]
    np.testing.assert_allclose(got.bodies.pos[:S],
                               np.asarray(want.bodies.pos)[:S], rtol=0,
                               atol=1e-5)
    for f in ("vel", "omega", "angle"):
        o = np.asarray(getattr(old, f))[:S]
        np.testing.assert_allclose(
            getattr(got.bodies, f)[:S] - o,
            np.asarray(getattr(want.bodies, f))[:S] - o, rtol=2e-3,
            atol=1e-5, err_msg=f)
    # the pentagons left free fall: gravity alone adds g * dt to vy
    dv = np.asarray(want.bodies.vel)[:S][dyn] - np.asarray(old.vel)[:S][dyn]
    g_dt = sc.cfg.gravity.gravitational_acceleration * \
        sc.cfg.shared.seconds_per_tick
    assert np.abs(dv - np.array([0.0, g_dt])).max() > 0.05
