"""The port's split-kernel fluid tick (``pair_backend="pallas"``: density,
force and coupling kernels, their plain PyTorch versions on the CPU) and
its per-tick scatter step (``residency="off"``) against lpe_tpu run with
the same ``residency`` and ``pair_backend`` (its Pallas kernels in
interpret mode, as tests/test_sph.py runs them), over 2 ticks on
test_sph.py's scenes carried across with convert.py: the blob, the walled
blob, the rigid-dense band and the wall whose top face lies mid-row; and,
resident, on test_torch_fluid_slice.py's blob with three polygons, whose
wall rides the big-solid table (the NBIG branch of the coupling kernel).
None of them fills a cell's K slots (checked), so every particle compares.

Tolerances, per particle: positions atol 1e-5, densities rtol 1e-5, rigid
velocity and spin atol 1e-5 (those of test_sph.py's Pallas-vs-XLA tests of
these scenes), and velocities atol 3e-4 where test_sph.py has 1e-4. On the
CPU lpe_tpu's two backends are equal to the bit on these scenes (within
1.9e-6 m/s on the mid-row wall scene below), so its 1e-4 is never used up
there; the port sums a particle's pairs slot by slot
and calls PyTorch's tanh and pow, and these scenes are stiff (blobs at
random positions, |v| up to 17-21 m/s after 2 ticks): the port's largest
velocity gaps are 1.63e-4 (blob), 1.93e-4 (walled blob) and 1.49e-4 m/s
(dense band), while lpe_tpu's own response to one float32 ulp on every
initial liquid position (four seeded patterns, 2 ticks) is 7.2e-4 to
5.5e-3 m/s on the blobs and 1.1e-2 to 0.15 m/s on the band.

The mid-row wall scene starts with particles inside the wall and reaches
35 m/s: one sub-step agrees to 1.2e-7 m and 7.6e-6 m/s, a second one
already shows 4.4e-3 m/s. It is held at the tolerances above over a tick of
one sub-step, and over the 2 ticks of 10 sub-steps to pos 2e-4, vel 3e-2,
density 5e-4, inside lpe_tpu's own one-ulp response there (5.7e-5 to
1.07e-3 m, 2.2e-2 to 0.173 m/s, 3.2e-4 to 3.0e-3); the port's gaps are
5.9e-5 m, 8.0e-3 m/s and 1.4e-4.

Run as a script, this file prints the measurements quoted above (the
port's gaps and lpe_tpu's one-ulp responses, per scene and residency):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fluid_split.py
"""
import dataclasses

import numpy as np
import pytest

from lpe_tpu_torch.core.telemetry import (assert_no_saturation,
                                          capacity_report)
from test_torch_fluid_slice import assert_fluid_close, blob_scene, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _scenes():
    import test_sph as T
    return {
        "blob": lambda: T._blob_scene(n=60, vmax=0.3),
        "walled_blob": lambda: T._blob_scene(n=50, vmax=0.4, walls=True,
                                             seed=5),
        "dense_band": T._dense_band_scene,
        "mid_row_wall": T._wall_contact_scene,
        "wall_polygons": lambda: blob_scene(n=60, seed=3, polygons=True),
    }


SCENES = ("blob", "walled_blob", "dense_band", "mid_row_wall")
CASES = [(n, r) for n in SCENES for r in ("on", "off")] \
    + [("wall_polygons", "on")]


def with_fluid(cfg, **kw):
    return cfg.replace(fluid=dataclasses.replace(cfg.fluid, **kw))


def run_jax(sc, ticks=2, **kw):
    import jax
    from lpe_tpu.state import to_numpy
    from lpe_tpu.systems.fluid import make_fluid
    step = jax.jit(make_fluid(sc.spec, with_fluid(sc.cfg, **kw)))
    s = sc.state
    for _ in range(ticks):
        s = step(s)
    return to_numpy(s)


def run_port(sc, ticks=2, **kw):
    from lpe_tpu_torch.systems.fluid import make_fluid
    spec, cfg, state = to_port(sc)
    assert_no_saturation(capacity_report(state, spec, cfg))
    step = make_fluid(spec, with_fluid(cfg, **kw), device="cpu")
    for _ in range(ticks):
        state = step(state)
    return state


def liquid(state, spec):
    liq, b = spec.liquid_slice, state.bodies
    return (np.asarray(b.pos)[liq], np.asarray(b.vel)[liq],
            np.asarray(b.density)[liq])


STIFF = dict(pos=2e-4, vel=3e-2, rho=5e-4)    # mid_row_wall, 2 ticks


def assert_bodies_close(spec, got, want, pos=1e-5, vel=3e-4, rho=1e-5):
    (pg, vg, rg), (pw, vw, rw) = liquid(got, spec), liquid(want, spec)
    assert np.isfinite(pg).all()
    np.testing.assert_allclose(pg, pw, rtol=0, atol=pos)
    np.testing.assert_allclose(vg, vw, rtol=0, atol=vel)
    np.testing.assert_allclose(rg, rw, rtol=rho)
    ns = spec.liquid_start
    for f in ("vel", "omega"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.bodies, f))[:ns],
            np.asarray(getattr(want.bodies, f))[:ns], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def scenes():
    made = {}
    make = _scenes()

    def get(name):
        if name not in made:
            made[name] = make[name]()
        return made[name]

    return get


@pytest.mark.parametrize("name,residency", CASES)
def test_split_tick_matches_lpe_tpu(scenes, name, residency):
    sc = scenes(name)
    if name == "wall_polygons":
        assert sc.spec.solid_big_idx == (0,)
    kw = dict(residency=residency, pair_backend="pallas")
    want = run_jax(sc, **kw)
    got = run_port(sc, **kw)
    if name == "wall_polygons":
        # the tolerances this scene has against the stacked path there
        # (velocity atol 3e-3, a light polygon's velocity change to rtol
        # 2e-3); here the largest velocity gap is 7.6e-4 m/s
        assert_fluid_close(sc.spec, want, got, sc.state)
    else:
        assert_bodies_close(sc.spec, got, want,
                            **(STIFF if name == "mid_row_wall" else {}))
    p0 = np.asarray(sc.state.bodies.pos)[sc.spec.liquid_slice]
    assert np.abs(liquid(got, sc.spec)[0] - p0).max() > 1e-3
    if name == "dense_band":
        # the band's polygons felt the fluid, every one that lpe_tpu moved
        ns = sc.spec.n_solid
        dv = np.abs(np.asarray(want.bodies.vel)[:ns]
                    - np.asarray(sc.state.bodies.vel)[:ns]).max(1)
        assert (dv > 1e-6).sum() > 10
    if name == "mid_row_wall":
        # the wall pushed the particles that started inside it up and out
        y0 = p0[:, 1]
        pushed = liquid(got, sc.spec)[0][:, 1] - y0
        assert (pushed[y0 < 0.425] > 1e-4).any()


@pytest.mark.parametrize("residency", ["on", "off"])
def test_mid_row_wall_one_sub_step(scenes, residency):
    """The wall's mid-row top face couples (the candidate window reaches
    it), held over a tick of one sub-step, before the scene's stiffness
    amplifies rounding."""
    sc = scenes("mid_row_wall")
    kw = dict(residency=residency, pair_backend="pallas", num_sub_steps=1)
    want = run_jax(sc, ticks=1, **kw)
    got = run_port(sc, ticks=1, **kw)
    assert_bodies_close(sc.spec, got, want, vel=1e-4)
    liq = sc.spec.liquid_slice
    y0 = np.asarray(sc.state.bodies.pos)[liq, 1]
    dt = sc.cfg.shared.seconds_per_tick
    drift = y0 + np.asarray(sc.state.bodies.vel)[liq, 1] * dt
    pushed = liquid(got, sc.spec)[0][:, 1] - drift
    assert (pushed[y0 < 0.425] > 1e-4).any()


def test_scatter_sweep_matches_lpe_tpu(scenes):
    """``residency="off"`` with the pair sweep on the scatter path's planes
    (lpe_tpu's F=6 use of the sweep kernel), at the limits of
    test_pallas_sweep_matches_xla_scatter."""
    import test_sph as T
    sc = T._blob_scene(n=40, vmax=0.5, seed=11)
    kw = dict(residency="off", pair_backend="sweep")
    assert_bodies_close(sc.spec, run_port(sc, **kw), run_jax(sc, **kw),
                        pos=1e-6, vel=1e-5, rho=1e-5)


@pytest.mark.parametrize("name", ["walled_blob", "dense_band"])
def test_split_resident_matches_stacked_resident(scenes, name):
    """Inside the port: the split sub-step against the stacked chain."""
    sc = scenes(name)
    a = run_port(sc, residency="on", pair_backend="pallas")
    b = run_port(sc, residency="on", pair_backend="sweep")
    assert_bodies_close(sc.spec, a, b, pos=1e-5, vel=1e-5, rho=1e-5)


@pytest.mark.parametrize("backend", ["pallas", "sweep"])
def test_scatter_matches_resident(scenes, backend):
    """Inside the port: the scatter step against the resident tick, at
    test_resident_matches_scatter_mode's limits (a fresh grid each
    sub-step orders a cell's slots anew, so pair sums reassociate)."""
    sc = scenes("walled_blob")
    a = run_port(sc, residency="off", pair_backend=backend)
    b = run_port(sc, residency="on", pair_backend=backend)
    assert_bodies_close(sc.spec, a, b, pos=1e-4, vel=1e-3, rho=1e-3)


def test_scatter_particles_without_a_slot_and_a_dead_rigid():
    """A particle off the grid gets no slot: it takes the self density
    m*poly6*h^6, feels no pair force and moves ballistically, and its
    neighbour in the grid's edge cell does not see it. A particle inside
    an inactive wall is not coupled. The rest of the blob goes on as
    lpe_tpu's."""
    import jax.numpy as jnp
    import test_sph as T
    from lpe_tpu_torch.systems.fluid.sph import poly6_coeff_2d
    sc = T._blob_scene(n=30, vmax=0.3, seed=7, walls=True)
    liq = sc.spec.liquid_slice
    b = sc.state.bodies
    pos, vel = np.asarray(b.pos).copy(), np.asarray(b.vel).copy()
    active = np.asarray(b.active).copy()
    assert sc.spec.liquid_start == 1 and active[0]
    active[0] = False                # the wall: x 0..1.5, y 0.01..0.09
    off, edge, dead = liq.start + 3, liq.start + 4, liq.start + 5
    pos[off] = (1.62, 0.7)           # the grid ends at x = 1.6
    pos[edge] = (1.58, 0.7)          # 0.04 < h away, in the edge cell
    pos[dead] = (0.75, 0.05)         # inside the inactive wall
    alone = [off, edge, dead]
    vel[alone] = ((0.25, -0.5), (0.0, 0.1), (0.1, 0.2))
    sc = dataclasses.replace(sc, state=sc.state.replace(bodies=b.replace(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel),
        active=jnp.asarray(active))))
    kw = dict(residency="off", pair_backend="pallas")
    want = run_jax(sc, ticks=1, **kw)
    got = run_port(sc, ticks=1, **kw)
    assert_bodies_close(sc.spec, got, want)
    h = sc.cfg.fluid.grid.smoothing_length
    dt = sc.cfg.shared.seconds_per_tick * sc.cfg.shared.time_acceleration
    gb = got.bodies
    np.testing.assert_allclose(gb.density.numpy()[alone],
                               0.005 * poly6_coeff_2d(h) * h ** 6, rtol=1e-6)
    np.testing.assert_allclose(gb.vel.numpy()[alone], vel[alone], atol=0)
    np.testing.assert_allclose(gb.pos.numpy()[alone],
                               pos[alone] + vel[alone] * dt, atol=1e-6)


def test_default_configuration_is_the_stacked_resident_path():
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_run_fn
    from lpe_tpu_torch.systems.fluid import make_fluid
    sc = build_dam_break(400, device="cpu")
    assert (sc.cfg.fluid.residency, sc.cfg.fluid.pair_backend) == \
        ("auto", "auto")
    n = sc.cfg.fluid.num_sub_steps

    def calls(**kw):
        cfg = with_fluid(sc.cfg, **kw)
        fl = make_fluid(sc.spec, cfg, device="cpu")
        SK.reset_counters()
        s = build_run_fn(sc.spec, cfg, ticks=1, device="cpu")(sc.state)
        assert int(s.tick) == 1
        return (hasattr(fl, "grid_build"),
                {op.name: op.plain_calls for op in SK.OPS})

    zero = dict.fromkeys(("migrate", "pair_sweep", "coupling9", "density",
                          "force", "coupling"), 0)
    assert calls() == (True, dict(zero, migrate=n, pair_sweep=n,
                                  coupling9=n))
    assert calls(pair_backend="pallas") == (
        True, dict(zero, migrate=n, density=n, force=n, coupling=n))
    assert calls(residency="off") == (False, dict(zero, pair_sweep=n))
    assert calls(residency="off", pair_backend="pallas") == (
        False, dict(zero, density=n, force=n))
    SK.reset_counters()


def _gaps(spec, a, b):
    """Largest liquid |dpos|, |dvel| and relative density gap, and largest
    rigid |dvel| and |domega|, between two states."""
    (pa, va, ra), (pb, vb, rb) = liquid(a, spec), liquid(b, spec)
    ns = spec.liquid_start
    rigid = [float(np.abs(np.asarray(getattr(a.bodies, f))[:ns]
                          - np.asarray(getattr(b.bodies, f))[:ns]).max())
             if ns else 0.0 for f in ("vel", "omega")]
    return [float(np.abs(pa - pb).max()), float(np.abs(va - vb).max()),
            float((np.abs(ra - rb) / np.abs(rb)).max()), *rigid]


def measure(seeds=4):
    """Print the port's gaps from lpe_tpu after 2 ticks, and the range of
    lpe_tpu's own response to one float32 ulp on every initial liquid
    position (lpe_tpu's xla backend, equal to its pallas one to the bit on
    the CPU, which the first column shows)."""
    import torch
    from test_torch_fluid_slice import nudged
    torch.set_num_threads(1)
    fmt = lambda g: " ".join(f"{v:.3g}" for v in g)
    print("columns: |dpos| m, |dvel| m/s, rho rel, rigid |dvel|, |domega|")
    for name, make in _scenes().items():
        sc = make()
        liq = sc.spec.liquid_slice
        for res in ("on", "off"):
            kw = dict(residency=res, pair_backend="pallas")
            want = run_jax(sc, **kw)
            xla = run_jax(sc, residency=res, pair_backend="xla")
            vmax = float(np.abs(liquid(want, sc.spec)[1]).max())
            print(f"{name} {res}: max |v| {vmax:.3g}; lpe_tpu pallas vs xla "
                  f"[{fmt(_gaps(sc.spec, want, xla))}]; port vs lpe_tpu "
                  f"[{fmt(_gaps(sc.spec, run_port(sc, **kw), want))}]",
                  flush=True)
            resp = np.array([_gaps(sc.spec, run_jax(
                dataclasses.replace(sc, state=nudged(sc.state, liq, seed)),
                residency=res, pair_backend="xla"), xla)
                for seed in range(seeds)])
            print(f"{name} {res}: lpe_tpu's one-ulp response over {seeds} "
                  f"seeds: least [{fmt(resp.min(0))}], most "
                  f"[{fmt(resp.max(0))}]", flush=True)
    sc = _scenes()["mid_row_wall"]()
    for nsub in (1, 2):
        kw = dict(residency="off", pair_backend="pallas", num_sub_steps=nsub)
        g = _gaps(sc.spec, run_port(sc, ticks=1, **kw),
                  run_jax(sc, ticks=1, **kw))
        print(f"mid_row_wall off, one tick of {nsub} sub-step(s): port vs "
              f"lpe_tpu [{fmt(g)}]", flush=True)


if __name__ == "__main__":
    measure()
