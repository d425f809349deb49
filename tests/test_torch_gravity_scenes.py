"""The three scenes N-body gravity opens, carried across ticks by the port
(``build_run_fn`` on the CPU) and by lpe_tpu from the same seed:
KEPLERIAN_DISK (the direct sum), PLANETARY_OCEAN (the resident fluid
without the cross-tick grid, the list pipeline with two circles, the
direct sum) and ``build_galaxy(2000)`` forced onto the P3M branch.

Tolerances: positions and velocities within 1e-6 of the scene's largest
|pos| and |vel| (about 8 float32 ulps; observed 1 ulp or less: 256 m of
5.4e9 m and 16 m/s of 2.6e8 m/s in the disk and the galaxy, 0 m and
9.8e-4 m/s of 9.1e3 m/s in the ocean); the ocean's density at the JAX
package's fluid tolerance, rtol 1e-4 (observed 2.4e-7). lpe_tpu's ocean
runs its resident XLA fluid path (``residency="on", pair_backend="xla"``),
the port its default, as ``tests/test_torch_fluid_slice.py`` holds them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from lpe_tpu_torch.convert import state_to_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _jax_ticks(sc, cfg, n):
    from lpe_tpu.systems import build_tick_fn
    tick = build_tick_fn(sc.spec, cfg, donate=False)
    s = sc.state
    for _ in range(n):
        s = tick(s)
    return jax.block_until_ready(s)


def _assert_carried(js, ts, liquid=None):
    """Every active body's position and velocity within 1e-6 of the
    scene's largest; the liquid's density within rtol 1e-4."""
    b = state_to_numpy(ts).bodies
    act = b.active
    for f in ("pos", "vel"):
        want = np.asarray(getattr(js.bodies, f))[act]
        got = getattr(b, f)[act]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), f
    if liquid is not None:
        np.testing.assert_allclose(
            b.density[liquid], np.asarray(js.bodies.density)[liquid],
            rtol=1e-4)


def _with_bh(cfg, **kw):
    return cfg.replace(barnes_hut=dataclasses.replace(cfg.barnes_hut, **kw))


def test_keplerian_disk_carried_10_ticks():
    from lpe_tpu.scenarios import create_scenario as jcreate
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems import build_run_fn
    js = jcreate("KEPLERIAN_DISK", seed=0)
    ts = create_scenario("KEPLERIAN_DISK", seed=0, device="cpu")
    run = build_run_fn(ts.spec, ts.cfg, ticks=10, device="cpu")
    assert list(run.systems) == ["boundary", "barnes_hut", "rotation",
                                 "movement", "sleep"]
    assert run.systems["barnes_hut"].pp is None        # the direct sum
    s = run(ts.state)
    assert int(s.tick) == 10
    _assert_carried(_jax_ticks(js, js.cfg, 10), s)


def _oceans():
    from lpe_tpu.scenarios import create_scenario as jcreate
    from lpe_tpu.scenarios.planetary_ocean import PlanetaryOceanConfig as JC
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.scenarios.planetary_ocean import PlanetaryOceanConfig
    return (jcreate("PLANETARY_OCEAN", seed=0,
                    ec=JC(ocean_particle_count=300)),
            create_scenario("PLANETARY_OCEAN", seed=0, device="cpu",
                            ec=PlanetaryOceanConfig(ocean_particle_count=300)))


def test_planetary_ocean_carried_3_ticks():
    from lpe_tpu_torch.systems import build_run_fn
    js, ts = _oceans()
    jcfg = js.cfg.replace(fluid=dataclasses.replace(
        js.cfg.fluid, residency="on", pair_backend="xla"))
    run = build_run_fn(ts.spec, ts.cfg, ticks=3, device="cpu")
    assert list(run.systems) == ["fluid", "boundary", "rigid", "barnes_hut",
                                 "rotation", "movement", "sleep"]
    assert hasattr(run.systems["fluid"], "grid_build")     # resident
    _assert_carried(_jax_ticks(js, jcfg, 3), run(ts.state),
                    liquid=ts.spec.liquid_slice)


def test_galaxy_p3m_carried_3_ticks():
    from lpe_tpu.scenarios.bench_scenes import build_galaxy as jgalaxy
    from lpe_tpu_torch.scenarios.bench_scenes import build_galaxy
    from lpe_tpu_torch.systems import build_run_fn
    js, ts = jgalaxy(2000, seed=0), build_galaxy(2000, seed=0, device="cpu")
    cfg = _with_bh(ts.cfg, direct_sum_max_bodies=1)
    run = build_run_fn(ts.spec, cfg, ticks=3, device="cpu")
    pp = run.systems["barnes_hut"].pp
    assert pp is not None and pp.overflow_fraction(ts.state.bodies.pos) == 0
    _assert_carried(_jax_ticks(js, _with_bh(js.cfg, direct_sum_max_bodies=1),
                               3), run(ts.state))


def test_run_fn_with_gravity_equals_tick_fn():
    """With barnes_hut in the tick the cross-tick grid stays off, so a
    block of build_run_fn is build_tick_fn tick by tick, to the bit."""
    from lpe_tpu_torch.systems import build_run_fn, build_tick_fn
    ts = _oceans()[1]
    run = build_run_fn(ts.spec, ts.cfg, ticks=2, device="cpu")
    tick = build_tick_fn(ts.spec, ts.cfg, device="cpu")
    a = run(ts.state)
    b = tick(tick(ts.state))
    for f in dataclasses.fields(a.bodies):
        u, v = getattr(a.bodies, f.name), getattr(b.bodies, f.name)
        assert torch.equal(u, v) or (
            u.is_floating_point() and torch.equal(u.isnan(), v.isnan()) and
            torch.equal(torch.nan_to_num(u), torch.nan_to_num(v))), f.name
    assert int(a.tick) == int(b.tick) == 2


@pytest.mark.parametrize("name", ["KEPLERIAN_DISK", "PLANETARY_OCEAN"])
def test_gravity_scene_ticks_finite(name):
    """Each gravity scene of create_scenario: two ticks, finite, moving."""
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems import build_run_fn
    sc = create_scenario(name, seed=0, device="cpu")
    s = build_run_fn(sc.spec, sc.cfg, ticks=2, device="cpu")(sc.state)
    for f in ("pos", "vel"):
        assert bool(torch.isfinite(getattr(s.bodies, f)).all()), f
    assert not torch.equal(s.bodies.vel, sc.state.bodies.vel)
