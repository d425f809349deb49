"""build_run_fn with the fluid grid resident across a 3-tick block, held
particle by particle against lpe_tpu's resident XLA path at the JAX
package's tolerances (positions atol 1e-5, density rtol 1e-4, velocity
atol 3e-3), on small scenes whose block is not chaotic at the float32 ulp.

The blocks run grid_build once, three fluid ticks with the grid-space
boundary and gravity between them, and grid_readback at the end. The
floor scene sends most particles through the boundary bounce in grid
space and has no rigid row (the sub-step without the coupling kernel)."""
import numpy as np
import pytest

from test_torch_fluid_slice import (assert_fluid_close, blob_scene,
                                    cross_tick, to_port, xla_resident)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def floor_scene(n=40, universe=1.0, seed=4):
    """A sparse layer of liquid on the floor margin, falling at ~0.6 m/s:
    most particles cross the margin in the block and bounce."""
    from lpe_tpu.core.config import (FluidConfig, ScenarioSystemConfig,
                                     SharedSystemConfig)
    from lpe_tpu.core.constants import Phase
    from lpe_tpu.scene import SceneBuilder
    cfg = ScenarioSystemConfig(
        shared=SharedSystemConfig(universe_size_m=universe),
        fluid=FluidConfig())
    floor = universe - cfg.boundary.margin_pixels * cfg.shared.meters_per_pixel
    rng = np.random.default_rng(seed)
    b = SceneBuilder("floor")
    for _ in range(n):
        b.add(pos=(rng.uniform(0.3, 0.7) * universe,
                   floor + rng.uniform(-0.006, 0.012)),
              vel=(rng.uniform(-0.2, 0.2), 0.6 + rng.uniform(-0.2, 0.2)),
              mass=0.005, phase=int(Phase.LIQUID), radius=0.02)
    return b.finalize(cfg)


SCENES = {
    "walled_blob": lambda: blob_scene(),
    "floor_bounce": floor_scene,
}


@pytest.mark.parametrize("name", list(SCENES))
def test_run_fn_block_matches_lpe_tpu_per_particle(name):
    from lpe_tpu.systems import build_run_fn as jrun
    from lpe_tpu_torch.systems import build_run_fn
    sc = SCENES[name]()
    spec, cfg, state = to_port(sc)
    s_j = jrun(sc.spec, cross_tick(xla_resident(sc.cfg)), ticks=3,
               donate=False)(sc.state)
    s_p = build_run_fn(spec, cross_tick(cfg), ticks=3, device="cpu")(state)
    assert int(s_p.tick) == int(s_j.tick) == 3
    assert_fluid_close(sc.spec, s_j, s_p, sc.state)
    liq = sc.spec.liquid_slice
    vy0 = np.asarray(sc.state.bodies.vel)[liq, 1]
    vy = s_p.bodies.vel.numpy()[liq, 1]
    if name == "floor_bounce":
        assert sc.spec.liquid_start == 0            # no rigid row
        assert ((vy0 > 0) & (vy < 0)).sum() > len(vy) // 2   # bounced
    else:
        # gravity (+y) acted on every particle over the block
        assert np.abs(vy - vy0).min() > 0
