"""Each simple system of the port (lpe_tpu_torch/systems/simple.py) against
lpe_tpu's on one random seeded state, to atol 1e-7."""
import dataclasses

import numpy as np
import pytest

from lpe_tpu_torch.convert import state_from_numpy, state_to_numpy
from lpe_tpu_torch.scene import SceneSpec
from test_torch_fluid_slice import port_cfg

SYSTEMS = ["movement", "gravity", "boundary", "rotation", "sleep",
           "dampening"]


def _random_state(seed=7, n=300):
    """A lpe_tpu scene of solids, walls, gas and liquid, then every
    kinematic and sleep field redrawn from the seed: positions straddling
    the boundary margins, speeds around the sleep and speed-cap
    thresholds, angles around the wrap points, half of the sleepers
    asleep."""
    from lpe_tpu.core.config import ScenarioSystemConfig, SharedSystemConfig
    from lpe_tpu.core.constants import Phase, ShapeKind
    from lpe_tpu.scene import SceneBuilder
    from lpe_tpu.state import to_numpy
    rng = np.random.default_rng(seed)
    cfg = ScenarioSystemConfig(shared=SharedSystemConfig(universe_size_m=2.0))
    b = SceneBuilder("random")
    b.add_wall(1.0, 0.0, 1.0, 0.05)
    phases = [Phase.SOLID, Phase.GAS, Phase.LIQUID]
    for i in range(n):
        b.add(pos=(0.0, 0.0), phase=int(phases[i % 3]),
              shape_kind=int(ShapeKind.CIRCLE), radius=0.02, mass=1.0,
              inertia=float(rng.choice([0.0, 0.01])),
              has_sleep=bool(i % 2))
    sc = b.finalize(cfg)
    st = to_numpy(sc.state)
    N = st.bodies.pos.shape[0]
    f32 = np.float32
    bodies = dataclasses.replace(
        st.bodies,
        pos=rng.uniform(-0.1, 2.1, (N, 2)).astype(f32),
        vel=rng.uniform(-1.2, 1.2, (N, 2)).astype(f32),
        angle=rng.uniform(-0.2, 6.5, N).astype(f32),
        omega=rng.uniform(-25.0, 25.0, N).astype(f32),
        asleep=st.bodies.asleep | (st.bodies.has_sleep
                                   & (rng.uniform(size=N) < 0.5)),
        sleep_counter=rng.integers(55, 66, N).astype(np.int32))
    st = dataclasses.replace(st, bodies=bodies,
                             time_scale=np.asarray(0.75, f32),
                             base_time_accel=np.asarray(1.5, f32))
    return sc.spec, sc.cfg, st


@pytest.mark.parametrize("name", SYSTEMS)
def test_simple_system_matches_lpe_tpu(name):
    import jax
    import lpe_tpu.systems.simple as jsimple
    import lpe_tpu_torch.systems.simple as tsimple
    from lpe_tpu.state import SimState as JState, Bodies as JBodies
    spec, cfg, st = _random_state()
    jstate = JState(bodies=JBodies(**{
        f.name: jax.numpy.asarray(getattr(st.bodies, f.name))
        for f in dataclasses.fields(JBodies)}), **{
        f.name: jax.numpy.asarray(getattr(st, f.name))
        for f in dataclasses.fields(JState) if f.name != "bodies"})
    jfn = getattr(jsimple, f"make_{name}")(spec, cfg)
    tspec = SceneSpec(**dataclasses.asdict(spec))
    tfn = getattr(tsimple, f"make_{name}")(tspec, port_cfg(cfg))
    out_j = jax.tree.map(np.asarray, jfn(jstate))
    out_t = state_to_numpy(tfn(state_from_numpy(st, "cpu")))
    for f in dataclasses.fields(JBodies):
        a = getattr(out_t.bodies, f.name)
        b = getattr(out_j.bodies, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    changed = [f.name for f in dataclasses.fields(JBodies)
               if not np.array_equal(getattr(out_t.bodies, f.name),
                                     getattr(st.bodies, f.name))]
    assert changed, f"{name} changed nothing on the random state"
