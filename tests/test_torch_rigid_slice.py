"""The port's restricted rigid step (lpe_tpu_torch/systems/rigid) against
lpe_tpu's list pipeline on scenes whose solids are all tank walls, and its
refusal of scenes with any other solid."""
import dataclasses

import jax
import numpy as np
import pytest

from lpe_tpu_torch.convert import state_to_numpy
from lpe_tpu_torch.state import Bodies, SimState


def _scenes(name):
    if name == "SIMPLE_FLUID":
        from lpe_tpu.scenarios import create_scenario as jcreate
        from lpe_tpu_torch.scenarios import create_scenario
        return (jcreate(name, seed=0),
                create_scenario(name, seed=0, device="cpu"))
    from lpe_tpu.scenarios.bench_scenes import build_dam_break as jdam
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    return jdam(400), build_dam_break(400, device="cpu")


@pytest.mark.parametrize("name", ["DAM_BREAK_400", "SIMPLE_FLUID"])
def test_all_wall_rigid_step_matches_lpe_tpu(name):
    """lpe_tpu's list pipeline drops every boundary-boundary pair
    (pipeline.py:241-244), so on an all-wall scene it changes no field but
    warm_n (EPA output for padding pairs, read only for valid pairs)."""
    from lpe_tpu.state import to_numpy
    from lpe_tpu.systems.rigid import make_rigid as jmake
    from lpe_tpu_torch.systems.rigid import make_rigid
    js, ts = _scenes(name)
    assert js.spec.n_solid == 4
    out_j = to_numpy(jax.jit(jmake(js.spec, js.cfg))(js.state))
    out_t = state_to_numpy(make_rigid(ts.spec, ts.cfg)(ts.state))
    compared = 0
    for cls, a, b in ((Bodies, out_t.bodies, out_j.bodies),
                      (SimState, out_t, out_j)):
        for f in dataclasses.fields(cls):
            if f.name in ("bodies", "warm_n"):
                continue
            u, v = getattr(a, f.name), np.asarray(getattr(b, f.name))
            assert u.dtype == v.dtype and u.shape == v.shape, f.name
            assert np.array_equal(u, v, equal_nan=True), f.name
            compared += 1
    assert compared == len(dataclasses.fields(Bodies)) + \
        len(dataclasses.fields(SimState)) - 2


def test_rigid_step_refuses_dynamic_polygons():
    from lpe_tpu_torch.core.config import ScenarioSystemConfig
    from lpe_tpu_torch.core.constants import Phase, ShapeKind
    from lpe_tpu_torch.math.polygon import (build_regular_polygon,
                                            calculate_polygon_inertia)
    from lpe_tpu_torch.scene import SceneBuilder
    from lpe_tpu_torch.systems.rigid import make_rigid
    b = SceneBuilder("walls_and_a_box")
    b.add_wall(3.0, 0.0, 3.0, 0.05)
    b.add_wall(3.0, 6.0, 3.0, 0.05)
    verts = build_regular_polygon(4, 0.1)
    b.add(pos=(3.0, 3.0), mass=1.0, phase=int(Phase.SOLID),
          shape_kind=int(ShapeKind.POLYGON), radius=0.1, verts=verts,
          inertia=calculate_polygon_inertia(verts, 1.0), has_sleep=True)
    sc = b.finalize(ScenarioSystemConfig(), device="cpu")
    step = make_rigid(sc.spec, sc.cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        step(sc.state)
