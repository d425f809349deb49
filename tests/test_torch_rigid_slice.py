"""The port's rigid list pipeline (lpe_tpu_torch/systems/rigid) against
lpe_tpu's on scenes whose solids are all tank walls, and on walls with a
dynamic box."""
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
    """The list pipeline drops every boundary-boundary pair
    (pipeline.py:241-244), so on an all-wall scene both packages change no
    field but warm_n (EPA's output for padding pairs, read only for valid
    pairs), and agree on all of them bitwise."""
    from lpe_tpu.state import to_numpy
    from lpe_tpu.systems.rigid import make_rigid as jmake
    from lpe_tpu_torch.systems.rigid import make_rigid
    js, ts = _scenes(name)
    assert js.spec.n_solid == 4
    out_j = to_numpy(jax.jit(jmake(js.spec, js.cfg))(js.state))
    out_t = state_to_numpy(make_rigid(ts.spec, ts.cfg, device="cpu")(
        ts.state))
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
    """Walls and a box (the scene the port once refused): the box falls
    onto the floor wall over 60 ticks in both packages, which agree per
    body (pos and angle 1e-5, vel and omega 1e-4,
    tests/test_torch_grid_rigid.py's tolerances) and on the contact pairs
    of the warm start, bitwise."""
    from lpe_tpu.state import to_numpy
    from lpe_tpu.systems import build_run_fn as jrun
    from lpe_tpu_torch.systems import build_run_fn
    scenes = []
    for pkg in ("lpe_tpu", "lpe_tpu_torch"):
        cm = __import__(f"{pkg}.core.config", fromlist=["x"])
        C = __import__(f"{pkg}.core.constants", fromlist=["x"])
        poly = __import__(f"{pkg}.math.polygon", fromlist=["x"])
        SceneBuilder = __import__(f"{pkg}.scene",
                                  fromlist=["x"]).SceneBuilder
        b = SceneBuilder("walls_and_a_box")
        b.add_wall(3.0, 0.0, 3.0, 0.05)
        b.add_wall(3.0, 6.0, 3.0, 0.05)
        verts = poly.build_regular_polygon(4, 0.1)
        b.add(pos=(3.0, 5.8), mass=1.0, phase=int(C.Phase.SOLID),
              shape_kind=int(C.ShapeKind.POLYGON), radius=0.1, verts=verts,
              inertia=poly.calculate_polygon_inertia(verts, 1.0),
              has_sleep=True)
        kw = {} if pkg == "lpe_tpu" else dict(device="cpu")
        scenes.append(b.finalize(cm.ScenarioSystemConfig(), **kw))
    js, ts = scenes
    want = to_numpy(jrun(js.spec, js.cfg, ticks=60, donate=False)(js.state))
    got = state_to_numpy(build_run_fn(ts.spec, ts.cfg, ticks=60,
                                      device="cpu")(ts.state))
    for f, atol in (("pos", 1e-5), ("angle", 1e-5), ("vel", 1e-4),
                    ("omega", 1e-4)):
        np.testing.assert_allclose(getattr(got.bodies, f)[:3],
                                   np.asarray(getattr(want.bodies, f))[:3],
                                   rtol=0, atol=atol, err_msg=f)
    for f in ("warm_ia", "warm_ib"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)))
    # the box reached the floor wall (y = 6): it rests on it, in contact
    assert got.warm_ia[0] == 1 and got.warm_ib[0] == 2
    assert abs(float(got.bodies.pos[2, 1]) - (6.0 - 0.05 - 0.1)) < 0.01
