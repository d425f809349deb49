"""The scenes the rigid list pipeline opens, built by the port against
lpe_tpu's builders: the same seed gives bitwise the same scene (every
field of the state and of its bodies, every SceneSpec field, the config),
as tests/test_torch_state_scene.py holds SIMPLE_FLUID. Then each runs two
ticks through the port's create_scenario / build_run_fn on the CPU, on
the rigid pipeline lpe_tpu would pick, with finite state."""
import dataclasses

import numpy as np
import pytest
import torch

from lpe_tpu_torch.convert import spec_from_dict, state_to_numpy
from lpe_tpu_torch.state import Bodies, SimState
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CATALOG = ("RANDOM_POLYGONS", "FLUID_AND_POLYGONS", "GALTON_BOARD",
           "HOURGLASSES")
# bench scenes at test sizes: (builder, arguments)
BENCH = {"coupled_dam": ("build_coupled_dam", (2000, 8)),
         "highlight_reel": ("build_highlight_reel", (2000, 12, 20)),
         "north_star": ("build_north_star", (2000, 300)),
         "north_star_grid": ("build_north_star", (2000, 1100))}


def _build(pkg, name):
    if pkg == "jax":
        from lpe_tpu.scenarios import bench_scenes, create_scenario
        kw = {}
    else:
        from lpe_tpu_torch.scenarios import bench_scenes, create_scenario
        kw = dict(device="cpu")
    if name in CATALOG:
        return create_scenario(name, seed=0, **kw)
    fn, args = BENCH[name]
    return getattr(bench_scenes, fn)(*args, seed=0, **kw)


@pytest.mark.parametrize("name", CATALOG + tuple(BENCH))
def test_scene_builder_is_lpe_tpus(name):
    from lpe_tpu.state import to_numpy
    js, ts = _build("jax", name), _build("torch", name)
    assert dataclasses.asdict(ts.spec) == dataclasses.asdict(
        spec_from_dict(dataclasses.asdict(js.spec)))
    assert repr(ts.cfg) == repr(js.cfg)
    a, b = state_to_numpy(ts.state), to_numpy(js.state)
    n = 0
    for cls, x, y in ((Bodies, a.bodies, b.bodies), (SimState, a, b)):
        for f in dataclasses.fields(cls):
            if f.name == "bodies":
                continue
            u, v = getattr(x, f.name), np.asarray(getattr(y, f.name))
            assert u.dtype == v.dtype and u.shape == v.shape, f.name
            assert np.array_equal(u, v, equal_nan=True), f.name
            n += 1
    assert n == len(dataclasses.fields(Bodies)) + \
        len(dataclasses.fields(SimState)) - 1
    assert ts.spec.n_solid >= 7


def test_polygon_builders_are_lpe_tpus():
    """The port's copy of lpe_tpu/math/polygon.py: every builder gives the
    same vertices from the same generator state, and the same inertia and
    bounding radius."""
    from lpe_tpu.math import polygon as jpoly
    from lpe_tpu_torch.math import polygon as tpoly
    names = sorted(n for n in vars(jpoly) if not n.startswith("_")
                   and callable(getattr(jpoly, n)) and n != "annotations")
    assert names == sorted(n for n in vars(tpoly) if not n.startswith("_")
                           and callable(getattr(tpoly, n))
                           and n != "annotations")
    for seed in range(5):
        for fn in ("build_random_convex_polygon", "build_random_polygon"):
            a = getattr(jpoly, fn)(np.random.default_rng(seed), 0.3)
            b = getattr(tpoly, fn)(np.random.default_rng(seed), 0.3)
            assert np.array_equal(a, b)
            assert jpoly.calculate_polygon_inertia(a, 2.0) == \
                tpoly.calculate_polygon_inertia(b, 2.0)
            assert jpoly.polygon_bounding_radius(a) == \
                tpoly.polygon_bounding_radius(b)
        assert np.array_equal(jpoly.build_regular_polygon(3 + seed, 0.2),
                              tpoly.build_regular_polygon(3 + seed, 0.2))


@pytest.mark.parametrize("name", CATALOG + tuple(BENCH))
def test_scene_runs_two_ticks(name):
    """Two ticks through build_run_fn: the grid pipeline above
    dense_max_solids solids, the list pipeline below; finite state."""
    from lpe_tpu_torch.systems import build_run_fn
    from lpe_tpu_torch.systems.rigid.grid_pipeline import grid_dims
    sc = _build("torch", name)
    run = build_run_fn(sc.spec, sc.cfg, ticks=2, device="cpu")
    grid = grid_dims(sc.spec, sc.cfg) is not None
    assert grid == (name == "north_star_grid")
    assert hasattr(run.systems["rigid"], "narrowphase_args") == grid
    s = run(sc.state)
    assert int(s.tick) == 2
    for f in ("pos", "vel", "angle", "omega"):
        assert bool(torch.isfinite(getattr(s.bodies, f)).all()), f
    assert not torch.equal(s.bodies.pos, sc.state.bodies.pos)
