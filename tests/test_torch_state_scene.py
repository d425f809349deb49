"""The port's config, scene building and state conversion against lpe_tpu:
the same seed gives bitwise the same scene in both packages."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lpe_tpu_torch.core.config as tcfg
from lpe_tpu_torch.convert import (spec_from_dict, state_from_numpy,
                                   state_to_numpy)
from lpe_tpu_torch.state import Bodies, SimState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(obj):
    """(class name, {field: subtree or value}) of a config dataclass."""
    return (type(obj).__name__,
            {f.name: (_tree(getattr(obj, f.name))
                      if dataclasses.is_dataclass(getattr(obj, f.name))
                      else getattr(obj, f.name))
             for f in dataclasses.fields(obj)})


def test_config_tree_equals_lpe_tpu():
    import lpe_tpu.core.config as jcfg
    assert _tree(tcfg.ScenarioSystemConfig()) == \
        _tree(jcfg.ScenarioSystemConfig())
    jnames = {n for n, v in vars(jcfg).items()
              if dataclasses.is_dataclass(v) and isinstance(v, type)}
    tnames = {n for n, v in vars(tcfg).items()
              if dataclasses.is_dataclass(v) and isinstance(v, type)}
    assert jnames == tnames
    for n in jnames:
        jf = [(f.name, f.type) for f in dataclasses.fields(getattr(jcfg, n))]
        tf = [(f.name, f.type) for f in dataclasses.fields(getattr(tcfg, n))]
        assert jf == tf, n


def _scenes(name):
    if name == "SIMPLE_FLUID":
        from lpe_tpu.scenarios import create_scenario as jcreate
        from lpe_tpu_torch.scenarios import create_scenario
        return (jcreate(name, seed=0),
                create_scenario(name, seed=0, device="cpu"))
    from lpe_tpu.scenarios.bench_scenes import build_dam_break as jdam
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    return jdam(400, seed=0), build_dam_break(400, seed=0, device="cpu")


def _assert_state_equal(a, b):
    """Every leaf of two states: same field, dtype, shape and bits."""
    for cls, x, y in ((Bodies, a.bodies, b.bodies), (SimState, a, b)):
        for f in dataclasses.fields(cls):
            if f.name == "bodies":
                continue
            u = np.asarray(getattr(x, f.name))
            v = np.asarray(getattr(y, f.name))
            assert u.dtype == v.dtype and u.shape == v.shape, f.name
            assert np.array_equal(u, v, equal_nan=True), f.name


@pytest.mark.parametrize("name", ["SIMPLE_FLUID", "DAM_BREAK_400"])
def test_scene_bitwise_equal(name):
    from lpe_tpu.state import to_numpy
    js, ts = _scenes(name)
    assert dataclasses.asdict(ts.spec) == dataclasses.asdict(js.spec)
    assert _tree(ts.cfg) == _tree(js.cfg)
    _assert_state_equal(state_to_numpy(ts.state), to_numpy(js.state))
    assert ts.state.bodies.pos.dtype == torch.float32
    assert ts.state.bodies.color.dtype == torch.uint8
    assert ts.state.bodies.boundary.dtype == torch.bool


@pytest.mark.parametrize("name", ["SIMPLE_FLUID", "DAM_BREAK_400"])
def test_convert_round_trip_is_bitwise(name):
    from lpe_tpu.state import to_numpy
    js, ts = _scenes(name)
    carried = state_from_numpy(to_numpy(js.state), "cpu")
    _assert_state_equal(state_to_numpy(carried), state_to_numpy(ts.state))
    back = state_from_numpy(state_to_numpy(ts.state), "cpu")
    _assert_state_equal(state_to_numpy(back), state_to_numpy(ts.state))
    assert spec_from_dict(dataclasses.asdict(js.spec)) == ts.spec


def test_port_never_imports_jax():
    """Importing the port, running a full SIMPLE_FLUID tick, the CLI's
    ``list`` and one SIMPLE_FLUID frame with the HUD loads no jax (and no
    lpe_tpu, whose __init__ imports jax)."""
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import lpe_tpu_torch\n"
        "from lpe_tpu_torch.scenarios import create_scenario\n"
        "from lpe_tpu_torch.systems import build_tick_fn\n"
        "sc = create_scenario('SIMPLE_FLUID', seed=0, device='cpu')\n"
        "s = build_tick_fn(sc.spec, sc.cfg, device='cpu')(sc.state)\n"
        "assert int(s.tick) == 1\n"
        "from lpe_tpu_torch.app.cli import main\n"
        "assert main(['list']) == 0\n"
        "from lpe_tpu_torch.app.sim_manager import SimManager\n"
        "m = SimManager(lpe_tpu_torch.SimulationType.SIMPLE_FLUID,\n"
        "               device='cpu')\n"
        "assert m.render_frame_with_ui(120, 600).shape == (600, 320, 3)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib', 'lpe_tpu.')) or\n"
        "             m == 'lpe_tpu')\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_out_of_slice_configurations_raise():
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems.fluid import make_fluid
    sc = create_scenario("SIMPLE_FLUID", seed=0, device="cpu")
    for kw in (dict(pair_backend="xla"), dict(residency="sometimes")):
        cfg = sc.cfg.replace(fluid=dataclasses.replace(sc.cfg.fluid, **kw))
        with pytest.raises(ValueError, match=next(iter(kw))):
            make_fluid(sc.spec, cfg, device="cpu")
    # the multi-device fluid (ROADMAP Queue 1 item 7) is ported: a mesh
    # builds the row-band step
    from lpe_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=["cpu"] * 2)
    assert make_fluid(sc.spec, sc.cfg, device="cpu", mesh=mesh).mesh is mesh
    # mixed per-particle h (ROADMAP Queue 1 item 5) is ported: the fluid
    # system builds on a mixed-h spec
    spec = dataclasses.replace(sc.spec, liquid_h_uniform=False)
    assert callable(make_fluid(spec, sc.cfg, device="cpu"))


@pytest.mark.parametrize("name", ["coordinates", "sph_numpy"])
def test_host_helper_copies_equal_lpe_tpu(name):
    """The port's copies of lpe_tpu's host helpers and of its float64 SPH
    oracle (lpe_tpu/__init__.py imports jax, so the port keeps its own)
    equal the originals but for their docstrings."""
    import ast

    def code(path):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if isinstance(body, list) and body and \
                    isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant) and \
                    isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
        return ast.dump(tree)

    sub = "oracle" if name == "sph_numpy" else "core"
    src = os.path.join(REPO, "lpe_tpu", sub, f"{name}.py")
    port = os.path.join(REPO, "lpe_tpu_torch", sub, f"{name}.py")
    assert code(port) == code(src)
    assert open(port).read() != "" and "jax" not in code(port)
