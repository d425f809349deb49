"""The port's application layer against lpe_tpu's: checkpoints that both
packages load to the bit (in both directions, and without the warm-start
fields), the standard-library PNG writer, the SimManager surface and key
dispatch, and the CLI (``python -m lpe_tpu_torch.app.cli``) on the CPU,
whose checkpoint is held to lpe_tpu's CLI run of the same scene within
tests/test_torch_fluid_slice.py's tolerances (positions atol 1e-5,
density rtol 1e-4, velocity atol 3e-3)."""
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from lpe_tpu_torch.convert import state_from_numpy, state_to_numpy
from lpe_tpu_torch.core.constants import SimulationType as ST
from lpe_tpu_torch.io import checkpoint as TC
from lpe_tpu_torch.io.media import save_png
from lpe_tpu_torch.state import Bodies, SimState
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _leaves(state):
    """{key: numpy array} of a state of either package, keyed as in the
    checkpoint format."""
    out = {}
    for f in dataclasses.fields(state.bodies):
        out[f"bodies.{f.name}"] = np.asarray(getattr(state.bodies, f.name))
    for f in dataclasses.fields(state):
        if f.name != "bodies":
            out[f.name] = np.asarray(getattr(state, f.name))
    return out


def _assert_same_bits(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def _lpe_tpu_scene(name):
    if name == "RIGID_STACKS_1100":        # the grid pipeline's rg_* caches
        from lpe_tpu.scenarios.bench_scenes import build_rigid_stacks
        return build_rigid_stacks(1100, seed=0)
    from lpe_tpu.scenarios import create_scenario
    return create_scenario(name, seed=0)


@pytest.mark.parametrize("name", ["RANDOM_POLYGONS", "SIMPLE_FLUID",
                                  "RIGID_STACKS_1100"])
def test_checkpoints_load_in_both_packages(tmp_path, name):
    """lpe_tpu writes and the port loads; the port writes and lpe_tpu
    loads: every field with its dtype, shape and bits."""
    from lpe_tpu.io.checkpoint import load_state as jload
    from lpe_tpu.io.checkpoint import save_state as jsave
    from lpe_tpu.state import to_numpy
    sc = _lpe_tpu_scene(name)
    ref = _leaves(to_numpy(sc.state))
    jsave(str(tmp_path / "j.npz"), sc.state)
    st = TC.load_state(str(tmp_path / "j.npz"), device="cpu")
    assert isinstance(st, SimState) and isinstance(st.bodies, Bodies)
    assert st.bodies.pos.device.type == "cpu"
    _assert_same_bits(_leaves(state_to_numpy(st)), ref)
    # the port writes a state it holds (its tick counter and time scale
    # moved) and lpe_tpu loads it
    moved = st.replace(tick=st.tick + 7,
                       time_scale=torch.tensor(0.25, dtype=torch.float32))
    TC.save_state(str(tmp_path / "t.npz"), moved)
    back = to_numpy(jload(str(tmp_path / "t.npz")))
    _assert_same_bits(_leaves(back), _leaves(state_to_numpy(moved)))
    with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)


def test_checkpoint_loads_without_new_fields(tmp_path):
    """A checkpoint without the warm_pt/warm_n caches loads in the port
    with the make_state defaults, as lpe_tpu's does
    (tests/test_render_io.py)."""
    from lpe_tpu.io.checkpoint import load_state as jload
    from lpe_tpu.state import to_numpy
    sc = _lpe_tpu_scene("RANDOM_POLYGONS")
    path = str(tmp_path / "old.npz")
    TC.save_state(path, state_from_numpy(to_numpy(sc.state), "cpu"))
    z = dict(np.load(path))
    for k in ("warm_pt", "warm_n"):
        del z[k]
    np.savez_compressed(path, **z)
    s2 = TC.load_state(path, device="cpu")
    assert torch.equal(s2.bodies.pos, torch.from_numpy(
        np.array(sc.state.bodies.pos)))
    assert float(s2.warm_pt.min()) >= 1e29
    assert not s2.warm_n.any()
    assert s2.warm_pt.shape[:2] == s2.warm_normal.shape
    _assert_same_bits(_leaves(state_to_numpy(s2)), _leaves(to_numpy(
        jload(path))))


def test_save_png_needs_no_pil_and_decodes_as_pils(tmp_path):
    """The standard-library writer's file decodes (by PIL) to the frame,
    and to what PIL's own PNG of the frame decodes to."""
    from PIL import Image
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    frame[:5] = 0
    frame[-5:] = 255
    path = str(tmp_path / "f.png")
    save_png(path, frame)
    got = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and got.shape == frame.shape
    np.testing.assert_array_equal(got, frame)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    np.testing.assert_array_equal(np.asarray(Image.open(buf)), got)
    save_png(path, torch.from_numpy(frame))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), frame)
    with pytest.raises(ValueError):
        save_png(path, frame[..., 0])


@pytest.mark.parametrize("name", ["SIMPLE_FLUID", "RANDOM_POLYGONS"])
def test_reset_after_ticks_gives_a_fresh_scene(name):
    """reset_simulator returns the state the scene was built with: no
    system writes into a state's tensors, so after ticks every field
    equals a fresh scene's bits (time scale kept, as the reference)."""
    from lpe_tpu_torch.app.sim_manager import SimManager
    from lpe_tpu_torch.scenarios import create_scenario
    m = SimManager(ST[name], seed=0, device="cpu")
    m.set_time_scale(0.5)
    m.tick(2)
    assert int(m.state.tick) == 2
    m.reset_simulator()
    fresh = create_scenario(name, seed=0, device="cpu").state
    got, want = _leaves(state_to_numpy(m.state)), _leaves(
        state_to_numpy(fresh))
    assert float(got.pop("time_scale")) == 0.5
    want.pop("time_scale")
    _assert_same_bits(got, want)


def test_sim_manager_api_surface(tmp_path):
    from lpe_tpu_torch.app.sim_manager import SimManager
    m = SimManager(ST.RANDOM_POLYGONS, seed=0, device="cpu")
    m.tick(2)
    assert int(m.state.tick) == 2
    m.set_time_scale(0.5)
    assert float(m.state.time_scale) == 0.5
    assert m.state.time_scale.dtype == torch.float32
    m.reset_simulator()
    assert int(m.state.tick) == 0
    assert float(m.state.time_scale) == 0.5   # preserved across reset
    frame = m.render_frame(120, 120)
    assert isinstance(frame, np.ndarray) and frame.shape == (120, 120, 3)
    m.toggle_pause()
    assert m.paused
    m.step_once()
    before = m.stats.ticks
    stats = m.run(10)      # paused: runs exactly the single stepped tick
    assert stats.ticks == before + 1 and int(m.state.tick) == 1
    m.paused = False
    frames = []
    m.run(4, frame_sink=lambda f, i: frames.append((f.shape, i)),
          frame_every=2)
    assert frames == [((120, 120, 3), 2), ((120, 120, 3), 4)]
    log = m.trace(str(tmp_path / "trace"), ticks=1)
    assert os.path.getsize(os.path.join(log, "trace.json")) > 0


def test_event_dispatch_parity():
    """Key->action dispatch (reference: event_manager.cpp:52-125), as
    tests/test_render_io.py holds lpe_tpu's."""
    from lpe_tpu_torch.app.sim_manager import SimManager
    from lpe_tpu_torch.app.viewer import dispatch_key
    from lpe_tpu_torch.render.frame import SCHEME_SLEEP
    m = SimManager(ST.RANDOM_POLYGONS, seed=0, device="cpu")
    assert dispatch_key(m, "p") == "paused" and m.paused
    assert dispatch_key(m, "p") == "resumed" and not m.paused
    assert dispatch_key(m, "x") == "speed=0.5x"
    assert float(m.state.time_scale) == 0.5
    assert dispatch_key(m, "l") == "scheme=l"
    assert m.color_scheme == SCHEME_SLEEP
    assert dispatch_key(m, "g").startswith("debug=")
    assert dispatch_key(m, " ") == "step" and m.step_frame
    m.tick(1)
    assert dispatch_key(m, "r") == "reset"
    assert int(m.state.tick) == 0
    assert dispatch_key(m, "1").startswith("scenario=KEPLERIAN")
    assert m.state.bodies.pos.device.type == "cpu"
    assert dispatch_key(m, "q") == ""      # unbound key: no-op


def test_cli_list(capsys):
    from lpe_tpu_torch.app.cli import main
    assert main(["list"]) == 0
    names = capsys.readouterr().out.split()
    assert names[0] == "KEPLERIAN_DISK" and len(names) == 7


def test_cli_device_defaults_to_cuda(monkeypatch):
    """Without --device the CLI builds its SimManager on "cuda" (on a
    machine with no card that fails; nothing falls back to the CPU)."""
    import lpe_tpu_torch.app.sim_manager as sm
    from lpe_tpu_torch.app.cli import main
    seen = []

    class Probe(Exception):
        pass

    def fake(*a, device, **kw):
        seen.append(str(device))
        raise Probe

    monkeypatch.setattr(sm, "SimManager", fake)
    for argv in (["run", "--ticks", "1"], ["bench"],
                 ["run", "--device", "cpu"]):
        with pytest.raises(Probe):
            main(argv)
    assert seen == ["cuda", "cuda", "cpu"]


def test_cli_run_matches_lpe_tpu_and_resumes_to_the_bit(tmp_path):
    """``run --device cpu --scenario SIMPLE_FLUID --ticks 3 --png
    --checkpoint``: the PNG is the port's own frame of the final state,
    the checkpoint loads in lpe_tpu and agrees with lpe_tpu's CLI run;
    then ``--resume`` for 2 ticks equals a straight 5-tick run in every
    field to the bit."""
    from lpe_tpu.app.cli import main as jmain
    from lpe_tpu.io.checkpoint import load_state as jload
    from PIL import Image

    from lpe_tpu_torch.app.cli import main
    from lpe_tpu_torch.render import make_renderer
    from lpe_tpu_torch.scenarios import create_scenario
    p = {k: str(tmp_path / k) for k in
         ("t.png", "t3.npz", "j3.npz", "j.png", "r5.npz", "s5.npz")}
    run = ["run", "--scenario", "SIMPLE_FLUID"]
    assert main(run + ["--device", "cpu", "--ticks", "3", "--png",
                       p["t.png"], "--checkpoint", p["t3.npz"]]) == 0
    assert jmain(run + ["--ticks", "3", "--png", p["j.png"],
                        "--checkpoint", p["j3.npz"]]) == 0
    png = np.asarray(Image.open(p["t.png"]))
    assert png.shape == (600, 600, 3)
    assert ((png[:, :, 2] > 200) & (png[:, :, 0] < 100)).mean() > 0.02
    state = TC.load_state(p["t3.npz"], device="cpu")
    sc = create_scenario("SIMPLE_FLUID", seed=0, device="cpu")
    np.testing.assert_array_equal(
        png, make_renderer(sc.spec, sc.cfg)(state).numpy())
    t, j = _leaves(jload(p["t3.npz"])), _leaves(jload(p["j3.npz"]))
    assert int(t["tick"]) == int(j["tick"]) == 3
    np.testing.assert_allclose(t["bodies.pos"], j["bodies.pos"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(t["bodies.vel"], j["bodies.vel"], atol=3e-3,
                               rtol=0)
    np.testing.assert_allclose(t["bodies.density"], j["bodies.density"],
                               rtol=1e-4)
    assert main(run + ["--device", "cpu", "--resume", p["t3.npz"],
                       "--ticks", "2", "--checkpoint", p["r5.npz"]]) == 0
    assert main(run + ["--device", "cpu", "--ticks", "5", "--checkpoint",
                       p["s5.npz"]]) == 0
    with np.load(p["r5.npz"]) as r, np.load(p["s5.npz"]) as s:
        _assert_same_bits(dict(r), dict(s))
        assert int(r["tick"]) == 5
