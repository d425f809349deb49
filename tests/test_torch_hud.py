"""The port's HUD (lpe_tpu_torch/render/hud.py) against lpe_tpu's: every
value of the panel and the stats overlay is an integer or an exact
constant, so both are held to the bit, over several states; the mouse
surface (hit_test, dispatch_button) on the port's SimManager."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpe_tpu.render import hud as JH
from lpe_tpu_torch.core import constants as C
from lpe_tpu_torch.render import hud as TH
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = tuple(C.get_scenario_name(s) for s in C.get_all_scenarios())

PANELS = [dict(),
          dict(paused=True),
          dict(ts=0.5, scheme=1, hl=TH.BTN_SPEED_1),
          dict(ts=0.25, scheme=2, debug=True, scen=3),
          dict(paused=True, debug=True, scen=6, hl=TH.BTN_PAUSE_PLAY),
          dict(ts=0.7, hl=TH.BTN_SCENARIO_BASE + 2),
          dict(hl=TH.BTN_DEBUG, scheme=0, scen=5),
          dict(hl=TH.BTN_SPEED_1)]             # hovered and active: green


@pytest.fixture(scope="module")
def huds():
    return JH.make_hud(NAMES), TH.make_hud(NAMES, device="cpu")


@pytest.mark.parametrize("case", range(len(PANELS)))
def test_hud_panel_equals_lpe_tpu(huds, case):
    kw = dict(dict(paused=False, ts=1.0, scheme=0, debug=False, scen=0,
                   hl=0), **PANELS[case])
    jhud, thud = huds
    ref = np.asarray(jhud(jnp.asarray(kw["paused"]), jnp.float32(kw["ts"]),
                          jnp.int32(kw["scheme"]), jnp.asarray(kw["debug"]),
                          jnp.int32(kw["scen"]), jnp.int32(kw["hl"])))
    args = (kw["paused"], kw["ts"], kw["scheme"], kw["debug"], kw["scen"],
            kw["hl"])
    got = thud(*args)
    assert got.dtype == torch.uint8 and got.shape == (600, TH.PANEL_W, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    # 0-d tensors give the same panel as Python scalars
    tens = thud(*(torch.tensor(a, dtype=torch.float32) if i == 1
                  else torch.tensor(a) for i, a in enumerate(args)))
    assert torch.equal(tens, got)


@pytest.mark.parametrize("fps,tps,ts", [(60.0, 120.0, 1.0),
                                        (7.5, 119.94, 0.25),
                                        (0.04, 3.456, 0.5),
                                        (12345.6, 99999.0, 42.0),
                                        (59.95, 0.0, 0.7)])
def test_stats_overlay_equals_lpe_tpu(fps, tps, ts):
    rng = np.random.default_rng(int(fps * 100) % 1000)
    img = rng.integers(0, 256, (64, 240, 3), dtype=np.uint8)
    ref = np.asarray(JH.make_stats_overlay()(
        jnp.asarray(img), jnp.float32(fps), jnp.float32(tps),
        jnp.float32(ts)))
    got = TH.make_stats_overlay()(torch.from_numpy(img), fps, tps, ts)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(ref, img)


def test_layout_and_hit_test_equal_lpe_tpu():
    tb, jb = TH.layout_buttons(NAMES), JH.layout_buttons(NAMES)
    assert [dataclasses.astuple(b) for b in tb] == \
        [dataclasses.astuple(b) for b in jb]
    for x in range(0, TH.PANEL_W, 7):
        for y in range(0, 600, 5):
            t, j = TH.hit_test(tb, x, y), JH.hit_test(jb, x, y)
            assert (t and t.id) == (j and j.id)
    np.testing.assert_array_equal(TH.encode("Debug: ON", 12),
                                  JH.encode("Debug: ON", 12))


def test_mouse_dispatch_on_the_port():
    """Mouse hit-test + ButtonID dispatch (event_manager.cpp:52-106) on
    the port's SimManager, as tests/test_hud.py does on lpe_tpu's."""
    from lpe_tpu_torch.app.sim_manager import SimManager
    btns = TH.layout_buttons(NAMES)
    assert TH.hit_test(btns, 15, 15).id == TH.BTN_PAUSE_PLAY
    assert TH.hit_test(btns, 15, 140).id == TH.BTN_SPEED_0_5
    assert TH.hit_test(btns, 199, 599) is None
    m = SimManager(C.SimulationType.RANDOM_POLYGONS, seed=0, device="cpu")
    assert TH.dispatch_button(m, TH.hit_test(btns, 15, 15)) == "paused"
    assert m.paused
    assert TH.dispatch_button(m, TH.hit_test(btns, 15, 140)) == "speed=0.5x"
    assert float(m.state.time_scale) == 0.5
    sleep = next(b for b in btns if b.id == TH.BTN_COLOR_SLEEP)
    assert TH.dispatch_button(m, sleep) == "scheme=1" and m.color_scheme == 1
    dbg = next(b for b in btns if b.id == TH.BTN_DEBUG)
    assert TH.dispatch_button(m, dbg) == "debug=on" and m.debug
    nxt = next(b for b in btns if b.id == TH.BTN_NEXT_FRAME)
    assert TH.dispatch_button(m, nxt) == "step" and m.step_frame
    m.tick(1)
    rst = next(b for b in btns if b.id == TH.BTN_RESET)
    assert TH.dispatch_button(m, rst) == "reset" and int(m.state.tick) == 0
    scen = next(b for b in btns if b.id == TH.BTN_SCENARIO_BASE + 2)
    assert TH.dispatch_button(m, scen) == "scenario=SIMPLE_FLUID"
    assert m.scenario_type == C.SimulationType.SIMPLE_FLUID
    assert m.state.bodies.pos.device.type == "cpu"


def test_frame_with_ui_equals_lpe_tpu():
    """The whole window (frame, debug stats block, panel) of the port's
    SimManager against lpe_tpu's, on the same RANDOM_POLYGONS state with
    the debug overlays and the sleep scheme on: the panel to the bit, the
    frame with its stats block as tests/test_torch_render.py holds frames."""
    from lpe_tpu.app.sim_manager import SimManager as JSim
    from lpe_tpu.state import to_numpy
    from lpe_tpu_torch.app.sim_manager import SimManager
    from lpe_tpu_torch.convert import state_from_numpy
    kw = dict(seed=0, color_scheme=1, debug=True)
    j = JSim(C.SimulationType.RANDOM_POLYGONS, **kw)
    t = SimManager(C.SimulationType.RANDOM_POLYGONS, device="cpu", **kw)
    t.state = state_from_numpy(to_numpy(j.state), "cpu")
    for m in (j, t):
        m.stats.frames_per_sec, m.stats.ticks_per_sec = 59.9, 118.25
        m.set_time_scale(0.5)
    W, H = 200, 600              # the panel's layout needs 600 rows
    ref = j.render_frame_with_ui(W, H, highlight=TH.BTN_RESET)
    got = t.render_frame_with_ui(W, H, highlight=TH.BTN_RESET)
    assert got.shape == (H, W + TH.PANEL_W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[:, W:], ref[:, W:])
    d = np.abs(got[:, :W].astype(int) - ref[:, :W].astype(int)).max(-1)
    assert (d > 1).mean() <= 1e-3
