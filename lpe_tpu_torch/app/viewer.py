"""Interactive viewer: the reference's event/UI surface on a matplotlib
window (reference: src/event_manager.cpp:52-125, presentation_manager.cpp
renderUI). The counterpart of ``lpe_tpu/app/viewer.py``.

The reference binds: P = pause, R = reset, space/S = single step, number keys
= scenario select, speed buttons 0.25x..1x, color-scheme buttons, debug
toggle. ``dispatch_key`` reproduces that dispatch table on a
:class:`SimManager` and is testable headless; ``view`` runs the matplotlib
loop when a display is available.
"""
from __future__ import annotations

from ..core import constants as C
from ..render.frame import SCHEME_DEFAULT, SCHEME_SLEEP, SCHEME_TEMPERATURE
from .sim_manager import SimManager

SPEEDS = {"z": 0.25, "x": 0.5, "c": 1.0}      # speed buttons (0.25x/0.5x/1x)
SCHEMES = {"d": SCHEME_DEFAULT, "l": SCHEME_SLEEP, "t": SCHEME_TEMPERATURE}


def dispatch_key(mgr: SimManager, key: str) -> str:
    """Apply one key event; returns a short action label (for the HUD).
    reference: src/event_manager.cpp:108-125 (keyboard) and :52-97 (the
    button actions the keys map to)."""
    key = (key or "").lower()
    if key == "p":
        mgr.toggle_pause()
        return "paused" if mgr.paused else "resumed"
    if key == "r":
        mgr.reset_simulator()
        return "reset"
    if key in (" ", "space", "s"):
        mgr.step_once()
        return "step"
    if key == "g":
        mgr.toggle_debug()
        return f"debug={'on' if mgr.debug else 'off'}"
    if key in SPEEDS:
        mgr.set_time_scale(SPEEDS[key])
        return f"speed={SPEEDS[key]}x"
    if key in SCHEMES:
        mgr.set_color_scheme(SCHEMES[key])
        return f"scheme={key}"
    if key.isdigit():
        idx = int(key) - 1
        scenarios = C.get_all_scenarios()
        if 0 <= idx < len(scenarios):
            mgr.select_scenario(scenarios[idx])
            return f"scenario={C.get_scenario_name(scenarios[idx])}"
    return ""


def view(scenario=C.SimulationType.KEPLERIAN_DISK, seed: int = 0,
         size: int = 600, ticks_per_frame: int = 2, device="cuda") -> int:
    """Open an interactive window (requires a display and matplotlib): the
    sim frame plus the reference's button panel, with mouse hover/click
    dispatch (reference: src/event_manager.cpp:26-106 processEvent ->
    handleMouseButtonPressed/handleMouseMoved)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    from ..render.hud import dispatch_button, hit_test, layout_buttons

    mgr = SimManager(scenario, seed=seed, device=device)
    names = tuple(C.get_scenario_name(s) for s in C.get_all_scenarios())
    buttons = layout_buttons(names)
    hover = [0]                                   # highlighted ButtonID

    fig, ax = plt.subplots(figsize=(9, 7))
    ax.set_axis_off()
    im = ax.imshow(mgr.render_frame_with_ui(size, size))
    title = ax.set_title(C.get_scenario_name(mgr.scenario_type))

    def on_key(event):
        label = dispatch_key(mgr, event.key)
        if label:
            title.set_text(
                f"{C.get_scenario_name(mgr.scenario_type)} [{label}]")

    def _panel_xy(event):
        if event.xdata is None or event.ydata is None:
            return None
        return event.xdata - size, event.ydata   # panel-local coords

    def on_move(event):
        p = _panel_xy(event)
        b = hit_test(buttons, *p) if p else None
        hover[0] = b.id if b else 0

    def on_click(event):
        p = _panel_xy(event)
        b = hit_test(buttons, *p) if p else None
        if b:
            label = dispatch_button(mgr, b)
            if label:
                title.set_text(
                    f"{C.get_scenario_name(mgr.scenario_type)} [{label}]")

    def update(_):
        if not mgr.paused or mgr.step_frame:
            n = 1 if mgr.step_frame else ticks_per_frame
            mgr.step_frame = False
            mgr.tick(n)
        im.set_data(mgr.render_frame_with_ui(size, size,
                                             highlight=hover[0]))
        return [im]

    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect("button_press_event", on_click)
    _anim = FuncAnimation(fig, update, interval=1000 // 60,
                          cache_frame_data=False)
    plt.show()
    return 0
