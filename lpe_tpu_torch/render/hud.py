"""On-device HUD: the reference's right-hand button panel and debug stats.

The counterpart of ``lpe_tpu/render/hud.py``. The reference draws its UI
with SFML every frame: buttons for pause/play, single-step, reset,
playback speed, color scheme, debug toggle and one button per scenario
(src/presentation_manager.cpp:187-323 renderUI), plus an FPS/TPS/
achieved-timescale text block in debug mode (:154-184 renderStatsInternal,
src/renderers/ui_renderer.cpp:14-44). Here the panel is a uint8
[H, PANEL_W, 3] tensor built on a device from a handful of scalars
(paused flag, time scale, scheme, debug flag, scenario index, hover
highlight, FPS, TPS), which may be Python numbers or 0-d tensors: the
scalars select colors and labels on the device, with no host read.
Text is the same 5x7 bitmap font, blitted as dense tensor ops; button
geometry and colors are the reference's. Every value is an integer or an
exact constant, so a panel equals lpe_tpu's to the bit.

``layout_buttons``/``hit_test``/``dispatch_button`` reproduce the
reference EventManager's mouse surface (src/event_manager.cpp:52-106).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import constants as C
from .frame import _div, _vec

PANEL_W = 200          # reference window = ScreenLength + 200 wide
_CHAR_W = 6            # 5 px glyph + 1 px spacing

# ---------------------------------------------------------------------------
# 5x7 bitmap font (each glyph: 7 rows of 5 bits, MSB = left column)
# ---------------------------------------------------------------------------
_FONT = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "0": (0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110),
    "1": (0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "2": (0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0b01000, 0b11111),
    "3": (0b11111, 0b00010, 0b00100, 0b00010, 0b00001, 0b10001, 0b01110),
    "4": (0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010),
    "5": (0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110),
    "6": (0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110),
    "7": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000),
    "8": (0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110),
    "9": (0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100),
    "A": (0b01110, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "B": (0b11110, 0b10001, 0b10001, 0b11110, 0b10001, 0b10001, 0b11110),
    "C": (0b01110, 0b10001, 0b10000, 0b10000, 0b10000, 0b10001, 0b01110),
    "D": (0b11100, 0b10010, 0b10001, 0b10001, 0b10001, 0b10010, 0b11100),
    "E": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b11111),
    "F": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000),
    "G": (0b01110, 0b10001, 0b10000, 0b10111, 0b10001, 0b10001, 0b01111),
    "H": (0b10001, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "I": (0b01110, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "J": (0b00111, 0b00010, 0b00010, 0b00010, 0b00010, 0b10010, 0b01100),
    "K": (0b10001, 0b10010, 0b10100, 0b11000, 0b10100, 0b10010, 0b10001),
    "L": (0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b11111),
    "M": (0b10001, 0b11011, 0b10101, 0b10101, 0b10001, 0b10001, 0b10001),
    "N": (0b10001, 0b10001, 0b11001, 0b10101, 0b10011, 0b10001, 0b10001),
    "O": (0b01110, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "P": (0b11110, 0b10001, 0b10001, 0b11110, 0b10000, 0b10000, 0b10000),
    "Q": (0b01110, 0b10001, 0b10001, 0b10001, 0b10101, 0b10010, 0b01101),
    "R": (0b11110, 0b10001, 0b10001, 0b11110, 0b10100, 0b10010, 0b10001),
    "S": (0b01111, 0b10000, 0b10000, 0b01110, 0b00001, 0b00001, 0b11110),
    "T": (0b11111, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100),
    "U": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "V": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01010, 0b00100),
    "W": (0b10001, 0b10001, 0b10001, 0b10101, 0b10101, 0b10101, 0b01010),
    "X": (0b10001, 0b10001, 0b01010, 0b00100, 0b01010, 0b10001, 0b10001),
    "Y": (0b10001, 0b10001, 0b01010, 0b00100, 0b00100, 0b00100, 0b00100),
    "Z": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0b11111),
    ".": (0, 0, 0, 0, 0, 0b01100, 0b01100),
    ":": (0, 0b01100, 0b01100, 0, 0b01100, 0b01100, 0),
    "(": (0b00010, 0b00100, 0b01000, 0b01000, 0b01000, 0b00100, 0b00010),
    ")": (0b01000, 0b00100, 0b00010, 0b00010, 0b00010, 0b00100, 0b01000),
    "-": (0, 0, 0, 0b11111, 0, 0, 0),
    "+": (0, 0b00100, 0b00100, 0b11111, 0b00100, 0b00100, 0),
    "/": (0, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0),
}
_CHARS = list(_FONT)
_CHAR_IDX = {c: i for i, c in enumerate(_CHARS)}


def _build_atlas() -> np.ndarray:
    a = np.zeros((len(_CHARS), 7, _CHAR_W), np.float32)
    for i, ch in enumerate(_CHARS):
        for r, bits in enumerate(_FONT[ch]):
            for c in range(5):
                a[i, r, c] = (bits >> (4 - c)) & 1
    return a


_ATLAS = _build_atlas()                                  # [G, 7, 6]


def encode(text: str, length: int | None = None) -> np.ndarray:
    """Host-side: string -> int32 glyph ids (uppercased, unknown -> space),
    space-padded/truncated to ``length``."""
    ids = [_CHAR_IDX.get(ch, 0) for ch in text.upper()]
    if length is not None:
        ids = (ids + [0] * length)[:length]
    return np.asarray(ids, np.int32)


def _scalar(v, dtype, device):
    """A Python number or 0-d tensor as a 0-d tensor on ``device``; a
    number is filled in there, not copied from the host."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _text_mask(atlas, ids):
    """Glyph ids [L] -> coverage mask [7, L*6] (dense gather + reshape —
    no per-character loop). ``atlas``: ``_ATLAS`` on the ids' device."""
    strip = atlas[torch.as_tensor(ids, device=atlas.device).long()]
    return strip.permute(1, 0, 2).reshape(7, -1)


def _blit(img, mask, x: int, y: int, color):
    """Composite a coverage mask onto the float image ``img`` at static
    (x, y), clipped; writes into ``img`` and returns it."""
    H, W = img.shape[:2]
    h, w = mask.shape
    if y >= H or x >= W:
        return img
    h = min(h, H - y)
    w = min(w, W - x)
    m = mask[:h, :w, None]
    col = torch.as_tensor(color, dtype=torch.float32, device=img.device)
    region = img[y:y + h, x:x + w]
    img[y:y + h, x:x + w] = region * (1 - m) + col * m
    return img


def _fill_rect(img, x, y, w, h, color, outline=None):
    """Filled rect + optional 1 px outline (ui_renderer.cpp:14-29); writes
    into ``img`` and returns it."""
    img[y:y + h, x:x + w] = torch.as_tensor(color, dtype=torch.float32,
                                            device=img.device)
    if outline is not None:
        o = torch.as_tensor(outline, dtype=torch.float32, device=img.device)
        img[y, x:x + w] = o
        img[y + h - 1, x:x + w] = o
        img[y:y + h, x] = o
        img[y:y + h, x + w - 1] = o
    return img


# ---------------------------------------------------------------------------
# Button layout + mouse dispatch (event_manager.cpp:52-106)
# ---------------------------------------------------------------------------
BTN_PAUSE_PLAY = 1
BTN_NEXT_FRAME = 2
BTN_RESET = 3
BTN_SPEED_0_25 = 4
BTN_SPEED_0_5 = 5
BTN_SPEED_1 = 6
BTN_COLOR_DEFAULT = 7
BTN_COLOR_SLEEP = 8
BTN_COLOR_TEMP = 9
BTN_DEBUG = 10
BTN_SCENARIO_BASE = 100

_GRAY = (100.0, 100.0, 100.0)
_YELLOW = (200.0, 200.0, 0.0)
_GREEN = (0.0, 200.0, 0.0)
_WHITE = (255.0, 255.0, 255.0)
_DIM = (50.0, 50.0, 50.0)
_DIM_FG = (150.0, 150.0, 150.0)


@dataclass(frozen=True)
class Button:
    id: int
    x: int            # panel-local
    y: int
    w: int
    h: int
    label: str
    speed: float = 0.0
    scheme: int = -1
    scenario: int = -1


def layout_buttons(scenario_names: tuple[str, ...]) -> list[Button]:
    """The reference's panel geometry verbatim
    (presentation_manager.cpp:196-318; panelX is panel-local here)."""
    x, y = 10, 10
    btns = [Button(BTN_PAUSE_PLAY, x, y, 60, 20, "Pause")]
    y += 25
    btns.append(Button(BTN_NEXT_FRAME, x, y, 80, 20, "Next Frame"))
    y += 25
    btns.append(Button(BTN_RESET, x, y, 60, 20, "Reset"))
    y += 25
    y += 25                                      # "Playback Speed:" text row
    for bid, sp, lab in ((BTN_SPEED_0_25, 0.25, "0.25x"),
                         (BTN_SPEED_0_5, 0.5, "0.5x"),
                         (BTN_SPEED_1, 1.0, "1x")):
        btns.append(Button(bid, x, y, 50, 20, lab, speed=sp))
        y += 25
    y += 20
    y += 25                                      # "Color Scheme:" text row
    for bid, sch, lab in ((BTN_COLOR_DEFAULT, 0, "Default"),
                          (BTN_COLOR_SLEEP, 1, "Sleep"),
                          (BTN_COLOR_TEMP, 2, "Temperature")):
        btns.append(Button(bid, x, y, 100, 25, lab, scheme=sch))
        y += 25
    y += 20
    y += 25                                      # "Debug View:" text row
    btns.append(Button(BTN_DEBUG, x, y, 100, 25, "Debug: OFF"))
    y += 25
    y += 20
    y += 25                                      # "Scenarios:" text row
    for i, name in enumerate(scenario_names):
        btns.append(Button(BTN_SCENARIO_BASE + i, x, y, 120, 20, name,
                           scenario=i))
        y += 25
    return btns


def hit_test(buttons: list[Button], x: float, y: float) -> Button | None:
    """Panel-local hit test (event_manager.cpp:128-136)."""
    for b in buttons:
        if b.x <= x < b.x + b.w and b.y <= y < b.y + b.h:
            return b
    return None


def dispatch_button(mgr, btn: Button) -> str:
    """The reference ButtonID dispatch (event_manager.cpp:52-97) on a
    SimManager; returns an action label for the window title."""
    if btn.id == BTN_PAUSE_PLAY:
        mgr.toggle_pause()
        return "paused" if mgr.paused else "resumed"
    if btn.id == BTN_NEXT_FRAME:
        mgr.step_once()
        return "step"
    if btn.id == BTN_RESET:
        mgr.reset_simulator()
        return "reset"
    if btn.id == BTN_DEBUG:
        mgr.toggle_debug()
        return f"debug={'on' if mgr.debug else 'off'}"
    if btn.speed > 0:
        mgr.set_time_scale(btn.speed)
        return f"speed={btn.speed}x"
    if btn.scheme >= 0:
        mgr.set_color_scheme(btn.scheme)
        return f"scheme={btn.scheme}"
    if btn.scenario >= 0:
        scenarios = C.get_all_scenarios()
        if btn.scenario < len(scenarios):
            mgr.select_scenario(scenarios[btn.scenario])
            return f"scenario={C.get_scenario_name(scenarios[btn.scenario])}"
    return ""


# ---------------------------------------------------------------------------
# Device-side number formatting
# ---------------------------------------------------------------------------
def _num_ids(v, int_digits: int, frac_digits: int):
    """f32 0-d tensor -> glyph ids for '%*.*f' (leading zeros -> spaces).
    Fixed width = int_digits + 1 + frac_digits."""
    d0 = _CHAR_IDX["0"]
    sp = _CHAR_IDX[" "]
    dot = torch.full((), _CHAR_IDX["."], device=v.device)
    scale = 10 ** frac_digits
    hi = 10 ** (int_digits + frac_digits) - 1
    n = torch.clamp(torch.round(v * scale), 0, hi).to(torch.int64)
    ids = []
    lead = torch.full((), True, device=v.device)
    for p in range(int_digits + frac_digits - 1, -1, -1):
        dig = torch.div(n, 10 ** p, rounding_mode="floor") % 10
        is_lead = lead & (dig == 0) if p > frac_digits else \
            torch.zeros_like(lead)
        ids.append(torch.where(is_lead, sp, d0 + dig))
        lead = is_lead
        if p == frac_digits and frac_digits > 0:
            ids.append(dot)
    return torch.stack(ids)


# ---------------------------------------------------------------------------
# The panel / stats builders
# ---------------------------------------------------------------------------
def make_hud(scenario_names: tuple[str, ...], *, height: int = 600,
             device="cuda"):
    """Build ``hud(paused, time_scale, scheme, debug, scenario_idx,
    highlight) -> uint8 [height, PANEL_W, 3]`` on ``device``.

    Geometry and labels are fixed when it is built; the scalars only flow
    into fill colors and the two flip labels (Pause/Play, Debug ON/OFF) —
    the reference recomputes the same layout every frame
    (presentation_manager.cpp:187-323)."""
    buttons = layout_buttons(scenario_names)
    H = height
    dev = torch.device(device)
    atlas = torch.from_numpy(_ATLAS).to(dev)

    def mask(text, length=None):
        return _text_mask(atlas, encode(text, length))

    gray, dim, white, dim_fg, green, yellow = (
        _vec(c, torch.float32, dev)
        for c in (_GRAY, _DIM, _WHITE, _DIM_FG, _GREEN, _YELLOW))
    off = torch.full((), False, device=dev)
    pause, play = mask("Pause", 5), mask("Play", 5)
    dbg_on, dbg_off = mask("Debug: ON", 10), mask("Debug: OFF", 10)
    labels = {b.id: mask(b.label, (b.w - 10) // _CHAR_W) for b in buttons}
    headers = [(mask("Playback Speed:"), 10, 10 + 3 * 25 + 3),
               (mask("Color Scheme:"), 10, 10 + 7 * 25 + 20 + 3),
               (mask("Debug View:"), 10, 10 + 11 * 25 + 40 + 3),
               (mask("Scenarios:"), 10, 10 + 13 * 25 + 60 + 3)]

    def hud(paused, time_scale, scheme, debug, scenario_idx, highlight):
        paused = _scalar(paused, torch.bool, dev)
        time_scale = _scalar(time_scale, torch.float32, dev)
        debug = _scalar(debug, torch.bool, dev)
        scheme = _scalar(scheme, torch.int64, dev)
        scenario_idx = _scalar(scenario_idx, torch.int64, dev)
        highlight = _scalar(highlight, torch.int64, dev)
        img = torch.zeros(H, PANEL_W, 3, dtype=torch.float32, device=dev)
        for m, hx, hy in headers:
            _blit(img, m, hx, hy, white)
        for b in buttons:
            if b.id == BTN_NEXT_FRAME:
                fill = torch.where(paused, gray, dim)
                fg = torch.where(paused, white, dim_fg)
            else:
                if b.speed > 0:
                    on = torch.abs(time_scale - b.speed) < 0.01
                elif b.scheme >= 0:
                    on = scheme == b.scheme
                elif b.scenario >= 0:
                    on = scenario_idx == b.scenario
                elif b.id == BTN_DEBUG:
                    on = debug
                else:
                    on = off
                hov = highlight == b.id
                fill = torch.where(on, green, torch.where(hov, yellow, gray))
                fg = white
            _fill_rect(img, b.x, b.y, b.w, b.h, fill, outline=white)
            if b.id == BTN_PAUSE_PLAY:
                text = torch.where(paused, play, pause)
            elif b.id == BTN_DEBUG:
                text = torch.where(debug, dbg_on, dbg_off)
            else:
                text = labels[b.id]
            _blit(img, text, b.x + 5, b.y + 3, fg)
        return torch.clamp(img, 0, 255).to(torch.uint8)

    return hud


def make_stats_overlay():
    """Build ``stats(img_u8, fps, tps, time_scale) -> uint8 img`` on the
    image's device: the debug-mode FPS / TPS / achieved-timescale block at
    (10, 10) (presentation_manager.cpp:154-184; achieved = tps /
    StepsPerSecond * desired)."""
    texts = [encode(t) for t in (" FPS", " TPS", "ACC: ", "x (TGT: ", "x)")]
    consts = {}                 # device -> (atlas, white, the texts' ids)

    def stats(img, fps, tps, time_scale):
        dev = img.device
        if dev not in consts:
            consts[dev] = (torch.from_numpy(_ATLAS).to(dev),
                           _vec(_WHITE, torch.float32, dev),
                           [torch.from_numpy(t).to(dev).long()
                            for t in texts])
        atlas, white, (fps_sfx, tps_sfx, acc_pre, acc_mid, acc_end) = \
            consts[dev]
        fps, tps, time_scale = (_scalar(v, torch.float32, dev)
                                for v in (fps, tps, time_scale))
        imgf = img.to(torch.float32)
        achieved = _div(tps, float(C.STEPS_PER_SECOND)) * time_scale
        l1 = torch.cat([_num_ids(fps, 4, 1), fps_sfx])
        l2 = torch.cat([_num_ids(tps, 4, 1), tps_sfx])
        l3 = torch.cat([acc_pre, _num_ids(achieved, 2, 2), acc_mid,
                        _num_ids(time_scale, 2, 2), acc_end])
        y = 10
        for ids in (l1, l2, l3):
            _blit(imgf, _text_mask(atlas, ids), 10, y, white)
            y += 15
        return torch.clamp(imgf, 0, 255).to(torch.uint8)

    return stats
