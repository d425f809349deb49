"""SimManager: the app shell / main loop.

The counterpart of ``lpe_tpu/app/sim_manager.py``: the reference's public
surface (include/sim_manager.hpp:36-81 -> run/init/togglePause/
resetSimulator/stepOnce/setTimeScale/setColorScheme/selectScenario) on a
headless simulation resident on one device. ``run`` runs free (as fast as
possible, the benchmark mode) or paced to real time (120 ticks/s,
src/sim_manager.cpp:38-116), and pulls frames from the device only when a
sink is attached.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import constants as C
from ..core.profiler import PROFILER
from ..render.frame import SCHEME_DEFAULT, make_renderer
from ..scenarios import create_scenario
from ..state import SimState
from ..systems import build_tick_fn


@dataclass
class LoopStats:
    ticks: int = 0
    frames: int = 0
    ticks_per_sec: float = 0.0
    frames_per_sec: float = 0.0
    actual_time_scale: float = 0.0


class SimManager:
    """Owns the scenario, its tick function, pause/step/speed state."""

    def __init__(self, scenario=C.SimulationType.KEPLERIAN_DISK, seed: int = 0,
                 color_scheme: int = SCHEME_DEFAULT, debug: bool = False,
                 device="cuda"):
        self.device = torch.device(device)
        self.paused = False
        self.step_frame = False
        self.color_scheme = color_scheme
        self.debug = debug
        self._renderer = None
        self._hud = None
        self.stats = LoopStats()
        self.select_scenario(scenario, seed=seed)

    # -- reference API surface ------------------------------------------
    def select_scenario(self, scenario, seed: int = 0):
        """reference: src/sim_manager.cpp:173-184."""
        self.scenario_type = scenario
        self.scene = create_scenario(scenario, seed=seed, device=self.device)
        # no system writes into a state's tensors, so the initial state
        # stays as it was built for reset_simulator
        self._initial_state = self.scene.state
        self.state: SimState = self.scene.state
        self.tick_fn = build_tick_fn(self.scene.spec, self.scene.cfg,
                                     device=self.device)
        self._renderer = None

    def reset_simulator(self):
        """Rebuild entities, preserving timeScale (reference: src/sim.cpp:81-101)."""
        ts = self.state.time_scale
        bta = self.state.base_time_accel
        self.state = self._initial_state.replace(time_scale=ts,
                                                 base_time_accel=bta)

    def toggle_pause(self):
        self.paused = not self.paused

    def step_once(self):
        self.paused = True
        self.step_frame = True

    def set_time_scale(self, scale: float):
        self.state = self.state.replace(time_scale=torch.full(
            (), scale, dtype=self.state.time_scale.dtype,
            device=self.state.time_scale.device))

    def set_color_scheme(self, scheme: int):
        self.color_scheme = scheme
        self._renderer = None

    def toggle_debug(self):
        """Debug overlay toggle (reference: event_manager.cpp DEBUG_TOGGLE)."""
        self.debug = not self.debug
        self._renderer = None

    # -- stepping & rendering -------------------------------------------
    def sync(self):
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, n: int = 1):
        with PROFILER.scope("tick"):
            for _ in range(n):
                self.state = self.tick_fn(self.state)
            self.stats.ticks += n

    def trace(self, log_dir: str, ticks: int = 10):
        """Capture a profile of ``ticks`` ticks (torch.profiler, CPU and,
        on a card, CUDA activity) and write it to ``log_dir/trace.json``
        as a Chrome trace. The counterpart of the reference's hierarchical
        profiler printouts for the device's part of a tick (host-side
        phases are covered by core/profiler.py scopes)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            self.tick(ticks)
            self.sync()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        return log_dir

    def _frame(self, width: int, height: int) -> torch.Tensor:
        if self._renderer is None:
            self._renderer = make_renderer(self.scene.spec, self.scene.cfg,
                                           width=width, height=height,
                                           color_scheme=self.color_scheme,
                                           debug=self.debug)
        with PROFILER.scope("render"):
            return self._renderer(self.state)

    def render_frame(self, width: int = 600, height: int = 600) -> np.ndarray:
        return self._frame(width, height).cpu().numpy()

    def render_frame_with_ui(self, width: int = 600, height: int = 600,
                             highlight: int = 0) -> np.ndarray:
        """Sim frame + the reference's right-hand button panel, plus the
        debug-mode FPS/TPS/achieved-timescale stats block — the full
        window the reference presents every frame
        (src/presentation_manager.cpp:96-137 presentFrame ->
        renderUI/renderStatsInternal). [height, width + PANEL_W, 3]."""
        from ..render.hud import make_hud, make_stats_overlay

        if self._hud is None:
            names = tuple(C.get_scenario_name(s)
                          for s in C.get_all_scenarios())
            self._hud = make_hud(names, height=height, device=self.device)
            self._stats_overlay = make_stats_overlay()
            self._scenario_list = list(C.get_all_scenarios())
        frame = self._frame(width, height)
        ts = self.state.time_scale.to(torch.float32)
        if self.debug:
            frame = self._stats_overlay(frame, self.stats.frames_per_sec,
                                        self.stats.ticks_per_sec, ts)
        panel = self._hud(self.paused, ts, self.color_scheme, self.debug,
                          self._scenario_list.index(self.scenario_type),
                          highlight)
        return torch.cat([frame, panel], dim=1).cpu().numpy()

    def run(self, ticks: int = C.STEPS_PER_SECOND, *, realtime: bool = False,
            frame_sink=None, frame_every: int = 2, print_profile: bool = False):
        """Fixed-dt loop. ``frame_sink(frame_u8, tick_idx)`` gets a frame
        every ``frame_every`` ticks (120 TPS / 2 = 60 FPS parity)."""
        spt = 1.0 / C.STEPS_PER_SECOND
        t_wall = time.perf_counter()
        window_t, window_ticks = t_wall, 0
        done = 0
        while done < ticks:
            if self.paused and not self.step_frame:
                break
            self.step_frame = False
            self.tick()
            done += 1
            window_ticks += 1
            if frame_sink is not None and done % frame_every == 0:
                frame_sink(self.render_frame(), done)
                self.stats.frames += 1
            now = time.perf_counter()
            if realtime:
                target = t_wall + done * spt
                if now < target:
                    time.sleep(target - now)
            if now - window_t >= 0.5:       # stats window, sim_manager.cpp:96-107
                self.stats.ticks_per_sec = window_ticks / (now - window_t)
                self.stats.actual_time_scale = (
                    self.stats.ticks_per_sec / C.STEPS_PER_SECOND *
                    float(self.state.base_time_accel) *
                    float(self.state.time_scale))
                window_t, window_ticks = now, 0
        self.sync()
        if print_profile:
            print(PROFILER.report())
        return self.stats
