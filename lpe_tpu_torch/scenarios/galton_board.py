"""GALTON_BOARD: funnel + triangular peg grid + bins, 55 balls.

reference: src/scenarios/galton_board.cpp:88-384,
include/scenarios/galton_board.hpp:25-110 (derived dimensions in the config
constructor).

The counterpart of ``lpe_tpu/scenarios/galton_board.py``: the same entities
from the same seed, so both packages build bitwise-equal scenes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, FluidConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig,
                           SleepConfig)
from ..core.constants import Phase, ShapeKind, SimulationType
from ..scene import Scene, SceneBuilder
from . import register


@dataclass(frozen=True)
class GaltonBoardConfig:
    ball_diameter: float = 0.05
    particle_count: int = 55
    particle_mass: float = 0.05
    particle_friction: float = 0.05
    peg_rows: int = 10
    peg_radius: float = 0.025
    peg_spacing: float = 0.2
    bin_width: float = 0.15
    wall_thickness: float = 0.05
    wall_friction: float = 0.05

    # derived (reference: galton_board.hpp:89-100)
    @property
    def peg_row_height(self):
        return self.ball_diameter * 3.0

    @property
    def funnel_exit_width(self):
        return self.ball_diameter * 2.0

    @property
    def funnel_height(self):
        return self.ball_diameter * 15.0

    @property
    def funnel_top_width(self):
        return self.ball_diameter * 16.0

    @property
    def particle_drop_height(self):
        return self.ball_diameter * 3.0

    @property
    def board_width(self):
        return (self.peg_rows - 1) * self.peg_spacing + self.ball_diameter * 4.0

    @property
    def board_height(self):
        return (self.peg_rows * self.peg_row_height + self.funnel_height +
                self.particle_drop_height + self.ball_diameter * 10.0)


def make_config(ec: GaltonBoardConfig) -> ScenarioSystemConfig:
    mpp = 5e-3
    shared = SharedSystemConfig(
        universe_size_m=C.SCREEN_LENGTH * mpp, meters_per_pixel=mpp,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
        grid_size=150, cell_size_pixels=C.SCREEN_LENGTH / 150,
        gravitational_softener=0.0, drag_coeff=0.15, particle_density=600.0,
    )
    sleep = SleepConfig(linear_sleep_threshold=-1.0,
                        angular_sleep_threshold=-1.0)
    fluid = FluidConfig(gravity=0.0, rest_density=1000.0, stiffness=3000.0,
                        viscosity=0.1)
    return ScenarioSystemConfig(
        shared=shared, sleep=sleep, fluid=fluid,
        rigid=RigidBodyConfig(broadphase=BroadphaseConfig(max_pairs=2048)))


@register(SimulationType.GALTON_BOARD)
def build(seed: int = 0, ec: GaltonBoardConfig | None = None,
          *, device="cuda") -> Scene:
    ec = ec or GaltonBoardConfig()
    cfg = make_config(ec)
    size = cfg.shared.universe_size_m
    rng = np.random.default_rng(seed)
    b = SceneBuilder("GALTON_BOARD")

    ball_d, ball_r = ec.ball_diameter, ec.ball_diameter / 2.0
    t = ec.wall_thickness
    bcx, bcy = size * 0.5, size * 0.5
    bw, bh = ec.board_width, ec.board_height
    board_top = bcy - bh / 2.0
    particle_start_y = board_top + ec.particle_drop_height / 2.0
    funnel_top_y = particle_start_y + ec.particle_drop_height / 2.0
    funnel_bottom_y = funnel_top_y + ec.funnel_height
    first_peg_row_y = funnel_bottom_y + ec.peg_row_height / 2.0

    def static_poly(cx, cy, pts, friction, color=(80, 80, 80)):
        verts = np.array(pts, np.float64)
        max_r = float(np.sqrt((verts ** 2).sum(-1).max()))
        b.add(pos=(cx, cy), mass=1e30, phase=int(Phase.SOLID), boundary=True,
              shape_kind=int(ShapeKind.POLYGON), radius=max_r, verts=verts,
              has_sleep=True, asleep=True, sleep_counter=9999999,
              static_friction=friction, dynamic_friction=friction, color=color)

    def peg(cx, cy, friction=0.05):
        b.add(pos=(cx, cy), mass=1e30, phase=int(Phase.SOLID), boundary=True,
              shape_kind=int(ShapeKind.CIRCLE), radius=ec.peg_radius,
              has_sleep=True, asleep=True, sleep_counter=9999999,
              static_friction=friction, dynamic_friction=friction,
              color=(120, 120, 120))

    # outer walls + floor (galton_board.cpp:188-224)
    rect = lambda hw, hh: [(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)]
    static_poly(bcx - bw / 2 - t / 2, bcy, rect(t / 2, bh / 2), ec.wall_friction)
    static_poly(bcx + bw / 2 + t / 2, bcy, rect(t / 2, bh / 2), ec.wall_friction)
    static_poly(bcx, bcy + bh / 2 - t / 2, rect(bw / 2 + t, t / 2),
                ec.wall_friction)

    # funnel (galton_board.cpp:227-259)
    half_top = ec.funnel_top_width / 2.0
    half_exit = ec.funnel_exit_width / 2.0
    fh = ec.funnel_height
    left_funnel = [(-half_top, -fh / 2), (-half_exit - t, fh / 2),
                   (-half_exit, fh / 2), (-half_top + t, -fh / 2)]
    right_funnel = [(half_top, -fh / 2), (half_exit + t, fh / 2),
                    (half_exit, fh / 2), (half_top - t, -fh / 2)]
    static_poly(bcx, funnel_top_y + fh / 2, left_funnel, 0.05)
    static_poly(bcx, funnel_top_y + fh / 2, right_funnel, 0.05)

    # pegs (galton_board.cpp:262-283)
    for row in range(ec.peg_rows):
        n_pegs = row + 1
        row_w = (n_pegs - 1) * ec.peg_spacing
        x0 = bcx - row_w / 2.0
        y = first_peg_row_y + row * ec.peg_row_height
        for i in range(n_pegs):
            peg(x0 + i * ec.peg_spacing, y)

    # bin dividers (galton_board.cpp:286-303)
    num_bins = ec.peg_rows + 1
    bins_total = num_bins * ec.bin_width
    bin_base_y = first_peg_row_y + (ec.peg_rows - 1) * ec.peg_row_height + \
        ec.peg_row_height / 2.0
    bin_h = bh - (bin_base_y - board_top)
    div_h = bin_h * 0.9
    bin_x0 = bcx - bins_total / 2.0
    for i in range(num_bins + 1):
        static_poly(bin_x0 + i * ec.bin_width, bin_base_y + div_h / 2,
                    rect(t / 2, div_h / 2), ec.wall_friction)

    # balls in the funnel mouth (galton_board.cpp:306-377)
    usable = ec.funnel_top_width - ball_d * 3.0
    per_row = int(usable / (ball_d * 1.1))
    max_rows = int((bh * 0.2) / (ball_d * 1.1))
    to_create = min(ec.particle_count, per_row * max_rows)
    created, row = 0, 0
    while created < to_create and row < max_rows:
        in_row = min(per_row, to_create - created)
        row_w = in_row * ball_d * 1.1
        x0 = bcx - row_w / 2.0 + ball_d * 0.55
        for i in range(in_row):
            jx = rng.uniform(-ball_d * 0.01, ball_d * 0.01)
            jy = rng.uniform(-ball_d * 0.01, ball_d * 0.01)
            b.add(pos=(x0 + i * ball_d * 1.1 + jx,
                       particle_start_y - row * ball_d * 1.1 + jy),
                  mass=ec.particle_mass, phase=int(Phase.SOLID),
                  shape_kind=int(ShapeKind.CIRCLE), radius=ball_r,
                  inertia=0.5 * ec.particle_mass * ball_r * ball_r,
                  has_sleep=True,
                  static_friction=ec.particle_friction,
                  dynamic_friction=ec.particle_friction,
                  color=(255, 165, 0))
            created += 1
        row += 1

    return b.finalize(cfg, device=device)
