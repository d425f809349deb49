"""HOURGLASSES: fluid vs. granular hexagons in two side-by-side hourglasses.

reference: src/scenarios/hourglasses.cpp:86-468,
include/scenarios/hourglasses.hpp:12-42.

The counterpart of ``lpe_tpu/scenarios/hourglasses.py``: the same entities
from the same seed, so both packages build bitwise-equal scenes.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, FluidConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig,
                           SleepConfig)
from ..core.constants import Phase, ShapeKind, SimulationType
from ..math.polygon import calculate_polygon_inertia
from ..scene import Scene, SceneBuilder
from . import register


@dataclass(frozen=True)
class HourglassesConfig:
    fluid_particle_count: int = 300
    fluid_particle_mass: float = 1.0
    fluid_rest_density: float = 60.0
    fluid_particle_size: float = 0.05
    hexagon_count: int = 60
    hexagon_size: float = 0.05
    hexagon_mass: float = 1.0
    hourglass_height: float = 4.0
    hourglass_top_width: float = 2.0
    hourglass_neck_width: float = 0.16
    hourglass_wall_thickness: float = 0.2
    wall_static_friction: float = 0.2
    wall_dynamic_friction: float = 0.1
    poly_static_friction: float = 0.3
    poly_dynamic_friction: float = 0.1
    wall_mass: float = 1e30


def make_config(ec: HourglassesConfig) -> ScenarioSystemConfig:
    mpp = 1e-2
    shared = SharedSystemConfig(
        universe_size_m=C.SCREEN_LENGTH * mpp, meters_per_pixel=mpp,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
        grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50,
        gravitational_softener=0.0, drag_coeff=0.0, particle_density=100.0,
    )
    fluid = dataclasses.replace(FluidConfig(), stiffness=100.0, viscosity=0.05)
    sleep = SleepConfig(linear_sleep_threshold=-1.0,
                        angular_sleep_threshold=-1.0)
    return ScenarioSystemConfig(
        shared=shared, fluid=fluid, sleep=sleep,
        rigid=RigidBodyConfig(broadphase=BroadphaseConfig(max_pairs=2048)))


def hexagon_vertices(size: float) -> np.ndarray:
    """CCW (screen coords) hexagon. reference: hourglasses.cpp:68-84."""
    i = np.arange(6)
    ang = 2.0 * np.pi * (6 - i - 1) / 6
    return np.stack([size * np.cos(ang), size * np.sin(ang)], axis=-1)


def _hourglass_walls(b: SceneBuilder, ec: HourglassesConfig, cx, cy):
    h, tw = ec.hourglass_height, ec.hourglass_top_width
    nw, t = ec.hourglass_neck_width, ec.hourglass_wall_thickness
    ov = 0.03
    left = [(-tw / 2, -h / 2 - ov), (-(tw / 2 + t), -h / 2 - ov),
            (-(nw / 2 + t), 0), (-(tw / 2 + t), h / 2 + ov),
            (-tw / 2, h / 2 + ov), (-nw / 2, 0), (-tw / 2, -h / 2 - ov)]
    right = [(tw / 2, -h / 2 - ov), (nw / 2, 0), (tw / 2, h / 2 + ov),
             ((tw / 2 + t), h / 2 + ov), ((nw / 2 + t), 0),
             ((tw / 2 + t), -h / 2 - ov), (tw / 2, -h / 2 - ov)]
    top = [(-tw / 2 - t, -h / 2 - t), (-tw / 2 - t, -h / 2 + ov),
           (tw / 2 + t, -h / 2 + ov), (tw / 2 + t, -h / 2 - t)]
    bot = [(-tw / 2 - t, h / 2 - ov), (-tw / 2 - t, h / 2 + t),
           (tw / 2 + t, h / 2 + t), (tw / 2 + t, h / 2 - ov)]
    for pts in (left, right, top, bot):
        verts = np.array(pts, np.float64)
        max_r = float(np.sqrt((verts ** 2).sum(-1).max()))
        b.add(pos=(cx, cy), mass=ec.wall_mass, phase=int(Phase.SOLID),
              boundary=True, shape_kind=int(ShapeKind.POLYGON), radius=max_r,
              verts=verts, has_sleep=True, asleep=True, sleep_counter=9999999,
              static_friction=ec.wall_static_friction,
              dynamic_friction=ec.wall_dynamic_friction,
              color=(128, 128, 128))


@register(SimulationType.HOURGLASSES)
def build(seed: int = 0, ec: HourglassesConfig | None = None,
          *, device="cuda") -> Scene:
    ec = ec or HourglassesConfig()
    cfg = make_config(ec)
    size = cfg.shared.universe_size_m
    rng = np.random.default_rng(seed)
    b = SceneBuilder("HOURGLASSES")

    left_x, right_x, hg_y = size * 0.3, size * 0.7, size * 0.5
    _hourglass_walls(b, ec, left_x, hg_y)
    _hourglass_walls(b, ec, right_x, hg_y)

    def jitter():
        return rng.uniform(-0.05, 0.05)

    # Fluid in left hourglass (top chamber trapezoid fill)
    h, tw, nw = ec.hourglass_height, ec.hourglass_top_width, ec.hourglass_neck_width
    r = ec.fluid_particle_size / 2.0
    margin = max(tw * 0.05, r * 1.1)
    x_min = left_x - tw / 2 + margin
    x_max = left_x + tw / 2 - margin
    y_min = hg_y - h / 2 + margin
    y_max = hg_y - 0.1
    rw, rh = x_max - x_min, y_max - y_min
    aspect = rw / rh
    n_rows = max(1, int(math.sqrt(ec.fluid_particle_count / aspect)))
    n_cols = (ec.fluid_particle_count + n_rows - 1) // n_rows
    dx = rw / (n_cols + 1) * 1.1
    dy = rh / (n_rows + 1) * 1.1
    half_top = tw / 2 - margin
    half_neck = nw / 2
    chamber_h = h / 2 - margin

    def add_fluid(x, y, count):
        b.add(pos=(x, y), mass=ec.fluid_particle_mass, phase=int(Phase.LIQUID),
              shape_kind=int(ShapeKind.CIRCLE), radius=r,
              static_friction=0.0, dynamic_friction=0.0,
              speed_of_sound=1000.0, color=(20, 100, 220))

    count = 0
    for row in range(n_rows):
        if count >= ec.fluid_particle_count:
            break
        y = y_min + (row + 1) * dy
        progress = (y - y_min) / chamber_h
        half_w = half_top - progress * (half_top - half_neck)
        row_xmin = left_x - half_w + margin
        row_xmax = left_x + half_w - margin
        row_w = row_xmax - row_xmin
        if row_w < 2 * margin:
            continue
        cols = max(1, int((row_w / rw) * n_cols))
        row_dx = row_w / (cols + 1)
        for col in range(cols):
            if count >= ec.fluid_particle_count:
                break
            add_fluid(row_xmin + (col + 1) * row_dx + jitter() * row_dx * 0.1,
                      y + jitter() * dy * 0.1, count)
            count += 1
    if count < ec.fluid_particle_count:
        remaining = ec.fluid_particle_count - count
        fy_min, fy_max = y_min, y_min + rh * 0.33
        f_half = tw / 2 - margin
        f_w = 2 * f_half
        f_cols = max(1, int(math.sqrt(remaining)))
        f_rows = (remaining + f_cols - 1) // f_cols
        fdx = f_w / (f_cols + 1)
        fdy = (fy_max - fy_min) / (f_rows + 1)
        for row in range(f_rows):
            for col in range(f_cols):
                if count >= ec.fluid_particle_count:
                    break
                add_fluid(left_x - f_half + (col + 1) * fdx + jitter() * fdx * 0.1,
                          fy_min + (row + 1) * fdy + jitter() * fdy * 0.1, count)
                count += 1

    # Hexagons in right hourglass
    hs = ec.hexagon_size
    margin2 = tw * 0.15
    hx_min = right_x - tw / 2 + margin2
    hx_max = right_x + tw / 2 - margin2
    hy_min = hg_y - h / 2 + margin2
    hy_max = hg_y - hs
    hrw, hrh = hx_max - hx_min, hy_max - hy_min
    aspect2 = hrw / hrh
    hn_rows = max(1, int(math.sqrt(ec.hexagon_count / aspect2)))
    hn_cols = (ec.hexagon_count + hn_rows - 1) // hn_rows
    hdy = hrh / (hn_rows + 1)
    half_top2 = tw / 2 - margin2
    chamber_h2 = h / 2 - margin2
    hex_verts = hexagon_vertices(hs)
    hex_inertia = calculate_polygon_inertia(hex_verts, ec.hexagon_mass)

    hcount = 0
    for row in range(hn_rows):
        if hcount >= ec.hexagon_count:
            break
        y = hy_min + (row + 1) * hdy
        progress = (y - hy_min) / chamber_h2
        half_w = half_top2 - progress * (half_top2 - half_neck)
        row_xmin = right_x - half_w + hs
        row_xmax = right_x + half_w - hs
        row_w = row_xmax - row_xmin
        if row_w < 2 * hs:
            continue
        cols = max(1, int((row_w / hrw) * hn_cols))
        row_dx = row_w / (cols + 1)
        for col in range(cols):
            if hcount >= ec.hexagon_count:
                break
            cr = int(rng.integers(100, 201)) + 55
            cg = int(rng.integers(100, 201)) - 50
            b.add(pos=(row_xmin + (col + 1) * row_dx + jitter() * row_dx * 0.2,
                       y + jitter() * hdy * 0.2),
                  mass=ec.hexagon_mass, phase=int(Phase.SOLID), has_sleep=True,
                  shape_kind=int(ShapeKind.POLYGON), radius=hs, verts=hex_verts,
                  inertia=hex_inertia,
                  static_friction=ec.poly_static_friction,
                  dynamic_friction=ec.poly_dynamic_friction,
                  color=(min(cr, 255), cg, 30))
            hcount += 1

    return b.finalize(cfg, device=device)
