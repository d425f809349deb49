"""SIMPLE_FLUID: a tank of 1000 SPH particles inside four walls.

reference: src/scenarios/simple_fluid.cpp:60-165,
include/scenarios/simple_fluid.hpp:15-34.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig)
from ..core.constants import Phase, ShapeKind, SimulationType
from ..scene import Scene, SceneBuilder
from . import register


@dataclass(frozen=True)
class SimpleFluidConfig:
    fluid_particle_count: int = 1000
    fluid_particle_mass: float = 0.005
    fluid_rest_density: float = 1000.0   # feeds shared.particle_density only
    wall_thickness: float = 0.1
    wall_mass: float = 1e30
    fluid_static_friction: float = 0.0
    fluid_dynamic_friction: float = 0.0
    fluid_region_min_x: float = 0.3
    fluid_region_max_x: float = 0.7
    fluid_region_min_y: float = 0.3
    fluid_region_max_y: float = 0.7


def make_config(ec: SimpleFluidConfig) -> ScenarioSystemConfig:
    mpp = 1e-2
    shared = SharedSystemConfig(
        universe_size_m=C.SCREEN_LENGTH * mpp, meters_per_pixel=mpp,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
        grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50,
        gravitational_softener=0.0, drag_coeff=0.0,
        particle_density=ec.fluid_rest_density,
    )
    # fluid solver params stay at FluidConfig defaults (the reference's
    # SimpleFluid scenario does not override fluidConfig)
    return ScenarioSystemConfig(shared=shared, rigid=RigidBodyConfig(
        broadphase=BroadphaseConfig(max_pairs=8)))


def add_tank_walls(b: SceneBuilder, size: float, half_wall: float, mass,
                   sf, df):
    b.add_wall(0.0, size * 0.5, half_wall, size * 0.5, mass=mass,
               static_friction=sf, dynamic_friction=df)
    b.add_wall(size, size * 0.5, half_wall, size * 0.5, mass=mass,
               static_friction=sf, dynamic_friction=df)
    b.add_wall(size * 0.5, 0.0, size * 0.5, half_wall, mass=mass,
               static_friction=sf, dynamic_friction=df)
    b.add_wall(size * 0.5, size, size * 0.5, half_wall, mass=mass,
               static_friction=sf, dynamic_friction=df)


@register(SimulationType.SIMPLE_FLUID)
def build(seed: int = 0, ec: SimpleFluidConfig | None = None, *,
          device) -> Scene:
    ec = ec or SimpleFluidConfig()
    cfg = make_config(ec)
    size = cfg.shared.universe_size_m
    rng = np.random.default_rng(seed)
    b = SceneBuilder("SIMPLE_FLUID")

    add_tank_walls(b, size, ec.wall_thickness * 0.5, ec.wall_mass,
                   ec.fluid_static_friction, ec.fluid_dynamic_friction)

    n = ec.fluid_particle_count
    x_min, x_max = size * ec.fluid_region_min_x, size * ec.fluid_region_max_x
    y_min, y_max = size * ec.fluid_region_min_y, size * ec.fluid_region_max_y
    n_cols = int(math.sqrt(n))
    n_rows = (n + n_cols - 1) // n_cols
    dx = (x_max - x_min) / (n_cols + 1)
    dy = (y_max - y_min) / (n_rows + 1)
    count = 0
    for row in range(n_rows):
        for col in range(n_cols):
            if count >= n:
                break
            x = x_min + (col + 1) * dx + rng.uniform(-0.1, 0.1) * dx
            y = y_min + (row + 1) * dy + rng.uniform(-0.1, 0.1) * dy
            b.add(pos=(x, y), mass=ec.fluid_particle_mass,
                  phase=int(Phase.LIQUID), shape_kind=int(ShapeKind.CIRCLE),
                  radius=0.02, static_friction=ec.fluid_static_friction,
                  dynamic_friction=ec.fluid_dynamic_friction,
                  speed_of_sound=1000.0,
                  color=(20, 20 + (count % 50), 200 + (count % 55)))
            count += 1

    return b.finalize(cfg, device=device)
