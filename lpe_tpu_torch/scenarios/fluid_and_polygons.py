"""FLUID_AND_POLYGONS: fluid pool at the bottom, pentagons dropped from top.

reference: src/scenarios/fluid_and_polygons.cpp:55-237.

The counterpart of ``lpe_tpu/scenarios/fluid_and_polygons.py``: the same
entities from the same seed, so both packages build bitwise-equal scenes.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, FluidConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig)
from ..core.constants import Phase, ShapeKind, SimulationType
from ..math.polygon import build_regular_polygon, calculate_polygon_inertia
from ..scene import Scene, SceneBuilder
from . import register


@dataclass(frozen=True)
class FluidAndPolygonsConfig:
    fluid_particle_count: int = 1000
    fluid_particle_mass: float = 0.005
    polygon_count: int = 3
    polygon_mass_mean: float = 5.0
    polygon_mass_std_dev: float = 0.2
    floor_static_friction: float = 0.6
    floor_dynamic_friction: float = 0.4
    wall_static_friction: float = 0.2
    wall_dynamic_friction: float = 0.1
    poly_static_friction: float = 0.3
    poly_dynamic_friction: float = 0.1
    wall_thickness: float = 0.1
    wall_mass: float = 1e30
    initial_velocity_scale: float = 0.5


def make_config(ec: FluidAndPolygonsConfig) -> ScenarioSystemConfig:
    mpp = 1e-2
    shared = SharedSystemConfig(
        universe_size_m=C.SCREEN_LENGTH * mpp, meters_per_pixel=mpp,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
        grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50,
        gravitational_softener=0.0, drag_coeff=0.0, particle_density=100.0,
    )
    fluid = dataclasses.replace(FluidConfig(), stiffness=100.0, viscosity=0.005)
    return ScenarioSystemConfig(shared=shared, fluid=fluid,
                                rigid=RigidBodyConfig(
                                    broadphase=BroadphaseConfig(max_pairs=64)))


@register(SimulationType.FLUID_AND_POLYGONS)
def build(seed: int = 0, ec: FluidAndPolygonsConfig | None = None,
          *, device="cuda") -> Scene:
    ec = ec or FluidAndPolygonsConfig()
    cfg = make_config(ec)
    size = cfg.shared.universe_size_m
    rng = np.random.default_rng(seed)
    b = SceneBuilder("FLUID_AND_POLYGONS")

    hw = ec.wall_thickness * 0.5
    b.add_wall(size * 0.5, size, size * 0.5, hw, mass=ec.wall_mass,
               static_friction=ec.floor_static_friction,
               dynamic_friction=ec.floor_dynamic_friction)  # bottom (y=size)
    b.add_wall(size * 0.5, 0.0, size * 0.5, hw, mass=ec.wall_mass,
               static_friction=ec.wall_static_friction,
               dynamic_friction=ec.wall_dynamic_friction)   # top
    b.add_wall(0.0, size * 0.5, hw, size * 0.5, mass=ec.wall_mass,
               static_friction=ec.wall_static_friction,
               dynamic_friction=ec.wall_dynamic_friction)   # left
    b.add_wall(size, size * 0.5, hw, size * 0.5, mass=ec.wall_mass,
               static_friction=ec.wall_static_friction,
               dynamic_friction=ec.wall_dynamic_friction)   # right

    for i in range(ec.polygon_count):
        x = rng.uniform(size * 0.3, size * 0.7)
        y = rng.uniform(size * 0.05, size * 0.2)
        mass = max(0.1, rng.normal(ec.polygon_mass_mean, ec.polygon_mass_std_dev))
        sz = 0.25 + 0.1 * (i % 3)
        verts = build_regular_polygon(5, sz)
        b.add(pos=(x, y),
              vel=(rng.normal(0, ec.initial_velocity_scale) * 0.2,
                   abs(rng.normal(0, ec.initial_velocity_scale))),
              mass=mass, phase=int(Phase.SOLID), has_sleep=True,
              shape_kind=int(ShapeKind.POLYGON), radius=sz, verts=verts,
              inertia=calculate_polygon_inertia(verts, mass),
              static_friction=ec.poly_static_friction,
              dynamic_friction=ec.poly_dynamic_friction,
              color=tuple(int(v) for v in rng.integers(50, 201, 3)))

    n = ec.fluid_particle_count
    x_min, x_max = size * 0.05, size * 0.95
    y_min, y_max = size * 0.85, size * 0.98
    rw, rh = x_max - x_min, y_max - y_min
    aspect = rw / rh
    n_rows = max(1, int(math.sqrt(n / aspect)))
    n_cols = (n + n_rows - 1) // n_rows
    dx = rw / (n_cols + 1)
    dy = rh / (n_rows + 1)
    count = 0
    for row in range(n_rows):
        for col in range(n_cols):
            if count >= n:
                break
            x = x_min + (col + 1) * dx + rng.uniform(-0.1, 0.1) * dx
            y = y_min + (row + 1) * dy + rng.uniform(-0.1, 0.1) * dy
            b.add(pos=(x, y), mass=ec.fluid_particle_mass,
                  phase=int(Phase.LIQUID), shape_kind=int(ShapeKind.CIRCLE),
                  radius=0.02, static_friction=0.0, dynamic_friction=0.0,
                  speed_of_sound=1000.0,
                  color=(20, 20 + (count % 50), 200 + (count % 50)))
            count += 1

    return b.finalize(cfg, device=device)
