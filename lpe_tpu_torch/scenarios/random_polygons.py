"""RANDOM_POLYGONS: its configuration only.

``build_rigid_stacks`` (``bench_scenes.py``) sizes its solver and universe
with this scenario's ``make_config``, as ``lpe_tpu`` does. The catalog
scenario itself runs the rigid list pipeline, which is not ported yet
(ROADMAP.md Queue 1 item 5).

reference: src/scenarios/random_polygons.cpp:34-216,
include/scenarios/random_polygons.hpp:14-45.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core import constants as C
from ..core.config import (BroadphaseConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig)


@dataclass(frozen=True)
class RandomPolygonsConfig:
    circles_fraction: float = 0.0
    regular_fraction: float = 0.6
    small_shape_ratio: float = 0.90
    small_shape_min: float = 0.1
    small_shape_max: float = 0.25
    large_shape_min: float = 0.3
    large_shape_max: float = 0.5
    wall_static_friction: float = 0.2
    wall_dynamic_friction: float = 0.1
    particle_static_friction: float = 0.3
    particle_dynamic_friction: float = 0.1
    particle_count: int = 100
    particle_mass_mean: float = 1.0
    particle_mass_std_dev: float = 0.1
    initial_velocity_factor: float = 1.0
    wall_thickness: float = 0.1


def make_config(ec: RandomPolygonsConfig) -> ScenarioSystemConfig:
    mpp = 1e-2
    shared = SharedSystemConfig(
        universe_size_m=C.SCREEN_LENGTH * mpp, meters_per_pixel=mpp,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
        grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50,
        gravitational_softener=0.0, drag_coeff=0.0, particle_density=0.5,
    )
    return ScenarioSystemConfig(shared=shared, rigid=RigidBodyConfig(
        broadphase=BroadphaseConfig(max_pairs=1024)))
