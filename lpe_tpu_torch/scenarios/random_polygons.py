"""RANDOM_POLYGONS: four walls + 100 random polygons/circles under gravity.

The counterpart of ``lpe_tpu/scenarios/random_polygons.py``; its
``make_config`` also sizes ``build_rigid_stacks`` (``bench_scenes.py``).

reference: src/scenarios/random_polygons.cpp:34-216,
include/scenarios/random_polygons.hpp:14-45.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig)
from ..core.constants import Phase, ShapeKind, SimulationType
from ..math.polygon import (build_random_convex_polygon, build_regular_polygon,
                            calculate_polygon_inertia)
from ..scene import Scene, SceneBuilder
from . import register


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


@register(SimulationType.RANDOM_POLYGONS)
def build(seed: int = 0, ec: RandomPolygonsConfig | None = None,
          *, device="cuda") -> Scene:
    ec = ec or RandomPolygonsConfig()
    cfg = make_config(ec)
    size = cfg.shared.universe_size_m
    rng = np.random.default_rng(seed)
    b = SceneBuilder("RANDOM_POLYGONS")

    half_wall = ec.wall_thickness * 0.5
    wf = dict(static_friction=ec.wall_static_friction,
              dynamic_friction=ec.wall_dynamic_friction)
    b.add_wall(0.0, size * 0.5, half_wall, size * 0.5, **wf)
    b.add_wall(size, size * 0.5, half_wall, size * 0.5, **wf)
    b.add_wall(size * 0.5, 0.0, size * 0.5, half_wall, **wf)
    b.add_wall(size * 0.5, size, size * 0.5, half_wall, **wf)

    for _ in range(ec.particle_count):
        x = rng.uniform(size * 0.1, size * 0.9)
        y = rng.uniform(size * 0.1, size * 0.9)
        vel = (rng.uniform(-2, 2) * ec.initial_velocity_factor,
               rng.uniform(-2, 2) * ec.initial_velocity_factor)
        mass = max(0.1, rng.normal(ec.particle_mass_mean,
                                   ec.particle_mass_std_dev))
        shape_type = rng.uniform(0, 1)
        if rng.uniform(0, 1) < ec.small_shape_ratio:
            sz = rng.uniform(ec.small_shape_min, ec.small_shape_max)
        else:
            sz = rng.uniform(ec.large_shape_min, ec.large_shape_max)
        common = dict(
            pos=(x, y), vel=vel, mass=mass, phase=int(Phase.SOLID),
            has_sleep=True, omega=rng.uniform(-2, 2) * 0.5,
            static_friction=ec.particle_static_friction,
            dynamic_friction=ec.particle_dynamic_friction,
            color=tuple(int(v) for v in rng.integers(50, 201, 3)),
        )
        if shape_type < ec.circles_fraction:
            b.add(shape_kind=int(ShapeKind.CIRCLE), radius=sz,
                  inertia=0.5 * mass * sz * sz, **common)
        else:
            if shape_type < ec.circles_fraction + ec.regular_fraction:
                verts = build_regular_polygon(int(rng.integers(3, 9)), sz)
            else:
                verts = build_random_convex_polygon(rng, sz)
            b.add(shape_kind=int(ShapeKind.POLYGON), radius=sz, verts=verts,
                  inertia=calculate_polygon_inertia(verts, mass), **common)

    return b.finalize(cfg, device=device)
