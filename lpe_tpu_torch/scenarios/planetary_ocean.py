"""PLANETARY_OCEAN: binary planets with an SPH ocean ring, n-body gravity.

The counterpart of ``lpe_tpu/scenarios/planetary_ocean.py``.

reference: src/scenarios/planetary_ocean.cpp:16-271,
include/scenarios/planetary_ocean.hpp:15-41.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, FluidConfig, FluidGridConfig,
                           FluidImpulseSolverConfig, FluidNumericalConfig,
                           FluidPositionSolverConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig)
from ..core.constants import Phase, ShapeKind, SimulationType
from ..scene import Scene, SceneBuilder
from . import register


@dataclass(frozen=True)
class PlanetaryOceanConfig:
    planet_radius: float = 60000.0
    planet_mass: float = 7.0e24
    ocean_particle_count: int = 1000
    ocean_particle_mass: float = 1.0e12
    ocean_depth: float = 10000.0
    ocean_layers: int = 2
    fluid_particle_radius: float = 2000.0
    moon_radius: float = 60000.0
    moon_mass: float = 3.5e24
    binary_distance: float = 350000.0
    fluid_rest_density: float = 1000.0


def make_config(ec: PlanetaryOceanConfig) -> ScenarioSystemConfig:
    planet_radius_pixels = 70.0
    mpp = ec.planet_radius / planet_radius_pixels * 2
    shared = SharedSystemConfig(
        universe_size_m=C.SCREEN_LENGTH * mpp, meters_per_pixel=mpp,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=5.0,
        grid_size=100, cell_size_pixels=C.SCREEN_LENGTH / 100,
        gravitational_softener=ec.planet_radius * 0.01, drag_coeff=0.0,
        particle_density=ec.fluid_rest_density,
    )
    fluid = FluidConfig(
        gravity=0.0, rest_density=100.0, stiffness=1000.0, viscosity=0.5,
        position_solver=FluidPositionSolverConfig(
            safety_margin=ec.fluid_particle_radius, relax_factor=0.5,
            max_correction=ec.fluid_particle_radius,
            velocity_damping=0.00001),
        impulse_solver=FluidImpulseSolverConfig(
            buoyancy_strength=0.0, fluid_force_scale=100.0, depth_scale=0.1),
        grid=FluidGridConfig(grid_epsilon=1e-8,
                             smoothing_length=ec.fluid_particle_radius * 4.0,
                             boundary_offset=100.0),
        numerical=FluidNumericalConfig(min_distance_threshold=1e-10,
                                       min_density_threshold=1e-8),
        damping_factor=1.0,
    )
    return ScenarioSystemConfig(shared=shared, fluid=fluid,
                                rigid=RigidBodyConfig(
                                    broadphase=BroadphaseConfig(max_pairs=4)))


@register(SimulationType.PLANETARY_OCEAN)
def build(seed: int = 0, ec: PlanetaryOceanConfig | None = None, *,
          device="cuda") -> Scene:
    ec = ec or PlanetaryOceanConfig()
    cfg = make_config(ec)
    size = cfg.shared.universe_size_m
    rng = np.random.default_rng(seed)
    b = SceneBuilder("PLANETARY_OCEAN")

    cx, cy = size * 0.5, size * 0.5
    half = ec.binary_distance * 0.5
    G = 6.67430e-11  # reference uses this local constant, not RealG
    total = ec.planet_mass + ec.moon_mass
    v_orb = math.sqrt(G * total / ec.binary_distance) / 6

    # planet (left), moving up (-y)
    b.add(pos=(cx - half, cy), vel=(0.0, -v_orb), mass=ec.planet_mass,
          phase=int(Phase.SOLID), shape_kind=int(ShapeKind.CIRCLE),
          radius=ec.planet_radius, color=(30, 150, 50))
    # moon = planet1 position + binary distance, moving down (+y)
    moon_pos = (cx - half + ec.binary_distance, cy)
    b.add(pos=moon_pos, vel=(0.0, v_orb), mass=ec.moon_mass,
          phase=int(Phase.SOLID), shape_kind=int(ShapeKind.CIRCLE),
          radius=ec.moon_radius, color=(30, 100, 200))

    # ocean around the moon only (reference comments out the planet's ocean)
    per_layer = ec.ocean_particle_count // ec.ocean_layers
    created = 0
    for layer in range(ec.ocean_layers):
        layer_r = ec.planet_radius + layer * ec.ocean_depth / ec.ocean_layers
        astep = 2.0 * C.PI / per_layer
        for i in range(per_layer):
            if created >= ec.ocean_particle_count:
                break
            ang = i * astep
            jr = layer_r * (1.0 + rng.uniform(-0.2, 0.2) * 0.05)
            ja = ang + rng.uniform(-0.2, 0.2) * astep * 0.1
            x = moon_pos[0] + jr * math.cos(ja)
            y = moon_pos[1] + jr * math.sin(ja)
            b.add(pos=(x, y), vel=(0.0, v_orb), mass=ec.ocean_particle_mass,
                  phase=int(Phase.LIQUID), shape_kind=int(ShapeKind.CIRCLE),
                  radius=ec.fluid_particle_radius,
                  static_friction=0.0, dynamic_friction=0.0,
                  speed_of_sound=1000.0, color=(0, 150, 255))
            created += 1

    return b.finalize(cfg, device=device)
