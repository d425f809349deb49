"""KEPLERIAN_DISK: central 1e36 kg body + 999 orbiting gas particles.

The counterpart of ``lpe_tpu/scenarios/keplerian_disk.py``; with a larger
``particle_count`` it is ``bench_scenes.build_galaxy``.

reference: src/scenarios/keplerian_disk.cpp:13-148,
include/scenarios/keplerian_disk.hpp:15-41.
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
class KeplerianDiskConfig:
    central_mass: float = 1e36
    inner_radius_pixels: float = 100.0
    outer_radius_factor: float = 2.5
    height_scale_factor: float = 20.0
    height_power_law: float = 1.25
    density_power_law: float = 15.0 / 8.0
    particle_mass_mean: float = 1e22
    particle_mass_std_dev: float = 1e21
    mass_radial_power_law: float = 0.5
    orbital_period_fraction: float = 5.0
    velocity_dispersion_factor: float = 0.01
    radial_velocity_factor: float = 0.001
    particle_count: int = 1000


def make_config(ec: KeplerianDiskConfig) -> ScenarioSystemConfig:
    mpp = 1e7
    size = C.SCREEN_LENGTH * mpp
    inner_r = ec.inner_radius_pixels * mpp
    period = 2 * C.PI * math.sqrt(inner_r ** 3 / (C.REAL_G * ec.central_mass))
    shared = SharedSystemConfig(
        universe_size_m=size, meters_per_pixel=mpp,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND,
        time_acceleration=period / (ec.orbital_period_fraction *
                                    C.STEPS_PER_SECOND) * 20.0,
        grid_size=100, cell_size_pixels=C.SCREEN_LENGTH / 100,
        gravitational_softener=2e7, drag_coeff=1e-11, particle_density=0.1,
    )
    return ScenarioSystemConfig(shared=shared, rigid=RigidBodyConfig(
        broadphase=BroadphaseConfig(max_pairs=8)))


@register(SimulationType.KEPLERIAN_DISK)
def build(seed: int = 0, ec: KeplerianDiskConfig | None = None, *,
          device="cuda") -> Scene:
    ec = ec or KeplerianDiskConfig()
    cfg = make_config(ec)
    sh = cfg.shared
    rng = np.random.default_rng(seed)
    b = SceneBuilder("KEPLERIAN_DISK")

    cx = cy = (C.SCREEN_LENGTH / 2.0) * sh.meters_per_pixel
    body_size = 2.0 * sh.meters_per_pixel
    b.add(pos=(cx, cy), mass=ec.central_mass, phase=int(Phase.GAS),
          shape_kind=int(ShapeKind.CIRCLE), radius=body_size,
          color=(255, 255, 0))

    min_rpix = ec.inner_radius_pixels
    max_rpix = C.SCREEN_LENGTH / ec.outer_radius_factor
    min_rm = min_rpix * sh.meters_per_pixel

    def disk_height(rpix):
        scale = ec.inner_radius_pixels / ec.height_scale_factor
        return scale * (rpix / ec.inner_radius_pixels) ** ec.height_power_law

    def disk_density(rpix):
        return (ec.inner_radius_pixels / rpix) ** ec.density_power_law

    created = 0
    while created < ec.particle_count - 1:
        while True:
            rpix = rng.uniform(min_rpix, max_rpix)
            if rng.uniform(0, 1) <= disk_density(rpix):
                break
        rm = rpix * sh.meters_per_pixel
        angle = rng.uniform(0, 2 * C.PI)
        max_hm = disk_height(rpix) * sh.meters_per_pixel
        h_off = rng.normal(0.0, max_hm / 3.0)
        x = cx + rm * math.cos(angle)
        y = cy + rm * math.sin(angle) + h_off
        base_vel = math.sqrt(C.REAL_G * ec.central_mass / rm)
        speed = base_vel * rng.normal(1.0, ec.velocity_dispersion_factor)
        vx = -speed * math.sin(angle)
        vy = speed * math.cos(angle)
        rv = rng.normal(0.0, speed * ec.radial_velocity_factor)
        vx += rv * math.cos(angle)
        vy += rv * math.sin(angle)
        mass_factor = (min_rm / rm) ** ec.mass_radial_power_law
        mass = rng.normal(mass_factor * ec.particle_mass_mean,
                          ec.particle_mass_std_dev)
        b.add(pos=(x, y), vel=(vx, vy), mass=mass, phase=int(Phase.GAS),
              shape_kind=int(ShapeKind.CIRCLE),
              radius=sh.meters_per_pixel * 0.5, color=(255, 255, 255))
        created += 1

    return b.finalize(cfg, device=device)
