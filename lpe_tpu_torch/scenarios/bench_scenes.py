"""Benchmark scenes beyond the catalog: the SPH dam break and the rigid
stacking stress. The north-star scene is ROADMAP.md Queue 1 item 1; the
galaxy, coupled and highlight scenes are item 3."""
from __future__ import annotations

import math

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig)
from ..core.constants import Phase, ShapeKind
from ..math.polygon import (build_random_convex_polygon,
                            calculate_polygon_inertia)
from ..scene import Scene, SceneBuilder
from .simple_fluid import add_tank_walls


def build_dam_break(n_particles: int = 20000, seed: int = 0, *,
                    device="cuda") -> Scene:
    """Dam break: a fluid column in the left third of the tank collapses.

    Uses the SIMPLE_FLUID solver configuration. The universe scales with
    sqrt(N) so particle spacing — and therefore the local SPH regime — is
    N-invariant (``lpe_tpu/scenarios/bench_scenes.py`` build_dam_break)."""
    scale = math.sqrt(n_particles / 20000.0)
    size = 6.0 * scale
    mpp = size / C.SCREEN_LENGTH
    shared = SharedSystemConfig(
        universe_size_m=size, meters_per_pixel=mpp,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
        grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50,
    )
    cfg = ScenarioSystemConfig(shared=shared, rigid=RigidBodyConfig(
        broadphase=BroadphaseConfig(max_pairs=8)))
    rng = np.random.default_rng(seed)
    b = SceneBuilder(f"DAM_BREAK_{n_particles}")
    add_tank_walls(b, size, 0.05 * scale, 1e30, 0.0, 0.0)

    # margins scale with the universe so particle spacing is N-invariant
    x_min, x_max = 0.16 * scale, size * 0.35
    y_min, y_max = size * 0.2, size - 0.16 * scale
    area = (x_max - x_min) * (y_max - y_min)
    spacing = math.sqrt(area / n_particles)
    # mass chosen so the column's density matches SIMPLE_FLUID's operating
    # point (1000 particles of 0.005 kg at 0.0742 m spacing)
    mass = 0.005 * (spacing / 0.0742) ** 2
    n_cols = int((x_max - x_min) / spacing)
    n_rows = (n_particles + n_cols - 1) // n_cols
    count = 0
    for row in range(n_rows):
        for col in range(n_cols):
            if count >= n_particles:
                break
            x = x_min + (col + 0.5) * spacing + rng.uniform(-0.05, 0.05) * spacing
            y = y_max - (row + 0.5) * spacing + rng.uniform(-0.05, 0.05) * spacing
            b.add(pos=(x, y), mass=mass, phase=int(Phase.LIQUID),
                  shape_kind=int(ShapeKind.CIRCLE), radius=0.02,
                  static_friction=0.0, dynamic_friction=0.0,
                  color=(20, 20 + count % 50, 200 + count % 55))
            count += 1
    return b.finalize(cfg, device=device)


def build_rigid_stacks(n_bodies: int = 1000, seed: int = 0, *,
                       device="cuda") -> Scene:
    """Rigid stacking stress: four walls and ``n_bodies`` random convex
    polygons raining down (``lpe_tpu/scenarios/bench_scenes.py``
    build_rigid_stacks; ``bench.py``'s ``rigid`` config at 10000). Above
    ``broadphase.dense_max_solids`` solids it runs the grid rigid
    pipeline."""
    from .random_polygons import RandomPolygonsConfig, make_config
    ec = RandomPolygonsConfig(particle_count=n_bodies, small_shape_min=0.05,
                              small_shape_max=0.12)
    cfg = make_config(ec).replace(rigid=RigidBodyConfig(
        broadphase=BroadphaseConfig(max_pairs=max(1024, 4 * n_bodies),
                                    # settling stacks rebuild rarely: skip
                                    # the grid build on quiet ticks
                                    persist_slack_m=0.04)))
    size = cfg.shared.universe_size_m
    rng = np.random.default_rng(seed)
    b = SceneBuilder(f"RIGID_STACKS_{n_bodies}")
    b.add_wall(0.0, size * 0.5, 0.05, size * 0.5)
    b.add_wall(size, size * 0.5, 0.05, size * 0.5)
    b.add_wall(size * 0.5, 0.0, size * 0.5, 0.05)
    b.add_wall(size * 0.5, size, size * 0.5, 0.05)
    for _ in range(n_bodies):
        sz = rng.uniform(0.05, 0.12)
        verts = build_random_convex_polygon(rng, sz)
        mass = max(0.1, rng.normal(1.0, 0.1))
        b.add(pos=(rng.uniform(size * 0.05, size * 0.95),
                   rng.uniform(size * 0.05, size * 0.95)),
              vel=(rng.uniform(-1, 1), rng.uniform(-1, 1)),
              mass=mass, phase=int(Phase.SOLID), has_sleep=True,
              shape_kind=int(ShapeKind.POLYGON), radius=sz, verts=verts,
              inertia=calculate_polygon_inertia(verts, mass),
              omega=rng.uniform(-1, 1),
              color=tuple(int(v) for v in rng.integers(50, 201, 3)))
    return b.finalize(cfg, device=device)
