"""Benchmark scenes beyond the catalog. Only the SPH dam break is ported so
far; the rigid, galaxy, coupled, highlight and north-star scenes are
ROADMAP.md Queue 1 item 7."""
from __future__ import annotations

import math

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig)
from ..core.constants import Phase, ShapeKind
from ..scene import Scene, SceneBuilder
from .simple_fluid import add_tank_walls


def build_dam_break(n_particles: int = 20000, seed: int = 0, *,
                    device) -> Scene:
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
