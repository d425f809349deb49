"""Benchmark scenes beyond the catalog (``lpe_tpu/scenarios/
bench_scenes.py``): the SPH dam break, the rigid stacking stress, the
north star (the dam spilling into 10k small polygons), the highlight reel
and the coupled dam. The galaxy needs gravity (ROADMAP.md Queue 1 item
4)."""
from __future__ import annotations

import math

import numpy as np

from ..core import constants as C
from ..core.config import (BroadphaseConfig, RigidBodyConfig,
                           ScenarioSystemConfig, SharedSystemConfig)
from ..core.constants import Phase, ShapeKind
from ..math.polygon import (build_random_convex_polygon,
                            build_regular_polygon, calculate_polygon_inertia)
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


def build_north_star(n_fluid: int = 100000, n_rigid: int = 10000,
                     seed: int = 0, *,
                     device="cuda") -> Scene:
    """The north-star workload (BASELINE.md): the dam-break column (100k
    SPH) collapsing into a field of 10k small rigid convex polygons in
    its spill path. The fluid half is DAM_BREAK's regime, the rigid half
    RIGID_STACKS' solver config; the rigids are smaller than the stacking
    stress's 0.05-0.12 m so that 10k of them fit beside the column, and
    their masses scale with body area so that the fluid can plough them.
    Above ``dense_max_solids`` solids it runs the grid rigid pipeline."""
    base = build_dam_break(n_fluid, seed=seed, device=device)
    scale = math.sqrt(n_fluid / 20000.0)
    size = base.cfg.shared.universe_size_m
    rng = np.random.default_rng(seed + 3)
    b = SceneBuilder(f"NORTH_STAR_{n_fluid}_{n_rigid}")
    add_tank_walls(b, size, 0.05 * scale, 1e30, 0.0, 0.0)
    # rigid field: dense jittered grid in the right 55% of the tank — the
    # dam spill ploughs into it (two-way coupling at full contact density)
    x_lo, x_hi = size * 0.42, size * 0.97
    y_lo, y_hi = size * 0.03, size * 0.9
    n_cols = int(math.sqrt(n_rigid * (x_hi - x_lo) / (y_hi - y_lo)))
    sx = (x_hi - x_lo) / n_cols
    sz_lo, sz_hi = 0.015, min(0.035, 0.45 * sx)
    count = 0
    row = 0
    while count < n_rigid:
        for col in range(n_cols):
            if count >= n_rigid:
                break
            sz = rng.uniform(sz_lo, sz_hi)
            verts = build_random_convex_polygon(rng, sz)
            mass = max(0.02, rng.normal(1.0, 0.1) * (sz / 0.085) ** 2)
            b.add(pos=(x_lo + (col + 0.5) * sx
                       + rng.uniform(-0.2, 0.2) * sx,
                       y_lo + (row + 0.5) * sx
                       + rng.uniform(-0.2, 0.2) * sx),
                  mass=mass, phase=int(Phase.SOLID), has_sleep=True,
                  shape_kind=int(ShapeKind.POLYGON), radius=sz, verts=verts,
                  inertia=calculate_polygon_inertia(verts, mass),
                  color=tuple(int(v) for v in rng.integers(50, 201, 3)))
            count += 1
        row += 1
    # benchmarked config == shipped defaults (the grid pipeline's solver is
    # always class-staged; see build_rigid_stacks)
    cfg = base.cfg.replace(rigid=RigidBodyConfig(
        broadphase=BroadphaseConfig(max_pairs=max(1024, 4 * n_rigid),
                                    persist_slack_m=0.04)))
    # fluid column (same layout as the dam break)
    x_min, x_max = 0.16 * scale, size * 0.35
    y_min, y_max = size * 0.2, size - 0.16 * scale
    area = (x_max - x_min) * (y_max - y_min)
    spacing = math.sqrt(area / n_fluid)
    mass_f = 0.005 * (spacing / 0.0742) ** 2
    n_fcols = int((x_max - x_min) / spacing)
    count = 0
    for frow in range((n_fluid + n_fcols - 1) // n_fcols):
        for col in range(n_fcols):
            if count >= n_fluid:
                break
            b.add(pos=(x_min + (col + 0.5) * spacing,
                       y_max - (frow + 0.5) * spacing),
                  mass=mass_f, phase=int(Phase.LIQUID),
                  shape_kind=int(ShapeKind.CIRCLE), radius=0.02,
                  static_friction=0.0, dynamic_friction=0.0,
                  color=(20, 20 + count % 50, 200 + count % 55))
            count += 1
    return b.finalize(cfg, device=device)


def build_highlight_reel(n_fluid: int = 20000, n_rigid: int = 60,
                         n_gas: int = 200, seed: int = 0, *,
                         device="cuda") -> Scene:
    """Combined highlight-reel workload (BASELINE.md's last benchmark
    config): every per-tick system at once — SPH fluid with two-way rigid
    coupling, the full rigid pipeline on mixed circles/polygons with sleep,
    gas-phase drifters, uniform gravity, boundary, rotation. The content
    mirrors the reference's showcase mix (fluid tank + dropped polygons +
    gas particles) at benchmark scale."""
    base = build_dam_break(n_fluid, seed=seed, device=device)
    size = base.cfg.shared.universe_size_m
    scale = math.sqrt(n_fluid / 20000.0)
    rng = np.random.default_rng(seed + 7)
    b = SceneBuilder(f"HIGHLIGHT_{n_fluid}_{n_rigid}_{n_gas}")
    add_tank_walls(b, size, 0.05 * scale, 1e30, 0.0, 0.0)
    cfg = base.cfg.replace(rigid=RigidBodyConfig(
        broadphase=BroadphaseConfig(max_pairs=max(512, 8 * n_rigid))))
    # mixed rigid bodies raining into the spill path: polygons + circles
    for i in range(n_rigid):
        x = rng.uniform(size * 0.45, size * 0.95)
        y = rng.uniform(size * 0.05, size * 0.45)
        if i % 3 == 2:
            r = rng.uniform(0.03, 0.06) * scale * 4.0
            m = 1.0 * scale * scale
            b.add(pos=(x, y), mass=m, phase=int(Phase.SOLID), has_sleep=True,
                  shape_kind=int(ShapeKind.CIRCLE), radius=r,
                  inertia=0.5 * m * r * r, omega=rng.uniform(-2, 2),
                  color=(220, 120, 60))
        else:
            r = rng.uniform(0.04, 0.08) * scale * 4.0
            verts = build_regular_polygon(3 + i % 4, r)
            m = 2.0 * scale * scale
            b.add(pos=(x, y), mass=m, phase=int(Phase.SOLID), has_sleep=True,
                  shape_kind=int(ShapeKind.POLYGON), radius=r, verts=verts,
                  inertia=calculate_polygon_inertia(verts, m),
                  omega=rng.uniform(-2, 2), color=(200, 160, 40))
    # gas drifters (Movement/Boundary only; rendered by the gas pass)
    for _ in range(n_gas):
        b.add(pos=(rng.uniform(0.1 * size, 0.9 * size),
                   rng.uniform(0.05 * size, 0.25 * size)),
              vel=(rng.uniform(-0.5, 0.5), rng.uniform(-0.2, 0.2)),
              mass=1e-3, phase=int(Phase.GAS),
              shape_kind=int(ShapeKind.CIRCLE), radius=0.01 * size / 6.0,
              color=(150, 150, 200))
    # fluid column (same layout as the dam break)
    x_min, x_max = 0.16 * scale, size * 0.35
    y_min, y_max = size * 0.2, size - 0.16 * scale
    area = (x_max - x_min) * (y_max - y_min)
    spacing = math.sqrt(area / n_fluid)
    mass_f = 0.005 * (spacing / 0.0742) ** 2
    n_cols = int((x_max - x_min) / spacing)
    count = 0
    for row in range((n_fluid + n_cols - 1) // n_cols):
        for col in range(n_cols):
            if count >= n_fluid:
                break
            b.add(pos=(x_min + (col + 0.5) * spacing,
                       y_max - (row + 0.5) * spacing),
                  mass=mass_f, phase=int(Phase.LIQUID),
                  shape_kind=int(ShapeKind.CIRCLE), radius=0.02,
                  static_friction=0.0, dynamic_friction=0.0,
                  color=(20, 20 + count % 50, 200 + count % 55))
            count += 1
    return b.finalize(cfg, device=device)


def build_coupled_dam(n_fluid: int = 20000, n_rigid: int = 50,
                      seed: int = 0, *,
                     device="cuda") -> Scene:
    """Two-way coupling at scale: the dam-break column plus rigid polygons
    dropped into the spill path (FLUID_AND_POLYGONS physics, larger N)."""
    scale = math.sqrt(n_fluid / 20000.0)
    base = build_dam_break(n_fluid, seed=seed, device=device)
    size = base.cfg.shared.universe_size_m
    rng = np.random.default_rng(seed + 1)
    b = SceneBuilder(f"COUPLED_DAM_{n_fluid}_{n_rigid}")
    add_tank_walls(b, size, 0.05 * scale, 1e30, 0.0, 0.0)
    for _ in range(n_rigid):
        sz = rng.uniform(0.04, 0.08) * scale * 4.0
        verts = build_regular_polygon(5, sz)
        mass = 2.0 * scale * scale
        b.add(pos=(rng.uniform(size * 0.45, size * 0.95),
                   rng.uniform(size * 0.1, size * 0.4)),
              mass=mass, phase=int(Phase.SOLID), has_sleep=True,
              shape_kind=int(ShapeKind.POLYGON), radius=sz, verts=verts,
              inertia=calculate_polygon_inertia(verts, mass),
              color=(200, 160, 40))
    # fluid column (same layout as the dam break)
    cfg = base.cfg.replace(rigid=RigidBodyConfig(
        broadphase=BroadphaseConfig(max_pairs=max(256, 8 * n_rigid))))
    x_min, x_max = 0.16 * scale, size * 0.35
    y_min, y_max = size * 0.2, size - 0.16 * scale
    area = (x_max - x_min) * (y_max - y_min)
    spacing = math.sqrt(area / n_fluid)
    mass_f = 0.005 * (spacing / 0.0742) ** 2
    n_cols = int((x_max - x_min) / spacing)
    count = 0
    for row in range((n_fluid + n_cols - 1) // n_cols):
        for col in range(n_cols):
            if count >= n_fluid:
                break
            b.add(pos=(x_min + (col + 0.5) * spacing,
                       y_max - (row + 0.5) * spacing),
                  mass=mass_f, phase=int(Phase.LIQUID),
                  shape_kind=int(ShapeKind.CIRCLE), radius=0.02,
                  static_friction=0.0, dynamic_friction=0.0,
                  color=(20, 20 + count % 50, 200 + count % 55))
            count += 1
    return b.finalize(cfg, device=device)
