"""Global simulator constants.

TPU-native rebuild of the reference constants table
(reference: src/core/constants.cpp:7-48). Values are kept bit-identical where
the reference defines them so scenario geometry matches.
"""
from __future__ import annotations

import enum

PI = 3.141592654          # reference: src/core/constants.cpp:7
REAL_G = 6.674e-11        # reference: src/core/constants.cpp:8
EPSILON = 1e-9            # reference: src/core/constants.cpp:9

SCREEN_LENGTH = 600       # pixels; reference: src/core/constants.cpp:12
STEPS_PER_SECOND = 120    # fixed tick rate; reference: src/core/constants.cpp:13

# Capacity caps (fixed shapes for XLA). The 16-vertex polygon cap matches the
# reference GPU contract (reference: include/systems/fluid/fluid.hpp:93).
MAX_POLY_VERTS = 16
# Per-cell neighbor-table occupancy cap for the SPH uniform grid
# (reference: src/systems/fluid/fluid_kernels.metal:60).
MAX_PER_CELL = 64
# Chunking geometry of the rasterized fluid<->rigid coupling field build
# (systems/fluid/sph.py _couple_field): rows per scan step and columns per
# x-tile window. Shared with scene.py's capacity seed (coupling_max_win0).
COUPLE_CHUNK_ROWS = 8
COUPLE_TILE_COLS = 128


class Phase(enum.IntEnum):
    """Particle phase (reference: include/entities/entity_components.hpp:8)."""

    SOLID = 0
    LIQUID = 1
    GAS = 2


class ShapeKind(enum.IntEnum):
    """Shape discriminator (reference: include/entities/entity_components.hpp:15)."""

    CIRCLE = 0
    POLYGON = 1


class SimulationType(enum.IntEnum):
    """Scenario catalog (reference: src/core/constants.cpp:25-35)."""

    KEPLERIAN_DISK = 0
    RANDOM_POLYGONS = 1
    SIMPLE_FLUID = 2
    FLUID_AND_POLYGONS = 3
    HOURGLASSES = 4
    PLANETARY_OCEAN = 5
    GALTON_BOARD = 6


SCENARIO_NAMES = {
    SimulationType.KEPLERIAN_DISK: "KEPLERIAN_DISK",
    SimulationType.RANDOM_POLYGONS: "RANDOM_POLYGONS",
    SimulationType.SIMPLE_FLUID: "SIMPLE_FLUID",
    SimulationType.FLUID_AND_POLYGONS: "FLUID_AND_POLYGONS",
    SimulationType.HOURGLASSES: "HOURGLASSES",
    SimulationType.PLANETARY_OCEAN: "PLANETARY_OCEAN",
    SimulationType.GALTON_BOARD: "GALTON_BOARD",
}


def get_all_scenarios() -> list[SimulationType]:
    return list(SCENARIO_NAMES.keys())


def get_scenario_name(s: SimulationType) -> str:
    return SCENARIO_NAMES.get(s, "UNKNOWN")


def pixels_to_meters(pixels: float, meters_per_pixel: float) -> float:
    return pixels * meters_per_pixel


def meters_to_pixels(meters: float, meters_per_pixel: float) -> float:
    return meters / meters_per_pixel
