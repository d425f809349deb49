"""Host-side polygon construction helpers (NumPy), copied from
``lpe_tpu/math/polygon.py``: the regular-polygon builder, the random
convex polygon and the polygon inertia formula that scene builders use for
rigid entities.
"""
from __future__ import annotations

import numpy as np


def build_regular_polygon(sides: int, size: float) -> np.ndarray:
    """CCW regular polygon of circumradius ``size``.

    reference: include/math/polygon.hpp:154-168.
    """
    k = np.arange(sides, dtype=np.float64)
    ang = 2.0 * np.pi * k / sides
    return np.stack([size * np.cos(ang), -size * np.sin(ang)], axis=-1)


def build_random_convex_polygon(rng: np.random.Generator,
                                size: float) -> np.ndarray:
    """Random convex-ish polygon, 3-7 sides, radius in [size/2, size].
    Draws from ``rng`` in the order ``lpe_tpu`` does, so scenes built from
    one seed are bitwise equal.

    reference: include/math/polygon.hpp:178-199.
    """
    sides = int(rng.integers(3, 8))
    ang = 2.0 * np.pi * np.arange(sides) / sides
    r = rng.uniform(0.5 * size, size, sides)
    return np.stack([r * np.cos(ang), -r * np.sin(ang)], axis=-1)


def calculate_polygon_inertia(vertices: np.ndarray, mass: float) -> float:
    """Moment of inertia of a uniform-density polygon about its local origin.

    reference: include/math/polygon.hpp:268-284.
    """
    v = np.asarray(vertices, dtype=np.float64)
    j = np.roll(v, -1, axis=0)
    cross = v[:, 0] * j[:, 1] - v[:, 1] * j[:, 0]
    dots = (v * v).sum(-1) + (v * j).sum(-1) + (j * j).sum(-1)
    num = float((cross * dots).sum())
    den = float(cross.sum())
    return (mass * num) / (6.0 * den)
