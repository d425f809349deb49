"""Host-side polygon construction helpers (NumPy), copied from
``lpe_tpu/math/polygon.py``: the regular-polygon builder and the polygon
inertia formula that scene builders use for rigid entities.
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
