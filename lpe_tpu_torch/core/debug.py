"""Debug statistics accumulators.

reference: include/core/debug.hpp:5-83 — static force/movement counters
compiled out behind ``ENABLE_DEBUG 0``; here an instantiable accumulator
(enabled at runtime, ``ENABLE_DEBUG`` mirrors the compile-time default) fed
from device arrays in one vectorized update instead of per-entity calls.
A copy of ``lpe_tpu/core/debug.py``, docstrings apart.
"""
from __future__ import annotations

import numpy as np

ENABLE_DEBUG = False          # reference default: compiled out


class DebugStats:
    def __init__(self, enabled: bool = ENABLE_DEBUG):
        self.enabled = enabled
        self.reset()

    def reset(self) -> None:
        self.max_force = 0.0
        self.total_force = 0.0
        self.force_count = 0
        self.max_speed = 0.0
        self.avg_dx = 0.0
        self.avg_dy = 0.0
        self.moving_particles = 0
        self.total_particles = 0

    def update_forces(self, force_mags) -> None:
        """Vectorized counterpart of DebugStats::updateForce (debug.hpp:24)."""
        if not self.enabled:
            return
        f = np.asarray(force_mags)
        if f.size:
            self.max_force = max(self.max_force, float(f.max()))
            self.total_force += float(f.sum())
            self.force_count += int(f.size)

    def update_movement(self, vel) -> None:
        """Vectorized counterpart of DebugStats::updateMovement
        (debug.hpp:30-38): speed/displacement stats over all entities."""
        if not self.enabled:
            return
        v = np.asarray(vel)
        speed = np.sqrt((v * v).sum(-1))
        moving = speed > 0
        self.moving_particles += int(moving.sum())
        self.total_particles += int(speed.size)
        if moving.any():
            self.max_speed = max(self.max_speed, float(speed.max()))
            self.avg_dx += float(np.abs(v[moving, 0]).sum())
            self.avg_dy += float(np.abs(v[moving, 1]).sum())

    def report(self) -> str:
        n = max(self.moving_particles, 1)
        return (f"forces: n={self.force_count} max={self.max_force:.3g} "
                f"mean={self.total_force / max(self.force_count, 1):.3g}\n"
                f"movement: moving={self.moving_particles}/"
                f"{self.total_particles} max_speed={self.max_speed:.3g} "
                f"avg_|dx|={self.avg_dx / n:.3g} avg_|dy|={self.avg_dy / n:.3g}")
