"""NumPy CPU oracle for the SPH fluid pipeline.

Two jobs (SURVEY.md §4, §6):
1. **Golden reference** for unit tests: an independent, readable
   implementation of the exact kernel math in
   reference: src/systems/fluid/fluid_kernels.metal (poly6/spiky/viscosity
   2D, EOS clamp, kick-drift-kick), cross-checked against the XLA fluid
   system on small scenes.
2. **Measured CPU baseline** for bench.py: the reference publishes no
   numbers, so the speedup denominator must be measured (BASELINE.md). This
   is a vectorized single-process NumPy solver with a uniform-grid neighbor
   search — a fair stand-in for an optimized CPU port of the reference's
   solver.
"""
from __future__ import annotations

import math

import numpy as np


class SphOracle:
    def __init__(self, *, h=0.05, rest_density=0.5, stiffness=200.0,
                 viscosity=0.03, gravity=9.8, dt_tick=1.0 / 120.0,
                 num_sub_steps=10, universe=6.0, margin=0.15,
                 bounce_damping=0.7, max_speed=1.0,
                 min_dist2=1e-14, min_density=1e-12):
        self.h = h
        self.rest = rest_density
        self.k = stiffness
        self.mu = viscosity
        self.g = gravity
        self.dt = dt_tick / num_sub_steps
        self.nsub = num_sub_steps
        self.universe = universe
        self.margin = margin
        self.bounce = bounce_damping
        self.vmax = max_speed
        self.min_d2 = min_dist2
        self.min_rho = min_density
        self.poly6 = 4.0 / (math.pi * h ** 8)
        self.spiky = -30.0 / (math.pi * h ** 5)
        self.visc = 40.0 / (math.pi * h ** 5)
        # per-particle smoothing lengths (reference: fluid.cpp:293 gathers
        # h per particle, fluid_kernels.metal:362-396 uses the pairwise
        # average h-bar); None = uniform self.h
        self.hs = None

    def _hbar(self, i, j):
        if self.hs is None:
            return self.h
        return 0.5 * (self.hs[i] + self.hs[j])

    def _neighbors(self, pos):
        """Uniform grid, cell = 2h: candidate pairs (i, j), fully vectorized
        (sorted cell ids + searchsorted range lookups per 3x3 offset).
        Mixed h: cell = 2*max(h), the reference's dynamic sizing
        (fluid.cpp:723-755) evaluated at the static per-scene max."""
        hmax = self.h if self.hs is None else float(np.max(self.hs))
        cell = 2.0 * hmax
        keys = np.floor(pos / cell).astype(np.int64)
        cid = keys[:, 0] * (1 << 32) + keys[:, 1]
        order = np.argsort(cid, kind="stable")
        sc = cid[order]
        out_i = []
        out_j = []
        n = len(pos)
        ar = np.arange(n)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                nid = (keys[:, 0] + dx) * (1 << 32) + (keys[:, 1] + dy)
                starts = np.searchsorted(sc, nid, side="left")
                ends = np.searchsorted(sc, nid, side="right")
                counts = ends - starts
                i = np.repeat(ar, counts)
                # ranges concat: arange over each [start, end)
                offs = np.repeat(ends - np.cumsum(counts), counts)
                j = order[np.arange(len(i)) + offs]
                out_i.append(i)
                out_j.append(j)
        return np.concatenate(out_i), np.concatenate(out_j)

    def density_pressure(self, pos, mass):
        i, j = self._neighbors(pos)
        d = pos[i] - pos[j]
        r2 = (d * d).sum(-1)
        hb = self._hbar(i, j)
        h2 = hb * hb
        poly6 = self.poly6 if self.hs is None else 4.0 / (math.pi * hb ** 8)
        w = np.where(r2 < h2, poly6 * (h2 - r2) ** 3, 0.0)
        rho = np.zeros(len(pos))
        np.add.at(rho, i, mass[j] * w)
        pres = np.maximum(self.k * (rho - self.rest), 0.0)
        return rho, pres

    def forces(self, pos, vel, mass, rho, pres):
        i, j = self._neighbors(pos)
        keep = i != j
        i, j = i[keep], j[keep]
        d = pos[i] - pos[j]
        r2 = (d * d).sum(-1)
        h = self._hbar(i, j)
        ok = (r2 >= self.min_d2) & (r2 < h * h) & \
            (rho[i] >= self.min_rho) & (rho[j] >= self.min_rho)
        if self.hs is not None:
            h = h[ok]
        i, j, d, r2 = i[ok], j[ok], d[ok], r2[ok]
        r = np.sqrt(r2)
        term = pres[i] / rho[i] ** 2 + pres[j] / rho[j] ** 2
        spiky = self.spiky if self.hs is None else -30.0 / (math.pi * h ** 5)
        visc = self.visc if self.hs is None else 40.0 / (math.pi * h ** 5)
        w_spiky = spiky * (h - r) ** 2
        f_press = -mass[j] * term * w_spiky
        f = f_press[:, None] * d / r[:, None]
        w_visc = visc * (h - r)
        f_visc = self.mu * mass[j] * (w_visc / rho[j])
        f -= f_visc[:, None] * (vel[i] - vel[j])
        acc = np.zeros_like(pos)
        np.add.at(acc, i, f)
        return acc

    def tick(self, pos, vel, mass):
        """One full tick: fluid substeps + boundary + uniform gravity,
        mirroring the system order for a fluid-only scene."""
        pos, vel = pos.copy(), vel.copy()
        acc = np.zeros_like(pos)
        for _ in range(self.nsub):
            vh = vel + 0.5 * self.dt * acc
            pos += vh * self.dt
            rho, pres = self.density_pressure(pos, mass)
            acc = self.forces(pos, vel, mass, rho, pres)
            vel = vh + 0.5 * self.dt * acc
        # boundary bounce (reference: src/systems/boundary.cpp:13-71)
        lo, hi = self.margin, self.universe - self.margin
        for ax in (0, 1):
            low = pos[:, ax] < lo
            high = pos[:, ax] > hi
            pos[:, ax] = np.clip(pos[:, ax], lo, hi)
            vel[low, ax] = np.abs(vel[low, ax]) * self.bounce
            vel[high, ax] = -np.abs(vel[high, ax]) * self.bounce
            b = low | high
            sp = np.linalg.norm(vel[b], axis=1)
            f = np.where(sp > self.vmax, self.vmax / np.maximum(sp, 1e-30), 1.0)
            vel[b] *= f[:, None]
        # uniform gravity (once per tick)
        vel[:, 1] += self.g * self.dt * self.nsub
        return pos, vel, rho, pres
