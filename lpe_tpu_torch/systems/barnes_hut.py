"""N-body gravity: the counterpart of ``lpe_tpu/systems/barnes_hut.py``.

Two solvers, chosen when the system is built, as in lpe_tpu:

1. **Direct sum** (``spec.capacity`` up to
   ``BarnesHutConfig.direct_sum_max_bodies``): every receiver against every
   source, exact, in row blocks of ``chunk`` receivers (lpe_tpu's
   ``lax.map`` becomes a Python loop).
2. **P3M** (larger scenes, ``ops/pm_gravity.py``): the S-rolled mesh far
   field, the exact short-range PP correction below the cutoff, and an exact
   direct sum over the few heavy bodies (mass >= ``heavy_threshold``), which
   are never meshed.

Semantics, as in lpe_tpu and the reference (src/systems/barnes_hut.cpp):
softened ``d2 = dx^2 + dy^2 + soft^2``; sources are active, non-boundary
bodies inside the universe and, with ``small_mass_threshold > 0``, at or
above it; receivers are active non-boundary bodies; the system is off when
every non-boundary mass is below the threshold (decided at build time,
since masses never change). Both solvers are plain PyTorch: lpe_tpu runs
them as XLA, not as Pallas kernels.
"""
from __future__ import annotations

import torch

from ..core.config import ScenarioSystemConfig
from ..core.constants import REAL_G
from ..ops.pm_gravity import (make_heavy_direct, make_pm_gravity,
                              make_pp_correction)
from ..scene import SceneSpec
from ..state import SimState


def _direct_sum_accel(pos, mass, src_mask, rcv_mask, soft2, chunk: int):
    """Acceleration on every body from the masked sources, O(N^2), in row
    blocks of ``chunk`` receivers ([chunk, N] temporaries)."""
    n = pos.shape[0]
    msrc = torch.where(src_mask, mass, torch.zeros_like(mass))
    blocks = []
    for a in range(0, n, chunk):
        p_blk = pos[a:a + chunk]
        dx = pos[None, :, 0] - p_blk[:, None, 0]      # [B, N]
        dy = pos[None, :, 1] - p_blk[:, None, 1]
        d2 = dx * dx + dy * dy + soft2
        inv_d = torch.rsqrt(d2)
        # force/m_i along (dx,dy)/d with magnitude m_j/d2; G once below
        w = msrc[None, :] * inv_d / d2
        w.diagonal(offset=a).fill_(0.0)              # no self pair: (i, a+i)
        blocks.append(torch.stack([(w * dx).sum(1), (w * dy).sum(1)], -1))
    acc = torch.cat(blocks) if len(blocks) > 1 else blocks[0]
    return REAL_G * acc * rcv_mask[:, None].to(acc.dtype)


def make_barnes_hut(spec: SceneSpec, cfg: ScenarioSystemConfig, *,
                    device="cuda"):
    """The gravity step ``SimState -> SimState`` (a velocity kick), or
    ``None`` when it is statically off. For diagnostics the step carries
    ``masks(bodies) -> (sources, receivers)``, ``use_pm``, ``chunk`` (the
    direct sum's row block), ``pp`` (the P3M branch's PP correction, with
    its ``K``, ``subdivision``, ``ncells`` and ``overflow_fraction``;
    ``None`` on the direct sum or without one) and, on the P3M branch,
    ``pm`` and ``heavy_direct``."""
    bh = cfg.barnes_hut
    sh = cfg.shared
    if bh.small_mass_threshold > 0.0 and \
            spec.max_nonboundary_mass < bh.small_mass_threshold:
        return None
    soft2 = sh.gravitational_softener ** 2
    size = sh.universe_size_m
    base_dt = sh.seconds_per_tick
    n = spec.capacity
    chunk = max(128, min(n, (1 << 25) // max(n, 1) // 1 * 8))
    use_pm = n > bh.direct_sum_max_bodies
    pp = None
    if use_pm:
        pm = make_pm_gravity(size, bh.pm_grid, sh.gravitational_softener,
                             cutoff_cells=bh.p3m_cutoff_cells, device=device)
        if bh.p3m_cutoff_cells > 0:
            pp = make_pp_correction(size, bh.pm_grid,
                                    sh.gravitational_softener,
                                    bh.p3m_cutoff_cells, bh.p3m_max_per_cell,
                                    n_bodies=n)
        heavy_direct = make_heavy_direct(bh.heavy_cap,
                                         sh.gravitational_softener)

    def masks(b):
        """(sources, receivers) of bodies ``b``."""
        in_bounds = (b.pos[:, 0] >= 0) & (b.pos[:, 0] < size) & \
                    (b.pos[:, 1] >= 0) & (b.pos[:, 1] < size)
        src = b.active & ~b.boundary & in_bounds
        if bh.small_mass_threshold > 0.0:
            src = src & (b.mass >= bh.small_mass_threshold)
        return src, b.active & ~b.boundary

    def step(state: SimState) -> SimState:
        b = state.bodies
        dt = base_dt * state.base_time_accel * state.time_scale
        src, rcv = masks(b)
        if use_pm:
            heavy = src & (b.mass >= bh.heavy_threshold)
            mesh_mass = torch.where(src & ~heavy, b.mass,
                                    torch.zeros_like(b.mass))
            acc = pm(b.pos, mesh_mass) + heavy_direct(b.pos, b.mass, heavy)
            if pp is not None:
                acc = acc + pp(b.pos, mesh_mass)
            acc = REAL_G * acc * rcv[:, None].to(acc.dtype)
        else:
            acc = _direct_sum_accel(b.pos, b.mass, src, rcv, soft2, chunk)
        vel = b.vel + acc * dt
        return state.replace(bodies=b.replace(vel=vel))

    step.masks, step.pp, step.use_pm, step.chunk = masks, pp, use_pm, chunk
    if use_pm:
        step.pm, step.heavy_direct = pm, heavy_direct
    return step
