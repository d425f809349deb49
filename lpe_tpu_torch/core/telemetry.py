"""Capacity-saturation telemetry: a copy of ``lpe_tpu/core/telemetry.py``.

Every dense-capacity structure drops overflow deterministically, mirroring
the reference's silent per-cell caps (reference:
src/systems/fluid/fluid_kernels.metal:60,237-240). ``capacity_report``
counts, from a live state, how full each capacity is and how much it
dropped; it is a host-side numpy diagnostic that never runs in the tick.
It reads the port's state through ``convert.state_to_numpy`` (a state of
numpy arrays is taken as it is), and sizes the caps with the port's own
``grid_dims`` and ``coupling_dims``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..convert import state_to_numpy


def _solid_aabbs(b, S, VS):
    """World AABBs of the first S bodies (numpy mirror of
    pipeline._aabbs)."""
    pos = np.asarray(b.pos[:S], np.float64)
    ang = np.asarray(b.angle[:S], np.float64)
    verts = np.asarray(b.verts[:S, :VS], np.float64)
    nv = np.asarray(b.nverts[:S])
    rad = np.asarray(b.radius[:S], np.float64)
    circ = np.asarray(b.shape_kind[:S]) == 0
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    wx = pos[:, None, 0] + verts[..., 0] * c - verts[..., 1] * s
    wy = pos[:, None, 1] + verts[..., 0] * s + verts[..., 1] * c
    vm = np.arange(VS)[None, :] < nv[:, None]
    big = 1e30
    pminx = np.where(vm, wx, big).min(1)
    pmaxx = np.where(vm, wx, -big).max(1)
    pminy = np.where(vm, wy, big).min(1)
    pmaxy = np.where(vm, wy, -big).max(1)
    minx = np.where(circ, pos[:, 0] - rad, pminx)
    maxx = np.where(circ, pos[:, 0] + rad, pmaxx)
    miny = np.where(circ, pos[:, 1] - rad, pminy)
    maxy = np.where(circ, pos[:, 1] + rad, pmaxy)
    return minx, miny, maxx, maxy


def _cell_counts(xs, ys, cell, n):
    gx = np.floor(xs / cell).astype(np.int64)
    gy = np.floor(ys / cell).astype(np.int64)
    _, cnt = np.unique(gy * (1 << 32) + gx, return_counts=True)
    return cnt if cnt.size else np.zeros(1, np.int64)


def capacity_report(state, spec, cfg) -> dict:
    """Saturation stats for every silent capacity, from a live state.

    Returns a dict of sections; each has ``cap`` (the configured capacity),
    ``max`` (the demand actually observed), ``dropped`` (units beyond cap)
    and ``frac`` (dropped / total). A healthy configuration has every
    ``frac`` ~ 0."""
    if isinstance(state.bodies.pos, torch.Tensor):
        state = state_to_numpy(state)
    b = state.bodies
    out = {}

    # ---- fluid neighbor grid: K particles per h-cell --------------------
    NL = spec.n_liquid
    if NL:
        fc = cfg.fluid
        cell = fc.grid.smoothing_length * fc.grid.cell_size_factor
        K = max(1, min(fc.grid.max_per_cell, NL))
        L = spec.liquid_slice
        pos = np.asarray(b.pos[L], np.float64)
        cnt = _cell_counts(pos[:, 0], pos[:, 1], cell, NL)
        drop = int(np.maximum(cnt - K, 0).sum())
        out["fluid_cell_slots"] = dict(
            cap=K, max=int(cnt.max()), dropped=drop, frac=drop / NL)

    S = spec.n_solid
    if S >= 2:
        from ..systems.rigid.grid_pipeline import grid_dims
        gd = grid_dims(spec, cfg)
        VS = spec.max_solid_verts
        minx, miny, maxx, maxy = _solid_aabbs(b, S, VS)
        big = np.zeros(S, bool)
        if spec.solid_big_idx:
            big[list(spec.solid_big_idx)] = True
        nb = ~big

        if gd is not None:
            # ---- grid rigid pipeline: KB slots/cell + class row caps ----
            cellb, KB, nbx = gd["cellb"], gd["KB"], gd["nbx"]
            pos = np.asarray(b.pos[:S], np.float64)
            gx = np.clip(np.floor(pos[:, 0] / cellb).astype(np.int64) + 1,
                         0, nbx - 1)
            gy = np.clip(np.floor(pos[:, 1] / cellb).astype(np.int64) + 1,
                         0, nbx - 1)
            cid = np.where(nb, gy * nbx + gx, -1)
            ids, cnt = np.unique(cid[nb], return_counts=True)
            drop = int(np.maximum(cnt - KB, 0).sum())
            out["rigid_grid_slots"] = dict(
                cap=KB, max=int(cnt.max()) if cnt.size else 0,
                dropped=drop, frac=drop / max(1, int(nb.sum())))

            # class row caps: exact candidate counts per (cell, class)
            slack = float(cfg.rigid.broadphase.persist_slack_m)
            e = slack * 0.5
            lo_x, lo_y = minx - e, miny - e
            hi_x, hi_y = maxx + e, maxy + e
            order = np.argsort(cid, kind="stable")
            caps = gd["caps"]
            # bucket bodies per cell (python dict of small lists — host-side
            # diagnostic, sizes are ~bodies not cells)
            cells = {}
            for i in order:
                if cid[i] >= 0:
                    cells.setdefault(int(cid[i]), []).append(int(i))
            offs = ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1))
            names = ("same", "E", "SW", "S", "SE")
            worst = {k: 0 for k in names}
            dropped = {k: 0 for k in names}
            total = 0

            def n_overlap(ia, ib):
                n = 0
                for aa in ia:
                    for bb in ib:
                        if aa == bb:
                            continue
                        if (lo_x[aa] <= hi_x[bb] and lo_x[bb] <= hi_x[aa]
                                and lo_y[aa] <= hi_y[bb]
                                and lo_y[bb] <= hi_y[aa]):
                            n += 1
                return n

            for c, members in cells.items():
                cy, cx = divmod(c, nbx)
                for k, (dx, dy) in zip(names, offs):
                    if k == "same":
                        n = n_overlap(members, members) // 2
                    else:
                        nc = (cy + dy) * nbx + (cx + dx)
                        if not (0 <= cx + dx < nbx and 0 <= cy + dy < nbx):
                            continue
                        n = n_overlap(members, cells.get(nc, []))
                    cap = caps[names.index(k)]
                    worst[k] = max(worst[k], n)
                    dropped[k] += max(0, n - cap)
                    total += n
            out["rigid_grid_rows"] = dict(
                caps={k: caps[i] for i, k in enumerate(names)},
                max=worst, dropped=dropped,
                frac=sum(dropped.values()) / max(1, total))
        else:
            # ---- list pipeline: max_pairs candidate capacity -------------
            e = 0.5 * float(cfg.rigid.broadphase.persist_slack_m)
            ox = (minx[:, None] - e <= maxx[None, :] + e) & \
                 (minx[None, :] - e <= maxx[:, None] + e)
            oy = (miny[:, None] - e <= maxy[None, :] + e) & \
                 (miny[None, :] - e <= maxy[:, None] + e)
            iu = np.triu_indices(S, 1)
            n_pairs = int((ox & oy)[iu].sum())
            cap = cfg.rigid.broadphase.max_pairs
            out["broadphase_pairs"] = dict(
                cap=cap, max=n_pairs, dropped=max(0, n_pairs - cap),
                frac=max(0, n_pairs - cap) / max(1, n_pairs))

    # ---- fluid<->rigid coupling: rigid slots per fluid cell ---------------
    if NL and S:
        from ..systems.fluid.sph import coupling_dims
        fc = cfg.fluid
        cell = fc.grid.smoothing_length * fc.grid.cell_size_factor
        cd = coupling_dims(spec, cfg)
        Sc = 0 if cd is None else cd["S"]
        if Sc:
            big = np.zeros(S, bool)
            if spec.solid_big_idx:
                big[list(spec.solid_big_idx)] = True
            nbi = np.flatnonzero(~big)
            # the coupling proxies cover ALL non-liquid entities (gas
            # included), not just solids (sph._rigid_proxies)
            NRC = spec.liquid_start
            minx, miny, maxx, maxy = _solid_aabbs(b, NRC,
                                                  spec.max_rigid_verts)
            nbi = np.setdiff1d(np.arange(NRC), list(spec.solid_big_idx))
            # rasterized coverage counts, slack-widened (sph._couple_field)
            slackm = float(cfg.fluid.coupling_raster_slack_cells) * cell
            size = cfg.shared.universe_size_m
            nx = int(math.ceil(size / cell)) + 4
            counts = np.zeros((nx + 2, nx + 2), np.int64)
            for i in nbi:
                cx0 = int(np.floor((minx[i] - slackm) / cell)) + 3
                cx1 = int(np.floor((maxx[i] + slackm) / cell)) + 3
                cy0 = int(np.floor((miny[i] - slackm) / cell)) + 3
                cy1 = int(np.floor((maxy[i] + slackm) / cell)) + 3
                cx0, cx1 = max(cx0, 0), min(cx1, nx + 1)
                cy0, cy1 = max(cy0, 0), min(cy1, nx + 1)
                counts[cy0:cy1 + 1, cx0:cx1 + 1] += 1
            drop = int(np.maximum(counts - Sc, 0).sum())
            out["coupling_cell_slots"] = dict(
                cap=Sc, max=int(counts.max()), dropped=drop,
                frac=drop / max(1, int(counts.sum())))
    return out


def assert_no_saturation(report: dict, tol: float = 0.0):
    """Raise AssertionError when any capacity section drops more than
    ``tol`` fraction of its demand."""
    bad = {k: v for k, v in report.items()
           if float(v.get("frac", 0.0)) > tol}
    assert not bad, f"capacity saturation beyond tol={tol}: {bad}"
