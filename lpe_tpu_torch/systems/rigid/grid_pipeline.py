"""Grid-resident rigid pipeline: the big-scene rigid path.

The counterpart of ``lpe_tpu/systems/rigid/grid_pipeline.py``. Bodies
live in a dense [cell, slot] grid (cell = broadphase cell, slot < KB),
rebuilt only when the displacement guard trips. Candidate pairs are per-cell
row tensors [NC, R] with a static class layout over the forward
half-stencil (same cell, E, SW, S, SE) plus a "big solid" class for the
walls kept off the grid; a row holds (own slot, partner slot) and its class
implies the partner cell, reached by rolling the grid. The narrowphase runs
over all NC * R rows (``ops/rigid_kernels.py``: a CUDA kernel on the card),
and both solvers iterate on the dense grids, one mass-splitting Jacobi pass
per class, the six class passes in turn (staged Gauss-Seidel).

The semantics are lpe_tpu's; the TPU layout is not kept:

- a row picks a body's fields by slot with ``torch.gather`` (``_sel``),
  where lpe_tpu used a one-hot broadcast-reduce because gathers were slow
  on the TPU; the values are the same;
- ``_place`` ranks and scatters where lpe_tpu unrolled one reduction per
  output slot; every target is written once, so the integers are the same;
- ``_scat`` keeps the broadcast-reduce: float atomics would make the sum's
  order, and so the result, vary from run to run;
- ``lax.cond`` on the displacement guard becomes one host read of ``need``
  per tick (``step.guard_reads`` counts them, ``step.rebuilds`` the ticks
  that rebuilt), and ``fori_loop`` a Python loop;
- profiler ranges ``rigid.rows`` (guard, rebuild, row selects; within it
  ``rigid.rebuild``) and ``rigid.narrowphase`` take the place of
  ``jax.named_scope``; the solvers are the rest of the system's range;
- ``_rebuild`` assigns slots with a STABLE argsort, so the bodies of a cell
  take ascending slots in body order. lpe_tpu's ``jnp.argsort(cid,
  stable=False)`` leaves that order to XLA, which on the CPU does not keep
  body order within a cell, and no port can reproduce it. Slot order
  changes only which candidates a saturated cell or class drops, so the
  two packages agree wherever ``core.telemetry.capacity_report`` shows no
  saturation.

Scenes with circle solids, or with ``max_contacts_per_pair != 2``, raise
``NotImplementedError`` (ROADMAP.md Queue 1 item 5); lpe_tpu runs them
through its XLA circle path.
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from ...core.config import ScenarioSystemConfig
from ...core.constants import ShapeKind
from ...core.numerics import sqrt, true_div
from ...scene import SceneSpec
from ...state import SimState
from . import geometry as geo
from .solver import match_warm_impulses

INF = 1e30
# forward half-stencil (dx, dy): each unordered cell pair exactly once
OFFS = ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def grid_dims(spec: SceneSpec, cfg: ScenarioSystemConfig):
    """Static grid geometry shared by scene.finalize (state sizing) and
    make_grid_rigid_system. Returns None when the grid pipeline is off."""
    rc = cfg.rigid
    bp = rc.broadphase
    S = spec.n_solid
    mode = getattr(rc, "grid_pipeline", "auto")
    on = (mode == "on" or (mode == "auto" and S > bp.dense_max_solids))
    if not on or S < 2:
        return None
    # big (off-grid) solids are frozen contact partners in the solvers —
    # exact for infinite-mass boundary walls, wrong for a dynamic oversized
    # body: those scenes keep the list pipeline
    if not spec.solid_big_all_boundary:
        return None
    slack = float(bp.persist_slack_m)
    cellb = spec.solid_cell_size + slack
    if cellb <= 0:
        return None
    size = cfg.shared.universe_size_m
    nbx = max(1, int(math.ceil(size / cellb))) + 2
    occ0 = int(getattr(spec, "solid_max_cell_occ0", 0))
    while nbx * nbx > (1 << 18):
        cellb *= 2.0
        occ0 *= 4          # each doubling quadruples expected cell occupancy
        nbx = max(1, int(math.ceil(size / cellb))) + 2
    # round the row count up to a multiple of 8: the flat [NC] cell axis
    # then splits into whole y-row bands on any 1/2/4/8-device mesh
    # (parallel/sharded.py shards the rg_* state on it), and power-of-two
    # row counts tile better everywhere. Extra rows are empty border cells
    # (positions clip to the original extent) — physics unchanged.
    nbx = -(-nbx // 8) * 8
    # Per-cell slot capacity. Auto-sizing is DENSITY-DRIVEN: 3x the scene's
    # initial max per-cell count (headroom for piling under gravity/fluid
    # ploughing), floored at 8 and never above the old worst-case constant.
    # A 13 m north-star tank (0.6 bodies/cell) sizes to KB=8-16 instead of
    # 48 — every narrowphase/solver select scales with KB, measured ~7x of
    # the tick at the oversized setting. Saturation (bodies dropped beyond
    # KB, rows beyond the class caps) is observable: core.telemetry
    # .capacity_report counts it and the bench scenes assert ~0.
    worst = max(8, (3 * bp.grid_max_per_cell) // 2)
    auto_kb = min(worst, max(8, -(-3 * occ0 // 8) * 8)) if occ0 > 0 else worst
    KB = getattr(rc, "grid_slots_per_cell", 0) or auto_kb
    # candidate packing stores (kb | ka << 8): slot ids must fit in 8 bits
    if KB > 256:
        raise ValueError(
            f"grid rigid pipeline: KB={KB} slots/cell exceeds the 8-bit "
            "candidate packing (max 256); lower rigid.grid_slots_per_cell "
            "or broadphase.grid_max_per_cell")
    r00 = getattr(rc, "grid_rows_same", 0) or KB
    rax = getattr(rc, "grid_rows_axis", 0) or max(4, KB // 2)
    rdg = getattr(rc, "grid_rows_diag", 0) or max(4, KB // 3)
    nbig = len(spec.solid_big_idx)
    # floor cells pair every resident body against the floor wall: the big
    # class needs up to KB rows (capped at the old 16 default for scenes
    # with huge KB)
    rbig = (getattr(rc, "grid_rows_big", 0) or min(KB, 16)) if nbig else 0
    # class layout over the row axis: [same | E | SW | S | SE | big]
    caps = (r00, rax, rdg, rax, rdg) + ((rbig,) if nbig else ())
    return dict(nbx=nbx, cellb=cellb, KB=KB, caps=caps, nbig=nbig,
                R=sum(caps), NC=nbx * nbx)


def _sel(grid, k):
    """[NC, Rc, ...] <- grid[NC, KB, ...] at slot k[NC, Rc]."""
    idx = k.long().reshape(k.shape + (1,) * (grid.dim() - 2))
    return grid.gather(1, idx.expand(k.shape + grid.shape[2:]))


def _scat(val, k, kmax):
    """[NC, kmax, ...] <- the sum over rows of val[NC, Rc, ...] onto slot
    k[NC, Rc], as a broadcast-reduce: no atomics, one fixed order."""
    hot = k[:, :, None] == torch.arange(kmax, dtype=k.dtype,
                                        device=k.device)
    hot = hot.reshape(hot.shape + (1,) * (val.dim() - 2))
    return torch.where(hot, val[:, :, None], val.new_zeros(())).sum(1)


def _place(mask, attr, cap):
    """Keep the first ``cap`` True entries of ``mask`` along its last axis,
    in ascending order, carrying ``attr`` (int32, mask's shape). Returns
    [..., cap] int32 with -1 for empty places."""
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    keep = mask & (rank < cap)
    out = torch.full(mask.shape[:-1] + (cap + 1,), -1, dtype=torch.int32,
                     device=mask.device)
    # kept entries land on distinct places; the rest on the spare place cap
    out.scatter_(-1, torch.where(keep, rank, cap).long(),
                 torch.where(keep, attr, -1).to(torch.int32))
    return out[..., :cap]


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def make_grid_rigid_system(spec: SceneSpec, cfg: ScenarioSystemConfig, *,
                           device="cuda"):
    gd = grid_dims(spec, cfg)
    assert gd is not None
    S = spec.n_solid
    rc = cfg.rigid
    bp = rc.broadphase
    C = rc.max_contacts_per_pair
    if spec.any_rigid_circle or C != 2:
        raise NotImplementedError(
            "the grid rigid pipeline is ported for polygon scenes with 2 "
            "contacts per pair; circles and other manifolds need the XLA "
            "circle path (ROADMAP.md Queue 1 item 5)")
    nb = getattr(rc, "narrowphase_backend", "auto")
    if nb not in ("auto", "pallas", "xla"):
        raise ValueError(f"narrowphase_backend={nb!r}")
    # "auto"/"pallas": the kernel wrapper (the CUDA kernel for CUDA tensors,
    # its plain version for CPU ones); "xla": the plain geometry path itself
    from ...ops.rigid_kernels import narrowphase, narrowphase_plain
    narrow = narrowphase_plain if nb == "xla" else narrowphase
    slack = float(bp.persist_slack_m)
    nbx, cellb, KB, caps = gd["nbx"], gd["cellb"], gd["KB"], gd["caps"]
    NC, R = gd["NC"], gd["R"]
    VS = spec.max_solid_verts
    NBIG = gd["nbig"]
    dev = torch.device(device)
    i32, f32 = torch.int32, torch.float32
    big_ids = torch.tensor(spec.solid_big_idx, dtype=torch.long,
                           device=dev).reshape(NBIG)
    is_big = torch.zeros((S,), dtype=torch.bool, device=dev)
    is_big[big_ids] = True
    size = cfg.shared.universe_size_m
    buf = bp.boundary_buffer
    mu = rc.solver.friction_coeff
    relax = rc.solver.relaxation

    classes = []
    base = 0
    for ci, (dx, dy) in enumerate(OFFS):
        classes.append(dict(kind="off", dx=dx, dy=dy,
                            sl=slice(base, base + caps[ci])))
        base += caps[ci]
    if NBIG:
        classes.append(dict(kind="big", dx=0, dy=0,
                            sl=slice(base, base + caps[5])))
        base += caps[5]
    assert base == R
    # per-(lo-slot) stage-1 caps: how many rows one body can own per class
    # before the per-cell compaction
    RK = {"same": max(6, caps[0] // 4), "off": max(4, caps[1] // 4),
          "big": min(4, NBIG) if NBIG else 0}

    kiota = torch.arange(KB, dtype=i32, device=dev)
    viota = torch.arange(VS, device=dev)

    # ---------------------------------------------------------------- rebuild
    def _aabbs_bodies(b):
        """World AABBs of all solids, all polygons here (reference:
        broadphase.cpp:164-199)."""
        c = torch.cos(b.angle[:S])[:, None]
        s = torch.sin(b.angle[:S])[:, None]
        v = b.verts[:S, :VS]
        vmask = viota[None, :] < b.nverts[:S, None]
        wx = b.pos[:S, None, 0] + v[..., 0] * c - v[..., 1] * s
        wy = b.pos[:S, None, 1] + v[..., 0] * s + v[..., 1] * c
        big = torch.full((), INF, dtype=f32, device=dev)
        return (torch.where(vmask, wx, big).amin(1),
                torch.where(vmask, wy, big).amin(1),
                torch.where(vmask, wx, -big).amax(1),
                torch.where(vmask, wy, -big).amax(1))

    def _inv_mass(b):
        m = b.mass[:S]
        return torch.where(m > 1e29, 0.0,
                           true_div(1.0, torch.clamp(m, min=1e-30)))

    def _inv_inertia(b):
        i = b.inertia[:S]
        return torch.where((i > 1e-12) & (i < 1e29),
                           true_div(1.0, torch.clamp(i, min=1e-30)), 0.0)

    def _rebuild(b):
        minx, miny, maxx, maxy = _aabbs_bodies(b)
        ext = torch.maximum(maxx - minx, maxy - miny)
        small = ext < bp.small_particle_threshold
        in_root = (maxx >= -buf) & (minx <= size + buf) & \
                  (maxy >= -buf) & (miny <= size + buf)
        bnd = b.boundary[:S]
        if slack > 0:
            e = slack * 0.5
            minx, miny, maxx, maxy = minx - e, miny - e, maxx + e, maxy + e

        # ---- body -> (cell, slot) assignment (counting order) ----
        gx = torch.clamp(torch.floor(true_div(b.pos[:S, 0], cellb)).to(i32)
                         + 1, 0, nbx - 1)
        gy = torch.clamp(torch.floor(true_div(b.pos[:S, 1], cellb)).to(i32)
                         + 1, 0, nbx - 1)
        cid = torch.where(is_big, NC, gy * nbx + gx).to(i32)
        # stable: a cell's bodies take ascending slots in body order (see
        # the module docstring for lpe_tpu's unstable sort)
        order = torch.argsort(cid, stable=True)
        sc = cid[order]
        start = torch.searchsorted(sc, sc, right=False).to(i32)
        rank_sorted = torch.arange(S, dtype=i32, device=dev) - start
        tvalid = (sc < NC) & (rank_sorted < KB)
        slot = torch.empty((S,), dtype=i32, device=dev)
        slot[order] = torch.where(tvalid, rank_sorted, -1)
        flat = torch.where(slot >= 0, cid * KB + slot, -1)
        dst = torch.where(flat >= 0, flat, NC * KB).long()
        table = torch.full((NC * KB + 1,), S, dtype=i32, device=dev)
        table[dst] = torch.arange(S, dtype=i32, device=dev)
        table = table[:NC * KB]

        # ---- static per-rebuild body grids ----
        def sg(vals, fill=0.0):
            g = torch.full((NC * KB + 1,) + vals.shape[1:], fill,
                           dtype=vals.dtype, device=dev)
            g[dst] = vals                  # the spare row takes the drops
            return g[:NC * KB]

        g_aabb = sg(torch.stack([minx, miny, maxx, maxy], dim=1),
                    fill=2 * INF)
        # filter bits: 0 boundary, 1 small, 2 in_root
        fbits = (bnd.to(i32) | (small.to(i32) << 1)
                 | (in_root.to(i32) << 2))
        g_fbits = sg(fbits, fill=0)
        g_occ = sg(torch.ones((S,), dtype=torch.bool, device=dev),
                   fill=False)

        # ---- candidate masks + two-stage compaction per class ----
        def overlap(a, bg):
            ox = (a[..., 0] <= bg[..., 2]) & (bg[..., 0] <= a[..., 2])
            oy = (a[..., 1] <= bg[..., 3]) & (bg[..., 1] <= a[..., 3])
            return ox & oy

        def filt_ok(fa, fb):
            both_bnd = ((fa & 1) & (fb & 1)) > 0
            both_small = (((fa >> 1) & 1) & ((fb >> 1) & 1)) > 0
            in_both = (((fa >> 2) & 1) & ((fb >> 2) & 1)) > 0
            return ~both_bnd & ~both_small & in_both

        A4 = g_aabb.reshape(nbx, nbx, KB, 4)
        F = g_fbits.reshape(nbx, nbx, KB)
        OCC = g_occ.reshape(nbx, nbx, KB)
        yi = torch.arange(nbx, device=dev)[:, None, None]
        xi = torch.arange(nbx, device=dev)[None, :, None]

        def compact(m, attr, rk, cap):
            """stage 1: per (cell, lo-slot) the first rk partners; stage 2:
            per cell the first cap of those, packed (kb | ka << 8)."""
            kb_s1 = _place(m, attr, rk)                       # [NC, KB, rk]
            v1 = kb_s1 >= 0
            both = (torch.clamp(kb_s1, min=0) & 0xFF) | \
                (kiota[None, :, None] << 8)
            packed = _place(v1.reshape(NC, KB * rk),
                            both.reshape(NC, KB * rk), cap)   # [NC, cap]
            valid = packed >= 0
            pk = torch.clamp(packed, min=0)
            zero = torch.zeros((), dtype=i32, device=dev)
            return (torch.where(valid, pk >> 8, zero),
                    torch.where(valid, pk & 0xFF, zero), valid)

        cols = []
        for cls in classes:
            if cls["kind"] == "big":
                continue
            dx, dy = cls["dx"], cls["dy"]
            if (dx, dy) == (0, 0):
                m = (overlap(A4[:, :, :, None, :], A4[:, :, None, :, :])
                     & filt_ok(F[:, :, :, None], F[:, :, None, :])
                     & OCC[:, :, :, None] & OCC[:, :, None, :]
                     & (kiota[None, :] > kiota[:, None])[None, None])
                rk = RK["same"]
            else:
                An = torch.roll(A4, (-dy, -dx), dims=(0, 1))
                Fn = torch.roll(F, (-dy, -dx), dims=(0, 1))
                On = torch.roll(OCC, (-dy, -dx), dims=(0, 1))
                # zero the wrapped rows/cols of the rolled-in neighbour
                inb = torch.ones((nbx, nbx, 1), dtype=torch.bool, device=dev)
                if dy > 0:
                    inb = inb & (yi < nbx - dy)
                if dx > 0:
                    inb = inb & (xi < nbx - dx)
                if dx < 0:
                    inb = inb & (xi >= -dx)
                On = On & inb
                m = (overlap(A4[:, :, :, None, :], An[:, :, None, :, :])
                     & filt_ok(F[:, :, :, None], Fn[:, :, None, :])
                     & OCC[:, :, :, None] & On[:, :, None, :])
                rk = RK["off"]
            m = m.reshape(NC, KB, KB)
            cols.append(compact(m, kiota.expand(NC, KB, KB), rk,
                                cls["sl"].stop - cls["sl"].start))
        if NBIG:
            bm = torch.stack([minx[big_ids], miny[big_ids], maxx[big_ids],
                              maxy[big_ids]], dim=1)          # [NBIG, 4]
            fb = fbits[big_ids]
            m = (overlap(A4.reshape(NC, KB, 1, 4), bm[None, None])
                 & filt_ok(F.reshape(NC, KB, 1), fb[None, None])
                 & OCC.reshape(NC, KB, 1))
            gi = torch.arange(NBIG, dtype=i32, device=dev).expand(m.shape)
            cols.append(compact(m, gi, RK["big"], caps[5]))

        rg_ka = torch.cat([c[0] for c in cols], dim=1)
        rg_kb = torch.cat([c[1] for c in cols], dim=1)
        rg_valid = torch.cat([c[2] for c in cols], dim=1)
        return (flat, table, rg_ka, rg_kb, rg_valid,
                sg(b.verts[:S, :VS]), sg(b.nverts[:S]), sg(b.radius[:S]),
                sg(b.shape_kind[:S] == int(ShapeKind.CIRCLE), fill=False),
                sg(_inv_mass(b)), sg(_inv_inertia(b)),
                b.pos[:S], b.angle[:S],
                torch.zeros((NC, R, C), dtype=f32, device=dev),
                torch.zeros((NC, R, C), dtype=f32, device=dev),
                torch.full((NC, R, C, 2), INF, dtype=f32, device=dev),
                torch.zeros((NC, R, 2), dtype=f32, device=dev))

    def roll_cells(g, dx, dy):
        if dx == 0 and dy == 0:
            return g
        g2 = g.reshape((nbx, nbx) + g.shape[1:])
        return torch.roll(g2, (-dy, -dx), dims=(0, 1)).reshape(g.shape)

    # ------------------------------------------------------------------ tick
    def _rows(state):
        """The displacement guard, rebuild or reuse, the per-tick body
        grids and the two shapes of every candidate row."""
        b = state.bodies
        # displacement guard (pipeline.py:256-283 semantics)
        vmask = viota[None, :] < b.nverts[:S, None]
        vv = b.verts[:S, :VS]
        rad = sqrt(vv[..., 0] * vv[..., 0] + vv[..., 1] * vv[..., 1])
        br = torch.where(vmask, rad, 0.0).amax(-1)     # bounding radius
        dp = torch.abs(b.pos[:S] - state.bp_anchor_pos[:S]).amax(-1)
        da = torch.abs(b.angle[:S] - state.bp_anchor_ang[:S])
        disp = (dp + da * br).amax()
        need = ~(disp <= slack * 0.5)
        step.guard_reads += 1
        if bool(need):                     # the tick's one host read
            step.rebuilds += 1
            with record_function("rigid.rebuild"):
                grids = _rebuild(b)
        else:
            grids = (state.rg_flat, state.rg_table,
                     state.rg_ka, state.rg_kb, state.rg_valid,
                     state.rg_verts, state.rg_nverts, state.rg_radius,
                     state.rg_iscirc, state.rg_invm, state.rg_invi,
                     state.bp_anchor_pos[:S], state.bp_anchor_ang[:S],
                     state.rg_warm_n, state.rg_warm_t, state.rg_warm_pt,
                     state.rg_warm_nrm)
        (flat, table, rg_ka, rg_kb, rg_valid, g_verts, g_nverts, g_radius,
         g_iscirc, g_invm, g_invi, anc_p, anc_a,
         warm_n, warm_t, warm_pt, warm_nrm) = grids

        # ---- per-tick body grids (pos/angle/vel/omega) ----
        dst = torch.where(flat >= 0, flat, NC * KB).long()

        def tg(vals):
            g = torch.zeros((NC * KB + 1,) + vals.shape[1:], dtype=f32,
                            device=dev)
            g[dst] = vals.to(f32)
            return g[:NC * KB]

        g_pos = tg(b.pos[:S])
        g_ang = tg(b.angle[:S])
        g_u = tg(torch.cat([b.vel[:S], b.omega[:S, None]], dim=1))

        # ---- per-row shapes via class-wise slot selects ----
        if NBIG:
            big_shape = dict(
                pos=b.pos[big_ids], angle=b.angle[big_ids],
                verts=b.verts[big_ids, :VS], nverts=b.nverts[big_ids],
                invm=_inv_mass(b)[big_ids], invi=_inv_inertia(b)[big_ids],
                u=torch.cat([b.vel[big_ids], b.omega[big_ids, None]], dim=1))

        own = dict(verts=g_verts.reshape(NC, KB, VS, 2),
                   nverts=g_nverts.reshape(NC, KB),
                   pos=g_pos.reshape(NC, KB, 2), angle=g_ang.reshape(NC, KB))
        Gim = g_invm.reshape(NC, KB)
        Gii = g_invi.reshape(NC, KB)

        def sel_shape(shape_grids, k):
            return {key: _sel(g, k) for key, g in shape_grids.items()}

        sa_parts, sb_parts, row_imb, row_iib = [], [], [], []
        for cls in classes:
            sl = cls["sl"]
            ka, kb = rg_ka[:, sl], rg_kb[:, sl]
            sa_parts.append(sel_shape(own, ka))
            if cls["kind"] == "big":
                kbl = kb.long()
                sb_parts.append({key: big_shape[key][kbl] for key in own})
                row_imb.append(big_shape["invm"][kbl])
                row_iib.append(big_shape["invi"][kbl])
            else:
                dx, dy = cls["dx"], cls["dy"]
                sb_parts.append(sel_shape(
                    {key: roll_cells(g, dx, dy) for key, g in own.items()},
                    kb))
                row_imb.append(_sel(roll_cells(Gim, dx, dy), kb))
                row_iib.append(_sel(roll_cells(Gii, dx, dy), kb))

        def cat(parts):
            return {key: torch.cat([p[key] for p in parts], dim=1)
                    for key in parts[0]}

        sa = cat(sa_parts)
        sb = cat(sb_parts)
        im_b_r = torch.cat(row_imb, dim=1)
        ii_b_r = torch.cat(row_iib, dim=1)
        rows = (sa, sb, _sel(Gim, rg_ka), _sel(Gii, rg_ka), im_b_r, ii_b_r)
        return grids, (g_pos, g_ang, g_u), rows, \
            (big_shape if NBIG else None)

    def _narrowphase_args(sa, sb):
        """[NC*R] rows of (pos, angle, verts, nverts) of side A, then of
        side B: the narrowphase's inputs."""
        return tuple(v[key].reshape((NC * R,) + v[key].shape[2:])
                     for v in (sa, sb)
                     for key in ("pos", "angle", "verts", "nverts"))

    def narrowphase_inputs(state):
        """The tensors this state's tick hands the narrowphase kernel. Runs
        the guard (and the rebuild it may call for) as a tick would."""
        _, _, (sa, sb, *_), _ = _rows(state)
        return _narrowphase_args(sa, sb)

    def step(state: SimState) -> SimState:
        b = state.bodies
        with record_function("rigid.rows"):
            grids, (g_pos, g_ang, g_u), rows, big_shape = _rows(state)
        (flat, table, rg_ka, rg_kb, rg_valid, g_verts, g_nverts, g_radius,
         g_iscirc, g_invm, g_invi, anc_p, anc_a,
         warm_n, warm_t, warm_pt, warm_nrm) = grids
        sa, sb, im_a_r, ii_a_r, im_b_r, ii_b_r = rows

        # ---- narrowphase: SAT + incident-edge clip over [NC*R] rows ----
        with record_function("rigid.narrowphase"):
            hit, nrm, pen, pts, pens, cval = narrow(
                *_narrowphase_args(sa, sb))
        nrm = nrm.reshape(NC, R, 2)
        valid = (rg_valid & hit.reshape(NC, R))[..., None] \
            & cval.reshape(NC, R, C)
        # sanitize invalid rows: clipping on garbage slot-0 shapes can emit
        # inf/NaN points, and NaN*0 would leak through the masked scatters
        pts = torch.where(valid[..., None], pts.reshape(NC, R, C, 2), 0.0)
        pens = torch.where(valid, pens.reshape(NC, R, C), 0.0)

        # ---- warm start (slot-persistent; point-matched within pair) ----
        if rc.warm_start:
            ln0, lt0 = match_warm_impulses(
                pts.reshape(NC * R, C, 2), nrm.reshape(NC * R, 2),
                warm_pt.reshape(NC * R, C, 2), warm_nrm.reshape(NC * R, 2),
                warm_n.reshape(NC * R, C), warm_t.reshape(NC * R, C),
                torch.ones((NC * R,), dtype=torch.bool, device=dev),
                tol=rc.warm_position_tolerance,
                slot_fallback=rc.warm_slot_fallback)
            ln0 = torch.where(valid, ln0.reshape(NC, R, C), 0.0)
            lt0 = torch.where(valid, lt0.reshape(NC, R, C), 0.0)

        # ---- per-row solver constants ----
        nh = geo._unit(nrm)
        th = torch.stack([-nh[..., 1], nh[..., 0]], dim=-1)
        ra = pts - sa["pos"][:, :, None, :]                   # [NC,R,C,2]
        rb = pts - sb["pos"][:, :, None, :]
        ra_xn = _cross2(ra, nh[:, :, None, :])
        rb_xn = _cross2(rb, nh[:, :, None, :])
        ra_xt = _cross2(ra, th[:, :, None, :])
        rb_xt = _cross2(rb, th[:, :, None, :])
        # own-contact normal->tangent coupling (solver.py ctn)
        ctn = (ra_xn * ra_xt * ii_a_r[..., None]
               + rb_xn * rb_xt * ii_b_r[..., None])

        def degrees(count):
            """Mass-splitting degrees of each row's two bodies: the class's
            contact count per body, at least 1; the big side is frozen."""
            dga = torch.zeros((NC, R), dtype=f32, device=dev)
            dgb = torch.zeros((NC, R), dtype=f32, device=dev)
            for cls in classes:
                sl = cls["sl"]
                ka, kb = rg_ka[:, sl], rg_kb[:, sl]
                d_own = _scat(count[:, sl], ka, KB)           # [NC, KB]
                if cls["kind"] == "big":
                    d_cls = d_own
                    dgb[:, sl] = 1.0
                else:
                    dx, dy = cls["dx"], cls["dy"]
                    d_cls = d_own + roll_cells(_scat(count[:, sl], kb, KB),
                                               -dx, -dy)
                    dgb[:, sl] = torch.clamp(
                        _sel(roll_cells(d_cls, dx, dy), kb), min=1.0)
                dga[:, sl] = torch.clamp(_sel(d_cls, ka), min=1.0)
            return dga, dgb

        deg_a_r, deg_b_r = degrees(valid.sum(-1).to(f32))

        def eff(im_a, im_b, ii_a, ii_b, rx_a, rx_b, dga, dgb):
            s = (im_a * dga + im_b * dgb
                 + rx_a * rx_a * ii_a * dga + rx_b * rx_b * ii_b * dgb)
            return torch.where(s < 1e-12, 0.0,
                               true_div(1.0, torch.clamp(s, min=1e-12)))

        va_c = valid.to(f32)
        row = (im_a_r[..., None], im_b_r[..., None], ii_a_r[..., None],
               ii_b_r[..., None])
        degs = (deg_a_r[..., None], deg_b_r[..., None])
        eff_n = eff(*row, ra_xn, rb_xn, *degs) * va_c
        eff_t = eff(*row, ra_xt, rb_xt, *degs) * va_c

        # ---- velocity solve (staged projected Jacobi over class passes) ----
        def partner(X, cls, kb, big_x):
            if cls["kind"] == "big":
                return big_x[kb.long()]
            return _sel(roll_cells(X, cls["dx"], cls["dy"]), kb)

        def class_rel_vel(U, cls, ka, kb, sl):
            ua = _sel(U, ka)                                  # [NC,Rc,3]
            ub = partner(U, cls, kb, big_shape["u"] if NBIG else None)
            va = ua[..., None, :2] + torch.stack(
                [-ua[..., None, 2] * ra[:, sl, :, 1],
                 ua[..., None, 2] * ra[:, sl, :, 0]], -1)
            vb = ub[..., None, :2] + torch.stack(
                [-ub[..., None, 2] * rb[:, sl, :, 1],
                 ub[..., None, 2] * rb[:, sl, :, 0]], -1)
            rv = vb - va                                      # [NC,Rc,C,2]
            return geo._dot2(rv, nh[:, sl, None, :]), \
                geo._dot2(rv, th[:, sl, None, :])

        def class_apply(U, cls, ka, kb, sl, dln, dlt):
            imp = (nh[:, sl, None, :] * dln[..., None]
                   + th[:, sl, None, :] * dlt[..., None])     # [NC,Rc,C,2]
            tq_a = ra_xn[:, sl] * dln + ra_xt[:, sl] * dlt
            tq_b = rb_xn[:, sl] * dln + rb_xt[:, sl] * dlt
            da = torch.cat(
                [-imp.sum(2) * im_a_r[:, sl, None],
                 -(tq_a.sum(2) * ii_a_r[:, sl])[..., None]], dim=-1)
            U = U + _scat(da, ka, KB)
            if cls["kind"] != "big":
                db = torch.cat(
                    [imp.sum(2) * im_b_r[:, sl, None],
                     (tq_b.sum(2) * ii_b_r[:, sl])[..., None]], dim=-1)
                U = U + roll_cells(_scat(db, kb, KB), -cls["dx"], -cls["dy"])
            return U

        U = g_u.reshape(NC, KB, 3)
        ln = torch.zeros((NC, R, C), dtype=f32, device=dev)
        lt = torch.zeros((NC, R, C), dtype=f32, device=dev)
        if rc.warm_start:
            # pre-apply cached impulses on approaching contacts
            # (solver.py:229-238 semantics), class-sequential
            for cls in classes:
                sl = cls["sl"]
                ka, kb = rg_ka[:, sl], rg_kb[:, sl]
                vn0, _ = class_rel_vel(U, cls, ka, kb, sl)
                ok = valid[:, sl] & (vn0 <= 0.0)
                ln_s = torch.where(ok, ln0[:, sl], 0.0)
                lt_s = torch.where(ok, lt0[:, sl], 0.0)
                U = class_apply(U, cls, ka, kb, sl, ln_s, lt_s)
                ln[:, sl] = ln_s
                lt[:, sl] = lt_s

        for _ in range(rc.solver.iterations):
            for cls in classes:
                sl = cls["sl"]
                ka, kb = rg_ka[:, sl], rg_kb[:, sl]
                vn, vt = class_rel_vel(U, cls, ka, kb, sl)
                lns, lts, vs = ln[:, sl], lt[:, sl], valid[:, sl]
                dl = -eff_n[:, sl] * vn * relax
                new_ln = torch.clamp(lns + dl, min=0.0)
                dln = torch.where(vs, new_ln - lns, 0.0)
                lim = mu * new_ln
                vt = vt + dln * ctn[:, sl]
                new_lt = torch.clamp(lts - eff_t[:, sl] * vt * relax,
                                     -lim, lim)
                dlt = torch.where(vs, new_lt - lts, 0.0)
                U = class_apply(U, cls, ka, kb, sl, dln, dlt)
                ln[:, sl] = torch.where(vs, new_ln, lns)
                lt[:, sl] = torch.where(vs, new_lt, lts)

        # ---- position solve (Baumgarte, lever arms track; solver.py) ----
        Q = torch.cat([g_pos.reshape(NC, KB, 2), g_ang.reshape(NC, KB, 1)],
                      dim=-1)
        act = valid & ((pens - rc.position.slop) > 0.0)
        corr = rc.position.baumgarte * (pens - rc.position.slop)
        dga_p, dgb_p = degrees(act.sum(-1).to(f32))
        big_q = torch.cat([big_shape["pos"], big_shape["angle"][:, None]],
                          dim=-1) if NBIG else None

        for _ in range(rc.position.iterations):
            for cls in classes:
                sl = cls["sl"]
                ka, kb = rg_ka[:, sl], rg_kb[:, sl]
                qa = _sel(Q, ka)
                qb = partner(Q, cls, kb, big_q)
                ra_ = pts[:, sl] - qa[..., None, :2]
                rb_ = pts[:, sl] - qb[..., None, :2]
                rxa = _cross2(ra_, nh[:, sl, None, :])
                rxb = _cross2(rb_, nh[:, sl, None, :])
                den = (im_a_r[:, sl, None] * dga_p[:, sl, None]
                       + im_b_r[:, sl, None] * dgb_p[:, sl, None]
                       + rxa * rxa * ii_a_r[:, sl, None] * dga_p[:, sl, None]
                       + rxb * rxb * ii_b_r[:, sl, None]
                       * dgb_p[:, sl, None])
                scl = torch.where(act[:, sl] & (den > 1e-12),
                                  corr[:, sl] / torch.clamp(den, min=1e-12),
                                  0.0)
                d = nh[:, sl, None, :] * scl[..., None]
                dqa = torch.cat(
                    [-d.sum(2) * im_a_r[:, sl, None],
                     -((rxa * scl).sum(2) * ii_a_r[:, sl])[..., None]],
                    dim=-1)
                Q = Q + _scat(dqa, ka, KB)
                if cls["kind"] != "big":
                    dqb = torch.cat(
                        [d.sum(2) * im_b_r[:, sl, None],
                         ((rxb * scl).sum(2) * ii_b_r[:, sl])[..., None]],
                        dim=-1)
                    Q = Q + roll_cells(_scat(dqb, kb, KB), -cls["dx"],
                                       -cls["dy"])

        # ---- gather back to body arrays ----
        src = torch.where(flat >= 0, flat, 0).long()
        on_grid = flat >= 0
        Uf = U.reshape(NC * KB, 3)[src]
        Qf = Q.reshape(NC * KB, 3)[src]

        def put(field, new):
            return torch.cat([new.to(field.dtype), field[S:]], dim=0)

        nb_ = b.replace(
            pos=put(b.pos, torch.where(on_grid[:, None], Qf[:, :2],
                                       b.pos[:S])),
            vel=put(b.vel, torch.where(on_grid[:, None], Uf[:, :2],
                                       b.vel[:S])),
            angle=put(b.angle, torch.where(on_grid, Qf[:, 2], b.angle[:S])),
            omega=put(b.omega, torch.where(on_grid, Uf[:, 2], b.omega[:S])),
        )
        return state.replace(
            bodies=nb_,
            rg_flat=flat, rg_table=table,
            rg_ka=rg_ka, rg_kb=rg_kb, rg_valid=rg_valid,
            rg_verts=g_verts, rg_nverts=g_nverts, rg_radius=g_radius,
            rg_iscirc=g_iscirc, rg_invm=g_invm, rg_invi=g_invi,
            bp_anchor_pos=put(state.bp_anchor_pos, anc_p),
            bp_anchor_ang=put(state.bp_anchor_ang, anc_a),
            rg_warm_n=torch.where(valid, ln, 0.0),
            rg_warm_t=torch.where(valid, lt, 0.0),
            rg_warm_pt=torch.where(valid[..., None], pts, INF),
            rg_warm_nrm=nh,
        )

    step.guard_reads = 0
    step.rebuilds = 0
    step.narrowphase_inputs = narrowphase_inputs
    return step
