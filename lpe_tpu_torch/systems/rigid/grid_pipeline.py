"""Grid-resident rigid pipeline: the big-scene rigid path.

The counterpart of ``lpe_tpu/systems/rigid/grid_pipeline.py``. Bodies
live in a dense [cell, slot] grid (cell = broadphase cell, slot < KB),
rebuilt only when the displacement guard trips. Candidate pairs are per-cell
row tensors [NC, R] with a static class layout over the forward
half-stencil (same cell, E, SW, S, SE) plus a "big solid" class for the
walls kept off the grid; a row holds (own slot, partner slot) and its class
implies the partner cell, reached by rolling the grid. The narrowphase runs
over all NC * R rows (``ops/rigid_kernels.narrowphase_grid``: on the card a
CUDA kernel that reads the body grids by slot itself), and both solvers
iterate on the dense grids, one mass-splitting Jacobi pass per class, the
six class passes in turn (staged Gauss-Seidel).

The semantics are lpe_tpu's; the TPU layout is not kept:

- a row picks a body's fields by slot with ``torch.gather`` (``_sel``),
  where lpe_tpu used a one-hot broadcast-reduce because gathers were slow
  on the TPU; the values are the same. The rows' shapes are not gathered
  here at all: the narrowphase reads them from the grids (its plain
  version, ``rigid_kernels.grid_rows``, gathers them);
- ``_place`` ranks and scatters where lpe_tpu unrolled one reduction per
  output slot; every target is written once, so the integers are the same;
- ``_scat`` keeps the broadcast-reduce: float atomics would make the sum's
  order, and so the result, vary from run to run;
- ``lax.cond`` on the displacement guard becomes one host read of ``need``
  per tick (``step.guard_reads`` counts them, ``step.rebuilds`` the ticks
  that rebuilt), and ``fori_loop`` a Python loop;
- tracer spans (``core/profiler.py``) ``rigid.rows`` (guard, rebuild, per-tick grids and the
  rows' mass selects; within it ``rigid.rebuild``) and
  ``rigid.narrowphase`` take the place of
  ``jax.named_scope``; the solvers are the rest of the system's range;
- ``_rebuild`` assigns slots with a STABLE argsort, so the bodies of a cell
  take ascending slots in body order. lpe_tpu's ``jnp.argsort(cid,
  stable=False)`` leaves that order to XLA, which on the CPU does not keep
  body order within a cell, and no port can reproduce it. Slot order
  changes only which candidates a saturated cell or class drops, so the
  two packages agree wherever ``core.telemetry.capacity_report`` shows no
  saturation.

Scenes with circle solids, or with ``max_contacts_per_pair != 2``, take
the plain geometry path in place of the kernel (``geometry.sat_contact``
with its circle branches, then ``pipeline._pair_contacts``), as lpe_tpu
takes its XLA path there.

Over a ``mesh`` of D > 1 devices whose size divides nbx, the tick runs in
y-row bands, the split of lpe_tpu's ``rg_*`` cell axis
(``parallel.sharded``). The guard and the rebuild stay whole on the lead
device; band i takes cell rows [i nbx/D, (i+1) nbx/D) of the candidate
rows, the warm starts and the body grids, and the row below them (the
halo row: the forward half-stencil's partners lie at dy in {0, 1}; the
last band's is row 0, so the whole grid's wrap is kept). A band runs the
narrowphase on its rows, the warm start, the row constants and the
solvers on its grids, which wrap over its own rows (``_Part``). In a
class pass with dy = 1 each band's halo row first takes the next band's
first row (``refresh``), and after the pass the increments a band rolled
into its halo row go to the next band's first row (``pass_on``), added
after the cell's own, in the single device's order. Velocities,
positions and warm starts come back to the lead in cell order. Every op
is per cell or per row, so the bands give the single device's bits;
``step.halo_stats`` counts the exchanges.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from ...core.config import ScenarioSystemConfig
from ...core.constants import ShapeKind
from ...core.numerics import sqrt, true_div
from ...core.profiler import PROFILER
from ...scene import SceneSpec
from ...state import SimState
from . import geometry as geo
from .pipeline import _aabbs, _pair_contacts, _solid_shapes
from .solver import match_warm_impulses
from ...ops.rigid_kernels import band_cells

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


class _Part:
    """The cells a part of the tick holds on its device ``dev``: cell rows
    [r0, r0 + rows) of the nbx x nbx grid, which own candidate rows, and
    ``halo`` (0 or 1) rows after them, which do not. The whole grid is r0
    = 0, rows = nbx, halo = 0, on the lead device: then every method gives
    its argument back, and the tick runs the single-device ops. A y-row
    band holds the row below its own ((r0 + rows) mod nbx: the forward
    half-stencil's partners lie at dy in {0, 1}), and its grids wrap over
    its ny = rows + 1 rows, so that its own rows' partners are read from
    the halo row, never wrapped."""

    def __init__(self, dev, r0, rows, halo, nbx, lead):
        self.dev = torch.device(dev)
        self.r0, self.rows, self.halo, self.nbx = r0, rows, halo, nbx
        self.ny = rows + halo
        self.own = rows * nbx              # cells that own candidate rows
        self.whole = halo == 0 and r0 == 0 and rows == nbx and \
            self.dev == torch.device(lead)
        self.cells = None if self.whole else \
            band_cells(nbx, r0, rows, lead)

    def to(self, t):
        return t if self.whole else t.to(self.dev, non_blocking=True)

    def cut(self, g):
        """The part's cells [ny * nbx, ...] of a grid [NC, ...]."""
        return g if self.whole else self.to(g.index_select(0, self.cells))

    def rows_of(self, t):
        """The own cells' [own, ...] of a row tensor [NC, ...]."""
        return t if self.whole else self.to(
            t[self.r0 * self.nbx:(self.r0 + self.rows) * self.nbx])

    def own_cells(self, g):
        return g if self.whole else g[:self.own]

    def grow(self, y):
        """An own-cells tensor [own, ...] with zeros for the halo row."""
        if not self.halo:
            return y
        return torch.nn.functional.pad(
            y, (0, 0) * (y.dim() - 1) + (0, self.halo * self.nbx))

    def roll(self, g, dx, dy):
        """g[(cy + dy) mod ny, (cx + dx) mod nbx] at every cell."""
        if dx == 0 and dy == 0:
            return g
        g2 = g.reshape((self.ny, self.nbx) + g.shape[1:])
        return torch.roll(g2, (-dy, -dx), dims=(0, 1)).reshape(g.shape)


def make_grid_rigid_system(spec: SceneSpec, cfg: ScenarioSystemConfig, *,
                           device="cuda", mesh=None):
    gd = grid_dims(spec, cfg)
    assert gd is not None
    S = spec.n_solid
    rc = cfg.rigid
    bp = rc.broadphase
    C = rc.max_contacts_per_pair
    # the kernel takes polygon pairs with two contacts; other scenes take
    # the plain geometry path
    circ = spec.any_rigid_circle
    plain_rows = circ or C != 2
    nb = getattr(rc, "narrowphase_backend", "auto")
    if nb not in ("auto", "pallas", "xla"):
        raise ValueError(f"narrowphase_backend={nb!r}")
    # "auto"/"pallas": the kernel wrapper (the CUDA kernel for CUDA tensors,
    # its plain version for CPU ones); "xla": the plain geometry path itself
    from ...ops import rigid_kernels as rko
    narrow = rko.narrowphase_grid_plain if nb == "xla" else \
        rko.narrowphase_grid
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
    # the classes as the narrowphase takes them: (rows, dx, dy, big)
    layout = tuple((c["sl"].stop - c["sl"].start, c["dx"], c["dy"],
                    c["kind"] == "big") for c in classes)
    # per-(lo-slot) stage-1 caps: how many rows one body can own per class
    # before the per-cell compaction
    RK = {"same": max(6, caps[0] // 4), "off": max(4, caps[1] // 4),
          "big": min(4, NBIG) if NBIG else 0}

    kiota = torch.arange(KB, dtype=i32, device=dev)
    viota = torch.arange(VS, device=dev)

    # ---------------------------------------------------------------- rebuild
    def _is_circle(b, idx):
        return b.shape_kind[idx] == int(ShapeKind.CIRCLE)

    def _inv_mass(b):
        m = b.mass[:S]
        return torch.where(m > 1e29, 0.0,
                           true_div(1.0, torch.clamp(m, min=1e-30)))

    def _inv_inertia(b):
        i = b.inertia[:S]
        return torch.where((i > 1e-12) & (i < 1e29),
                           true_div(1.0, torch.clamp(i, min=1e-30)), 0.0)

    def _rebuild(b):
        minx, miny, maxx, maxy = _aabbs(_solid_shapes(b, S, VS))
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

    # ------------------------------------------------------------- parts
    whole = _Part(dev, 0, nbx, 0, nbx, dev)
    n_bands = mesh.size if mesh is not None else 1
    banded = n_bands > 1 and nbx % n_bands == 0
    if banded:
        rows_b = nbx // n_bands
        parts = [_Part(d, i * rows_b, rows_b, 1, nbx, dev)
                 for i, d in enumerate(mesh.devices)]
    else:
        parts = [whole]
    # bytes and copies of the bands' exchanges, and the bytes the split
    # moves to the bands and back, since the step was built
    halo_stats = dict(bytes=0, copies=0, split_bytes=0)

    def refresh(X):
        """Each band's halo row <- the first row of the band after it
        (cyclically: the last band's halo row is the grid's row 0)."""
        for i, p in enumerate(parts):
            src = X[(i + 1) % n_bands][:nbx]
            X[i][p.own:].copy_(src, non_blocking=True)
            halo_stats["bytes"] += src.numel() * src.element_size()
            halo_stats["copies"] += 1

    def pass_on(Y):
        """Each band's first row <- what the band before it rolled into its
        halo row: the increments of the cells of that row."""
        for i, p in enumerate(parts):
            src = Y[i][p.own:]
            Y[(i + 1) % n_bands][:nbx].copy_(src, non_blocking=True)
            halo_stats["bytes"] += src.numel() * src.element_size()
            halo_stats["copies"] += 1

    def gather(X):
        """The parts' own cells of X, on the lead device in cell order."""
        if not banded:
            return X[0]
        out = [p.own_cells(x).to(dev, non_blocking=True)
               for p, x in zip(parts, X)]
        halo_stats["split_bytes"] += sum(t.numel() * t.element_size()
                                         for t in out)
        return torch.cat(out)

    # ------------------------------------------------------------------ tick
    def _rows(state):
        """The displacement guard, rebuild or reuse, and the per-tick body
        grids (pos/angle/vel/omega), on the lead device."""
        b = state.bodies
        # displacement guard (pipeline.py:256-283 semantics)
        vmask = viota[None, :] < b.nverts[:S, None]
        vv = b.verts[:S, :VS]
        rad = sqrt(vv[..., 0] * vv[..., 0] + vv[..., 1] * vv[..., 1])
        br = torch.where(vmask, rad, 0.0).amax(-1)     # bounding radius
        if circ:
            br = torch.where(_is_circle(b, slice(0, S)), b.radius[:S], br)
        dp = torch.abs(b.pos[:S] - state.bp_anchor_pos[:S]).amax(-1)
        da = torch.abs(b.angle[:S] - state.bp_anchor_ang[:S])
        disp = (dp + da * br).amax()
        need = ~(disp <= slack * 0.5)
        step.guard_reads += 1
        if bool(need):                     # the tick's one host read
            step.rebuilds += 1
            with PROFILER.scope("rigid.rebuild"):
                grids = _rebuild(b)
        else:
            grids = (state.rg_flat, state.rg_table,
                     state.rg_ka, state.rg_kb, state.rg_valid,
                     state.rg_verts, state.rg_nverts, state.rg_radius,
                     state.rg_iscirc, state.rg_invm, state.rg_invi,
                     state.bp_anchor_pos[:S], state.bp_anchor_ang[:S],
                     state.rg_warm_n, state.rg_warm_t, state.rg_warm_pt,
                     state.rg_warm_nrm)

        # ---- per-tick body grids (pos/angle/vel/omega) ----
        dst = torch.where(grids[0] >= 0, grids[0], NC * KB).long()

        def tg(vals):
            g = torch.zeros((NC * KB + 1,) + vals.shape[1:], dtype=f32,
                            device=dev)
            g[dst] = vals.to(f32)
            return g[:NC * KB]

        g_pos = tg(b.pos[:S])
        g_ang = tg(b.angle[:S])
        g_u = tg(torch.cat([b.vel[:S], b.omega[:S, None]], dim=1))
        return grids, (g_pos, g_ang, g_u)

    def _part_inputs(p, state, grids, tick_grids):
        """What part ``p`` takes of the tick: its cells of the body grids
        (the halo row's too), its own cells' candidate rows and warm
        starts, the big bodies, the narrowphase's arguments and the rows'
        masses and inertias, on its device."""
        b = state.bodies
        (_, _, rg_ka, rg_kb, rg_valid, g_verts, g_nverts, g_radius,
         g_iscirc, g_invm, g_invi, _, _,
         warm_n, warm_t, warm_pt, warm_nrm) = grids
        g_pos, g_ang, g_u = tick_grids
        w = SimpleNamespace()
        cut, rows, to = p.cut, p.rows_of, p.to
        w.ka, w.kb, w.rvalid = rows(rg_ka), rows(rg_kb), rows(rg_valid)
        w.warm = tuple(rows(t) for t in (warm_n, warm_t, warm_pt, warm_nrm))
        w.pos = cut(g_pos.reshape(NC, KB, 2))
        w.u = cut(g_u.reshape(NC, KB, 3))
        w.ang = cut(g_ang.reshape(NC, KB))
        big_pos, big_ang = b.pos[big_ids], b.angle[big_ids]
        w.nargs = (w.pos, w.ang, cut(g_verts.reshape(NC, KB, VS, 2)),
                   cut(g_nverts.reshape(NC, KB)), to(big_pos), to(big_ang),
                   to(b.verts[big_ids, :VS]), to(b.nverts[big_ids]),
                   w.ka, w.kb)
        if plain_rows:
            w.circ = (cut(g_radius.reshape(NC, KB)),
                      cut(g_iscirc.reshape(NC, KB)),
                      to(b.radius[big_ids]), to(_is_circle(b, big_ids)))
        w.big = None
        if NBIG:
            w.big = dict(
                pos=big_pos, angle=big_ang,
                invm=_inv_mass(b)[big_ids], invi=_inv_inertia(b)[big_ids],
                u=torch.cat([b.vel[big_ids], b.omega[big_ids, None]], dim=1))
            w.big = {k: to(v) for k, v in w.big.items()}
        if not p.whole:
            halo_stats["split_bytes"] += sum(
                t.numel() * t.element_size() for t in (
                    *w.nargs, w.u, w.rvalid, *w.warm,
                    *(w.circ if plain_rows else ())))
        Gim = cut(g_invm.reshape(NC, KB))
        Gii = cut(g_invi.reshape(NC, KB))
        row_imb, row_iib = [], []
        for cls in classes:
            kb = w.kb[:, cls["sl"]]
            if cls["kind"] == "big":
                kbl = kb.long()
                row_imb.append(w.big["invm"][kbl])
                row_iib.append(w.big["invi"][kbl])
            else:
                dx, dy = cls["dx"], cls["dy"]
                row_imb.append(_sel(p.own_cells(p.roll(Gim, dx, dy)), kb))
                row_iib.append(_sel(p.own_cells(p.roll(Gii, dx, dy)), kb))
        w.im_a, w.ii_a = (_sel(p.own_cells(Gim), w.ka),
                          _sel(p.own_cells(Gii), w.ka))
        w.im_b, w.ii_b = torch.cat(row_imb, dim=1), torch.cat(row_iib, dim=1)
        return w

    def _plain_rows(w):
        """The plain geometry narrowphase of the candidate rows (circles,
        any C): the outputs of ``narrowphase_grid``, contact masks without
        the hit."""
        g_rad, g_circ, big_rad, big_circ = w.circ
        grids, bigs = list(w.nargs[:4]), list(w.nargs[4:8])
        grids += [g_rad, g_circ]
        bigs += [big_rad, big_circ]
        sides = rko.grid_gather(grids, bigs, *w.nargs[8:], nbx=nbx,
                               layout=layout)
        sa, sb = ({"pos": p, "angle": a, "verts": v, "nverts": n,
                   "vmask": viota[None, :].to(n.device) < n[:, None],
                   **({"radius": r, "is_circle": c} if circ else {})}
                  for p, a, v, n, r, c in sides)
        hit, nrm, pen = geo.sat_contact(sa, sb, any_circle=circ)
        pts, pens, cval = _pair_contacts(sa, sb, nrm, pen, C)
        return hit, nrm, pen, pts, pens, cval, sa["pos"], sb["pos"]

    def narrowphase_args(state):
        """The arguments this state's tick hands the narrowphase on the
        whole grid: the tensors and the keywords of
        ``rigid_kernels.narrowphase_grid`` (``rigid_kernels.grid_rows``
        takes the same and gives the row-form kernel's; ``rigid_kernels
        .grid_band`` cuts a band's from them), and which rows are
        candidates (rg_valid [NC, R]). Runs the guard (and the rebuild it
        may call for) as a tick would."""
        grids, tick_grids = _rows(state)
        w = _part_inputs(whole, state, grids, tick_grids)
        return w.nargs, dict(nbx=nbx, layout=layout), grids[4]

    def _contacts(p, w):
        """The part's narrowphase results, warm start and per-row solver
        constants (all per row: no exchange)."""
        NR = p.own
        hit, nrm, pen, pts, pens, cval, pos_a, pos_b = w.narrow
        nrm = nrm.reshape(NR, R, 2)
        valid = (w.rvalid & hit.reshape(NR, R))[..., None] \
            & cval.reshape(NR, R, C)
        # sanitize invalid rows: clipping on garbage slot-0 shapes can emit
        # inf/NaN points, and NaN*0 would leak through the masked scatters
        w.pts = torch.where(valid[..., None], pts.reshape(NR, R, C, 2), 0.0)
        w.pens = torch.where(valid, pens.reshape(NR, R, C), 0.0)
        w.valid = valid

        # ---- warm start (slot-persistent; point-matched within pair) ----
        if rc.warm_start:
            warm_n, warm_t, warm_pt, warm_nrm = w.warm
            ln0, lt0 = match_warm_impulses(
                w.pts.reshape(NR * R, C, 2), nrm.reshape(NR * R, 2),
                warm_pt.reshape(NR * R, C, 2), warm_nrm.reshape(NR * R, 2),
                warm_n.reshape(NR * R, C), warm_t.reshape(NR * R, C),
                torch.ones((NR * R,), dtype=torch.bool, device=p.dev),
                tol=rc.warm_position_tolerance,
                slot_fallback=rc.warm_slot_fallback)
            w.ln0 = torch.where(valid, ln0.reshape(NR, R, C), 0.0)
            w.lt0 = torch.where(valid, lt0.reshape(NR, R, C), 0.0)

        # ---- per-row solver constants ----
        w.nh = nh = geo._unit(nrm)
        w.th = th = torch.stack([-nh[..., 1], nh[..., 0]], dim=-1)
        w.ra = ra = w.pts - pos_a.reshape(NR, R, 1, 2)        # [NR,R,C,2]
        w.rb = rb = w.pts - pos_b.reshape(NR, R, 1, 2)
        w.ra_xn = _cross2(ra, nh[:, :, None, :])
        w.rb_xn = _cross2(rb, nh[:, :, None, :])
        w.ra_xt = _cross2(ra, th[:, :, None, :])
        w.rb_xt = _cross2(rb, th[:, :, None, :])
        # own-contact normal->tangent coupling (solver.py ctn)
        w.ctn = (w.ra_xn * w.ra_xt * w.ii_a[..., None]
                 + w.rb_xn * w.rb_xt * w.ii_b[..., None])

    def degrees(W, counts):
        """Mass-splitting degrees of each row's two bodies: the class's
        contact count per body, at least 1; the big side is frozen. A
        (dy = 1) class takes the partner counts of a band's last row into
        the next band's first row, then the next band's totals of that row
        into its halo row."""
        dga = [torch.zeros((p.own, R), dtype=f32, device=p.dev)
               for p in parts]
        dgb = [torch.zeros((p.own, R), dtype=f32, device=p.dev)
               for p in parts]
        for cls in classes:
            sl = cls["sl"]
            d_own = [_scat(c[:, sl], w.ka[:, sl], KB)        # [own, KB]
                     for c, w in zip(counts, W)]
            if cls["kind"] == "big":
                d_cls = d_own
                for i, w in enumerate(W):
                    dgb[i][:, sl] = 1.0
            else:
                dx, dy = cls["dx"], cls["dy"]
                ysh = [p.roll(p.grow(_scat(c[:, sl], w.kb[:, sl], KB)),
                              -dx, -dy)
                       for p, c, w in zip(parts, counts, W)]
                if banded and dy:
                    pass_on(ysh)
                d_cls = [p.grow(d) + y for p, d, y in zip(parts, d_own, ysh)]
                if banded and dy:
                    refresh(d_cls)
                for i, (p, w) in enumerate(zip(parts, W)):
                    dgb[i][:, sl] = torch.clamp(
                        _sel(p.own_cells(p.roll(d_cls[i], dx, dy)),
                             w.kb[:, sl]), min=1.0)
            for i, (p, w) in enumerate(zip(parts, W)):
                dga[i][:, sl] = torch.clamp(
                    _sel(p.own_cells(d_cls[i]), w.ka[:, sl]), min=1.0)
        return dga, dgb

    def eff(im_a, im_b, ii_a, ii_b, rx_a, rx_b, dga, dgb):
        s = (im_a * dga + im_b * dgb
             + rx_a * rx_a * ii_a * dga + rx_b * rx_b * ii_b * dgb)
        return torch.where(s < 1e-12, 0.0,
                           true_div(1.0, torch.clamp(s, min=1e-12)))

    def partner(p, X, cls, kb, big_x):
        if cls["kind"] == "big":
            return big_x[kb.long()]
        return _sel(p.own_cells(p.roll(X, cls["dx"], cls["dy"])), kb)

    def class_rel_vel(p, w, U, cls):
        sl = cls["sl"]
        ka, kb = w.ka[:, sl], w.kb[:, sl]
        ua = _sel(p.own_cells(U), ka)                      # [own,Rc,3]
        ub = partner(p, U, cls, kb, w.big["u"] if NBIG else None)
        ra, rb = w.ra[:, sl], w.rb[:, sl]
        va = ua[..., None, :2] + torch.stack(
            [-ua[..., None, 2] * ra[..., 1], ua[..., None, 2] * ra[..., 0]],
            -1)
        vb = ub[..., None, :2] + torch.stack(
            [-ub[..., None, 2] * rb[..., 1], ub[..., None, 2] * rb[..., 0]],
            -1)
        rv = vb - va                                          # [own,Rc,C,2]
        return geo._dot2(rv, w.nh[:, sl, None, :]), \
            geo._dot2(rv, w.th[:, sl, None, :])

    def class_apply(W, X, cls, incs):
        """X (a grid a part) plus the class's increments ``incs`` (a part's
        (side A, side B or None for the big class) rows): each part's own
        side, then the partner side rolled into the partner cells, which a
        (dy = 1) class passes on from a band's halo row to the next band's
        first row."""
        sl = cls["sl"]
        ysh = []
        for i, (p, w, (da, db)) in enumerate(zip(parts, W, incs)):
            X[i] = X[i] + p.grow(_scat(da, w.ka[:, sl], KB))
            if db is not None:
                ysh.append(p.roll(p.grow(_scat(db, w.kb[:, sl], KB)),
                                  -cls["dx"], -cls["dy"]))
        if ysh:
            if banded and cls["dy"]:
                pass_on(ysh)
            X = [x + y for x, y in zip(X, ysh)]
        return X

    def vel_incr(w, cls, dln, dlt):
        """A class's velocity increments of sides A and B (None: big)."""
        sl = cls["sl"]
        imp = (w.nh[:, sl, None, :] * dln[..., None]
               + w.th[:, sl, None, :] * dlt[..., None])       # [own,Rc,C,2]
        tq_a = w.ra_xn[:, sl] * dln + w.ra_xt[:, sl] * dlt
        da = torch.cat(
            [-imp.sum(2) * w.im_a[:, sl, None],
             -(tq_a.sum(2) * w.ii_a[:, sl])[..., None]], dim=-1)
        if cls["kind"] == "big":
            return da, None
        tq_b = w.rb_xn[:, sl] * dln + w.rb_xt[:, sl] * dlt
        return da, torch.cat(
            [imp.sum(2) * w.im_b[:, sl, None],
             (tq_b.sum(2) * w.ii_b[:, sl])[..., None]], dim=-1)

    def step(state: SimState) -> SimState:
        b = state.bodies
        with PROFILER.scope("rigid.rows"):
            grids, tick_grids = _rows(state)
            W = [_part_inputs(p, state, grids, tick_grids) for p in parts]

        # ---- narrowphase: SAT + incident-edge clip over each part's rows
        with PROFILER.scope("rigid.narrowphase"):
            for w in W:
                w.narrow = _plain_rows(w) if plain_rows else \
                    narrow(*w.nargs, nbx=nbx, layout=layout)
        for p, w in zip(parts, W):
            _contacts(p, w)
        dga, dgb = degrees(W, [w.valid.sum(-1).to(f32) for w in W])
        for i, w in enumerate(W):
            row = (w.im_a[..., None], w.im_b[..., None], w.ii_a[..., None],
                   w.ii_b[..., None])
            degs = (dga[i][..., None], dgb[i][..., None])
            va_c = w.valid.to(f32)
            w.eff_n = eff(*row, w.ra_xn, w.rb_xn, *degs) * va_c
            w.eff_t = eff(*row, w.ra_xt, w.rb_xt, *degs) * va_c

        # ---- velocity solve (staged projected Jacobi over class passes;
        # a (dy = 1) pass first refreshes the bands' halo rows) ----
        U = [w.u for w in W]
        for p, w in zip(parts, W):
            w.ln = torch.zeros((p.own, R, C), dtype=f32, device=p.dev)
            w.lt = torch.zeros((p.own, R, C), dtype=f32, device=p.dev)
        if rc.warm_start:
            # pre-apply cached impulses on approaching contacts
            # (solver.py:229-238 semantics), class-sequential
            for cls in classes:
                sl = cls["sl"]
                if banded and cls["dy"]:
                    refresh(U)
                dl = []
                for p, w, u in zip(parts, W, U):
                    vn0, _ = class_rel_vel(p, w, u, cls)
                    ok = w.valid[:, sl] & (vn0 <= 0.0)
                    dl.append((torch.where(ok, w.ln0[:, sl], 0.0),
                               torch.where(ok, w.lt0[:, sl], 0.0)))
                U = class_apply(W, U, cls, [vel_incr(w, cls, *d)
                                            for w, d in zip(W, dl)])
                for w, (ln_s, lt_s) in zip(W, dl):
                    w.ln[:, sl] = ln_s
                    w.lt[:, sl] = lt_s

        for _ in range(rc.solver.iterations):
            for cls in classes:
                sl = cls["sl"]
                if banded and cls["dy"]:
                    refresh(U)
                dl = []
                for p, w, u in zip(parts, W, U):
                    vn, vt = class_rel_vel(p, w, u, cls)
                    lns, lts, vs = w.ln[:, sl], w.lt[:, sl], w.valid[:, sl]
                    d = -w.eff_n[:, sl] * vn * relax
                    new_ln = torch.clamp(lns + d, min=0.0)
                    dln = torch.where(vs, new_ln - lns, 0.0)
                    lim = mu * new_ln
                    vt = vt + dln * w.ctn[:, sl]
                    new_lt = torch.clamp(lts - w.eff_t[:, sl] * vt * relax,
                                         -lim, lim)
                    dlt = torch.where(vs, new_lt - lts, 0.0)
                    dl.append((dln, dlt, new_ln, new_lt))
                U = class_apply(W, U, cls, [vel_incr(w, cls, *d[:2])
                                            for w, d in zip(W, dl)])
                for w, (_, _, new_ln, new_lt) in zip(W, dl):
                    vs = w.valid[:, sl]
                    w.ln[:, sl] = torch.where(vs, new_ln, w.ln[:, sl])
                    w.lt[:, sl] = torch.where(vs, new_lt, w.lt[:, sl])

        # ---- position solve (Baumgarte, lever arms track; solver.py) ----
        Q = [torch.cat([w.pos, w.ang[..., None]], dim=-1) for w in W]
        for w in W:
            w.act = w.valid & ((w.pens - rc.position.slop) > 0.0)
            w.corr = rc.position.baumgarte * (w.pens - rc.position.slop)
        dga_p, dgb_p = degrees(W, [w.act.sum(-1).to(f32) for w in W])
        big_q = [torch.cat([w.big["pos"], w.big["angle"][:, None]], dim=-1)
                 if NBIG else None for w in W]

        for _ in range(rc.position.iterations):
            for cls in classes:
                sl = cls["sl"]
                if banded and cls["dy"]:
                    refresh(Q)
                inc = []
                for i, (p, w, q) in enumerate(zip(parts, W, Q)):
                    ka, kb = w.ka[:, sl], w.kb[:, sl]
                    qa = _sel(p.own_cells(q), ka)
                    qb = partner(p, q, cls, kb, big_q[i])
                    ra_ = w.pts[:, sl] - qa[..., None, :2]
                    rb_ = w.pts[:, sl] - qb[..., None, :2]
                    rxa = _cross2(ra_, w.nh[:, sl, None, :])
                    rxb = _cross2(rb_, w.nh[:, sl, None, :])
                    ga, gb = dga_p[i][:, sl, None], dgb_p[i][:, sl, None]
                    den = (w.im_a[:, sl, None] * ga
                           + w.im_b[:, sl, None] * gb
                           + rxa * rxa * w.ii_a[:, sl, None] * ga
                           + rxb * rxb * w.ii_b[:, sl, None] * gb)
                    scl = torch.where(w.act[:, sl] & (den > 1e-12),
                                      w.corr[:, sl]
                                      / torch.clamp(den, min=1e-12), 0.0)
                    d = w.nh[:, sl, None, :] * scl[..., None]
                    dqa = torch.cat(
                        [-d.sum(2) * w.im_a[:, sl, None],
                         -((rxa * scl).sum(2) * w.ii_a[:, sl])[..., None]],
                        dim=-1)
                    dqb = None if cls["kind"] == "big" else torch.cat(
                        [d.sum(2) * w.im_b[:, sl, None],
                         ((rxb * scl).sum(2) * w.ii_b[:, sl])[..., None]],
                        dim=-1)
                    inc.append((dqa, dqb))
                Q = class_apply(W, Q, cls, inc)

        # ---- gather back to body arrays, in cell order on the lead ----
        flat = grids[0]
        U, Q = gather(U), gather(Q)
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
        anc_p, anc_a = grids[11], grids[12]
        return state.replace(
            bodies=nb_,
            rg_flat=flat, rg_table=grids[1],
            rg_ka=grids[2], rg_kb=grids[3], rg_valid=grids[4],
            rg_verts=grids[5], rg_nverts=grids[6], rg_radius=grids[7],
            rg_iscirc=grids[8], rg_invm=grids[9], rg_invi=grids[10],
            bp_anchor_pos=put(state.bp_anchor_pos, anc_p),
            bp_anchor_ang=put(state.bp_anchor_ang, anc_a),
            rg_warm_n=gather([torch.where(w.valid, w.ln, 0.0) for w in W]),
            rg_warm_t=gather([torch.where(w.valid, w.lt, 0.0) for w in W]),
            rg_warm_pt=gather([torch.where(w.valid[..., None], w.pts, INF)
                               for w in W]),
            rg_warm_nrm=gather([w.nh for w in W]),
        )

    step.guard_reads = 0
    step.rebuilds = 0
    step.narrowphase_args = narrowphase_args
    step.mesh = mesh if banded else None
    step.bands = len(parts)
    step.halo_stats = halo_stats
    return step
