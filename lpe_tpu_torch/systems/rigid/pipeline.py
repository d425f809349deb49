"""The rigid list pipeline: broadphase -> GJK/EPA narrowphase -> contact
manifolds -> velocity and position solvers, for scenes of up to
``broadphase.dense_max_solids`` solids (and larger ones whose big solids
are not all walls).

The counterpart of ``lpe_tpu/systems/rigid/pipeline.py``
(``make_rigid_system``); every stage keeps its fixed shapes, caps and
orders:

- the broadphase is lpe_tpu's dense all-pairs AABB matrix, or above
  ``dense_max_solids`` its uniform grid over solid centres plus a dense
  block against the big solids; the candidate pairs are the first
  ``max_pairs`` set entries in row-major order (``jnp.nonzero(size=N,
  fill_value=F)``), here a cumsum rank and a scatter into N + 1 places,
  the last dropped (``_first_set``), with no host read;
- the grid broadphase sorts the cells' bodies stably; lpe_tpu's
  ``argsort(stable=False)`` leaves their order to XLA, so the two agree
  on the candidate pair sets, and on their order wherever no cell holds
  two bodies;
- with ``persist_slack_m > 0`` the displacement guard decides on the
  host whether to rebuild the pairs: one read a tick, counted in
  ``step.guard_reads`` (lpe_tpu's ``lax.cond``); with slack 0 the step
  reads back only once, on its first call: whether every solid is a
  boundary wall (no system changes the flags). The broadphase drops every
  boundary-boundary pair, so in such a scene (a fluid tank) no pair ever
  forms, and the step writes the warm-start caches lpe_tpu's step writes
  there and skips the rest, whose results it would discard: some 8,000
  launches a tick of GJK, EPA and the solvers on padding rows. lpe_tpu
  also writes ``warm_n`` there, EPA's normals of the padding pairs, which
  no step reads (a slot's cache is read only for the pair in it);
- ``.at[...].set(..., mode="drop")`` writes into a buffer one longer,
  sliced off after;
- lpe_tpu's perf-triage switch ``LPE_RIGID_ABLATE`` is not ported.

Over a ``mesh`` (``parallel.BandMesh``) of more than one device the step
is split as lpe_tpu's GSPMD splits its vmapped pairs and rows: the
``max_pairs`` candidate pairs go to the devices in contiguous runs of
whole pairs (``parallel.Runs``): the lead gathers the pairs' shapes, each
device takes its run's and runs GJK, EPA, the circle closed form and the
manifolds on them, and the normals, points, depths and masks come back
to the lead device in pair order; the solvers split each stage
segment's rows the same way (``solver.py``). The broadphase, the guard
and its one host read, the compaction, the warm-start hash and the
caches stay on the lead device: their ``[max_pairs]`` leaves are ones
lpe_tpu's ``state_shardings`` replicates. Every op of a run is per pair or per
row, and each body's impulses are summed on the lead in row order, so
the split gives the single device's bits. ``step.shards`` is the number
of pair runs (1 on one device; fewer than the mesh's size where there
are fewer pairs than devices: the first devices then take a pair each,
the lead the first) and
``step.shard_stats`` the copies and bytes the split has moved since the
step was built (``parallel.Runs``).

Tracer spans (``core/profiler.py``): ``rigid.broadphase``, ``rigid.narrowphase`` (GJK, EPA,
circle pairs, manifolds), ``rigid.compact`` (active-row compaction and
warm start), ``rigid.velocity`` and ``rigid.position``.
"""
from __future__ import annotations

import math

import torch

from ...core.config import ScenarioSystemConfig
from ...core.constants import MAX_POLY_VERTS, ShapeKind
from ...core.numerics import sqrt, true_div
from ...core.profiler import PROFILER
from ...parallel import Runs
from ...scene import SceneSpec
from ...state import SimState
from . import geometry as geo
from .solver import match_warm_impulses, solve_position, solve_velocity

INF = 1e30
# Knuth's multiplicative hash constant 2654435761 as a wrapped int32, and
# the second multiplier of lpe_tpu's warm-start hash
HASH_A, HASH_B = -1640531535, 40503


def _solid_shapes(b, S, VS=MAX_POLY_VERTS):
    """The solids' shapes; ``VS`` = the scene's max solid vertex count."""
    vmask = torch.arange(VS, device=b.pos.device)[None, :] < \
        b.nverts[:S, None]
    return dict(pos=b.pos[:S], angle=b.angle[:S],
                is_circle=b.shape_kind[:S] == int(ShapeKind.CIRCLE),
                radius=b.radius[:S], verts=b.verts[:S, :VS], vmask=vmask,
                nverts=b.nverts[:S])


def _aabbs(sh):
    """World AABBs (broadphase.cpp:164-199): (minx, miny, maxx, maxy)."""
    c = torch.cos(sh["angle"])[:, None]
    s = torch.sin(sh["angle"])[:, None]
    v = sh["verts"]
    wx = sh["pos"][:, None, 0] + v[..., 0] * c - v[..., 1] * s
    wy = sh["pos"][:, None, 1] + v[..., 0] * s + v[..., 1] * c
    m = sh["vmask"]
    big = torch.full((), INF, dtype=wx.dtype, device=wx.device)
    r = sh["radius"]
    cir = sh["is_circle"]
    px, py = sh["pos"][:, 0], sh["pos"][:, 1]
    return (torch.where(cir, px - r, torch.where(m, wx, big).amin(1)),
            torch.where(cir, py - r, torch.where(m, wy, big).amin(1)),
            torch.where(cir, px + r, torch.where(m, wx, -big).amax(1)),
            torch.where(cir, py + r, torch.where(m, wy, -big).amax(1)))


def _gather_shape(sh, idx, keys=None):
    return {k: sh[k][idx] for k in (keys or sh)}


def _first_set(mask, n, fill):
    """``jnp.nonzero(mask, size=n, fill_value=fill)`` of a 1-D mask: the
    indices of its first ``n`` set entries in order, then ``fill``
    (int64 [n])."""
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    keep = mask & (rank < n)
    out = torch.full((n + 1,), fill, dtype=torch.int64, device=mask.device)
    idx = torch.arange(mask.shape[0], device=mask.device)
    # kept entries land on distinct places; the rest on the spare place n
    out.scatter_(0, torch.where(keep, rank.long(), n),
                 torch.where(keep, idx, fill))
    return out[:n]


def warm_hash(a, b, H):
    """lpe_tpu's warm-start pair hash ``((a * -1640531535 ^ b) * 40503) &
    (H - 1)`` with int32 wrapping: computed in int64 on the low 32 bits,
    which are all that the int32 result's masked bits depend on."""
    lo = 0xFFFFFFFF
    x = ((a.long() * HASH_A) & lo) ^ (b.long() & lo)
    return ((x * HASH_B) & (H - 1)).to(torch.int32)


def _pair_contacts(sa, sb, normal, pen, max_contacts):
    """Contact generation of each row (narrowphase.cpp:352-420): one
    contact for a pair with a circle (on B's surface when B is a circle,
    else on A's), the reference-face clip for two polygons. Returns
    (points [N, C, 2], penetrations [N, C], valid [N, C])."""
    pts, pens, valid = geo.polygon_contacts(sa, sb, normal, max_contacts)
    if "is_circle" not in sa:
        return pts, pens, valid
    a_cir, b_cir = sa["is_circle"], sb["is_circle"]
    pt_bc = sb["pos"] - normal * sb["radius"][:, None]
    pt_ac = sa["pos"] + normal * sa["radius"][:, None]
    single = torch.where(b_cir[:, None], pt_bc, pt_ac)
    anyc = a_cir | b_cir
    pts_sc = torch.zeros_like(pts)
    pts_sc[:, 0] = single
    pen_sc = torch.zeros_like(pens)
    pen_sc[:, 0] = pen
    val_sc = torch.zeros_like(valid)
    val_sc[:, 0] = True
    return (torch.where(anyc[:, None, None], pts_sc, pts),
            torch.where(anyc[:, None], pen_sc, pens),
            torch.where(anyc[:, None], val_sc, valid))


def make_rigid_system(spec: SceneSpec, cfg: ScenarioSystemConfig, *,
                      device="cuda", mesh=None):
    """The list pipeline's step; over a ``mesh`` of more than one device
    (whose first device is ``device``) the narrowphase and the solvers'
    row math run in contiguous runs over its devices (module
    docstring)."""
    S = spec.n_solid
    rc = cfg.rigid
    bp = rc.broadphase
    MAX_PAIRS = min(bp.max_pairs, max(1, S * (S - 1) // 2))
    C = rc.max_contacts_per_pair
    size = cfg.shared.universe_size_m
    buf = bp.boundary_buffer
    use_grid_bp = S > bp.dense_max_solids
    slack = float(bp.persist_slack_m)
    VS = spec.max_solid_verts
    ROWS = MAX_PAIRS * C
    ACT = min(rc.max_active_contacts or 2 * MAX_PAIRS, ROWS)
    H = 1 << max(4, (8 * MAX_PAIRS - 1).bit_length())
    dev = torch.device(device)
    i32 = torch.int32
    iota_s = torch.arange(S, device=dev)
    iota_p = torch.arange(MAX_PAIRS, dtype=i32, device=dev)
    # a row's contact index: only each pair's two deepest go to the solve
    row_c = torch.arange(C, device=dev).repeat(MAX_PAIRS)
    # without circle solids the narrowphase leaves its circle branches out
    # (lpe_tpu computes them and selects them nowhere)
    narrow_keys = ("pos", "angle", "verts", "vmask", "nverts") + \
        (("is_circle", "radius") if spec.any_rigid_circle else ())
    devices = list(mesh.devices) if mesh is not None and mesh.size > 1 \
        else None
    # the pairs' runs; the solvers cut their rows over the same devices
    # (Runs.over), and the copies and bytes all move are counted in
    # pair_runs.stats from the step's build on
    pair_runs = Runs(MAX_PAIRS, devices, dev)

    if use_grid_bp:
        # cells sized so that every non-big AABB (expanded by the slack)
        # fits one cell; one apron cell a side; the table at most 2^20
        Kb = bp.grid_max_per_cell
        cellb = spec.solid_cell_size + slack
        nbx = max(1, int(math.ceil(size / cellb))) + 2
        while nbx * nbx > (1 << 20):
            cellb *= 2.0
            nbx = max(1, int(math.ceil(size / cellb))) + 2
        ncells_b = nbx * nbx
        BIG = spec.solid_big_idx
        NBIG = len(BIG)
        big_ids = torch.tensor(BIG, dtype=torch.long, device=dev) \
            .reshape(NBIG)
        is_big = torch.zeros((S,), dtype=torch.bool, device=dev)
        is_big[big_ids] = True

    def _grid_broadphase(b, minx, miny, maxx, maxy, filt):
        """Candidate pairs through a uniform grid over solid centres (the
        forward half-stencil: same cell, E, SW, S, SE), plus a dense block
        against the big solids; exact for AABB overlap up to the per-cell
        cap Kb."""
        gx = torch.clamp(torch.floor(true_div(b.pos[:S, 0], cellb))
                         .to(i32) + 1, 0, nbx - 1)
        gy = torch.clamp(torch.floor(true_div(b.pos[:S, 1], cellb))
                         .to(i32) + 1, 0, nbx - 1)
        cid = torch.where(is_big, ncells_b, gy * nbx + gx).to(i32)
        order = torch.argsort(cid, stable=True)
        counts = torch.zeros((ncells_b + 1,), dtype=i32, device=dev) \
            .index_add_(0, cid.long(), torch.ones_like(cid))
        start = torch.cat([torch.zeros((1,), dtype=i32, device=dev),
                           torch.cumsum(counts[:-1], 0, dtype=i32)])
        sc = cid[order]
        rank_sorted = (iota_s - start[sc.long()]).to(i32)
        tvalid = (sc < ncells_b) & (rank_sorted < Kb)
        # one extra all-empty cell row for out-of-grid neighbours, and one
        # spare place past it for the dropped scatters
        slot = torch.where(tvalid, sc * Kb + rank_sorted,
                           (ncells_b + 1) * Kb).long()
        table = torch.full(((ncells_b + 1) * Kb + 1,), S, dtype=i32,
                           device=dev)
        table[slot] = order.to(i32)
        table = table[:(ncells_b + 1) * Kb]
        my_rank = torch.empty((S,), dtype=i32, device=dev)
        my_rank[order] = rank_sorted

        kb = torch.arange(Kb, device=dev)
        cands, cmask = [], []
        for dx, dy in ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1)):
            jx, jy = gx + dx, gy + dy
            ok = (jx >= 0) & (jx < nbx) & (jy >= 0) & (jy < nbx) & ~is_big
            ncid = torch.where(ok, jy * nbx + jx, ncells_b).long()
            rows = table[ncid[:, None] * Kb + kb[None, :]]      # [S, Kb]
            valid = rows < S
            if (dx, dy) == (0, 0):
                # rank-ordered rows: "rank_j > rank_i" dedups a cell
                valid = valid & (kb[None, :] > my_rank[:, None])
            cands.append(rows)
            cmask.append(valid)
        if NBIG:
            rows = big_ids[None, :].expand(S, NBIG).to(i32)
            i_idx = iota_s[:, None]
            # big-big pairs once (i < j); big-small always from small i
            valid = torch.where(is_big[:, None], i_idx < rows,
                                i_idx != rows)
            cands.append(rows)
            cmask.append(valid)
        cand = torch.cat(cands, dim=1)                          # [S, W]
        valid = torch.cat(cmask, dim=1)
        W = cand.shape[1]
        packed = torch.stack([minx, miny, maxx, maxy, filt.to(minx.dtype)],
                             dim=1)
        pj = packed[torch.clamp(cand, 0, S - 1).long()]         # [S, W, 5]
        ox = (minx[:, None] <= pj[..., 2]) & (pj[..., 0] <= maxx[:, None])
        oy = (miny[:, None] <= pj[..., 3]) & (pj[..., 1] <= maxy[:, None])
        # filt bit 0: boundary, bit 1: small, bit 2: in_root
        fj = pj[..., 4].to(i32)
        fi = filt[:, None]
        both_bnd = ((fi & 1) & (fj & 1)) > 0
        both_small = (((fi >> 1) & 1) & ((fj >> 1) & 1)) > 0
        in_both = (((fi >> 2) & 1) & ((fj >> 2) & 1)) > 0
        m = valid & ox & oy & ~both_bnd & ~both_small & in_both
        flat = _first_set(m.reshape(-1), MAX_PAIRS, S * W)
        pvalid = flat < S * W
        flat = torch.where(pvalid, flat, 0)
        i0 = flat // W
        j0 = cand.reshape(-1)[flat].long()
        ia = torch.where(pvalid, torch.minimum(i0, j0), 0)
        ib = torch.where(pvalid, torch.maximum(i0, j0), 0)
        return ia, ib, pvalid

    def _broadphase(b, sh):
        """One candidate-pair build: AABBs (expanded by slack/2 under
        persistence) -> filters -> grid or dense compaction."""
        minx, miny, maxx, maxy = _aabbs(sh)
        bnd = b.boundary[:S]
        # filters from the unexpanded boxes
        ext = torch.maximum(maxx - minx, maxy - miny)
        small = ext < bp.small_particle_threshold
        in_root = (maxx >= -buf) & (minx <= size + buf) & \
                  (maxy >= -buf) & (miny <= size + buf)
        if slack > 0:
            e = slack * 0.5
            minx, miny, maxx, maxy = minx - e, miny - e, maxx + e, maxy + e
        if use_grid_bp:
            filt = (bnd.to(i32) | (small.to(i32) << 1)
                    | (in_root.to(i32) << 2))
            return _grid_broadphase(b, minx, miny, maxx, maxy, filt)
        ox = (minx[:, None] <= maxx[None, :]) & \
             (minx[None, :] <= maxx[:, None])
        oy = (miny[:, None] <= maxy[None, :]) & \
             (miny[None, :] <= maxy[:, None])
        iu = iota_s[:, None] < iota_s[None, :]
        both_bnd = bnd[:, None] & bnd[None, :]
        both_small = small[:, None] & small[None, :]
        in_both = in_root[:, None] & in_root[None, :]
        m = ox & oy & iu & ~both_bnd & ~both_small & in_both
        flat = _first_set(m.reshape(-1), MAX_PAIRS, S * S)
        pvalid = flat < S * S
        flat = torch.where(pvalid, flat, 0)
        return flat // S, flat % S, pvalid

    def _guarded_pairs(state, b, sh):
        """The displacement guard (pipeline.py:259-286): rebuild the pairs
        when a solid's worst-case surface motion since the anchor pose
        exceeds slack/2; +inf anchors (a fresh state) always rebuild.
        Returns (ia or -1, ib or -1, anchor pos, anchor angle) as int32 /
        float tensors to store."""
        vv = sh["verts"]
        rad = sqrt(vv[..., 0] * vv[..., 0] + vv[..., 1] * vv[..., 1])
        # max(-1, initial=0, where=vmask): the radii are >= 0, so masking
        # the rest to 0 and taking the max is the same
        br = torch.where(sh["is_circle"], sh["radius"],
                         torch.where(sh["vmask"], rad, 0.0).amax(-1))
        dp = torch.abs(b.pos[:S] - state.bp_anchor_pos[:S]).amax(-1)
        da = torch.abs(b.angle[:S] - state.bp_anchor_ang[:S])
        need = ~((dp + da * br).amax() <= slack * 0.5)
        step.guard_reads += 1
        if bool(need):                     # the tick's one host read
            step.rebuilds += 1
            ia, ib, pv = _broadphase(b, sh)
            return (torch.where(pv, ia, -1).to(i32),
                    torch.where(pv, ib, -1).to(i32), b.pos[:S], b.angle[:S])
        return (state.bp_ia[:MAX_PAIRS], state.bp_ib[:MAX_PAIRS],
                state.bp_anchor_pos[:S], state.bp_anchor_ang[:S])

    def _narrowphase(sa, sb, pvalid):
        """GJK -> EPA, the closed form for circle pairs, then manifolds:
        (nrm [P, 2], pts [P, C, 2], pens [P, C], valid_r [P * C])."""
        hit, simplex = geo.gjk(sa, sb, rc.gjk_iterations)
        evalid, nrm, pen = geo.epa(sa, sb, simplex, rc.epa_iterations)
        if "is_circle" in sa:
            # circle-circle pairs: the analytic contact (exact where
            # iterative EPA is ~1e-3 accurate in float32 on smooth
            # boundaries)
            both = sa["is_circle"] & sb["is_circle"]
            dcc = sb["pos"] - sa["pos"]
            dlen = sqrt(geo._dot2(dcc, dcc))
            rsum = sa["radius"] + sb["radius"]
            touch = dlen < rsum
            hit = torch.where(both, touch, hit)
            evalid = torch.where(both, touch, evalid)
            nrm = torch.where(both[:, None], geo._circle_normal(dcc, dlen),
                              nrm)
            pen = torch.where(both, rsum - dlen, pen)
        coll = pvalid & hit & evalid
        pts, pens, cvalid = _pair_contacts(sa, sb, nrm, pen, C)
        return nrm, pts, pens, (coll[:, None] & cvalid).reshape(-1)

    def _warm(state, ia, ib, nrm, pts, avalid, rid_s):
        """Cached impulses matched by pair identity, then by contact point
        (pipeline.py:370-414): the slot's own pair first, else the hash
        table's slot for the pair (a collision can only cold-start)."""
        pia = state.warm_ia[:MAX_PAIRS]
        pib = state.warm_ib[:MAX_PAIRS]
        tbl = torch.full((H,), -1, dtype=i32, device=dev)
        tbl = tbl.scatter_reduce(0, warm_hash(pia, pib, H).long(),
                                 torch.where(pia >= 0, iota_p, -1), "amax")
        hslot = tbl[warm_hash(ia, ib, H).long()]
        in_slot = (pia == ia) & (pib == ib)
        slot = torch.where(in_slot, iota_p, hslot)
        sc_ = torch.clamp(slot, min=0).long()
        same = in_slot | ((slot >= 0) & (pia[sc_] == ia) & (pib[sc_] == ib))
        nh = geo._unit(nrm)
        ln0_m, lt0_m = match_warm_impulses(
            pts, nh, state.warm_pt[:MAX_PAIRS][sc_],
            state.warm_n[:MAX_PAIRS][sc_],
            state.warm_normal[:MAX_PAIRS][sc_],
            state.warm_tangent[:MAX_PAIRS][sc_], same,
            tol=rc.warm_position_tolerance,
            slot_fallback=rc.warm_slot_fallback)
        ln0 = torch.where(avalid, ln0_m.reshape(-1)[rid_s], 0.0)
        lt0 = torch.where(avalid, lt0_m.reshape(-1)[rid_s], 0.0)
        return ln0, lt0, nh

    def _put(field, n, new):
        """``field.at[:n].set(new)``, out of place."""
        return torch.cat([new.to(field.dtype), field[n:]], dim=0)

    def _no_pairs(state):
        """The step of a scene whose solids are all walls: empty caches."""
        if not rc.warm_start:
            return state
        return state.replace(
            warm_normal=_put(state.warm_normal, MAX_PAIRS,
                             torch.zeros_like(state.warm_normal[:MAX_PAIRS])),
            warm_tangent=_put(state.warm_tangent, MAX_PAIRS, torch.zeros_like(
                state.warm_tangent[:MAX_PAIRS])),
            warm_ia=_put(state.warm_ia, MAX_PAIRS,
                         torch.full_like(iota_p, -1)),
            warm_ib=_put(state.warm_ib, MAX_PAIRS,
                         torch.full_like(iota_p, -1)),
            warm_pt=_put(state.warm_pt, MAX_PAIRS, torch.full_like(
                state.warm_pt[:MAX_PAIRS], INF)))

    walls_only = []

    def step(state: SimState) -> SimState:
        b = state.bodies
        if not walls_only:                 # the first call's one host read
            walls_only.append(bool(b.boundary[:S].all()))
        if walls_only[0] and slack == 0:
            return _no_pairs(state)
        sh = _solid_shapes(b, S, VS)
        with PROFILER.scope("rigid.broadphase"):
            if slack > 0:
                ia_c8, ib_c8, anc_p, anc_a = _guarded_pairs(state, b, sh)
                pvalid = ia_c8 >= 0
                ia = torch.clamp(ia_c8, min=0).long()
                ib = torch.clamp(ib_c8, min=0).long()
            else:
                ia, ib, pvalid = _broadphase(b, sh)
        ia32, ib32 = ia.to(i32), ib.to(i32)

        with PROFILER.scope("rigid.narrowphase"):
            sa = _gather_shape(sh, ia, narrow_keys)
            sb = _gather_shape(sh, ib, narrow_keys)
            # each run of pairs on its device, back in pair order
            outs = [_narrowphase(*a) for a in zip(
                pair_runs.cut_dict(sa), pair_runs.cut_dict(sb),
                pair_runs.cut(pvalid))]
            nrm, pts, pens, valid_r = (pair_runs.join(list(x))
                                       for x in zip(*outs))

        with PROFILER.scope("rigid.compact"):
            # the active rows: each pair's two deepest contacts (manifolds
            # come deepest first), compacted to ACT rows
            rid = _first_set(valid_r & (row_c < 2), ACT, ROWS)
            avalid = rid < ROWS
            rid_s = torch.where(avalid, rid, 0)
            pair_s = rid_s // C
            ia_c, ib_c = ia[pair_s], ib[pair_s]
            n_c = nrm[pair_s]
            pt_c = pts.reshape(-1, 2)[rid_s]
            pen_c = pens.reshape(-1)[rid_s]
            mass = b.mass[:S]
            inertia = b.inertia[:S]
            inv_m = torch.where(mass > 1e29, 0.0,
                                true_div(1.0, torch.clamp(mass, min=1e-30)))
            inv_i = torch.where((inertia > 1e-12) & (inertia < 1e29),
                                true_div(1.0, torch.clamp(inertia,
                                                          min=1e-30)), 0.0)
            if rc.warm_start:
                if state.warm_normal.shape[0] < MAX_PAIRS or \
                        state.warm_normal.shape[1] != C:
                    raise ValueError(
                        f"warm-start cache {tuple(state.warm_normal.shape)}"
                        f" does not fit (max_pairs={MAX_PAIRS}, "
                        f"max_contacts={C}); the state was built with a "
                        "different RigidBodyConfig: rebuild the scene with "
                        "the same config or set warm_start=False")
                ln0, lt0, nh = _warm(state, ia32, ib32, nrm, pts, avalid,
                                     rid_s)
            else:
                ln0 = torch.zeros_like(pen_c)
                lt0 = torch.zeros_like(pen_c)

        with PROFILER.scope("rigid.velocity"):
            vel, omega, ln_c, lt_c = solve_velocity(
                b.pos[:S], b.vel[:S], b.omega[:S], inv_m, inv_i,
                ia_c, ib_c, n_c, pt_c, avalid, ln0, lt0, rc.solver,
                pair_runs)
        with PROFILER.scope("rigid.position"):
            pos, angle = solve_position(
                b.pos[:S], b.angle[:S], inv_m, inv_i,
                ia_c, ib_c, n_c, pt_c, pen_c, avalid, rc.position,
                pair_runs)

        nb = b.replace(pos=_put(b.pos, S, pos), vel=_put(b.vel, S, vel),
                       angle=_put(b.angle, S, angle),
                       omega=_put(b.omega, S, omega))
        st = state.replace(bodies=nb)
        if slack > 0:
            # anchors are the pre-solve poses; the next tick's guard
            # measures the post-solve poses against them
            st = st.replace(
                bp_ia=_put(state.bp_ia, MAX_PAIRS, ia_c8),
                bp_ib=_put(state.bp_ib, MAX_PAIRS, ib_c8),
                bp_anchor_pos=_put(state.bp_anchor_pos, S, anc_p),
                bp_anchor_ang=_put(state.bp_anchor_ang, S, anc_a))
        if rc.warm_start:
            # the compacted impulses back to their capacity rows
            ridx = torch.where(avalid, rid, ROWS)
            ln = torch.zeros((ROWS + 1,), dtype=ln_c.dtype, device=dev) \
                .scatter(0, ridx, ln_c)[:ROWS]
            lt = torch.zeros((ROWS + 1,), dtype=lt_c.dtype, device=dev) \
                .scatter(0, ridx, lt_c)[:ROWS]
            vr = valid_r.reshape(MAX_PAIRS, C)
            st = st.replace(
                warm_normal=_put(state.warm_normal, MAX_PAIRS,
                                 ln.reshape(MAX_PAIRS, C)),
                warm_tangent=_put(state.warm_tangent, MAX_PAIRS,
                                  lt.reshape(MAX_PAIRS, C)),
                warm_ia=_put(state.warm_ia, MAX_PAIRS,
                             torch.where(pvalid, ia32, -1)),
                warm_ib=_put(state.warm_ib, MAX_PAIRS,
                             torch.where(pvalid, ib32, -1)),
                # a far sentinel on invalid rows: they can never match
                warm_pt=_put(state.warm_pt, MAX_PAIRS,
                             torch.where(vr[..., None], pts, INF)),
                warm_n=_put(state.warm_n, MAX_PAIRS, nh))
        return st

    step.guard_reads = 0
    step.rebuilds = 0
    step.mesh = mesh if devices is not None else None
    step.shards = len(pair_runs)
    step.shard_stats = pair_runs.stats
    return step
