"""The grid-rigid narrowphase kernels, with their plain PyTorch versions.

Both replace ``lpe_tpu/ops/pallas_rigid.py`` ``make_narrowphase`` and keep
its contract: rows of two polygon shapes in, ``(hit [N], nrm [N, 2],
pen [N], pts [N, 2, 2], pens [N, 2], cval [N, 2])`` out, where ``cval`` is
already ANDed with ``hit`` (the TPU kernel's ``oka``/``okb``). The plain
version of a row is the vmapped XLA pair it stands in for:
``geometry.sat_contact`` then ``pipeline._pair_contacts`` with C = 2.

- ``narrowphase`` takes the rows' shapes as gathered tensors: the CUDA
  kernel ``csrc/narrowphase.cu``, plain version ``narrowphase_plain``.
- ``narrowphase_grid``, the rigid tick's, takes the body grids and the
  rows' slots and reads the shapes by slot itself: the CUDA kernel
  ``csrc/narrowphase_grid.cu``, plain version ``narrowphase_grid_plain``
  (``grid_rows``'s gathers, then ``narrowphase_plain``). It also returns
  the rows' side-A and side-B positions, which the solvers read. It takes
  the whole grid or a y-row band of it (``grid_band``: the band's rows and
  the row below them, the multi-device rigid pipeline's), with the
  partner row wrapped over the rows its grids hold.

Each launches its kernel (built by ``_build.py``) for CUDA tensors and
runs its plain version for CPU tensors; any other device raises, and a
CUDA input the kernel does not take raises too. ``op.launches`` and
``op.plain_calls`` count the two; ``reset_counters()`` zeroes them.
"""
from __future__ import annotations

import torch

from ..systems.rigid import geometry as geo
from ..systems.rigid.pipeline import _pair_contacts
from .sph_kernels import KernelOp, _check

V_MIN, V_MAX = 3, 16      # the vertex counts the kernels instantiate
SMEM_MAX = 232448         # shared memory a block may have on Hopper


def _shape(pos, angle, verts, nverts):
    V = verts.shape[1]
    vmask = torch.arange(V, device=verts.device)[None, :] < nverts[:, None]
    return dict(pos=pos, angle=angle, verts=verts, nverts=nverts,
                vmask=vmask)


def narrowphase_plain(a_pos, a_angle, a_verts, a_nverts,
                      b_pos, b_angle, b_verts, b_nverts):
    """Poly-poly SAT + incident-edge clip of each row: pos [N, 2], angle
    [N], verts [N, V, 2] (local), nverts [N] int32 per side."""
    sa = _shape(a_pos, a_angle, a_verts, a_nverts)
    sb = _shape(b_pos, b_angle, b_verts, b_nverts)
    hit, nrm, pen = geo.sat_contact(sa, sb, any_circle=False)
    pts, pens, cval = _pair_contacts(sa, sb, nrm, pen, 2)
    return hit, nrm, pen, pts, pens, cval & hit[:, None]


def _check_v(what, V):
    if not (V_MIN <= V <= V_MAX):
        raise ValueError(f"{what}: V={V} vertices per ring; the kernel "
                         f"takes {V_MIN} to {V_MAX}")


def _narrowphase_cuda(a_pos, a_angle, a_verts, a_nverts,
                      b_pos, b_angle, b_verts, b_nverts):
    from . import _build
    N, V = a_verts.shape[0], a_verts.shape[1]
    _check_v("narrowphase", V)
    for side, (pos, ang, verts, nv) in (
            ("a", (a_pos, a_angle, a_verts, a_nverts)),
            ("b", (b_pos, b_angle, b_verts, b_nverts))):
        _check(f"narrowphase {side}_pos", pos, (N, 2))
        _check(f"narrowphase {side}_angle", ang, (N,))
        _check(f"narrowphase {side}_verts", verts, (N, V, 2))
        _check(f"narrowphase {side}_nverts", nv, (N,), torch.int32)
    # cos and sin exactly as the plain version (geometry.world_verts)
    # takes them
    ca, sa_ = torch.cos(a_angle), torch.sin(a_angle)
    cb, sb_ = torch.cos(b_angle), torch.sin(b_angle)
    outs = _row_outputs(N, a_pos.device)
    _build.call("lpe_narrowphase", a_pos, ca, sa_, a_verts, a_nverts,
                b_pos, cb, sb_, b_verts, b_nverts, *outs,
                _build.NarrowParams(N, V))
    return outs


def _row_outputs(N, dev):
    """Empty (hit, nrm, pen, pts, pens, cval) for N rows."""
    f32 = torch.float32
    return (torch.empty((N,), dtype=torch.bool, device=dev),
            torch.empty((N, 2), dtype=f32, device=dev),
            torch.empty((N,), dtype=f32, device=dev),
            torch.empty((N, 2, 2), dtype=f32, device=dev),
            torch.empty((N, 2), dtype=f32, device=dev),
            torch.empty((N, 2), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# the grid form: rows named by slot in per-cell body grids
# ---------------------------------------------------------------------------

def grid_gather(grids, bigs, ka, kb, *, nbx, layout):
    """Fields of each candidate row's two bodies, gathered from the body
    grids by slot: (the fields of side A, the same of side B), each
    [NR * R, ...], the rows of cell c at c * R .. c * R + R - 1. ``grids``
    are fields [NC, KB, ...] of the bodies in their cells' slots, NC = ny
    * nbx cells in row-major (y, x) order; ``bigs`` the same fields
    [NBIG, ...] of the big bodies. ka, kb [NR, R] int32, NR = rows * nbx:
    the rows of the grids' first ``rows`` cell rows, a row's slot on side A
    (its own cell) and on side B. ``layout`` gives the row classes in row
    order as (rows, dx, dy, big): side B of a row of class (dx, dy) lies in
    cell ((cy + dy) mod ny, (cx + dx) mod nbx), of a big class (``big``
    true) in the big bodies, at index kb. The whole grid has ny = rows =
    nbx; a y-row band (``grid_band``) its own rows and the row below them,
    ny = rows + 1."""
    NC, KB = grids[0].shape[:2]
    ny = NC // nbx
    NR = ka.shape[0]
    dev = ka.device
    cell = torch.arange(NR, device=dev)
    cy, cx = cell // nbx, cell % nbx
    base = []
    for rows, dx, dy, big in layout:
        b = torch.full_like(cell, NC * KB) if big else \
            ((cy + dy) % ny * nbx + (cx + dx) % nbx) * KB
        base.append(b[:, None].expand(NR, rows))
    ia = (cell[:, None] * KB + ka.long()).reshape(-1)
    ib = (torch.cat(base, dim=1) + kb.long()).reshape(-1)
    side_a, side_b = [], []
    for g, bg in zip(grids, bigs):
        flat = g.reshape((NC * KB,) + g.shape[2:])
        side_a.append(flat[ia])
        side_b.append(torch.cat([flat, bg])[ib])
    return tuple(side_a), tuple(side_b)


def band_cells(nbx, r0, rows, device):
    """The cells a y-row band of the nbx x nbx grid holds, in its order:
    its own rows [r0, r0 + rows), then the row below them, (r0 + rows) mod
    nbx (int64 [(rows + 1) * nbx])."""
    h = (r0 + rows) % nbx
    return torch.cat([torch.arange(r0 * nbx, (r0 + rows) * nbx,
                                   device=device),
                      torch.arange(h * nbx, (h + 1) * nbx, device=device)])


def grid_band(nargs, *, nbx, r0, rows):
    """The arguments of ``narrowphase_grid`` (the whole grid's ``nargs``:
    grids [NC, KB, ...], big bodies, ka, kb [NC, R]) for the y-row band of
    cell rows [r0, r0 + rows): its grids with the row below it
    (``band_cells``), the big bodies, the band's rows of ka and kb. Its
    outputs are the whole grid's rows of those cells."""
    cells = band_cells(nbx, r0, rows, nargs[0].device)
    own = slice(r0 * nbx, (r0 + rows) * nbx)
    return (*(g.index_select(0, cells) for g in nargs[:4]), *nargs[4:8],
            nargs[8][own], nargs[9][own])


def grid_rows(g_pos, g_ang, g_verts, g_nverts, big_pos, big_ang, big_verts,
              big_nverts, ka, kb, *, nbx, layout):
    """The two shapes of each candidate row, gathered from the body grids
    by slot (``grid_gather``): ((pos, angle, verts, nverts) of side A, the
    same of side B). g_pos [NC, KB, 2], g_ang [NC, KB], g_verts [NC, KB,
    V, 2] (local), g_nverts [NC, KB] int32 (NC = ny * nbx); big_* the same
    of the NBIG big bodies; ka, kb [rows * nbx, R]."""
    return grid_gather((g_pos, g_ang, g_verts, g_nverts),
                       (big_pos, big_ang, big_verts, big_nverts), ka, kb,
                       nbx=nbx, layout=layout)


def narrowphase_grid_plain(g_pos, g_ang, g_verts, g_nverts, big_pos,
                           big_ang, big_verts, big_nverts, ka, kb, *, nbx,
                           layout):
    """``narrowphase_plain`` on the rows of ``grid_rows`` (same arguments):
    (hit, nrm, pen, pts, pens, cval, pos_a [NR * R, 2], pos_b [NR * R,
    2]), NR = ka.shape[0]."""
    a, b = grid_rows(g_pos, g_ang, g_verts, g_nverts, big_pos, big_ang,
                     big_verts, big_nverts, ka, kb, nbx=nbx, layout=layout)
    return (*narrowphase_plain(*a, *b), a[0], b[0])


def grid_passes(KB, NBIG, V, layout):
    """Split the row classes into passes of csrc/narrowphase_grid.cu whose
    staged bodies fit a block's shared memory: the own cell's KB, plus per
    class its partner's (KB for a neighbour cell, NBIG for the big class,
    none for the same cell). Returns (one past each pass's last class, the
    staged bodies of the largest pass)."""
    most = SMEM_MAX // (16 * V + 24)        # bytes a staged body takes
    ends, n, nsb = [], KB, KB
    for c, (_, dx, dy, big) in enumerate(layout):
        need = NBIG if big else (0 if dx == dy == 0 else KB)
        if n + need > most and n > KB:
            ends.append(c)
            n = KB
        if n + need > most:
            raise ValueError(f"narrowphase_grid: {KB} + {need} staged "
                             f"bodies of {V} vertices exceed a block's "
                             "shared memory")
        n += need
        nsb = max(nsb, n)
    return ends + [len(layout)], nsb


def _narrowphase_grid_cuda(g_pos, g_ang, g_verts, g_nverts, big_pos,
                           big_ang, big_verts, big_nverts, ka, kb, *, nbx,
                           layout):
    from . import _build
    NC, KB, V = g_verts.shape[:3]
    NBIG, (NR, R) = big_ang.shape[0], ka.shape
    ny, rows = NC // nbx, NR // nbx
    _check_v("narrowphase_grid", V)
    if ny * nbx != NC or rows * nbx != NR or not 1 <= rows <= ny:
        raise ValueError(f"narrowphase_grid: grids of {NC} cells and rows "
                         f"of {NR} are not whole rows of {nbx} cells, the "
                         "rows' cells among the grids'")
    if sum(c[0] for c in layout) != R or \
            not 1 <= len(layout) <= _build.NG_MAX_CLS:
        raise ValueError(f"narrowphase_grid: layout {layout} does not "
                         f"give {R} rows to each cell")
    for name, t, shape, dtype in (
            ("g_pos", g_pos, (NC, KB, 2), torch.float32),
            ("g_ang", g_ang, (NC, KB), torch.float32),
            ("g_verts", g_verts, (NC, KB, V, 2), torch.float32),
            ("g_nverts", g_nverts, (NC, KB), torch.int32),
            ("big_pos", big_pos, (NBIG, 2), torch.float32),
            ("big_ang", big_ang, (NBIG,), torch.float32),
            ("big_verts", big_verts, (NBIG, V, 2), torch.float32),
            ("big_nverts", big_nverts, (NBIG,), torch.int32),
            ("ka", ka, (NR, R), torch.int32),
            ("kb", kb, (NR, R), torch.int32)):
        _check(f"narrowphase_grid {name}", t, shape, dtype)
    # cos and sin exactly as the plain version (geometry.world_verts)
    # takes them, once a body
    ang = torch.cat([g_ang.reshape(-1), big_ang])
    cs, sn = torch.cos(ang), torch.sin(ang)
    outs = _row_outputs(NR * R, g_pos.device)
    pos_a = torch.empty((NR * R, 2), dtype=torch.float32,
                        device=g_pos.device)
    pos_b = torch.empty_like(pos_a)
    ends, nsb = grid_passes(KB, NBIG, V, layout)
    P = _build.NarrowGridParams(NC, KB, R, NBIG, nbx, V, len(layout),
                                len(ends), ny, rows, nsb)
    end = 0
    for c, (rows, dx, dy, big) in enumerate(layout):
        end += rows
        P.cls_end[c], P.cls_dx[c], P.cls_dy[c] = end, dx, dy
        P.cls_big[c] = int(bool(big))
    for q, e in enumerate(ends):
        P.pass_end[q] = e
    _build.call("lpe_narrowphase_grid", g_pos, cs, sn, g_verts, g_nverts,
                big_pos, cs[NC * KB:], sn[NC * KB:], big_verts, big_nverts,
                ka, kb, *outs, pos_a, pos_b, P)
    return (*outs, pos_a, pos_b)


narrowphase = KernelOp("narrowphase", narrowphase_plain, _narrowphase_cuda)
narrowphase_grid = KernelOp("narrowphase_grid", narrowphase_grid_plain,
                            _narrowphase_grid_cuda)
OPS = (narrowphase, narrowphase_grid)


def reset_counters():
    for op in OPS:
        op.launches = 0
        op.plain_calls = 0
