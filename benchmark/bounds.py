"""The yardstick's arithmetic: one H100's published peaks and the bytes
and operations that the work of a launch needs, counted from its inputs.

Frozen copies, kept here so that a change to the program cannot move
them: the peaks and the per-unit operation counts of ``chip_smoke.py``
(``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``, ``MIGRATE_OPS``, ``PAIR_OPS``,
``CPL_OPS*``, ``GRAV_PAIR_OPS``, ``PP_PAIR_OPS``, ``CIC_OPS``), and its
byte counts of the stacked SPH chain (``slot_bytes``, ``coupling9_bytes``,
``neighbour_pairs``; ``couple_ops``). A bound is the least time the card
could take: the larger of the bytes over the HBM rate and the operations
over the fp32 rate.

The SPH grid's geometry (padded columns a multiple of 32, S candidate
slots a cell, the candidate row width) is the stacked chain's, as the
configuration runs it. The P3M counts follow the configuration's sizing
rule and count the PP pairs closer than the cutoff among the first K
bodies of each cell, found by this module's own binning, so that any
implementation of the pass is held to the same work.
"""
from __future__ import annotations

import math

import torch

# H100 SXM, NVIDIA's data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per unit of work (estimates from the kernels' arithmetic): a
# particle's kick, drift and re-bin; a pair of the 3x3 cells in the density
# and the force pass; a particle-candidate pair of the coupling (per vertex
# and fixed); a source-receiver pair of a direct sum and of the PP pass; a
# body's CIC deposit and gather
MIGRATE_OPS = 20
DENSITY_OPS, FORCE_OPS = 12, 48
PAIR_OPS = DENSITY_OPS + FORCE_OPS
CPL_OPS_PER_VERT, CPL_OPS = 25, 60
GRAV_PAIR_OPS, PP_PAIR_OPS, CIC_OPS = 15, 30, 40
F32 = 4
COL_ALIGN = 32            # padded grid columns: a multiple of one warp
BIG_BLOCK_COLS = 32       # columns a block of the coupling's big sums
RW_V0 = 13                # candidate parameters before the vertex ring


def bound_s(n_bytes: float, ops: float) -> float:
    """Seconds: the larger of the bytes' and the operations' bounds."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


# ---------------------------------------------------------------------------
# the SPH sub-step's stacked chain: migrate -> pair sweep -> coupling9
# ---------------------------------------------------------------------------

def sph_geometry(conf, size: float) -> dict:
    """Grid shape of the dam's fluid: K slots, padded rows and columns."""
    g = conf["fluid"]["grid"]
    cell = g["cell_size_factor"] * g["smoothing_length"]
    nx = int(math.ceil(size / cell)) + 4
    W = -(-(nx + 2) // COL_ALIGN) * COL_ALIGN
    return dict(cell=cell, nx=nx, ny=nx, rows=nx + 2, W=W, eps=g[
        "grid_epsilon"], K=min(g["max_per_cell"], int(conf["n_particles"])))


def cell_counts(pos, geo) -> torch.Tensor:
    """Particles a cell [ny, nx] holds (at most K, the first by index)
    on the edge-clamped grid with a two-cell apron."""
    nx, ny = geo["nx"], geo["ny"]
    gx = torch.clamp(torch.floor((pos[:, 0] + geo["eps"]) / geo["cell"])
                     .long() + 2, 0, nx - 1)
    gy = torch.clamp(torch.floor((pos[:, 1] + geo["eps"]) / geo["cell"])
                     .long() + 2, 0, ny - 1)
    n = torch.zeros(nx * ny, dtype=torch.int64, device=pos.device)
    n.index_add_(0, gy * nx + gx, torch.ones_like(gx))
    return torch.clamp(n, max=geo["K"]).view(ny, nx)


def neighbour_pairs(counts) -> float:
    """(particle, occupied slot of its 3x3 cells) pairs, self included."""
    n = counts.double()
    p = torch.nn.functional.pad(n, (1, 1, 1, 1))
    nb = sum(p[1 + dy:p.shape[0] - 1 + dy, 1 + dx:p.shape[1] - 1 + dx]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return float((n * nb).sum())


def coupled_cells(counts, geo, boxes):
    """(cells, particles) that couple: occupied cells whose extent (one
    cell around it in x and y, two above in x) meets a solid's box
    [minx, miny, maxx, maxy]."""
    ny, nx = counts.shape
    c = geo["cell"]
    gx = torch.arange(nx, device=counts.device, dtype=torch.float64)
    gy = torch.arange(ny, device=counts.device, dtype=torch.float64)
    x0, y0 = (gx - 3) * c, (gy - 3) * c
    b = boxes.to(counts.device, torch.float64)
    hx = (b[None, :, 0] <= x0[:, None] + 4 * c) & \
        (b[None, :, 2] >= x0[:, None])                      # [nx, NB]
    hy = (b[None, :, 1] <= y0[:, None] + 3 * c) & \
        (b[None, :, 3] >= y0[:, None])                      # [ny, NB]
    hit = (hy.double() @ hx.double().T) > 0
    live = (counts > 0) & hit
    return int(live.sum()), int(counts[live].sum())


def sph_launch_work(conf, size, pos, boxes, n_vert: int) -> dict:
    """(bytes, operations) of a launch of each kernel of the stacked chain
    at the cell occupancy of positions ``pos`` (a block's start): kernel
    name -> (bytes, ops). ``boxes`` [NBIG, 4] are the solids' boxes, all
    big candidates with ``n_vert`` vertices."""
    geo = sph_geometry(conf, size)
    K, W, rows = geo["K"], geo["W"], geo["rows"]
    counts = cell_counts(pos, geo)
    live = float(counts.sum())
    pairs = neighbour_pairs(counts)
    ncoupled, live_c = coupled_cells(counts, geo, boxes)
    nbig = int(boxes.shape[0])
    fl = conf["fluid"]
    S = fl.get("coupling_slots_per_cell") or 8
    Wp = -(-(RW_V0 + 2 * n_vert) // 8) * 8
    NB = -(-W // BIG_BLOCK_COLS)
    row = K * W * F32                  # one plane of one padded grid row
    grid = rows * row                  # one whole plane
    inner = (rows - 2) * row
    migrate = grid + 8 * live * F32 + 9 * grid
    sweep = grid + 5 * live * F32 + 3 * inner
    coupling9 = (rows * 7 * row + 3 * inner + rows * W * F32
                 + ncoupled * S * Wp * F32
                 + ((nbig + 1) * Wp * F32 if ncoupled else 0)
                 + 9 * grid + rows * 3 * S * W * F32
                 + rows * NB * 3 * nbig * F32)
    return {
        "migrate_kernel": (migrate, MIGRATE_OPS * live),
        "sweep_kernel": (sweep, PAIR_OPS * pairs),
        "coupling9_kernel": (coupling9, live_c * nbig
                             * (CPL_OPS_PER_VERT * n_vert + CPL_OPS)),
    }


def sph_launch_bounds(conf, size, pos, boxes, n_vert: int) -> dict:
    """Seconds a launch of each kernel of the stacked chain needs:
    ``sph_launch_work`` bounded by the peaks."""
    return {k: bound_s(*w) for k, w in sph_launch_work(
        conf, size, pos, boxes, n_vert).items()}


# ---------------------------------------------------------------------------
# P3M gravity
# ---------------------------------------------------------------------------

def pp_grid(conf, size: float, n_bodies: int):
    """(cell width, cells a side, m, K, rc) of the PP pass: cells of rc/m
    with m = 2 where the mean occupancy with 3x headroom passes 64; K that
    occupancy, at least max_per_cell / m^2, at most 128."""
    bh = conf["barnes_hut"]
    rc = bh["p3m_cutoff_cells"] * size / bh["pm_grid"]
    m = 1
    nc = int(math.ceil(size / rc))
    need = int(math.ceil(3.0 * n_bodies / float(nc * nc)))
    if need > 64:
        m = 2
        nc = int(math.ceil(size / (rc / m)))
        need = int(math.ceil(3.0 * n_bodies / float(nc * nc)))
    K = min(max(-(-int(bh["p3m_max_per_cell"]) // (m * m)), need), 128)
    return rc / m, nc, m, K, rc


def pp_pairs(pos, conf, size: float, n_bodies: int) -> float:
    """Ordered pairs (receiver, source), receiver != source, closer than
    rc, both among the first K bodies (by index) of their PP cells."""
    width, nc, m, K, rc = pp_grid(conf, size, n_bodies)
    p = pos.to(torch.float64)
    gx = torch.floor(p[:, 0] / width).long()
    gy = torch.floor(p[:, 1] / width).long()
    ok = (gx >= 0) & (gx < nc) & (gy >= 0) & (gy < nc)
    cid = torch.where(ok, gy * nc + gx, torch.full_like(gx, nc * nc))
    order = torch.argsort(cid, stable=True)
    sc = cid[order]
    rank = torch.arange(len(sc), device=sc.device) - \
        torch.searchsorted(sc, sc)
    keep = order[(sc < nc * nc) & (rank < K)]          # resident bodies
    rp, rc_ = p[keep], cid[keep]
    srt = torch.argsort(rc_)
    rp, rc_ = rp[srt], rc_[srt]
    cx, cy = rc_ % nc, rc_ // nc
    total = 0.0
    band = 1 << 16
    for dy in range(-m, m + 1):
        for dx in range(-m, m + 1):
            nx_, ny_ = cx + dx, cy + dy
            inside = (nx_ >= 0) & (nx_ < nc) & (ny_ >= 0) & (ny_ < nc)
            nid = torch.where(inside, ny_ * nc + nx_, torch.full_like(cx, -1))
            lo = torch.searchsorted(rc_, nid)
            cnt = torch.searchsorted(rc_, nid, right=True) - lo
            for a in range(0, len(rp), band):
                b = min(len(rp), a + band)
                kk = torch.arange(K, device=rp.device)
                j = lo[a:b, None] + kk[None, :]
                valid = kk[None, :] < cnt[a:b, None]
                j = torch.where(valid, j, torch.zeros_like(j))
                d = rp[j] - rp[a:b, None, :]
                d2 = (d * d).sum(-1)
                near = valid & (d2 < rc * rc)
                if dx == 0 and dy == 0:
                    near = near & (j != torch.arange(a, b, device=j.device)
                                   [:, None])
                total += float(near.sum())
    return total


def gravity_bound_s(pos, conf, size: float, n_bodies: int, n_heavy: int):
    """Seconds one P3M gravity step needs for positions ``pos``: the
    mesh (three FFTs of the padded 2G grid and the CIC deposit and
    gather), the PP pairs and the heavy direct sum, each bounded by its
    operations or by its inputs and result (positions, masses, [n, 2])."""
    n = pos.shape[0]
    P = 2 * conf["barnes_hut"]["pm_grid"]
    io = (2 + 1 + 2) * n * F32
    fft_ops = 3 * 2.5 * P * P * math.log2(P * P)
    return (bound_s(io, fft_ops + CIC_OPS * n)
            + bound_s(io, PP_PAIR_OPS * pp_pairs(pos, conf, size, n_bodies))
            + bound_s(io, GRAV_PAIR_OPS * n * n_heavy))
