"""The kernels of the SPH sub-step, with their plain PyTorch versions: the
stacked chain (``migrate``, ``pair_sweep``, ``coupling9``), the split
kernels (``density``, ``force``, ``coupling``) and the split kernels of a
scene whose liquid particles have mixed smoothing lengths (``migrate_h``,
``density_h``, ``force_h``: each pair's kernel at h-bar = (h_i + h_j) / 2,
``lpe_tpu/systems/fluid/sph.py`` density_core and force_core).

Each public op launches a
hand-written CUDA kernel (``csrc/*.cu``, built by ``_build.py``) for CUDA
tensors and runs its plain PyTorch version (``*_plain`` below) for CPU
tensors; any other device raises. There is no fallback: a CUDA input that
the kernel does not take raises. ``op.launches`` counts kernel launches
and ``op.plain_calls`` counts plain runs; ``reset_counters()`` zeroes both.

Layouts keep the JAX package's plane orders (``lpe_tpu/ops/pallas_sph.py``
:1109-1123). All grids are row stacks ``[rows, planes, K, cols]`` with
``rows = ny + 2`` padded grid rows (apron rows 0 and ny+1 are empty) and
any ``cols >= nx + 2`` padded columns (columns past nx+1 are empty):

- ``ST`` (sub-step input): x, y, vx, vy, ax, ay, m, id, occ
- ``M9`` (migrated):        x1, y1, vx, vy, m, occ, hx, hy, id
- ``D4`` (density input):   x, y, m, occ        (``pallas_sph.py:94``)
- ``D8`` (force input):     x, y, vx, vy, m, rho, p, occ        (``:142``)
- ``D10`` (coupling input): x, y, vx1, vy1, rho, p, m, occ, ax, ay (``:567``)

The mixed-h variants append the particles' smoothing length h as the last
plane, so that planes 0-8 keep their indices: ``ST10`` and ``M10`` (ST and
M9 + h, the migration carries h with the particle, ``lpe_tpu`` sph.py:632),
``D5`` (D4 + h) and ``D9`` (D8 + h).

The JAX package's per-(row, tile) occupancy tables (``rm2``, ``cpl2``) are
scalar-prefetch devices of the TPU: the ops here take no ``rm2`` and a
per-column ``cpl``.

The rigid candidate tables of the coupling (``fld`` and ``big``) use the
``_RW_*`` parameter layout of ``lpe_tpu/ops/pallas_sph.py:248-257``.
"""
from __future__ import annotations

import math

import torch

from ..core.numerics import scatter_add, sqrt, true_div
from ..core.profiler import HOST, PROFILER

(ST_X, ST_Y, ST_VX, ST_VY, ST_AX, ST_AY, ST_M, ST_ID, ST_OCC) = range(9)
(M9_X, M9_Y, M9_VX, M9_VY, M9_M, M9_OCC, M9_HX, M9_HY, M9_ID) = range(9)
(D8_X, D8_Y, D8_VX, D8_VY, D8_M, D8_RHO, D8_P, D8_OCC) = range(8)
ST_H = M10_H = 9       # h, the last plane of ST10 and M10
(D10_X, D10_Y, D10_VX, D10_VY, D10_RHO, D10_P, D10_M, D10_OCC, D10_AX,
 D10_AY) = range(10)
(RW_PX, RW_PY, RW_VX, RW_VY, RW_OM, RW_M, RW_I, RW_RAD, RW_CIR,
 RW_MINX, RW_MINY, RW_MAXX, RW_MAXY) = range(13)
RW_V0 = 13
# columns per block of the coupling kernel: the granularity of its
# per-block big-solid partial sums (``bigp``)
BIG_BLOCK_COLS = 32
MAX_K = 64          # the kernels keep a cell's K slots in at most two warps


def rig_width(V: int) -> int:
    """Candidate parameter planes for V-vertex rings (multiple of 8)."""
    return -(-(RW_V0 + 2 * V) // 8) * 8


class KernelOp:
    """A kernel with its plain version and its two counters. Each call is
    an ``op.<name>`` span of the port's tracer (host time: the argument
    checks, the parameter packing and the launch, or the plain run)."""

    def __init__(self, name, plain, launch):
        self.name = name
        self.plain = plain
        self._launch = launch
        self._span = f"op.{name}"
        self.launches = 0
        self.plain_calls = 0

    def __call__(self, *args, **kw):
        dev = args[0].device
        with PROFILER.scope(self._span, HOST):
            if dev.type == "cuda":
                out = self._launch(*args, **kw)
                self.launches += 1
                return out
            if dev.type == "cpu":
                self.plain_calls += 1
                return self.plain(*args, **kw)
        raise ValueError(f"{self.name}: no kernel for device {dev}")


# ---------------------------------------------------------------------------
# migrate: kick + drift + cell migration (replaces make_migrate_ring)
# ---------------------------------------------------------------------------

def migrate_plain(ST, *, nx, half_dt, sub_dt, lim, cell, eps, gmin,
                  row_off=0, ny=None):
    """Half kick ``h = v + half_dt*a``, drift ``x1 = x + clip(h*sub_dt,
    +-lim)``, then re-bin: each occupied slot targets the cell of its new
    position, clamped to the grid and to +-1 of its current cell (the
    walk of ``lpe_tpu/systems/fluid/sph.py`` _migrate). Each target cell
    takes its candidates in (dy, dx, slot) order over its 3x3 source
    cells and keeps the first K; the rest are dropped. Returns M9; a tenth
    plane of ST (h, ``migrate_h_plain``) rides the permutation into a
    tenth plane of the output.

    A row band's block (``row_off``, ``ny``; lpe_tpu ``_migrate(...,
    row_off)``, sph.py:666-668) holds ``rows - 2`` interior rows of a grid
    of ``ny`` rows, from global row ``row_off`` (the last band's may run
    past the grid's rows: they take no particle), and its apron rows hold the
    neighbour bands' edge rows (their ST planes, before the kick). Every
    occupied slot is kicked, drifted and ranked, apron rows included, so a
    particle crossing into the band from a halo row is a candidate as on
    the whole grid; its kick and drift are the elementwise arithmetic its
    own band does, so they give the same bits. A cell row clamps to the
    whole grid, then shifts by ``row_off``; only interior rows take
    particles. The defaults are the whole grid: 0 and ``rows - 2``."""
    rows, F, K, W = ST.shape
    nyl = rows - 2
    if ny is None:
        ny = nyl
    if row_off < 0 or ny < nyl:
        raise ValueError(f"migrate: a block of {nyl} rows from row "
                         f"{row_off} is not in a grid of {ny}")
    x, y, vx, vy, ax, ay, m, pid, occ = ST.unbind(1)[:9]
    hx = vx + half_dt * ax
    hy = vy + half_dt * ay
    x1 = x + torch.clamp(hx * sub_dt, -lim, lim)
    y1 = y + torch.clamp(hy * sub_dt, -lim, lim)
    dev = ST.device
    colg = torch.arange(W, device=dev, dtype=torch.int32).view(1, 1, W)
    rowg = torch.arange(rows, device=dev, dtype=torch.int32).view(rows, 1, 1)
    i32 = torch.int32
    gx = torch.clamp(torch.floor(true_div(x1 + eps, cell)).to(i32) - gmin,
                     0, nx - 1)
    gy = torch.clamp(torch.floor(true_div(y1 + eps, cell)).to(i32) - gmin,
                     0, ny - 1) - row_off
    tgx = torch.minimum(torch.maximum(gx, colg - 2), colg) + 1
    tgy = torch.minimum(torch.maximum(gy, rowg - 2), rowg) + 1
    live = (occ > 0) & (tgy >= 1) & (tgy <= nyl) & (tgx >= 1) & (tgx <= nx)
    # candidate order inside a target cell: (dy, dx, slot)
    kk = torch.arange(K, device=dev, dtype=torch.int64).view(1, K, 1)
    off = ((rowg - tgy + 1) * 3 + (colg - tgx + 1)).to(torch.int64)
    tcell = (tgy * W + tgx).to(torch.int64)
    big = rows * W * 9 * K
    key = torch.where(live, (tcell * 9 + off) * K + kk,
                      torch.full_like(tcell, big)).reshape(-1)
    order = torch.argsort(key)          # keys of live slots are unique
    skey = key[order]
    scell = skey // (9 * K)
    rank = torch.arange(skey.numel(), device=dev) - \
        torch.searchsorted(scell, scell)
    keep = (skey < big) & (rank < K)
    ty = scell // W
    tx = scell % W
    plane = K * W

    def dest(f):
        d = ((ty * F + f) * K + rank) * W + tx
        return torch.where(keep, d, torch.full_like(d, rows * F * plane))

    out = torch.zeros(rows * F * plane + 1, dtype=ST.dtype, device=dev)
    srcs = {M9_X: x1, M9_Y: y1, M9_VX: vx, M9_VY: vy, M9_M: m,
            M9_OCC: torch.ones_like(x), M9_HX: hx, M9_HY: hy, M9_ID: pid}
    srcs.update({f: ST[:, f] for f in range(9, F)})
    for f, v in srcs.items():
        out.scatter_(0, dest(f), v.reshape(-1)[order])
    return out[:-1].view(rows, F, K, W)


def migrate_h_plain(ST10, **consts):
    """``migrate_plain`` on ST10 [rows, 10, K, cols]: the particles'
    smoothing lengths (plane 9) move with them. Returns M10, M9's planes
    and h."""
    if ST10.shape[1] != 10:
        raise ValueError(f"migrate_h: expected ST10, got {tuple(ST10.shape)}")
    return migrate_plain(ST10, **consts)


# ---------------------------------------------------------------------------
# pair sweep: density, EOS, pressure + viscosity forces (make_pair_sweep F=9)
# ---------------------------------------------------------------------------

def _occupied(occ):
    """Flat indices into [rows, K, W] of the occupied interior slots, and
    their (row, slot, column)."""
    rows, K, W = occ.shape
    inner = torch.zeros_like(occ, dtype=torch.bool)
    inner[1:-1] = occ[1:-1] > 0
    idx = torch.nonzero(inner.reshape(-1)).squeeze(1)
    return idx, idx // (K * W), (idx // W) % K, idx % W


def _neighbours(r, c, K, W):
    """Flat [rows, K, W] indices [N, 9, K] of the 3x3-cell neighbour slots
    of particles in cells (r, c), in (dy, dx, slot) order, and the mask of
    neighbour cells inside the columns (rows always are: r is interior)."""
    d = torch.arange(-1, 2, device=r.device)
    nr = (r[:, None] + d.repeat_interleave(3)[None, :])[..., None]
    nc = (c[:, None] + d.repeat(3)[None, :])[..., None]
    inside = (nc >= 0) & (nc < W)
    k2 = torch.arange(K, device=r.device)[None, None, :]
    nidx = (nr * K + k2) * W + torch.clamp(nc, 0, W - 1)
    return nidx, inside


def _offset_sum(v):
    """[N, 9, K] pair terms -> [N]: each neighbour cell's K slots summed in
    slot order, then the 9 cells added in (dy, dx) order, the association
    of lpe_tpu's XLA pair passes (sph.py density_core / force_core)."""
    acc = None
    for o in range(v.shape[1]):
        cell = v[:, o, 0]
        for k in range(1, v.shape[2]):
            cell = cell + v[:, o, k]
        acc = cell if acc is None else acc + cell
    return acc


class _Pairs:
    """The pairs of the occupied interior slots of planes x, y, occ
    [rows, K, W] with the slots of their 3x3 cells: ``idx`` [N] flat slot
    indices, ``nidx`` [N, 9, K] their neighbour slots in (dy, dx, slot)
    order, the separations and the mask of occupied neighbours. Works on
    the list of occupied slots (``nonzero``: a host sync on a GPU, where
    the kernels run instead)."""

    def __init__(self, x, y, occ):
        rows, K, W = occ.shape
        self.shape = (rows, K, W)
        self.idx, r, self.k, c = _occupied(occ)
        self.nidx, inside = _neighbours(r, c, K, W)
        fx, fy = x.reshape(-1), y.reshape(-1)
        self.ddx = fx[self.idx][:, None, None] - fx[self.nidx]
        self.ddy = fy[self.idx][:, None, None] - fy[self.nidx]
        self.r2 = self.ddx * self.ddx + self.ddy * self.ddy
        self.nocc = (occ.reshape(-1)[self.nidx] > 0) & inside

    def centre(self, v):
        return v.reshape(-1)[self.idx][:, None, None]     # [N, 1, 1]

    def neighbour(self, v):
        return v.reshape(-1)[self.nidx]                   # [N, 9, K]

    def dense(self, v):
        """[N] values of the occupied slots -> a flat [rows*K*W] plane,
        0 in empty slots."""
        rows, K, W = self.shape
        out = torch.zeros(rows * K * W, dtype=v.dtype, device=v.device)
        return out.scatter_(0, self.idx, v)


def _density_pairs(pairs, m, h, poly6):
    """Flat [rows*K*W] poly6 density over ``pairs``, self term included.
    ``h`` and ``poly6`` are the grid's numbers, or per-pair [N, 9, K]
    tensors for mixed h (``_pair_h``)."""
    h2 = h * h
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    d = h2 - pairs.r2
    w = torch.where(pairs.nocc & (pairs.r2 < h2), poly6 * (d * d * d), zero)
    return pairs.dense(_offset_sum(pairs.neighbour(m) * w))


def _force_pairs(pairs, vx, vy, m, rho_full, p_full, *, h, spiky, visc_lap,
                 viscosity, min_d2, min_rho):
    """Flat [rows*K*W] fx, fy over ``pairs`` from the flat density and
    pressure planes, with the masks of ``lpe_tpu`` force_core
    (sph.py:545-599). ``h``, ``spiky`` and ``visc_lap`` are the grid's
    numbers, or per-pair [N, 9, K] tensors for mixed h (``_pair_h``)."""
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    K = pairs.shape[1]
    r2, ddx, ddy = pairs.r2, pairs.ddx, pairs.ddy
    nm = pairs.neighbour(m)
    crho = pairs.centre(rho_full)
    cterm = pairs.centre(p_full) / torch.clamp(crho * crho, min=1e-30)
    nrho, np_ = pairs.neighbour(rho_full), pairs.neighbour(p_full)
    ok = pairs.nocc & (r2 >= min_d2) & (r2 < h * h) & (nrho >= min_rho) \
        & (crho >= min_rho)
    self_pair = torch.zeros_like(ok)
    self_pair[:, 4] = torch.arange(K, device=m.device)[None, :] \
        == pairs.k[:, None]
    ok = ok & ~self_pair
    rr = sqrt(torch.clamp(r2, min=1e-30))
    term = cterm + np_ / torch.clamp(nrho * nrho, min=1e-30)
    hr = h - rr
    w_spiky = spiky * (hr * hr)
    f_press = -nm * term * w_spiky
    gx = f_press * ddx / rr
    gy = f_press * ddy / rr
    f_visc = viscosity * nm * (visc_lap * hr / torch.clamp(nrho, min=1e-30))
    gx = gx - f_visc * (pairs.centre(vx) - pairs.neighbour(vx))
    gy = gy - f_visc * (pairs.centre(vy) - pairs.neighbour(vy))
    return (pairs.dense(_offset_sum(torch.where(ok, gx, zero))),
            pairs.dense(_offset_sum(torch.where(ok, gy, zero))))


def _pair_h(pairs, hpl):
    """Per pair [N, 9, K] of a mixed-h grid (h plane ``hpl``): h-bar =
    (h_i + h_j) / 2 and the kernels' 2D normalisations at h-bar, in the
    operation order of ``lpe_tpu`` density_core and force_core
    (sph.py:488-599; reference: fluid_kernels.metal:362-396): poly6
    4 / (pi max(h-bar^2, 1e-30)^4), spiky -30 / (pi max(h-bar, 1e-30)^5),
    viscosity 40 / (pi max(h-bar, 1e-30)^5). Powers multiply as XLA's
    integer_pow does: x^4 = (x x)(x x), x^5 = x ((x x)(x x))."""
    hb = 0.5 * (pairs.centre(hpl) + pairs.neighbour(hpl))
    m2 = torch.clamp(hb * hb, min=1e-30)
    m2 = m2 * m2
    m1 = torch.clamp(hb, min=1e-30)
    pi_h5 = math.pi * (m1 * ((m1 * m1) * (m1 * m1)))
    return dict(h=hb, poly6=true_div(4.0, math.pi * (m2 * m2)),
                spiky=true_div(-30.0, pi_h5), visc_lap=true_div(40.0, pi_h5))


def pair_sweep_plain(M9, *, h, poly6, spiky, visc_lap, viscosity, min_d2,
                     min_rho, stiffness, rest_density):
    """Poly6 density over the 3x3 cells (self term included), EOS
    ``p = max(k*(rho - rho0), 0)``, then the symmetric spiky pressure
    force and the viscosity-Laplacian force on the pre-kick velocities
    (M9 planes 2-3). Returns (rho, fx, fy), each [ny, K, cols] over the
    interior rows; empty slots hold 0."""
    x, y, vx, vy, m, occ = M9.unbind(1)[:6]
    pairs = _Pairs(x, y, occ)
    rho_full = _density_pairs(pairs, m, h, poly6)
    p_full = torch.clamp(stiffness * (rho_full - rest_density), min=0.0)
    fx, fy = _force_pairs(pairs, vx, vy, m, rho_full, p_full, h=h, spiky=spiky,
                          visc_lap=visc_lap, viscosity=viscosity,
                          min_d2=min_d2, min_rho=min_rho)
    return tuple(v.view(occ.shape)[1:-1] for v in (rho_full, fx, fy))


# ---------------------------------------------------------------------------
# density, force: the split pair passes (make_density, make_force)
# ---------------------------------------------------------------------------

def density_plain(D4, *, h, poly6):
    """Poly6 density over the 3x3 cells of D4 [rows, 4(x, y, m, occ), K,
    cols], self term included (``lpe_tpu/ops/pallas_sph.py``
    _density_kernel). Returns rho [ny, K, cols] over the interior rows;
    empty slots hold 0."""
    x, y, m, occ = D4.unbind(1)
    rho = _density_pairs(_Pairs(x, y, occ), m, h, poly6)
    return rho.view(occ.shape)[1:-1]


def density_h_plain(D5):
    """Poly6 density over the 3x3 cells of D5 [rows, 5(x, y, m, occ, h), K,
    cols] with each pair's kernel at its h-bar (``_pair_h``): a pair counts
    when r^2 < h-bar^2. Returns rho [ny, K, cols] over the interior rows;
    empty slots hold 0."""
    x, y, m, occ, hpl = D5.unbind(1)
    pairs = _Pairs(x, y, occ)
    ph = _pair_h(pairs, hpl)
    rho = _density_pairs(pairs, m, ph["h"], ph["poly6"])
    return rho.view(occ.shape)[1:-1]


def force_plain(D8, *, h, spiky, visc_lap, viscosity, min_d2, min_rho):
    """Symmetric spiky pressure force and viscosity-Laplacian force over
    the 3x3 cells of D8 [rows, 8(x, y, vx, vy, m, rho, p, occ), K, cols]
    (``lpe_tpu/ops/pallas_sph.py`` _force_kernel): the density and the
    pressure are inputs, the self pair is excluded, and a pair counts when
    min_d2 <= r^2 < h^2 and both densities reach min_rho. Returns (fx, fy),
    each [ny, K, cols] over the interior rows; empty slots hold 0."""
    x, y, vx, vy, m, rho, p, occ = D8.unbind(1)
    fx, fy = _force_pairs(_Pairs(x, y, occ), vx, vy, m, rho.reshape(-1),
                          p.reshape(-1), h=h, spiky=spiky,
                          visc_lap=visc_lap, viscosity=viscosity,
                          min_d2=min_d2, min_rho=min_rho)
    return tuple(v.view(occ.shape)[1:-1] for v in (fx, fy))


def force_h_plain(D9, *, viscosity, min_d2, min_rho):
    """``force_plain`` over D9 [rows, 9(x, y, vx, vy, m, rho, p, occ, h),
    K, cols] with each pair's h-bar and kernels (``_pair_h``): a pair
    counts when min_d2 <= r^2 < h-bar^2 and both densities reach min_rho.
    Returns (fx, fy), each [ny, K, cols] over the interior rows."""
    x, y, vx, vy, m, rho, p, occ, hpl = D9.unbind(1)
    pairs = _Pairs(x, y, occ)
    ph = _pair_h(pairs, hpl)
    fx, fy = _force_pairs(pairs, vx, vy, m, rho.reshape(-1), p.reshape(-1),
                          h=ph["h"], spiky=ph["spiky"],
                          visc_lap=ph["visc_lap"], viscosity=viscosity,
                          min_d2=min_d2, min_rho=min_rho)
    return tuple(v.view(occ.shape)[1:-1] for v in (fx, fy))


# ---------------------------------------------------------------------------
# coupling9: second kick + two-way rigid coupling (make_coupling9)
# ---------------------------------------------------------------------------

def hoist_particle_terms(cn, py, rho, p, m):
    """Per-particle factors of the coupling impulse
    (``lpe_tpu/ops/pallas_sph.py`` hoist_particle_terms)."""
    rest = cn["rest_density"]
    pos = rho > 0.0
    dens = torch.where(pos, rho, torch.full_like(rho, rest))
    vol = torch.where(pos, m / torch.clamp(rho, min=1e-30),
                      true_div(m, rest))
    area = vol.abs() ** (2.0 / 3.0)
    depth = torch.clamp(true_div(py, cn["depth_estimate_scale"]),
                        max=1.0)
    hydro = dens * cn["gravity"] * depth
    parea = (p + hydro) * area
    vmul = cn["viscosity"] * cn["viscosity_scale"] * dens * cn["sub_dt"]
    bmul = cn["buoyancy_strength"] * area * cn["gravity"] * dens
    return dict(parea=parea, vmul=vmul, bmul=bmul)


def _cand_math(V, cn, gp, in_aabb, px, py, vx1, vy1, hp):
    """Coupling of a batch of candidates against the particles: the
    position push-out and impulse of ``lpe_tpu/ops/pallas_sph.py``
    _cand_math (reference: fluid_kernels.metal:533-924). ``gp(i)`` is
    candidate plane i broadcastable against the particles."""
    where = torch.where
    zero = torch.zeros((), dtype=px.dtype, device=px.device)
    one = torch.ones((), dtype=px.dtype, device=px.device)
    rpx, rpy = gp(RW_PX), gp(RW_PY)
    rvxs, rvys, rom = gp(RW_VX), gp(RW_VY), gp(RW_OM)
    rmass, rinert, rrad = gp(RW_M), gp(RW_I), gp(RW_RAD)
    rx = px - rpx
    ry = py - rpy
    if cn["any_circle"]:
        d2 = rx * rx + ry * ry
        dist_c = sqrt(torch.clamp(d2, min=1e-30))
        inside_c = d2 < rrad * rrad
    else:
        dist_c = torch.ones_like(rx)
        inside_c = torch.zeros_like(rx, dtype=torch.bool)
    parity = torch.zeros_like(rx, dtype=torch.int32)
    best_d2 = torch.full_like(rx, 1e30)
    cxb = torch.zeros_like(rx)
    cyb = torch.zeros_like(rx)
    for v in range(V if cn["any_poly"] else 0):
        xi, yi = gp(RW_V0 + 2 * v), gp(RW_V0 + 2 * v + 1)
        xj = gp(RW_V0 + 2 * ((v - 1) % V))
        yj = gp(RW_V0 + 2 * ((v - 1) % V) + 1)
        denom = yj - yi
        denc = where(denom.abs() < 1e-30, one * 1e-30, denom)
        lhs = (px - xi) * denc
        rhs = (xj - xi) * (py - yi)
        straddle = (yi > py) != (yj > py)
        pos = denc > 0
        crosses = straddle & ((pos & (lhs < rhs)) | (~pos & (lhs > rhs)))
        parity = parity + crosses.to(torch.int32)
        x2s = gp(RW_V0 + 2 * ((v + 1) % V))
        y2s = gp(RW_V0 + 2 * ((v + 1) % V) + 1)
        ex = x2s - xi
        ey = y2s - yi
        el2 = ex * ex + ey * ey
        iel = 1.0 / where(el2 < 1e-16, one * 1e-16, el2)
        tt = ((px - xi) * ex + (py - yi) * ey) * iel
        tt = torch.clamp(tt, 0.0, 1.0)
        qx = xi + tt * ex
        qy = yi + tt * ey
        qd2 = (px - qx) * (px - qx) + (py - qy) * (py - qy)
        qd2 = where(el2 >= 1e-16, qd2, one * 1e30)
        better = qd2 < best_d2
        best_d2 = where(better, qd2, best_d2)
        cxb = where(better, qx, cxb)
        cyb = where(better, qy, cyb)
    inside_p = (parity % 2) == 1
    pdx = px - cxb
    pdy = py - cyb
    dist_p = sqrt(torch.clamp(pdx * pdx + pdy * pdy, min=1e-30))
    if cn["any_circle"] and cn["any_poly"]:
        is_c = gp(RW_CIR) > 0
        inside_s = (is_c & inside_c) | (~is_c & inside_p)
    else:
        is_c = torch.full_like(rx, float(cn["any_circle"])) > 0
        inside_s = inside_c if cn["any_circle"] else inside_p
    inside = in_aabb & inside_s

    # position correction (metal:533-668)
    msd = cn["min_safe_distance"]
    d_c = torch.clamp(dist_c, min=msd)
    inv_dc = 1.0 / d_c
    dirx_c = where(dist_c < msd, one, rx * inv_dc)
    diry_c = where(dist_c < msd, zero, ry * inv_dc)
    pen_c = (rrad - d_c) + cn["safety_margin"]
    d_p = torch.clamp(dist_p, min=msd)
    inv_dp = 1.0 / d_p
    dirx_p = where(dist_p < msd, one, pdx * inv_dp)
    diry_p = where(dist_p < msd, zero, pdy * inv_dp)
    pen_p = d_p + cn["safety_margin"]
    corr_x = where(is_c, -dirx_c * pen_c, dirx_p * pen_p)
    corr_y = where(is_c, -diry_c * pen_c, diry_p * pen_p)
    corr_x = where(inside, corr_x * cn["relax_factor"], zero)
    corr_y = where(inside, corr_y * cn["relax_factor"], zero)

    # impulse exchange (metal:679-924)
    mpen = cn["min_penetration"]
    rb_v2 = rvxs * rvxs + rvys * rvys + rom * rom
    ok_r = rb_v2 <= cn["max_safe_velocity_sq"]
    pen = where(is_c,
                torch.clamp(rrad - torch.clamp(dist_c, min=mpen), min=0.0),
                torch.clamp(dist_p, min=mpen))
    inv_nc = 1.0 / torch.clamp(dist_c, min=mpen)
    inv_np = 1.0 / torch.clamp(dist_p, min=mpen)
    nrm_x = where(is_c, rx * inv_nc, pdx * inv_np)
    nrm_y = where(is_c, ry * inv_nc, pdy * inv_np)
    act = inside & ok_r & (pen >= mpen)
    rig_vx = rvxs - rom * ry
    rig_vy = rvys + rom * rx
    rvx = vx1 - rig_vx
    rvy = vy1 - rig_vy
    depth_f = torch.tanh(true_div(cn["depth_transition_rate"] * pen,
                                  cn["depth_scale"]))
    vn = rvx * nrm_x + rvy * nrm_y
    tvx = rvx - nrm_x * vn
    tvy = rvy - nrm_y * vn
    pforce = hp["parea"] * depth_f
    maxF = cn["max_force"]
    fx = nrm_x * torch.clamp(pforce, max=maxF * cn["pressure_force_ratio"])
    fy = nrm_y * torch.clamp(pforce, max=maxF * cn["pressure_force_ratio"])
    tmag = sqrt(tvx * tvx + tvy * tvy)
    hast = tmag > cn["min_rel_velocity"]
    vforce = hp["vmul"] * tmag * depth_f
    vcap = torch.clamp(vforce, max=maxF * cn["viscous_force_ratio"])
    tdir = vcap / torch.clamp(tmag, min=1e-30)
    fx = fx + where(hast, -tvx * tdir, zero)
    fy = fy + where(hast, -tvy * tdir, zero)
    buoy = -(hp["bmul"] * pen)
    bfy = where(rmass > 0.1, buoy, zero)
    fyb = fy + bfy
    keep = fx * fx + fyb * fyb <= maxF * maxF
    fy = where(keep, fyb, fy)
    fmag2 = fx * fx + fy * fy
    fscale = where(fmag2 > maxF * maxF,
                   maxF * torch.rsqrt(torch.clamp(fmag2, min=1e-30)), one)
    fx = fx * fscale
    fy = fy * fscale
    tq = torch.clamp(rx * fy - ry * fx, -cn["max_torque"], cn["max_torque"])
    spin = rom.abs() > cn["angular_damping_threshold"]
    tq = tq - where(spin, cn["angular_damping_factor"] * torch.sign(rom)
                    * rom.abs() * rinert, zero)
    fx = where(act, fx, zero)
    fy = where(act, fy, zero)
    tq = where(act, tq, zero)
    return inside, corr_x, corr_y, fx, fy, tq, act


def _couple_fin(cn, acc, px, py, vx1, vy1, m, ax, ay):
    """Fluid back-reaction, capped push-out and PBD velocity fix-up
    (``lpe_tpu/ops/pallas_sph.py`` _couple_fin)."""
    where = torch.where
    one = torch.ones((), dtype=px.dtype, device=px.device)
    acx, acy, sfx, sfy, had_pos, had_imp = acc
    ffx = -sfx * cn["fluid_force_scale"]
    ffy = -sfy * cn["fluid_force_scale"]
    fm = sqrt(ffx * ffx + ffy * ffy)
    fsc = where(fm > cn["fluid_force_max"],
                true_div(cn["fluid_force_max"],
                         torch.clamp(fm, min=1e-30)), one)
    inv_m = where(m > 1e-4, 1.0 / m, one)
    axo = where(had_imp, ax + ffx * fsc * inv_m, ax)
    ayo = where(had_imp, ay + ffy * fsc * inv_m, ay)
    mag = sqrt(acx * acx + acy * acy)
    scale = where(mag > cn["max_correction"],
                  true_div(cn["max_correction"],
                           torch.clamp(mag, min=1e-30)), one)
    nx_ = px - acx * scale
    ny_ = py - acy * scale
    off = cn["boundary_offset"]
    nx_ = where(nx_ < 0.0, one * off, nx_)
    ny_ = where(ny_ < 0.0, one * off, ny_)
    ddx = nx_ - px
    ddy = ny_ - py
    dmag = sqrt(ddx * ddx + ddy * ddy)
    moved = had_pos & (dmag > cn["min_position_change"])
    cdx = ddx / torch.clamp(dmag, min=1e-30)
    cdy = ddy / torch.clamp(dmag, min=1e-30)
    valong = vx1 * cdx + vy1 * cdy
    fix = moved & (valong < 0.0)
    return (nx_, ny_, where(fix, vx1 - valong * cdx, vx1),
            where(fix, vy1 - valong * cdy, vy1), axo, ayo)


def _couple_planes(cpl, fld, big, cn, x1, y1, vx1, vy1, rho, p, m, occ, ax,
                   ay):
    """The coupling of ``lpe_tpu/ops/pallas_sph.py`` _couple_rows on
    particle planes [rows, K, cols]: every occupied slot of a cell with
    ``cpl > 0`` against the <= S rigids rasterized to its cell (``fld``
    [rows, S, Wp, cols]) and the NBIG big solids (``big`` [NBIG+1, Wp],
    last row zero). Every other slot is copied through, with the floor
    clamp on its position.

    Returns the six new planes (x, y, vx, vy, ax, ay; apron rows zero),
    the per-(row, slot, column) force partials PL [rows, 3S, cols] (fx, fy,
    tq of slot s at 3s..3s+2, summed over the K slots of the column), and
    the big-solid sums per (row, block of BIG_BLOCK_COLS columns)
    [rows, NB, 3*NBIG]."""
    rows, K, W = x1.shape
    S, Wp = fld.shape[1], fld.shape[2]
    NBIG = big.shape[0] - 1
    C = S + NBIG
    dev, dt = x1.device, x1.dtype
    # every slot first gets the copy-through (what coupling with no
    # candidate in reach also gives), then coupled particles overwrite it
    off = torch.full((), cn["boundary_offset"], dtype=dt, device=dev)
    planes = [torch.where(x1 < 0.0, off, x1), torch.where(y1 < 0.0, off, y1),
              vx1, vy1, ax, ay]
    planes = [v.reshape(-1).clone() for v in planes]

    # the coupled particles: occupied slots of cells with cpl > 0
    live = (occ > 0) & (cpl > 0).unsqueeze(1)
    live[0] = live[-1] = False
    idx = torch.nonzero(live.reshape(-1)).squeeze(1)
    r, c = idx // (K * W), idx % W
    pv = lambda v: v.reshape(-1)[idx][:, None]           # [N, 1]
    px, py, pvx1, pvy1, pm = pv(x1), pv(y1), pv(vx1), pv(vy1), pv(m)
    hp = hoist_particle_terms(cn, py, pv(rho), pv(p), pm)
    # candidates: the S slots rasterized to the particle's cell, then the
    # NBIG big solids
    prm = torch.cat([fld.permute(0, 3, 1, 2)[r, c],     # [N, S, Wp]
                     big[:NBIG].expand(idx.numel(), NBIG, Wp)], 1)
    gp = lambda i: prm[:, :, i]                          # [N, C]
    in_aabb = (px >= gp(RW_MINX)) & (px <= gp(RW_MAXX)) & \
        (py >= gp(RW_MINY)) & (py <= gp(RW_MAXY)) & (gp(RW_M) > 0)
    inside, cx_, cy_, cfx, cfy, ctq, act = _cand_math(
        cn["V"], cn, gp, in_aabb, px, py, pvx1, pvy1, hp)
    acc = [torch.zeros_like(px[:, 0])] * 4
    for j in range(C):                          # candidate order, in turn
        acc = [acc[0] + cx_[:, j], acc[1] + cy_[:, j], acc[2] + cfx[:, j],
               acc[3] + cfy[:, j]]
    acc += [inside.any(1), act.any(1)]
    outs = _couple_fin(cn, acc, px[:, 0], py[:, 0], pvx1[:, 0], pvy1[:, 0],
                       pm[:, 0], pv(ax)[:, 0], pv(ay)[:, 0])
    for f, v in enumerate(outs):                # x, y, vx, vy, ax, ay
        planes[f].scatter_(0, idx, v)
    planes = [v.view(rows, K, W) for v in planes]
    for v in planes:
        v[0] = 0.0
        v[-1] = 0.0

    # force partials: sums over the K slots of a column (per slot s), and
    # over the BIG_BLOCK_COLS columns of a block (per big solid)
    parts = torch.stack([cfx, cfy, ctq], 2)              # [N, C, 3]
    s_ = torch.arange(S, device=dev)
    pl_idx = ((r[:, None] * S + s_) * 3)[:, :, None] \
        + torch.arange(3, device=dev)
    PL = scatter_add(torch.zeros(rows * S * 3 * W, dtype=dt, device=dev),
                     (pl_idx * W + c[:, None, None]).reshape(-1),
                     parts[:, :S].reshape(-1))
    NB = -(-W // BIG_BLOCK_COLS)
    blk = (r * NB + c // BIG_BLOCK_COLS) * NBIG * 3
    bigp = scatter_add(
        torch.zeros(rows * NB * NBIG * 3, dtype=dt, device=dev),
        (blk[:, None] + torch.arange(NBIG * 3, device=dev)).reshape(-1),
        parts[:, S:].reshape(-1))
    return planes, PL.view(rows, 3 * S, W), bigp.view(rows, NB, NBIG * 3)


def coupling9_plain(cpl, fld, big, M9, rho, fx, fy, *, cn):
    """Second kick (``v = h + half_dt*f``) with EOS inline, then the
    coupling of ``_couple_planes``. Cells with ``cpl == 0`` ([rows, cols]
    int32) are copied through (with the floor clamp); apron rows are zero.

    Returns (ST, PL, bigp): the next sub-step's stack and the force
    partials of ``_couple_planes``."""
    x1, y1, vx, vy, m, occ, hx, hy, pid = M9.unbind(1)
    pad_r = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    fxp, fyp, rhop = pad_r(fx), pad_r(fy), pad_r(rho)
    vx1 = hx + cn["half_dt"] * fxp
    vy1 = hy + cn["half_dt"] * fyp
    pe = torch.clamp(cn["stiffness"] * (rhop - cn["rest_density"]), min=0.0)
    planes, PL, bigp = _couple_planes(cpl, fld, big, cn, x1, y1, vx1, vy1,
                                      rhop, pe, m, occ, fxp, fyp)
    ST = torch.stack(planes + [m, pid, occ], 1)
    ST[0] = 0.0
    ST[-1] = 0.0
    return ST, PL, bigp


# ---------------------------------------------------------------------------
# coupling: the same coupling on unstacked planes (make_coupling)
# ---------------------------------------------------------------------------

def coupling_plain(cpl, fld, big, D10, *, cn):
    """Two-way rigid coupling of D10 [rows, 10(x, y, vx1, vy1, rho, p, m,
    occ, ax, ay), K, cols] (``lpe_tpu/ops/pallas_sph.py`` _coupling_kernel):
    the velocity after the second kick, the density, the pressure and the
    pair acceleration are inputs. Cells with ``cpl == 0`` ([rows, cols]
    int32) are copied through; a position below 0 becomes the boundary
    offset in every slot (``lpe_tpu`` applies this clamp to the kernel's
    output, sph.py:1060-1062); apron rows are zero.

    Returns (x, y, vx, vy, ax, ay, PL, bigp): six planes [rows, K, cols]
    and the force partials of ``_couple_planes``."""
    x, y, vx1, vy1, rho, p, m, occ, ax, ay = D10.unbind(1)
    planes, PL, bigp = _couple_planes(cpl, fld, big, cn, x, y, vx1, vy1,
                                      rho, p, m, occ, ax, ay)
    return (*planes, PL, bigp)


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _grid_shape(M, what, F=9):
    if M.dim() != 4 or M.shape[1] != F:
        raise ValueError(f"{what}: expected [rows, {F}, K, cols], "
                         f"got {tuple(M.shape)}")
    rows, _, K, W = M.shape
    if not (1 <= K <= MAX_K) or rows < 4:
        raise ValueError(f"{what}: K must be in [1, {MAX_K}] and rows >= 4")
    return rows, K, W


def _migrate_launch(entry, F, ST, *, nx, half_dt, sub_dt, lim, cell, eps,
                    gmin, row_off=0, ny=None):
    from . import _build
    name = entry.removeprefix("lpe_")
    rows, K, W = _grid_shape(ST, name, F)
    ny = rows - 2 if ny is None else ny
    if not (1 <= nx <= W - 2):
        raise ValueError(f"{name}: nx={nx} does not fit {W} columns")
    if row_off < 0 or ny < rows - 2:
        raise ValueError(f"{name}: a block of {rows - 2} rows from row "
                         f"{row_off} is not in a grid of {ny}")
    _check(f"{name} ST", ST, (rows, F, K, W))
    out = torch.empty_like(ST)
    P = _build.MigrateParams(rows, K, W, nx, ny, gmin, row_off, half_dt,
                             sub_dt, lim, cell, eps)
    _build.call(entry, ST, out, P)
    return out


def _migrate_cuda(ST, **consts):
    return _migrate_launch("lpe_migrate", 9, ST, **consts)


def _migrate_h_cuda(ST10, **consts):
    return _migrate_launch("lpe_migrate_h", 10, ST10, **consts)


def _pair_sweep_cuda(M9, *, h, poly6, spiky, visc_lap, viscosity, min_d2,
                     min_rho, stiffness, rest_density):
    from . import _build
    rows, K, W = _grid_shape(M9, "pair_sweep")
    _check("pair_sweep M9", M9, (rows, 9, K, W))
    ny = rows - 2
    rho = torch.empty((ny, K, W), dtype=M9.dtype, device=M9.device)
    fx = torch.empty_like(rho)
    fy = torch.empty_like(rho)
    P = _build.SweepParams(rows, K, W, h, h * h, poly6, spiky, visc_lap,
                           viscosity, min_d2, min_rho, stiffness,
                           rest_density)
    _build.call("lpe_pair_sweep", M9, rho, fx, fy, P)
    return rho, fx, fy


def _density_cuda(D4, *, h, poly6):
    from . import _build
    rows, K, W = _grid_shape(D4, "density", 4)
    _check("density D4", D4, (rows, 4, K, W))
    rho = torch.empty((rows - 2, K, W), dtype=D4.dtype, device=D4.device)
    P = _build.SweepParams(rows, K, W, h, h * h, poly6, 0.0, 0.0, 0.0, 0.0,
                           0.0, 0.0, 0.0)
    _build.call("lpe_density", D4, rho, P)
    return rho


def _force_cuda(D8, *, h, spiky, visc_lap, viscosity, min_d2, min_rho):
    from . import _build
    rows, K, W = _grid_shape(D8, "force", 8)
    _check("force D8", D8, (rows, 8, K, W))
    fx = torch.empty((rows - 2, K, W), dtype=D8.dtype, device=D8.device)
    fy = torch.empty_like(fx)
    P = _build.SweepParams(rows, K, W, h, h * h, 0.0, spiky, visc_lap,
                           viscosity, min_d2, min_rho, 0.0, 0.0)
    _build.call("lpe_force", D8, fx, fy, P)
    return fx, fy


def _density_h_cuda(D5):
    from . import _build
    rows, K, W = _grid_shape(D5, "density_h", 5)
    _check("density_h D5", D5, (rows, 5, K, W))
    rho = torch.empty((rows - 2, K, W), dtype=D5.dtype, device=D5.device)
    P = _build.SweepParams(rows, K, W, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                           0.0, 0.0, 0.0)
    _build.call("lpe_density_h", D5, rho, P)
    return rho


def _force_h_cuda(D9, *, viscosity, min_d2, min_rho):
    from . import _build
    rows, K, W = _grid_shape(D9, "force_h", 9)
    _check("force_h D9", D9, (rows, 9, K, W))
    fx = torch.empty((rows - 2, K, W), dtype=D9.dtype, device=D9.device)
    fy = torch.empty_like(fx)
    P = _build.SweepParams(rows, K, W, 0.0, 0.0, 0.0, 0.0, 0.0, viscosity,
                           min_d2, min_rho, 0.0, 0.0)
    _build.call("lpe_force_h", D9, fx, fy, P)
    return fx, fy


def _couple_args(what, cpl, fld, big, M, F, cn):
    """Check the coupling arguments shared by coupling9 and coupling;
    returns (rows, K, W, S, NBIG, PL, bigp) with the partial outputs
    allocated."""
    rows, K, W = _grid_shape(M, what, F)
    if fld.dim() != 4 or big.dim() != 2:
        raise ValueError(f"{what}: fld must be [rows, S, Wp, cols] and "
                         "big [NBIG+1, Wp]")
    S, Wp = fld.shape[1], fld.shape[2]
    NBIG = big.shape[0] - 1
    if S < 1 or Wp != rig_width(cn["V"]) or big.shape[1] != Wp:
        raise ValueError(f"{what}: candidate width {Wp} != "
                         f"rig_width({cn['V']})")
    _check(f"{what} particles", M, (rows, F, K, W))
    _check(f"{what} cpl", cpl, (rows, W), torch.int32)
    _check(f"{what} fld", fld, (rows, S, Wp, W))
    _check(f"{what} big", big, (NBIG + 1, Wp))
    NB = -(-W // BIG_BLOCK_COLS)
    PL = torch.empty((rows, 3 * S, W), dtype=M.dtype, device=M.device)
    bigp = torch.empty((rows, NB, 3 * max(NBIG, 1)), dtype=M.dtype,
                       device=M.device)
    return rows, K, W, S, NBIG, PL, bigp


def _coupling9_cuda(cpl, fld, big, M9, rho, fx, fy, *, cn):
    from . import _build
    rows, K, W, S, NBIG, PL, bigp = _couple_args("coupling9", cpl, fld, big,
                                                 M9, 9, cn)
    for name, t in (("rho", rho), ("fx", fx), ("fy", fy)):
        _check(f"coupling9 {name}", t, (rows - 2, K, W))
    ST = torch.empty_like(M9)
    P = _build.couple_params(rows, K, W, S, NBIG, cn)
    _build.call("lpe_coupling9", cpl, fld, big, M9, rho, fx, fy, ST, PL,
                bigp, P)
    return ST, PL, bigp[:, :, :3 * NBIG]


def _coupling_cuda(cpl, fld, big, D10, *, cn):
    from . import _build
    rows, K, W, S, NBIG, PL, bigp = _couple_args("coupling", cpl, fld, big,
                                                 D10, 10, cn)
    out = torch.empty((6, rows, K, W), dtype=D10.dtype, device=D10.device)
    P = _build.couple_params(rows, K, W, S, NBIG, cn)
    _build.call("lpe_coupling", cpl, fld, big, D10, out, PL, bigp, P)
    return (*out.unbind(0), PL, bigp[:, :, :3 * NBIG])


migrate = KernelOp("migrate", migrate_plain, _migrate_cuda)
pair_sweep = KernelOp("pair_sweep", pair_sweep_plain, _pair_sweep_cuda)
coupling9 = KernelOp("coupling9", coupling9_plain, _coupling9_cuda)
density = KernelOp("density", density_plain, _density_cuda)
force = KernelOp("force", force_plain, _force_cuda)
coupling = KernelOp("coupling", coupling_plain, _coupling_cuda)
migrate_h = KernelOp("migrate_h", migrate_h_plain, _migrate_h_cuda)
density_h = KernelOp("density_h", density_h_plain, _density_h_cuda)
force_h = KernelOp("force_h", force_h_plain, _force_h_cuda)
OPS = (migrate, pair_sweep, coupling9, density, force, coupling, migrate_h,
       density_h, force_h)


def reset_counters():
    for op in OPS:
        op.launches = 0
        op.plain_calls = 0
