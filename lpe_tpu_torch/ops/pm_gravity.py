"""Particle-mesh (P3M) N-body gravity for large N, in PyTorch and one
CUDA kernel (the PP pass).

The counterpart of ``lpe_tpu/ops/pm_gravity.py``, which lpe_tpu runs as
XLA (it reaches no Pallas kernel): the far field is

    CIC deposit -> FFT -> multiply by the free-space force kernels -> IFFT
    -> CIC gather

with the kernel rolled off by a quintic smoothstep below ``rc`` and the CIC
window deconvolved, a dense cell-grid particle-particle pass adds the exact
complementary short-range force ``(1 - S(d/rc)) * f(d)`` for pairs within
``rc`` (``make_pp_correction``), and an exact direct sum covers the few
heavy bodies (``make_heavy_direct``). Force law and softening are the
reference's: ``|f| = G*M / (d^2 + soft^2)`` along the separation. Every
function returns the acceleration unscaled by G.

Kept from lpe_tpu: the kernel spectra, built on the host in float64 exactly
as there; the dump slot that takes out-of-grid CIC corners; the PP
occupancy sizing, its first-K per-cell drop and ``overflow_fraction``; the
first ``heavy_cap`` heavy bodies by index. Changed for the GPU:

- the spectra live on the device as ``complex64`` and multiply as complex
  tensors (lpe_tpu ships float32 re/im pairs, a TPU workaround);
- the CIC deposit adds with one ordered scatter-add
  (``core.numerics.scatter_add``) over the four corners in lpe_tpu's
  order: no float atomics, the same bits run to run and at any thread
  count;
- the PP cell sort is stable, so an overflowing cell keeps its first K
  bodies by index (lpe_tpu's ``argsort(stable=False)`` may keep others);
- the PP pass (``pp_pass``) runs over the bodies, not the cells. On
  CUDA it is one launch of a hand-written kernel (``csrc/pp_pass.cu``)
  over a compact cell-sorted layout of the resident bodies
  (``pp_layout``): each resident sums the residents of its (2m+1)^2
  neighbour cells within rc, empty slots and farther pairs skipped. Its
  plain version, for CPU tensors, reads the K slots of those cells from a
  dense table, in Python loops over the offsets and over bands of bodies
  whose ``[bodies, K]`` pair temporaries stay under ``PP_BAND_ELEMS``
  elements. lpe_tpu's dense ``[nc, nc, K, K]`` passes compute the same
  sums for every slot, empty ones too, and its unroll-or-scan switch is
  an XLA compile-time workaround;
- heavy bodies are picked by a stable sort of the mask, with no host read.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.numerics import scatter_add, true_div
from ..parallel import split_runs
from .sph_kernels import KernelOp, _check

# largest [bodies, K] pair temporary of a plain PP pass (128 MB float32)
PP_BAND_ELEMS = 1 << 25
# the PP kernel's blocks: cells of one cell row a block takes, and its
# threads (tuned on an H100 at the 1M galaxy, PERF.md); the shared memory
# a block may have on Hopper
PP_STRIP_CELLS = 8
PP_THREADS = 512
PP_SMEM_MAX = 232448


def _ramp(rc: float, cell: float):
    """Mesh/PP blend window (r0, width) for cutoff rc: the ramp starts at
    min(2 cells, rc/2), where the mesh becomes trustworthy, and spans the
    rest of the way to rc."""
    r0 = min(2.0 * cell, 0.5 * rc)
    return r0, max(rc - r0, 1e-300)


def _smoothstep5(u):
    """C^2 quintic smoothstep: 0 at u<=0, 1 at u>=1 (numpy or torch)."""
    if isinstance(u, np.ndarray):
        u = np.clip(u, 0.0, 1.0)
    else:
        u = torch.clamp(u, 0.0, 1.0)
    return u * u * u * (u * (u * 6.0 - 15.0) + 10.0)


def _spectra(universe: float, G: int, soft: float, cutoff_cells: float):
    """The force kernels' rfft2 on the padded 2G grid (float64, host), as
    lpe_tpu builds them: K(d) = -d / (|d|^2 + soft^2)^{3/2} in wrapped
    offset order, S-rolled off and CIC-deconvolved under P3M."""
    cell = universe / G
    P = 2 * G
    off = np.arange(P)
    off = np.where(off < G, off, off - P).astype(np.float64) * cell
    dx = off[None, :]          # x varies along axis 1
    dy = off[:, None]
    d2 = dx * dx + dy * dy + soft * soft
    inv = 1.0 / np.power(np.maximum(d2, 1e-300), 1.5)
    if cutoff_cells > 0.0:
        rc = cutoff_cells * cell
        r0, rw = _ramp(rc, cell)
        s = _smoothstep5((np.sqrt(dx * dx + dy * dy) - r0) / rw)
        # s == 0 wherever the unclamped-softener kernel can blow up (d < r0
        # covers the origin): kill those entries, so a zero softener cannot
        # give inf * 0 = NaN at the origin sample
        with np.errstate(over="ignore", invalid="ignore"):
            inv = np.where(s > 0.0, inv * s, 0.0)
    kx = np.fft.rfft2(-dx * inv)
    ky = np.fft.rfft2(-dy * inv)
    if cutoff_cells > 0.0:
        # deconvolve the CIC window, applied twice (deposit and gather)
        fy = np.fft.fftfreq(P)[:, None]
        fx = np.fft.rfftfreq(P)[None, :]
        w2 = (np.sinc(fy) * np.sinc(fx)) ** 2     # one CIC pass
        kx /= w2 * w2
        ky /= w2 * w2
    return kx, ky


def make_pm_gravity(universe: float, grid: int, softener: float,
                    cutoff_cells: float = 0.0, *, device):
    """Returns ``accel(pos[N,2], src_mass[N]) -> [N,2]`` (unscaled by G).

    Free-space solve by zero padding to 2G x 2G. Sources outside the
    universe are dropped. With ``cutoff_cells > 0`` the kernel carries only
    the S-smoothed far field; pair it with ``make_pp_correction``. Without,
    the softening is clamped up to one cell (plain PM cannot resolve
    below a cell)."""
    G = int(grid)
    cell = universe / G
    soft = float(softener) if cutoff_cells > 0.0 else max(float(softener),
                                                           cell)
    P = 2 * G
    kx, ky = _spectra(universe, G, soft, cutoff_cells)
    kx = torch.from_numpy(kx.astype(np.complex64)).to(device)
    ky = torch.from_numpy(ky.astype(np.complex64)).to(device)

    def accel(pos, src_mass):
        dtype = pos.dtype
        x = true_div(pos[:, 0], cell) - 0.5
        y = true_div(pos[:, 1], cell) - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx_w = x - x0
        fy_w = y - y0
        ix = x0.to(torch.int64)
        iy = y0.to(torch.int64)
        in_b = (pos[:, 0] >= 0) & (pos[:, 0] < universe) & \
               (pos[:, 1] >= 0) & (pos[:, 1] < universe)
        m = torch.where(in_b, src_mass, torch.zeros_like(src_mass))

        def slot(jx, jy):
            ok = (jx >= 0) & (jx < G) & (jy >= 0) & (jy < G)
            return torch.where(ok, jy * G + jx, G * G)

        corners = [(slot(ix + ddx, iy + ddy), w) for ddx, ddy, w in (
            (0, 0, (1 - fx_w) * (1 - fy_w)), (1, 0, fx_w * (1 - fy_w)),
            (0, 1, (1 - fx_w) * fy_w), (1, 1, fx_w * fy_w))]
        # one ordered scatter-add of the four corners in turn: lpe_tpu's
        # four .at[slot].add() calls, with G*G the dump slot
        rho = torch.zeros((G * G + 1,), dtype=dtype, device=pos.device)
        rho = scatter_add(rho, torch.cat([s for s, _ in corners]),
                          torch.cat([m * w for _, w in corners]))
        pad = torch.zeros((P, P), dtype=dtype, device=pos.device)
        pad[:G, :G] = rho[:G * G].reshape(G, G)
        rho_hat = torch.fft.rfft2(pad)
        zero = torch.zeros((1,), dtype=dtype, device=pos.device)
        out = []
        for k in (kx, ky):
            f_g = torch.fft.irfft2(rho_hat * k, s=(P, P))[:G, :G]
            f_flat = torch.cat([f_g.reshape(-1), zero])
            fp = torch.zeros((pos.shape[0],), dtype=dtype, device=pos.device)
            for s, w in corners:          # CIC gather, the same weights
                fp = fp + f_flat[s] * w
            out.append(fp)
        return torch.stack(out, dim=-1)

    return accel


@dataclass(frozen=True)
class PPGrid:
    """The PP pass's cell grid and constants (``make_pp_correction``):
    ``nc`` cells a side of width ``ccell`` = rc/m, ``m`` the subdivision,
    ``K`` residents a cell, the ramp ``r0``, ``rw``, rc^2 and the softener
    squared, ``band`` bodies a plain pass takes at once, and the devices of
    a split (or None)."""

    nc: int
    m: int
    K: int
    ccell: float
    rc2: float
    r0: float
    rw: float
    s2c: float
    band: int
    devices: tuple | None = None

    @property
    def ncells(self) -> int:
        return self.nc * self.nc

    def cells_of(self, pos):
        """Row-major cell id (gy * nc + gx) of each body, ncells outside."""
        gx = torch.floor(true_div(pos[:, 0], self.ccell)).to(torch.int64)
        gy = torch.floor(true_div(pos[:, 1], self.ccell)).to(torch.int64)
        nc = self.nc
        ok = (gx >= 0) & (gx < nc) & (gy >= 0) & (gy < nc)
        return torch.where(ok, gy * nc + gx, self.ncells)


def pp_layout(pos, src_mass, g: PPGrid):
    """The compact cell-sorted layout that the PP kernel reads: the
    resident bodies (the first K by index of each cell) in cell order,
    ``rows`` [N + 1, 4] float32 (x, y, m, 0) and ``body`` [N + 1] int32
    (each row's body index), and ``cstart`` [ncells + 1] int32, the
    exclusive scan of min(count, K): cell c's residents are rows
    cstart[c] .. cstart[c + 1] - 1. Rows past cstart[ncells] are
    unused (row N takes every body that is not resident). Cell ids are
    row-major, so cells cx-m .. cx+m of one cell row are one contiguous
    run of rows, in (dx, rank) order. No host read.

    The residency is ``pp_pass_plain``'s (a stable sort of the same cell
    ids), in 32-bit integers: the cell ids (at most ncells) sort in
    half the radix passes, each cell's first index comes from a binary
    search of the sorted ids, and the rows are written from the bodies'
    own planes (a gather of 16-byte rows through ``order`` took 0.6 ms at
    1M bodies on an H100)."""
    N = pos.shape[0]
    dev, i32 = pos.device, torch.int32
    sc, order = torch.sort(g.cells_of(pos).to(i32), stable=True)
    start = torch.searchsorted(
        sc, torch.arange(g.ncells + 1, dtype=i32, device=dev), out_int32=True)
    cstart = F.pad(torch.cumsum(torch.clamp(start[1:] - start[:-1], max=g.K),
                                0, dtype=i32), (1, 0))
    rank = torch.arange(N, dtype=i32, device=dev) - start[sc]
    dest = torch.where((sc < g.ncells) & (rank < g.K), cstart[sc] + rank, N)
    body = torch.zeros((N + 1,), dtype=i32, device=dev)
    body = body.index_put_((dest,), order.to(i32))
    dest_p = torch.empty_like(dest).scatter_(0, order, dest)   # by body
    rows = torch.zeros((N + 1, 4), dtype=torch.float32, device=dev)
    rows[:, :2].index_put_((dest_p,), pos.float())
    rows[:, 2].index_put_((dest_p,), src_mass.float())
    return rows, body, cstart


def pp_pass_plain(pos, src_mass, g: PPGrid):
    """The PP pass in plain PyTorch: each resident body reads the K slots
    of its (2m+1)^2 neighbour cells from a dense [(nc+2m)^2, 4, K] table,
    in Python loops over the offsets and over bands of ``g.band`` bodies;
    with ``g.devices`` the bands go to the devices in contiguous runs."""
    N = pos.shape[0]
    dev, dtype = pos.device, pos.dtype
    nc, m, K, ncells = g.nc, g.m, g.K, g.ncells
    W = nc + 2 * m                     # padded grid width
    band = g.band
    x, y = pos[:, 0], pos[:, 1]
    cid = g.cells_of(pos)
    sc, order = torch.sort(cid, stable=True)
    counts = torch.zeros((ncells + 1,), dtype=torch.int64, device=dev)
    counts = counts.scatter_add(0, cid, torch.ones_like(cid))
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N, device=dev) - start[sc]
    valid = (sc < ncells) & (rank < K)
    slot = torch.where(valid, sc * K + rank, ncells * K)
    slot_p = torch.empty_like(slot).scatter_(0, order, slot)
    res = slot_p < ncells * K

    # the planes x, y, m, occupancy as [W*W padded cells, 4, K]; slot
    # ncells*K takes every dropped body and is cut off
    flat = torch.zeros((ncells * K + 1, 4), dtype=dtype, device=dev)
    flat = flat.index_put((slot_p,), torch.stack(
        [x, y, src_mass.to(dtype), torch.ones_like(x)], -1))
    D = flat[:ncells * K].reshape(nc, nc, K, 4).permute(0, 1, 3, 2)
    D = F.pad(D, (0, 0, 0, 0, m, m, m, m)).reshape(W * W, 4, K)
    cell = torch.div(slot_p, K, rounding_mode="floor")
    own = torch.where(res, (cell // nc + m) * W + cell % nc + m,
                      m * W + m)            # a dropped body: any cell
    self_k = torch.arange(K, device=dev)[None, :] == (slot_p % K)[:, None]
    parts = []
    for pdev, run in split_runs(list(range(0, N, band)), g.devices or [dev]):
        # this device's passes, rows [a0, a1): its own copy of the table,
        # its receivers' rows; a pass is the same shape as on one device,
        # so each body's sum keeps its order and its bits
        a0, a1 = run[0], min(N, run[-1] + band)
        Dd = D.to(pdev, non_blocking=True)
        xd, yd, own_d, self_d = (
            t[a0:a1].to(pdev, non_blocking=True)
            for t in (x, y, own, self_k))
        acc = torch.zeros((a1 - a0, 2), dtype=dtype, device=pdev)
        for a in run:
            b = min(a1, a + band)
            i, j = a - a0, b - a0
            xi, yi = xd[i:j, None], yd[i:j, None]
            for dy_ in range(-m, m + 1):
                for dx_ in range(-m, m + 1):
                    nb = Dd[own_d[i:j] + dy_ * W + dx_]  # [bodies, 4, K]
                    ddx = nb[:, 0] - xi                     # j - i
                    ddy = nb[:, 1] - yi
                    d2g = ddx * ddx + ddy * ddy
                    pair = nb[:, 3] > 0
                    if dy_ == 0 and dx_ == 0:           # no self pair
                        pair = pair & ~self_d[i:j]
                    pair = pair & (d2g < g.rc2)
                    w = (1.0 - _smoothstep5((torch.sqrt(d2g) - g.r0) / g.rw)
                         ) / torch.pow(torch.clamp(d2g + g.s2c, min=1e-30),
                                       1.5)
                    w = torch.where(pair, nb[:, 2] * w, torch.zeros_like(w))
                    acc[i:j, 0] += (w * ddx).sum(-1)
                    acc[i:j, 1] += (w * ddy).sum(-1)
        parts.append(acc.to(dev, non_blocking=True))
    acc = torch.cat(parts) if len(parts) > 1 else parts[0]
    return torch.where(res[:, None], acc, torch.zeros_like(acc))


def pp_strip_cells(g: PPGrid) -> int:
    """Cells a block of the kernel takes: ``PP_STRIP_CELLS``, fewer where
    its two staged runs of (T + 2m) * K rows would pass ``PP_SMEM_MAX``."""
    fit = PP_SMEM_MAX // (2 * 16 * g.K) - 2 * g.m
    if fit < 1:
        raise ValueError(f"pp_pass: K={g.K} at m={g.m} does not fit the "
                         f"kernel's shared memory")
    return min(PP_STRIP_CELLS, fit)


def pp_params(g: PPGrid, T: int, s0: int, strips: int, threads: int):
    """The kernel's ``PPParams``: strips s0 .. s0 + strips - 1 of T cells
    (``pp_strip_cells``), ``threads`` a block; the ramp's width as its
    float32 reciprocal, the product PyTorch's ``tensor / rw`` takes on
    CUDA."""
    from . import _build
    inv_rw = float(np.float32(1.0) / np.float32(g.rw))
    return _build.PPParams(g.m, g.nc, g.K, T, s0, strips, threads, g.rc2,
                           g.r0, inv_rw, g.s2c)


def _pp_pass_cuda(pos, src_mass, g: PPGrid):
    from . import _build
    N = pos.shape[0]
    _check("pp_pass pos", pos, (N, 2))
    _check("pp_pass src_mass", src_mass, (N,))
    if N >= 2 ** 31 - 1 or g.m not in (1, 2):
        raise ValueError(f"pp_pass: N={N}, m={g.m}; the kernel takes "
                         f"N < 2^31 - 1 and m 1 or 2")
    T = pp_strip_cells(g)
    strips = g.nc * -(-g.nc // T)
    rows, body, cstart = pp_layout(pos, src_mass, g)
    dev = pos.device
    parts = []
    for pdev, run in split_runs(range(strips), g.devices or [dev]):
        # this device's strips, on its own copy of the layout; the other
        # bodies keep their zeros, so the sum of the parts is exact
        out = torch.zeros((N, 2), dtype=torch.float32, device=pdev)
        _build.call("lpe_pp_pass", *(t.to(pdev, non_blocking=True)
                                     for t in (rows, body, cstart)), out,
                    pp_params(g, T, run[0], len(run), PP_THREADS))
        parts.append(out.to(dev, non_blocking=True))
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# The PP pass: the CUDA kernel (csrc/pp_pass.cu) for CUDA tensors, the
# plain banded loop for CPU tensors; op.pp_pass spans, launches and
# plain_calls count the calls (a pass over a mesh of devices launches the
# kernel on each and counts once)
pp_pass = KernelOp("pp_pass", pp_pass_plain, _pp_pass_cuda)
OPS = (pp_pass,)


def reset_counters():
    for op in OPS:
        op.launches = 0
        op.plain_calls = 0


def make_pp_correction(universe: float, grid: int, softener: float,
                       cutoff_cells: float, max_per_cell: int,
                       n_bodies: int | None = None, devices=None):
    """Short-range particle-particle half of the P3M split (unscaled by G).

    Returns ``correct(pos[N,2], src_mass[N]) -> [N,2]``: the exact softened
    pair force scaled by ``1 - S(d/rc)``, summed over pairs with d < rc,
    rc = cutoff_cells * (universe/grid). Neighbours come from a cell grid
    of cells rc/m wide (m in {1, 2}), over each body's (2m+1)^2 neighbour
    cells, with a deterministic first-K residency per cell: a body past
    its cell's K gets no correction and keeps the smooth mesh force. The
    pass is ``pp_pass``: on CUDA one kernel launch over ``pp_layout``, on
    the CPU the plain banded loop.

    Sizing is lpe_tpu's: with ``n_bodies`` given, K follows the expected
    mean occupancy with 3x headroom; past 64 the grid subdivides (m = 2)
    before K grows, K is floored at ``max_per_cell / m^2`` and capped at
    128. With ``devices`` (a list), the cell table (the kernel's layout) is
    built on the input's device and copied to each of them, and the
    receivers (the plain passes, the kernel's strips of cells) go to them
    in contiguous runs (``parallel.split_runs``); the results come back,
    the bits of one device. The returned function carries
    ``overflow_fraction(pos)`` (the fraction of in-bounds bodies past
    their cell's K; a host read), ``K``, ``subdivision`` (m), ``ncells``,
    ``cells_of``, ``grid`` (the ``PPGrid``) and ``layout(pos, src_mass)``
    (``pp_layout``)."""
    cell = universe / int(grid)
    rc = cutoff_cells * cell
    r0, rw = _ramp(rc, cell)
    K = int(max_per_cell)
    m = 1
    nc = int(math.ceil(universe / rc))
    if n_bodies is not None:
        need = int(math.ceil(3.0 * n_bodies / float(nc * nc)))
        if need > 64:
            m = 2
            nc = int(math.ceil(universe / (rc / m)))
            need = int(math.ceil(3.0 * n_bodies / float(nc * nc)))
        K = min(max(-(-K // (m * m)), need), 128)
    g = PPGrid(nc=nc, m=m, K=K, ccell=rc / m, rc2=rc * rc, r0=r0, rw=rw,
               s2c=float(softener) * float(softener),
               band=max(1, PP_BAND_ELEMS // K),
               devices=tuple(devices) if devices else None)

    def correct(pos, src_mass):
        return pp_pass(pos, src_mass, g)

    def overflow_fraction(pos) -> float:
        """Host diagnostic: the fraction of in-bounds bodies whose cell
        rank is past K (they keep only the rolled-off mesh force)."""
        cid = g.cells_of(pos.double())
        cnt = torch.zeros((g.ncells + 1,), dtype=torch.int64,
                          device=pos.device)
        cnt = cnt.scatter_add(0, cid, torch.ones_like(cid))[:g.ncells]
        n_ok = int((cid < g.ncells).sum())
        if n_ok == 0:
            return 0.0
        return float(torch.clamp(cnt - K, min=0).sum()) / n_ok

    correct.overflow_fraction = overflow_fraction
    correct.cells_of = g.cells_of
    correct.layout = lambda pos, src_mass: pp_layout(pos, src_mass, g)
    correct.grid = g
    correct.K = K
    correct.subdivision = m
    correct.ncells = g.ncells
    return correct


def heavy_indices(heavy_mask, heavy_cap: int):
    """``jnp.nonzero(heavy_mask, size=heavy_cap, fill_value=n)``: the
    first ``heavy_cap`` set entries by index, then n (int64), with no
    host read."""
    n = heavy_mask.shape[0]
    order = torch.argsort((~heavy_mask).to(torch.uint8), stable=True)
    order = order[:heavy_cap]
    hidx = torch.where(heavy_mask[order], order, n)
    if hidx.shape[0] < heavy_cap:
        hidx = F.pad(hidx, (0, heavy_cap - hidx.shape[0]), value=n)
    return hidx


def make_heavy_direct(heavy_cap: int, softener: float):
    """Exact direct force from up to ``heavy_cap`` heavy sources (the first
    by index; unscaled by G): ``accel(pos, mass, heavy_mask) -> [N,2]``."""
    soft2 = softener * softener

    def accel(pos, mass, heavy_mask):
        n = pos.shape[0]
        hidx = heavy_indices(heavy_mask, heavy_cap)
        hvalid = hidx < n
        hi = torch.where(hvalid, hidx, 0)
        hpos = pos[hi]                             # [H,2]
        hm = torch.where(hvalid, mass[hi], torch.zeros_like(mass[hi]))
        dx = hpos[None, :, 0] - pos[:, None, 0]    # [N,H]
        dy = hpos[None, :, 1] - pos[:, None, 1]
        d2 = dx * dx + dy * dy + soft2
        self_pair = torch.arange(n, device=pos.device)[:, None] == hi[None, :]
        w = hm[None, :] / (d2 * torch.sqrt(d2))
        w = torch.where(self_pair, torch.zeros_like(w), w)
        return torch.stack([(w * dx).sum(1), (w * dy).sum(1)], dim=-1)

    return accel
