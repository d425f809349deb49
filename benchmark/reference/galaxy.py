"""Plain reference of the galaxy's tick.

It imports nothing of the port. From one tick's input (positions and
velocities; masses from the benchmark's own inputs) it computes the
tick's output as the configuration states it (``configs/galaxy_1m.json``
and upstream's system order): the boundary bounce, the gravity kick, the
drift.

Gravity is P3M, computed afresh here from the inputs:

- sources are the bodies inside the universe of at least
  ``small_mass_threshold``; the first ``heavy_cap`` sources of at least
  ``heavy_threshold`` (by index) act by an exact softened direct sum and
  are kept out of the mesh;
- the mesh: cloud-in-cell deposit on a G x G grid, a free-space FFT
  convolution on the zero-padded 2G grid with the softened force kernel
  rolled off by a quintic smoothstep below the cutoff rc and the CIC
  window deconvolved twice, and the CIC gather;
- the particle-particle correction: the softened pair force times
  ``1 - S(d)`` for pairs closer than rc, among the first K bodies of each
  cell (by index) of a grid of cells rc/m wide, where m and K follow the
  configuration's sizing rule; a body past its cell's K keeps the mesh
  force alone. The cells are found in float32 (``pp_cells``): which body
  a full cell keeps is a discrete decision, which float64 binning would
  take otherwise for bodies within rounding of a cell's edge.

Everything runs in the dtype given: float64 is the reference, bfloat16
(each operation's result rounded to it; the FFT, which has no bfloat16,
in float32 on rounded inputs with its result rounded) is the control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import f32

REAL_G = 6.674e-11
_SPECTRA = {}          # (size, G, soft, cutoff) -> spectra, built once


def _smooth5(u):
    u = u.clamp(0.0, 1.0) if isinstance(u, torch.Tensor) else \
        np.clip(u, 0.0, 1.0)
    return u * u * u * (u * (u * 6.0 - 15.0) + 10.0)


def _ramp(rc, cell):
    r0 = min(2.0 * cell, 0.5 * rc)
    return r0, max(rc - r0, 1e-300)


def spectra(size, G, soft, cutoff_cells):
    """rfft2 of the x and y force kernels on the padded 2G grid (float64,
    numpy): K(d) = -d / (|d|^2 + soft^2)^1.5, rolled off below rc, CIC
    window divided out twice."""
    cell = size / G
    P = 2 * G
    off = np.arange(P)
    off = np.where(off < G, off, off - P).astype(np.float64) * cell
    dx, dy = off[None, :], off[:, None]
    d2 = dx * dx + dy * dy + soft * soft
    inv = 1.0 / np.power(np.maximum(d2, 1e-300), 1.5)
    rc = cutoff_cells * cell
    r0, rw = _ramp(rc, cell)
    s = _smooth5((np.sqrt(dx * dx + dy * dy) - r0) / rw)
    with np.errstate(over="ignore", invalid="ignore"):
        inv = np.where(s > 0.0, inv * s, 0.0)
    kx = np.fft.rfft2(-dx * inv)
    ky = np.fft.rfft2(-dy * inv)
    w2 = (np.sinc(np.fft.fftfreq(P)[:, None])
          * np.sinc(np.fft.rfftfreq(P)[None, :])) ** 2
    return kx / (w2 * w2), ky / (w2 * w2)


def pp_sizing(size, G, cutoff_cells, max_per_cell, n_bodies):
    """(cell width, cells a side, m, K) of the PP grid."""
    rc = cutoff_cells * size / G
    m, K = 1, int(max_per_cell)
    nc = int(math.ceil(size / rc))
    need = int(math.ceil(3.0 * n_bodies / float(nc * nc)))
    if need > 64:
        m = 2
        nc = int(math.ceil(size / (rc / m)))
        need = int(math.ceil(3.0 * n_bodies / float(nc * nc)))
    K = min(max(-(-K // (m * m)), need), 128)
    return rc / m, nc, m, K


def pp_cells(pos, width, nc):
    """Cell index of each position (nc*nc: off the grid). The binning is
    a discrete decision of the configuration's float32: the position and
    the cell width rounded to float32, one correctly rounded division,
    whatever dtype the rest runs in, so that the reference keeps in each
    cell the bodies that the configuration keeps there."""
    p32 = pos.to(torch.float32)
    w32 = torch.tensor(f32(width), dtype=torch.float32, device=pos.device)
    gx = torch.floor(p32[:, 0] / w32).long()       # a tensor divisor: one
    gy = torch.floor(p32[:, 1] / w32).long()       # rounding on the card
    ok = (gx >= 0) & (gx < nc) & (gy >= 0) & (gy < nc)
    return torch.where(ok, gy * nc + gx, torch.full_like(gx, nc * nc))


def _resident(cid, ncells, K):
    """Slot (cell * K + rank) of the first K bodies of each cell by index,
    -1 for the others."""
    order = torch.argsort(cid, stable=True)
    sc = cid[order]
    rank = torch.arange(len(cid), device=cid.device) - \
        torch.searchsorted(sc, sc)
    slot = torch.where((sc < ncells) & (rank < K), sc * K + rank,
                       torch.full_like(sc, -1))
    return torch.empty_like(slot).scatter_(0, order, slot)


def _mesh(pos, mass, size, G, kx, ky, dtype):
    cell = size / G
    P = 2 * G
    x = pos[:, 0] / cell - 0.5
    y = pos[:, 1] / cell - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    ix, iy = x0.long(), y0.long()
    inb = (pos[:, 0] >= 0) & (pos[:, 0] < size) & (pos[:, 1] >= 0) & \
        (pos[:, 1] < size)
    m = torch.where(inb, mass, torch.zeros_like(mass))
    corners = []
    for ddx, ddy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        jx, jy = ix + ddx, iy + ddy
        ok = (jx >= 0) & (jx < G) & (jy >= 0) & (jy < G)
        corners.append((torch.where(ok, jy * G + jx, G * G), w))
    rho = torch.zeros(G * G + 1, dtype=dtype, device=pos.device)
    for s, w in corners:
        rho.index_add_(0, s, m * w)
    fft_t = torch.float64 if dtype == torch.float64 else torch.float32
    pad = torch.zeros((P, P), dtype=fft_t, device=pos.device)
    pad[:G, :G] = rho[:G * G].reshape(G, G).to(fft_t)
    rho_hat = torch.fft.rfft2(pad)
    out = []
    for k in (kx, ky):
        f = torch.fft.irfft2(rho_hat * k, s=(P, P))[:G, :G].to(dtype)
        f = torch.cat([f.reshape(-1), f.new_zeros(1)])
        acc = torch.zeros_like(mass)
        for s, w in corners:
            acc = acc + f[s] * w
        out.append(acc)
    return torch.stack(out, -1)


def _pp(pos, mass, conf, size, n):
    bh = conf["barnes_hut"]
    G = bh["pm_grid"]
    width, nc, m, K = pp_sizing(size, G, bh["p3m_cutoff_cells"],
                                bh["p3m_max_per_cell"], n)
    rc = bh["p3m_cutoff_cells"] * size / G
    r0, rw = _ramp(rc, size / G)
    s2 = conf["gravitational_softener"] ** 2
    dev, dt = pos.device, pos.dtype
    slot = _resident(pp_cells(pos, width, nc), nc * nc, K)
    res = slot >= 0
    Wd = nc + 2 * m
    tab = torch.zeros((nc * nc * K + 1, 4), dtype=dt, device=dev)
    tab[torch.where(res, slot, nc * nc * K)] = torch.stack(
        [pos[:, 0], pos[:, 1], mass, torch.ones_like(mass)], -1)
    tab = tab[:-1].reshape(nc, nc, K, 4)
    tab = torch.nn.functional.pad(tab, (0, 0, 0, 0, m, m, m, m))
    tab = tab.reshape(Wd * Wd, K, 4)
    ridx = torch.nonzero(res).squeeze(1)
    cell = slot[ridx] // K
    own = (cell // nc + m) * Wd + cell % nc + m
    kself = slot[ridx] % K
    acc = torch.zeros((len(ridx), 2), dtype=dt, device=dev)
    band = max(1, (1 << 22) // K)
    kk = torch.arange(K, device=dev)
    for a in range(0, len(ridx), band):
        b = min(len(ridx), a + band)
        xi = pos[ridx[a:b], 0:1]
        yi = pos[ridx[a:b], 1:2]
        for dy in range(-m, m + 1):
            for dx in range(-m, m + 1):
                nb = tab[own[a:b] + dy * Wd + dx]            # [B, K, 4]
                ddx = nb[..., 0] - xi
                ddy = nb[..., 1] - yi
                d2 = ddx * ddx + ddy * ddy
                ok = (nb[..., 3] > 0) & (d2 < rc * rc)
                if dx == 0 and dy == 0:
                    ok = ok & (kk[None, :] != kself[a:b, None])
                w = (1.0 - _smooth5((torch.sqrt(d2) - r0) / rw)) \
                    / torch.clamp(d2 + s2, min=1e-30) ** 1.5
                w = torch.where(ok, nb[..., 2] * w, torch.zeros_like(w))
                acc[a:b, 0] += (w * ddx).sum(-1)
                acc[a:b, 1] += (w * ddy).sum(-1)
    out = torch.zeros_like(pos)
    out[ridx] = acc
    return out


def _heavy(pos, mass, heavy, cap, soft2):
    idx = torch.nonzero(heavy).squeeze(1)[:cap]
    hp, hm = pos[idx], mass[idx]
    dx = hp[None, :, 0] - pos[:, None, 0]
    dy = hp[None, :, 1] - pos[:, None, 1]
    d2 = dx * dx + dy * dy + soft2
    w = hm[None, :] / (d2 * torch.sqrt(d2))
    w = torch.where(torch.arange(len(pos), device=pos.device)[:, None]
                    == idx[None, :], torch.zeros_like(w), w)
    return torch.stack([(w * dx).sum(1), (w * dy).sum(1)], -1)


def gravity(conf, pos, mass, size):
    """Acceleration of every body (each is a receiver)."""
    bh = conf["barnes_hut"]
    dt = pos.dtype
    inb = (pos[:, 0] >= 0) & (pos[:, 0] < size) & (pos[:, 1] >= 0) & \
        (pos[:, 1] < size)
    src = inb & (mass >= bh["small_mass_threshold"])
    heavy = src & (mass >= bh["heavy_threshold"])
    mm = torch.where(src & ~heavy, mass, torch.zeros_like(mass))
    key = (size, bh["pm_grid"], conf["gravitational_softener"],
           bh["p3m_cutoff_cells"])
    if key not in _SPECTRA:
        _SPECTRA[key] = spectra(*key)
    kx, ky = _SPECTRA[key]
    ct = torch.complex128 if dt == torch.float64 else torch.complex64
    kx = torch.from_numpy(kx).to(pos.device, ct)
    ky = torch.from_numpy(ky).to(pos.device, ct)
    a_h = _heavy(pos, mass, heavy, bh["heavy_cap"],
                 conf["gravitational_softener"] ** 2)
    a_m = _mesh(pos, mm, size, bh["pm_grid"], kx, ky, dt)
    # the port sizes the PP cells by its capacity: n rounded up to 128
    a_p = _pp(pos, mm, conf, size, -(-len(pos) // 128) * 128)
    return REAL_G * (a_m + a_h + a_p)


def _boundary(conf, size, mpp, pos, vel):
    """The bounce at the margin, decided in float32 as the dam's
    reference does (``dam_break._boundary``)."""
    bc = conf["boundary"]
    lo = bc["margin_pixels"] * mpp
    lo, hi = f32(lo), f32(size - lo)
    x, y, vx, vy = pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1]
    x32, y32 = x.to(torch.float32), y.to(torch.float32)
    hl, ht = x32 < lo, y32 < lo
    hr, hb = (x32 > hi) & ~hl, (y32 > hi) & ~ht
    vx2 = torch.where(hl, vx.abs() * bc["bounce_damping"],
                      torch.where(hr, -vx.abs() * bc["bounce_damping"], vx))
    vy2 = torch.where(ht, vy.abs() * bc["bounce_damping"],
                      torch.where(hb, -vy.abs() * bc["bounce_damping"], vy))
    sp = torch.sqrt(vx2 * vx2 + vy2 * vy2)
    s = torch.where((hl | hr | ht | hb) & (sp > bc["max_speed"]),
                    bc["max_speed"] / torch.clamp(sp, min=1e-30),
                    torch.ones_like(sp))
    return (torch.stack([x.clamp(lo, hi), y.clamp(lo, hi)], -1),
            torch.stack([vx2 * s, vy2 * s], -1))


def advance(conf, inputs, obs, ticks, dtype=torch.float64, device=None):
    """The output of ``ticks`` ticks from ``obs`` (``scenes.galaxy.
    observe``): pos, vel of the n bodies, and ``kick`` (the velocity
    change of the last tick's gravity) for the check's scale."""
    from benchmark.scenes.galaxy import time_acceleration
    device = device or obs["pos"].device
    n = len(inputs["mass"])
    size, mpp = inputs["size"], inputs["mpp"]
    pos = obs["pos"][:n].to(device, dtype)
    vel = obs["vel"][:n].to(device, dtype)
    mass = torch.as_tensor(inputs["mass"]).to(device, dtype)
    base = 1.0 / conf["ticks_per_second"]
    kick_dt = base * float(obs["dt_scale"])
    move_dt = base * time_acceleration(conf)
    kick = None
    for _ in range(ticks):
        pos, vel = _boundary(conf, size, mpp, pos, vel)
        kick = gravity(conf, pos, mass, size) * kick_dt
        vel = vel + kick
        pos = pos + vel * move_dt
    return dict(pos=pos, vel=vel, kick=kick, step=vel * move_dt)


def gaps(conf, obs_in, obs_out, ref) -> dict:
    """The numbers the output check compares, widest over the bodies:
    the velocity gap over the tick's gravity kick and the position gap
    over the tick's drift (each body's, or the median body's where that
    is larger)."""
    n = ref["pos"].shape[0]
    f = lambda a: a[:n].to(torch.float64)
    kick = f(ref["kick"]).norm(dim=-1)
    step = f(ref["step"]).norm(dim=-1)
    dv = (f(obs_out["vel"]) - f(ref["vel"])).norm(dim=-1)
    dp = (f(obs_out["pos"]) - f(ref["pos"])).norm(dim=-1)
    return dict(
        kick_gap=float((dv / torch.clamp(kick, min=kick.median())).max()),
        drift_gap=float((dp / torch.clamp(step, min=step.median())).max()))
