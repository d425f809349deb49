"""Plain reference of the dam break's block, in particle order.

It imports nothing of the port. From one block's input (positions,
velocities, densities and pressures of the liquid, the walls and masses
from the benchmark's own inputs) it computes the block's output as the
configuration states it (``configs/dam_break_100k.json``):

- at the block's start every particle takes the cell of its position on a
  grid of h-sized cells with a two-cell apron (edge-clamped), and the
  first K of a cell by particle index take its slots; the rest are
  dropped for the block;
- each tick of the block resets the accelerations, runs the sub-steps,
  then the boundary bounce and the uniform gravity kick;
- a sub-step: half kick, drift clamped to 0.45 cells, re-binning to the
  cell of the new position within one cell of the current one, where each
  cell keeps its first K candidates in (dy, dx, slot) order of their
  source cells (the others are dropped); poly6 density over the particles
  of the 3x3 cells, the EOS, spiky pressure and viscosity-Laplacian
  forces; the second kick; the coupling with the wall solids (push-out,
  impulse, fluid back-reaction, PBD velocity fix) for particles of cells
  within a cell of a solid's box, and the floor clamp;
- a dropped particle keeps its values outside the grid, where each tick's
  boundary bounce and gravity still act on it (in particle order), and
  its density and pressure of the block's start.

Every step is elementwise or a sum over pairs or candidates, so the
reference runs in any floating dtype: float64 is the reference; bfloat16
(each operation's result rounded to it) is the control of the output
check. Sums are over pair lists (``index_add_``), in no fixed order.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import f32


def _geometry(conf, size):
    fc = conf["fluid"]
    h = fc["grid"]["smoothing_length"]
    cell = fc["grid"]["cell_size_factor"] * h
    nx = int(math.ceil(size / cell)) + 4
    dt = 1.0 / conf["ticks_per_second"] * conf["time_acceleration"]
    sub_dt = dt / fc["num_sub_steps"]
    return dict(h=h, cell=cell, nx=nx, ny=nx, gmin=-2,
                eps=fc["grid"]["grid_epsilon"], sub_dt=sub_dt,
                half_dt=0.5 * sub_dt, lim=0.45 * cell,
                poly6=4.0 / (math.pi * h ** 8),
                spiky=-30.0 / (math.pi * h ** 5),
                visc_lap=40.0 / (math.pi * h ** 5))


def _cells(x, g, n):
    """Edge-clamped grid cell of coordinate ``x`` (0 .. n-1)."""
    return torch.clamp(torch.floor((x + g["eps"]) / g["cell"]).long()
                       - g["gmin"], 0, n - 1)


def _first_k(key, group, K):
    """Rank of each entry within its ``group`` in ascending ``key`` order
    and the mask of the first K of each group."""
    order = torch.argsort(key, stable=True)
    sg = group[order]
    pos = torch.arange(len(key), device=key.device)
    start = torch.searchsorted(sg, sg)
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    return rank, rank < K


def _pairs(cgx, cgy, nx):
    """(i, j) of every live particle i and live particle j of the 3x3 cells
    around i's cell (i == j included)."""
    cid = cgy * nx + cgx
    order = torch.argsort(cid)
    sc = cid[order]
    n = len(cid)
    ar = torch.arange(n, device=cid.device)
    ii, jj = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ngx, ngy = cgx + dx, cgy + dy
            ok = (ngx >= 0) & (ngx < nx) & (ngy >= 0) & (ngy < nx)
            nid = torch.where(ok, ngy * nx + ngx, torch.full_like(cid, -1))
            lo = torch.searchsorted(sc, nid)
            hi = torch.searchsorted(sc, nid, right=True)
            cnt = hi - lo
            i = torch.repeat_interleave(ar, cnt)
            first = torch.repeat_interleave(lo - torch.cumsum(cnt, 0) + cnt,
                                            cnt)
            ii.append(i)
            jj.append(order[torch.arange(len(i), device=cid.device) + first])
    return torch.cat(ii), torch.cat(jj)


def _walls(inputs, dtype, device):
    """World vertices [4, V, 2] and boxes of the walls (angle 0)."""
    p = torch.as_tensor(inputs["wall_pos"], dtype=torch.float64)
    v = torch.as_tensor(inputs["wall_verts"][:, :4], dtype=torch.float64)
    w = p[:, None, :] + v
    box = torch.stack([w[..., 0].amin(1), w[..., 1].amin(1),
                       w[..., 0].amax(1), w[..., 1].amax(1)], -1)
    return dict(verts=w.to(device, dtype), box=box.to(device, dtype),
                pos=p.to(device, dtype),
                mass=torch.as_tensor(inputs["wall_mass"]).to(device, dtype))


def _couple(conf, g, W, x, y, vx1, vy1, rho, p, m, ax, ay):
    """The coupling of particles with the wall solids (all candidates:
    polygons at rest), then the floor clamp. Returns x, y, vx, vy, ax,
    ay."""
    fc = conf["fluid"]
    ps, im = fc["position_solver"], fc["impulse_solver"]
    rest = fc["rest_density"]
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    where = torch.where
    # per-particle factors
    pos_rho = rho > 0
    dens = where(pos_rho, rho, one * rest)
    vol = where(pos_rho, m / torch.clamp(rho, min=1e-30), m / rest)
    area = vol.abs() ** (2.0 / 3.0)
    depth = torch.clamp(y / im["depth_estimate_scale"], max=1.0)
    parea = (p + dens * fc["gravity"] * depth) * area
    vmul = fc["viscosity"] * im["viscosity_scale"] * dens * g["sub_dt"]
    bmul = im["buoyancy_strength"] * area * fc["gravity"] * dens
    acx = acy = sfx = sfy = zero
    had_pos = had_imp = torch.zeros_like(x, dtype=torch.bool)
    msd, mpen = ps["min_safe_distance"], im["min_penetration"]
    maxF = im["max_force"]
    for k in range(W["verts"].shape[0]):
        box = W["box"][k]
        in_box = (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & \
            (y <= box[3]) & (W["mass"][k] > 0)
        vs = W["verts"][k]
        nv = vs.shape[0]
        parity = torch.zeros_like(x, dtype=torch.int32)
        best = torch.full_like(x, 1e30)
        qxb = torch.zeros_like(x)
        qyb = torch.zeros_like(x)
        for v in range(nv):
            xi, yi = vs[v, 0], vs[v, 1]
            xj, yj = vs[(v - 1) % nv, 0], vs[(v - 1) % nv, 1]
            den = yj - yi
            den = where(den.abs() < 1e-30, one * 1e-30, den)
            lhs = (x - xi) * den
            rhs = (xj - xi) * (y - yi)
            straddle = (yi > y) != (yj > y)
            crosses = straddle & (((den > 0) & (lhs < rhs))
                                  | ((den <= 0) & (lhs > rhs)))
            parity = parity + crosses.to(torch.int32)
            ex = vs[(v + 1) % nv, 0] - xi
            ey = vs[(v + 1) % nv, 1] - yi
            el2 = ex * ex + ey * ey
            t = torch.clamp(((x - xi) * ex + (y - yi) * ey)
                            / torch.clamp(el2, min=1e-16), 0.0, 1.0)
            qx, qy = xi + t * ex, yi + t * ey
            d2 = (x - qx) ** 2 + (y - qy) ** 2
            d2 = where(el2 >= 1e-16, d2, one * 1e30)
            better = d2 < best
            best = where(better, d2, best)
            qxb = where(better, qx, qxb)
            qyb = where(better, qy, qyb)
        inside = in_box & (parity % 2 == 1)
        pdx, pdy = x - qxb, y - qyb
        dist = torch.sqrt(torch.clamp(pdx * pdx + pdy * pdy, min=1e-30))
        d_p = torch.clamp(dist, min=msd)
        dirx = where(dist < msd, one, pdx / d_p)
        diry = where(dist < msd, zero, pdy / d_p)
        pen_p = d_p + ps["safety_margin"]
        acx = acx + where(inside, dirx * pen_p * ps["relax_factor"], zero)
        acy = acy + where(inside, diry * pen_p * ps["relax_factor"], zero)
        # the impulse (a wall at rest: no rigid velocity)
        pen = torch.clamp(dist, min=mpen)
        nrm_x, nrm_y = pdx / pen, pdy / pen
        act = inside & (pen >= mpen)
        depth_f = torch.tanh(im["depth_transition_rate"] * pen
                             / im["depth_scale"])
        vn = vx1 * nrm_x + vy1 * nrm_y
        tvx, tvy = vx1 - nrm_x * vn, vy1 - nrm_y * vn
        pf = torch.clamp(parea * depth_f,
                         max=maxF * im["pressure_force_ratio"])
        fx, fy = nrm_x * pf, nrm_y * pf
        tmag = torch.sqrt(tvx * tvx + tvy * tvy)
        vcap = torch.clamp(vmul * tmag * depth_f,
                           max=maxF * im["viscous_force_ratio"])
        tdir = vcap / torch.clamp(tmag, min=1e-30)
        hast = tmag > im["min_rel_velocity"]
        fx = fx + where(hast, -tvx * tdir, zero)
        fy = fy + where(hast, -tvy * tdir, zero)
        fyb = fy + where(W["mass"][k] > 0.1, -(bmul * pen), zero)
        fy = where(fx * fx + fyb * fyb <= maxF * maxF, fyb, fy)
        f2 = fx * fx + fy * fy
        sc = where(f2 > maxF * maxF,
                   maxF / torch.sqrt(torch.clamp(f2, min=1e-30)), one)
        sfx = sfx + where(act, fx * sc, zero)
        sfy = sfy + where(act, fy * sc, zero)
        had_pos = had_pos | inside
        had_imp = had_imp | act
    # back-reaction, capped push-out, PBD velocity fix, floor clamp
    ffx = -sfx * im["fluid_force_scale"]
    ffy = -sfy * im["fluid_force_scale"]
    fm = torch.sqrt(ffx * ffx + ffy * ffy)
    fsc = where(fm > im["fluid_force_max"],
                im["fluid_force_max"] / torch.clamp(fm, min=1e-30), one)
    inv_m = where(m > 1e-4, 1.0 / m, one)
    ax = where(had_imp, ax + ffx * fsc * inv_m, ax)
    ay = where(had_imp, ay + ffy * fsc * inv_m, ay)
    mag = torch.sqrt(acx * acx + acy * acy)
    scale = where(mag > ps["max_correction"],
                  ps["max_correction"] / torch.clamp(mag, min=1e-30), one)
    nx_, ny_ = x - acx * scale, y - acy * scale
    off = fc["grid"]["boundary_offset"]
    nx_ = where(nx_ < 0, one * off, nx_)
    ny_ = where(ny_ < 0, one * off, ny_)
    ddx, ddy = nx_ - x, ny_ - y
    dmag = torch.sqrt(ddx * ddx + ddy * ddy)
    cdx = ddx / torch.clamp(dmag, min=1e-30)
    cdy = ddy / torch.clamp(dmag, min=1e-30)
    along = vx1 * cdx + vy1 * cdy
    fix = had_pos & (dmag > ps["min_position_change"]) & (along < 0)
    return (nx_, ny_, where(fix, vx1 - along * cdx, vx1),
            where(fix, vy1 - along * cdy, vy1), ax, ay)


def _boundary(conf, size, mpp, x, y, vx, vy):
    """The bounce at the margin. Whether a particle has crossed it is a
    discrete decision of the configuration's float32: its position and
    the margin rounded to float32 are compared, and it is clamped to the
    rounded margin, so that a particle that rests on the margin bounces
    (and has its speed capped) here where it does in float32, whatever
    dtype the rest runs in."""
    bc = conf["boundary"]
    lo = bc["margin_pixels"] * mpp
    lo, hi = f32(lo), f32(size - lo)
    damp, vmax = bc["bounce_damping"], bc["max_speed"]
    x32, y32 = x.to(torch.float32), y.to(torch.float32)
    hl, hr = x32 < lo, x32 > hi
    hr = hr & ~hl
    ht, hb = y32 < lo, y32 > hi
    hb = hb & ~ht
    x2, y2 = torch.clamp(x, lo, hi), torch.clamp(y, lo, hi)
    vx2 = torch.where(hl, vx.abs() * damp, torch.where(hr, -vx.abs() * damp,
                                                        vx))
    vy2 = torch.where(ht, vy.abs() * damp, torch.where(hb, -vy.abs() * damp,
                                                        vy))
    sp = torch.sqrt(vx2 * vx2 + vy2 * vy2)
    b = hl | hr | ht | hb
    s = torch.where(b & (sp > vmax), vmax / torch.clamp(sp, min=1e-30),
                    torch.ones_like(sp))
    return x2, y2, vx2 * s, vy2 * s


def advance(conf, inputs, obs, ticks, dtype=torch.float64, device=None):
    """The block's output from its input ``obs`` (``scenes.dam_break.
    observe``): a dict of pos, vel, density, pressure."""
    device = device or obs["pos"].device
    t = lambda a: a.to(device=device, dtype=dtype)
    fc = conf["fluid"]
    size, mpp = inputs["size"], inputs["mpp"]
    g = _geometry(conf, size)
    K = min(fc["grid"]["max_per_cell"], obs["pos"].shape[0])
    nx = g["nx"]
    W = _walls(inputs, dtype, device)
    m = t(torch.as_tensor(inputs["liquid_mass"]))
    x, y = t(obs["pos"][:, 0]), t(obs["pos"][:, 1])
    vx, vy = t(obs["vel"][:, 0]), t(obs["vel"][:, 1])
    # particle-order copies: what a dropped particle keeps
    px, py, pvx, pvy = x, y, vx, vy
    n = len(x)
    idx = torch.arange(n, device=device)
    cgx, cgy = _cells(x, g, nx), _cells(y, g, nx)
    slot, live = _first_k(cgy * nx + cgx, cgy * nx + cgx, K)
    # grid state: the live particles, by index into the arrays
    L = idx[live]
    gx, gy, gvx, gvy = x[L], y[L], vx[L], vy[L]
    gcx, gcy, gslot = cgx[L], cgy[L], slot[L]
    rho = prs = None
    kgrav = conf["gravity"]["gravitational_acceleration"] * \
        (1.0 / conf["ticks_per_second"]) * float(obs["dt_scale"])
    stiff, rest = fc["stiffness"], fc["rest_density"]
    nm = fc["numerical"]
    zero = torch.zeros((), dtype=dtype, device=device)
    for _ in range(ticks):
        gax = torch.zeros_like(gx)
        gay = torch.zeros_like(gx)
        for _ in range(fc["num_sub_steps"]):
            hx = gvx + g["half_dt"] * gax
            hy = gvy + g["half_dt"] * gay
            x1 = gx + torch.clamp(hx * g["sub_dt"], -g["lim"], g["lim"])
            y1 = gy + torch.clamp(hy * g["sub_dt"], -g["lim"], g["lim"])
            tgx = torch.minimum(torch.maximum(_cells(x1, g, nx), gcx - 1),
                                gcx + 1)
            tgy = torch.minimum(torch.maximum(_cells(y1, g, nx), gcy - 1),
                                gcy + 1)
            tcell = tgy * nx + tgx
            off = (gcy - tgy + 1) * 3 + (gcx - tgx + 1)
            rank, keep = _first_k((tcell * 9 + off) * K + gslot, tcell, K)
            L, gslot = L[keep], rank[keep]
            gcx, gcy = tgx[keep], tgy[keep]
            x1, y1, hx, hy = x1[keep], y1[keep], hx[keep], hy[keep]
            v0x, v0y = gvx[keep], gvy[keep]
            ml = m[L]
            i, j = _pairs(gcx, gcy, nx)
            dx, dy = x1[i] - x1[j], y1[i] - y1[j]
            r2 = dx * dx + dy * dy
            h2 = g["h"] * g["h"]
            w = torch.where(r2 < h2, g["poly6"] * (h2 - r2) ** 3, zero)
            rho = torch.zeros_like(x1).index_add_(0, i, ml[j] * w)
            prs = torch.clamp(stiff * (rho - rest), min=0.0)
            ok = (i != j) & (r2 >= nm["min_distance_threshold"]) & \
                (r2 < h2) & (rho[i] >= nm["min_density_threshold"]) & \
                (rho[j] >= nm["min_density_threshold"])
            rr = torch.sqrt(torch.clamp(r2, min=1e-30))
            term = prs[i] / torch.clamp(rho[i] * rho[i], min=1e-30) + \
                prs[j] / torch.clamp(rho[j] * rho[j], min=1e-30)
            hr = g["h"] - rr
            fp = -ml[j] * term * (g["spiky"] * hr * hr)
            fv = fc["viscosity"] * ml[j] * (g["visc_lap"] * hr
                                            / torch.clamp(rho[j], min=1e-30))
            fx = torch.where(ok, fp * dx / rr - fv * (v0x[i] - v0x[j]), zero)
            fy = torch.where(ok, fp * dy / rr - fv * (v0y[i] - v0y[j]), zero)
            fx = torch.zeros_like(x1).index_add_(0, i, fx)
            fy = torch.zeros_like(x1).index_add_(0, i, fy)
            vx1 = hx + g["half_dt"] * fx
            vy1 = hy + g["half_dt"] * fy
            # cells within a cell of a solid's box couple (the extent of
            # cell (gx, gy): x in [(gx-3)c, (gx+1)c], y in [(gy-3)c, gy c])
            cx0 = (gcx - 3).to(dtype) * g["cell"]
            cy0 = (gcy - 3).to(dtype) * g["cell"]
            bx = W["box"]
            near = ((bx[None, :, 0] <= cx0[:, None] + 4 * g["cell"])
                    & (bx[None, :, 2] >= cx0[:, None])
                    & (bx[None, :, 1] <= cy0[:, None] + 3 * g["cell"])
                    & (bx[None, :, 3] >= cy0[:, None])).any(1)
            out = _couple(conf, g, W, x1, y1, vx1, vy1, rho, prs, ml, fx, fy)
            off_ = fc["grid"]["boundary_offset"]
            plain = (torch.where(x1 < 0, zero + off_, x1),
                     torch.where(y1 < 0, zero + off_, y1), vx1, vy1, fx, fy)
            gx, gy, gvx, gvy, gax, gay = (torch.where(near, a, b)
                                          for a, b in zip(out, plain))
        # boundary and gravity: the grid's particles and, in particle
        # order, every particle's copy (a dropped one keeps it)
        gx, gy, gvx, gvy = _boundary(conf, size, mpp, gx, gy, gvx, gvy)
        gvy = gvy + kgrav
        px, py, pvx, pvy = _boundary(conf, size, mpp, px, py, pvx, pvy)
        pvy = pvy + kgrav
    out_pos = torch.stack([px, py], -1)
    out_vel = torch.stack([pvx, pvy], -1)
    den = t(obs["density"]).clone()
    pre = t(obs["pressure"]).clone()
    out_pos[L] = torch.stack([gx, gy], -1)
    out_vel[L] = torch.stack([gvx, gvy], -1)
    if rho is not None:
        den[L] = rho
        pre[L] = torch.clamp(stiff * (rho - rest), min=0.0)
    return dict(pos=out_pos, vel=out_vel, density=den, pressure=pre)


def gaps(conf, obs_in, obs_out, ref) -> dict:
    """The numbers the output check compares: the upper quartile and the
    99th percentile over the particles of the program's gap from the
    reference (float64) in position (m), velocity (m/s) and density (over
    the reference's largest).

    Quantiles and not the widest gap: the dam's flow amplifies rounding
    (boundary bounces with their speed cap, K drops, the walk, the push
    of neighbours on the margin) into centimetres on a few hundredths of
    the particles in a block, at float32 as at float64, while a fault of
    the tick, of a quarter of the particles, or of more than a hundredth
    of them by more than that moves one of these numbers."""
    f = lambda a: a.to(torch.float64)

    def q(v, p):
        return float(torch.quantile(v, p))

    dp = (f(obs_out["pos"]) - f(ref["pos"])).norm(dim=-1)
    dv = (f(obs_out["vel"]) - f(ref["vel"])).norm(dim=-1)
    dr = (f(obs_out["density"]) - f(ref["density"])).abs() / float(
        f(ref["density"]).abs().max().clamp(min=1e-30))
    return dict(pos_gap=q(dp, 0.75), vel_gap=q(dv, 0.75),
                rho_gap=q(dr, 0.75), pos_gap_p99=q(dp, 0.99),
                vel_gap_p99=q(dv, 0.99), rho_gap_p99=q(dr, 0.99))
