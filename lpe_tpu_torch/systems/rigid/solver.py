"""Contact solvers of the rigid list pipeline: the velocity LCP and the
Baumgarte position correction, and the warm-start lookup.

The counterpart of ``lpe_tpu/systems/rigid/solver.py``: mass-splitting
projected Jacobi (each body is split across its contacts, so a row's
effective mass uses ``invMass * degree``), staged round-robin (row r in
segment r % NB, the segments applied in turn), 16 velocity and 8
position iterations by default. ``fori_loop`` becomes a Python loop.

lpe_tpu scatters the impulses with ``.at[ia].add(...).at[ib].add(...)``,
which adds them one by one in row order. Here one ordered scatter-add
(``core.numerics.scatter_add``) over the rows' side-A indices followed by
their side-B indices does the same adds, never with float atomics, so two
runs give the same bits at any thread count.
"""
from __future__ import annotations

import torch

from ...core.config import ContactSolverConfig, PositionSolverConfig
from ...core.numerics import scatter_add, true_div
from .geometry import _cross2, _dot2, _unit


def _contact_degree(ia, ib, valid, n_bodies):
    """Contacts per body (each valid row counts for both its bodies), at
    least 1."""
    ones = valid.to(torch.float32)
    d = torch.zeros((n_bodies,), dtype=torch.float32, device=ia.device)
    d = scatter_add(d, torch.cat([ia, ib]), torch.cat([ones, ones]))
    return torch.clamp(d, min=1.0)


def _eff_mass(dirv, ra, rb, im_a, im_b, ii_a, ii_b):
    ra_x = _cross2(ra, dirv)
    rb_x = _cross2(rb, dirv)
    s = im_a + im_b + ra_x * ra_x * ii_a + rb_x * rb_x * ii_b
    return torch.where(s < 1e-12, 0.0,
                       true_div(1.0, torch.clamp(s, min=1e-12)))


def match_warm_impulses(pts, nrm, cpt, cn, cln, clt, pair_ok,
                        tol: float = 1e-3, normal_cos: float = 0.95,
                        slot_fallback: bool = True):
    """Position-matched warm-start lookup (contact_manager.cpp:164-248):
    a pair's cache is dropped when its normal turned past ``normal_cos``;
    each new point takes the impulse of the first cached point within
    ``tol``; with ``slot_fallback`` a point with no match takes its slot's
    cached impulse instead of zero (see lpe_tpu's docstring for why).

    pts [P, C, 2], nrm [P, 2], cpt [P, C, 2], cn [P, 2], cln/clt [P, C],
    pair_ok [P] bool. Returns (ln0, lt0), each [P, C]."""
    ndot = cn[..., 0] * nrm[..., 0] + cn[..., 1] * nrm[..., 1]
    ok = pair_ok & (ndot >= normal_cos)
    d = pts[:, :, None, :] - cpt[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    m = d2 < tol * tol                                   # [P, C, C']
    first = m & (torch.cumsum(m.to(torch.int32), dim=2) == 1)
    matched = m.any(dim=2)
    zero = torch.zeros((), dtype=cln.dtype, device=cln.device)
    ln0 = torch.where(first, cln[:, None, :], zero).sum(dim=2)
    lt0 = torch.where(first, clt[:, None, :], zero).sum(dim=2)
    if slot_fallback:
        ln0 = torch.where(matched, ln0, cln)
        lt0 = torch.where(matched, lt0, clt)
    keep = ok[:, None]
    return torch.where(keep, ln0, zero), torch.where(keep, lt0, zero)


def _pad_rows(NB, rows):
    """The row tensors padded to a multiple of NB rows with lpe_tpu's pad
    values: (name, tensor, pad value) -> list of padded tensors."""
    R = rows[0][1].shape[0]
    padr = -(-R // NB) * NB - R
    if padr == 0:
        return [t for _, t, _ in rows]
    return [torch.cat([t, torch.full((padr,) + t.shape[1:], v, dtype=t.dtype,
                                     device=t.device)])
            for _, t, v in rows]


def solve_velocity(pos, vel, omega, inv_m, inv_i, ia, ib, n, pt, valid,
                   lam_n0, lam_t0, cfg: ContactSolverConfig):
    """Returns (vel, omega, lam_n, lam_t): lpe_tpu's staged projected
    Jacobi (solver.py ``solve_velocity``; its docstring gives the
    scheme). Normal rows bounded [0, inf), friction rows by mu times the
    fresh normal impulse; only approaching contacts (vn <= 0) are warm
    started."""
    S = pos.shape[0]
    R = ia.shape[0]
    NB = max(1, min(int(getattr(cfg, "stages", 1)), R))
    Rp = -(-R // NB) * NB
    ia, ib = ia.long(), ib.long()
    ia, ib, n, pt, valid, lam_n0, lam_t0 = _pad_rows(NB, [
        ("ia", ia, 0), ("ib", ib, 0), ("n", n, 1.0), ("pt", pt, 0.0),
        ("valid", valid, False), ("ln", lam_n0, 0.0), ("lt", lam_t0, 0.0)])

    nrm = _unit(n)
    tan = torch.stack([-nrm[:, 1], nrm[:, 0]], dim=-1)
    ra = pt - pos[ia]
    rb = pt - pos[ib]
    im_a, im_b = inv_m[ia], inv_m[ib]
    ii_a, ii_b = inv_i[ia], inv_i[ib]
    relax = cfg.relaxation
    mu = cfg.friction_coeff
    # friction_stages == 1 under staging: one synchronous Jacobi friction
    # update per iteration, normal rows staged
    fr_jacobi = NB > 1 and int(getattr(cfg, "friction_stages", 0)) == 1
    if fr_jacobi:
        deg_g = _contact_degree(ia, ib, valid, S)

    segs = []
    for s in range(NB):
        g = {k: v[s::NB] for k, v in dict(
            ia=ia, ib=ib, valid=valid, nrm=nrm, tan=tan, ra=ra, rb=rb,
            im_a=im_a, im_b=im_b, ii_a=ii_a, ii_b=ii_b).items()}
        deg = _contact_degree(g["ia"], g["ib"], g["valid"], S)
        dg_a, dg_b = deg[g["ia"]], deg[g["ib"]]
        vs = g["valid"].to(torch.float32)

        def eff(dirv, da, db):
            return _eff_mass(dirv, g["ra"], g["rb"], g["im_a"] * da,
                             g["im_b"] * db, g["ii_a"] * da,
                             g["ii_b"] * db) * vs

        g["eff_n"] = eff(g["nrm"], dg_a, dg_b)
        g["eff_t"] = eff(g["tan"], dg_a, dg_b)
        g["ra_n"], g["ra_t"] = _cross2(g["ra"], g["nrm"]), \
            _cross2(g["ra"], g["tan"])
        g["rb_n"], g["rb_t"] = _cross2(g["rb"], g["nrm"]), \
            _cross2(g["rb"], g["tan"])
        # own-contact normal -> tangent velocity coupling (n.t = 0)
        g["ctn"] = (g["ra_n"] * g["ra_t"] * g["ii_a"]
                    + g["rb_n"] * g["rb_t"] * g["ii_b"])
        if fr_jacobi:
            g["eff_t_g"] = eff(g["tan"], deg_g[g["ia"]], deg_g[g["ib"]])
        g["idx"] = torch.cat([g["ia"], g["ib"]])
        segs.append(g)

    def rel_vel2(u, g):
        ua = u[g["ia"]]
        ub = u[g["ib"]]
        va = ua[:, :2] + torch.stack([-ua[:, 2] * g["ra"][:, 1],
                                      ua[:, 2] * g["ra"][:, 0]], -1)
        vb = ub[:, :2] + torch.stack([-ub[:, 2] * g["rb"][:, 1],
                                      ub[:, 2] * g["rb"][:, 0]], -1)
        rv = vb - va
        return _dot2(rv, g["nrm"]), _dot2(rv, g["tan"])

    def apply2(u, g, dln, dlt):
        imp = g["nrm"] * dln[:, None] + g["tan"] * dlt[:, None]
        da = torch.cat([-imp * g["im_a"][:, None],
                        (-(g["ra_n"] * dln + g["ra_t"] * dlt)
                         * g["ii_a"])[:, None]], dim=1)
        db = torch.cat([imp * g["im_b"][:, None],
                        ((g["rb_n"] * dln + g["rb_t"] * dlt)
                         * g["ii_b"])[:, None]], dim=1)
        return scatter_add(u, g["idx"], torch.cat([da, db]))

    u = torch.cat([vel, omega[:, None]], dim=1)        # [S, 3]
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    lns, lts = [], []
    for s in range(NB):
        g = segs[s]
        vn0, _ = rel_vel2(u, g)
        warm_ok = g["valid"] & (vn0 <= 0.0)
        ln_s = torch.where(warm_ok, lam_n0[s::NB], zero)
        lt_s = torch.where(warm_ok, lam_t0[s::NB], zero)
        u = apply2(u, g, ln_s, lt_s)
        lns.append(ln_s)
        lts.append(lt_s)

    for _ in range(cfg.iterations):
        if fr_jacobi:
            for s in range(NB):
                g = segs[s]
                vn, _ = rel_vel2(u, g)
                new_ln = torch.clamp(lns[s] - g["eff_n"] * vn * relax,
                                     min=0.0)
                dln = torch.where(g["valid"], new_ln - lns[s], zero)
                u = apply2(u, g, dln, torch.zeros_like(dln))
                lns[s] = torch.where(g["valid"], new_ln, lns[s])
            upd = []
            for s in range(NB):
                g = segs[s]
                _, vt = rel_vel2(u, g)
                lim = mu * lns[s]
                new_lt = torch.clamp(lts[s] - g["eff_t_g"] * vt * relax,
                                     -lim, lim)
                upd.append(torch.where(g["valid"], new_lt, lts[s]))
            for s in range(NB):
                g = segs[s]
                dlt = torch.where(g["valid"], upd[s] - lts[s], zero)
                u = apply2(u, g, torch.zeros_like(dlt), dlt)
                lts[s] = upd[s]
            continue
        for s in range(NB):
            g = segs[s]
            ln, lt = lns[s], lts[s]
            vn, vt = rel_vel2(u, g)
            new_ln = torch.clamp(ln - g["eff_n"] * vn * relax, min=0.0)
            dln = torch.where(g["valid"], new_ln - ln, zero)
            lim = mu * new_ln
            vt = vt + dln * g["ctn"]
            new_lt = torch.clamp(lt - g["eff_t"] * vt * relax, -lim, lim)
            dlt = torch.where(g["valid"], new_lt - lt, zero)
            u = apply2(u, g, dln, dlt)
            lns[s] = torch.where(g["valid"], new_ln, ln)
            lts[s] = torch.where(g["valid"], new_lt, lt)

    # reassemble round-robin segments: row r = NB * k + s <- segs[s][k]
    ln = torch.stack(lns, dim=1).reshape(Rp)[:R]
    lt = torch.stack(lts, dim=1).reshape(Rp)[:R]
    return u[:, :2], u[:, 2], ln, lt


def solve_position(pos, angle, inv_m, inv_i, ia, ib, n, pt, pen, valid,
                   cfg: PositionSolverConfig):
    """Baumgarte positional correction (position_solver.cpp:215-290):
    lever arms track the moving bodies, penetration stays frozen; staged
    round-robin like solve_velocity. Returns (pos, angle)."""
    S = pos.shape[0]
    R = ia.shape[0]
    NB = max(1, min(int(getattr(cfg, "stages", 1)), R))
    ia, ib = ia.long(), ib.long()
    ia, ib, n, pt, pen, valid = _pad_rows(NB, [
        ("ia", ia, 0), ("ib", ib, 0), ("n", n, 1.0), ("pt", pt, 0.0),
        ("pen", pen, 0.0), ("valid", valid, False)])
    nrm = _unit(n)
    act = valid & ((pen - cfg.slop) > 0.0)
    corr = cfg.baumgarte * (pen - cfg.slop)

    segs = []
    for s in range(NB):
        a_s = act[s::NB]
        sia, sib = ia[s::NB], ib[s::NB]
        deg = _contact_degree(sia, sib, a_s, S)
        segs.append(dict(
            ia=sia, ib=sib, act=a_s, nrm=nrm[s::NB], pt=pt[s::NB],
            corr=corr[s::NB], im_a=inv_m[sia], im_b=inv_m[sib],
            ii_a=inv_i[sia], ii_b=inv_i[sib], dg_a=deg[sia], dg_b=deg[sib],
            idx=torch.cat([sia, sib])))

    q = torch.cat([pos, angle[:, None]], dim=1)          # [S, 3]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    for _ in range(cfg.iterations):
        for g in segs:
            qa = q[g["ia"]]
            qb = q[g["ib"]]
            ra_x = _cross2(g["pt"] - qa[:, :2], g["nrm"])
            rb_x = _cross2(g["pt"] - qb[:, :2], g["nrm"])
            denom = (g["im_a"] * g["dg_a"] + g["im_b"] * g["dg_b"]
                     + ra_x * ra_x * g["ii_a"] * g["dg_a"]
                     + rb_x * rb_x * g["ii_b"] * g["dg_b"])
            scalar = torch.where(g["act"] & (denom > 1e-12),
                                 g["corr"] / torch.clamp(denom, min=1e-12),
                                 zero)
            d = g["nrm"] * scalar[:, None]
            da = torch.cat([-d * g["im_a"][:, None],
                            (-ra_x * scalar * g["ii_a"])[:, None]], dim=1)
            db = torch.cat([d * g["im_b"][:, None],
                            (rb_x * scalar * g["ii_b"])[:, None]], dim=1)
            q = scatter_add(q, g["idx"], torch.cat([da, db]))
    return q[:, :2], q[:, 2]
