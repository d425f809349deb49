"""Batched collision geometry: support functions, GJK, EPA, SAT and
contact clipping.

The counterpart of ``lpe_tpu/systems/rigid/geometry.py``. The JAX
functions handle one pair and are ``vmap``-ed over rows; here every
function takes a batch of rows, so the row axis is written out as the
leading dimension. A shape is a dict of per-row tensors: ``pos`` [N, 2],
``angle`` [N], ``verts`` [N, V, 2] (local, CCW), ``nverts`` [N] and
``vmask`` [N, V]; a shape that may be a circle also has ``is_circle``
[N] and ``radius`` [N] (without them every row is a polygon).

- ``gjk`` and ``epa`` keep lpe_tpu's fixed iteration counts and masks:
  ``fori_loop`` becomes a Python loop over fixed-shape tensors, and a row
  that has finished keeps its values under a mask, as there.
- A first-match select (``_select_row``, ``_first_row``) gathers the
  row that lpe_tpu's masked sum picks: the first of equal maxima or
  minima (``argmax`` and ``argmin`` return the first).
- Sums over a vertex ring run in ring order, as ``csrc/narrowphase.cu``
  runs them, so the kernel and this plain version round alike.
"""
from __future__ import annotations

import math

import torch

from ...core.constants import EPSILON
from ...core.numerics import sqrt

GJK_ITERS_DEFAULT = 32
EPA_ITERS_DEFAULT = 24
NEG = -1e30
CIRCLE_SAMPLES = 8        # a circle clips as an 8-gon (narrowphase.cpp:56-67)


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _unit(v):
    """``v / max(|v|, 1e-30)`` along the last axis (length 2)."""
    ln = sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
    return v / torch.clamp(ln, min=1e-30).unsqueeze(-1)


def _select_row(rows, mask):
    """``rows[n, i]`` at the first ``i`` with ``mask[n, i]`` (geometry.py
    ``_select_row``'s first-match semantics); zeros where no ``i`` is set.
    rows [N, M, ...], mask [N, M] -> [N, ...]."""
    first = mask & (torch.cumsum(mask.to(torch.int32), dim=1) == 1)
    i = first.to(torch.int32).argmax(dim=1)
    i = i.view((-1, 1) + (1,) * (rows.dim() - 2))
    out = rows.gather(1, i.expand((rows.shape[0], 1) + rows.shape[2:]))
    out = out.squeeze(1)
    hit = first.any(dim=1).view((-1,) + (1,) * (out.dim() - 1))
    return torch.where(hit, out, torch.zeros_like(out))


def _poly_world(shape):
    c = torch.cos(shape["angle"])[:, None]
    s = torch.sin(shape["angle"])[:, None]
    v = shape["verts"]
    rot = torch.stack([v[..., 0] * c - v[..., 1] * s,
                       v[..., 0] * s + v[..., 1] * c], dim=-1)
    return shape["pos"][:, None, :] + rot


def world_verts(shape):
    """World-space vertex ring of each row (``pos + R(angle) v``), with its
    validity mask and count; a circle row is sampled as an 8-gon offset by
    the body angle (geometry.py ``world_verts``, narrowphase.cpp:52-79)."""
    w_poly = _poly_world(shape)
    if "is_circle" not in shape:
        return w_poly, shape["vmask"], shape["nverts"]
    V = w_poly.shape[1]
    k = torch.arange(V, device=w_poly.device)
    ang = k.to(w_poly.dtype) * (2.0 * math.pi / CIRCLE_SAMPLES) \
        + shape["angle"][:, None]
    w_circ = shape["pos"][:, None, :] + shape["radius"][:, None, None] * \
        torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    cir = shape["is_circle"]
    verts = torch.where(cir[:, None, None], w_circ, w_poly)
    mask = torch.where(cir[:, None], (k < CIRCLE_SAMPLES)[None, :],
                       shape["vmask"])
    count = torch.where(cir, CIRCLE_SAMPLES, shape["nverts"])
    return verts, mask, count


def _ring_next(w, count):
    """The next vertex of each ring vertex, wrapping at ``count``."""
    V = w.shape[1]
    last = torch.arange(V, device=w.device)[None, :] == (count[:, None] - 1)
    return torch.where(last[..., None], w[:, :1], torch.roll(w, -1, dims=1))


def _outward_face_normals(w, mask, count):
    """Unit outward face normals of masked vertex rings, oriented off the
    centroid (CW and CCW rings both work). Returns (normals, next, edge)."""
    nxt = _ring_next(w, count)
    e = nxt - w
    n = _unit(torch.stack([e[..., 1], -e[..., 0]], dim=-1))
    zero = torch.zeros_like(w[:, 0])
    cen = zero
    for v in range(w.shape[1]):                  # ring order
        cen = cen + torch.where(mask[:, v, None], w[:, v], zero)
    cnt = torch.clamp(mask.sum(dim=1), min=1).to(w.dtype)
    cen = cen / cnt[:, None]
    flip = (_dot2(n, w - cen[:, None, :]) < 0)[..., None]
    return torch.where(flip, -n, n), nxt, e


def _sat_poly_poly(wa, ma, na, wb, mb, nb):
    """Minimum-translation axis of two convex polygon rings over both
    face-normal sets (first minimum). Normal points A -> B."""
    fa, _, _ = _outward_face_normals(wa, ma, na)
    fb, _, _ = _outward_face_normals(wb, mb, nb)
    dirs = torch.cat([fa, -fb], dim=1)                      # [N, 2V, 2]
    vmask = torch.cat([ma, mb], dim=1)
    inf = torch.full((), float("inf"), dtype=wa.dtype, device=wa.device)
    pa = _dot2(wa[:, None, :, :], dirs[:, :, None, :])     # [N, 2V, V]
    pb = _dot2(wb[:, None, :, :], dirs[:, :, None, :])
    amax = torch.where(ma[:, None, :], pa, -inf).amax(dim=2)
    bmin = torch.where(mb[:, None, :], pb, inf).amin(dim=2)
    pens = torch.where(vmask, amax - bmin, inf)
    hit = (pens > 0.0).all(dim=1) & vmask.any(dim=1)
    pmin = pens.amin(dim=1)
    normal = _select_row(dirs, pens == pmin[:, None])
    return hit, normal, torch.clamp(pmin, min=0.0)


def _first_row(rows, i):
    """``rows[n, i[n]]``: rows [N, M, ...], i [N] int -> [N, ...]."""
    idx = i.view((-1, 1) + (1,) * (rows.dim() - 2))
    return rows.gather(1, idx.expand((rows.shape[0], 1) + rows.shape[2:])) \
        .squeeze(1)


def _perp(v):
    """(v_y, -v_x): rot90-right of the vectors v [..., 2]."""
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


# ---------------------------------------------------------------------------
# support functions, GJK, EPA
# ---------------------------------------------------------------------------

def support_shape(shape, d, w=None):
    """Furthest point of each row's shape in direction ``d`` [N, 2]
    (include/math/polygon.hpp:55-141): the exact circle for a circle row,
    the first vertex of greatest projection for a polygon. ``w``: the
    rows' polygon world vertices, if the caller has them already."""
    if w is None:
        w = _poly_world(shape)
    proj = torch.where(shape["vmask"], _dot2(w, d[:, None, :]),
                       torch.full((), NEG, dtype=w.dtype, device=w.device))
    p_poly = _first_row(w, proj.argmax(dim=1))
    if "is_circle" not in shape:
        return p_poly
    dlen = sqrt(_dot2(d, d))
    dn = d / torch.clamp(dlen, min=1e-9)[:, None]
    p_circle = shape["pos"] + dn * shape["radius"][:, None]
    return torch.where(shape["is_circle"][:, None], p_circle, p_poly)


def support_minkowski(sa, sb, d, wa=None, wb=None):
    """A - B support (include/math/polygon.hpp:124-141)."""
    return support_shape(sa, d, wa) - support_shape(sb, -d, wb)


def gjk(sa, sb, iters: int = GJK_ITERS_DEFAULT):
    """Boolean intersection of each row's pair: (hit [N], simplex [N, 3,
    2]). lpe_tpu's masked fixed-iteration loop (gjk.cpp:71-133) with the
    same simplex case analysis (gjk.cpp:9-69); a row that hit or missed
    keeps its values."""
    wa, wb = _poly_world(sa), _poly_world(sb)
    N = wa.shape[0]
    dev, dt = wa.device, wa.dtype
    d0 = torch.zeros((N, 2), dtype=dt, device=dev)
    d0[:, 0] = 1.0
    s0 = support_minkowski(sa, sb, d0, wa, wb)
    simplex = torch.zeros((N, 3, 2), dtype=dt, device=dev)
    simplex[:, 0] = s0
    count = torch.ones((N,), dtype=torch.int32, device=dev)
    d = -s0
    hit = torch.zeros((N,), dtype=torch.bool, device=dev)
    miss = _dot2(s0, d0) < 0
    idx = torch.arange(3, device=dev)
    for _ in range(iters):
        active = ~hit & ~miss
        p = support_minkowski(sa, sb, d, wa, wb)
        new_miss = _dot2(p, d) < 0
        sx = torch.where((idx[None, :] == count[:, None])[..., None],
                         p[:, None, :], simplex)
        # two points [b, a], a the newest
        a2, b2 = sx[:, 1], sx[:, 0]
        ab2, ao2 = b2 - a2, -a2
        perp2 = -_perp(ab2)
        perp2 = torch.where((_dot2(perp2, ao2) < 0)[:, None], _perp(ab2),
                            perp2)
        toward = _dot2(ab2, ao2) > 0
        d_c2 = torch.where(toward[:, None], perp2, ao2)
        sx_c2 = torch.where(toward[:, None, None], sx,
                            torch.stack([a2, sx[:, 1], sx[:, 2]], dim=1))
        cnt_c2 = torch.where(toward, 2, 1).to(torch.int32)
        # three points [c, b, a], a the newest
        a3, b3, c3 = sx[:, 2], sx[:, 1], sx[:, 0]
        ab, ac, ao = b3 - a3, c3 - a3, -a3
        ab_p = _perp(ab)
        ab_p = torch.where((_dot2(ab_p, ac) > 0)[:, None], -ab_p, ab_p)
        ac_p = _perp(ac)
        ac_p = torch.where((_dot2(ac_p, ab) > 0)[:, None], -ac_p, ac_p)
        out_ab = (_dot2(ab, ao) > 0) & (_dot2(ab_p, ao) > 0)
        out_ac = ~out_ab & (_dot2(ac, ao) > 0) & (_dot2(ac_p, ao) > 0)
        inside = ~out_ab & ~out_ac
        # out_ab: drop c -> [b, a]; out_ac: drop b -> [c, a]
        sx_c3 = torch.where(
            out_ab[:, None, None], torch.stack([b3, a3, sx[:, 2]], dim=1),
            torch.where(out_ac[:, None, None],
                        torch.stack([c3, a3, sx[:, 2]], dim=1), sx))
        d_c3 = torch.where(out_ab[:, None], ab_p,
                           torch.where(out_ac[:, None], ac_p, d))
        cnt_c3 = torch.where(inside, 3, 2).to(torch.int32)
        is3 = count + 1 == 3
        upd = active & ~new_miss
        simplex = torch.where(upd[:, None, None],
                              torch.where(is3[:, None, None], sx_c3, sx_c2),
                              simplex)
        count = torch.where(upd, torch.where(is3, cnt_c3, cnt_c2), count)
        d = torch.where(upd[:, None], torch.where(is3[:, None], d_c3, d_c2),
                        d)
        hit = torch.where(upd, is3 & inside, hit)
        miss = miss | (active & new_miss)
    # iteration-cap exhaustion counts as "no collision" (gjk.cpp:98-103)
    return hit & ~miss, simplex


def epa(sa, sb, simplex, iters: int = EPA_ITERS_DEFAULT):
    """Penetration normal and depth of each row from its touching simplex:
    (valid [N], normal [N, 2], penetration [N]). lpe_tpu's fixed-capacity
    polytope with masked insertion after the closest edge, keeping the
    least support distance seen and its normal (epa.cpp:31-119)."""
    wa, wb = _poly_world(sa), _poly_world(sb)
    N = simplex.shape[0]
    dev, dt = simplex.device, simplex.dtype
    cap = 3 + iters + 1
    crossv = _cross2(simplex[:, 1] - simplex[:, 0],
                     simplex[:, 2] - simplex[:, 0])
    degenerate = torch.abs(crossv) < 1e-14
    tri = torch.where((crossv < 0)[:, None, None], simplex.flip(1), simplex)
    poly = torch.zeros((N, cap, 2), dtype=dt, device=dev)
    poly[:, :3] = tri
    count = torch.full((N,), 3, dtype=torch.int32, device=dev)
    done = degenerate
    started = torch.zeros((N,), dtype=torch.bool, device=dev)
    normal = torch.zeros((N, 2), dtype=dt, device=dev)
    normal[:, 0] = 1.0
    pen = torch.full((N,), float("inf"), dtype=dt, device=dev)
    idx = torch.arange(cap, device=dev)[None, :]
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    # the dtype's noise floor (geometry.py: the reference's 1e-9 is
    # unreachable in float32 on smooth boundaries)
    eps = max(EPSILON, 32 * float(torch.finfo(dt).eps))
    for _ in range(iters):
        active = ~done
        last = (idx == (count[:, None] - 1))[..., None]
        nxt = torch.where(last, poly[:, :1], torch.roll(poly, -1, dims=1))
        n = _unit(_perp(nxt - poly))
        dist = _dot2(n, poly)
        n = torch.where((dist < 0)[..., None], -n, n)
        dist = torch.where(idx < count[:, None], torch.abs(dist), inf)
        j = dist.argmin(dim=1)
        closest = _first_row(dist[..., None], j).squeeze(1)
        en = _first_row(n, j)
        sp = support_minkowski(sa, sb, en, wa, wb)
        dsp = _dot2(sp, en)
        converged = (dsp - closest) < eps * torch.clamp(dsp, min=1.0)
        # insert sp at k = (j + 1) % count
        k = torch.where(j + 1 >= count, 0, j + 1)[:, None]
        shifted = torch.where((idx < k)[..., None], poly,
                              torch.where((idx == k)[..., None],
                                          sp[:, None, :],
                                          torch.roll(poly, 1, dims=1)))
        cap_hit = count >= cap
        grow = active & ~converged & ~cap_hit
        better = active & (dsp < pen)
        poly = torch.where(grow[:, None, None], shifted, poly)
        count = torch.where(grow, count + 1, count)
        done = done | (active & (converged | cap_hit))
        started = started | active
        normal = torch.where(better[:, None], en, normal)
        pen = torch.where(better, dsp, pen)
    pen = torch.where(torch.isfinite(pen), pen, 0.0)
    return started & ~degenerate, normal, pen


# ---------------------------------------------------------------------------
# SAT (closed form)
# ---------------------------------------------------------------------------

def _proj_minmax(d, w, mask):
    """(min, max) over each ring's valid vertices of their projections on
    d: d [N, 2], w [N, V, 2], mask [N, V]."""
    p = _dot2(w, d[:, None, :])
    inf = torch.full((), float("inf"), dtype=w.dtype, device=w.device)
    return (torch.where(mask, p, inf).amin(dim=1),
            torch.where(mask, p, -inf).amax(dim=1))


def _sat_circle_poly(circ, poly):
    """Circle rows ``circ`` against polygon rows ``poly``, closed form:
    (hit, normal pointing poly -> circle, penetration)."""
    wv, wm, wc = world_verts(poly)
    fn, _, e = _outward_face_normals(wv, wm, wc)
    c = circ["pos"][:, None, :]
    r = circ["radius"]
    inf = torch.full((), float("inf"), dtype=wv.dtype, device=wv.device)
    d_face = torch.where(wm, _dot2(fn, c - wv), -inf)
    inside = (d_face <= 0.0).all(dim=1)
    i_in = d_face.argmax(dim=1)                   # the deepest face
    n_in = _first_row(fn, i_in)
    pen_in = r - _first_row(d_face[..., None], i_in).squeeze(1)
    ee = torch.clamp(_dot2(e, e), min=1e-30)
    t = torch.clamp(_dot2(c - wv, e) / ee, 0.0, 1.0)
    q = wv + e * t[..., None]
    dq = c - q
    dq2 = torch.where(wm, _dot2(dq, dq), inf)
    i_out = dq2.argmin(dim=1)                     # the closest edge point
    qbest = _first_row(q, i_out)
    dist = sqrt(torch.clamp(_first_row(dq2[..., None], i_out).squeeze(1),
                            min=0.0))
    n_out = (circ["pos"] - qbest) / torch.clamp(dist, min=1e-12)[:, None]
    n_out = torch.where((dist > 1e-12)[:, None], n_out, n_in)
    hit = inside | (dist < r)
    normal = torch.where(inside[:, None], n_in, n_out)
    pen = torch.where(inside, pen_in, r - dist)
    return hit & wm.any(dim=1), normal, torch.clamp(pen, min=0.0)


def sat_contact(sa, sb, any_circle: bool = True):
    """(hit [N], normal [N, 2], penetration [N]), closed form; the normal
    points A -> B. Polygons take the separating-axis MTV, circles their
    analytic cases (geometry.py ``sat_contact``). ``any_circle=False``
    leaves the circle branches out."""
    hit, normal, pen = _sat_poly_poly(*world_verts(sa), *world_verts(sb))
    if not any_circle:
        return hit, normal, pen
    a_cir, b_cir = sa["is_circle"], sb["is_circle"]
    dcc = sb["pos"] - sa["pos"]
    dlen = sqrt(_dot2(dcc, dcc))
    rsum = sa["radius"] + sb["radius"]
    ncc = _circle_normal(dcc, dlen)
    hit_ab, n_ab, p_ab = _sat_circle_poly(sa, sb)     # A circle, B poly
    hit_ba, n_ba, p_ba = _sat_circle_poly(sb, sa)     # A poly, B circle
    both = a_cir & b_cir
    hit = torch.where(both, dlen < rsum, torch.where(
        a_cir, hit_ab, torch.where(b_cir, hit_ba, hit)))
    normal = torch.where(both[:, None], ncc, torch.where(
        a_cir[:, None], -n_ab, torch.where(b_cir[:, None], n_ba, normal)))
    pen = torch.where(both, rsum - dlen, torch.where(
        a_cir, p_ab, torch.where(b_cir, p_ba, pen)))
    return hit, normal, torch.clamp(pen, min=0.0)


def _circle_normal(dcc, dlen):
    """Unit centre-to-centre normal, (1, 0) for coincident centres."""
    ncc = dcc / torch.clamp(dlen, min=1e-12)[:, None]
    x = torch.zeros_like(ncc)
    x[:, 0] = 1.0
    return torch.where((dlen > 1e-12)[:, None], ncc, x)


def _best_face(verts, mask, count, normal):
    """Face whose raw CCW normal (rot90-left of the edge) best aligns with
    ``normal`` (first maximum): its endpoints and unit normal."""
    nxt = _ring_next(verts, count)
    e = nxt - verts
    fn = _unit(torch.stack([-e[..., 1], e[..., 0]], dim=-1))
    d = torch.where(mask, _dot2(fn, normal[:, None, :]),
                    torch.full((), NEG, dtype=verts.dtype,
                               device=verts.device))
    best = d == d.amax(dim=1, keepdim=True)
    return (_select_row(verts, best), _select_row(nxt, best),
            _select_row(fn, best))


def polygon_contacts(sa, sb, normal, max_contacts: int):
    """Poly-poly manifold by reference-face / incident-edge clipping
    (geometry.py ``polygon_contacts``): A's best face is the reference,
    B's face most anti-parallel to it is clipped against the two side
    planes, and the <=2 points at or below the face come deepest first.
    Returns (points [N, C, 2], penetrations [N, C], valid [N, C])."""
    av, am, ac = world_verts(sa)
    bv, bm, bc = world_verts(sb)
    v1, v2, ref_n = _best_face(av, am, ac, normal)
    face_off = _dot2(ref_n, v1)
    edge = _unit(v2 - v1)
    p1, p2, _ = _best_face(bv, bm, bc, -ref_n)
    ok1 = ok2 = torch.ones_like(face_off, dtype=torch.bool)
    tiny = torch.full((), 1e-30, dtype=face_off.dtype, device=face_off.device)
    for pn, po in ((edge, _dot2(edge, v2)), (-edge, _dot2(-edge, v1))):
        d1 = _dot2(pn, p1) - po
        d2 = _dot2(pn, p2) - po
        dd = d1 - d2
        t = d1 / torch.where(torch.abs(dd) < 1e-30, tiny, dd)
        inter = p1 + (p2 - p1) * t[:, None]
        both_out = (d1 > 0.0) & (d2 > 0.0)
        ok1 = ok1 & ~both_out
        ok2 = ok2 & ~both_out
        p1 = torch.where(((d1 > 0.0) & ~both_out)[:, None], inter, p1)
        p2 = torch.where(((d2 > 0.0) & ~both_out)[:, None], inter, p2)
    pen1 = face_off - _dot2(ref_n, p1)
    pen2 = face_off - _dot2(ref_n, p2)
    ok1 = ok1 & (pen1 >= 0.0)
    ok2 = ok2 & (pen2 >= 0.0)
    swap = pen2 > pen1
    pa = torch.where(swap[:, None], p2, p1)
    pb = torch.where(swap[:, None], p1, p2)
    pena = torch.where(swap, pen2, pen1)
    penb = torch.where(swap, pen1, pen2)
    oka = torch.where(swap, ok2, ok1)
    okb = torch.where(swap, ok1, ok2)
    C = max_contacts
    N = face_off.shape[0]
    pts = torch.zeros((N, C, 2), dtype=av.dtype, device=av.device)
    pen = torch.zeros((N, C), dtype=av.dtype, device=av.device)
    valid = torch.zeros((N, C), dtype=torch.bool, device=av.device)
    pts[:, 0], pen[:, 0], valid[:, 0] = pa, pena, oka
    if C >= 2:
        pts[:, 1], pen[:, 1], valid[:, 1] = pb, penb, okb
    return pts, pen, valid
