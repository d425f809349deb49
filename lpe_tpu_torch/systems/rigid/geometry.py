"""Batched collision geometry: the polygon-polygon narrowphase.

The counterpart of ``lpe_tpu/systems/rigid/geometry.py``, poly-poly only:
closed-form SAT (``sat_contact(any_circle=False)``) and the reference-face
/ incident-edge clip (``polygon_contacts``). The JAX functions handle one
pair and are ``vmap``-ed over rows; here every function takes a batch of
rows, so the row axis is written out as the leading dimension. A shape is a
dict of per-row tensors: ``pos`` [N, 2], ``angle`` [N], ``verts`` [N, V, 2]
(local, CCW), ``nverts`` [N] and ``vmask`` [N, V].

Sums over a vertex ring run in ring order, as ``csrc/narrowphase.cu``
runs them, so the kernel and this plain version round alike. GJK/EPA and
the circle branches are ROADMAP.md Queue 1 item 2.
"""
from __future__ import annotations

import torch

from ...core.numerics import sqrt

NEG = -1e30


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


def world_verts(shape):
    """World-space vertex ring of a polygon row (``pos + R(angle) v``), with
    its validity mask and count (the polygon branch of geometry.py
    ``world_verts``)."""
    c = torch.cos(shape["angle"])[:, None]
    s = torch.sin(shape["angle"])[:, None]
    v = shape["verts"]
    rot = torch.stack([v[..., 0] * c - v[..., 1] * s,
                       v[..., 0] * s + v[..., 1] * c], dim=-1)
    return shape["pos"][:, None, :] + rot, shape["vmask"], shape["nverts"]


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


def sat_contact(sa, sb, any_circle: bool = False):
    """(hit [N], normal [N, 2], penetration [N]) of polygon rows; the
    normal points A -> B. Circles are not ported (``any_circle`` must be
    False)."""
    if any_circle:
        raise NotImplementedError(
            "circle narrowphase is not ported yet (ROADMAP.md Queue 1 "
            "item 2)")
    return _sat_poly_poly(*world_verts(sa), *world_verts(sb))


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
