"""Contact-solver helpers: the warm-start lookup of
``lpe_tpu/systems/rigid/solver.py`` (``match_warm_impulses``). The list
pipeline's solvers (``solve_velocity``, ``solve_position``) are ROADMAP.md
Queue 1 item 5; the grid pipeline runs its own staged solvers."""
from __future__ import annotations

import torch


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
