"""Static geometry of the grid-resident rigid pipeline.

Only ``grid_dims`` is ported so far: ``scene.finalize`` sizes the state's
grid-rigid caches with it, exactly as ``lpe_tpu/systems/rigid/
grid_pipeline.py`` does. The pipeline itself is ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import math

from ...core.config import ScenarioSystemConfig
from ...scene import SceneSpec


def grid_dims(spec: SceneSpec, cfg: ScenarioSystemConfig):
    """Static grid geometry shared by scene.finalize (state sizing) and
    make_grid_rigid_system. Returns None when the grid pipeline is off."""
    rc = cfg.rigid
    bp = rc.broadphase
    S = spec.n_solid
    mode = getattr(rc, "grid_pipeline", "auto")
    on = (mode == "on" or (mode == "auto" and S > bp.dense_max_solids))
    if not on or S < 2:
        return None
    # big (off-grid) solids are frozen contact partners in the solvers —
    # exact for infinite-mass boundary walls, wrong for a dynamic oversized
    # body: those scenes keep the list pipeline
    if not spec.solid_big_all_boundary:
        return None
    slack = float(bp.persist_slack_m)
    cellb = spec.solid_cell_size + slack
    if cellb <= 0:
        return None
    size = cfg.shared.universe_size_m
    nbx = max(1, int(math.ceil(size / cellb))) + 2
    occ0 = int(getattr(spec, "solid_max_cell_occ0", 0))
    while nbx * nbx > (1 << 18):
        cellb *= 2.0
        occ0 *= 4          # each doubling quadruples expected cell occupancy
        nbx = max(1, int(math.ceil(size / cellb))) + 2
    # round the row count up to a multiple of 8: the flat [NC] cell axis
    # then splits into whole y-row bands on any 1/2/4/8-device mesh
    # (parallel/sharded.py shards the rg_* state on it), and power-of-two
    # row counts tile better everywhere. Extra rows are empty border cells
    # (positions clip to the original extent) — physics unchanged.
    nbx = -(-nbx // 8) * 8
    # Per-cell slot capacity. Auto-sizing is DENSITY-DRIVEN: 3x the scene's
    # initial max per-cell count (headroom for piling under gravity/fluid
    # ploughing), floored at 8 and never above the old worst-case constant.
    # A 13 m north-star tank (0.6 bodies/cell) sizes to KB=8-16 instead of
    # 48 — every narrowphase/solver select scales with KB, measured ~7x of
    # the tick at the oversized setting. Saturation (bodies dropped beyond
    # KB, rows beyond the class caps) is observable: core.telemetry
    # .capacity_report counts it and the bench scenes assert ~0.
    worst = max(8, (3 * bp.grid_max_per_cell) // 2)
    auto_kb = min(worst, max(8, -(-3 * occ0 // 8) * 8)) if occ0 > 0 else worst
    KB = getattr(rc, "grid_slots_per_cell", 0) or auto_kb
    # candidate packing stores (kb | ka << 8): slot ids must fit in 8 bits
    if KB > 256:
        raise ValueError(
            f"grid rigid pipeline: KB={KB} slots/cell exceeds the 8-bit "
            "candidate packing (max 256); lower rigid.grid_slots_per_cell "
            "or broadphase.grid_max_per_cell")
    r00 = getattr(rc, "grid_rows_same", 0) or KB
    rax = getattr(rc, "grid_rows_axis", 0) or max(4, KB // 2)
    rdg = getattr(rc, "grid_rows_diag", 0) or max(4, KB // 3)
    nbig = len(spec.solid_big_idx)
    # floor cells pair every resident body against the floor wall: the big
    # class needs up to KB rows (capped at the old 16 default for scenes
    # with huge KB)
    rbig = (getattr(rc, "grid_rows_big", 0) or min(KB, 16)) if nbig else 0
    # class layout over the row axis: [same | E | SW | S | SE | big]
    caps = (r00, rax, rdg, rax, rdg) + ((rbig,) if nbig else ())
    return dict(nbx=nbx, cellb=cellb, KB=KB, caps=caps, nbig=nbig,
                R=sum(caps), NC=nbx * nbx)
