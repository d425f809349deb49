"""SPH fluid system: the fluid tick with two-way rigid coupling.

The PyTorch counterpart of the single-device paths of
``lpe_tpu/systems/fluid/sph.py``, chosen by ``FluidConfig.residency`` and
``FluidConfig.pair_backend``:

- resident (``"auto"``, ``"on"``): particle state lives in a dense
  ``[ny+2, K, cols]`` cell grid for a whole tick (or a whole block of
  ticks, see ``systems.build_run_fn``): one stable sort + scatter builds
  it, and one gather writes it back in particle order. With the pair sweep
  (``pair_backend`` ``"auto"`` or ``"sweep"``) each of the
  ``num_sub_steps`` sub-steps runs three kernels on a 9-plane state stack
  (``ops/sph_kernels.py``: migrate -> pair sweep -> coupling9, the JAX
  package's stacked chain, ``sph.py:1385-1436``). With the split kernels
  (``"pallas"``) the sub-step carries a dict of planes: migrate ->
  density -> EOS -> force -> second kick -> coupling
  (``sph.py:1438-1528``), which is also the per-band engine of the JAX
  package's multi-device halo path;
- scatter (``"off"``): every sub-step integrates in particle order,
  builds a fresh grid, runs the pair pass on it (density + force, or the
  pair sweep) and couples each particle against every rigid in dense
  ``[NR, NL]`` PyTorch code (``sph.py:1249-1322``).

The same code runs on the CPU and on the GPU: only the kernel wrappers
branch, on the device of their tensors.

Kept from the JAX package: the coefficients, the first-K-per-cell drop
contract, the (dy, dx, slot) migration order and walk clamp, the S-slot
per-cell coupling raster with its overflow counter, and every formula.
Changed for the GPU: a stable argsort (so slot order within a cell can
differ from the JAX package's, and pair sums reassociate), plain gathers
in place of one-hot-matmul permutes, and per-column instead of per-128-
column-tile coupling masks.

Not ported yet (raise ``NotImplementedError``): mixed per-particle h and
the multi-device mesh. ``pair_backend="xla"`` is a ``ValueError``: the
kernels' plain PyTorch versions, taken for CPU tensors, are the port's
counterpart of the XLA pair passes.
"""
from __future__ import annotations

import math

import torch

from ...core import constants as C
from ...core.config import ScenarioSystemConfig
from ...core.constants import MAX_POLY_VERTS, ShapeKind
from ...core.numerics import sqrt, true_div
from ...ops import sph_kernels as SK
from ...scene import SceneSpec
from ...state import SimState

INF = 1e30
# padded grid columns are a multiple of this (one warp of columns)
COL_ALIGN = 32


def poly6_coeff_2d(h: float) -> float:
    return 4.0 / (math.pi * h ** 8)


def spiky_coeff_2d(h: float) -> float:
    return -30.0 / (math.pi * h ** 5)


def visc_laplacian_coeff_2d(h: float) -> float:
    return 40.0 / (math.pi * h ** 5)


def _rigid_proxies(b, NR, VU=MAX_POLY_VERTS):
    """World-space rigid data for coupling: every non-liquid entity with a
    shape participates (reference: fluid.cpp:304-438 gatherRigidBodies).
    ``VU`` = the scene's static max vertex count."""
    dev = b.pos.device
    vmask = torch.arange(VU, device=dev)[None, :] < b.nverts[:NR, None]
    c = torch.cos(b.angle[:NR])[:, None]
    s = torch.sin(b.angle[:NR])[:, None]
    v = b.verts[:NR, :VU]
    wx = b.pos[:NR, None, 0] + v[..., 0] * c - v[..., 1] * s
    wy = b.pos[:NR, None, 1] + v[..., 0] * s + v[..., 1] * c
    is_circle = b.shape_kind[:NR] == int(ShapeKind.CIRCLE)
    r = b.radius[:NR]
    big = torch.full_like(wx, INF)
    pminx = torch.where(vmask, wx, big).amin(1)
    pmaxx = torch.where(vmask, wx, -big).amax(1)
    pminy = torch.where(vmask, wy, big).amin(1)
    pmaxy = torch.where(vmask, wy, -big).amax(1)
    return dict(
        is_circle=is_circle,
        pos=b.pos[:NR], radius=r,
        wx=wx, wy=wy, vmask=vmask, nverts=b.nverts[:NR],
        vel=b.vel[:NR], omega=b.omega[:NR],
        mass=b.mass[:NR], inertia=b.inertia[:NR],
        minx=torch.where(is_circle, b.pos[:NR, 0] - r, pminx),
        maxx=torch.where(is_circle, b.pos[:NR, 0] + r, pmaxx),
        miny=torch.where(is_circle, b.pos[:NR, 1] - r, pminy),
        maxy=torch.where(is_circle, b.pos[:NR, 1] + r, pmaxy),
        valid=b.active[:NR],
    )


def _next_mult(n: int, m: int) -> int:
    return -(-n // m) * m


def coupling_dims(spec, cfg):
    """Static geometry of the per-cell rasterized coupling candidates
    (None when the scene has no fluid<->rigid coupling), exactly as
    ``lpe_tpu`` sizes it: S candidate slots per cell, the sorted-window
    capacity WCAP of the field build, and NBIG big solids."""
    NR = spec.liquid_start
    if NR == 0 or spec.n_liquid == 0:
        return None
    fc = cfg.fluid
    S = fc.coupling_slots_per_cell or min(
        32, max(8, _next_mult(3 * max(1, spec.coupling_max_cell_cover0), 8)))
    w0 = max(1, spec.coupling_max_win0
             or getattr(spec, "coupling_max_row_cover0", 0))
    wauto = max(256, _next_mult(4 * w0, 128))
    WCAP = fc.coupling_window_rows or wauto
    WCAP = min(WCAP, _next_mult(2 * NR, 128))
    return dict(S=S, WCAP=WCAP, NBIG=len(spec.solid_big_idx),
                slack_cells=float(fc.coupling_raster_slack_cells))


def grid_slots(max_per_cell: int, n_liquid: int, device) -> int:
    """K, the slots of a grid cell: ``max_per_cell``, at most the liquid
    particles. On a CUDA device a K above the kernels' ``SK.MAX_K`` (64,
    the reference's cap) raises ``ValueError``; the CPU takes any K."""
    K = max(1, min(max_per_cell, n_liquid))
    if torch.device(device).type == "cuda" and K > SK.MAX_K:
        raise ValueError(
            f"fluid.grid.max_per_cell = {max_per_cell} gives {K} slots a "
            f"cell; the CUDA SPH kernels take at most {SK.MAX_K}, the "
            f"reference's cap: lower max_per_cell, or run on the CPU")
    return K


def make_fluid_system(spec: SceneSpec, cfg: ScenarioSystemConfig, *,
                      device, mesh=None):
    """The fluid step of ``cfg.fluid.residency`` and ``pair_backend``. The
    resident step carries its cross-tick hooks as attributes
    (``grid_build``, ``grid_tick``, ``grid_readback``, ``grid_boundary``,
    ``grid_gravity``) for ``systems.build_run_fn``; the scatter step
    (``residency="off"``) has none and runs tick by tick."""
    fc = cfg.fluid
    if mesh is not None:
        raise NotImplementedError(
            "the multi-device fluid path is not ported yet "
            "(ROADMAP.md Queue 1 item 7)")
    if not spec.liquid_h_uniform:
        raise NotImplementedError(
            "mixed per-particle smoothing lengths are not ported yet "
            "(ROADMAP.md Queue 1 item 5)")
    NL = spec.n_liquid
    K = grid_slots(fc.grid.max_per_cell, NL, device)
    if fc.residency not in ("auto", "on", "off"):
        raise ValueError(f"unknown residency {fc.residency!r}")
    if fc.pair_backend not in ("auto", "sweep", "pallas"):
        raise ValueError(
            f"pair_backend {fc.pair_backend!r}: the port has the pair sweep "
            "('auto' or 'sweep') and the split density and force kernels "
            "('pallas'); their plain PyTorch versions run on CPU tensors")
    use_split = fc.pair_backend == "pallas"
    if fc.grid.cell_size_factor < 1.0:
        raise ValueError("cell_size_factor must be >= 1.0 (3x3 scan needs "
                         "cells at least h wide to cover the r<h support)")
    L0 = spec.liquid_start
    NR = L0                       # solids + gas precede liquids in layout
    h = fc.grid.smoothing_length
    cell = fc.grid.cell_size_factor * h
    size = cfg.shared.universe_size_m
    gmin = -2                     # static grid: universe + 2-cell apron
    nx = int(math.ceil(size / cell)) + 4
    ny = nx
    sub_dt = (cfg.shared.seconds_per_tick * cfg.shared.time_acceleration
              / fc.num_sub_steps)
    half_dt = 0.5 * sub_dt
    eps = fc.grid.grid_epsilon
    POLY6 = poly6_coeff_2d(h)
    SPIKY = spiky_coeff_2d(h)
    VISC = visc_laplacian_coeff_2d(h)
    nm = fc.numerical
    nxp = nx + 2
    W = _next_mult(nxp, COL_ALIGN)   # padded grid columns
    rows = ny + 2
    PSIZE = rows * K * W
    f32 = torch.float32

    # drift clamp: migration handles at most 1-cell moves per sub-step;
    # drift + coupling push-out (<= max_correction) stay under one cell
    _RES_LIM = 0.45 * cell
    mig_kw = dict(nx=nx, half_dt=half_dt, sub_dt=sub_dt, lim=_RES_LIM,
                  cell=cell, eps=eps, gmin=gmin)
    density_kw = dict(h=h, poly6=POLY6)
    force_kw = dict(h=h, spiky=SPIKY, visc_lap=VISC, viscosity=fc.viscosity,
                    min_d2=nm.min_distance_threshold,
                    min_rho=nm.min_density_threshold)
    sweep_kw = dict(force_kw, poly6=POLY6, stiffness=fc.stiffness,
                    rest_density=fc.rest_density)

    def _pad_rows(v):
        """[ny, K, W] interior rows -> [rows, K, W] with zero apron rows."""
        return torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))

    def _eos(rho):
        return torch.clamp(fc.stiffness * (rho - fc.rest_density), min=0.0)

    def build_grid(x, y, clamp):
        """Assign every particle a cell: edge-clamped (``clamp``, the
        resident build, so that none is ever lost from the resident
        state), or none when it lies off the grid (the scatter build). The
        first K of a cell in particle order get its slots (stable sort),
        the rest are dropped. ``slot_p``: each particle's flat index into
        the padded ``[rows, K, W]`` grid (PSIZE = no slot); ``pvalid``:
        the particle has a slot."""
        i32 = torch.int32
        gx = torch.floor(true_div(x + eps, cell)).to(i32) - gmin
        gy = torch.floor(true_div(y + eps, cell)).to(i32) - gmin
        if clamp:
            gx = torch.clamp(gx, 0, nx - 1)
            gy = torch.clamp(gy, 0, ny - 1)
            cid = gy * nx + gx
        else:
            ok = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny)
            cid = torch.where(ok, gy * nx + gx,
                              torch.full_like(gx, nx * ny))
        cid = cid.to(torch.int64)
        order = torch.argsort(cid, stable=True)
        sc = cid[order]
        rank = torch.arange(NL, device=x.device) - \
            torch.searchsorted(sc, sc)
        valid = (sc < nx * ny) & (rank < K)
        row = sc // nx + 1
        col = sc % nx + 1
        slot = torch.where(valid, (row * K + rank) * W + col,
                           torch.full_like(sc, PSIZE))
        slot_p = torch.empty_like(slot).scatter_(0, order, slot)
        return dict(slot_p=slot_p, pvalid=slot_p < PSIZE)

    def to_dense(grid, fields: dict):
        """Scatter per-particle fields into padded [rows, K, W] planes."""
        out = {}
        for name, v in fields.items():
            flat = torch.zeros(PSIZE + 1, dtype=v.dtype, device=v.device)
            flat.scatter_(0, grid["slot_p"], v)
            out[name] = flat[:PSIZE].view(rows, K, W)
        return out

    def from_dense(grid, planes):
        """Per-particle values of padded [rows, K, W] planes: one gather
        per plane, 0 for a particle without a slot."""
        gi = torch.clamp(grid["slot_p"], max=PSIZE - 1)
        return [torch.where(grid["pvalid"], v.reshape(-1)[gi],
                            torch.zeros((), dtype=v.dtype, device=v.device))
                for v in planes]

    def _tile_bounds_t(occ):
        """Per-(padded row, column) occupancy count of a [rows, K, W] occ
        plane. The port's coupling mask works per column: a column is its
        tile."""
        return occ.sum(1)

    # ------------------------------------------------------------------
    # Rigid-fluid coupling: tick-constant candidate raster + per-tick
    # reduction of the kernel's force partials.
    # ------------------------------------------------------------------
    psv = fc.position_solver
    isv = fc.impulse_solver
    use_cpl = NR > 0
    if use_cpl:
        _VR = spec.max_rigid_verts
        _CN = dict(
            V=_VR, half_dt=half_dt, stiffness=fc.stiffness,
            min_safe_distance=psv.min_safe_distance,
            safety_margin=psv.safety_margin, relax_factor=psv.relax_factor,
            max_correction=psv.max_correction,
            min_position_change=psv.min_position_change,
            boundary_offset=fc.grid.boundary_offset,
            min_penetration=isv.min_penetration,
            max_safe_velocity_sq=isv.max_safe_velocity_sq,
            rest_density=fc.rest_density,
            depth_transition_rate=isv.depth_transition_rate,
            depth_scale=isv.depth_scale,
            depth_estimate_scale=isv.depth_estimate_scale,
            gravity=fc.gravity, max_force=isv.max_force,
            pressure_force_ratio=isv.pressure_force_ratio,
            min_rel_velocity=isv.min_rel_velocity, viscosity=fc.viscosity,
            viscosity_scale=isv.viscosity_scale, sub_dt=sub_dt,
            viscous_force_ratio=isv.viscous_force_ratio,
            buoyancy_strength=isv.buoyancy_strength,
            max_torque=isv.max_torque,
            angular_damping_threshold=isv.angular_damping_threshold,
            angular_damping_factor=isv.angular_damping_factor,
            fluid_force_scale=isv.fluid_force_scale,
            fluid_force_max=isv.fluid_force_max,
            any_circle=spec.any_rigid_circle,
            any_poly=spec.any_rigid_polygon,
        )
        _cd = coupling_dims(spec, cfg)
        _S, _WCAP, _NBIG = _cd["S"], _cd["WCAP"], _cd["NBIG"]
        _Wp = SK.rig_width(_VR)
        _slackm = _cd["slack_cells"] * cell
        _big_arr = torch.tensor(list(spec.solid_big_idx) or [0],
                                dtype=torch.int64, device=device)
        _isbig = torch.zeros(NR, dtype=torch.bool, device=device)
        _isbig[list(spec.solid_big_idx)] = True
        # widened-AABB height bound in rows (static: bounding diameters
        # are rotation-invariant) — the sorted-window span of the build
        _hcells = int(math.ceil(
            (spec.coupling_max_diam + 2.0 * _slackm) / cell)) + 1
        _CH = C.COUPLE_CHUNK_ROWS
        _CTW = C.COUPLE_TILE_COLS
        _NTL = -(-nxp // _CTW)           # x-tiles of the candidate windows
        _E = 2 * NR                      # candidate copies (one per tile)
        _WN = min(_WCAP, _E)             # window width that can be live
        _rowi = torch.arange(rows, device=device)
        _coli = torch.arange(W, device=device)
        _tile_of_col = torch.clamp(_coli // _CTW, max=_NTL - 1)

        def _rig_cols(R):
            """[NR, Wp] candidate parameter matrix (sph_kernels RW_*
            layout). Vertex rings pad with vertex 0; inactive entities
            zero their mass — mass > 0 is the validity bit."""
            wxp = torch.where(R["vmask"], R["wx"], R["wx"][:, :1])
            wyp = torch.where(R["vmask"], R["wy"], R["wy"][:, :1])
            mass_v = torch.where(R["valid"], R["mass"],
                                 torch.zeros_like(R["mass"]))
            cols = torch.stack([
                R["pos"][:, 0], R["pos"][:, 1],
                R["vel"][:, 0], R["vel"][:, 1], R["omega"],
                mass_v, R["inertia"], R["radius"],
                R["is_circle"].to(f32),
                R["minx"], R["miny"], R["maxx"], R["maxy"]], dim=1)
            wxy = torch.stack([wxp, wyp], dim=-1).reshape(NR, 2 * _VR)
            tab = torch.cat([cols, wxy], dim=1)
            return torch.nn.functional.pad(tab, (0, _Wp - tab.shape[1]))

        def _couple_field(R):
            """Tick-constant rasterized candidates. Returns (fld [rows, S,
            Wp, W], bigtab [NBIG+1, Wp], meta).

            The JAX package's windowed build (sph.py _couple_field and
            _win_chunk), with gathers in place of one-hot matmuls: small
            candidates get one copy per covered x-tile of COUPLE_TILE_COLS
            columns, sorted by (tile, bottom-edge bucket). A cell's
            candidates are its tile's sorted window from the chunk's
            lowest reachable bucket to the cell's own row, capped at WCAP;
            those whose slack-widened AABB covers the cell take its slots
            in window order, the first S kept. ``meta['body']`` maps each
            (row, slot, column) to its rigid (NR = empty) for
            _couple_reduce; ``meta['overflow']`` counts dropped
            candidates (slot and window caps, and bodies spanning more
            than two tiles)."""
            tab = _rig_cols(R)
            if _NBIG:
                bigtab = torch.cat([tab[_big_arr],
                                    tab.new_zeros((1, _Wp))])
            else:
                bigtab = tab.new_zeros((1, _Wp))
            i32 = torch.int32
            tmax = _NTL * _CTW - 1
            def tile(x):
                c = torch.floor(true_div(x, cell)).to(i32) + 3
                return torch.clamp(c, 0, tmax) // _CTW

            ctl0 = tile(tab[:, 9] - _slackm)
            ctl1 = tile(tab[:, 11] + _slackm)
            live = (tab[:, 5] > 0) & ~_isbig
            tab2 = torch.cat([tab, tab, tab.new_zeros((1, _Wp))])
            tile2 = torch.cat([ctl0, ctl1])
            live2 = torch.cat([live, live & (ctl1 != ctl0)])
            ovf_mid = (((ctl1 - ctl0) > 1) & live).sum()
            keys_c = torch.clamp(tab[:, 10] - _slackm, -1e6, 1e6)
            nyT = rows - 2
            NB = nyT + 3
            buck = torch.clamp(torch.floor(true_div(keys_c, cell)).to(i32) + 3,
                               0, nyT + 1)
            buck2 = torch.cat([buck, buck])
            key = torch.where(live2, tile2 * NB + buck2,
                              torch.full_like(tile2, _NTL * NB)) \
                .to(torch.int64)
            order = torch.argsort(key, stable=True)
            skey = key[order]
            starts = torch.searchsorted(
                skey, torch.arange(_NTL * NB + 1, device=device))
            tabs = tab2[torch.cat([order, order.new_full((1,), _E)])]
            # window [lo, lo + cnt) of tile t for padded row g
            g0 = (_rowi // _CH) * _CH
            lo_b = torch.clamp(g0 - _hcells, 0, nyT + 1)
            hi_b = torch.clamp(_rowi, 0, nyT + 1) + 1
            tb = torch.arange(_NTL, device=device)[:, None] * NB
            lo = starts[tb + lo_b[None]]                 # [NTL, rows]
            cnt = starts[tb + hi_b[None]] - lo
            iw = torch.arange(_WN, device=device)
            pos = lo[..., None] + iw                     # [NTL, rows, WN]
            inwin = iw < cnt[..., None]
            pos = torch.where(inwin, pos, torch.full_like(pos, _E))
            win = tabs[pos]                              # [.., WN, Wp]
            gf = _rowi.to(f32)
            ry0 = (gf - 3.0) * cell - _slackm
            ry1 = (gf - 2.0) * cell + _slackm
            yov = (win[..., 10] <= ry1[:, None]) & \
                (win[..., 12] >= ry0[:, None]) & inwin & (win[..., 5] > 0)
            cx0 = (_coli.to(f32) - 3.0) * cell - _slackm
            cx1 = cx0 + cell + 2.0 * _slackm
            t = _tile_of_col
            xov = (win[t, :, :, 9] <= cx1[:, None, None]) & \
                (win[t, :, :, 11] >= cx0[:, None, None])  # [W, rows, WN]
            ov = (yov[t] & xov).permute(1, 0, 2)          # [rows, W, WN]
            rank = torch.cumsum(ov.to(i32), dim=-1)
            keep = ov & (rank <= _S)
            slot = torch.where(keep, rank - 1, torch.full_like(rank, _S))
            posw = pos[t].permute(1, 0, 2)               # [rows, W, WN]
            sel = torch.full((rows, W, _S + 1), _E, dtype=torch.int64,
                             device=device)
            sel.scatter_(2, slot.to(torch.int64),
                         torch.where(keep, posw, torch.full_like(posw, _E)))
            sel = sel[..., :_S]                          # [rows, W, S]
            fld = tabs[sel].permute(0, 2, 3, 1).contiguous()
            order_e = torch.cat([order, order.new_full((1,), NR)])
            body = torch.where(sel < _E, order_e[sel] % NR,
                               torch.full_like(sel, NR))
            overflow = (torch.clamp(ov.sum(-1) - _S, min=0).sum()
                        + torch.clamp(cnt - _WCAP, min=0).sum() + ovf_mid)
            meta = dict(body=body.permute(0, 2, 1), overflow=overflow)
            return fld, bigtab, meta

        # bodies per chunk of the reduction (bounds its [chunk, E] mask)
        _RED_CHUNK = max(1, (1 << 24) // max(1, rows * _S * W))

        def _couple_reduce(meta, PL):
            """Per-tick sums of the accumulated per-(row, slot, column)
            force partials PL [rows, 3S, W] onto their rigids: [NR, 3]
            (fx, fy, tq). Masked sums in a fixed order, no float atomics,
            so the result is deterministic."""
            P3 = PL.view(rows, _S, 3, W)
            body = meta["body"]                          # [rows, S, W]
            out = []
            for j0 in range(0, NR, _RED_CHUNK):
                ids = torch.arange(j0, min(NR, j0 + _RED_CHUNK),
                                   device=PL.device)
                m = body[None] == ids.view(-1, 1, 1, 1)  # [c, rows, S, W]
                sel = torch.where(m[:, :, :, None, :], P3[None],
                                  torch.zeros((), dtype=PL.dtype,
                                              device=PL.device))
                out.append(sel.sum((1, 2, 4)))
            return torch.cat(out)

        def _cpl_mask(counts, R):
            """[rows, W] int32: the cell holds particles AND a rigid AABB
            lies within a cell of slack of its column and row (coupling is
            a no-op outside the AABB). Padded column c holds particles
            with x in [(c-3)*cell, (c-2)*cell)."""
            tx0 = (_coli - 4).to(f32) * cell
            tx1 = tx0 + 4.0 * cell
            ry0 = (_rowi - 4).to(f32) * cell
            ry1 = ry0 + 3.0 * cell
            ovx = (R["minx"][None, :] <= tx1[:, None]) & \
                (R["maxx"][None, :] >= tx0[:, None])      # [W, NR]
            ovy = (R["miny"][None, :] <= ry1[:, None]) & \
                (R["maxy"][None, :] >= ry0[:, None]) & R["valid"][None, :]
            hit = (ovy.to(f32) @ ovx.to(f32).T) > 0      # [rows, W]
            return ((counts > 0) & hit).to(torch.int32)

        def _add_bigF(Fx, Fy, Tq, bigF):
            """Accumulate the big-solid force sums onto their rigids."""
            if not _NBIG:
                return Fx, Fy, Tq
            return (Fx.index_add(0, _big_arr, bigF[:, 0]),
                    Fy.index_add(0, _big_arr, bigF[:, 1]),
                    Tq.index_add(0, _big_arr, bigF[:, 2]))

        def _dense_couple(R, x1, y1, vx1, vy1, rho, pres, mass, ax, ay):
            """The scatter path's coupling: every particle against every
            rigid, on dense [NR, NL] tensors (``lpe_tpu`` overlap_info,
            impulse_solve and position_solve, sph.py:1079-1247, which
            mirror the kernels' candidate math form for form: here all NR
            rigids are the candidates of every particle). Returns the
            particles' (x, y, vx, vy, ax, ay) and the rigids' (Fx, Fy, Tq)
            of this sub-step; rigid sums run over the particle axis, no
            atomics.

            Memory: about 40 live [NR, NL] float32 intermediates, 64 MB at
            the dam's 4 walls x 100k particles, 160 GB at 10k rigids x
            100k particles: the scatter path is for scenes with few
            rigids, as in ``lpe_tpu``."""
            tab = _rig_cols(R)
            gp = lambda i: tab[:, i, None]                   # [NR, 1]
            px, py = x1[None, :], y1[None, :]                # [1, NL]
            in_aabb = (px >= gp(SK.RW_MINX)) & (px <= gp(SK.RW_MAXX)) & \
                (py >= gp(SK.RW_MINY)) & (py <= gp(SK.RW_MAXY)) & \
                R["valid"][:, None]
            hp = SK.hoist_particle_terms(_CN, py, rho[None, :],
                                         pres[None, :], mass[None, :])
            inside, cx_, cy_, cfx, cfy, ctq, act = SK._cand_math(
                _VR, _CN, gp, in_aabb, px, py, vx1[None, :], vy1[None, :],
                hp)
            acc = [cx_.sum(0), cy_.sum(0), cfx.sum(0), cfy.sum(0),
                   inside.any(0), act.any(0)]
            outs = SK._couple_fin(_CN, acc, x1, y1, vx1, vy1, mass, ax, ay)
            return outs, (cfx.sum(1), cfy.sum(1), ctq.sum(1))

    def _finalize_rigid(state, Fx, Fy, Tq):
        """Rigid velocity write-back, once per tick (fluid.cpp:526-580)."""
        if NR == 0:
            return state
        b = state.bodies
        rm = b.mass[:NR]
        ri = b.inertia[:NR]
        zero = torch.zeros_like(rm)
        inv_m = torch.where(rm > 1e-12, 1.0 / rm, zero)
        inv_i = torch.where(ri > 1e-12, 1.0 / ri, zero)
        damp = fc.damping_factor
        rvx = (b.vel[:NR, 0] + Fx * inv_m) * damp
        rvy = (b.vel[:NR, 1] + Fy * inv_m) * damp
        rom = (b.omega[:NR] + Tq * inv_i) * damp
        vel = torch.cat([torch.stack([rvx, rvy], -1), b.vel[NR:]])
        omega = torch.cat([rom, b.omega[NR:]])
        return state.replace(bodies=b.replace(vel=vel, omega=omega))

    def _finalize_liquid(state, xn, yn, vxn, vyn, rhon, presn):
        b = state.bodies

        def put(full, part):
            return torch.cat([full[:L0], part, full[L0 + NL:]])

        pos = put(b.pos, torch.stack([xn, yn], -1))
        vel = put(b.vel, torch.stack([vxn, vyn], -1))
        return state.replace(bodies=b.replace(
            pos=pos, vel=vel, density=put(b.density, rhon),
            pressure=put(b.pressure, presn)))

    def _grid_build(state: SimState):
        """Sort+scatter the liquid slice into the dense grid (once per
        tick — or once per block under cross-tick residency)."""
        b = state.bodies
        x = b.pos[L0:L0 + NL, 0]
        y = b.pos[L0:L0 + NL, 1]
        idf = torch.arange(1, NL + 1, dtype=f32, device=x.device)  # 0=empty
        grid = build_grid(x, y, clamp=True)
        D0 = to_dense(grid, dict(
            x=x, y=y, vx=b.vel[L0:L0 + NL, 0], vy=b.vel[L0:L0 + NL, 1],
            m=b.mass[L0:L0 + NL], id=idf, occ=torch.ones_like(x)))
        zd = torch.zeros_like(D0["x"])
        return dict(D0, hx=zd, hy=zd, ax=zd, ay=zd, rho=zd, p=zd)

    def _stack(D):
        """The sub-step state stack ST [rows, 9, K, W] of a grid dict,
        accelerations reset to zero."""
        zd = torch.zeros_like(D["x"])
        return torch.stack([D["x"], D["y"], D["vx"], D["vy"], zd, zd,
                            D["m"], D["id"], D["occ"]], dim=1)

    def _substep(cr, R, fld, bigtab):
        """One sub-step on the stacked state: migrate -> pair sweep ->
        coupling9 (which emits the next ST); with no rigids the second
        kick and restack run in PyTorch."""
        M9 = SK.migrate(cr["ST"], **mig_kw)
        rho, fx, fy = SK.pair_sweep(M9, **sweep_kw)
        if NR > 0:
            cpl = _cpl_mask(_tile_bounds_t(M9[:, SK.M9_OCC]), R)
            ST, pl, bigp = SK.coupling9(cpl, fld, bigtab, M9, rho, fx, fy,
                                        cn=_CN)
            Fx, Fy, Tq = cr["Fx"], cr["Fy"], cr["Tq"]
            if _NBIG:
                bigF = bigp.sum((0, 1)).view(_NBIG, 3)
                Fx, Fy, Tq = _add_bigF(Fx, Fy, Tq, bigF)
            return dict(ST=ST, RHO=rho, PL=cr["PL"] + pl, Fx=Fx, Fy=Fy,
                        Tq=Tq)
        fxp, fyp = _pad_rows(fx), _pad_rows(fy)
        vx1 = M9[:, SK.M9_HX] + half_dt * fxp
        vy1 = M9[:, SK.M9_HY] + half_dt * fyp
        ST2 = torch.stack([M9[:, SK.M9_X], M9[:, SK.M9_Y], vx1, vy1, fxp,
                           fyp, M9[:, SK.M9_M], M9[:, SK.M9_ID],
                           M9[:, SK.M9_OCC]], dim=1)
        return dict(cr, ST=ST2, RHO=rho)

    def _substep_split(cr, R, fld, bigtab):
        """One sub-step on the plane dict ``cr["D"]`` with the split
        kernels (``lpe_tpu`` _make_res_substep, sph.py:1438-1528): migrate
        (kick, clamped drift, re-bin: the kernel the stacked chain uses,
        whose result is the JAX package's XLA ``_migrate``), density, EOS,
        force, second kick, coupling. The planes keep the previous
        sub-step's rho and p until the density pass overwrites them."""
        D = cr["D"]
        M9 = SK.migrate(torch.stack(
            [D["x"], D["y"], D["vx"], D["vy"], D["ax"], D["ay"], D["m"],
             D["id"], D["occ"]], dim=1), **mig_kw)
        x1, y1, vx, vy, m, occ, hx, hy, pid = M9.unbind(1)
        rho = _pad_rows(SK.density(torch.stack([x1, y1, m, occ], dim=1),
                                   **density_kw))
        pres = _eos(rho)
        fx, fy = SK.force(torch.stack([x1, y1, vx, vy, m, rho, pres, occ],
                                      dim=1), **force_kw)
        ax1, ay1 = _pad_rows(fx), _pad_rows(fy)
        vx1 = hx + half_dt * ax1
        vy1 = hy + half_dt * ay1
        Dn = dict(x=x1, y=y1, vx=vx1, vy=vy1, ax=ax1, ay=ay1, m=m, id=pid,
                  occ=occ, hx=hx, hy=hy, rho=rho, p=pres)
        if NR == 0:
            return dict(cr, D=Dn)
        cpl = _cpl_mask(_tile_bounds_t(occ), R)
        x2, y2, vx2, vy2, axf, ayf, pl, bigp = SK.coupling(
            cpl, fld, bigtab, torch.stack(
                [x1, y1, vx1, vy1, rho, pres, m, occ, ax1, ay1], dim=1),
            cn=_CN)
        Fx, Fy, Tq = cr["Fx"], cr["Fy"], cr["Tq"]
        if _NBIG:
            Fx, Fy, Tq = _add_bigF(Fx, Fy, Tq,
                                   bigp.sum((0, 1)).view(_NBIG, 3))
        return dict(D=dict(Dn, x=x2, y=y2, vx=vx2, vy=vy2, ax=axf, ay=ayf),
                    PL=cr["PL"] + pl, Fx=Fx, Fy=Fy, Tq=Tq)

    def _grid_tick(state: SimState, D):
        """One fluid tick on the resident grid: sub-steps + the per-tick
        rigid velocity write-back. Accelerations reset at tick start (the
        reference zero-inits them on every particle gather,
        fluid.cpp:250-302)."""
        R = _rigid_proxies(state.bodies, NR, spec.max_rigid_verts) \
            if NR > 0 else None
        fld = bigtab = cmeta = None
        if use_cpl:
            fld, bigtab, cmeta = _couple_field(R)
        zd = torch.zeros_like(D["x"])
        nf = max(NR, 1)
        cr = dict(Fx=zd.new_zeros(nf), Fy=zd.new_zeros(nf),
                  Tq=zd.new_zeros(nf))
        if use_split:
            cr["D"] = dict(D, ax=zd, ay=zd)
        else:
            cr.update(RHO=None, ST=_stack(D))
        if use_cpl:
            cr["PL"] = zd.new_zeros((rows, 3 * _S, W))
        substep = _substep_split if use_split else _substep
        for _ in range(fc.num_sub_steps):
            cr = substep(cr, R, fld, bigtab)
        Fx, Fy, Tq = cr["Fx"], cr["Fy"], cr["Tq"]
        if use_cpl:
            Fs = _couple_reduce(cmeta, cr["PL"])
            Fx = Fx + Fs[:, 0]
            Fy = Fy + Fs[:, 1]
            Tq = Tq + Fs[:, 2]
        if use_split:
            return _finalize_rigid(state, Fx, Fy, Tq), cr["D"]
        STf = cr["ST"]
        rho_pad = _pad_rows(cr["RHO"])
        D2 = dict(x=STf[:, 0], y=STf[:, 1], vx=STf[:, 2], vy=STf[:, 3],
                  ax=STf[:, 4], ay=STf[:, 5], m=STf[:, 6], id=STf[:, 7],
                  occ=STf[:, 8], hx=zd, hy=zd, rho=rho_pad, p=_eos(rho_pad))
        return _finalize_rigid(state, Fx, Fy, Tq), D2

    def _grid_readback(state: SimState, D):
        """Gather liquid state back to particle order. Particles dropped by
        cell overflow (rank >= K at build or migration) keep their old
        values for the block, as in lpe_tpu."""
        b = state.bodies
        x = b.pos[L0:L0 + NL, 0]
        y = b.pos[L0:L0 + NL, 1]
        vx = b.vel[L0:L0 + NL, 0]
        vy = b.vel[L0:L0 + NL, 1]
        flat_id = torch.round(D["id"].reshape(-1)).to(torch.int64)
        occf = D["occ"].reshape(-1) > 0
        tgt = torch.where(occf, flat_id - 1, torch.full_like(flat_id, NL))
        slot_of = torch.full((NL + 1,), -1, dtype=torch.int64,
                             device=x.device)
        slot_of.scatter_(0, tgt, torch.arange(tgt.numel(), device=x.device))
        slot_of = slot_of[:NL]
        res_mask = slot_of >= 0
        gi = torch.clamp(slot_of, min=0)

        def readback(fld, old):
            return torch.where(res_mask, fld.reshape(-1)[gi], old)

        return _finalize_liquid(
            state,
            readback(D["x"], x), readback(D["y"], y),
            readback(D["vx"], vx), readback(D["vy"], vy),
            readback(D["rho"], b.density[L0:L0 + NL]),
            readback(D["p"], b.pressure[L0:L0 + NL]))

    # grid-space per-tick systems for cross-tick residency: the boundary
    # bounce and uniform gravity are the only systems that touch liquid
    # state between fluid ticks
    _bc = cfg.boundary
    _b_margin = _bc.margin_pixels * cfg.shared.meters_per_pixel

    def _grid_boundary(D):
        """make_boundary's clamp+bounce on the liquid planes (occ-masked;
        liquids never sleep — gated by spec.liquid_has_sleep upstream).
        reference: src/systems/boundary.cpp:13-71."""
        occm = D["occ"] > 0
        x, y, vx, vy = D["x"], D["y"], D["vx"], D["vy"]
        lo, hi = _b_margin, size - _b_margin
        damp = _bc.bounce_damping
        hit_l = x < lo
        hit_r = (~hit_l) & (x > hi)
        x2 = torch.clamp(x, lo, hi)
        vx2 = torch.where(hit_l, vx.abs() * damp,
                          torch.where(hit_r, -vx.abs() * damp, vx))
        hit_t = y < lo
        hit_b = (~hit_t) & (y > hi)
        y2 = torch.clamp(y, lo, hi)
        vy2 = torch.where(hit_t, vy.abs() * damp,
                          torch.where(hit_b, -vy.abs() * damp, vy))
        bounced = hit_l | hit_r | hit_t | hit_b
        speed = sqrt(vx2 * vx2 + vy2 * vy2)
        scale = torch.where(bounced & (speed > _bc.max_speed),
                            true_div(_bc.max_speed,
                                     torch.clamp(speed, min=1e-30)),
                            torch.ones_like(speed))
        m = occm & bounced
        return dict(D,
                    x=torch.where(m, x2, x), y=torch.where(m, y2, y),
                    vx=torch.where(m, vx2 * scale, vx),
                    vy=torch.where(m, vy2 * scale, vy))

    _g_accel = cfg.gravity.gravitational_acceleration
    _g_base_dt = cfg.shared.seconds_per_tick

    def _grid_gravity(state, D):
        """make_gravity's uniform pull on the liquid planes.
        reference: src/systems/gravity.cpp:19-59."""
        dt = _g_base_dt * state.base_time_accel * state.time_scale
        vy = torch.where(D["occ"] > 0, D["vy"] + _g_accel * dt, D["vy"])
        return dict(D, vy=vy)

    def step_scatter(state: SimState) -> SimState:
        """Per-tick scatter step (``lpe_tpu`` step, sph.py:1249-1322):
        every sub-step integrates in particle order, builds a fresh grid
        (a particle off the grid or beyond a cell's K slots gets no slot:
        it takes the self density ``m*poly6*h^6`` and zero pair force, and
        integrates ballistically), runs the pair pass on it and couples in
        dense [NR, NL] code."""
        b = state.bodies
        x = b.pos[L0:L0 + NL, 0]
        y = b.pos[L0:L0 + NL, 1]
        vx = b.vel[L0:L0 + NL, 0]
        vy = b.vel[L0:L0 + NL, 1]
        mass = b.mass[L0:L0 + NL]
        R = _rigid_proxies(b, NR, spec.max_rigid_verts) if NR > 0 else None
        ax = ay = torch.zeros_like(x)
        nf = max(NR, 1)
        Fx, Fy, Tq = x.new_zeros(nf), x.new_zeros(nf), x.new_zeros(nf)
        rho, pres = b.density[L0:L0 + NL], b.pressure[L0:L0 + NL]
        for _ in range(fc.num_sub_steps):
            # kick-drift (metal:408-423)
            vhx = vx + half_dt * ax
            vhy = vy + half_dt * ay
            x = x + vhx * sub_dt
            y = y + vhy * sub_dt
            grid = build_grid(x, y, clamp=False)
            D = to_dense(grid, dict(x=x, y=y, vx=vx, vy=vy, m=mass,
                                    occ=torch.ones_like(x)))
            if use_split:
                rho_d = _pad_rows(SK.density(torch.stack(
                    [D["x"], D["y"], D["m"], D["occ"]], dim=1), **density_kw))
                fx_d, fy_d = SK.force(torch.stack(
                    [D["x"], D["y"], D["vx"], D["vy"], D["m"], rho_d,
                     _eos(rho_d), D["occ"]], dim=1), **force_kw)
            else:
                # the sweep reads M9 planes 0-5; hx, hy and id are not its
                # inputs (lpe_tpu's scatter path hands it a 6-plane stack)
                zd = torch.zeros_like(D["x"])
                rho_d, fx_d, fy_d = SK.pair_sweep(torch.stack(
                    [D["x"], D["y"], D["vx"], D["vy"], D["m"], D["occ"], zd,
                     zd, zd], dim=1), **sweep_kw)
                rho_d = _pad_rows(rho_d)
            rho, ax, ay = from_dense(
                grid, [rho_d, _pad_rows(fx_d), _pad_rows(fy_d)])
            rho = torch.where(grid["pvalid"], rho,
                              mass * POLY6 * (h * h) ** 3)
            pres = _eos(rho)
            # second kick (metal:428-441)
            vx = vhx + half_dt * ax
            vy = vhy + half_dt * ay
            if NR > 0:
                (x, y, vx, vy, ax, ay), (dFx, dFy, dTq) = _dense_couple(
                    R, x, y, vx, vy, rho, pres, mass, ax, ay)
                Fx, Fy, Tq = Fx + dFx, Fy + dFy, Tq + dTq
        return _finalize_liquid(_finalize_rigid(state, Fx, Fy, Tq),
                                x, y, vx, vy, rho, pres)

    if fc.residency == "off":
        return step_scatter

    def step_resident(state: SimState) -> SimState:
        """Grid-resident tick: one sort/scatter at build, the sub-step
        kernels, one gather-back at tick end."""
        D0 = _grid_build(state)
        state2, D = _grid_tick(state, D0)
        return _grid_readback(state2, D)

    # cross-tick residency hooks (consumed by systems.build_run_fn)
    step_resident.grid_build = _grid_build
    step_resident.grid_tick = _grid_tick
    step_resident.grid_readback = _grid_readback
    step_resident.grid_boundary = _grid_boundary
    step_resident.grid_gravity = _grid_gravity
    # the kernels' inputs as the resident paths build them (chip_smoke.py
    # holds each kernel against its plain version on these)
    step_resident.grid_stack = _stack
    step_resident.eos = _eos
    step_resident.migrate_consts = mig_kw
    step_resident.sweep_consts = sweep_kw
    step_resident.density_consts = density_kw
    step_resident.force_consts = force_kw
    if use_cpl:
        def _coupling_inputs(state, M9):
            R = _rigid_proxies(state.bodies, NR, spec.max_rigid_verts)
            fld, bigtab, _ = _couple_field(R)
            cpl = _cpl_mask(_tile_bounds_t(M9[:, SK.M9_OCC]), R)
            return cpl, fld, bigtab

        def _coupled_cells(state):
            """A diagnostic (chip_smoke, tests), not run in a tick: on the
            first sub-step from ``state``, the cells that couple (cpl > 0)
            and those of them with a dynamic candidate in their slots (a
            rigid of finite mass, so never a wall): (cells, dynamic)."""
            M9 = SK.migrate(_stack(_grid_build(state)), **mig_kw)
            cpl, fld, _ = _coupling_inputs(state, M9)
            m = fld[:, :, SK.RW_M, :]
            dyn = ((m > 0) & (m < 1e29)).any(1)
            return int((cpl > 0).sum()), int(((cpl > 0) & dyn).sum())

        step_resident.coupling_inputs = _coupling_inputs
        step_resident.coupled_cells = _coupled_cells
        step_resident.couple_consts = _CN
    return step_resident
