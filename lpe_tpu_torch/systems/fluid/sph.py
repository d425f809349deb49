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

Mixed per-particle smoothing lengths (``spec.liquid_h_uniform`` false;
reference: fluid.cpp:293, each pair at h-bar = (h_i + h_j) / 2,
fluid_kernels.metal:362-396): the grid's cell and 3x3 support are sized by
the scene's largest h (``sph.py:225-227``), and each particle's h rides the
grid as one more plane. Such a scene takes the split kernels' mixed-h
variants whatever ``pair_backend`` says, as lpe_tpu sends it away from its
pair sweep (``sph.py:264``): resident, migrate_h -> density_h -> EOS ->
force_h -> second kick -> coupling (which reads no h); scatter, density_h +
force_h.

The same code runs on the CPU and on the GPU: only the kernel wrappers
branch, on the device of their tensors.

Kept from the JAX package: the coefficients, the first-K-per-cell drop
contract, the (dy, dx, slot) migration order and walk clamp, the S-slot
per-cell coupling raster with its overflow counter, and every formula.
Changed for the GPU: a stable argsort (so slot order within a cell can
differ from the JAX package's, and pair sums reassociate), plain gathers
in place of one-hot-matmul permutes, and per-column instead of per-128-
column-tile coupling masks.

With a mesh (``mesh=``, ``lpe_tpu_torch.parallel.make_mesh``) the fluid
runs in row bands, the counterpart of ``lpe_tpu``'s ``step_halo``
(sph.py:1695-1982): band i owns ``ceil(ny / ND)`` grid rows (the grid's
rows padded with empty ones to a multiple of ND) in a ``[band+2, K,
cols]`` block on ``mesh.devices[i]``, whose apron rows hold the neighbour
bands' edge rows. Each sub-step runs the split chain on every band, with
three one-row exchanges: the ST planes before migrate (its row offset
clamps cell rows on the whole grid), x, y, vx, vy, m, occ after it, and
rho, p before the force pass. Each band builds its coupling candidates
over its rows and sums its rigid forces; the bands' sums are added in band
order on the lead device. The rest of the state stays on the lead device.
A mixed-h scene runs unsharded, as in ``lpe_tpu``.

``pair_backend="xla"`` is a ``ValueError``: the
kernels' plain PyTorch versions, taken for CPU tensors, are the port's
counterpart of the XLA pair passes.
"""
from __future__ import annotations

import math

import torch

from ...core import constants as C
from ...core.config import ScenarioSystemConfig
from ...core.constants import MAX_POLY_VERTS, ShapeKind
from ...core.numerics import scatter_add, sqrt, true_div
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
    (``residency="off"``) has none and runs tick by tick. With ``mesh``
    (a ``parallel.BandMesh``) the step is the row-band step on the
    mesh's devices, whatever ``residency`` and ``pair_backend`` say, as
    ``lpe_tpu``'s ``step_halo``; its hooks take and return the list of
    the bands' blocks, and ``device`` is the mesh's lead."""
    fc = cfg.fluid
    var_h = not spec.liquid_h_uniform
    if var_h:
        mesh = None               # mixed h runs unsharded (sph.py:226-229)
    if mesh is not None:
        device = mesh.lead
    ND = mesh.size if mesh is not None else 1
    NL = spec.n_liquid
    K = grid_slots(fc.grid.max_per_cell, NL, device)
    if fc.residency not in ("auto", "on", "off"):
        raise ValueError(f"unknown residency {fc.residency!r}")
    if fc.pair_backend not in ("auto", "sweep", "pallas"):
        raise ValueError(
            f"pair_backend {fc.pair_backend!r}: the port has the pair sweep "
            "('auto' or 'sweep') and the split density and force kernels "
            "('pallas'); their plain PyTorch versions run on CPU tensors")
    # mixed h: the grid is sized by the largest h (h is immutable, so the
    # reference's per-sub-step rescale, fluid.cpp:723-755, is this static
    # bound), and the split chain's mixed-h variants run
    use_split = fc.pair_backend == "pallas" or var_h or mesh is not None
    if fc.grid.cell_size_factor < 1.0:
        raise ValueError("cell_size_factor must be >= 1.0 (3x3 scan needs "
                         "cells at least h wide to cover the r<h support)")
    L0 = spec.liquid_start
    NR = L0                       # solids + gas precede liquids in layout
    h = fc.grid.smoothing_length
    if var_h:
        h = max(h, float(spec.max_liquid_h))
    cell = fc.grid.cell_size_factor * h
    size = cfg.shared.universe_size_m
    gmin = -2                     # static grid: universe + 2-cell apron
    nx = int(math.ceil(size / cell)) + 4
    ny = nx
    # row bands divide evenly: the grid's rows are padded past the last of
    # its ny rows, which cell rows never reach (a row clamps to the ny rows
    # in the build and in migrate), so the padding changes no result;
    # lpe_tpu clamps to its padded row count (sph.py:239-242)
    band = -(-ny // ND)
    if mesh is not None and band < 2:
        raise ValueError(f"{ND} bands of a {ny}-row grid: a band needs at "
                         "least 2 rows")
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
    rows = band * ND + 2
    PSIZE = rows * K * W
    f32 = torch.float32

    # drift clamp: migration handles at most 1-cell moves per sub-step;
    # drift + coupling push-out (<= max_correction) stay under one cell
    _RES_LIM = 0.45 * cell
    mig_kw = dict(nx=nx, half_dt=half_dt, sub_dt=sub_dt, lim=_RES_LIM,
                  cell=cell, eps=eps, gmin=gmin)
    density_kw = dict(h=h, poly6=POLY6)
    force_h_kw = dict(viscosity=fc.viscosity,
                      min_d2=nm.min_distance_threshold,
                      min_rho=nm.min_density_threshold)
    force_kw = dict(force_h_kw, h=h, spiky=SPIKY, visc_lap=VISC)
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

    def _dense(slot, fields: dict, nrows):
        """Scatter per-particle fields into [nrows, K, W] planes at the
        flat indices ``slot`` (nrows * K * W: no slot)."""
        n = nrows * K * W
        out = {}
        for name, v in fields.items():
            flat = torch.zeros(n + 1, dtype=v.dtype, device=v.device)
            flat.scatter_(0, slot, v)
            out[name] = flat[:n].view(nrows, K, W)
        return out

    def to_dense(grid, fields: dict):
        """Scatter per-particle fields into padded [rows, K, W] planes."""
        return _dense(grid["slot_p"], fields, rows)

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

        def _band_geometry(dev, nrows, row_off):
            """The tick-constant geometry of the coupling on a block of
            ``nrows`` padded rows from global padded row ``row_off`` (the
            whole grid: ``rows`` from 0; a band: ``band + 2`` from its
            first row), on ``dev``: each row's candidate window (the
            bucket span of its chunk of the whole grid) and the extents
            of its rows and columns, for _couple_field and _cpl_mask.
            ``lpe_tpu`` takes a band row's chunk origin from the band's
            block (sph.py:856); where a window saturates its cap, its
            bands then keep other candidates than its single device. The
            whole grid's origin keeps a band row's window, and so its
            candidates, the single device's."""
            rowi = torch.arange(nrows, device=dev)
            coli = torch.arange(W, device=dev)
            g = rowi + row_off                       # global padded row
            g0 = (g // _CH) * _CH                    # its chunk's origin
            gf = g.to(f32)
            cx0 = (coli.to(f32) - 3.0) * cell - _slackm
            mx0 = (coli - 4).to(f32) * cell
            my0 = (g - 4).to(f32) * cell
            return dict(
                rows=nrows,
                lo_b=torch.clamp(g0 - _hcells, 0, ny + 1),
                hi_b=torch.clamp(g, 0, ny + 1) + 1,
                ry0=(gf - 3.0) * cell - _slackm,
                ry1=(gf - 2.0) * cell + _slackm,
                cx0=cx0, cx1=cx0 + cell + 2.0 * _slackm,
                tile=torch.clamp(coli // _CTW, max=_NTL - 1),
                mx0=mx0, mx1=mx0 + 4.0 * cell, my0=my0,
                my1=my0 + 3.0 * cell, big=_big_arr.to(dev),
                isbig=_isbig.to(dev))

        _whole = _band_geometry(device, rows, 0)

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

        def _couple_field(R, geo):
            """Tick-constant rasterized candidates on the rows of ``geo``
            (_band_geometry). Returns (fld [rows, S, Wp, W], bigtab
            [NBIG+1, Wp], meta).

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
            than two tiles). A band's rows take the candidates of the
            same rows of the whole grid, in the same order."""
            tab = _rig_cols(R)
            dev = tab.device
            if _NBIG:
                bigtab = torch.cat([tab[geo["big"]],
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
            live = (tab[:, 5] > 0) & ~geo["isbig"]
            tab2 = torch.cat([tab, tab, tab.new_zeros((1, _Wp))])
            tile2 = torch.cat([ctl0, ctl1])
            live2 = torch.cat([live, live & (ctl1 != ctl0)])
            ovf_mid = (((ctl1 - ctl0) > 1) & live).sum()
            keys_c = torch.clamp(tab[:, 10] - _slackm, -1e6, 1e6)
            NB = ny + 3
            buck = torch.clamp(torch.floor(true_div(keys_c, cell)).to(i32) + 3,
                               0, ny + 1)
            buck2 = torch.cat([buck, buck])
            key = torch.where(live2, tile2 * NB + buck2,
                              torch.full_like(tile2, _NTL * NB)) \
                .to(torch.int64)
            order = torch.argsort(key, stable=True)
            skey = key[order]
            starts = torch.searchsorted(
                skey, torch.arange(_NTL * NB + 1, device=dev))
            tabs = tab2[torch.cat([order, order.new_full((1,), _E)])]
            # window [lo, lo + cnt) of tile t for padded row g
            tb = torch.arange(_NTL, device=dev)[:, None] * NB
            lo = starts[tb + geo["lo_b"][None]]          # [NTL, rows]
            cnt = starts[tb + geo["hi_b"][None]] - lo
            iw = torch.arange(_WN, device=dev)
            pos = lo[..., None] + iw                     # [NTL, rows, WN]
            inwin = iw < cnt[..., None]
            pos = torch.where(inwin, pos, torch.full_like(pos, _E))
            win = tabs[pos]                              # [.., WN, Wp]
            yov = (win[..., 10] <= geo["ry1"][:, None]) & \
                (win[..., 12] >= geo["ry0"][:, None]) & inwin & \
                (win[..., 5] > 0)
            cx0, cx1, t = geo["cx0"], geo["cx1"], geo["tile"]
            xov = (win[t, :, :, 9] <= cx1[:, None, None]) & \
                (win[t, :, :, 11] >= cx0[:, None, None])  # [W, rows, WN]
            ov = (yov[t] & xov).permute(1, 0, 2)          # [rows, W, WN]
            rank = torch.cumsum(ov.to(i32), dim=-1)
            keep = ov & (rank <= _S)
            slot = torch.where(keep, rank - 1, torch.full_like(rank, _S))
            posw = pos[t].permute(1, 0, 2)               # [rows, W, WN]
            sel = torch.full((geo["rows"], W, _S + 1), _E,
                             dtype=torch.int64, device=dev)
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

        def _couple_reduce(meta, PL):
            """Per-tick sums of the accumulated per-(row, slot, column)
            force partials PL [rows, 3S, W] onto their rigids: [NR, 3]
            (fx, fy, tq). Masked sums in a fixed order, no float atomics,
            so the result is deterministic."""
            nrows = PL.shape[0]
            P3 = PL.view(nrows, _S, 3, W)
            body = meta["body"]                          # [rows, S, W]
            # bodies per chunk of the reduction (bounds its [chunk, E] mask)
            chunk = max(1, (1 << 24) // max(1, nrows * _S * W))
            out = []
            for j0 in range(0, NR, chunk):
                ids = torch.arange(j0, min(NR, j0 + chunk),
                                   device=PL.device)
                m = body[None] == ids.view(-1, 1, 1, 1)  # [c, rows, S, W]
                sel = torch.where(m[:, :, :, None, :], P3[None],
                                  torch.zeros((), dtype=PL.dtype,
                                              device=PL.device))
                out.append(sel.sum((1, 2, 4)))
            return torch.cat(out)

        def _cpl_mask(counts, R, geo):
            """[rows, W] int32: the cell holds particles AND a rigid AABB
            lies within a cell of slack of its column and row (coupling is
            a no-op outside the AABB). Padded column c holds particles
            with x in [(c-3)*cell, (c-2)*cell); a row's extent is its
            global row's (``geo``, _band_geometry)."""
            tx0, tx1 = geo["mx0"], geo["mx1"]
            ry0, ry1 = geo["my0"], geo["my1"]
            ovx = (R["minx"][None, :] <= tx1[:, None]) & \
                (R["maxx"][None, :] >= tx0[:, None])      # [W, NR]
            ovy = (R["miny"][None, :] <= ry1[:, None]) & \
                (R["maxy"][None, :] >= ry0[:, None]) & R["valid"][None, :]
            hit = (ovy.to(f32) @ ovx.to(f32).T) > 0      # [rows, W]
            return ((counts > 0) & hit).to(torch.int32)

        def _rigid_forces(meta, PL, BF, geo):
            """The tick's per-rigid force sums (Fx, Fy, Tq) of a block:
            the big solids' BF [NBIG, 3] (fx, fy, tq, summed over the
            sub-steps in turn) on their rigids, plus the partials PL
            reduced onto theirs (_couple_reduce)."""
            F3 = PL.new_zeros((NR, 3))
            if _NBIG:
                F3 = scatter_add(F3, geo["big"], BF)
            Fs = _couple_reduce(meta, PL)
            return F3[:, 0] + Fs[:, 0], F3[:, 1] + Fs[:, 1], \
                F3[:, 2] + Fs[:, 2]

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

    def _liquid_fields(state: SimState):
        """The liquid slice's per-particle fields a grid holds (id: the
        particle's index + 1, 0 = empty)."""
        b = state.bodies
        x = b.pos[L0:L0 + NL, 0]
        idf = torch.arange(1, NL + 1, dtype=f32, device=x.device)
        flds = dict(
            x=x, y=b.pos[L0:L0 + NL, 1], vx=b.vel[L0:L0 + NL, 0],
            vy=b.vel[L0:L0 + NL, 1], m=b.mass[L0:L0 + NL], id=idf,
            occ=torch.ones_like(x))
        if var_h:
            flds["h"] = b.h[L0:L0 + NL]
        return flds

    def _with_zeros(D0):
        zd = torch.zeros_like(D0["x"])
        return dict(D0, hx=zd, hy=zd, ax=zd, ay=zd, rho=zd, p=zd)

    def _grid_build(state: SimState):
        """Sort+scatter the liquid slice into the dense grid (once per
        tick — or once per block under cross-tick residency)."""
        flds = _liquid_fields(state)
        grid = build_grid(flds["x"], flds["y"], clamp=True)
        return _with_zeros(to_dense(grid, flds))

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
            cpl = _cpl_mask(_tile_bounds_t(M9[:, SK.M9_OCC]), R, _whole)
            ST, pl, bigp = SK.coupling9(cpl, fld, bigtab, M9, rho, fx, fy,
                                        cn=_CN)
            BF = cr["BF"]
            if _NBIG:
                BF = BF + bigp.sum((0, 1)).view(_NBIG, 3)
            return dict(ST=ST, RHO=rho, PL=cr["PL"] + pl, BF=BF)
        fxp, fyp = _pad_rows(fx), _pad_rows(fy)
        vx1 = M9[:, SK.M9_HX] + half_dt * fxp
        vy1 = M9[:, SK.M9_HY] + half_dt * fyp
        ST2 = torch.stack([M9[:, SK.M9_X], M9[:, SK.M9_Y], vx1, vy1, fxp,
                           fyp, M9[:, SK.M9_M], M9[:, SK.M9_ID],
                           M9[:, SK.M9_OCC]], dim=1)
        return dict(cr, ST=ST2, RHO=rho)

    # bytes and copies of the bands' halo exchanges since the step was
    # built (a reader may set them to 0)
    halo_stats = dict(bytes=0, copies=0)

    def _exchange(blocks, planes=slice(None)):
        """Refresh the halo rows of the bands' stacked blocks from their
        neighbours' edge rows (``mesh.exchange``); one band has none."""
        if len(blocks) > 1:
            halo_stats["bytes"] += mesh.exchange(blocks, planes)
            halo_stats["copies"] += 2 * (len(blocks) - 1)

    def _substep_split(crs, bands):
        """One sub-step with the split kernels on each band's plane dict
        ``crs[i]["D"]`` (``lpe_tpu`` _make_res_substep, sph.py:1438-1528;
        per band _make_halo_substep, :1790-1866; the whole grid is one
        band): migrate (kick, clamped drift, re-bin: the kernel the
        stacked chain uses, whose result is the JAX package's XLA
        ``_migrate``), density, EOS, force, second kick, coupling. The
        planes keep the previous sub-step's rho and p until the density
        pass overwrites them. Between the passes the bands exchange edge
        rows: the ST planes before migrate (``lpe_tpu`` sends the
        post-drift planes; migrate kicks and drifts a halo slot with its
        owner's arithmetic, so the same bits), x, y, vx, vy, m, occ after
        it, and rho, p before the force pass. Mixed h (never banded): the
        h plane rides migrate_h, and density_h and force_h take it."""
        STs = []
        for cr in crs:
            D = cr["D"]
            st = [D["x"], D["y"], D["vx"], D["vy"], D["ax"], D["ay"],
                  D["m"], D["id"], D["occ"]]
            STs.append(torch.stack(st + [D["h"]] if var_h else st, dim=1))
        _exchange(STs)                              # all nine ST planes
        migrate = SK.migrate_h if var_h else SK.migrate
        Ms = [migrate(ST, **mig_kw, **b["mig"]) for ST, b in zip(STs, bands)]
        _exchange(Ms, slice(SK.M9_X, SK.M9_OCC + 1))   # x, y, vx, vy, m, occ
        D8s = []
        for M in Ms:
            x1, y1, vx, vy, m, occ = M.unbind(1)[:6]
            if var_h:
                hp = M[:, SK.M10_H]
                rho = _pad_rows(SK.density_h(
                    torch.stack([x1, y1, m, occ, hp], dim=1)))
            else:
                rho = _pad_rows(SK.density(
                    torch.stack([x1, y1, m, occ], dim=1), **density_kw))
            D8 = [x1, y1, vx, vy, m, rho, _eos(rho), occ]
            D8s.append(torch.stack(D8 + [hp] if var_h else D8, dim=1))
        _exchange(D8s, slice(SK.D8_RHO, SK.D8_P + 1))  # rho, p
        out = []
        for cr, b, M, D8 in zip(crs, bands, Ms, D8s):
            x1, y1, vx, vy, m, occ, hx, hy, pid = M.unbind(1)[:9]
            if var_h:
                fx, fy = SK.force_h(D8, **force_h_kw)
            else:
                fx, fy = SK.force(D8, **force_kw)
            rho, pres = D8[:, SK.D8_RHO], D8[:, SK.D8_P]
            ax1, ay1 = _pad_rows(fx), _pad_rows(fy)
            vx1 = hx + half_dt * ax1
            vy1 = hy + half_dt * ay1
            Dn = dict(x=x1, y=y1, vx=vx1, vy=vy1, ax=ax1, ay=ay1, m=m,
                      id=pid, occ=occ, hx=hx, hy=hy, rho=rho, p=pres)
            if var_h:
                Dn["h"] = M[:, SK.M10_H]
            if NR == 0:
                out.append(dict(cr, D=Dn))
                continue
            cpl = _cpl_mask(_tile_bounds_t(occ), b["R"], b["geo"])
            x2, y2, vx2, vy2, axf, ayf, pl, bigp = SK.coupling(
                cpl, b["fld"], b["bigtab"], torch.stack(
                    [x1, y1, vx1, vy1, rho, pres, m, occ, ax1, ay1], dim=1),
                cn=_CN)
            BF = cr["BF"]
            if _NBIG:
                BF = BF + bigp.sum((0, 1)).view(_NBIG, 3)
            out.append(dict(
                D=dict(Dn, x=x2, y=y2, vx=vx2, vy=vy2, ax=axf, ay=ayf),
                PL=cr["PL"] + pl, BF=BF))
        return out

    def _split_tick(state: SimState, Ds, geos):
        """One fluid tick of the split kernels on the blocks ``Ds`` (one a
        band, in band order; the whole grid is one band) and the per-tick
        rigid velocity write-back. Each band rasterizes the coupling
        candidates over its rows (``geos``) and reduces its own force
        partials; the bands' force sums are added in band order on the
        lead device (``lpe_tpu``: a psum, sph.py:1868-1905)."""
        R0 = _rigid_proxies(state.bodies, NR, spec.max_rigid_verts) \
            if NR > 0 else None
        bands, crs = [], []
        for i, D in enumerate(Ds):
            # accelerations reset at tick start (the reference zero-inits
            # them on every particle gather, fluid.cpp:250-302)
            zd = torch.zeros_like(D["x"])
            b = dict(mig=dict(row_off=i * band, ny=ny))
            cr = dict(D=dict(D, ax=zd, ay=zd))
            if use_cpl:
                R = {k: v.to(zd.device) for k, v in R0.items()}
                fld, bigtab, meta = _couple_field(R, geos[i])
                b.update(R=R, geo=geos[i], fld=fld, bigtab=bigtab, meta=meta)
                cr.update(PL=zd.new_zeros((D["x"].shape[0], 3 * _S, W)),
                          BF=zd.new_zeros((_NBIG, 3)))
            bands.append(b)
            crs.append(cr)
        for _ in range(fc.num_sub_steps):
            crs = _substep_split(crs, bands)
        F = [None] * 3                      # no rigid: nothing to write
        if use_cpl:
            for cr, b in zip(crs, bands):
                Fb = _rigid_forces(b["meta"], cr["PL"], cr["BF"], b["geo"])
                F = [v.to(device) if s is None else s + v.to(device)
                     for s, v in zip(F, Fb)]
        return _finalize_rigid(state, *F), [cr["D"] for cr in crs]

    def _grid_tick(state: SimState, D):
        """One fluid tick on the resident grid: sub-steps + the per-tick
        rigid velocity write-back."""
        if use_split:
            state, (D2,) = _split_tick(state, [D], [_whole] if use_cpl
                                       else [None])
            return state, D2
        R = _rigid_proxies(state.bodies, NR, spec.max_rigid_verts) \
            if NR > 0 else None
        fld = bigtab = cmeta = None
        if use_cpl:
            fld, bigtab, cmeta = _couple_field(R, _whole)
        # accelerations reset at tick start (fluid.cpp:250-302)
        zd = torch.zeros_like(D["x"])
        cr = dict(RHO=None, ST=_stack(D))
        if use_cpl:
            cr.update(PL=zd.new_zeros((rows, 3 * _S, W)),
                      BF=zd.new_zeros((_NBIG, 3)))
        for _ in range(fc.num_sub_steps):
            cr = _substep(cr, R, fld, bigtab)
        Fx = Fy = Tq = None                 # no rigid: nothing to write
        if use_cpl:
            Fx, Fy, Tq = _rigid_forces(cmeta, cr["PL"], cr["BF"], _whole)
        STf = cr["ST"]
        rho_pad = _pad_rows(cr["RHO"])
        D2 = dict(x=STf[:, 0], y=STf[:, 1], vx=STf[:, 2], vy=STf[:, 3],
                  ax=STf[:, 4], ay=STf[:, 5], m=STf[:, 6], id=STf[:, 7],
                  occ=STf[:, 8], hx=zd, hy=zd, rho=rho_pad, p=_eos(rho_pad))
        return _finalize_rigid(state, Fx, Fy, Tq), D2

    def _read_blocks(state: SimState, blocks):
        """Gather liquid state back to particle order from the blocks
        (dicts of planes; each occupied slot holds the particle of its
        id), which hold every particle at most once. Particles dropped by
        cell overflow (rank >= K at build or migration) keep their old
        values for the block, as in lpe_tpu."""
        b = state.bodies
        keys = ("x", "y", "vx", "vy", "rho", "p")
        cur = [b.pos[L0:L0 + NL, 0], b.pos[L0:L0 + NL, 1],
               b.vel[L0:L0 + NL, 0], b.vel[L0:L0 + NL, 1],
               b.density[L0:L0 + NL], b.pressure[L0:L0 + NL]]
        for D in blocks:
            dev = D["id"].device
            flat_id = torch.round(D["id"].reshape(-1)).to(torch.int64)
            occf = D["occ"].reshape(-1) > 0
            tgt = torch.where(occf, flat_id - 1,
                              torch.full_like(flat_id, NL))
            slot_of = torch.full((NL + 1,), -1, dtype=torch.int64,
                                 device=dev)
            slot_of.scatter_(0, tgt, torch.arange(tgt.numel(), device=dev))
            slot_of = slot_of[:NL]
            res_mask = (slot_of >= 0).to(device)
            gi = torch.clamp(slot_of, min=0)
            cur = [torch.where(res_mask, D[k].reshape(-1)[gi].to(device), c)
                   for k, c in zip(keys, cur)]
        return _finalize_liquid(state, *cur)

    def _grid_readback(state: SimState, D):
        return _read_blocks(state, [D])

    def _band_step(mesh):
        """The row-band step on ``mesh`` (``lpe_tpu`` step_halo,
        sph.py:1695-1982), with its cross-tick hooks, which take and
        return the list of the bands' blocks: ``systems.build_run_fn``
        keeps them resident across a block. Halo rows go stale between
        ticks; every sub-step exchanges them again before they are read.
        ``halo_stats`` counts the exchanges' bytes and copies."""
        geos = [_band_geometry(dev, band + 2, i * band) if use_cpl else None
                for i, dev in enumerate(mesh.devices)]
        plane = K * W
        n_b = (band + 2) * plane

        def _halo_build(state: SimState):
            """The bands' blocks [band+2, K, W]: one stable sort of all
            particles (build_grid, as the single-device build: a cell keeps
            its first K by index), then each band scatters the particles
            of its rows into its block on its device; halo rows start
            empty (``lpe_tpu`` _halo_build_core, sph.py:1745-1788)."""
            flds = _liquid_fields(state)
            grid = build_grid(flds["x"], flds["y"], clamp=True)
            blocks = []
            for i, dev in enumerate(mesh.devices):
                loc = grid["slot_p"] - i * band * plane
                mine = grid["pvalid"] & (loc >= plane) & \
                    (loc < (band + 1) * plane)
                slot = torch.where(mine, loc, torch.full_like(loc, n_b))
                blocks.append(_with_zeros(_dense(
                    slot.to(dev), {k: v.to(dev) for k, v in flds.items()},
                    band + 2)))
            return blocks

        def _halo_tick(state: SimState, Ds):
            return _split_tick(state, Ds, geos)

        def _halo_readback(state: SimState, Ds):
            """Each band's interior rows back to particle order by id. A
            particle sits in at most one band's interior (its halo copies
            are read by its neighbours), so the bands' values are
            selected, not summed (``lpe_tpu``: a reduce-scatter by id,
            sph.py:1907-1921)."""
            keys = ("id", "occ", "x", "y", "vx", "vy", "rho", "p")
            return _read_blocks(state, [{k: D[k][1:-1] for k in keys}
                                        for D in Ds])

        def step_halo(state: SimState) -> SimState:
            """Band tick: one build, the sub-steps of every band, one
            readback."""
            state2, Ds = _halo_tick(state, _halo_build(state))
            return _halo_readback(state2, Ds)

        def band_of(y):
            """The band of each position ``y``: that of its cell row, as
            the build clamps it."""
            gy = torch.floor(true_div(y + eps, cell)).to(torch.int32) - gmin
            return torch.clamp(gy, 0, ny - 1) // band

        step_halo.grid_build = _halo_build
        step_halo.grid_tick = _halo_tick
        step_halo.grid_readback = _halo_readback
        step_halo.grid_boundary = lambda Ds: [_grid_boundary(D) for D in Ds]
        step_halo.grid_gravity = lambda state, Ds: [_grid_gravity(state, D)
                                                    for D in Ds]
        step_halo.mesh = mesh
        step_halo.band_rows = band
        step_halo.band_of = band_of
        step_halo.halo_stats = halo_stats
        return step_halo

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
        dt = (_g_base_dt * state.base_time_accel * state.time_scale) \
            .to(D["vy"].device)
        vy = torch.where(D["occ"] > 0, D["vy"] + _g_accel * dt, D["vy"])
        return dict(D, vy=vy)

    def step_scatter(state: SimState) -> SimState:
        """Per-tick scatter step (``lpe_tpu`` step, sph.py:1249-1322):
        every sub-step integrates in particle order, builds a fresh grid
        (a particle off the grid or beyond a cell's K slots gets no slot:
        it takes the self density ``m*poly6*h^6`` at its own h and zero pair
        force, and integrates ballistically), runs the pair pass on it and
        couples in dense [NR, NL] code."""
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
        if var_h:
            # lpe_tpu's overflow self density at the particle's own h,
            # sph.py:533, its powers multiplied as XLA's integer_pow does
            hs = b.h[L0:L0 + NL]
            h2 = hs * hs
            h4 = h2 * h2
            self_rho = mass * true_div(4.0, math.pi * (h4 * h4)) \
                * (h2 * (h2 * h2))
        else:
            self_rho = mass * POLY6 * (h * h) ** 3
        for _ in range(fc.num_sub_steps):
            # kick-drift (metal:408-423)
            vhx = vx + half_dt * ax
            vhy = vy + half_dt * ay
            x = x + vhx * sub_dt
            y = y + vhy * sub_dt
            grid = build_grid(x, y, clamp=False)
            flds = dict(x=x, y=y, vx=vx, vy=vy, m=mass,
                        occ=torch.ones_like(x))
            if var_h:
                flds["h"] = hs
            D = to_dense(grid, flds)
            if var_h:
                rho_d = _pad_rows(SK.density_h(torch.stack(
                    [D["x"], D["y"], D["m"], D["occ"], D["h"]], dim=1)))
                fx_d, fy_d = SK.force_h(torch.stack(
                    [D["x"], D["y"], D["vx"], D["vy"], D["m"], rho_d,
                     _eos(rho_d), D["occ"], D["h"]], dim=1), **force_h_kw)
            elif use_split:
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
            rho = torch.where(grid["pvalid"], rho, self_rho)
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

    if mesh is not None:
        return _band_step(mesh)
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
    step_resident.force_h_consts = force_h_kw
    if use_cpl:
        def _coupling_inputs(state, M9):
            R = _rigid_proxies(state.bodies, NR, spec.max_rigid_verts)
            fld, bigtab, _ = _couple_field(R, _whole)
            cpl = _cpl_mask(_tile_bounds_t(M9[:, SK.M9_OCC]), R, _whole)
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
