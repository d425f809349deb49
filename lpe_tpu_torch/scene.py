"""Scene construction: host-side entity accumulation -> device SoA state.

The PyTorch counterpart of ``lpe_tpu/scene.py``. Scenario builders append
entities to a :class:`SceneBuilder`; ``finalize(cfg, device=...)`` groups
them by phase (solids first, then gas, then liquid), pads capacity to a
multiple of 128, and produces the :class:`SimState` of tensors on
``device`` plus the static :class:`SceneSpec` the systems specialize on.
Every static statistic is computed in numpy exactly as ``lpe_tpu`` does,
so a scene built by either package from the same seed is bitwise equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .core import constants
from .core.config import ScenarioSystemConfig
from .core.constants import Phase, ShapeKind
from .state import Bodies, SimState, make_state


@dataclass
class EntityProto:
    """Host-side staging record for one entity."""

    pos: tuple[float, float]
    vel: tuple[float, float] = (0.0, 0.0)
    mass: float = 1.0
    phase: int = int(Phase.SOLID)
    boundary: bool = False
    shape_kind: int = int(ShapeKind.CIRCLE)
    radius: float = 1.0
    verts: np.ndarray | None = None      # local CCW vertices [k, 2]
    angle: float = 0.0
    omega: float = 0.0
    inertia: float = 0.0                  # <=0: cannot rotate (no Inertia comp)
    has_sleep: bool = False
    asleep: bool = False
    sleep_counter: int = 0
    static_friction: float = 0.5
    dynamic_friction: float = 0.3
    color: tuple[int, int, int] = (255, 255, 255)
    speed_of_sound: float = 1000.0
    smoothing_length: float = 0.0         # 0 -> fluid cfg default at gather
    temperature: float | None = None      # None: no Temperature component


@dataclass(frozen=True)
class SceneSpec:
    """Static (non-traced) facts the tick builder specializes on."""

    capacity: int
    n_entities: int
    n_solid: int
    n_gas: int
    n_liquid: int
    # slices into the arrays (solids at 0, then gas, then liquid, then pad)
    solid_start: int = 0
    gas_start: int = 0
    liquid_start: int = 0
    # static mass facts used for system auto-enable decisions (masses are
    # immutable at runtime, as in the reference where no system writes Mass)
    max_nonboundary_mass: float = 0.0
    max_mass_overall: float = 0.0
    # static broadphase-grid facts (shapes are immutable; bounding radii are
    # rotation-invariant): cell edge sized to the largest non-"big" solid,
    # and the indices of the few oversized solids (walls etc.) that are
    # paired densely instead of through the grid
    solid_cell_size: float = 0.0
    solid_big_idx: tuple = ()
    # every "big" solid is an infinite-mass boundary wall: lets the grid
    # rigid pipeline treat them as frozen contact partners
    solid_big_all_boundary: bool = True
    # max non-big solids per broadphase cell at scene BUILD time: the grid
    # rigid pipeline auto-sizes its per-cell slot/row capacities from real
    # scene density instead of a worst-case constant (a 13 m universe with
    # 0.6 bodies/cell was paying 48-slot selects everywhere). Runtime
    # saturation is observable via core.telemetry.capacity_report.
    solid_max_cell_occ0: int = 0
    # initial-density seeds for the fluid<->rigid coupling raster
    # (systems/fluid/sph.py coupling_dims): max rigids covering one fluid
    # grid cell / one padded grid row (slack-widened AABBs, non-big
    # non-liquid entities), and the max bounding DIAMETER of those
    # entities (static: rotation-invariant) bounding the sorted-window
    # span of the field build
    coupling_max_cell_cover0: int = 0
    coupling_max_row_cover0: int = 0
    coupling_max_diam: float = 0.0
    # max candidate-copy population of one (128-column x-tile,
    # hcells+CH-row) sorted-bucket window of the chunked field build
    # (sph.py _couple_field) — seeds its per-tile window capacity
    coupling_max_win0: int = 0
    # static max polygon vertex count over the non-liquid entities: the
    # fluid-coupling kernels size their vertex loops to this instead of
    # MAX_POLY_VERTS (walls are 4-gons; a 16-wide vert axis would 4x the
    # point-in-polygon / closest-point work)
    max_rigid_verts: int = constants.MAX_POLY_VERTS
    # same for the solid slice only (rigid narrowphase/clipping); >= 8 when
    # any solid circle exists (circles clip as 8-gons, narrowphase.cpp:56-67)
    max_solid_verts: int = constants.MAX_POLY_VERTS
    # static shape-population facts over the non-liquid slice: when a scene
    # has no circle (or no polygon) rigids, the fluid-coupling kernels
    # constant-fold the dead branch away (XLA DCEs it)
    any_rigid_circle: bool = True
    any_rigid_polygon: bool = True
    # static fact gating cross-tick grid residency (systems.build_run_fn):
    # a liquid with a Sleep component would need fresh per-tick velocities
    # in particle order, which a grid-resident block doesn't materialize
    liquid_has_sleep: bool = False
    # per-particle smoothing lengths (reference: fluid.cpp:293 gathers h per
    # particle; fluid_kernels.metal:362-396 uses the pairwise average).
    # Uniform-h scenes (all 7 reference scenarios) take the fast kernel
    # paths with build-time-baked coefficients; mixed-h scenes use the XLA
    # pair path with per-pair h-bar (systems/fluid/sph.py).
    liquid_h_uniform: bool = True
    max_liquid_h: float = 0.0
    name: str = "scene"

    @property
    def solid_slice(self):
        return slice(self.solid_start, self.solid_start + self.n_solid)

    @property
    def liquid_slice(self):
        return slice(self.liquid_start, self.liquid_start + self.n_liquid)


def _round_capacity(n: int) -> int:
    """Pad to a multiple of 128 lanes (min 128) for TPU-friendly shapes."""
    return max(128, -(-n // 128) * 128)


class SceneBuilder:
    def __init__(self, name: str = "scene"):
        self.name = name
        self.entities: list[EntityProto] = []

    def add(self, **kw) -> EntityProto:
        e = EntityProto(**kw)
        self.entities.append(e)
        return e

    # -- convenience constructors used by several scenarios ----------------
    def add_wall(self, cx, cy, half_w, half_h, *, mass=1e30,
                 static_friction=0.5, dynamic_friction=0.3,
                 color=(60, 60, 60)) -> EntityProto:
        """Static rectangle wall: infinite mass, asleep, Boundary-tagged
        (reference: src/scenarios/random_polygons.cpp:34-74)."""
        verts = np.array([[-half_w, -half_h], [-half_w, half_h],
                          [half_w, half_h], [half_w, -half_h]], np.float64)
        return self.add(
            pos=(cx, cy), mass=mass, phase=int(Phase.SOLID), boundary=True,
            shape_kind=int(ShapeKind.POLYGON), radius=half_h, verts=verts,
            has_sleep=True, asleep=True, sleep_counter=9999999,
            static_friction=static_friction, dynamic_friction=dynamic_friction,
            color=color,
        )

    def finalize(self, cfg: ScenarioSystemConfig, *, device,
                 extra_capacity: int = 0) -> "Scene":
        order = {int(Phase.SOLID): 0, int(Phase.GAS): 1, int(Phase.LIQUID): 2}
        ents = sorted(self.entities, key=lambda e: order[e.phase])
        n = len(ents)
        cap = _round_capacity(n + extra_capacity)
        V = constants.MAX_POLY_VERTS

        def arr(shape, dt, fill=0):
            a = np.zeros(shape, dt)
            if fill:
                a[...] = fill
            return a

        pos = arr((cap, 2), np.float64)
        vel = arr((cap, 2), np.float64)
        mass = arr((cap,), np.float64, 1.0)
        angle = arr((cap,), np.float64)
        omega = arr((cap,), np.float64)
        inertia = arr((cap,), np.float64)
        shape_kind = arr((cap,), np.int32)
        radius = arr((cap,), np.float64, 1.0)
        verts = arr((cap, V, 2), np.float64)
        nverts = arr((cap,), np.int32)
        phase = arr((cap,), np.int32)
        boundary = arr((cap,), bool)
        has_sleep = arr((cap,), bool)
        asleep = arr((cap,), bool)
        sleep_counter = arr((cap,), np.int32)
        active = arr((cap,), bool)
        sfric = arr((cap,), np.float64, 0.5)
        dfric = arr((cap,), np.float64, 0.3)
        color = arr((cap, 3), np.uint8, 255)
        temperature = arr((cap,), np.float64)
        has_temperature = arr((cap,), bool)
        h = arr((cap,), np.float64)
        c = arr((cap,), np.float64, 1000.0)

        n_by_phase = {0: 0, 1: 0, 2: 0}
        for i, e in enumerate(ents):
            pos[i] = e.pos
            vel[i] = e.vel
            mass[i] = e.mass
            angle[i] = e.angle
            omega[i] = e.omega
            inertia[i] = e.inertia
            shape_kind[i] = e.shape_kind
            radius[i] = e.radius
            if e.verts is not None:
                k = len(e.verts)
                if k > V:
                    raise ValueError(f"polygon has {k} > {V} vertices")
                verts[i, :k] = e.verts
                nverts[i] = k
            phase[i] = e.phase
            boundary[i] = e.boundary
            has_sleep[i] = e.has_sleep
            asleep[i] = e.asleep
            sleep_counter[i] = e.sleep_counter
            sfric[i] = e.static_friction
            dfric[i] = e.dynamic_friction
            color[i] = e.color
            if e.temperature is not None:
                temperature[i] = e.temperature
                has_temperature[i] = True
            c[i] = e.speed_of_sound
            hh = e.smoothing_length or cfg.fluid.grid.smoothing_length
            h[i] = hh
            active[i] = True
            n_by_phase[e.phase] += 1

        ns, ng, nl = (n_by_phase[int(Phase.SOLID)], n_by_phase[int(Phase.GAS)],
                      n_by_phase[int(Phase.LIQUID)])
        nb_mass = mass[:n][~boundary[:n]] if n else np.zeros(0)
        # broadphase-grid statics: rotation-invariant bounding radius per
        # solid; "big" solids (over ~3x the median, e.g. walls) are paired
        # densely, the rest through a uniform grid of cells sized to cover
        # the largest non-big AABB (see systems/rigid/pipeline.py)
        cell_size, big_idx = 0.0, ()
        big_all_bnd = True
        occ0 = 0
        if ns:
            rb = np.where(
                shape_kind[:ns] == int(ShapeKind.CIRCLE), radius[:ns],
                np.linalg.norm(verts[:ns], axis=-1).max(-1))
            med = np.median(rb[rb > 0]) if (rb > 0).any() else 1.0
            big = np.flatnonzero(rb > 3.0 * med)
            if nl:
                # coupling-raster invariant: small candidates are copied
                # only into the x-tiles containing their widened-AABB EDGES
                # (sph.py _couple_field), so a body whose widened AABB can
                # span >= 3 coupling tiles must ride the dense bigtab
                # side-channel regardless of how it compares to the median
                # (ADVICE r4 medium — uniformly-large-rigid scenes).
                fcell_b = (cfg.fluid.grid.smoothing_length
                           * cfg.fluid.grid.cell_size_factor)
                slack_b = (float(cfg.fluid.coupling_raster_slack_cells)
                           * fcell_b)
                tile_w = constants.COUPLE_TILE_COLS * fcell_b
                big = np.union1d(big, np.flatnonzero(
                    2.0 * (rb + slack_b) > tile_w)).astype(np.int64)
            if big.size > 64:          # cap the dense block; the grid cell
                big = big[np.argsort(-rb[big])[:64]]   # grows to cover rest
            nonbig = np.setdiff1d(np.arange(ns), big)
            max_nb = float(rb[nonbig].max()) if nonbig.size else float(med)
            cell_size = max(2.0 * max_nb, 1e-9)
            big_idx = tuple(int(i) for i in big)
            big_all_bnd = bool(
                (boundary[big] & (mass[big] > 1e29)).all()) if big.size \
                else True
            # initial max per-cell occupancy at the grid pipeline's cell
            # edge (cell_size + persistence slack, the same geometry as
            # grid_pipeline.grid_dims) — the density seed for capacity
            # auto-sizing
            if nonbig.size:
                cb = cell_size + float(cfg.rigid.broadphase.persist_slack_m)
                gx = np.floor(pos[nonbig, 0] / cb).astype(np.int64)
                gy = np.floor(pos[nonbig, 1] / cb).astype(np.int64)
                _, cnt = np.unique(gy << 32 | (gx & 0xFFFFFFFF),
                                   return_counts=True)
                occ0 = int(cnt.max())
        # coupling-raster density seeds (non-big non-liquid entities vs the
        # FLUID grid; see systems/fluid/sph.py coupling_dims)
        cpl_cell0 = cpl_row0 = cpl_win0 = 0
        cpl_diam = 0.0
        nrig = ns + ng
        if nrig and nl:
            fcell = (cfg.fluid.grid.smoothing_length
                     * cfg.fluid.grid.cell_size_factor)
            slackm = float(cfg.fluid.coupling_raster_slack_cells) * fcell
            idx = np.setdiff1d(np.arange(nrig), np.asarray(big_idx, int))
            if idx.size:
                ca = np.cos(angle[idx])[:, None]
                sa = np.sin(angle[idx])[:, None]
                vx_ = verts[idx, :, 0]
                vy_ = verts[idx, :, 1]
                wx = pos[idx, None, 0] + vx_ * ca - vy_ * sa
                wy = pos[idx, None, 1] + vx_ * sa + vy_ * ca
                vm = np.arange(V)[None, :] < nverts[idx, None]
                big_f = 1e30
                circ = shape_kind[idx] == int(ShapeKind.CIRCLE)
                r = radius[idx]
                mnx = np.where(circ, pos[idx, 0] - r,
                               np.where(vm, wx, big_f).min(1)) - slackm
                mxx = np.where(circ, pos[idx, 0] + r,
                               np.where(vm, wx, -big_f).max(1)) + slackm
                mny = np.where(circ, pos[idx, 1] - r,
                               np.where(vm, wy, big_f).min(1)) - slackm
                mxy = np.where(circ, pos[idx, 1] + r,
                               np.where(vm, wy, -big_f).max(1)) + slackm
                rows = int(math.ceil(cfg.shared.universe_size_m / fcell)) + 6
                # x-column count mirrors sph.py's padded-column geometry
                # (ceil(universe_x/fcell)+6); tiles run along X, so the
                # tile count derives from COLS, not rows (ADVICE r4 low —
                # only coincidentally equal for square universes)
                cols = int(math.ceil(cfg.shared.universe_size_m / fcell)) + 6
                cy0 = np.clip(np.floor(mny / fcell).astype(int) + 3,
                              0, rows - 1)
                cy1 = np.clip(np.floor(mxy / fcell).astype(int) + 3,
                              0, rows - 1)
                cx0 = np.clip(np.floor(mnx / fcell).astype(int) + 3,
                              0, cols - 1)
                cx1 = np.clip(np.floor(mxx / fcell).astype(int) + 3,
                              0, cols - 1)
                cov = np.zeros((rows, rows), np.int64)
                rcov = np.zeros((rows,), np.int64)
                for a0, a1, b0, b1 in zip(cy0, cy1, cx0, cx1):
                    cov[a0:a1 + 1, b0:b1 + 1] += 1
                    rcov[a0:a1 + 1] += 1
                cpl_cell0 = int(cov.max())
                cpl_row0 = int(rcov.max())
                rb_c = np.where(circ, r, np.sqrt(
                    np.where(vm, vx_ ** 2 + vy_ ** 2, 0.0)).max(1))
                cpl_diam = float(2.0 * rb_c.max()) if rb_c.size else 0.0
                # chunked-window population (sph.py _couple_field): copies
                # binned by (x-tile of the widened AABB edge, bottom-edge
                # bucket), max summed over one hcells+CH-row strip
                hc = int(math.ceil((cpl_diam + 2.0 * slackm) / fcell)) + 1
                ch = constants.COUPLE_CHUNK_ROWS
                buck = np.clip(np.floor(mny / fcell).astype(int) + 3,
                               0, rows - 1)
                ntl = cols // constants.COUPLE_TILE_COLS + 2
                ct0 = np.clip(cx0 // constants.COUPLE_TILE_COLS, 0, ntl - 1)
                ct1 = np.clip(cx1 // constants.COUPLE_TILE_COLS, 0, ntl - 1)
                bc = np.zeros((ntl, rows), np.int64)
                np.add.at(bc, (ct0, buck), 1)
                dup = ct1 != ct0
                np.add.at(bc, (ct1[dup], buck[dup]), 1)
                w = min(hc + ch, rows)
                cs = np.concatenate(
                    [np.zeros((ntl, 1), np.int64), np.cumsum(bc, 1)], 1)
                cpl_win0 = int((cs[:, w:] - cs[:, :-w]).max()) \
                    if rows > w else int(bc.sum(1).max())
        spec = SceneSpec(
            capacity=cap, n_entities=n, n_solid=ns, n_gas=ng, n_liquid=nl,
            solid_start=0, gas_start=ns, liquid_start=ns + ng,
            max_nonboundary_mass=float(nb_mass.max()) if nb_mass.size else 0.0,
            max_mass_overall=float(mass[:n].max()) if n else 0.0,
            solid_cell_size=cell_size, solid_big_idx=big_idx,
            solid_big_all_boundary=big_all_bnd,
            solid_max_cell_occ0=occ0,
            coupling_max_cell_cover0=cpl_cell0,
            coupling_max_row_cover0=cpl_row0,
            coupling_max_diam=cpl_diam,
            coupling_max_win0=cpl_win0,
            max_rigid_verts=max(3, int(nverts[:ns + ng].max(initial=0))),
            max_solid_verts=max(
                3, int(nverts[:ns].max(initial=0)),
                8 if (shape_kind[:ns] == int(ShapeKind.CIRCLE)).any() else 0),
            any_rigid_circle=bool(
                (shape_kind[:ns + ng] == int(ShapeKind.CIRCLE)).any()),
            any_rigid_polygon=bool(
                (shape_kind[:ns + ng] == int(ShapeKind.POLYGON)).any()),
            liquid_has_sleep=bool(has_sleep[ns + ng:n].any()),
            liquid_h_uniform=bool(
                nl == 0 or np.ptp(h[ns + ng:n]) == 0.0),
            max_liquid_h=float(h[ns + ng:n].max()) if nl else 0.0,
            name=self.name,
        )

        def f(a):   # float64 staging -> float32, round to nearest as jnp
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        bodies = Bodies(
            pos=f(pos), vel=f(vel), mass=f(mass), angle=f(angle),
            omega=f(omega), inertia=f(inertia), shape_kind=t(shape_kind),
            radius=f(radius), verts=f(verts), nverts=t(nverts),
            phase=t(phase), boundary=t(boundary), has_sleep=t(has_sleep),
            asleep=t(asleep), sleep_counter=t(sleep_counter),
            active=t(active), static_friction=f(sfric),
            dynamic_friction=f(dfric), color=t(color),
            temperature=f(temperature), has_temperature=t(has_temperature),
            h=f(h), c=f(c), density=zf(cap), pressure=zf(cap),
            vhalf=zf(cap, 2),
        )
        mp = max(1, cfg.rigid.broadphase.max_pairs)
        from .systems.rigid.grid_pipeline import grid_dims
        gd = grid_dims(spec, cfg)
        gkw = {} if gd is None else dict(
            grid_cells=gd["NC"], grid_slots=gd["KB"], grid_rows=gd["R"],
            grid_verts=spec.max_solid_verts, n_solid=ns)
        state = make_state(bodies, max_pairs=mp,
                           max_contacts=cfg.rigid.max_contacts_per_pair,
                           **gkw)
        return Scene(state=state, spec=spec, cfg=cfg)


@dataclass
class Scene:
    state: SimState
    spec: SceneSpec
    cfg: ScenarioSystemConfig
