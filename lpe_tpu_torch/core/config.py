"""Typed configuration tree.

Mirrors the reference's ``ScenarioSystemConfig`` bundle (reference:
include/scenarios/i_scenario.hpp:25-41) — a shared config plus one typed config
per system — as frozen dataclasses. All values are *static* with respect to
jit: a tick function is specialized for a scenario's config, exactly as the
reference bakes configs into systems at scenario-selection time
(reference: src/sim.cpp:41-79).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from . import constants


def _d(obj):  # tiny helper for nested default factories
    return field(default_factory=obj)


@dataclass(frozen=True)
class SharedSystemConfig:
    """reference: include/systems/shared_system_config.hpp:10-21."""

    universe_size_m: float = 6.0
    time_acceleration: float = 1.0
    meters_per_pixel: float = 1e-2
    seconds_per_tick: float = 1.0 / constants.STEPS_PER_SECOND
    gravitational_softener: float = 0.0
    drag_coeff: float = 0.0          # set by scenarios, read by no system (parity)
    particle_density: float = 0.5    # set by scenarios, read by no system (parity)
    grid_size: int = 50
    cell_size_pixels: float = 12.0


@dataclass(frozen=True)
class MovementConfig:
    """reference: include/systems/movement.hpp:28-33 (empty)."""


@dataclass(frozen=True)
class GravityConfig:
    """reference: include/systems/gravity.hpp:26-33."""

    gravitational_acceleration: float = 9.8
    planetary_mass_threshold: float = 1e10


@dataclass(frozen=True)
class BoundaryConfig:
    """reference: include/systems/boundary.hpp:28-39."""

    margin_pixels: float = 15.0
    bounce_damping: float = 0.7
    max_speed: float = 1.0


@dataclass(frozen=True)
class RotationConfig:
    """reference: include/systems/rotation.hpp:26-33."""

    angular_damping: float = 0.98
    max_angular_speed: float = 20.0


@dataclass(frozen=True)
class SleepConfig:
    """reference: include/systems/sleep.hpp:29-38."""

    linear_sleep_threshold: float = 0.5
    angular_sleep_threshold: float = 0.5
    sleep_frames_threshold: int = 60


@dataclass(frozen=True)
class DampeningConfig:
    """reference: include/systems/dampening.hpp:28-31 (dead code there; kept
    for API parity, disabled by default exactly like the reference never adds
    the system to its list, src/sim.cpp:107-114)."""

    linear_damping: float = 0.99


@dataclass(frozen=True)
class BarnesHutConfig:
    """reference: include/systems/barnes_hut.hpp:28-46."""

    theta: float = 0.5               # parity field; the TPU far-field knob
    #                                  is pm_grid (mesh smearing ~ theta err)
    small_mass_threshold: float = 1e3
    # TPU rebuild knobs: below this body count the O(N^2) direct sum is both
    # faster and *more* accurate than any tree; above it the particle-mesh
    # (FFT) far-field solver takes over (ops/pm_gravity.py).
    direct_sum_max_bodies: int = 131072
    pm_grid: int = 1024
    # bodies above this mass are solved exactly (direct), never meshed —
    # keeps central stars/planets from being smeared by the grid
    heavy_threshold: float = 1e28
    heavy_cap: int = 16
    # P3M split: the mesh kernel is rolled off by a quintic smoothstep
    # (ramping over ~2..p3m_cutoff_cells mesh cells, ops/pm_gravity._ramp)
    # and CIC-deconvolved, and a dense cell-grid particle-particle pass adds
    # the exact complementary short-range force below the cutoff
    # (make_pp_correction). 0 disables the correction (plain PM).
    # Measured on a random self-gravitating blob vs the exact direct sum
    # (tests/test_barnes_hut.py): p95 error 7% (plain PM) -> 0.9% at the
    # defaults. Per-cell candidate residency is a deterministic first-K drop
    # (overflow keeps the smooth mesh force only).
    p3m_cutoff_cells: float = 8.0
    p3m_max_per_cell: int = 64


@dataclass(frozen=True)
class BroadphaseConfig:
    """reference: include/systems/rigid/broadphase.hpp:25-33."""

    quadtree_capacity: int = 8       # kept for parity; unused by the TPU design
    boundary_buffer: float = 500.0
    small_particle_threshold: float = 0.01
    # TPU rebuild: fixed candidate-pair capacity (pairs beyond it are dropped
    # deterministically, mirroring the reference's silent 64/cell drop policy).
    max_pairs: int = 2048
    # Above this solid count the all-pairs AABB matrix (O(S^2) + a huge
    # nonzero compaction) is replaced by a uniform-grid broadphase with a
    # dense side-channel for oversized solids (walls).
    dense_max_solids: int = 1024
    grid_max_per_cell: int = 32
    # Cross-tick candidate persistence (>0 enables): candidate pairs are
    # built from AABBs expanded by slack/2 and REUSED until any solid has
    # moved more than slack/2 (translation + rotation*bounding-radius)
    # since the build — the candidate set stays a superset of the exact
    # overlap set, so contacts are identical; only the (expensive) grid
    # build + pair compaction is skipped on quiet ticks. The reference
    # rebuilds its quadtree every tick (broadphase.cpp:205-288); settled
    # stacks rebuild here ~never. Off by default: scenes with mostly
    # moving bodies pay the (cheap) displacement check for nothing.
    persist_slack_m: float = 0.0


@dataclass(frozen=True)
class ContactSolverConfig:
    """reference: include/systems/rigid/contact_solver.hpp:22-27.

    The reference runs 10 sequential PGS iterations; the TPU solver is
    mass-splitting projected *Jacobi* (parallel over contacts), which needs
    more sweeps for the same convergence on stacks — each sweep is a handful
    of tiny fused VPU ops, so the budget is raised rather than matched
    1:1."""

    iterations: int = 16
    friction_coeff: float = 0.5
    # relaxation for the mass-splitting Jacobi sweep that replaces the
    # (inherently sequential) Gauss-Seidel inner loop.
    relaxation: float = 1.0
    # Staged (block) Jacobi: contact rows are split round-robin into this
    # many segments applied sequentially per iteration — between plain
    # Jacobi (1) and the reference's Gauss-Seidel (rows) at the same
    # indexed-op volume per iteration. See solver.solve_velocity.
    # Default 1, and this IS the benchmarked configuration: staging
    # converges friction much closer to the true LCP solution (measured
    # 3.5x less tall-stack penetration at 4), but the stickier contacts
    # jam the Galton funnel that the validated Jacobi behavior flows
    # through, so 1 ships. Only the LIST pipeline reads this knob; the
    # grid pipeline the big bench scenes auto-select is always
    # class-staged (grid_pipeline.py vel_body: 6 sequential class passes
    # per iteration over spatially-disjoint rows), which delivers the
    # staging convergence there without any per-scene opt-in.
    stages: int = 1
    # Segment count for the FRICTION rows specifically. 0 = follow
    # ``stages``. 1 under stages>1 runs the normal rows staged (fast stack
    # convergence) while friction stays a single synchronous Jacobi update
    # per iteration — the validated stages=1 friction behavior — so staged
    # scenes keep sliding contacts (funnels) flowing. See
    # solver.solve_velocity.
    friction_stages: int = 0


@dataclass(frozen=True)
class PositionSolverConfig:
    """reference: include/systems/rigid/position_solver.hpp:21-35 (10 iters
    there; raised for the parallel Jacobi scheme, see ContactSolverConfig)."""

    iterations: int = 8
    baumgarte: float = 0.02
    slop: float = 0.001
    # Staged Jacobi segments, as in ContactSolverConfig.stages — but 1
    # (pure Jacobi) by default: staging the normal-only position push-out
    # measured 4x better floor-sink yet ~10x worse lateral creep on tall
    # stacks (it has no friction rows to oppose the asymmetric push), so
    # symmetry wins here, while stacking scenes opt the velocity solver
    # into stages=4 (ContactSolverConfig.stages defaults to 1 too).
    stages: int = 1


@dataclass(frozen=True)
class RigidBodyConfig:
    """Bundle for the 5-stage rigid pipeline (reference:
    src/systems/rigid/rigid_body_collision.cpp:25-53)."""

    broadphase: BroadphaseConfig = _d(BroadphaseConfig)
    solver: ContactSolverConfig = _d(ContactSolverConfig)
    position: PositionSolverConfig = _d(PositionSolverConfig)
    gjk_iterations: int = 32         # reference caps at 100 (gjk.cpp:99)
    epa_iterations: int = 24         # reference caps at 100 (epa.cpp:58)
    # Incident-edge clipping emits at most 2 manifold points per pair
    # (geometry.polygon_contacts) — exactly the full-rank count for a 2D
    # convex contact — so 2 is lossless. Solver row count (and cost) scales
    # linearly with this.
    max_contacts_per_pair: int = 2
    # Fixed capacity for the *active* (touching) contact rows the solvers
    # iterate over. Narrowphase emits max_pairs*max_contacts_per_pair rows,
    # but most candidate pairs are not in contact on any given tick;
    # compacting the valid rows before the solve cuts each iteration's
    # gather/scatter volume (the TPU cost floor) by rows/cap.
    # 0 = auto (2*max_pairs: a 2D convex pair has at most 2 meaningful
    # manifold points, so the auto cap only ever drops clipping artifacts).
    max_active_contacts: int = 0
    # Grid-resident rigid pipeline (systems/rigid/grid_pipeline.py): bodies
    # live in a dense [cell, slot] grid, candidates/narrowphase/solvers run
    # on per-cell row tensors with roll + one-hot-slot neighbor access — no
    # indexed gathers in the iteration loops. "auto" = on exactly when the
    # grid broadphase would be (n_solid > broadphase.dense_max_solids).
    # Narrowphase there is closed-form SAT (geometry.sat_contact), equal to
    # converged GJK->EPA on convex shapes (tests/test_geometry_sat.py).
    grid_pipeline: str = "auto"      # "auto" | "on" | "off"
    # Narrowphase engine for the grid pipeline's dense candidate rows:
    # "pallas" = fused SAT+clip VMEM kernel (ops/pallas_rigid.py; all-
    # polygon scenes with max_contacts_per_pair == 2 only — the XLA pair
    # materializes ~65 GB/tick of projection intermediates at north-star
    # scale), "xla" = vmapped geometry.sat_contact + _pair_contacts,
    # "auto" = pallas on TPU when eligible.
    narrowphase_backend: str = "auto"   # "auto" | "pallas" | "xla"
    grid_slots_per_cell: int = 0     # body slots per cell; 0 = auto
    grid_rows_same: int = 0          # same-cell pair rows per cell; 0 = auto
    grid_rows_axis: int = 0          # E/S neighbor rows per cell; 0 = auto
    grid_rows_diag: int = 0          # SW/SE neighbor rows per cell; 0 = auto
    grid_rows_big: int = 0           # vs-big (wall) rows per cell; 0 = auto
    # Persistent cross-tick warm starting. The reference built the machinery
    # (ContactManager impulse caching, contact_manager.cpp:164-279) but
    # recreates the manager every tick so it never takes effect
    # (rigid_body_collision.cpp:40). Here it is on by default: the parallel
    # Jacobi solver leans on persistent-contact warm starts for stack
    # convergence, which is the behavior the reference *intended*.
    warm_start: bool = True
    # Cached impulses follow contact POINTS: a new contact inherits the
    # impulse of the pair's cached point within this distance (reference
    # matches dist^2 < 1e-6, contact_manager.cpp:222-234), and the pair's
    # manifold resets when its normal rotates past cos 0.95 (:202-209).
    warm_position_tolerance: float = 1e-3
    # True: a point with no positional match inherits its slot's cached
    # impulse (helps the plain-Jacobi stages=1 solver through settling).
    # False: strict reference semantics — no match, cold start
    # (contact_manager.cpp:236-245). See solver.match_warm_impulses.
    warm_slot_fallback: bool = True


@dataclass(frozen=True)
class FluidPositionSolverConfig:
    """reference: include/systems/fluid/fluid.hpp:140-148."""

    safety_margin: float = 0.001
    relax_factor: float = 0.9
    max_correction: float = 0.1
    max_velocity_update: float = 1.0
    min_safe_distance: float = 1e-10
    velocity_damping: float = 0.3
    min_position_change: float = 1e-6


@dataclass(frozen=True)
class FluidImpulseSolverConfig:
    """reference: include/systems/fluid/fluid.hpp:151-179."""

    max_force: float = 0.15
    max_torque: float = 0.03
    fluid_force_scale: float = 100.0
    fluid_force_max: float = 50000.0
    buoyancy_strength: float = 0.2
    viscosity_scale: float = 0.05
    depth_scale: float = 0.04
    depth_transition_rate: float = 2.0
    depth_estimate_scale: float = 10.0
    pressure_force_ratio: float = 1.0
    viscous_force_ratio: float = 0.3
    angular_damping_threshold: float = 0.5
    angular_damping_factor: float = 0.005
    max_safe_velocity_sq: float = 80.0
    min_penetration: float = 1e-6
    min_rel_velocity: float = 1e-6


@dataclass(frozen=True)
class FluidGridConfig:
    """reference: include/systems/fluid/fluid.hpp:182-186."""

    grid_epsilon: float = 1e-6
    smoothing_length: float = 0.05
    boundary_offset: float = 0.001
    # Grid cell edge as a multiple of h. The reference uses 2h cells with a
    # 3x3 scan (fluid.cpp:737-755); since the kernels' support is r < h, a
    # 3x3 scan over *h-sized* cells already covers every interacting pair
    # exactly, with 4x fewer pair slots per cell. Must be >= 1.0.
    cell_size_factor: float = 1.0
    # Per-cell neighbor-table occupancy cap. The reference hard-codes 64
    # particles per (2h)^2 cell and silently drops overflow by atomic race
    # (fluid_kernels.metal:60,237-240); 16 per h^2 cell is the identical
    # density contract, applied deterministically (first K in cell order).
    max_per_cell: int = constants.MAX_PER_CELL // 4


@dataclass(frozen=True)
class FluidNumericalConfig:
    """reference: include/systems/fluid/fluid.hpp:189-194."""

    min_distance_threshold: float = 1e-14
    min_density_threshold: float = 1e-12
    min_timestep: float = 1e-10
    fallback_timestep: float = 1e-4


@dataclass(frozen=True)
class FluidConfig:
    """reference: include/systems/fluid/fluid.hpp:131-200."""

    gravity: float = 9.81
    rest_density: float = 0.5
    stiffness: float = 200.0
    viscosity: float = 0.03
    position_solver: FluidPositionSolverConfig = _d(FluidPositionSolverConfig)
    impulse_solver: FluidImpulseSolverConfig = _d(FluidImpulseSolverConfig)
    grid: FluidGridConfig = _d(FluidGridConfig)
    numerical: FluidNumericalConfig = _d(FluidNumericalConfig)
    damping_factor: float = 1.0
    num_sub_steps: int = 10
    threads_per_group: int = 256     # parity field; XLA/Pallas choose tiling
    # Pair-pass backend: "auto" = the rolling-window Pallas pair sweep on
    # TPU (density+force in one pass, each grid row DMA'd once per
    # sub-step, rho kept on-chip — ops/pallas_sph.make_pair_sweep), plain
    # XLA elsewhere. "sweep" / "pallas" (split density/force row-band
    # kernels) / "xla" force a backend. Results agree up to float
    # reassociation of neighbor sums. The multi-device halo path always
    # uses the split kernels (force at band edges needs the neighbor
    # band's rho, which is exchanged between the kernels).
    pair_backend: str = "auto"
    # Grid residency across sub-steps: "auto" = on for TPU, off elsewhere;
    # "on"/"off" force it. When on, particle state lives in the dense
    # [cells, K] grid tensor for the whole tick and per-sub-step cell
    # migration is a dense one-hot compaction over the 3x3 neighborhood —
    # zero per-sub-step sort/scatter/gather (the indexed-op machinery is the
    # measured cost floor on TPU, not the pair math). Same first-K-per-cell
    # drop contract as the scatter path; pair sums reassociate, so results
    # match the scatter path to float tolerance, not bitwise.
    residency: str = "auto"
    # Grid residency across TICKS (multi-tick dispatch blocks built by
    # systems.build_run_fn): "auto" = on for TPU when residency is active,
    # single-device, no Barnes-Hut (n-body touches liquid velocities in
    # particle order) and no liquid has a Sleep component; "on"/"off" force
    # it. When on, the dense grid is built once per BLOCK and read back once
    # per block instead of once per tick; the per-tick boundary bounce and
    # uniform gravity are applied to the liquid planes in grid space
    # (identical elementwise math; a margin clamp that moves a particle
    # more than one cell leaves it briefly mis-binned while the migration
    # target-walk re-bins it over the next sub-steps).
    # Slot assignment differs from the per-tick rebuild, so pair
    # sums reassociate: results match per-tick residency to float
    # tolerance, not bitwise.
    cross_tick_residency: str = "auto"
    # Per-CELL rasterized coupling candidates (ops/pallas_sph.py coupling
    # section; sph.coupling_dims). Each grid cell couples against at most
    # ``coupling_slots_per_cell`` rigids whose slack-widened AABB covers
    # it (0 = auto: 3x the scene's initial max coverage, in [8, 32]) — the
    # capacity scales with LOCAL rigid density, so any per-row/scene rigid
    # count works. ``coupling_window_rows`` bounds how many small rigids
    # may overlap one padded grid row's widened strip in the field build
    # (0 = auto: 4x the initial max, >= 256). Saturation of either cap is
    # counted (build `overflow` diagnostic; core.telemetry).
    # ``coupling_raster_slack_cells`` widens the rasterized AABBs so
    # particles mis-binned by up to that many cells (post-clamp "walking"
    # migration, large push-outs) still see their rigids.
    coupling_slots_per_cell: int = 0
    coupling_window_rows: int = 0
    coupling_raster_slack_cells: float = 1.0
    # Multi-chip decomposition (only read by parallel/sharded.py when a mesh
    # with >1 devices is used): "halo" = spatial row-band sharding of the
    # dense grid with one-row ppermute halo exchanges per sub-step over ICI
    # (the scalable design: per-step comms are O(nx*K), independent of N and
    # device count); "entity" = shard the particle axis and let GSPMD insert
    # collectives (all-gathers the grid — simple, correct, not scalable);
    # "auto" = halo.
    partition: str = "auto"


@dataclass(frozen=True)
class ScenarioSystemConfig:
    """Top-level bundle (reference: include/scenarios/i_scenario.hpp:25-41)."""

    shared: SharedSystemConfig = _d(SharedSystemConfig)
    movement: MovementConfig = _d(MovementConfig)
    gravity: GravityConfig = _d(GravityConfig)
    boundary: BoundaryConfig = _d(BoundaryConfig)
    rotation: RotationConfig = _d(RotationConfig)
    sleep: SleepConfig = _d(SleepConfig)
    dampening: DampeningConfig = _d(DampeningConfig)
    barnes_hut: BarnesHutConfig = _d(BarnesHutConfig)
    rigid: RigidBodyConfig = _d(RigidBodyConfig)
    fluid: FluidConfig = _d(FluidConfig)

    def replace(self, **kw) -> "ScenarioSystemConfig":
        return dataclasses.replace(self, **kw)
