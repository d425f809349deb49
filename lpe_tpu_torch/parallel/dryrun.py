"""A dry run of the multi-device path: the counterpart of
``__graft_entry__.py`` ``dryrun_multichip`` (lines 18-171).
``dryrun_multichip(4)`` puts 4 bands on the first CUDA card
(``device="cpu"`` on the CPU; ``devices=`` to list the bands' devices),
runs 3 ticks of a coupled scene (the fluid in row bands, its rigid list
pipeline by runs of pairs and rows), of a galaxy (gravity split by
receiver blocks) and of a grid rigid scene (y-row bands) against the
single-device tick and prints one line.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

TICKS = 3


def tracer_scene(n_bands: int, *, device, particles: int = 200):
    """FLUID_AND_POLYGONS at ``particles`` liquid particles (seed 1), the
    split kernels, ``max_per_cell`` 8 and 5 sub-steps, with its first 8
    liquid particles set just above an interior band edge and falling, so
    that particles cross a band boundary within a few ticks (``lpe_tpu``'s
    dry run, ``__graft_entry__.py:73-91``; its bands are equal slices of
    the universe, as here)."""
    from ..core.constants import SimulationType
    from ..scenarios import create_scenario
    from ..scenarios.fluid_and_polygons import FluidAndPolygonsConfig
    sc = create_scenario(
        SimulationType.FLUID_AND_POLYGONS, seed=1, device=device,
        ec=FluidAndPolygonsConfig(fluid_particle_count=particles))
    fl = dataclasses.replace(
        sc.cfg.fluid, pair_backend="pallas", residency="on",
        num_sub_steps=5,
        grid=dataclasses.replace(sc.cfg.fluid.grid, max_per_cell=8))
    sc.cfg = sc.cfg.replace(fluid=fl)
    liq = sc.spec.liquid_slice
    size = sc.cfg.shared.universe_size_m
    y = sc.state.bodies.pos[liq, 1].cpu().numpy()
    edges = size * np.arange(1, n_bands) / n_bands
    inside = edges[(edges > y.min() + 0.05) & (edges < y.max() - 0.05)]
    edge = float(inside[len(inside) // 2]) if inside.size else \
        float(edges[len(edges) // 2])
    idx = torch.arange(liq.start, liq.start + 8, device=sc.state.bodies.pos
                       .device)
    b = sc.state.bodies
    pos, vel = b.pos.clone(), b.vel.clone()
    pos[idx, 1] = edge - 0.002
    vel[idx, 1] = 0.5
    sc.state = sc.state.replace(bodies=b.replace(pos=pos, vel=vel))
    return sc


SHARD_GRID_SIZE = 3.0


def shard_grid_scene(device, seed: int = 2):
    """``lpe_tpu``'s SHARD_GRID scene (tests/test_parallel.py:66-104): four
    walls and 96 random convex polygons in a 3 m box, moving and spinning,
    on the grid rigid pipeline (``grid_pipeline="on"``, persist slack 0.04
    m), built from ``seed`` as ``lpe_tpu`` builds it."""
    from ..core import constants as C
    from ..core.config import (BroadphaseConfig, RigidBodyConfig,
                               ScenarioSystemConfig, SharedSystemConfig)
    from ..math.polygon import (build_random_convex_polygon,
                                calculate_polygon_inertia)
    from ..scene import SceneBuilder
    size = SHARD_GRID_SIZE
    cfg = ScenarioSystemConfig(
        shared=SharedSystemConfig(
            universe_size_m=size, meters_per_pixel=size / C.SCREEN_LENGTH,
            seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
            grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50),
        rigid=RigidBodyConfig(
            broadphase=BroadphaseConfig(max_pairs=4096,
                                        persist_slack_m=0.04),
            grid_pipeline="on"))
    rng = np.random.default_rng(seed)
    b = SceneBuilder("SHARD_GRID")
    for wall in ((0.0, size / 2, 0.05, size / 2),
                 (size, size / 2, 0.05, size / 2),
                 (size / 2, 0.0, size / 2, 0.05),
                 (size / 2, size, size / 2, 0.05)):
        b.add_wall(*wall)
    for _ in range(96):
        sz = rng.uniform(0.05, 0.12)
        verts = build_random_convex_polygon(rng, sz)
        mass = max(0.1, rng.normal(1.0, 0.1))
        b.add(pos=(rng.uniform(size * 0.1, size * 0.9),
                   rng.uniform(size * 0.1, size * 0.9)),
              vel=(rng.uniform(-1, 1), rng.uniform(-1, 1)),
              mass=mass, phase=int(C.Phase.SOLID),
              shape_kind=int(C.ShapeKind.POLYGON), radius=sz, verts=verts,
              inertia=calculate_polygon_inertia(verts, mass),
              omega=rng.uniform(-1, 1))
    return b.finalize(cfg, device=device)


def band_of(state, spec, cfg, n_bands: int) -> np.ndarray:
    """The band (an equal slice of the universe in y) of each liquid
    particle."""
    y = state.bodies.pos[spec.liquid_slice, 1].cpu().numpy()
    size = cfg.shared.universe_size_m
    return np.clip((y / size * n_bands).astype(int), 0, n_bands - 1)


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> dict:
    """Run 3 ticks of three scenes over a mesh of ``n_devices`` bands (on
    ``devices``, else all on ``device``) against the single-device tick on
    the mesh's lead device, and assert:

    - the coupled scene, its fluid in row bands and its rigid list
      pipeline in ``n_devices`` shards: |dpos| < 5e-4 m and |dvel| <
      5e-3 m/s over every active body; more than 0 liquid particles
      crossed a band; at least 2 bands hold liquid at the end; the
      rigids' deviation and whether they are to the bit are printed
      (their forces from the fluid's bands may reassociate);
    - KEPLERIAN_DISK at 512 bodies, its direct sum split by receiver
      blocks: equal to the single device to the bit (galaxy_rel_dpos 0);
    - ``lpe_tpu``'s SHARD_GRID scene, the grid rigid pipeline in y-row
      bands: |dpos| <= 1e-5 m, |dvel| and |domega| <= 1e-4
      (tests/test_parallel.py:108-112); whether to the bit is printed.

    Prints one line and returns its numbers."""
    from ..core.constants import SimulationType
    from ..scenarios import create_scenario
    from ..scenarios.keplerian_disk import KeplerianDiskConfig
    from ..systems import build_tick_fn
    from . import make_mesh
    from .sharded import build_sharded_tick, shard_state, uses_bands

    mesh = make_mesh(n_devices, devices=devices or
                     [torch.device(device)] * n_devices)
    lead = mesh.lead

    def both(make):
        """3 ticks of a fresh scene from ``make`` on the lead device and
        over the mesh: (scene, single-device state, mesh state, the mesh's
        tick)."""
        ref = make()
        ref_tick = build_tick_fn(ref.spec, ref.cfg, device=lead)
        s_ref = ref.state
        for _ in range(TICKS):
            s_ref = ref_tick(s_ref)
        scene = make()
        tick = build_sharded_tick(scene, mesh)
        state = shard_state(mesh, scene.state)
        for _ in range(TICKS):
            state = tick(state)
        return scene, s_ref, state, tick

    scene, s_ref, state, tick = both(
        lambda: tracer_scene(n_devices, device=lead))
    if not uses_bands(scene, mesh):
        raise AssertionError(f"{mesh} does not run the fluid in bands")
    list_step = tick.systems["rigid"]
    if list_step.shards != n_devices:
        raise AssertionError(f"{mesh} runs the rigid list pipeline in "
                             f"{list_step.shards} shards, not {n_devices}")
    nr = scene.spec.n_solid
    list_gaps = {f: float((getattr(state.bodies, f)[:nr]
                           - getattr(s_ref.bodies, f)[:nr]).abs().max())
                 for f in ("pos", "vel", "omega")}
    list_bitwise = all(torch.equal(getattr(state.bodies, f)[:nr],
                                   getattr(s_ref.bodies, f)[:nr])
                       for f in ("pos", "vel", "angle", "omega"))
    act = scene.state.bodies.active
    p_sh, v_sh = state.bodies.pos[act], state.bodies.vel[act]
    if not (bool(torch.isfinite(p_sh).all())
            and bool(torch.isfinite(v_sh).all())):
        raise AssertionError("non-finite banded state")
    dp = float((p_sh - s_ref.bodies.pos[act]).abs().max())
    dv = float((v_sh - s_ref.bodies.vel[act]).abs().max())
    assert dp < 5e-4, f"banded position deviation {dp} exceeds 5e-4"
    assert dv < 5e-3, f"banded velocity deviation {dv} exceeds 5e-3"

    b0 = band_of(scene.state, scene.spec, scene.cfg, n_devices)
    b1 = band_of(state, scene.spec, scene.cfg, n_devices)
    crossings = int((b0 != b1).sum())
    occ = np.bincount(b1, minlength=n_devices)
    assert (occ > 0).sum() >= 2, f"degenerate band occupancy {occ.tolist()}"
    assert crossings > 0, (
        "no particle crossed a band boundary: halo rows never exercised")

    gal, g_ref, g_sh, g_tick = both(lambda: create_scenario(
        SimulationType.KEPLERIAN_DISK, seed=2, device=lead,
        ec=KeplerianDiskConfig(particle_count=512)))
    g_step = g_tick.systems["barnes_hut"]
    if g_step.devices is None:
        raise AssertionError(f"{mesh} does not split the galaxy's gravity")
    g_blocks = -(-gal.spec.capacity // g_step.chunk)
    ga = gal.state.bodies.active
    gp_r, gp_s = g_ref.bodies.pos[ga], g_sh.bodies.pos[ga]
    scale = float(gp_r.abs().max())
    gdp = float((gp_s - gp_r).abs().max()) / max(scale, 1e-30)
    assert bool(torch.isfinite(gp_s).all())
    assert gdp == 0.0, f"galaxy relative deviation {gdp:.2e}"

    grid, r_ref, r_sh, r_tick = both(lambda: shard_grid_scene(lead))
    r_step = r_tick.systems["rigid"]
    if r_step.bands != n_devices:
        raise AssertionError(f"{mesh} does not run the grid rigid "
                             f"pipeline in bands")
    gaps = {f: float((getattr(r_sh.bodies, f)
                      - getattr(r_ref.bodies, f)).abs().max())
            for f in ("pos", "vel", "omega")}
    rigid_bitwise = all(torch.equal(getattr(r_sh.bodies, f),
                                    getattr(r_ref.bodies, f))
                        for f in ("pos", "vel", "angle", "omega"))
    assert gaps["pos"] <= 1e-5 and gaps["vel"] <= 1e-4 and \
        gaps["omega"] <= 1e-4, f"grid rigid bands deviate: {gaps}"

    print(f"dryrun_multichip({n_devices}): OK — {TICKS} coupled "
          f"fluid+rigid ticks, {scene.spec.capacity} entities, the fluid "
          f"in {n_devices} row bands on {[str(d) for d in mesh.devices]}; "
          f"max |dpos|={dp:.2e} m, max |dvel|={dv:.2e} m/s vs single-device;"
          f" {crossings} band crossings, per-band occupancy {occ.tolist()};"
          f" its {nr} solids' list pipeline in {list_step.shards} shards: "
          f"max |dpos|={list_gaps['pos']:.2e} m, |dvel|="
          f"{list_gaps['vel']:.2e} m/s, |domega|={list_gaps['omega']:.2e} "
          f"rad/s, bitwise {list_bitwise}, "
          f"{list_step.shard_stats['copies']} copies;"
          f" galaxy-512 rel |dpos|={gdp:.2e} (its direct sum's {g_blocks} "
          f"receiver block(s) over the mesh); SHARD_GRID "
          f"{grid.spec.n_solid} solids in "
          f"{n_devices} y-row bands: max |dpos|={gaps['pos']:.2e} m, "
          f"|dvel|={gaps['vel']:.2e} m/s, |domega|={gaps['omega']:.2e} "
          f"rad/s, bitwise {rigid_bitwise}, {r_step.halo_stats['copies']} "
          f"row exchanges", flush=True)
    return dict(dpos=dp, dvel=dv, crossings=crossings, occupancy=occ.tolist(),
                list_rigid=dict(list_gaps, bitwise=list_bitwise,
                                shards=list_step.shards,
                                copies=list_step.shard_stats["copies"],
                                bytes=list_step.shard_stats["bytes"]),
                galaxy_rel_dpos=gdp,
                grid_rigid=dict(gaps, bitwise=rigid_bitwise))
