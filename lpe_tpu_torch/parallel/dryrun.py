"""A dry run of the multi-device path: the counterpart of
``__graft_entry__.py`` ``dryrun_multichip`` (lines 18-171).
``dryrun_multichip(4)`` puts 4 bands of the fluid on the first CUDA card
(``device="cpu"`` on the CPU; ``devices=`` to list the bands' devices),
runs 3 ticks of a coupled scene against the single-device tick and prints
one line.
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


def band_of(state, spec, cfg, n_bands: int) -> np.ndarray:
    """The band (an equal slice of the universe in y) of each liquid
    particle."""
    y = state.bodies.pos[spec.liquid_slice, 1].cpu().numpy()
    size = cfg.shared.universe_size_m
    return np.clip((y / size * n_bands).astype(int), 0, n_bands - 1)


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> dict:
    """Run the coupled scene's fluid in ``n_devices`` row bands (on
    ``devices``, else all on ``device``) for 3 ticks against the
    single-device tick on the mesh's lead device, and assert:

    - |dpos| < 5e-4 m and |dvel| < 5e-3 m/s over every active body;
    - more than 0 liquid particles crossed a band;
    - at least 2 bands hold liquid at the end.

    Then KEPLERIAN_DISK at 512 bodies through ``build_sharded_tick``: it
    has no liquid, so its gravity runs on the lead device (entity sharding
    of gravity is not ported), and it is compared with the plain tick.
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

    ref = tracer_scene(n_devices, device=lead)
    ref_tick = build_tick_fn(ref.spec, ref.cfg, device=lead)
    s_ref = ref.state
    for _ in range(TICKS):
        s_ref = ref_tick(s_ref)

    scene = tracer_scene(n_devices, device=lead)
    if not uses_bands(scene, mesh):
        raise AssertionError(f"{mesh} does not run the fluid in bands")
    tick = build_sharded_tick(scene, mesh)
    state = shard_state(mesh, scene.state)
    for _ in range(TICKS):
        state = tick(state)

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

    def galaxy():
        return create_scenario(SimulationType.KEPLERIAN_DISK, seed=2,
                               device=lead,
                               ec=KeplerianDiskConfig(particle_count=512))

    gal = galaxy()
    g_tick = build_tick_fn(gal.spec, gal.cfg, device=lead)
    g_ref = gal.state
    for _ in range(TICKS):
        g_ref = g_tick(g_ref)
    gal2 = galaxy()
    gs_tick = build_sharded_tick(gal2, mesh)
    g_sh = shard_state(mesh, gal2.state)
    for _ in range(TICKS):
        g_sh = gs_tick(g_sh)
    ga = gal.state.bodies.active
    gp_r, gp_s = g_ref.bodies.pos[ga], g_sh.bodies.pos[ga]
    scale = float(gp_r.abs().max())
    gdp = float((gp_s - gp_r).abs().max()) / max(scale, 1e-30)
    assert bool(torch.isfinite(gp_s).all())
    assert gdp < 1e-5, f"galaxy relative deviation {gdp:.2e}"

    print(f"dryrun_multichip({n_devices}): OK — {TICKS} coupled "
          f"fluid+rigid ticks, {scene.spec.capacity} entities, the fluid "
          f"in {n_devices} row bands on {[str(d) for d in mesh.devices]}; "
          f"max |dpos|={dp:.2e} m, max |dvel|={dv:.2e} m/s vs single-device;"
          f" {crossings} band crossings, per-band occupancy {occ.tolist()};"
          f" galaxy-512 rel |dpos|={gdp:.2e} (gravity on the lead device: "
          f"entity sharding not ported)", flush=True)
    return dict(dpos=dp, dvel=dv, crossings=crossings, occupancy=occ.tolist(),
                galaxy_rel_dpos=gdp)
