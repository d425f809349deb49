"""The galaxy: upstream's KEPLERIAN_DISK at scale, from the seed.

A vectorised copy of the distribution of ``lpe_tpu_torch.scenarios.
keplerian_disk.build`` (``bench_scenes.build_galaxy``): a central body and
a power-law disk of gas bodies, drawn by the same rejection law for the
radius and the same normal laws for height, speed, radial drift and mass;
the draws come in batches, so a seed gives other bodies than that
function does. ``make_inputs`` gives the arrays in the port's entity order
(the central body first), which both the port and the reference take.
"""
from __future__ import annotations

import math

import numpy as np

SCREEN_LENGTH = 600
PI = 3.141592654             # the reference's constants
REAL_G = 6.674e-11
GAS, CIRCLE = 2, 0


def time_acceleration(conf) -> float:
    d = conf["disk"]
    inner = d["inner_radius_pixels"] * conf["meters_per_pixel"]
    period = 2 * PI * math.sqrt(inner ** 3 / (REAL_G * d["central_mass"]))
    return period / (d["orbital_period_fraction"]
                     * conf["ticks_per_second"]) * 20.0


def make_inputs(conf, seed: int) -> dict:
    """Host arrays (float64) of the central body and the disk."""
    d = conf["disk"]
    mpp = conf["meters_per_pixel"]
    n = int(conf["particle_count"]) - 1
    size = SCREEN_LENGTH * mpp
    cx = cy = SCREEN_LENGTH / 2.0 * mpp
    rng = np.random.default_rng(seed)
    lo = d["inner_radius_pixels"]
    hi = SCREEN_LENGTH / d["outer_radius_factor"]
    got = []
    while sum(len(r) for r in got) < n:
        r = rng.uniform(lo, hi, size=2 * n)
        u = rng.uniform(0.0, 1.0, size=2 * n)
        got.append(r[u <= (lo / r) ** d["density_power_law"]])
    rpix = np.concatenate(got)[:n]
    rm = rpix * mpp
    angle = rng.uniform(0.0, 2 * PI, size=n)
    max_hm = (lo / d["height_scale_factor"]) * (rpix / lo) \
        ** d["height_power_law"] * mpp
    h_off = rng.normal(0.0, 1.0, size=n) * (max_hm / 3.0)
    x = cx + rm * np.cos(angle)
    y = cy + rm * np.sin(angle) + h_off
    speed = np.sqrt(REAL_G * d["central_mass"] / rm) * rng.normal(
        1.0, d["velocity_dispersion_factor"], size=n)
    vx = -speed * np.sin(angle)
    vy = speed * np.cos(angle)
    rv = rng.normal(0.0, 1.0, size=n) * (speed * d["radial_velocity_factor"])
    vx = vx + rv * np.cos(angle)
    vy = vy + rv * np.sin(angle)
    factor = (lo * mpp / rm) ** d["mass_radial_power_law"]
    mass = rng.normal(factor * d["particle_mass_mean"],
                      d["particle_mass_std_dev"])
    return dict(
        size=size, mpp=mpp,
        pos=np.concatenate([[[cx, cy]], np.stack([x, y], -1)]),
        vel=np.concatenate([[[0.0, 0.0]], np.stack([vx, vy], -1)]),
        mass=np.concatenate([[d["central_mass"]], mass]),
        radius=np.concatenate([[2.0 * mpp], np.full(n, 0.5 * mpp)]))


def program_config(conf, inputs):
    from lpe_tpu_torch.core import config as C
    mpp = conf["meters_per_pixel"]
    shared = C.SharedSystemConfig(
        universe_size_m=inputs["size"], meters_per_pixel=mpp,
        seconds_per_tick=1.0 / conf["ticks_per_second"],
        time_acceleration=time_acceleration(conf), grid_size=100,
        cell_size_pixels=SCREEN_LENGTH / 100,
        gravitational_softener=conf["gravitational_softener"],
        drag_coeff=1e-11, particle_density=0.1)
    return C.ScenarioSystemConfig(
        shared=shared, boundary=C.BoundaryConfig(**conf["boundary"]),
        barnes_hut=C.BarnesHutConfig(**conf["barnes_hut"]),
        rigid=C.RigidBodyConfig(broadphase=C.BroadphaseConfig(
            max_pairs=conf["max_pairs"])))


def to_program(conf, inputs, device):
    """(spec, cfg, state) of the port on ``device``: the port's
    ``SceneBuilder`` takes the central body and one disk body for the
    scene's static facts; the bodies' tensors are made in bulk."""
    import dataclasses

    import torch

    from lpe_tpu_torch.scene import SceneBuilder
    from lpe_tpu_torch.state import Bodies, make_state

    cfg = program_config(conf, inputs)
    pos, vel, mass = inputs["pos"], inputs["vel"], inputs["mass"]
    b = SceneBuilder("KEPLERIAN_DISK")
    b.add(pos=tuple(pos[0]), mass=float(mass[0]), phase=GAS,
          shape_kind=CIRCLE, radius=float(inputs["radius"][0]),
          color=(255, 255, 0))
    b.add(pos=tuple(pos[1]), vel=tuple(vel[1]), mass=float(mass[1]),
          phase=GAS, shape_kind=CIRCLE, radius=float(inputs["radius"][1]),
          color=(255, 255, 255))
    small = b.finalize(cfg, device="cpu")
    n = len(pos)
    cap = max(128, -(-n // 128) * 128)
    spec = dataclasses.replace(
        small.spec, capacity=cap, n_entities=n, n_gas=n, liquid_start=n,
        max_nonboundary_mass=float(mass.max()),
        max_mass_overall=float(mass.max()))
    sb = small.state.bodies
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    rows = dict(pos=f32(pos), vel=f32(vel), mass=f32(mass),
                radius=f32(inputs["radius"]))
    pads = dict(mass=1.0, radius=1.0, static_friction=0.5,
                dynamic_friction=0.3, color=255, c=1000.0)
    bodies = {}
    for f in dataclasses.fields(sb):
        t = getattr(sb, f.name)
        if f.name in rows:
            body = rows[f.name]
        else:     # every disk body as the scene's second one
            body = t[1:2].expand((n,) + tuple(t.shape[1:]))
            body = torch.cat([t[:1], body[1:]])
        tail = torch.full((cap - n,) + tuple(t.shape[1:]),
                          pads.get(f.name, 0), dtype=t.dtype)
        bodies[f.name] = torch.cat([body.to(t.dtype), tail]).to(device)
    state = make_state(Bodies(**bodies), max_pairs=max(
        1, cfg.rigid.broadphase.max_pairs),
        max_contacts=cfg.rigid.max_contacts_per_pair)
    return spec, cfg, state


def observe(spec, state) -> dict:
    """What the output check reads of a state: every body's position and
    velocity (copies) and the tick's time scale."""
    b = state.bodies
    return dict(pos=b.pos.clone(), vel=b.vel.clone(),
                dt_scale=(state.base_time_accel * state.time_scale).clone())
