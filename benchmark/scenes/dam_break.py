"""The dam break: inputs made from the seed, and the port's scene from them.

A vectorised copy of the distribution of ``lpe_tpu_torch.scenarios.
bench_scenes.build_dam_break`` (the same layout, jitter law and draws,
masses and walls, so a seed gives that function's arrays to the bit): a
column of liquid in the left third of a tank of four wall solids.
``make_inputs`` gives the arrays in the port's entity order (the walls,
then the liquid), which both the port and the reference take.
"""
from __future__ import annotations

import math

import numpy as np

SCREEN_LENGTH = 600          # pixels across the universe (the reference's)
LIQUID, SOLID = 1, 0         # Phase
CIRCLE, POLYGON = 0, 1       # ShapeKind
MAX_POLY_VERTS = 16


def layout(conf) -> dict:
    """The tank's geometry for ``conf['n_particles']`` particles."""
    n = int(conf["n_particles"])
    scale = math.sqrt(n / 20000.0)
    size = 6.0 * scale
    x_min, x_max = 0.16 * scale, size * 0.35
    y_min, y_max = size * 0.2, size - 0.16 * scale
    spacing = math.sqrt((x_max - x_min) * (y_max - y_min) / n)
    return dict(n=n, scale=scale, size=size, mpp=size / SCREEN_LENGTH,
                x_min=x_min, y_max=y_max, spacing=spacing,
                mass=0.005 * (spacing / 0.0742) ** 2,
                n_cols=int((x_max - x_min) / spacing),
                half_wall=0.05 * scale)


def make_inputs(conf, seed: int) -> dict:
    """Host arrays (float64; the port takes them rounded to float32) of
    the 4 walls and the n liquid particles, from ``seed``."""
    g = layout(conf)
    n, sp = g["n"], g["spacing"]
    rng = np.random.default_rng(seed)
    jit = rng.uniform(-0.05, 0.05, size=(n, 2)) * sp
    i = np.arange(n)
    row, col = i // g["n_cols"], i % g["n_cols"]
    lx = g["x_min"] + (col + 0.5) * sp + jit[:, 0]
    ly = g["y_max"] - (row + 0.5) * sp + jit[:, 1]
    size, hw = g["size"], g["half_wall"]
    # left, right, floor (y = 0), top: (cx, cy, half_w, half_h)
    walls = np.array([[0.0, size * 0.5, hw, size * 0.5],
                      [size, size * 0.5, hw, size * 0.5],
                      [size * 0.5, 0.0, size * 0.5, hw],
                      [size * 0.5, size, size * 0.5, hw]])
    wv = np.zeros((4, MAX_POLY_VERTS, 2))
    for k, (_, _, a, b) in enumerate(walls):
        wv[k, :4] = [[-a, -b], [-a, b], [a, b], [a, -b]]
    return dict(
        size=size, mpp=g["mpp"],
        liquid_pos=np.stack([lx, ly], -1),
        liquid_mass=np.full(n, g["mass"]),
        liquid_color=np.stack([np.full(n, 20), 20 + i % 50, 200 + i % 55],
                              -1).astype(np.uint8),
        wall_pos=walls[:, :2].copy(), wall_verts=wv,
        wall_radius=walls[:, 3].copy(), wall_mass=np.full(4, 1e30))


def program_config(conf, inputs):
    """The port's ``ScenarioSystemConfig`` of this configuration."""
    import dataclasses

    from lpe_tpu_torch.core import config as C
    fc = conf["fluid"]
    fluid = C.FluidConfig(
        **{k: v for k, v in fc.items() if not isinstance(v, dict)},
        grid=C.FluidGridConfig(**fc["grid"]),
        numerical=dataclasses.replace(C.FluidNumericalConfig(),
                                      **fc["numerical"]),
        position_solver=dataclasses.replace(C.FluidPositionSolverConfig(),
                                            **fc["position_solver"]),
        impulse_solver=C.FluidImpulseSolverConfig(**fc["impulse_solver"]))
    shared = C.SharedSystemConfig(
        universe_size_m=inputs["size"], meters_per_pixel=inputs["mpp"],
        seconds_per_tick=1.0 / conf["ticks_per_second"],
        time_acceleration=conf["time_acceleration"], grid_size=50,
        cell_size_pixels=SCREEN_LENGTH / 50)
    return C.ScenarioSystemConfig(
        shared=shared, gravity=C.GravityConfig(**conf["gravity"]),
        boundary=C.BoundaryConfig(**conf["boundary"]), fluid=fluid,
        rigid=C.RigidBodyConfig(broadphase=C.BroadphaseConfig(
            max_pairs=conf["max_pairs"])))


def to_program(conf, inputs, device):
    """(spec, cfg, state) of the port on ``device`` from ``inputs``.

    The port's ``SceneBuilder`` takes the 4 walls and one particle, whose
    ``finalize`` gives the scene's static facts (they depend on the walls,
    the liquid's count, mass and h); the per-particle tensors are made
    from the arrays in a few bulk calls, as ``finalize`` would fill them,
    so no Python loop runs over the particles."""
    import dataclasses

    import torch

    from lpe_tpu_torch.scene import SceneBuilder
    from lpe_tpu_torch.state import Bodies, make_state
    from lpe_tpu_torch.systems.rigid.grid_pipeline import grid_dims

    cfg = program_config(conf, inputs)
    pos = inputs["liquid_pos"]
    mass = inputs["liquid_mass"]
    b = SceneBuilder(f"DAM_BREAK_{len(pos)}")
    for k in range(4):
        c = inputs["wall_pos"][k]
        v = inputs["wall_verts"][k, :4]
        b.add_wall(c[0], c[1], v[2, 0], v[2, 1], mass=inputs["wall_mass"][k],
                   static_friction=0.0, dynamic_friction=0.0)
    b.add(pos=tuple(pos[0]), mass=float(mass[0]), phase=LIQUID,
          shape_kind=CIRCLE, radius=0.02, static_friction=0.0,
          dynamic_friction=0.0)
    small = b.finalize(cfg, device="cpu")
    n = len(pos) + 4
    cap = max(128, -(-n // 128) * 128)
    spec = dataclasses.replace(
        small.spec, capacity=cap, n_entities=n, n_liquid=len(pos),
        max_nonboundary_mass=float(mass.max()))
    if grid_dims(spec, cfg) is not None:
        raise ValueError("dam_break: a scene for the grid rigid pipeline")
    sb = small.state.bodies
    h = cfg.fluid.grid.smoothing_length

    def grow(t, liquid, pad):
        """The 4 walls of ``t``, then ``liquid`` (n rows), then ``pad``."""
        shape = (cap - n,) + tuple(t.shape[1:])
        tail = torch.full(shape, pad, dtype=t.dtype)
        lq = torch.as_tensor(liquid, dtype=t.dtype).expand(
            (n - 4,) + tuple(t.shape[1:]))
        return torch.cat([t[:4], lq, tail]).to(device)

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    nl = n - 4
    fields = dict(
        pos=f32(pos), vel=0.0, mass=f32(mass), angle=0.0, omega=0.0,
        inertia=0.0, shape_kind=CIRCLE, radius=0.02, verts=0.0, nverts=0,
        phase=LIQUID, boundary=False, has_sleep=False, asleep=False,
        sleep_counter=0, active=True, static_friction=0.0,
        dynamic_friction=0.0,
        color=torch.from_numpy(inputs["liquid_color"]),
        temperature=0.0, has_temperature=False, h=h, c=1000.0,
        density=0.0, pressure=0.0, vhalf=0.0)
    pads = dict(mass=1.0, radius=1.0, static_friction=0.5,
                dynamic_friction=0.3, color=255, c=1000.0)
    bodies = {}
    for name, liquid in fields.items():
        t = getattr(sb, name)
        if isinstance(liquid, torch.Tensor) and liquid.shape[0] != nl:
            raise ValueError(name)
        bodies[name] = grow(t, liquid, pads.get(name, 0))
    state = make_state(Bodies(**bodies), max_pairs=max(1, cfg.rigid.
                                                       broadphase.max_pairs),
                       max_contacts=cfg.rigid.max_contacts_per_pair)
    return spec, cfg, state


def observe(spec, state) -> dict:
    """What the output check reads of a state: the liquid's position,
    velocity, density and pressure (copies) and the tick's time scale."""
    b = state.bodies
    sl = spec.liquid_slice
    return dict(pos=b.pos[sl].clone(), vel=b.vel[sl].clone(),
                density=b.density[sl].clone(),
                pressure=b.pressure[sl].clone(),
                dt_scale=(state.base_time_accel * state.time_scale).clone())
