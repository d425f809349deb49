"""Trivially-vectorizable systems: Movement, BasicGravity, Boundary,
Rotation, Sleep, Dampening.

The counterparts of ``lpe_tpu/systems/simple.py``: each ``make_*`` returns
a function ``SimState -> SimState`` specialized on the static scene spec
and config. Per-entity branching becomes ``torch.where`` on masks; the
arithmetic is written in the same order as the JAX version.
"""
from __future__ import annotations

import torch

from ..core.config import ScenarioSystemConfig
from ..core.constants import PI, Phase
from ..core.numerics import sqrt, true_div
from ..scene import SceneSpec
from ..state import SimState


def make_movement(spec: SceneSpec, cfg: ScenarioSystemConfig):
    """pos += vel*dt for non-boundary, non-liquid entities. dt ignores the
    runtime timeScale, as in the reference (src/systems/movement.cpp:13-39)."""
    sh = cfg.shared
    dt = sh.seconds_per_tick * sh.time_acceleration

    def step(state: SimState) -> SimState:
        b = state.bodies
        mask = b.active & ~b.boundary & (b.phase != int(Phase.LIQUID))
        pos = torch.where(mask[:, None], b.pos + b.vel * dt, b.pos)
        return state.replace(bodies=b.replace(pos=pos))

    return step


def make_gravity(spec: SceneSpec, cfg: ScenarioSystemConfig):
    """Uniform ``vel.y += g*dt`` (screen-down is +y); ``None`` when the
    planetary-mass auto-disable applies (src/systems/gravity.cpp:19-59)."""
    g = cfg.gravity.gravitational_acceleration
    thr = cfg.gravity.planetary_mass_threshold
    if thr > 0.0 and spec.max_nonboundary_mass >= thr:
        return None
    base_dt = cfg.shared.seconds_per_tick

    def step(state: SimState) -> SimState:
        b = state.bodies
        dt = base_dt * state.base_time_accel * state.time_scale
        mask = b.active & ~b.boundary
        vy = torch.where(mask, b.vel[:, 1] + g * dt, b.vel[:, 1])
        vel = torch.stack([b.vel[:, 0], vy], -1)
        return state.replace(bodies=b.replace(vel=vel))

    return step


def make_boundary(spec: SceneSpec, cfg: ScenarioSystemConfig):
    """Clamp + bounce at universe edges with margin/damping/speed cap
    (src/systems/boundary.cpp:13-71)."""
    bc = cfg.boundary
    margin = bc.margin_pixels * cfg.shared.meters_per_pixel
    size = cfg.shared.universe_size_m
    damp = bc.bounce_damping
    vmax = bc.max_speed

    def step(state: SimState) -> SimState:
        b = state.bodies
        mask = b.active & ~b.asleep
        x, y = b.pos[:, 0], b.pos[:, 1]
        vx, vy = b.vel[:, 0], b.vel[:, 1]

        lo, hi = margin, size - margin
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
        scale = torch.where(bounced & (speed > vmax),
                            true_div(vmax, torch.clamp(speed, min=1e-30)),
                            torch.ones_like(speed))
        vx2, vy2 = vx2 * scale, vy2 * scale

        pos = torch.where(mask[:, None], torch.stack([x2, y2], -1), b.pos)
        vel = torch.where(mask[:, None], torch.stack([vx2, vy2], -1), b.vel)
        return state.replace(bodies=b.replace(pos=pos, vel=vel))

    return step


def make_rotation(spec: SceneSpec, cfg: ScenarioSystemConfig):
    """angle += omega*dt, angular damping, omega clamp, single-step wrap
    (src/systems/rotation.cpp:17-60)."""
    rc = cfg.rotation
    base_dt = cfg.shared.seconds_per_tick
    two_pi = 2.0 * PI

    def step(state: SimState) -> SimState:
        b = state.bodies
        dt = base_dt * state.base_time_accel * state.time_scale
        mask = b.active & ~b.boundary
        ang = b.angle + b.omega * dt
        om = b.omega
        if rc.angular_damping < 1.0:
            om = om * rc.angular_damping
        if rc.max_angular_speed > 0:
            om = torch.clamp(om, -rc.max_angular_speed, rc.max_angular_speed)
        # single-step normalization, exactly as the reference does it
        ang = torch.where(ang > two_pi, ang - two_pi, ang)
        ang = torch.where(ang < 0.0, ang + two_pi, ang)
        return state.replace(bodies=b.replace(
            angle=torch.where(mask, ang, b.angle),
            omega=torch.where(mask, om, b.omega)))

    return step


def make_sleep(spec: SceneSpec, cfg: ScenarioSystemConfig):
    """Sleep counter bookkeeping; sleeping zeroes velocities
    (src/systems/sleep.cpp:19-70)."""
    sc = cfg.sleep

    def step(state: SimState) -> SimState:
        b = state.bodies
        mask = b.active & b.has_sleep & ~b.boundary
        speed = sqrt((b.vel ** 2).sum(-1))
        can_rot = b.inertia > 0
        ang_speed = torch.where(can_rot, b.omega.abs(),
                                torch.zeros_like(b.omega))
        slow = (speed < sc.linear_sleep_threshold) & \
               (ang_speed < sc.angular_sleep_threshold)

        counter = torch.where(
            mask & slow & ~b.asleep, b.sleep_counter + 1,
            torch.where(mask & ~slow, torch.zeros_like(b.sleep_counter),
                        b.sleep_counter))
        asleep = torch.where(
            mask, slow & (b.asleep | (counter > sc.sleep_frames_threshold)),
            b.asleep)
        vel = torch.where((mask & asleep)[:, None], torch.zeros_like(b.vel),
                          b.vel)
        omega = torch.where(mask & asleep & can_rot,
                            torch.zeros_like(b.omega), b.omega)
        return state.replace(bodies=b.replace(
            vel=vel, omega=omega, asleep=asleep, sleep_counter=counter))

    return step


def make_dampening(spec: SceneSpec, cfg: ScenarioSystemConfig):
    """Uniform velocity damping: dead code in the reference (never added to
    its system list, src/sim.cpp:107-114); opt-in here as in lpe_tpu."""
    k = cfg.dampening.linear_damping

    def step(state: SimState) -> SimState:
        b = state.bodies
        mask = b.active
        vel = torch.where(mask[:, None], b.vel * k, b.vel)
        omega = torch.where(mask, b.omega * k, b.omega)
        return state.replace(bodies=b.replace(vel=vel, omega=omega))

    return step
