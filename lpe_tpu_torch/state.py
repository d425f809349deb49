"""Simulation state: a fixed-capacity structure-of-arrays of tensors.

The PyTorch counterpart of ``lpe_tpu/state.py``: the same two frozen
dataclasses with the same fields, dtypes and shapes, holding ``torch``
tensors on one device instead of jax arrays. "Has component" checks are
boolean masks; every system is a function ``SimState -> SimState`` that
returns a new state through ``.replace()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Bodies(_Replace):
    """Per-entity tensors, capacity ``N`` (padded; see ``active``)."""

    # Kinematics
    pos: torch.Tensor           # [N, 2] float32
    vel: torch.Tensor           # [N, 2] float32
    mass: torch.Tensor          # [N] float32
    angle: torch.Tensor         # [N] float32
    omega: torch.Tensor         # [N] float32
    inertia: torch.Tensor       # [N] float32 (<=0 means "cannot rotate")

    # Shape
    shape_kind: torch.Tensor    # [N] int32 (ShapeKind)
    radius: torch.Tensor        # [N] float32
    verts: torch.Tensor         # [N, MAX_POLY_VERTS, 2] float32, local, CCW
    nverts: torch.Tensor        # [N] int32

    # Classification / flags
    phase: torch.Tensor         # [N] int32 (Phase)
    boundary: torch.Tensor      # [N] bool
    has_sleep: torch.Tensor     # [N] bool
    asleep: torch.Tensor        # [N] bool
    sleep_counter: torch.Tensor  # [N] int32
    active: torch.Tensor        # [N] bool (capacity padding mask)

    # Material & render
    static_friction: torch.Tensor   # [N] float32
    dynamic_friction: torch.Tensor  # [N] float32
    color: torch.Tensor         # [N, 3] uint8
    temperature: torch.Tensor   # [N] float32
    has_temperature: torch.Tensor  # [N] bool

    # SPH per-particle quantities
    h: torch.Tensor             # [N] float32 smoothing length
    c: torch.Tensor             # [N] float32 speed of sound
    density: torch.Tensor       # [N] float32
    pressure: torch.Tensor      # [N] float32
    vhalf: torch.Tensor         # [N, 2] float32


@dataclass(frozen=True)
class SimState(_Replace):
    """Full simulation state: bodies + the SimulatorState singleton. The
    rigid-solver caches keep the shapes of ``lpe_tpu.state.SimState``
    (see its field comments) so states convert one to one."""

    bodies: Bodies
    time_scale: torch.Tensor       # scalar float32
    base_time_accel: torch.Tensor  # scalar float32
    tick: torch.Tensor             # scalar int32
    warm_normal: torch.Tensor      # [max_pairs, max_contacts] float32
    warm_tangent: torch.Tensor     # [max_pairs, max_contacts] float32
    warm_ia: torch.Tensor          # [max_pairs] int32 (-1 = empty slot)
    warm_ib: torch.Tensor          # [max_pairs] int32
    warm_pt: torch.Tensor          # [max_pairs, max_contacts, 2] float32
    warm_n: torch.Tensor           # [max_pairs, 2] float32
    bp_ia: torch.Tensor            # [max_pairs] int32
    bp_ib: torch.Tensor            # [max_pairs] int32
    bp_anchor_pos: torch.Tensor    # [n, 2] float32
    bp_anchor_ang: torch.Tensor    # [n] float32
    rg_flat: torch.Tensor          # [n_solid] int32
    rg_table: torch.Tensor         # [NC*KB] int32
    rg_ka: torch.Tensor            # [NC, R] int32
    rg_kb: torch.Tensor            # [NC, R] int32
    rg_valid: torch.Tensor         # [NC, R] bool
    rg_verts: torch.Tensor         # [NC*KB, VS, 2] float32
    rg_nverts: torch.Tensor        # [NC*KB] int32
    rg_radius: torch.Tensor        # [NC*KB] float32
    rg_iscirc: torch.Tensor        # [NC*KB] bool
    rg_invm: torch.Tensor          # [NC*KB] float32
    rg_invi: torch.Tensor          # [NC*KB] float32
    rg_warm_n: torch.Tensor        # [NC, R, C] float32
    rg_warm_t: torch.Tensor        # [NC, R, C] float32
    rg_warm_pt: torch.Tensor       # [NC, R, C, 2] float32
    rg_warm_nrm: torch.Tensor      # [NC, R, 2] float32


def make_state(bodies: Bodies, max_pairs: int = 1, max_contacts: int = 8,
               grid_cells: int = 0, grid_slots: int = 0, grid_rows: int = 0,
               grid_verts: int = 0, n_solid: int = 0) -> SimState:
    """The state around ``bodies``, on ``bodies``' device. Grid-rigid cache
    sizing uses placeholder [1]-shapes when the grid pipeline is off
    (``grid_cells == 0``), as ``lpe_tpu.state.make_state`` does."""
    dev = bodies.pos.device
    f32, i32 = torch.float32, torch.int32
    NC = max(1, grid_cells)
    KB = max(1, grid_slots)
    R = max(1, grid_rows)
    VS = max(1, grid_verts)
    NS = max(1, n_solid if grid_cells else 1)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SimState(
        bodies=bodies,
        time_scale=full((), 1.0, f32),
        base_time_accel=full((), 1.0, f32),
        tick=zeros((), i32),
        warm_normal=zeros((max_pairs, max_contacts), f32),
        warm_tangent=zeros((max_pairs, max_contacts), f32),
        warm_ia=full((max_pairs,), -1, i32),
        warm_ib=full((max_pairs,), -1, i32),
        warm_pt=full((max_pairs, max_contacts, 2), 1e30, f32),
        warm_n=zeros((max_pairs, 2), f32),
        bp_ia=full((max_pairs,), -1, i32),
        bp_ib=full((max_pairs,), -1, i32),
        bp_anchor_pos=torch.full_like(bodies.pos, float("inf")),
        bp_anchor_ang=torch.full_like(bodies.angle, float("inf")),
        rg_flat=full((NS,), -1, i32),
        rg_table=full((NC * KB,), n_solid, i32),
        rg_ka=zeros((NC, R), i32),
        rg_kb=zeros((NC, R), i32),
        rg_valid=zeros((NC, R), torch.bool),
        rg_verts=zeros((NC * KB, VS, 2), f32),
        rg_nverts=zeros((NC * KB,), i32),
        rg_radius=zeros((NC * KB,), f32),
        rg_iscirc=zeros((NC * KB,), torch.bool),
        rg_invm=zeros((NC * KB,), f32),
        rg_invi=zeros((NC * KB,), f32),
        rg_warm_n=zeros((NC, R, max_contacts), f32),
        rg_warm_t=zeros((NC, R, max_contacts), f32),
        rg_warm_pt=full((NC, R, max_contacts, 2), 1e30, f32),
        rg_warm_nrm=zeros((NC, R, 2), f32),
    )
