"""Carry states and specs across from ``lpe_tpu`` without importing jax.

``state_from_numpy`` takes any tree with the field names of
``lpe_tpu.state.SimState`` whose leaves are numpy arrays (for example the
output of ``lpe_tpu.state.to_numpy``) and returns this package's
:class:`~lpe_tpu_torch.state.SimState` on ``device``. ``state_to_numpy``
goes the other way, to this package's dataclasses holding numpy arrays.
Both are bitwise: dtypes and values are kept as they are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene import SceneSpec
from .state import Bodies, SimState


def _names(cls):
    return [f.name for f in dataclasses.fields(cls)]


def state_from_numpy(tree, device) -> SimState:
    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    bodies = Bodies(**{n: t(getattr(tree.bodies, n)) for n in _names(Bodies)})
    rest = {n: t(getattr(tree, n)) for n in _names(SimState) if n != "bodies"}
    return SimState(bodies=bodies, **rest)


def state_to_numpy(state: SimState) -> SimState:
    def a(x):
        return x.detach().cpu().numpy()

    bodies = Bodies(**{n: a(getattr(state.bodies, n)) for n in _names(Bodies)})
    rest = {n: a(getattr(state, n)) for n in _names(SimState)
            if n != "bodies"}
    return SimState(bodies=bodies, **rest)


def spec_from_dict(d: dict) -> SceneSpec:
    """``SceneSpec`` from ``dataclasses.asdict`` of either package's spec."""
    d = dict(d)
    d["solid_big_idx"] = tuple(int(i) for i in d["solid_big_idx"])
    return SceneSpec(**d)
