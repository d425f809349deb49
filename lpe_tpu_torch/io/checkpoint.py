"""Checkpoint / resume: SimState <-> npz on disk.

The counterpart of ``lpe_tpu/io/checkpoint.py``, in the same format: one
compressed npz with a key per leaf, ``bodies.<field>`` for the bodies and
``<field>`` for the rest, each with lpe_tpu's dtype and shape. A file that
either package writes loads in the other to the bit, so a state moves
between the two with no conversion code.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..state import Bodies, SimState, make_state


def _flatten(tree, prefix=""):
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_flatten(getattr(tree, f.name), f"{prefix}{f.name}."))
    else:
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    return out


def save_state(path: str, state: SimState) -> None:
    np.savez_compressed(path, **_flatten(state))


def load_state(path: str, device="cuda") -> SimState:
    """The state in ``path`` on ``device``. Missing state fields (e.g.
    warm-start caches added after a checkpoint was written) fall back to
    their make_state initializers so old checkpoints stay loadable —
    resuming merely cold-starts the new caches, which is always a valid
    solver state."""
    with np.load(path) as z:
        def t(key):
            return torch.from_numpy(z[key]).to(device)

        bodies = Bodies(**{f.name: t(f"bodies.{f.name}")
                           for f in dataclasses.fields(Bodies)})
        mp, mc = (z["warm_normal"].shape if "warm_normal" in z else (1, 8))
        defaults = make_state(bodies, max_pairs=int(mp), max_contacts=int(mc))
        rest = {f.name: (t(f.name) if f.name in z
                         else getattr(defaults, f.name))
                for f in dataclasses.fields(SimState) if f.name != "bodies"}
    return SimState(bodies=bodies, **rest)
