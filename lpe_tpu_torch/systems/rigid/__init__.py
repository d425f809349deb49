"""Rigid-body system: a restricted port.

Only scenes whose solids are all boundary walls are supported so far. For
those, ``lpe_tpu``'s list pipeline (``lpe_tpu/systems/rigid/pipeline.py``)
builds no valid candidate pair: its broadphase filter drops every
boundary-boundary pair (``pipeline.py:241-244``), so the step leaves every
field of the state as it was. The one field the JAX step does write is
``warm_n``, with EPA output for padding pairs that is only ever read for
a valid pair (``pipeline.py:394-412``); the port leaves it untouched.
Scenes with a non-boundary solid need the real pipeline: ROADMAP.md Queue 1
item 5.
"""
from __future__ import annotations


def make_rigid(spec, cfg):
    if spec.n_solid < 2:
        return None
    solids = spec.solid_slice
    checked = []

    def step(state):
        # Which solids are walls is state, not spec: read it once, on the
        # first tick (the only host read of the rigid step).
        if not checked:
            if not bool(state.bodies.boundary[solids].all()):
                raise NotImplementedError(
                    "rigid bodies other than boundary walls need the rigid "
                    "list pipeline (ROADMAP.md Queue 1 item 5)")
            checked.append(True)
        return state

    return step
