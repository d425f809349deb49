"""Rigid-body system, wired as ``lpe_tpu/systems/rigid/__init__.py`` does.

- Scenes that the grid-resident pipeline takes (``grid_dims`` is not None:
  more than ``broadphase.dense_max_solids`` solids, or
  ``grid_pipeline="on"``, and only walls off the grid) run
  ``grid_pipeline.make_grid_rigid_system``.
- Other scenes need ``lpe_tpu``'s list pipeline
  (``lpe_tpu/systems/rigid/pipeline.py``), which is ROADMAP.md Queue 1
  item 5. The one case ported is a scene whose solids are all boundary
  walls: the list pipeline's broadphase drops every boundary-boundary pair
  (``pipeline.py:241-244``), so its step leaves every field as it was but
  ``warm_n`` (EPA output for padding pairs, read only for a valid pair,
  ``pipeline.py:394-412``), which the port leaves untouched. Any other
  solid raises.
"""
from __future__ import annotations


def make_rigid(spec, cfg, *, device="cuda"):
    if spec.n_solid < 2:
        return None
    from .grid_pipeline import grid_dims, make_grid_rigid_system
    if grid_dims(spec, cfg) is not None:
        return make_grid_rigid_system(spec, cfg, device=device)
    solids = spec.solid_slice
    checked = []

    def step(state):
        # Which solids are walls is state, not spec: read it once, on the
        # first tick (the only host read of the all-wall step).
        if not checked:
            if not bool(state.bodies.boundary[solids].all()):
                raise NotImplementedError(
                    "rigid bodies other than boundary walls need the rigid "
                    "list pipeline (ROADMAP.md Queue 1 item 5)")
            checked.append(True)
        return state

    return step
