"""Rigid-body system, wired as ``lpe_tpu/systems/rigid/__init__.py`` does:
the grid-resident pipeline (``grid_pipeline.make_grid_rigid_system``) for
the scenes it takes (``grid_dims`` is not None: more than
``broadphase.dense_max_solids`` solids, or ``grid_pipeline="on"``, and
only walls off the grid), the list pipeline (``pipeline.py``) for the
rest. Over a ``mesh`` (``parallel.BandMesh``) of more than one device the
grid pipeline runs in y-row bands when the mesh's size divides its cell
rows; the list pipeline splits its narrowphase by runs of pairs and its
solvers' row math by runs of rows."""
from __future__ import annotations


def make_rigid(spec, cfg, *, device="cuda", mesh=None):
    if spec.n_solid < 2:
        return None
    from .grid_pipeline import grid_dims, make_grid_rigid_system
    if grid_dims(spec, cfg) is not None:
        return make_grid_rigid_system(spec, cfg, device=device, mesh=mesh)
    from .pipeline import make_rigid_system
    return make_rigid_system(spec, cfg, device=device, mesh=mesh)
