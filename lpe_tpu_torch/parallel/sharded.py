"""Multi-device execution over a band mesh.

The counterpart of ``lpe_tpu/parallel/sharded.py``. Over a mesh of more
than one device the work is split as ``lpe_tpu``'s shardings split it:

- **the fluid** runs in row bands (``systems/fluid/sph.py``'s band step,
  the counterpart of ``lpe_tpu``'s ``step_halo``) when the scene has liquid
  and ``cfg.fluid.partition`` is ``"auto"`` or ``"halo"`` (``lpe_tpu``'s
  rule, sharded.py:105-107);
- **gravity** (``systems/barnes_hut.py``) is split by receiver, as GSPMD
  splits the O(N^2) tiles of the entity-sharded arrays: the direct sum's
  row blocks, and on the P3M branch the PP correction's passes, go to the
  devices in contiguous runs of whole blocks, each device with its own
  copy of the sources; the P3M mesh and the heavy direct sum stay on the
  lead device;
- **the grid rigid pipeline** (``systems/rigid/grid_pipeline.py``) runs in
  y-row bands, the split of ``lpe_tpu``'s ``rg_*`` cell axis, when the
  mesh's size divides its nbx cell rows (``grid_dims`` rounds nbx to a
  multiple of 8); each band takes its rows of the candidate rows, the warm
  starts and the body grids, and the row below it, which the (dy = 1)
  class passes exchange. Otherwise it runs whole on the lead device, as
  ``lpe_tpu`` replicates an ``rg_*`` leaf its mesh does not divide;
- **the rigid list pipeline** (``systems/rigid/pipeline.py``), as GSPMD
  splits its vmapped pairs: the narrowphase (GJK, EPA, the circle closed
  form, the manifolds) by contiguous runs of candidate pairs and the
  solvers' row math by contiguous runs of each stage segment's rows
  (``parallel.Runs``), the results back to the lead in pair and row
  order, where the broadphase, the guard, the compaction, the warm-start
  hash and the solvers' ordered scatter-adds stay (their leaves are
  ``[max_pairs]``-shaped, which ``lpe_tpu`` replicates);
- the elementwise systems run on the lead device.

Every split keeps the single device's shapes or its per-row ops (the
fluid's and the rigid bands' per cell or row, gravity's per block, the
list pipeline's per pair or row, its sums in row order on the lead), so
the bits are one device's (the fluid's force sums on rigids and the
rigid bands' scatters may reassociate: see their tests). State
placement differs from ``lpe_tpu``: the state stays whole on the lead
device (``mesh.devices[0]``), and each split system copies its inputs
to the devices and its results back in a fixed order;
``state_shardings`` names the lead for every leaf.
``lpe_tpu``'s ``_platform_cfg`` has no counterpart: the kernel wrappers
choose a kernel or its plain version by the device of their tensors.
"""
from __future__ import annotations

import dataclasses

from ..scene import Scene
from ..state import SimState
from ..systems import build_run_fn, build_tick_fn
from . import BandMesh


def state_shardings(mesh: BandMesh, state: SimState):
    """The device of each leaf of ``state``: the mesh's lead device for
    every one. The state is not split; the work on it is. ``lpe_tpu``
    shards a leaf's leading axis when it is the entity axis (the bodies:
    here gravity splits its receivers in blocks, and the list pipeline,
    which works on per-pair rows gathered from the entity leaves, its
    pairs and contact rows in runs) or, for an ``rg_*`` leaf but
    ``rg_flat``, when the mesh's size divides it (the cell axis: here the
    grid rigid pipeline's y-row bands, when the size divides nbx); the
    rest it replicates (see the module docstring)."""
    def dev(x):
        return mesh.lead

    bodies = state.bodies.replace(**{
        f.name: dev(getattr(state.bodies, f.name))
        for f in dataclasses.fields(state.bodies)})
    return state.replace(bodies=bodies, **{
        f.name: dev(getattr(state, f.name))
        for f in dataclasses.fields(state) if f.name != "bodies"})


def shard_state(mesh: BandMesh, state: SimState) -> SimState:
    """``state`` on the mesh's lead device."""
    def to(x):
        return x.to(mesh.lead)

    bodies = state.bodies.replace(**{
        f.name: to(getattr(state.bodies, f.name))
        for f in dataclasses.fields(state.bodies)})
    return state.replace(bodies=bodies, **{
        f.name: to(getattr(state, f.name))
        for f in dataclasses.fields(state) if f.name != "bodies"})


def uses_bands(scene: Scene, mesh: BandMesh) -> bool:
    """Whether the fluid of ``scene`` runs in row bands over ``mesh``."""
    return (scene.cfg.fluid.partition in ("auto", "halo")
            and mesh.size > 1 and scene.spec.n_liquid > 0)


def _entity_mesh(mesh: BandMesh):
    """The mesh gravity and both rigid pipelines split over, or None."""
    return mesh if mesh.size > 1 else None


def build_sharded_tick(scene: Scene, mesh: BandMesh):
    """One tick over ``mesh``: the fluid in row bands when
    ``uses_bands``, gravity and the rigid pipelines split when the mesh
    has more than one device (the module docstring), the rest on the lead
    device. ``lpe_tpu``'s ``donate`` has no counterpart (PyTorch runs
    eagerly)."""
    return build_tick_fn(scene.spec, scene.cfg, device=mesh.lead,
                         fluid_mesh=mesh if uses_bands(scene, mesh) else None,
                         mesh=_entity_mesh(mesh))


def build_sharded_run(scene: Scene, mesh: BandMesh, *, ticks: int):
    """A block of ``ticks`` ticks over ``mesh`` (``systems.build_run_fn``),
    split as ``build_sharded_tick``: under the fluid's band path the bands'
    blocks stay resident across the whole block, one build at its start
    and one readback at its end, and a tick's traffic between bands is the
    halo rows, three exchanges a sub-step; the gravity and rigid splits
    copy their inputs out and their results back every tick (the list
    pipeline's solvers at every stage of every iteration)."""
    return build_run_fn(scene.spec, scene.cfg, ticks=ticks,
                        device=mesh.lead,
                        fluid_mesh=mesh if uses_bands(scene, mesh) else None,
                        mesh=_entity_mesh(mesh))
