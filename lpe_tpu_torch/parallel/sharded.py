"""Multi-device execution over a band mesh.

The counterpart of ``lpe_tpu/parallel/sharded.py``. The fluid runs in row
bands over the mesh's devices (``systems/fluid/sph.py``'s band step, the
counterpart of ``lpe_tpu``'s ``step_halo``) when the mesh has more than one
device, the scene has liquid and ``cfg.fluid.partition`` is ``"auto"`` or
``"halo"`` (``lpe_tpu``'s rule, sharded.py:105-107); otherwise the whole
tick runs on the mesh's lead device.

State placement differs from ``lpe_tpu``. There the entity axis of every
per-entity array is sharded under GSPMD, which changes the layout, not the
result. Here the state stays whole on the lead device (``mesh.devices[0]``),
and the rigid and gravity systems run there: only the fluid's band blocks
live on the other devices. Sharding those systems' entity axis is not
ported (ROADMAP.md Queue 1). ``lpe_tpu``'s ``_platform_cfg`` has no
counterpart: the kernel wrappers choose a kernel or its plain version by
the device of their tensors.
"""
from __future__ import annotations

import dataclasses

from ..scene import Scene
from ..state import SimState
from ..systems import build_run_fn, build_tick_fn
from . import BandMesh


def state_shardings(mesh: BandMesh, state: SimState):
    """The device of each leaf of ``state``: the mesh's lead device for
    every one (the state is not split; see the module docstring)."""
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


def build_sharded_tick(scene: Scene, mesh: BandMesh):
    """One tick over ``mesh``: the fluid in row bands when
    ``uses_bands``, everything else on the lead device. ``lpe_tpu``'s
    ``donate`` has no counterpart (PyTorch runs eagerly)."""
    return build_tick_fn(scene.spec, scene.cfg, device=mesh.lead,
                         fluid_mesh=mesh if uses_bands(scene, mesh) else None)


def build_sharded_run(scene: Scene, mesh: BandMesh, *, ticks: int):
    """A block of ``ticks`` ticks over ``mesh`` (``systems.build_run_fn``):
    under the band path the bands' blocks stay resident across the whole
    block, one build at its start and one readback at its end; a tick's
    traffic between bands is the halo rows, three exchanges a sub-step."""
    return build_run_fn(scene.spec, scene.cfg, ticks=ticks,
                        device=mesh.lead,
                        fluid_mesh=mesh if uses_bands(scene, mesh) else None)
