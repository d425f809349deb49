"""System composition: one tick in the reference's fixed order.

Order (reference: src/sim.cpp:107-114):
Fluid -> Boundary -> BasicGravity -> RigidBodyCollision -> BarnesHut ->
Rotation -> Movement -> Sleep.

The counterpart of ``lpe_tpu/systems/__init__.py``. ``build_tick_fn``
resolves which systems exist for a scene at build time and returns one
function ``SimState -> SimState``; ``build_run_fn`` advances a block of
ticks, keeping the fluid grid resident across the block when it can. Both
returned functions carry ``.systems``, the dict of their systems by name.
PyTorch runs eagerly, so ``jit`` and ``donate`` have no counterpart here.
Each call is a ``run`` span of the port's tracer (``core/profiler.py``;
a tick function called inside a ``run`` opens none), each tick in it a
``tick`` span, and each system a span of its name, as
lpe_tpu's run inside a ``jax.named_scope``; ``tick.advance`` covers the
tick counter's add, and ``fluid.grid_build`` and ``fluid.readback`` the
resident grid's build and gather-back.
"""
from __future__ import annotations

from ..core.config import ScenarioSystemConfig
from ..core.profiler import HOST, PROFILER, ROOT
from ..scene import SceneSpec
from ..state import SimState
from . import simple
from .barnes_hut import make_barnes_hut


def build_system_list(spec: SceneSpec, cfg: ScenarioSystemConfig, *,
                      device, fluid_mesh=None, mesh=None):
    """The scene's systems in tick order, as (name, step). ``fluid_mesh``
    runs the fluid in row bands over its devices; ``mesh`` splits the
    grid rigid pipeline (y-row bands) and gravity (receiver blocks) over
    its devices (``parallel.sharded``)."""
    from .fluid import make_fluid
    from .rigid import make_rigid

    systems = []

    def addn(name, fn):
        if fn is not None:
            systems.append((name, fn))

    addn("fluid", make_fluid(spec, cfg, device=device, mesh=fluid_mesh))
    addn("boundary", simple.make_boundary(spec, cfg))
    addn("gravity", simple.make_gravity(spec, cfg))
    addn("rigid", make_rigid(spec, cfg, device=device, mesh=mesh))
    addn("barnes_hut", make_barnes_hut(spec, cfg, device=device, mesh=mesh))
    addn("rotation", simple.make_rotation(spec, cfg))
    addn("movement", simple.make_movement(spec, cfg))
    addn("sleep", simple.make_sleep(spec, cfg))
    return systems


def _advance(state: SimState) -> SimState:
    with PROFILER.scope("tick.advance"):
        return state.replace(tick=state.tick + 1)


def build_tick_fn(spec: SceneSpec, cfg: ScenarioSystemConfig, *,
                  device="cuda", fluid_mesh=None, mesh=None):
    systems = build_system_list(spec, cfg, device=device,
                                fluid_mesh=fluid_mesh, mesh=mesh)

    def tick(state: SimState) -> SimState:
        with PROFILER.scope("run", ROOT, device), \
                PROFILER.scope("tick", HOST):
            for name, fn in systems:
                with PROFILER.scope(name):
                    state = fn(state)
            return _advance(state)

    tick.systems = dict(systems)
    return tick


def build_run_fn(spec: SceneSpec, cfg: ScenarioSystemConfig, *, ticks: int,
                 device="cuda", fluid_mesh=None, mesh=None):
    """Advance ``ticks`` ticks per call.

    When the fluid runs grid-resident and no other system needs per-tick
    liquid state in particle order (no Barnes-Hut, no liquid Sleep), the
    fluid grid stays resident across the WHOLE block: one
    sort/scatter at block start, one gather-back at block end, with the
    per-tick boundary/gravity updates applied to the liquid planes in grid
    space (sph.py grid_boundary/grid_gravity). See
    FluidConfig.cross_tick_residency."""
    systems = build_system_list(spec, cfg, device=device,
                                fluid_mesh=fluid_mesh, mesh=mesh)
    sysd = dict(systems)
    fl = sysd.get("fluid")
    cross_tick = (getattr(fl, "grid_build", None) is not None
                  and cfg.fluid.cross_tick_residency != "off"
                  and "barnes_hut" not in sysd
                  and not spec.liquid_has_sleep)

    if not cross_tick:
        def run(state: SimState) -> SimState:
            with PROFILER.scope("run", ROOT, device):
                for _ in range(ticks):
                    with PROFILER.scope("tick", HOST):
                        for name, fn in systems:
                            with PROFILER.scope(name):
                                state = fn(state)
                        state = _advance(state)
            return state
        run.systems = sysd
        return run

    def tick_ct(state: SimState, D):
        for name, fn in systems:
            with PROFILER.scope(name):
                if name == "fluid":
                    state, D = fl.grid_tick(state, D)
                else:
                    state = fn(state)
                    if name == "boundary":
                        D = fl.grid_boundary(D)
                    elif name == "gravity":
                        D = fl.grid_gravity(state, D)
        return _advance(state), D

    def run(state: SimState) -> SimState:
        with PROFILER.scope("run", ROOT, device):
            with PROFILER.scope("fluid.grid_build"):
                D = fl.grid_build(state)
            for _ in range(ticks):
                with PROFILER.scope("tick", HOST):
                    state, D = tick_ct(state, D)
            with PROFILER.scope("fluid.readback"):
                return fl.grid_readback(state, D)

    run.systems = sysd
    return run
