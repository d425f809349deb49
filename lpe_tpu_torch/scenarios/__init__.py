"""Scenario catalog + factory.

The counterpart of ``lpe_tpu/scenarios/__init__.py``. Each scenario module
exposes ``build(seed=..., device=...) -> Scene``; seeds drive
``numpy.random.default_rng`` exactly as in ``lpe_tpu``, so both packages
build bitwise-identical scenes. Every ``SimulationType`` has a builder.
"""
from __future__ import annotations

from ..core.constants import (SimulationType, get_all_scenarios,
                              get_scenario_name)
from ..scene import Scene

_BUILDERS = {}


def register(sim_type: SimulationType):
    def deco(fn):
        _BUILDERS[sim_type] = fn
        return fn
    return deco


def create_scenario(sim_type: SimulationType, seed: int = 0, *,
                    device="cuda", **kw) -> Scene:
    from . import (fluid_and_polygons, galton_board,  # noqa: F401
                   hourglasses, keplerian_disk, planetary_ocean,
                   random_polygons, simple_fluid)
    if isinstance(sim_type, str):
        sim_type = SimulationType[sim_type]
    return _BUILDERS[sim_type](seed=seed, device=device, **kw)


def list_scenarios():
    return [(s, get_scenario_name(s)) for s in get_all_scenarios()]
