"""Scenario catalog + factory.

The counterpart of ``lpe_tpu/scenarios/__init__.py``. Each scenario module
exposes ``build(seed=..., device=...) -> Scene``; seeds drive
``numpy.random.default_rng`` exactly as in ``lpe_tpu``, so both packages
build bitwise-identical scenes. KEPLERIAN_DISK and PLANETARY_OCEAN need
N-body gravity, which is not ported yet.
"""
from __future__ import annotations

from ..core.constants import SimulationType, get_scenario_name
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
                   hourglasses, random_polygons, simple_fluid)
    if isinstance(sim_type, str):
        sim_type = SimulationType[sim_type]
    if sim_type not in _BUILDERS:
        raise NotImplementedError(
            f"scenario {get_scenario_name(sim_type)} needs N-body gravity, "
            "which is not ported yet (ROADMAP.md Queue 1 item 4)")
    return _BUILDERS[sim_type](seed=seed, device=device, **kw)

