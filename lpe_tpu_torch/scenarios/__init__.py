"""Scenario catalog + factory.

The counterpart of ``lpe_tpu/scenarios/__init__.py``. Each scenario module
exposes ``build(seed=..., device=...) -> Scene``; seeds drive
``numpy.random.default_rng`` exactly as in ``lpe_tpu``, so both packages
build bitwise-identical scenes. Only SIMPLE_FLUID is ported so far.
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
    from . import simple_fluid  # noqa: F401
    if isinstance(sim_type, str):
        sim_type = SimulationType[sim_type]
    if sim_type not in _BUILDERS:
        raise NotImplementedError(
            f"scenario {get_scenario_name(sim_type)} is not ported yet "
            "(ROADMAP.md Queue 1 item 7: the remaining scenarios)")
    return _BUILDERS[sim_type](seed=seed, device=device, **kw)

