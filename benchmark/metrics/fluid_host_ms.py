"""fluid_host_ms (ms/tick): host time of the program's ``fluid``,
``fluid.grid_build`` and ``fluid.readback`` spans (``spans.py``) a tick:
what the host spends on the fluid (its dispatch, and its kernel calls).
Moves ticks_per_s."""
from benchmark import spans

NAMES = ("fluid", "fluid.grid_build", "fluid.readback")


def read(tr):
    return spans.per_tick(tr, NAMES.__contains__, lambda s: s.host_ms)
