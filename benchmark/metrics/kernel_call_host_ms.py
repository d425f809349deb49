"""kernel_call_host_ms (ms/tick): host time of the program's ``op.<name>``
spans (``spans.py``) a tick: the kernel calls' argument checks, parameter
packing and ctypes launches. Moves ticks_per_s."""
from benchmark import spans


def read(tr):
    return spans.per_tick(tr, lambda name: name.startswith("op."),
                          lambda s: s.host_ms)
