"""The program's spans in a traced window, for the metrics that read them.

The port's tracer (``lpe_tpu_torch/core/profiler.py``) records a span
while a torch.profiler session records. A traced run's root spans are its
traced blocks (``run``, one a ``build_run_fn`` call): 2n + 1 of them, n =
``tr.ticks // tr.ticks_per_block`` (``trace.py``: the start-up block, n
blocks with the device's activity alone, n with host and device). The
readers of host time take blocks 1 .. n, where the profiler slows the host
least, and find nothing (None) where the program has no such spans or
their count is not 2n + 1.

A span's device time is read from the trace, not from the span
(``range_ms``): while torch.profiler records, each layer span is a
``record_function`` range of its name, and the host+device session
credits each device operation to the ranges its launch call was made in,
as ``trace.reduce`` does for the harness's ranges.
"""
from __future__ import annotations

import sys


def blocks(tr):
    """The spans of the device-only blocks (each a root span and the spans
    under it), or None."""
    from lpe_tpu_torch.core import profiler
    read = getattr(profiler.PROFILER, "spans", None)
    if read is None or tr.ticks_per_block <= 0:
        return None
    spans = read()
    roots = [s for s in spans if s.parent is None]
    n = tr.ticks // tr.ticks_per_block
    if n <= 0 or len(roots) != 2 * n + 1:
        return None
    keep = {id(s) for s in roots[1:n + 1]}

    def root(s):
        while s.parent is not None:
            s = s.parent
        return s

    return [s for s in spans if id(root(s)) in keep]


def per_tick(tr, chosen, value):
    """The sum of ``value(span)`` over the chosen spans (``chosen(name)``)
    of the device-only blocks, over those blocks' ``tick`` spans; None
    where there are none or a value is None."""
    spans = blocks(tr)
    if spans is None:
        return None
    ticks = sum(1 for s in spans if s.name == "tick")
    values = [value(s) for s in spans if chosen(s.name)]
    if ticks == 0 or not values or any(v is None for v in values):
        return None
    return sum(values) / ticks


def _full_session(tr):
    """The host+device profiler session that ``tr`` was reduced from, or
    None. The harness hands a reader ``tr`` alone and keeps its
    ``trace.Sessions`` in a calling frame: the one whose block inputs are
    ``tr``'s."""
    from benchmark.trace import Sessions
    inputs = getattr(tr, "block_inputs", None)
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, Sessions) and v.full is not None and \
                    v.block_inputs is inputs:
                return v.full
        f = f.f_back
    return None


def range_ms(tr, name):
    """Device ms a tick under the program's range ``name`` in the
    host+device session (the device operations whose launch call the host
    made inside it), or None where that session is not found or nothing
    on the device ran under ``name`` (the CPU; a program without the
    span)."""
    prof = _full_session(tr)
    if prof is None or tr.ticks <= 0:
        return None
    from benchmark.trace import reduce
    us = reduce(prof, ticks=tr.ticks, range_names=(name,),
                port_kernels=set()).range_us[name]
    return us / 1e3 / tr.ticks if us > 0 else None
