"""cuda_mallocs_per_tick (calls/tick): the caching allocator's segments
allocated (its ``cudaMalloc`` calls) over the program's ``run`` spans
(``spans.py``) a tick; None on the CPU. Moves ticks_per_s."""
from benchmark import spans


def read(tr):
    return spans.per_tick(tr, "run".__eq__, lambda s: s.mallocs)
