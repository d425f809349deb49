"""gravity_mesh_ms (ms/tick): device time under the program's
``barnes_hut.mesh`` span (P3M's mesh far field: deposit, FFT solve,
interpolation) a tick, from the trace (``spans.range_ms``). Moves
ticks_per_s."""
from benchmark import spans


def read(tr):
    return spans.range_ms(tr, "barnes_hut.mesh")
