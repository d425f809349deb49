"""gravity_pp_ms (ms/tick): device time under the program's
``barnes_hut.pp`` span (P3M's PP correction) a tick, from the trace
(``spans.range_ms``). Moves ticks_per_s."""
from benchmark import spans


def read(tr):
    return spans.range_ms(tr, "barnes_hut.pp")
