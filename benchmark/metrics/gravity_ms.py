"""gravity_ms (ms/tick): device time under the ``barnes_hut`` range of the
tick (``systems/barnes_hut.py`` and ``ops/pm_gravity.py``: masks, heavy
direct sum, mesh, PP correction, the kick). Moves ticks_per_s."""


def read(tr):
    us = tr.range_us.get("barnes_hut", 0.0)
    if us <= 0 or tr.ticks == 0:
        return None
    return us / 1e3 / tr.ticks
