"""gravity_roofline (%): the bound of the traced ticks' P3M work
(``bounds.gravity_bound_s`` at each tick's input positions: the mesh's
FFTs and CIC passes, the PP pairs within the cutoff among the first K
bodies of each cell by the benchmark's own binning, the heavy direct
sum) over the device time under the ``barnes_hut`` range. Moves
ticks_per_s."""
from benchmark import bounds


def read(tr):
    us = tr.range_us.get("barnes_hut", 0.0)
    if us <= 0 or not tr.block_inputs:
        return None
    conf, inp = tr.conf, tr.inputs
    n = len(inp["mass"])
    heavy = int((inp["mass"] >= conf["barnes_hut"]["heavy_threshold"]).sum())
    heavy = min(heavy, conf["barnes_hut"]["heavy_cap"])
    cap = -(-n // 128) * 128          # the port sizes the PP grid by it
    need = sum(bounds.gravity_bound_s(obs["pos"][:n], conf, inp["size"],
                                      cap, heavy)
               for obs in tr.block_inputs) * tr.ticks_per_block
    return 100.0 * need / (us * 1e-6)
