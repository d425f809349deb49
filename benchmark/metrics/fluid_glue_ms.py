"""fluid_glue_ms (ms/tick): device time of every operation that is not
one of the program's own kernels, a tick: in the dam's cells the fluid's
PyTorch glue (grid build and readback, stacks, candidate raster, force
sums) and the small systems around it. Read only where the program's
kernels ran (the fluid's sub-steps). Moves ticks_per_s."""


def read(tr):
    if tr.device_us(port=True) <= 0 or tr.ticks == 0:
        return None
    return tr.device_us(port=False) / 1e3 / tr.ticks
