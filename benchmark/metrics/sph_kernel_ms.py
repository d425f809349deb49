"""sph_kernel_ms (ms/tick): device time of the program's own kernels
(the ``__global__`` functions of ``lpe_tpu_torch/ops/csrc``) a tick.
Moves ticks_per_s."""


def read(tr):
    us = tr.device_us(port=True)
    if us <= 0 or tr.ticks == 0:
        return None
    return us / 1e3 / tr.ticks
