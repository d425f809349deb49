"""Float32 arithmetic that rounds like the JAX package and the CUDA
kernels."""
from __future__ import annotations

import torch


def true_div(a, b):
    """``a / b`` with one IEEE rounding, also when ``a`` or ``b`` is a
    Python number. PyTorch evaluates ``c / t`` as ``reciprocal(t) * c``,
    and on CUDA ``t / c`` as ``t * (1 / c)``; each rounds twice, which can
    move a particle across a cell boundary that ``floor(x / cell)`` tests."""
    t = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=t.dtype, device=t.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=t.dtype, device=t.device)
    return torch.div(a, b)


def sqrt(x):
    """Correctly rounded float32 square root. PyTorch's CPU ``sqrt`` can be
    off by one ulp; float64 then rounding to float32 is exact for a float32
    input (53 >= 2 * 24 + 2 bits), as IEEE ``sqrtf`` is on the GPU."""
    return torch.sqrt(x.double()).to(x.dtype)
