"""lpe_tpu_torch — the PyTorch/CUDA port of lpe_tpu.

A second package beside ``lpe_tpu``: it imports ``torch`` and ``numpy``
and never ``jax``. Module paths mirror ``lpe_tpu``'s. The ported slice is
the single-device, grid-resident SPH fluid tick (see README.md, "PyTorch/
CUDA port"); its three hot kernels are hand-written CUDA C++ in
``ops/csrc/``, built with ``nvcc`` at first use.
"""
from .core import constants
from .core.config import ScenarioSystemConfig
from .state import Bodies, SimState

__all__ = ["constants", "ScenarioSystemConfig", "Bodies", "SimState"]
