"""lpe_tpu_torch — the PyTorch/CUDA port of lpe_tpu.

A second package beside ``lpe_tpu``: it imports ``torch`` and ``numpy``
and never ``jax``. Module paths mirror ``lpe_tpu``'s, and so do the names
exported here. Entry points run on the card (``device="cuda"``) unless
given ``device="cpu"``; the hot kernels are hand-written CUDA C++ in
``ops/csrc/``, built with ``nvcc`` at first use. The CLI is
``python -m lpe_tpu_torch.app.cli``.
"""
from .core import constants
from .core.config import ScenarioSystemConfig
from .core.constants import Phase, ShapeKind, SimulationType
from .scenarios import create_scenario, list_scenarios
from .scene import Scene, SceneBuilder, SceneSpec
from .state import Bodies, SimState
from .systems import build_tick_fn

__all__ = [
    "constants", "ScenarioSystemConfig", "Phase", "ShapeKind",
    "SimulationType", "create_scenario", "list_scenarios", "Scene",
    "SceneBuilder", "SceneSpec", "Bodies", "SimState", "build_tick_fn",
]
