"""Cells of more than 32 slots, up to the reference's cap of 64. The CUDA SPH
kernels keep a cell's K slots in at most two warps (``ops/sph_kernels.MAX_K``
= 64, lpe_tpu/core/constants.py MAX_PER_CELL), so on the card
``make_fluid_system`` refuses a larger K when it builds, before it touches
CUDA (these tests run without a card), and takes K = 64. On the CPU the
plain versions take any K, as lpe_tpu does: scenes with 40 particles in one
cell at ``max_per_cell=48`` and 60 at ``max_per_cell=64`` match lpe_tpu's
resident XLA path at the JAX package's tolerances (tests/test_sph.py)."""
import dataclasses

import jax
import numpy as np
import pytest

from lpe_tpu_torch.ops import sph_kernels as SK
from test_torch_fluid_slice import assert_fluid_close, to_port, xla_resident
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CROWD = 40           # particles in one cell, more than a warp's 32 slots


def with_max_per_cell(cfg, k):
    return cfg.replace(fluid=dataclasses.replace(
        cfg.fluid, grid=dataclasses.replace(cfg.fluid.grid, max_per_cell=k)))


@pytest.mark.parametrize("max_per_cell", [SK.MAX_K + 1, 96, 128])
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_cuda_build_refuses_more_slots_than_the_kernels_take(max_per_cell,
                                                             device):
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems.fluid import make_fluid
    sc = create_scenario("SIMPLE_FLUID", seed=0, device="cpu")
    cfg = with_max_per_cell(sc.cfg, max_per_cell)
    with pytest.raises(ValueError, match=(
            rf"fluid\.grid\.max_per_cell = {max_per_cell} gives "
            rf"{max_per_cell} slots a cell; the CUDA SPH kernels take at "
            rf"most {SK.MAX_K}, the reference's cap")):
        make_fluid(sc.spec, cfg, device=device)


def test_kernels_take_64_slots_and_refuse_65():
    """The dispatch decisions the card would take, without a card: the
    kernels' shape check and make_fluid_system's slot check take K = 64,
    the reference's cap, and refuse K = 65."""
    import torch
    from lpe_tpu_torch.systems.fluid.sph import grid_slots
    assert SK.MAX_K == 64
    for what, F in (("migrate", 9), ("density", 4), ("force", 8),
                    ("coupling", 10)):
        assert SK._grid_shape(torch.zeros((4, F, 64, 3)), what, F) == \
            (4, 64, 3)
        with pytest.raises(ValueError, match=r"K must be in \[1, 64\]"):
            SK._grid_shape(torch.zeros((4, F, 65, 3)), what, F)
    for device in ("cuda", "cuda:0", "cpu"):
        assert grid_slots(64, 1000, device) == 64
        assert grid_slots(80, 50, device) == 50     # at most the particles
    assert grid_slots(65, 1000, "cpu") == 65
    with pytest.raises(ValueError, match="gives 65 slots a cell"):
        grid_slots(65, 1000, "cuda")


def crowd_scene(n_blob=40, universe=1.5, seed=5, crowd=CROWD, slots=48):
    """lpe_tpu's walled blob (test_torch_fluid_slice.blob_scene) with
    ``crowd`` more particles at rest inside one grid cell, at max_per_cell
    ``slots``."""
    from lpe_tpu.core.config import (FluidConfig, ScenarioSystemConfig,
                                     SharedSystemConfig)
    from lpe_tpu.core.constants import Phase
    from lpe_tpu.scene import SceneBuilder
    fc = FluidConfig()
    cfg = with_max_per_cell(ScenarioSystemConfig(
        shared=SharedSystemConfig(universe_size_m=universe), fluid=fc),
        slots)
    rng = np.random.default_rng(seed)
    b = SceneBuilder("crowd")
    b.add_wall(universe / 2, 0.05, universe / 2, 0.04)
    for _ in range(n_blob):
        b.add(pos=tuple(rng.uniform(universe * 0.3, universe * 0.7, 2)),
              vel=tuple(rng.uniform(-0.4, 0.4, 2)), mass=0.005,
              phase=int(Phase.LIQUID), radius=0.02)
    h = fc.grid.smoothing_length          # the cell size (factor 1)
    centre = np.array([11.5, 12.5]) * h
    for _ in range(crowd):
        b.add(pos=tuple(centre + rng.uniform(-0.4 * h, 0.4 * h, 2)),
              vel=(0.0, 0.0), mass=0.005, phase=int(Phase.LIQUID),
              radius=0.02)
    return b.finalize(cfg)


def _two_ticks_match_lpe_tpu(crowd, slots):
    """Two ticks of crowd_scene on the CPU against lpe_tpu's resident XLA
    path."""
    from lpe_tpu.systems.fluid import make_fluid as jmake
    from lpe_tpu_torch.systems.fluid import make_fluid
    sc = crowd_scene(crowd=crowd, slots=slots)
    spec, cfg, state = to_port(sc)
    pstep = make_fluid(spec, cfg, device="cpu")
    occ = pstep.grid_build(state)["occ"]
    assert occ.shape[1] == slots
    assert int(occ.sum(1).max()) == crowd
    jstep = jax.jit(jmake(sc.spec, xla_resident(sc.cfg)))
    s_j, s_p = sc.state, state
    for _ in range(2):
        s_j = jstep(s_j)
        s_p = pstep(s_p)
    assert_fluid_close(sc.spec, s_j, s_p, sc.state)


def test_cpu_builds_48_slots_and_matches_lpe_tpu():
    _two_ticks_match_lpe_tpu(CROWD, 48)


def test_cpu_builds_64_slots_and_matches_lpe_tpu():
    """60 particles in one cell at the reference's cap, max_per_cell 64:
    the size the card's kernels take since K <= 64."""
    _two_ticks_match_lpe_tpu(60, 64)
