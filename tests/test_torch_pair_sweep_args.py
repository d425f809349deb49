"""The argument checks of the pair sweep's CUDA wrapper, on the CPU: they
raise before anything is built or launched. The launch itself (32-column
tiles, bands of 4 rows, shared memory) is sized in csrc/pair_sweep.cu,
which holds its shared memory at K = 32 under the 227 KB a Hopper block may
have at compile time. test_torch_cuda_kernels.py and chip_smoke.py hold the
kernel against density + EOS + force to the bit on the card, on grids
whose last band and last tile are short."""
import numpy as np
import pytest
import torch

from lpe_tpu_torch.ops import sph_kernels as SK

SWEEP = dict(h=0.1, poly6=4.0 / (np.pi * 0.1 ** 8),
             spiky=-30.0 / (np.pi * 0.1 ** 5),
             visc_lap=40.0 / (np.pi * 0.1 ** 5), viscosity=0.1, min_d2=1e-8,
             min_rho=1e-3, stiffness=100.0, rest_density=1000.0)


@pytest.mark.parametrize("shape, match", [
    ((6, 9, 0, 8), "K must be in"),       # no slot
    ((6, 9, 33, 8), "K must be in"),      # more slots than a 32-bit mask
    ((3, 9, 16, 8), "rows >= 4"),         # fewer than two interior rows
    ((6, 8, 16, 8), r"expected \[rows, 9"),  # a stack of the wrong planes
])
def test_pair_sweep_wrapper_refuses_a_grid_it_cannot_launch(shape, match):
    with pytest.raises(ValueError, match=match):
        SK._pair_sweep_cuda(torch.zeros(shape), **SWEEP)


@pytest.mark.parametrize("K", [1, 16, 32])
def test_pair_sweep_wrapper_takes_no_cpu_tensor(K):
    # a grid it can launch gets past the shape checks; on a CPU tensor the
    # wrapper raises rather than run the plain version
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        SK._pair_sweep_cuda(torch.zeros((6, 9, K, 8)), **SWEEP)


def test_pair_sweep_on_the_cpu_runs_its_plain_version():
    SK.reset_counters()
    m9 = torch.zeros((6, 9, 16, 8))
    m9[2, SK.M9_OCC, 0, 3] = 1.0
    m9[2, SK.M9_M, 0, 3] = 0.02
    rho, fx, fy = SK.pair_sweep(m9, **SWEEP)
    assert rho.shape == fx.shape == fy.shape == (4, 16, 8)
    assert SK.pair_sweep.plain_calls == 1 and SK.pair_sweep.launches == 0
    assert float(rho[1, 0, 3]) > 0.0 and float(rho.abs().sum()) == \
        float(rho[1, 0, 3])
