"""The argument checks of the CUDA wrappers of the four staged kernels
(the pair sweep, migrate and the split density and force passes), on the
CPU: they raise before anything is built or launched, and on a CPU tensor
each op runs its plain version. The launches themselves (tiles of 32
columns up to K = 32 and of 16 from 33 to 64, bands of rows, shared
memory) are sized in csrc/pair_sweep.cu, migrate.cu, density.cu and
force.cu, each of which holds its shared memory at K = 32 and at K = 64
under the 227 KB a Hopper block may have at compile time.
test_torch_cuda_kernels.py and chip_smoke.py hold the kernels against
their plain versions and their twins to the bit on the card, on grids
whose last band and last tile are short."""
import numpy as np
import pytest
import torch

from lpe_tpu_torch.ops import sph_kernels as SK

SWEEP = dict(h=0.1, poly6=4.0 / (np.pi * 0.1 ** 8),
             spiky=-30.0 / (np.pi * 0.1 ** 5),
             visc_lap=40.0 / (np.pi * 0.1 ** 5), viscosity=0.1, min_d2=1e-8,
             min_rho=1e-3, stiffness=100.0, rest_density=1000.0)
FORCE = {k: SWEEP[k] for k in ("h", "spiky", "visc_lap", "viscosity",
                               "min_d2", "min_rho")}
MIG = dict(nx=4, half_dt=1e-3, sub_dt=2e-3, lim=0.045, cell=0.1, eps=1e-6,
           gmin=-2)
STAGED = {   # op -> (its CUDA wrapper, planes of its input, its constants)
    "pair_sweep": (SK._pair_sweep_cuda, 9, SWEEP),
    "migrate": (SK._migrate_cuda, 9, MIG),
    "density": (SK._density_cuda, 4, dict(h=0.1, poly6=SWEEP["poly6"])),
    "force": (SK._force_cuda, 8, FORCE),
}


@pytest.mark.parametrize("name", STAGED)
@pytest.mark.parametrize("rows, dplanes, K, match", [
    (6, 0, 0, "K must be in"),                 # no slot
    (6, 0, 65, "K must be in"),                # more slots than two words
    (3, 0, 16, "rows >= 4"),                   # fewer than two interior rows
    (6, -1, 16, r"expected \[rows, {planes}"),  # a stack of the wrong planes
])
def test_staged_wrapper_refuses_a_grid_it_cannot_launch(name, rows, dplanes,
                                                        K, match):
    wrapper, planes, kw = STAGED[name]
    with pytest.raises(ValueError, match=match.format(planes=planes)):
        wrapper(torch.zeros((rows, planes + dplanes, K, 8)), **kw)


def test_migrate_wrapper_refuses_nx_that_does_not_fit():
    # nx interior columns need nx + 2 padded columns
    with pytest.raises(ValueError, match="does not fit"):
        SK._migrate_cuda(torch.zeros((6, 9, 16, 8)), **dict(MIG, nx=7))


@pytest.mark.parametrize("name", STAGED)
@pytest.mark.parametrize("K", [1, 16, 32, 64])
def test_staged_wrapper_takes_no_cpu_tensor(name, K):
    # a grid it can launch gets past the shape checks; on a CPU tensor the
    # wrapper raises rather than run the plain version
    wrapper, planes, kw = STAGED[name]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wrapper(torch.zeros((6, planes, K, 8)), **kw)


def _one_particle(planes, occ, m, row=2, col=3):
    """A [6, planes, 16, 8] grid holding one particle in slot 0 of (row,
    col), inside its cell, at rest."""
    g = torch.zeros((6, planes, 16, 8))
    g[row, 0, 0, col] = (col - 2.5) * 0.1       # x, y in the cell (gmin -2)
    g[row, 1, 0, col] = (row - 2.5) * 0.1
    g[row, occ, 0, col] = 1.0
    g[row, m, 0, col] = 0.02
    return g


@pytest.mark.parametrize("name", STAGED)
def test_staged_op_on_the_cpu_runs_its_plain_version(name):
    SK.reset_counters()
    op = getattr(SK, name)
    _, planes, kw = STAGED[name]
    if name == "pair_sweep":
        rho, fx, fy = op(_one_particle(9, SK.M9_OCC, SK.M9_M), **kw)
        assert rho.shape == fx.shape == fy.shape == (4, 16, 8)
        assert float(rho[1, 0, 3]) > 0.0 and float(rho.abs().sum()) == \
            float(rho[1, 0, 3])
    elif name == "migrate":
        st = _one_particle(9, SK.ST_OCC, SK.ST_M)
        m9 = op(st, **kw)
        assert m9.shape == st.shape
        # a particle at rest stays in its cell, in slot 0
        assert float(m9[:, SK.M9_OCC].sum()) == float(m9[2, SK.M9_OCC, 0, 3])
        assert float(m9[2, SK.M9_M, 0, 3]) == float(st[2, SK.ST_M, 0, 3])
    elif name == "density":
        rho = op(_one_particle(4, 3, 2), **kw)       # D4: x, y, m, occ
        # a lone particle's density is its self term
        assert rho.shape == (4, 16, 8)
        assert float(rho[1, 0, 3]) > 0.0 and float(rho.abs().sum()) == \
            float(rho[1, 0, 3])
    else:
        d8 = _one_particle(8, SK.D8_OCC, SK.D8_M)
        d8[2, SK.D8_RHO, 0, 3] = 1.0
        fx, fy = op(d8, **kw)
        # a lone particle feels no pair force
        assert fx.shape == fy.shape == (4, 16, 8)
        assert float(fx.abs().sum()) == float(fy.abs().sum()) == 0.0
    assert op.plain_calls == 1 and op.launches == 0
