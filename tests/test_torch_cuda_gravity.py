"""P3M's PP pass on the card: the CUDA kernel (``pm_gravity.pp_pass``,
``csrc/pp_pass.cu``) against its plain version. This file imports no jax,
so it runs where the kernel runs:

    python -m pytest --noconftest tests/test_torch_cuda_gravity.py -m cuda

Without a GPU the tests skip with a reason. The plain version is held
against lpe_tpu's PP correction in test_torch_gravity.py.

The gate: max |kernel - plain| <= 1e-5 x max |plain| over all bodies. The
kernel adds up to (2m+1)^2 K float32 terms a body in one sequence, where
the plain pass adds each cell offset's K terms as a tree; the same bodies
read exactly 0 (those past their cell's K, and those with no pair inside
rc)."""
import numpy as np
import pytest
import torch

from lpe_tpu_torch.ops import pm_gravity as PM

UNI = 1e10
GALAXY_N = 1_000_000
TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda", 0)


def _uniform(n, seed):
    """n bodies uniform in the universe, a tenth of them outside it, and
    their PP correction sized for n (m = 1 up to ~349k bodies, m = 2
    above)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.05 * UNI, 1.05 * UNI, (n, 2)).astype(np.float32)
    mass = rng.uniform(1e18, 1e20, n).astype(np.float32)
    return PM.make_pp_correction(UNI, 1024, 1e6, 8.0, 16, n_bodies=n), \
        pos, mass


def _clump(m):
    """test_torch_gravity.py's overflowing 500-body clump."""
    rc = 8.0 * UNI / 1024
    rng = np.random.default_rng(3)
    pos = (np.full((500, 2), 0.5 * UNI) +
           rng.normal(0, 0.05 * rc, (500, 2))).astype(np.float32)
    sizing = (None, 8) if m == 1 else (30 * 128 * 128, 64)
    pp = PM.make_pp_correction(UNI, 1024, 1e6, 8.0, sizing[1],
                               n_bodies=sizing[0])
    return pp, pos, np.ones((500,), np.float32)


@pytest.fixture(scope="module")
def galaxy():
    """build_galaxy(1M)'s PP correction (K = 46, m = 2), its positions and
    the masses the step gives the mesh and PP (sources, heavy ones out),
    and the arguments that build the correction."""
    dev = _card()
    from lpe_tpu_torch.scenarios.bench_scenes import build_galaxy
    from lpe_tpu_torch.systems.barnes_hut import make_barnes_hut
    sc = build_galaxy(GALAXY_N, device=dev)
    step = make_barnes_hut(sc.spec, sc.cfg, device=dev)
    b = sc.state.bodies
    src, _ = step.masks(b)
    heavy = src & (b.mass >= sc.cfg.barnes_hut.heavy_threshold)
    mm = torch.where(src & ~heavy, b.mass, torch.zeros_like(b.mass))
    bh, sh = sc.cfg.barnes_hut, sc.cfg.shared
    args = (sh.universe_size_m, bh.pm_grid, sh.gravitational_softener,
            bh.p3m_cutoff_cells, bh.p3m_max_per_cell)
    return step.pp, b.pos, mm, dict(args=args, n_bodies=sc.spec.capacity)


def _inputs(case, galaxy_fixture=None):
    dev = _card()
    if case == "galaxy":
        pp, pos, mm, _ = galaxy_fixture
        return pp, pos, mm
    kind, m = case.split("_m")
    pp, pos, mass = (_uniform(200_000 if m == "1" else GALAXY_N, int(m))
                     if kind == "uniform" else _clump(int(m)))
    assert pp.subdivision == int(m)
    return pp, torch.from_numpy(pos).to(dev), torch.from_numpy(mass).to(dev)


def _hold(got, want, what):
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert scale > 0, what
    assert err <= TOL * scale, f"{what}: max |kernel - plain| {err:.3e} " \
        f"over max |plain| {scale:.3e}"
    zero_k = got.abs().sum(1) == 0
    zero_p = want.abs().sum(1) == 0
    assert torch.equal(zero_k, zero_p), f"{what}: bodies read 0 differently"
    return err / scale


CASES = ["uniform_m1", "uniform_m2", "clump_m1", "clump_m2", "galaxy"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_pp_pass_matches_plain(case, request):
    """The kernel against its plain version, at m = 1 and m = 2 on a
    uniform scene (a tenth of it outside the universe) and on the
    overflowing clump, and on build_galaxy at 1M bodies; two launches give
    equal bits; a pass is one launch and no plain call."""
    g = request.getfixturevalue("galaxy") if case == "galaxy" else None
    pp, pos, mm = _inputs(case, g)
    PM.reset_counters()
    got = pp(pos, mm)
    again = pp(pos, mm)
    torch.cuda.synchronize()
    assert (PM.pp_pass.launches, PM.pp_pass.plain_calls) == (2, 0)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = PM.pp_pass.plain(pos, mm, pp.grid)
    _hold(got, want, case)
    if case.startswith("clump"):
        assert pp.overflow_fraction(pos) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform_m1", "galaxy"])
def test_pp_pass_split_over_devices_gives_one_devices_bits(case, request):
    """The kernel's strips over two and three devices on one card (each
    its own copy of the layout, the results back to the lead) give the
    single device's bits; each pass counts one launch."""
    dev = _card()
    g = request.getfixturevalue("galaxy") if case == "galaxy" else None
    pp, pos, mm = _inputs(case, g)
    if case == "galaxy":
        build = g[3]
        make = lambda devices: PM.make_pp_correction(
            *build["args"], n_bodies=build["n_bodies"], devices=devices)
    else:
        make = lambda devices: PM.make_pp_correction(
            UNI, 1024, 1e6, 8.0, 16, n_bodies=200_000, devices=devices)
    want = pp(pos, mm)
    for D in (2, 3):
        split = make([dev] * D)
        assert split.grid.devices == (dev,) * D
        PM.reset_counters()
        got = split(pos, mm)
        torch.cuda.synchronize()
        assert (PM.pp_pass.launches, PM.pp_pass.plain_calls) == (1, 0)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
