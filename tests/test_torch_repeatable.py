"""The port's CPU path repeats its bits at any torch thread count, as
lpe_tpu's XLA scatters do: every float scatter-add goes through
``core.numerics.scatter_add``, which adds in index order whatever the
thread count (PyTorch's CPU ``index_put(accumulate=True)`` adds a large
input with atomics across threads, in the order the threads happen to
run).

Each case runs twice at 4 torch threads and once at one thread, and the
three results must be equal to the bit: the helper on 4M keys into 1,000
slots, a galaxy on the P3M branch (the CIC deposit), RANDOM_POLYGONS and
the rigid solvers on a dense contact set (their impulse scatter) and
frames of the dam (the renderer's deposits). Where the sizes are given,
they are the least that send each scatter down PyTorch's multithreaded
path (32,768 values or more): below it PyTorch adds serially, and the
parent's bare ``index_put`` repeated there too. The module sets the thread
count itself and restores it; it does not use the suite's one-thread
fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

THREADS = 4


@pytest.fixture(autouse=True, scope="module")
def four_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def same_bits(a, b):
    """Tensors, tuples of them, or the tensor fields of (nested)
    dataclasses, equal to the bit (NaN matches NaN of the same bits; +0
    and -0 differ)."""
    if isinstance(a, tuple):
        return all(same_bits(u, v) for u, v in zip(a, b))
    if isinstance(a, torch.Tensor):
        bits = lambda t: t.reshape(-1).view(torch.uint8) \
            if t.is_floating_point() else t
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            torch.equal(bits(a), bits(b)))
    return all(same_bits(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a)
               if isinstance(getattr(a, f.name), torch.Tensor)
               or dataclasses.is_dataclass(getattr(a, f.name)))


def runs(fn):
    """fn() twice at THREADS threads and once at one thread."""
    out = [fn(), fn()]
    torch.set_num_threads(1)
    try:
        out.append(fn())
    finally:
        torch.set_num_threads(THREADS)
    return out


def assert_repeats(fn):
    a, b, one = runs(fn)
    assert same_bits(a, b), "two runs at 4 threads differ"
    assert same_bits(a, one), "4 threads differ from one thread"


def test_scatter_add_4m_keys_into_1000_slots():
    from lpe_tpu_torch.core.numerics import scatter_add
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 1000, 4_000_000))
    vals = torch.from_numpy(rng.standard_normal(4_000_000)
                            .astype(np.float32))
    init = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    assert_repeats(lambda: scatter_add(init, idx, vals))
    # index order: the serial sum of each slot's values, one by one
    got = scatter_add(init, idx[:20_000], vals[:20_000])
    want = init.numpy().copy()
    for i, v in zip(idx[:20_000].numpy(), vals[:20_000].numpy()):
        want[i] = np.float32(want[i] + v)
    assert np.array_equal(got.numpy(), want)


def test_p3m_galaxy_repeats():
    """10,000 bodies: the CIC deposit's 40,000 adds take PyTorch's
    multithreaded path (it adds serially below 32,768)."""
    from lpe_tpu_torch.scenarios.bench_scenes import build_galaxy
    from lpe_tpu_torch.systems import build_run_fn
    sc = build_galaxy(10_000, seed=0, device="cpu")
    cfg = sc.cfg.replace(barnes_hut=dataclasses.replace(
        sc.cfg.barnes_hut, direct_sum_max_bodies=1))
    run = build_run_fn(sc.spec, cfg, ticks=1, device="cpu")
    assert run.systems["barnes_hut"].pp is not None        # P3M
    assert_repeats(lambda: run(sc.state))


def test_random_polygons_repeats():
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems import build_run_fn
    sc = create_scenario("RANDOM_POLYGONS", seed=0, device="cpu")
    run = build_run_fn(sc.spec, sc.cfg, ticks=3, device="cpu")
    assert_repeats(lambda: run(sc.state))


def test_rigid_solvers_repeat():
    """The list pipeline's velocity and position solvers on 40,000 contact
    rows among 64 bodies: each impulse scatter adds 240,000 values, most of
    them onto bodies that other threads add to as well."""
    from lpe_tpu_torch.core.config import (ContactSolverConfig,
                                           PositionSolverConfig)
    from lpe_tpu_torch.systems.rigid.solver import (solve_position,
                                                    solve_velocity)
    rng = np.random.default_rng(1)
    S, R = 64, 40_000
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    pos = f32(rng.uniform(0, 4, (S, 2)))
    vel = f32(rng.uniform(-1, 1, (S, 2)))
    omega, angle = f32(rng.uniform(-1, 1, S)), f32(rng.uniform(-3, 3, S))
    inv_m, inv_i = f32(rng.uniform(0.5, 2, S)), f32(rng.uniform(1, 5, S))
    ia = torch.from_numpy(rng.integers(0, S, R))
    ib = (ia + torch.from_numpy(rng.integers(1, S, R))) % S
    n = f32(rng.standard_normal((R, 2)))
    pt = f32(rng.uniform(0, 4, (R, 2)))
    pen = f32(rng.uniform(0, 0.01, R))
    valid = torch.from_numpy(rng.uniform(size=R) < 0.9)
    lam = f32(rng.uniform(0, 0.1, (2, R)))

    def solve():
        v = solve_velocity(pos, vel, omega, inv_m, inv_i, ia, ib, n, pt,
                           valid, lam[0], lam[1],
                           ContactSolverConfig(iterations=2))
        p = solve_position(pos, angle, inv_m, inv_i, ia, ib, n, pt, pen,
                           valid, PositionSolverConfig(iterations=2))
        return torch.cat([v[0].reshape(-1), v[1], p[0].reshape(-1), p[1]])

    out = solve()
    assert torch.isfinite(out).all() and not torch.equal(out[:2 * S],
                                                         vel.reshape(-1))
    assert_repeats(solve)


@pytest.mark.parametrize("splat,n", [("exact", 2000), ("conv", 10_000)])
def test_dam_frame_repeats(splat, n):
    """A frame of the dam and its float fluid layer (the uint8 frame alone
    would hide a last-bit change): the exact splat's 441 adds a particle,
    the convolution splat's bilinear deposit, 4 a particle."""
    from lpe_tpu_torch.render.frame import _fluid_layer, make_renderer
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    sc = build_dam_break(n, device="cpu")
    draw = make_renderer(sc.spec, sc.cfg, width=300, height=300,
                         splat=splat)
    frame = draw(sc.state)
    assert frame.shape == (300, 300, 3) and int(frame[..., 2].max()) > 0
    mpp = sc.cfg.shared.meters_per_pixel * 2.0
    assert_repeats(lambda: (draw(sc.state), _fluid_layer(
        sc.state, sc.spec, 300, 300, mpp, splat)))
