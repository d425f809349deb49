"""The plain PyTorch versions of the split SPH kernels (density, force,
coupling in lpe_tpu_torch/ops/sph_kernels.py) against the JAX package's
Pallas kernels make_density, make_force and make_coupling, each called once
in interpret mode on the small grid of test_torch_cuda_kernels.py (8x8
interior cells, one 128-column tile, K=16, the slot count the seeded blobs
and their crowded cell are made for). Inputs are made with numpy from a
seed and handed to both; the CUDA kernels themselves are held against the
plain versions on the card (test_torch_cuda_kernels.py and chip_smoke.py).

Layouts: the JAX kernels take plane-first stacks [F, rows, K, cols] and
per-(row, tile) tables; the port's ops take row stacks [rows, F, K, cols],
no occupancy table and a per-column coupling mask."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpe_tpu_torch.ops import sph_kernels as SK
from test_torch_cuda_kernels import (FC, H, HALF_DT, K, MIG, NT, NY, ROWS,
                                     SWEEP, TX, V, W, WP, _cn, _make_st,
                                     _raster, _rigids, assert_sweep_close)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DENSITY = dict(h=H, poly6=SWEEP["poly6"])
FORCE = {k: SWEEP[k] for k in ("h", "spiky", "visc_lap", "viscosity",
                               "min_d2", "min_rho")}


def _tile_bounds(occ):
    return jnp.asarray(occ.sum(axis=1).reshape(occ.shape[0], NT, TX)
                       .max(-1).astype(np.int32))


def _planes_first(stack):
    """The port's row stack [rows, F, K, W] as the JAX kernels' [F, rows,
    K, W]."""
    return jnp.asarray(np.ascontiguousarray(np.swapaxes(stack, 0, 1)))


def _pad_rows(v):
    return np.pad(v, ((1, 1), (0, 0), (0, 0)))


def _eos(rho):
    return np.maximum(np.float32(FC.stiffness)
                      * (rho - np.float32(FC.rest_density)),
                      np.float32(0.0)).astype(np.float32)


@pytest.fixture(scope="module")
def m9():
    """The migrated test blobs: dense cells, one of them full."""
    return SK.migrate_plain(torch.from_numpy(_make_st()), **MIG).numpy()


@pytest.fixture(scope="module")
def density(m9):
    from lpe_tpu.ops.pallas_sph import make_density
    d4 = np.ascontiguousarray(
        m9[:, [SK.M9_X, SK.M9_Y, SK.M9_M, SK.M9_OCC]])
    dens = make_density(NY, NT, K, H, SWEEP["poly6"], interpret=True)
    rho_j = np.asarray(dens(_tile_bounds(m9[:, SK.M9_OCC]),
                            _planes_first(d4)))
    rho_t = SK.density_plain(torch.from_numpy(d4), **DENSITY).numpy()
    return d4, rho_j, rho_t


def test_density_plain_matches_pallas(m9, density):
    _, rho_j, rho_t = density
    occ = m9[1:-1, SK.M9_OCC] > 0
    assert rho_t.shape == rho_j.shape == (NY, K, W)
    assert occ.sum() > 100 and (rho_j[occ] > 0).all()
    np.testing.assert_allclose(rho_t[occ], rho_j[occ], rtol=1e-5)
    assert (rho_t[~occ] == 0).all()


@pytest.fixture(scope="module")
def forces(m9, density):
    """D8 from the Pallas density (so that both force versions read the
    same rho and p), and both force results."""
    from lpe_tpu.ops.pallas_sph import make_force
    _, rho_j, _ = density
    rho = _pad_rows(rho_j)
    d8 = np.ascontiguousarray(np.stack(
        [m9[:, SK.M9_X], m9[:, SK.M9_Y], m9[:, SK.M9_VX], m9[:, SK.M9_VY],
         m9[:, SK.M9_M], rho, _eos(rho), m9[:, SK.M9_OCC]], axis=1))
    frc = make_force(NY, NT, K, H, SWEEP["spiky"], SWEEP["visc_lap"],
                     FC.viscosity, SWEEP["min_d2"], SWEEP["min_rho"],
                     interpret=True)
    out_j = [np.asarray(a) for a in
             frc(_tile_bounds(m9[:, SK.M9_OCC]), _planes_first(d8))]
    out_t = [a.numpy() for a in
             SK.force_plain(torch.from_numpy(d8), **FORCE)]
    return d8, out_j, out_t


def test_force_plain_matches_pallas(m9, forces):
    d8, (fx_j, fy_j), (fx_t, fy_t) = forces
    occ = m9[1:-1, SK.M9_OCC] > 0
    rho = d8[1:-1, SK.D8_RHO]
    assert np.abs(fx_j[occ]).max() > 1.0
    # forces elementwise to rtol 1e-5 plus 1e-6 of the force scale
    assert_sweep_close((rho, fx_t, fy_t), (rho, fx_j, fy_j), occ)
    assert (fx_t[~occ] == 0).all() and (fy_t[~occ] == 0).all()


def test_force_gates_on_min_rho_of_both_sides(forces):
    """min_rho above a particle's density drops every pair it is in, as a
    centre and as a neighbour: raising it to the median changes the forces
    of denser particles too."""
    d8, _, (fx_t, _) = forces
    occ = d8[1:-1, SK.D8_OCC] > 0
    rho = d8[1:-1, SK.D8_RHO]
    cut = float(np.median(rho[occ]))
    fx_c = SK.force_plain(torch.from_numpy(d8),
                          **dict(FORCE, min_rho=cut))[0].numpy()
    assert (fx_c[occ & (rho < cut)] == 0).all()
    dense = occ & (rho >= cut)
    assert np.abs(fx_c[dense] - fx_t[dense]).max() > 1e-3 * np.abs(
        fx_t[dense]).max()


def test_split_pair_equals_pair_sweep(m9, density):
    """density + EOS + force is the pair sweep by another route: on the
    CPU the plain versions share their pair arithmetic, so the results are
    equal to the bit."""
    d4, _, _ = density
    t = torch.from_numpy(m9)
    rho_s, fx_s, fy_s = SK.pair_sweep_plain(t, **SWEEP)
    rho = SK.density_plain(torch.from_numpy(d4), **DENSITY)
    rho_p = torch.nn.functional.pad(rho, (0, 0, 0, 0, 1, 1))
    pres = torch.clamp(FC.stiffness * (rho_p - FC.rest_density), min=0.0)
    x, y, vx, vy, m, occ = t.unbind(1)[:6]
    fx, fy = SK.force_plain(torch.stack([x, y, vx, vy, m, rho_p, pres, occ],
                                        dim=1), **FORCE)
    for a, b in ((rho, rho_s), (fx, fx_s), (fy, fy_s)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("nbig", [0, 1])
def test_coupling_plain_matches_pallas(m9, forces, nbig):
    """S-slot candidates (a square, a triangle, a circle) and, with nbig,
    a wall in the big-solid table; one row with particles is masked out
    and must be copied through."""
    from lpe_tpu.ops.pallas_sph import make_coupling
    d8, (fx, fy), _ = forces
    S = 8
    small, wall = _rigids()
    fld, body = _raster(small, S)
    big = np.concatenate([wall[:nbig], np.zeros((1, WP), np.float32)])
    cn = _cn()
    ax, ay = _pad_rows(fx), _pad_rows(fy)
    vx1 = m9[:, SK.M9_HX] + np.float32(HALF_DT) * ax
    vy1 = m9[:, SK.M9_HY] + np.float32(HALF_DT) * ay
    d10 = np.ascontiguousarray(np.stack(
        [m9[:, SK.M9_X], m9[:, SK.M9_Y], vx1, vy1, d8[:, SK.D8_RHO],
         d8[:, SK.D8_P], m9[:, SK.M9_M], m9[:, SK.M9_OCC], ax, ay], axis=1))
    occ_rows = m9[:, SK.M9_OCC].sum(axis=(1, 2))
    cpl = (occ_rows > 0).astype(np.int32)[:, None]        # [rows, NT]
    cpl[5] = 0                     # a copied-through tile with particles
    assert occ_rows[5] > 0
    cp = make_coupling(NY, NT, K, S, nbig, V, cn, interpret=True)
    out_j = [np.asarray(a) for a in
             cp(jnp.asarray(cpl), jnp.asarray(fld), jnp.asarray(big),
                _planes_first(d10))]
    cpl_cols = np.repeat(cpl, TX, axis=1)[:, :W]
    out_t = [a.numpy() for a in SK.coupling_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in
          (cpl_cols, fld, big, d10)],
        cn=dict(cn, V=V, half_dt=HALF_DT, stiffness=FC.stiffness))]
    x0, y0 = d10[1:-1, SK.D10_X], d10[1:-1, SK.D10_Y]
    assert (x0 >= 0).all() and (y0 >= 0).all()   # the floor clamp is idle
    # x, y, vx, vy to atol 1e-5; the accelerations (forces of order 1e4 on
    # these blobs) to 1e-6 of their largest value
    for f in range(4):
        assert (out_t[f][0] == 0).all() and (out_t[f][-1] == 0).all()
        np.testing.assert_allclose(out_t[f][1:-1], out_j[f], rtol=0,
                                   atol=1e-5)
    a_scale = max(np.abs(out_j[4]).max(), np.abs(out_j[5]).max())
    for f in (4, 5):
        np.testing.assert_allclose(out_t[f][1:-1], out_j[f], rtol=0,
                                   atol=max(1e-5, 1e-6 * a_scale))
    # the coupling really moved particles, except on the copied-through row
    assert np.abs(out_j[0] - x0).max() > 1e-4
    np.testing.assert_array_equal(out_t[0][5], d10[5, SK.D10_X])
    np.testing.assert_array_equal(out_t[2][5], d10[5, SK.D10_VX])
    # per-rigid force partials: reduce (row, slot, column) onto rigids
    pl_t, pl_j = out_t[6], _pad_rows(out_j[6])

    def per_rigid(pl):
        p3 = pl.reshape(ROWS, S, 3, W)
        return np.stack([np.where((body == j)[:, :, None, :], p3, 0)
                         .sum((0, 1, 3)) for j in range(len(small))])
    fr_t, fr_j = per_rigid(pl_t), per_rigid(pl_j)
    assert (np.abs(fr_j).max(1) > 1e-3).all()    # polygons and the circle
    p_scale = np.abs(fr_j).max()
    np.testing.assert_allclose(fr_t, fr_j, rtol=0, atol=1e-5 + 1e-6 * p_scale)
    if nbig:
        bj = out_j[7].sum((0, 1)).reshape(nbig, 3)
        bt = out_t[7].sum((0, 1)).reshape(nbig, 3)
        assert np.abs(bj).max() > 1e-3
        np.testing.assert_allclose(bt, bj, rtol=0,
                                   atol=1e-5 + 1e-6 * np.abs(bj).max())
    else:
        assert out_t[7].shape[-1] == 0


def test_coupling_floor_clamp_reaches_every_slot(m9):
    """A position below 0 becomes the boundary offset in coupled and in
    copied-through cells alike."""
    S = 8
    fld = np.zeros((ROWS, S, WP, W), np.float32)
    big = np.zeros((1, WP), np.float32)
    d10 = np.zeros((ROWS, 10, K, W), np.float32)
    d10[:, SK.D10_OCC] = m9[:, SK.M9_OCC]
    d10[:, SK.D10_X] = -np.abs(m9[:, SK.M9_X])
    d10[:, SK.D10_Y] = m9[:, SK.M9_Y]
    cpl = np.zeros((ROWS, W), np.int32)
    cpl[4] = 1
    out = SK.coupling_plain(*[torch.from_numpy(a) for a in
                              (cpl, fld, big, d10)],
                            cn=dict(_cn(), V=V, half_dt=HALF_DT,
                                    stiffness=FC.stiffness))
    occ = m9[1:-1, SK.M9_OCC] > 0
    off = np.float32(FC.grid.boundary_offset)
    assert (out[0].numpy()[1:-1][occ] == off).all()
    np.testing.assert_array_equal(out[1].numpy()[1:-1][occ],
                                  m9[1:-1, SK.M9_Y][occ])


def test_cpu_tensors_take_the_plain_versions(density, forces):
    d4, _, _ = density
    d8, _, _ = forces
    SK.reset_counters()
    rho = SK.density(torch.from_numpy(d4), **DENSITY)
    fx, _ = SK.force(torch.from_numpy(d8), **FORCE)
    assert SK.density.plain_calls == 1 and SK.force.plain_calls == 1
    assert all(op.launches == 0 for op in SK.OPS)
    torch.testing.assert_close(
        rho, SK.density_plain(torch.from_numpy(d4), **DENSITY), rtol=0,
        atol=0)
    with pytest.raises(ValueError, match="no kernel for device"):
        SK.force(torch.from_numpy(d8).to("meta"), **FORCE)
    SK.reset_counters()
    assert all(op.plain_calls == 0 for op in SK.OPS)
