"""The plain PyTorch versions of the three SPH sub-step kernels
(lpe_tpu_torch/ops/sph_kernels.py) against the JAX package's Pallas
kernels, each called once in interpret mode on a small grid (8x8 interior
cells, one 128-column tile, K=16). Inputs are made with numpy from a seed
and handed to both; the CUDA kernels themselves are held against the
plain versions on the card (the ``cuda`` test below and chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpe_tpu_torch.ops import sph_kernels as SK
from test_torch_cuda_kernels import (CELL, EPS, FC, GMIN, H, HALF_DT, K,
                                     LIM, MIG, NT, NX, NY, ROWS, SUB_DT,
                                     SWEEP, TX, V, W, WP, _cn, _make_st,
                                     _raster, _rigids, assert_st_close,
                                     assert_sweep_close)

def _tile_bounds(occ):
    return jnp.asarray(occ.sum(axis=1).reshape(occ.shape[0], NT, TX)
                       .max(-1).astype(np.int32))


def _run_migrate(st):
    from lpe_tpu.ops.pallas_sph import make_migrate_ring
    mig = make_migrate_ring(NY, NX, NT, K, HALF_DT, SUB_DT, LIM, CELL, EPS,
                            GMIN, interpret=True)
    return np.array(mig(_tile_bounds(st[:, 8]), jnp.asarray(st)))


@pytest.fixture(scope="module")
def migrated():
    st = _make_st()
    return st, _run_migrate(st)


def test_migrate_plain_matches_pallas(migrated):
    st, m9_j = migrated
    m9_t = SK.migrate_plain(torch.from_numpy(st), **MIG).numpy()
    assert m9_t.shape == m9_j.shape
    occ_t, occ_j = m9_t[:, SK.M9_OCC], m9_j[:, SK.M9_OCC]
    # the crowded cell really dropped candidates, and nothing else did
    n_in, n_out = int(st[:, 8].sum()), int(occ_j.sum())
    assert n_out < n_in
    np.testing.assert_array_equal(occ_t, occ_j)
    np.testing.assert_array_equal(m9_t[:, SK.M9_ID], m9_j[:, SK.M9_ID])
    np.testing.assert_allclose(m9_t, m9_j, rtol=0, atol=1e-6)
    # the far-stored particles walked exactly one cell toward home
    ids = m9_t[:, SK.M9_ID]
    where = {int(round(ids[r, k, c])): (r - 1, c - 1)
             for r, k, c in zip(*np.nonzero(occ_t > 0))}
    far = int(st[2, 7, 0, 2])                # stored at interior (1, 1)
    assert where[far] == (2, 2)


def _sweep_both(m9):
    from lpe_tpu.ops.pallas_sph import make_pair_sweep
    sw = make_pair_sweep(NY, NT, K, H, SWEEP["poly6"], SWEEP["spiky"],
                         SWEEP["visc_lap"], FC.viscosity, SWEEP["min_d2"],
                         SWEEP["min_rho"], FC.stiffness, FC.rest_density,
                         interpret=True, F=9)
    out_j = [np.array(a) for a in
             sw(_tile_bounds(m9[:, SK.M9_OCC]), jnp.asarray(m9))]
    out_t = [a.numpy() for a in
             SK.pair_sweep_plain(torch.from_numpy(m9), **SWEEP)]
    return out_j, out_t


@pytest.fixture(scope="module")
def swept(migrated):
    _, m9 = migrated
    return m9, _sweep_both(m9)


def test_pair_sweep_plain_matches_pallas(swept):
    m9, ((rho_j, fx_j, fy_j), (rho_t, fx_t, fy_t)) = swept
    occ = m9[1:-1, SK.M9_OCC] > 0
    assert occ.sum() > 100 and (rho_j[occ] > 0).all()
    assert_sweep_close((rho_t, fx_t, fy_t), (rho_j, fx_j, fy_j), occ)
    assert (fx_t[~occ] == 0).all() and (fy_t[~occ] == 0).all()


@pytest.mark.parametrize("nbig", [0, 1])
def test_coupling9_plain_matches_pallas(swept, nbig):
    from lpe_tpu.ops.pallas_sph import make_coupling9
    m9, ((rho, fx, fy), _) = swept
    S = 8
    small, wall = _rigids()
    fld, body = _raster(small, S)
    big = np.concatenate([wall[:nbig], np.zeros((1, WP), np.float32)])
    cn = _cn()
    occ_rows = m9[:, SK.M9_OCC].sum(axis=(1, 2))
    cpl = (occ_rows > 0).astype(np.int32)[:, None]        # [rows, NT]
    cpl[5] = 0                     # a copied-through tile with particles
    assert occ_rows[5] > 0
    c9 = make_coupling9(NY, NT, K, S, nbig, V, cn, HALF_DT, FC.stiffness,
                        interpret=True)
    args = [jnp.asarray(a) for a in (cpl, fld, big, m9, rho, fx, fy)]
    out_j = [np.asarray(a) for a in c9(*args)]
    cpl_cols = np.repeat(cpl, TX, axis=1)[:, :W]
    st_t, pl_t, bigp_t = [a.numpy() for a in SK.coupling9_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in
          (cpl_cols, fld, big, m9, rho, fx, fy)],
        cn=dict(cn, V=V, half_dt=HALF_DT, stiffness=FC.stiffness))]
    st_j, pl_j = out_j[0], out_j[1]
    assert st_t.shape == st_j.shape
    assert (st_j[0] == 0).all() and (st_j[-1] == 0).all()
    assert_st_close(st_t, st_j)
    # the coupling really moved particles, except on the copied-through row
    kicked = m9[:, SK.M9_X].copy()
    assert np.abs(st_j[:, SK.ST_X] - kicked).max() > 1e-4
    row5 = m9[5, SK.M9_X]
    np.testing.assert_array_equal(st_t[5, SK.ST_X],
                                  np.where(row5 < 0, 0.001, row5))
    # per-rigid force partials: reduce (row, slot, column) onto rigids
    def per_rigid(pl):
        p3 = pl.reshape(ROWS, S, 3, W)
        return np.stack([np.where((body == j)[:, :, None, :], p3, 0)
                         .sum((0, 1, 3)) for j in range(len(small))])
    fr_t, fr_j = per_rigid(pl_t), per_rigid(pl_j)
    assert np.abs(fr_j).max() > 1e-3
    np.testing.assert_allclose(fr_t, fr_j, rtol=0, atol=1e-5)
    if nbig:
        bj = out_j[2].sum((0, 1)).reshape(nbig, 3)
        bt = bigp_t.sum((0, 1)).reshape(nbig, 3)
        assert np.abs(bj).max() > 1e-3
        np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-5)
    else:
        assert bigp_t.shape[-1] == 0


def test_cpu_tensors_take_the_plain_versions(migrated):
    st, _ = migrated
    SK.reset_counters()
    t = torch.from_numpy(st)
    m9 = SK.migrate(t, **MIG)
    rho, fx, fy = SK.pair_sweep(m9, **SWEEP)
    assert SK.migrate.plain_calls == 1 and SK.pair_sweep.plain_calls == 1
    assert all(op.launches == 0 for op in SK.OPS)
    torch.testing.assert_close(m9, SK.migrate_plain(t, **MIG), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="no kernel for device"):
        SK.migrate(t.to("meta"), **MIG)
    SK.reset_counters()
    assert all(op.plain_calls == 0 for op in SK.OPS)
