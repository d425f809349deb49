"""Seeded small-grid inputs for the SPH sub-step kernels, and the tests
that hold each CUDA kernel against its plain PyTorch version on the card.
This file imports no jax, so it runs where the kernels run:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Without a GPU the CUDA tests skip with a reason. The plain versions are
held against the JAX package's Pallas kernels in test_torch_sph_kernels.py
and test_torch_split_kernels.py, on these same inputs."""
import dataclasses

import numpy as np
import pytest
import torch

from lpe_tpu_torch.core.config import FluidConfig
from lpe_tpu_torch.ops import sph_kernels as SK

NY = NX = 8
K, NT, TX = 16, 1, 128
W = NT * TX
ROWS = NY + 2
FC = FluidConfig()
H = FC.grid.smoothing_length
CELL = H
EPS = FC.grid.grid_epsilon
GMIN = -2
SUB_DT = 1.0 / 120 / FC.num_sub_steps
HALF_DT = 0.5 * SUB_DT
LIM = 0.45 * CELL
MIG = dict(nx=NX, half_dt=HALF_DT, sub_dt=SUB_DT, lim=LIM, cell=CELL,
           eps=EPS, gmin=GMIN)
SWEEP = dict(h=H, poly6=4.0 / (np.pi * H ** 8),
             spiky=-30.0 / (np.pi * H ** 5), visc_lap=40.0 / (np.pi * H ** 5),
             viscosity=FC.viscosity,
             min_d2=FC.numerical.min_distance_threshold,
             min_rho=FC.numerical.min_density_threshold,
             stiffness=FC.stiffness, rest_density=FC.rest_density)
# the multi-block grid of _crowded_st: 3 tiles of 32 columns, the last of
# 20; migrate's bands of 3 rows (apron rows included) 3 + 3 + 3 + 2, the
# force pass's one interior row a block, the sweep's bands of 4 interior
# rows 4 + 4 + 1, density's of 3 (3 + 3 + 3; widened by 5 empty rows, 3 +
# 3 + 3 + 3 + 2); crowds on tile and band edges
CROWD_ROWS, CROWD_COLS, CROWD_NX = 11, 84, 80
CROWDS = ((4, 32), (3, 63), (8, 31), (5, 64))
V = 4                                   # vertex ring of the test rigids
WP = SK.rig_width(V)


def _make_st(seed=0):
    """A seeded ST stack: dense blobs (5-9 per cell), some particles stored
    2-3 cells away from their position (the >1-cell walk), and one cell
    whose 3x3 neighbourhood sends it more than K candidates."""
    rng = np.random.default_rng(seed)
    st = np.zeros((ROWS, 9, K, W), np.float32)
    nxt = {}
    pid = [0]

    def put(r, c, x, y, vx=0.0, vy=0.0, ax=0.0, ay=0.0):
        s = nxt.get((r, c), 0)
        if s >= K:
            return
        nxt[(r, c)] = s + 1
        pid[0] += 1
        st[r + 1, :, s, c + 1] = (x, y, vx, vy, ax, ay, 0.005, pid[0], 1.0)

    for r in range(2, 7):
        for c in range(2, 7):
            for _ in range(int(rng.integers(5, 10))):
                x = (c - 2 + rng.uniform(0.02, 0.98)) * CELL
                y = (r - 2 + rng.uniform(0.02, 0.98)) * CELL
                put(r, c, x, y, *rng.uniform(-0.6, 0.6, 2),
                    *rng.uniform(-80.0, 80.0, 2))
    # crowd: cell (4, 4) full, its neighbours push 8 more candidates in
    tx_, ty_ = 2.5 * CELL, 2.5 * CELL
    for _ in range(K):
        put(4, 4, tx_ + rng.uniform(-0.4, 0.4) * CELL,
            ty_ + rng.uniform(-0.4, 0.4) * CELL)
    for (r, c) in ((3, 4), (5, 4), (4, 3), (4, 5), (3, 3), (5, 5), (3, 5),
                   (5, 3)):
        put(r, c, tx_ + rng.uniform(-0.3, 0.3) * CELL,
            ty_ + rng.uniform(-0.3, 0.3) * CELL)
    # multi-cell moves: stored far from the cell of their position
    put(1, 1, 5.5 * CELL, 4.5 * CELL)        # 3 rows, 4 cols away
    put(7, 7, 0.5 * CELL, 0.5 * CELL)
    put(6, 1, 0.3 * CELL, 3.5 * CELL, vx=2.0)
    return st


def _crowded_st(K, seed=1, full=False):
    """A seeded ST stack of CROWD_ROWS x CROWD_COLS over several blocks of
    the staged kernels (32-column tiles and bands of rows; the last tile
    and band short), columns past nx + 1 empty: cells of 1-6 particles, some
    stored a cell away from their position; at target cells on tile and
    band edges, crowds of more than K candidates fed across those edges;
    with ``full``, a 3x3 block of full cells around a tile and band
    corner."""
    rng = np.random.default_rng(seed)
    st = np.zeros((CROWD_ROWS, 9, K, CROWD_COLS), np.float32)
    nxt = {}
    pid = [0]

    def put(r, c, u, v, vel=(0.0, 0.0), acc=(0.0, 0.0), at=None):
        """A particle stored in padded cell (r, c) at the point (u, v) of
        padded cell ``at`` (default: its own)."""
        s = nxt.get((r, c), 0)
        if s >= K:
            return
        nxt[(r, c)] = s + 1
        pid[0] += 1
        ar, ac = at or (r, c)
        st[r, :, s, c] = ((ac - 3 + u) * CELL, (ar - 3 + v) * CELL, *vel,
                          *acc, 0.005, pid[0], 1.0)

    if full:
        for r in (4, 5, 6):
            for c in (31, 32, 33):
                for _ in range(K):
                    put(r, c, *rng.uniform(0.02, 0.98, 2))
    for r, c in CROWDS:
        for _ in range(K):
            put(r, c, *rng.uniform(0.1, 0.9, 2))
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                for _ in range(2):
                    put(r + dr, c + dc, *rng.uniform(0.1, 0.9, 2), at=(r, c))
    put(4, 31, 0.5, 0.5, at=(6, 34))          # 2 rows, 3 columns away
    put(7, 65, 0.5, 0.5, at=(9, 61))
    for r in range(1, CROWD_ROWS - 1):
        for c in range(1, CROWD_NX + 1):
            if rng.uniform() < 0.35:
                for _ in range(int(rng.integers(1, 7))):
                    put(r, c, *rng.uniform(-0.3, 1.3, 2),
                        vel=rng.uniform(-0.6, 0.6, 2),
                        acc=rng.uniform(-80.0, 80.0, 2))
    return st


def _rig_row(px, py, vx, vy, om, mass, inertia, rad, circle, verts):
    """One candidate parameter row (sph_kernels RW_* layout)."""
    if circle:
        mnx, mny, mxx, mxy = px - rad, py - rad, px + rad, py + rad
        wv = np.zeros((V, 2))
    else:
        wv = np.asarray(verts, np.float64) + (px, py)
        wv = np.concatenate([wv, np.repeat(wv[:1], V - len(wv), 0)])
        mnx, mny = wv.min(0)
        mxx, mxy = wv.max(0)
    row = np.zeros(WP, np.float32)
    row[:13] = (px, py, vx, vy, om, mass, inertia, rad, float(circle),
                mnx, mny, mxx, mxy)
    row[13:13 + 2 * V] = wv.reshape(-1)
    return row


def _rigids(at=(0.0, 0.0)):
    """Small rigids over the particle blob: a square, a triangle and a
    circle (the rasterized slots) and one long wall (the big table); all
    moved by ``at``."""
    ox, oy = at
    sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * 0.03
    tri = np.array([[0.0, -0.035], [0.03, 0.02], [-0.03, 0.02]])
    small = [_rig_row(0.13 + ox, 0.13 + oy, 0.1, -0.2, 0.8, 2.0, 1e-3, 0.04,
                      False, sq),
             _rig_row(0.21 + ox, 0.10 + oy, 0.0, 0.1, -1.2, 0.05, 5e-4,
                      0.035, False, tri),
             _rig_row(0.09 + ox, 0.22 + oy, -0.1, 0.0, 0.3, 1.0, 1e-3, 0.03,
                      True, None)]
    wall = _rig_row(0.15 + ox, 0.23 + oy, 0.0, 0.0, 0.0, 1e30, 0.0, 0.15,
                    False, np.array([[-0.15, -0.02], [0.15, -0.02],
                                     [0.15, 0.02], [-0.15, 0.02]]))
    return np.stack(small), wall[None]


def _raster(small, S=8, slack=CELL, rows=ROWS, cols=W, used=NX + 2):
    """fld [rows, S, Wp, cols] and its (row, slot, column) -> rigid map:
    the rigids whose slack-widened AABB covers a cell of the first ``used``
    columns, in table order."""
    fld = np.zeros((rows, S, WP, cols), np.float32)
    body = np.full((rows, S, cols), -1)
    for r in range(rows):
        y0, y1 = (r - 3) * CELL - slack, (r - 2) * CELL + slack
        for c in range(used):
            x0, x1 = (c - 3) * CELL - slack, (c - 2) * CELL + slack
            s = 0
            for j, row in enumerate(small):
                if row[9] <= x1 and row[11] >= x0 and row[10] <= y1 \
                        and row[12] >= y0:
                    fld[r, s, :, c] = row
                    body[r, s, c] = j
                    s += 1
    return fld, body


def _cn():
    fc, psv, isv = FC, FC.position_solver, FC.impulse_solver
    return dict(
        min_safe_distance=psv.min_safe_distance,
        safety_margin=psv.safety_margin, relax_factor=psv.relax_factor,
        max_correction=psv.max_correction,
        min_position_change=psv.min_position_change,
        boundary_offset=fc.grid.boundary_offset,
        min_penetration=isv.min_penetration,
        max_safe_velocity_sq=isv.max_safe_velocity_sq,
        rest_density=fc.rest_density,
        depth_transition_rate=isv.depth_transition_rate,
        depth_scale=isv.depth_scale,
        depth_estimate_scale=isv.depth_estimate_scale,
        gravity=fc.gravity, max_force=isv.max_force,
        pressure_force_ratio=isv.pressure_force_ratio,
        min_rel_velocity=isv.min_rel_velocity, viscosity=fc.viscosity,
        viscosity_scale=isv.viscosity_scale, sub_dt=SUB_DT,
        viscous_force_ratio=isv.viscous_force_ratio,
        buoyancy_strength=isv.buoyancy_strength, max_torque=isv.max_torque,
        angular_damping_threshold=isv.angular_damping_threshold,
        angular_damping_factor=isv.angular_damping_factor,
        fluid_force_scale=isv.fluid_force_scale,
        fluid_force_max=isv.fluid_force_max,
        any_circle=True, any_poly=True)


def assert_st_close(a, b):
    """ST stacks: planes within atol 1e-5, except the acceleration planes,
    which carry forces of order 1e4 on the dense test blobs and are held
    to 1e-6 of their largest value (a few float32 ulps of the
    back-reaction sum)."""
    a, b = np.asarray(a), np.asarray(b)
    acc = [SK.ST_AX, SK.ST_AY]
    rest = [f for f in range(9) if f not in acc]
    np.testing.assert_allclose(a[:, rest], b[:, rest], rtol=0, atol=1e-5)
    scale = np.abs(b[:, acc]).max()
    np.testing.assert_allclose(a[:, acc], b[:, acc], rtol=0,
                               atol=max(1e-5, 1e-6 * scale))


def assert_sweep_close(a, b, occ):
    """(rho, fx, fy) on the occupied slots: rho to rtol 1e-5, forces
    elementwise to rtol 1e-5 plus 1e-6 of the force scale (the stiff EOS
    turns ULP-level rho reassociation into force noise,
    tests/test_sph.py:248-254)."""
    (rho_a, fx_a, fy_a), (rho_b, fx_b, fy_b) = \
        [[np.asarray(v) for v in t] for t in (a, b)]
    np.testing.assert_allclose(rho_a[occ], rho_b[occ], rtol=1e-5)
    fscale = np.abs(np.stack([fx_b, fy_b])[:, occ]).max()
    for u, v in ((fx_a, fx_b), (fy_a, fy_b)):
        np.testing.assert_allclose(u[occ], v[occ], rtol=1e-5,
                                   atol=1e-6 * fscale)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    SK.reset_counters()
    t = torch.from_numpy(_make_st()).cuda()
    m9 = SK.migrate(t, **MIG)
    torch.testing.assert_close(m9, SK.migrate_plain(t, **MIG), rtol=0,
                               atol=0)
    occ = (m9[1:-1, SK.M9_OCC] > 0).cpu().numpy()
    sw = SK.pair_sweep(m9, **SWEEP)
    assert_sweep_close([v.cpu() for v in sw],
                       [v.cpu() for v in SK.pair_sweep_plain(m9, **SWEEP)],
                       occ)
    small, wall = _rigids()
    fld, _ = _raster(small)
    big = np.concatenate([wall, np.zeros((1, WP), np.float32)])
    cpl = (m9[:, SK.M9_OCC].sum(1) > 0).to(torch.int32).contiguous()
    cn = dict(_cn(), V=V, half_dt=HALF_DT, stiffness=FC.stiffness)
    args = [cpl, torch.from_numpy(fld).cuda(), torch.from_numpy(big).cuda(),
            m9, *sw]
    out_k = [v.cpu() for v in SK.coupling9(*args, cn=cn)]
    out_p = [v.cpu() for v in SK.coupling9_plain(*args, cn=cn)]
    assert_st_close(out_k[0], out_p[0])
    for u, v in zip(out_k[1:], out_p[1:]):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-5)
    assert {op.name: op.launches for op in SK.OPS} == dict(
        migrate=1, pair_sweep=1, coupling9=1, density=0, force=0, coupling=0,
        migrate_h=0, density_h=0, force_h=0)


@pytest.mark.cuda
def test_cuda_split_kernels_match_plain():
    """density, force and coupling against their plain versions on the
    card, and density + EOS + force against the pair sweep (the same
    function by another route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    t = torch.from_numpy(_make_st()).cuda()
    m9 = SK.migrate(t, **MIG)
    x, y, vx, vy, m, occ, hx, hy, _ = m9.unbind(1)
    inner = (occ[1:-1] > 0).cpu().numpy()
    SK.reset_counters()
    dkw = dict(h=H, poly6=SWEEP["poly6"])
    fkw = {k: SWEEP[k] for k in ("h", "spiky", "visc_lap", "viscosity",
                                 "min_d2", "min_rho")}
    d4 = torch.stack([x, y, m, occ], 1)
    rho = SK.density(d4, **dkw)
    rho_p = pad(rho)
    pres = torch.clamp(FC.stiffness * (rho_p - FC.rest_density), min=0.0)
    d8 = torch.stack([x, y, vx, vy, m, rho_p, pres, occ], 1)
    fx, fy = SK.force(d8, **fkw)
    got = [v.cpu() for v in (rho, fx, fy)]
    plain = [SK.density_plain(d4, **dkw).cpu()] + \
        [v.cpu() for v in SK.force_plain(d8, **fkw)]
    assert_sweep_close(got, plain, inner)
    assert_sweep_close(got, [v.cpu() for v in SK.pair_sweep(m9, **SWEEP)],
                       inner)
    small, wall = _rigids()
    fld, _ = _raster(small)
    big = np.concatenate([wall, np.zeros((1, WP), np.float32)])
    cpl = (occ.sum(1) > 0).to(torch.int32).contiguous()
    cn = dict(_cn(), V=V, half_dt=HALF_DT, stiffness=FC.stiffness)
    ax, ay = pad(fx), pad(fy)
    d10 = torch.stack([x, y, hx + HALF_DT * ax, hy + HALF_DT * ay, rho_p,
                       pres, m, occ, ax, ay], 1)
    args = [cpl, torch.from_numpy(fld).cuda(), torch.from_numpy(big).cuda(),
            d10]
    out_k = [v.cpu() for v in SK.coupling(*args, cn=cn)]
    out_p = [v.cpu() for v in SK.coupling_plain(*args, cn=cn)]
    a_scale = float(torch.stack(out_p[4:6]).abs().max())
    for f, (u, v) in enumerate(zip(out_k, out_p)):
        atol = max(1e-5, 1e-6 * a_scale) if f in (4, 5) else 1e-5
        torch.testing.assert_close(u, v, rtol=0, atol=atol)
    assert float(out_p[6].abs().max()) > 1e-3
    assert {op.name: op.launches for op in SK.OPS} == dict(
        migrate=0, pair_sweep=1, coupling9=0, density=1, force=1, coupling=1,
        migrate_h=0, density_h=0, force_h=0)
    with pytest.raises(ValueError, match="expected"):
        SK.density(d8, **dkw)


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("rows, cols", [
    (ROWS, W),      # two whole bands of 4 rows; four 32-column tiles
    (9, 45),        # a short last band (7 = 4 + 3 rows) and a short tile
    (5, 20),        # fewer interior rows than a band; one short tile
])
def test_cuda_sweep_and_coupling9_equal_their_twins(rows, cols):
    """The pair sweep against density + EOS + force, and coupling9 against
    coupling on the same sub-step, to the bit: each pair of kernels shares
    its arithmetic and its summation order. With NaN in x, y, vx, vy and m
    of every empty slot, rho, fx, fy, PL and bigp keep their bits. The
    seeded grid is cut to ``rows`` x ``cols`` (its last row emptied as the
    apron)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    st = np.ascontiguousarray(_make_st()[:rows, ..., :cols])
    st[-1] = 0.0
    m9 = SK.migrate(torch.from_numpy(st).cuda(), **MIG)
    x, y, vx, vy, m, occ, hx, hy, pid = m9.unbind(1)
    sw = SK.pair_sweep(m9, **SWEEP)
    rho_p = pad(SK.density(torch.stack([x, y, m, occ], 1), h=H,
                           poly6=SWEEP["poly6"]))
    pres = torch.clamp(FC.stiffness * (rho_p - FC.rest_density), min=0.0)
    fkw = {k: SWEEP[k] for k in ("h", "spiky", "visc_lap", "viscosity",
                                 "min_d2", "min_rho")}
    fx, fy = SK.force(torch.stack([x, y, vx, vy, m, rho_p, pres, occ], 1),
                      **fkw)
    for u, v in zip(sw, (rho_p[1:-1], fx, fy)):
        assert torch.equal(_bits(u), _bits(v))
    assert float(sw[1].abs().max()) > 0

    small, wall = _rigids()
    fld = torch.from_numpy(np.ascontiguousarray(
        _raster(small)[0][:rows, ..., :cols])).cuda()
    big = torch.from_numpy(np.concatenate(
        [wall, np.zeros((1, WP), np.float32)])).cuda()
    cn = dict(_cn(), V=V, half_dt=HALF_DT, stiffness=FC.stiffness)
    ax, ay = pad(sw[1]), pad(sw[2])
    rp = pad(sw[0])
    pe = torch.clamp(FC.stiffness * (rp - FC.rest_density), min=0.0)
    d10 = torch.stack([x, y, hx + HALF_DT * ax, hy + HALF_DT * ay, rp, pe, m,
                       occ, ax, ay], 1)
    coupled = (occ.sum(1) > 0).to(torch.int32).contiguous()
    m9n = m9.clone()
    empty = m9n[:, SK.M9_OCC] <= 0
    for f in (SK.M9_X, SK.M9_Y, SK.M9_VX, SK.M9_VY, SK.M9_M):
        m9n[:, f][empty] = float("nan")
    swn = SK.pair_sweep(m9n, **SWEEP)
    for u, v in zip(swn, sw):
        assert torch.equal(_bits(u), _bits(v))
    for cpl in (coupled, torch.zeros_like(coupled)):   # coupled; copied
        st, pl, bigp = SK.coupling9(cpl, fld, big, m9, *sw, cn=cn)
        out = SK.coupling(cpl, fld, big, d10, cn=cn)
        ref = torch.stack([*out[:6], m, pid, occ], 1)
        ref[0] = ref[-1] = 0.0
        for u, v in ((st, ref), (pl, out[6]), (bigp, out[7])):
            assert torch.equal(_bits(u), _bits(v))
        st_n, pl_n, bigp_n = SK.coupling9(cpl, fld, big, m9n, *swn, cn=cn)
        assert torch.equal(_bits(pl_n), _bits(pl))
        assert torch.equal(_bits(bigp_n), _bits(bigp))
        keep = torch.ones_like(st, dtype=torch.bool)
        for f in (SK.ST_X, SK.ST_Y, SK.ST_M):    # copied through as NaN
            keep[1:-1, f] = ~empty[1:-1]
        assert torch.equal(_bits(st_n[keep]), _bits(st[keep]))
        assert bool(torch.isnan(st_n[~keep]).all())
    assert float(pl.abs().max()) == 0.0          # copied-through cells


@pytest.mark.cuda
@pytest.mark.parametrize("K, full", [(16, False), (32, True), (64, True)])
def test_cuda_migrate_and_force_on_a_multi_block_grid(K, full):
    """migrate and the force pass on a grid of several tiles and bands of
    their blocks, with crowds on tile and band edges fed across them: M9
    equals migrate_plain to the bit and particles were dropped; the force
    pass is within the sweep tolerances of force_plain and equals the pair
    sweep's forces to the bit on the M9 whose rho and p come from the
    density kernel and the EOS. NaN in every plane but the occupancy of the
    empty slots of ST and D8 changes no output bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    st = torch.from_numpy(_crowded_st(K, full=full)).cuda()
    mig = dict(MIG, nx=CROWD_NX)
    SK.reset_counters()
    m9 = SK.migrate(st, **mig)
    assert torch.equal(_bits(m9), _bits(SK.migrate_plain(st, **mig)))
    assert int((st[:, SK.ST_OCC] > 0).sum()) > int((m9[:, SK.M9_OCC] > 0)
                                                   .sum())    # drops
    x, y, vx, vy, m, occ, hx, hy, pid = m9.unbind(1)
    rho_p = pad(SK.density(torch.stack([x, y, m, occ], 1), h=H,
                           poly6=SWEEP["poly6"]))
    pres = torch.clamp(FC.stiffness * (rho_p - FC.rest_density), min=0.0)
    fkw = {k: SWEEP[k] for k in ("h", "spiky", "visc_lap", "viscosity",
                                 "min_d2", "min_rho")}
    d8 = torch.stack([x, y, vx, vy, m, rho_p, pres, occ], 1)
    fx, fy = SK.force(d8, **fkw)
    inner = (occ[1:-1] > 0).cpu().numpy()
    assert_sweep_close([v.cpu() for v in (rho_p[1:-1], fx, fy)],
                       [rho_p[1:-1].cpu()] +
                       [v.cpu() for v in SK.force_plain(d8, **fkw)], inner)
    sw = SK.pair_sweep(m9, **SWEEP)
    for u, v in zip(sw, (rho_p[1:-1], fx, fy)):
        assert torch.equal(_bits(u), _bits(v))
    assert float(fx.abs().max()) > 0
    assert {op.name: op.launches for op in SK.OPS} == dict(
        migrate=1, pair_sweep=1, coupling9=0, density=1, force=1, coupling=0,
        migrate_h=0, density_h=0, force_h=0)

    assert torch.equal(_bits(SK.migrate(_plant_nan(st, SK.ST_OCC), **mig)),
                       _bits(m9))
    for u, v in zip(SK.force(_plant_nan(d8, SK.D8_OCC), **fkw), (fx, fy)):
        assert torch.equal(_bits(u), _bits(v))


def _pad_slots(stack, K2):
    """A row stack [rows, F, K, W] with empty slots appended up to K2."""
    return torch.nn.functional.pad(stack, (0, 0, 0, K2 - stack.shape[2]))


def _plant_nan(stack, occ_plane):
    """``stack`` with NaN in every plane but the occupancy of its empty
    slots."""
    out = stack.clone()
    empty = out[:, occ_plane] <= 0
    for f in range(stack.shape[1]):
        if f != occ_plane:
            out[:, f][empty] = float("nan")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("K, full, empty_tiles", [
    (16, False, False), (16, False, True), (32, True, False),
    (32, True, True), (64, True, False), (64, True, True)])
def test_cuda_staged_density_on_a_multi_block_grid(K, full, empty_tiles):
    """The staged density kernel on the crowded grid of several tiles and
    bands (with ``empty_tiles``, widened by empty tiles and bands, whose
    blocks write zeros and leave): within rtol 1e-5 of density_plain on the
    occupied slots (pairs reassociate against the plain version's order),
    0 in every empty slot, and to the bit the pair sweep's rho (one loop,
    staged_row_density). NaN in x, y and m of D4's empty slots changes no
    output bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    st = torch.from_numpy(_crowded_st(K, full=full)).cuda()
    m9 = SK.migrate(st, **dict(MIG, nx=CROWD_NX))
    if empty_tiles:       # two more tiles of columns and 5 more rows
        m9 = torch.nn.functional.pad(m9, (0, 64, 0, 0, 0, 0, 0, 5))
    x, y, vx, vy, m, occ = m9.unbind(1)[:6]
    d4 = torch.stack([x, y, m, occ], 1)
    dkw = dict(h=H, poly6=SWEEP["poly6"])
    SK.reset_counters()
    rho = SK.density(d4, **dkw)
    assert SK.density.launches == 1
    inner = occ[1:-1] > 0
    np.testing.assert_allclose(rho.cpu().numpy()[inner.cpu().numpy()],
                               SK.density_plain(d4, **dkw).cpu().numpy()
                               [inner.cpu().numpy()], rtol=1e-5)
    assert float(rho[~inner].abs().max()) == 0.0
    assert torch.equal(_bits(rho), _bits(SK.pair_sweep(m9, **SWEEP)[0]))
    assert torch.equal(_bits(SK.density(_plant_nan(d4, 3), **dkw)),
                       _bits(rho))


@pytest.mark.cuda
@pytest.mark.parametrize("K2", [32, 64])
def test_cuda_couplings_at_k32(K2):
    """The coupling kernel at K2 = 32 and 64 (the seeded sub-step with its
    slots padded from 16; a block of 1024 threads, at 64 two slots a
    thread) against coupling_plain,
    on cells that copy through (cpl 0, as on the dam's main path) and on
    cells that couple with the test rigids (cpl 1 on occupied cells), at
    the tolerances of test_cuda_split_kernels_match_plain: its outputs
    equal the K = 16 kernel's in slots 0-15 and PL and bigp to the bit
    (empty slots sum as +0), and coupling9 on the same sub-step gives the
    same bits. NaN in every plane but the occupancy of D10's empty slots
    reaches only those slots' own outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    m9 = SK.migrate(torch.from_numpy(_make_st()).cuda(), **MIG)
    small, wall = _rigids()
    fld = torch.from_numpy(_raster(small)[0]).cuda()
    big = torch.from_numpy(np.concatenate(
        [wall, np.zeros((1, WP), np.float32)])).cuda()
    cn = dict(_cn(), V=V, half_dt=HALF_DT, stiffness=FC.stiffness)
    coupled = (m9[:, SK.M9_OCC].sum(1) > 0).to(torch.int32).contiguous()
    d10s = {}
    for k2 in (K, K2):
        x, y, vx, vy, m, occ, hx, hy, pid = _pad_slots(m9, k2).unbind(1)
        sw = SK.pair_sweep(_pad_slots(m9, k2), **SWEEP)
        rho, fx, fy = (pad(v) for v in sw)
        pe = torch.clamp(FC.stiffness * (rho - FC.rest_density), min=0.0)
        d10s[k2] = torch.stack([x, y, hx + HALF_DT * fx, hy + HALF_DT * fy,
                                rho, pe, m, occ, fx, fy], 1)
    d10 = d10s[K2]
    empty = d10[:, SK.D10_OCC] <= 0
    for cpl in (torch.zeros_like(coupled), coupled):
        args = [cpl, fld, big, d10]
        out = SK.coupling(*args, cn=cn)
        ref = SK.coupling_plain(*args, cn=cn)
        a_scale = float(torch.stack(ref[4:6]).abs().max())
        for f, (u, v) in enumerate(zip(out, ref)):
            atol = max(1e-5, 1e-6 * a_scale) if f in (4, 5) else 1e-5
            torch.testing.assert_close(u.cpu(), v.cpu(), rtol=0, atol=atol)
        out16 = SK.coupling(cpl, fld, big, d10s[K], cn=cn)
        st9, pl9, bigp9 = SK.coupling9(cpl, fld, big, _pad_slots(m9, K2),
                                       *sw, cn=cn)
        ref9 = torch.stack([*out[:6], m, pid, occ], 1)
        ref9[0] = ref9[-1] = 0.0
        for u, v in ((st9, ref9), (pl9, out[6]), (bigp9, out[7])):
            assert torch.equal(_bits(u), _bits(v))
        for u, v in zip(out[:6], out16[:6]):
            assert torch.equal(_bits(u[:, :K]), _bits(v))
        for u, v in zip(out[6:], out16[6:]):
            assert torch.equal(_bits(u), _bits(v))
        out_n = SK.coupling(cpl, fld, big, _plant_nan(d10, SK.D10_OCC),
                            cn=cn)
        for u, v in zip(out_n[:6], out[:6]):
            live = ~empty
            live[0] = live[-1] = True                 # apron rows: zero
            assert torch.equal(_bits(u[live]), _bits(v[live]))
            assert bool(torch.isnan(u[~live]).all())
        for u, v in zip(out_n[6:], out[6:]):
            assert torch.equal(_bits(u), _bits(v))
    assert float(out[6].abs().max()) > 1e-3          # the coupled cells


@pytest.mark.cuda
@pytest.mark.parametrize("K2", [32, 64])
def test_cuda_couplings_on_full_cells_at_k32(K2):
    """coupling and coupling9 at K2 = 32 and 64 on the crowded multi-block
    grid with its 3x3 block of full cells (K2 live slots each, so every
    warp of those blocks lists live particles, at 64 for both of its
    thread's slots), the test rigids moved over that block and cpl 1 on
    every occupied cell: coupling within the tolerances of
    test_cuda_split_kernels_match_plain of coupling_plain, particles of
    slots 16 and up (at 64: 32 and up) moved by the rigids, and coupling9
    on the same sub-step with the same bits. NaN in every plane but the
    occupancy of D10's empty slots reaches only those slots' own
    outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    st = torch.from_numpy(_crowded_st(K2, full=True)).cuda()
    m9 = SK.migrate(st, **dict(MIG, nx=CROWD_NX))
    x, y, vx, vy, m, occ, hx, hy, pid = m9.unbind(1)
    assert int((occ[:, K:] > 0).sum()) >= 9 * (K2 - K)   # full cells kept
    # the full block spans x in [28, 31) and y in [1, 4) cells
    small, wall = _rigids(at=(29.5 * CELL - 0.15, 2.5 * CELL - 0.16))
    fld = torch.from_numpy(_raster(small, rows=CROWD_ROWS, cols=CROWD_COLS,
                                   used=CROWD_NX + 2)[0]).cuda()
    big = torch.from_numpy(np.concatenate(
        [wall, np.zeros((1, WP), np.float32)])).cuda()
    cn = dict(_cn(), V=V, half_dt=HALF_DT, stiffness=FC.stiffness)
    sw = SK.pair_sweep(m9, **SWEEP)
    rho, fx, fy = (pad(v) for v in sw)
    pe = torch.clamp(FC.stiffness * (rho - FC.rest_density), min=0.0)
    d10 = torch.stack([x, y, hx + HALF_DT * fx, hy + HALF_DT * fy, rho, pe,
                       m, occ, fx, fy], 1)
    cpl = (occ.sum(1) > 0).to(torch.int32).contiguous()
    SK.reset_counters()
    out = SK.coupling(cpl, fld, big, d10, cn=cn)
    ref = SK.coupling_plain(cpl, fld, big, d10, cn=cn)
    a_scale = float(torch.stack(ref[4:6]).abs().max())
    for f, (u, v) in enumerate(zip(out, ref)):
        atol = max(1e-5, 1e-6 * a_scale) if f in (4, 5) else 1e-5
        torch.testing.assert_close(u.cpu(), v.cpu(), rtol=0, atol=atol)
    live = occ > 0
    moved = ((out[0] != x) | (out[1] != y)) & live
    assert int(moved[:, K2 // 2:].sum()) > 0          # the upper slots
    assert float(out[6].abs().max()) > 1e-3 and float(out[7].abs().max()) > 0
    st9, pl9, bigp9 = SK.coupling9(cpl, fld, big, m9, *sw, cn=cn)
    ref9 = torch.stack([*out[:6], m, pid, occ], 1)
    ref9[0] = ref9[-1] = 0.0
    for u, v in ((st9, ref9), (pl9, out[6]), (bigp9, out[7])):
        assert torch.equal(_bits(u), _bits(v))
    assert {op.name: op.launches for op in SK.OPS} == dict(
        migrate=0, pair_sweep=0, coupling9=1, density=0, force=0, coupling=1,
        migrate_h=0, density_h=0, force_h=0)
    out_n = SK.coupling(cpl, fld, big, _plant_nan(d10, SK.D10_OCC), cn=cn)
    keep = live.clone()
    keep[0] = keep[-1] = True                         # apron rows: zero
    for u, v in zip(out_n[:6], out[:6]):
        assert torch.equal(_bits(u[keep]), _bits(v[keep]))
        assert bool(torch.isnan(u[~keep]).all())
    for u, v in zip(out_n[6:], out[6:]):
        assert torch.equal(_bits(u), _bits(v))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 40])
def test_cuda_mixed_h_kernels_match_plain(k):
    """migrate_h, density_h and force_h against their plain versions on
    the crowded multi-block grid with a seeded h of 0.04 or 0.05 a
    particle: migrate_h to the bit (planes 0-8 the bits of migrate), the
    pair passes at assert_sweep_close's limits; at K = 16 and at K = 40
    (the 64-bit tier)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    st = _crowded_st(k)
    rng = np.random.default_rng(7)
    h = np.where(rng.random(st[:, 0].shape) < 0.5, 0.04, 0.05) \
        .astype(np.float32) * (st[:, SK.ST_OCC] > 0)
    t = torch.from_numpy(np.concatenate([st, h[:, None]], 1)).cuda()
    mig = dict(MIG, nx=CROWD_NX)
    SK.reset_counters()
    m10 = SK.migrate_h(t, **mig)
    assert torch.equal(_bits(m10), _bits(SK.migrate_h_plain(t, **mig)))
    assert torch.equal(_bits(m10[:, :9]),
                       _bits(SK.migrate(t[:, :9].contiguous(), **mig)))
    x, y, vx, vy, m, occ, _, _, _, hp = m10.unbind(1)
    inner = (occ[1:-1] > 0).cpu().numpy()
    d5 = torch.stack([x, y, m, occ, hp], 1)
    rho = SK.density_h(d5)
    rho_p = torch.nn.functional.pad(rho, (0, 0, 0, 0, 1, 1))
    pres = torch.clamp(FC.stiffness * (rho_p - FC.rest_density), min=0.0)
    d9 = torch.stack([x, y, vx, vy, m, rho_p, pres, occ, hp], 1)
    fkw = {k_: SWEEP[k_] for k_ in ("viscosity", "min_d2", "min_rho")}
    got = [rho.cpu(), *(v.cpu() for v in SK.force_h(d9, **fkw))]
    plain = [SK.density_h_plain(d5).cpu(),
             *(v.cpu() for v in SK.force_h_plain(d9, **fkw))]
    assert_sweep_close(got, plain, inner)
    assert {op.name: op.launches for op in SK.OPS if op.launches} == dict(
        migrate_h=1, migrate=1, density_h=1, force_h=1)


def test_fluid_config_tree_is_the_one_tested():
    # the constants above come from the port's default FluidConfig
    assert dataclasses.asdict(FC)["grid"]["max_per_cell"] == K
