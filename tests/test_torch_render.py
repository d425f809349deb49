"""The port's renderer (lpe_tpu_torch/render/frame.py) against lpe_tpu's
jitted one on the same states, carried across with convert.state_from_numpy.

Tolerances:
- fluid alpha (before quantization): 1e-5 absolute against lpe_tpu's
  jitted ``_fluid_layer`` (XLA fuses the splat's products into FMAs; the
  port's 1e-6-2.5e-6 gaps are that rounding through the steep smoothstep);
- uint8 frames: within 1 level on every pixel, except that shape coverage
  and colors may differ on at most 0.1% of the pixels, where an inside
  test sits within float rounding of an edge (cos/sin/atan2 of the two
  libraries differ in the last bit);
- the box blur: 1e-6 of the image's largest value;
- the port's own painters against each other: to the bit.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from lpe_tpu.render import frame as JF
from lpe_tpu_torch.render import frame as TF
from test_torch_fluid_slice import to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ALPHA_ATOL = 1e-5
EDGE_PIXELS = 1e-3


def _frames(sc, W, **kw):
    """(lpe_tpu's frame, the port's frame, the port's spec and state)."""
    spec, cfg, st = to_port(sc)
    fj = np.asarray(JF.make_renderer(sc.spec, sc.cfg, width=W, height=W,
                                     **kw)(sc.state))
    ft = TF.make_renderer(spec, cfg, width=W, height=W, **kw)(st)
    assert ft.dtype == torch.uint8 and ft.shape == (W, W, 3)
    return fj, ft.numpy(), spec, st


def _assert_frames_agree(fj, ft):
    d = np.abs(fj.astype(np.int32) - ft.astype(np.int32)).max(-1)
    assert (d > 1).mean() <= EDGE_PIXELS, (d > 1).mean()


def test_box_blur_matches_lpe_tpu_on_the_border():
    """avg_pool2d without the padding in its count is lpe_tpu's 5x5
    reduce_window sum over the same sum of ones, border rows and columns
    (windows cut by the image edge) included."""
    rng = np.random.default_rng(0)
    img = (rng.random((37, 53)).astype(np.float32) ** 4) * 1e6
    ref = np.asarray(jax.jit(JF._box_blur5)(img))
    got = TF._box_blur5(torch.from_numpy(img)).numpy()
    scale = np.abs(ref).max()
    for part in (np.s_[:2], np.s_[-2:], np.s_[:, :2], np.s_[:, -2:],
                 np.s_[:, :]):
        assert np.abs(got[part] - ref[part]).max() <= 1e-6 * scale


@pytest.mark.parametrize("scene,conv", [("SIMPLE_FLUID", False),
                                        ("DAM_9000", True)])
def test_fluid_splat_matches_lpe_tpu(scene, conv):
    """SIMPLE_FLUID (1,000 particles) takes the exact splat, a dam of
    9,000 the bilinear deposit and convolution, in both packages."""
    from lpe_tpu.scenarios import create_scenario
    from lpe_tpu.scenarios.bench_scenes import build_dam_break
    sc = create_scenario(scene, seed=0) if scene == "SIMPLE_FLUID" else \
        build_dam_break(9000, seed=0)
    assert (sc.spec.n_liquid >= TF._SPLAT_CONV_MIN_NL) == conv
    W = 160
    fj, ft, spec, st = _frames(sc, W)
    mpp = sc.cfg.shared.meters_per_pixel * 600.0 / W
    aj = np.asarray(jax.jit(lambda s: JF._fluid_layer(
        s, sc.spec, W, W, mpp))(sc.state))
    at = TF._fluid_layer(st, spec, W, W, mpp).numpy()
    assert np.abs(aj - at).max() <= ALPHA_ATOL
    assert at.max() == 1.0 and (at > 0.5).mean() > 0.02
    _assert_frames_agree(fj, ft)


def test_windowed_raster_matches_loop():
    """The port's windowed priority rasterizer reproduces its painter's
    pass to the bit (coverage and winning color), as lpe_tpu's does
    (tests/test_render_io.py); both agree with lpe_tpu's painter."""
    from lpe_tpu.scenarios.bench_scenes import build_rigid_stacks
    sc = build_rigid_stacks(64, seed=3)
    spec, cfg, st = to_port(sc)
    mpp = sc.cfg.shared.meters_per_pixel
    WR = int(spec.solid_cell_size / (2.0 * mpp)) + 2
    cl, al = TF._shape_masks_loop(st, spec.solid_start, spec.n_solid,
                                  600, 600, mpp)
    cw, aw = TF._shape_masks_windowed(st, spec, spec.solid_start,
                                      spec.n_solid, 600, 600, mpp, WR)
    assert bool((al > 0).any()) and spec.solid_big_idx
    assert torch.equal(al, aw) and torch.equal(cl, cw)
    cj, aj = JF._shape_masks_loop(sc.state, spec.solid_start, spec.n_solid,
                                  600, 600, mpp)
    cj, aj = np.asarray(cj), np.asarray(aj)
    assert ((aj > 0) != (al.numpy() > 0)).mean() <= EDGE_PIXELS
    assert (cj != cl.numpy()).any(-1).mean() <= EDGE_PIXELS


def test_painter_chunks_equal_the_one_at_a_time_loop(monkeypatch):
    """The painter's pass tests a chunk of entities at a time; it equals
    the sequential loop (each entity painted over the full screen in index
    order) to the bit, whatever the chunk: the highlight reel's gas and
    solids, at chunks of 1, 3 and the default."""
    from lpe_tpu.scenarios.bench_scenes import build_highlight_reel
    sc = build_highlight_reel(600, 12, 20, seed=1)
    spec, cfg, st = to_port(sc)
    H = W = 120
    mpp = sc.cfg.shared.meters_per_pixel * 600.0 / W
    b = st.bodies
    xpix, ypix = TF._pixel_centers(H, W, torch.float32, "cpu")
    for idx0, count in ((spec.gas_start, spec.n_gas),
                        (spec.solid_start, spec.n_solid)):
        g = TF._shape_geom(b, idx0, count, mpp)
        color = torch.zeros(H, W, 3)
        alpha = torch.zeros(H, W)
        for i in range(count):
            inside = TF._inside(g[i:i + 1], xpix, ypix)[0]
            color = torch.where(inside[:, :, None],
                                b.color[idx0 + i].to(torch.float32), color)
            alpha = torch.where(inside, 1.0, alpha)
        assert bool(alpha.any())
        for per in (None, 1, 3):
            if per is not None:
                monkeypatch.setattr(TF, "_CHUNK_ELEMS",
                                    per * TF.MAX_POLY_VERTS * H * W)
            c, a = TF._shape_masks_loop(st, idx0, count, H, W, mpp)
            assert torch.equal(c, color) and torch.equal(a, alpha)


def _scheme_scene(builder_mod):
    """Circles whose centers share pixels (sleepers and wakers, hot and
    cold, with and without Temperature), one off-screen, and a wall. The
    40-degree one sharing a pixel sits on a truncation edge: 255 * 0.4
    rounds to 101.99999 in float32 as lpe_tpu's jitted frame computes it."""
    from lpe_tpu.core.config import ScenarioSystemConfig
    from lpe_tpu.core.constants import ShapeKind
    b = builder_mod.SceneBuilder("schemes")
    circle = int(ShapeKind.CIRCLE)
    for i, (x, y, temp, mass, sleep, asleep) in enumerate((
            (1.004, 1.004, 100.0, 2.0, True, True),
            (1.006, 1.002, 0.0, 1.0, True, False),    # same pixel as above
            (2.0, 2.0, None, 1.0, False, False),
            (2.001, 2.003, 40.0, 3.0, True, True),    # shares with a None
            (3.0, 3.0, 75.0, 1.0, False, False),
            (4.0, 4.5, None, 1.0, True, True),
            (9.0, 9.0, 50.0, 1.0, True, False))):     # off-screen
        b.add(pos=(x, y), radius=0.2 + 0.02 * i, temperature=temp,
              mass=mass, has_sleep=sleep, asleep=asleep, shape_kind=circle)
    b.add_wall(3.0, 5.8, 2.8, 0.1)
    return b, ScenarioSystemConfig()


@pytest.mark.parametrize("scheme", [JF.SCHEME_SLEEP, JF.SCHEME_TEMPERATURE])
def test_color_schemes_match_lpe_tpu(scheme):
    """Per-pixel aggregates -> per-entity fill colors (the int32
    scatter-max for SLEEP, the ordered float sums for TEMPERATURE):
    the same colors as lpe_tpu's, and frames that agree."""
    import lpe_tpu.scene as jscene
    b, cfg = _scheme_scene(jscene)
    sc = b.finalize(cfg)
    spec, tcfg, st = to_port(sc)
    W = 200
    mpp = sc.cfg.shared.meters_per_pixel * 600.0 / W
    cj = np.asarray(jax.jit(lambda s: JF._scheme_colors(
        s, sc.spec, W, W, mpp, scheme))(sc.state))
    ct = TF._scheme_colors(st, spec, W, W, mpp, scheme).numpy()
    np.testing.assert_array_equal(ct, cj)
    assert len({tuple(c) for c in ct}) >= 3
    fj, ft, _, _ = _frames(sc, W, color_scheme=scheme)
    _assert_frames_agree(fj, ft)


def test_sleep_scheme_on_random_polygons_matches_lpe_tpu():
    from lpe_tpu.scenarios import create_scenario
    sc = create_scenario("RANDOM_POLYGONS", seed=0)
    fj, ft, _, _ = _frames(sc, 200, color_scheme=JF.SCHEME_SLEEP)
    green = (ft[:, :, 1] == 200) & (ft[:, :, 0] == 50)
    red = (ft[:, :, 0] == 200) & (ft[:, :, 1] == 50)
    assert green.any() and red.any()
    _assert_frames_agree(fj, ft)


def test_velocity_and_arc_overlays_match_lpe_tpu():
    import lpe_tpu.scene as jscene
    from lpe_tpu.core.config import ScenarioSystemConfig
    from lpe_tpu.core.constants import ShapeKind
    b = jscene.SceneBuilder("dbg")
    for i, (vel, omega) in enumerate((((1.0, 0.0), 2.0), ((-0.5, 0.7), -1.5),
                                      ((0.0, 0.0), 0.01), ((0.3, -2.0), 4.0))):
        b.add(pos=(1.5 + 0.9 * i, 2.0 + 0.3 * i), vel=vel, omega=omega,
              radius=0.05, inertia=0.1, shape_kind=int(ShapeKind.CIRCLE))
    sc = b.finalize(ScenarioSystemConfig())
    fj, ft, _, _ = _frames(sc, 300, debug=True)
    cyan = (ft[:, :, 0] == 0) & (ft[:, :, 1] == 255) & (ft[:, :, 2] == 255)
    magenta = (ft[:, :, 0] == 255) & (ft[:, :, 1] == 0) & \
        (ft[:, :, 2] == 255)
    assert cyan.any() and magenta.any()
    _assert_frames_agree(fj, ft)


def _synthetic_contacts(sc, seed=0):
    """A state of ``sc`` whose two contact caches hold seeded rows: the
    list pipeline's [P, C] (some empty) and a grid cache of [4, 24, C]
    rows (lpe_tpu's scenes below 1024 solids carry a [1, 1, C] one)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    st = sc.state
    P, C = st.warm_normal.shape
    P = min(P, 64)
    size = sc.cfg.shared.universe_size_m
    ids = np.arange(sc.spec.solid_start, sc.spec.solid_start + sc.spec.n_solid)

    def pts(*shape):
        p = rng.uniform(0.05 * size, 0.95 * size, shape + (2,))
        p[rng.random(shape) < 0.2] = 1e30                   # empty rows
        return p.astype(np.float32)

    def unit(*shape):
        a = rng.uniform(0, 2 * np.pi, shape)
        return np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)

    def imp(*shape):
        v = rng.standard_normal(shape) * 4
        v[rng.random(shape) < 0.2] = 0.0
        return v.astype(np.float32)

    ia = rng.choice(ids, P).astype(np.int32)
    ia[rng.random(P) < 0.15] = -1
    kw = dict(warm_ia=ia, warm_ib=rng.choice(ids, P).astype(np.int32),
              warm_pt=pts(P, C), warm_n=unit(P), warm_normal=imp(P, C),
              warm_tangent=imp(P, C), rg_warm_pt=pts(4, 24, C),
              rg_warm_nrm=unit(4, 24), rg_warm_n=imp(4, 24, C),
              rg_warm_t=imp(4, 24, C))
    state = st.replace(**{k: jnp.asarray(v) for k, v in kw.items()})
    return SimpleNamespace(spec=sc.spec, cfg=sc.cfg, state=state)


def _assert_overlay_agrees(sc, W):
    """The debug frames of lpe_tpu and the port agree on the pixels that
    at most one contact-overlay sample writes; returns the count of
    pixels written once."""
    fj, ft, spec, st = _frames(sc, W, debug=True)
    mpp = sc.cfg.shared.meters_per_pixel * 600.0 / W
    idx, _, _ = TF._overlay_writes(st, W, W, mpp, torch.float32)
    writes = torch.bincount(idx, minlength=W * W + 1)[:W * W].view(W, W)
    once = (writes <= 1).numpy()
    yellow = (ft[:, :, 0] == 255) & (ft[:, :, 1] == 255) & (ft[:, :, 2] == 0)
    assert yellow.any()
    d = np.abs(fj.astype(np.int32) - ft.astype(np.int32)).max(-1)
    assert (d[once] > 1).mean() <= EDGE_PIXELS
    # a debug frame repeats its bits
    frame = TF.make_renderer(spec, to_port(sc)[1], width=W, height=W,
                             debug=True)
    assert torch.equal(frame(st), frame(st))
    return int((writes == 1).sum())


def test_contact_overlay_matches_lpe_tpu():
    """The contact overlay on live warm-cache rows: lpe_tpu ticks rigid
    stacks 150 ticks (its own test's state), the port renders the same
    state. lpe_tpu leaves the winner of a pixel that several samples
    write to its scatter's order, the port takes the last write in
    lpe_tpu's order; so the two are compared only on pixels that at most
    one sample writes."""
    from lpe_tpu.scenarios.bench_scenes import build_rigid_stacks
    from lpe_tpu.systems import build_run_fn
    sc = build_rigid_stacks(24, seed=1)
    state = build_run_fn(sc.spec, sc.cfg, ticks=150, donate=False)(sc.state)
    assert int((np.asarray(state.warm_pt)[..., 0] < 1e29).sum()) > 0
    sc = SimpleNamespace(spec=sc.spec, cfg=sc.cfg, state=state)
    assert _assert_overlay_agrees(sc, 300) > 100


def test_contact_overlay_on_both_caches_matches_lpe_tpu():
    """Both caches at once, seeded (the list pipeline's pair rows colored
    by their bodies, the grid pipeline's rows white), on RANDOM_POLYGONS;
    compared as above."""
    from lpe_tpu.scenarios import create_scenario
    sc = _synthetic_contacts(create_scenario("RANDOM_POLYGONS", seed=0))
    assert _assert_overlay_agrees(sc, 240) > 1000
