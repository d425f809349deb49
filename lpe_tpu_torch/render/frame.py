"""On-device frame rendering: RGB frames as functions of SimState.

The counterpart of ``lpe_tpu/render/frame.py``, which renders each frame as
one XLA program. Here a frame is a sequence of PyTorch ops on the state's
device producing a uint8 [H, W, 3] tensor there; the host sees the
finished frame only if it asks. The pipeline is lpe_tpu's (and through it
the reference's: fluid_renderer.cpp:330-556, solid_renderer.cpp:22-275,
gas_renderer.cpp:15-44):

- fluid: unnormalized poly6 splat with smoothing radius 10 px, two 5x5
  boundary-normalized box blurs, max-normalize on the device, smoothstep
  threshold 0.19 +/- 0.02, base color RGB(40, 130, 240);
- solids: filled convex polygons / circles with per-entity color and the
  DEFAULT / SLEEP / TEMPERATURE color schemes, later entities painting
  over earlier ones;
- gas: the same shapes at alpha 180/255;
- debug: velocity lines, angular arcs and the live contact overlay.

Arithmetic follows lpe_tpu's jitted frame: XLA multiplies by the float32
reciprocal of a constant divisor (``_div``), so the port does too. Every
deposit that adds floats is one ordered scatter-add
(``core.numerics.scatter_add``: no float atomics, the same bits at any
thread count), every painter's choice an integer ``scatter_reduce("amax")``
or max over entity order, so a frame repeats its bits from run to run.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ScenarioSystemConfig
from ..core.constants import MAX_POLY_VERTS, ShapeKind
from ..core.numerics import scatter_add, sqrt
from ..core.profiler import PROFILER
from ..scene import SceneSpec
from ..state import SimState

FLUID_BASE_COLOR = (40.0, 130.0, 240.0)
FLUID_THRESHOLD = 0.19
FLUID_SMOOTHNESS = 0.02
FLUID_SMOOTH_RADIUS_PX = 10.0

SCHEME_DEFAULT = 0
SCHEME_SLEEP = 1
SCHEME_TEMPERATURE = 2

# Above this liquid count the exact per-particle 21x21 splat switches to a
# bilinear deposit plus one 21x21 convolution with the poly6 disc
# (lpe_tpu/render/frame.py:55-62): both packages take the same branch at
# the same particle count.
_SPLAT_CONV_MIN_NL = 8192
# Above this shape count (the whole solid slice, with a static shape-size
# bound) the painter's pass over full-screen masks switches to the
# windowed priority scatter.
_RASTER_WINDOW_MIN_COUNT = 256
# The grid pipeline's contact rows are drawn only up to this many.
_RG_OVERLAY_MAX_ROWS = 262144
# Elements of the [shapes, vertices, rows, cols] edge tests (and of the
# debug overlays' [shapes, rows, cols] planes) held at once: shapes are
# tested in chunks of this size, in index order.
_CHUNK_ELEMS = 1 << 25


def _div(x, c: float):
    """``x / c`` for a Python constant ``c`` as lpe_tpu's jitted frame
    computes it: XLA multiplies by the float32 reciprocal of ``c``. On
    the card PyTorch's ``x / c`` does the same; on the CPU it divides."""
    return x * float(np.float32(1.0) / np.float32(c))


def _vec(values, dtype, device):
    """A small constant vector made on ``device`` (a fill per entry), not
    copied from the host: a host-to-card copy would wait for the card."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


def _chunk(per_shape: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, per_shape))


def _box_blur5(img):
    """5x5 box blur, each pixel the mean over the in-bounds part of its
    window (kernels.metal:82-113; lpe_tpu's reduce_window sum over the
    same sum of ones): ``avg_pool2d`` without the padding in the count."""
    return F.avg_pool2d(img[None, None], 5, stride=1, padding=2,
                        count_include_pad=False)[0, 0]


def _deposit(idx, vals, n):
    """Sum ``vals`` into ``n`` slots at ``idx`` in index order."""
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return scatter_add(out, idx.long(), vals)


def _fluid_layer(state, spec, H, W, mpp, splat="auto"):
    """Density splat -> blur x2 -> normalize -> smoothstep alpha. [H,W] f32."""
    L0, NL = spec.liquid_start, spec.n_liquid
    pos = _div(state.bodies.pos[L0:L0 + NL], mpp)        # pixel coords
    dev, dt, i32 = pos.device, pos.dtype, torch.int32
    h = FLUID_SMOOTH_RADIUS_PX
    h2 = h * h
    R = int(h) + 1
    win = 2 * R + 1
    if splat == "conv" or (splat == "auto" and NL >= _SPLAT_CONV_MIN_NL):
        # bilinear deposit: pixel i's center sits at i + 0.5
        u = pos[:, 0] - 0.5
        v = pos[:, 1] - 0.5
        i0 = torch.floor(u).to(i32)
        j0 = torch.floor(v).to(i32)
        fu = u - i0.to(dt)
        fv = v - j0.to(dt)
        idx, wgt = [], []
        for di, dj, w in ((0, 0, (1 - fu) * (1 - fv)), (1, 0, fu * (1 - fv)),
                          (0, 1, (1 - fu) * fv), (1, 1, fu * fv)):
            xi = i0 + di
            yj = j0 + dj
            ok = (xi >= 0) & (xi < W) & (yj >= 0) & (yj < H)
            idx.append(torch.where(ok, yj * W + xi, H * W))
            wgt.append(w)
        imp = _deposit(torch.cat(idx), torch.cat(wgt), H * W + 1)
        d = torch.arange(-R, R + 1, dtype=dt, device=dev)
        r2k = d[:, None] * d[:, None] + d[None, :] * d[None, :]
        u = h2 - r2k
        kern = torch.where(r2k < h2, u * u * u, 0.0)
        # float32 on the card, not TF32, and one algorithm every run
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            img = F.conv2d(imp[:H * W].view(1, 1, H, W), kern[None, None],
                           padding=R)[0, 0]
        return _fluid_post(img)
    ox = torch.floor(pos[:, 0]).to(i32) - R
    oy = torch.floor(pos[:, 1]).to(i32) - R
    d = torch.arange(win, dtype=i32, device=dev)
    gx = ox[:, None] + d[None, :]                        # [NL, win]
    gy = oy[:, None] + d[None, :]
    cx = gx.to(dt) + 0.5
    cy = gy.to(dt) + 0.5
    dx = cx[:, None, :] - pos[:, 0, None, None]          # [NL, 1, win] x-term
    dy = cy[:, :, None] - pos[:, 1, None, None]          # [NL, win, 1] y-term
    r2 = dx * dx + dy * dy
    u = h2 - r2
    w = torch.where(r2 < h2, u * u * u, 0.0)             # unnormalized poly6
    fy = gy[:, :, None]
    fx = gx[:, None, :]
    ok = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    flat = torch.where(ok, fy * W + fx, H * W)
    grid = _deposit(flat.reshape(-1), w.reshape(-1), H * W + 1)
    return _fluid_post(grid[:H * W].view(H, W))


def _fluid_post(img):
    """Shared splat postprocess: blur x2 -> max-normalize -> smoothstep."""
    img = _box_blur5(_box_blur5(img))
    max_d = img.max()
    img = torch.where(max_d > 1e-12, img / torch.clamp(max_d, min=1e-12),
                      0.0)
    lo = FLUID_THRESHOLD - FLUID_SMOOTHNESS
    hi = FLUID_THRESHOLD + FLUID_SMOOTHNESS
    t = torch.clamp(_div(img - lo, hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)                       # smoothstep alpha


class _Geom:
    """Pixel-space geometry of a slice of entities, computed once a frame:
    centers, circle radii squared, world vertices and edges ([n, V]), the
    valid-edge mask. Indexing selects entities."""

    FIELDS = ("px", "py", "circ", "rr", "wx", "wy", "ex", "ey", "vmask",
              "poly", "active")

    def __init__(self, **kw):
        for k in self.FIELDS:
            setattr(self, k, kw[k])

    def __getitem__(self, sel):
        return _Geom(**{k: getattr(self, k)[sel] for k in self.FIELDS})


def _shape_geom(b, idx0, count, mpp) -> _Geom:
    sl = slice(idx0, idx0 + count)
    pos = b.pos[sl]
    c = torch.cos(b.angle[sl])[:, None]
    s = torch.sin(b.angle[sl])[:, None]
    v = b.verts[sl]                                      # [n, V, 2] local
    wx = _div(pos[:, 0:1] + v[..., 0] * c - v[..., 1] * s, mpp)
    wy = _div(pos[:, 1:2] + v[..., 0] * s + v[..., 1] * c, mpp)
    nv = b.nverts[sl][:, None]
    vi = torch.arange(MAX_POLY_VERTS, device=pos.device)[None, :]
    nxt = torch.where(vi + 1 >= nv, 0, vi + 1).expand(count, -1)
    rpx = torch.clamp(_div(b.radius[sl], mpp), min=1.0)
    return _Geom(px=_div(pos[:, 0], mpp), py=_div(pos[:, 1], mpp),
                 circ=b.shape_kind[sl] == int(ShapeKind.CIRCLE),
                 rr=rpx * rpx, wx=wx, wy=wy,
                 ex=wx.gather(1, nxt) - wx, ey=wy.gather(1, nxt) - wy,
                 vmask=vi < nv, poly=nv[:, 0] >= 3, active=b.active[sl])


def _inside(g: _Geom, xpix, ypix):
    """Coverage [n, rows, cols] of the n entities of ``g`` on pixel-center
    grids ``xpix`` [1 or n, 1, cols] and ``ypix`` [1 or n, rows, 1]: a
    circle, or a convex polygon (inside iff on one side of every valid
    edge), gated by ``active`` (lpe_tpu/render/frame.py:136-163)."""
    e = (slice(None), None, None)
    dx = xpix - g.px[e]
    dy = ypix - g.py[e]
    in_circle = dx * dx + dy * dy <= g.rr[e]
    ev = (slice(None), slice(None), None, None)
    crossv = g.ex[ev] * (ypix[:, None] - g.wy[ev]) - \
        g.ey[ev] * (xpix[:, None] - g.wx[ev])            # [n, V, rows, cols]
    off = ~g.vmask[ev]
    all_pos = ((crossv >= 0) | off).all(1)
    all_neg = ((crossv <= 0) | off).all(1)
    in_poly = (all_pos | all_neg) & g.poly[e]
    return torch.where(g.circ[e], in_circle, in_poly) & g.active[e]


def _pixel_centers(H, W, dt, dev):
    ypix = (torch.arange(H, dtype=dt, device=dev) + 0.5)[None, :, None]
    xpix = (torch.arange(W, dtype=dt, device=dev) + 0.5)[None, None, :]
    return xpix, ypix


def _shape_masks_loop(state, idx0, count, H, W, mpp):
    """The painter's pass in the reference's draw-loop order: each entity
    paints its color over the full screen where it covers, later entities
    over earlier ones. Entities are tested a chunk at a time; a pixel
    takes the highest index that covers it, which is what the sequential
    loop (lpe_tpu/render/frame.py:166-186) leaves there."""
    b = state.bodies
    dev, dt = b.pos.device, b.pos.dtype
    if count == 0:
        return (torch.zeros(H, W, 3, dtype=torch.float32, device=dev),
                torch.zeros(H, W, dtype=torch.float32, device=dev))
    g = _shape_geom(b, idx0, count, mpp)
    xpix, ypix = _pixel_centers(H, W, dt, dev)
    win = torch.full((H, W), -1, dtype=torch.int64, device=dev)
    C = _chunk(MAX_POLY_VERTS * H * W)
    for c0 in range(0, count, C):
        n = min(C, count - c0)
        ins = _inside(g[c0:c0 + n], xpix, ypix)
        k = torch.arange(c0, c0 + n, device=dev)[:, None, None]
        win = torch.maximum(win, torch.where(ins, k, -1).amax(0))
    covered = win >= 0
    col = b.color[idx0 + win.clamp(min=0)].to(torch.float32)
    return (torch.where(covered[:, :, None], col, 0.0),
            covered.to(torch.float32))


def _shape_masks_windowed(state, spec, idx0, count, H, W, mpp, WR):
    """Large-count rasterizer: each non-"big" shape tests coverage only in
    its own (2*WR+1)^2 pixel window (a batched [shapes, WIN, WIN] test),
    then an int32 scatter-max of entity index + 1 keeps the highest index
    a pixel gets, the painter's order (exact and order-free). The few
    oversized solids (spec.solid_big_idx) are painted full-screen into the
    same priority image in sorted order (lpe_tpu/render/frame.py:189-243)."""
    b = state.bodies
    dev, dt = b.pos.device, b.pos.dtype
    WIN = 2 * WR + 1
    big = sorted(i - idx0 for i in set(spec.solid_big_idx)
                 if idx0 <= i < idx0 + count)
    g = _shape_geom(b, idx0, count, mpp)
    d = torch.arange(WIN, dtype=torch.int32, device=dev)
    prio_v = torch.arange(idx0 + 1, idx0 + count + 1, dtype=torch.int32,
                          device=dev)
    for k in big:
        # big shapes can exceed the window: priority 0 never wins here
        prio_v[k:k + 1].fill_(0)
    prio = torch.zeros(H * W + 1, dtype=torch.int32, device=dev)
    C = _chunk(MAX_POLY_VERTS * WIN * WIN)
    for c0 in range(0, count, C):
        n = min(C, count - c0)
        gs = g[c0:c0 + n]
        gx = torch.floor(gs.px).to(torch.int32)[:, None] - WR + d  # [n, WIN]
        gy = torch.floor(gs.py).to(torch.int32)[:, None] - WR + d
        xc = (gx.to(dt) + 0.5)[:, None, :]               # [n, 1, WIN]
        yc = (gy.to(dt) + 0.5)[:, :, None]               # [n, WIN, 1]
        ok = _inside(gs, xc, yc) & ((gx >= 0) & (gx < W))[:, None, :] \
            & ((gy >= 0) & (gy < H))[:, :, None]
        flat = torch.where(ok, gy[:, :, None] * W + gx[:, None, :], H * W)
        prio.scatter_reduce_(0, flat.reshape(-1).long(),
                             prio_v[c0:c0 + n, None, None].expand(
                                 n, WIN, WIN).reshape(-1), "amax")
    prio = prio[:H * W].view(H, W)
    if big:
        xpix, ypix = _pixel_centers(H, W, dt, dev)
        for k in big:
            inside = _inside(g[k:k + 1], xpix, ypix)[0]
            prio = torch.where(inside, torch.clamp(prio, min=idx0 + k + 1),
                               prio)
    covered = prio > 0
    winner = torch.clamp(prio - 1, min=0).long()
    color_img = torch.where(covered[:, :, None],
                            b.color[winner].to(torch.float32), 0.0)
    return color_img, covered.to(torch.float32)


def _shape_masks(state, spec, idx0, count, H, W, mpp):
    """Rasterize shapes [idx0:idx0+count] -> per-pixel (color, covered),
    later shapes painting over earlier ones. Takes the windowed priority
    rasterizer for the whole solid slice at large counts when the scene's
    static size bound keeps windows small (lpe_tpu/render/frame.py:246)."""
    if count >= _RASTER_WINDOW_MIN_COUNT and idx0 == spec.solid_start \
            and count == spec.n_solid and spec.solid_cell_size > 0:
        WR = int(spec.solid_cell_size / (2.0 * mpp)) + 2
        if 2 * WR + 1 <= 96:
            return _shape_masks_windowed(state, spec, idx0, count, H, W,
                                         mpp, WR)
    return _shape_masks_loop(state, idx0, count, H, W, mpp)


def _debug_overlays(state, spec, img, H, W, mpp):
    """Velocity vectors (cyan, 20 px per m/s) and angular-velocity arcs
    (magenta, radius 15 px, arc = min(|w|*0.5, pi/2) from -pi/2) of each
    solid (solid_renderer.cpp:206-275). lpe_tpu draws solid after solid,
    each its line then its arc; here a chunk of solids at a time, a pixel
    taking the last (solid, line-then-arc) that covers it."""
    if spec.n_solid == 0:
        return img
    b = state.bodies
    dev, dt = b.pos.device, b.pos.dtype
    s0, ns = spec.solid_start, spec.n_solid
    sl = slice(s0, s0 + ns)
    px = _div(b.pos[sl, 0], mpp)
    py = _div(b.pos[sl, 1], mpp)
    vx, vy = b.vel[sl, 0], b.vel[sl, 1]
    vmag = sqrt(vx * vx + vy * vy)
    vlen = vmag * 20.0
    ux = torch.where(vmag > 1e-9, vx / torch.clamp(vmag, min=1e-9), 0.0)
    uy = torch.where(vmag > 1e-9, vy / torch.clamp(vmag, min=1e-9), 0.0)
    w = b.omega[sl]
    arc_len = torch.clamp(torch.abs(w) * 0.5, max=math.pi / 2)
    line_ok = (vlen > 1.0) & b.active[sl]
    arc_ok = (torch.abs(w) > 0.05) & b.active[sl]
    xpix, ypix = _pixel_centers(H, W, dt, dev)
    prio = torch.full((H, W), -1, dtype=torch.int64, device=dev)
    e = (slice(None), None, None)
    C = _chunk(16 * H * W)
    for c0 in range(0, ns, C):
        k = slice(c0, min(ns, c0 + C))
        dx = xpix - px[k][e]
        dy = ypix - py[k][e]
        # --- velocity line ---
        t = torch.clamp(dx * ux[k][e] + dy * uy[k][e], min=0.0)
        t = torch.minimum(t, vlen[k][e])
        ex = dx - t * ux[k][e]
        ey = dy - t * uy[k][e]
        on_line = (ex * ex + ey * ey <= 1.0) & line_ok[k][e]
        # --- angular arc ---
        r = sqrt(dx * dx + dy * dy)
        rel = torch.atan2(dy, dx) - (-math.pi / 2)
        rel = torch.where(rel > math.pi, rel - 2 * math.pi,
                          torch.where(rel < -math.pi, rel + 2 * math.pi, rel))
        al = arc_len[k][e]
        in_arc = torch.where(w[k][e] >= 0, (rel >= 0) & (rel <= al),
                             (rel <= 0) & (rel >= -al))
        on_arc = (torch.abs(r - 15.0) <= 1.0) & in_arc & arc_ok[k][e]
        order = 2 * torch.arange(k.start, k.stop, device=dev)[e]
        prio = torch.maximum(prio, torch.maximum(
            torch.where(on_line, order, -1),
            torch.where(on_arc, order + 1, -1)).amax(0))
    cyan = _vec((0.0, 255.0, 255.0), img.dtype, dev)
    magenta = _vec((255.0, 0.0, 255.0), img.dtype, dev)
    col = torch.where((prio % 2 == 1)[:, :, None], magenta, cyan)
    return torch.where((prio >= 0)[:, :, None], col, img)


def _overlay_writes(state, H, W, mpp, dt):
    """The contact overlay's pixel writes, in lpe_tpu's order
    (lpe_tpu/render/frame.py:308-407): ``idx`` [T] flat pixels (H*W: not
    drawn), ``row`` [T] into ``colors`` [R, 3]. Segments are sampled at
    fixed counts and drawn 2x2; dots are discs of radius 3."""
    b = state.bodies
    dev = b.pos.device
    calls = []                     # (pixel indices [n, S], colors [n, 3])
    t16 = _div(torch.arange(16, dtype=dt, device=dev), 15.0)[None, :]

    def seg(x0, y0, ux, uy, length, color, val):
        # segment from (x0, y0) px along (ux, uy), 16 samples, 2x2 thick
        xs = x0[:, None] + ux[:, None] * t16 * length[:, None]
        ys = y0[:, None] + uy[:, None] * t16 * length[:, None]
        v = (val[:, None] & (xs >= 0) & (xs < W - 1)
             & (ys >= 0) & (ys < H - 1))
        xi = torch.floor(xs).to(torch.int32)
        yi = torch.floor(ys).to(torch.int32)
        for dy in (0, 1):
            for dx in (0, 1):
                calls.append((torch.where(v, (yi + dy) * W + xi + dx, H * W),
                              color))

    def dot(x0, y0, color, val, r=3):
        xi = torch.floor(x0).to(torch.int32)
        yi = torch.floor(y0).to(torch.int32)
        v = val & (x0 >= r) & (x0 < W - r) & (y0 >= r) & (y0 < H - r)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dx * dx + dy * dy > r * r:
                    continue
                calls.append((torch.where(v, (yi + dy) * W + xi + dx,
                                          H * W)[:, None],
                              color.expand(x0.shape[0], 3)))

    yellow = _vec((255.0, 255.0, 0.0), dt, dev)
    blue = _vec((0.0, 0.0, 255.0), dt, dev)
    white = torch.full((3,), 255.0, dtype=dt, device=dev)

    def draw(pt, nrm, jn, jt, val, colA, colB):
        px = _div(pt[:, 0], mpp)
        py = _div(pt[:, 1], mpp)
        nx, ny = nrm[:, 0], nrm[:, 1]
        seg(px, py, nx, ny, torch.full_like(px, 30.0), colA, val)
        li = torch.clamp(torch.abs(jn) * 5.0, max=50.0)
        seg(px, py, nx, ny, li, colB, val & (torch.abs(jn) > 1e-3))
        # tangent: normal rotated +90deg, flipped when jt < 0
        sgn = torch.where(jt < 0, -1.0, 1.0)
        lt = torch.clamp(torch.abs(jt) * 5.0, max=50.0)
        seg(px, py, -ny * sgn, nx * sgn, lt, blue.expand(px.shape[0], 3),
            val & (torch.abs(jt) > 1e-3))
        dot(px, py, yellow, val)

    # list pipeline's pair-keyed cache
    P, C = state.warm_normal.shape
    if P:
        ia = torch.clamp(state.warm_ia, min=0).long()
        ib = torch.clamp(state.warm_ib, min=0).long()
        colA = (b.color[ia].to(dt) * 0.9)[:, None, :].expand(P, C, 3) \
            .reshape(-1, 3)
        colB = (b.color[ib].to(dt) * 0.9)[:, None, :].expand(P, C, 3) \
            .reshape(-1, 3)
        nrm = state.warm_n[:, None, :].expand(P, C, 2).reshape(-1, 2)
        val = ((state.warm_ia >= 0)[:, None]
               & (state.warm_pt[..., 0] < 1e29)).reshape(-1)
        draw(state.warm_pt.reshape(-1, 2), nrm, state.warm_normal.reshape(-1),
             state.warm_tangent.reshape(-1), val, colA, colB)
    # grid pipeline's cell-resident cache (no body ids in the rows: the
    # normal draws white; skipped when the resident row count would make
    # the overlay itself a workload)
    rg = state.rg_warm_n
    if rg.numel() and rg.numel() <= _RG_OVERLAY_MAX_ROWS:
        NCc, R, Cc = rg.shape
        pt = state.rg_warm_pt.reshape(-1, 2)
        nrm = state.rg_warm_nrm[:, :, None, :].expand(NCc, R, Cc, 2) \
            .reshape(-1, 2)
        val = (pt[:, 0] < 1e29) & \
            ((torch.abs(rg) > 1e-3)
             | (torch.abs(state.rg_warm_t) > 1e-3)).reshape(-1)
        colW = white.expand(pt.shape[0], 3)
        draw(pt, nrm, rg.reshape(-1), state.rg_warm_t.reshape(-1), val,
             colW, colW)
    if not calls:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, 3, dtype=dt, device=dev))
    idx, row, off = [], [], 0
    for pix, col in calls:
        n, S = pix.shape
        idx.append(pix.reshape(-1).long())
        row.append((off + torch.arange(n, device=dev))[:, None]
                   .expand(n, S).reshape(-1))
        off += n
    return (torch.cat(idx), torch.cat(row),
            torch.cat([col for _, col in calls]))


def _contact_overlays(state, spec, img, H, W, mpp):
    """Live contact debug overlay: yellow contact points, a 30 px normal
    line darkened to body A's color, a normal-impulse line (min(|jn|*5,
    50) px, body B's color) and a perpendicular blue tangent-impulse line
    flipped by the impulse sign (solid_renderer.cpp:151-204). Where
    several writes land on one pixel the last in lpe_tpu's order wins,
    chosen by an int32 scatter-max of the write's order and a gather, so
    a debug frame repeats on the card (lpe_tpu leaves that winner to its
    scatter's order)."""
    idx, row, colors = _overlay_writes(state, H, W, mpp, img.dtype)
    if idx.numel() == 0:
        return img
    order = torch.arange(idx.numel(), dtype=torch.int32, device=idx.device)
    last = torch.full((H * W + 1,), -1, dtype=torch.int32,
                      device=idx.device).scatter_reduce_(0, idx, order,
                                                         "amax")[:H * W]
    drawn = colors[row[last.clamp(min=0).long()]]
    return torch.where((last >= 0)[:, None], drawn,
                       img.reshape(H * W, 3)).view(H, W, 3)


def _scheme_colors(state, spec, H, W, mpp, scheme):
    """Per-PIXEL property aggregation -> per-entity fill colors for the
    solid slice (renderer_types.hpp:34-73, solid_renderer.cpp:34-59,
    125-149, presentation_manager.cpp:34-48). Every solid is bucketed by
    its CENTER pixel and colored from its pixel's aggregate (White when
    the center is off-screen). lpe_tpu's documented deviation is kept:
    temperature is the mass-weighted mean over the temperature-carrying
    sharers only (order-free; identical to the reference whenever all
    sharers carry temperature; lpe_tpu/render/frame.py:416-424)."""
    b = state.bodies
    s0, ns = spec.solid_start, spec.n_solid
    dev, dt = b.pos.device, b.pos.dtype
    px = torch.floor(_div(b.pos[s0:s0 + ns, 0], mpp)).to(torch.int32)
    py = torch.floor(_div(b.pos[s0:s0 + ns, 1], mpp)).to(torch.int32)
    act = b.active[s0:s0 + ns]
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & act
    flat = torch.where(inb, py * W + px, H * W).long()  # OOB: dump slot
    white = torch.full((ns, 3), 255, dtype=torch.uint8, device=dev)
    if scheme == SCHEME_SLEEP:
        # asleep = that of the LAST entity with a Sleep component on the
        # pixel (entity index order); no Sleep sharer reads awake (green)
        hs = b.has_sleep[s0:s0 + ns] & inb
        rank = torch.where(hs, torch.arange(1, ns + 1, dtype=torch.int32,
                                            device=dev), 0).to(torch.int32)
        winner = torch.zeros(H * W + 1, dtype=torch.int32, device=dev) \
            .scatter_reduce_(0, flat, rank, "amax")
        wk = winner[flat].long()                    # per-entity pixel winner
        asleep_pix = torch.where(wk > 0,
                                 b.asleep[s0 + torch.clamp(wk - 1, min=0)],
                                 False)
        red = _vec((200, 50, 50), torch.uint8, dev)
        green = _vec((50, 200, 50), torch.uint8, dev)
        col = torch.where(asleep_pix[:, None], red, green)
        return torch.where(inb[:, None], col, white)
    # TEMPERATURE: mass-weighted mean over has_temperature sharers; no
    # temperature at the pixel -> gray 128 (temperatureColorMapper)
    ht = b.has_temperature[s0:s0 + ns] & inb
    m = torch.where(ht, b.mass[s0:s0 + ns], 0.0).to(dt)
    mt = m * b.temperature[s0:s0 + ns].to(dt)
    m_sum = _deposit(flat, m, H * W + 1)[flat]
    mt_sum = _deposit(flat, mt, H * W + 1)[flat]
    has_t = m_sum > 1e-9
    t = torch.clamp(_div(mt_sum / torch.clamp(m_sum, min=1e-9), 100.0),
                    0.0, 1.0)
    col = torch.stack([255.0 * t, torch.zeros_like(t), 255.0 * (1.0 - t)],
                      dim=-1).to(torch.uint8)
    gray = torch.full((ns, 3), 128, dtype=torch.uint8, device=dev)
    return torch.where(inb[:, None], torch.where(has_t[:, None], col, gray),
                       white)


def make_renderer(spec: SceneSpec, cfg: ScenarioSystemConfig, *,
                  width: int = 600, height: int = 600,
                  color_scheme: int = SCHEME_DEFAULT, debug: bool = False,
                  splat: str = "auto"):
    """``frame(state) -> uint8 [height, width, 3]`` on the state's device.
    Each phase runs in a span of the port's tracer: ``render_fluid``,
    ``render_solids``, ``render_gas``, ``render_debug``."""
    mpp = cfg.shared.meters_per_pixel * (600.0 / width)
    H, W = height, width

    def frame(state: SimState) -> torch.Tensor:
        b = state.bodies
        dev = b.pos.device
        img = torch.zeros(H, W, 3, dtype=torch.float32, device=dev)
        if spec.n_liquid > 0:
            with PROFILER.scope("render_fluid"):
                alpha = _fluid_layer(state, spec, H, W, mpp, splat)
            base = _vec(FLUID_BASE_COLOR, torch.float32, dev)
            img = img * (1 - alpha[:, :, None]) + base * alpha[:, :, None]
        # color-scheme recolor of the solids from per-PIXEL aggregates;
        # the gas pass always uses the entity's own color
        # (gas_renderer.cpp:29-39)
        st = state
        if color_scheme != SCHEME_DEFAULT and spec.n_solid > 0:
            fill = _scheme_colors(state, spec, H, W, mpp, color_scheme)
            s0 = spec.solid_start
            color = torch.cat([b.color[:s0], fill,
                               b.color[s0 + spec.n_solid:]])
            st = state.replace(bodies=b.replace(color=color))
        with PROFILER.scope("render_solids"):
            scol, salpha = _shape_masks(st, spec, spec.solid_start,
                                        spec.n_solid, H, W, mpp)
        img = torch.where(salpha[:, :, None] > 0, scol, img)
        if spec.n_gas > 0:                               # alpha 180/255
            with PROFILER.scope("render_gas"):
                gcol, galpha = _shape_masks(st, spec, spec.gas_start,
                                            spec.n_gas, H, W, mpp)
            ga = galpha[:, :, None] * (180.0 / 255.0)
            img = img * (1 - ga) + gcol * ga
        if debug:
            with PROFILER.scope("render_debug"):
                img = _debug_overlays(st, spec, img, H, W, mpp)
                if spec.n_solid > 0:
                    img = _contact_overlays(st, spec, img, H, W, mpp)
        return torch.clamp(img, 0, 255).to(torch.uint8)

    return frame
