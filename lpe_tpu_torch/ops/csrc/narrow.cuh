// One row of the grid-rigid narrowphase: poly-poly SAT + incident-edge
// clip of two polygon rings, shared by the row-form kernel
// (narrowphase.cu: a thread builds its row's two rings) and the grid kernel
// (narrowphase_grid.cu: rings built once per body and staged in shared
// memory). Either runs the row on rings in registers (Ring).
//
// It computes what the vmapped XLA pair computes
// (lpe_tpu/systems/rigid/geometry.py sat_contact(any_circle=False), then
// pipeline.py _pair_contacts with C = 2): the separating axis of least
// penetration over both rings' centroid-oriented face normals (the first
// minimum), then A's best face as the reference face (first maximum of the
// raw rot90-left normals against the axis), B's most anti-parallel face
// clipped against its two side planes, and the <= 2 points at or below the
// reference face, deepest first. The plain version is
// lpe_tpu_torch/ops/rigid_kernels.py narrowphase_plain. Every sum over a
// ring runs in ring order, as the plain version's does; with --fmad=false
// the two round alike.
#pragma once

#include "common.cuh"

namespace {

constexpr float kBig = 1e30f;

// One side of a row: world vertices, raw rot90-left unit face normals, and
// per face whether the outward (centroid-oriented) normal is the raw one
// (bit set) or its negation. A thread holds it in registers (loops
// unrolled by the template on V).
template <int V>
struct Ring {
  float x[V], y[V];
  float rx[V], ry[V];
  unsigned raw_out;
  int n;
};

template <int V>
__device__ __forceinline__ float next_x(const Ring<V>& g, int i) {
  return (i == g.n - 1) ? g.x[0] : g.x[(i + 1) % V];
}

template <int V>
__device__ __forceinline__ float next_y(const Ring<V>& g, int i) {
  return (i == g.n - 1) ? g.y[0] : g.y[(i + 1) % V];
}

// The ring of a body at (px, py) turned by (c, s) = (cos, sin) of its
// angle, from its V local vertices v[2 V] of which the first n are live.
template <int V>
__device__ __forceinline__ void build_ring(float px, float py, float c,
                                           float s,
                                           const float* __restrict__ v,
                                           int n, Ring<V>& g) {
  g.n = n;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float vx = v[2 * i], vy = v[2 * i + 1];
    g.x[i] = px + (vx * c - vy * s);
    g.y[i] = py + (vx * s + vy * c);
  }
  float cx = 0.f, cy = 0.f;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i < g.n) {
      cx = cx + g.x[i];
      cy = cy + g.y[i];
      ++cnt;
    }
  }
  const float fc = (float)(cnt > 1 ? cnt : 1);
  cx = cx / fc;
  cy = cy / fc;
  g.raw_out = 0u;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float xi = g.x[i], yi = g.y[i];
    const float ex = next_x<V>(g, i) - xi;
    const float ey = next_y<V>(g, i) - yi;
    const float ln = fmaxf(sqrtf(ex * ex + ey * ey), 1e-30f);
    const float rxi = -ey / ln, ryi = ex / ln;
    g.rx[i] = rxi;
    g.ry[i] = ryi;
    // outward candidate (ey, -ex)/ln = -raw; flipped when it faces the
    // centroid
    const float ox = -rxi, oy = -ryi;
    if ((ox * (xi - cx) + oy * (yi - cy)) < 0.f) g.raw_out |= 1u << i;
  }
}

// Outward unit normal of face i.
template <int V>
__device__ __forceinline__ void outward(const Ring<V>& g, int i, float& ox,
                                        float& oy) {
  const bool raw = (g.raw_out >> i) & 1u;
  ox = raw ? g.rx[i] : -g.rx[i];
  oy = raw ? g.ry[i] : -g.ry[i];
}

// The face of g whose raw normal aligns best with (nx, ny), first maximum:
// its two endpoints and its raw normal.
template <int V>
__device__ __forceinline__ void best_face(const Ring<V>& g, float nx,
                                          float ny,
                                          float& v1x, float& v1y,
                                          float& v2x, float& v2y, float& fx,
                                          float& fy) {
  float bd = -2.f * kBig;
  v1x = v1y = v2x = v2y = fx = fy = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = (i < g.n) ? (g.rx[i] * nx + g.ry[i] * ny) : -kBig;
    if (d > bd) {
      bd = d;
      v1x = g.x[i];
      v1y = g.y[i];
      v2x = next_x<V>(g, i);
      v2y = next_y<V>(g, i);
      fx = g.rx[i];
      fy = g.ry[i];
    }
  }
}

// A row's results: (hit, nrm, pen, pts, pens, cval) of make_narrowphase,
// cval ANDed with hit.
struct RowOut {
  bool hit, cv0, cv1;
  float nx, ny, pen, pts[4], pens[2];
};

template <int V>
__device__ __forceinline__ RowOut narrow_row(const Ring<V>& a,
                                             const Ring<V>& b) {
  // ---- SAT: A's outward normals, then B's negated; first minimum ----
  const float inf = __int_as_float(0x7f800000);
  float best = inf, nx = 0.f, ny = 0.f;
  bool hit = true, anyv = false;
#pragma unroll
  for (int i = 0; i < 2 * V; ++i) {
    float dx, dy;
    bool dvalid;
    if (i < V) {
      outward(a, i, dx, dy);
      dvalid = i < a.n;
    } else {
      outward(b, i - V, dx, dy);
      dx = -dx;
      dy = -dy;
      dvalid = (i - V) < b.n;
    }
    float amax = -inf, bmin = inf;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (v < a.n) amax = fmaxf(amax, a.x[v] * dx + a.y[v] * dy);
      if (v < b.n) bmin = fminf(bmin, b.x[v] * dx + b.y[v] * dy);
    }
    const float pend = dvalid ? amax - bmin : inf;
    hit = hit && (!dvalid || pend > 0.f);
    anyv = anyv || dvalid;
    if (i == 0 || pend < best) {
      best = pend;
      nx = dx;
      ny = dy;
    }
  }
  hit = hit && anyv;

  // ---- reference face on A, incident face on B, side-plane clip ----
  float v1x, v1y, v2x, v2y, rfx, rfy;
  best_face<V>(a, nx, ny, v1x, v1y, v2x, v2y, rfx, rfy);
  const float face_off = rfx * v1x + rfy * v1y;
  float edx = v2x - v1x, edy = v2y - v1y;
  const float el = fmaxf(sqrtf(edx * edx + edy * edy), 1e-30f);
  edx = edx / el;
  edy = edy / el;
  float p1x, p1y, p2x, p2y, ifx, ify;
  best_face<V>(b, -rfx, -rfy, p1x, p1y, p2x, p2y, ifx, ify);
  bool ok1 = true, ok2 = true;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const float pnx = side == 0 ? edx : -edx;
    const float pny = side == 0 ? edy : -edy;
    const float po = side == 0 ? (edx * v2x + edy * v2y)
                               : (pnx * v1x + pny * v1y);
    const float d1 = (pnx * p1x + pny * p1y) - po;
    const float d2 = (pnx * p2x + pny * p2y) - po;
    const float dd = d1 - d2;
    const float t = d1 / (fabsf(dd) < 1e-30f ? 1e-30f : dd);
    const float ix = p1x + (p2x - p1x) * t;
    const float iy = p1y + (p2y - p1y) * t;
    const bool both_out = (d1 > 0.f) && (d2 > 0.f);
    ok1 = ok1 && !both_out;
    ok2 = ok2 && !both_out;
    if (d1 > 0.f && !both_out) {
      p1x = ix;
      p1y = iy;
    }
    if (d2 > 0.f && !both_out) {
      p2x = ix;
      p2y = iy;
    }
  }
  const float pen1 = face_off - (rfx * p1x + rfy * p1y);
  const float pen2 = face_off - (rfx * p2x + rfy * p2y);
  ok1 = ok1 && (pen1 >= 0.f);
  ok2 = ok2 && (pen2 >= 0.f);
  const bool swap = pen2 > pen1;

  RowOut o;
  o.hit = hit;
  o.nx = nx;
  o.ny = ny;
  o.pen = fmaxf(best, 0.f);
  o.pts[0] = swap ? p2x : p1x;
  o.pts[1] = swap ? p2y : p1y;
  o.pts[2] = swap ? p1x : p2x;
  o.pts[3] = swap ? p1y : p2y;
  o.pens[0] = swap ? pen2 : pen1;
  o.pens[1] = swap ? pen1 : pen2;
  o.cv0 = hit && (swap ? ok2 : ok1);
  o.cv1 = hit && (swap ? ok1 : ok2);
  return o;
}

// Row r's results, row-contiguous as make_narrowphase lays them out.
__device__ __forceinline__ void store_row(const RowOut& o, long r,
                                          bool* __restrict__ hit,
                                          float* __restrict__ nrm,
                                          float* __restrict__ pen,
                                          float* __restrict__ pts,
                                          float* __restrict__ pens,
                                          bool* __restrict__ cval) {
  hit[r] = o.hit;
  nrm[2 * r] = o.nx;
  nrm[2 * r + 1] = o.ny;
  pen[r] = o.pen;
  float* p = pts + 4 * r;
  p[0] = o.pts[0];
  p[1] = o.pts[1];
  p[2] = o.pts[2];
  p[3] = o.pts[3];
  pens[2 * r] = o.pens[0];
  pens[2 * r + 1] = o.pens[1];
  cval[2 * r] = o.cv0;
  cval[2 * r + 1] = o.cv1;
}

}  // namespace

// The vertex counts the narrowphase kernels are instantiated for, as a
// switch over V calling CASE(V) (rigid_kernels.V_MIN .. V_MAX).
#define LPE_NARROW_SWITCH(VAR, CASE)                                       \
  switch (VAR) {                                                           \
    CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)       \
    CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)                  \
    default:                                                               \
      return (int)cudaErrorInvalidValue;                                   \
  }
