// Grid-rigid narrowphase: poly-poly SAT + incident-edge clip, one thread
// per candidate row.
//
// Replaces lpe_tpu/ops/pallas_rigid.py:_nphase_kernel (built by
// make_narrowphase). It computes what the vmapped XLA pair computes
// (lpe_tpu/systems/rigid/geometry.py sat_contact(any_circle=False), then
// pipeline.py _pair_contacts with C = 2): the separating axis of least
// penetration over both rings' centroid-oriented face normals (the first
// minimum), then A's best face as the reference face (first maximum of the
// raw rot90-left normals against the axis), B's most anti-parallel face
// clipped against its two side planes, and the <= 2 points at or below the
// reference face, deepest first. The plain version is
// lpe_tpu_torch/ops/rigid_kernels.py narrowphase_plain.
//
// Bound on the H100: a row reads pos (8 B), cos, sin, nverts (12 B) and
// V x 2 vertex floats (56 B at V = 7) per side and writes 39 B of results,
// about 190 B a row: the 82,944 rows of a RIGID_STACKS 10k tick are about
// 16 MB, ~5 us at 3.35 TB/s. Its ~1-1.5 kFLOP a row take under 3 us at the
// 67 TFLOP/s fp32 rate, so the kernel is bound by memory. The TPU kernel
// kept (8, 128) blocks of rows in VMEM planes; here one thread holds one
// row's two rings in registers (loops unrolled by the template on V) and
// nothing is staged in shared memory. Every sum over a ring runs in ring
// order, as the plain version's does; with --fmad=false the two round
// alike.
#include "common.cuh"

struct NarrowParams {
  int N, V;
};

namespace {

constexpr float kBig = 1e30f;

// One side of a row: world vertices, raw rot90-left unit face normals, and
// per face whether the outward (centroid-oriented) normal is the raw one
// (bit set) or its negation.
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

template <int V>
__device__ __forceinline__ void load_ring(
    const float* __restrict__ pos, const float* __restrict__ cs,
    const float* __restrict__ sn, const float* __restrict__ verts,
    const int* __restrict__ nv, long r, Ring<V>& g) {
  const float px = pos[2 * r], py = pos[2 * r + 1];
  const float c = cs[r], s = sn[r];
  const float* v = verts + r * (2 * V);
  g.n = nv[r];
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
    const float ex = next_x(g, i) - g.x[i];
    const float ey = next_y(g, i) - g.y[i];
    const float ln = fmaxf(sqrtf(ex * ex + ey * ey), 1e-30f);
    g.rx[i] = -ey / ln;
    g.ry[i] = ex / ln;
    // outward candidate (ey, -ex)/ln = -raw; flipped when it faces the
    // centroid
    const float ox = -g.rx[i], oy = -g.ry[i];
    if ((ox * (g.x[i] - cx) + oy * (g.y[i] - cy)) < 0.f) g.raw_out |= 1u << i;
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
                                          float ny, float& v1x, float& v1y,
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
      v2x = next_x(g, i);
      v2y = next_y(g, i);
      fx = g.rx[i];
      fy = g.ry[i];
    }
  }
}

}  // namespace

// Global namespace: profilers name it narrowphase_kernel<V>.
template <int V>
__global__ void __launch_bounds__(128) narrowphase_kernel(
    const float* __restrict__ a_pos, const float* __restrict__ a_cos,
    const float* __restrict__ a_sin, const float* __restrict__ a_verts,
    const int* __restrict__ a_nv, const float* __restrict__ b_pos,
    const float* __restrict__ b_cos, const float* __restrict__ b_sin,
    const float* __restrict__ b_verts, const int* __restrict__ b_nv,
    bool* __restrict__ hit_out, float* __restrict__ nrm_out,
    float* __restrict__ pen_out, float* __restrict__ pts_out,
    float* __restrict__ pens_out, bool* __restrict__ cval_out, int N) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  Ring<V> a, b;
  load_ring<V>(a_pos, a_cos, a_sin, a_verts, a_nv, r, a);
  load_ring<V>(b_pos, b_cos, b_sin, b_verts, b_nv, r, b);

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
  best_face(a, nx, ny, v1x, v1y, v2x, v2y, rfx, rfy);
  const float face_off = rfx * v1x + rfy * v1y;
  float edx = v2x - v1x, edy = v2y - v1y;
  const float el = fmaxf(sqrtf(edx * edx + edy * edy), 1e-30f);
  edx = edx / el;
  edy = edy / el;
  float p1x, p1y, p2x, p2y, ifx, ify;
  best_face(b, -rfx, -rfy, p1x, p1y, p2x, p2y, ifx, ify);
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

  hit_out[r] = hit;
  nrm_out[2 * r] = nx;
  nrm_out[2 * r + 1] = ny;
  pen_out[r] = fmaxf(best, 0.f);
  float* p = pts_out + 4 * r;
  p[0] = swap ? p2x : p1x;
  p[1] = swap ? p2y : p1y;
  p[2] = swap ? p1x : p2x;
  p[3] = swap ? p1y : p2y;
  pens_out[2 * r] = swap ? pen2 : pen1;
  pens_out[2 * r + 1] = swap ? pen1 : pen2;
  cval_out[2 * r] = hit && (swap ? ok2 : ok1);
  cval_out[2 * r + 1] = hit && (swap ? ok1 : ok2);
}

namespace {

template <int V>
cudaError_t launch(const float* ap, const float* ac, const float* as,
                   const float* av, const int* an, const float* bp,
                   const float* bc, const float* bs, const float* bv,
                   const int* bn, bool* hit, float* nrm, float* pen,
                   float* pts, float* pens, bool* cval, int N,
                   cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  narrowphase_kernel<V><<<blocks, threads, 0, stream>>>(
      ap, ac, as, av, an, bp, bc, bs, bv, bn, hit, nrm, pen, pts, pens, cval,
      N);
  return cudaGetLastError();
}

}  // namespace

LPE_EXPORT int lpe_narrowphase(const float* a_pos, const float* a_cos,
                               const float* a_sin, const float* a_verts,
                               const int* a_nv, const float* b_pos,
                               const float* b_cos, const float* b_sin,
                               const float* b_verts, const int* b_nv,
                               bool* hit, float* nrm, float* pen, float* pts,
                               float* pens, bool* cval, cudaStream_t stream,
                               const NarrowParams* P) {
  if (P->N <= 0) return (int)cudaSuccess;
#define LPE_NARROW_CASE(VV)                                                  \
  case VV:                                                                   \
    return (int)launch<VV>(a_pos, a_cos, a_sin, a_verts, a_nv, b_pos, b_cos, \
                           b_sin, b_verts, b_nv, hit, nrm, pen, pts, pens,   \
                           cval, P->N, stream);
  switch (P->V) {
    LPE_NARROW_CASE(3)
    LPE_NARROW_CASE(4)
    LPE_NARROW_CASE(5)
    LPE_NARROW_CASE(6)
    LPE_NARROW_CASE(7)
    LPE_NARROW_CASE(8)
    LPE_NARROW_CASE(9)
    LPE_NARROW_CASE(10)
    LPE_NARROW_CASE(11)
    LPE_NARROW_CASE(12)
    LPE_NARROW_CASE(13)
    LPE_NARROW_CASE(14)
    LPE_NARROW_CASE(15)
    LPE_NARROW_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LPE_NARROW_CASE
}
