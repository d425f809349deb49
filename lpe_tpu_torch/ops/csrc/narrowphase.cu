// Grid-rigid narrowphase, row form: poly-poly SAT + incident-edge clip,
// one thread per candidate row given as two gathered shapes.
//
// Replaces lpe_tpu/ops/pallas_rigid.py:_nphase_kernel (built by
// make_narrowphase) on its own contract: rows of two polygon shapes in,
// (hit, nrm, pen, pts, pens, cval) out. The row's math is narrow.cuh's
// narrow_row, which the grid kernel (narrowphase_grid.cu) shares; the
// rigid tick runs the grid kernel, which reads the body grids by slot
// itself. The plain version is lpe_tpu_torch/ops/rigid_kernels.py
// narrowphase_plain.
//
// Bound on the H100: a row reads pos (8 B), cos, sin, nverts (12 B) and
// V x 2 vertex floats (56 B at V = 7) per side and writes 39 B of results,
// about 190 B a row: the 82,944 rows of a RIGID_STACKS 10k tick are about
// 16 MB, ~5 us at 3.35 TB/s. Its ~1-1.5 kFLOP a row take under 3 us at the
// 67 TFLOP/s fp32 rate, so the kernel is bound by memory. One thread holds
// one row's two rings in registers (loops unrolled by the template on V)
// and nothing is staged in shared memory.
#include "narrow.cuh"

struct NarrowParams {
  int N, V;
};

namespace {

template <int V>
__device__ __forceinline__ void load_ring(
    const float* __restrict__ pos, const float* __restrict__ cs,
    const float* __restrict__ sn, const float* __restrict__ verts,
    const int* __restrict__ nv, long r, Ring<V>& g) {
  build_ring<V>(pos[2 * r], pos[2 * r + 1], cs[r], sn[r],
                verts + r * (2 * V), nv[r], g);
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
  store_row(narrow_row<V>(a, b), r, hit_out, nrm_out, pen_out, pts_out,
            pens_out, cval_out);
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
  LPE_NARROW_SWITCH(P->V, LPE_NARROW_CASE)
#undef LPE_NARROW_CASE
}
