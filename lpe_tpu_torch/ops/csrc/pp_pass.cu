// P3M's short-range (PP) pass: each resident body's softened pair force,
// rolled off by 1 - S5((d - r0) / rw), from the residents within rc of its
// (2m+1)^2 neighbour cells, read from a compact cell-sorted layout.
//
// Replaces no TPU kernel: lpe_tpu runs this pass as XLA (lpe_tpu/ops/
// pm_gravity.py make_pp_correction, dense [nc, nc, K, K] slices), with no
// Pallas kernel. It was added because the port's plain PyTorch pass
// (lpe_tpu_torch/ops/pm_gravity.py pp_pass_plain, its plain version)
// gathers a [bodies, 4, K] block of a dense cell table for each of the
// (2m+1)^2 cell offsets and runs ~35 generic launches on it: at the 1M-body
// galaxy (K = 46, m = 2) ~1,750 launches and ~95% of the tick on an H100,
// 1.15e9 slot pairs looked at for ~3.3e8 inside rc.
//
// What bounds it on the H100: operations. A pair inside rc takes two IEEE
// square roots and an IEEE division (the weight), about 40 instructions;
// about twice as many pairs are looked at as lie inside rc (the (2m+1)^2
// cells of width rc/m cover (2m+1)^2/m^2 rc^2 against pi rc^2), each a few
// operations. Device memory moves ~0.1 GB a pass at 1M bodies
// (the layout's 16 B a resident read 2m+1 times, mostly from L2, cstart,
// the [N, 2] result): ~0.03 ms at 3.35 TB/s.
//
// Design:
// - Layout (pm_gravity.py pp_layout): the residents (the first K bodies by
//   index of each cell) in cell order as float4 rows (x, y, m, 0), their
//   body indices, and cstart[ncells + 1], the exclusive scan of
//   min(count, K). Cell ids are row-major (gy * nc + gx), so the cells
//   cx-m .. cx+m of one cell row are one contiguous run of rows, in (dx,
//   rank) order: the plain pass's order within a row of offsets.
// - A block takes a strip of T consecutive cells of one cell row
//   (PPParams.T; pm_gravity.py PP_STRIP_CELLS); its receivers, the strip's
//   residents, are contiguous rows. For each dy it copies the one run that
//   covers cells cx0-m .. cx0+T-1+m of row cy+dy into shared memory, a
//   16-byte load a row; two buffers, so one barrier a row of cells.
// - A thread owns one receiver (stepping over the strip's residents by the
//   block size) and sums in registers over its run of each row: dy, then
//   dx, then slot, in one fixed order. It skips itself and the pairs with
//   d2 >= rc^2, the terms the plain pass sets to exactly 0.
// - The plain pass's float32 arithmetic as PyTorch runs it on the card,
//   compiled with --fmad=false: the ramp's division by rw a product with
//   the float32 reciprocal (PyTorch's tensor / scalar on CUDA), with one
//   change: x^1.5 is x * sqrt(x), within two ulp of PyTorch's powf, which
//   took half the kernel's time (3.05 against 1.51 ms at the 1M galaxy on
//   an H100). Otherwise the roundings differ only by the order of the sum
//   (the plain pass adds each cell offset's K terms as a tree).
// - Each sum goes to out[body]; bodies that are not resident keep the
//   caller's zeros. No atomics: each sum is one thread's, in one order, so
//   the bits repeat from run to run.
// - Over a mesh of devices each device takes a contiguous run of strips
//   (PPParams.s0, strips) on its own copy of the layout.
#include "common.cuh"

// mirrors lpe_tpu_torch/ops/_build.py PPParams field for field
struct PPParams {
  int m, nc, K, T, s0, strips, threads;
  float rc2, r0, inv_rw, soft2;
};

namespace {

constexpr int PP_MAX_THREADS = 512;

// the plain pass's _smoothstep5 on u clamped to [0, 1], in its order of
// operations
__device__ __forceinline__ float smoothstep5(float u) {
  u = clampf(u, 0.f, 1.f);
  return u * u * u * (u * (u * 6.f - 15.f) + 10.f);
}

}  // namespace

// Global namespace: profilers name it pp_pass_kernel<M>.
template <int M>
__global__ void __launch_bounds__(PP_MAX_THREADS) pp_pass_kernel(
    const float4* __restrict__ rows, const int* __restrict__ body,
    const int* __restrict__ cstart, float2* __restrict__ out, PPParams p) {
  extern __shared__ float4 stage[];   // two buffers of (T + 2M) * K rows
  const int nc = p.nc, T = p.T;
  const int span = (T + 2 * M) * p.K;
  const int per_row = (nc + T - 1) / T;
  const int strip = p.s0 + blockIdx.x;
  const int cy = strip / per_row;
  const int cx0 = (strip - cy * per_row) * T;
  const int cx1 = min(cx0 + T, nc);
  const int* own = cstart + cy * nc;          // this cell row's starts
  const int r_lo = own[cx0], r_hi = own[cx1];
  if (r_lo == r_hi) return;                   // no resident in the strip
  const int lo = max(cx0 - M, 0), hi = min(cx1 + M, nc);   // staged cells
  const int y_lo = max(cy - M, 0), y_hi = min(cy + M + 1, nc);
  int buf = 0;
  for (int base = r_lo; base < r_hi; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool live = i < r_hi;
    float xi = 0.f, yi = 0.f;
    int a_c = lo, b_c = lo;         // the receiver's source cells [a_c, b_c)
    if (live) {
      const float4 q = rows[i];
      xi = q.x;
      yi = q.y;
      int c = cx0;
      while (own[c + 1] <= i) ++c;            // the receiver's cell
      a_c = max(c - M, 0);
      b_c = min(c + M + 1, nc);
    }
    float ax = 0.f, ay = 0.f;
    for (int y = y_lo; y < y_hi; ++y) {
      // the run of cells lo .. hi-1 of row y; the buffer written here was
      // last read two rows ago, before every thread passed the barrier
      // of the previous row
      const int* ys = cstart + y * nc;
      const int s0 = ys[lo], n = ys[hi] - s0;
      float4* src = stage + buf * span;
      for (int t = threadIdx.x; t < n; t += blockDim.x) src[t] = rows[s0 + t];
      __syncthreads();
      if (live) {
        const int self = i - s0;    // inside [a, b) in the receiver's row only
        const int b = ys[b_c] - s0;
        for (int j = ys[a_c] - s0; j < b; ++j) {
          const float4 q = src[j];
          const float dx = q.x - xi;
          const float dy = q.y - yi;
          const float d2 = dx * dx + dy * dy;
          if (d2 < p.rc2 && j != self) {
            const float s = fmaxf(d2 + p.soft2, 1e-30f);
            const float w =
                (1.f - smoothstep5((sqrtf(d2) - p.r0) * p.inv_rw)) /
                (s * sqrtf(s));
            const float wm = q.z * w;
            ax += wm * dx;
            ay += wm * dy;
          }
        }
      }
      buf ^= 1;
    }
    if (live) out[body[i]] = make_float2(ax, ay);
  }
}

namespace {

template <int M>
cudaError_t launch_pp(const float4* rows, const int* body, const int* cstart,
                      float2* out, cudaStream_t stream, const PPParams& p) {
  const int smem = 2 * (p.T + 2 * M) * p.K * (int)sizeof(float4);
  static int smem_set[MAX_DEVICES] = {};   // allowed so far, by device
  const cudaError_t err = allow_smem(pp_pass_kernel<M>, smem, smem_set);
  if (err != cudaSuccess) return err;
  pp_pass_kernel<M><<<p.strips, p.threads, smem, stream>>>(rows, body,
                                                          cstart, out, p);
  return cudaGetLastError();
}

}  // namespace

// rows [N + 1, 4] float32, body [N + 1] int32, cstart [nc * nc + 1] int32
// (pm_gravity.py pp_layout); out [N, 2] float32, zeroed by the caller;
// strips s0 .. s0 + strips - 1 of the nc * ceil(nc / T) strips
LPE_EXPORT int lpe_pp_pass(const float* rows, const int* body,
                           const int* cstart, float* out,
                           cudaStream_t stream, const PPParams* P) {
  const int per_row = P->T > 0 ? (P->nc + P->T - 1) / P->T : 0;
  if (P->nc < 1 || P->K < 1 || P->T < 1 || P->s0 < 0 || P->strips < 1 ||
      P->s0 + P->strips > P->nc * per_row || P->threads < 32 ||
      P->threads > PP_MAX_THREADS || P->threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const float4* r = reinterpret_cast<const float4*>(rows);
  float2* o = reinterpret_cast<float2*>(out);
  switch (P->m) {
    case 1:
      return (int)launch_pp<1>(r, body, cstart, o, stream, *P);
    case 2:
      return (int)launch_pp<2>(r, body, cstart, o, stream, *P);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
