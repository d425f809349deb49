// SPH pair sweep: poly6 density, EOS pressure, spiky pressure force and
// viscosity-Laplacian force over each particle's 3x3 neighbour cells.
//
// Replaces the Pallas TPU kernel make_pair_sweep(F=9) / _sweep_kernel
// (lpe_tpu/ops/pallas_sph.py:804, built at :1058). Input M9 [rows, 9, K,
// W]; outputs rho, fx, fy [ny, K, W] over the interior rows.
//
// What bounds it on the H100: memory latency. Per particle it visits 9
// cells x K slots, skips the empty ones on one occupancy load, and spends
// ~30 float32 flops per live pair; the grid (~40 MB at 100k particles)
// stays in the 50 MB L2 between the two launches, so the loads are L2
// hits and the work is latency-bound gathers, far from the compute roof.
//
// Design: the TPU kernel ran its rows in order and kept rho in a rolling
// on-chip ring. Blocks on the H100 run in no order, so the sweep is two
// launches on one stream: density first (with the self term), then forces,
// which read the neighbours' rho and derive their pressure inline. One
// thread per (row, slot, column), columns fastest, so a warp's loads of a
// plane are contiguous. Each thread sums its pairs in a fixed order
// (dy, dx, slot): deterministic, no atomics. The pair arithmetic itself is
// sph_pair.cuh's, which the split density and force kernels share.
#include "sph_pair.cuh"

namespace {

__device__ __forceinline__ PairPlanes m9_planes(const float* m9,
                                                const SweepParams& P) {
  const size_t plane = (size_t)P.K * P.W;
  return {m9 + M9_X * plane,  m9 + M9_Y * plane, m9 + M9_VX * plane,
          m9 + M9_VY * plane, m9 + M9_M * plane, m9 + M9_OCC * plane,
          9 * plane};
}

}  // namespace

__global__ void density_kernel(const float* __restrict__ m9,
                               float* __restrict__ rho, SweepParams P) {
  long idx;
  int p, k, c;
  if (!pair_slot(P, idx, p, k, c)) return;
  rho[idx] = pair_density(m9_planes(m9, P), p, k, c, P);
}

__global__ void force_kernel(const float* __restrict__ m9,
                             const float* __restrict__ rho,
                             float* __restrict__ fx_out,
                             float* __restrict__ fy_out, SweepParams P) {
  long idx;
  int p, k, c;
  if (!pair_slot(P, idx, p, k, c)) return;
  // rho holds the interior rows only: grid row p is its row p - 1
  pair_force<true>(m9_planes(m9, P), rho, nullptr, (size_t)P.K * P.W, 1, p,
                   k, c, P, fx_out[idx], fy_out[idx]);
}

LPE_EXPORT int lpe_pair_sweep(const float* m9, float* rho, float* fx,
                              float* fy, cudaStream_t stream,
                              const SweepParams* P) {
  const unsigned grid = pair_grid(P);
  density_kernel<<<grid, PAIR_BLOCK, 0, stream>>>(m9, rho, *P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  force_kernel<<<grid, PAIR_BLOCK, 0, stream>>>(m9, rho, fx, fy, *P);
  return (int)cudaGetLastError();
}
