// Split SPH density pass: poly6 density over each particle's 3x3 neighbour
// cells, self term included.
//
// Replaces the Pallas TPU kernel make_density / _density_kernel
// (lpe_tpu/ops/pallas_sph.py:78, built at :1356). Input D4 [rows, 4(x, y,
// m, occ), K, W]; output rho [ny, K, W] over the interior rows, 0 in empty
// slots. The TPU kernel's per-(row, tile) occupancy table only let it skip
// empty tiles; here an empty slot costs one occupancy load.
//
// What bounds it on the H100: memory latency. One thread per (row, slot,
// column), pairs summed in (dy, dx, slot) order through the pair
// arithmetic of sph_pair.cuh, which the pair sweep shares, so the two give
// the same bits; no atomics.
#include "sph_pair.cuh"

__global__ void split_density_kernel(const float* __restrict__ d4,
                                     float* __restrict__ rho, SweepParams P) {
  long idx;
  int p, k, c;
  if (!pair_slot(P, idx, p, k, c)) return;
  const size_t plane = (size_t)P.K * P.W;
  const PairPlanes g = {d4, d4 + plane, d4 + 2 * plane, d4 + 3 * plane,
                        4 * plane};
  rho[idx] = pair_density(g, p, k, c, P);
}

LPE_EXPORT int lpe_density(const float* d4, float* rho, cudaStream_t stream,
                           const SweepParams* P) {
  split_density_kernel<<<pair_grid(P), PAIR_BLOCK, 0, stream>>>(d4, rho, *P);
  return (int)cudaGetLastError();
}
