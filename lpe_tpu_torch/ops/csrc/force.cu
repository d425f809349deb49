// Split SPH force pass: symmetric spiky pressure force and viscosity-
// Laplacian force over each particle's 3x3 neighbour cells.
//
// Replaces the Pallas TPU kernel make_force / _force_kernel
// (lpe_tpu/ops/pallas_sph.py:122, built at :1377). Input D8 [rows, 8(x, y,
// vx, vy, m, rho, p, occ), K, W]: density and pressure arrive as planes
// (the caller ran the density pass and the EOS), unlike the pair sweep,
// which derives the pressure inline. Outputs fx, fy [ny, K, W] over the
// interior rows, 0 in empty slots. The self pair is excluded; a pair counts
// when min_d2 <= r^2 < h^2 and both densities reach min_rho.
//
// What bounds it on the H100: memory latency (eight plane gathers per live
// pair out of L2). One thread per (row, slot, column), pairs summed in
// (dy, dx, slot) order through the pair arithmetic of sph_pair.cuh, which
// the pair sweep shares, so the two give the same bits; no atomics.
#include "sph_pair.cuh"

__global__ void split_force_kernel(const float* __restrict__ d8,
                                   float* __restrict__ fx_out,
                                   float* __restrict__ fy_out,
                                   SweepParams P) {
  long idx;
  int p, k, c;
  if (!pair_slot(P, idx, p, k, c)) return;
  const size_t plane = (size_t)P.K * P.W;
  const PairPlanes g = {d8,           d8 + plane,     d8 + 2 * plane,
                        d8 + 3 * plane, d8 + 4 * plane, d8 + 7 * plane,
                        8 * plane};
  pair_force(g, d8 + 5 * plane, d8 + 6 * plane, 8 * plane, 0, p, k, c, P,
             fx_out[idx], fy_out[idx]);
}

LPE_EXPORT int lpe_force(const float* d8, float* fx, float* fy,
                         cudaStream_t stream, const SweepParams* P) {
  split_force_kernel<<<pair_grid(P), PAIR_BLOCK, 0, stream>>>(d8, fx, fy,
                                                              *P);
  return (int)cudaGetLastError();
}
