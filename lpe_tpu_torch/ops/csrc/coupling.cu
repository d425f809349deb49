// Two-way fluid <-> rigid coupling on unstacked particle planes.
//
// Replaces the Pallas TPU kernel make_coupling / _coupling_kernel
// (lpe_tpu/ops/pallas_sph.py:554, built at :608; its math in _couple_rows
// :488, _cand_math :290, _couple_fin :449, hoist_particle_terms :266).
// Inputs: cpl [rows, W] int32 (0 = copy the cell through), fld [rows, S,
// Wp, W] (the <= S rigids rasterized to each cell), big [NBIG+1, Wp] (the
// big solids) and D10 [rows, 10(x, y, vx1, vy1, rho, p, m, occ, ax, ay), K,
// W]: the velocity after the second kick, the density, the pressure and the
// pair acceleration arrive as planes (the stacked kernel, coupling9.cu,
// computes the kick and the EOS itself). Outputs: out [6(x, y, vx, vy, ax,
// ay), rows, K, W], the force partials PL [rows, 3S, W] (per row, slot and
// column, summed over the column's K slots) and the big-solid sums bigp
// [rows, NB, 3 NBIG] per row and block of BIG_BLOCK_COLS columns. Cells
// with cpl == 0 are copied through; a position below 0 is set to the
// boundary offset in every slot (lpe_tpu applies this floor clamp to the
// kernel's output, sph.py:1060-1062). Apron rows are zero.
//
// What bounds it on the H100: as coupling9.cu, the latency and divergence
// of the per-candidate math, then the candidate-parameter loads.
//
// Design: the block layout, the per-block candidate skip and the fixed-order
// shared-memory reductions are couple.cuh's, shared with coupling9.cu.
#include "couple.cuh"

enum { D10_X = 0, D10_Y, D10_VX, D10_VY, D10_RHO, D10_P, D10_M, D10_OCC,
       D10_AX, D10_AY };

// block: (BIG_BLOCK_COLS columns, K slots); grid: (column blocks, rows).
__global__ void coupling_kernel(const int* __restrict__ cpl,
                                const float* __restrict__ fld,
                                const float* __restrict__ big,
                                const float* __restrict__ d10,
                                float* __restrict__ out,
                                float* __restrict__ pl,
                                float* __restrict__ bigp, CoupleParams P) {
  extern __shared__ float red[];
  const int K = P.K, W = P.W;
  const int k = threadIdx.y;
  const int c = blockIdx.x * BIG_BLOCK_COLS + threadIdx.x;
  const int p = blockIdx.y;
  const bool col_ok = c < W;
  const size_t plane = (size_t)K * W;
  const size_t at = (size_t)k * W + c;
  const size_t oplane = (size_t)P.rows * plane;   // one output plane
  float* o = out + p * plane + at;

  if (p == 0 || p == P.rows - 1) {          // apron rows: all zero
    if (col_ok)
      for (int f = 0; f < 6; ++f) o[f * oplane] = 0.f;
    couple_zero_partials(P, pl, bigp, p, c, col_ok);
    return;
  }

  const float* q = d10 + p * 10 * plane + at;
  CoupleIn in = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false};
  if (col_ok) {
    in.px = q[D10_X * plane];
    in.py = q[D10_Y * plane];
    in.vx1 = q[D10_VX * plane];
    in.vy1 = q[D10_VY * plane];
    in.rho = q[D10_RHO * plane];
    in.pe = q[D10_P * plane];
    in.m = q[D10_M * plane];
    in.ax = q[D10_AX * plane];
    in.ay = q[D10_AY * plane];
    in.live = q[D10_OCC * plane] > 0.f && cpl[(size_t)p * W + c] > 0;
  }
  const CoupleOut r =
      couple_block(P, fld, big, pl, bigp, red, p, c, col_ok, in);
  if (!col_ok) return;
  o[0] = r.x;
  o[oplane] = r.y;
  o[2 * oplane] = r.vx;
  o[3 * oplane] = r.vy;
  o[4 * oplane] = r.ax;
  o[5 * oplane] = r.ay;
}

LPE_EXPORT int lpe_coupling(const int* cpl, const float* fld,
                            const float* big, const float* d10, float* out,
                            float* pl, float* bigp, cudaStream_t stream,
                            const CoupleParams* P) {
  dim3 block(BIG_BLOCK_COLS, P->K);
  dim3 grid((P->W + BIG_BLOCK_COLS - 1) / BIG_BLOCK_COLS, P->rows);
  coupling_kernel<<<grid, block, couple_smem(P), stream>>>(
      cpl, fld, big, d10, out, pl, bigp, *P);
  return (int)cudaGetLastError();
}
