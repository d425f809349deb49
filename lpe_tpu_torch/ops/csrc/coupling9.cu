// Second kick + two-way fluid <-> rigid coupling on the SPH grid state.
//
// Replaces the Pallas TPU kernel make_coupling9 / _coupling9_kernel
// (lpe_tpu/ops/pallas_sph.py:664, built at :739; its math in _couple_rows
// :488, _cand_math :290, _couple_fin :449, hoist_particle_terms :266).
// Inputs: cpl [rows, W] int32 (0 = copy the cell through), fld [rows, S,
// Wp, W] (the <= S rigids rasterized to each cell), big [NBIG+1, Wp] (the
// big solids), M9 [rows, 9, K, W] and the sweep's rho, fx, fy [ny, K, W].
// Outputs: the next sub-step's ST [rows, 9, K, W], the force partials PL
// [rows, 3S, W] (per row, slot and column, summed over the column's K
// slots) and the big-solid sums bigp [rows, NB, 3 NBIG] per row and block
// of BIG_BLOCK_COLS columns.
//
// What bounds it on the H100: instruction latency and divergence in the
// per-candidate math (a few hundred float32 flops with sqrt, tanh, pow and
// divides per particle and candidate), then the candidate-parameter loads
// (up to S x Wp floats per column, shared by the column's K threads). The
// tensor cores have no part in it.
//
// Design: one thread per (row, slot, column); a block is one row, 32
// columns and all K slots (K <= 32), laid out columns-fastest so each warp
// reads contiguous columns. The TPU kernel skipped a candidate when no lane
// of its tile was inside the candidate's AABB; here __syncthreads_or makes
// the same skip per block and candidate. The per-(row, slot, column)
// partials and the per-block big-solid sums are reduced in shared memory
// in a fixed order (never float atomics), so one seed gives bitwise one
// result. The candidate loops and the finalization are couple.cuh's, which
// the split coupling kernel (coupling.cu) shares; this kernel adds the
// second kick and EOS before them and emits the 9-plane stack after.
#include "couple.cuh"

// block: (BIG_BLOCK_COLS columns, K slots); grid: (column blocks, rows).
__global__ void coupling9_kernel(const int* __restrict__ cpl,
                                 const float* __restrict__ fld,
                                 const float* __restrict__ big,
                                 const float* __restrict__ m9,
                                 const float* __restrict__ rho,
                                 const float* __restrict__ fxr,
                                 const float* __restrict__ fyr,
                                 float* __restrict__ st,
                                 float* __restrict__ pl,
                                 float* __restrict__ bigp, CoupleParams P) {
  extern __shared__ float red[];
  const int K = P.K, W = P.W;
  const int k = threadIdx.y;
  const int c = blockIdx.x * BIG_BLOCK_COLS + threadIdx.x;
  const int p = blockIdx.y;
  const bool col_ok = c < W;
  const size_t plane = (size_t)K * W;
  const size_t rs = 9 * plane;
  const size_t at = (size_t)k * W + c;

  if (p == 0 || p == P.rows - 1) {          // apron rows: all zero
    if (col_ok)
      for (int f = 0; f < 9; ++f) st[p * rs + f * plane + at] = 0.f;
    couple_zero_partials(P, pl, bigp, p, c, col_ok);
    return;
  }

  // second kick + EOS (metal:428-441)
  const float* q = m9 + p * rs + at;
  const size_t ri = (size_t)(p - 1) * plane + at;
  CoupleIn in = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false};
  float occ = 0.f, pid = 0.f;
  if (col_ok) {
    in.px = q[M9_X * plane];
    in.py = q[M9_Y * plane];
    in.m = q[M9_M * plane];
    occ = q[M9_OCC * plane];
    pid = q[M9_ID * plane];
    in.ax = fxr[ri];
    in.ay = fyr[ri];
    in.rho = rho[ri];
    in.vx1 = q[M9_HX * plane] + P.half_dt * in.ax;
    in.vy1 = q[M9_HY * plane] + P.half_dt * in.ay;
    in.pe = eos(in.rho, P.stiffness, P.rest_density);
    in.live = occ > 0.f && cpl[(size_t)p * W + c] > 0;
  }
  const CoupleOut out =
      couple_block(P, fld, big, pl, bigp, red, p, c, col_ok, in);
  if (!col_ok) return;
  float* o = st + p * rs + at;
  o[ST_X * plane] = out.x;
  o[ST_Y * plane] = out.y;
  o[ST_VX * plane] = out.vx;
  o[ST_VY * plane] = out.vy;
  o[ST_AX * plane] = out.ax;
  o[ST_AY * plane] = out.ay;
  o[ST_M * plane] = in.m;
  o[ST_ID * plane] = pid;
  o[ST_OCC * plane] = occ;
}

LPE_EXPORT int lpe_coupling9(const int* cpl, const float* fld,
                             const float* big, const float* m9,
                             const float* rho, const float* fx,
                             const float* fy, float* st, float* pl,
                             float* bigp, cudaStream_t stream,
                             const CoupleParams* P) {
  dim3 block(BIG_BLOCK_COLS, P->K);
  dim3 grid((P->W + BIG_BLOCK_COLS - 1) / BIG_BLOCK_COLS, P->rows);
  coupling9_kernel<<<grid, block, couple_smem(P), stream>>>(
      cpl, fld, big, m9, rho, fx, fy, st, pl, bigp, *P);
  return (int)cudaGetLastError();
}
