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
// What bounds it on the H100, and the design: couple.cuh's couple_rows,
// the block body it shares with the split kernel (coupling.cu). In most
// blocks no particle couples (every cell of DAM_BREAK's main path) and the
// kernel is a copy: seven M9 planes and rho, fx, fy in, nine ST planes and
// zero partials out. Its slot source loads a slot's M9 planes and the
// sweep's results whole, with the second kick and the EOS, for the
// copy-through and the candidate math alike, and stores the nine ST
// planes. ST, PL and bigp equal coupling.cu's on the same sub-step to the
// bit.
#include "couple.cuh"

namespace {

// A slot of M9 with the sweep's results: the coupling's input after the
// second kick and EOS, and the planes the stack carries through.
struct Slot9 {
  CoupleIn in;
  float occ, pid;
};

__device__ __forceinline__ Slot9 load_slot9(
    const int* __restrict__ cpl, const float* __restrict__ m9,
    const float* __restrict__ rho, const float* __restrict__ fxr,
    const float* __restrict__ fyr, const CoupleParams& P, int p, int k,
    int c) {
  const size_t plane = (size_t)P.K * P.W;
  const size_t at = (size_t)k * P.W + c;
  const float* q = m9 + (size_t)p * 9 * plane + at;
  const size_t ri = (size_t)(p - 1) * plane + at;
  Slot9 s;
  s.in.px = q[M9_X * plane];
  s.in.py = q[M9_Y * plane];
  s.in.m = q[M9_M * plane];
  s.occ = q[M9_OCC * plane];
  s.pid = q[M9_ID * plane];
  s.in.ax = fxr[ri];
  s.in.ay = fyr[ri];
  s.in.rho = rho[ri];
  s.in.vx1 = q[M9_HX * plane] + P.half_dt * s.in.ax;
  s.in.vy1 = q[M9_HY * plane] + P.half_dt * s.in.ay;
  s.in.pe = eos(s.in.rho, P.stiffness, P.rest_density);
  s.in.live = s.occ > 0.f && cpl[(size_t)p * P.W + c] > 0;
  return s;
}

__device__ __forceinline__ void store_st9(float* __restrict__ st,
                                          const CoupleParams& P, int p,
                                          int k, int c, const CoupleOut& out,
                                          const Slot9& s) {
  const size_t plane = (size_t)P.K * P.W;
  float* o = st + (size_t)p * 9 * plane + (size_t)k * P.W + c;
  o[ST_X * plane] = out.x;
  o[ST_Y * plane] = out.y;
  o[ST_VX * plane] = out.vx;
  o[ST_VY * plane] = out.vy;
  o[ST_AX * plane] = out.ax;
  o[ST_AY * plane] = out.ay;
  o[ST_M * plane] = s.in.m;
  o[ST_ID * plane] = s.pid;
  o[ST_OCC * plane] = s.occ;
}

// coupling9's slots for couple_rows: a slot of M9 with the sweep's
// results, stored as the nine ST planes.
struct Src9 {
  using Slot = Slot9;
  const int* __restrict__ cpl;
  const float *__restrict__ m9, *__restrict__ rho, *__restrict__ fxr,
      *__restrict__ fyr;
  float* __restrict__ st;

  __device__ __forceinline__ Slot9 first(const CoupleParams& P, int p, int k,
                                         int c) const {
    return load_slot9(cpl, m9, rho, fxr, fyr, P, p, k, c);
  }
  __device__ __forceinline__ Slot9 full(const CoupleParams& P, int p, int k,
                                        int c) const {
    return first(P, p, k, c);
  }
  __device__ __forceinline__ void store(const CoupleParams& P, int p, int k,
                                        int c, const CoupleOut& out,
                                        const Slot9& s) const {
    store_st9(st, P, p, k, c, out, s);
  }
  __device__ __forceinline__ void zero(const CoupleParams& P, int p, int k,
                                       int c) const {
    const size_t plane = (size_t)P.K * P.W;
    for (int f = 0; f < 9; ++f)
      st[(size_t)p * 9 * plane + f * plane + (size_t)k * P.W + c] = 0.f;
  }
};

}  // namespace

// block: couple_block(K); grid: (column blocks, rows); NS slots a thread.
template <int NS>
__global__ void __launch_bounds__(COUPLE_THREADS)
    coupling9_kernel(const int* __restrict__ cpl,
                     const float* __restrict__ fld,
                     const float* __restrict__ big,
                     const float* __restrict__ m9,
                     const float* __restrict__ rho,
                     const float* __restrict__ fxr,
                     const float* __restrict__ fyr,
                     float* __restrict__ st,
                     float* __restrict__ pl,
                     float* __restrict__ bigp,
                     CoupleParams P) {
  extern __shared__ float red[];
  const Src9 src = {cpl, m9, rho, fxr, fyr, st};
  couple_rows<NS>(P, fld, big, pl, bigp, red, src);
}

LPE_EXPORT int lpe_coupling9(const int* cpl, const float* fld,
                             const float* big, const float* m9,
                             const float* rho, const float* fx,
                             const float* fy, float* st, float* pl,
                             float* bigp, cudaStream_t stream,
                             const CoupleParams* P) {
  if (P->K < 1 || P->K > 64) return (int)cudaErrorInvalidValue;
  const dim3 block = couple_block(P->K);
  const dim3 grid((P->W + BIG_BLOCK_COLS - 1) / BIG_BLOCK_COLS, P->rows);
  if (P->K <= 32)
    coupling9_kernel<1><<<grid, block, couple_smem(P), stream>>>(
        cpl, fld, big, m9, rho, fx, fy, st, pl, bigp, *P);
  else
    coupling9_kernel<2><<<grid, block, couple_smem(P), stream>>>(
        cpl, fld, big, m9, rho, fx, fy, st, pl, bigp, *P);
  return (int)cudaGetLastError();
}
