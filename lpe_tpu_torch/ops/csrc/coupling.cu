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
// What bounds it on the H100, and the design: couple.cuh's couple_rows,
// the block body it shares with the stacked kernel (coupling9.cu), so the
// two give the same bits on one sub-step. In most blocks no particle
// couples (every cell of DAM_BREAK's main path) and the kernel is a copy.
// Its slot source reads cpl first and a slot's occupancy only where cpl >
// 0, and for the copy-through only the six planes that a particle which
// does not couple carries to its outputs (x, y, vx1, vy1, ax, ay); rho, p
// and m are read for the live particles alone, by the thread that takes
// one in the block's live list.
#include "couple.cuh"

namespace {

enum { D10_X = 0, D10_Y, D10_VX, D10_VY, D10_RHO, D10_P, D10_M, D10_OCC,
       D10_AX, D10_AY };

struct Slot10 {
  CoupleIn in;
};

// coupling's slots for couple_rows: the D10 planes in, the six output
// planes out.
struct Src10 {
  using Slot = Slot10;
  const int* __restrict__ cpl;
  const float* __restrict__ d10;
  float* __restrict__ out;

  __device__ __forceinline__ const float* at(const CoupleParams& P, int p,
                                             int k, int c) const {
    return d10 + (size_t)p * 10 * P.K * P.W + (size_t)k * P.W + c;
  }
  __device__ __forceinline__ Slot10 first(const CoupleParams& P, int p,
                                          int k, int c) const {
    const size_t plane = (size_t)P.K * P.W;
    const float* q = at(P, p, k, c);
    Slot10 s{};
    s.in.live = cpl[(size_t)p * P.W + c] > 0 && q[D10_OCC * plane] > 0.f;
    s.in.px = q[D10_X * plane];
    s.in.py = q[D10_Y * plane];
    s.in.vx1 = q[D10_VX * plane];
    s.in.vy1 = q[D10_VY * plane];
    s.in.ax = q[D10_AX * plane];
    s.in.ay = q[D10_AY * plane];
    return s;
  }
  __device__ __forceinline__ Slot10 full(const CoupleParams& P, int p,
                                         int k, int c) const {
    const size_t plane = (size_t)P.K * P.W;
    const float* q = at(P, p, k, c);
    Slot10 s;
    s.in.live = true;
    s.in.px = q[D10_X * plane];
    s.in.py = q[D10_Y * plane];
    s.in.vx1 = q[D10_VX * plane];
    s.in.vy1 = q[D10_VY * plane];
    s.in.rho = q[D10_RHO * plane];
    s.in.pe = q[D10_P * plane];
    s.in.m = q[D10_M * plane];
    s.in.ax = q[D10_AX * plane];
    s.in.ay = q[D10_AY * plane];
    return s;
  }
  __device__ __forceinline__ void store(const CoupleParams& P, int p, int k,
                                        int c, const CoupleOut& r,
                                        const Slot10&) const {
    const size_t plane = (size_t)P.K * P.W;
    const size_t oplane = (size_t)P.rows * plane;   // one output plane
    float* o = out + p * plane + (size_t)k * P.W + c;
    o[0] = r.x;
    o[oplane] = r.y;
    o[2 * oplane] = r.vx;
    o[3 * oplane] = r.vy;
    o[4 * oplane] = r.ax;
    o[5 * oplane] = r.ay;
  }
  __device__ __forceinline__ void zero(const CoupleParams& P, int p, int k,
                                       int c) const {
    const size_t plane = (size_t)P.K * P.W;
    const size_t oplane = (size_t)P.rows * plane;
    float* o = out + p * plane + (size_t)k * P.W + c;
    for (int f = 0; f < 6; ++f) o[f * oplane] = 0.f;
  }
};

}  // namespace

// block: couple_block(K); grid: (column blocks, rows); NS slots a thread.
template <int NS>
__global__ void __launch_bounds__(COUPLE_THREADS)
    coupling_kernel(const int* __restrict__ cpl,
                    const float* __restrict__ fld,
                    const float* __restrict__ big,
                    const float* __restrict__ d10,
                    float* __restrict__ out,
                    float* __restrict__ pl,
                    float* __restrict__ bigp,
                    CoupleParams P) {
  extern __shared__ float red[];
  const Src10 src = {cpl, d10, out};
  couple_rows<NS>(P, fld, big, pl, bigp, red, src);
}

LPE_EXPORT int lpe_coupling(const int* cpl, const float* fld,
                            const float* big, const float* d10, float* out,
                            float* pl, float* bigp, cudaStream_t stream,
                            const CoupleParams* P) {
  if (P->K < 1 || P->K > 64) return (int)cudaErrorInvalidValue;
  const dim3 block = couple_block(P->K);
  const dim3 grid((P->W + BIG_BLOCK_COLS - 1) / BIG_BLOCK_COLS, P->rows);
  if (P->K <= 32)
    coupling_kernel<1><<<grid, block, couple_smem(P), stream>>>(
        cpl, fld, big, d10, out, pl, bigp, *P);
  else
    coupling_kernel<2><<<grid, block, couple_smem(P), stream>>>(
        cpl, fld, big, d10, out, pl, bigp, *P);
  return (int)cudaGetLastError();
}
