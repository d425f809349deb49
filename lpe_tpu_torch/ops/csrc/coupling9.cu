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
// What bounds it on the H100: in most blocks, bytes. Where no particle of
// a block couples (every cell of DAM_BREAK's main path: its boundary
// margin keeps the fluid off the walls) the kernel is a copy: seven M9
// planes and rho, fx, fy in, nine ST planes and zero partials out. Where
// particles couple, the latency and divergence of the per-candidate math
// (a few hundred float32 operations with sqrt, tanh, pow and divides per
// particle and candidate) and the candidate-parameter loads.
//
// Design: a block is one row, BIG_BLOCK_COLS columns and all K slots (K <=
// 32), one thread per (slot, column), columns fastest, so every load and
// store of a plane is coalesced.
// - One block-wide vote (__syncthreads_count) over the threads' `live`
//   flags. A block with none takes a straight copy-through: second kick,
//   EOS, floor clamp (couple_fin with no candidate), the nine ST planes and
//   zero partials; no candidate loop, barrier or reduction.
// - Otherwise the block lists its live slots (a ballot per warp) and the
//   first nlive threads take one live particle each, so the candidate math
//   runs in full warps. A candidate with no live particle in its box is
//   skipped by the block (__syncthreads_or, the TPU kernel's per-tile skip).
// - The partials are summed as the split kernel (coupling.cu) sums them:
//   per column over the K slots in slot order (empty slots hold +0), then
//   per block over the columns in order; each particle sums its candidates
//   in candidate order through couple.cuh's cand_math, cand_add and
//   couple_fin. ST, PL and bigp equal coupling.cu's on the same sub-step to
//   the bit, never with float atomics.
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

// Shared memory of a block: floats red[3][K][BIG_BLOCK_COLS] and
// colsum[3][BIG_BLOCK_COLS], ints list[K * BIG_BLOCK_COLS] and
// count[BIG_BLOCK_COLS].
inline size_t coupling9_smem(const CoupleParams* P) {
  const size_t kc = (size_t)P->K * BIG_BLOCK_COLS;
  return (3 * kc + 3 * BIG_BLOCK_COLS + kc + BIG_BLOCK_COLS) * 4;
}

}  // namespace

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
  const int K = P.K, W = P.W, S = P.S, NBIG = P.NBIG, Wp = P.Wp;
  const int KC = K * BIG_BLOCK_COLS;
  const int tx = threadIdx.x, k = threadIdx.y;
  const int t = k * BIG_BLOCK_COLS + tx;     // warp k, lane tx
  const int c0 = blockIdx.x * BIG_BLOCK_COLS;
  const int c = c0 + tx;
  const int p = blockIdx.y;
  const bool col_ok = c < W;
  const size_t plane = (size_t)K * W;

  if (p == 0 || p == P.rows - 1) {          // apron rows: all zero
    if (col_ok)
      for (int f = 0; f < 9; ++f)
        st[(size_t)p * 9 * plane + f * plane + (size_t)k * W + c] = 0.f;
    couple_zero_partials(P, pl, bigp, p, c, col_ok);
    return;
  }

  Slot9 me = {{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false}, 0.f,
              0.f};
  if (col_ok) me = load_slot9(cpl, m9, rho, fxr, fyr, P, p, k, c);
  float* red_x = red;
  float* red_y = red + KC;
  float* red_t = red + 2 * KC;
  float* colsum = red + 3 * KC;                // [3][BIG_BLOCK_COLS]
  int* list = reinterpret_cast<int*>(colsum + 3 * BIG_BLOCK_COLS);
  int* count = list + KC;                      // live slots per warp
  const unsigned ball = __ballot_sync(0xffffffffu, me.in.live);
  if (tx == 0) count[k] = __popc(ball);
  const int nlive = __syncthreads_count(me.in.live);

  if (nlive == 0) {                           // copy-through block
    couple_zero_partials(P, pl, bigp, p, c, col_ok);
    if (col_ok) {
      const CoupleAcc none = {0.f, 0.f, 0.f, 0.f, false, false};
      store_st9(st, P, p, k, c, couple_fin(P, none, me.in), me);
    }
    return;
  }

  // the live slots, slot-major: thread i < nlive takes list[i]
  if (me.in.live) {
    int base = 0;
    for (int w = 0; w < k; ++w) base += count[w];
    list[base + __popc(ball & ((1u << tx) - 1u))] = t;
  }
  red_x[t] = 0.f;                             // empty slots sum as +0
  red_y[t] = 0.f;
  red_t[t] = 0.f;
  __syncthreads();
  const bool has = t < nlive;
  int ridx = 0, ic = 0, ik = 0;
  Slot9 it = me;
  Hoist hp = {0.f, 0.f, 0.f};
  CoupleAcc acc = {0.f, 0.f, 0.f, 0.f, false, false};
  if (has) {
    ridx = list[t];
    ik = ridx / BIG_BLOCK_COLS;
    ic = c0 + ridx % BIG_BLOCK_COLS;
    it = load_slot9(cpl, m9, rho, fxr, fyr, P, p, ik, ic);
    hp = hoist(P, it.in.py, it.in.rho, it.in.pe, it.in.m);
  }
  const CoupleIn& in = it.in;
  // a listed particle against one candidate (parameter i at prm[i *
  // stride]): its sums, and its force and torque into the slot's red entry
  // (+0 where the particle is not in the candidate's box)
  auto add_cand = [&](const float* prm, int stride, bool inb) {
    Cand r = {false, false, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (inb) {
      r = cand_math(P, prm, stride, true, in.px, in.py, in.vx1, in.vy1, hp);
      cand_add(acc, r);
    }
    red_x[ridx] = r.fx;
    red_y[ridx] = r.fy;
    red_t[ridx] = r.tq;
  };

  // rasterized per-cell candidates: one column's slot s shares its params
  for (int s = 0; s < S; ++s) {
    const float* prm = fld + ((size_t)(p * S + s) * Wp) * W + ic;
    const bool inb = has && in_box(prm, W, in.px, in.py, true);
    float* o = pl + ((size_t)p * 3 * S + 3 * s) * W + c;
    if (!__syncthreads_or(inb)) {
      if (k == 0 && col_ok) o[0] = o[W] = o[2 * W] = 0.f;
      continue;
    }
    if (has) add_cand(prm, W, inb);
    __syncthreads();
    if (k == 0 && col_ok) {                   // fixed-order sum over slots
      float a = 0.f, b = 0.f, q = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        a = a + red_x[kk * BIG_BLOCK_COLS + tx];
        b = b + red_y[kk * BIG_BLOCK_COLS + tx];
        q = q + red_t[kk * BIG_BLOCK_COLS + tx];
      }
      o[0] = a;
      o[W] = b;
      o[2 * W] = q;
    }
    __syncthreads();
  }

  // big solids: one dense parameter row each, shared by the whole block
  const int NB = gridDim.x;
  for (int bi = 0; bi < NBIG; ++bi) {
    const float* prm = big + (size_t)bi * Wp;
    const bool inb = has && in_box(prm, 1, in.px, in.py, true);
    float* o = bigp + ((size_t)p * NB + blockIdx.x) * 3 * NBIG + 3 * bi;
    if (!__syncthreads_or(inb)) {
      if (t == 0) o[0] = o[1] = o[2] = 0.f;
      continue;
    }
    if (has) add_cand(prm, 1, inb);
    __syncthreads();
    if (k == 0) {                             // per column over K, in order
      float a = 0.f, b = 0.f, q = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        a = a + red_x[kk * BIG_BLOCK_COLS + tx];
        b = b + red_y[kk * BIG_BLOCK_COLS + tx];
        q = q + red_t[kk * BIG_BLOCK_COLS + tx];
      }
      colsum[tx] = a;
      colsum[BIG_BLOCK_COLS + tx] = b;
      colsum[2 * BIG_BLOCK_COLS + tx] = q;
    }
    __syncthreads();
    if (t == 0) {                             // then over the columns
      float a = 0.f, b = 0.f, q = 0.f;
      for (int cc = 0; cc < BIG_BLOCK_COLS; ++cc) {
        a = a + colsum[cc];
        b = b + colsum[BIG_BLOCK_COLS + cc];
        q = q + colsum[2 * BIG_BLOCK_COLS + cc];
      }
      o[0] = a;
      o[1] = b;
      o[2] = q;
    }
    __syncthreads();
  }

  if (has)
    store_st9(st, P, p, ik, ic, couple_fin(P, acc, in), it);
  if (col_ok && !me.in.live) {
    const CoupleAcc none = {0.f, 0.f, 0.f, 0.f, false, false};
    store_st9(st, P, p, k, c, couple_fin(P, none, me.in), me);
  }
}

LPE_EXPORT int lpe_coupling9(const int* cpl, const float* fld,
                             const float* big, const float* m9,
                             const float* rho, const float* fx,
                             const float* fy, float* st, float* pl,
                             float* bigp, cudaStream_t stream,
                             const CoupleParams* P) {
  dim3 block(BIG_BLOCK_COLS, P->K);
  dim3 grid((P->W + BIG_BLOCK_COLS - 1) / BIG_BLOCK_COLS, P->rows);
  coupling9_kernel<<<grid, block, coupling9_smem(P), stream>>>(
      cpl, fld, big, m9, rho, fx, fy, st, pl, bigp, *P);
  return (int)cudaGetLastError();
}
