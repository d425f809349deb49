// Staging of a grid row's live slots in shared memory, shared by the
// kernels whose blocks walk the rows of a column tile: the pair sweep
// (pair_sweep.cu), the split density and force passes (density.cu,
// force.cu) and migrate (migrate.cu).
//
// A block stages the window of WIN columns (its tile plus halo columns,
// window cell l at column cw + l) of one row of a stack [rows, F, K, W]:
// 1. RowOcc::load: the occupancy of the window, coalesced along W, into
//    registers (element i = tid + e * nthr: slot i / WIN of window cell
//    i % WIN), issued one row ahead so that the load is in flight while
//    the block computes; RowOcc::to_mask: one bit per live slot in a mask
//    per window cell;
// 2. stage_scan: the exclusive prefix of the cells' live counts: a cell's
//    entries start at start[l], the row holds start[WIN];
// 3. stage_live: f(e, k, l, c) for each live slot k of window cell l
//    (column c), with its compacted entry e: cell by cell, in slot order
//    within a cell, so the cells l-1 .. l+1 of a row are one contiguous
//    run of entries in (dx, slot) order.
// An empty slot is read no further than its occupancy, so what it holds
// never reaches an output.
//
// A mask word holds one bit a slot of a window cell: ``unsigned`` for
// K <= 32 (the dam's K = 16 included), ``unsigned long long`` for 33 <= K
// <= 64, the reference's cap (lpe_tpu/core/constants.py MAX_PER_CELL). The
// kernels instantiate one tier each; the 32-bit one is the code that the
// K <= 32 path always ran.
#pragma once

#include "common.cuh"

__device__ __forceinline__ int popc(unsigned v) { return __popc(v); }
__device__ __forceinline__ int popc(unsigned long long v) {
  return __popcll(v);
}

// The K tier of a staged kernel whose blocks own TILE columns and stage
// HALO more a side, with THREADS threads: up to K = 32 a 32-bit mask word
// and 32 columns; from 33 to 64 a 64-bit word and 16 columns, so that a
// row's window of K x WIN entries is no larger than at K = 32 (the sweep's
// 1,280 against 1,152): the same occupancy registers a thread, and shared
// memory within the 227 KB a block may have.
template <class Mask, int HALO, int THREADS>
struct StageTier {
  static constexpr int KMAX = 8 * (int)sizeof(Mask);   // slots a word holds
  static constexpr int TILE = KMAX == 32 ? 32 : 16;     // columns a block owns
  static constexpr int WIN = TILE + 2 * HALO;           // staged columns
  static constexpr int OCC = (KMAX * WIN + THREADS - 1) / THREADS;
  static_assert(OCC <= 5, "a row's window in five occupancies a thread");
};

// The occupancy of one row's window, held in registers.
template <int WIN, int NOCC>
struct RowOcc {
  float v[NOCC];

  // ``occ``: the occupancy plane of the row (slot 0, column 0), or null
  // for a row outside the grid, which stages as empty.
  __device__ __forceinline__ void load(const float* __restrict__ occ, int K,
                                       int W, int cw) {
    const int tid = threadIdx.x, nthr = blockDim.x;
#pragma unroll
    for (int e = 0; e < NOCC; ++e) {
      const int i = tid + e * nthr;
      const int k = i / WIN, c = cw + i - k * WIN;
      v[e] = 0.f;
      if (occ != nullptr && k < K && c >= 0 && c < W)
        v[e] = occ[(size_t)k * W + c];
    }
  }

  // Bit k of mask[l] for each live slot (the mask was zeroed before).
  template <class Mask>
  __device__ __forceinline__ void to_mask(Mask* mask) const {
    const int tid = threadIdx.x, nthr = blockDim.x;
#pragma unroll
    for (int e = 0; e < NOCC; ++e)
      if (v[e] > 0.f) {
        const int i = tid + e * nthr;
        const int k = i / WIN;
        atomicOr(&mask[i - k * WIN], Mask(1) << k);
      }
  }
};

// A lane's two cells (2 lane, 2 lane + 1) of the scan: the exclusive
// prefix at its first cell and that cell's live count.
struct RowScan {
  int excl, na;
};

// Every warp scans the cells' live counts, two cells a lane, so that each
// can hand its lanes' prefixes to stage_live; warp 0 writes start[0 ..
// WIN]. The mask must be complete (a barrier after to_mask).
template <int WIN, class Mask>
__device__ __forceinline__ RowScan stage_scan(const Mask* mask, int* start) {
  static_assert(WIN <= 64, "two window cells a lane");
  const int lane = threadIdx.x & 31;
  const int l0 = 2 * lane, l1 = 2 * lane + 1;
  const int na = l0 < WIN ? popc(mask[l0]) : 0;
  const int nb = l1 < WIN ? popc(mask[l1]) : 0;
  int incl = na + nb;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - na - nb;
  if (threadIdx.x < 32) {
    if (l0 < WIN) start[l0] = excl;
    if (l1 < WIN) start[l1] = excl + na;
    if (lane == 31) start[WIN] = incl;
  }
  return {excl, na};
}

// f(e, k, l, c) for every live slot of the row, e its compacted entry.
// Every thread must call it (it shuffles).
template <int WIN, class Mask, class F>
__device__ __forceinline__ void stage_live(const Mask* mask, RowScan s,
                                           int K, int cw, F&& f) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int i0 = 0; i0 < K * WIN; i0 += nthr) {
    const int i = i0 + tid;
    const int k = i / WIN, l = i - k * WIN;
    const int src = l >> 1;                     // every lane shuffles
    const int ex = __shfl_sync(0xffffffffu, s.excl, src);
    const int n0 = __shfl_sync(0xffffffffu, s.na, src);
    if (k >= K) continue;
    const Mask bits = mask[l];
    if (!((bits >> k) & 1u)) continue;
    f(ex + ((l & 1) ? n0 : 0) + popc(bits & ((Mask(1) << k) - 1u)), k, l,
      cw + l);
  }
}

// Whether any slot of rows [p0, p1) and columns [c0, c0 + TILE) of the
// occupancy plane ``occ`` (row 0; ``rs`` floats between rows) is live: a
// vote of the whole block, which every thread must call. A block whose
// own cells are empty writes zeros and leaves.
template <int TILE>
__device__ __forceinline__ bool block_any_live(const float* __restrict__ occ,
                                               size_t rs, int p0, int p1,
                                               int K, int W, int c0) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  bool any = false;
  for (int i = tid; i < (p1 - p0) * K * TILE; i += nthr) {
    const int r = i / (K * TILE), k = (i / TILE) % K;
    const int c = c0 + i % TILE;
    if (c < W && occ[(size_t)(p0 + r) * rs + (size_t)k * W + c] > 0.f)
      any = true;                               // loads stay independent
  }
  return __syncthreads_or(any);
}
