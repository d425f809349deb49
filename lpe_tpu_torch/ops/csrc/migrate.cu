// Kick + drift + cell migration of the SPH grid state.
//
// Replaces the Pallas TPU kernel make_migrate_ring / _migrate_ring_kernel
// (lpe_tpu/ops/pallas_sph.py:1128, built at :1311; XLA semantics
// lpe_tpu/systems/fluid/sph.py:634 _migrate). Input ST [rows, 9, K, W],
// output M9 [rows, 9, K, W] (plane orders in common.cuh), dense: every slot
// that takes no particle, apron rows and padded columns included, is 0.
// The mixed-h variant (lpe_migrate_h, F = 10) takes ST10 and writes M10:
// a tenth plane, the particles' smoothing lengths, rides the permutation
// (lpe_tpu/systems/fluid/sph.py:632, h among the migrated fields).
//
// A row band's block (the multi-device fluid, lpe_tpu sph.py _migrate with
// row_off, :666-668) holds rows - 2 interior rows of a grid of P.ny rows,
// from global row P.row_off (the last band's may run past the grid's rows:
// they take no particle), and its apron rows hold the neighbour bands' edge
// rows: their ST planes, before the kick. Every occupied source slot is
// kicked, drifted and ranked, apron rows included, so a particle crossing
// into the band from a halo row is a candidate as on the whole grid; its
// kick and drift are the elementwise arithmetic its own band does, so the
// same bits. A cell row clamps to the whole grid, then shifts by row_off;
// apron rows of the output stay 0. The whole grid is row_off 0, P.ny =
// rows - 2.
//
// What bounds it on the H100: bytes, and most of them the dense M9 write.
// At DAM_BREAK 100k (275 rows, K = 16, 288 columns, 8% of the slots live)
// the function needs the ST occupancy plane (5.1 MB), the live slots'
// other 8 planes (3.2 MB) and the 45.6 MB of M9: ~54 MB, ~0.016 ms at
// 3.35 TB/s. A candidate costs ~20 flops. So the design spends its loads
// on live slots only, computes each candidate once, and makes every store
// a full 128-byte line.
//
// Design (the TPU kernel's rolling rows, recast for blocks that run in no
// order):
// - A block owns MG_TILE target columns and a band of MG_BAND target rows
//   (apron rows included: their slots are written 0). It walks the source
//   rows p0-1 .. p1 in order and stages each row's window (the tile plus
//   one halo column a side) into a ring of MG_RING rows in shared memory
//   (stage.cuh): the occupancy, coalesced along W, into a bit mask per
//   cell; then only the live slots, compacted cell by cell in slot order.
// - One thread per live candidate computes its half kick, clamped drift
//   and clamped re-bin once, and stages x1, y1, vx, vy, m, hx, hy, id with
//   its target as a byte (target row offset, target window column).
// - Once source row q is staged, target row q-1 is ranked: a warp per
//   target cell. Its candidates in source row p-1+dy lie in the contiguous
//   run of cells c-1 .. c+1, already in (dx, slot) order; a ballot and a
//   popc prefix over the three runs in dy order give each match its rank,
//   and ranks >= K are dropped: exactly the (dy, dx, slot) order of the
//   JAX _migrate, with no atomics on floats.
// - A kept candidate's staged entry goes into a [K][MG_TILE] index tile in
//   shared memory, from which the row's 9 x K x MG_TILE outputs, zeros
//   included, are stored along W: a warp writes 32 consecutive columns.
// - The band is three rows: timed on an H100 at DAM_BREAK 100k against
//   bands of 2-6 rows, it was the fastest (PERF.md); 56 KB of shared
//   memory a block (K = 16) lets four blocks share an SM.
// - Two K tiers (MigrateTier), one template: up to K = 32 a cell's slots
//   are a 32-bit mask and a block owns 32 columns (the code the dam's K =
//   16 always ran); from 33 to 64, the reference's cap, a 64-bit mask and
//   16 columns, so that a row's window keeps the occupancy registers and a
//   kept candidate's offset a short (116 KB of shared memory at K = 64).
//   The ranks are lane ballots over candidates, whatever K: a target cell
//   keeps its first K of up to 9 K candidates.
// - F planes (9, or 10 with h): a plane past M9's is passive, staged and
//   stored like the id (an 8% larger stage and 11% more bytes with h).
#include "stage.cuh"

namespace {

constexpr int MG_BAND = 3;               // target rows of a block
constexpr int MG_RING = 3;               // staged source rows
constexpr int MG_THREADS = 256;
// staged: the output's planes but occ
__host__ __device__ constexpr int mg_part(int F) {
  return F - 1;
}

template <class Mask>
using MigrateTier = StageTier<Mask, 1, MG_THREADS>;   // one halo column

// Bytes of shared memory of a block: floats part[RING][PART][E], then
// Mask mask[WIN] (after an even count of floats: 8-byte aligned), int
// start[RING][WIN + 1], int cnt[TILE], then short kept[K][TILE] (a kept
// candidate's offset in part), then bytes code[RING][E], with E = K *
// WIN entries a row (55,564 bytes at K = 16; 62,092 for F = 10).
template <class Mask, int F>
constexpr int migrate_smem(int K) {
  using T = MigrateTier<Mask>;
  return 4 * (MG_RING * mg_part(F) * K * T::WIN + MG_RING * (T::WIN + 1) +
              T::TILE) +
         (int)sizeof(Mask) * T::WIN + 2 * K * T::TILE + MG_RING * K * T::WIN;
}
// the most a block may have on Hopper (227 KB), at each tier's largest K;
// a kept candidate's offset in part fits a short
static_assert(migrate_smem<unsigned, 10>(32) <= 232448, "smem at K = 32");
static_assert(migrate_smem<unsigned long long, 10>(64) <= 232448,
              "smem at K = 64");
static_assert(MG_RING * mg_part(10) * 64 *
                      MigrateTier<unsigned long long>::WIN <= 32768 &&
                  MG_RING * mg_part(10) * 32 * MigrateTier<unsigned>::WIN <=
                      32768,
              "short offsets");

__device__ __forceinline__ int mg_ring(int q) {
  return (q + MG_RING) % MG_RING;
}

// A candidate's target, for a source in row q: (target row - q + 1) * 64
// + (target column - cw + 1); the row offset is 0..2, the column 0..WIN+1.
__device__ __forceinline__ unsigned char target_code(int dy, int wl) {
  return (unsigned char)(dy * 64 + wl);
}

}  // namespace

// grid: (column tiles, bands of MG_BAND rows); MG_THREADS threads.
template <class Mask, int F>
__global__ void __launch_bounds__(MG_THREADS)
    migrate_kernel(const float* __restrict__ st, float* __restrict__ m9,
                   MigrateParams P) {
  using T = MigrateTier<Mask>;
  constexpr int MG_TILE = T::TILE, MG_WIN = T::WIN;
  constexpr int MG_PART = mg_part(F);
  extern __shared__ __align__(16) float sm[];
  const int K = P.K, W = P.W;
  const int E = K * MG_WIN;
  float* part = sm;                                 // [RING][PART][E]
  Mask* mask = reinterpret_cast<Mask*>(part + MG_RING * MG_PART * E);
  int* start = reinterpret_cast<int*>(mask + MG_WIN);   // [RING][WIN + 1]
  int* cnt = start + MG_RING * (MG_WIN + 1);        // [TILE]
  short* kept = reinterpret_cast<short*>(cnt + MG_TILE);   // [K][TILE]
  unsigned char* code = reinterpret_cast<unsigned char*>(kept + K * MG_TILE);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  const int c0 = blockIdx.x * MG_TILE;               // first tile column
  const int cw = c0 - 1;                              // window column 0
  const int p0 = blockIdx.y * MG_BAND;
  const int p1 = min(p0 + MG_BAND, P.rows);           // band rows [p0, p1)
  const size_t plane = (size_t)K * W;
  const size_t rs = F * plane;
  auto X = [&](int r, int f) { return part + (r * MG_PART + f) * E; };
  auto occ_row = [&](int q) {
    return q >= 0 && q < P.rows ? st + q * rs + ST_OCC * plane : nullptr;
  };

  RowOcc<MG_WIN, T::OCC> ro;
  ro.load(occ_row(p0 - 1), K, W, cw);
  for (int i = tid; i < MG_WIN; i += nthr) mask[i] = 0;
  __syncthreads();

  for (int q = p0 - 1; q <= p1; ++q) {
    // 1. source row q: occupancy bits per window cell
    const int rq = mg_ring(q);
    ro.to_mask(mask);
    __syncthreads();
    // 2. each live candidate's kick, drift and target, once, compacted
    const RowScan s = stage_scan<MG_WIN>(mask, start + rq * (MG_WIN + 1));
    stage_live<MG_WIN>(mask, s, K, cw, [&](int e, int k, int, int c) {
      const float* g = st + q * rs + (size_t)k * W + c;
      const float vx = g[ST_VX * plane];
      const float vy = g[ST_VY * plane];
      const float hx = vx + P.half_dt * g[ST_AX * plane];
      const float hy = vy + P.half_dt * g[ST_AY * plane];
      const float x1 =
          g[ST_X * plane] + clampf(hx * P.sub_dt, -P.lim, P.lim);
      const float y1 =
          g[ST_Y * plane] + clampf(hy * P.sub_dt, -P.lim, P.lim);
      // clip to the grid, then walk at most one cell from the stored cell
      // (sph.py _migrate; the eps sits inside the floor); a band's block
      // clips the row on the whole grid and shifts it by its row_off
      int gx = (int)floorf((x1 + P.eps) / P.cell) - P.gmin;
      int gy = (int)floorf((y1 + P.eps) / P.cell) - P.gmin;
      gx = clampi(clampi(gx, 0, P.nx - 1), c - 2, c) + 1;
      gy = clampi(clampi(gy, 0, P.ny - 1) - P.row_off, q - 2, q) + 1;
      X(rq, 0)[e] = x1;
      X(rq, 1)[e] = y1;
      X(rq, 2)[e] = vx;
      X(rq, 3)[e] = vy;
      X(rq, 4)[e] = g[ST_M * plane];
      X(rq, 5)[e] = hx;
      X(rq, 6)[e] = hy;
      X(rq, 7)[e] = g[ST_ID * plane];
#pragma unroll
      for (int f = 9; f < F; ++f) X(rq, f - 1)[e] = g[f * plane];
      code[rq * E + e] = target_code(gy - q + 1, gx - cw + 1);
    });
    if (q < p1) ro.load(occ_row(q + 1), K, W, cw);
    __syncthreads();

    // 3. rank the candidates of target row p = q-1, a warp per target
    // cell: rows p-1 .. p+1, cells c-1 .. c+1, slots, the first K kept
    const int p = q - 1;
    for (int i = tid; i < MG_WIN; i += nthr) mask[i] = 0;   // row q's read
    if (p >= p0) {
      // apron (or halo) rows take nothing
      const bool prow = p >= 1 && p <= P.rows - 2;
      int any = 0;
      for (int dy = 0; dy < 3; ++dy)
        any += start[mg_ring(p - 1 + dy) * (MG_WIN + 1) + MG_WIN];
      for (int t = warp; t < MG_TILE; t += nwarp) {
        const int c = c0 + t;
        int n = 0;
        if (prow && any > 0 && c >= 1 && c <= P.nx) {
          for (int dy = 0; dy < 3; ++dy) {
            const int rr = mg_ring(p - 1 + dy);
            const int* sr = start + rr * (MG_WIN + 1);
            const unsigned char* cr = code + rr * E;
            const unsigned char want = target_code(2 - dy, t + 2);
            const int j1 = sr[t + 3];
            for (int b = sr[t]; b < j1; b += 32) {
              const int j = b + lane;
              const bool match = j < j1 && cr[j] == want;
              const unsigned bal = __ballot_sync(0xffffffffu, match);
              const int rank = n + __popc(bal & ((1u << lane) - 1u));
              if (match && rank < K)
                kept[rank * MG_TILE + t] = (short)(rr * MG_PART * E + j);
              n += __popc(bal);
            }
          }
        }
        if (lane == 0) cnt[t] = min(n, K);
      }
    }
    __syncthreads();

    // 4. row p of M9 along W: kept slots from their staged entries, 0
    // past the count
    if (p < p0) continue;
    float* orow = m9 + (size_t)p * rs;
    for (int i = tid; i < K * MG_TILE; i += nthr) {
      const int k = i / MG_TILE, t = i - k * MG_TILE, c = c0 + t;
      if (c >= W) continue;
      const bool live = k < cnt[t];
      const float* src = part + (live ? kept[i] : 0);
      float* o = orow + (size_t)k * W + c;
#pragma unroll
      for (int g = 0; g < F; ++g) {
        const int f = g < M9_OCC ? g : g - 1;
        o[g * plane] = !live ? 0.f
                       : g == M9_OCC ? 1.f
                                     : src[f * E];
      }
    }
  }
}

namespace {

template <class Mask, int F>
cudaError_t launch_migrate(const float* st, float* m9, cudaStream_t stream,
                           const MigrateParams* P) {
  using T = MigrateTier<Mask>;
  const int smem = migrate_smem<Mask, F>(P->K);
  static int smem_set[MAX_DEVICES] = {};   // allowed so far, by device
  const cudaError_t err = allow_smem(migrate_kernel<Mask, F>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((P->W + T::TILE - 1) / T::TILE,
                  (P->rows + MG_BAND - 1) / MG_BAND);
  migrate_kernel<Mask, F><<<grid, MG_THREADS, smem, stream>>>(st, m9, *P);
  return cudaGetLastError();
}

}  // namespace

namespace {

template <int F>
int migrate_entry(const float* st, float* m, cudaStream_t stream,
                  const MigrateParams* P) {
  if (P->K < 1 || P->K > 64 || P->rows < 3 || P->W < 1 || P->nx < 1 ||
      P->nx > P->W - 2 || P->row_off < 0 || P->ny < P->rows - 2)
    return (int)cudaErrorInvalidValue;
  return (int)(P->K <= 32
                   ? launch_migrate<unsigned, F>(st, m, stream, P)
                   : launch_migrate<unsigned long long, F>(st, m, stream, P));
}

}  // namespace

LPE_EXPORT int lpe_migrate(const float* st, float* m9, cudaStream_t stream,
                           const MigrateParams* P) {
  return migrate_entry<9>(st, m9, stream, P);
}

// ST10 -> M10: the particles' smoothing lengths ride the permutation
LPE_EXPORT int lpe_migrate_h(const float* st10, float* m10,
                             cudaStream_t stream, const MigrateParams* P) {
  return migrate_entry<10>(st10, m10, stream, P);
}

LPE_EXPORT const char* lpe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
