// Split SPH force pass: symmetric spiky pressure force and viscosity-
// Laplacian force over each particle's 3x3 neighbour cells.
//
// Replaces the Pallas TPU kernel make_force / _force_kernel
// (lpe_tpu/ops/pallas_sph.py:122, built at :1377). Input D8 [rows, 8(x, y,
// vx, vy, m, rho, p, occ), K, W]: density and pressure arrive as planes
// (the caller ran the density pass and the EOS), unlike the pair sweep,
// which derives them one row ahead. Outputs fx, fy [ny, K, W] over the
// interior rows, 0 in empty slots. The self pair is excluded; a pair counts
// when min_d2 <= r^2 < h^2 and both densities reach min_rho. The mixed-h
// variant (lpe_force_h, VAR_H) takes D9 [rows, 9(D8's planes, h), K, W]
// and takes each pair at its h-bar: r^2 < h-bar^2, the spiky and viscosity
// kernels at h-bar (sph_pair.cuh force_term_h; the JAX package runs mixed
// h through XLA's force_core, lpe_tpu/systems/fluid/sph.py:545-599).
//
// What bounds it on the H100: by bytes, one read of the occupancy plane
// and of the live slots' seven planes and one write of fx, fy (~18 MB at
// DAM_BREAK 100k, ~0.005 ms at 3.35 TB/s); by operations, ~48 float32
// operations a counted pair, far below the fp32 rate. A grid is sparse
// (8% of the slots live at the dam), so a thread per slot spends its loads
// on empty slots and idles its lanes, and a neighbour's planes would be
// gathered again by each of the ~50 particles that see it. Once those are
// gone, what is left is each particle's serial chain of counted pairs (a
// sqrt and three IEEE divides each) and the staging of its rows.
//
// Design: the force stage of pair_sweep.cu on its own, over the staging
// of stage.cuh.
// - A block owns FC_TILE columns and a band of FC_BAND interior rows. A
//   block whose own cells hold no particle reads their occupancy once and
//   writes zeros. Otherwise it walks rows p0-1 .. p1 in order and stages
//   each row's window (the tile plus one halo column a side) into a ring
//   of FC_RING rows in shared memory: the occupancy into a bit mask per
//   cell, then only the live slots' x, y, vx, vy, m, rho and pressure term
//   p / max(rho^2, 1e-30), compacted cell by cell in slot order.
// - The band is one row: timed on an H100 at DAM_BREAK 100k against
//   bands of 2-4 rows, it was the fastest (PERF.md). Each particle's pair
//   chain, not the staging, sets the time, and one-row bands' many blocks
//   keep more particles in flight, though each stages three rows for one.
// - Once row q is staged, row q-1's forces run with threads on its live
//   particles, not its slots. A cell's 3x3 neighbourhood in a staged row is
//   one contiguous run of entries (cells l-1 .. l+1), in (dx, slot) order;
//   sph_pair.cuh's staged_row_force, the pair sweep's force loop, marks
//   the run's neighbours within h and spends the costly term on those
//   alone, summing in (dy, dx, slot) order: the bits of the pair sweep's
//   force stage on the same rho and pressure.
// - Two K tiers (ForceTier), one template: up to K = 32 a 32-bit mask a
//   cell and 32 columns a block (the code the dam's K = 16 always ran);
//   from 33 to 64, the reference's cap, a 64-bit mask and 16 columns
//   (113 KB of shared memory at K = 64).
// - Outputs go through shared memory to stores along W.
// - Mixed h (VAR_H): the h plane is staged with the others (FC_PART 8),
//   the near mark tests each neighbour against its pair's h-bar, and the
//   pair's kernels (h-bar^5, two divides) are computed for the counted
//   pairs only.
#include "sph_pair.cuh"
#include "stage.cuh"

namespace {

constexpr int FC_BAND = 1;               // interior rows of a block
constexpr int FC_RING = 3;               // staged particle rows
constexpr int FC_THREADS = 256;
// staged planes: x, y, vx, vy, m, rho, p term(, h); input planes: D8 or D9
__host__ __device__ constexpr int fc_part(bool var_h) {
  return var_h ? 8 : 7;
}
__host__ __device__ constexpr int fc_planes(bool var_h) {
  return var_h ? 9 : 8;
}

template <class Mask>
using ForceTier = StageTier<Mask, 1, FC_THREADS>;   // one halo column

// Bytes of shared memory of a block: floats part[RING][PART][E],
// out[2][K][TILE], then Mask mask[RING][WIN] (after an even count of
// floats: 8-byte aligned), int start[RING][WIN + 1], then bytes
// slot[RING][E], cell[RING][E], with E = K * WIN entries a row (53,884
// bytes at K = 16; 60,412 with the h plane).
template <class Mask, bool VAR_H>
constexpr int force_smem(int K) {
  using T = ForceTier<Mask>;
  return 4 * (FC_RING * fc_part(VAR_H) * K * T::WIN + 2 * K * T::TILE +
              FC_RING * (T::WIN + 1)) +
         (int)sizeof(Mask) * FC_RING * T::WIN + 2 * FC_RING * K * T::WIN;
}
// the most a block may have on Hopper (227 KB), at each tier's largest K
static_assert(force_smem<unsigned, true>(32) <= 232448, "smem at K = 32");
static_assert(force_smem<unsigned long long, true>(64) <= 232448,
              "smem at K = 64");

__device__ __forceinline__ int fc_ring(int q) {
  return (q + FC_RING) % FC_RING;
}

}  // namespace

// grid: (column tiles, bands of FC_BAND interior rows); FC_THREADS threads.
template <class Mask, bool VAR_H>
__global__ void __launch_bounds__(FC_THREADS)
    split_force_kernel(const float* __restrict__ d8,
                       float* __restrict__ fx_o, float* __restrict__ fy_o,
                       SweepParams P) {
  using T = ForceTier<Mask>;
  constexpr int FC_TILE = T::TILE, FC_WIN = T::WIN;
  constexpr int FC_PART = fc_part(VAR_H);
  extern __shared__ __align__(16) float sm[];
  const int K = P.K, W = P.W, ny = P.rows - 2;
  const int E = K * FC_WIN;
  float* part = sm;                                   // [RING][PART][E]
  float* sout = part + FC_RING * FC_PART * E;         // [2][K][TILE]
  Mask* mask = reinterpret_cast<Mask*>(sout + 2 * K * FC_TILE);
  int* start = reinterpret_cast<int*>(mask + FC_RING * FC_WIN);
  unsigned char* sslot =
      reinterpret_cast<unsigned char*>(start + FC_RING * (FC_WIN + 1));
  unsigned char* scell = sslot + FC_RING * E;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c0 = blockIdx.x * FC_TILE;                // first tile column
  const int cw = c0 - 1;                              // window column 0
  const int p0 = 1 + blockIdx.y * FC_BAND;
  const int p1 = min(p0 + FC_BAND, ny + 1);           // band rows [p0, p1)
  const size_t plane = (size_t)K * W;
  const size_t rs = fc_planes(VAR_H) * plane;
  const float* occ = d8 + 7 * plane;
  auto X = [&](int r, int f) { return part + (r * FC_PART + f) * E; };

  // a block whose own cells hold no particle has only zeros to write
  if (!block_any_live<FC_TILE>(occ, rs, p0, p1, K, W, c0)) {
    for (int i = tid; i < (p1 - p0) * K * FC_TILE; i += nthr) {
      const int r = i / (K * FC_TILE), k = (i / FC_TILE) % K;
      const int c = c0 + i % FC_TILE;
      if (c >= W) continue;
      const size_t at = (size_t)(p0 + r - 1) * plane + (size_t)k * W + c;
      fx_o[at] = fy_o[at] = 0.f;
    }
    return;
  }

  RowOcc<FC_WIN, T::OCC> ro;
  auto load_occ = [&](int q) {
    ro.load(q >= 0 && q < P.rows ? occ + q * rs : nullptr, K, W, cw);
  };
  load_occ(p0 - 1);
  for (int i = tid; i < FC_RING * FC_WIN; i += nthr) mask[i] = 0;
  __syncthreads();

  for (int q = p0 - 1; q <= p1; ++q) {
    // 1. stage row q: occupancy bits per window cell (its ring slot was
    // zeroed while row q-1 was staged)
    const int rq = fc_ring(q);
    Mask* mq = mask + rq * FC_WIN;
    ro.to_mask(mq);
    __syncthreads();
    // 2. the live slots' planes, compacted cell by cell in slot order
    const RowScan s = stage_scan<FC_WIN>(mq, start + rq * (FC_WIN + 1));
    stage_live<FC_WIN>(mq, s, K, cw, [&](int e, int k, int l, int c) {
      const float* g = d8 + q * rs + (size_t)k * W + c;
      const float rho = g[5 * plane];
      X(rq, 0)[e] = g[0];
      X(rq, 1)[e] = g[plane];
      X(rq, 2)[e] = g[2 * plane];
      X(rq, 3)[e] = g[3 * plane];
      X(rq, 4)[e] = g[4 * plane];
      X(rq, 5)[e] = rho;
      X(rq, 6)[e] = pressure_term(g[6 * plane], rho);
      if (VAR_H) X(rq, 7)[e] = g[8 * plane];
      sslot[rq * E + e] = (unsigned char)k;
      scell[rq * E + e] = (unsigned char)l;
    });
    // row q-2's mask, last read by the previous row's output pass
    for (int i = tid; i < FC_WIN; i += nthr)
      mask[fc_ring(q + 1) * FC_WIN + i] = 0;
    if (q < p1) load_occ(q + 1);
    __syncthreads();

    // 3. forces of row f = q-1 in the tile's cells 1 .. WIN-2
    const int f = q - 1;
    if (f < p0) continue;
    const int rf = fc_ring(f);
    const int* sf = start + rf * (FC_WIN + 1);
    for (int i = sf[1] + tid; i < sf[FC_WIN - 1]; i += nthr) {
      const int l = scell[rf * E + i];
      const float cx = X(rf, 0)[i], cy = X(rf, 1)[i];
      const float cvx = X(rf, 2)[i], cvy = X(rf, 3)[i];
      const float crho = X(rf, 5)[i];
      const float cterm = X(rf, 6)[i];
      const float ch = VAR_H ? X(rf, 7)[i] : 0.f;
      const bool crho_ok = crho >= P.min_rho;
      float fxa = 0.f, fya = 0.f;
      for (int dy = -1; dy <= 1; ++dy) {
        const int rowi = f + dy;
        if (rowi < 1 || rowi > ny) continue;   // aprons hold no particles
        const int rn = fc_ring(rowi);
        const int* sn = start + rn * (FC_WIN + 1);
        const StagedRow r = {X(rn, 0), X(rn, 1), X(rn, 2), X(rn, 3),
                             X(rn, 4), X(rn, 5), X(rn, 6), sn,
                             VAR_H ? X(rn, 7) : nullptr};
        staged_row_force<VAR_H>(fxa, fya, r, l, dy == 0 ? i : -1, cx, cy,
                                cvx, cvy, cterm, crho_ok, P, ch);
      }
      const int o = sslot[rf * E + i] * FC_TILE + (l - 1);
      sout[o] = fxa;
      sout[K * FC_TILE + o] = fya;
    }
    __syncthreads();

    // 4. row f's outputs along W, 0 in empty slots
    const Mask* mf = mask + rf * FC_WIN;
    const size_t orow = (size_t)(f - 1) * plane;
    for (int i = tid; i < K * FC_TILE; i += nthr) {
      const int k = i / FC_TILE, t = i - k * FC_TILE, c = c0 + t;
      if (c >= W) continue;
      const bool live = (mf[t + 1] >> k) & 1u;
      const size_t at = orow + (size_t)k * W + c;
      fx_o[at] = live ? sout[i] : 0.f;
      fy_o[at] = live ? sout[K * FC_TILE + i] : 0.f;
    }
  }
}

namespace {

template <class Mask, bool VAR_H>
cudaError_t launch_force(const float* d8, float* fx, float* fy,
                         cudaStream_t stream, const SweepParams* P) {
  using T = ForceTier<Mask>;
  const int smem = force_smem<Mask, VAR_H>(P->K);
  static int smem_set = 0;      // the largest dynamic size allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_force_kernel<Mask, VAR_H>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int ny = P->rows - 2;
  const dim3 grid((P->W + T::TILE - 1) / T::TILE,
                  (ny + FC_BAND - 1) / FC_BAND);
  split_force_kernel<Mask, VAR_H>
      <<<grid, FC_THREADS, smem, stream>>>(d8, fx, fy, *P);
  return cudaGetLastError();
}

}  // namespace

namespace {

template <bool VAR_H>
int force_entry(const float* d, float* fx, float* fy, cudaStream_t stream,
                const SweepParams* P) {
  if (P->K < 1 || P->K > 64 || P->rows < 3 || P->W < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(P->K <= 32
                   ? launch_force<unsigned, VAR_H>(d, fx, fy, stream, P)
                   : launch_force<unsigned long long, VAR_H>(d, fx, fy,
                                                             stream, P));
}

}  // namespace

LPE_EXPORT int lpe_force(const float* d8, float* fx, float* fy,
                         cudaStream_t stream, const SweepParams* P) {
  return force_entry<false>(d8, fx, fy, stream, P);
}

// D9: D8 and the particles' smoothing lengths
LPE_EXPORT int lpe_force_h(const float* d9, float* fx, float* fy,
                           cudaStream_t stream, const SweepParams* P) {
  return force_entry<true>(d9, fx, fy, stream, P);
}
