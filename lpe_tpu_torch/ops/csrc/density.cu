// Split SPH density pass: poly6 density over each particle's 3x3 neighbour
// cells, self term included.
//
// Replaces the Pallas TPU kernel make_density / _density_kernel
// (lpe_tpu/ops/pallas_sph.py:78, built at :1356). Input D4 [rows, 4(x, y,
// m, occ), K, W]; output rho [ny, K, W] over the interior rows, 0 in empty
// slots. The mixed-h variant (lpe_density_h, VAR_H) takes D5 [rows, 5(x,
// y, m, occ, h), K, W] and sums each pair's kernel at its h-bar
// (sph_pair.cuh density_term_h; the JAX package runs mixed h through XLA's
// density_core, lpe_tpu/systems/fluid/sph.py:488-517, not through Pallas).
//
// What bounds it on the H100: by bytes, one read of the occupancy plane
// and of the live slots' x, y, m and one write of rho (~8 MB at DAM_BREAK
// 100k, ~0.003 ms at 3.35 TB/s); by operations, ~12 float32 operations a
// pair, far below the fp32 rate. A grid is sparse (8% of the slots live at
// the dam), so a thread per slot spends its loads on empty slots and idles
// its lanes, and a neighbour's x, y, m would be gathered again by each of
// the ~50 particles that see it. Once those are gone, what is left is
// each block's chain of loads and barriers. Staged row by row in a ring, as
// the sweep stages, every row adds an occupancy load, a gather and three
// barriers to it; staging the band's rows at once took 15% less time on an
// H100 at DAM_BREAK 100k (PERF.md).
//
// Design: the density stage of pair_sweep.cu on its own, over the staging
// primitives of stage.cuh, with the band's rows staged at once.
// - A block owns DN_TILE columns and a band of DN_BAND interior rows, and
//   stages its DN_ROWS = DN_BAND + 2 rows (a halo row above and below) at
//   once: all their occupancy loads in flight together, a bit mask per
//   window cell (the tile plus one halo column a side); a block whose own
//   cells hold no particle writes zeros and leaves. Then the live slots'
//   x, y, m of every row, compacted cell by cell in slot order, copied to
//   shared memory with cp.async, all rows' copies in flight together. An
//   empty slot is read no further than its occupancy.
// - Threads take the live particles of the band's rows, not its slots. A
//   cell's 3x3 neighbourhood in a staged row is one contiguous run of
//   entries (cells l-1 .. l+1), in (dx, slot) order; sph_pair.cuh's
//   staged_row_density, the pair sweep's density loop, sums it in (dy, dx,
//   slot) order: the bits of the sweep's rho.
// - The band height was timed on an H100 at DAM_BREAK 100k
//   (scripts/density_band_sweep.py; PERF.md).
// - Two K tiers (DensityTier), one template: up to K = 32 a 32-bit mask a
//   cell and 32 columns a block (the code the dam's K = 16 always ran);
//   from 33 to 64, the reference's cap, a 64-bit mask and 16 columns
//   (94 KB of shared memory at K = 64).
// - Outputs go through shared memory to stores along W.
// - Mixed h (VAR_H): the h plane is staged with x, y, m (one more float an
//   entry), and each pair's h-bar and poly6 normalisation, a divide, are
//   computed for the pairs within h-bar only.
#include "sph_pair.cuh"
#include "stage.cuh"

namespace {

constexpr int DN_BAND = 3;               // interior rows of a block
constexpr int DN_ROWS = DN_BAND + 2;     // staged rows: one halo a side
constexpr int DN_THREADS = 256;
// staged planes: x, y, m(, h); input planes: D4 or D5
__host__ __device__ constexpr int dn_part(bool var_h) {
  return var_h ? 4 : 3;
}
__host__ __device__ constexpr int dn_planes(bool var_h) {
  return var_h ? 5 : 4;
}

template <class Mask>
using DensityTier = StageTier<Mask, 1, DN_THREADS>;   // one halo column

// Bytes of shared memory of a block: floats part[ROWS][PART][E],
// out[BAND][K][TILE], then Mask mask[ROWS][WIN] (after an even count of
// floats: 8-byte aligned), int start[ROWS][WIN + 1], then bytes
// slot[ROWS][E], cell[ROWS][E], with E = K * WIN entries a row (45,604
// bytes at K = 16; 56,484 with the h plane).
template <class Mask, bool VAR_H>
constexpr int density_smem(int K) {
  using T = DensityTier<Mask>;
  return 4 * (DN_ROWS * dn_part(VAR_H) * K * T::WIN + DN_BAND * K * T::TILE +
              DN_ROWS * (T::WIN + 1)) +
         (int)sizeof(Mask) * DN_ROWS * T::WIN + 2 * DN_ROWS * K * T::WIN;
}
// the most a block may have on Hopper (227 KB), at each tier's largest K
static_assert(density_smem<unsigned, true>(32) <= 232448, "smem at K = 32");
static_assert(density_smem<unsigned long long, true>(64) <= 232448,
              "smem at K = 64");

// A 4-byte copy from global to shared memory that the thread does not wait
// for; cp_async_wait_all waits for all of the thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

// grid: (column tiles, bands of DN_BAND interior rows); DN_THREADS threads.
template <class Mask, bool VAR_H>
__global__ void __launch_bounds__(DN_THREADS)
    split_density_kernel(const float* __restrict__ d4,
                         float* __restrict__ rho_o, SweepParams P) {
  using T = DensityTier<Mask>;
  constexpr int DN_TILE = T::TILE, DN_WIN = T::WIN;
  constexpr int DN_PART = dn_part(VAR_H);
  extern __shared__ __align__(16) float sm[];
  const int K = P.K, W = P.W, ny = P.rows - 2;
  const int E = K * DN_WIN;
  float* part = sm;                                   // [ROWS][PART][E]
  float* sout = part + DN_ROWS * DN_PART * E;         // [BAND][K][TILE]
  Mask* mask = reinterpret_cast<Mask*>(sout + DN_BAND * K * DN_TILE);
  int* start = reinterpret_cast<int*>(mask + DN_ROWS * DN_WIN);
  unsigned char* sslot =
      reinterpret_cast<unsigned char*>(start + DN_ROWS * (DN_WIN + 1));
  unsigned char* scell = sslot + DN_ROWS * E;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c0 = blockIdx.x * DN_TILE;                // first tile column
  const int cw = c0 - 1;                              // window column 0
  const int p0 = 1 + blockIdx.y * DN_BAND;
  const int nb = min(DN_BAND, ny + 1 - p0);           // band rows [p0, p0+nb)
  const size_t plane = (size_t)K * W;
  const size_t rs = dn_planes(VAR_H) * plane;
  const float* occ = d4 + 3 * plane;
  auto X = [&](int r, int f) { return part + (r * DN_PART + f) * E; };

  // 1. the occupancy of staged rows p0-1 .. p0+nb (row r of the stage is
  // grid row p0-1+r), all loads in flight together, into bit masks
  RowOcc<DN_WIN, T::OCC> ro[DN_ROWS];
#pragma unroll
  for (int r = 0; r < DN_ROWS; ++r) {
    const int q = p0 - 1 + r;
    ro[r].load(r <= nb + 1 && q < P.rows ? occ + q * rs : nullptr, K, W, cw);
  }
  for (int i = tid; i < DN_ROWS * DN_WIN; i += nthr) mask[i] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < DN_ROWS; ++r) ro[r].to_mask(mask + r * DN_WIN);
  __syncthreads();

  // a block whose own cells hold no particle has only zeros to write
  bool any = false;
  for (int i = tid; i < nb * DN_TILE; i += nthr)
    any = any || mask[(1 + i / DN_TILE) * DN_WIN + 1 + i % DN_TILE] != 0;
  if (!__syncthreads_or(any)) {
    for (int i = tid; i < nb * K * DN_TILE; i += nthr) {
      const int r = i / (K * DN_TILE), k = (i / DN_TILE) % K;
      const int c = c0 + i % DN_TILE;
      if (c >= W) continue;
      rho_o[(size_t)(p0 + r - 1) * plane + (size_t)k * W + c] = 0.f;
    }
    return;
  }

  // 2. every staged row's live slots, compacted cell by cell in slot order
  for (int r = 0; r <= nb + 1; ++r) {
    const int q = p0 - 1 + r;
    const Mask* mr = mask + r * DN_WIN;
    const RowScan s = stage_scan<DN_WIN>(mr, start + r * (DN_WIN + 1));
    stage_live<DN_WIN>(mr, s, K, cw, [&](int e, int k, int l, int c) {
      const float* g = d4 + q * rs + (size_t)k * W + c;
      cp_async4(X(r, 0) + e, g);
      cp_async4(X(r, 1) + e, g + plane);
      cp_async4(X(r, 2) + e, g + 2 * plane);
      if (VAR_H) cp_async4(X(r, 3) + e, g + 4 * plane);
      sslot[r * E + e] = (unsigned char)k;
      scell[r * E + e] = (unsigned char)l;
    });
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. densities of the band's rows (stage rows 1 .. nb) in the tile's
  // cells 1 .. WIN-2
  for (int r = 1; r <= nb; ++r) {
    const int* sr = start + r * (DN_WIN + 1);
    for (int i = sr[1] + tid; i < sr[DN_WIN - 1]; i += nthr) {
      const int l = scell[r * E + i];
      const float cx = X(r, 0)[i], cy = X(r, 1)[i];
      const float ch = VAR_H ? X(r, 3)[i] : 0.f;
      float acc = 0.f;
      for (int dy = -1; dy <= 1; ++dy)
        staged_row_density<VAR_H>(
            acc, X(r + dy, 0), X(r + dy, 1), X(r + dy, 2),
            start + (r + dy) * (DN_WIN + 1), l, cx, cy, P,
            VAR_H ? X(r + dy, 3) : nullptr, ch);
      sout[((r - 1) * K + sslot[r * E + i]) * DN_TILE + (l - 1)] = acc;
    }
  }
  __syncthreads();

  // 4. the band's outputs along W, 0 in empty slots
  for (int i = tid; i < nb * K * DN_TILE; i += nthr) {
    const int r = i / (K * DN_TILE), k = (i / DN_TILE) % K;
    const int t = i % DN_TILE, c = c0 + t;
    if (c >= W) continue;
    const bool live = (mask[(1 + r) * DN_WIN + t + 1] >> k) & 1u;
    rho_o[(size_t)(p0 + r - 1) * plane + (size_t)k * W + c] =
        live ? sout[i] : 0.f;
  }
}

namespace {

template <class Mask, bool VAR_H>
cudaError_t launch_density(const float* d4, float* rho, cudaStream_t stream,
                           const SweepParams* P) {
  using T = DensityTier<Mask>;
  const int smem = density_smem<Mask, VAR_H>(P->K);
  static int smem_set = 0;      // the largest dynamic size allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_density_kernel<Mask, VAR_H>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int ny = P->rows - 2;
  const dim3 grid((P->W + T::TILE - 1) / T::TILE,
                  (ny + DN_BAND - 1) / DN_BAND);
  split_density_kernel<Mask, VAR_H>
      <<<grid, DN_THREADS, smem, stream>>>(d4, rho, *P);
  return cudaGetLastError();
}

}  // namespace

namespace {

template <bool VAR_H>
int density_entry(const float* d, float* rho, cudaStream_t stream,
                  const SweepParams* P) {
  if (P->K < 1 || P->K > 64 || P->rows < 3 || P->W < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(P->K <= 32
                   ? launch_density<unsigned, VAR_H>(d, rho, stream, P)
                   : launch_density<unsigned long long, VAR_H>(d, rho,
                                                               stream, P));
}

}  // namespace

LPE_EXPORT int lpe_density(const float* d4, float* rho, cudaStream_t stream,
                           const SweepParams* P) {
  return density_entry<false>(d4, rho, stream, P);
}

// D5: D4 and the particles' smoothing lengths
LPE_EXPORT int lpe_density_h(const float* d5, float* rho,
                             cudaStream_t stream, const SweepParams* P) {
  return density_entry<true>(d5, rho, stream, P);
}
