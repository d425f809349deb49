// SPH pair sweep: poly6 density, EOS pressure, spiky pressure force and
// viscosity-Laplacian force over each particle's 3x3 neighbour cells, in
// one launch.
//
// Replaces the Pallas TPU kernel make_pair_sweep(F=9) / _sweep_kernel
// (lpe_tpu/ops/pallas_sph.py:804, built at :1058). Input M9 [rows, 9, K,
// W] (planes x, y, vx, vy, m, occ are read); outputs rho, fx, fy [ny, K, W]
// over the interior rows, 0 in empty slots.
//
// What bounds it on the H100: not the arithmetic (a live pair costs ~12
// float32 operations in the density pass and ~48 in the force pass, far
// below the fp32 rate) and, at the least, bytes: one read of the occupancy
// plane and of the live slots' x, y, vx, vy, m, and one write of three
// planes. A grid is sparse (DAM_BREAK 100k: 8% of the slots hold a
// particle, 5.5 particles in an occupied cell of K = 16), so a thread per
// slot spends its loads on empty slots and its warps idle, and a
// neighbour's data is fetched again by every particle that sees it. Once
// those are gone, what is left is each particle's serial chain of counted
// pairs (a sqrt and three IEEE divides each) and the staging of its rows.
//
// Design (the TPU kernel's rolling rows, recast for blocks that run in no
// order):
// - A block owns SW_TILE columns and a band of SW_BAND interior rows. It
//   walks rows p0-2 .. p1+1 in order and stages each row's window (the
//   tile plus two halo columns each side) into a ring of SW_RING rows in
//   shared memory: the occupancy plane first (coalesced, loaded into
//   registers one row ahead) into a bit mask per cell; then only the live
//   slots' x, y, vx, vy, m, compacted cell by cell in slot order
//   (stage.cuh, which force.cu and migrate.cu share). An empty slot is
//   never read beyond its occupancy, so what it holds never reaches a sum.
// - Density runs one row ahead (row q-1 once row q is staged), over the
//   tile and one halo column each side, into a ring of SW_RHO_RING rows in
//   shared memory with the particle's pressure term; the band recomputes
//   one halo row above and below. Forces for row q-2 then read rho from
//   the ring: no round trip through device memory, one launch. The band
//   height trades blocks for halo work: a band stages SW_BAND + 4 rows and
//   computes the density of SW_BAND + 2 for SW_BAND rows of forces; at 4
//   rows DAM_BREAK 100k's 273 x 288 grid gives 9 x 69 = 621 blocks for the
//   132 SMs (3 resident on each at K = 16).
// - Two K tiers (SweepTier), one template: up to K = 32 a cell's slots are
//   a 32-bit mask and a block owns 32 columns (the code the dam's K = 16
//   always ran); from 33 to 64, the reference's cap, a 64-bit mask and 16
//   columns: 32 columns at K = 64 would need 283,792 bytes of shared
//   memory, over the 232,448 a block may have; 16 need 156,624.
// - Threads take the row's live particles, not its slots, so warps run
//   full. A block whose own cells hold no particle (most of a tank or dam:
//   the TPU kernel skipped such slabs too) reads their occupancy once and
//   writes zeros; a row with no particle costs its occupancy load and a
//   zero store.
// - Each particle sums its pairs in (dy, dx, slot) order through
//   sph_pair.cuh's pair functions, as the split density and force kernels
//   do: the results equal density + EOS + force to the bit.
//   A cell's 3x3 neighbourhood in a staged row is one contiguous run of
//   entries (cells l-1 .. l+1), already in (dx, slot) order. The density
//   loop is sph_pair.cuh's staged_row_density, which density.cu shares;
//   the force loop (staged_row_force, which force.cu shares) first
//   marks the run's neighbours within h (~1/3 of them; r^2 by the same
//   separation()) and spends the costly term (a sqrt and three IEEE
//   divides) on those alone. Outputs go through shared memory to
//   coalesced stores.
#include "sph_pair.cuh"
#include "stage.cuh"

namespace {

constexpr int SW_BAND = 4;               // interior rows of a block
constexpr int SW_RING = 4;               // staged particle rows
constexpr int SW_RHO_RING = 3;           // rows of density kept
constexpr int SW_THREADS = 256;
constexpr int SW_PART = 5;               // staged planes: x, y, vx, vy, m

template <class Mask>
using SweepTier = StageTier<Mask, 2, SW_THREADS>;   // two halo columns

// Bytes of shared memory of a block: floats part[RING][5][E],
// rho[RHO_RING][2][E], out[3][K][TILE], then Mask mask[RING][WIN] (the
// floats before it are an even count: 8-byte aligned), int
// start[RING][WIN + 1], then bytes slot[RING][E], cell[RING][E], with E =
// K * WIN entries a row (71,824 bytes at K = 16). 32 columns at K = 64
// would need 283,792.
template <class Mask>
constexpr int sweep_smem(int K) {
  using T = SweepTier<Mask>;
  return 4 * (SW_RING * SW_PART * K * T::WIN +
              SW_RHO_RING * 2 * K * T::WIN + 3 * K * T::TILE +
              SW_RING * (T::WIN + 1)) +
         (int)sizeof(Mask) * SW_RING * T::WIN + 2 * SW_RING * K * T::WIN;
}
// the most a block may have on Hopper (227 KB), at each tier's largest K
static_assert(sweep_smem<unsigned>(32) <= 232448, "smem at K = 32");
static_assert(sweep_smem<unsigned long long>(64) <= 232448,
              "smem at K = 64");

__device__ __forceinline__ int ring(int q) { return (q + SW_RING) % SW_RING; }

}  // namespace

// grid: (column tiles, bands of SW_BAND interior rows); SW_THREADS threads.
template <class Mask>
__global__ void __launch_bounds__(SW_THREADS)
    sweep_kernel(const float* __restrict__ m9, float* __restrict__ rho_o,
                 float* __restrict__ fx_o, float* __restrict__ fy_o,
                 SweepParams P) {
  using T = SweepTier<Mask>;
  constexpr int SW_TILE = T::TILE, SW_WIN = T::WIN;
  extern __shared__ __align__(16) float sm[];
  const int K = P.K, W = P.W, ny = P.rows - 2;
  const int E = K * SW_WIN;
  float* part = sm;                                   // [RING][5][E]
  float* rhor = part + SW_RING * SW_PART * E;         // [RHO_RING][2][E]
  float* sout = rhor + SW_RHO_RING * 2 * E;           // [3][K][TILE]
  Mask* mask = reinterpret_cast<Mask*>(sout + 3 * K * SW_TILE);
  int* start = reinterpret_cast<int*>(mask + SW_RING * SW_WIN);
  unsigned char* sslot =
      reinterpret_cast<unsigned char*>(start + SW_RING * (SW_WIN + 1));
  unsigned char* scell = sslot + SW_RING * E;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c0 = blockIdx.x * SW_TILE;                // first tile column
  const int cw = c0 - 2;                              // window column 0
  const int p0 = 1 + blockIdx.y * SW_BAND;
  const int p1 = min(p0 + SW_BAND, ny + 1);           // band rows [p0, p1)
  const size_t plane = (size_t)K * W;
  const size_t rs = 9 * plane;
  auto X = [&](int r, int f) { return part + (r * SW_PART + f) * E; };

  // a block whose own cells hold no particle has only zeros to write
  const float* occ = m9 + M9_OCC * plane;
  if (!block_any_live<SW_TILE>(occ, rs, p0, p1, K, W, c0)) {
    for (int i = tid; i < (p1 - p0) * K * SW_TILE; i += nthr) {
      const int r = i / (K * SW_TILE), k = (i / SW_TILE) % K;
      const int c = c0 + i % SW_TILE;
      if (c >= W) continue;
      const size_t at = (size_t)(p0 + r - 1) * plane + (size_t)k * W + c;
      rho_o[at] = fx_o[at] = fy_o[at] = 0.f;
    }
    return;
  }

  // the occupancy of a row's window, loaded one row ahead (stage.cuh)
  RowOcc<SW_WIN, T::OCC> ro;
  auto load_occ = [&](int q) {
    ro.load(q >= 0 && q < P.rows ? occ + q * rs : nullptr, K, W, cw);
  };
  load_occ(p0 - 2);
  for (int i = tid; i < SW_RING * SW_WIN; i += nthr) mask[i] = 0;
  __syncthreads();

  for (int q = p0 - 2; q <= p1 + 1; ++q) {
    // 1. stage row q: occupancy bits per window cell (its ring slot was
    // zeroed while row q-1 was staged)
    const int rq = ring(q);
    Mask* mq = mask + rq * SW_WIN;
    ro.to_mask(mq);
    __syncthreads();
    // 2.-3. the live slots' planes, compacted cell by cell in slot order
    const RowScan s = stage_scan<SW_WIN>(mq, start + rq * (SW_WIN + 1));
    stage_live<SW_WIN>(mq, s, K, cw, [&](int e, int k, int l, int c) {
      const float* g = m9 + q * rs + (size_t)k * W + c;
      X(rq, 0)[e] = g[M9_X * plane];
      X(rq, 1)[e] = g[M9_Y * plane];
      X(rq, 2)[e] = g[M9_VX * plane];
      X(rq, 3)[e] = g[M9_VY * plane];
      X(rq, 4)[e] = g[M9_M * plane];
      sslot[rq * E + e] = (unsigned char)k;
      scell[rq * E + e] = (unsigned char)l;
    });
    // row q-3's mask, last read by the previous row's output pass
    for (int i = tid; i < SW_WIN; i += nthr)
      mask[ring(q + 1) * SW_WIN + i] = 0;
    if (q <= p1) load_occ(q + 1);
    __syncthreads();

    // 4. density of row d = q-1 in window cells 1 .. WIN-2
    const int d = q - 1;
    if (d >= p0 - 1 && d >= 1 && d <= ny) {
      const int rd = ring(d);
      const int* sd = start + rd * (SW_WIN + 1);
      float* rho_d = rhor + (d % SW_RHO_RING) * 2 * E;
      for (int i = sd[1] + tid; i < sd[SW_WIN - 1]; i += nthr) {
        const int l = scell[rd * E + i];
        const float cx = X(rd, 0)[i], cy = X(rd, 1)[i];
        float acc = 0.f;
        for (int dy = -1; dy <= 1; ++dy) {
          const int rn = ring(d + dy);
          staged_row_density(acc, X(rn, 0), X(rn, 1), X(rn, 4),
                             start + rn * (SW_WIN + 1), l, cx, cy, P);
        }
        rho_d[i] = acc;
        rho_d[E + i] =
            pressure_term(eos(acc, P.stiffness, P.rest_density), acc);
      }
    }
    __syncthreads();

    // 5. forces of row f = q-2 in the tile's cells 2 .. WIN-3, then the
    // row's outputs, 0 in empty slots
    const int f = q - 2;
    if (f < p0) continue;
    const int rf = ring(f);
    const int* sf = start + rf * (SW_WIN + 1);
    for (int i = sf[2] + tid; i < sf[SW_WIN - 2]; i += nthr) {
      const int l = scell[rf * E + i];
      const float cx = X(rf, 0)[i], cy = X(rf, 1)[i];
      const float cvx = X(rf, 2)[i], cvy = X(rf, 3)[i];
      const float* rho_f = rhor + (f % SW_RHO_RING) * 2 * E;
      const float crho = rho_f[i];
      const float cterm = rho_f[E + i];
      const bool crho_ok = crho >= P.min_rho;
      float fxa = 0.f, fya = 0.f;
      for (int dy = -1; dy <= 1; ++dy) {
        const int rowi = f + dy;
        if (rowi < 1 || rowi > ny) continue;   // aprons hold no particles
        const int rn = ring(rowi);
        const int* sn = start + rn * (SW_WIN + 1);
        const float* nr = rhor + (rowi % SW_RHO_RING) * 2 * E;
        const StagedRow r = {X(rn, 0), X(rn, 1), X(rn, 2), X(rn, 3),
                             X(rn, 4), nr, nr + E, sn};
        staged_row_force(fxa, fya, r, l, dy == 0 ? i : -1, cx, cy, cvx, cvy,
                         cterm, crho_ok, P);
      }
      const int o = sslot[rf * E + i] * SW_TILE + (l - 2);
      sout[o] = crho;
      sout[K * SW_TILE + o] = fxa;
      sout[2 * K * SW_TILE + o] = fya;
    }
    __syncthreads();
    const Mask* mf = mask + rf * SW_WIN;
    const size_t orow = (size_t)(f - 1) * plane;
    for (int i = tid; i < K * SW_TILE; i += nthr) {
      const int k = i / SW_TILE, t = i - k * SW_TILE, c = c0 + t;
      if (c >= W) continue;
      const bool live = (mf[t + 2] >> k) & 1u;
      const size_t at = orow + (size_t)k * W + c;
      rho_o[at] = live ? sout[i] : 0.f;
      fx_o[at] = live ? sout[K * SW_TILE + i] : 0.f;
      fy_o[at] = live ? sout[2 * K * SW_TILE + i] : 0.f;
    }
  }
}

namespace {

template <class Mask>
cudaError_t launch_sweep(const float* m9, float* rho, float* fx, float* fy,
                         cudaStream_t stream, const SweepParams* P) {
  using T = SweepTier<Mask>;
  const int smem = sweep_smem<Mask>(P->K);
  static int smem_set[MAX_DEVICES] = {};   // allowed so far, by device
  const cudaError_t err = allow_smem(sweep_kernel<Mask>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int ny = P->rows - 2;
  const dim3 grid((P->W + T::TILE - 1) / T::TILE,
                  (ny + SW_BAND - 1) / SW_BAND);
  sweep_kernel<Mask><<<grid, SW_THREADS, smem, stream>>>(m9, rho, fx, fy,
                                                         *P);
  return cudaGetLastError();
}

}  // namespace

LPE_EXPORT int lpe_pair_sweep(const float* m9, float* rho, float* fx,
                              float* fy, cudaStream_t stream,
                              const SweepParams* P) {
  if (P->K < 1 || P->K > 64 || P->rows < 3 || P->W < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(P->K <= 32
                   ? launch_sweep<unsigned>(m9, rho, fx, fy, stream, P)
                   : launch_sweep<unsigned long long>(m9, rho, fx, fy,
                                                      stream, P));
}
