// Grid-rigid narrowphase, grid form: the rigid tick's narrowphase, reading
// the body grids by slot itself.
//
// Replaces lpe_tpu/ops/pallas_rigid.py:_nphase_kernel (built by
// make_narrowphase) together with the row gathers that lpe_tpu runs around
// it (lpe_tpu/systems/rigid/grid_pipeline.py:470-527): there a row's two
// shapes are selected from the body grids by slot, class by class, and
// concatenated, and the kernel reads them back. Here one block takes one
// cell's R candidate rows and stages the bodies they name:
// - inputs: the per-cell body grids of ny rows of nbx cells, NC = ny * nbx
//   (pos [NC, KB, 2], cos and sin of the angle [NC, KB], local vertices
//   [NC, KB, V, 2], vertex counts [NC, KB]) and the NBIG big bodies' (pos,
//   cos, sin, vertices, counts), the slots ka, kb [rows * nbx, R] of the
//   candidate rows of the grids' first `rows` cell rows (rows <= ny) and
//   the class layout (NarrowGridParams): a row of class (dx, dy) takes side
//   B from cell ((cy + dy) mod ny, (cx + dx) mod nbx) at slot kb, a row of
//   the big class from big body kb; side A is always the row's own cell at
//   slot ka. The whole grid is ny = rows = nbx. A y-row band of the
//   multi-device rigid pipeline (systems/rigid/grid_pipeline.py) holds its
//   own rows and the row below them, ny = rows + 1: the forward
//   half-stencil's partners lie at dy in {0, 1}, so its rows' partners are
//   always among its rows;
// - outputs, row-contiguous [rows * nbx * R]: make_narrowphase's (hit,
//   nrm, pen, pts, pens, cval), cval ANDed with hit, and the rows' side-A
//   and side-B positions, which the solvers read.
// The row's math is narrow.cuh's narrow_row, which the row-form kernel
// (narrowphase.cu) shares, so one row gives the bits of the plain version
// (rigid_kernels.narrowphase_grid_plain: the gathers, then
// narrowphase_plain), invalid rows (slot 0 of both sides) included.
//
// The least time the H100 could take is set by bytes: the function needs
// each body grid once (RIGID_STACKS 10k: 576 cells x 48 slots x 7
// vertices, ~2 MB with pos, cos, sin and counts), the rows' slots (0.7 MB)
// and its outputs (39 B a row of results and 16 B of positions: 4.6 MB at
// 82,944 rows): ~7 MB, ~2 us at 3.35 TB/s; a band of D moves ~1/D of it
// (its rows, its grids and the halo row's). Its ~1-1.5 kFLOP a row take
// under 3 us at the 67 TFLOP/s fp32 rate. The row form instead reads 2 x
// 76 B of gathered shapes a row and rebuilds both world rings and all face
// normals per row (82,944 rows x 2 rings, where the grid holds 27,648
// bodies).
//
// Design:
// - One block a cell that owns rows. Its staging area holds its own
//   cell's KB bodies and, for each class, the partner's: a neighbour
//   cell's KB bodies (E, SW, S, SE) or the NBIG big bodies; the same-cell
//   class reads the own cell. The
//   block first lists the bodies its rows name, each once (shared-memory
//   atomics; RIGID_STACKS 10k: at most 132 of the 244, as a class has fewer
//   rows than its partner has slots), then builds each listed body once
//   (build_ring, one thread a body, in registers, then stored): its world
//   ring, raw rot90-left unit normals, outward bits and vertex count,
//   instead of twice per row as the row form does. The list's order does
//   not matter: a body's ring is its own.
// - A row's thread copies its two staged rings into registers (narrow.cuh
//   Ring) and runs the row there: the SAT reads each vertex once a face,
//   and from shared memory, where a warp's rows name random bodies, those
//   reads would meet bank conflicts at every face.
// - The classes are staged in passes that fit the shared memory a block
//   may have (rigid_kernels.grid_passes): RIGID_STACKS 10k stages all five
//   regions at once (244 bodies, 33 KB at V = 7), one pass; only very
//   large cells (KB x V beyond ~160 x 16) take several.
// - Threads take the pass's rows, a row each, and write its results. The
//   kernel is bound by latency (its chains of square roots, divides and
//   dependent maxima), not by bytes: NG_THREADS sets how many blocks fit
//   an SM.
#include "narrow.cuh"

constexpr int NG_MAX_CLS = 8;

// The ctypes Structure of lpe_tpu_torch/ops/_build.py, field for field.
struct NarrowGridParams {
  int NC, KB, R, NBIG, nbx, V, ncls, npass;
  int ny;                      // cell rows of the grids: NC = ny * nbx
  int rows;                    // the first `rows` of them own the rows
  int nsb;                     // staged bodies of the largest pass
  int cls_end[NG_MAX_CLS];     // one past class c's last row
  int cls_dx[NG_MAX_CLS], cls_dy[NG_MAX_CLS];
  int cls_big[NG_MAX_CLS];     // side B of class c is a big body
  int pass_end[NG_MAX_CLS];    // one past pass q's last class
};

namespace {

// The most threads a block takes. A row's two rings in registers take
// ~144 registers a thread; at 64 threads, 576 blocks (RIGID_STACKS 10k)
// fit the 132 SMs in one wave (7 an SM, as their shared memory also
// allows). Timed on an H100 against caps of 128 (with 128 registers),
// 160 (96 registers, some spilled) and 256: 0.0209 ms a tick against
// 0.0270, 0.0233 and 0.0300 (PERF.md).
constexpr int NG_THREADS = 64;

// Bytes of shared memory a staged body takes: floats ring[4][V], px, py,
// then ints raw_out, n, whether a row names it, and an entry of the list
// of named bodies (rigid_kernels.grid_passes counts the same).
constexpr int ng_body_bytes(int V) { return 4 * (4 * V + 6); }

// Stage ring g as body i.
template <int V>
__device__ __forceinline__ void store_ring(const Ring<V>& g, float* ring,
                                           int s, int i, int* raw,
                                           int* cnt) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ring[v * s + i] = g.x[v];
    ring[(V + v) * s + i] = g.y[v];
    ring[(2 * V + v) * s + i] = g.rx[v];
    ring[(3 * V + v) * s + i] = g.ry[v];
  }
  raw[i] = (int)g.raw_out;
  cnt[i] = g.n;
}

// Copy staged body i into registers.
template <int V>
__device__ __forceinline__ void load_ring(const float* ring, int s, int i,
                                          const int* raw, const int* cnt,
                                          Ring<V>& g) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    g.x[v] = ring[v * s + i];
    g.y[v] = ring[(V + v) * s + i];
    g.rx[v] = ring[(2 * V + v) * s + i];
    g.ry[v] = ring[(3 * V + v) * s + i];
  }
  g.raw_out = (unsigned)raw[i];
  g.n = cnt[i];
}

}  // namespace

// Global namespace: profilers name it narrowphase_grid_kernel<V>.
// grid: rows * nbx blocks, one a cell that owns rows; shared memory nsb *
// ng_body_bytes(V).
template <int V>
__global__ void __launch_bounds__(NG_THREADS) narrowphase_grid_kernel(
    const float* __restrict__ g_pos, const float* __restrict__ g_cos,
    const float* __restrict__ g_sin, const float* __restrict__ g_verts,
    const int* __restrict__ g_nv, const float* __restrict__ b_pos,
    const float* __restrict__ b_cos, const float* __restrict__ b_sin,
    const float* __restrict__ b_verts, const int* __restrict__ b_nv,
    const int* __restrict__ ka, const int* __restrict__ kb,
    bool* __restrict__ hit, float* __restrict__ nrm,
    float* __restrict__ pen, float* __restrict__ pts,
    float* __restrict__ pens, bool* __restrict__ cval,
    float* __restrict__ pos_a, float* __restrict__ pos_b,
    NarrowGridParams P) {
  extern __shared__ __align__(16) float sm[];
  // per class of the pass: its first row, its region of staged bodies
  __shared__ int row0[NG_MAX_CLS + 1], reg0[NG_MAX_CLS], reg1[NG_MAX_CLS];
  __shared__ int nnamed;
  const int s = P.nsb;
  float* ring = sm;                          // [4][V][s]
  float* spx = ring + 4 * V * s;             // [s]
  float* spy = spx + s;                      // [s]
  int* sraw = reinterpret_cast<int*>(spy + s);
  int* scnt = sraw + s;
  int* used = scnt + s;                      // [s]
  int* named = used + s;                     // [s]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cell = blockIdx.x;
  const int cy = cell / P.nbx, cx = cell - cy * P.nbx;
  const int KB = P.KB;

  for (int q = 0, cb = 0; q < P.npass; cb = P.pass_end[q], ++q) {
    const int ce = P.pass_end[q];
    // regions: the own cell first, then each class's partner (the
    // same-cell class reads the own cell); no body marked yet
    for (int i = tid; i < s; i += nthr) used[i] = 0;
    if (tid == 0) {
      nnamed = 0;
      int off = KB;
      for (int c = 0; c < P.ncls; ++c) {
        row0[c] = c == 0 ? 0 : P.cls_end[c - 1];
        reg0[c] = reg1[c] = 0;
        if (c < cb || c >= ce) continue;
        const int n = P.cls_big[c] ? P.NBIG
                      : (P.cls_dx[c] == 0 && P.cls_dy[c] == 0) ? 0 : KB;
        reg0[c] = n ? off : 0;
        reg1[c] = n ? off + n : 0;
        off += n;
      }
      row0[P.ncls] = P.R;
    }
    __syncthreads();

    // list the bodies the pass's rows name, each once (in no order)
    for (int r = row0[cb] + tid; r < row0[ce]; r += nthr) {
      int c = cb;
      while (r >= row0[c + 1]) ++c;
      const long row = (long)cell * P.R + r;
      const int ia = ka[row], ib = reg0[c] + kb[row];
      if (atomicExch(&used[ia], 1) == 0) named[atomicAdd(&nnamed, 1)] = ia;
      if (atomicExch(&used[ib], 1) == 0) named[atomicAdd(&nnamed, 1)] = ib;
    }
    __syncthreads();

    // stage them, one thread a body
    for (int k = tid; k < nnamed; k += nthr) {
      const int i = named[k];
      const float *pos = g_pos, *cs = g_cos, *sn = g_sin, *verts = g_verts;
      const int* nv = g_nv;
      long j = (long)cell * KB + i;
      if (i >= KB) {
        int c = cb;
        while (!(i >= reg0[c] && i < reg1[c])) ++c;
        if (P.cls_big[c]) {
          pos = b_pos, cs = b_cos, sn = b_sin, verts = b_verts, nv = b_nv;
          j = i - reg0[c];
        } else {
          const int py = (cy + P.cls_dy[c] + P.ny) % P.ny;
          const int px = (cx + P.cls_dx[c] + P.nbx) % P.nbx;
          j = (long)(py * P.nbx + px) * KB + (i - reg0[c]);
        }
      }
      Ring<V> g;
      const float x = pos[2 * j], y = pos[2 * j + 1];
      build_ring<V>(x, y, cs[j], sn[j], verts + j * (2 * V), nv[j], g);
      store_ring<V>(g, ring, s, i, sraw, scnt);
      spx[i] = x;
      spy[i] = y;
    }
    __syncthreads();

    // the pass's rows, a thread a row
    for (int r = row0[cb] + tid; r < row0[ce]; r += nthr) {
      int c = cb;
      while (r >= row0[c + 1]) ++c;
      const long row = (long)cell * P.R + r;
      const int ia = ka[row];
      const int ib = reg0[c] + kb[row];
      Ring<V> a, b;
      load_ring<V>(ring, s, ia, sraw, scnt, a);
      load_ring<V>(ring, s, ib, sraw, scnt, b);
      store_row(narrow_row<V>(a, b), row, hit, nrm, pen, pts, pens, cval);
      pos_a[2 * row] = spx[ia];
      pos_a[2 * row + 1] = spy[ia];
      pos_b[2 * row] = spx[ib];
      pos_b[2 * row + 1] = spy[ib];
    }
    __syncthreads();                         // before the next pass stages
  }
}

namespace {

template <int V>
cudaError_t launch_grid(const float* gp, const float* gc, const float* gs,
                        const float* gv, const int* gn, const float* bp,
                        const float* bc, const float* bs, const float* bv,
                        const int* bn, const int* ka, const int* kb,
                        bool* hit, float* nrm, float* pen, float* pts,
                        float* pens, bool* cval, float* pa, float* pb,
                        cudaStream_t stream, const NarrowGridParams* P) {
  const int smem = ng_body_bytes(V) * P->nsb;
  static int smem_set[MAX_DEVICES] = {};   // allowed so far, by device
  const cudaError_t err =
      allow_smem(narrowphase_grid_kernel<V>, smem, smem_set);
  if (err != cudaSuccess) return err;
  // threads: the rows of the largest pass, in whole warps
  int rows = 0;
  for (int q = 0, cb = 0; q < P->npass; cb = P->pass_end[q], ++q) {
    const int r0 = cb == 0 ? 0 : P->cls_end[cb - 1];
    const int r1 = P->cls_end[P->pass_end[q] - 1];
    rows = r1 - r0 > rows ? r1 - r0 : rows;
  }
  int threads = (rows + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > NG_THREADS ? NG_THREADS : threads);
  narrowphase_grid_kernel<V><<<P->rows * P->nbx, threads, smem, stream>>>(
      gp, gc, gs, gv, gn, bp, bc, bs, bv, bn, ka, kb, hit, nrm, pen, pts,
      pens, cval, pa, pb, *P);
  return cudaGetLastError();
}

}  // namespace

LPE_EXPORT int lpe_narrowphase_grid(
    const float* g_pos, const float* g_cos, const float* g_sin,
    const float* g_verts, const int* g_nv, const float* b_pos,
    const float* b_cos, const float* b_sin, const float* b_verts,
    const int* b_nv, const int* ka, const int* kb, bool* hit, float* nrm,
    float* pen, float* pts, float* pens, bool* cval, float* pos_a,
    float* pos_b, cudaStream_t stream, const NarrowGridParams* P) {
  const NarrowGridParams& p = *P;
  bool ok = p.NC >= 1 && p.KB >= 1 && p.R >= 1 && p.NBIG >= 0 &&
            p.nbx >= 1 && p.ny >= 1 && p.nbx * p.ny == p.NC &&
            p.rows >= 1 && p.rows <= p.ny && p.ncls >= 1 &&
            p.ncls <= NG_MAX_CLS && p.npass >= 1 && p.npass <= p.ncls &&
            p.nsb >= p.KB && p.cls_end[p.ncls - 1] == p.R &&
            p.pass_end[p.npass - 1] == p.ncls;
  for (int c = 0; ok && c < p.ncls; ++c)
    ok = (c == 0 ? p.cls_end[c] >= 0 : p.cls_end[c] >= p.cls_end[c - 1]) &&
         (!p.cls_big[c] || p.NBIG >= 1);
  for (int q = 0; ok && q < p.npass; ++q) {   // each pass fits nsb bodies
    const int cb = q == 0 ? 0 : p.pass_end[q - 1];
    ok = p.pass_end[q] > cb;
    int n = p.KB;
    for (int c = cb; ok && c < p.pass_end[q]; ++c)
      n += p.cls_big[c] ? p.NBIG
           : (p.cls_dx[c] == 0 && p.cls_dy[c] == 0) ? 0 : p.KB;
    ok = ok && n <= p.nsb;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
#define LPE_NARROW_CASE(VV)                                               \
  case VV:                                                                \
    return (int)launch_grid<VV>(g_pos, g_cos, g_sin, g_verts, g_nv, b_pos, \
                                b_cos, b_sin, b_verts, b_nv, ka, kb, hit, \
                                nrm, pen, pts, pens, cval, pos_a, pos_b,  \
                                stream, P);
  LPE_NARROW_SWITCH(p.V, LPE_NARROW_CASE)
#undef LPE_NARROW_CASE
}
