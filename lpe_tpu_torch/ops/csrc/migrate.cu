// Kick + drift + cell migration of the SPH grid state.
//
// Replaces the Pallas TPU kernel make_migrate_ring / _migrate_ring_kernel
// (lpe_tpu/ops/pallas_sph.py:1128, built at :1311). Input ST [rows, 9, K,
// W], output M9 [rows, 9, K, W] (plane orders in common.cuh).
//
// What bounds it on the H100: memory and latency, not arithmetic. Each
// target cell reads the 9 x K slots of its 3x3 source cells (a handful of
// float32 loads and ~20 flops per candidate) and writes its K slots; at
// 100k particles the whole stack is ~40 MB per sub-step, so the kernel is
// a gather over L2-resident data.
//
// Design: one warp per target cell. Lane k takes slot k of each source
// cell in (dy, dx) order, recomputes that candidate's kick, drift and
// clamped target, and a __ballot_sync + __popc prefix gives each match its
// rank: exactly the (dy, dx, slot) order of the JAX _migrate, with the
// first K kept and the rest dropped. No atomics and no shared memory, so
// the output is deterministic. Recomputing a candidate's drift in each of
// the 9 warps that see it is cheaper than a second pass over the grid.
#include "common.cuh"

__global__ void migrate_kernel(const float* __restrict__ st,
                               float* __restrict__ m9, MigrateParams P) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int p = blockIdx.y;
  if (col >= P.W) return;
  const int K = P.K, W = P.W;
  const size_t plane = (size_t)K * W;
  const size_t rowstride = 9 * plane;
  float* out = m9 + p * rowstride + col;
  int cnt = 0;
  // apron rows and columns are never targets (targets clip to the grid)
  if (p >= 1 && p <= P.ny && col >= 1 && col <= P.nx) {
    for (int dy = 0; dy < 3; ++dy) {
      const int sr = p - 1 + dy;
      for (int dx = 0; dx < 3; ++dx) {
        const int sc = col - 1 + dx;
        const float* src = st + sr * rowstride + sc;
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          bool match = false;
          float x1 = 0.f, y1 = 0.f, hx = 0.f, hy = 0.f;
          if (k < K && src[ST_OCC * plane + k * W] > 0.f) {
            const float vx = src[ST_VX * plane + k * W];
            const float vy = src[ST_VY * plane + k * W];
            hx = vx + P.half_dt * src[ST_AX * plane + k * W];
            hy = vy + P.half_dt * src[ST_AY * plane + k * W];
            x1 = src[ST_X * plane + k * W] +
                 clampf(hx * P.sub_dt, -P.lim, P.lim);
            y1 = src[ST_Y * plane + k * W] +
                 clampf(hy * P.sub_dt, -P.lim, P.lim);
            // clip to the grid, then walk at most one cell from the
            // stored cell (sph.py _migrate; the eps sits inside the floor)
            int gx = (int)floorf((x1 + P.eps) / P.cell) - P.gmin;
            int gy = (int)floorf((y1 + P.eps) / P.cell) - P.gmin;
            gx = clampi(clampi(gx, 0, P.nx - 1), sc - 2, sc) + 1;
            gy = clampi(clampi(gy, 0, P.ny - 1), sr - 2, sr) + 1;
            match = (gx == col) && (gy == p);
          }
          const unsigned mask = __ballot_sync(0xffffffffu, match);
          const int rank = cnt + __popc(mask & ((1u << lane) - 1u));
          if (match && rank < K) {
            float* o = out + rank * W;
            o[M9_X * plane] = x1;
            o[M9_Y * plane] = y1;
            o[M9_VX * plane] = src[ST_VX * plane + k * W];
            o[M9_VY * plane] = src[ST_VY * plane + k * W];
            o[M9_M * plane] = src[ST_M * plane + k * W];
            o[M9_OCC * plane] = 1.f;
            o[M9_HX * plane] = hx;
            o[M9_HY * plane] = hy;
            o[M9_ID * plane] = src[ST_ID * plane + k * W];
          }
          cnt += __popc(mask);
        }
      }
    }
  }
  // slots past the cell's count (and every slot of a non-target) are empty
  for (int k = lane; k < K; k += 32) {
    if (k >= cnt) {
      for (int f = 0; f < 9; ++f) out[f * plane + k * W] = 0.f;
    }
  }
}

LPE_EXPORT int lpe_migrate(const float* st, float* m9, cudaStream_t stream,
                           const MigrateParams* P) {
  const int warps = 8;
  dim3 block(32 * warps);
  dim3 grid((P->W + warps - 1) / warps, P->rows);
  migrate_kernel<<<grid, block, 0, stream>>>(st, m9, *P);
  return (int)cudaGetLastError();
}

LPE_EXPORT const char* lpe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
