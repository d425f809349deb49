// SPH pair sweep: poly6 density, EOS pressure, spiky pressure force and
// viscosity-Laplacian force over each particle's 3x3 neighbour cells.
//
// Replaces the Pallas TPU kernel make_pair_sweep(F=9) / _sweep_kernel
// (lpe_tpu/ops/pallas_sph.py:804, built at :1058). Input M9 [rows, 9, K,
// W]; outputs rho, fx, fy [ny, K, W] over the interior rows.
//
// What bounds it on the H100: memory latency. Per particle it visits 9
// cells x K slots, skips the empty ones on one occupancy load, and spends
// ~30 float32 flops per live pair; the grid (~40 MB at 100k particles)
// stays in the 50 MB L2 between the two launches, so the loads are L2
// hits and the work is latency-bound gathers, far from the compute roof.
//
// Design: the TPU kernel ran its rows in order and kept rho in a rolling
// on-chip ring. Blocks on the H100 run in no order, so the sweep is two
// launches on one stream: density first (with the self term), then forces,
// which read the neighbours' rho and derive their pressure inline. One
// thread per (row, slot, column), columns fastest, so a warp's loads of a
// plane are contiguous. Each thread sums its pairs in a fixed order
// (dy, dx, slot): deterministic, no atomics.
#include "common.cuh"

__global__ void density_kernel(const float* __restrict__ m9,
                               float* __restrict__ rho, SweepParams P) {
  const int K = P.K, W = P.W, ny = P.rows - 2;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)ny * K * W) return;
  const int c = (int)(idx % W);
  const int k = (int)((idx / W) % K);
  const int p = (int)(idx / ((long)W * K)) + 1;
  const size_t plane = (size_t)K * W;
  const size_t rs = 9 * plane;
  const float* ctr = m9 + p * rs + (size_t)k * W + c;
  float acc = 0.f;
  if (ctr[M9_OCC * plane] > 0.f) {
    const float cx = ctr[M9_X * plane];
    const float cy = ctr[M9_Y * plane];
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int nc = c + dx;
        if (nc < 0 || nc >= W) continue;
        const float* nb = m9 + (p + dy) * rs + nc;
        for (int k2 = 0; k2 < K; ++k2) {
          const float* q = nb + (size_t)k2 * W;
          if (!(q[M9_OCC * plane] > 0.f)) continue;
          const float ddx = cx - q[M9_X * plane];
          const float ddy = cy - q[M9_Y * plane];
          const float r2 = ddx * ddx + ddy * ddy;
          if (r2 < P.h2) {
            const float d = P.h2 - r2;
            acc = acc + q[M9_M * plane] * (P.poly6 * (d * d * d));
          }
        }
      }
    }
  }
  rho[idx] = acc;
}

__global__ void force_kernel(const float* __restrict__ m9,
                             const float* __restrict__ rho,
                             float* __restrict__ fx_out,
                             float* __restrict__ fy_out, SweepParams P) {
  const int K = P.K, W = P.W, ny = P.rows - 2;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)ny * K * W) return;
  const int c = (int)(idx % W);
  const int k = (int)((idx / W) % K);
  const int j = (int)(idx / ((long)W * K));
  const int p = j + 1;
  const size_t plane = (size_t)K * W;
  const size_t rs = 9 * plane;
  const float* ctr = m9 + p * rs + (size_t)k * W + c;
  float fxa = 0.f, fya = 0.f;
  if (ctr[M9_OCC * plane] > 0.f) {
    const float cx = ctr[M9_X * plane];
    const float cy = ctr[M9_Y * plane];
    const float cvx = ctr[M9_VX * plane];
    const float cvy = ctr[M9_VY * plane];
    const float crho = rho[idx];
    const float cp = eos(crho, P.stiffness, P.rest_density);
    const float cterm = cp / fmaxf(crho * crho, 1e-30f);
    const bool crho_ok = crho >= P.min_rho;
    for (int dy = -1; dy <= 1; ++dy) {
      const int nj = j + dy;              // interior row of the neighbour
      if (nj < 0 || nj >= ny) continue;  // aprons hold no particles
      for (int dx = -1; dx <= 1; ++dx) {
        const int nc = c + dx;
        if (nc < 0 || nc >= W) continue;
        const float* nb = m9 + (p + dy) * rs + nc;
        const float* nrho_row = rho + (size_t)nj * plane + nc;
        for (int k2 = 0; k2 < K; ++k2) {
          if (dy == 0 && dx == 0 && k2 == k) continue;   // self pair
          const float* q = nb + (size_t)k2 * W;
          if (!(q[M9_OCC * plane] > 0.f)) continue;
          const float ddx = cx - q[M9_X * plane];
          const float ddy = cy - q[M9_Y * plane];
          const float r2 = ddx * ddx + ddy * ddy;
          const float nrho = nrho_row[(size_t)k2 * W];
          if (!(r2 >= P.min_d2 && r2 < P.h2 && nrho >= P.min_rho &&
                crho_ok))
            continue;
          const float nm = q[M9_M * plane];
          const float np = eos(nrho, P.stiffness, P.rest_density);
          const float r = sqrtf(fmaxf(r2, 1e-30f));
          const float term = cterm + np / fmaxf(nrho * nrho, 1e-30f);
          const float hr = P.h - r;
          const float w_spiky = P.spiky * (hr * hr);
          const float f_press = -nm * term * w_spiky;
          float gx = f_press * ddx / r;
          float gy = f_press * ddy / r;
          const float f_visc =
              P.viscosity * nm * (P.visc_lap * hr / fmaxf(nrho, 1e-30f));
          gx = gx - f_visc * (cvx - q[M9_VX * plane]);
          gy = gy - f_visc * (cvy - q[M9_VY * plane]);
          fxa = fxa + gx;
          fya = fya + gy;
        }
      }
    }
  }
  fx_out[idx] = fxa;
  fy_out[idx] = fya;
}

LPE_EXPORT int lpe_pair_sweep(const float* m9, float* rho, float* fx,
                              float* fy, cudaStream_t stream,
                              const SweepParams* P) {
  const long n = (long)(P->rows - 2) * P->K * P->W;
  const int block = 256;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  density_kernel<<<grid, block, 0, stream>>>(m9, rho, *P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  force_kernel<<<grid, block, 0, stream>>>(m9, rho, fx, fy, *P);
  return (int)cudaGetLastError();
}
