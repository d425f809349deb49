// The SPH pair arithmetic, shared by the fused pair sweep (pair_sweep.cu)
// and the split density and force kernels (density.cu, force.cu).
//
// A particle is the slot (row p, slot k, column c) of a padded grid; its
// pairs are the occupied slots of its 3x3 neighbour cells, visited and
// summed in the fixed order (dy, dx, slot): one input gives one bitwise
// result, whichever kernel asks. The callers differ only in where their
// planes lie, which PairPlanes and the rho arguments describe.
#pragma once

#include "common.cuh"

// Particle planes of one row stack [rows, F, K, W]: each pointer is its
// plane at grid row 0; ``rs`` floats lie between consecutive rows.
struct PairPlanes {
  const float *x, *y, *vx, *vy, *m, *occ;
  size_t rs;
};

// Poly6 density at slot (p, k, c), self term included; 0 for an empty slot.
// Neighbour rows p-1 and p+1 must exist (p is an interior row).
__device__ __forceinline__ float pair_density(const PairPlanes& g, int p,
                                              int k, int c,
                                              const SweepParams& P) {
  const int K = P.K, W = P.W;
  const size_t at = (size_t)p * g.rs + (size_t)k * W + c;
  float acc = 0.f;
  if (g.occ[at] > 0.f) {
    const float cx = g.x[at];
    const float cy = g.y[at];
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int nc = c + dx;
        if (nc < 0 || nc >= W) continue;
        const size_t nb = (size_t)(p + dy) * g.rs + nc;
        for (int k2 = 0; k2 < K; ++k2) {
          const size_t q = nb + (size_t)k2 * W;
          if (!(g.occ[q] > 0.f)) continue;
          const float ddx = cx - g.x[q];
          const float ddy = cy - g.y[q];
          const float r2 = ddx * ddx + ddy * ddy;
          if (r2 < P.h2) {
            const float d = P.h2 - r2;
            acc = acc + g.m[q] * (P.poly6 * (d * d * d));
          }
        }
      }
    }
  }
  return acc;
}

// Symmetric spiky pressure force and viscosity-Laplacian force at slot
// (p, k, c), self pair excluded, gated by min_d2, h2 and min_rho on both
// sides. The density of slot (p', k', c') is rho[(p' - rho_row0) * rho_rs
// + k' * W + c']; its pressure is the EOS of that density (INLINE_EOS) or
// ``pres`` at the same index. Rows outside 1..ny hold no particles and are
// not read.
template <bool INLINE_EOS>
__device__ __forceinline__ void pair_force(const PairPlanes& g,
                                           const float* __restrict__ rho,
                                           const float* __restrict__ pres,
                                           size_t rho_rs, int rho_row0, int p,
                                           int k, int c, const SweepParams& P,
                                           float& fx_out, float& fy_out) {
  const int K = P.K, W = P.W, ny = P.rows - 2;
  const size_t at = (size_t)p * g.rs + (size_t)k * W + c;
  float fxa = 0.f, fya = 0.f;
  if (g.occ[at] > 0.f) {
    const float cx = g.x[at];
    const float cy = g.y[at];
    const float cvx = g.vx[at];
    const float cvy = g.vy[at];
    const size_t cat = (size_t)(p - rho_row0) * rho_rs + (size_t)k * W + c;
    const float crho = rho[cat];
    const float cp =
        INLINE_EOS ? eos(crho, P.stiffness, P.rest_density) : pres[cat];
    const float cterm = cp / fmaxf(crho * crho, 1e-30f);
    const bool crho_ok = crho >= P.min_rho;
    for (int dy = -1; dy <= 1; ++dy) {
      const int np_ = p + dy;
      if (np_ < 1 || np_ > ny) continue;   // aprons hold no particles
      for (int dx = -1; dx <= 1; ++dx) {
        const int nc = c + dx;
        if (nc < 0 || nc >= W) continue;
        const size_t nb = (size_t)np_ * g.rs + nc;
        const size_t nrho_row = (size_t)(np_ - rho_row0) * rho_rs + nc;
        for (int k2 = 0; k2 < K; ++k2) {
          if (dy == 0 && dx == 0 && k2 == k) continue;   // self pair
          const size_t q = nb + (size_t)k2 * W;
          if (!(g.occ[q] > 0.f)) continue;
          const float ddx = cx - g.x[q];
          const float ddy = cy - g.y[q];
          const float r2 = ddx * ddx + ddy * ddy;
          const size_t qr = nrho_row + (size_t)k2 * W;
          const float nrho = rho[qr];
          if (!(r2 >= P.min_d2 && r2 < P.h2 && nrho >= P.min_rho &&
                crho_ok))
            continue;
          const float nm = g.m[q];
          const float np =
              INLINE_EOS ? eos(nrho, P.stiffness, P.rest_density) : pres[qr];
          const float r = sqrtf(fmaxf(r2, 1e-30f));
          const float term = cterm + np / fmaxf(nrho * nrho, 1e-30f);
          const float hr = P.h - r;
          const float w_spiky = P.spiky * (hr * hr);
          const float f_press = -nm * term * w_spiky;
          float gx = f_press * ddx / r;
          float gy = f_press * ddy / r;
          const float f_visc =
              P.viscosity * nm * (P.visc_lap * hr / fmaxf(nrho, 1e-30f));
          gx = gx - f_visc * (cvx - g.vx[q]);
          gy = gy - f_visc * (cvy - g.vy[q]);
          fxa = fxa + gx;
          fya = fya + gy;
        }
      }
    }
  }
  fx_out = fxa;
  fy_out = fya;
}

// One thread per (interior row, slot, column), columns fastest: the flat
// index of the [ny, K, W] outputs and its slot (p, k, c) of the padded grid.
__device__ __forceinline__ bool pair_slot(const SweepParams& P, long& idx,
                                          int& p, int& k, int& c) {
  idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)(P.rows - 2) * P.K * P.W) return false;
  c = (int)(idx % P.W);
  k = (int)((idx / P.W) % P.K);
  p = (int)(idx / ((long)P.W * P.K)) + 1;
  return true;
}

constexpr int PAIR_BLOCK = 256;

inline unsigned pair_grid(const SweepParams* P) {
  const long n = (long)(P->rows - 2) * P->K * P->W;
  return (unsigned)((n + PAIR_BLOCK - 1) / PAIR_BLOCK);
}
