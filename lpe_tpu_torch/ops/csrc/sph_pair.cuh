// The SPH pair arithmetic, shared by the fused pair sweep (pair_sweep.cu)
// and the split density and force kernels (density.cu, force.cu).
//
// A particle is the slot (row p, slot k, column c) of a padded grid; its
// pairs are the occupied slots of its 3x3 neighbour cells, visited and
// summed in the fixed order (dy, dx, slot). The arithmetic of one pair is
// the functions below (separation, density_term; force_counts, force_term),
// and every kernel sums their terms in that order, so one input gives one
// bitwise result, whichever kernel asks. The split kernels walk the slots
// of the padded grid (pair_density, pair_force); the pair sweep walks the
// live slots it staged in shared memory.
#pragma once

#include "common.cuh"

// Particle planes of one row stack [rows, F, K, W]: each pointer is its
// plane at grid row 0; ``rs`` floats lie between consecutive rows.
struct PairPlanes {
  const float *x, *y, *vx, *vy, *m, *occ;
  size_t rs;
};

// The separation (dx, dy) of a particle at (cx, cy) from a neighbour at
// (nx, ny), and its square r2.
struct Sep {
  float dx, dy, r2;
};

__device__ __forceinline__ Sep separation(float cx, float cy, float nx,
                                          float ny) {
  Sep s;
  s.dx = cx - nx;
  s.dy = cy - ny;
  s.r2 = s.dx * s.dx + s.dy * s.dy;
  return s;
}

// One poly6 density term: a neighbour of mass nm at separation s adds it
// to the particle's density when it lies within h (``ok``).
__device__ __forceinline__ float density_term(bool& ok, const Sep& s,
                                              float nm,
                                              const SweepParams& P) {
  const float d = P.h2 - s.r2;
  ok = s.r2 < P.h2;
  return nm * (P.poly6 * (d * d * d));
}

// p / max(rho^2, 1e-30): a particle's share of the symmetric pressure term.
__device__ __forceinline__ float pressure_term(float p, float rho) {
  return p / fmaxf(rho * rho, 1e-30f);
}

// Whether a neighbour at separation s with density nrho exerts a pair
// force: min_d2 <= r^2 < h^2 and both densities reach min_rho.
__device__ __forceinline__ bool force_counts(const Sep& s, float nrho,
                                             bool crho_ok,
                                             const SweepParams& P) {
  return s.r2 >= P.min_d2 && s.r2 < P.h2 && nrho >= P.min_rho && crho_ok;
}

// The spiky pressure force plus the viscosity-Laplacian force (gx, gy) of
// a counted pair: the particle (velocity cvx, cvy; pressure term cterm)
// and a neighbour at separation s (velocity nvx, nvy; mass nm; density
// nrho; pressure term nterm).
__device__ __forceinline__ void force_term(float& gx, float& gy,
                                           const Sep& s, float cvx,
                                           float cvy, float cterm, float nvx,
                                           float nvy, float nm, float nrho,
                                           float nterm,
                                           const SweepParams& P) {
  const float r = sqrtf(fmaxf(s.r2, 1e-30f));
  const float term = cterm + nterm;
  const float hr = P.h - r;
  const float w_spiky = P.spiky * (hr * hr);
  const float f_press = -nm * term * w_spiky;
  gx = f_press * s.dx / r;
  gy = f_press * s.dy / r;
  const float f_visc =
      P.viscosity * nm * (P.visc_lap * hr / fmaxf(nrho, 1e-30f));
  gx = gx - f_visc * (cvx - nvx);
  gy = gy - f_visc * (cvy - nvy);
}

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
          bool ok;
          const float t = density_term(
              ok, separation(cx, cy, g.x[q], g.y[q]), g.m[q], P);
          if (ok) acc = acc + t;
        }
      }
    }
  }
  return acc;
}

// Symmetric spiky pressure force and viscosity-Laplacian force at slot
// (p, k, c), self pair excluded, gated by min_d2, h2 and min_rho on both
// sides. The density and pressure of slot (p', k', c') are rho and pres at
// (p' - rho_row0) * rho_rs + k' * W + c'. Rows outside 1..ny hold no
// particles and are not read.
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
    const float cterm = pressure_term(pres[cat], crho);
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
          const Sep sp = separation(cx, cy, g.x[q], g.y[q]);
          const size_t qr = nrho_row + (size_t)k2 * W;
          const float nrho = rho[qr];
          if (!force_counts(sp, nrho, crho_ok, P)) continue;
          float gx, gy;
          force_term(gx, gy, sp, cvx, cvy, cterm, g.vx[q], g.vy[q], g.m[q],
                     nrho, pressure_term(pres[qr], nrho), P);
          fxa = fxa + gx;
          fya = fya + gy;
        }
      }
    }
  }
  fx_out = fxa;
  fy_out = fya;
}

// The split kernels' layout: one thread per (interior row, slot, column),
// columns fastest: the flat index of the [ny, K, W] outputs and its slot
// (p, k, c) of the padded grid.
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
