// The SPH pair arithmetic, shared by the fused pair sweep (pair_sweep.cu)
// and the split density and force kernels (density.cu, force.cu).
//
// A particle is the slot (row p, slot k, column c) of a padded grid; its
// pairs are the occupied slots of its 3x3 neighbour cells, visited and
// summed in the fixed order (dy, dx, slot). The arithmetic of one pair is
// the functions below (separation, density_term; force_counts, force_term),
// and every kernel sums their terms in that order, so one input gives one
// bitwise result, whichever kernel asks. Each kernel walks the live slots
// it staged in shared memory (stage.cuh) through one loop per sum:
// staged_row_density (the sweep and the density kernel) and
// staged_row_force (the sweep and the force kernel).
#pragma once

#include "common.cuh"

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

// Mixed smoothing lengths (the _h kernels): a pair's kernel is taken at
// h-bar = (h_i + h_j) / 2 (reference: fluid_kernels.metal:362-396), with
// its normalisations computed per pair in the operation order of lpe_tpu's
// density_core and force_core (lpe_tpu/systems/fluid/sph.py:488-599), as
// the plain versions (sph_kernels.py _pair_h) compute them: powers as
// XLA's integer_pow multiplies them, x^4 = (x x)(x x), x^5 = x((x x)(x x)).
constexpr float PI_F = 3.14159265358979323846f;

__device__ __forceinline__ float hbar(float ch, float nh) {
  return 0.5f * (ch + nh);
}

// 4 / (pi max(h-bar^2, 1e-30)^4): poly6's 2D normalisation at h-bar.
__device__ __forceinline__ float poly6_at(float h2) {
  const float m = fmaxf(h2, 1e-30f);
  const float m2 = m * m;
  return 4.f / (PI_F * (m2 * m2));
}

// pi max(h-bar, 1e-30)^5: spiky's normalisation is -30 over it, the
// viscosity Laplacian's 40 over it.
__device__ __forceinline__ float pi_h5(float hb) {
  const float m = fmaxf(hb, 1e-30f);
  return PI_F * (m * ((m * m) * (m * m)));
}

// density_term at the pair's h-bar: a particle of smoothing length ch and
// a neighbour of nh.
__device__ __forceinline__ float density_term_h(bool& ok, const Sep& s,
                                                float nm, float ch,
                                                float nh) {
  const float hb = hbar(ch, nh);
  const float h2 = hb * hb;
  ok = s.r2 < h2;
  if (!ok) return 0.f;
  const float d = h2 - s.r2;
  return nm * (poly6_at(h2) * (d * d * d));
}

// force_term at the pair's h-bar hb (the pair counts: force_counts with
// r^2 < hb^2).
__device__ __forceinline__ void force_term_h(float& gx, float& gy,
                                             const Sep& s, float hb,
                                             float cvx, float cvy,
                                             float cterm, float nvx,
                                             float nvy, float nm, float nrho,
                                             float nterm,
                                             const SweepParams& P) {
  const float r = sqrtf(fmaxf(s.r2, 1e-30f));
  const float den = pi_h5(hb);
  const float spiky = -30.f / den;
  const float visc_lap = 40.f / den;
  const float term = cterm + nterm;
  const float hr = hb - r;
  const float w_spiky = spiky * (hr * hr);
  const float f_press = -nm * term * w_spiky;
  gx = f_press * s.dx / r;
  gy = f_press * s.dy / r;
  const float f_visc =
      P.viscosity * nm * (visc_lap * hr / fmaxf(nrho, 1e-30f));
  gx = gx - f_visc * (cvx - nvx);
  gy = gy - f_visc * (cvy - nvy);
}

// Add the poly6 density terms of a staged particle at (cx, cy) of window
// cell l from its neighbours in one staged row (stage.cuh: planes x, y, m
// by entry; window cell l' starts at entry start[l']), self included: the
// entries start[l - 1] .. start[l + 2] - 1, in (dx, slot) order. VAR_H:
// each pair at its h-bar, from the particle's smoothing length ch and the
// staged plane h.
template <bool VAR_H = false>
__device__ __forceinline__ void staged_row_density(
    float& acc, const float* x, const float* y, const float* m,
    const int* start, int l, float cx, float cy, const SweepParams& P,
    const float* h = nullptr, float ch = 0.f) {
  const int j1 = start[l + 2];
#pragma unroll 4
  for (int j = start[l - 1]; j < j1; ++j) {
    bool ok;
    const Sep sp = separation(cx, cy, x[j], y[j]);
    const float t = VAR_H ? density_term_h(ok, sp, m[j], ch, h[j])
                          : density_term(ok, sp, m[j], P);
    if (ok) acc = acc + t;
  }
}

// One staged row of live particles (stage.cuh): their planes by entry and
// the entry where each window cell starts. The neighbours that a particle
// of window cell l has in the row are the entries start[l - 1] ..
// start[l + 2] - 1, in (dx, slot) order.
struct StagedRow {
  const float *x, *y, *vx, *vy, *m, *rho, *term;   // term: pressure_term
  const int* start;
  const float* h = nullptr;                        // VAR_H: smoothing lengths
};

// Add the pair forces on a staged particle (position cx, cy; velocity cvx,
// cvy; pressure term cterm; its density reaches min_rho: crho_ok) from its
// neighbours in row r, in entry order, leaving out entry ``self`` (the
// particle itself, or -1). The neighbours within h are marked first (r^2 by
// the same separation()); only those pay the costly term, a sqrt and three
// IEEE divides. VAR_H: within each pair's h-bar, from the particle's
// smoothing length ch and the row's plane h, with the pair's kernels.
template <bool VAR_H = false>
__device__ __forceinline__ void staged_row_force(
    float& fxa, float& fya, const StagedRow& r, int l, int self, float cx,
    float cy, float cvx, float cvy, float cterm, bool crho_ok,
    const SweepParams& P, float ch = 0.f) {
  const int j1 = r.start[l + 2];
  for (int b = r.start[l - 1]; b < j1; b += 32) {
    const int n = min(32, j1 - b);
    unsigned near = 0u;
    for (int u = 0; u < n; ++u) {
      const float r2 = separation(cx, cy, r.x[b + u], r.y[b + u]).r2;
      float h2 = P.h2;
      if (VAR_H) {
        const float hb = hbar(ch, r.h[b + u]);
        h2 = hb * hb;
      }
      near |= (unsigned)(r2 < h2) << u;
    }
    if (self >= b && self < b + 32) near &= ~(1u << (self - b));
    while (near) {
      const int j = b + __ffs(near) - 1;
      near &= near - 1u;
      const Sep sp = separation(cx, cy, r.x[j], r.y[j]);
      float gx, gy;
      if (VAR_H) {
        // r^2 < h-bar^2 holds (the mark); the rest of force_counts
        const float hb = hbar(ch, r.h[j]);
        if (!(sp.r2 >= P.min_d2 && r.rho[j] >= P.min_rho && crho_ok))
          continue;
        force_term_h(gx, gy, sp, hb, cvx, cvy, cterm, r.vx[j], r.vy[j],
                     r.m[j], r.rho[j], r.term[j], P);
      } else {
        if (!force_counts(sp, r.rho[j], crho_ok, P)) continue;
        force_term(gx, gy, sp, cvx, cvy, cterm, r.vx[j], r.vy[j], r.m[j],
                   r.rho[j], r.term[j], P);
      }
      fxa = fxa + gx;
      fya = fya + gy;
    }
  }
}
