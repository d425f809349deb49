// The fluid <-> rigid coupling of one particle, shared by the stacked
// coupling kernel (coupling9.cu) and the split one (coupling.cu).
//
// The math is that of lpe_tpu/ops/pallas_sph.py: hoist_particle_terms
// (:266), _cand_math (:290), _couple_rows (:488) and _couple_fin (:449),
// here hoist, cand_math, cand_add and couple_fin. Both kernels use a block
// of one grid row, BIG_BLOCK_COLS columns and all K slots (K <= 32), one
// thread per (slot, column), columns fastest. The per-(row, slot, column)
// partials and the per-block big-solid sums are reduced in shared memory in
// a fixed order, never with float atomics, so one input gives one bitwise
// result. couple_block is the split kernel's block body: every thread walks
// every candidate that some particle of the block lies in the box of
// (__syncthreads_or; the TPU kernel skipped per tile).
#pragma once

#include "common.cuh"

namespace {

struct Hoist {
  float parea, vmul, bmul;
};

__device__ __forceinline__ Hoist hoist(const CoupleParams& P, float py,
                                       float rho, float p, float m) {
  const bool pos = rho > 0.f;
  const float dens = pos ? rho : P.rest_density;
  const float vol = pos ? m / fmaxf(rho, 1e-30f) : m / P.rest_density;
  const float area = powf(fabsf(vol), P.two_thirds);
  const float depth = fminf(py / P.depth_estimate_scale, 1.f);
  const float hydro = dens * P.gravity * depth;
  Hoist h;
  h.parea = (p + hydro) * area;
  h.vmul = P.visc_vscale * dens * P.sub_dt;
  h.bmul = P.buoyancy_strength * area * P.gravity * dens;
  return h;
}

struct Cand {
  bool inside, act;
  float corr_x, corr_y, fx, fy, tq;
};

// One candidate against one particle; prm(i) = prm[i * stride].
__device__ Cand cand_math(const CoupleParams& P, const float* prm,
                          int stride, bool in_aabb, float px, float py,
                          float vx1, float vy1, const Hoist& hp) {
  auto g = [&](int i) { return prm[(size_t)i * stride]; };
  const float rpx = g(RW_PX), rpy = g(RW_PY);
  const float rvxs = g(RW_VX), rvys = g(RW_VY), rom = g(RW_OM);
  const float rmass = g(RW_M), rinert = g(RW_I), rrad = g(RW_RAD);
  const float rx = px - rpx;
  const float ry = py - rpy;
  float dist_c = 1.f;
  bool inside_c = false;
  if (P.any_circle) {
    const float d2 = rx * rx + ry * ry;
    dist_c = sqrtf(fmaxf(d2, 1e-30f));
    inside_c = d2 < rrad * rrad;
  }
  int parity = 0;
  float best_d2 = 1e30f, cxb = 0.f, cyb = 0.f;
  if (P.any_poly) {
    const int V = P.V;
    for (int v = 0; v < V; ++v) {
      const int vp = (v + V - 1) % V, vn = (v + 1) % V;
      const float xi = g(RW_V0 + 2 * v), yi = g(RW_V0 + 2 * v + 1);
      const float xj = g(RW_V0 + 2 * vp), yj = g(RW_V0 + 2 * vp + 1);
      const float denom = yj - yi;
      const float denc = fabsf(denom) < 1e-30f ? 1e-30f : denom;
      const float lhs = (px - xi) * denc;
      const float rhs = (xj - xi) * (py - yi);
      const bool straddle = (yi > py) != (yj > py);
      const bool pos = denc > 0.f;
      const bool crosses =
          straddle && ((pos && lhs < rhs) || (!pos && lhs > rhs));
      parity += crosses ? 1 : 0;
      const float x2s = g(RW_V0 + 2 * vn), y2s = g(RW_V0 + 2 * vn + 1);
      const float ex = x2s - xi;
      const float ey = y2s - yi;
      const float el2 = ex * ex + ey * ey;
      const float iel = 1.f / (el2 < 1e-16f ? 1e-16f : el2);
      float tt = ((px - xi) * ex + (py - yi) * ey) * iel;
      tt = clampf(tt, 0.f, 1.f);
      const float qx = xi + tt * ex;
      const float qy = yi + tt * ey;
      float qd2 = (px - qx) * (px - qx) + (py - qy) * (py - qy);
      qd2 = el2 >= 1e-16f ? qd2 : 1e30f;
      if (qd2 < best_d2) {
        best_d2 = qd2;
        cxb = qx;
        cyb = qy;
      }
    }
  }
  const bool inside_p = (parity % 2) == 1;
  const float pdx = px - cxb;
  const float pdy = py - cyb;
  const float dist_p = sqrtf(fmaxf(pdx * pdx + pdy * pdy, 1e-30f));
  bool is_c;
  bool inside_s;
  if (P.any_circle && P.any_poly) {
    is_c = g(RW_CIR) > 0.f;
    inside_s = (is_c && inside_c) || (!is_c && inside_p);
  } else {
    is_c = P.any_circle != 0;
    inside_s = is_c ? inside_c : inside_p;
  }
  Cand o;
  o.inside = in_aabb && inside_s;

  // position correction (metal:533-668)
  const float msd = P.min_safe_distance;
  const float d_c = fmaxf(dist_c, msd);
  const float inv_dc = 1.f / d_c;
  const float dirx_c = dist_c < msd ? 1.f : rx * inv_dc;
  const float diry_c = dist_c < msd ? 0.f : ry * inv_dc;
  const float pen_c = (rrad - d_c) + P.safety_margin;
  const float d_p = fmaxf(dist_p, msd);
  const float inv_dp = 1.f / d_p;
  const float dirx_p = dist_p < msd ? 1.f : pdx * inv_dp;
  const float diry_p = dist_p < msd ? 0.f : pdy * inv_dp;
  const float pen_p = d_p + P.safety_margin;
  const float cxr = is_c ? -dirx_c * pen_c : dirx_p * pen_p;
  const float cyr = is_c ? -diry_c * pen_c : diry_p * pen_p;
  o.corr_x = o.inside ? cxr * P.relax_factor : 0.f;
  o.corr_y = o.inside ? cyr * P.relax_factor : 0.f;

  // impulse exchange (metal:679-924)
  const float mpen = P.min_penetration;
  const float rb_v2 = rvxs * rvxs + rvys * rvys + rom * rom;
  const bool ok_r = rb_v2 <= P.max_safe_velocity_sq;
  const float pen = is_c ? fmaxf(rrad - fmaxf(dist_c, mpen), 0.f)
                         : fmaxf(dist_p, mpen);
  const float inv_nc = 1.f / fmaxf(dist_c, mpen);
  const float inv_np = 1.f / fmaxf(dist_p, mpen);
  const float nrm_x = is_c ? rx * inv_nc : pdx * inv_np;
  const float nrm_y = is_c ? ry * inv_nc : pdy * inv_np;
  o.act = o.inside && ok_r && (pen >= mpen);
  const float rig_vx = rvxs - rom * ry;
  const float rig_vy = rvys + rom * rx;
  const float rvx = vx1 - rig_vx;
  const float rvy = vy1 - rig_vy;
  const float depth_f = tanhf(P.depth_transition_rate * pen / P.depth_scale);
  const float vn = rvx * nrm_x + rvy * nrm_y;
  const float tvx = rvx - nrm_x * vn;
  const float tvy = rvy - nrm_y * vn;
  const float pforce = hp.parea * depth_f;
  float fx = nrm_x * fminf(pforce, P.max_force_pressure);
  float fy = nrm_y * fminf(pforce, P.max_force_pressure);
  const float tmag = sqrtf(tvx * tvx + tvy * tvy);
  const bool hast = tmag > P.min_rel_velocity;
  const float vforce = hp.vmul * tmag * depth_f;
  const float vcap = fminf(vforce, P.max_force_viscous);
  const float tdir = vcap / fmaxf(tmag, 1e-30f);
  fx = fx + (hast ? -tvx * tdir : 0.f);
  fy = fy + (hast ? -tvy * tdir : 0.f);
  const float buoy = -(hp.bmul * pen);
  const float bfy = rmass > 0.1f ? buoy : 0.f;
  const float fyb = fy + bfy;
  if (fx * fx + fyb * fyb <= P.max_force_sq) fy = fyb;
  const float fmag2 = fx * fx + fy * fy;
  const float fscale = fmag2 > P.max_force_sq
                           ? P.max_force * rsqrtf(fmaxf(fmag2, 1e-30f))
                           : 1.f;
  fx = fx * fscale;
  fy = fy * fscale;
  float tq = clampf(rx * fy - ry * fx, -P.max_torque, P.max_torque);
  if (fabsf(rom) > P.angular_damping_threshold) {
    const float sgn = rom > 0.f ? 1.f : (rom < 0.f ? -1.f : 0.f);
    tq = tq - P.angular_damping_factor * sgn * fabsf(rom) * rinert;
  }
  o.fx = o.act ? fx : 0.f;
  o.fy = o.act ? fy : 0.f;
  o.tq = o.act ? tq : 0.f;
  return o;
}

__device__ __forceinline__ bool in_box(const float* prm, int stride,
                                       float px, float py, bool live) {
  return live && px >= prm[(size_t)RW_MINX * stride] &&
         px <= prm[(size_t)RW_MAXX * stride] &&
         py >= prm[(size_t)RW_MINY * stride] &&
         py <= prm[(size_t)RW_MAXY * stride] &&
         prm[(size_t)RW_M * stride] > 0.f;
}

// What the coupling needs of one particle: its position, its velocity
// after the second kick, density, pressure, mass, the pair acceleration,
// and whether it couples at all (an occupied slot of a cell with cpl > 0).
struct CoupleIn {
  float px, py, vx1, vy1, rho, pe, m, ax, ay;
  bool live;
};

struct CoupleOut {
  float x, y, vx, vy, ax, ay;
};

// A particle's sums over its candidates, in candidate order.
struct CoupleAcc {
  float acx, acy, sfx, sfy;
  bool had_pos, had_imp;
};

__device__ __forceinline__ void cand_add(CoupleAcc& a, const Cand& o) {
  a.acx = a.acx + o.corr_x;
  a.acy = a.acy + o.corr_y;
  a.sfx = a.sfx + o.fx;
  a.sfy = a.sfy + o.fy;
  a.had_pos = a.had_pos || o.inside;
  a.had_imp = a.had_imp || o.act;
}

// Fluid back-reaction, capped push-out and PBD velocity fix-up: the
// particle's new state. With no candidate (zero sums, no flag) it is the
// copy-through, with the floor clamp on the position.
__device__ __forceinline__ CoupleOut couple_fin(const CoupleParams& P,
                                                const CoupleAcc& a,
                                                const CoupleIn& in) {
  const float px = in.px, py = in.py, vx1 = in.vx1, vy1 = in.vy1;
  const float m = in.m;
  const float acx = a.acx, acy = a.acy;
  const float ffx = -a.sfx * P.fluid_force_scale;
  const float ffy = -a.sfy * P.fluid_force_scale;
  const float fm = sqrtf(ffx * ffx + ffy * ffy);
  const float fsc =
      fm > P.fluid_force_max ? P.fluid_force_max / fmaxf(fm, 1e-30f) : 1.f;
  const float inv_m = m > 1e-4f ? 1.f / m : 1.f;
  const float axo = a.had_imp ? in.ax + ffx * fsc * inv_m : in.ax;
  const float ayo = a.had_imp ? in.ay + ffy * fsc * inv_m : in.ay;
  const float mag = sqrtf(acx * acx + acy * acy);
  const float scale =
      mag > P.max_correction ? P.max_correction / fmaxf(mag, 1e-30f) : 1.f;
  float nx_ = px - acx * scale;
  float ny_ = py - acy * scale;
  nx_ = nx_ < 0.f ? P.boundary_offset : nx_;
  ny_ = ny_ < 0.f ? P.boundary_offset : ny_;
  const float ddx = nx_ - px;
  const float ddy = ny_ - py;
  const float dmag = sqrtf(ddx * ddx + ddy * ddy);
  const bool moved = a.had_pos && dmag > P.min_position_change;
  const float cdx = ddx / fmaxf(dmag, 1e-30f);
  const float cdy = ddy / fmaxf(dmag, 1e-30f);
  const float valong = vx1 * cdx + vy1 * cdy;
  const bool fix = moved && valong < 0.f;
  CoupleOut o;
  o.x = nx_;
  o.y = ny_;
  o.vx = fix ? vx1 - valong * cdx : vx1;
  o.vy = fix ? vy1 - valong * cdy : vy1;
  o.ax = axo;
  o.ay = ayo;
  return o;
}

// Shared memory of a coupling block: red[3][K][BIG_BLOCK_COLS] floats.
inline size_t couple_smem(const CoupleParams* P) {
  return 3 * (size_t)P->K * BIG_BLOCK_COLS * sizeof(float);
}

// Zero the partial outputs of row p in this block's columns (an apron row,
// or a block with no coupled particle).
__device__ __forceinline__ void couple_zero_partials(const CoupleParams& P,
                                                     float* pl, float* bigp,
                                                     int p, int c,
                                                     bool col_ok) {
  if (col_ok && threadIdx.y == 0)
    for (int i = 0; i < 3 * P.S; ++i)
      pl[((size_t)p * 3 * P.S + i) * P.W + c] = 0.f;
  if (threadIdx.x == 0 && threadIdx.y == 0)
    for (int i = 0; i < 3 * P.NBIG; ++i)
      bigp[((size_t)p * gridDim.x + blockIdx.x) * 3 * P.NBIG + i] = 0.f;
}

// Couple the block's particles (threadIdx.x = column in the block,
// threadIdx.y = slot) of interior row p against the <= S rigids rasterized
// to each column's cell and the NBIG big solids. Every thread of the block
// must call it (it synchronizes). Writes pl [rows, 3S, W] and bigp [rows,
// NB, 3 NBIG] of this block; returns the particle's new state (for a
// particle that does not couple: unchanged but for the floor clamp).
__device__ __forceinline__ CoupleOut couple_block(
    const CoupleParams& P, const float* __restrict__ fld,
    const float* __restrict__ big, float* __restrict__ pl,
    float* __restrict__ bigp, float* red, int p, int c, bool col_ok,
    const CoupleIn& in) {
  const int K = P.K, W = P.W, S = P.S, NBIG = P.NBIG, Wp = P.Wp;
  const int tx = threadIdx.x, k = threadIdx.y;
  const int NB = gridDim.x;
  float* red_x = red;
  float* red_y = red + K * BIG_BLOCK_COLS;
  float* red_t = red + 2 * K * BIG_BLOCK_COLS;
  const int ridx = k * BIG_BLOCK_COLS + tx;
  const float px = in.px, py = in.py, vx1 = in.vx1, vy1 = in.vy1;
  const bool live = in.live;
  const Hoist hp = hoist(P, py, in.rho, in.pe, in.m);
  CoupleAcc acc = {0.f, 0.f, 0.f, 0.f, false, false};

  // rasterized per-cell candidates: one column's slot s shares its params
  for (int s = 0; s < S; ++s) {
    const float* prm = fld + ((size_t)(p * S + s) * Wp) * W + c;
    const bool inb = col_ok && in_box(prm, W, px, py, live);
    float cfx = 0.f, cfy = 0.f, ctq = 0.f;
    if (__syncthreads_or(inb)) {
      if (col_ok) {
        const Cand o = cand_math(P, prm, W, inb, px, py, vx1, vy1, hp);
        cand_add(acc, o);
        cfx = o.fx;
        cfy = o.fy;
        ctq = o.tq;
      }
    }
    red_x[ridx] = cfx;
    red_y[ridx] = cfy;
    red_t[ridx] = ctq;
    __syncthreads();
    if (k == 0 && col_ok) {            // fixed-order sum over the K slots
      float a = 0.f, b = 0.f, t = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        a = a + red_x[kk * BIG_BLOCK_COLS + tx];
        b = b + red_y[kk * BIG_BLOCK_COLS + tx];
        t = t + red_t[kk * BIG_BLOCK_COLS + tx];
      }
      float* o = pl + ((size_t)p * 3 * S + 3 * s) * W + c;
      o[0] = a;
      o[W] = b;
      o[2 * W] = t;
    }
    __syncthreads();
  }

  // big solids: one dense parameter row each, shared by the whole block
  for (int bi = 0; bi < NBIG; ++bi) {
    const float* prm = big + (size_t)bi * Wp;
    const bool inb = col_ok && in_box(prm, 1, px, py, live);
    float cfx = 0.f, cfy = 0.f, ctq = 0.f;
    if (__syncthreads_or(inb)) {
      if (col_ok) {
        const Cand o = cand_math(P, prm, 1, inb, px, py, vx1, vy1, hp);
        cand_add(acc, o);
        cfx = o.fx;
        cfy = o.fy;
        ctq = o.tq;
      }
    }
    red_x[ridx] = cfx;
    red_y[ridx] = cfy;
    red_t[ridx] = ctq;
    __syncthreads();
    if (k == 0) {                      // per column over K, fixed order
      float a = 0.f, b = 0.f, t = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        a = a + red_x[kk * BIG_BLOCK_COLS + tx];
        b = b + red_y[kk * BIG_BLOCK_COLS + tx];
        t = t + red_t[kk * BIG_BLOCK_COLS + tx];
      }
      red_x[tx] = a;
      red_y[tx] = b;
      red_t[tx] = t;
    }
    __syncthreads();
    if (k == 0 && tx == 0) {           // then over the block's columns
      float a = 0.f, b = 0.f, t = 0.f;
      for (int cc = 0; cc < BIG_BLOCK_COLS; ++cc) {
        a = a + red_x[cc];
        b = b + red_y[cc];
        t = t + red_t[cc];
      }
      float* o = bigp + ((size_t)p * NB + blockIdx.x) * 3 * NBIG + 3 * bi;
      o[0] = a;
      o[1] = b;
      o[2] = t;
    }
    __syncthreads();
  }

  return couple_fin(P, acc, in);
}

}  // namespace
