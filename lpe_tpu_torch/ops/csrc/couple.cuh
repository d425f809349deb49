// The fluid <-> rigid coupling of one particle and the block body of both
// coupling kernels: the stacked one (coupling9.cu) and the split one
// (coupling.cu).
//
// The math is that of lpe_tpu/ops/pallas_sph.py: hoist_particle_terms
// (:266), _cand_math (:290), _couple_rows (:488) and _couple_fin (:449),
// here hoist, cand_math, cand_add and couple_fin. couple_rows is the block
// body: a block of one grid row, BIG_BLOCK_COLS columns and all K slots
// (K <= 64), one thread per (slot, column) up to K = 32 and per (slot
// pair k, k + 32, column) above, columns fastest. The two
// kernels differ only in the slot source they hand it (what a slot loads
// and where its new state is stored), so on one sub-step they give the
// same bits. The per-(row, slot, column) partials and the per-block
// big-solid sums are reduced in shared memory in a fixed order, never with
// float atomics, so one input gives one bitwise result.
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

// A coupling block is BIG_BLOCK_COLS x min(K, 32) threads: up to 1024 at
// K >= 32, where a thread may hold at most 64 registers; unbounded, the
// candidate math takes 96. So both coupling kernels take
// __launch_bounds__(COUPLE_THREADS), which holds them to 64 registers
// (ptxas spills the rest). At K = 16 (the dam's K) two blocks of 512
// threads are then resident an SM: on an H100 at DAM_BREAK 100k two beat
// one (the loads of a copy-through block overlap another's stores; the
// candidate math's latency hides behind twice the warps) and three (fewer
// registers, more spills). SIMPLE_FLUID's coupling9, whose few coupled
// blocks each wait on their own candidate loop, pays the spills: PERF.md.
// Above K = 32 a block of 2,048 threads cannot launch, so a thread takes
// the slots k and k + 32 of its column (couple_rows<2>); the sums keep
// their order, so a cell's partials do not depend on the tier.
constexpr int COUPLE_THREADS = BIG_BLOCK_COLS * 32;

// The block of a coupling kernel at K slots.
inline dim3 couple_block(int K) {
  return dim3(BIG_BLOCK_COLS, K < 32 ? K : 32);
}

// Shared memory of a coupling block: floats red[3][K][BIG_BLOCK_COLS] and
// colsum[3][BIG_BLOCK_COLS], ints list[K * BIG_BLOCK_COLS] and
// count[max(K, BIG_BLOCK_COLS)].
inline size_t couple_smem(const CoupleParams* P) {
  const size_t kc = (size_t)P->K * BIG_BLOCK_COLS;
  const size_t nc = P->K > BIG_BLOCK_COLS ? P->K : BIG_BLOCK_COLS;
  return (3 * kc + 3 * BIG_BLOCK_COLS + kc + nc) * 4;
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

// The block body of a coupling kernel: grid (column blocks, rows), block
// couple_block(K) (BIG_BLOCK_COLS columns, min(K, 32) slot rows), shared
// memory couple_smem; NS = 1 for K <= 32 and 2 above (a thread of slot row
// y takes slots y and y + 32). Couples the particles of row blockIdx.y in
// the block's columns against the <= S rigids rasterized to each column's
// cell (fld [rows, S, Wp, W]) and the NBIG big solids (big [NBIG+1, Wp]);
// writes PL [rows, 3S, W] and bigp [rows, NB, 3 NBIG] of this block.
// ``src`` is the kernel's slot source:
// - Slot: holds ``CoupleIn in`` and whatever its store needs;
// - first(P, p, k, c): a slot's ``in.live`` flag (an occupied slot of a
//   cell with cpl > 0) and the input of its copy-through (couple_fin with
//   no candidate, which reads px, py, vx1, vy1, ax and ay);
// - full(P, p, k, c): all of a live slot's input;
// - store(P, p, k, c, out, slot): its new state; zero(P, p, k, c): an apron
//   slot's.
//
// What bounds it on the H100: in most blocks, bytes. Where no particle of
// a block couples (every cell of DAM_BREAK's main path: its boundary
// margin keeps the fluid off the walls) the kernel is a copy. Where
// particles couple, the latency and divergence of the per-candidate math
// (a few hundred float32 operations with sqrt, tanh, pow and divides per
// particle and candidate) and the candidate-parameter loads.
//
// Design:
// - One block-wide vote (__syncthreads_count) over the threads' live
//   flags. A block with none copies through: couple_fin with no candidate
//   (the floor clamp), the new state and zero partials; no hoist,
//   candidate loop, barrier or reduction.
// - Otherwise the block lists its live slots (a ballot per warp and slot)
//   and the first nlive list entries go one to a thread (two a thread
//   above 1024), so the candidate math runs in full warps. A candidate
//   with no live particle in its box is skipped by the block
//   (__syncthreads_or, the TPU kernel's per-tile skip).
// - The partials are summed per column over the K slots in slot order
//   (empty slots add +0), then per block over the columns in order; each
//   particle sums its candidates in candidate order through cand_math,
//   cand_add and couple_fin.
template <int NS, class Src>
__device__ __forceinline__ void couple_rows(const CoupleParams& P,
                                            const float* __restrict__ fld,
                                            const float* __restrict__ big,
                                            float* __restrict__ pl,
                                            float* __restrict__ bigp,
                                            float* red, const Src& src) {
  const int K = P.K, W = P.W, S = P.S, NBIG = P.NBIG, Wp = P.Wp;
  const int KC = K * BIG_BLOCK_COLS;
  const int NT = BIG_BLOCK_COLS * blockDim.y;    // threads of the block
  const int tx = threadIdx.x, ky = threadIdx.y;
  const int t = ky * BIG_BLOCK_COLS + tx;     // warp ky, lane tx
  const int c0 = blockIdx.x * BIG_BLOCK_COLS;
  const int c = c0 + tx;
  const int p = blockIdx.y;
  const bool col_ok = c < W;
  using Slot = typename Src::Slot;
  // slot j of this thread: ky + 32 j, if below K
  auto slot_ok = [&](int j) { return col_ok && ky + 32 * j < K; };

  if (p == 0 || p == P.rows - 1) {          // apron rows: all zero
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (slot_ok(j)) src.zero(P, p, ky + 32 * j, c);
    couple_zero_partials(P, pl, bigp, p, c, col_ok);
    return;
  }

  Slot me[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    me[j] = Slot{};
    if (slot_ok(j)) me[j] = src.first(P, p, ky + 32 * j, c);
  }
  float* red_x = red;
  float* red_y = red + KC;
  float* red_t = red + 2 * KC;
  float* colsum = red + 3 * KC;                // [3][BIG_BLOCK_COLS]
  int* list = reinterpret_cast<int*>(colsum + 3 * BIG_BLOCK_COLS);
  int* count = list + KC;                      // live slots per slot row
  unsigned ball[NS];
  int nlive = 0;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    ball[j] = __ballot_sync(0xffffffffu, me[j].in.live);
    if (tx == 0 && ky + 32 * j < K) count[ky + 32 * j] = __popc(ball[j]);
    nlive += __syncthreads_count(me[j].in.live);
  }
  const CoupleAcc none = {0.f, 0.f, 0.f, 0.f, false, false};

  if (nlive == 0) {                           // copy-through block
    couple_zero_partials(P, pl, bigp, p, c, col_ok);
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (slot_ok(j))
        src.store(P, p, ky + 32 * j, c, couple_fin(P, none, me[j].in),
                  me[j]);
    return;
  }

  // the live slots, slot-major: list entry i goes to thread i % NT
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int k = ky + 32 * j;
    if (me[j].in.live) {
      int base = 0;
      for (int w = 0; w < k; ++w) base += count[w];
      list[base + __popc(ball[j] & ((1u << tx) - 1u))] =
          k * BIG_BLOCK_COLS + tx;
    }
    if (k < K) {                              // empty slots sum as +0
      red_x[k * BIG_BLOCK_COLS + tx] = 0.f;
      red_y[k * BIG_BLOCK_COLS + tx] = 0.f;
      red_t[k * BIG_BLOCK_COLS + tx] = 0.f;
    }
  }
  __syncthreads();
  bool has[NS];
  int ridx[NS], ic[NS], ik[NS];
  Slot it[NS];
  Hoist hp[NS];
  CoupleAcc acc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    has[j] = t + NT * j < nlive;
    ridx[j] = ic[j] = ik[j] = 0;
    it[j] = me[j];
    hp[j] = {0.f, 0.f, 0.f};
    acc[j] = none;
    if (has[j]) {
      ridx[j] = list[t + NT * j];
      ik[j] = ridx[j] / BIG_BLOCK_COLS;
      ic[j] = c0 + ridx[j] % BIG_BLOCK_COLS;
      it[j] = src.full(P, p, ik[j], ic[j]);
      hp[j] = hoist(P, it[j].in.py, it[j].in.rho, it[j].in.pe, it[j].in.m);
    }
  }
  // listed particle j against one candidate (parameter i at prm[i *
  // stride]): its sums, and its force and torque into the slot's red entry
  // (+0 where the particle is not in the candidate's box)
  auto add_cand = [&](int j, const float* prm, int stride, bool inb) {
    Cand r = {false, false, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (inb) {
      const CoupleIn& in = it[j].in;
      r = cand_math(P, prm, stride, true, in.px, in.py, in.vx1, in.vy1,
                    hp[j]);
      cand_add(acc[j], r);
    }
    red_x[ridx[j]] = r.fx;
    red_y[ridx[j]] = r.fy;
    red_t[ridx[j]] = r.tq;
  };

  // rasterized per-cell candidates: one column's slot s shares its params
  for (int s = 0; s < S; ++s) {
    const float* prm[NS];
    bool inb[NS], any = false;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      prm[j] = fld + ((size_t)(p * S + s) * Wp) * W + ic[j];
      inb[j] = has[j] && in_box(prm[j], W, it[j].in.px, it[j].in.py, true);
      any = any || inb[j];
    }
    float* o = pl + ((size_t)p * 3 * S + 3 * s) * W + c;
    if (!__syncthreads_or(any)) {
      if (ky == 0 && col_ok) o[0] = o[W] = o[2 * W] = 0.f;
      continue;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (has[j]) add_cand(j, prm[j], W, inb[j]);
    __syncthreads();
    if (ky == 0 && col_ok) {                  // fixed-order sum over slots
      float a = 0.f, b = 0.f, q = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        a = a + red_x[kk * BIG_BLOCK_COLS + tx];
        b = b + red_y[kk * BIG_BLOCK_COLS + tx];
        q = q + red_t[kk * BIG_BLOCK_COLS + tx];
      }
      o[0] = a;
      o[W] = b;
      o[2 * W] = q;
    }
    __syncthreads();
  }

  // big solids: one dense parameter row each, shared by the whole block
  const int NB = gridDim.x;
  for (int bi = 0; bi < NBIG; ++bi) {
    const float* prm = big + (size_t)bi * Wp;
    bool inb[NS], any = false;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      inb[j] = has[j] && in_box(prm, 1, it[j].in.px, it[j].in.py, true);
      any = any || inb[j];
    }
    float* o = bigp + ((size_t)p * NB + blockIdx.x) * 3 * NBIG + 3 * bi;
    if (!__syncthreads_or(any)) {
      if (t == 0) o[0] = o[1] = o[2] = 0.f;
      continue;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (has[j]) add_cand(j, prm, 1, inb[j]);
    __syncthreads();
    if (ky == 0) {                            // per column over K, in order
      float a = 0.f, b = 0.f, q = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        a = a + red_x[kk * BIG_BLOCK_COLS + tx];
        b = b + red_y[kk * BIG_BLOCK_COLS + tx];
        q = q + red_t[kk * BIG_BLOCK_COLS + tx];
      }
      colsum[tx] = a;
      colsum[BIG_BLOCK_COLS + tx] = b;
      colsum[2 * BIG_BLOCK_COLS + tx] = q;
    }
    __syncthreads();
    if (t == 0) {                             // then over the columns
      float a = 0.f, b = 0.f, q = 0.f;
      for (int cc = 0; cc < BIG_BLOCK_COLS; ++cc) {
        a = a + colsum[cc];
        b = b + colsum[BIG_BLOCK_COLS + cc];
        q = q + colsum[2 * BIG_BLOCK_COLS + cc];
      }
      o[0] = a;
      o[1] = b;
      o[2] = q;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (has[j])
      src.store(P, p, ik[j], ic[j], couple_fin(P, acc[j], it[j].in), it[j]);
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (slot_ok(j) && !me[j].in.live)
      src.store(P, p, ky + 32 * j, c, couple_fin(P, none, me[j].in), me[j]);
}

}  // namespace
