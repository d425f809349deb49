// Shared definitions of the grid-resident SPH kernels.
//
// Layouts (lpe_tpu_torch/ops/sph_kernels.py): row stacks [rows, planes, K,
// W] of float32, rows = ny + 2 padded grid rows, K slots per cell, W
// padded columns. The plane orders are those of the JAX package
// (lpe_tpu/ops/pallas_sph.py:1109-1123).
//
// Every kernel is compiled with --fmad=false and without fast math: each
// product and sum rounds on its own, as in the plain PyTorch versions.
#pragma once

#include <cuda_runtime.h>

enum { ST_X = 0, ST_Y, ST_VX, ST_VY, ST_AX, ST_AY, ST_M, ST_ID, ST_OCC };
enum { M9_X = 0, M9_Y, M9_VX, M9_VY, M9_M, M9_OCC, M9_HX, M9_HY, M9_ID };
enum {
  RW_PX = 0, RW_PY, RW_VX, RW_VY, RW_OM, RW_M, RW_I, RW_RAD, RW_CIR,
  RW_MINX, RW_MINY, RW_MAXX, RW_MAXY, RW_V0
};

// columns per coupling block: the granularity of the big-solid partials
constexpr int BIG_BLOCK_COLS = 32;

// The three parameter structs mirror the ctypes Structures of
// lpe_tpu_torch/ops/_build.py field for field.
// ny and row_off: the whole grid's interior rows and the global row of the
// block's first interior row; a block of a row band (rows - 2 rows from
// row_off) clamps a particle's cell row on the whole grid
struct MigrateParams {
  int rows, K, W, nx, ny, gmin, row_off;
  float half_dt, sub_dt, lim, cell, eps;
};

struct SweepParams {
  int rows, K, W;
  float h, h2, poly6, spiky, visc_lap, viscosity, min_d2, min_rho,
      stiffness, rest_density;
};

struct CoupleParams {
  int rows, K, W, S, NBIG, V, Wp, any_circle, any_poly;
  float half_dt, stiffness, rest_density, min_safe_distance, safety_margin,
      relax_factor, max_correction, min_position_change, boundary_offset,
      min_penetration, max_safe_velocity_sq, depth_transition_rate,
      depth_scale, depth_estimate_scale, gravity, max_force,
      max_force_pressure, max_force_viscous, max_force_sq, min_rel_velocity,
      visc_vscale, sub_dt, buoyancy_strength, max_torque,
      angular_damping_threshold, angular_damping_factor, fluid_force_scale,
      fluid_force_max, two_thirds;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// jnp.clip / torch.clamp on floats: min(max(v, lo), hi)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float eos(float rho, float stiffness,
                                     float rest_density) {
  return fmaxf(stiffness * (rho - rest_density), 0.f);
}

// The devices a process may launch on: the dynamic shared memory limit of
// a kernel is set per device.
constexpr int MAX_DEVICES = 64;

// Allow `kernel` smem bytes of dynamic shared memory on the current
// device, once per device and larger size (`set` holds the size allowed
// so far on each device).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int (&set)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set[dev] = smem;
  }
  return cudaSuccess;
}

#define LPE_EXPORT extern "C" __attribute__((visibility("default")))
