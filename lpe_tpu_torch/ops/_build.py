"""Build and bind the CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, which ``ctypes``
loads. The library lives in ``build/lpe_tpu_torch/`` at the root
of the checkout, under a name keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. Each C entry
launches on the caller's stream (PyTorch's current stream), allocates
nothing, and returns ``cudaGetLastError()``; a non-zero code raises here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("common.cuh", "sph_pair.cuh", "stage.cuh", "couple.cuh",
           "narrow.cuh", "migrate.cu", "pair_sweep.cu", "coupling9.cu",
           "narrowphase.cu", "narrowphase_grid.cu", "density.cu", "force.cu",
           "coupling.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lpe_tpu_torch"
# --fmad=false: no contraction of a*b+c into one rounding, so the kernels
# round like the plain PyTorch ops they are held against. No fast math:
# it would change sqrt and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_f, _i = ctypes.c_float, ctypes.c_int


class MigrateParams(ctypes.Structure):
    _fields_ = [("rows", _i), ("K", _i), ("W", _i), ("nx", _i), ("ny", _i),
                ("gmin", _i), ("row_off", _i), ("half_dt", _f),
                ("sub_dt", _f), ("lim", _f), ("cell", _f), ("eps", _f)]


class SweepParams(ctypes.Structure):
    # also the params of the split density and force kernels, which read
    # the pressure as a plane and ignore stiffness and rest_density, and
    # of their mixed-h variants, which read h as a plane and ignore h, h2,
    # poly6, spiky and visc_lap too
    _fields_ = [("rows", _i), ("K", _i), ("W", _i), ("h", _f), ("h2", _f),
                ("poly6", _f), ("spiky", _f), ("visc_lap", _f),
                ("viscosity", _f), ("min_d2", _f), ("min_rho", _f),
                ("stiffness", _f), ("rest_density", _f)]


class CoupleParams(ctypes.Structure):
    # the order of csrc/common.cuh CoupleParams; constants that the JAX
    # expressions fold in double precision before meeting an array
    # (max_force * ratio, max_force**2, viscosity * viscosity_scale) are
    # folded here the same way
    _fields_ = [("rows", _i), ("K", _i), ("W", _i), ("S", _i), ("NBIG", _i),
                ("V", _i), ("Wp", _i), ("any_circle", _i), ("any_poly", _i),
                ("half_dt", _f), ("stiffness", _f), ("rest_density", _f),
                ("min_safe_distance", _f), ("safety_margin", _f),
                ("relax_factor", _f), ("max_correction", _f),
                ("min_position_change", _f), ("boundary_offset", _f),
                ("min_penetration", _f), ("max_safe_velocity_sq", _f),
                ("depth_transition_rate", _f), ("depth_scale", _f),
                ("depth_estimate_scale", _f), ("gravity", _f),
                ("max_force", _f), ("max_force_pressure", _f),
                ("max_force_viscous", _f), ("max_force_sq", _f),
                ("min_rel_velocity", _f), ("visc_vscale", _f),
                ("sub_dt", _f), ("buoyancy_strength", _f),
                ("max_torque", _f), ("angular_damping_threshold", _f),
                ("angular_damping_factor", _f), ("fluid_force_scale", _f),
                ("fluid_force_max", _f), ("two_thirds", _f)]


class NarrowParams(ctypes.Structure):
    _fields_ = [("N", _i), ("V", _i)]


NG_MAX_CLS = 8       # classes of rows csrc/narrowphase_grid.cu takes


class NarrowGridParams(ctypes.Structure):
    _fields_ = [("NC", _i), ("KB", _i), ("R", _i), ("NBIG", _i),
                ("nbx", _i), ("V", _i), ("ncls", _i), ("npass", _i),
                ("ny", _i), ("rows", _i), ("nsb", _i),
                ("cls_end", _i * NG_MAX_CLS),
                ("cls_dx", _i * NG_MAX_CLS), ("cls_dy", _i * NG_MAX_CLS),
                ("cls_big", _i * NG_MAX_CLS), ("pass_end", _i * NG_MAX_CLS)]


def couple_params(rows, K, W, S, NBIG, cn) -> CoupleParams:
    from .sph_kernels import rig_width
    mf = cn["max_force"]
    return CoupleParams(
        rows, K, W, S, NBIG, cn["V"], rig_width(cn["V"]),
        int(bool(cn["any_circle"])), int(bool(cn["any_poly"])),
        cn["half_dt"], cn["stiffness"], cn["rest_density"],
        cn["min_safe_distance"], cn["safety_margin"], cn["relax_factor"],
        cn["max_correction"], cn["min_position_change"],
        cn["boundary_offset"], cn["min_penetration"],
        cn["max_safe_velocity_sq"], cn["depth_transition_rate"],
        cn["depth_scale"], cn["depth_estimate_scale"], cn["gravity"],
        mf, mf * cn["pressure_force_ratio"], mf * cn["viscous_force_ratio"],
        mf * mf, cn["min_rel_velocity"],
        cn["viscosity"] * cn["viscosity_scale"], cn["sub_dt"],
        cn["buoyancy_strength"], cn["max_torque"],
        cn["angular_damping_threshold"], cn["angular_damping_factor"],
        cn["fluid_force_scale"], cn["fluid_force_max"],
        float(np.float32(2.0 / 3.0)))


_ENTRIES = {   # name -> (number of tensor arguments, params type)
    "lpe_migrate": (2, MigrateParams),
    "lpe_pair_sweep": (4, SweepParams),
    "lpe_coupling9": (10, CoupleParams),
    "lpe_narrowphase": (16, NarrowParams),
    "lpe_narrowphase_grid": (20, NarrowGridParams),
    "lpe_density": (2, SweepParams),
    "lpe_force": (3, SweepParams),
    "lpe_coupling": (7, CoupleParams),
    "lpe_migrate_h": (2, MigrateParams),
    "lpe_density_h": (2, SweepParams),
    "lpe_force_h": (3, SweepParams),
}
_lib = None
build_log = ""           # nvcc's report (-Xptxas -v) of this process's build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lpe_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblpe_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source hash is already built."""
    global build_log
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs, procs = [], []
    for src in (s for s in SOURCES if s.endswith(".cu")):
        obj = tmp.with_name(f"{tmp.name}.{Path(src).stem}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
             str(CSRC / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        logs.append(f"== {src}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(src)
    if not failed:
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        logs.append(f"== link\n{r.stdout}{r.stderr}")
        if r.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{build_log}")
    os.replace(tmp, out)
    return out


def library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (n, params) in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * (n + 1) + [
                ctypes.POINTER(params)]
            fn.restype = ctypes.c_int
        lib.lpe_error_string.argtypes = [ctypes.c_int]
        lib.lpe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name, *args):
    """Launch C entry ``name`` on the current stream: tensors, then the
    params struct. Raises on a refused launch."""
    lib = library()
    *tensors, params = args
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in tensors]
    if dev.index == torch.cuda.current_device():
        err = getattr(lib, name)(*ptrs, stream, ctypes.byref(params))
    else:                   # a launch goes to its stream's device
        with torch.cuda.device(dev):
            err = getattr(lib, name)(*ptrs, stream, ctypes.byref(params))
    if err != 0:
        msg = lib.lpe_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
