"""ctypes bindings for the native CPU reference engines
(native/sph_ref.cpp, native/engine_ref.cpp): the port's copy of
``lpe_tpu/oracle/native.py``.

These are the measured benchmark denominators for every BASELINE.md config
(the upstream reference publishes no numbers). The shared library is
compiled on first use (g++ is part of the toolchain); callers should catch
``NativeUnavailable`` and fall back to the NumPy oracle when no compiler is
present.

One difference from the original: where the library is built. lpe_tpu's
``_load`` runs ``make -C native``, which writes ``native/liblpe_ref.so``
in the source tree. This copy compiles the same two sources with the
Makefile's flags (``native/Makefile``'s CXXFLAGS) into the build tree,
``build/native/liblpe_ref.so`` at the repository's root, and never
writes into ``native/``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "build",
                          "native")
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
            "-fno-math-errno")
_LIB = None

_d = ctypes.POINTER(ctypes.c_double)
_i = ctypes.POINTER(ctypes.c_int)
_u8 = ctypes.POINTER(ctypes.c_ubyte)
_cd = ctypes.c_double
_ci = ctypes.c_int


class NativeUnavailable(RuntimeError):
    pass


def _build():
    """The path of ``build/native/liblpe_ref.so``, compiled from
    native/sph_ref.cpp and native/engine_ref.cpp when it is missing or
    older than either. The compiler writes a file of its own, renamed into
    place, so that processes building at once never load a half-written
    library."""
    so = os.path.abspath(os.path.join(_BUILD_DIR, "liblpe_ref.so"))
    srcs = [os.path.abspath(os.path.join(_NATIVE_DIR, f))
            for f in ("sph_ref.cpp", "engine_ref.cpp")]
    if (not os.path.exists(so)
            or any(os.path.getmtime(so) < os.path.getmtime(s)
                   for s in srcs if os.path.exists(s))):
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            os.makedirs(os.path.dirname(so), exist_ok=True)
            subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS,
                            "-o", tmp, *srcs],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError) as e:
            raise NativeUnavailable(f"cannot build native engine: {e}")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _build()
    lib = ctypes.CDLL(so)
    lib.lpe_sph_run.restype = _ci
    lib.lpe_sph_run.argtypes = [
        _ci, _d, _d, _d, _d, _d,
        _cd, _cd, _cd, _cd, _cd, _cd, _ci,
        _cd, _cd, _cd, _cd, _cd, _cd, _ci,
    ]
    lib.lpe_rigid_run.restype = _ci
    lib.lpe_rigid_run.argtypes = [
        _ci, _d, _d, _d, _d, _d, _d, _d, _i, _d, _u8, _u8,
        _cd, _cd, _cd, _cd, _cd, _cd, _ci, _ci, _cd, _cd, _cd, _ci,
    ]
    lib.lpe_nbody_run.restype = _ci
    lib.lpe_nbody_run.argtypes = [
        _ci, _d, _d, _d, _cd, _cd, _cd, _cd, _cd, _ci,
    ]
    lib.lpe_coupled_run.restype = _ci
    lib.lpe_coupled_run.argtypes = [
        _ci, _d, _d, _d,
        _ci, _d, _d, _d, _d, _d, _d, _d, _i, _d, _u8, _u8,
        _ci, _d, _d,
        _cd, _cd, _cd, _cd, _cd, _cd, _ci,
        _cd, _cd, _cd, _cd,
        _ci, _ci, _cd, _cd, _cd,
        _cd, _cd, _cd, _ci,
    ]
    _LIB = lib
    return lib


def _carr(a, dtype=np.float64):
    return np.ascontiguousarray(a, dtype)


def _p(a):
    if a.dtype == np.float64:
        return a.ctypes.data_as(_d)
    if a.dtype == np.int32:
        return a.ctypes.data_as(_i)
    return a.ctypes.data_as(_u8)


class NativeSphOracle:
    """Drop-in counterpart of
    :class:`lpe_tpu_torch.oracle.sph_numpy.SphOracle` backed by the
    native engine (same math, same tick structure)."""

    def __init__(self, *, h=0.05, rest_density=0.5, stiffness=200.0,
                 viscosity=0.03, gravity=9.8, dt_tick=1.0 / 120.0,
                 num_sub_steps=10, universe=6.0, margin=0.15,
                 bounce_damping=0.7, max_speed=1.0,
                 min_dist2=1e-14, min_density=1e-12):
        self.p = dict(h=h, rest_density=rest_density, stiffness=stiffness,
                      viscosity=viscosity, gravity=gravity, dt_tick=dt_tick,
                      num_sub_steps=num_sub_steps, universe=universe,
                      margin=margin, bounce_damping=bounce_damping,
                      max_speed=max_speed, min_dist2=min_dist2,
                      min_density=min_density)
        self._lib = _load()

    def run(self, pos, vel, mass, ticks: int):
        """Advance `ticks` ticks in place on float64 copies; returns
        (pos, vel, rho, pres)."""
        n = len(pos)
        pos = _carr(pos).copy()
        vel = _carr(vel).copy()
        mass = _carr(mass)
        rho = np.zeros(n)
        pres = np.zeros(n)
        p = self.p
        rc = self._lib.lpe_sph_run(
            n, _p(pos), _p(vel), _p(mass), _p(rho), _p(pres),
            p["h"], p["rest_density"], p["stiffness"], p["viscosity"],
            p["gravity"], p["dt_tick"], p["num_sub_steps"],
            p["universe"], p["margin"], p["bounce_damping"], p["max_speed"],
            p["min_dist2"], p["min_density"], ticks)
        if rc != 0:
            raise RuntimeError(f"lpe_sph_run failed rc={rc}")
        return pos, vel, rho, pres

    def tick(self, pos, vel, mass):
        return self.run(pos, vel, mass, 1)


class NativeRigidOracle:
    """Native rigid pipeline (native/engine_ref.cpp lpe_rigid_run):
    grid broadphase -> SAT narrowphase -> warm-started PGS -> Baumgarte
    position solve, reference budgets (10 velocity / 10 position
    iterations, mu=0.5, beta=0.02, slop=1e-3; contact_solver.hpp:22-27,
    position_solver.hpp:21-35)."""

    def __init__(self, *, gravity=9.8, dt_tick=1.0 / 120.0, universe=6.0,
                 margin=0.15, bounce_damping=0.7, max_speed=1.0,
                 vel_iters=10, pos_iters=10, mu=0.5, beta=0.02, slop=1e-3):
        self.p = dict(gravity=gravity, dt_tick=dt_tick, universe=universe,
                      margin=margin, bounce_damping=bounce_damping,
                      max_speed=max_speed, vel_iters=vel_iters,
                      pos_iters=pos_iters, mu=mu, beta=beta, slop=slop)
        self._lib = _load()

    def run(self, pos, vel, angle, omega, mass, inertia, verts, nverts,
            radius, is_circle, is_wall, ticks: int):
        n = len(pos)
        pos = _carr(pos).copy()
        vel = _carr(vel).copy()
        angle = _carr(angle).copy()
        omega = _carr(omega).copy()
        mass, inertia = _carr(mass), _carr(inertia)
        verts = _carr(verts)
        nverts = _carr(nverts, np.int32)
        radius = _carr(radius)
        is_circle = _carr(is_circle, np.uint8)
        is_wall = _carr(is_wall, np.uint8)
        p = self.p
        rc = self._lib.lpe_rigid_run(
            n, _p(pos), _p(vel), _p(angle), _p(omega), _p(mass),
            _p(inertia), _p(verts), _p(nverts), _p(radius), _p(is_circle),
            _p(is_wall), p["gravity"], p["dt_tick"], p["universe"],
            p["margin"], p["bounce_damping"], p["max_speed"],
            p["vel_iters"], p["pos_iters"], p["mu"], p["beta"], p["slop"],
            ticks)
        if rc != 0:
            raise RuntimeError(f"lpe_rigid_run failed rc={rc}")
        return pos, vel, angle, omega


class NativeNBodyOracle:
    """Native Barnes-Hut quadtree N-body (native/engine_ref.cpp
    lpe_nbody_run), theta=0.5 like the reference
    (include/systems/barnes_hut.hpp:28-46)."""

    def __init__(self, *, G, soft, theta=0.5, dt=1.0 / 120.0, universe=6.0):
        self.p = dict(G=G, soft=soft, theta=theta, dt=dt, universe=universe)
        self._lib = _load()

    def run(self, pos, vel, mass, ticks: int):
        pos = _carr(pos).copy()
        vel = _carr(vel).copy()
        mass = _carr(mass)
        p = self.p
        rc = self._lib.lpe_nbody_run(
            len(pos), _p(pos), _p(vel), _p(mass),
            p["G"], p["soft"], p["theta"], p["dt"], p["universe"], ticks)
        if rc != 0:
            raise RuntimeError(f"lpe_nbody_run failed rc={rc}")
        return pos, vel


class NativeCoupledOracle:
    """Native coupled SPH + rigid + gas engine (native/engine_ref.cpp
    lpe_coupled_run): the sph_ref SPH core with per-substep two-way
    coupling and the rigid pipeline per tick."""

    def __init__(self, *, h=0.05, rest_density=0.5, stiffness=200.0,
                 viscosity=0.03, gravity=9.8, dt_tick=1.0 / 120.0,
                 num_sub_steps=10, universe=6.0, margin=0.15,
                 bounce_damping=0.7, max_speed=1.0,
                 vel_iters=10, pos_iters=10, mu=0.5, beta=0.02, slop=1e-3,
                 relax=0.5, max_correction=0.1, drag=0.1):
        self.p = dict(h=h, rest_density=rest_density, stiffness=stiffness,
                      viscosity=viscosity, gravity=gravity, dt_tick=dt_tick,
                      num_sub_steps=num_sub_steps, universe=universe,
                      margin=margin, bounce_damping=bounce_damping,
                      max_speed=max_speed, vel_iters=vel_iters,
                      pos_iters=pos_iters, mu=mu, beta=beta, slop=slop,
                      relax=relax, max_correction=max_correction, drag=drag)
        self._lib = _load()

    def run(self, fpos, fvel, fmass, rpos, rvel, rangle, romega, rmass,
            rinertia, rverts, rnverts, rradius, ris_circle, ris_wall,
            gpos, gvel, ticks: int):
        nf, nr = len(fpos), len(rpos)
        ng = len(gpos)
        fpos, fvel = _carr(fpos).copy(), _carr(fvel).copy()
        fmass = _carr(fmass)
        rpos, rvel = _carr(rpos).copy(), _carr(rvel).copy()
        rangle, romega = _carr(rangle).copy(), _carr(romega).copy()
        rmass, rinertia = _carr(rmass), _carr(rinertia)
        rverts = _carr(rverts)
        rnverts = _carr(rnverts, np.int32)
        rradius = _carr(rradius)
        ris_circle = _carr(ris_circle, np.uint8)
        ris_wall = _carr(ris_wall, np.uint8)
        gpos, gvel = _carr(gpos).copy(), _carr(gvel).copy()
        if ng == 0:
            gpos = np.zeros((1, 2))
            gvel = np.zeros((1, 2))
        p = self.p
        rc = self._lib.lpe_coupled_run(
            nf, _p(fpos), _p(fvel), _p(fmass),
            nr, _p(rpos), _p(rvel), _p(rangle), _p(romega), _p(rmass),
            _p(rinertia), _p(rverts), _p(rnverts), _p(rradius),
            _p(ris_circle), _p(ris_wall),
            ng, _p(gpos), _p(gvel),
            p["h"], p["rest_density"], p["stiffness"], p["viscosity"],
            p["gravity"], p["dt_tick"], p["num_sub_steps"],
            p["universe"], p["margin"], p["bounce_damping"], p["max_speed"],
            p["vel_iters"], p["pos_iters"], p["mu"], p["beta"], p["slop"],
            p["relax"], p["max_correction"], p["drag"], ticks)
        if rc != 0:
            raise RuntimeError(f"lpe_coupled_run failed rc={rc}")
        # full mutated state so callers can settle, then time from the
        # settled configuration (bench.py times at contact density)
        return fpos, fvel, rpos, rvel, rangle, romega, gpos, gvel
