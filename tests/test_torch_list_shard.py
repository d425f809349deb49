"""The rigid list pipeline over a band mesh (``systems/rigid/pipeline.py``
with a ``mesh``: the narrowphase by runs of pairs, the solvers' row math
by runs of rows), on CPU meshes (``make_mesh(devices=["cpu"] * D)``),
and the port's copy of the native reference engines' binding
(``lpe_tpu_torch/oracle/native.py``).

Tolerances:

- the split against the port's single device: to the bit, in ``pos``,
  ``vel``, ``angle``, ``omega`` and the warm-start caches (every op of a
  run is per pair or per row, and each body's impulses are summed on the
  lead device in row order). lpe_tpu's sharded tolerances (pos 1e-5 m,
  vel and omega 1e-4, tests/test_parallel.py:38-52, 100-112) are the
  weaker bound; the split is held to the bit here;
- the native SPH engine against the port's float64 NumPy oracle: |dpos|
  and |drho| < 1e-5 after 3 ticks, tests/test_render_io.py's bound for
  lpe_tpu's pair (both float64, pairs summed in other orders);
- the copy of ``native.py`` against lpe_tpu's: equal statement for
  statement but for docstrings and the build (see
  ``test_native_copy_equals_lpe_tpus``).
"""
import ast
import dataclasses
import hashlib
import os
import subprocess

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS = 3
FIELDS = ("pos", "vel", "angle", "omega")
WARM = ("warm_normal", "warm_tangent", "warm_ia", "warm_ib", "warm_pt",
        "warm_n")


def cpu_mesh(n, devices=None):
    """A mesh of ``n`` CPU devices: ``["cpu"] * n``, or ``devices``, which
    may name the CPU by distinct device objects (``cpu`` and ``cpu:0``
    compare unequal, as two cards do, and hold the same memory)."""
    from lpe_tpu_torch.parallel import make_mesh
    return make_mesh(n, devices=devices or ["cpu"] * n)


def run_both(sc, D, ticks=TICKS, devices=None):
    """``ticks`` ticks of ``sc`` on one device and over a D-device CPU
    mesh (``cpu_mesh``): (single-device state, mesh state, the mesh's
    rigid step)."""
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    from lpe_tpu_torch.systems import build_tick_fn
    one = build_tick_fn(sc.spec, sc.cfg, device="cpu")
    tick = build_sharded_tick(sc, cpu_mesh(D, devices))
    a = b = sc.state
    for _ in range(ticks):
        a, b = one(a), tick(b)
    return a, b, tick.systems["rigid"]


def assert_same_bits(want, got, caches=True):
    for f in FIELDS:
        assert torch.equal(getattr(got.bodies, f), getattr(want.bodies, f)), f
    for f in WARM if caches else ():
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def random_polygons(**rigid):
    from lpe_tpu_torch.scenarios import create_scenario
    sc = create_scenario("RANDOM_POLYGONS", seed=1, device="cpu")
    if rigid:
        sc.cfg = sc.cfg.replace(rigid=dataclasses.replace(sc.cfg.rigid,
                                                          **rigid))
    return sc


@pytest.mark.parametrize("D", [2, 3, 8])
def test_random_polygons_split_equals_one_device(D):
    """RANDOM_POLYGONS (seed 1: 4 walls and 100 polygons, max_pairs 1024)
    in D shards, 3 ticks: the state and the warm caches to the bit."""
    sc = random_polygons()
    want, got, step = run_both(sc, D)
    assert step.shards == D and step.mesh is not None
    assert step.shard_stats["copies"] > 0 and step.shard_stats["bytes"] > 0
    assert bool(want.bodies.vel.abs().max() > 0)
    assert_same_bits(want, got)


def test_guarded_rigid_stacks_split_equals_one_device():
    """build_rigid_stacks(200) from rest, 6 ticks: the list pipeline with
    persist_slack_m 0.04, in 3 shards; the guard rebuilds on the first
    ticks (the overlaps of the random placement push bodies apart) and
    reuses the pairs on later ones, one host read a tick, and the state and
    caches equal the single device's to the bit on both kinds of tick."""
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    from lpe_tpu_torch.scenarios.bench_scenes import build_rigid_stacks
    from lpe_tpu_torch.systems import build_tick_fn
    sc = build_rigid_stacks(200, device="cpu")
    assert sc.cfg.rigid.broadphase.persist_slack_m == 0.04
    # at rest, so that the pairs of the first tick's build stay within the
    # slack for the next ticks
    b = sc.state.bodies
    sc.state = sc.state.replace(bodies=b.replace(
        vel=torch.zeros_like(b.vel), omega=torch.zeros_like(b.omega)))
    one = build_tick_fn(sc.spec, sc.cfg, device="cpu")
    tick = build_sharded_tick(sc, cpu_mesh(3))
    step = tick.systems["rigid"]
    assert step.shards == 3 and not hasattr(step, "bands")
    a = b = sc.state
    rebuilt = []
    for t in range(6):
        before = step.rebuilds
        a, b = one(a), tick(b)
        rebuilt.append(step.rebuilds > before)
        assert step.guard_reads == t + 1
        assert_same_bits(a, b)
        for f in ("bp_ia", "bp_ib", "bp_anchor_pos", "bp_anchor_ang"):
            assert torch.equal(getattr(b, f), getattr(a, f)), f
    assert rebuilt[0] and not all(rebuilt), rebuilt


@pytest.mark.parametrize("case", ["cold", "fr_jacobi"])
def test_solver_branches_split_equal_one_device(case):
    """The velocity solver without warm starts, and its staged branch
    with synchronous friction (stages 2, friction_stages 1) beside a
    staged position solver (stages 2), in 3 shards: to the bit."""
    from lpe_tpu_torch.core.config import (ContactSolverConfig,
                                           PositionSolverConfig)
    if case == "cold":
        sc = random_polygons(warm_start=False)
    else:
        sc = random_polygons(
            solver=ContactSolverConfig(stages=2, friction_stages=1),
            position=PositionSolverConfig(stages=2))
    want, got, step = run_both(sc, 3)
    assert step.shards == 3
    assert_same_bits(want, got, caches=case != "cold")


@pytest.mark.parametrize("others", ["cpu", "cpu:0"])
def test_more_devices_than_pairs_leave_empty_runs_out(others):
    """max_pairs 3 over 8 devices: 3 runs of one pair on the first three
    devices, the lead's first (the solvers' 6 rows in 6 runs), the other
    devices left out; to the bit. With ``others`` "cpu:0" the seven
    devices after the lead are device objects other than the lead's, as
    on a mesh of separate cards, so a run cut that left the lead empty
    would raise here."""
    sc = random_polygons(broadphase=dataclasses.replace(
        random_polygons().cfg.rigid.broadphase, max_pairs=3))
    want, got, step = run_both(sc, 8, devices=["cpu"] + [others] * 7)
    assert step.shards == 3
    assert_same_bits(want, got)


META = ["cpu"] + ["meta"] * 7


@pytest.mark.parametrize("n", [1, 3, 6, 8, 11])
def test_runs_over_distinct_devices_put_the_first_rows_on_the_lead(n):
    """Runs of n rows over 8 distinct devices, the lead on the CPU and 7
    "meta" devices (tensors with shapes and no data), with fewer, as many
    and more rows than devices: min(n, 8) runs, contiguous, whole and in
    order on the first devices, the lead's first; cut and copy put each
    run on its device with its rows' shapes. Placement and shapes, not
    values."""
    from lpe_tpu_torch.parallel import Runs
    runs = Runs(n, META, "cpu")
    assert len(runs) == min(n, 8)
    assert [d for d, _, _ in runs.runs] == \
        [torch.device(d) for d in META[:len(runs)]]
    assert [a for _, a, _ in runs.runs] + [n] == \
        [0] + [b for _, _, b in runs.runs]
    assert all(b > a for _, a, b in runs.runs)
    t = torch.arange(2.0 * n).reshape(n, 2)
    for (dev, a, b), part in zip(runs.runs, runs.cut(t)):
        assert part.device == dev and part.shape == (b - a, 2)
    for (dev, _, _), whole in zip(runs.runs, runs.copy(t)):
        assert whole.device == dev and whole.shape == t.shape
    assert runs.over(2 * n).devices == runs.devices


def test_list_step_places_each_run_on_its_device(monkeypatch):
    """max_pairs 3 over the 8 devices of the test above: the step builds
    and runs two ticks; every tensor a run is given lies on its run's
    device with its run's rows, the lead holds the first run, every
    result a run sends back lies on its run's device, and the joined
    results and the new state lie on the lead with the single device's
    shapes. Every op but a copy takes its tensors from one device: a
    0-dim tensor of the lead's in a run's op passes on the CPU and is
    refused where the lead is one card and the run another. A meta tensor
    cannot be copied out, so what a meta run sends back is replaced by
    zeros on the lead before the join: placement and shapes are checked,
    not values."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from lpe_tpu_torch.parallel import BandMesh, Runs
    from lpe_tpu_torch.systems.rigid.pipeline import make_rigid_system

    copies = (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default)
    mixed = set()

    class OneDevice(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            devs = {t.device for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor)}
            if len(devs) > 1 and func not in copies:
                mixed.add(str(func))
            return func(*args, **kwargs)
    sc = random_polygons(broadphase=dataclasses.replace(
        random_polygons().cfg.rigid.broadphase, max_pairs=3))
    cpu = torch.device("cpu")
    cut, copy, join = Runs.cut, Runs.copy, Runs.join
    seen = dict(cut=0, copy=0, join=0)

    def placed(fn, key, rows):
        def wrapped(self, t):
            out = fn(self, t)
            assert len(out) == len(self.runs)
            assert self.runs[0][0] == cpu and self.runs[0][1] == 0
            for (dev, a, b), o in zip(self.runs, out):
                assert o.device == dev
                assert o.shape[0] == (b - a if rows else t.shape[0])
            seen[key] += not self.whole
            return out
        return wrapped

    def joined(self, parts):
        if not self.whole:
            n = len(self.runs)
            assert len(parts) % n == 0
            for i, p in enumerate(parts):
                dev, a, b = self.runs[i % n]
                # a run's rows, or C of them a row (a pair's contacts)
                k = parts[i - i % n].shape[0] // (self.runs[0][2])
                assert p.device == dev and p.shape[0] == k * (b - a)
            parts = [torch.zeros(p.shape, dtype=p.dtype, device=cpu)
                     if p.device.type == "meta" else p for p in parts]
            seen["join"] += 1
        out = join(self, parts)
        assert out.device == cpu
        return out

    monkeypatch.setattr(Runs, "cut", placed(cut, "cut", True))
    monkeypatch.setattr(Runs, "copy", placed(copy, "copy", False))
    monkeypatch.setattr(Runs, "join", joined)
    one = make_rigid_system(sc.spec, sc.cfg, device="cpu")
    step = make_rigid_system(sc.spec, sc.cfg, device="cpu",
                             mesh=BandMesh(META))
    assert step.shards == 3
    a = b = sc.state
    for _ in range(2):
        a = one(a)
        with OneDevice():
            b = step(b)
    assert min(seen.values()) > 0, seen
    assert not mixed, mixed
    for f in FIELDS:
        got, want = getattr(b.bodies, f), getattr(a.bodies, f)
        assert got.device == cpu and got.shape == want.shape, f
    for f in WARM:
        assert getattr(b, f).device == cpu
        assert getattr(b, f).shape == getattr(a, f).shape, f


def test_solver_runs_join_in_row_order():
    """The solvers on their own, rows in 5 runs over CPU devices (a
    ``parallel.Runs`` split): the same bits as one device, and the runs'
    copies counted in the split's ``stats``."""
    from lpe_tpu_torch.core.config import (ContactSolverConfig,
                                           PositionSolverConfig)
    from lpe_tpu_torch.parallel import Runs
    from lpe_tpu_torch.systems.rigid.solver import (solve_position,
                                                    solve_velocity)
    rng = np.random.default_rng(3)
    S, R = 12, 37
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    pos, vel = t(rng.uniform(0, 1, (S, 2))), t(rng.normal(0, 1, (S, 2)))
    omega, angle = t(rng.normal(0, 1, S)), t(rng.normal(0, 1, S))
    inv_m, inv_i = t(rng.uniform(0.5, 2, S)), t(rng.uniform(0.5, 2, S))
    ia = torch.tensor(rng.integers(0, S, R))
    ib = torch.tensor(rng.integers(0, S, R))
    n, pt = t(rng.normal(0, 1, (R, 2))), t(rng.uniform(0, 1, (R, 2)))
    pen, valid = t(rng.uniform(0, 0.01, R)), torch.tensor(rng.random(R) < .8)
    ln0, lt0 = t(rng.uniform(0, 1, R)), t(rng.normal(0, 0.1, R))
    vcfg = ContactSolverConfig(stages=3)
    pcfg = PositionSolverConfig(stages=2)
    split = Runs(1, ["cpu"] * 5, "cpu")
    want = solve_velocity(pos, vel, omega, inv_m, inv_i, ia, ib, n, pt,
                          valid, ln0, lt0, vcfg) + solve_position(
        pos, angle, inv_m, inv_i, ia, ib, n, pt, pen, valid, pcfg)
    got = solve_velocity(pos, vel, omega, inv_m, inv_i, ia, ib, n, pt,
                         valid, ln0, lt0, vcfg, split) + \
        solve_position(pos, angle, inv_m, inv_i, ia, ib, n, pt, pen, valid,
                       pcfg, split)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert split.stats["copies"] > 0 and split.stats["bytes"] > 0


def test_a_mesh_led_by_another_device_raises():
    """No fallback: a mesh whose first device is not the step's raises
    when the step is built."""
    from lpe_tpu_torch.parallel import BandMesh
    from lpe_tpu_torch.systems.rigid.pipeline import make_rigid_system
    sc = random_polygons()
    with pytest.raises(ValueError, match="cannot split"):
        make_rigid_system(sc.spec, sc.cfg, device="cpu",
                          mesh=BandMesh(["meta", "cpu"]))


# ---------------------------------------------------------------------------
# the native reference engines' binding
# ---------------------------------------------------------------------------

def _code(path):
    """The module's AST with its docstrings dropped, top-level statement
    by statement (name -> dump)."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    out = {}
    for i, node in enumerate(tree.body):
        name = getattr(node, "name", None)
        if name is None and isinstance(node, ast.Assign):
            name = ast.unparse(node.targets[0])
        out[name or f"stmt{i}"] = node
    return out


def test_native_copy_equals_lpe_tpus():
    """The port's native.py equals lpe_tpu's statement for statement, but
    for docstrings and where the library is built: the copy adds
    ``_BUILD_DIR``, ``CXXFLAGS`` (native/Makefile's CXXFLAGS, held here)
    and ``_build``, and its ``_load`` takes the path from ``_build()``
    where lpe_tpu's runs ``make -C native``; from ``ctypes.CDLL`` on, the
    two ``_load``s are equal."""
    src = _code(os.path.join(REPO, "lpe_tpu", "oracle", "native.py"))
    port = _code(os.path.join(REPO, "lpe_tpu_torch", "oracle",
                              "native.py"))
    added = {"_BUILD_DIR", "CXXFLAGS", "_build"}
    assert set(port) - set(src) == added and set(src) <= set(port)
    for name, node in src.items():
        if name != "_load":
            assert ast.dump(port[name]) == ast.dump(node), name
    load_s, load_p = src["_load"].body, port["_load"].body
    cut_s = next(i for i, n in enumerate(load_s) if "CDLL" in ast.unparse(n))
    cut_p = next(i for i, n in enumerate(load_p) if "CDLL" in ast.unparse(n))
    assert [ast.dump(n) for n in load_p[cut_p:]] == \
        [ast.dump(n) for n in load_s[cut_s:]]
    assert [ast.unparse(n) for n in load_p[:cut_p]] == \
        [ast.unparse(n) for n in load_s[:2]] + ["so = _build()"]
    assert "make" in ast.unparse(load_s[cut_s - 1])
    from lpe_tpu_torch.oracle import native
    flags = next(line for line in open(os.path.join(REPO, "native",
                                                    "Makefile"))
                 if line.startswith("CXXFLAGS"))
    assert native.CXXFLAGS == tuple(flags.split("?=")[1].split())
    text = open(native.__file__).read()
    assert "import jax" not in text and "from lpe_tpu." not in text


def _native_snapshot():
    d = os.path.join(REPO, "native")
    return {f: (os.stat(os.path.join(d, f)).st_mtime_ns,
                hashlib.sha256(open(os.path.join(d, f), "rb").read())
                .hexdigest()) for f in sorted(os.listdir(d))}


def _git_status_native():
    try:
        return subprocess.run(["git", "status", "--porcelain", "native/"],
                              cwd=REPO, capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None


def test_native_sph_matches_the_ports_numpy_oracle():
    """The port's NativeSphOracle, built into build/native, against the
    port's SphOracle on a wall-free swirling blob (tests/test_render_io.py
    _drop_scene's, made here with NumPy): 3 ticks, |dpos| and |drho| <
    1e-5. The build writes nothing into native/: its files keep their
    bytes and times, and git's status of native/ is unchanged."""
    from lpe_tpu_torch.oracle import native
    from lpe_tpu_torch.oracle.sph_numpy import SphOracle
    before, git_before = _native_snapshot(), _git_status_native()
    try:
        nat = native.NativeSphOracle()
    except native.NativeUnavailable:
        pytest.skip("no C++ compiler")
    so = os.path.join(REPO, "build", "native", "liblpe_ref.so")
    assert os.path.exists(so)
    assert os.path.samefile(nat._lib._name, so)
    rng = np.random.default_rng(0)
    n_side, spacing, c, vswirl = 18, 0.035, 3.0, 0.2
    pos, vel = [], []
    for i in range(n_side):
        for j in range(n_side):
            x = c + (i - n_side / 2) * spacing + rng.uniform(-.1, .1) * spacing
            y = c + (j - n_side / 2) * spacing + rng.uniform(-.1, .1) * spacing
            pos.append((x, y))
            vel.append((-vswirl * (y - c), vswirl * (x - c)))
    # float32 as a scene stores them, then float64 for both engines
    pos = np.asarray(pos, np.float32).astype(np.float64)
    vel = np.asarray(vel, np.float32).astype(np.float64)
    mass = np.full(len(pos), np.float32(3.5e-4), np.float64)
    ref = SphOracle()
    p2, v2 = pos.copy(), vel.copy()
    for _ in range(3):
        p2, v2, r2, _ = ref.tick(p2, v2, mass)
    p1, v1, r1, _ = nat.run(pos, vel, mass, 3)
    assert np.abs(p1 - p2).max() < 1e-5
    assert np.abs(r1 - r2).max() < 1e-5
    assert np.abs(p1 - pos).max() > 1e-4            # the blob moved
    assert _native_snapshot() == before
    assert _git_status_native() == git_before
