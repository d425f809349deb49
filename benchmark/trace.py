"""The traced window: torch.profiler's events reduced to what the
per-layer metrics read.

A traced run profiles the first 2n + 1 blocks of its window (n =
``trace_blocks``) in three sessions (``Sessions``): one block that takes
the profiler's start-up cost; n blocks with the device's activity alone,
whose span is the traced window and whose union of device operations is
the busy time (recording every host op would slow the host that paces
these cells, and read as idle time that an untraced run has not); n
blocks with host and device activity inside a ``record_function`` range
named ``WINDOW``, each block in a range named ``BLOCK``, from which
``reduce`` takes:

- the device operations (kernels, copies, sets) with their intervals;
- the host's kernel launches (the CUDA launch calls, ``cudaLaunch*``
  and ``cuLaunch*``) inside the window;
- the device time under each ``record_function`` range of the program
  that a metric names (a system of the tick, a render phase): the device
  operations whose launch call (the runtime event of the same
  correlation id) the host made inside a span of that range. Kernels
  launched through ctypes count too; the profiler's own device time of a
  range event counts the range's device span over again;
- the blocks' host spans, which bound their kernels (every block ends in
  a synchronize);
- the breakdown: the device operations that took most time, and the
  longest idle gaps of the device inside ``WINDOW``, with what the host
  was doing then.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "benchmark.window"
BLOCK = "benchmark.block"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperative")
# the runtime calls that put an operation on the device
ENQUEUES = LAUNCHES + ("cudaMemcpy", "cudaMemset")


def short_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces' anonymous marks, its
    template arguments and its signature."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].removeprefix("void ").strip()


def port_kernel_names(root: Path) -> set:
    """The ``__global__`` functions of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    names = set()
    for src in sorted((root / "lpe_tpu_torch" / "ops" / "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return names


@dataclass
class Trace:
    """What one traced window holds, for ``metrics/<name>.py``."""

    window_s: float
    busy_s: float
    ops: list                 # (short name, start us, duration us, block)
    launches: int
    ticks: int
    range_us: dict            # range name -> device microseconds
    port_kernels: set
    conf: dict = field(default_factory=dict)
    inputs: dict = field(default_factory=dict)
    block_inputs: list = field(default_factory=list)   # observations
    ticks_per_block: int = 1
    breakdown: dict = field(default_factory=dict)

    def device_us(self, port=None) -> float:
        """Device microseconds of every operation, or of the program's
        kernels (``port`` True) or of the rest (False)."""
        return sum(d for n, _, d, _ in self.ops
                   if port is None or (n in self.port_kernels) == port)


def _union(intervals, lo, hi):
    total, end = 0.0, lo
    gaps = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return total, gaps


class Sessions:
    """The profiler sessions of a traced window over its blocks 0 .. 2n:
    block 0 alone (the profiler's start-up), blocks 1 .. n with device
    activity alone, blocks n+1 .. 2n with host and device activity."""

    def __init__(self, n: int, cuda: bool):
        self.n, self.cuda = n, cuda
        self.prof = self.light = self.full = self.window = None
        self.block_inputs = []

    def _start(self, host: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if self.cuda else []
        if host or not acts:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def open(self, i: int) -> bool:
        """Whether block i is traced; starts the session it begins."""
        if i >= 2 * self.n + 1:
            return False
        if i in (0, 1):
            self._start(host=False)
        elif i == self.n + 1:
            from torch.profiler import record_function
            self._start(host=True)
            self.window = record_function(WINDOW)
            self.window.__enter__()
        return True

    @contextlib.contextmanager
    def block(self, i: int, obs):
        if i <= self.n:
            yield
            return
        from torch.profiler import record_function
        self.block_inputs.append(obs)
        with record_function(BLOCK):
            yield

    def close(self, i: int):
        """Ends the session that block i ends."""
        if i == 2 * self.n:
            self.window.__exit__(None, None, None)
        if i in (0, self.n, 2 * self.n):
            self.prof.__exit__(None, None, None)
            if i == self.n:
                self.light = self.prof
            elif i == 2 * self.n:
                self.full = self.prof

    def done(self, i: int) -> bool:
        return i >= 2 * self.n + 1

    def reduce(self, *, ticks_per_block, range_names, port_kernels,
               top=10) -> Trace:
        tr = reduce(self.full, ticks=self.n * ticks_per_block,
                    range_names=range_names, port_kernels=port_kernels,
                    top=top)
        from torch.autograd import DeviceType
        light = [(e.time_range.start, e.time_range.end)
                 for e in self.light.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        if light:
            lo = min(a for a, _ in light)
            hi = max(b for _, b in light)
            tr.busy_s = _union(light, lo, hi)[0] * 1e-6
            tr.window_s = (hi - lo) * 1e-6
        tr.block_inputs = self.block_inputs
        tr.ticks_per_block = ticks_per_block
        return tr


def reduce(prof, *, ticks, range_names, port_kernels,
           top=10) -> Trace:
    """The ``Trace`` of a session with host and device activity (see the
    module's docstring)."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in host if e.name == WINDOW]
    if not win:
        raise RuntimeError("the traced window has no range " + WINDOW)
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    blocks = sorted((e.time_range.start, e.time_range.end)
                    for e in host if e.name == BLOCK)
    starts = [b[0] for b in blocks]
    skip = set(range_names) | {WINDOW, BLOCK}
    calls = {e.id: e.time_range.start for e in host
             if e.name.startswith(ENQUEUES)}
    spans = {r: sorted((e.time_range.start, e.time_range.end)
                       for e in host if e.name == r) for r in range_names}
    range_us = dict.fromkeys(range_names, 0.0)
    ops = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in skip or \
                getattr(e, "is_user_annotation", False):
            continue
        a, d = e.time_range.start, e.time_range.elapsed_us()
        ops.append((short_name(e.name), a, d,
                    bisect.bisect_right(starts, a) - 1))
        t = calls.get(e.id)
        if t is not None:
            for r, sp in spans.items():
                k = bisect.bisect_right(sp, (t, float("inf"))) - 1
                if k >= 0 and sp[k][0] <= t <= sp[k][1]:
                    range_us[r] += d
    busy, gaps = _union(((a, a + d) for _, a, d, _ in ops), w0, w1)
    launches = sum(1 for e in host if e.name.startswith(LAUNCHES)
                   and w0 <= e.time_range.start <= w1)
    by_name = {}
    for n, _, d, _ in ops:
        by_name[n] = by_name.get(n, 0.0) + d
    dev_top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return Trace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, ops=ops,
        launches=launches, ticks=ticks, range_us=range_us,
        port_kernels=port_kernels,
        breakdown=dict(
            device_ops=[[n, d * 1e-6] for n, d in dev_top],
            idle_gaps=[[_host_at(host, a, b), (b - a) * 1e-6]
                       for a, b in gaps]))


def _host_at(host, a, b):
    """What the host ran over the idle gap (a, b): the innermost host
    event covering its middle, under the program's outermost range."""
    mid = 0.5 * (a + b)
    cover = [e for e in host if e.time_range.start <= mid <= e.time_range.end
             and e.name not in (WINDOW, BLOCK)]
    if not cover:
        return "host: outside any event"
    inner = min(cover, key=lambda e: e.time_range.elapsed_us())
    outer = max(cover, key=lambda e: e.time_range.elapsed_us())
    return inner.name if inner is outer else f"{outer.name} > {inner.name}"
