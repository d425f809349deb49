"""The port's tracer: named spans on the clock of torch.profiler's trace.

``PROFILER.scope(name)`` is the program's span. It is off unless a
``torch.profiler`` session records (any session, device-only ones too:
torch sets ``torch.autograd.profiler._is_profiler_enabled`` for each) or
the operator asked for it (``PROFILER.recording()``: ``cli run --profile``,
``SimManager.run(print_profile=True)``). Off, ``scope`` returns one shared
no-op context: no ``record_function``, no CUDA event, no clock read.

On, each span records its name, its parent (the span open when it opened)
and its host start and end in ``time.time_ns()``, the Unix-epoch clock that
torch.profiler puts its host and device events on (kineto's ``start_ns``),
so spans and a trace can be laid over each other. By kind:

- ``LAYER`` (the default; a system, a part of one): while torch.profiler
  records it opens a ``record_function`` of its name inside its host
  interval, so the trace's host timeline names it, and the trace holds its
  device time. Recorded for the operator (``recording()``) on CUDA, it
  records a pair of CUDA events on the current stream, resolved when the
  spans are read (after the caller's synchronize) into its ``device_ms``:
  stream time from its start to the end of its last operation, so idle
  waits for the host count too. On the CPU its ``device_ms`` is its host
  interval.
- ``HOST`` (a tick, a kernel call): host time alone.
- ``ROOT`` (a block of ticks, opened only where no span is open): host
  time and, on CUDA, ``mallocs``: the caching allocator's segments
  allocated over it (its ``cudaMalloc`` calls), read at its start and
  end.

Records stay in memory: ``spans()`` reads them, ``reset()`` clears them,
and past ``CAP`` records the closed ones fold into the aggregate tree that
``report()`` prints (total, self, min, max, count and device ms a name
path; self time is a span's duration less the union of its children's).
"""
from __future__ import annotations

import contextlib
import copy
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

LAYER, HOST, ROOT = "layer", "host", "root"
CAP = 1 << 17              # records kept before they fold into the tree
_OFF = contextlib.nullcontext()


class Span:
    """One span: ``name``, ``parent`` (a Span or None), host ``t0``/``t1``
    (ns, Unix epoch), ``device_ms`` (LAYER spans on the CPU, and on CUDA
    those recorded for the operator; None otherwise) and
    ``mallocs`` (ROOT spans on CUDA; None otherwise)."""

    __slots__ = ("name", "parent", "t0", "t1", "device_ms", "mallocs",
                 "kind", "cuda", "_prof", "_device", "_rf", "_ev", "_seg")

    def __init__(self, prof, name, kind, device):
        self._prof, self.name, self.kind, self._device = \
            prof, name, kind, device
        self.device_ms = self.mallocs = self._rf = self._ev = None
        self.t1 = None

    def __enter__(self):
        prof = self._prof
        stack = prof._stack
        self.parent = stack[-1] if stack else None
        if self._device is not None:
            self.cuda = torch.device(self._device).type == "cuda"
        else:
            self.cuda = self.parent is not None and self.parent.cuda
        prof._records.append(self)
        stack.append(self)
        self.t0 = time.time_ns()
        if self.kind == LAYER:
            if _autograd_profiler._is_profiler_enabled:
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
            if self.cuda and prof.on:
                self._ev = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                self._ev[0].record()
        elif self.kind == ROOT and self.cuda:
            self._seg = _segments(self._device)
        return self

    def __exit__(self, *exc):
        if self._ev is not None:
            self._ev[1].record()
        elif self.kind == ROOT and self.cuda:
            self.mallocs = _segments(self._device) - self._seg
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.t1 = time.time_ns()
        prof = self._prof
        prof._stack.pop()
        if not prof._stack and len(prof._records) > CAP:
            prof._fold()
        return False

    def _resolve(self):
        """Fills ``device_ms`` (waits for the span's end event)."""
        if self._ev is not None:
            self._ev[1].synchronize()
            self.device_ms = self._ev[0].elapsed_time(self._ev[1])
            self._ev = None
        elif self.kind == LAYER and not self.cuda and self.device_ms is None:
            self.device_ms = (self.t1 - self.t0) * 1e-6

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def path(self) -> tuple:
        """Names from the root span down to this one."""
        out, s = [], self
        while s is not None:
            out.append(s.name)
            s = s.parent
        return tuple(reversed(out))


def _segments(device) -> int:
    return torch.cuda.memory_stats(device)["segment.all.allocated"]


@dataclass
class _Node:
    total: float = 0.0         # ms
    self_t: float = 0.0
    count: int = 0
    min_t: float = float("inf")
    max_t: float = 0.0
    device: float | None = None
    children: dict = field(default_factory=dict)


def _union_ms(intervals) -> float:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def _fold_into(tree, records):
    """Adds each closed span of ``records`` to the node of its name path;
    a span's children are among the same records."""
    kids = {}
    for s in records:
        if s.parent is not None:
            kids.setdefault(id(s.parent), []).append(s)
    for s in records:
        node = tree
        for name in s.path():
            node = node.children.setdefault(name, _Node())
        dur = s.host_ms
        node.total += dur
        node.self_t += dur - _union_ms((c.t0, c.t1)
                                       for c in kids.get(id(s), ()))
        node.count += 1
        node.min_t = min(node.min_t, dur)
        node.max_t = max(node.max_t, dur)
        if s.device_ms is not None:
            node.device = (node.device or 0.0) + s.device_ms


class Profiler:
    def __init__(self):
        self.on = False
        self.reset()

    def scope(self, name: str, kind: str = LAYER, device=None):
        """A span of ``name`` and ``kind`` (``LAYER``, ``HOST``, ``ROOT``);
        ``device`` (a ROOT's, where it runs) says whether it and the spans
        under it are on CUDA; a span given none is where its parent is, and
        on the CPU where it has no parent. Off, or a ROOT asked for inside
        another span, the shared no-op context."""
        if not (self.on or _autograd_profiler._is_profiler_enabled) or \
                (kind == ROOT and self._stack):
            return _OFF
        return Span(self, name, kind, device)

    @contextlib.contextmanager
    def recording(self):
        """Spans on inside the block, whatever torch.profiler does."""
        prev, self.on = self.on, True
        try:
            yield
        finally:
            self.on = prev

    def spans(self) -> list:
        """The closed spans not yet folded, in the order they opened, their
        ``device_ms`` resolved."""
        out = [s for s in self._records if s.t1 is not None]
        for s in out:
            s._resolve()
        return out

    def _fold(self):
        """Folds the records into the tree (no span is open)."""
        _fold_into(self._tree, self.spans())
        self._records = []

    def report(self) -> str:
        """The tree of every span since ``reset``: a line per name path,
        sorted by total host time."""
        tree = copy.deepcopy(self._tree)
        _fold_into(tree, self.spans())
        wall = (time.time_ns() - self._t0) * 1e-6
        lines = [f"Profiler report (wall {wall / 1e3:.2f}s; host ms, and "
                 f"device ms of the layer spans)"]

        def walk(node, depth):
            for name, c in sorted(node.children.items(),
                                  key=lambda kv: -kv[1].total):
                pct = 100.0 * c.total / wall if wall > 0 else 0.0
                dev = "" if c.device is None else f" device={c.device:.1f}ms"
                lines.append(
                    f"{'  ' * depth}{name}: {c.total:.1f}ms ({pct:.1f}%) "
                    f"calls={c.count} self={c.self_t:.1f}ms "
                    f"min={c.min_t:.2f} max={c.max_t:.2f}{dev}")
                walk(c, depth + 1)

        walk(tree, 0)
        return "\n".join(lines)

    def reset(self):
        self._records = []
        self._stack = []
        self._tree = _Node()
        self._t0 = time.time_ns()


PROFILER = Profiler()
