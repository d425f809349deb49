"""Hierarchical scope profiler.

Host-side analog of the reference's RAII scope profiler
(reference: include/core/profile.hpp:30-147, src/core/profile.cpp:21-181):
named scopes on a stack, total/self/min/max/count per scope with
parent->child edges, ASCII tree report with percent-of-root, periodic
print + reset. Device-side phases additionally carry
``torch.profiler.record_function`` ranges (systems/__init__.py,
render/frame.py) so they show up in torch.profiler traces. A copy of
``lpe_tpu/core/profiler.py``, docstrings apart.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class _Node:
    name: str
    total: float = 0.0
    count: int = 0
    min_t: float = float("inf")
    max_t: float = 0.0
    children: dict = field(default_factory=dict)


class Profiler:
    def __init__(self):
        self.root = _Node("root")
        self._stack = [self.root]
        self._t0 = time.perf_counter()

    @contextmanager
    def scope(self, name: str):
        parent = self._stack[-1]
        node = parent.children.get(name)
        if node is None:
            node = parent.children[name] = _Node(name)
        self._stack.append(node)
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            node.total += dt
            node.count += 1
            node.min_t = min(node.min_t, dt)
            node.max_t = max(node.max_t, dt)
            self._stack.pop()

    def report(self) -> str:
        wall = time.perf_counter() - self._t0
        lines = [f"Profiler report (wall {wall:.2f}s)"]

        def walk(node, depth):
            for child in sorted(node.children.values(), key=lambda n: -n.total):
                self_t = child.total - sum(c.total for c in
                                           child.children.values())
                pct = 100.0 * child.total / wall if wall > 0 else 0.0
                lines.append(
                    f"{'  ' * depth}{child.name}: {child.total * 1e3:.1f}ms "
                    f"({pct:.1f}%) calls={child.count} "
                    f"self={self_t * 1e3:.1f}ms "
                    f"min={child.min_t * 1e3:.2f} max={child.max_t * 1e3:.2f}")
                walk(child, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    def reset(self):
        self.root = _Node("root")
        self._stack = [self.root]
        self._t0 = time.perf_counter()


PROFILER = Profiler()


def profile_scope(name: str):
    """Module-level convenience mirroring PROFILE_SCOPE(name)."""
    return PROFILER.scope(name)
