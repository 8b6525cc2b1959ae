"""The device's side of a traced window, from torch.profiler's CUDA
activity: every kernel, copy and fill the card ran, moved onto the
host's monotonic clock (the one the program's spans use) by a marker
kernel launched on an idle card at a known host time."""

from __future__ import annotations

import heapq
import re
import time


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


class DeviceTrace:
    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._mark_ns = None
        self.ops: list = []  # (name, start ns, end ns), by start

    def mark(self) -> None:
        """Launch the marker on the idle card and note the host time."""
        import torch

        torch.cuda.synchronize()
        self._mark_ns = time.monotonic_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != cuda:
                continue
            start = ev.start_ns()
            ops.append((ev.name(), start, start + ev.duration_ns()))
        ops.sort(key=lambda o: o[1])
        marks = [o for o in ops if MARKER in o[0]]
        if not marks or self._mark_ns is None:
            raise RuntimeError("the profiler recorded no marker kernel")
        shift = marks[0][1] - self._mark_ns
        self.ops = [(n, s - shift, e - shift) for n, s, e in ops
                    if MARKER not in n]


def clip(ops: list, lo_ns: int, hi_ns: int) -> list:
    """The ops' intervals cut to [lo_ns, hi_ns]."""
    out = []
    for name, s, e in ops:
        s, e = max(s, lo_ns), min(e, hi_ns)
        if e > s:
            out.append((name, s, e))
    return out


def busy_intervals(ops: list) -> list:
    """The union of the ops' intervals, as sorted disjoint (start, end)."""
    merged: list = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def device_seconds(ops: list, pattern: str) -> tuple:
    """(launches, summed seconds) of the ops whose name matches."""
    rx = re.compile(pattern)
    hits = [(e - s) for name, s, e in ops if rx.search(name)]
    return len(hits), sum(hits) / 1e9


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and
    arguments; a copy's or a fill's as the profiler gives it."""
    if not name.startswith("void "):
        return name[:80]
    depth, cut, start = 0, len(name), 5
    for k in range(5, len(name)):
        ch = name[k]
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and ch == "(" and k > 5:
            cut = k
            break
        elif depth == 0 and name.startswith("::", k):
            start = k + 2
    return name[start:cut][:80]


def top_ops(ops: list, k: int = 10) -> list:
    by: dict = {}
    for name, s, e in ops:
        key = kernel_name(name)
        by[key] = by.get(key, 0.0) + (e - s) / 1e9
    return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]


def idle_gaps(busy: list, lo_ns: int, hi_ns: int, spans: list,
              k: int = 10) -> list:
    """The card's idle time in [lo_ns, hi_ns], summed by the host span
    open at each gap's middle (the innermost: latest to start); spans
    are (name, start ns, end ns) on the same clock."""
    edges = [lo_ns] + [x for iv in busy for x in iv] + [hi_ns]
    by: dict = {}
    spans = sorted(spans, key=lambda s: s[1])
    open_: list = []  # heap of (-start, end, name): latest start on top
    j = 0
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e <= s:
            continue
        mid = (s + e) // 2
        while j < len(spans) and spans[j][1] <= mid:
            heapq.heappush(open_, (-spans[j][1], spans[j][2], spans[j][0]))
            j += 1
        while open_ and open_[0][1] < mid:
            heapq.heappop(open_)
        label = f"host:{open_[0][2]}" if open_ else "host:none"
        by[label] = by.get(label, 0.0) + (e - s) / 1e9
    return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]
