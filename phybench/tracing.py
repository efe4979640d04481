"""Spans and the profiler pass of a traced run.

Spans are the benchmark's own, around its calls into the program; they are
kept in memory and read after the run. Inside the profiled slice each span
is also a torch.profiler annotation, so the device timeline and the host's
spans share one clock: an idle gap of the device is labelled by the span
the host was in when it began.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


class Spans:
    """Host spans: (name, start s, end s, profiled) on the perf_counter
    clock, recorded only when enabled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.profiling = False
        self.items: list = []

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.items.append((name, t0, time.perf_counter(), self.profiling))

    def total_s(self, name: str) -> float:
        """Seconds spent in spans `name` outside the profiled slice."""
        return sum(t1 - t0 for n, t0, t1, p in self.items
                   if n == name and not p)


@dataclass
class Trace:
    """What the profiler saw over the traced slice.

    device: (name, start us, end us) of every kernel, copy and memset;
    host: (name, start us, end us) of the benchmark's spans, same clock;
    wall_s: the slice's host wall time, ending in a synchronize."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    wall_s: float = 0.0

    def busy_intervals(self) -> list:
        """The device timeline's busy intervals, overlaps merged."""
        out: list = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(b - a for n, a, b in self.device if match(n)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for n, a, b in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n[:96], s] for n, s in sorted(by.items(),
                                               key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The k longest gaps between device work inside the host spans'
        range, each named by the innermost host span open at its start."""
        if not self.host:
            return []
        lo = min(a for _, a, _ in self.host)
        hi = max(b for _, _, b in self.host)
        gaps, t = [], lo
        for a, b in self.busy_intervals() + [[hi, hi]]:
            if a > t:
                gaps.append((t, min(a, hi)))
            t = max(t, b)
            if t >= hi:
                break

        def label(at):
            open_ = [(a, n) for n, a, b in self.host if a <= at < b]
            return max(open_)[1] if open_ else "harness"

        gaps.sort(key=lambda g: g[0] - g[1])
        return [[label(a), (b - a) / 1e6] for a, b in gaps[:k] if b > a]


def profile(fn, spans: Spans, cuda: bool) -> Trace:
    """Run fn() under torch.profiler with the spans as annotations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    spans.profiling = True
    try:
        with torch_profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        spans.profiling = False
    names = {n for n, _, _, p in spans.items if p}
    trace = Trace(wall_s=wall)
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if e.name in names:
                trace.host.append((e.name, a, b))
        elif e.name not in names and not getattr(e, "is_user_annotation",
                                                 False):
            trace.device.append((e.name, a, b))
    return trace
