"""Reduction of a traced window (torch.profiler with CUDA activity) to
what the per-layer metrics read: the device operations (kernels, copies
and memsets) inside the benchmark's `bench.window` span, the union of
their intervals (busy time), and the benchmark's own host spans
(`bench.*`, record_function, which the profiler also mirrors on the
device's timeline as annotations: those are not operations) that say
what the host was doing in each idle gap. Times from the profiler's
clock, in seconds."""

from __future__ import annotations

from dataclasses import dataclass

import torch

WINDOW = "bench.window"


def union(intervals):
    """(total length, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list            # (start_s, end_s, name) of device operations
    merged: list         # busy intervals, seconds from the window start
    spans: list          # (start_s, end_s, name) of the benchmark's spans

    @property
    def op_seconds(self):
        return sum(e - s for s, e, _ in self.ops)

    def kernel_seconds(self, name):
        """Device time of the operations whose name is `name` (kernel
        names without their argument lists)."""
        return sum(e - s for s, e, n in self.ops if n == name)

    def top_ops(self, k=10):
        by = {}
        for s, e, n in self.ops:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """The k longest device-idle gaps of the window, each named by
        the innermost benchmark span open at its middle."""
        edges = [0.0] + [x for iv in self.merged for x in iv] + \
            [self.window_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (s + e) / 2
            open_ = [sp for sp in self.spans if sp[0] <= mid <= sp[1]]
            name = max(open_, key=lambda sp: sp[0])[2] if open_ else \
                "outside the benchmark's spans"
            out.append([name, e - s])
        return out


def reduce(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and
           e.device_type() != torch.autograd.DeviceType.CUDA]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    t0, t1 = win[0].start_ns(), win[0].end_ns()

    def sec(ns):
        return (min(max(ns, t0), t1) - t0) * 1e-9
    ops, spans = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if s + d < t0 or s > t1:
            continue
        name = e.name()
        if name.startswith("bench."):
            # the benchmark's spans; on the CUDA side too, where the
            # profiler mirrors them as annotations, not operations
            if e.device_type() != torch.autograd.DeviceType.CUDA and \
                    name != WINDOW:
                spans.append((sec(s), sec(s + d), name))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((sec(s), sec(s + d), name.split("(")[0]))
    busy, merged = union([(s, e) for s, e, _ in ops])
    return Trace((t1 - t0) * 1e-9, busy, ops, merged, spans)
