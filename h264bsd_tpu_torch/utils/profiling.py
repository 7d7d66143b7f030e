"""Tracing and profiling utilities: the JAX package's utils/profiling.py
for the port. device_trace is a torch.profiler context (the counterpart
of the JAX profiler's xplane trace) that leaves a Chrome trace behind;
StageTimers accumulates wall time of host-side pipeline stages."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path

import torch

from ..device import resolve_device


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """Profile everything inside the context with torch.profiler (CPU
    activity, and CUDA activity on a CUDA device) and yield the profiler;
    on exit, after the device has finished the work, write a Chrome trace
    (trace_<pid>_<ns>.json) into log_dir, viewable in Perfetto or
    chrome://tracing. device: see device.resolve_device (None is the
    card, and raises without one)."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimers:
    """Lightweight accumulating wall timers for host-side pipeline stages
    (parse / pack / transfer / dispatch ...)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = max(self.counts[name], 1)
            lines.append(f"{name}: {self.totals[name] * 1e3:.2f} ms total, "
                         f"{self.totals[name] / n * 1e3:.3f} ms avg x{n}")
        return "\n".join(lines)
