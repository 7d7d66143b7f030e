"""Tracing and profiling utilities: the JAX package's utils/profiling.py
for the port. device_trace is a torch.profiler context (the counterpart
of the JAX profiler's xplane trace) that leaves a Chrome trace behind;
span marks a stage of the host pipeline in such a trace.

The decoder's spans, all named h264.*, in the order a picture meets
them: h264.parse (one call of the C++ front-end), h264.prepare
(Decoder._prepare: caps and blob), h264.queue_put (decode_stream's parse
thread handing a frame on, blocked while the queue is full),
h264.queue_wait (decode_stream's consumer blocked on an empty queue),
h264.flush (Decoder._submit_window: one pending window), h264.stage (the
input rows' host-to-device copy), h264.replay / h264.capture /
h264.eager (a frame body as a graph replay, a graph capture, or run
eagerly), h264.output (Decoder._make_output: the plane copies out of the
ring). A span carries no argument: the n-th h264.prepare of a thread
belongs to the n-th frame it parsed."""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch
from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

from ..device import resolve_device

# what span returns while no profiler runs
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a span of the calling thread
    while a torch profiler runs (a thread other than the profiler's own
    is recorded only when the profiler records all threads, as
    device_trace does), and the shared null context otherwise: with no
    profiler a span costs one flag read. The span is a CPU operation of
    the trace (_RecordFunctionFast), not record_function's user
    annotation, which the profiler mirrors on the device's timeline
    among the kernels."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """Profile everything inside the context with torch.profiler (CPU
    activity of every thread, so the spans of decode_stream's parse
    thread too, and CUDA activity on a CUDA device) and yield the
    profiler; on exit, after the device has finished the work, write a
    Chrome trace (trace_<pid>_<ns>.json) into log_dir, viewable in
    Perfetto or chrome://tracing. device: see device.resolve_device
    (None is the card, and raises without one)."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts, experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
