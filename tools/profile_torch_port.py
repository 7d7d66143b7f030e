#!/usr/bin/env python3
"""Where the time of the PyTorch port's decode goes, on one GPU.

Decodes, with h264bsd_tpu_torch, per geometry [KIND:]WxHxN one of
  intra   make_intra_stress_stream(W, H, N)   (all-I; the default)
  ippp    make_ippp_stream(W, H, N)           (I then zero-motion P)
  motion  make_motion_stream(W, H, N, seed=0) (I then P with real motion)
and prints one JSON line per geometry with:
  host_ms_per_frame     the C++ front-end parse plus the host half of a
                        frame (Decoder._prepare), with no device work;
  e2e_ms_per_frame      decode_stream, pipelined and not, warm, ending
                        in torch.cuda.synchronize();
  device_busy_ms_per_frame / device_idle_share
                        from a torch.profiler trace of one pipelined
                        pass: the union of the CUDA activity intervals
                        (kernels, copies, memsets) over the wall time;
  kernels               device time and calls per frame by kernel name,
                        the port's CUDA kernels (every __global__
                        function in the checkout's csrc/*.cu) and the
                        rest (the PyTorch glue: unpack, bS, copies,
                        fills and memsets);
  graph_captures, graph_replays, eager_frames
                        how the frames of the profiled pass ran
                        (models/graphs.py): one capture per frame shape
                        (each decode_stream call makes a new decoder),
                        replays for the rest.
Usage: python3 tools/profile_torch_port.py \
           [--geometry 80x45x16 ippp:120x68x8 motion:120x68x5 ...]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


KERNEL_DECL = (r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
               r"(\w+)\s*\(")


def our_kernels():
    """The port's CUDA kernels by function name: every __global__ function
    of the checkout's csrc/*.cu. Every other device event counts as
    glue."""
    names = set()
    for src in (ROOT / "h264bsd_tpu_torch" / "csrc").glob("*.cu"):
        names.update(re.findall(KERNEL_DECL, src.read_text()))
    return names


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def make_stream(kind, w, h, n):
    """(call, bytes) of the stream of `kind` at W x H MBs, N frames."""
    from h264bsd_tpu_torch.utils import motion_stream, streamgen
    if kind == "intra":
        return (f"make_intra_stress_stream({w}, {h}, {n})",
                streamgen.make_intra_stress_stream(w, h, n))
    if kind == "ippp":
        return (f"make_ippp_stream({w}, {h}, {n})",
                streamgen.make_ippp_stream(w, h, n))
    if kind == "motion":
        return (f"make_motion_stream({w}, {h}, {n}, seed=0)",
                motion_stream.make_motion_stream(w, h, n, seed=0))
    raise ValueError(f"unknown stream kind {kind!r}")


def profile(kind, w, h, n):
    from h264bsd_tpu_torch.frontend import binding as fe
    from h264bsd_tpu_torch.models.decoder import Decoder, decode_stream
    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats

    call, data = make_stream(kind, w, h, n)

    # host half alone: parse + _prepare, no device work
    dec = Decoder(device="cuda")
    t0 = time.perf_counter()
    pos, frames = 0, 0
    while pos < len(data):
        status, read = dec._fe.decode(data, 0, pos)
        pos += read
        if status == fe.PIC_RDY:
            dec._prepare()
            frames += 1
            while dec._fe.next_output() is not None:
                pass
    host_ms = 1e3 * (time.perf_counter() - t0) / frames
    dec.close()

    def e2e(pipelined):
        t0 = time.perf_counter()
        k = sum(1 for _ in decode_stream(data, pipelined=pipelined))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / k

    e2e(True)                                   # warm-up
    piped, unpiped = e2e(True), e2e(False)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    reset_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        k = sum(1 for _ in decode_stream(data))
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        name = e.name.split("(")[0]
        by_name[name][0] += e.time_range.end - e.time_range.start
        by_name[name][1] += 1
    rows = sorted(({"name": nm, "ms_per_frame": us / 1e3 / k,
                    "calls_per_frame": c / k}
                   for nm, (us, c) in by_name.items()),
                  key=lambda r: -r["ms_per_frame"])
    names = our_kernels()
    ours = [r for r in rows if r["name"] in names]
    glue = [r for r in rows if r["name"] not in names]
    return {"stream": call,
            "frames": k, "host_ms_per_frame": host_ms,
            "e2e_ms_per_frame_pipelined": piped,
            "e2e_ms_per_frame_unpipelined": unpiped,
            "profiled_wall_ms_per_frame": wall_us / 1e3 / k,
            "device_busy_ms_per_frame": busy / 1e3 / k,
            "device_idle_share": 1 - busy / wall_us,
            **STATS,
            "kernels_ms_per_frame": sum(r["ms_per_frame"] for r in ours),
            "glue_ms_per_frame": sum(r["ms_per_frame"] for r in glue),
            "glue_calls_per_frame": sum(r["calls_per_frame"] for r in glue),
            "kernels": ours, "glue_top": glue[:12]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometry", nargs="+", default=["80x45x16"],
                    help="[KIND:]WxHxN: stream kind (intra, ippp, motion), "
                    "width and height in MBs, frames")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_port: no CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for geo in args.geometry:
        kind, _, dims = geo.rpartition(":")
        w, h, n = (int(x) for x in dims.split("x"))
        print(json.dumps({"gpu": gpu, **profile(kind or "intra", w, h, n)}),
              flush=True)


if __name__ == "__main__":
    main()
