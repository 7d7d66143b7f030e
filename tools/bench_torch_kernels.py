#!/usr/bin/env python3
"""Device time of the port's CUDA kernels on one GPU, for the tree it runs
in, on the cases chip_smoke.py times them on:

- deblock_raster (K8, deblock_raster_kernel): frames of 2x4, 1x68, 2x68
  and 2x543 MBs, random inputs (kernel_cases.deblock_case) of two seeds
  (one at 2x543), and the first seed's frame with every bS 0 ("no
  edges": staging, barriers and stores only) and with bS 4 on every edge
  inside the frame ("all strong": the longest filters);
- deblock_wf (K1, deblock_wf_kernel): 80x45 and 120x68, random inputs;
- mc_recon (mc_recon_kernel): the 1080p MC case
  (kernel_cases.mc_recon_case(15, 120, 68, 4, 0.06)) and the 1080p frames
  whose MBs all take one path (kernel_cases.mc_recon_kind_cases);
- idct_blocks (K9, idct_blocks_kernel): kernel_cases.idct_case(16, n)
  at n = 8192, 97,920 (a 34-MB-row stripe of 1080p) and 195,840 (a whole
  1080p frame) random blocks (K9's time does not depend on the data).

Builds the CUDA kernels from the checkout, then prints one JSON line per
case: graph_ms, the mean time of one call from CUDA events around the
replay of a CUDA graph of --reps back-to-back calls, each on its own
copy of the planes (no host launch cost is in it; a wrapper's memsets
are; K9, which writes no input, calls on the same inputs: warm);
profiler_ms, the mean of the kernel's torch.profiler events over 20
calls (chip_smoke.py's method); the bound from the bytes (and, for
mc_recon, the int32 operations) chip_smoke.py counts; and the card's
name and power limit. For K9 also the cold readings cold_graph_ms and
cold_profiler_ms: call i takes copy i mod c of the inputs, the c copies
together more than COLD_BYTES (twice the card's 50 MB L2 cache), so
each call reads its inputs from device memory, as the bound assumes;
and the bound's share of the cold profiler time. Every case under 1000
MBs, and every K9 case, is checked byte-equal to the plain version
first (the plain K8 takes ~40 s at 2x543). It uses only what
chip_smoke.py, kernel_cases.py and _kernels.py have had since the tree
that added K9's dense frame_step (git b0ab340), so a copy of it in an
earlier checkout's tools/ times that tree's kernels: run parent and
change in turns in one call.

Usage: python3 tools/bench_torch_kernels.py [--kernel deblock_raster ...]
                                      [--reps 50]
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

KERNELS = ("deblock_raster", "deblock_wf", "mc_recon", "idct_blocks")
# K9's blocks per case, and the bytes a block moves: 16 int32 levels and
# scales, its int32 ext_dc and skip_dc, 16 int32 out (chip_smoke.py's
# idct_bound)
IDCT_BLOCKS = (8192, 97920, 195840)
IDCT_BLOCK_BYTES = 16 * 4 * 2 + 8 + 16 * 4
# a cold reading's copies of the inputs hold more than this: twice the
# H100's 50 MB L2 cache
COLD_BYTES = 100e6


def deblock_kinds(args, seed, wm, hm, variants):
    """(label, inputs) of one random frame and, with variants, its two
    edge variants."""
    y, cb, cr, bs_left, bs_top, lt, ct = args
    kinds = [(f"random, seed {seed}", args)]
    if variants:
        mb = torch.arange(wm * hm, device=y.device)
        strong_left = torch.full_like(bs_left, 4)
        strong_left[mb % wm == 0, 0::4] = 0      # the frame's left border
        strong_top = torch.full_like(bs_top, 4)
        strong_top[mb // wm == 0, 0:4] = 0       # and its top border
        kinds += [("no edges", (y, cb, cr, torch.zeros_like(bs_left),
                                torch.zeros_like(bs_top), lt, ct)),
                  ("all strong", (y, cb, cr, strong_left, strong_top, lt,
                                  ct))]
    return kinds


def cases(name, dev):
    """(label, kernel, plain, inputs, dims, bound bytes, bound ops or
    None) of each case of kernel `name`."""
    import chip_smoke as cs
    from h264bsd_tpu_torch.utils import kernel_cases as kc
    if name == "idct_blocks":
        from h264bsd_tpu_torch.ops.cuda_transform import idct_blocks
        from h264bsd_tpu_torch.ops.transform import idct_blocks_plain
        for n in IDCT_BLOCKS:
            yield (f"random, seed 16, {n} blocks",
                   lambda *a: (idct_blocks(*a[:4]),),
                   lambda *a: (idct_blocks_plain(*a[:4]),),
                   kc.case_inputs(kc.idct_case(16, n), kc.IDCT_STATE, dev),
                   (n,), n * IDCT_BLOCK_BYTES, None)
        return
    if name == "mc_recon":
        from h264bsd_tpu_torch.ops.cuda_mc import (mc_recon_cuda,
                                                   mc_recon_plain)
        dims = (120, 68)
        for label, case in [("chip_smoke 1080p MC case", kc.mc_recon_case(
                15, *dims, 4, 0.06))] + kc.mc_recon_kind_cases(*dims):
            args = kc.mc_recon_inputs(case, dev)
            yield (label, mc_recon_cuda, mc_recon_plain, args, dims,
                   *cs.mc_recon_bound(args))
        return
    if name == "deblock_raster":
        from h264bsd_tpu_torch.ops.cuda_deblock import (
            deblock_frame_cuda_from_bs as kernel, deblock_raster_plain as
            plain)
        frames = (((2, 4), (14, 30)), ((1, 68), (15, 31)),
                  ((2, 68), (16, 32)), ((2, 543), (17,)))
    else:
        from h264bsd_tpu_torch.ops.cuda_deblock_wf import (
            deblock_frame_wavefront_from_bs as kernel,
            deblock_wavefront_plain as plain)
        frames = (((80, 45), (11,)), ((120, 68), (10,)))
    for dims, seeds in frames:
        for seed in seeds:
            base = kc.deblock_inputs(kc.deblock_case(seed, *dims), *dims,
                                     dev)
            variants = name == "deblock_raster" and seed == seeds[0]
            for label, args in deblock_kinds(base, seed, *dims, variants):
                byt = 2 * cs.nbytes(args[:3]) + cs.nbytes(
                    (args[3], args[4], *args[5], *args[6]))
                yield label, kernel, plain, args, dims, byt, None


def graph_ms(kernel, calls, dims):
    """Mean time of one call from CUDA events around the replay of a CUDA
    graph of kernel(*c, *dims) for each argument tuple c of `calls`,
    back to back (after one warm replay)."""
    import chip_smoke as cs
    kernel(*cs.planes_copy(calls[0]), *dims)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            kernel(*c, *dims)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()             # warm
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", nargs="+", choices=KERNELS, default=KERNELS)
    ap.add_argument("--reps", type=int, default=50)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from h264bsd_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    _kernels.build(force=True)
    for name in opts.kernel:
        # K9 writes none of its inputs: its warm graph calls on them as
        # they are; the other kernels work on their planes in place
        in_place = name != "idct_blocks"
        for label, kernel, plain, args, dims, byt, ops in cases(name, dev):
            if not in_place or math.prod(dims) < 1000:
                err = cs.max_abs_err(kernel(*cs.planes_copy(args), *dims),
                                     plain(*cs.planes_copy(args), *dims))
                if err:
                    raise AssertionError(
                        f"{name} {dims} {label}: the kernel differs from "
                        f"its plain version (max |err| {err})")
            calls = [cs.planes_copy(args) if in_place else args
                     for _ in range(opts.reps)]
            ms = graph_ms(kernel, calls, dims)
            prof_ms, _ = cs.device_ms(lambda *a: kernel(*a, *dims), args,
                                      20, name)
            row = {"kernel": name, "dims": list(dims), "case": label,
                   "graph_ms": ms, "profiler_ms": prof_ms,
                   "bound_bytes_ms": 1e3 * byt / cs.HBM_BYTES_PER_S}
            if in_place:
                row["us_per_mb"] = 1e3 * ms / math.prod(dims)
            else:
                copies = [tuple(a.clone() for a in args) for _ in range(
                    int(COLD_BYTES // cs.nbytes(args)) + 2)]
                rot = itertools.cycle(copies)
                row["cold_copies"] = len(copies)
                row["cold_graph_ms"] = graph_ms(
                    kernel, [next(rot) for _ in range(max(opts.reps,
                                                          len(copies)))],
                    dims)
                # args () makes device_ms copy nothing in the profiled run
                row["cold_profiler_ms"] = cs.device_ms(
                    lambda: kernel(*next(rot), *dims), (), 20, name)[0]
                row["cold_share_of_bound"] = \
                    row["bound_bytes_ms"] / row["cold_profiler_ms"]
                del copies, rot
            if ops is not None:
                row["bound_ops_ms"] = 1e3 * ops / cs.ALU_OPS_PER_S
            print(json.dumps({**row, "gpu": smi}), flush=True)
            del calls
    return 0


if __name__ == "__main__":
    sys.exit(main())
