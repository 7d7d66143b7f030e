#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (h264bsd_tpu_torch) on one GPU.

Builds the host front-end (g++) and the CUDA kernels (nvcc) from the
sources in this checkout, holds each kernel byte-equal to its plain
PyTorch version on the card, decodes the all-intra streams through
decode_stream and checks every picture's checksum against the values the
JAX package recorded (h264bsd_tpu_torch/testdata/reference_checksums.json,
written by tools/record_torch_port_checksums.py), then times each kernel
with CUDA events. Prints one JSON line per phase, then the kernel table,
the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Any failure raises (exit code != 0).

Usage: python3 chip_smoke.py     (needs one CUDA device)
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import torch

# the least time the card could take (bound_ms): NVIDIA's H100 SXM data
# sheet, HBM rate and the float32 rate outside the tensor cores (the
# kernels do int32 ALU work, which has no tensor-core path)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# int32 operations per filtered pel line (luma / chroma deblocking) and per
# reconstructed pel (intra): prediction, residual add and clip
OPS_LUMA_LINE, OPS_CHROMA_LINE, OPS_INTRA_PEL = 40, 20, 30

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "deblock_wf": ("h264bsd_tpu_torch/csrc/deblock_wf.cu",
                   "h264bsd_tpu/ops/pallas_deblock_wf.py:616"),
    "deblock_raster": ("h264bsd_tpu_torch/csrc/deblock_wf.cu",
                       "h264bsd_tpu/ops/pallas_deblock.py:335"),
    "intra_list": ("h264bsd_tpu_torch/csrc/intra_list.cu",
                   "h264bsd_tpu/ops/pallas_intra.py:379"),
    "intra_wf": ("h264bsd_tpu_torch/csrc/intra_wf.cu",
                 "h264bsd_tpu/ops/pallas_intra_wf.py:600"),
}


def emit(record):
    print(json.dumps(record), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def planes_copy(args):
    return tuple(a.clone() for a in args[:3]) + tuple(args[3:])


def max_abs_err(got, want):
    torch.cuda.synchronize()
    return max(int((g.int() - w.int()).abs().max()) for g, w in
               zip(got, want))


def timed_ms(fn, args, reps):
    """Mean CUDA-event time of fn on fresh copies of the planes (the
    kernels work in place), copies outside the timed region."""
    total = 0.0
    for _ in range(reps):
        a = planes_copy(args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from h264bsd_tpu_torch.frontend import build as fe_build
    from h264bsd_tpu_torch.models.decoder import (decode_stream,
                                                  frame_checksum_host)
    from h264bsd_tpu_torch.ops import _kernels
    from h264bsd_tpu_torch.ops.cuda_deblock import (
        deblock_frame_cuda_from_bs, deblock_raster_plain)
    from h264bsd_tpu_torch.ops.cuda_deblock_wf import (
        deblock_frame_wavefront_from_bs, deblock_wavefront_plain)
    from h264bsd_tpu_torch.ops.cuda_intra import intra_pass_cuda
    from h264bsd_tpu_torch.ops.cuda_intra_wf import (
        intra_pass_wavefront_cuda, intra_pass_wavefront_plain)
    from h264bsd_tpu_torch.ops.deblock import anti_diagonals
    from h264bsd_tpu_torch.ops.intra import intra_pass_list
    from h264bsd_tpu_torch.utils import kernel_cases as kc
    from h264bsd_tpu_torch.utils import streamgen

    dev = torch.device("cuda")
    smi = nvidia_smi()

    # ---- env: build everything from the checkout's sources
    t0 = time.perf_counter()
    fe_build.build(force=True)
    t1 = time.perf_counter()
    _kernels.build(force=True)
    t2 = time.perf_counter()
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "frontend_build_s": t1 - t0,
          "kernel_build_s": t2 - t1})

    # ---- kernels: each CUDA kernel byte-equal to its plain version
    def plain_intra_list(y, cb, cr, *rest, ids):
        return intra_pass_list(y, cb, cr, ids, *rest)

    errs = {k: 0 for k in KERNELS}
    checks = []

    def check(name, kernel, plain, args, dims):
        got = kernel(*planes_copy(args), *dims)
        want = plain(*planes_copy(args), *dims)
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        checks.append({"kernel": name, "dims": list(dims), "max_abs_err": err})
        if err:
            raise AssertionError(f"{name} at {dims}: kernel differs from "
                                 f"its plain version (max |err| {err})")

    _kernels.reset_launches()
    for seed, dims in enumerate([(6, 4), (9, 5), (3, 7), (20, 12)]):
        check("deblock_wf", deblock_frame_wavefront_from_bs,
              deblock_wavefront_plain,
              kc.deblock_inputs(kc.deblock_case(seed, *dims), *dims, dev),
              dims)
    for seed, dims in enumerate([(2, 5), (1, 1)]):
        check("deblock_raster", deblock_frame_cuda_from_bs,
              deblock_raster_plain,
              kc.deblock_inputs(kc.deblock_case(seed, *dims), *dims, dev),
              dims)
    for seed, (dims, pad) in enumerate([((6, 4), 0), ((20, 12), 7)]):
        case = kc.intra_case(seed, *dims)
        ids = kc.padded_intra_ids(case, pad, dev)
        check("intra_list",
              lambda *a: intra_pass_cuda(*a, intra_ids=ids),
              lambda *a: plain_intra_list(*a[:-1], ids=ids),
              kc.intra_inputs(case, dev), dims)
    for dims in [(12, 9), (16, 3), (5, 11), (3, 2), (20, 12)]:
        check("intra_wf", intra_pass_wavefront_cuda,
              intra_pass_wavefront_plain,
              kc.intra_inputs(kc.intra_case(7, *dims), dev), dims)
    emit({"phase": "kernels", "checks": checks,
          "launches": dict(_kernels.LAUNCHES)})

    # ---- decodes: checksums against the JAX package's recorded values
    ref = json.loads(open("h264bsd_tpu_torch/testdata/"
                          "reference_checksums.json").read())
    launches = {k: 0 for k in KERNELS}

    def decode(name, timed):
        e = ref[name]
        data = getattr(streamgen, e["maker"])(*e["args"])
        if hashlib.sha256(data).hexdigest() != e["sha256"]:
            raise AssertionError(f"{name}: stream bytes differ from the "
                                 "recorded stream")
        _kernels.reset_launches()
        sums = [frame_checksum_host(p.yuv_bytes())
                for p in decode_stream(data)]
        counts = dict(_kernels.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        if sums != e["checksums"]:
            raise AssertionError(f"{name}: checksums {sums} != recorded "
                                 f"{e['checksums']}")
        rec = {"stream": name, "pictures": len(sums), "checksums_ok": True,
               "launches": counts}
        if timed:
            # steady state: the pass above warmed everything up
            t0 = time.perf_counter()
            n = sum(1 for _ in decode_stream(data))
            torch.cuda.synchronize()
            rec["fps"] = n / (time.perf_counter() - t0)
        return rec, counts

    for phase, name, need in [("decode_720p_all_i", "intra_720p",
                               ("intra_wf", "deblock_wf")),
                              ("decode_1080p_all_i", "intra_1080p",
                               ("intra_wf", "deblock_wf"))]:
        rec, counts = decode(name, timed=True)
        if not all(counts[k] > 0 for k in need):
            raise AssertionError(f"{name}: kernels {need} not all launched: "
                                 f"{counts}")
        emit({"phase": phase, **rec})
    small = [decode(name, timed=False)
             for name in ("intra_40x23", "lowqp_i", "intra_2x4")]
    small_counts = {k: sum(c[k] for _, c in small) for k in KERNELS}
    if not (small_counts["intra_list"] > 0
            and small_counts["deblock_raster"] > 0):
        raise AssertionError(f"small streams: K2/K8 not launched: "
                             f"{small_counts}")
    emit({"phase": "decode_small", "streams": [r for r, _ in small]})
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # ---- timing at the main path's shapes (720p for K1/K7, 40x23 for K2,
    # 2x4 for K8), kernel vs plain on the same inputs
    def deblock_bound(args, dims):
        y, cb, cr, bs_left, bs_top, lt, ct = args
        lines = 4 * int((bs_left > 0).sum() + (bs_top > 0).sum())
        # chroma edges read the bS of luma block columns / rows 0 and 2
        c_lines = 2 * 2 * int((bs_left[:, [0, 2, 4, 6, 8, 10, 12, 14]] > 0)
                              .sum() + (bs_top[:, :4] > 0).sum()
                              + (bs_top[:, 8:12] > 0).sum())
        ops = lines * OPS_LUMA_LINE + c_lines * OPS_CHROMA_LINE
        byt = 2 * nbytes((y, cb, cr)) + nbytes((bs_left, bs_top, *lt, *ct))
        return byt, ops

    def intra_bound(args, dims, ids=None):
        y, cb, cr, mb_class, *rest = args
        n_intra = int(((mb_class == 3) | (mb_class == 4)).sum())
        ops = n_intra * 384 * OPS_INTRA_PEL
        # the kernel reads the per-MB inputs as int32, the weight table
        # (9x16x13 int32) and the id list
        byt = 2 * nbytes((y, cb, cr)) + 4 * sum(
            t.numel() for t in (mb_class, *rest)) + 9 * 16 * 13 * 4
        if ids is not None:
            byt += 4 * ids.numel()
        return byt, ops

    rows = []

    def time_kernel(name, kernel, plain, args, dims, bound, serial,
                    plain_reps):
        """serial: the kernel's chain of dependent steps (diagonals for
        the wavefront kernels, one CUDA launch each; MBs walked by the
        single launch of the raster and list kernels)."""
        got = kernel(*planes_copy(args), *dims)
        want = plain(*planes_copy(args), *dims)
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        if err:
            raise AssertionError(f"{name} at {dims}: kernel differs from "
                                 f"its plain version (max |err| {err})")
        ms = timed_ms(lambda *a: kernel(*a, *dims), args, 20)
        plain_ms = timed_ms(lambda *a: plain(*a, *dims), args, plain_reps)
        byt, ops = bound
        t_bytes, t_ops = byt / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": None, "dims": list(dims),
                     "cuda_launches_per_call":
                         serial if name.endswith("_wf") else 1,
                     "serial_steps": serial})

    dims = (80, 45)
    n_diag = len(anti_diagonals(*dims))
    args = kc.deblock_inputs(kc.deblock_case(11, *dims), *dims, dev)
    time_kernel("deblock_wf", deblock_frame_wavefront_from_bs,
                deblock_wavefront_plain, args, dims,
                deblock_bound(args, dims), n_diag, 2)
    args = kc.intra_inputs(kc.intra_case(12, *dims, all_intra=True), dev)
    time_kernel("intra_wf", intra_pass_wavefront_cuda,
                intra_pass_wavefront_plain, args, dims,
                intra_bound(args, dims), n_diag, 2)
    dims = (40, 23)
    case = kc.intra_case(13, *dims, all_intra=True)
    ids = kc.padded_intra_ids(case, 0, dev)
    args = kc.intra_inputs(case, dev)
    time_kernel("intra_list",
                lambda *a: intra_pass_cuda(*a, intra_ids=ids),
                lambda *a: plain_intra_list(*a[:-1], ids=ids), args, dims,
                intra_bound(args, dims, ids), int(ids.numel()), 1)
    dims = (2, 4)
    args = kc.deblock_inputs(kc.deblock_case(14, *dims), *dims, dev)
    time_kernel("deblock_raster", deblock_frame_cuda_from_bs,
                deblock_raster_plain, args, dims,
                deblock_bound(args, dims), dims[0] * dims[1], 3)
    emit({"phase": "timing", "gpu": smi,
          "kernels": [{k: r[k] for k in ("name", "dims", "ms", "plain_ms",
                                         "cuda_launches_per_call")}
                      for r in rows]})

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
