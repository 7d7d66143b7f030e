#!/usr/bin/env python3
"""Device time of the main path's MC stage (mc_recon_kernel, csrc/mc.cu)
on one GPU, for the tree it runs in.

Builds the CUDA kernels from the checkout, then for chip_smoke.py's 1080p
MC case (kernel_cases.mc_recon_case(15, 120, 68, 4, 0.06)) and for 1080p
frames whose MBs are all of one kind (chip_smoke.py's split rows) prints
one JSON line: the mean duration of the kernel's torch.profiler events
over --reps calls, its bound (bytes and int32 operations, counted as
chip_smoke.py counts them) and the card's name and power limit. Every
call is checked byte-equal to the plain version first. Run it in two
checkouts, one after the other on the same card, to compare them in turns.

Usage: python3 tools/bench_mc_recon.py [--reps 50]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_mc_recon: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from h264bsd_tpu_torch.ops import _kernels
    from h264bsd_tpu_torch.ops.cuda_mc import mc_recon_cuda, mc_recon_plain
    from h264bsd_tpu_torch.utils import kernel_cases as kc

    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi()
    _kernels.build(force=True)
    dims = (120, 68)
    cases = [("chip_smoke 1080p MC case",
              kc.mc_recon_case(15, *dims, 4, 0.06))]
    for label, case in cases + kc.mc_recon_kind_cases(*dims):
        args = kc.mc_recon_inputs(case, dev)
        err = chip_smoke.max_abs_err(mc_recon_cuda(*args, *dims),
                                     mc_recon_plain(*args, *dims))
        if err:
            raise AssertionError(f"{label}: mc_recon differs from its plain "
                                 f"version (max |err| {err})")
        ms, recorded = chip_smoke.device_ms(
            lambda *a: mc_recon_cuda(*a, *dims), args, opts.reps,
            "mc_recon")
        byt, ops = chip_smoke.mc_recon_bound(args)
        print(json.dumps({
            "case": label, "dims": list(dims), "ms": ms,
            "profiled_launches_per_call": recorded,
            "bound_bytes_ms": 1e3 * byt / chip_smoke.HBM_BYTES_PER_S,
            "bound_ops_ms": 1e3 * ops / chip_smoke.ALU_OPS_PER_S,
            "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
