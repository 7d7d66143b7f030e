#!/usr/bin/env python3
"""The benchmark of h264bsd_tpu_torch, the PyTorch/CUDA H.264 Baseline
decoder, on NVIDIA GPUs. Runs one cell of BENCHMARK.json once:

    python3 benchmark/run.py --workload stream_1080p.motion --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout, and prints the run's result as the last line
of standard output (one JSON object: correct, attempted, failed, metrics,
device; with --trace 1 the per-layer metrics and a breakdown of the
traced window), after the compared numbers beside their limits as the
last lines of standard error. Exits non-zero, printing no result,
without a CUDA device (it never measures the CPU), with fewer devices
than the cell asks for, or when JAX or the JAX package is loaded once
the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # the harness's modules, then the checkout root for the program;
    # imported here, not at the top, as spawned workers re-import this file
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except harness.NoDevice as exc:
        print(f"run.py: {exc}", file=sys.stderr)
        return 2
    except Exception:  # noqa: BLE001 - a failed run prints no result
        traceback.print_exc()
        return 1
    loaded = harness.forbidden_modules()
    if loaded:
        print("run.py: JAX or the JAX package is loaded in the measuring "
              f"process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
