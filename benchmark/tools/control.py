#!/usr/bin/env python3
"""The control of `correct`, at a cell's own size: the plain reference
put in the program's place with the luma centre half-sample filtered
from 8-bit intermediates (reference.h264, control=True), compared picture
by picture with the reference itself, as a run compares the program.
The control has to come out not correct (mismatched pictures > 0).

    python3 benchmark/tools/control.py --workload stream_1080p.motion \\
        --seeds 11 12 13

One JSON line per seed: the distinct pictures compared and how many the
control gets wrong.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main():
    import multiprocessing

    import check
    import harness
    import workload
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    spec = harness.load_spec()
    cell, config, traffic = harness.resolve(spec, args.workload)
    harness.prepare_process()
    if args.device == "cuda":
        harness.check_device(cell["chips"])
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        for seed in args.seeds:
            t = time.perf_counter()
            streams = workload.make_streams(config, traffic, seed, pool)
            ref = check.reference_digests(streams, args.device, pool)
            ctl = check.reference_digests(streams, args.device, pool,
                                          control=True)
            bad = sum(not ref[k].equal(ctl[k]) for k in ref)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "pictures": len(ref),
                              "control_mismatched": bad,
                              "seconds": time.perf_counter() - t}),
                  flush=True)


if __name__ == "__main__":
    main()
