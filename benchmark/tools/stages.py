#!/usr/bin/env python3
"""Where the device's idle time goes, by stage of the program: a cell's
traced run (run.py --trace 1, the harness's own run) with the profiler
recording every thread, so that the spans of decode_stream's parse
thread are in the trace beside the consumer's, then the program's spans
read from the run's Chrome trace (program_spans.py).

    python3 benchmark/tools/stages.py --workload stream_1080p.motion \\
        --seeds 11 12 13

One JSON line per seed: the run's correctness, pictures and per-layer
metrics; `stages`, [span, thread, self seconds, device-idle seconds as
the consumer's innermost span] of the traced window, most idle first;
`frontend.span_ms`, the parse thread's h264.parse and h264.prepare
seconds over its h264.prepare spans (the front-end as it runs beside the
consumer); `named_idle_share`, the percent of the device-idle time
inside bench.next_picture under one of the consumer's h264.* spans;
`replay_launch_share`, the percent of cudaGraphLaunch calls inside
h264.replay spans (the spans and the device operations on one clock).
"""

import argparse
import functools
import json
import sys
import time
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def all_threads():
    """The harness's profiler, recording the CPU activity of every
    thread (it records only the thread that starts it otherwise)."""
    import torch.profiler
    from torch._C._profiler import _ExperimentalConfig
    return mock.patch.object(torch.profiler, "profile", functools.partial(
        torch.profiler.profile,
        experimental_config=_ExperimentalConfig(profile_all_threads=True)))


def stage_run(name, seed, seconds, **kwargs):
    """One traced run of cell `name` with every thread recorded: the
    result line's object with the stage split added."""
    import harness
    import program_spans
    result = harness.run_cell(name, seed, seconds, True, time.perf_counter(),
                              patch=all_threads, **kwargs)
    st = program_spans.read(harness.OUT / f"trace_{name}.json")
    out = {"workload": name, "seed": seed, "correct": result["correct"],
           "device": result["device"]["kind"],
           "pictures": result["attempted"],
           "window_s": result["device"]["window_s"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
    if st is not None:
        out.update({"stages": st.stages(),
                    "frontend.span_ms": st.frontend_ms(),
                    "named_idle_share": st.named_idle_share(),
                    "replay_launch_share": st.replay_launch_share()})
    return out


def main():
    import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float,
                    default=harness.load_spec()["run_seconds"])
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(stage_run(args.workload, seed, args.seconds)),
              flush=True)


if __name__ == "__main__":
    main()
