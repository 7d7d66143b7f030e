#!/usr/bin/env python3
"""Sweep of the paced path's rates: the highest rate at which the
StreamingDecoder path of stream_1080p.live keeps up (no growing
backlog), from which the cell's fixed rate is set (0.8 of it).

    python3 benchmark/tools/sweep_live.py --seed 5 --seconds 6 \\
        --rates 40 60 80 100 120

One decoder session, warmed up once on the cell's GOPs, then one paced
window per rate in turn; one JSON line per rate: latency percentiles,
the feeder's lateness, and the median latency of the window's last fifth
against its first fifth (a backlog grows when the last is far above).
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main():
    import numpy as np

    import harness
    import workload
    from drivers import Paced
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="stream_1080p.live")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=6)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    spec = harness.load_spec()
    cell, config, traffic = harness.resolve(spec, args.workload)
    harness.prepare_process()
    harness.check_device(cell["chips"])
    streams = workload.make_streams(config, traffic, args.seed)
    drv = Paced(streams, traffic, args.seconds, "cuda")
    drv.warm(harness._no_span)
    for rate in args.rates:
        drv.rate = rate
        win = drv.window(args.seconds, harness._no_span)
        lat = 1e3 * np.array(win.latencies)
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "rate_fps": rate, "pictures": len(lat),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "max_ms": float(lat.max()),
            "first_fifth_p50_ms": float(np.median(lat[:fifth])),
            "last_fifth_p50_ms": float(np.median(lat[-fifth:])),
            "feeder_late_p50_ms": 1e3 * float(np.median(win.lateness)),
            "feeder_late_max_ms": 1e3 * float(max(win.lateness)),
            "missing": win.missing, "time": time.time()}), flush=True)
    drv.close()


if __name__ == "__main__":
    main()
