#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port (h264bsd_tpu_torch): decoded
frames per second of decode_stream on one GPU, bit-exact against the
checksums the JAX package recorded
(h264bsd_tpu_torch/testdata/reference_checksums.json,
tools/record_torch_port_checksums.py).

Per stream (default: bench_ippp_1080p, a 32-picture 1080p IPPP stream,
and bench_motion_1080p, 16 1080p pictures with real motion; --stream
takes any recorded entry), models.decoder.benchmark_stream runs:
  1. a verification pass, whose per-picture checksums are computed on the
     device and compared with the recorded ones; it takes the CUDA graph
     captures (cold_fps includes them);
  2. only if every picture matched, warm timed passes on the same
     decoder's graphs, each ending in torch.cuda.synchronize(), repeated
     until --budget seconds of them have run; after each pass's clock
     stops its pictures are checksummed on the device too, and a pass
     that differs makes the stream's result bit_exact false.
Then it prints ONE JSON line: metric, value (best fps), unit, median,
fps_all (all the timed pictures over all the timed seconds), runs (fps
of each timed pass), timed_s, cold_fps, captures, capture_ms, pictures,
stream, bit_exact, vs_baseline and device (its name and power limit from
nvidia-smi). vs_baseline is the ratio to the reference C decoder's best
fps on the same stream, timed only when utils/golden.reference_binary
can build it (H264BSD_REFERENCE names a reference tree), else null.

Nothing is salvaged: a checksum mismatch, an exception or a failed kernel
build prints a last JSON line with "bit_exact": false (and "error") and
exits non-zero; no fps of an unverified pass is ever reported. It writes
no other file.

Usage: python3 bench_torch.py [--stream NAME ...] [--budget SECONDS]
           [--device DEV] [--checksums PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKSUMS = ROOT / "h264bsd_tpu_torch" / "testdata" / \
    "reference_checksums.json"
STREAMS = ("bench_ippp_1080p", "bench_motion_1080p")
METRIC = "decode_fps_bitexact"


def device_info(dev) -> dict:
    """The device's name and power limit, from nvidia-smi on a card."""
    if dev.type != "cuda":
        return {"name": str(dev), "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, _, limit = out.rpartition(", ")
    return {"name": name, "power_limit": limit}


def reference_fps(data: bytes, pictures: int):
    """Best fps of 5 runs of the reference C decoder's test app on the
    stream, or None when its binary cannot be built (no reference
    tree)."""
    from h264bsd_tpu_torch.utils import golden

    try:
        binary = golden.reference_binary()
    except FileNotFoundError:
        return None
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "stream.h264"
        path.write_bytes(data)
        best = 0.0
        for _ in range(5):
            t0 = time.perf_counter()
            subprocess.run([str(binary), str(path)], check=True,
                           capture_output=True)
            best = max(best, pictures / (time.perf_counter() - t0))
    return best


def bench(name, entry, budget, dev) -> dict:
    """One stream's JSON record (see the module docstring)."""
    from h264bsd_tpu_torch.models.decoder import benchmark_stream
    from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

    data = make_recorded_stream(entry)
    if hashlib.sha256(data).hexdigest() != entry["sha256"]:
        raise RuntimeError(f"{name}: stream bytes differ from the "
                           "recorded stream")
    r = benchmark_stream(data, entry["checksums"], repeats=1, device=dev,
                         budget_s=budget)
    rec = {"metric": METRIC, "value": r["fps"], "unit": "frames/sec",
           "median": r["median"], "fps_all": r["fps_all"],
           "runs": r["runs"], "timed_s": r["timed_s"],
           "cold_fps": r["cold_fps"] if r["bit_exact"] else None,
           "captures": r["captures"], "capture_ms": r["capture_ms"],
           "pictures": r["pictures"], "stream": name,
           "bit_exact": r["bit_exact"], "vs_baseline": None,
           "device": device_info(dev)}
    if "failed_pass" in r:
        rec["failed_pass"] = r["failed_pass"]
    if r["bit_exact"]:
        rec["timed_captures"] = r["timed_captures"]
        ref = reference_fps(data, r["pictures"])
        if ref is not None:
            rec["vs_baseline"] = r["fps"] / ref
            rec["ref_fps"] = ref
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stream", nargs="+", default=list(STREAMS),
                    help="recorded stream names (default: %(default)s)")
    ap.add_argument("--budget", type=float, default=60.0,
                    help="seconds of timed passes per stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--checksums", type=Path, default=CHECKSUMS,
                    help="recorded checksums (default: the port's "
                         "testdata)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for name in args.stream:
        rec = {"metric": METRIC, "stream": name, "bit_exact": False}
        try:
            from h264bsd_tpu_torch.device import resolve_device

            dev = resolve_device(args.device)
            entry = json.loads(args.checksums.read_text())[name]
            rec = bench(name, entry, args.budget, dev)
        except Exception as exc:
            rec["error"] = f"{type(exc).__name__}: {exc}"
            print(json.dumps(rec), flush=True)
            raise
        print(json.dumps(rec), flush=True)
        if not rec["bit_exact"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
