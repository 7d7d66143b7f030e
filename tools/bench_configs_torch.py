#!/usr/bin/env python3
"""Benchmark BASELINE.json's config matrix on the PyTorch port
(h264bsd_tpu_torch), the counterpart of tools/bench_configs.py:

  1. test_640x360.h264, full decode loop, bit-exact against the
     reference decoder's output
  2. test_1920x1080.h264 and test_1920x1080_fullRange.h264, the same
  3. intra-only all-I 720p (recorded entry intra_720p,
     make_intra_stress_stream(80, 45, 6)): the front-end and the intra
     wavefront (K7)
  4. GOP-parallel decode of a long IPPP stream: the 1080p IPPP stream
     bench_torch.py times (bench_ippp_1080p, 32 pictures), four times
     over (closed GOPs), on decode_stream_gop_parallel and on
     decode_stream_framepipe at 2 positions
  5. many streams at once: N 640x360 streams (40x23 MBs; recorded entries
     ms360_0..7, 16 pictures each) on MultiStreamDecoder

The streams of configs 1 and 2 are the reference tree's
(utils/golden.py, H264BSD_REFERENCE); without it their lines say
"absent": true. Every other config is verified by checksum before it is
timed: configs 1-3 through models/decoder.benchmark_stream, config 4's
drivers through models/decoder.benchmark_passes (a verification pass
checksummed on the device, then timed passes, each checksummed after
its clock stops), config 5 round by round (every picture in the round
that released it) and then in timed runs of the pipelined
MultiStreamDecoder.run() on the verification run's ring and round
graphs, each checked by its picture counts and the last picture of
every stream. Each config prints one JSON line (config 4 one per
driver): best fps ("value"), "median", "fps_all" (all the timed
pictures over all the timed seconds) and "runs", as bench_torch.py
prints them, with "bit_exact" and the device's name and power limit. A
line that is not bit-exact has no fps and makes the tool exit 1.

Usage: python3 tools/bench_configs_torch.py [--only CONFIG ...]
           [--budget SECONDS] [--device DEV] [--streams N]
           [--checksums PATH] [--entries CONFIG=NAME[,NAME...] ...]

--entries replaces the recorded streams of config 3, 4 or 5 (for
instance 4x4 streams for a short run on the CPU).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_torch import CHECKSUMS, device_info  # noqa: E402

# config name -> (BASELINE.json config number, the recorded entries it
# decodes; none for the reference tree's streams)
CONFIGS = {
    "640x360": (1, ()),
    "1080p": (2, ()),
    "1080p_fullRange": (2, ()),
    "intra720p": (3, ("intra_720p",)),
    "gop": (4, ("bench_ippp_1080p",)),
    "framepipe": (4, ("bench_ippp_1080p",)),
    "multistream": (5, tuple(f"ms360_{k}" for k in range(8))),
}
GOP_COPIES = 4
FRAMEPIPE_POSITIONS = 2
GOLDEN = {"640x360": "640x360", "1080p": "1920x1080",
          "1080p_fullRange": "1920x1080_fullRange"}


def recorded_entries(ref, names):
    """[(entry, bytes)] of the recorded entries, each checked against
    its SHA-256."""
    from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

    out = []
    for name in names:
        data = make_recorded_stream(ref[name])
        if hashlib.sha256(data).hexdigest() != ref[name]["sha256"]:
            raise RuntimeError(f"{name}: stream bytes differ from the "
                               "recorded stream")
        out.append((ref[name], data))
    return out


def _fps_fields(r) -> dict:
    return {"value": r["fps"], "unit": "frames/sec", "median": r["median"],
            "fps_all": r["fps_all"], "runs": r["runs"],
            "timed_s": r["timed_s"], "cold_fps": r["cold_fps"],
            "captures": r["captures"], "capture_ms": r["capture_ms"],
            "pictures": r["pictures"], "bit_exact": r["bit_exact"]}


def config_golden(name, budget, dev) -> dict:
    """Configs 1 and 2: a reference-tree stream against the reference
    decoder's dump (its truncated frames), or absent."""
    from h264bsd_tpu_torch.models.decoder import (benchmark_stream,
                                                  frame_checksum_host)
    from h264bsd_tpu_torch.utils import golden

    if golden.REFERENCE is None or not (golden.REFERENCE / "src").is_dir():
        return {"absent": True}
    data = golden.stream_path(GOLDEN[name]).read_bytes()
    goldens = golden.golden_frames(GOLDEN[name])
    r = benchmark_stream(data, [frame_checksum_host(g) for g in goldens],
                         repeats=1, device=dev, budget_s=budget,
                         n_trunc=len(goldens[0]))
    return _fps_fields(r)


def config_intra(entries, budget, dev) -> dict:
    from h264bsd_tpu_torch.models.decoder import benchmark_stream

    (e, data), = entries
    return _fps_fields(benchmark_stream(data, e["checksums"], repeats=1,
                                        device=dev, budget_s=budget))


def config_long_ippp(driver, entries, budget, dev) -> dict:
    """Config 4: the entries' bytes concatenated GOP_COPIES times (each
    starts with its parameter sets and an IDR: closed GOPs), on the GOP
    or framepipe driver."""
    from h264bsd_tpu_torch.models.decoder import benchmark_passes
    from h264bsd_tpu_torch.parallel.framepipe import decode_stream_framepipe
    from h264bsd_tpu_torch.parallel.gop import decode_stream_gop_parallel
    from h264bsd_tpu_torch.parallel.mesh import Mesh

    data = b"".join(d for _, d in entries) * GOP_COPIES
    want = [c for e, _ in entries for c in e["checksums"]] * GOP_COPIES
    if driver == "gop":
        def run():
            return [p.planes for p in decode_stream_gop_parallel(
                data, devices=[dev])]
    else:
        mesh = Mesh([dev] * FRAMEPIPE_POSITIONS, ("pipe",))

        def run():
            return [p.planes for p in decode_stream_framepipe(data, mesh,
                                                              "pipe")]
    r = benchmark_passes(run, want, dev, repeats=1, budget_s=budget)
    return {**_fps_fields(r), "copies": GOP_COPIES,
            **({"positions": FRAMEPIPE_POSITIONS} if driver != "gop"
               else {})}


def _picture_sum(dec, i, j):
    from h264bsd_tpu_torch.models.decoder import frame_checksum_device

    planes = dec.picture(i, j)
    return frame_checksum_device(*planes, sum(p.numel() for p in planes))


def config_multistream(entries, n, budget, dev, mesh=None) -> dict:
    """Config 5: the first n of the entries (cycled) on one
    MultiStreamDecoder on `dev`, or sharded over `mesh`'s "stream" axis
    (`dev` its first device). Verification: round by round, every picture's
    checksum taken in the round that released it. Timed: the pipelined
    run() on decoders that take over the verification decoder's ring and
    round graphs (the steady state of a server), until `budget` seconds,
    each checked by its picture counts and every stream's last
    picture."""
    import torch

    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
    from h264bsd_tpu_torch.parallel.multistream import MultiStreamDecoder

    chosen = [entries[k % len(entries)] for k in range(n)]
    streams = [d for _, d in chosen]
    want = [e["checksums"] for e, _ in chosen]
    reset_stats()
    t0 = time.perf_counter()
    first = MultiStreamDecoder(streams, device=dev, mesh=mesh)
    got = [[] for _ in streams]
    while first.step():
        for i, sums in enumerate(got):
            sums += [_picture_sum(first, i, j)
                     for j in range(len(sums), len(first.outputs[i]))]
    got = [[int(s) for s in sums] for sums in got]
    cold_s = time.perf_counter() - t0
    first.close()
    pictures = sum(map(len, want))
    rec = {"streams": n, "pictures": pictures,
           "bit_exact": got == want, "cold_fps": pictures / cold_s,
           "captures": STATS["graph_captures"],
           "capture_ms": STATS["capture_ms"]}
    runs, timed_s = [], 0.0
    if rec["bit_exact"]:
        reset_stats()
        while not runs or timed_s < budget:
            dec = MultiStreamDecoder(streams, device=dev, mesh=mesh)
            dec.geom, dec._shards = first.geom, first._shards
            t0 = time.perf_counter()
            counts = dec.run(pipelined=True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            last = [int(_picture_sum(dec, i, -1)) if w else None
                    for i, w in enumerate(want)]
            dec.close()
            if counts != [len(w) for w in want] or \
                    last != [w[-1] if w else None for w in want]:
                rec["bit_exact"] = False
                rec["failed_pass"] = len(runs)
                runs = []
                break
            timed_s += dt
            runs.append(pictures / dt)
        rec["timed_captures"] = STATS["graph_captures"]
    return {"value": max(runs) if runs else None, "unit": "frames/sec",
            "median": float(np.median(runs)) if runs else None,
            "fps_all": len(runs) * pictures / timed_s if runs else None,
            "runs": runs, "timed_s": timed_s, **rec}


def run_config(name, args, ref, dev) -> dict:
    number, default = CONFIGS[name]
    names = args.entries.get(name, default)
    if number in (1, 2):
        out = config_golden(name, args.budget, dev)
    elif number == 3:
        out = config_intra(recorded_entries(ref, names), args.budget, dev)
    elif number == 4:
        out = config_long_ippp(name, recorded_entries(ref, names), args.budget,
                               dev)
    else:
        out = config_multistream(recorded_entries(ref, names), args.streams,
                                 args.budget, dev)
    return {"config": name, "baseline_config": number,
            "entries": list(names), **out}


def entries_option(allowed):
    """The argparse type of --entries: NAME=ENTRY[,ENTRY...] with NAME
    one of `allowed`, as (NAME, (ENTRY, ...))."""
    def parse(text):
        name, _, entries = text.partition("=")
        if name not in allowed or not entries:
            raise argparse.ArgumentTypeError(
                f"{text!r}: want NAME=ENTRY[,ENTRY...] with NAME one of "
                f"{list(allowed)}")
        return name, tuple(entries.split(","))
    return parse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=list(CONFIGS),
                    default=list(CONFIGS), help="configs to run")
    ap.add_argument("--budget", type=float, default=10.0,
                    help="seconds of timed passes per config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--streams", type=int, default=8,
                    help="stream count of the multistream config")
    ap.add_argument("--checksums", type=Path, default=CHECKSUMS)
    ap.add_argument("--entries", nargs="+", default=[],
                    type=entries_option(
                        [k for k, v in CONFIGS.items() if v[0] >= 3]),
                    help="CONFIG=NAME[,NAME...]: recorded entries in place "
                         "of a config's own")
    args = ap.parse_args(argv)
    args.entries = dict(args.entries)
    from h264bsd_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    info = device_info(dev)
    ref = json.loads(args.checksums.read_text())
    ok = True
    for name in args.only:
        rec = {"config": name, "baseline_config": CONFIGS[name][0]}
        try:
            rec = run_config(name, args, ref, dev)
        except Exception as exc:
            rec.update(bit_exact=False, error=f"{type(exc).__name__}: {exc}")
            print(json.dumps({**rec, "device": info}), flush=True)
            raise
        print(json.dumps({**rec, "device": info}), flush=True)
        ok &= rec.get("absent", False) or rec["bit_exact"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
