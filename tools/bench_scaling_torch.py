#!/usr/bin/env python3
"""Multi-device scaling of the PyTorch port: frames per second at 1, 2
and 4 devices on the three sharding axes of tools/bench_scaling.py
(BASELINE.md's "≥80% frames/s scaling 1→N"):

  gop          GOP segments decoded concurrently, one worker per device
               (parallel/gop.py; strong scaling over one stream: the
               recorded bench_ippp_1080p, --gop-copies times over)
  multistream  streams through MultiStreamDecoder sharded over a mesh of
               the devices (parallel/multistream.py; weak scaling:
               --ms-per-dev recorded 640x360 streams, ms360_*, per
               device)
  rowshard     one stream's MB rows over the devices, the blob
               row-sharded step frame by frame (parallel/rowshard.py;
               strong scaling over the recorded ippp_1080p, parsed
               before the clock starts)

The n devices are the first n CUDA cards, taken round robin when the
host has fewer: the list then repeats a card, and the tool prints the
fps but "efficiency": null, so it never states a multi-GPU figure it
did not measure. With all n cards distinct, efficiency = fps(n) / (n *
fps(1)). --device cpu runs on a list of "cpu" positions (efficiency
null). Every run is verified: its pictures' checksums against the
recorded ones (models/decoder.benchmark_passes: a verification pass,
then timed passes until --budget seconds, each checksummed after its
clock stops; MultiStreamDecoder round by round and then by its picture
counts and last pictures). Prints torch.cuda.device_count() and one
JSON line per axis; exits 1 when a run differs from the recorded
checksums.

Usage: python3 tools/bench_scaling_torch.py [--axes AXIS ...]
           [--devices N ...] [--budget SECONDS] [--device cpu]
           [--gop-copies K] [--ms-per-dev K] [--checksums PATH]
           [--entries AXIS=NAME[,NAME...] ...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_torch import CHECKSUMS, device_info  # noqa: E402
from tools.bench_configs_torch import (recorded_entries,  # noqa: E402
                                       config_multistream, entries_option)

AXES = {"gop": ("bench_ippp_1080p",),
        "multistream": tuple(f"ms360_{k}" for k in range(8)),
        "rowshard": ("ippp_1080p",)}


def devices(n, cpu):
    """The first n devices: "cpu" positions, or the CUDA cards round
    robin; and whether they are n distinct devices."""
    import torch

    if cpu:
        return [torch.device("cpu")] * n, n == 1
    cards = torch.cuda.device_count()
    return [torch.device("cuda", k % cards) for k in range(n)], n <= cards


def bench_gop(entries, devs, copies, budget):
    from h264bsd_tpu_torch.models.decoder import benchmark_passes
    from h264bsd_tpu_torch.parallel.gop import decode_stream_gop_parallel

    data = b"".join(d for _, d in entries) * copies
    want = [c for e, _ in entries for c in e["checksums"]] * copies
    return benchmark_passes(
        lambda: [p.planes for p in decode_stream_gop_parallel(
            data, devices=devs, threads=len(devs))],
        want, devs[0], repeats=1, budget_s=budget)


def _parsed_frames(data):
    """The stream parsed on the host: per frame its _prepare() record and
    the display-order outputs it releases."""
    from h264bsd_tpu_torch.frontend import binding as fe
    from h264bsd_tpu_torch.models.decoder import Decoder, pin_caps_for_stream

    dec = Decoder(caps_pin=pin_caps_for_stream(data), device="cpu")
    frames, pos = [], 0
    try:
        while pos < len(data):
            status, read = dec._fe.decode(data, 0, pos)
            pos += read
            if status == fe.PIC_RDY:
                prep = dec._prepare()
                outs = []
                while (o := dec._fe.next_output()) is not None:
                    outs.append(o)
                frames.append((prep, outs))
            elif status >= fe.ERROR and read == 0:
                break
    finally:
        dec.close()
    return frames


def bench_rowshard(entries, devs, budget):
    """The blob row-sharded step over the devices' "row" axis, on frames
    parsed before the clock starts; a pass copies every released picture
    out of position 0's ring (every replica holds it)."""
    import torch

    from h264bsd_tpu_torch.models.decoder import benchmark_passes
    from h264bsd_tpu_torch.models.state import new_ring
    from h264bsd_tpu_torch.ops.reconstruct import build_pcm_tensors
    from h264bsd_tpu_torch.parallel.mesh import Mesh
    from h264bsd_tpu_torch.parallel.rowshard import (
        make_row_sharded_blob_step)

    (e, data), = entries
    frames = _parsed_frames(data)
    mesh = Mesh(devs, ("row",))
    prep0 = frames[0][0]
    g = prep0["geom"]
    steps = {}
    for prep, _ in frames:
        if prep["caps"] not in steps:
            steps[prep["caps"]] = make_row_sharded_blob_step(
                mesh, "row", prep["w_mbs"], prep["h_mbs"], prep["caps"])

    def run():
        dpb = tuple(mesh.replicate(p) for p in new_ring(
            g["dpb_slots"], g["height_mbs"], g["width_mbs"], devs[0]))
        pics = []
        for prep, outs in frames:
            pcm = (None,) * 3
            if len(prep["ipcm"][0]):
                pcm = tuple(torch.from_numpy(p) for p in build_pcm_tensors(
                    prep["n_mbs"], *prep["ipcm"]))
            steps[prep["caps"]](prep["blob"], *pcm, *dpb,
                                prep["info"]["slot"])
            pics += [tuple(p[0][o["slot"]].clone() for p in dpb)
                     for o in outs]
        for d in {d for d in devs if d.type == "cuda"}:
            torch.cuda.synchronize(d)
        return pics

    return benchmark_passes(run, e["checksums"], devs[0], repeats=1,
                            budget_s=budget)


def measure(axis, entries, devs, args):
    if axis == "gop":
        r = bench_gop(entries, devs, args.gop_copies, args.budget)
    elif axis == "rowshard":
        r = bench_rowshard(entries, devs, args.budget)
    else:
        from h264bsd_tpu_torch.parallel.mesh import Mesh

        r = config_multistream(entries, args.ms_per_dev * len(devs),
                               args.budget, devs[0],
                               Mesh(devs, ("stream",)))
        r["fps"] = r["value"]
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--axes", nargs="+", choices=list(AXES),
                    default=list(AXES))
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--budget", type=float, default=5.0,
                    help="seconds of timed passes per measurement")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--gop-copies", type=int, default=4)
    ap.add_argument("--ms-per-dev", type=int, default=2)
    ap.add_argument("--checksums", type=Path, default=CHECKSUMS)
    ap.add_argument("--entries", type=entries_option(AXES), nargs="+",
                    default=[],
                    help="AXIS=NAME[,NAME...]: recorded entries in place "
                         "of an axis' own")
    args = ap.parse_args(argv)
    import torch

    from h264bsd_tpu_torch.device import resolve_device

    cpu = args.device == "cpu"
    info = device_info(resolve_device("cpu" if cpu else None))
    print(json.dumps({"cuda_device_count": torch.cuda.device_count(),
                      "device": info}), flush=True)
    ref = json.loads(args.checksums.read_text())
    picked = dict(args.entries)
    ok = True
    for axis in args.axes:
        names = picked.get(axis, AXES[axis])
        entries = recorded_entries(ref, names)
        fps, frames, distinct, exact = {}, {}, True, True
        for n in args.devices:
            devs, alone = devices(n, cpu)
            distinct &= alone
            r = measure(axis, entries, devs, args)
            exact &= r["bit_exact"]
            fps[str(n)], frames[str(n)] = r["fps"], r["pictures"]
        base = fps.get("1")
        eff = {k: v / (int(k) * base) for k, v in fps.items()} \
            if distinct and exact and base else None
        print(json.dumps({"axis": axis, "entries": list(names), "fps": fps,
                          "pictures": frames, "bit_exact": exact,
                          "distinct_devices": distinct, "efficiency": eff,
                          "device": info}), flush=True)
        ok &= exact
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
