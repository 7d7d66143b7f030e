#!/usr/bin/env python3
"""Report the CUDA graphs one stream's decode makes in the PyTorch port
(the port's form of tools/count_programs.py, which counts the JAX
package's compiled programs).

A windowable frame replays the graph of its key (geometry, ring slots,
blob caps and words, intra class, inter or not; models/decoder.py
Decoder._graph_key), captured by the key's first frame; frames with host
work of their own (I_PCM, the spiral concealment, non-existing frames)
run eagerly. For each recorded stream (reference_checksums.json) the
tool decodes once with decode_stream's sticky caps and once with the
caps pinned from a dry parse (pin_caps_for_stream), and prints one JSON
line each: the graph keys the windowable frames used, captures, replays,
eager frames and, on the card, the captures' host ms (models/graphs.py
STATS), with whether every picture matched its recorded checksum. On
the CPU every frame runs eagerly: the keys are those the card would
capture, and captures and replays are 0.

Usage: python3 tools/count_graphs_torch.py [STREAM ...] [--device DEV]
           [--checksums PATH]
Exits 1 when a picture differs from its recorded checksum.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHECKSUMS = ROOT / "h264bsd_tpu_torch" / "testdata" / \
    "reference_checksums.json"
STREAMS = ("bench_ippp_1080p", "bench_motion_1080p", "intra_720p",
           "ms360_0")


def count(data, want, pin, dev) -> dict:
    """One decode of `data` on `dev`, its caps pinned or not."""
    import torch

    from h264bsd_tpu_torch.models.decoder import (WINDOW, Decoder,
                                                  decode_stream,
                                                  frame_checksum_host,
                                                  pin_caps_for_stream)
    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats

    keys = set()

    class Counting(Decoder):
        def _run_graphed(self, prep, row):
            keys.add(self._graph_key(prep, row))
            super()._run_graphed(prep, row)

    dec = Counting(caps_pin=pin_caps_for_stream(data) if pin else None,
                   slot_margin=WINDOW, device=dev)
    reset_stats()
    try:
        sums = [frame_checksum_host(p.yuv_bytes())
                for p in decode_stream(data, decoder=dec)]
    finally:
        dec.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec = {"pin": pin, "pictures": len(sums), "bit_exact": sums == want,
           "graph_keys": len(keys), **STATS}
    if dev.type != "cuda":
        del rec["capture_ms"]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("streams", nargs="*", default=list(STREAMS),
                    help="recorded stream names (default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--checksums", type=Path, default=CHECKSUMS)
    args = ap.parse_args(argv)
    from h264bsd_tpu_torch.device import resolve_device
    from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

    dev = resolve_device(args.device)
    ref = json.loads(args.checksums.read_text())
    ok = True
    for name in args.streams:
        data = make_recorded_stream(ref[name])
        for pin in (False, True):
            rec = {"stream": name, "device": str(dev),
                   **count(data, ref[name]["checksums"], pin, dev)}
            print(json.dumps(rec), flush=True)
            ok &= rec["bit_exact"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
