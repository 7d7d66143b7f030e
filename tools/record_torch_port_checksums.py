#!/usr/bin/env python3
"""Record the per-picture checksums that the PyTorch port is held to.

Decodes each stream of STREAMS with the JAX package
(h264bsd_tpu.models.decoder.decode_stream) on the CPU and writes
h264bsd_tpu_torch/testdata/reference_checksums.json: for every stream its
generator call, the SHA-256 of the generated bytes and the
frame_checksum_host of every output picture's uncropped YUV, in display
order. chip_smoke.py regenerates the streams with the port's own copy of
streamgen (it may not import the JAX package) and compares.

Usage:
  JAX_PLATFORMS=cpu python tools/record_torch_port_checksums.py [--check]

--check recomputes everything and exits non-zero if the file differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "h264bsd_tpu_torch" / "testdata" / "reference_checksums.json"

# name -> (streamgen function, positional arguments)
STREAMS = {
    # BASELINE.json config 3: all-I 720p (tools/bench_configs.py)
    "intra_720p": ("make_intra_stress_stream", [80, 45, 6]),
    "intra_1080p": ("make_intra_stress_stream", [120, 68, 2]),
    # <= 2048 intra MBs: the list intra kernel
    "intra_40x23": ("make_intra_stress_stream", [40, 23, 2]),
    # one MB: list intra kernel + raster deblock kernel
    "lowqp_i": ("make_lowqp_i_stream", []),
    # 2 MBs wide: both hand-offs to the raster kernels
    "intra_2x4": ("make_intra_stress_stream", [2, 4, 2]),
}


def record() -> dict:
    from h264bsd_tpu.models.decoder import decode_stream, frame_checksum_host
    from h264bsd_tpu.utils import streamgen

    out = {}
    for name, (fn, args) in STREAMS.items():
        t0 = time.perf_counter()
        data = getattr(streamgen, fn)(*args)
        sums = [frame_checksum_host(p.yuv_bytes())
                for p in decode_stream(data)]
        out[name] = {"maker": fn, "args": args,
                     "sha256": hashlib.sha256(data).hexdigest(),
                     "checksums": sums}
        print(f"{name}: {len(sums)} pictures in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the recorded file instead of writing")
    args = ap.parse_args()
    got = record()
    if args.check:
        want = json.loads(OUT.read_text())
        if got != want:
            print("reference checksums differ from the recorded file",
                  file=sys.stderr)
            sys.exit(1)
        print("reference checksums match")
        return
    OUT.write_text(json.dumps(got, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
