#!/usr/bin/env python3
"""Record the per-picture checksums that the PyTorch port is held to.

Decodes each stream of STREAMS with the JAX package
(h264bsd_tpu.models.decoder.decode_stream) on the CPU and writes
h264bsd_tpu_torch/testdata/reference_checksums.json: for every stream its
generator call, the SHA-256 of the generated bytes and the
frame_checksum_host of every output picture's uncropped YUV, in display
order. The streamgen streams are generated with the JAX package's
streamgen, the motion and SEI streams with the port's
utils/motion_stream.py and utils/sei_stream.py (test data of the port).
An entry marked "sei" also records the SEI messages the JAX package's
Decoder.take_sei_messages returns, as [payload_type, name, payload hex].
chip_smoke.py regenerates every stream with the port's own modules (it
may not import the JAX package) and compares.

Usage:
  JAX_PLATFORMS=cpu python tools/record_torch_port_checksums.py \
      [--check] [--only NAME ...]

--check recomputes and exits non-zero if the file differs; --only limits
the work to the named entries (the 720p/1080p decodes take minutes on the
CPU).

The fuzz_* entries (FUZZ_SEEDS) are corrupted copies of other entries,
decoded with pipelined=False; where the JAX package raises on one, the
entry records the exception's type under "raises" and no checksums.
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

# frame dicts of tests/test_conformance_streams.py MULTIREF_CASES (lists
# for JSON)
MULTIREF = {
    "six_ref_cycle": dict(num_ref_frames=6, frames=[
        dict(idr=True, frame_num=0, dc=4), dict(frame_num=1, dc=5),
        dict(frame_num=2, dc=-3), dict(frame_num=3, dc=6),
        dict(frame_num=4, dc=-4), dict(frame_num=5, dc=7),
        dict(frame_num=6, n_active=6, ref_cycle=6, dc=-5)]),
    "frame_num_gap": dict(gaps_allowed=True, num_ref_frames=2, frames=[
        dict(idr=True, frame_num=0, dc=4), dict(frame_num=1, dc=5),
        dict(frame_num=3, n_active=2, ref_idx=1, dc=-3),
        dict(frame_num=4, n_active=2, ref_idx=0, dc=6)]),
    "longterm": dict(num_ref_frames=3, frames=[
        dict(idr=True, frame_num=0, dc=4),
        dict(frame_num=1, mmco=[[4, 1], [3, 0, 0]], dc=5),
        dict(frame_num=2, dc=-3),
        dict(frame_num=3, n_active=3, ref_idx=2, dc=6),
        dict(frame_num=4, reorder=[[2, 0]], dc=-6)]),
}

# name -> entry: generator ("maker", in "module", default streamgen), its
# "args" and "kwargs", and the NAL unit a loss case removes ("drop_nal";
# see h264bsd_tpu_torch/utils/recorded.py)
STREAMS = {
    # BASELINE.json config 3: all-I 720p (tools/bench_configs.py)
    "intra_720p": dict(maker="make_intra_stress_stream", args=[80, 45, 6]),
    "intra_1080p": dict(maker="make_intra_stress_stream",
                        args=[120, 68, 2]),
    # <= 2048 intra MBs: the list intra kernel
    "intra_40x23": dict(maker="make_intra_stress_stream", args=[40, 23, 2]),
    # one MB: list intra kernel + raster deblock kernel
    "lowqp_i": dict(maker="make_lowqp_i_stream", args=[]),
    # 2 MBs wide: both hand-offs to the raster kernels
    "intra_2x4": dict(maker="make_intra_stress_stream", args=[2, 4, 2]),
    # BASELINE.json config 4's IPPP at 1080p: the uniform MC kernel
    "ippp_1080p": dict(maker="make_ippp_stream", args=[120, 68, 8]),
    # real motion at 1080p: both MC kernels and sparse intra (K2)
    "motion_1080p": dict(module="motion_stream", maker="make_motion_stream",
                         args=[120, 68, 5], kwargs=dict(seed=0)),
    # the small P streams of tests/test_torch_p_decode.py
    "ippp_4x4": dict(maker="make_ippp_stream", args=[4, 4, 4]),
    **{name: dict(maker="make_multiref_stream", args=[], kwargs=kw)
       for name, kw in MULTIREF.items()},
    "intra_in_p": dict(maker="make_intra_in_p_stream", args=[False]),
    "intra_in_p_constrained": dict(maker="make_intra_in_p_stream",
                                   args=[True]),
    "pcm": dict(maker="make_pcm_stream", args=[]),
    "deblock_control": dict(maker="make_deblock_control_stream", args=[]),
    "slice_groups": dict(maker="make_conformance_stream", args=[],
                         kwargs=dict(num_slice_groups=2)),
    "redundant": dict(maker="make_redundant_stream", args=[False]),
    "motion_6x4": dict(module="motion_stream", maker="make_motion_stream",
                       args=[6, 4, 4], kwargs=dict(seed=0)),
    # partial losses: the IDR's second slice (spiral concealment on the
    # host), the first P picture's second slice (copy on the device)
    "loss_idr_slice": dict(maker="make_conformance_stream", args=[],
                           kwargs=dict(slices_per_frame=2), drop_nal=3),
    "loss_p_slice": dict(maker="make_conformance_stream", args=[],
                         kwargs=dict(slices_per_frame=2), drop_nal=5),
    # an SEI NAL unit before every picture (Decoder.take_sei_messages)
    "sei_20x12": dict(module="sei_stream", maker="make_sei_stream",
                      args=[20, 12, 6], sei=True),
    # 1080p IPPP fed to StreamingDecoder in chunks
    "stream_ippp_1080p": dict(maker="make_ippp_stream", args=[120, 68, 12]),
    # 2 MBs wide and 68 tall (a 32x1088 strip): the raster deblock kernel
    # across bands of MB rows
    "ippp_2x68": dict(maker="make_ippp_stream", args=[2, 68, 4]),
    # further 1080p streams of the multistream phase (with motion_1080p,
    # ippp_1080p and stream_ippp_1080p): other motion seeds and IPPP QPs
    **{f"motion_1080p_s{s}": dict(module="motion_stream",
                                  maker="make_motion_stream",
                                  args=[120, 68, 4], kwargs=dict(seed=s))
       for s in (1, 2, 3)},
    "ippp_1080p_qp30": dict(maker="make_ippp_stream", args=[120, 68, 6],
                            kwargs=dict(qp=30)),
    "ippp_1080p_qp22": dict(maker="make_ippp_stream", args=[120, 68, 5],
                            kwargs=dict(qp=22)),
    # the streams bench_torch.py times: 32-picture 1080p IPPP and
    # 16-picture 1080p motion
    "bench_ippp_1080p": dict(maker="make_ippp_stream", args=[120, 68, 32]),
    "bench_motion_1080p": dict(module="motion_stream",
                               maker="make_motion_stream",
                               args=[120, 68, 16], kwargs=dict(seed=0)),
    # BASELINE.json config 5 cut to N = 8 streams of 40x23 MBs (640x360,
    # tools/bench_configs_torch.py): motion seeds 0-3 between IPPP
    # streams at four QPs, 16 pictures each, a motion stream first (its
    # DPB sizes the shared ring)
    **{f"ms360_{k}": dict(module="motion_stream", maker="make_motion_stream",
                          args=[40, 23, 16], kwargs=dict(seed=k // 2))
       if k % 2 == 0 else
       dict(maker="make_ippp_stream", args=[40, 23, 16],
            kwargs=dict(qp=(26, 30, 34, 22)[k // 2]))
       for k in range(8)},
}

# corrupted copies of these entries ("corrupt": 1-4 flipped bytes drawn
# from the seed, utils/recorded.py corrupt), named fuzz_<base>_s<seed>:
# every P path, FMO, I_PCM, frame_num gaps and redundant slices at 4x4;
# the raster deblock on a 2x68 strip; the intra wavefront and the
# spiral concealment at 1080p; MC, sparse intra lists and the wavefront
# deblock on 1080p P pictures
FUZZ_SEEDS = {
    **{base: range(4) for base in (
        "ippp_4x4", "motion_6x4", "six_ref_cycle", "longterm",
        "frame_num_gap", "slice_groups", "pcm", "intra_in_p_constrained",
        "redundant")},
    "ippp_2x68": range(2), "intra_1080p": range(2),
    "ippp_1080p": range(3), "motion_1080p": range(3)}
STREAMS.update({f"fuzz_{base}_s{seed}": dict(STREAMS[base],
                                             corrupt=dict(seed=seed))
                for base, seeds in FUZZ_SEEDS.items() for seed in seeds})


def sei_messages(data, jdec) -> list:
    """[payload_type, name, payload hex] of every SEI message of the
    stream, in order, from the decoder module `jdec`'s Decoder."""
    dec = jdec.Decoder()
    out = []
    pos = 0
    while pos < len(data):
        status, read = dec.decode(data[pos:])
        pos += read
        if status == jdec.PIC_RDY:
            while dec.next_output_picture() is not None:
                pass
        out += [[m.payload_type, m.name, m.payload.hex()]
                for m in dec.take_sei_messages()]
        if status >= jdec.ERROR and read == 0:
            break
    return out


def record(names) -> dict:
    from h264bsd_tpu.models import decoder as jdec
    from h264bsd_tpu.models.decoder import decode_stream, frame_checksum_host
    from h264bsd_tpu.utils import streamgen
    from h264bsd_tpu_torch.utils import motion_stream, sei_stream
    from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

    # the JAX package's streamgen for its streams; the motion and SEI
    # streams are the port's own test data
    modules = {"streamgen": streamgen, "motion_stream": motion_stream,
               "sei_stream": sei_stream}
    out = {}
    for name in names:
        entry = STREAMS[name]
        t0 = time.perf_counter()
        data = make_recorded_stream(entry, modules)
        out[name] = {**entry, "sha256": hashlib.sha256(data).hexdigest()}
        # a corrupted stream may change its geometry mid-stream, which
        # the pipelined decode_stream of the JAX package does not follow
        pipelined = "corrupt" not in entry
        try:
            sums = [frame_checksum_host(p.yuv_bytes())
                    for p in decode_stream(data, pipelined=pipelined)]
        except Exception as exc:
            # no oracle for this stream: the entry says what was raised
            out[name]["raises"] = type(exc).__name__
            print(f"{name}: {type(exc).__name__}: {exc}", file=sys.stderr)
            continue
        out[name]["checksums"] = sums
        if entry.get("sei"):
            out[name]["sei_messages"] = sei_messages(data, jdec)
        print(f"{name}: {len(sums)} pictures in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the recorded file instead of writing")
    ap.add_argument("--only", nargs="+", choices=sorted(STREAMS),
                    help="record (or check) only these entries; the file "
                    "keeps the others")
    args = ap.parse_args()
    got = record(args.only or list(STREAMS))
    want = json.loads(OUT.read_text()) if OUT.exists() else {}
    if args.check:
        if any(want.get(k) != v for k, v in got.items()) or \
                (not args.only and set(want) != set(got)):
            print("reference checksums differ from the recorded file",
                  file=sys.stderr)
            sys.exit(1)
        print("reference checksums match")
        return
    merged = {k: got.get(k, want.get(k)) for k in STREAMS
              if k in got or k in want}
    OUT.write_text(json.dumps(merged, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
