"""CLI decoder of the PyTorch port, the counterpart of the JAX package's
tools/h264dec.py and of the reference posix test app (reference
posix/test_h264bsd.c): decode an Annex-B H.264 Baseline file, optionally
dump YUV (-o), pixel-compare against a golden YUV (-c), loop forever for
soak testing (-r), and print the decoded-frame count and fps (reference
win/h264bsdTest/h264bsdTest.cpp:84 prints the same figures). The options
and printed lines are h264dec.py's; --device picks the device (the card
by default, "cpu" runs the kernels' plain versions).

Usage:
  python -m h264bsd_tpu_torch.cli [-o out.yuv] [-c golden.yuv] [-r]
      [--rgba out.rgba] [--render DIR] [--device DEV] stream.h264
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

from .models.decoder import ERROR, HDRS_RDY, PIC_RDY, Decoder


def decode_file(data: bytes, on_picture, device=None):
    """Reference decode loop (posix/test_h264bsd.c:146-177); returns the
    pictures decoded, every one finished on the device."""
    dec = Decoder(device=device)
    pos = 0
    n_pics = 0
    try:
        while pos < len(data):
            status, read = dec.decode(data, n_pics, pos)
            pos += read
            if status == HDRS_RDY:
                crop = dec.cropping_params()
                print(f"Decoded headers. Image size (cropped) "
                      f"{crop[2]}x{crop[4]}.")
            elif status == PIC_RDY:
                while (pic := dec.next_output_picture()) is not None:
                    on_picture(pic)
                    n_pics += 1
            elif status >= ERROR:
                if read == 0:
                    print(f"decode error at byte {pos}, cannot resync",
                          file=sys.stderr)
                    break
        if dec.device.type == "cuda":
            torch.cuda.synchronize(dec.device)
    finally:
        dec.close()
    return n_pics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("stream", type=Path)
    ap.add_argument("-o", "--output", type=Path,
                    help="dump decoded pictures as cropped YUV420 "
                         "(reference -o semantics: first crop-sized bytes "
                         "of the picture buffer)")
    ap.add_argument("-c", "--compare", type=Path,
                    help="per-pixel compare against a golden YUV file "
                         "(reference -c semantics)")
    ap.add_argument("--rgba", type=Path, help="dump RGBA frames")
    ap.add_argument("--render", type=Path, metavar="DIR",
                    help="render each output picture to DIR/frame_%%05d"
                         ".ppm (cropped, BT.601 device conversion with "
                         "the stream's full-range flag) — the display-"
                         "sink analogue of the reference's WebGL canvas "
                         "renderer (wasm/h264bsd_canvas.js:241 "
                         "drawNextOutputPicture), as viewable files "
                         "instead of GL draws")
    ap.add_argument("-r", "--repeat", action="store_true",
                    help="decode in an infinite loop (soak test)")
    ap.add_argument("--device", default=None,
                    help="torch device to decode on (default: the current "
                         "CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    data = args.stream.read_bytes()
    golden = args.compare.read_bytes() if args.compare else None

    out_f = open(args.output, "wb") if args.output else None
    rgba_f = open(args.rgba, "wb") if args.rgba else None
    if args.render:
        args.render.mkdir(parents=True, exist_ok=True)
    state = {"frame": 0, "diffs": 0}

    def on_picture(pic):
        crop = pic.crop
        n = crop[1] * crop[3] * 3 // 2
        yuv = pic.yuv_bytes()[:n]
        if out_f:
            out_f.write(yuv)
        if rgba_f:
            rgba_f.write(pic.rgba().tobytes())
        if args.render:
            # crop is (left, width, top, height); full_range comes from
            # the stream's VUI exactly as the canvas renderer would use
            left, w, top, h = crop
            rgb = pic.rgba(full_range=pic.full_range) \
                [top:top + h, left:left + w, :3]
            p = args.render / f"frame_{state['frame']:05d}.ppm"
            with open(p, "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (w, h))
                f.write(rgb.tobytes())
        if golden is not None:
            ref = golden[state["frame"] * n:(state["frame"] + 1) * n]
            diffs = 0
            if yuv != ref:
                # a short golden counts every missing byte as a diff
                diffs = sum(a != b for a, b in zip(yuv, ref)) \
                    + abs(len(yuv) - len(ref))
            if diffs:
                print(f"frame {state['frame']}: {diffs} differing pixels")
            state["diffs"] += diffs
        state["frame"] += 1

    try:
        while True:
            state["frame"] = 0
            t0 = time.perf_counter()
            n = decode_file(data, on_picture, args.device)
            dt = time.perf_counter() - t0
            print(f"Test file complete. {n} pictures decoded. "
                  f"{n / dt:.1f} fps ({dt / max(n, 1) * 1000:.2f} ms per "
                  f"frame)")
            if golden is not None:
                print("Binary comparison",
                      "FAILED:" if state["diffs"] else "OK:",
                      f"{state['diffs']} differing pixels")
            if not args.repeat:
                break
    finally:
        if out_f:
            out_f.close()
        if rgba_f:
            rgba_f.close()
    return 1 if (golden is not None and state["diffs"]) else 0


if __name__ == "__main__":
    sys.exit(main())
