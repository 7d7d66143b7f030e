"""Golden-oracle utilities: build the reference decoder in a work directory
and produce golden YUV dumps for the bundled test streams. The port's own
copy of the JAX package's utils/golden.py (it imports nothing of that
package).

The reference is the h264bsd C tree (oneam/h264bsd) with its bundled test
streams, taken only from H264BSD_REFERENCE: without it every helper that
needs the tree raises (or, under pytest, skips), and nothing outside the
checkout is looked for. Builds and dumps go to H264BSD_GOLDEN_DIR, by
default h264bsd_golden in the temporary directory.

The reference posix test app (reference posix/test_h264bsd.c:46-60) writes
``cropped_width * cropped_height * 3/2`` bytes per picture taken from the START
of the *uncropped* picture buffer (whose luma plane is coded_width x
coded_height, e.g. 640x368 for the 640x360 stream). The golden files are
therefore truncated raw buffers, not valid planar YUV at the cropped size.
``truncate_frame`` reproduces that exact quirk so byte-compares match.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path

_REFERENCE_ENV = os.environ.get("H264BSD_REFERENCE")
REFERENCE = Path(_REFERENCE_ENV) if _REFERENCE_ENV else None
WORK = Path(os.environ.get("H264BSD_GOLDEN_DIR",
                           Path(tempfile.gettempdir()) / "h264bsd_golden"))

STREAMS = {
    "640x360": ("test_640x360.h264", 640, 360, 640, 368),
    "1920x1080": ("test_1920x1080.h264", 1920, 1080, 1920, 1088),
    "1920x1080_fullRange": ("test_1920x1080_fullRange.h264", 1920, 1080, 1920, 1088),
}


def _build_once(target: Path, build_to) -> Path:
    """Build `target` exactly once across concurrent processes
    (pytest-xdist workers): exclusive flock + build-to-temp + atomic
    rename, so no process ever runs or reads a half-written artifact."""
    if target.exists():
        return target
    import fcntl

    WORK.mkdir(parents=True, exist_ok=True)
    lockfile = target.with_name(target.name + ".lock")
    fd = os.open(lockfile, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if not target.exists():
            tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
            build_to(tmp)
            os.replace(tmp, target)
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    return target


def _require_reference() -> None:
    """Fail (or, under pytest, skip) clearly when the reference tree is
    absent or H264BSD_REFERENCE is not set: the golden-oracle tests are
    meaningless without it."""
    if REFERENCE is not None and (REFERENCE / "src").is_dir():
        return
    import sys

    where = "H264BSD_REFERENCE is not set" if REFERENCE is None \
        else f"reference tree {REFERENCE} not available"
    msg = f"{where} (set H264BSD_REFERENCE to an oneam/h264bsd checkout)"
    if "pytest" in sys.modules:
        import pytest

        pytest.skip(msg)
    raise FileNotFoundError(msg)


def reference_binary() -> Path:
    """Build the reference test binary (once) into WORK and return its path."""
    _require_reference()

    def _gcc(out: Path):
        srcs = sorted(str(p) for p in (REFERENCE / "src").glob("*.c"))
        srcs.append(str(REFERENCE / "posix" / "test_h264bsd.c"))
        subprocess.run(
            ["gcc", "-O3", "-std=gnu99", f"-I{REFERENCE}/src", *srcs,
             "-o", str(out)],
            check=True,
        )

    return _build_once(WORK / "test_h264bsd", _gcc)


def stream_path(name: str) -> Path:
    _require_reference()
    return REFERENCE / "test" / STREAMS[name][0]


def golden_yuv(name: str) -> Path:
    """Golden YUV dump (truncated-frame format, see module docstring)."""
    def _decode(out: Path):
        binary = reference_binary()
        subprocess.run(
            [str(binary), "-o", str(out), str(stream_path(name))],
            check=True, capture_output=True,
        )

    return _build_once(WORK / f"golden_{name}.yuv", _decode)


def golden_frames(name: str) -> list[bytes]:
    """Golden output pictures as a list of per-frame byte strings."""
    _, cw, ch, _, _ = STREAMS[name]
    frame_size = cw * ch * 3 // 2
    data = golden_yuv(name).read_bytes()
    assert len(data) % frame_size == 0, (len(data), frame_size)
    return [data[i : i + frame_size] for i in range(0, len(data), frame_size)]


def truncate_frame(uncropped_yuv: bytes, name: str) -> bytes:
    """Reproduce the reference test app's dump quirk: first cropped-size bytes
    of the uncropped picture buffer (reference posix/test_h264bsd.c:55-59)."""
    _, cw, ch, _, _ = STREAMS[name]
    return uncropped_yuv[: cw * ch * 3 // 2]


RESILIENT_MAIN = r"""
/* resilient decode loop: like posix/test_h264bsd.c but continues past
 * decode errors so the library's concealment paths run (the stock app
 * exits on the first error). Oracle harness only; built from the
 * read-only reference tree at test time. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "h264bsd_decoder.h"
#include "h264bsd_storage.h"

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  fseek(f, 0, SEEK_END); long size = ftell(f); fseek(f, 0, SEEK_SET);
  u8* buf = malloc(size);
  if (fread(buf, 1, size, f) != (size_t)size) return 2;
  fclose(f);
  FILE* out = fopen(argv[2], "wb");

  storage_t* dec = h264bsdAlloc();
  h264bsdInit(dec, 0);
#ifdef INTRA_CONCEAL
  /* intraConcealmentFlag has no setter in the reference API; poke the
   * struct (h264bsd_storage.h:148-149) */
  dec->intraConcealmentFlag = 1;
#endif
  u8* ptr = buf; long len = size;
  u32 readBytes = 0, picId, isIdr, numErrMbs;
  u32 w = 0, h = 0, cropFlag = 0, left = 0, top = 0;
  while (len > 0) {
    u32 result = h264bsdDecode(dec, ptr, (u32)len, 0, &readBytes);
    len -= readBytes; ptr += readBytes;
    if (result == H264BSD_PIC_RDY) {
      u8* pic = h264bsdNextOutputPicture(dec, &picId, &isIdr, &numErrMbs);
      fprintf(stderr, "pic errMbs=%u\n", numErrMbs);
      if (pic && out && w) fwrite(pic, 1, w * h * 3 / 2, out);
    } else if (result == H264BSD_HDRS_RDY) {
      h264bsdCroppingParams(dec, &cropFlag, &left, &w, &top, &h);
      if (!cropFlag) { w = h264bsdPicWidth(dec) * 16; h = h264bsdPicHeight(dec) * 16; }
    } else if (result == H264BSD_MEMALLOC_ERROR) {
      break;
    }
    /* ERROR / PARAM_SET_ERROR: keep going (readBytes advanced) */
    if (readBytes == 0 && result != H264BSD_HDRS_RDY &&
        result != H264BSD_PIC_RDY) break;
  }
  h264bsdShutdown(dec);
  h264bsdFree(dec);
  if (out) fclose(out);
  return 0;
}
"""


def resilient_binary(intra_conceal: bool = False) -> Path:
    """Reference-based oracle that keeps decoding past errors (exercises
    concealment); see RESILIENT_MAIN. With intra_conceal the oracle pokes
    the reference's intraConcealmentFlag (storage.h:148-149) so P-picture
    losses are concealed from neighbour pels."""
    _require_reference()
    tag = "_ic" if intra_conceal else ""

    def _gcc(out: Path):
        main_c = WORK / f"resilient_main{tag}_{os.getpid()}.c"
        main_c.write_text(RESILIENT_MAIN)
        srcs = sorted(str(p) for p in (REFERENCE / "src").glob("*.c"))
        defs = ["-DINTRA_CONCEAL=1"] if intra_conceal else []
        subprocess.run(
            ["gcc", "-O2", "-std=gnu99", *defs, f"-I{REFERENCE}/src", *srcs,
             str(main_c), "-o", str(out)],
            check=True)
        main_c.unlink()

    return _build_once(WORK / f"resilient_h264bsd{tag}", _gcc)
