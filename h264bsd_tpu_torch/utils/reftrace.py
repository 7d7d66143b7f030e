"""Reader for the instrumented-reference trace format, and the build of
that instrumented reference: a stage-level oracle giving per-MB parsed
state, pixel-domain residuals, and pre-/post-deblock frames. The port's
own copy of the JAX package's utils/reftrace.py and of the tracer build
in tools/make_ref_tracer.py (it imports nothing of that package).

The reference tree comes only from utils/golden.py (H264BSD_REFERENCE):
without it build_tracer and trace_stream raise FileNotFoundError (under
pytest, skip). The instrumented binaries are built under
H264BSD_TRACE_DIR, by default ref_trace in golden.WORK; traces of the
bundled streams go to golden.WORK.

Trace record format (little-endian):
  tag u32:
    1 = MB record        payload: mbNum u32, sliceId u32, mbType u32, qpY u32,
                         totalCoeff i16[27] (+1 pad), intra4x4PredMode u8[16],
                         refPic u32[4], mv i16[16][2],
                         layer: codedBlockPattern u32, mbQpDelta i32,
                         interModes: subMbType u32[4], refIdxL0 u32[4],
                         level i32[26][16]
    2 = pre-deblock frame   payload: byteCount u32, data
    3 = post-deblock frame  payload: byteCount u32, data
    4 = picture done        payload: picOrderCnt i32, frameNum u32,
                                     isIdr u32, nalRefIdc u32
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import golden

TRACE_DIR = Path(os.environ.get("H264BSD_TRACE_DIR",
                                golden.WORK / "ref_trace"))

# zigzag 4x4-block order -> raster within MB (reference neighbour.c:51-62)
ZIG2RAS = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15])


@dataclass
class TraceMb:
    mb_num: int
    slice_id: int
    mb_type: int       # reference internal numbering (P_Skip=0..I_PCM=31)
    qp_y: int
    total_coeff: np.ndarray      # (27,) i16, zigzag block order
    intra4_modes: np.ndarray     # (16,) u8, zigzag
    ref_pic: np.ndarray          # (4,) u32 per 8x8
    mv: np.ndarray               # (16,2) i16, zigzag
    cbp: int
    qp_delta: int
    sub_types: np.ndarray        # (4,) u32
    ref_idx: np.ndarray          # (4,) u32
    levels: np.ndarray           # (26,16) i32 pixel-domain residual


@dataclass
class TracePicture:
    mbs: dict = field(default_factory=dict)   # mb_num -> TraceMb (last write)
    pre_deblock: bytes = b""
    post_deblock: bytes = b""
    poc: int = 0
    frame_num: int = 0
    is_idr: int = 0
    nal_ref_idc: int = 0


# the hooks the tracer adds to the reference library
HOOK_HEADER = r"""
#ifndef TRACE_HOOKS_H
#define TRACE_HOOKS_H
#include "basetype.h"
#include "h264bsd_macroblock_layer.h"
#include "h264bsd_image.h"
void traceMb(u32 mbNum, macroblockLayer_t *lay, mbStorage_t *mb);
void traceFrame(u32 tag, image_t *img);
void tracePicDone(i32 poc, u32 frameNum, u32 isIdr, u32 nalRefIdc);
#endif
"""

HOOK_IMPL = r"""
#include <stdio.h>
#include <stdlib.h>
#include "trace_hooks.h"

static FILE* traceFile(void) {
    static FILE *f = NULL;
    if (!f) {
        const char *path = getenv("TRACE_OUT");
        f = fopen(path ? path : "ref_trace.bin", "wb");
    }
    return f;
}

static void w32(u32 v) { fwrite(&v, 4, 1, traceFile()); }

void traceMb(u32 mbNum, macroblockLayer_t *lay, mbStorage_t *mb) {
    FILE *f = traceFile();
    w32(1); w32(mbNum); w32(mb->sliceId); w32((u32)mb->mbType); w32(mb->qpY);
    fwrite(mb->totalCoeff, sizeof(i16), 27, f);
    i16 pad = 0; fwrite(&pad, sizeof(i16), 1, f);
    fwrite(mb->intra4x4PredMode, 1, 16, f);
    fwrite(mb->refPic, 4, 4, f);
    fwrite(mb->mv, sizeof(mv_t), 16, f);
    w32(lay->codedBlockPattern);
    fwrite(&lay->mbQpDelta, 4, 1, f);
    fwrite(lay->subMbPred.subMbType, 4, 4, f);
    fwrite(lay->subMbPred.refIdxL0, 4, 4, f);
    fwrite(lay->residual.level, 4, 26*16, f);
}

void traceFrame(u32 tag, image_t *img) {
    FILE *f = traceFile();
    u32 n = img->width * img->height * 384;
    w32(tag); w32(n);
    fwrite(img->data, 1, n, f);
}

void tracePicDone(i32 poc, u32 frameNum, u32 isIdr, u32 nalRefIdc) {
    FILE *f = traceFile();
    w32(4); fwrite(&poc, 4, 1, f); w32(frameNum); w32(isIdr); w32(nalRefIdc);
    fflush(f);
}
"""

# (file of the reference's src/, text that occurs once, its replacement):
# the per-MB hook after each macroblock's reconstruction, the frame hooks
# around deblocking and the picture hook before PIC_RDY
PATCHES = (
    ("h264bsd_slice_data.c", '#include "h264bsd_util.h"',
     '#include "h264bsd_util.h"\n#include "trace_hooks.h"'),
    ("h264bsd_slice_data.c",
     """        /* increment macroblock count only for macroblocks that were decoded
         * for the first time (redundant slices) */
        if (pStorage->mb[currMbAddr].decoded == 1)""",
     """        traceMb(currMbAddr, mbLayer, pStorage->mb + currMbAddr);

        /* increment macroblock count only for macroblocks that were decoded
         * for the first time (redundant slices) */
        if (pStorage->mb[currMbAddr].decoded == 1)"""),
    ("h264bsd_decoder.c", '#include "h264bsd_byte_stream.h"',
     '#include "h264bsd_byte_stream.h"\n#include "trace_hooks.h"'),
    ("h264bsd_decoder.c",
     "    if (picReady)\n    {\n"
     "        h264bsdFilterPicture(pStorage->currImage, pStorage->mb);",
     "    if (picReady)\n    {\n        traceFrame(2, pStorage->currImage);\n"
     "        h264bsdFilterPicture(pStorage->currImage, pStorage->mb);\n"
     "        traceFrame(3, pStorage->currImage);"),
    ("h264bsd_decoder.c",
     "        pStorage->picStarted = HANTRO_FALSE;\n"
     "        pStorage->validSliceInAccessUnit = HANTRO_FALSE;\n\n"
     "        return(H264BSD_PIC_RDY);",
     "        tracePicDone(picOrderCnt, pStorage->sliceHeader->frameNum,\n"
     "            IS_IDR_NAL_UNIT(pStorage->prevNalUnit) ? 1 : 0,\n"
     "            pStorage->prevNalUnit->nalRefIdc);\n"
     "        pStorage->picStarted = HANTRO_FALSE;\n"
     "        pStorage->validSliceInAccessUnit = HANTRO_FALSE;\n\n"
     "        return(H264BSD_PIC_RDY);"),
)


def _instrumented_source(out: Path) -> None:
    """The reference's src/ copied to `out`, with the hooks added."""
    shutil.copytree(golden.REFERENCE / "src", out)
    (out / "trace_hooks.h").write_text(HOOK_HEADER)
    (out / "trace_hooks.c").write_text(HOOK_IMPL)
    for name, old, new in PATCHES:
        path = out / name
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"pattern not unique/found in {path}: {old!r}")
        path.write_text(text.replace(old, new))


def build_tracer() -> Path:
    """Build (once) the instrumented reference under TRACE_DIR and return
    the path of its test app; beside it, trace_h264bsd_resilient runs
    the same library under golden.RESILIENT_MAIN's keep-going loop, so
    traces cover the concealment of corrupt streams."""
    golden._require_reference()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    src = golden._build_once(TRACE_DIR / "src", _instrumented_source)
    lib_srcs = sorted(str(p) for p in src.glob("*.c"))

    def gcc(main_c: Path):
        def _make(out: Path):
            subprocess.run(["gcc", "-O2", "-std=gnu99", f"-I{src}",
                            *lib_srcs, str(main_c), "-o", str(out)],
                           check=True)
        return _make

    def resilient(out: Path):
        main_c = TRACE_DIR / f"resilient_main_{os.getpid()}.c"
        main_c.write_text(golden.RESILIENT_MAIN)
        try:
            gcc(main_c)(out)
        finally:
            main_c.unlink()

    golden._build_once(TRACE_DIR / "trace_h264bsd_resilient", resilient)
    return golden._build_once(
        TRACE_DIR / "trace_h264bsd",
        gcc(golden.REFERENCE / "posix" / "test_h264bsd.c"))


def trace_stream(name: str) -> Path:
    """Run the instrumented reference over a bundled stream (cached)."""
    def _run(out: Path):
        binary = build_tracer()
        env = dict(os.environ, TRACE_OUT=str(out))
        subprocess.run([str(binary), str(golden.stream_path(name))],
                       check=True, env=env, capture_output=True)

    golden._require_reference()
    return golden._build_once(golden.WORK / f"trace_{name}.bin", _run)


def read_trace(path: Path, max_pics: int | None = None,
               with_frames: bool = False) -> list[TracePicture]:
    pics = []
    cur = TracePicture()
    with open(path, "rb") as f:
        while True:
            raw = f.read(4)
            if len(raw) < 4:
                break
            (tag,) = struct.unpack("<I", raw)
            if tag == 1:
                mb_num, slice_id, mb_type, qp_y = struct.unpack("<4I", f.read(16))
                total_coeff = np.frombuffer(f.read(56), np.int16)[:27].copy()
                modes = np.frombuffer(f.read(16), np.uint8).copy()
                ref_pic = np.frombuffer(f.read(16), np.uint32).copy()
                mv = np.frombuffer(f.read(64), np.int16).reshape(16, 2).copy()
                cbp, qp_delta = struct.unpack("<Ii", f.read(8))
                sub_types = np.frombuffer(f.read(16), np.uint32).copy()
                ref_idx = np.frombuffer(f.read(16), np.uint32).copy()
                levels = np.frombuffer(f.read(4 * 26 * 16), np.int32)
                cur.mbs[mb_num] = TraceMb(mb_num, slice_id, mb_type, qp_y,
                                          total_coeff, modes, ref_pic, mv,
                                          cbp, qp_delta, sub_types, ref_idx,
                                          levels.reshape(26, 16).copy())
            elif tag in (2, 3):
                (n,) = struct.unpack("<I", f.read(4))
                data = f.read(n) if with_frames else (f.seek(n, 1), b"")[1]
                if tag == 2:
                    cur.pre_deblock = data
                else:
                    cur.post_deblock = data
            elif tag == 4:
                cur.poc, cur.frame_num, cur.is_idr, cur.nal_ref_idc = (
                    struct.unpack("<iIII", f.read(16)))
                pics.append(cur)
                cur = TracePicture()
                if max_pics is not None and len(pics) >= max_pics:
                    break
            else:
                raise ValueError(f"bad trace tag {tag}")
    return pics
