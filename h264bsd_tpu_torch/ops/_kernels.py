"""Build and load the hand-written CUDA kernels (h264bsd_tpu_torch/csrc).

Each csrc/*.cu source compiles on first use, with nvcc for sm_90a, into
its own shared library with a plain C interface under _build/, loaded
with ctypes. All nvcc processes start together. A content-hash stamp
(sources, flags, compiler) decides when to rebuild, and a file lock
serializes concurrent builds (pytest-xdist workers, several processes
of one run), as frontend/build.py does for the host front-end.

Nothing here runs at import time: a wrapper calls launch() only when it
holds CUDA tensors, so environments without nvcc import every module.
Each C entry point launches on the stream it is given, allocates
nothing, and returns cudaGetLastError(); launch() raises on a non-zero
code. LAUNCHES counts, per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from ..frontend.build import exclusive_lock

CSRC = Path(__file__).parents[1] / "csrc"
BUILD = Path(__file__).parents[1] / "_build"
STAMP = BUILD / "kernels.stamp"
LOCK = BUILD / ".build.lock"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I = ct.c_void_p, ct.c_int
# C entry point -> (kernel name, source stem, argtypes); the trailing
# c_void_p of every entry point is the CUDA stream
ENTRY = {
    "h264_deblock_wavefront": ("deblock_wf", "deblock_wf",
                               [_P] * 11 + [_I, _I, _P]),
    "h264_deblock_raster": ("deblock_raster", "deblock_wf",
                            [_P] * 11 + [_I, _I, _P]),
    "h264_intra_list": ("intra_list", "intra_list",
                        [_P] * 13 + [_I, _I, _I, _P]),
    "h264_intra_wavefront": ("intra_wf", "intra_wf",
                             [_P] * 12 + [_I, _I, _P]),
}

# wrapper calls that launched each kernel (reset_launches() zeroes them)
LAUNCHES = {name: 0 for name, _, _ in ENTRY.values()}

_libs: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "CUDA kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _fingerprint(nvcc: str) -> str:
    h = hashlib.sha256(" ".join([nvcc] + NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def lib_path(stem: str) -> Path:
    return BUILD / f"lib{stem}.so"


def build(force: bool = False) -> list[Path]:
    """Compile every csrc/*.cu (in parallel) unless the stamp is fresh;
    returns the library paths. ptxas' register and shared-memory report
    of each source lands in _build/<stem>.log."""
    nvcc = _nvcc()
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    libs = [lib_path(s) for s in stems]
    fp = _fingerprint(nvcc)

    def fresh():
        return (not force and STAMP.exists()
                and STAMP.read_text().strip() == fp
                and all(p.exists() for p in libs))

    if fresh():
        return libs
    BUILD.mkdir(exist_ok=True)
    with exclusive_lock(LOCK):
        if fresh():
            return libs
        procs = []
        for stem, out in zip(stems, libs):
            tmp = out.with_suffix(f".so.tmp{os.getpid()}")
            log = open(BUILD / f"{stem}.log", "w")
            procs.append((out, tmp, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
                stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for out, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc:
                failed.append(f"{out.name}: {Path(log.name).read_text()}")
            else:
                os.replace(tmp, out)   # loaders never see a partial .so
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        STAMP.write_text(fp)
    return libs


def _function(entry: str):
    if entry not in _libs:
        _, stem, argtypes = ENTRY[entry]
        build()
        fn = getattr(ct.CDLL(str(lib_path(stem))), entry)
        fn.argtypes = argtypes
        fn.restype = ct.c_int
        _libs[entry] = fn
    return _libs[entry]


def ptr(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> int:
    """Device pointer of a CUDA tensor the kernel reads or writes, after
    checking what the kernel assumes of it."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` on `device`'s current stream and count
    the launch; raises when the entry point reports a CUDA error."""
    fn = _function(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} at launch")
    LAUNCHES[ENTRY[entry][0]] += 1
