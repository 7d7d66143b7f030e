"""Build the host front-end shared library (g++ -O3 -shared).

Rebuilds when the content of any csrc/ file changes (hash sidecar, not
mtimes: a fresh checkout gives sources and a stale .so the same
timestamp). The translation units compile in parallel, one g++ each, and
link into libh264tpu_torch_frontend.so next to the sources; -march=native
makes the .so machine-local, so it is never committed.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import tempfile
from contextlib import contextmanager
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
LIB = Path(__file__).parent / "libh264tpu_torch_frontend.so"
STAMP = Path(__file__).parent / "libh264tpu_torch_frontend.stamp"
LOCK = Path(__file__).parent / ".build.lock"

CXXFLAGS = [
    "-std=c++17", "-O3", "-march=native", "-fPIC", "-Wall", "-Wextra",
    "-Wno-unused-parameter",
]


@contextmanager
def exclusive_lock(path: Path):
    """Serialize concurrent builds (pytest-xdist workers import the
    package at once; two compilers writing one .so corrupt it)."""
    import fcntl

    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _fingerprint(sources: list[Path]) -> str:
    h = hashlib.sha256()
    h.update(" ".join(CXXFLAGS).encode())
    h.update(platform.machine().encode() + platform.node().encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _fresh(fp: str) -> bool:
    return (LIB.exists() and STAMP.exists()
            and STAMP.read_text().strip() == fp)


def build(force: bool = False) -> Path:
    sources = sorted(CSRC.glob("*.cpp")) + sorted(CSRC.glob("*.h"))
    fp = _fingerprint(sources)
    if not force and _fresh(fp):
        return LIB
    with exclusive_lock(LOCK):
        # re-check under the lock: another process may have just built
        if not force and _fresh(fp):
            return LIB
        with tempfile.TemporaryDirectory(dir=LIB.parent) as tmpdir:
            objs, procs = [], []
            for src in (s for s in sources if s.suffix == ".cpp"):
                obj = Path(tmpdir) / (src.stem + ".o")
                objs.append(str(obj))
                procs.append(subprocess.Popen(
                    ["g++", *CXXFLAGS, "-c", str(src), "-o", str(obj)]))
            failed = [p.args for p in procs if p.wait() != 0]
            if failed:
                raise RuntimeError(f"front-end compile failed: {failed}")
            tmp = LIB.with_suffix(f".so.tmp{os.getpid()}")
            subprocess.run(["g++", "-shared", *objs, "-o", str(tmp)],
                           check=True)
            os.replace(tmp, LIB)   # atomic: loaders never see a partial .so
        STAMP.write_text(fp)
    return LIB


if __name__ == "__main__":
    build(force=True)
    print(f"built {LIB}")
