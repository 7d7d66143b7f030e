"""CUDA graphs of the frame body: the port's counterpart of the JAX
package's compiled per-shape programs (_decode_step and
_decode_window_step, h264bsd_tpu/models/decoder.py:186, :203).

A FrameGraph is the frame body captured for one graph key (geometry, ring
slots, blob caps and words, intra wavefront class, inter or not). Its only
input is one static int32 row on the device: the frame's scalars [slot,
conceal_from_ref, conceal_ref_slot] followed by its blob words. Every
other tensor of the body is made inside the capture from that row and the
DPB ring, which the body reads and writes in place; the ring's tensors
must outlive the graph (Decoder drops its graphs with its ring).

Capture: the body first runs eagerly on a side stream, which decodes the
key's first frame and does what must not happen inside a capture (kernel
builds, library loading, the cached constant tables of ops/consts.py).
Then it is captured once into the decoder's memory pool. Every later frame
of the key copies its row into the static input and replays. A capture
that fails raises; nothing runs the frame eagerly instead. Captures on one
device take turns (a lock per device), so decoders on several threads
(parallel/gop.py) never capture at once on one device; their replays and
eager frames go on meanwhile.

Launch counts: _kernels.LAUNCHES counts wrapper calls, which a replay
does not make. A capture's launches go to its thread's record
(_kernels.recording), not to LAUNCHES, and every replay adds them.
STATS changes under a lock, as threads share it.
"""

from __future__ import annotations

import threading
import time

import torch

from ..ops import _kernels
from ..utils.profiling import span

# frames decoded by a capture's eager first run, by replays, and by the
# eager body outside any graph (frames that cannot be graphed, and every
# frame on the CPU), and the host milliseconds the captures took (eager
# first run included); reset_stats() zeroes them
STATS = {"graph_captures": 0, "graph_replays": 0, "eager_frames": 0,
         "capture_ms": 0.0}
_stats_lock = threading.Lock()
# one capture at a time per device
_capture_locks: dict = {}


def reset_stats() -> None:
    with _stats_lock:
        for k in STATS:
            STATS[k] = 0


def count(key: str, n=1) -> None:
    """Add n to STATS[key]."""
    with _stats_lock:
        STATS[key] += n


def _capture_lock(device: torch.device) -> threading.Lock:
    with _stats_lock:
        return _capture_locks.setdefault(device, threading.Lock())


class FrameGraph:
    """body(row) captured over a static copy of `row`; constructing it
    decodes the frame of `row` (the eager first run). Both the first run
    and the capture go on `side`, a stream other than the current one
    that all of a decoder's captures share, so the memory one capture
    frees in `pool` serves the next."""

    def __init__(self, body, row, pool, side):
        with span("h264.capture"), _capture_lock(row.device):
            t0 = time.perf_counter()
            self.row = row.clone()
            cur = torch.cuda.current_stream(row.device)
            side.wait_stream(cur)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                body(self.row)
                # capture_begin/end, not the torch.cuda.graph context: that
                # one synchronizes and empties the device and pinned-host
                # caches on every capture. thread_local: host calls of
                # other threads (the parse-ahead thread, other decoders)
                # cannot invalidate the capture
                with _kernels.recording() as self.launches:
                    self.graph.capture_begin(
                        pool=pool, capture_error_mode="thread_local")
                    try:
                        body(self.row)
                    finally:
                        self.graph.capture_end()
            cur.wait_stream(side)
            with _stats_lock:
                STATS["graph_captures"] += 1
                STATS["capture_ms"] += 1e3 * (time.perf_counter() - t0)

    def replay(self, row) -> None:
        """Decode the frame of `row` (same key) by replaying the graph."""
        with span("h264.replay"):
            self.row.copy_(row)
            self.graph.replay()
        _kernels.add_launches(self.launches)
        count("graph_replays")
