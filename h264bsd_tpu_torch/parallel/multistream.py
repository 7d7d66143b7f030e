"""Batched multi-stream decoding on one card (BASELINE config 5: many
independent same-resolution streams decoded concurrently).

Counterpart of the JAX package's parallel/multistream.py
(MultiStreamDecoder :75, _batched_blob_step :56). Each stream keeps its
own host front-end. Every round, each stream advances to its next
picture and the round's N frames run on the device together, each on
its own slice of one DPB ring of shape (N, slots + 1, H, W). The extra
slot is a scratch slot: a stream without a picture this round, or one
that runs eagerly (below), writes its frame there.

Host half (_parse_round). The streams parse on a pool of worker threads
(the C++ front-end is called through ctypes, which releases the GIL);
the JAX version parses them in turn. The round's section caps and blob
length are shared, tiered from the maxima of the streams' counts as the
JAX version does, so each stream's blob bytes are the JAX version's.

Device half (_submit). On the card the round's N frame bodies
(models.decoder._frame_decode_body) are one CUDA graph per round key
(geometry, ring slots, caps, blob words, intra class). Each body runs on
its own CUDA stream, forked from the capturing stream and joined back
before the capture ends, so the N chains of the dependency-driven
kernels (K1, K2, K7, which take their MBs or rows from tickets) and the
other stages run side by side. A stream whose picture needs the spiral
concealment (a partial loss without a usable reference) or carries I_PCM
samples runs in the graph as a no-op into the scratch slot, then runs the
frame body eagerly on its ring slice (spiral= or pcm=), as the JAX
version's _submit_exact does for the first. Slots of non-existing frames
are zeroed before the round. On the CPU the bodies run eagerly, one
after the other.

With a mesh (parallel/mesh.py) the streams are sharded over its
stream_axis, as in the JAX version (multistream.py:79-98, :204-221):
position p decodes its contiguous block of N / n streams on its own
device, with its own ring slice and its own round graph. The round's
parse, caps and blob bytes stay shared, so a stream's blobs and pictures
are those of the decoder without a mesh.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..frontend import binding as fe
from ..models.decoder import (ROW_SCALARS, WF_THRESH, _frame_decode_body,
                              caps_from_counts, ladder, tier)
from ..models.graphs import FrameGraph, count
from ..models.state import new_ring
from ..ops.reconstruct import build_pcm_tensors
from ..ops.unpack import compact_blob_words


def _on(device):
    """The device's context on the card (a shard's graphs and streams
    belong to its device); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _round_body(rows, dpb, branches, **args):
    """The round's frame bodies: stream i's from input row rows[i] on its
    ring slice, each on CUDA stream branches[i] (forked from the current
    stream and joined back), or one after the other when branches is
    None."""
    if branches is None:
        for i, row in enumerate(rows):
            _frame_decode_body(row, tuple(p[i] for p in dpb), None, **args)
        return
    cur = torch.cuda.current_stream(rows.device)
    for i, branch in enumerate(branches):
        branch.wait_stream(cur)
        with torch.cuda.stream(branch):
            _frame_decode_body(rows[i], tuple(p[i] for p in dpb), None,
                               **args)
    for branch in branches:
        cur.wait_stream(branch)


class _Shard:
    """Streams lo..hi-1 on one device: their slice of the ring (y, cb,
    cr), (hi - lo, slots, H, W), the round graphs over it (round key ->
    FrameGraph), the graphs' memory pool and capture stream, and the
    bodies' CUDA streams."""

    def __init__(self, device, lo, hi):
        self.device, self.lo, self.hi = device, lo, hi
        self.dpb = None
        self.graphs = {}
        self.pool = self.side = self.branches = None


class MultiStreamDecoder:
    """Decode N same-resolution streams concurrently on `device` (the
    current CUDA device when None; "cpu" runs the kernels' plain
    versions), one batched device step per round; with `mesh`, sharded
    over its `stream_axis` (N must be divisible by the axis size), each
    position's block of streams on its device. Streams out of data stop
    contributing. outputs[i] lists stream i's released pictures in
    display order ({"slot", "pic_id", "is_idr", "num_err_mbs"});
    picture(i, j) reads picture j of stream i from the ring, whose slots
    later rounds overwrite, as in the JAX version."""

    def __init__(self, streams: list[bytes], device=None, mesh=None,
                 stream_axis: str = "stream"):
        self.n = len(streams)
        if mesh is None:
            self._shards = [_Shard(resolve_device(device), 0, self.n)]
        else:
            devices = mesh.axis_devices(stream_axis)
            if self.n % len(devices):
                raise ValueError(
                    f"{self.n} streams not divisible by mesh axis "
                    f"{stream_axis!r} size {len(devices)}")
            per = self.n // len(devices)
            self._shards = [_Shard(d, k * per, (k + 1) * per)
                            for k, d in enumerate(devices)]
        self.device = self._shards[0].device
        self.data = streams
        self.pos = [0] * self.n
        self.fes = [fe.FrontendDecoder() for _ in range(self.n)]
        self.geom = None           # (width_mbs, height_mbs, ring slots)
        self.outputs = [[] for _ in range(self.n)]
        self._workers = ThreadPoolExecutor(
            min(self.n, os.cpu_count() or 1),
            thread_name_prefix="h264-parse")

    @property
    def dpb(self):
        """The (y, cb, cr) ring, (N, slots, H, W); with a mesh, a list of
        the positions' rings."""
        rings = [sh.dpb for sh in self._shards]
        return rings[0] if len(rings) == 1 else rings

    def _shard_of(self, i):
        """(shard, index in its ring) of stream i."""
        sh = next(sh for sh in self._shards if sh.lo <= i < sh.hi)
        return sh, i - sh.lo

    def close(self):
        """Stop the parse workers and free the front-ends."""
        self._workers.shutdown()
        for dec in self.fes:
            dec.close()

    # -- host half (worker and producer threads: no device work) ----------

    def _advance(self, i):
        """Parse stream i up to its next picture: (counts, stream info,
        picture info, non-existing slots), or None once it is drained.
        The pictures it releases go to outputs[i]."""
        data, pos, dec = self.data[i], self.pos[i], self.fes[i]
        got = None
        while pos < len(data):
            status, read = dec.decode(data, len(self.outputs[i]), pos)
            pos += read
            if status == fe.PIC_RDY:
                info = dec.stream_info()
                counts = tuple(int(x) for x in dec.blob_counts())
                got = (counts, info, dec.pic_info(), dec.take_non_existing())
                while (o := dec.next_output()) is not None:
                    self.outputs[i].append(o)
                break
            if status >= fe.ERROR and read == 0:
                pos = len(data)
        self.pos[i] = pos
        return got

    def _geometry(self, infos):
        """(width_mbs, height_mbs, ring slots): fixed at the first round
        with a picture, with room for the most slots a stream of it asks
        for plus the scratch slot. Raises for a stream that does not
        fit."""
        if self.geom is None:
            self.geom = (infos[0]["width_mbs"], infos[0]["height_mbs"],
                         max(g["dpb_slots"] for g in infos) + 1)
        w_mbs, h_mbs, slots = self.geom
        for g in infos:
            if (g["width_mbs"], g["height_mbs"]) != (w_mbs, h_mbs) or \
                    g["dpb_slots"] >= slots:
                raise ValueError(
                    f"MultiStreamDecoder decodes streams of one geometry: "
                    f"a {g['width_mbs']}x{g['height_mbs']}-MB stream with "
                    f"{g['dpb_slots']} DPB slots does not fit a "
                    f"{w_mbs}x{h_mbs}-MB ring of {slots - 1}")
        return self.geom

    def _parse_round(self):
        """Advance every live stream to its next picture and build the
        round's input rows. Returns None when every stream is drained."""
        got = list(self._workers.map(self._advance, range(self.n)))
        ready = {i: r for i, r in enumerate(got) if r is not None}
        if not ready:
            return None
        w_mbs, h_mbs, slots = self._geometry([r[1] for r in ready.values()])
        n_mbs = w_mbs * h_mbs
        scratch = slots - 1
        # shared tier caps and blob length for the round
        mx = [max(r[0][k] for r in ready.values()) for k in range(7)]
        wavefront = mx[5] > WF_THRESH
        caps = caps_from_counts(mx, n_mbs, wavefront)
        _, need_w = compact_blob_words(mx, n_mbs, caps)
        total_w = tier(need_w, ladder(8192, 12) + (need_w,))

        # one input row per stream (models.decoder._frame_decode_body):
        # [slot, conceal_from_ref, conceal_ref_slot] and the blob, all zero
        # (an empty frame) for a stream without a picture, which goes to
        # the scratch slot
        rows = np.zeros((self.n, ROW_SCALARS + total_w), np.int32)
        rows[:, 0] = scratch
        rows[:, 2] = -1

        def blob(i):
            rows[i, ROW_SCALARS:] = self.fes[i].blob_compact(
                *caps, total_w * 4).view(np.int32)
            return self.fes[i].ipcm()

        ipcm = dict(zip(ready, self._workers.map(blob, ready)))
        eager, eager_rows, non_existing = [], [], []
        for i, (_, _, info, nonex) in ready.items():
            n_conc = info["num_concealed_mbs"]
            scalars = (info["slot"],
                       bool(info["conceal_from_ref"]) and n_conc > 0,
                       info["conceal_ref_slot"])
            spiral = None
            if 0 < n_conc < n_mbs and (not info["conceal_from_ref"] or
                                       info["conceal_ref_slot"] < 0):
                # decoded MBs from the packed records behind the 64-byte
                # header (8 bytes per MB, mb_class in byte 1's low bits)
                mb_class = rows[i, ROW_SCALARS:].view(np.uint8)[
                    64:64 + n_mbs * 8].reshape(n_mbs, 8)[:, 1] & 7
                spiral = (mb_class != 6, bool(info["conceal_from_ref"]))
            mb, data = ipcm[i]
            pcm = (mb, data) if len(mb) else None
            if spiral is None and pcm is None:
                rows[i, :ROW_SCALARS] = scalars
            else:
                # a no-op in the batch (scratch slot); the frame itself
                # runs eagerly on the stream's ring slice
                eager.append((i, pcm, spiral))
                row = rows[i].copy()
                row[:ROW_SCALARS] = scalars
                eager_rows.append(row)
            non_existing += [(i, s) for s in nonex]
        # the eager streams' rows, with their own scalars, after the batch
        return dict(rows=np.concatenate([rows] + [r[None] for r in
                                                  eager_rows]),
                    caps=caps, wavefront=wavefront, geom=self.geom,
                    n_ready=len(ready), n_batched=len(ready) - len(eager),
                    eager=eager, non_existing=non_existing)

    # -- device half --------------------------------------------------------

    def _ensure_dpb(self, geom):
        w_mbs, h_mbs, slots = geom
        for sh in self._shards:
            if sh.dpb is None:
                n = sh.hi - sh.lo
                sh.dpb = tuple(p.view(n, slots, *p.shape[1:]) for p in
                               new_ring(n * slots, h_mbs, w_mbs, sh.device))

    def _run_round(self, sh, rows, args):
        """Shard sh's batched bodies from their input rows (n, words): the
        round key's graph, replayed or captured (the capture's first run
        decodes the round); on the CPU the bodies one by one."""
        if sh.device.type == "cpu":
            _round_body(rows, sh.dpb, None, **args)
            count("eager_frames", sh.hi - sh.lo)
            return
        key = (args["width_mbs"], args["height_mbs"], sh.dpb[0].shape[1],
               args["caps"], rows.shape[1], args["intra_wavefront"])
        graph = sh.graphs.get(key)
        if graph is not None:
            graph.replay(rows)
            return
        if sh.pool is None:
            sh.pool = torch.cuda.graph_pool_handle()
            sh.side = torch.cuda.Stream(sh.device)
            sh.branches = [torch.cuda.Stream(sh.device)
                           for _ in range(sh.hi - sh.lo)]
        sh.graphs[key] = FrameGraph(
            partial(_round_body, dpb=sh.dpb, branches=sh.branches, **args),
            rows, sh.pool, sh.side)

    def _submit(self, rnd):
        self._ensure_dpb(rnd["geom"])
        w_mbs, h_mbs, _ = rnd["geom"]
        for i, slot in rnd["non_existing"]:
            sh, j = self._shard_of(i)
            for plane in sh.dpb:
                plane[j, slot].zero_()
        args = dict(width_mbs=w_mbs, height_mbs=h_mbs, caps=rnd["caps"],
                    intra_wavefront=rnd["wavefront"])
        for sh in self._shards:
            # the shard's rows and those of its eager streams, after the
            # batch, in one host-to-device copy
            eager = [(k, e) for k, e in enumerate(rnd["eager"])
                     if sh.lo <= e[0] < sh.hi]
            host = np.concatenate([rnd["rows"][sh.lo:sh.hi]] + [
                rnd["rows"][self.n + k][None] for k, _ in eager])
            rows = torch.from_numpy(host)
            if sh.device.type == "cuda":
                rows = rows.pin_memory()
            rows = rows.to(sh.device, non_blocking=True)
            with _on(sh.device):
                if rnd["n_batched"]:
                    self._run_round(sh, rows[:sh.hi - sh.lo], args)
                for row, (_, (i, pcm, spiral)) in zip(
                        rows[sh.hi - sh.lo:], eager):
                    if pcm is not None:
                        pcm = tuple(torch.from_numpy(p).to(sh.device)
                                    for p in build_pcm_tensors(
                                        w_mbs * h_mbs, *pcm))
                    _frame_decode_body(
                        row, tuple(p[i - sh.lo] for p in sh.dpb), pcm,
                        **args, spiral=spiral)
                    count("eager_frames")

    def step(self) -> int:
        """Advance every live stream to its next picture, then run one
        batched device step. Returns the number of pictures decoded."""
        rnd = self._parse_round()
        if rnd is None:
            return 0
        self._submit(rnd)
        return rnd["n_ready"]

    def run(self, pipelined: bool = True):
        """Decode all streams to completion; returns per-stream picture
        counts. With pipelined=True the host parse of round k+1 (on a
        producer thread) overlaps the device work of round k."""
        if not pipelined:
            while self.step():
                pass
            return [len(o) for o in self.outputs]

        q: queue.Queue = queue.Queue(maxsize=4)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            try:
                while not stop.is_set():
                    rnd = self._parse_round()
                    put(rnd)
                    if rnd is None:
                        return
            except BaseException as exc:  # re-raised by the consumer
                put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while (rnd := q.get()) is not None:
                if isinstance(rnd, BaseException):
                    raise rnd
                self._submit(rnd)
        finally:
            stop.set()
            t.join()
        return [len(o) for o in self.outputs]

    def picture(self, stream_idx, out_idx):
        """(y, cb, cr) of picture out_idx of stream stream_idx, copied out
        of its ring slot as it stands."""
        o = self.outputs[stream_idx][out_idx]
        sh, j = self._shard_of(stream_idx)
        return tuple(p[j, o["slot"]].clone() for p in sh.dpb)
