"""Top-level H.264 Baseline decoder on PyTorch and CUDA.

Public API mirrors the reference library surface (h264bsd_decoder.h:64-93)
and the JAX package's models/decoder.py: decode one NAL per call, drain
display-order output pictures, query stream geometry, decode SEI
messages, convert to RGBA/BGRA/YCbCrA. The bitstream front-end runs in
C++ (frontend/); the pixel stages run on the device, one frame at a time,
into a DPB ring written in place (unpack -> reconstruct -> conceal ->
deblock -> slot).

I and P pictures decode, with motion compensation from up to 16
reference slots, whole-picture and partial-loss concealment (a partial
loss without a usable reference takes the reference's spiral
concealment on the host, ops/conceal.py).

On the card a frame's body runs as a CUDA graph captured once per frame
shape (models/graphs.py), as the JAX package dispatches one compiled
program per shape: _decode_step replays it for one frame, and
_decode_window_step for a window of up to WINDOW compatible frames
shipped in one host-to-device copy. Frames that need host work of their
own (I_PCM samples, the spiral concealment, non-existing frame slots)
run the body eagerly (_submit). On the CPU every frame runs eagerly.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..frontend import binding as fe
from ..frontend.sei import parse_sei_rbsp
from ..ops.conceal import conceal_picture
from ..ops.cuda_deblock_wf import deblock_frame_wavefront
from ..ops.reconstruct import (WF_THRESH, build_pcm_tensors,
                               reconstruct_frame_fast)
from ..ops.unpack import compact_blob_words, unpack_blob, widen_words
from ..utils.profiling import span
from .graphs import STATS, FrameGraph, count, reset_stats
from .state import new_ring, tensor_from_numpy

# frames per windowed dispatch of decode_stream, and the DPB slot margin
# it asks of the front-end (the JAX package's default window)
WINDOW = 16

# a frame's input row: these scalars, then its blob words (int32)
ROW_SCALARS = 3      # slot, conceal_from_ref, conceal_ref_slot


def tier(length, tiers):
    """Smallest tier >= length."""
    return next(c for c in tiers if c >= length)


def ladder(base, steps):
    """~1.5x tier ladder of transfer-blob section caps (the JAX package's
    ladder: the port ships the same blob bytes)."""
    out = []
    for i in range(steps):
        out += [base << i, (base << i) + (base << i >> 1)]
    return tuple(out)


def caps_from_counts(mx, n_mbs, wavefront):
    """Tier-select the transfer-blob section caps from raw per-class
    counts (FrontendDecoder.blob_counts order)."""
    sgl = tier(mx[0], ladder(2048, 8) + (max(n_mbs * 26, 2048),))
    sht = tier(mx[1], ladder(1024, 8) + (max(n_mbs * 26, 1024),))
    cap = tier(mx[2], ladder(512, 8) + (max(n_mbs * 26, 512),))
    wcap = tier(mx[3], (64, 1024, 16384, max(cap * 16, 64)))
    # exceptions are quad-grained (up to 4 per MB)
    ecap = tier(mx[4], ladder(256, 8) + (max(n_mbs * 4, 256),))
    scap = tier(mx[6], (32, max(n_mbs, 32)))
    icap = tier(mx[5], (512, 1024, 1536, 2048, 3072, n_mbs)
                if not wavefront else (n_mbs,))
    # dense per-MB slice ids travel only for multi-slice pictures;
    # rounded up to even so every later blob section stays 4-byte aligned
    sidcap = 0 if mx[6] <= 1 else (n_mbs + 1) & ~1
    return (sgl, sht, cap, wcap, ecap, icap, scap, sidcap)


# status re-exports (reference h264bsd_decoder.h:46-55)
RDY = fe.RDY
PIC_RDY = fe.PIC_RDY
HDRS_RDY = fe.HDRS_RDY
ERROR = fe.ERROR
PARAM_SET_ERROR = fe.PARAM_SET_ERROR


def _frame_decode_body(row, dpb, pcm, width_mbs, height_mbs, caps,
                       intra_wavefront, spiral=None):
    """One full frame on the device: unpack, reconstruct (motion
    compensation from the ring `dpb`), conceal, deblock, store into the
    ring slot (in place).

    row: int32 (ROW_SCALARS + blob words,) on the device, the frame's
    slot, conceal_from_ref and conceal_ref_slot then its blob. Nothing is
    read back to the host, so the same work serves every frame of a shape
    (models/graphs.py captures it). spiral, a pair
    (numpy (nMB,) bool of the decoded MBs, conceal_from_ref), selects the
    exact spiral concealment on the host for a partial loss without a
    usable reference (eager frames only)."""
    n_mbs = width_mbs * height_mbs
    (packed, slice_table, sparse_ids, sparse_levels, mv_exc_ids,
     mv_exc_payload, intra_mbs, intra_payload, slice_ids) = unpack_blob(
        widen_words(row[ROW_SCALARS:]), n_mbs, *caps)
    y, cb, cr, t = reconstruct_frame_fast(
        packed, slice_table, sparse_ids, sparse_levels, mv_exc_ids,
        mv_exc_payload, intra_mbs, intra_payload, pcm, dpb, width_mbs,
        height_mbs, intra_wavefront, slice_ids)

    # concealment of lost MBs (mb_class 6); motion compensation above and
    # the concealment reference read other ring slots, never the slot
    # written at the end
    if spiral is not None:
        # the reference's sequential neighbour-DC synthesis (conceal.c:
        # 124-254), in numpy on the host between reconstruction and
        # deblocking, as the JAX package's _recon_only_step and
        # _deblock_store_step do
        decoded, from_ref = spiral
        host = [p.cpu().numpy().copy() for p in (y, cb, cr)]
        conceal_picture(*host, decoded, width_mbs, height_mbs, from_ref,
                        None)
        planes = [torch.from_numpy(h).to(y.device) for h in host]
    else:
        # a copy of the co-located MB of the first available reference
        # (ConcealMb conceal.c:318-338), or a grey fill (conceal.c:172-199)
        concealed = (t["mb_class"] == 6).reshape(height_mbs, width_mbs)
        ref = row[2:3].long()
        from_ref = (row[1] != 0) & (row[2] >= 0)
        planes = []
        for plane, ring, size in zip((y, cb, cr), dpb, (16, 8, 8)):
            mask = concealed.repeat_interleave(size, 0) \
                .repeat_interleave(size, 1)
            rep = torch.where(from_ref,
                              ring.index_select(0, ref.clamp(min=0))[0], 128)
            planes.append(torch.where(mask, rep, plane))

    deblock_frame_wavefront(
        *planes, t["mb_class"], t["nnz"], t["mv"], t["ref_slot"],
        t["slice_id"], t["disable_dblk"], t["qp_y"], t["filter_off_a"],
        t["filter_off_b"], t["chroma_qp_offset"], width_mbs, height_mbs)
    # the store into the ring slot. The ring is written in place, so
    # Decoder._make_output copies a picture's planes out of its slot
    # before a later frame may reuse it
    slot = row[:1].long()
    for ring, plane in zip(dpb, planes):
        ring.index_copy_(0, slot, plane[None])


def stage_rows(preps, device):
    """The frames' input rows (see _frame_decode_body), (K, ROW_SCALARS
    + blob words) int32, on `device` in one host-to-device copy (from
    pinned memory on the card, so the copy is asynchronous)."""
    rows = np.empty((len(preps), ROW_SCALARS + preps[0]["blob"].nbytes
                     // 4), np.int32)
    for row, p in zip(rows, preps):
        info = p["info"]
        row[:ROW_SCALARS] = (info["slot"], bool(info["conceal_from_ref"]),
                             info["conceal_ref_slot"])
        row[ROW_SCALARS:] = p["blob"].view(np.int32)
    host = torch.from_numpy(rows)
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def spiral_of(prep):
    """The spiral= argument of _frame_decode_body for a frame that needs
    the exact spiral concealment (a partial loss without a usable
    reference), else None."""
    info = prep["info"]
    n_mbs = prep["n_mbs"]
    n_conc = info["num_concealed_mbs"]
    if not (0 < n_conc < n_mbs and (not info["conceal_from_ref"]
                                    or info["conceal_ref_slot"] < 0)):
        return None
    # decoded MBs from the frame's own blob (the parser may already be
    # ahead on a producer thread): packed records, 8 B/MB, follow the
    # 64-byte header; mb_class is byte 1's low 3 bits
    mb_class = prep["blob"][64:64 + n_mbs * 8].reshape(n_mbs, 8)[:, 1] & 7
    return mb_class != 6, bool(info["conceal_from_ref"])


def _to_rgba(y, cb, cr, full_range=False):
    """BT.601 fixed-point YUV->RGBA (reference h264bsdConvertToRGBA
    decoder.c:1163-1216); full_range applies the full-swing matrix for
    streams whose VUI signals video_full_range_flag."""
    d = cb.int().repeat_interleave(2, 0).repeat_interleave(2, 1) - 128
    e = cr.int().repeat_interleave(2, 0).repeat_interleave(2, 1) - 128
    if full_range:
        c = y.int()
        r = ((256 * c + 359 * e + 128) >> 8).clamp(0, 255)
        g = ((256 * c - 88 * d - 183 * e + 128) >> 8).clamp(0, 255)
        b = ((256 * c + 454 * d + 128) >> 8).clamp(0, 255)
    else:
        c = y.int() - 16
        r = ((298 * c + 409 * e + 128) >> 8).clamp(0, 255)
        g = ((298 * c - 100 * d - 208 * e + 128) >> 8).clamp(0, 255)
        b = ((298 * c + 516 * d + 128) >> 8).clamp(0, 255)
    a = torch.full_like(r, 255)
    return torch.stack([r, g, b, a], dim=-1).to(torch.uint8)


@dataclass
class OutputPicture:
    pic_id: int
    is_idr: bool
    num_err_mbs: int
    width: int          # uncropped, pels
    height: int
    crop: tuple         # (left, width, top, height)
    # the picture's (y, cb, cr) planes on the device, copied out of the
    # DPB ring (which later frames overwrite in place)
    planes: tuple
    # VUI video_full_range_flag of the stream
    full_range: bool = False

    def yuv_planes(self):
        return self.planes

    def detach(self):
        """The JAX package's detach (copy the planes out of the DPB ring):
        this picture's planes are its own already, copied out of the ring
        by Decoder._make_output."""
        return self

    def yuv_bytes(self) -> bytes:
        """Planar uncropped YUV420, reference picture-buffer layout."""
        return b"".join(p.cpu().numpy().tobytes() for p in self.planes)

    def rgba(self, full_range=False) -> np.ndarray:
        return _to_rgba(*self.planes, full_range=full_range).cpu().numpy()

    def bgra(self, full_range=False) -> np.ndarray:
        return self.rgba(full_range)[..., [2, 1, 0, 3]]

    def ycbcra(self) -> np.ndarray:
        """Packed YCbCrA pixels (reference h264bsdNextOutputPictureYCbCrA
        decoder.c:732; chroma upsampled by replication)."""
        y, cb, cr = (p.cpu().numpy() for p in self.planes)
        cb = cb.repeat(2, 0).repeat(2, 1)
        cr = cr.repeat(2, 0).repeat(2, 1)
        return np.stack([y, cb, cr, np.full_like(y, 255)], axis=-1)


class Decoder:
    """Reference-equivalent decoder instance (h264bsdAlloc+Init ->
    h264bsdDecode loop -> h264bsdShutdown) on `device` (the current CUDA
    device when None; "cpu" runs the kernels' plain versions)."""

    def __init__(self, no_output_reordering: bool = False,
                 intra_concealment: bool = False, caps_pin: dict = None,
                 slot_margin: int = 0, device=None):
        """intra_concealment = the reference's intraConcealmentFlag: a
        fully lost I picture copies the reference picture instead of
        going grey. slot_margin adds spare ring slots (FIFO-rotated by
        the C++ allocator). caps_pin: see pin_caps_for_stream."""
        self.device = resolve_device(device)
        self._fe_args = (no_output_reordering, intra_concealment,
                         slot_margin)
        self._fe = fe.FrontendDecoder(*self._fe_args)
        self._caps_pin = caps_pin
        # sticky-caps history per wavefront class (see _prepare)
        self._cap_hist = {}
        self._dpb = None           # (y, cb, cr) ring tensors
        self._geom = None          # stream_info dict
        self._graphs = {}          # graph key -> FrameGraph over _dpb
        self._spare = None         # a dropped ring and its graphs
        self._pool = None          # the graphs' memory pool and
        self._side = None          # capture stream, shared

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        self._fe.close()

    def restart(self):
        """Start over as a fresh decoder of the same options (a new
        front-end, no caps history, no ring) for another stream, keeping
        the ring and its graphs aside: a picture of the ring's shape takes
        them back zeroed (_ensure_dpb), so a decoder that decodes stream
        after stream of one geometry captures each graph key once."""
        self._fe.close()
        self._fe = fe.FrontendDecoder(*self._fe_args)
        self._cap_hist = {}
        self._geom = None
        self._set_ring(None)

    # -- decoding ----------------------------------------------------------

    def decode(self, data, pic_id: int = 0, offset: int = 0,
               length: int | None = None):
        """Decode one NAL unit; returns (status, bytes_consumed)."""
        status, read = self._parse(data, pic_id, offset, length)
        if status == fe.HDRS_RDY:
            self._geom = self._fe.stream_info()
            self._set_ring(None)  # realloc lazily at the next picture
        elif status == fe.PIC_RDY:
            prep = self._prepare()
            if self._windowable(prep):
                self._decode_step(prep)
            else:
                self._submit(prep)
        return status, read

    def _parse(self, data, pic_id, offset, length=None):
        """The C++ front-end's decode of one NAL unit: (status,
        bytes_consumed)."""
        with span("h264.parse"):
            return self._fe.decode(data, pic_id, offset, length)

    def _set_ring(self, ring):
        """Replace the DPB ring; the graphs captured over the old one go
        with it. Dropped (ring None), the old ring and its graphs are kept
        aside for _ensure_dpb."""
        if ring is None and self._dpb is not None:
            self._spare = (self._dpb, self._graphs)
        self._dpb = ring
        self._graphs = {}

    def _ensure_dpb(self, g):
        """A ring of the geometry `g`: the current one, or the ring kept
        aside when it has that shape (zeroed, as a new ring is, with its
        graphs), or a new one."""
        shape = (g["dpb_slots"], g["height_mbs"] * 16, g["width_mbs"] * 16)
        if self._dpb is not None and tuple(self._dpb[0].shape) == shape:
            return
        spare, self._spare = self._spare, None
        if spare is not None and tuple(spare[0][0].shape) == shape:
            for plane in spare[0]:
                plane.zero_()
            self._set_ring(spare[0])
            self._graphs = spare[1]
        else:
            self._set_ring(new_ring(g["dpb_slots"], g["height_mbs"],
                                    g["width_mbs"], self.device))

    def load_ring(self, y, cb, cr):
        """Seed the DPB ring from numpy (slots, H, W) / (slots, H/2, W/2)
        uint8 arrays, e.g. the JAX package's ring. Call after the stream
        headers (HDRS_RDY), which reset the ring."""
        self._set_ring(tuple(tensor_from_numpy(p, self.device)
                             for p in (y, cb, cr)))

    def _prepare(self, pic=None):
        """Host-only half of a frame: gather everything the device step
        needs (no device work, so it may run on a parse-ahead thread),
        from the front-end's current picture, or from `pic`, a picture
        taken from its pool (frontend.binding.PooledPicture)."""
        src = self._fe if pic is None else pic
        with span("h264.prepare"):
            # read afresh: the ring size (dpb_slots) is known only once the
            # first slice has activated the DPB, after HDRS_RDY
            g = src.stream_info()
            self._geom = g
            info = src.pic_info()
            w_mbs, h_mbs = g["width_mbs"], g["height_mbs"]
            n_mbs = w_mbs * h_mbs
            non_existing = src.take_non_existing()
            counts = tuple(int(x) for x in src.blob_counts())
            n_slices = counts[6]
            # sparse intra -> list kernel; intra-heavy -> wavefront kernel
            wavefront = counts[5] > WF_THRESH

            def fits(p):
                return (all(counts[k] <= p[k] for k in range(7))
                        and (n_slices <= 1 or p[7] > 0))

            pin = None
            if self._caps_pin is not None and wavefront in self._caps_pin:
                # first pinned (caps, total_words) tier the frame fits
                for caps_p, tot_p in self._caps_pin[wavefront]:
                    if fits(caps_p) and compact_blob_words(
                            counts, n_mbs, caps_p)[1] <= tot_p:
                        pin = (caps_p, tot_p)
                        break
            if pin is not None:
                caps, total_w = pin
            else:
                # sticky caps: tier over the max counts of the last 8 frames of
                # this wavefront class, as the JAX package does, so both ship
                # the same blob bytes
                hist = self._cap_hist.setdefault(wavefront, [])
                hist.append(counts)
                del hist[:-8]
                mx = [max(h[k] for h in hist) for k in range(7)]
                caps = caps_from_counts(mx, n_mbs, wavefront)
                _, need_w = compact_blob_words(mx, n_mbs, caps)
                total_w = tier(need_w, ladder(8192, 12) + (need_w,))
            blob = src.blob_compact(*caps, total_w * 4)
            return dict(info=info, geom=g, w_mbs=w_mbs, h_mbs=h_mbs,
                        n_mbs=n_mbs, blob=blob, caps=caps, wavefront=wavefront,
                        has_inter=info["used_slot_count"] > 0,
                        ipcm=src.ipcm(),
                        non_existing=non_existing)

    def _stage(self, preps):
        """The frames' input rows on the decoder's device (stage_rows)."""
        with span("h264.stage"):
            return stage_rows(preps, self.device)

    @staticmethod
    def _body_args(prep):
        """The frame body's static arguments: with the ring's slot count,
        the blob's length and has_inter (whether the picture references a
        slot) they make the graph key."""
        return dict(width_mbs=prep["w_mbs"], height_mbs=prep["h_mbs"],
                    caps=prep["caps"], intra_wavefront=prep["wavefront"])

    def _windowable(self, prep) -> bool:
        """True when the frame can run the graphed body: nothing
        frame-individual (no I_PCM samples, no exact spiral concealment,
        no non-existing-frame slot zeroing), as the JAX package's
        _windowable decides."""
        info = prep["info"]
        n_conc = info["num_concealed_mbs"]
        partial_loss = 0 < n_conc < prep["n_mbs"]
        needs_exact = partial_loss and (
            not info["conceal_from_ref"] or info["conceal_ref_slot"] < 0)
        return (not needs_exact and not prep["non_existing"]
                and not len(prep["ipcm"][0]))

    def _submit(self, prep):
        """Device half of a frame, eagerly: transfer the blob and run the
        body (the frames _windowable rejects)."""
        with span("h264.eager"):
            n_mbs = prep["n_mbs"]
            self._ensure_dpb(prep["geom"])
            dev = self.device

            # zero-fill slots of synthesized non-existing frames (the reference
            # leaves them as uninitialized memory; the JAX package zeroes them)
            for slot in prep["non_existing"]:
                for plane in self._dpb:
                    plane[slot].zero_()

            ipcm_mb, ipcm_data = prep["ipcm"]
            pcm = None
            if len(ipcm_mb):
                pcm = tuple(torch.from_numpy(p).to(dev) for p in
                            build_pcm_tensors(n_mbs, ipcm_mb, ipcm_data))
            # a partial loss without a usable reference needs the exact spiral
            # concealment (host); a partial loss with one and the whole-picture
            # cases stay on the device (both exact)
            _frame_decode_body(self._stage([prep])[0], self._dpb, pcm,
                               **self._body_args(prep), spiral=spiral_of(prep))
            count("eager_frames")

    def _run_graphed(self, prep, row):
        """Decode a windowable frame from its input row on the device:
        replay the graph of its key, or capture it (which decodes the
        frame) on the key's first frame. On the CPU the body runs
        eagerly."""
        args = self._body_args(prep)
        if self.device.type == "cpu":
            with span("h264.eager"):
                _frame_decode_body(row, self._dpb, None, **args)
            count("eager_frames")
            return
        key = self._graph_key(prep, row)
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay(row)
            return
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        self._graphs[key] = FrameGraph(
            partial(_frame_decode_body, dpb=self._dpb, pcm=None, **args),
            row, self._pool, self._side)

    def _graph_key(self, prep, row):
        """The key of the graph that decodes a windowable frame from its
        input row: geometry, ring slots, caps, row length, intra class
        and whether it references a slot."""
        return (prep["w_mbs"], prep["h_mbs"], self._dpb[0].shape[0],
                prep["caps"], row.shape[0], prep["wavefront"],
                prep["has_inter"])

    def _decode_step(self, prep):
        """One windowable frame through its graph (the JAX package's
        _decode_step)."""
        self._decode_window_step([(prep, [])])

    def _decode_window_step(self, items):
        """K windowable frames of one graph key, [(prep, outs)] in decode
        order (the JAX package's _decode_window_step): their rows go to
        the device in one copy, then frame k's row is replayed and the
        pictures it released (outs) are copied out of the ring before
        frame k+1 may overwrite their slots. Returns those pictures."""
        self._ensure_dpb(items[0][0]["geom"])
        rows = self._stage([prep for prep, _ in items])
        pics = []
        for row, (prep, outs) in zip(rows, items):
            self._run_graphed(prep, row)
            pics += [self._make_output(o, prep["geom"]) for o in outs]
        return pics

    def _submit_window(self, items):
        """Decode a window of compatible windowable frames [(prep, outs)]
        in power-of-two chunks (16, 8, 4, 2, then a lone frame through
        _decode_step), as the JAX package's _submit_window does. Returns
        the released pictures in order."""
        pics = []
        i = 0
        with span("h264.flush"):
            while len(items) - i > 1:
                k = next(k for k in (16, 8, 4, 2) if k <= len(items) - i)
                pics += self._decode_window_step(items[i:i + k])
                i += k
            if len(items) - i:
                prep, outs = items[i]
                self._decode_step(prep)
                pics += [self._make_output(o, prep["geom"]) for o in outs]
        return pics

    # -- output ------------------------------------------------------------

    def next_output_picture(self):
        """Next display-order picture, or None (reference
        h264bsdNextOutputPicture decoder.c:599)."""
        out = self._fe.next_output()
        if out is None or self._dpb is None:
            return None
        return self._make_output(out, self._geom)

    def _make_output(self, out, g):
        """The picture of ring slot out["slot"], with its planes copied
        out of the ring (device to device): the ring is written in place,
        so without the copy a later frame reusing the slot would change a
        picture the consumer still holds."""
        crop = (g["crop_left"], g["crop_width"], g["crop_top"],
                g["crop_height"]) if g["crop_flag"] else \
            (0, g["width_mbs"] * 16, 0, g["height_mbs"] * 16)
        with span("h264.output"):
            planes = tuple(p[out["slot"]].clone() for p in self._dpb)
        return OutputPicture(
            pic_id=out["pic_id"], is_idr=bool(out["is_idr"]),
            num_err_mbs=out["num_err_mbs"],
            width=g["width_mbs"] * 16, height=g["height_mbs"] * 16,
            crop=crop, planes=planes,
            full_range=bool(g.get("full_range", 0)))

    # -- metadata (reference decoder.c:771-1105) ---------------------------

    def pic_width(self):
        return self._geom["width_mbs"] * 16 if self._geom else 0

    def pic_height(self):
        return self._geom["height_mbs"] * 16 if self._geom else 0

    def cropping_params(self):
        g = self._geom
        return (bool(g["crop_flag"]), g["crop_left"], g["crop_width"],
                g["crop_top"], g["crop_height"])

    def sample_aspect_ratio(self):
        return (self._geom["sar_width"], self._geom["sar_height"])

    def profile(self):
        return self._geom["profile"]

    def matrix_coefficients(self):
        """VUI matrix_coefficients, 2 (unspecified) when absent
        (reference h264bsdMatrixCoefficients decoder.c:928)."""
        return self._geom["matrix_coefficients"] if self._geom else 2

    def flush_buffer(self):
        """Force every pending picture into the display-order output
        queue (reference h264bsdFlushBuffer decoder.c:834); drain with
        next_output_picture()."""
        self._fe.flush_buffer()

    def video_full_range(self):
        return bool(self._geom["full_range"])

    def check_valid_param_sets(self) -> bool:
        """True when at least one valid SPS/PPS combination has been
        received (reference h264bsdCheckValidParamSets decoder.h:82)."""
        return self._fe.valid_param_sets()

    def take_sei_messages(self):
        """Drain and decode every SEI message received since the last
        call (list of frontend.sei.SeiMessage). Goes beyond the reference,
        whose SEI parser is dead code (h264bsd_sei.c; decoder.c:464-466
        skips the NAL): the front-end queues each SEI NAL's RBSP and the
        messages are decoded on the host, with buffering-period /
        pic-timing HRD geometry looked up from the stored SPSs."""
        def hrd_lookup(sps_id):
            h = self._fe.sps_hrd(sps_id)
            if h is None or not h["vui_present"]:
                return None
            return {"nal_hrd_present": h["nal_hrd_present"],
                    "vcl_hrd_present": h["vcl_hrd_present"],
                    "nal_cpb_cnt": h["nal_cpb_cnt"],
                    "vcl_cpb_cnt": h["vcl_cpb_cnt"],
                    "nal_initial_len": h["nal_initial_len"],
                    "vcl_initial_len": h["vcl_initial_len"]}

        active = None
        g = self._geom
        if g is not None:
            # pic-timing geometry comes from the active SPS
            for sid in range(32):
                h = self._fe.sps_hrd(sid)
                if h is not None:
                    active = h
                    break
        msgs = []
        pic_size = 0
        if g:
            pic_size = g["width_mbs"] * g["height_mbs"]
        while (rbsp := self._fe.take_sei()) is not None:
            msgs.extend(parse_sei_rbsp(
                rbsp, hrd_lookup=hrd_lookup, active_hrd=active,
                pic_size_in_map_units=pic_size))
        return msgs


def pin_caps_for_stream(data: bytes, typical_pct: float = 75.0) -> dict:
    """Dry-parse a stream (C++ front-end only, no device work) and return
    a {wavefront_class: [(typical_caps, total_words), (max_caps,
    total_words)]} pin for Decoder(caps_pin=...): at most two blob shapes
    per class, the typical tier covering `typical_pct` percent of the
    class's frames (the JAX package's pin_caps_for_stream)."""
    d = fe.FrontendDecoder(no_output_reordering=True)
    per: dict = {}
    n_mbs = 0
    pos = 0
    while pos < len(data):
        status, read = d.decode(data, 0, pos)
        pos += read
        if status == fe.HDRS_RDY:
            g = d.stream_info()
            n_mbs = g["width_mbs"] * g["height_mbs"]
        elif status == fe.PIC_RDY:
            counts = [int(x) for x in d.blob_counts()]
            per.setdefault(counts[5] > WF_THRESH, []).append(counts)
            while d.next_output() is not None:
                pass
        elif status >= fe.ERROR and read == 0:
            break
    d.close()

    def fits(counts, p):
        return (all(counts[k] <= p[k] for k in range(7))
                and (counts[6] <= 1 or p[7] > 0))

    pins = {}
    for wf, rows in per.items():
        a = np.asarray(rows)
        c_max = caps_from_counts(a.max(axis=0).tolist(), n_mbs, wf)
        c_typ = caps_from_counts(
            np.percentile(a, typical_pct, axis=0,
                          method="higher").astype(int).tolist(), n_mbs, wf)
        tiers = [c_typ, c_max] if c_typ != c_max else [c_max]
        assigned = [[] for _ in tiers]
        for counts in rows:
            k = next(k for k, caps in enumerate(tiers) if fits(counts, caps))
            assigned[k].append(counts)
        entries = []
        for k, caps in enumerate(tiers):
            needs = [compact_blob_words(c, n_mbs, caps)[1]
                     for c in assigned[k]] or \
                [compact_blob_words([0] * 7, n_mbs, caps)[1]]
            entries.append((caps, -(-max(needs) // 256) * 256))
        pins[wf] = entries
    return pins


def pool_workers() -> int:
    """Parse workers of decode_stream's pipelined front-end: the CPUs this
    process may run on, less one for the consumer and one for the
    in-order parse thread, at most 4."""
    return max(1, min(4, len(os.sched_getaffinity(0)) - 2))


def decode_stream(data: bytes, max_pictures: int | None = None,
                  pipelined: bool = True, caps_pin: dict = None,
                  device=None, decoder: Decoder = None):
    """Full posix-test-app decode loop (reference posix/test_h264bsd.c:
    146-177) on `device` (see Decoder). Yields OutputPicture in display
    order.

    With pipelined=True the bitstream parse (C++, releases the GIL) runs
    ahead on a worker thread, and consecutive compatible frames are
    grouped into windows of up to WINDOW frames, each decoded by
    Decoder._submit_window (one host-to-device copy, then one graph replay
    per frame on the card). That parse thread keeps the in-order work
    (NAL units, slice headers, the DPB, the blob layout) and hands each
    picture's slice data to pool_workers() threads of the front-end's
    pool (FrontendDecoder.pool_start), taking the pictures back in decode
    order, identical to a serial parse.

    decoder: decode with this Decoder, restarted (Decoder.restart), in
    place of a new one (caps_pin and device are then its own): a decoder
    that decoded a stream of the same geometry replays the CUDA graphs it
    captured there, as benchmark_stream's timed passes do."""
    if decoder is None:
        # slot margin = window length, as the JAX package's decode_stream
        # sets it, so both allocate the same ring slots
        dec = Decoder(caps_pin=caps_pin, slot_margin=WINDOW, device=device)
    else:
        dec = decoder
        dec.restart()
    if not pipelined:
        pos = 0
        n_out = 0
        while pos < len(data):
            status, read = dec.decode(data, n_out, pos)
            pos += read
            if status == fe.PIC_RDY:
                while (pic := dec.next_output_picture()) is not None:
                    yield pic
                    n_out += 1
                    if max_pictures is not None and n_out >= max_pictures:
                        return
            elif status >= fe.ERROR and read == 0:
                return
        return

    # depth bounds the parse-ahead memory (one blob per entry)
    q: "queue.Queue" = queue.Queue(maxsize=6)
    stop = threading.Event()

    def put(item):
        with span("h264.queue_put"):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

    front = dec._fe
    workers = pool_workers()

    def hand_on(drain):
        """Queue the ended pictures, in decode order, while the oldest's
        job is done, or more than 2 x workers have ended, or `drain`
        (blocking on the oldest's job then). Returns the output pictures
        queued so far (the pic_id of the next NAL)."""
        while True:
            n, ready, n_out = front.pool_poll()
            if not n or not (ready or drain or n > 2 * workers):
                return n_out
            if ready:
                pic = front.pool_take()
            else:
                fe.STATS["pool_waits"] += 1
                with span("h264.pool_wait"):
                    pic = front.pool_take()
            if pic is None:        # the pool was stopped
                return n_out
            prep = dec._prepare(pic)
            outs = pic.outputs()
            pic.release()
            put((prep, outs))

    def producer():
        front.pool_start(workers)
        try:
            pos = 0
            n_out = 0
            while pos < len(data) and not stop.is_set():
                status, read = dec._parse(data, n_out, pos)
                pos += read
                if status == fe.HDRS_RDY:
                    # geometry changes flow through the queue so pending
                    # submits of the previous sequence use its ring
                    hand_on(drain=True)
                    dec._geom = front.stream_info()
                    put(("reset",))
                elif status >= fe.ERROR and read == 0:
                    break
                n_out = hand_on(drain=False)
            if not stop.is_set():
                front.pool_finish()
                hand_on(drain=True)
        except BaseException as exc:  # re-raised by the consuming thread
            put(("error", exc))
            return
        finally:
            front.pool_stop()
        put(None)

    # the pending window: consecutive windowable frames of one graph key
    window: list = []          # [(prep, outs)]

    def compatible(prep):
        if not window:
            return True
        head = window[0][0]
        return all(prep[k] == head[k] for k in ("caps", "wavefront",
                                                 "has_inter", "n_mbs")) \
            and prep["blob"].nbytes == head["blob"].nbytes

    def flush():
        """Decode the pending window; its released pictures, in order."""
        ready = dec._submit_window(window) if window else []
        window.clear()
        return ready

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    n_out = 0
    # Pipeline-ramp flushing (the JAX package's): when nothing is parsed
    # ahead the window is flushed once it holds next_min frames, and
    # next_min doubles after each such flush (1, 2, 4, ... WINDOW): the
    # first frames go to the device at once, and behind a busy device
    # the windows grow to full length.
    next_min = 1
    done = False
    try:
        while not done:
            with span("h264.queue_wait"):
                item = q.get()
            while True:
                if item is None:
                    done = True
                    ready = flush()
                elif item[0] == "error":
                    raise item[1]
                elif item[0] == "reset":
                    ready = flush()
                    dec._set_ring(None)
                else:
                    prep, outs = item
                    if not dec._windowable(prep):
                        ready = flush()
                        dec._submit(prep)
                        # copied out of the ring before the next submit
                        ready += [dec._make_output(o, prep["geom"])
                                  for o in outs]
                    else:
                        ready = [] if compatible(prep) else flush()
                        window.append(item)
                        if len(window) >= WINDOW:
                            ready += flush()
                for pic in ready:
                    yield pic
                    n_out += 1
                    if max_pictures is not None and n_out >= max_pictures:
                        return
                if done:
                    break
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    if len(window) >= next_min:
                        next_min = min(2 * next_min, WINDOW)
                        for pic in flush():
                            yield pic
                            n_out += 1
                            if max_pictures is not None and \
                                    n_out >= max_pictures:
                                return
                    break
    finally:
        stop.set()
        t.join()


def frame_checksum_host(frame_bytes: bytes) -> int:
    """Weighted uint32 checksum (wraparound) of a truncated YUV frame."""
    x = np.frombuffer(frame_bytes, np.uint8).astype(np.uint32)
    w = (np.arange(x.size, dtype=np.uint32) * np.uint32(2654435761)) \
        + np.uint32(1)
    return int((x * w).sum(dtype=np.uint32))


def frame_checksum_device(y, cb, cr, n_trunc: int) -> torch.Tensor:
    """frame_checksum_host of the first n_trunc bytes of the planes'
    uncropped YUV, as tensor ops on their device: a 0-d int64 tensor
    holding the uint32 value. torch has no wrapping uint32 multiply, so
    the products are taken in int64 (x <= 255 and w < 2**32, so each is
    below 2**40 and a 1080p frame's sum of ~3.1 M below 2**62) and the
    sum is reduced modulo 2**32."""
    flat = torch.cat([y.reshape(-1), cb.reshape(-1), cr.reshape(-1)])
    x = flat[:n_trunc].long()
    w = (torch.arange(n_trunc, dtype=torch.int64, device=x.device)
         * 2654435761 + 1) & 0xFFFFFFFF
    return (x * w).sum() & 0xFFFFFFFF


def benchmark_passes(run, want_checksums, device, repeats: int = 5,
                     budget_s: float | None = None,
                     n_trunc: int | None = None) -> dict:
    """Time a decode on `device` (a torch.device) that run() makes once
    per call, returning the (y, cb, cr) planes of its pictures in order:
    first a verification pass, whose per-picture checksums
    (frame_checksum_device over each picture's first n_trunc bytes, the
    whole picture when None) are computed on the device and read back
    once, against want_checksums; then, only when every picture matched,
    `repeats` timed passes, and more until they have taken budget_s
    seconds when it is given. Each timed pass keeps its pictures and
    ends in torch.cuda.synchronize() on the card; after its clock stops,
    its pictures are checksummed on the device as the verification
    pass's were, and a pass that differs ends the timing.

    Returns {"bit_exact" (every pass matched), "pictures", "cold_fps" (the
    verification pass, its captures and checksums included), "captures",
    "capture_ms" (the verification pass's), "timed_captures" (the timed
    passes'), "runs" (each timed pass's fps), "fps" (the best), "median",
    "fps_all" (all the timed passes' pictures over all their seconds),
    "timed_s"}; when a pass differs, "runs" is empty and "fps", "median"
    and "fps_all" are None."""
    want = list(want_checksums)

    def checksums(pics):
        sums = [frame_checksum_device(*planes, n_trunc or sum(
            q.numel() for q in planes)) for planes in pics]
        return torch.stack(sums).cpu().tolist() if sums else []

    reset_stats()
    t0 = time.perf_counter()
    got = checksums(run())
    cold_s = time.perf_counter() - t0
    out = {"bit_exact": got == want, "pictures": len(got),
           "cold_fps": len(got) / cold_s,
           "captures": STATS["graph_captures"],
           "capture_ms": STATS["capture_ms"]}
    runs, n_all, timed_s = [], 0, 0.0
    if out["bit_exact"]:
        reset_stats()
        while len(runs) < repeats or (budget_s is not None
                                      and timed_s < budget_s):
            t0 = time.perf_counter()
            pics = run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if checksums(pics) != want:
                out["bit_exact"] = False
                out["failed_pass"] = len(runs)
                runs = []
                break
            timed_s += dt
            n_all += len(pics)
            runs.append(len(pics) / dt)
        out["timed_captures"] = STATS["graph_captures"]
    out["runs"] = runs
    out["fps"] = max(runs) if runs else None
    out["median"] = float(np.median(runs)) if runs else None
    out["fps_all"] = n_all / timed_s if runs else None
    out["timed_s"] = timed_s
    return out


def benchmark_stream(data: bytes, want_checksums, repeats: int = 5,
                     device=None, budget_s: float | None = None,
                     n_trunc: int | None = None) -> dict:
    """Decode `data` with decode_stream on `device` (see Decoder) under
    benchmark_passes: a verification pass checksummed on the device,
    then, only when bit-exact, timed passes (see there for the record it
    returns). The verification pass takes the CUDA graph captures: the
    timed passes decode with the same Decoder (decode_stream's
    decoder=), restarted, and replay them."""
    dev = resolve_device(device)
    dec = Decoder(caps_pin=pin_caps_for_stream(data), slot_margin=WINDOW,
                  device=dev)
    try:
        return benchmark_passes(
            lambda: [p.planes for p in decode_stream(data, decoder=dec)],
            want_checksums, dev, repeats, budget_s, n_trunc)
    finally:
        dec.close()


def benchmark_decode(stream_name: str, repeats: int = 5, device=None):
    """Bench helper: decode a bundled stream of utils/golden (the
    reference tree's test streams), returns (fps, bit_exact) as the JAX
    package's benchmark_decode does: benchmark_stream against the
    reference decoder's golden frames, checksummed over the truncated
    frame the reference test app dumps; fps is None when a picture
    differs."""
    from ..utils import golden

    data = golden.stream_path(stream_name).read_bytes()
    goldens = golden.golden_frames(stream_name)
    r = benchmark_stream(data, [frame_checksum_host(g) for g in goldens],
                         repeats, device, n_trunc=len(goldens[0]))
    return r["fps"], r["bit_exact"]
