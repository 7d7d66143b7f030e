"""Top-level H.264 Baseline decoder on PyTorch and CUDA.

Public API mirrors the reference library surface (h264bsd_decoder.h:64-93)
and the JAX package's models/decoder.py: decode one NAL per call, drain
display-order output pictures, query stream geometry, convert to
RGBA/BGRA/YCbCrA. The bitstream front-end runs in C++ (frontend/); the
pixel stages run on the device, one frame at a time, into a DPB ring
written in place (unpack -> reconstruct -> conceal -> deblock -> slot).

Scope of this version: pictures that reference no DPB slot (intra
pictures, whole-picture concealment). A picture that needs motion
compensation, a partial loss that needs the host spiral concealment, and
SEI decoding raise NotImplementedError.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..frontend import binding as fe
from ..ops.cuda_deblock_wf import deblock_frame_wavefront
from ..ops.reconstruct import build_pcm_tensors, reconstruct_frame_fast
from ..ops.unpack import blob_words, compact_blob_words, unpack_blob
from .state import new_ring, tensor_from_numpy

# intra-MB count above which a frame runs the anti-diagonal wavefront
# intra kernel (K7) instead of the list kernel (K2); the JAX package's
# threshold, so both take the same caps and blob shapes
WF_THRESH = 2048


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


def _frame_decode_body(words, header, dpb, pcm, slot, conceal_from_ref,
                       conceal_ref_slot, width_mbs, height_mbs, caps,
                       intra_wavefront):
    """One full frame on the device: unpack, reconstruct, conceal,
    deblock, store into ring slot `slot` (in place)."""
    n_mbs = width_mbs * height_mbs
    (packed, slice_table, sparse_ids, sparse_levels, mv_exc_ids,
     mv_exc_payload, intra_mbs, intra_payload, slice_ids) = unpack_blob(
        words, n_mbs, *caps, header=header)
    y, cb, cr, t = reconstruct_frame_fast(
        packed, slice_table, sparse_ids, sparse_levels, mv_exc_ids,
        mv_exc_payload, intra_mbs, intra_payload, pcm, width_mbs,
        height_mbs, intra_wavefront, slice_ids)

    # concealment of lost MBs (mb_class 6): a copy of the co-located MB of
    # the first available reference (ConcealMb conceal.c:318-338), or a
    # grey fill (conceal.c:172-199). Written straight into the ring slot,
    # in place (no per-frame ring copy), which then holds the picture
    # through deblocking; the reference slot is another picture, so it is
    # never the slot written. Because the ring is overwritten in place,
    # Decoder._make_output copies a picture's planes out of its slot
    # before the next frame is submitted.
    dpb_y, dpb_cb, dpb_cr = dpb
    concealed = (t["mb_class"] == 6).reshape(height_mbs, width_mbs)
    from_ref = conceal_from_ref and conceal_ref_slot >= 0
    planes = []
    for plane, ring, size in ((y, dpb_y, 16), (cb, dpb_cb, 8),
                              (cr, dpb_cr, 8)):
        mask = concealed.repeat_interleave(size, 0) \
            .repeat_interleave(size, 1)
        rep = ring[conceal_ref_slot] if from_ref else plane.new_full((), 128)
        out = ring[slot]
        torch.where(mask, rep, plane, out=out)
        planes.append(out)

    deblock_frame_wavefront(
        *planes, t["mb_class"], t["nnz"], t["mv"], t["ref_slot"],
        t["slice_id"], t["disable_dblk"], t["qp_y"], t["filter_off_a"],
        t["filter_off_b"], t["chroma_qp_offset"], width_mbs, height_mbs)


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
        self._fe = fe.FrontendDecoder(no_output_reordering,
                                      intra_concealment, slot_margin)
        self._caps_pin = caps_pin
        # sticky-caps history per wavefront class (see _prepare)
        self._cap_hist = {}
        self._dpb = None           # (y, cb, cr) ring tensors
        self._geom = None          # stream_info dict

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        self._fe.close()

    # -- decoding ----------------------------------------------------------

    def decode(self, data, pic_id: int = 0, offset: int = 0,
               length: int | None = None):
        """Decode one NAL unit; returns (status, bytes_consumed)."""
        status, read = self._fe.decode(data, pic_id, offset, length)
        if status == fe.HDRS_RDY:
            self._geom = self._fe.stream_info()
            self._dpb = None  # realloc lazily at the next picture
        elif status == fe.PIC_RDY:
            self._submit(self._prepare())
        return status, read

    def _ensure_dpb(self, g):
        shape = (g["dpb_slots"], g["height_mbs"] * 16, g["width_mbs"] * 16)
        if self._dpb is None or tuple(self._dpb[0].shape) != shape:
            self._dpb = new_ring(g["dpb_slots"], g["height_mbs"],
                                 g["width_mbs"], self.device)

    def load_ring(self, y, cb, cr):
        """Seed the DPB ring from numpy (slots, H, W) / (slots, H/2, W/2)
        uint8 arrays, e.g. the JAX package's ring. Call after the stream
        headers (HDRS_RDY), which reset the ring."""
        self._dpb = tuple(tensor_from_numpy(p, self.device)
                          for p in (y, cb, cr))

    def _prepare(self):
        """Host-only half of a frame: gather everything the device step
        needs (no device work, so it may run on a parse-ahead thread)."""
        # read afresh: the ring size (dpb_slots) is known only once the
        # first slice has activated the DPB, after HDRS_RDY
        g = self._fe.stream_info()
        self._geom = g
        info = self._fe.pic_info()
        w_mbs, h_mbs = g["width_mbs"], g["height_mbs"]
        n_mbs = w_mbs * h_mbs
        non_existing = self._fe.take_non_existing()
        counts = tuple(int(x) for x in self._fe.blob_counts())
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
        blob = self._fe.blob_compact(*caps, total_w * 4)
        return dict(info=info, geom=g, w_mbs=w_mbs, h_mbs=h_mbs,
                    n_mbs=n_mbs, blob=blob, caps=caps, wavefront=wavefront,
                    ipcm=self._fe.ipcm(), non_existing=non_existing)

    def _submit(self, prep):
        """Device half: transfer the blob and run the frame step."""
        info = prep["info"]
        n_mbs = prep["n_mbs"]
        if info["used_slot_count"] > 0:
            raise NotImplementedError(
                "this picture references DPB slots: motion compensation "
                "(P pictures) comes with the next slice of the port")
        n_conc = info["num_concealed_mbs"]
        if 0 < n_conc < n_mbs and (not info["conceal_from_ref"]
                                   or info["conceal_ref_slot"] < 0):
            raise NotImplementedError(
                "partial loss without a usable reference needs the host "
                "spiral concealment, which comes with the error-path slice "
                "of the port")
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
        blob = prep["blob"]
        _frame_decode_body(
            blob_words(blob, dev), blob[:64].view(np.uint32).tolist(),
            self._dpb, pcm, info["slot"], bool(info["conceal_from_ref"]),
            info["conceal_ref_slot"], prep["w_mbs"], prep["h_mbs"],
            prep["caps"], prep["wavefront"])

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
        return OutputPicture(
            pic_id=out["pic_id"], is_idr=bool(out["is_idr"]),
            num_err_mbs=out["num_err_mbs"],
            width=g["width_mbs"] * 16, height=g["height_mbs"] * 16,
            crop=crop, planes=tuple(p[out["slot"]].clone()
                                    for p in self._dpb),
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
        raise NotImplementedError(
            "SEI decoding (frontend/sei.py) comes with a later slice of the "
            "port")


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


def decode_stream(data: bytes, max_pictures: int | None = None,
                  pipelined: bool = True, caps_pin: dict = None,
                  device=None):
    """Full posix-test-app decode loop (reference posix/test_h264bsd.c:
    146-177) on `device` (see Decoder). Yields OutputPicture in display
    order.

    With pipelined=True the bitstream parse (C++, releases the GIL) runs
    ahead on a worker thread, overlapping the device work of earlier
    frames; frames are submitted to the device one at a time."""
    dec = Decoder(caps_pin=caps_pin, device=device)
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
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def producer():
        try:
            pos = 0
            n_out = 0
            while pos < len(data) and not stop.is_set():
                status, read = dec._fe.decode(data, n_out, pos)
                pos += read
                if status == fe.HDRS_RDY:
                    # geometry changes flow through the queue so pending
                    # submits of the previous sequence use its ring
                    dec._geom = dec._fe.stream_info()
                    put(("reset",))
                elif status == fe.PIC_RDY:
                    prep = dec._prepare()
                    outs = []
                    while (o := dec._fe.next_output()) is not None:
                        outs.append(o)
                    n_out += len(outs)
                    put((prep, outs))
                elif status >= fe.ERROR and read == 0:
                    break
        except BaseException as exc:  # re-raised by the consuming thread
            put(("error", exc))
            return
        put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    n_out = 0
    try:
        while (item := q.get()) is not None:
            if item[0] == "error":
                raise item[1]
            if item[0] == "reset":
                dec._dpb = None
                continue
            prep, outs = item
            dec._submit(prep)
            # every output is copied out of the ring before the next submit
            pics = [dec._make_output(o, prep["geom"]) for o in outs]
            for pic in pics:
                yield pic
                n_out += 1
                if max_pictures is not None and n_out >= max_pictures:
                    return
    finally:
        stop.set()
        t.join()


def frame_checksum_host(frame_bytes: bytes) -> int:
    """Weighted uint32 checksum (wraparound) of a truncated YUV frame."""
    x = np.frombuffer(frame_bytes, np.uint8).astype(np.uint32)
    w = (np.arange(x.size, dtype=np.uint32) * np.uint32(2654435761)) \
        + np.uint32(1)
    return int((x * w).sum(dtype=np.uint32))
