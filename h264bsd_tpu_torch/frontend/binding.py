"""ctypes binding for the host front-end library."""

from __future__ import annotations

import ctypes as ct
import threading

import numpy as np

from .build import build

_lib = None

# Front-end counters, beside models/graphs.py STATS. pictures_pooled:
# pictures whose slice data ran ahead on a pool's workers; pictures_serial:
# pictures of a pooled front-end parsed in order instead (multi-slice,
# FMO, redundant or lost slices); pool_waits: takes that blocked on a
# picture's job; packed_builds: packed-record builds, one a picture.
STATS = {"pictures_pooled": 0, "pictures_serial": 0, "pool_waits": 0,
         "packed_builds": 0}
_builds_seen = [0]
_builds_lock = threading.Lock()


def _count_builds() -> None:
    """Bring STATS["packed_builds"] up to the library's count."""
    with _builds_lock:
        n = lib().h264tpu_packed_builds()
        STATS["packed_builds"] += n - _builds_seen[0]
        _builds_seen[0] = n


def lib() -> ct.CDLL:
    global _lib
    if _lib is None:
        _lib = ct.CDLL(str(build()))
        _configure(_lib)
    return _lib


def _configure(L: ct.CDLL) -> None:
    L.h264tpu_create.restype = ct.c_void_p
    L.h264tpu_create.argtypes = [ct.c_uint32]
    L.h264tpu_destroy.restype = None
    L.h264tpu_destroy.argtypes = [ct.c_void_p]
    L.h264tpu_decode.restype = ct.c_uint32
    L.h264tpu_decode.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_uint32, ct.c_uint32,
        ct.POINTER(ct.c_uint32),
    ]
    L.h264tpu_stream_info.restype = None
    L.h264tpu_stream_info.argtypes = [
        ct.c_void_p, np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")]
    L.h264tpu_pic_info.restype = None
    L.h264tpu_pic_info.argtypes = [
        ct.c_void_p, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    L.h264tpu_tensor.restype = ct.c_void_p
    L.h264tpu_tensor.argtypes = [ct.c_void_p, ct.c_uint32,
                                 ct.POINTER(ct.c_uint64)]
    L.h264tpu_next_output.restype = ct.c_uint32
    L.h264tpu_next_output.argtypes = [
        ct.c_void_p, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    L.h264tpu_packed.restype = ct.c_void_p
    L.h264tpu_packed.argtypes = [ct.c_void_p, ct.POINTER(ct.c_uint64)]
    L.h264tpu_blob.restype = ct.c_void_p
    L.h264tpu_blob.argtypes = [
        ct.c_void_p, ct.c_uint32, ct.c_uint32, ct.c_uint32, ct.c_uint32,
        ct.c_uint32, ct.c_uint32, ct.c_uint32, ct.c_uint32,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ct.POINTER(ct.c_uint64)]
    L.h264tpu_blob_compact.restype = ct.c_void_p
    L.h264tpu_blob_compact.argtypes = [
        ct.c_void_p, ct.c_uint32, ct.c_uint32, ct.c_uint32, ct.c_uint32,
        ct.c_uint32, ct.c_uint32, ct.c_uint32, ct.c_uint32, ct.c_uint32,
        ct.POINTER(ct.c_uint64)]
    L.h264tpu_flush_buffer.restype = None
    L.h264tpu_flush_buffer.argtypes = [ct.c_void_p]
    L.h264tpu_valid_param_sets.restype = ct.c_uint32
    L.h264tpu_valid_param_sets.argtypes = [ct.c_void_p]
    L.h264tpu_peek_idr_boundary.restype = ct.c_int
    L.h264tpu_peek_idr_boundary.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_uint32]
    L.h264tpu_take_non_existing.restype = ct.c_uint32
    L.h264tpu_take_non_existing.argtypes = [
        ct.c_void_p, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ct.c_uint32]
    L.h264tpu_dev_coeff_token.restype = ct.c_uint32
    L.h264tpu_dev_coeff_token.argtypes = [ct.c_uint32, ct.c_int32]
    L.h264tpu_dev_total_zeros.restype = ct.c_uint32
    L.h264tpu_dev_total_zeros.argtypes = [ct.c_uint32, ct.c_uint32, ct.c_int32]
    L.h264tpu_dev_run_before.restype = ct.c_uint32
    L.h264tpu_dev_run_before.argtypes = [ct.c_uint32, ct.c_uint32]
    L.h264tpu_dev_residual_block.restype = ct.c_uint32
    L.h264tpu_dev_residual_block.argtypes = [
        ct.c_char_p, ct.c_uint32, ct.c_int32, ct.c_uint32,
        np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
    ]
    L.h264tpu_take_sei.restype = ct.c_void_p
    L.h264tpu_take_sei.argtypes = [ct.c_void_p, ct.POINTER(ct.c_uint64)]
    L.h264tpu_sps_hrd.restype = ct.c_uint32
    L.h264tpu_sps_hrd.argtypes = [
        ct.c_void_p, ct.c_uint32,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")]
    L.h264tpu_packed_builds.restype = ct.c_uint64
    L.h264tpu_packed_builds.argtypes = []
    for name in ("pool_start", "pool_stop", "pool_finish"):
        getattr(L, "h264tpu_" + name).restype = None
        getattr(L, "h264tpu_" + name).argtypes = [ct.c_void_p]
    for name in ("pool_next_job", "pool_take"):
        getattr(L, "h264tpu_" + name).restype = ct.c_void_p
        getattr(L, "h264tpu_" + name).argtypes = [ct.c_void_p]
    for name in ("pool_run_job", "pool_release"):
        getattr(L, "h264tpu_" + name).restype = None
        getattr(L, "h264tpu_" + name).argtypes = [ct.c_void_p, ct.c_void_p]
    L.h264tpu_pool_poll.restype = None
    L.h264tpu_pool_poll.argtypes = [
        ct.c_void_p, np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")]
    # a taken picture's reads: the instance calls of the same names
    for name in ("stream_info", "pic_info", "tensor", "blob", "blob_compact",
                 "take_non_existing"):
        src = getattr(L, "h264tpu_" + name)
        dst = getattr(L, "h264tpu_picture_" + name)
        dst.restype, dst.argtypes = src.restype, src.argtypes
    L.h264tpu_picture_outputs.restype = ct.c_uint32
    L.h264tpu_picture_outputs.argtypes = [
        ct.c_void_p, np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ct.c_uint32]
    L.h264tpu_picture_pooled.restype = ct.c_uint32
    L.h264tpu_picture_pooled.argtypes = [ct.c_void_p]
    L.h264tpu_dev_parse_sps.restype = ct.c_uint32
    L.h264tpu_dev_parse_sps.argtypes = [
        ct.c_char_p, ct.c_uint32,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
    ]


def dev_parse_sps(data: bytes) -> dict:
    out = np.zeros(13, np.uint32)
    status = lib().h264tpu_dev_parse_sps(data, len(data), out)
    if status != 0:
        raise ValueError(f"SPS parse failed with status {status}")
    keys = ["width_mbs", "height_mbs", "crop_l", "crop_r", "crop_t", "crop_b",
            "max_dpb", "num_ref", "max_frame_num", "poc_type", "level",
            "profile", "cropping"]
    return dict(zip(keys, out.tolist()))


# ---- decoder instance wrapper ----

# return codes, reference h264bsd_decoder.h:46-55
RDY = 0
PIC_RDY = 1
HDRS_RDY = 2
ERROR = 3
PARAM_SET_ERROR = 4
MEMALLOC_ERROR = 5

_TENSORS = {
    # name: (tensor_id, dtype, per-MB shape)
    "mb_class": (0, np.uint8, ()),
    "qp_y": (1, np.uint8, ()),
    "slice_id": (2, np.uint32, ()),
    "decoded": (3, np.uint8, ()),
    "disable_dblk": (4, np.uint8, ()),
    "filter_off_a": (5, np.int8, ()),
    "filter_off_b": (6, np.int8, ()),
    "i16_mode": (7, np.uint8, ()),
    "chroma_mode": (8, np.uint8, ()),
    "i4_modes": (9, np.uint8, (16,)),
    "i4_avail": (10, np.uint8, (16,)),
    "mb_avail": (11, np.uint8, ()),
    "mv": (12, np.int16, (16, 2)),
    "ref_slot": (13, np.int8, (16,)),
    "nnz": (14, np.uint8, (24,)),
    "nnz_dc": (15, np.uint8, (3,)),
    "coeff": (16, np.int16, (24, 16)),
    "luma_dc": (17, np.int16, (16,)),
    "chroma_dc": (18, np.int16, (8,)),
    "chroma_qp_offset": (21, np.int8, ()),
}


class _Reads:
    """The reads Decoder._prepare makes of one picture's front-end output,
    through the C calls named _PREFIX + name: the decoder instance's
    current picture (FrontendDecoder) or a picture taken from its pool
    (PooledPicture)."""

    _PREFIX = "h264tpu_"

    def _c(self, name):
        return getattr(self._lib, self._PREFIX + name)

    def stream_info(self) -> dict:
        out = np.zeros(16, np.uint32)
        self._c("stream_info")(self._h, out)
        keys = ["width_mbs", "height_mbs", "dpb_slots", "crop_flag",
                "crop_left", "crop_width", "crop_top", "crop_height",
                "sar_width", "sar_height", "profile", "full_range",
                "n_slots", "matrix_coefficients", "slot_margin"]
        return dict(zip(keys, out[:15].tolist()))

    def pic_info(self) -> dict:
        out = np.zeros(16, np.int32)
        self._c("pic_info")(self._h, out)
        keys = ["slot", "pic_id", "is_idr", "poc", "frame_num",
                "num_concealed_mbs", "slice_type", "conceal_from_ref",
                "conceal_ref_slot", "mv_min_x", "mv_min_y", "mv_max_x",
                "mv_max_y", "used_slot_count", "used_slot_mask"]
        return dict(zip(keys, out[:15].tolist()))

    def ipcm(self) -> tuple[np.ndarray, np.ndarray]:
        size = ct.c_uint64(0)
        ptr = self._c("tensor")(self._h, 19, ct.byref(size))
        if size.value == 0:
            return np.zeros(0, np.uint32), np.zeros((0, 384), np.uint8)
        mbs = np.frombuffer((ct.c_char * size.value).from_address(ptr),
                            dtype=np.uint32).copy()
        ptr = self._c("tensor")(self._h, 20, ct.byref(size))
        data = np.frombuffer((ct.c_char * size.value).from_address(ptr),
                             dtype=np.uint8).copy()
        return mbs, data.reshape(-1, 384)

    def blob_counts(self):
        """[n_single, n_short, n_full, n_wide, n_exc, n_intra, n_slices]
        for tier selection; builds + classifies the picture's packed
        records unless they are built (once a picture)."""
        counts = np.zeros(7, np.uint32)
        size = ct.c_uint64(0)
        self._c("blob")(self._h, 0, 0, 0, 0, 0, 0, 0, 0, counts,
                        ct.byref(size))
        _count_builds()
        return counts

    def blob_compact(self, single_cap, short_cap, full_cap, wide_cap,
                     exc_cap, intra_cap, stab_cap, sid_cap,
                     total_bytes) -> np.ndarray:
        """Compact transfer blob: sections at their REAL counts behind a
        64-byte count header, zero-padded to total_bytes (layout:
        build_blob_compact, mbparse.cpp). Transfer volume tracks content
        instead of the caps; the device derives offsets from the header
        and masks entries beyond the counts (ops.unpack)."""
        size = ct.c_uint64(0)
        ptr = self._c("blob_compact")(
            self._h, single_cap, short_cap, full_cap, wide_cap, exc_cap,
            intra_cap, stab_cap, sid_cap, total_bytes, ct.byref(size))
        _count_builds()
        buf = (ct.c_char * size.value).from_address(ptr)
        # copy: the C++ blob buffer is reused by the next frame while this
        # one may still be in flight to the device
        return np.frombuffer(buf, dtype=np.uint8).copy()

    def take_non_existing(self) -> list[int]:
        out = np.zeros(32, np.int32)
        n = self._c("take_non_existing")(self._h, out, 32)
        return out[:n].tolist()


class FrontendDecoder(_Reads):
    """Host bitstream front-end instance (C++), reference-equivalent control
    surface (h264bsd_decoder.h:64-93). Emits per-picture MB tensors for the
    device reconstruction pipeline."""

    def __init__(self, no_output_reordering: bool = False,
                 intra_concealment: bool = False, slot_margin: int = 0):
        """intra_concealment mirrors the reference's intraConcealmentFlag
        (h264bsd_storage.h:148-149, read at conceal.c:146-186). It only
        affects the whole-picture-lost I case: with the flag set a fully
        lost I picture is concealed by copying the reference picture
        instead of going grey. P-picture concealment is unchanged.

        slot_margin requests spare device-ring slots rotated FIFO by the
        DPB allocator so a windowed device dispatch of up to that many
        frames never reuses a ring slot (Dpb::init). Clamped so slot ids
        stay < 32; read the effective value from
        stream_info()["slot_margin"]."""
        self._lib = lib()
        flags = (1 if no_output_reordering else 0) | \
            (2 if intra_concealment else 0) | \
            ((min(max(int(slot_margin), 0), 255) & 0xFF) << 8)
        self._h = self._lib.h264tpu_create(flags)
        self._workers = []

    def close(self) -> None:
        if self._h:
            self.pool_stop()
            self._lib.h264tpu_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def decode(self, data, pic_id: int = 0, offset: int = 0,
               length: int | None = None) -> tuple[int, int]:
        """Decode one NAL unit starting at `offset`; returns
        (status, bytes_consumed). bytes and bytearray inputs are passed
        zero-copy (the C++ side never modifies the input, unlike the
        reference's in-place EPB strip); `offset`/`length` avoid slicing
        large streaming buffers per NAL."""
        read = ct.c_uint32(0)
        n = (len(data) - offset) if length is None else length
        if isinstance(data, bytes):
            ptr = ct.c_void_p(ct.cast(data, ct.c_void_p).value + offset)
            status = self._lib.h264tpu_decode(self._h, ptr, n, pic_id,
                                              ct.byref(read))
        else:
            buf = (ct.c_ubyte * n).from_buffer(data, offset)
            try:
                status = self._lib.h264tpu_decode(self._h, buf, n, pic_id,
                                                  ct.byref(read))
            finally:
                del buf   # release the buffer export before the caller
                          # resizes the underlying bytearray
        return status, read.value

    def tensor(self, name: str, n_mbs: int) -> np.ndarray:
        """Copy of a per-frame tensor shaped (n_mbs, *per_mb_shape).
        The residual tensors are synthesized from the sparse stream (the
        C++ side no longer materializes the dense 6 MB coefficient array
        on the hot path)."""
        if name in ("coeff", "luma_dc", "chroma_dc"):
            ids, levels = self.sparse_residual()
            dense = np.zeros((n_mbs * 26 + 1, 16), np.int16)
            dense[ids] = levels
            dense = dense[:n_mbs * 26].reshape(n_mbs, 26, 16)
            if name == "coeff":
                return dense[:, :24].copy()
            if name == "luma_dc":
                return dense[:, 24].copy()
            return dense[:, 25, :8].copy()
        tid, dtype, shape = _TENSORS[name]
        size = ct.c_uint64(0)
        ptr = self._c("tensor")(self._h, tid, ct.byref(size))
        count = size.value // np.dtype(dtype).itemsize
        buf = (ct.c_char * size.value).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype, count=count).copy()
        return arr.reshape((n_mbs,) + shape)

    def tensors(self, n_mbs: int) -> dict:
        return {name: self.tensor(name, n_mbs) for name in _TENSORS}

    def _raw(self, tid, dtype):
        size = ct.c_uint64(0)
        ptr = self._c("tensor")(self._h, tid, ct.byref(size))
        if size.value == 0:
            return np.zeros(0, dtype)
        buf = (ct.c_char * size.value).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).copy()

    def packed_meta(self) -> np.ndarray:
        """Single-buffer per-MB metadata (layout: FrameTensors::build_packed
        in mbparse.cpp). Also refreshes the intra-MB list."""
        size = ct.c_uint64(0)
        ptr = self._c("packed")(self._h, ct.byref(size))
        _count_builds()
        buf = (ct.c_char * size.value).from_address(ptr)
        return np.frombuffer(buf, dtype=np.uint8).copy()

    def sparse_residual(self):
        """(ids u32[N], levels i16[N,16]) non-empty residual blocks."""
        ids = self._raw(22, np.uint32)
        levels = self._raw(23, np.int16).reshape(-1, 16)
        return ids, levels

    def intra_list(self) -> np.ndarray:
        """Raster-ordered intra MB indices (valid after packed_meta())."""
        return self._raw(25, np.uint32)

    def slice_table(self) -> np.ndarray:
        return self._raw(26, np.int8).reshape(-1, 4)

    def mv_exceptions(self):
        """(ids u32[N] = mb*4 + quadrant, payload u8[N,16]: 4 packed u32
        blocks of that 8x8 quadrant, x13 | y13<<13 | (ref+1)<<26)."""
        ids = self._raw(27, np.uint32)
        payload = self._raw(28, np.uint8).reshape(-1, 16)
        return ids, payload

    def intra_payload(self) -> np.ndarray:
        """u8[K,32]: i4 modes[16] + avail[16] per intra_list entry."""
        return self._raw(29, np.uint8).reshape(-1, 32)

    def take_sei(self):
        """Oldest captured SEI RBSP payload (bytes) or None. The C++
        front-end queues each SEI NAL's payload (the reference skips the
        NAL entirely, decoder.c:464-466); decode the messages with
        frontend.sei.parse_sei_rbsp."""
        size = ct.c_uint64(0)
        ptr = self._lib.h264tpu_take_sei(self._h, ct.byref(size))
        if not ptr:
            return None
        return bytes((ct.c_char * size.value).from_address(ptr))

    def sps_hrd(self, sps_id: int):
        """HRD/pic-timing fields of a stored SPS (for SEI decoding), or
        None if that SPS was never seen."""
        out = np.zeros(16, np.uint32)
        if not self._lib.h264tpu_sps_hrd(self._h, sps_id, out):
            return None
        keys = ["vui_present", "nal_hrd_present", "vcl_hrd_present",
                "nal_cpb_cnt", "vcl_cpb_cnt", "nal_initial_len",
                "vcl_initial_len", "cpb_removal_delay_length",
                "dpb_output_delay_length", "time_offset_length",
                "pic_struct_present", "timing_info_present",
                "num_units_in_tick", "time_scale", "low_delay_hrd"]
        return dict(zip(keys, out[:15].tolist()))

    def flush_buffer(self):
        """Drain the DPB into the output queue (h264bsdFlushBuffer,
        reference decoder.c:834)."""
        self._lib.h264tpu_flush_buffer(self._h)

    def valid_param_sets(self) -> bool:
        """True when at least one stored SPS/PPS combination is valid
        (h264bsdCheckValidParamSets, reference decoder.h:82 ->
        h264bsdValidParamSets storage.c:863-885)."""
        return bool(self._lib.h264tpu_valid_param_sets(self._h))

    def peek_idr_boundary(self, nal: bytes) -> int:
        """Peek whether an IDR slice NAL begins a new primary picture:
        1 = yes (first_mb_in_slice == 0 and redundant_pic_cnt == 0), 0 =
        no, -1 = undecidable (unknown PPS/SPS or not an IDR slice). The
        referenced SPS/PPS must have been fed to decode() first
        (reference CheckRedundantPicCnt slice_header.c:1239)."""
        return int(self._lib.h264tpu_peek_idr_boundary(
            self._h, nal, len(nal)))

    def next_output(self):
        out = np.zeros(4, np.int32)
        if not self._lib.h264tpu_next_output(self._h, out):
            return None
        return {"slot": int(out[0]), "pic_id": int(out[1]),
                "is_idr": int(out[2]), "num_err_mbs": int(out[3])}

    # -- pool mode (Decoder::start_pool, csrc/decoder.h) ---------------------

    def pool_start(self, workers: int) -> None:
        """Parse pictures in parallel from here on, on `workers` threads:
        decode() holds a picture's first slice and returns PIC_RDY (with
        the NAL to decode again) when a picture has ended; its slice data,
        concealment and packed records run on a worker meanwhile, each
        job under an h264.parse span. Take the ended pictures in decode
        order with pool_take. Call before the first NAL."""
        from ..utils.profiling import span

        L, h = self._lib, self._h
        L.h264tpu_pool_start(h)

        def work():
            while pic := L.h264tpu_pool_next_job(h):
                with span("h264.parse"):
                    L.h264tpu_pool_run_job(h, pic)

        self._workers = [threading.Thread(target=work, daemon=True,
                                          name=f"h264-parse-{i}")
                         for i in range(workers)]
        for t in self._workers:
            t.start()

    def pool_stop(self) -> None:
        """Stop the pool's workers (each finishes the job it runs)."""
        if self._workers:
            self._lib.h264tpu_pool_stop(self._h)
            for t in self._workers:
                t.join()
            self._workers = []

    def pool_poll(self) -> tuple[int, bool, int]:
        """(ended pictures not yet taken, whether the oldest one's job is
        done, output pictures queued so far: the pic_id the serial
        decode loop would pass)."""
        out = np.zeros(3, np.uint32)
        self._lib.h264tpu_pool_poll(self._h, out)
        return int(out[0]), bool(out[1]), int(out[2])

    def pool_take(self) -> "PooledPicture | None":
        """The oldest ended picture, once its job is done (blocks), or
        None when none has ended."""
        pic = self._lib.h264tpu_pool_take(self._h)
        if not pic:
            return None
        pooled = bool(self._lib.h264tpu_picture_pooled(pic))
        STATS["pictures_pooled" if pooled else "pictures_serial"] += 1
        return PooledPicture(self, pic, pooled)

    def pool_finish(self) -> None:
        """At the stream's end: a held slice is parsed, and its picture
        ends (and is queued) if the slice completed it."""
        self._lib.h264tpu_pool_finish(self._h)


class PooledPicture(_Reads):
    """One picture taken from a pooled FrontendDecoder: the reads
    Decoder._prepare makes of a decoder instance's current picture
    (stream_info as the picture ended, pic_info, take_non_existing,
    blob_counts, blob_compact, ipcm), identical to the serial
    front-end's, and the output pictures the DPB queued as it ended.
    release() hands it back."""

    _PREFIX = "h264tpu_picture_"

    def __init__(self, fe: FrontendDecoder, handle, pooled: bool):
        self._lib = fe._lib
        self._fe_h = fe._h
        self._h = handle
        self.pooled = pooled      # its slice data ran on the pool

    def outputs(self) -> list[dict]:
        """Display-order output pictures queued when the picture ended
        (what next_output() drains after a serial PIC_RDY)."""
        out = np.zeros((64, 4), np.int32)
        n = self._lib.h264tpu_picture_outputs(self._h, out.reshape(-1), 64)
        if n > 64:
            out = np.zeros((n, 4), np.int32)
            self._lib.h264tpu_picture_outputs(self._h, out.reshape(-1), n)
        return [{"slot": int(o[0]), "pic_id": int(o[1]),
                 "is_idr": int(o[2]), "num_err_mbs": int(o[3])}
                for o in out[:n]]

    def release(self) -> None:
        self._lib.h264tpu_pool_release(self._fe_h, self._h)
        self._h = None

