"""GOP-parallel decoding: the counterpart of the JAX package's
parallel/gop.py (_nal_positions :35, _first_mb_is_zero :52, split_gops
:60, _decode_segment :112, decode_stream_gop_parallel :133).

An IDR picture resets the DPB (reference decoder.c:343-389), so closed
GOPs (IDR .. next IDR) decode independently. split_gops cuts the stream
on the host at IDR *picture* boundaries (a NAL scan and the front-end's
header peek: a multi-slice IDR picture and a redundant IDR copy stay in
one segment) and prefixes every later segment with the stream's leading
parameter sets.

decode_stream_gop_parallel decodes the segments on worker threads (the
C++ front-end releases the GIL, and the device work of each thread goes
to its own CUDA stream) and yields the pictures in stream order. Worker w
keeps one Decoder on devices[w % len(devices)] and takes the segments in
stream order, each from a fresh front-end (Decoder.restart): the JAX
package's decoders share one compiled program per shape, while a port
decoder's CUDA graphs are bound to its ring, so a decoder per segment
would capture every graph key again (37-73 ms each). The worker's
decoder keeps its ring, zeroed at each segment start as a new decoder's
is, and its graphs while the geometry and slot count match.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future

import torch

from ..device import resolve_device
from ..frontend import binding as fe
from ..models.decoder import ERROR, PIC_RDY, Decoder


def _nal_positions(data: bytes):
    """(payload_offset, start_offset, nal_type) for every Annex-B start
    code; start_offset includes the zero bytes of 3- and 4-byte start
    codes (h264bsdExtractNalUnit byte_stream.c:108-129 skips any number
    of leading zeros)."""
    out = []
    pos = 0
    while (pos := data.find(b"\x00\x00\x01", pos)) != -1:
        start = pos
        while start > 0 and data[start - 1] == 0:
            start -= 1
        if pos + 3 < len(data):
            out.append((pos + 3, start, data[pos + 3] & 0x1F))
        pos += 3
    return out


def _first_mb_is_zero(data: bytes, payload_off: int) -> bool:
    """True when the slice NAL at payload_off has first_mb_in_slice == 0:
    ue(v) == 0 is the single bit '1', so the first slice-header bit (MSB
    of the byte after the one-byte NAL header) decides."""
    hdr = payload_off + 1
    return hdr < len(data) and (data[hdr] & 0x80) != 0


def split_gops(data: bytes):
    """Split an Annex-B stream into independently decodable segments:
    [param sets + GOP] per IDR picture. Returns a list of byte strings.

    An IDR slice opens a segment only when it starts a new access unit
    (first_mb_in_slice == 0, storage.c:593) and is a primary coded
    picture (redundant_pic_cnt == 0, CheckRedundantPicCnt
    slice_header.c:1239), decided by the front-end's exact header peek
    with the SPS/PPS seen so far; when the peek cannot decide (the slice
    names a PPS the stream never sent) the first header bit does."""
    nals = _nal_positions(data)
    peek = fe.FrontendDecoder(no_output_reordering=True)
    idr_starts = []
    try:
        for i, (payload, start, t) in enumerate(nals):
            end = nals[i + 1][1] if i + 1 < len(nals) else len(data)
            if t in (7, 8):
                # feed the whole parameter set to the peek's registry: a
                # partial consume would drop it and leave the IDR peek to
                # the header-bit rule, blind to redundant IDR slices
                p = start
                while p < end:
                    _, read = peek.decode(data[p:end], 0)
                    if read == 0:
                        break
                    p += read
            elif t == 5:
                r = peek.peek_idr_boundary(data[start:end])
                opens = (r == 1) if r >= 0 else \
                    _first_mb_is_zero(data, payload)
                if opens:
                    idr_starts.append(start)
    finally:
        peek.close()
    if not idr_starts:
        return [data]
    # prefix: everything before the first IDR picture (SPS/PPS/SEI)
    header = data[:idr_starts[0]]
    segments = []
    for i, start in enumerate(idr_starts):
        end = idr_starts[i + 1] if i + 1 < len(idr_starts) else len(data)
        segments.append(header + data[start:end] if i > 0 else data[:end])
    return segments


def _decode_segment(seg: bytes, dec: Decoder):
    """Every picture of one segment, decoded by `dec` restarted as a fresh
    decoder (the JAX version's Decoder() per segment)."""
    dec.restart()
    pics = []
    pos = 0
    while pos < len(seg):
        status, read = dec.decode(seg, len(pics), pos)
        pos += read
        if status == PIC_RDY:
            while (pic := dec.next_output_picture()) is not None:
                pics.append(pic.detach())
        elif status >= ERROR and read == 0:
            break
    return pics


def _devices(devices):
    if devices is None:
        resolve_device(None)        # raises without a CUDA device
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def decode_stream_gop_parallel(data: bytes, devices=None, threads=None):
    """Decode the stream's GOPs concurrently across `devices` (every CUDA
    device when None; ["cpu"] runs the plain versions); yields the output
    pictures in stream order. `threads` workers (by default as many as
    the JAX version's pool: min(segments, max(2 * devices, 4))) take the
    segments in stream order, worker w on devices[w % len(devices)] (see
    the module docstring); each segment's pictures stream out as soon as
    it and the segments before it are done."""
    devices = _devices(devices)
    segments = split_gops(data)
    n_workers = min(len(segments),
                    threads or max(2 * len(devices), 4))
    results = [Future() for _ in segments]
    order = itertools.count()
    lock = threading.Lock()
    stop = threading.Event()

    decoders = [Decoder(device=devices[w % len(devices)])
                for w in range(n_workers)]

    def work(dec):
        stream = torch.cuda.Stream(dec.device) \
            if dec.device.type == "cuda" else None
        while not stop.is_set():
            with lock:
                i = next(order)
            if i >= len(segments):
                return
            try:
                if stream is None:
                    pics = _decode_segment(segments[i], dec)
                else:
                    with torch.cuda.device(dec.device), \
                            torch.cuda.stream(stream):
                        pics = _decode_segment(segments[i], dec)
                    # the pictures' planes are written on this worker's
                    # stream: done before another thread reads them
                    stream.synchronize()
                results[i].set_result(pics)
            except BaseException as exc:    # raised by the consumer
                results[i].set_exception(exc)
                stop.set()
                return

    workers = [threading.Thread(target=work, args=(dec,), daemon=True)
               for dec in decoders]
    for t in workers:
        t.start()
    try:
        for fut in results:
            yield from fut.result()
    finally:
        stop.set()
        for t in workers:
            t.join()
        for dec in decoders:
            dec.close()
