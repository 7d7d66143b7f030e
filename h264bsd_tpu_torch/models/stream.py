"""Streaming decoder session: the analogue of the reference's JS/wasm
wrapper classes (reference wasm/h264bsd_decoder.js H264bsdDecoder
queueInput/decode/nextOutputPicture* and wasm/h264bsd_worker.js's
'pictureReady'/'pictureParams'/'noInput'/'decoderReady' event protocol),
as the JAX package's models/stream.py has it.

Feed arbitrary byte chunks with queue_input(); pictures and header events
are delivered through callbacks. Pictures hand out device tensors
directly (their planes copied out of the DPB ring).

The session delimits Annex-B NAL units itself and only feeds complete ones
to the decoder. The reference passes whatever is buffered, so a chunk
boundary inside a slice makes the C decoder treat buffer-end as NAL-end
and decode a truncated slice (the worker then halts on the resulting
decodeError, h264bsd_worker.js:70-77). Here the trailing partial NAL
waits for the next chunk; pass final=True with the last chunk (or call
end_of_stream()) to flush it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .decoder import ERROR, HDRS_RDY, PIC_RDY, Decoder, OutputPicture

NO_INPUT = 1024  # reference wasm/h264bsd_decoder.js:68


@dataclass
class StreamingDecoder:
    """Push-based session: queue_input() then pump(). Decodes on `device`
    (see models.decoder.Decoder)."""

    on_picture_ready: Optional[Callable[[OutputPicture], None]] = None
    on_headers_ready: Optional[Callable[[dict], None]] = None
    on_error: Optional[Callable[[int, int], None]] = None
    device: object = None
    _dec: Decoder = None
    _buf: bytearray = field(default_factory=bytearray)
    _pos: int = 0
    _limit: int = 0     # bytes [.._limit) hold only complete NAL units
    _final: bool = False
    _n_pics: int = 0

    def __post_init__(self):
        if self._dec is None:
            self._dec = Decoder(device=self.device)

    def queue_input(self, data: bytes = b"", final: bool = False) -> None:
        # drop the consumed prefix lazily to keep the buffer bounded
        if self._pos > 1 << 20:
            del self._buf[:self._pos]
            self._limit -= self._pos
            self._pos = 0
        self._buf.extend(data)
        if final:
            self._final = True
        if self._final:
            self._limit = len(self._buf)
            return
        # expose bytes only up to the start of the last (possibly still
        # incomplete) NAL unit: find the final Annex-B start code
        idx = self._buf.rfind(b"\x00\x00\x01", self._limit)
        if idx > self._pos:
            while idx > self._pos and self._buf[idx - 1] == 0:
                idx -= 1    # 00 00 00 01 form: keep the zero with the NAL
            self._limit = max(self._limit, idx)

    def end_of_stream(self) -> None:
        """No further input: release the trailing NAL for decode."""
        self.queue_input(b"", final=True)

    def decode(self) -> int:
        """Decode one NAL unit (reference decode() one-NAL-per-call
        contract). Returns the decoder status or NO_INPUT."""
        if self._pos >= self._limit:
            return NO_INPUT
        status, read = self._dec.decode(self._buf, pic_id=self._n_pics,
                                        offset=self._pos,
                                        length=self._limit - self._pos)
        self._pos += read
        if status == HDRS_RDY and self.on_headers_ready:
            self.on_headers_ready(self.picture_params())
        elif status == PIC_RDY:
            while (pic := self._dec.next_output_picture()) is not None:
                self._n_pics += 1
                if self.on_picture_ready:
                    self.on_picture_ready(pic)
        elif status >= ERROR:
            if self.on_error:
                self.on_error(status, self._pos)
            if read == 0:
                return NO_INPUT  # cannot make progress without new input
        return status

    def pump(self) -> int:
        """Decode until input is exhausted (worker 'queueInput' handler
        loop, reference h264bsd_worker.js:26-53). Returns pictures emitted."""
        before = self._n_pics
        while self.decode() != NO_INPUT:
            pass
        return self._n_pics - before

    def picture_params(self) -> dict:
        crop = self._dec.cropping_params()
        sar = self._dec.sample_aspect_ratio()
        return {
            "width": self._dec.pic_width(),
            "height": self._dec.pic_height(),
            "croppingParams": {
                "width": crop[2], "height": crop[4],
                "left": crop[1], "top": crop[3],
            } if crop[0] else None,
            "sar": sar,
            "profile": self._dec.profile(),
            "fullRange": self._dec.video_full_range(),
        }
