"""SEI decoding and the streaming session of the PyTorch port, on the CPU,
against the JAX package: parse_sei_rbsp on hand-built SEI RBSPs,
Decoder.take_sei_messages on a stream with SEI NAL units, and
StreamingDecoder over random chunkings byte-identical to JAX
decode_stream."""

import random

import pytest

from h264bsd_tpu.frontend import sei as jsei
from h264bsd_tpu.models import decoder as jdec
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.frontend import sei as tsei
from h264bsd_tpu_torch.models import decoder as tdec
from h264bsd_tpu_torch.models.stream import NO_INPUT, StreamingDecoder
from h264bsd_tpu_torch.utils.sei_stream import make_sei_stream


class BitWriter:
    def __init__(self):
        self.bits = []

    def u(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def ue(self, v):
        k = v + 1
        n = k.bit_length()
        self.u(0, n - 1)
        self.u(k, n)

    def payload_bytes(self):
        bits = self.bits[:]
        if len(bits) % 8:
            # payloads are byte-aligned with stop-bit padding
            bits.append(1)
            while len(bits) % 8:
                bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def sei_rbsp(*messages):
    """messages: (payload_type, payload_bytes) -> RBSP with framing +
    trailing bits."""
    out = bytearray()
    for ptype, payload in messages:
        while ptype >= 255:
            out.append(255)
            ptype -= 255
        out.append(ptype)
        size = len(payload)
        while size >= 255:
            out.append(255)
            size -= 255
        out.append(size)
        out.extend(payload)
    out.append(0x80)  # rbsp trailing bits
    return bytes(out)


def _recovery_point():
    w = BitWriter()
    w.ue(12)          # recovery_frame_cnt
    w.u(1, 1)         # exact_match
    w.u(0, 1)         # broken_link
    w.u(2, 2)         # changing_slice_group_idc
    return w.payload_bytes()


def _pan_scan():
    w = BitWriter()
    w.ue(3)           # pan_scan_rect_id
    w.u(0, 1)         # cancel
    w.ue(0)           # cnt-1 -> 1 rect
    for off in (-2, 2, -4, 4):
        # se(v): positive v -> code 2v-1, non-positive -> -2v
        w.ue(2 * off - 1 if off > 0 else -2 * off)
    w.ue(1)           # repetition period
    return w.payload_bytes()


def _scene_info():
    w = BitWriter()
    w.u(1, 1)         # scene_info_present
    w.ue(7)           # scene_id
    w.ue(0)           # transition type
    return w.payload_bytes()


def _buffering_period():
    w = BitWriter()
    w.ue(0)           # seq_parameter_set_id; no HRD known: header only
    return w.payload_bytes()


RBSPS = {
    "recovery_point_and_user_data": sei_rbsp(
        (6, _recovery_point()), (5, bytes(range(16)) + b"hello-sei")),
    "pan_scan_and_scene_info": sei_rbsp((2, _pan_scan()),
                                        (9, _scene_info())),
    "unknown_type": sei_rbsp((200, b"\x01\x02\x03")),
    "long_type_and_size": sei_rbsp((300, bytes(300))),
    "buffering_period": sei_rbsp((0, _buffering_period())),
}


def _fields(msgs):
    return [(m.payload_type, m.name, m.payload, m.fields) for m in msgs]


@pytest.mark.parametrize("name", sorted(RBSPS))
def test_parse_sei_rbsp_matches_jax(name):
    got = tsei.parse_sei_rbsp(RBSPS[name])
    want = jsei.parse_sei_rbsp(RBSPS[name])
    assert got and _fields(got) == _fields(want)


def _decode_with_sei(mod, data, **kw):
    """Pictures and SEI messages of a NAL-by-NAL Decoder loop."""
    dec = mod.Decoder(**kw)
    pics, msgs = [], []
    pos = 0
    while pos < len(data):
        status, read = dec.decode(data[pos:], len(pics))
        pos += read
        if status == mod.PIC_RDY:
            while (pic := dec.next_output_picture()) is not None:
                pics.append(pic.yuv_bytes())
        msgs += dec.take_sei_messages()
        if status >= mod.ERROR and read == 0:
            break
    return pics, msgs


def test_take_sei_messages_matches_jax():
    data = make_sei_stream(4, 4, 6)
    got_pics, got = _decode_with_sei(tdec, data, device="cpu")
    want_pics, want = _decode_with_sei(jdec, data)
    assert len(got) == 7
    assert _fields(got) == _fields(want)
    assert got_pics == want_pics and len(got_pics) == 6


_WANT: dict = {}


def _stream():
    """A 6-frame IPPP stream and the JAX package's pictures of it."""
    if not _WANT:
        data = streamgen.make_ippp_stream(4, 4, 6)
        _WANT["data"] = data
        _WANT["pics"] = [p.yuv_bytes() for p in jdec.decode_stream(data)]
    return _WANT["data"], _WANT["pics"]


@pytest.mark.parametrize("chunking", ["whole", "97", "random3", "random7"])
def test_streaming_decoder_matches_jax(chunking):
    data, want = _stream()
    if chunking == "whole":
        chunks = [data]
    elif chunking.startswith("random"):
        rng = random.Random(int(chunking[6:]))
        cuts = sorted(rng.sample(range(1, len(data)), 40))
        chunks = [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]
    else:
        n = int(chunking)
        chunks = [data[i:i + n] for i in range(0, len(data), n)]
    pics, headers = [], []
    sd = StreamingDecoder(on_picture_ready=pics.append,
                          on_headers_ready=headers.append, device="cpu")
    for c in chunks:
        sd.queue_input(c)
        sd.pump()
    sd.end_of_stream()
    sd.pump()
    assert [p.yuv_bytes() for p in pics] == want
    assert headers and headers[0]["width"] == 64


def test_no_input_without_complete_nal():
    data, _ = _stream()
    sd = StreamingDecoder(device="cpu")
    sd.queue_input(data[:5])        # inside the SPS
    assert sd.decode() == NO_INPUT   # incomplete NAL stays buffered
    sd.queue_input(data[5:])
    assert sd.pump() > 0
