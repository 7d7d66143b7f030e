"""A streamgen IPPP stream with SEI NAL units in front of its pictures:
test data for Decoder.take_sei_messages and for decoding past SEI NAL
units, which the reference skips (decoder.c:464-466).

Each picture's slice is preceded by one SEI NAL unit whose messages cycle
through recovery point, unregistered user data, pan-scan rectangle, scene
information and a reserved payload type (kept raw by the parser); the
first one carries two messages. Everything is a function of the picture
index, so the bytes are the same on every call.
"""

from __future__ import annotations

from .streamgen import BitWriter, _ebsp, make_ippp_stream

SEI_NAL_HEADER = 0x06          # nal_ref_idc 0, nal_unit_type 6


def _payload(w: BitWriter) -> bytes:
    """The written bits as a byte-aligned payload (stop-bit padding)."""
    if len(w.bits) % 8:
        w.rbsp_trailing()
    return w.bytes_rbsp()


def _recovery_point(k):
    w = BitWriter().ue(k).u(1, 1).u(0, 1).u(k % 3, 2)
    return 6, _payload(w)


def _user_data(k):
    uuid = bytes((17 * i + k) % 256 for i in range(16))
    return 5, uuid + f"picture {k}".encode()


def _pan_scan(k):
    w = BitWriter().ue(k).u(0, 1).ue(0)
    for off in (-k, k, 2 - k, k + 2):
        w.se(off)
    return 2, _payload(w.ue(1))


def _scene_info(k):
    return 9, _payload(BitWriter().u(1, 1).ue(k).ue(k % 4))


def _reserved(k):
    return 200, bytes([k % 256, 1, 2])


MESSAGES = (_recovery_point, _user_data, _pan_scan, _scene_info, _reserved)


def sei_nal(messages) -> bytes:
    """An Annex-B SEI NAL unit carrying (payload_type, payload) pairs."""
    out = bytearray()
    for ptype, payload in messages:
        for v in (ptype, len(payload)):
            while v >= 255:
                out.append(255)
                v -= 255
            out.append(v)
        out.extend(payload)
    out.append(0x80)                       # rbsp trailing bits
    return b"\x00\x00\x00\x01" + bytes([SEI_NAL_HEADER]) + _ebsp(bytes(out))


def make_sei_stream(width_mbs: int = 4, height_mbs: int = 4,
                    n_frames: int = 4) -> bytes:
    """make_ippp_stream(width_mbs, height_mbs, n_frames) with an SEI NAL
    unit before every picture's slice."""
    data = make_ippp_stream(width_mbs, height_mbs, n_frames)
    starts = []
    at = data.find(b"\x00\x00\x00\x01")
    while at >= 0:
        starts.append(at)
        at = data.find(b"\x00\x00\x00\x01", at + 4)
    out = bytearray()
    k = 0
    for a, b in zip(starts, starts[1:] + [len(data)]):
        if data[a + 4] & 0x1F in (1, 5):          # a slice: one per picture
            msgs = [MESSAGES[k % len(MESSAGES)](k)]
            if k == 0:
                msgs.append(_user_data(k))
            out += sei_nal(msgs)
            k += 1
        out += data[a:b]
    return bytes(out)
