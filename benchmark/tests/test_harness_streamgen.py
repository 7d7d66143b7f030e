"""The frozen generator writes the port generator's bytes."""

import pytest

import streamgen
from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream


@pytest.mark.parametrize("w,h,n,seed,qp", [
    (4, 4, 16, 1, 26), (6, 5, 16, 123456789012, 22), (3, 3, 20, 7, 34),
    (40, 23, 3, 2 ** 62 - 1, 30), (2, 9, 17, 0, 26)])
def test_frozen_generator_writes_the_ports_bytes(w, h, n, seed, qp):
    data, pics = streamgen.make_motion_gop(w, h, n, seed, qp)
    assert data == make_motion_stream(w, h, n, seed=seed, qp=qp)
    assert len(pics) == n and pics[0].idr
    assert all(p.qp == qp for p in pics)


def test_bit_writer_packs_as_the_ports():
    from h264bsd_tpu_torch.utils.streamgen import BitWriter
    a, b = streamgen.BitWriter(), BitWriter()
    for v, n in [(5, 3), (0, 0), (1, 1), (123456, 17), (0, 9), (7, 70)]:
        a.u(v, n)
        b.u(v, n)
    for v in (0, 1, 2, 300, 70000):
        a.ue(v).se(-v)
        b.ue(v).se(-v)
    assert a.rbsp_trailing().bytes_rbsp() == b.rbsp_trailing().bytes_rbsp()


def test_emulation_prevention_as_the_ports():
    from h264bsd_tpu_torch.utils.streamgen import _ebsp
    for raw in (b"\x00\x00\x00\x00\x01", b"\x00\x00\x03\x00\x00\x02\x04",
                b"\x01\x00\x00", b"\x00\x00\x00\x00\x00\x00"):
        assert streamgen._ebsp(raw) == _ebsp(raw)
