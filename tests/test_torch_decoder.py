"""The PyTorch port's decoder, on the CPU, against the JAX package's:
byte-identical pictures on all-intra streams, the same colour
conversions and metadata, the slice's scope limits, and device
resolution."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.models import decoder as jdec
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.models import decoder as tdec

ROOT = Path(__file__).parents[1]


@pytest.mark.parametrize("maker,args", [
    ("make_intra_stress_stream", (6, 4, 3)), ("make_qp_sweep_stream", ()),
    ("make_lowqp_i_stream", ()), ("make_intra_stress_stream", (2, 4, 2))])
def test_decode_stream_matches_jax(maker, args):
    data = getattr(streamgen, maker)(*args)
    want = [p.yuv_bytes() for p in jdec.decode_stream(data)]
    # every picture is collected before any is read: a picture must not
    # change when a later frame reuses its ring slot
    pics = list(tdec.decode_stream(data, device="cpu"))
    got = [p.yuv_bytes() for p in pics]
    assert len(got) == len(want) > 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"picture {k}"
    unpipelined = [p.yuv_bytes() for p in
                   tdec.decode_stream(data, pipelined=False, device="cpu")]
    assert unpipelined == want


def _decode(mod, data, **kw):
    dec = mod.Decoder(**kw)
    pics = []
    pos = 0
    while pos < len(data):
        status, read = dec.decode(data, len(pics), pos)
        pos += read
        if status == mod.PIC_RDY:
            while (pic := dec.next_output_picture()) is not None:
                pics.append(pic)
        elif status >= mod.ERROR and read == 0:
            break
    return dec, pics


def test_conversions_and_metadata_match_jax():
    data = streamgen.make_intra_stress_stream(4, 3, 1)
    jd, (jpic,) = _decode(jdec, data)
    td, (tpic,) = _decode(tdec, data, device="cpu")
    for full_range in (False, True):
        np.testing.assert_array_equal(tpic.rgba(full_range),
                                      jpic.rgba(full_range))
        np.testing.assert_array_equal(tpic.bgra(full_range),
                                      jpic.bgra(full_range))
    np.testing.assert_array_equal(tpic.ycbcra(), jpic.ycbcra())
    for attr in ("pic_id", "is_idr", "num_err_mbs", "width", "height",
                 "crop", "full_range"):
        assert getattr(tpic, attr) == getattr(jpic, attr), attr
    for getter in ("pic_width", "pic_height", "cropping_params",
                   "sample_aspect_ratio", "profile", "matrix_coefficients",
                   "video_full_range", "check_valid_param_sets"):
        assert getattr(td, getter)() == getattr(jd, getter)(), getter
    jd.flush_buffer()
    td.flush_buffer()
    assert td.next_output_picture() is None
    assert jd.next_output_picture() is None


def _whole_i_loss_stream():
    """4x4-MB all-I stream whose third picture loses every MB (the JAX
    package's test_intra_concealment_flag_whole_i_loss corruption)."""
    base = streamgen.make_intra_stress_stream(4, 4, 4)
    p1 = base.find(b"\x00\x00\x01\x61")
    p2 = base.find(b"\x00\x00\x01\x61", p1 + 4)
    p3 = base.find(b"\x00\x00\x01\x61", p2 + 4)
    data = bytearray(base)
    at = p2 + (p3 - p2) // 4
    data[at] ^= 0x5A
    data[at + 1] ^= 0xC3
    return bytes(data), p2


@pytest.mark.parametrize("intra_concealment", [False, True])
def test_whole_picture_loss_concealment_matches_jax(intra_concealment):
    """Grey fill, or a copy of the reference slot, with both rings seeded
    by load_ring from the same random numpy planes just before the lost
    picture: the copy reads the seeded reference."""
    data, lost_at = _whole_i_loss_stream()
    outs = {}
    for mod, kw in ((jdec, {}), (tdec, {"device": "cpu"})):
        dec, pics = _decode(mod, data[:lost_at],
                            intra_concealment=intra_concealment, **kw)
        n, h, w = dec._dpb[0].shape
        rng = np.random.default_rng(3)
        ring = [rng.integers(0, 256, s, dtype=np.uint8)
                for s in ((n, h, w), (n, h // 2, w // 2),
                          (n, h // 2, w // 2))]
        if mod is tdec:
            dec.load_ring(*ring)
        else:
            dec._dpb = tuple(jnp.asarray(p) for p in ring)
        pos = lost_at
        while pos < len(data):
            status, read = dec.decode(data, len(pics), pos)
            pos += read
            if status == mod.PIC_RDY:
                while (pic := dec.next_output_picture()) is not None:
                    pics.append(pic)
        outs[mod] = [p.yuv_bytes() for p in pics]
    assert len(outs[tdec]) == len(outs[jdec]) == 4
    assert outs[tdec] == outs[jdec]


def test_p_pictures_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="motion compensation"):
        list(tdec.decode_stream(streamgen.make_ippp_stream(), device="cpu"))


def test_sei_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="SEI"):
        tdec.Decoder(device="cpu").take_sei_messages()


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.Decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        next(tdec.decode_stream(streamgen.make_lowqp_i_stream()))


RECORDED = ROOT / "h264bsd_tpu_torch" / "testdata" / "reference_checksums.json"


@pytest.mark.parametrize("name", ["lowqp_i", "intra_2x4"])
def test_recorded_checksums_hold_on_cpu(name):
    """The port's plain versions reproduce the recorded JAX checksums that
    chip_smoke.py holds the card to (small entries; the others decode in
    chip_smoke.py and in the slow re-recording test)."""
    from h264bsd_tpu_torch.utils import streamgen as port_streamgen
    e = json.loads(RECORDED.read_text())[name]
    data = getattr(port_streamgen, e["maker"])(*e["args"])
    assert hashlib.sha256(data).hexdigest() == e["sha256"]
    got = [tdec.frame_checksum_host(p.yuv_bytes())
           for p in tdec.decode_stream(data, device="cpu")]
    assert got == e["checksums"]


@pytest.mark.slow
def test_reference_checksums_rerecord():
    """tools/record_torch_port_checksums.py decodes every recorded stream
    with the JAX package again and finds the file unchanged."""
    res = subprocess.run(
        [sys.executable, "tools/record_torch_port_checksums.py", "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=3000)
    assert res.returncode == 0, res.stderr
