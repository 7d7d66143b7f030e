"""The PyTorch port's frame-pipelined decode (h264bsd_tpu_torch/parallel/
framepipe.py), on the CPU, against the JAX package, with zero tolerance:
a GOP-less IPPP stream whose frames are round-robined over 2 and 4
positions, every P frame predicting from pictures another position
decoded and handed over; and a stream whose first slice is corrupted so
that its picture needs the exact spiral concealment, which the pipeline
evicts (tests/test_framepipe.py's construction). Corrupted streams are
held through the port's decode_stream too: the evicted picture's, and a
slice cut in the middle (the picture concealed from its reference)."""

import pytest

from h264bsd_tpu.models.decoder import decode_stream as j_decode_stream
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models.decoder import decode_stream
from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
from h264bsd_tpu_torch.parallel.framepipe import decode_stream_framepipe
from h264bsd_tpu_torch.parallel.gop import _nal_positions, split_gops
from h264bsd_tpu_torch.parallel.mesh import Mesh


def _jax_frames(data):
    return [p.yuv_bytes() for p in j_decode_stream(data, pipelined=False)]


def _framepipe(data, n_dev):
    return [p.yuv_bytes() for p in decode_stream_framepipe(
        data, Mesh(["cpu"] * n_dev, ("pipe",)), "pipe")]


@pytest.fixture(scope="module")
def ippp():
    data = streamgen.make_ippp_stream(4, 4, 6)
    return data, _jax_frames(data)


def _corrupt_first_slice(data):
    """The stream with a byte of its first slice NAL flipped at 80% of
    the slice: enough MBs decode that the loss is partial, and the
    picture (a non-IDR I picture, the stream's first) has no reference
    to conceal from."""
    data = bytearray(data)
    nals = _nal_positions(bytes(data))
    slices = [n for n in nals if n[2] in (1, 5)]
    k = nals.index(slices[0])
    end = nals[k + 1][1] if k + 1 < len(nals) else len(data)
    payload = slices[0][0]
    data[payload + int((end - payload) * 0.8)] ^= 0xFF
    return bytes(data)


def _has_partial_loss_without_reference(data, n_mbs):
    d = fe.FrontendDecoder()
    pos, hit = 0, False
    while pos < len(data):
        status, read = d.decode(data, 0, pos)
        pos += read
        if status == fe.PIC_RDY:
            i = d.pic_info()
            n = i["num_concealed_mbs"]
            hit |= 0 < n < n_mbs and (not i["conceal_from_ref"]
                                      or i["conceal_ref_slot"] < 0)
            while d.next_output() is not None:
                pass
        elif status >= fe.ERROR and read == 0:
            break
    d.close()
    return hit


def test_ippp_stream_has_no_gop_split(ippp):
    data, frames = ippp
    assert len(split_gops(data)) == 1
    assert len(frames) == 6


@pytest.mark.parametrize("n_dev", [2, 4])
def test_framepipe_matches_jax(ippp, n_dev):
    data, want = ippp
    reset_stats()
    got = _framepipe(data, n_dev)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {k} differs across the hand-off"
    # on the CPU every frame runs the body eagerly on its owner
    assert STATS["eager_frames"] == len(want)


@pytest.fixture(scope="module")
def corrupt():
    data = _corrupt_first_slice(streamgen.make_ippp_stream(4, 4, 6))
    return data, _jax_frames(data)


def test_corruption_hits_the_eviction_case(corrupt):
    data, want = corrupt
    assert _has_partial_loss_without_reference(data, 16)
    assert want, "the corrupted stream still decodes"


@pytest.mark.parametrize("n_dev", [2, 4])
def test_framepipe_evicts_and_conceals_like_jax(corrupt, n_dev):
    data, want = corrupt
    got = _framepipe(data, n_dev)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {k} differs after the eviction"


@pytest.mark.parametrize("pipelined", [True, False])
def test_corrupt_first_slice_decodes_like_jax(corrupt, pipelined):
    data, want = corrupt
    got = [p.yuv_bytes() for p in decode_stream(data, pipelined=pipelined,
                                                device="cpu")]
    assert got == want


@pytest.fixture(scope="module")
def cut():
    """The third picture's slice cut in the middle (its second half lost,
    a truncated packet), the stream going on after it."""
    data = streamgen.make_ippp_stream(4, 4, 5)
    nals = _nal_positions(data)
    k = [i for i, n in enumerate(nals) if n[2] in (1, 5)][2]
    payload, end = nals[k][0], nals[k + 1][1]
    data = data[:payload + (end - payload) // 2] + data[end:]
    return data, _jax_frames(data)


@pytest.mark.parametrize("pipelined", [True, False])
def test_slice_cut_mid_way_decodes_like_jax(cut, pipelined):
    data, want = cut
    pics = list(decode_stream(data, pipelined=pipelined, device="cpu"))
    assert [p.yuv_bytes() for p in pics] == want
    assert [p.num_err_mbs for p in pics] == [0, 0, 16, 0, 0]
