"""The PyTorch port's decoder on P streams, on the CPU, against the JAX
package: byte-identical pictures with motion compensation (one to six
references, long-term references, frame_num gaps, intra MBs in P
pictures, I_PCM, slice groups, deblocking controls, redundant slices,
a redundant slice in place of a lost primary one, real motion) and on
the two partial-loss paths: the spiral concealment on the host and the
copy from a reference on the device."""

import pytest

from h264bsd_tpu.models import decoder as jdec
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.models import decoder as tdec
from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream
from h264bsd_tpu_torch.utils.recorded import drop_nal

# frame dicts of tests/test_conformance_streams.py MULTIREF_CASES
MULTIREF = {
    "six_ref_cycle": dict(num_ref_frames=6, frames=[
        dict(idr=True, frame_num=0, dc=4),
        dict(frame_num=1, dc=5),
        dict(frame_num=2, dc=-3),
        dict(frame_num=3, dc=6),
        dict(frame_num=4, dc=-4),
        dict(frame_num=5, dc=7),
        dict(frame_num=6, n_active=6, ref_cycle=6, dc=-5),
    ]),
    "frame_num_gap": dict(gaps_allowed=True, num_ref_frames=2, frames=[
        dict(idr=True, frame_num=0, dc=4),
        dict(frame_num=1, dc=5),
        dict(frame_num=3, n_active=2, ref_idx=1, dc=-3),
        dict(frame_num=4, n_active=2, ref_idx=0, dc=6),
    ]),
    "longterm": dict(num_ref_frames=3, frames=[
        dict(idr=True, frame_num=0, dc=4),
        dict(frame_num=1, mmco=[(4, 1), (3, 0, 0)], dc=5),
        dict(frame_num=2, dc=-3),
        dict(frame_num=3, n_active=3, ref_idx=2, dc=6),
        dict(frame_num=4, reorder=[(2, 0)], dc=-6),
    ]),
}

STREAMS = {
    "ippp": lambda: streamgen.make_ippp_stream(4, 4, 4),
    **{name: (lambda kw=kw: streamgen.make_multiref_stream(**kw))
       for name, kw in MULTIREF.items()},
    "intra_in_p": lambda: streamgen.make_intra_in_p_stream(False),
    "intra_in_p_constrained": lambda: streamgen.make_intra_in_p_stream(True),
    "pcm": streamgen.make_pcm_stream,
    "deblock_control": streamgen.make_deblock_control_stream,
    "slice_groups": lambda: streamgen.make_conformance_stream(
        num_slice_groups=2),
    "redundant": lambda: streamgen.make_redundant_stream(False),
    # the primary slice of MBs 0-7 lost, the redundant slice in its place
    "redundant_lost": lambda: streamgen.make_redundant_stream(True),
    "motion": lambda: make_motion_stream(6, 4, 4, seed=0),
}


def _assert_same_pictures(data):
    want = [p.yuv_bytes() for p in jdec.decode_stream(data)]
    assert len(want) > 1
    # every picture is collected before any is read: a picture must not
    # change when a later frame reuses its ring slot
    for pipelined in (True, False):
        pics = list(tdec.decode_stream(data, pipelined=pipelined,
                                       device="cpu"))
        got = [p.yuv_bytes() for p in pics]
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"picture {k} (pipelined={pipelined})"
    return pics


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_p_stream_matches_jax(name):
    pics = _assert_same_pictures(STREAMS[name]())
    assert all(p.num_err_mbs == 0 for p in pics)


@pytest.mark.parametrize("lost,errs", [
    # the IDR's second slice: a partial I loss with no reference, the
    # exact spiral concealment on the host
    (3, [8, 0, 0, 0]),
    # the first P picture's second slice: a partial P loss with a
    # reference, the co-located copy on the device
    (5, [0, 8, 0, 0])])
def test_partial_loss_matches_jax(lost, errs):
    data = drop_nal(streamgen.make_conformance_stream(slices_per_frame=2),
                    lost)
    pics = _assert_same_pictures(data)
    assert [p.num_err_mbs for p in pics] == errs
