"""The PyTorch port's GOP-parallel decode (h264bsd_tpu_torch/parallel/
gop.py), on the CPU, against the JAX package, with zero tolerance:
split_gops cuts streamgen streams where the JAX package's does (a
four-slice IDR picture, a redundant IDR slice, 4-byte start codes, a
stream without IDR, a stream after itself), and
decode_stream_gop_parallel over two CPU positions gives the JAX
package's pictures of a three-GOP stream, each worker's decoder reused
from segment to segment. The JAX package decodes a concatenation of
closed-GOP streams as the concatenation of their decodes (what
chip_smoke.py's gop phase relies on). Launch counts stay exact with two
threads launching at once, one of them recording (a graph capture)."""

import sys
import threading

import pytest

from h264bsd_tpu.models.decoder import decode_stream as j_decode_stream
from h264bsd_tpu.parallel.gop import split_gops as j_split_gops
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.models.decoder import OutputPicture
from h264bsd_tpu_torch.ops import _kernels
from h264bsd_tpu_torch.parallel.gop import (decode_stream_gop_parallel,
                                            split_gops)
from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream


def _four_slice_idr():
    return streamgen.make_conformance_stream(8, 8, 3, slices_per_frame=4)


def _start_codes4():
    base = streamgen.make_conformance_stream(n_frames=2)
    return base.replace(b"\x00\x00\x01", b"\x00\x00\x00\x01")


SPLIT_STREAMS = {
    "four_slice_idr": _four_slice_idr,
    "four_slice_idr_twice": lambda: _four_slice_idr() * 2,
    "redundant_idr_twice": lambda: streamgen.make_redundant_stream(
        False) * 2,
    "start_codes4_twice": lambda: _start_codes4() * 2,
    "no_idr": lambda: streamgen.make_ippp_stream(4, 4, 4),
    "motion_6x4_twice": lambda: make_motion_stream(6, 4, 4, seed=0) * 2,
}


@pytest.mark.parametrize("name", sorted(SPLIT_STREAMS))
def test_split_gops_matches_jax(name):
    data = SPLIT_STREAMS[name]()
    got = split_gops(data)
    assert got == j_split_gops(data)
    if name.endswith("twice"):
        assert len(got) == 2
    else:
        assert len(got) == 1


# three closed GOPs of 4x4 MBs
PARTS = [make_motion_stream(4, 4, 3, seed=s) for s in (0, 1, 2)]


@pytest.fixture(scope="module")
def three_gops():
    data = b"".join(PARTS)
    return data, [p.yuv_bytes() for p in j_decode_stream(data,
                                                         pipelined=False)]


def test_jax_decodes_a_concatenation_as_its_parts(three_gops):
    _, want = three_gops
    parts = [p.yuv_bytes() for d in PARTS
             for p in j_decode_stream(d, pipelined=False)]
    assert want == parts


@pytest.mark.parametrize("threads", [1, 2, None])
def test_gop_parallel_matches_jax(three_gops, threads):
    data, want = three_gops
    assert len(split_gops(data)) == 3
    got = [p.yuv_bytes() for p in decode_stream_gop_parallel(
        data, devices=["cpu"] * 2, threads=threads)]
    assert got == want


def test_gop_parallel_stops_its_workers_when_the_consumer_stops(three_gops):
    data, want = three_gops
    before = threading.active_count()
    pics = decode_stream_gop_parallel(data, devices=["cpu"], threads=2)
    assert next(pics).yuv_bytes() == want[0]
    pics.close()                 # joins the workers
    assert threading.active_count() == before


def test_detach_returns_the_picture():
    pic = OutputPicture(0, True, 0, 16, 16, (0, 16, 0, 16), ())
    assert pic.detach() is pic


def test_launch_counts_stay_exact_across_threads():
    """Eight threads count 2000 launches each at the same time, four of
    them inside recording() (as a graph capture records them), with a
    short switch interval: LAUNCHES gains exactly the other four's, each
    record holds its own thread's."""
    _kernels.reset_launches()
    start = threading.Barrier(8)
    records = []

    def count(record):
        start.wait()
        for _ in range(2000):
            _kernels.count_launch("deblock_wf")
        if record is not None:
            records.append(dict(record))

    def recorder():
        with _kernels.recording() as rec:
            count(rec)

    threads = [threading.Thread(target=recorder) for _ in range(4)] + \
        [threading.Thread(target=count, args=(None,)) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _kernels.LAUNCHES["deblock_wf"] == 4 * 2000
    assert [r["deblock_wf"] for r in records] == [2000] * 4
    for r in records:
        _kernels.add_launches(r)
    assert _kernels.LAUNCHES["deblock_wf"] == 8 * 2000
    _kernels.reset_launches()
