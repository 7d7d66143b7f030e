"""The port's front-end in pool mode (FrontendDecoder.pool_start,
csrc/decoder.h Decoder::start_pool) against the same front-end parsing
serially: picture by picture the same events in the same order (HDRS_RDY
and PIC_RDY), stream_info, pic_info, non-existing frames, I_PCM samples,
compact blob bytes and the output pictures each picture releases, on
every recorded stream and the 36 corrupted 4x4 entries; which pictures
ran on the pool (binding.STATS); one packed-record build a picture; and
decode_stream's pool threads joined when the stream ends."""

import json
import threading
from pathlib import Path

import pytest

from h264bsd_tpu.frontend import binding as jfe
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models.decoder import (WF_THRESH, caps_from_counts,
                                              decode_stream)
from h264bsd_tpu_torch.ops.unpack import compact_blob_words
from h264bsd_tpu_torch.utils import motion_stream, streamgen
from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

REF = json.loads((Path(__file__).parents[1] / "h264bsd_tpu_torch" /
                  "testdata" / "reference_checksums.json").read_text())
RECORDED = sorted(k for k in REF if not k.startswith("fuzz_"))
FUZZ = sorted(k for k in REF if k.startswith("fuzz_")
              and "1080p" not in k and "2x68" not in k)


def _picture(src):
    """What decode_stream's parse thread reads of one picture."""
    g = src.stream_info()
    n_mbs = g["width_mbs"] * g["height_mbs"]
    info = src.pic_info()
    non_existing = src.take_non_existing()
    counts = [int(x) for x in src.blob_counts()]
    caps = caps_from_counts(counts, n_mbs, counts[5] > WF_THRESH)
    words = compact_blob_words(counts, n_mbs, caps)[1]
    blob = src.blob_compact(*caps, words * 4).tobytes()
    mbs, pcm = src.ipcm()
    return ("pic", g, info, non_existing, mbs.tolist(), pcm.tobytes(), blob)


def _events(data, workers=None, lag=0):
    """The front-end's events over `data`, serially (workers None) or on
    a pool of `workers`, taking a pooled picture once more than `lag`
    have ended (and at HDRS_RDY and the end), as decode_stream's parse
    thread does with lag 2 x workers."""
    dec = fe.FrontendDecoder(slot_margin=16)
    out = []

    def take(drain):
        n_out = 0
        while True:
            n, ready, n_out = dec.pool_poll()
            if not n or not (drain or n > lag):
                return n_out
            pic = dec.pool_take()
            out.append(_picture(pic) + (pic.outputs(),))
            pic.release()

    if workers:
        dec.pool_start(workers)
    pos = n_out = 0
    while pos < len(data):
        status, read = dec.decode(data, n_out, pos)
        pos += read
        if status == fe.HDRS_RDY:
            if workers:
                take(True)
            out.append(("hdrs", dec.stream_info()))
        elif status == fe.PIC_RDY and not workers:
            outs = []
            while (o := dec.next_output()) is not None:
                outs.append(o)
            n_out += len(outs)
            out.append(_picture(dec) + (outs,))
        elif status >= fe.ERROR and read == 0:
            break
        if workers:
            n_out = take(False)
    if workers:
        dec.pool_finish()
        take(True)
    dec.close()
    return out


def _stats_delta(before):
    return {k: fe.STATS[k] - before[k] for k in before}


def _assert_same(want, got):
    assert [e[0] for e in got] == [e[0] for e in want]
    for k, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"event {k} ({w[0]})"


@pytest.mark.parametrize("name", RECORDED + FUZZ)
def test_pooled_frontend_matches_serial(name):
    data = make_recorded_stream(REF[name])
    want = _events(data)
    _assert_same(want, _events(data, workers=3, lag=0))
    _assert_same(want, _events(data, workers=2, lag=6))


@pytest.mark.parametrize("maker,args", [
    (motion_stream.make_motion_stream, (6, 4, 12, 1)),
    (streamgen.make_ippp_stream, (4, 4, 20))])
def test_single_slice_stream_pools_every_picture(maker, args):
    data = maker(*args)
    before = dict(fe.STATS)
    got = _events(data, workers=4, lag=8)
    d = _stats_delta(before)
    n = sum(e[0] == "pic" for e in got)
    assert n == args[2]
    assert d["pictures_pooled"] == n and d["pictures_serial"] == 0
    assert d["packed_builds"] == n
    _assert_same(_events(data), got)


@pytest.mark.parametrize("name", ["slice_groups", "redundant",
                                  "deblock_control", "loss_p_slice",
                                  "fuzz_slice_groups_s1"])
def test_multi_slice_streams_fall_back(name):
    """Slice groups, a redundant slice, three slices a picture, a lost
    slice: those pictures are parsed in order, the same as serially."""
    data = make_recorded_stream(REF[name])
    before = dict(fe.STATS)
    got = _events(data, workers=2)
    d = _stats_delta(before)
    assert d["pictures_serial"] > 0
    assert d["pictures_pooled"] + d["pictures_serial"] == \
        sum(e[0] == "pic" for e in got)
    _assert_same(_events(data), got)


def test_geometry_change_mid_stream():
    """A 4x4 stream, then a 6x4 one with two slices a picture: HDRS_RDY
    between them after the first stream's last pooled picture."""
    data = streamgen.make_ippp_stream(4, 4, 6) + \
        streamgen.make_conformance_stream(6, 4, 5)
    want = _events(data)
    assert [e[0] for e in want].count("hdrs") == 2
    for workers, lag in ((1, 0), (4, 8)):
        _assert_same(want, _events(data, workers, lag))
    pics = list(decode_stream(data, device="cpu"))
    assert [p.yuv_bytes() for p in pics] == \
        [p.yuv_bytes() for p in decode_stream(data, pipelined=False,
                                              device="cpu")]


def test_one_packed_build_a_picture():
    """blob_counts() then blob_compact() build the packed records once;
    the bytes are the JAX package's front-end's, which builds them for
    each call."""
    data = motion_stream.make_motion_stream(6, 4, 3, 2)
    ours, theirs = fe.FrontendDecoder(), jfe.FrontendDecoder()
    blobs = []
    for dec in (ours, theirs):
        pos = 0
        while pos < len(data):
            status, read = dec.decode(data, 0, pos)
            pos += read
            if status == fe.PIC_RDY:
                g = dec.stream_info()
                n_mbs = g["width_mbs"] * g["height_mbs"]
                before = dict(fe.STATS)
                counts = [int(x) for x in dec.blob_counts()]
                caps = caps_from_counts(counts, n_mbs,
                                        counts[5] > WF_THRESH)
                words = compact_blob_words(counts, n_mbs, caps)[1]
                blob = dec.blob_compact(*caps, words * 4).tobytes()
                again = dec.blob_compact(*caps, words * 4).tobytes()
                if dec is ours:
                    assert _stats_delta(before)["packed_builds"] == 1
                    assert again == blob
                blobs.append(blob)
        dec.close()
    assert len(blobs) == 6
    assert blobs[:3] == blobs[3:]


def test_decode_stream_joins_its_pool():
    data = streamgen.make_ippp_stream(4, 4, 8)
    before = dict(fe.STATS)
    assert len(list(decode_stream(data, device="cpu"))) == 8
    assert _stats_delta(before)["pictures_pooled"] == 8
    pics = decode_stream(data, max_pictures=2, device="cpu")
    assert len(list(pics)) == 2
    assert not [t for t in threading.enumerate()
                if t.name.startswith("h264-parse")]
