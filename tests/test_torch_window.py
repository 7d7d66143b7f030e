"""The windowed main path of the PyTorch port, on the CPU, against the
JAX package: decode_stream groups compatible frames into windows of up to
WINDOW frames (Decoder._submit_window, the ramp flush, the reset flush)
and sends every other frame through the eager body; pipelined or not, the
pictures are byte-identical to h264bsd_tpu's decode_stream. On the CPU
the window steps run the frame body eagerly, frame by frame (the card
replays CUDA graphs: tests/test_torch_kernels_cuda.py). Also the
device-side section offsets of unpack_blob against the JAX package's
dynamic slices."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.models import decoder as jdec
from h264bsd_tpu.ops import unpack as junpack
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models import decoder as tdec
from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
from h264bsd_tpu_torch.ops import unpack as tunpack
from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream
from h264bsd_tpu_torch.utils.recorded import drop_nal

CPU = torch.device("cpu")

# tests/test_conformance_streams.py MULTIREF_CASES["frame_num_gap"]: the
# gap synthesizes a non-existing frame, whose slot is zeroed eagerly
FRAME_NUM_GAP = dict(gaps_allowed=True, num_ref_frames=2, frames=[
    dict(idr=True, frame_num=0, dc=4),
    dict(frame_num=1, dc=5),
    dict(frame_num=3, n_active=2, ref_idx=1, dc=-3),
    dict(frame_num=4, n_active=2, ref_idx=0, dc=6),
])

STREAMS = {
    # 20 frames fill a 16-frame window and the ramp
    "ippp_20": lambda: streamgen.make_ippp_stream(4, 4, 20),
    "motion_20": lambda: make_motion_stream(6, 4, 20, seed=1),
    # windowable frames mixed with eager ones: I_PCM samples, a
    # non-existing frame, the spiral concealment of a lost IDR slice
    "pcm": streamgen.make_pcm_stream,
    "frame_num_gap": lambda: streamgen.make_multiref_stream(**FRAME_NUM_GAP),
    "loss_idr_slice": lambda: drop_nal(
        streamgen.make_conformance_stream(slices_per_frame=2), 3),
    # a second sequence of another geometry: the reset flush
    "two_geometries": lambda: streamgen.make_ippp_stream(4, 4, 6)
    + streamgen.make_conformance_stream(6, 4, 5),
}

_WANT: dict = {}


def _want(name):
    """The JAX package's pictures of STREAMS[name], decoded once (frame by
    frame: its pipelined loop reads the second sequence's geometry early
    when the geometry changes mid-stream)."""
    if name not in _WANT:
        _WANT[name] = [p.yuv_bytes() for p in jdec.decode_stream(
            STREAMS[name](), pipelined=False)]
    return _WANT[name]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_windowed_decode_matches_jax(name, monkeypatch):
    want = _want(name)
    assert len(want) > 1
    data = STREAMS[name]()
    sizes = []
    step = tdec.Decoder._decode_window_step

    def spy(self, items):
        sizes.append(len(items))
        return step(self, items)

    monkeypatch.setattr(tdec.Decoder, "_decode_window_step", spy)
    for pipelined in (True, False):
        reset_stats()
        # every picture is collected before any is read: a picture must
        # not change when a later frame reuses its ring slot
        pics = list(tdec.decode_stream(data, pipelined=pipelined,
                                       device="cpu"))
        got = [p.yuv_bytes() for p in pics]
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"picture {k} (pipelined={pipelined})"
        # on the CPU every frame runs the eager body, none a graph
        assert STATS["graph_captures"] == STATS["graph_replays"] == 0
        assert STATS["eager_frames"] >= len(want)
    assert sizes and all(0 < k <= tdec.WINDOW for k in sizes)


def test_max_pictures_stops_early():
    want = _want("ippp_20")
    data = STREAMS["ippp_20"]()
    for pipelined in (True, False):
        got = [p.yuv_bytes() for p in tdec.decode_stream(
            data, max_pictures=5, pipelined=pipelined, device="cpu")]
        assert got == want[:5]


def _items(data, n):
    """(decoder, the first n frames' [(prep, outs)]): host halves only."""
    dec = tdec.Decoder(slot_margin=tdec.WINDOW, device="cpu")
    items = []
    pos = 0
    while pos < len(data) and len(items) < n:
        status, read = dec._fe.decode(data, 0, pos)
        pos += read
        if status == fe.PIC_RDY:
            prep = dec._prepare()
            outs = []
            while (o := dec._fe.next_output()) is not None:
                outs.append(o)
            items.append((prep, outs))
    return dec, items


def test_window_step_equals_single_steps():
    """_decode_window_step over K frames leaves the same ring and releases
    the same pictures as K _decode_steps, each followed by its outputs."""
    dec, items = _items(make_motion_stream(6, 4, 9, seed=3), 9)
    assert all(dec._windowable(p) for p, _ in items)
    single = tdec.Decoder(device="cpu")
    want = []
    for prep, outs in items:
        single._decode_step(prep)
        want += [single._make_output(o, prep["geom"]).yuv_bytes()
                 for o in outs]
    window = tdec.Decoder(device="cpu")
    got = [p.yuv_bytes() for p in window._decode_window_step(items)]
    assert got == want and len(got) > 1
    for a, b in zip(window._dpb, single._dpb):
        assert torch.equal(a, b)


def test_submit_window_chunks(monkeypatch):
    """Power-of-two chunks, then a lone frame through _decode_step."""
    _, items = _items(streamgen.make_ippp_stream(4, 4, 20), 20)
    calls = []
    dec = tdec.Decoder(device="cpu")
    monkeypatch.setattr(dec, "_decode_window_step",
                        lambda it: calls.append(len(it)) or [])
    monkeypatch.setattr(dec, "_decode_step", lambda p: calls.append(-1))
    monkeypatch.setattr(dec, "_make_output", lambda o, g: None)
    dec._submit_window(items[:19])
    assert calls == [16, 2, -1]
    calls.clear()
    dec._submit_window(items[:7])
    assert calls == [4, 2, -1]


@partial(jax.jit, static_argnums=(1, 2))
def _jax_unpack(blob, n, caps):
    return junpack.unpack_blob(blob, n, *caps)


NAMES = ["packed", "slice_table", "sparse_ids", "sparse_levels", "exc_ids",
         "exc_payload", "intra_ids", "intra_payload", "slice_ids"]


@pytest.mark.parametrize("name", ["ippp_20", "motion_20", "two_geometries",
                                  "loss_idr_slice"])
def test_unpack_blob_offsets_match_jax(name):
    """Section by section, on every blob the stream ships, whole and cut
    back to its written words (the section starts then clamp, as
    lax.dynamic_slice_in_dim clamps)."""
    _, items = _items(STREAMS[name](), 64)
    for prep, _ in items:
        blob, n, caps = prep["blob"], prep["n_mbs"], prep["caps"]
        # the written words, or the largest section if that is longer
        # (a JAX dynamic slice must fit the blob)
        real = tunpack.compact_blob_words(
            blob[:64].view(np.uint32)[:7], n, caps)[0]
        single, short, full, wide, exc, intra, stab, sid = caps
        cut = max(real, n * 2, stab, 4 * exc, single, 2 * short, 4 * intra,
                  4 * full, wide)
        for b in (blob, blob[:cut * 4]):
            want = _jax_unpack(jnp.asarray(b), n, caps)
            got = tunpack.unpack_blob(tunpack.blob_words(b, CPU), n, *caps)
            for label, g, w in zip(NAMES, got, want):
                if w is None:
                    assert g is None, label
                else:
                    np.testing.assert_array_equal(np.asarray(g),
                                                  np.asarray(w), label)
    assert len(items) >= 4
