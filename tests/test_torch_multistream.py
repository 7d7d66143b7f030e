"""The PyTorch port's MultiStreamDecoder (h264bsd_tpu_torch/parallel), on
the CPU, against the JAX package's MultiStreamDecoder: the same blob
bytes and caps every round, and byte-identical pictures per stream and
per round. The streams share one geometry (4x4 MBs): an IPPP stream, a
shorter one (it drains first and then sends the empty frame), an I_PCM
stream (eager with pcm=), a lost IDR slice (the spiral concealment:
evicted from the batch) and a lost P slice (concealed from a reference
inside the batch). With a mesh of two CPU positions the same streams
give the same pictures, round by round."""

import numpy as np
import pytest
import torch

from h264bsd_tpu.parallel.multistream import \
    MultiStreamDecoder as JMultiStreamDecoder
from h264bsd_tpu.utils import streamgen
from h264bsd_tpu_torch.models.decoder import ROW_SCALARS, decode_stream
from h264bsd_tpu_torch.parallel.mesh import Mesh
from h264bsd_tpu_torch.parallel.multistream import MultiStreamDecoder
from h264bsd_tpu_torch.utils.recorded import drop_nal

STREAMS = {
    "ippp": lambda: streamgen.make_ippp_stream(4, 4, 4),
    "ippp_short": lambda: streamgen.make_ippp_stream(4, 4, 2),
    "pcm": lambda: streamgen.make_pcm_stream(4, 4),
    "loss_idr_slice": lambda: drop_nal(
        streamgen.make_conformance_stream(slices_per_frame=2), 3),
    "loss_p_slice": lambda: drop_nal(
        streamgen.make_conformance_stream(slices_per_frame=2), 5),
}


def _streams():
    return [make() for make in STREAMS.values()]


def _picture_bytes(planes):
    return b"".join(np.asarray(p).tobytes() for p in planes)


def _take_new(dec, seen):
    """The pictures each stream released since the last call, as bytes
    read from the ring now (later rounds may overwrite their slots)."""
    new = []
    for i, got in enumerate(seen):
        fresh = []
        while len(got) < len(dec.outputs[i]):
            got.append(_picture_bytes(dec.picture(i, len(got))))
            fresh.append(got[-1])
        new.append(fresh)
    return new


@pytest.fixture(scope="module")
def lockstep():
    """Both decoders driven round by round: for every round each one's
    released pictures per stream, and the round blobs (N, bytes), caps
    and intra classes."""
    streams = _streams()
    jdec = JMultiStreamDecoder(streams)
    tdec = MultiStreamDecoder(streams, device="cpu")
    rounds = []
    jseen = [[] for _ in streams]
    tseen = [[] for _ in streams]
    try:
        while True:
            jrnd = jdec._parse_round()
            trnd = tdec._parse_round()
            if jrnd is None or trnd is None:
                assert jrnd is None and trnd is None
                break
            jdec._submit(jrnd)
            tdec._submit(trnd)
            rounds.append(dict(
                jblobs=jrnd["blobs"],
                tblobs=trnd["rows"][:len(streams), ROW_SCALARS:].view(
                    np.uint8),
                caps=(jrnd["caps"], trnd["caps"]),
                wavefront=(jrnd["wavefront"], trnd["wavefront"]),
                n_ready=(jrnd["n_ready"], trnd["n_ready"]),
                eager=[i for i, _, _ in trnd["eager"]],
                jpics=_take_new(jdec, jseen), tpics=_take_new(tdec, tseen)))
        yield dict(rounds=rounds, jouts=jdec.outputs, touts=tdec.outputs,
                   tpics=tseen)
    finally:
        tdec.close()


def test_rounds_and_outputs_match_jax(lockstep):
    assert len(lockstep["rounds"]) == 4      # the longest stream's pictures
    assert [len(o) for o in lockstep["touts"]] == \
        [len(o) for o in lockstep["jouts"]]
    assert lockstep["touts"] == lockstep["jouts"]
    for k, rnd in enumerate(lockstep["rounds"]):
        assert rnd["n_ready"][0] == rnd["n_ready"][1], k
        assert rnd["caps"][0] == rnd["caps"][1], k
        assert rnd["wavefront"][0] == rnd["wavefront"][1], k


def test_pcm_and_spiral_pictures_run_eagerly(lockstep):
    """The I_PCM pictures and the lost IDR slice leave the batch; the
    lost P slice, concealed from its reference, stays in it."""
    names = list(STREAMS)
    eager = [[names[i] for i in rnd["eager"]] for rnd in lockstep["rounds"]]
    assert "pcm" in eager[0] and "loss_idr_slice" in eager[0]
    assert all("loss_p_slice" not in e and "ippp" not in e for e in eager)


def test_round_blobs_are_the_jax_blobs(lockstep):
    """The streams parse on worker threads; each round's blob bytes are
    still the JAX version's, the empty blob of a drained stream too."""
    for k, rnd in enumerate(lockstep["rounds"]):
        np.testing.assert_array_equal(rnd["tblobs"], rnd["jblobs"],
                                      f"round {k}")


@pytest.mark.parametrize("name", list(STREAMS))
def test_pictures_of_every_round_match_jax(lockstep, name):
    i = list(STREAMS).index(name)
    for k, rnd in enumerate(lockstep["rounds"]):
        assert len(rnd["tpics"][i]) == len(rnd["jpics"][i]), k
        for j, (got, want) in enumerate(zip(rnd["tpics"][i],
                                            rnd["jpics"][i])):
            assert got == want, f"round {k} picture {j}"


@pytest.mark.parametrize("name", list(STREAMS))
def test_each_stream_matches_its_single_stream_decode(lockstep, name):
    i = list(STREAMS).index(name)
    want = [p.yuv_bytes() for p in
            decode_stream(STREAMS[name](), device="cpu")]
    assert lockstep["tpics"][i] == want


def test_pipelined_and_not_give_the_same_bytes():
    rings, outs = [], []
    for pipelined in (True, False):
        dec = MultiStreamDecoder(_streams(), device="cpu")
        try:
            counts = dec.run(pipelined=pipelined)
        finally:
            dec.close()
        assert counts == [len(o) for o in dec.outputs]
        rings.append(dec.dpb)
        outs.append(dec.outputs)
    assert outs[0] == outs[1]
    for a, b, name in zip(*rings, ("y", "cb", "cr")):
        assert torch.equal(a, b), name


def test_without_a_device_it_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamDecoder(_streams())


def test_streams_of_another_geometry_raise():
    dec = MultiStreamDecoder([streamgen.make_ippp_stream(4, 4, 2),
                              streamgen.make_ippp_stream(6, 4, 2)],
                             device="cpu")
    try:
        with pytest.raises(ValueError, match="one geometry"):
            dec.step()
    finally:
        dec.close()


def _rounds(dec):
    """Step dec to its end: every round's new pictures per stream, read
    from the ring in the round that released them."""
    seen = [[] for _ in dec.outputs]
    rounds = []
    try:
        while dec.step():
            rounds.append(_take_new(dec, seen))
    finally:
        dec.close()
    return rounds, dec.outputs


def test_a_mesh_of_two_positions_matches_one_device():
    """Four streams sharded over two positions (two CPU devices of a
    Mesh): the pcm and lost-IDR streams, both eager, on position 1. Every
    round's pictures and the outputs equal the decoder without a mesh."""
    streams = _streams()[:4]
    want = _rounds(MultiStreamDecoder(streams, device="cpu"))
    mesh = Mesh(["cpu"] * 2, ("stream",))
    dec = MultiStreamDecoder(streams, mesh=mesh, stream_axis="stream")
    assert [sh.device.type for sh in dec._shards] == ["cpu", "cpu"]
    got = _rounds(dec)
    assert got == want
    assert len(dec.dpb) == 2 and dec.dpb[0][0].shape[0] == 2


def test_a_mesh_needs_a_divisible_stream_count():
    with pytest.raises(ValueError, match="not divisible"):
        MultiStreamDecoder(_streams(), mesh=Mesh(["cpu"] * 2, ("stream",)))
