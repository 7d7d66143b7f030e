"""Corrupted streams through every decode path of the PyTorch port, on the
CPU, held byte-exact to the checksums the JAX package recorded for them
(h264bsd_tpu_torch/testdata/reference_checksums.json, the fuzz_* entries
of tools/record_torch_port_checksums.py: 1-4 bytes of a tier-1 stream
XORed, drawn from a seed by utils/recorded.py corrupt, and decoded by the
JAX package's decode_stream(pipelined=False)).

Every 4x4-MB corrupted entry goes through decode_stream, pipelined (the
front-end's parse pool) and not; StreamingDecoder fed random chunks of 1-200 bytes; framepipe at 2
replicas; GOP-parallel decode with 2 workers; and MultiStreamDecoder on
two groups of 4 corrupted streams of one geometry. Three entries are
also decoded live by the JAX package and compared picture by picture
(at most three JAX decodes: the XLA:CPU compile-count limit,
pytest.ini). The row-sharded step is held on clean streams only: like
the JAX package's, it is a per-frame step without the spiral
concealment, which these streams need."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from h264bsd_tpu.models import decoder as jdec
from h264bsd_tpu_torch.frontend import binding as fe
from h264bsd_tpu_torch.models.decoder import (decode_stream,
                                              frame_checksum_host)
from h264bsd_tpu_torch.models.stream import StreamingDecoder
from h264bsd_tpu_torch.parallel.framepipe import decode_stream_framepipe
from h264bsd_tpu_torch.parallel.gop import decode_stream_gop_parallel
from h264bsd_tpu_torch.parallel.mesh import Mesh
from h264bsd_tpu_torch.parallel.multistream import MultiStreamDecoder
from h264bsd_tpu_torch.utils.recorded import corrupt, make_recorded_stream

CHECKSUMS = Path(__file__).parents[1] / "h264bsd_tpu_torch" / "testdata" / \
    "reference_checksums.json"
REF = json.loads(CHECKSUMS.read_text())
# the 4x4-MB (and 6x4, 4x2) corrupted entries: the tier-1 streams
FUZZ = sorted(k for k in REF if k.startswith("fuzz_")
              and "1080p" not in k and "2x68" not in k)
# decoded live by the JAX package too: a lost and a concealed P picture
# of real motion, partial losses over six references, an I_PCM stream
LIVE = ("fuzz_motion_6x4_s3", "fuzz_six_ref_cycle_s2", "fuzz_pcm_s1")
# streams of one geometry (4x4 MBs) for MultiStreamDecoder: the one with
# the most DPB slots first in each, as the ring is sized by the first
# round
GROUPS = (("fuzz_six_ref_cycle_s2", "fuzz_longterm_s3",
           "fuzz_frame_num_gap_s3", "fuzz_ippp_4x4_s1"),
          ("fuzz_ippp_4x4_s2", "fuzz_slice_groups_s1", "fuzz_redundant_s1",
           "fuzz_intra_in_p_constrained_s2"))


def _stream(name):
    """The entry's bytes, checked against the recorded SHA-256 first."""
    data = make_recorded_stream(REF[name])
    assert hashlib.sha256(data).hexdigest() == REF[name]["sha256"], name
    return data


def _sums(pics):
    return [frame_checksum_host(p.yuv_bytes()) for p in pics]


def test_the_corpus():
    """36 corrupted 4x4 entries, each a copy of a recorded tier-1 stream
    with 1-4 bytes past the first start code flipped; the JAX package
    decoded every one (no entry records an exception)."""
    assert len(FUZZ) == 36
    for name in FUZZ:
        e = REF[name]
        base = name[len("fuzz_"):name.rindex("_s")]
        clean = make_recorded_stream(REF[base])
        data = _stream(name)
        assert e["corrupt"] == {"seed": int(name[name.rindex("_s") + 2:])}
        assert data == corrupt(clean, e["corrupt"]["seed"])
        diff = np.flatnonzero(np.frombuffer(clean, np.uint8)
                              != np.frombuffer(data, np.uint8))
        assert 1 <= len(diff) <= 4 and diff.min() >= 4
        assert "raises" not in e and "checksums" in e


@pytest.mark.parametrize("name", FUZZ)
def test_decode_stream_matches_recorded(name):
    """Pipelined, every picture goes through the front-end's parse pool
    (frontend.binding.STATS counts each one it hands back)."""
    data = _stream(name)
    for pipelined in (True, False):
        before = dict(fe.STATS)
        assert _sums(decode_stream(data, pipelined=pipelined,
                                   device="cpu")) == REF[name]["checksums"], \
            f"pipelined={pipelined}"
        taken = sum(fe.STATS[k] - before[k]
                    for k in ("pictures_pooled", "pictures_serial"))
        assert taken >= len(REF[name]["checksums"]) if pipelined else \
            taken == 0


@pytest.mark.parametrize("name", LIVE)
def test_matches_a_live_jax_decode(name):
    data = _stream(name)
    want = [p.yuv_bytes() for p in jdec.decode_stream(data, pipelined=False)]
    got = [p.yuv_bytes() for p in decode_stream(data, device="cpu")]
    assert len(got) == len(want) == len(REF[name]["checksums"]) > 1
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"picture {k}"


@pytest.mark.parametrize("name", FUZZ)
def test_streaming_decoder_in_random_chunks(name):
    data = _stream(name)
    rng = np.random.default_rng(2024)
    pics = []
    sd = StreamingDecoder(on_picture_ready=pics.append, device="cpu")
    at = 0
    while at < len(data):
        n = int(rng.integers(1, 201))
        sd.queue_input(data[at:at + n])
        sd.pump()
        at += n
    sd.end_of_stream()
    sd.pump()
    assert _sums(pics) == REF[name]["checksums"]


@pytest.mark.parametrize("name", FUZZ)
def test_framepipe_at_two_replicas(name):
    mesh = Mesh(["cpu", "cpu"], ("pipe",))
    assert _sums(decode_stream_framepipe(_stream(name), mesh, "pipe")) == \
        REF[name]["checksums"]


@pytest.mark.parametrize("name", FUZZ)
def test_gop_parallel_with_two_workers(name):
    assert _sums(decode_stream_gop_parallel(
        _stream(name), devices=["cpu"], threads=2)) == REF[name]["checksums"]


@pytest.mark.parametrize("names", GROUPS, ids=["multiref", "two_slots"])
def test_multistream_decoder(names):
    """Round by round, each released picture read from the ring in the
    round that released it (later rounds may overwrite its slot)."""
    dec = MultiStreamDecoder([_stream(n) for n in names], device="cpu")
    got = [[] for _ in names]
    try:
        while dec.step():
            for i, sums in enumerate(got):
                sums += [frame_checksum_host(b"".join(
                    p.numpy().tobytes() for p in dec.picture(i, j)))
                    for j in range(len(sums), len(dec.outputs[i]))]
    finally:
        dec.close()
    assert got == [REF[n]["checksums"] for n in names]
    assert all(got)
