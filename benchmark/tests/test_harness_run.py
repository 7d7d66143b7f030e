"""Runs of the harness: without a card run.py exits non-zero and prints
no result; on the CPU, at small sizes (the card's check skipped), every
cell's run comes out correct, and comes out not correct with the
program broken underneath it in each way the cell can be: a frame step
that leaves the ring as it was, half of a batch left out, a picture
altered where it is produced."""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import pytest

import harness

ROOT = Path(__file__).resolve().parents[2]

SMALL = {
    "stream_1080p.motion": {
        "config": {"width_mbs": 4, "height_mbs": 3, "gop_len": 6},
        "traffic": {"warm_cycles": 1, "max_fps": 400, "trace_seconds": 1}},
    "streams_360p.motion16": {
        "config": {"width_mbs": 4, "height_mbs": 3, "streams": 4,
                   "gop_len": 6},
        "traffic": {"warm_cycles": 1, "max_fps": 400, "trace_seconds": 1}},
    "stream_1080p.live": {
        "config": {"width_mbs": 4, "height_mbs": 3, "gop_len": 6},
        "traffic": {"warm_cycles": 1, "rate_fps": 6, "trace_seconds": 1}},
}


# the many-stream and paced cells are not in BENCHMARK.json (PERF.md,
# Open questions): their entries as a later change would add them
MORE = {
    "configs": [{"name": "streams_360p", "source": "test_640x360.h264",
                 "file": "benchmark/configs/streams_360p.json",
                 "reduced": ["streams", "gop_len"], "why": "many"}],
    "workloads": [{"name": "streams_360p.motion16", "config": "streams_360p",
                   "traffic": "motion16", "chips": 1, "why": "rounds"},
                  {"name": "stream_1080p.live", "config": "stream_1080p",
                   "traffic": "live", "chips": 1, "why": "paced"}],
    "end_to_end": [{"name": "latency_p50_ms", "unit": "ms", "bound": 0.25,
                    "better": "lower", "source": "host_clock",
                    "workloads": ["stream_1080p.live"]}],
    "per_layer": [{"name": n, "unit": u, "better": "lower", "source": "",
                   "layer": "", "moves": "", "workloads": [w]}
                  for n, u, w in (
                      ("device.idle_share.live", "%", "stream_1080p.live"),
                      ("frontend.parse_ms.live", "ms", "stream_1080p.live"),
                      ("multistream.overlap", "x", "streams_360p.motion16"))]}

_load_spec = harness.load_spec


def spec_with_more():
    spec = _load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and m["name"] != "setup_s":
            m["workloads"] = m["workloads"] + ["streams_360p.motion16"]
    for key, entries in MORE.items():
        spec[key] = spec[key] + entries
    return spec


@pytest.fixture(autouse=True)
def more_cells():
    with mock.patch.object(harness, "load_spec", spec_with_more):
        yield


def run(cell, patch=None, traced=False, device="cpu", seed=4242):
    return harness.run_cell(cell, seed, 1.5, traced, time.perf_counter(),
                            device=device, need_device=False, patch=patch,
                            overrides=SMALL[cell])


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "stream_1080p.motion", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(
        harness.load_spec(), cell, False)}
    assert set(r["metrics"]) == names
    assert json.loads(json.dumps(r)) == r


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_is_correct(cell):
    r = run(cell, traced=True)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert "device_ops" in r["breakdown"] and "idle_gaps" in r["breakdown"]


def frame_step_unchanged():
    """The frame body returns without touching the ring."""
    noop = mock.MagicMock(return_value=None)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch(
        "h264bsd_tpu_torch.models.decoder._frame_decode_body", noop))
    stack.enter_context(mock.patch(
        "h264bsd_tpu_torch.parallel.multistream._frame_decode_body", noop))
    return stack


def half_of_the_batch():
    """A round decodes only its first half of streams; a window of frames
    only its first half of frames."""
    from h264bsd_tpu_torch.models import decoder
    from h264bsd_tpu_torch.parallel import multistream
    round_body = multistream._round_body

    def half_round(rows, dpb, branches, **args):
        n = rows.shape[0] // 2
        return round_body(rows[:n], tuple(p[:n] for p in dpb),
                          branches[:n] if branches else branches, **args)
    window_step = decoder.Decoder._decode_window_step

    def half_window(self, items):
        keep = items[:max(1, len(items) // 2)]
        pics = window_step(self, keep)
        return pics + [self._make_output(o, p["geom"])
                       for p, outs in items[len(keep):] for o in outs]
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(multistream, "_round_body",
                                          half_round))
    stack.enter_context(mock.patch.object(
        decoder.Decoder, "_decode_window_step", half_window))
    return stack


def one_sample_altered():
    """Every 7th picture handed out has one luma sample changed."""
    from h264bsd_tpu_torch.models import decoder
    from h264bsd_tpu_torch.parallel import multistream
    made = [0]

    def alter(planes):
        made[0] += 1
        if made[0] % 7 == 0:
            planes[0][3, 5] ^= 1
        return planes
    make_output = decoder.Decoder._make_output
    picture = multistream.MultiStreamDecoder.picture

    def altered_output(self, out, g):
        pic = make_output(self, out, g)
        alter(pic.planes)
        return pic
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        decoder.Decoder, "_make_output", altered_output))
    stack.enter_context(mock.patch.object(
        multistream.MultiStreamDecoder, "picture",
        lambda self, i, j: alter(picture(self, i, j))))
    return stack


FAULTS = [("stream_1080p.motion", frame_step_unchanged),
          ("stream_1080p.motion", half_of_the_batch),
          ("stream_1080p.motion", one_sample_altered),
          ("streams_360p.motion16", frame_step_unchanged),
          ("streams_360p.motion16", half_of_the_batch),
          ("streams_360p.motion16", one_sample_altered),
          ("stream_1080p.live", frame_step_unchanged),
          ("stream_1080p.live", one_sample_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_broken_program_is_not_correct(cell, fault):
    r = run(cell, patch=fault)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["mismatched_pictures"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_card_run_is_correct(card, cell):
    r = run(cell, device=card)
    assert r["correct"] and r["device"]["platform"] == "gpu"
