"""The program's spans in the benchmark (program_spans.py, the metrics
device.idle_parse_wait and host.submit_ms, tools/stages.py): their
arithmetic on a synthetic trace, tracing.reduce unchanged by them, a
program without them read as nothing, and traced runs of the 1080p cell
on the CPU at a small size that read them; on the card, that the spans
have no device-side mirror and that the graph launches fall inside the
replay spans."""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import harness
import program_spans
import tracing

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import stages  # noqa: E402

CELL = "stream_1080p.motion"
SMALL = {"config": {"width_mbs": 4, "height_mbs": 3, "gop_len": 6},
         "traffic": {"warm_cycles": 1, "max_fps": 400, "trace_seconds": 1}}
NEW = ("device.idle_parse_wait", "host.submit_ms")
T0 = 5000.0          # the window's start in the synthetic trace, in us


def op(name, start, end, tid, cat="cpu_op"):
    """A complete event of a Chrome trace, times in us from the window's
    start."""
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": T0 + start, "dur": end - start}


# consumer (thread 1): waits 0-300 us, then a flush of one frame (stage,
# replay, output); the parse thread (2): parse, prepare, a put blocked on
# the full queue, the next frame's prepare. The card runs 360-700 us.
SYNTHETIC = [
    op(tracing.WINDOW, 0, 1000, 1, "user_annotation"),
    op("bench.next_picture", 0, 800, 1, "user_annotation"),
    op("h264.queue_wait", 0, 300, 1),
    op("h264.flush", 300, 600, 1),
    op("h264.stage", 300, 350, 1),
    op("h264.replay", 350, 450, 1),
    op("cudaGraphLaunch", 400, 405, 1, "cuda_runtime"),
    op("h264.output", 450, 500, 1),
    op("cudaGraphLaunch", 900, 905, 1, "cuda_runtime"),
    op("h264.parse", 0, 100, 2),
    op("h264.prepare", 100, 250, 2),
    op("h264.queue_put", 250, 600, 2),
    op("h264.prepare", 600, 700, 2),
    op("deblock_wf_kernel", 360, 700, "stream 7", "kernel"),
    # the profiler's device-side mirror of an annotation: not an operation
    op("h264.flush", 300, 1000, "stream 7", "gpu_user_annotation"),
]


def read_synthetic(tmp_path, events):
    path = tmp_path / "trace_synthetic.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return program_spans.read(path)


def test_stage_arithmetic_on_a_synthetic_trace(tmp_path, monkeypatch):
    st = read_synthetic(tmp_path, SYNTHETIC)
    assert st.window_s == pytest.approx(1e-3)
    assert st.idle == [pytest.approx((0.0, 360e-6)),
                       pytest.approx((700e-6, 1e-3))]
    rows = {(n, r): (s, i) for n, r, s, i in st.stages()}
    want = {("h264.queue_wait", "consumer"): (300e-6, 300e-6),
            ("h264.stage", "consumer"): (50e-6, 50e-6),
            ("h264.replay", "consumer"): (100e-6, 10e-6),
            ("h264.output", "consumer"): (50e-6, 0.0),
            ("h264.flush", "consumer"): (100e-6, 0.0),
            (program_spans.OUTSIDE, "consumer"): (400e-6, 300e-6),
            ("h264.parse", "parse"): (100e-6, 0.0),
            ("h264.prepare", "parse"): (250e-6, 0.0),
            ("h264.queue_put", "parse"): (350e-6, 0.0)}
    assert set(rows) == set(want)
    for key, (sec, idle) in want.items():
        assert rows[key] == (pytest.approx(sec), pytest.approx(idle)), key
    assert st.named_idle_share() == pytest.approx(100 * 360 / 460)
    assert st.replay_launch_share() == pytest.approx(50.0)
    assert st.frontend_ms() == pytest.approx(0.175)

    monkeypatch.setattr(program_spans, "OUT", tmp_path)
    ctx = SimpleNamespace(trace=SimpleNamespace(window_s=1e-3),
                          n_pictures=2)
    assert harness.reader("device.idle_parse_wait").read(ctx) == \
        pytest.approx(30.0)
    assert harness.reader("host.submit_ms").read(ctx) == pytest.approx(0.1)
    # another run's trace (another window) is not read
    ctx.trace.window_s = 5e-3
    assert all(harness.reader(m).read(ctx) is None for m in NEW)


def test_a_program_without_spans_reads_nothing(tmp_path, monkeypatch):
    """The program as it was before its spans: no h264.* event, so the
    readers return nothing and raise nothing."""
    events = [e for e in SYNTHETIC if not e["name"].startswith("h264.")]
    assert read_synthetic(tmp_path, events) is None
    monkeypatch.setattr(program_spans, "OUT", tmp_path)
    ctx = SimpleNamespace(trace=SimpleNamespace(window_s=1e-3),
                          n_pictures=2)
    assert all(harness.reader(m).read(ctx) is None for m in NEW)
    monkeypatch.setattr(program_spans, "OUT", tmp_path / "absent")
    assert all(harness.reader(m).read(ctx) is None for m in NEW)


class KinetoEvent:
    """The parts of a profiler event that tracing.reduce reads."""

    def __init__(self, name, start_us, end_us, cuda):
        import torch
        self._name, self._s = name, int(start_us * 1e3)
        self._d = int((end_us - start_us) * 1e3)
        self._dev = torch.autograd.DeviceType.CUDA if cuda else \
            torch.autograd.DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def end_ns(self):
        return self._s + self._d


def reduced(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return tracing.reduce(prof)


def test_reduce_is_unchanged_by_the_program_spans():
    """The program's spans are CPU operations of the trace: the device
    operations, busy time and idle gaps tracing.reduce reads are those of
    the trace without them."""
    base = [KinetoEvent(tracing.WINDOW, 0, 1000, False),
            KinetoEvent(tracing.WINDOW, 0, 1000, True),
            KinetoEvent("bench.next_picture", 0, 800, False),
            KinetoEvent("bench.next_picture", 360, 700, True),
            KinetoEvent("deblock_wf_kernel(int*)", 360, 500, True),
            KinetoEvent("Memcpy HtoD", 520, 700, True)]
    spans = [KinetoEvent(e["name"], e["ts"] - T0, e["ts"] - T0 + e["dur"],
                         False)
             for e in SYNTHETIC if e["name"].startswith("h264.")
             and e["cat"] == "cpu_op"]
    a, b = reduced(base), reduced(base + spans)
    assert b.ops == a.ops and len(a.ops) == 2
    assert b.busy_s == a.busy_s == pytest.approx(320e-6)
    assert b.spans == a.spans and b.idle_gaps() == a.idle_gaps()


def test_traced_run_reads_the_program_spans():
    """A traced run of the 1080p cell reports the two metrics of the
    program's spans; its trace names the consumer's wait on the queue."""
    r = harness.run_cell(CELL, 4242, 1.5, True, time.perf_counter(),
                         device="cpu", need_device=False, overrides=SMALL)
    assert r["correct"]
    assert set(NEW) <= set(r["metrics"])
    assert 0 <= r["metrics"]["device.idle_parse_wait"]["value"] <= 100
    assert r["metrics"]["host.submit_ms"]["value"] > 0
    st = program_spans.read(harness.OUT / f"trace_{CELL}.json")
    assert ("h264.queue_wait", "consumer") in \
        {(n, role) for n, role, *_ in st.stages()}
    assert st.parse is None      # the parse thread is not recorded


def test_stages_tool_records_the_parse_thread():
    """tools/stages.py: the same run with every thread recorded names
    the parse thread's spans and reads the front-end beside the
    consumer."""
    out = stages.stage_run(CELL, 4242, 1.5, device="cpu", need_device=False,
                           overrides=SMALL)
    assert out["correct"] and set(NEW) <= set(out["metrics"])
    rows = {(n, role) for n, role, *_ in out["stages"]}
    assert {("h264.parse", "parse"), ("h264.prepare", "parse"),
            ("h264.queue_wait", "consumer")} <= rows
    assert out["frontend.span_ms"] > 0
    assert out["named_idle_share"] is not None


@pytest.mark.cuda
def test_card_spans_have_no_device_mirror(card, tmp_path):
    """On the card the program's spans are host operations only, and
    every graph launch of a decode falls inside an h264.replay span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import streamgen
    from h264bsd_tpu_torch.models.decoder import (WINDOW, Decoder,
                                                  decode_stream)
    data, _ = streamgen.make_motion_gop(8, 6, 16, 7, 26, 4)
    dec = Decoder(slot_margin=WINDOW, device=card)
    for _ in decode_stream(data, decoder=dec):      # the captures
        pass
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tracing.WINDOW):
            n = sum(1 for _ in decode_stream(data, decoder=dec))
            torch.cuda.synchronize()
    dec.close()
    assert n == 16
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("h264.") and
                e.device_type() == torch.autograd.DeviceType.CUDA]
    prof.export_chrome_trace(str(tmp_path / "trace_card.json"))
    st = program_spans.read(tmp_path / "trace_card.json")
    assert st.replay_launch_share() == pytest.approx(100.0)
