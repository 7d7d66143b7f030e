"""The port's spans (utils/profiling.span) on the CPU: which stages of
decode_stream and Decoder record them, on which thread, how they nest,
and that with no profiler running a span makes no recorder call and
tracing changes no picture."""

from unittest import mock

import pytest
import torch

from h264bsd_tpu_torch.models.decoder import decode_stream
from h264bsd_tpu_torch.utils import profiling
from h264bsd_tpu_torch.utils.profiling import device_trace, span
from h264bsd_tpu_torch.utils.streamgen import make_ippp_stream

N_FRAMES = 6
# the spans the CPU path records (no graph replays or captures there)
PIPELINED = {"h264.parse", "h264.prepare", "h264.queue_put",
             "h264.queue_wait", "h264.flush", "h264.stage", "h264.eager",
             "h264.output"}
PARSE_THREAD = {"h264.parse", "h264.prepare", "h264.queue_put"}


@pytest.fixture(scope="module")
def stream():
    """One MB a picture: the CPU path's plain kernels make ~10,000
    PyTorch operations a picture there, each one a profiler event."""
    return make_ippp_stream(1, 1, N_FRAMES)


def traced_decode(log_dir, data, pipelined):
    """(pictures, [(name, thread, start_ns, end_ns)] of the h264.* spans)
    of one decode on the CPU under device_trace."""
    with device_trace(log_dir, device="cpu") as prof:
        pics = list(decode_stream(data, pipelined=pipelined, device="cpu"))
    spans = [(e.name(), e.start_thread_id(), e.start_ns(),
              e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("h264.")]
    assert list(log_dir.glob("trace_*.json"))
    return pics, spans


@pytest.fixture(scope="module")
def traced(tmp_path_factory, stream):
    """{pipelined: traced_decode of the stream}, each decoded once."""
    return {p: traced_decode(tmp_path_factory.mktemp("trace"), stream, p)
            for p in (True, False)}


def inside(inner, outers):
    """True when span `inner` lies within one of `outers` on its thread."""
    _, tid, s, e = inner
    return any(t == tid and os <= s and e <= oe for _, t, os, oe in outers)


def test_pipelined_decode_records_every_stage(traced):
    """decode_stream pipelined: every stage of the CPU path, the parse
    thread's spans on a thread of their own, one h264.prepare a frame,
    and the window's staging and eager bodies inside its h264.flush."""
    pics, spans = traced[True]
    assert len(pics) == N_FRAMES
    assert {n for n, *_ in spans} == PIPELINED
    consumer = {t for n, t, *_ in spans if n == "h264.queue_wait"}
    assert len(consumer) == 1
    assert all(t not in consumer for n, t, *_ in spans if n in PARSE_THREAD)
    assert all(t in consumer for n, t, *_ in spans
               if n not in PARSE_THREAD)
    assert sum(n == "h264.prepare" for n, *_ in spans) == N_FRAMES
    flushes = [sp for sp in spans if sp[0] == "h264.flush"]
    nested = [sp for sp in spans if sp[0] in ("h264.stage", "h264.eager")]
    assert nested and all(inside(sp, flushes) for sp in nested)
    prepares = [sp for sp in spans if sp[0] == "h264.prepare"]
    assert not any(inside(sp, flushes) for sp in prepares)


def test_unpipelined_decode_records_on_one_thread(traced):
    """decode_stream(pipelined=False) (Decoder.decode frame by frame):
    parse, prepare, staging, eager bodies and outputs, all on the
    calling thread, with no queue and no window flush."""
    pics, spans = traced[False]
    assert len(pics) == N_FRAMES
    assert {n for n, *_ in spans} == {"h264.parse", "h264.prepare",
                                      "h264.stage", "h264.eager",
                                      "h264.output"}
    assert len({t for _, t, *_ in spans}) == 1
    assert sum(n == "h264.prepare" for n, *_ in spans) == N_FRAMES


def test_span_without_a_profiler_is_the_shared_null_context(stream):
    """No profiler: span returns one shared null context and calls no
    recorder, so a decode goes through with every recorder raising."""
    assert span("h264.parse") is span("h264.flush") is profiling._NO_SPAN

    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler running")
    with mock.patch.object(profiling, "_RecordFunctionFast", refuse), \
            mock.patch("torch.autograd.profiler.record_function", refuse), \
            mock.patch("torch.profiler.record_function", refuse):
        for pipelined in (True, False):
            assert len(list(decode_stream(stream, pipelined=pipelined,
                                          device="cpu"))) == N_FRAMES


def test_span_under_a_profiler_records(tmp_path):
    """With a profiler running, span records its name as a CPU
    operation of the calling thread."""
    with device_trace(tmp_path, device="cpu") as prof:
        assert span("h264.test") is not profiling._NO_SPAN
        with span("h264.test"):
            torch.ones(4).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "h264.test"]
    assert len(events) == 1
    assert events[0].device_type() == torch.autograd.DeviceType.CPU


@pytest.mark.parametrize("pipelined", [True, False])
def test_tracing_changes_no_picture(traced, stream, pipelined):
    """The pictures of a traced decode are byte-identical to those of an
    untraced one."""
    plain = list(decode_stream(stream, pipelined=pipelined, device="cpu"))
    pics, _ = traced[pipelined]
    assert len(pics) == len(plain) == N_FRAMES
    for a, b in zip(plain, pics):
        assert a.yuv_bytes() == b.yuv_bytes()
