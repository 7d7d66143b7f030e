"""The program's own spans in a traced window: the h264.* CPU operations
the port records while a profiler runs (h264bsd_tpu_torch/utils/
profiling.py names each), read from the Chrome trace a traced run leaves
in _out/, on the same clock as the device operations there.

The consumer is the thread that holds the benchmark's `bench.window`
span: decode_stream's consumer, which stages and replays the frames.
The parse thread (decode_stream's producer) is the thread that holds the
h264.prepare spans; a trace records it only when the profiler records
every thread (tools/stages.py). Each span's self seconds are its time in
the window less that of the h264.* spans inside it on its thread; the
device-idle seconds of a consumer span are the window's seconds in which
no device operation (kernel, copy or memset) ran and the span was the
consumer's innermost h264.* span. Times in seconds from the window's
start."""

from __future__ import annotations

import functools
import json
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from pathlib import Path

from tracing import WINDOW, union

HERE = Path(__file__).resolve().parent
OUT = HERE / "_out"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "h264."
OUTSIDE = "outside the program's spans"
# the consumer's host work of feeding the card, per picture handed on
SUBMIT = ("h264.stage", "h264.replay", "h264.capture", "h264.eager",
          "h264.output")


@dataclass
class Stages:
    window_s: float
    idle: list                  # device-idle intervals of the window
    consumer: int               # thread id of the consumer
    parse: int | None           # thread id of the parse thread, if traced
    # (start, end, name, thread) of the program's spans, clipped
    spans: list = field(default_factory=list)
    # (start, end) of the consumer's bench.next_picture spans
    next_picture: list = field(default_factory=list)
    graph_launches: list = field(default_factory=list)  # (time, thread)

    def role(self, tid):
        return "consumer" if tid == self.consumer else \
            "parse" if tid == self.parse else f"thread {tid}"

    def innermost(self, tid):
        """[(start, end, name)], in order: the stretches of the window in
        which thread `tid` has an h264.* span open, each named by the
        innermost open span, and between them OUTSIDE."""
        out = []
        t = 0.0

        def emit(end, name):
            nonlocal t
            if end > t:
                if out and out[-1][2] == name:
                    out[-1] = (out[-1][0], end, name)
                else:
                    out.append((t, end, name))
                t = end
        stack = []
        for s, e, name in sorted(((s, e, n) for s, e, n, th in self.spans
                                  if th == tid), key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][0] <= s:
                emit(*stack.pop())
            emit(s, stack[-1][1] if stack else OUTSIDE)
            stack.append((e, name))
        while stack:
            emit(*stack.pop())
        emit(self.window_s, OUTSIDE)
        return out

    def self_seconds(self):
        """{(name, role): seconds}, each span's time less that of the
        program's spans inside it on its thread; OUTSIDE of the consumer
        is its time under none of them."""
        out = {}
        for tid in {t for *_, t in self.spans} | {self.consumer}:
            for s, e, name in self.innermost(tid):
                if name == OUTSIDE and tid != self.consumer:
                    continue
                key = (name, self.role(tid))
                out[key] = out.get(key, 0.0) + (e - s)
        return out

    def idle_seconds(self, stretches):
        """Device-idle seconds inside each of `stretches` [(start, end,
        name)], summed by name."""
        starts = [s for s, _ in self.idle]
        ends = [e for _, e in self.idle]
        cum = [0.0]
        for s, e in self.idle:
            cum.append(cum[-1] + e - s)
        out = {}
        for s, e, name in stretches:
            i, j = bisect_right(ends, s), bisect_left(starts, e)
            n = 0.0
            if i < j:
                n = cum[j] - cum[i] - max(0.0, s - starts[i]) \
                    - max(0.0, ends[j - 1] - e)
            out[name] = out.get(name, 0.0) + n
        return out

    def stages(self):
        """[name, thread role, self seconds, device-idle seconds as the
        consumer's innermost span] of every h264.* span name and thread,
        and OUTSIDE of the consumer, most device-idle time first."""
        idle = self.idle_seconds(self.innermost(self.consumer))
        rows = [[name, role, sec,
                 idle.get(name, 0.0) if role == "consumer" else 0.0]
                for (name, role), sec in self.self_seconds().items()]
        return sorted(rows, key=lambda r: (-r[3], -r[2]))

    def named_idle_share(self):
        """Percent of the device-idle time inside the consumer's
        bench.next_picture spans under one of its h264.* spans."""
        inner = [(max(s, ps), min(e, pe), name)
                 for s, e, name in self.innermost(self.consumer)
                 for ps, pe in self.next_picture if s < pe and ps < e]
        idle = self.idle_seconds(inner)
        total = sum(idle.values())
        if total <= 0:
            return None
        return 100.0 * (total - idle.get(OUTSIDE, 0.0)) / total

    def frontend_ms(self):
        """Milliseconds of the parse thread's h264.parse and h264.prepare
        spans per h264.prepare span in the window (the front-end as it
        runs beside the consumer), or None without the parse thread."""
        n = sum(1 for *_, name, t in self.spans
                if name == "h264.prepare" and t == self.parse)
        if self.parse is None or not n:
            return None
        sec = self.self_seconds()
        return 1e3 * (sec.get(("h264.parse", "parse"), 0.0) +
                      sec.get(("h264.prepare", "parse"), 0.0)) / n

    def replay_launch_share(self):
        """Percent of the window's cudaGraphLaunch calls made inside an
        h264.replay span of their thread."""
        if not self.graph_launches:
            return None
        replays = [(s, e, t) for s, e, n, t in self.spans
                   if n == "h264.replay"]
        inside = sum(any(t == rt and s <= x <= e for s, e, rt in replays)
                     for x, t in self.graph_launches)
        return 100.0 * inside / len(self.graph_launches)


def read(path: Path) -> Stages | None:
    """The program's spans in the traced window of a Chrome trace, or
    None when the trace holds none (a program without them)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    win = [e for e in events if e["name"] == WINDOW and
           not e.get("cat", "").startswith("gpu_")]
    if not win:
        return None
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])

    def clip(e):
        s = float(e["ts"])
        return (min(max(s, t0), t1) - t0) * 1e-6, \
            (min(max(s + float(e.get("dur", 0)), t0), t1) - t0) * 1e-6

    def within(e):
        s = float(e["ts"])
        return s <= t1 and s + float(e.get("dur", 0)) >= t0
    consumer = win[0]["tid"]
    window_s = (t1 - t0) * 1e-6
    st = Stages(window_s, [], consumer, None)
    busy = []
    for e in events:
        if not within(e):
            continue
        cat, name = e.get("cat", ""), e["name"]
        if cat in DEVICE_OPS:
            busy.append(clip(e))
        elif cat.startswith("gpu_"):
            continue
        elif name.startswith(PREFIX):
            st.spans.append((*clip(e), name, e["tid"]))
        elif name == "bench.next_picture" and e["tid"] == consumer:
            st.next_picture.append(clip(e))
        elif name == "cudaGraphLaunch":
            st.graph_launches.append((clip(e)[0], e["tid"]))
    if not st.spans:
        return None
    _, merged = union(busy)
    edges = [0.0] + [x for iv in merged for x in iv] + [window_s]
    st.idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
               if edges[i + 1] > edges[i]]
    parse = {t for *_, n, t in st.spans if n == "h264.prepare"} - {consumer}
    st.parse = parse.pop() if len(parse) == 1 else None
    return st


@functools.lru_cache(maxsize=1)
def _read(path: str, mtime_ns: int) -> Stages | None:
    """read, once per file and version: the metrics of a run share it."""
    return read(Path(path))


def of(ctx) -> Stages | None:
    """The spans of the run whose result `ctx` holds: read from the
    newest trace_*.json in _out/, the one its traced run just wrote, when
    its window lasts as long as the run's (ctx.trace.window_s); else
    None."""
    traces = sorted(OUT.glob("trace_*.json"), key=lambda p: p.stat().st_mtime)
    if ctx.trace is None or not traces:
        return None
    st = _read(str(traces[-1]), traces[-1].stat().st_mtime_ns)
    if st is None or abs(st.window_s - ctx.trace.window_s) > 1e-3:
        return None
    return st
