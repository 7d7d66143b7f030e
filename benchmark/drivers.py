"""The loops that drive the program, one per traffic `mode`:

closed_stream  one stream through decode_stream, each picture taken as
               soon as it is released (closed loop: the next picture is
               asked for when the last has been handed on);
rounds         N streams through MultiStreamDecoder.step(), round by
               round, each picture the round releases taken out of the
               ring in that round with picture(i, j);
paced          one stream fed one access unit at a time through
               StreamingDecoder.queue_input + pump at a fixed rate (open
               loop), each picture timed from its access unit's due time
               to the moment its planes are complete on the device.

Each driver warms up on the cell's own pictures (warm_cycles whole cycles
of the stream's GOPs, so every frame shape's graph is captured before
the window), then runs one window. Every picture the window hands on is
fingerprinted on the device (digest.py) for the comparison with the
reference after the window. `span(name)` marks what the host is doing
for the traced run (a torch.profiler.record_function, or nothing).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

from digest import digest

START_CODE = b"\x00\x00\x00\x01"


def ran_out():
    """The window ends early where the stream runs out: its rate is still
    all the work over all the time of the window, but the traffic's
    max_fps (the GOP cycles the stream holds) should be raised."""
    print("drivers: the stream ran out inside the window; raise the "
          "traffic's max_fps", file=sys.stderr)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """What a window handed on: keys[k] = (stream, n), the n-th output
    picture of that stream, whose digest is digests row k."""
    seconds: float = 0.0
    keys: list = field(default_factory=list)
    digests: list = field(default_factory=list)
    latencies: list = field(default_factory=list)   # seconds, paced only
    lateness: list = field(default_factory=list)    # feeder, paced only
    missing: int = 0

    @property
    def n(self):
        return len(self.keys)

    def digest_rows(self):
        return torch.cat(self.digests).cpu() if self.digests else \
            torch.zeros((0, 3, 3), dtype=torch.float64)


class ClosedStream:
    def __init__(self, streams, traffic, seconds, device):
        from h264bsd_tpu_torch.models.decoder import decode_stream
        per_cycle = streams.gop_len * streams.n_gops
        self.n_warm = traffic["warm_cycles"] * per_cycle
        data = streams.cycle(0, self.n_warm +
                             int(traffic["max_fps"] * (seconds + 1)))
        self.device = device
        self.gen = decode_stream(data, device=device)
        self.n_out = 0

    def _take(self, span, win):
        """Hand on the next picture; False once the stream has run out."""
        with span("bench.next_picture"):
            pic = next(self.gen, None)
        if pic is None:
            ran_out()
            return False
        with span("bench.digest"):
            d = digest(tuple(p[None] for p in pic.planes))
        if win is not None:
            win.keys.append((0, self.n_out))
            win.digests.append(d)
        self.n_out += 1
        return True

    def warm(self, span):
        for _ in range(self.n_warm):
            self._take(span, None)
        sync(self.device)

    def window(self, seconds, span):
        win = Window()
        t0 = time.perf_counter()
        while self._take(span, win) and time.perf_counter() - t0 < seconds:
            pass
        with span("bench.sync"):
            sync(self.device)
        win.seconds = time.perf_counter() - t0
        return win

    def close(self):
        self.gen.close()
        del self.gen


class Rounds:
    def __init__(self, streams, traffic, seconds, device):
        from h264bsd_tpu_torch.parallel.multistream import \
            MultiStreamDecoder
        per_cycle = streams.gop_len * streams.n_gops
        self.n_warm = traffic["warm_cycles"] * per_cycle
        n_pics = self.n_warm + int(traffic["max_fps"] * (seconds + 1))
        self.dec = MultiStreamDecoder(
            [streams.cycle(i, n_pics) for i in range(streams.n_streams)],
            device=device)
        self.taken = [0] * streams.n_streams
        self.device = device

    def _round(self, span, win):
        """Run a round and hand on its pictures; False once the streams
        have run out."""
        with span("bench.step"):
            if not self.dec.step():
                ran_out()
                return False
        keys, pics = [], []
        with span("bench.take"):
            for i, outs in enumerate(self.dec.outputs):
                for j in range(self.taken[i], len(outs)):
                    keys.append((i, j))
                    pics.append(self.dec.picture(i, j))
                self.taken[i] = len(outs)
        if pics:
            with span("bench.digest"):
                d = digest(tuple(torch.stack(p) for p in zip(*pics)))
            if win is not None:
                win.keys += keys
                win.digests.append(d)
        return True

    def warm(self, span):
        for _ in range(self.n_warm):
            self._round(span, None)
        sync(self.device)

    def window(self, seconds, span):
        win = Window()
        t0 = time.perf_counter()
        while self._round(span, win) and time.perf_counter() - t0 < seconds:
            pass
        with span("bench.sync"):
            sync(self.device)
        win.seconds = time.perf_counter() - t0
        return win

    def close(self):
        self.dec.close()
        del self.dec


def access_units(data: bytes) -> list:
    """The access units of one cycle of a stream written with 4-byte
    start codes: each picture's slice NAL unit with the parameter sets
    before it."""
    starts = []
    pos = data.find(START_CODE)
    while pos >= 0:
        starts.append(pos)
        pos = data.find(START_CODE, pos + 4)
    units, begin = [], 0
    for k, s in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else len(data)
        if data[s + 4] & 0x1F in (1, 5):         # a slice ends the unit
            units.append(data[begin:end])
            begin = end
    return units


class Paced:
    """Access unit k is due at t0 + k / rate. Its chunk is the unit
    without its own start code, followed by the next unit's start code
    (the first chunk keeps its start code): the bytes of the stream in
    order, cut so that each chunk completes one access unit, which the
    session then decodes at once (it holds back only an unterminated
    last NAL unit)."""

    def __init__(self, streams, traffic, seconds, device):
        from h264bsd_tpu_torch.models.stream import StreamingDecoder
        self.units = access_units(streams.cycle(0, 1))
        per_cycle = len(self.units)
        if per_cycle != streams.gop_len * streams.n_gops:
            raise RuntimeError("access units do not match the pictures")
        self.n_warm = traffic["warm_cycles"] * per_cycle
        self.rate = float(traffic["rate_fps"])
        self.ready = []
        self.dec = StreamingDecoder(on_picture_ready=self.ready.append,
                                    device=device)
        self.device = device
        self.k = 0          # next access unit
        self.n_out = 0

    def _chunk(self, k):
        unit = self.units[k % len(self.units)]
        return (unit if k == 0 else unit[4:]) + START_CODE

    def _feed(self, span):
        with span("bench.feed"):
            self.dec.queue_input(self._chunk(self.k))
            self.dec.pump()
        self.k += 1

    def warm(self, span):
        for _ in range(self.n_warm):
            self._feed(span)
            for pic in self.ready:
                digest(tuple(p[None] for p in pic.planes))
                self.n_out += 1
            self.ready.clear()
        sync(self.device)

    def window(self, seconds, span):
        win = Window()
        cuda = torch.device(self.device).type == "cuda"
        t0 = time.perf_counter()
        n_due = int(seconds * self.rate)
        for i in range(n_due):
            due = t0 + i / self.rate
            with span("bench.wait_due"):
                while (left := due - time.perf_counter()) > 0:
                    time.sleep(min(left, 0.002) if left > 0.0005 else 0)
            win.lateness.append(time.perf_counter() - due)
            self._feed(span)
            if len(self.ready) != 1:
                win.missing += 1
            for pic in self.ready:
                with span("bench.picture_done"):
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record()
                        ev.synchronize()
                    win.latencies.append(time.perf_counter() - due)
                with span("bench.digest"):
                    win.digests.append(
                        digest(tuple(p[None] for p in pic.planes)))
                win.keys.append((0, self.n_out))
                self.n_out += 1
            self.ready.clear()
        with span("bench.sync"):
            sync(self.device)
        win.seconds = time.perf_counter() - t0
        return win

    def close(self):
        del self.dec


DRIVERS = {"closed_stream": ClosedStream, "rounds": Rounds, "paced": Paced}
