"""One run of one benchmark cell, driven by BENCHMARK.json: the cell names
a configuration (configs/<name>.json), a traffic mix
(traffic/<name>.json) and the metrics it reports, each read by
metrics/<metric>.py. A run generates the cell's streams from the seed,
builds the driver of the traffic's mode (drivers.py), warms up, measures
one window (or, traced, one trace_seconds window under torch.profiler),
frees the program's state, decodes the same GOPs with the plain
reference (check.py) and compares every picture the window handed on.

Nothing here imports JAX or the JAX package; the program is imported
only inside run_cell.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import multiprocessing
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = HERE / "_out"               # traced runs' Chrome traces
CACHE = ROOT / ".bench_cache"     # build and kernel caches
FORBIDDEN = ("jax", "jaxlib", "flax", "h264bsd_tpu")

import check  # noqa: E402
import tracing  # noqa: E402
import workload  # noqa: E402
from drivers import DRIVERS  # noqa: E402


class NoDevice(RuntimeError):
    pass


def load_spec() -> dict:
    return workload.load_json(ROOT / "BENCHMARK.json")


def resolve(spec: dict, name: str):
    """(cell, config file, traffic file) of workload `name`."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = workload.load_json(ROOT / entry["file"])
    return cell, config, workload.traffic_of(cell["traffic"])


def cell_metrics(spec: dict, cell: str, traced: bool) -> list:
    """The metric entries the cell reports: end-to-end untraced,
    per-layer traced; an entry with `workloads` only in those cells."""
    entries = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


_READERS: dict = {}


def reader(name: str):
    """metrics/<name>.py, loaded once."""
    if name not in _READERS:
        path = HERE / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[name] = mod
    return _READERS[name]


def prepare_process():
    """The measuring process's environment: build and kernel caches inside
    the checkout, at fixed paths; one PyTorch intra-op thread. The
    decoder's parallelism on the host is its own threads (parse ahead,
    the consumer, a parse worker per stream); PyTorch's default of one
    OpenMP thread per core contends with them for the 8 cores (on the
    H100 host, 16 streams at 640x360 ran 780-1170 fps with the default
    and 1440-1580 with one thread, and drifted less)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch
    torch.set_num_threads(1)


def check_device(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: this benchmark measures the card "
                       "and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} present")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package
    (whole names: the port's name starts with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_ms(streams, device) -> float:
    """Milliseconds per picture of the program's front-end alone (C++
    parse and Decoder._prepare, one thread, no device work) over every
    distinct GOP of the streams."""
    from h264bsd_tpu_torch.frontend import binding as fe
    from h264bsd_tpu_torch.models.decoder import Decoder
    total, frames = 0.0, 0
    for gops in streams.gops:
        for data, _ in gops:
            dec = Decoder(device=device)
            t0 = time.perf_counter()
            pos = 0
            while pos < len(data):
                status, read = dec._fe.decode(data, 0, pos)
                pos += read
                if status == fe.PIC_RDY:
                    dec._prepare()
                    frames += 1
                    while dec._fe.next_output() is not None:
                        pass
            total += time.perf_counter() - t0
            dec.close()
    return 1e3 * total / max(frames, 1)


def _no_span(name):
    return contextlib.nullcontext()


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda", need_device=True,
             patch=None, overrides=None) -> dict:
    """One run; returns the result line's object. patch: a context
    manager factory entered around the program's set-up and window (the
    tests plant faults with it); overrides: {"config": {...}, "traffic":
    {...}} laid over the cell's files (the tests' small sizes)."""
    spec = load_spec()
    cell, config, traffic = resolve(spec, name)
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(part)
    prepare_process()
    if need_device:
        check_device(cell["chips"])
    import torch
    cuda = torch.device(device).type == "cuda"
    seed = int(seed) % 2 ** 64
    pool = multiprocessing.get_context("spawn").Pool(
        min(8, os.cpu_count() or 1))
    phases = {}
    try:
        t = time.perf_counter()
        streams = workload.make_streams(config, traffic, seed, pool)
        phases["generate"] = time.perf_counter() - t
        from h264bsd_tpu_torch.models import graphs
        with (patch() if patch else contextlib.nullcontext()):
            t = time.perf_counter()
            drv = DRIVERS[traffic["mode"]](streams, traffic, seconds, device)
            drv.warm(_no_span)
            phases["warm"] = time.perf_counter() - t
            captures = graphs.STATS["graph_captures"]
            setup_s = time.perf_counter() - t_start
            tr = None
            if traced:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)
                acts = [ProfilerActivity.CPU] + \
                    ([ProfilerActivity.CUDA] if cuda else [])
                with profile(activities=acts) as prof:
                    with record_function(tracing.WINDOW):
                        win = drv.window(traffic["trace_seconds"],
                                         record_function)
                tr = tracing.reduce(prof)
                OUT.mkdir(exist_ok=True)
                prof.export_chrome_trace(str(OUT / f"trace_{name}.json"))
                del prof
            else:
                win = drv.window(seconds, _no_span)
            captures = graphs.STATS["graph_captures"] - captures
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            drv.close()
        del drv
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        counts = {} if traced else None
        t = time.perf_counter()
        ref = check.reference_digests(streams, device, pool, counts=counts)
        phases["reference"] = time.perf_counter() - t
        compared, bad, missing = check.compare(win, streams, ref)
        pm = parse_ms(streams, device) if traced else None
    finally:
        pool.close()
        pool.join()

    ctx = SimpleNamespace(
        window=win, setup_s=setup_s, trace=tr, n_pictures=win.n,
        graph_captures=captures, parse_ms=pm,
        picture_counts=[counts[(i, *streams.gop_of(n))]
                        for i, n in win.keys] if traced else [])
    metrics = {}
    for m in cell_metrics(spec, name, traced):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": compared > 0 and bad == 0 and missing == 0,
              "attempted": compared + missing, "failed": bad + missing,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    if win.lateness:
        result["feeder_late_ms"] = {
            "median": 1e3 * sorted(win.lateness)[len(win.lateness) // 2],
            "max": 1e3 * max(win.lateness)}
    result["phases_s"] = phases
    result["checks"] = {
        "mismatched_pictures": {"value": bad, "limit": 0},
        "missing_pictures": {"value": missing, "limit": 0},
        "pictures_compared": {"value": compared, "limit": 1}}
    return result


def check_lines(result: dict) -> list:
    """The compared numbers beside their limits, one per line."""
    out = []
    for k, v in result["checks"].items():
        rel = "at least" if k == "pictures_compared" else "at most"
        out.append(f"{k} {v['value']} ({rel} {v['limit']})")
    return out

