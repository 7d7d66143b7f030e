#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (h264bsd_tpu_torch) on one GPU.

Builds the host front-end (g++) and the CUDA kernels (nvcc) from the
sources in this checkout, holds each kernel byte-equal to its plain
PyTorch version on the card (K1 and K2 also on the row-sharded path's
extended stripes, K9 on the dense row-sharded step's stripe blocks and
on the dense frame_step's whole 1080p P picture, 195,840 blocks; the
dependency-driven K1, K2 and K7 and the MC stage mc_recon, and its
stripe kernel at MB-row offset 34 of 1080p, also over 50 CUDA-graph
replays on fresh planes, a race check), decodes all-intra,
P (IPPP and real motion), partial-loss and SEI streams through
decode_stream, Decoder.decode and
StreamingDecoder (windowable frames replay one CUDA graph per frame
shape), N = 1, 2, 4 and 8 1080p streams through MultiStreamDecoder
(one CUDA graph per round, the N frame bodies side by side on their own
CUDA streams; on 32-picture streams the aggregate fps of a fresh
decoder and of one whose round graphs are all captured, the device's
idle share, parse time and graph captures per N) and small streams
whose I_PCM and spiral-concealed frames run eagerly after the replay
(against the same decoder on the CPU), then the multi-device decoders
on device lists that repeat the one card (GOP-parallel decode with 1
and 2 workers, the row-sharded blob and dense steps at 2 and 4 stripes,
framepipe at 2 and 4 replicas and its eviction, MultiStreamDecoder
sharded over 2 positions), the entry hooks (entry_fn_check, the dense
frame_step of models/entry.py over 1080p IPPP, motion and all-I frames
and the 2x68 strip, then the motion frames once more with each step
profiled, its device time split by stage, run_multichip_dryrun on 2 and
4 positions), the CLI
(a subprocess dumping 1080p IPPP, then --rgba and --render against the
CPU) and bench_torch.py (30 s of timed passes per bench stream, its JSON
lines printed), then the corrupted streams (the fuzz_* entries: 1-4
flipped bytes of the small P streams, the 2x68 strip and the 1080p
all-I, IPPP and motion streams) through decode_stream, and the 1080p ones
also through MultiStreamDecoder at N = 4 and framepipe at 2 replicas,
failing unless K1, K2, K7, K8, mc_recon and the residual stage launched
on them (their launches kept apart, the kernels line's fuzz_launches),
and the tools tools/bench_configs_torch.py (BASELINE.json's config
matrix), bench_scaling_torch.py (1, 2 and 4 positions of the card) and
count_graphs_torch.py with short budgets, and checks every picture's
checksum, and the SEI messages, against the values the JAX package
recorded (h264bsd_tpu_torch/testdata/reference_checksums.json, written
by tools/record_torch_port_checksums.py) and that no decode launches the
MC kernels of the TPU kernels' signature, then times each kernel: its
device time from torch.profiler's kernel events, the CUDA-event time of
the wrapper call, and the plain version's time (K8 also at 1x68, 2x68
and 2x543, and on each frame with every bS 0; K9 also cold, each call on
its own copy of the inputs, rotated over more than 100 MB, and the
bound's share of that time); and the MC route that
mc_recon replaced, on the same inputs. Prints one JSON line per
phase (with the graph captures, replays and eager frames of each decode
phase), then the kernel table, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Any failure raises (exit
code != 0).

Usage: python3 chip_smoke.py     (needs one CUDA device)
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

# the least time the card could take (bound_ms). Bytes: the H100 SXM data
# sheet's HBM rate. Operations: the kernels do int32 ALU work, which has
# no tensor-core path, and a Hopper SM runs 64 INT32 lanes per clock
# (half its 128 FP32 lanes), so 132 SMs x 64 x 1.98 GHz (boost clock) =
# 16.7e12 int32 operations per second.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per filtered pel line (luma / chroma deblocking) and per
# reconstructed pel (intra): prediction, residual add and clip
OPS_LUMA_LINE, OPS_CHROMA_LINE, OPS_INTRA_PEL = 40, 20, 30
# int32 operations of an unclipped 6-tap sum, and of a half-pel value (the
# sum, its rounding and clip), an average, and a bilinear chroma pel (1
# at weight (0, 0): a copy); the inter combine's add and clip per pel
OPS_TAP, OPS_HALF, OPS_AVG, OPS_CHROMA_PEL, OPS_COMBINE_PEL = 10, 14, 3, 10, 3


def luma_case_ops(size):
    """int32 operations per predicted luma pel by fractional case xFrac*4
    + yFrac, for a unit (an MB or a 4x4 block) of size x size pels with
    one MV. The centre j is computed separably: the unclipped horizontal
    sums of the unit's size + 5 window rows once per unit, size + 5 per
    column of size pels, then one vertical tap with its rounding and
    clip; f and q take b from those sums."""
    j = OPS_TAP * (size + 5) / size + OPS_HALF
    half, avg = OPS_HALF, OPS_AVG
    return (1, half + avg, half, half + avg, half + avg, 2 * half + avg,
            j + half + avg, 2 * half + avg, half, j + 4 + avg, j,
            j + 4 + avg, half + avg, 2 * half + avg, j + half + avg,
            2 * half + avg)

# int32 operations of one K9 block: 16 dequant products, two passes of
# four 4-point butterflies (2 shifts and 6 additions each), and the
# rounding add and shift of 16 pels; per pel of the DC-only base, 3
OPS_IDCT_BLOCK, OPS_DC_PEL = 16 + 64 + 32, 3

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "deblock_wf": ("h264bsd_tpu_torch/csrc/deblock_wf.cu",
                   "h264bsd_tpu/ops/pallas_deblock_wf.py:616"),
    "deblock_raster": ("h264bsd_tpu_torch/csrc/deblock_wf.cu",
                       "h264bsd_tpu/ops/pallas_deblock.py:335"),
    "intra_list": ("h264bsd_tpu_torch/csrc/intra_list.cu",
                   "h264bsd_tpu/ops/pallas_intra.py:379"),
    "intra_wf": ("h264bsd_tpu_torch/csrc/intra_wf.cu",
                 "h264bsd_tpu/ops/pallas_intra_wf.py:600"),
    "mc_uniform": ("h264bsd_tpu_torch/csrc/mc.cu",
                   "h264bsd_tpu/ops/pallas_mc.py:174 and :226"),
    "mc_exception": ("h264bsd_tpu_torch/csrc/mc.cu",
                     "h264bsd_tpu/ops/pallas_mc.py:284 and :306"),
    # K3-K6 with the inter combine, the main path's MC stage, and the
    # same on a stripe at an MB-row offset (the row-sharded path)
    "mc_recon": ("h264bsd_tpu_torch/csrc/mc.cu",
                 "h264bsd_tpu/ops/pallas_mc.py:174, :226, :284 and :306"),
    "mc_recon_stripe": ("h264bsd_tpu_torch/csrc/mc.cu",
                        "h264bsd_tpu/ops/pallas_mc.py:174, :226, :284 and "
                        ":306 (mb_row_offset :411)"),
    # K9 with the JAX package's signature, and K9's body as the main
    # path's residual stage
    "idct_blocks": ("h264bsd_tpu_torch/csrc/transform.cu",
                    "h264bsd_tpu/ops/pallas_transform.py:64"),
    "residual_sparse": ("h264bsd_tpu_torch/csrc/transform.cu",
                        "h264bsd_tpu/ops/pallas_transform.py:64"),
}
# each kernel's CUDA functions (their names in the profiler's events) and
# the decode phase whose pictures give its launches per frame
DEVICE_FN = {k: (f"{k}_kernel",) for k in KERNELS}
DEVICE_FN["residual_sparse"] = ("residual_map_kernel", "residual_mb_kernel")
DEVICE_FN["intra_list"] = ("intra_list_pos_kernel", "intra_list_kernel")
# device work of a wrapper beside its kernels, by profiler event name
# prefix: the residual stage's memset of its id map
DEVICE_EXTRA = {"residual_sparse": "Memset"}
PER_FRAME_PHASE = {"deblock_wf": "decode_720p_all_i",
                   "intra_wf": "decode_720p_all_i",
                   "intra_list": "decode_1080p_motion",
                   "deblock_raster": "decode_small",
                   "mc_uniform": "decode_1080p_motion",
                   "mc_exception": "decode_1080p_motion",
                   "mc_recon": "decode_1080p_motion",
                   "mc_recon_stripe": "rowshard",
                   "idct_blocks": "rowshard",
                   "residual_sparse": "decode_1080p_motion"}
# the main path runs K9's body through residual_sparse and K3-K6 through
# mc_recon; mc_uniform and mc_exception are those kernels with the TPU
# kernels' own signatures, which no decode calls. idct_blocks, K9 with
# its own signature, runs on the row-sharded dense step, and
# mc_recon_stripe on every row-sharded stripe (the rowshard phase gives
# their launches per frame)
OFF_PATH = ("mc_uniform", "mc_exception")


def emit(record):
    print(json.dumps(record), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def planes_copy(args):
    return tuple(a.clone() for a in args[:3]) + tuple(args[3:])


def max_abs_err(got, want):
    torch.cuda.synchronize()
    return max(int((g.int() - w.int()).abs().max()) for g, w in
               zip(got, want))


def timed_ms(fn, args, reps):
    """Mean CUDA-event time of fn on fresh copies of the planes (the
    kernels work in place), copies outside the timed region."""
    total = 0.0
    for _ in range(reps):
        a = planes_copy(args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(fn, args, reps, name, attempts=3):
    """Device time per call of kernel `name`, each of whose CUDA
    functions launches once per call: for each, the mean duration of its
    torch.profiler kernel events over `reps` calls on fresh copies of the
    planes (the copies are other kernels, not counted), summed, plus the
    wrapper's other device work of DEVICE_EXTRA per call. The mean, not
    the sum, because the profiler may drop an event (it recorded 19 of 20
    launches of K8 once, and none of 20 of K9 once): a profiled run that
    recorded no event of a function is made again, up to `attempts`
    runs. Returns (ms, kernel events recorded per call)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn(*planes_copy(args))
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        us = {f: [e.time_range.end - e.time_range.start for e in dev
                  if e.name.split("(")[0] == f] for f in DEVICE_FN[name]}
        if all(us.values()):
            break
    else:
        missing = [f for f, u in us.items() if not u]
        raise AssertionError(f"{name}: the profiler recorded no device time "
                             f"of {missing} in {attempts} runs")
    ms = sum(sum(u) / len(u) for u in us.values()) / 1e3
    extra = DEVICE_EXTRA.get(name)
    if extra:
        ms += sum(e.time_range.end - e.time_range.start for e in dev
                  if e.name.startswith(extra)) / reps / 1e3
    return ms, sum(len(u) for u in us.values()) / reps


# a cold reading's copies of the inputs hold more than this: twice the
# H100's 50 MB L2 cache
COLD_BYTES = 100e6


def cold_device_ms(fn, args, reps, name):
    """device_ms of kernel `name` on inputs the L2 cache does not hold, as
    the bytes bound assumes: call i takes copy i mod c of `args` (made
    before the profiled run, which then copies nothing), the c copies
    together more than COLD_BYTES. Only the kernel's own events count.
    Returns (ms, the copies c)."""
    copies = [tuple(a.clone() for a in args)
              for _ in range(int(COLD_BYTES // nbytes(args)) + 2)]
    rot = itertools.cycle(copies)
    return device_ms(lambda: fn(*next(rot)), (), reps, name)[0], len(copies)


def route_device_ms(fn, args, reps):
    """Device time per call of everything fn(*args) runs on the card
    (kernels, copies, fills: every CUDA event of torch.profiler), the
    mean over `reps` calls after a warm one, and the CUDA events per
    call."""
    fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.end - e.time_range.start for e in dev) / reps
            / 1e3, len(dev) / reps)


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def graph_replays_err(kernel, plain, args, dims, replays):
    """Capture one call of `kernel` in a CUDA graph and replay it
    `replays` times, each on a fresh copy of the planes (and into outputs
    filled with a sentinel first, for a kernel that returns new planes);
    returns the largest max |err| of a replay against the plain version.
    A race between the blocks of a dependency-driven kernel, or a pel a
    replay leaves unwritten, would show as a replay that differs."""
    want = plain(*planes_copy(args), *dims)
    static = planes_copy(args)
    kernel(*planes_copy(args), *dims)        # warm: libraries, tables
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(*static, *dims)
    worst = 0
    for _ in range(replays):
        for o in out:
            o.fill_(0xA5)
        for dst, src in zip(static[:3], args[:3]):
            dst.copy_(src)
        graph.replay()
        worst = max(worst, max_abs_err(out, want))
    return worst


def mc_ops(mvx, mvy, size):
    """int32 operations of the one fractional case each predicted unit (an
    MB, size 16, or a 4x4 block, size 4, with its MV) needs: size^2 luma
    pels and 2 x (size/2)^2 chroma pels."""
    mvx, mvy = mvx.long(), mvy.long()
    frac = (mvx & 3) * 4 + (mvy & 3)
    per = torch.as_tensor(luma_case_ops(size), dtype=torch.float64,
                          device=frac.device)[frac]
    chroma = torch.where(((mvx | mvy) & 7) != 0, OPS_CHROMA_PEL, 1)
    return int(per.sum()) * size * size \
        + int(chroma.sum()) * 2 * (size // 2) ** 2


def mc_recon_bound(args):
    """(bytes, int32 operations) the main path's MC stage needs on
    mc_recon_cuda's arguments."""
    _, _, _, mv, ref_slot, mb_class, _, _, pcm = args
    n = mv.shape[0]
    inter = (mb_class == 1) | (mb_class == 2)
    slot = ref_slot.long().clamp(0, args[0].shape[0] - 1)
    uniform = (mv == mv[:, :1]).all(2).all(1) \
        & (slot == slot[:, :1]).all(1)
    n_inter = int(inter.sum())
    n_pcm = 0 if pcm is None else int((mb_class == 5).sum())
    # per inter MB its ring pels read once, its int32 residual and its
    # pels written, and its motion (64 + 16 bytes); per other MB its
    # pels written (and read from the PCM grids on an I_PCM MB); the
    # class of every MB
    byt = n_inter * (384 + 1536 + 384 + 80) + (n - n_inter) * 384 \
        + n_pcm * 384 + n
    # an MB whose blocks share block 0's motion is one 16x16 unit, any
    # other inter MB 16 4x4 units; the combine on every inter pel
    split = mv[inter & ~uniform].reshape(-1, 2)
    ops = mc_ops(mv[inter & uniform][:, 0, 0],
                 mv[inter & uniform][:, 0, 1], 16) \
        + mc_ops(split[:, 0], split[:, 1], 4) \
        + n_inter * 384 * OPS_COMBINE_PEL
    return byt, ops


# the multistream phase's streams, in order (recorded names)
MULTISTREAM = ("motion_1080p", "ippp_1080p", "motion_1080p_s1",
               "ippp_1080p_qp30", "motion_1080p_s2", "stream_ippp_1080p",
               "motion_1080p_s3", "ippp_1080p_qp22")
# the timed and profiled passes' streams, the first N: the same makers
# at LONG_PICTURES pictures each, motion seeds 0-3 between IPPP streams
# at four QPs
LONG_PICTURES = 32
LONG_MIX = tuple(
    dict(module="motion_stream", maker="make_motion_stream",
         args=[120, 68, LONG_PICTURES], kwargs=dict(seed=v))
    if kind == "motion" else
    dict(maker="make_ippp_stream", args=[120, 68, LONG_PICTURES],
         kwargs=dict(qp=v))
    for kind, v in (("motion", 0), ("ippp", 26), ("motion", 1),
                    ("ippp", 30), ("motion", 2), ("ippp", 34),
                    ("motion", 3), ("ippp", 22)))
# the kernels every multistream run launches: K7 on the I pictures, K2 on
# the motion streams' intra MBs, K1, the MC and residual stages
MULTISTREAM_KERNELS = ("intra_wf", "intra_list", "deblock_wf", "mc_recon",
                       "residual_sparse")
# streams of one geometry (4x4 MBs) whose frames run the eager body on
# their ring slice after the round's replay: an I_PCM stream (pcm=) and
# a lost IDR slice (spiral=), beside an IPPP stream and a lost P slice
# that stay in the graph; recorded names, or (label, maker, args)
MULTISTREAM_EAGER = ("ippp_4x4", ("pcm_4x4", "make_pcm_stream", (4, 4)),
                     "loss_idr_slice", "loss_p_slice")


def picture_checksum(dec, i, j):
    """frame_checksum_host of picture j of stream i of a
    MultiStreamDecoder, read from its ring now."""
    from h264bsd_tpu_torch.models.decoder import frame_checksum_host
    return frame_checksum_host(b"".join(
        p.cpu().numpy().tobytes() for p in dec.picture(i, j)))


def multistream_rounds(dec):
    """Step dec to its end; returns, per stream, the checksums of its
    pictures, each taken in the round that released it (later rounds
    may overwrite its slot), and the rounds run."""
    got = [[] for _ in dec.outputs]
    rounds = 0
    while dec.step():
        rounds += 1
        for i, sums in enumerate(got):
            sums += [picture_checksum(dec, i, j) for j in
                     range(len(sums), len(dec.outputs[i]))]
    dec.close()
    return got, rounds


def multistream(names, long_streams, recorded_stream, launches):
    """Decode the recorded streams `names` together with
    MultiStreamDecoder round by round (step()), every released picture's
    checksum against the recorded one, with the launch counts set to 0
    just before and read just after (added to `launches`); then replay
    each round key's graph 50 times more, every replay leaving the ring
    byte-equal to the first (a race check). Then decode `long_streams`
    (LONG_PICTURES each) three times with the pipelined run():
    - cold: a fresh decoder, its graph captures included (aggregate fps,
      captures and their host ms);
    - warm: a decoder of the same streams on the cold one's ring and
      round graphs, so every round key is captured already (the steady
      aggregate fps; it must capture nothing);
    - warm under torch.profiler: the device's busy time and idle share,
      and the device time of each kernel and of the glue per picture;
    each stream's last picture equal in all three; and time the host
    half alone (_parse_round, the streams on worker threads). Returns
    the record."""
    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
    from h264bsd_tpu_torch.ops import _kernels
    from h264bsd_tpu_torch.parallel.multistream import MultiStreamDecoder
    from tools.profile_torch_port import busy_us, our_kernels

    n = len(names)
    entries, streams = zip(*(recorded_stream(x) for x in names))
    want = [e["checksums"] for e in entries]

    # checksums of every picture, round by round
    dec = MultiStreamDecoder(list(streams))
    _kernels.reset_launches()
    reset_stats()
    got, rounds = multistream_rounds(dec)
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    stats = dict(STATS)
    # a race check of the N bodies side by side: a round graph's replay is
    # idempotent (a body reads reference slots and writes its own), so
    # every one of 50 more replays of each round key's graph leaves the
    # ring as its first replay did
    race_err = 0
    for graph in dec._shards[0].graphs.values():
        graph.graph.replay()
        first = [p.clone() for p in dec.dpb]
        for _ in range(50):
            graph.graph.replay()
            race_err = max(race_err, max_abs_err(dec.dpb, first))
    if race_err:
        raise AssertionError(f"multistream {names}: a round graph's replays "
                             f"differ (max |err| {race_err})")
    for k, v in counts.items():
        launches[k] += v
    if got != want:
        raise AssertionError(f"multistream {names}: checksums {got} != "
                             f"recorded {want}")
    if not all(counts[k] > 0 for k in MULTISTREAM_KERNELS):
        raise AssertionError(f"multistream {names}: kernels "
                             f"{MULTISTREAM_KERNELS} not all launched: "
                             f"{counts}")
    if stats["graph_captures"] == 0:
        raise AssertionError(f"multistream {names}: no round ran as a "
                             f"graph: {stats}")

    long_streams = list(long_streams[:n])
    n_pics = n * LONG_PICTURES

    def run(dec):
        reset_stats()
        t0 = time.perf_counter()
        counts = dec.run(pipelined=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if counts != [LONG_PICTURES] * n:
            raise AssertionError(f"multistream {names}: {counts} pictures "
                                 f"of {LONG_PICTURES}-picture streams")
        last = [picture_checksum(dec, i, -1) for i in range(n)]
        dec.close()
        return wall, dict(STATS), last

    def warm(cold):
        """A decoder of the long streams on `cold`'s ring and round
        graphs: its rounds are cold's, so their keys are captured."""
        dec = MultiStreamDecoder(long_streams)
        dec.geom, dec._shards = cold.geom, cold._shards
        return dec

    cold = MultiStreamDecoder(long_streams)
    cold_wall, cold_stats, cold_last = run(cold)
    wall, warm_stats, last = run(warm(cold))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        p_wall, p_stats, p_last = run(warm(cold))
    if not cold_last == last == p_last:
        raise AssertionError(f"multistream {names}: the long streams' last "
                             f"pictures differ between runs: {cold_last}, "
                             f"{last}, {p_last}")
    if warm_stats["graph_captures"] or p_stats["graph_captures"]:
        raise AssertionError(f"multistream {names}: a warm run captured: "
                             f"{warm_stats}, {p_stats}")
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in dev_events]) / 1e3
    ours = our_kernels()
    by_kernel = {}
    for e in dev_events:
        name = e.name.split("(")[0]
        name = name if name in ours else "glue"
        by_kernel[name] = by_kernel.get(name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3 / n_pics

    dec = MultiStreamDecoder(long_streams)
    long_rounds = 0
    t0 = time.perf_counter()
    while dec._parse_round() is not None:
        long_rounds += 1
    parse_ms = 1e3 * (time.perf_counter() - t0)
    dec.close()
    return {"streams": list(names), "pictures": sum(map(len, want)),
            "rounds": rounds, "checksums_ok": True, "launches": counts,
            "step_graph_captures": stats["graph_captures"],
            "step_graph_replays": stats["graph_replays"],
            "step_eager_frames": stats["eager_frames"],
            "race_replays": 50 * stats["graph_captures"],
            "long_pictures": n_pics, "long_rounds": long_rounds,
            "fps_cold": n_pics / cold_wall,
            "graph_captures": cold_stats["graph_captures"],
            "capture_ms": cold_stats["capture_ms"],
            "fps": n_pics / wall,
            "warm_graph_replays": warm_stats["graph_replays"],
            "warm_eager_frames": warm_stats["eager_frames"],
            "profiled_wall_ms": 1e3 * p_wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / (1e3 * p_wall),
            "device_ms_per_picture": by_kernel,
            "parse_ms_per_round": parse_ms / long_rounds,
            "parse_ms_per_stream_picture": parse_ms / n_pics,
            "host_cpus": os.cpu_count()}


def multistream_eager(recorded_stream, launches):
    """MULTISTREAM_EAGER through MultiStreamDecoder on the card and on
    the CPU, round by round: every picture equal in the round that
    released it, the recorded streams' checksums equal to the recorded
    ones, and the card's run with eager frames (the pictures run after
    the replay) as well as a graph. The card run's launch counts are
    added to `launches`. Returns the record."""
    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
    from h264bsd_tpu_torch.ops import _kernels
    from h264bsd_tpu_torch.parallel.multistream import MultiStreamDecoder
    from h264bsd_tpu_torch.utils import streamgen

    names, streams, want = [], [], []
    for s in MULTISTREAM_EAGER:
        if isinstance(s, str):
            e, data = recorded_stream(s)
            names.append(s)
            streams.append(data)
            want.append(e["checksums"])
        else:
            names.append(s[0])
            streams.append(getattr(streamgen, s[1])(*s[2]))
            want.append(None)
    _kernels.reset_launches()
    reset_stats()
    got, rounds = multistream_rounds(MultiStreamDecoder(streams))
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    stats = dict(STATS)
    for k, v in counts.items():
        launches[k] += v
    cpu, cpu_rounds = multistream_rounds(MultiStreamDecoder(streams,
                                                            device="cpu"))
    if (got, rounds) != (cpu, cpu_rounds):
        raise AssertionError(f"multistream {names}: the card's pictures "
                             f"{got} != the CPU's {cpu}")
    for name, sums, rec in zip(names, got, want):
        if rec is not None and sums != rec:
            raise AssertionError(f"multistream {name}: checksums {sums} != "
                                 f"recorded {rec}")
    if stats["eager_frames"] == 0 or stats["graph_captures"] == 0:
        raise AssertionError(f"multistream {names}: no eager frame or no "
                             f"graph: {stats}")
    return {"streams": names, "pictures": sum(map(len, got)),
            "rounds": rounds, "checksums_ok": True, **stats,
            "launches": counts}


# ---- the multi-device decoders (parallel/gop.py, rowshard.py,
# framepipe.py, multistream.py's mesh=) on device lists that repeat the
# one card: every stripe, halo, hand-off and replica path runs, no
# multi-GPU scaling is measured

# the card the device lists repeat
CARD = "cuda:0"
# the gop phase's stream: four closed GOPs, the recorded 1080p motion
# streams one after another
GOP_PARTS = ("motion_1080p", "motion_1080p_s1", "motion_1080p_s2",
             "motion_1080p_s3")
# the kernels each decoder's run must launch
GOP_KERNELS = ("intra_list", "deblock_wf", "mc_recon", "residual_sparse")
ROWSHARD_KERNELS = {"blob": ("intra_list", "deblock_wf", "mc_recon_stripe",
                             "residual_sparse"),
                    "dense": ("intra_list", "deblock_wf", "mc_recon_stripe",
                              "idct_blocks")}


def counted(fn):
    """Run fn() with the launch counts and graph stats set to 0 just
    before; returns (its result, wall seconds ending in a synchronize,
    launch counts, graph stats)."""
    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
    from h264bsd_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    reset_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, dict(_kernels.LAUNCHES), dict(STATS)


def need_launched(phase, counts, kernels):
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: kernels {missing} never launched: "
                             f"{counts}")


def checksums_of(pics):
    from h264bsd_tpu_torch.models.decoder import frame_checksum_host
    return [frame_checksum_host(p.yuv_bytes()) for p in pics]


def gop_phase(recorded_stream, launches):
    """decode_stream_gop_parallel on GOP_PARTS concatenated, with 1 and 2
    workers on ["cuda:0"] (each worker's decoder keeps its ring and graphs
    across its segments); the pictures' checksums against the recorded
    lists concatenated, the fps (pictures collected, then the checksums)
    beside decode_stream's on the same stream, captures and launches."""
    from h264bsd_tpu_torch.models.decoder import decode_stream
    from h264bsd_tpu_torch.parallel.gop import (decode_stream_gop_parallel,
                                                split_gops)

    entries, parts = zip(*(recorded_stream(n) for n in GOP_PARTS))
    data = b"".join(parts)
    want = [c for e in entries for c in e["checksums"]]
    if len(split_gops(data)) != len(GOP_PARTS):
        raise AssertionError("gop: the stream does not split into "
                             f"{len(GOP_PARTS)} GOPs")
    rec = {"streams": list(GOP_PARTS), "pictures": len(want),
           "checksums_ok": True}
    for workers in (1, 2):
        pics, wall, counts, stats = counted(lambda: list(
            decode_stream_gop_parallel(data, devices=[CARD],
                                       threads=workers)))
        if checksums_of(pics) != want:
            raise AssertionError(f"gop, {workers} workers: checksums differ "
                                 "from the recorded ones")
        need_launched(f"gop, {workers} workers", counts, GOP_KERNELS)
        for k, v in counts.items():
            launches[k] += v
        rec[f"workers_{workers}"] = {
            "fps": len(pics) / wall, "wall_ms": 1e3 * wall, **stats,
            "launches_per_picture": {k: v / len(pics)
                                     for k, v in counts.items() if v}}
    pics, wall, _, stats = counted(lambda: list(decode_stream(data,
                                                              device=CARD)))
    if checksums_of(pics) != want:
        raise AssertionError("gop: decode_stream's checksums differ")
    rec["decode_stream"] = {"fps": len(pics) / wall, **stats}
    return rec


def rowshard_decode(data, mesh, kind, max_frames=None):
    """Decode `data` frame by frame through the row-sharded step (blob or
    dense) on `mesh`'s "row" axis; returns the pictures' checksums in
    display order, read from position 0's ring after checking that every
    replica holds the same picture, the frames decoded, and the seconds
    of the step calls (from the call to the end of its device work). With
    max_frames, the pictures of the first max_frames frames (the
    front-end flushed after them)."""
    from h264bsd_tpu_torch.frontend import binding as fe
    from h264bsd_tpu_torch.models.decoder import (Decoder,
                                                  frame_checksum_host,
                                                  pin_caps_for_stream)
    from h264bsd_tpu_torch.models.state import new_ring
    from h264bsd_tpu_torch.ops.reconstruct import build_pcm_tensors
    from h264bsd_tpu_torch.parallel.rowshard import (
        make_row_sharded_blob_step, make_row_sharded_step)

    n_row = mesh.shape["row"]
    dec = Decoder(caps_pin=pin_caps_for_stream(data), device="cpu")
    dpb, steps, sums, pos, frames = None, {}, [], 0, 0

    step_s = 0.0

    def take_outputs():
        while (o := dec._fe.next_output()) is not None:
            pics = [b"".join(p[k][o["slot"]].cpu().numpy().tobytes()
                             for p in dpb) for k in range(n_row)]
            if any(x != pics[0] for x in pics):
                raise AssertionError("rowshard: the replicas' rings differ")
            sums.append(frame_checksum_host(pics[0]))

    while pos < len(data):
        status, read = dec._fe.decode(data, len(sums), pos)
        pos += read
        if status == fe.HDRS_RDY:
            dpb = None
        elif status == fe.PIC_RDY:
            prep = dec._prepare()
            g, n = prep["geom"], prep["n_mbs"]
            w, h = prep["w_mbs"], prep["h_mbs"]
            if dpb is None:
                dpb = tuple(mesh.replicate(p) for p in new_ring(
                    g["dpb_slots"], g["height_mbs"], g["width_mbs"],
                    mesh.devices[0]))
            pcm = build_pcm_tensors(n, *prep["ipcm"])
            slot = prep["info"]["slot"]
            if kind == "blob":
                if prep["caps"] not in steps:
                    steps[prep["caps"]] = make_row_sharded_blob_step(
                        mesh, "row", w, h, prep["caps"])
                pcm_t = tuple(torch.from_numpy(p) for p in pcm) \
                    if len(prep["ipcm"][0]) else (None,) * 3
                t0 = time.perf_counter()
                steps[prep["caps"]](prep["blob"], *pcm_t, *dpb, slot)
            else:
                t = dec._fe.tensors(n)
                t["pcm_y"], t["pcm_cb"], t["pcm_cr"] = pcm
                t0 = time.perf_counter()
                make_row_sharded_step(mesh, "row", w, h)(t, *dpb, slot)
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t0
            frames += 1
            if max_frames is not None and frames == max_frames:
                dec._fe.flush_buffer()
                take_outputs()
                break
            take_outputs()
        elif status >= fe.ERROR and read == 0:
            break
    dec.close()
    return sums, frames, step_s


def rowshard_phase(recorded_stream, launches, per_frame):
    """ippp_1080p and motion_1080p through the blob step, and their first
    two frames through the dense step (K9's idct_blocks), at 2 and 4
    stripes of ["cuda:0"]: checksums against the recorded ones, ms per
    frame (eager, stripe after stripe), launches per frame."""
    from h264bsd_tpu_torch.parallel.mesh import Mesh

    rec = {}
    dense_counts, dense_frames = {k: 0 for k in KERNELS}, 0
    stripe_launches, all_frames = 0, 0
    for name in ("ippp_1080p", "motion_1080p"):
        e, data = recorded_stream(name)
        for kind, max_frames in (("blob", None), ("dense", 2)):
            for n_row in (2, 4):
                mesh = Mesh([CARD] * n_row, ("row",))
                (sums, frames, step_s), _, counts, _ = counted(
                    lambda: rowshard_decode(data, mesh, kind, max_frames))
                if not sums or sums != e["checksums"][:len(sums)] or (
                        max_frames is None and sums != e["checksums"]):
                    raise AssertionError(
                        f"rowshard {name} {kind} {n_row}: checksums {sums} "
                        f"!= recorded {e['checksums']}")
                need_launched(f"rowshard {name} {kind} {n_row}", counts,
                              ROWSHARD_KERNELS[kind])
                for k, v in counts.items():
                    launches[k] += v
                stripe_launches += counts["mc_recon_stripe"]
                all_frames += frames
                if kind == "dense":
                    dense_frames += frames
                    for k, v in counts.items():
                        dense_counts[k] += v
                rec[f"{name}_{kind}_{n_row}"] = {
                    "frames": frames, "pictures": len(sums),
                    "ms_per_frame": 1e3 * step_s / frames,
                    "launches_per_frame": {k: v / frames
                                           for k, v in counts.items() if v}}
    per_frame["idct_blocks"] = dense_counts["idct_blocks"] / dense_frames
    per_frame["mc_recon_stripe"] = stripe_launches / all_frames
    return {"checksums_ok": True, **rec}


def framepipe_phase(recorded_stream, long_ippp, launches):
    """decode_stream_framepipe at 2 and 4 replicas of ["cuda:0"]: the
    recorded ippp_1080p's checksums; on a 32-picture IPPP stream its fps
    (a fresh run, its captures included) beside decode_stream's, every
    picture equal, and the hand-off's device ms per frame; and a small
    stream whose first slice is corrupted (the eviction) against the
    decoder on the CPU."""
    from h264bsd_tpu_torch.models.decoder import decode_stream
    from h264bsd_tpu_torch.parallel.framepipe import (
        _handoff, decode_stream_framepipe)
    from h264bsd_tpu_torch.parallel.gop import _nal_positions
    from h264bsd_tpu_torch.parallel.mesh import Mesh
    from h264bsd_tpu_torch.utils import streamgen

    e, data = recorded_stream("ippp_1080p")
    ref_pics, ref_wall, _, ref_stats = counted(
        lambda: list(decode_stream(long_ippp, device=CARD)))
    ref_sums = checksums_of(ref_pics)
    del ref_pics
    rec = {"decode_stream_fps": len(ref_sums) / ref_wall,
           "decode_stream_captures": ref_stats["graph_captures"]}
    for n in (2, 4):
        mesh = Mesh([CARD] * n, ("pipe",))
        pics, _, counts, _ = counted(
            lambda: list(decode_stream_framepipe(data, mesh, "pipe")))
        if checksums_of(pics) != e["checksums"]:
            raise AssertionError(f"framepipe {n}: checksums differ from "
                                 "the recorded ones")
        need_launched(f"framepipe {n}", counts, ("mc_recon", "deblock_wf",
                                                 "residual_sparse"))
        for k, v in counts.items():
            launches[k] += v
        pics, wall, counts, stats = counted(
            lambda: list(decode_stream_framepipe(long_ippp, mesh, "pipe")))
        if checksums_of(pics) != ref_sums:
            raise AssertionError(f"framepipe {n}: the 32-picture stream "
                                 "differs from decode_stream's")
        # the hand-off of one 1080p slot into the n-1 other replicas
        replicas = tuple([torch.zeros((2,) + tuple(p.shape),
                                      dtype=torch.uint8, device=CARD)
                          for _ in range(n)] for p in pics[0].planes)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(20):
            _handoff(*replicas, k % n, 1)
        end.record()
        end.synchronize()
        rec[f"replicas_{n}"] = {
            "pictures": len(pics), "fps": len(pics) / wall, **stats,
            "handoff_ms_per_frame": start.elapsed_time(end) / 20,
            "launches_per_picture": {k: v / len(pics)
                                     for k, v in counts.items() if v}}
        del pics
    # eviction: a partial loss without a reference on the owner, repaired
    # on the host and handed to every replica
    bad = bytearray(streamgen.make_ippp_stream(4, 4, 6))
    nals = _nal_positions(bytes(bad))
    first = next(k for k, x in enumerate(nals) if x[2] in (1, 5))
    at = nals[first][0]
    bad[at + int((nals[first + 1][1] - at) * 0.8)] ^= 0xFF
    bad = bytes(bad)
    want = [p.yuv_bytes() for p in decode_stream(bad, device="cpu")]
    got, _, _, stats = counted(lambda: [p.yuv_bytes() for p in
                                        decode_stream_framepipe(
                                            bad, Mesh([CARD] * 2,
                                                      ("pipe",)), "pipe")])
    if got != want or stats["eager_frames"] == 0:
        raise AssertionError(f"framepipe eviction: the card's pictures "
                             f"differ from the CPU's, or nothing was "
                             f"evicted: {stats}")
    rec["eviction"] = {"pictures": len(got), **stats}
    return {"checksums_ok": True, **rec}


def multistream_mesh_phase(recorded_stream, long_streams, launches):
    """MultiStreamDecoder on N = 4 recorded 1080p streams sharded over 2
    positions of ["cuda:0"] (each position's block of two streams with
    its own ring and round graph), round by round: every picture's
    checksum against the recorded one; then the 32-picture streams, a
    fresh decoder (aggregate fps, captures included)."""
    from h264bsd_tpu_torch.parallel.mesh import Mesh
    from h264bsd_tpu_torch.parallel.multistream import MultiStreamDecoder

    names = MULTISTREAM[:4]
    mesh = Mesh([CARD] * 2, ("stream",))
    entries, streams = zip(*(recorded_stream(x) for x in names))
    (got, rounds), _, counts, stats = counted(lambda: multistream_rounds(
        MultiStreamDecoder(list(streams), mesh=mesh)))
    if got != [e["checksums"] for e in entries]:
        raise AssertionError(f"multistream_mesh: checksums {got} differ "
                             "from the recorded ones")
    need_launched("multistream_mesh", counts, MULTISTREAM_KERNELS)
    for k, v in counts.items():
        launches[k] += v
    dec = MultiStreamDecoder(list(long_streams[:4]), mesh=mesh)
    n_pics, wall, _, long_stats = counted(lambda: sum(dec.run()))
    dec.close()
    return {"streams": list(names), "positions": 2, "rounds": rounds,
            "checksums_ok": True, **stats, "launches": counts,
            "long_pictures": n_pics, "fps_cold": n_pics / wall,
            "long_graph_captures": long_stats["graph_captures"],
            "long_capture_ms": long_stats["capture_ms"]}


# the entry phase's streams: IPPP and motion 1080p (K9, mc_recon, K2 on
# the motion stream's intra MBs, K1), all-I 1080p (K7) and the 2x68
# strip (K8), through the dense frame_step; the kernels each must launch
ENTRY_STREAMS = ("ippp_1080p", "motion_1080p", "intra_1080p", "ippp_2x68")
ENTRY_KERNELS = ("idct_blocks", "mc_recon", "intra_list", "intra_wf",
                 "deblock_wf", "deblock_raster")
# the stream whose dense frame_step the entry phase splits by stage: an I
# picture (K7) and four P pictures (mc_recon, K2 on their intra MBs)
SPLIT_STREAM = "motion_1080p"
# the kernels each multi-device dry run must launch: the dense stripes
# (K9, the stripe MC kernel), the blob stripes and the main path's frame
# body (residual stage, mc_recon), K2 and K1 on every path
DRYRUN_KERNELS = ("idct_blocks", "mc_recon_stripe", "mc_recon",
                  "residual_sparse", "intra_list", "deblock_wf")


# the dense frame_step's device work by stage, in the order it runs on
# its stream: the residual transform's PyTorch glue up to K9
# (residual_blocks: DC transforms, dequant scales, external DC and skip
# flags), K9, the empty-block mask and the residuals' plane layout,
# mc_recon, the intra stage (K2's scratch, K2 or K7), the deblocking
# filter (bS and thresholds, then K1 or K8), the store into the ring
# slot; "upload" is every host-to-device copy (the front-end's tensors,
# K2's list). A port kernel's event goes to its own stage, and the glue
# after it to the stage that follows it (SPLIT_KERNELS: stage, the glue
# stage after it or None)
SPLIT_STAGES = ("upload", "residual_blocks glue", "K9",
                "residual mask glue", "mc_recon", "intra", "deblock",
                "store")
SPLIT_KERNELS = {"idct_blocks_kernel": ("K9", "residual mask glue"),
                 "mc_recon_kernel": ("mc_recon", "intra"),
                 "intra_list_pos_kernel": ("intra", None),
                 "intra_list_kernel": ("intra", "deblock"),
                 "intra_wf_kernel": ("intra", "deblock"),
                 "deblock_wf_kernel": ("deblock", "store"),
                 "deblock_raster_kernel": ("deblock", "store")}


def frame_split(events):
    """Device microseconds of one dense frame_step by stage (SPLIT_STAGES)
    from its profiler events, and whether the events held each of its
    stages' kernels (the profiler may drop an event)."""
    dev = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    split = dict.fromkeys(SPLIT_STAGES, 0.0)
    glue, seen = "residual_blocks glue", set()
    for e in dev:
        us = e.time_range.end - e.time_range.start
        own, after = SPLIT_KERNELS.get(e.name.split("(")[0], (None, None))
        if e.name.startswith("Memcpy HtoD"):
            split["upload"] += us
        elif own is None:
            split[glue] += us
        else:
            split[own] += us
            seen.add(own)
            glue = after or glue
    return split, seen == {"K9", "mc_recon", "intra", "deblock"}


def entry_decode(data, split=None):
    """Decode `data` frame by frame with models/entry.frame_step on the
    front-end's dense tensors (entry.dense_frames) on the card; returns
    the checksums of its pictures in display order (each taken on the
    card from its ring slot when the front-end releases it, read back
    once), the frames decoded and the seconds of the frame_step calls,
    each to the end of its device work. split: a list that gets each
    frame's frame_split, from a torch.profiler run around its step (the
    seconds then include the profiler's cost)."""
    from h264bsd_tpu_torch.models.decoder import frame_checksum_device
    from h264bsd_tpu_torch.models.entry import dense_frames, frame_step
    from h264bsd_tpu_torch.models.state import new_ring

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ring, shape, sums, frames, step_s = None, None, [], 0, 0.0
    for t, slot, g, released in dense_frames(data):
        w, h = g["width_mbs"], g["height_mbs"]
        if (g["dpb_slots"], h, w) != shape:
            shape = (g["dpb_slots"], h, w)
            ring = new_ring(*shape, CARD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if split is None:
            frame_step(t, *ring, slot, w, h)
            torch.cuda.synchronize()
        else:
            with torch.profiler.profile(activities=acts) as prof:
                frame_step(t, *ring, slot, w, h)
                torch.cuda.synchronize()
            split.append(frame_split(prof.events()))
        step_s += time.perf_counter() - t0
        frames += 1
        sums += [frame_checksum_device(*(p[s] for p in ring), 384 * w * h)
                 for s in released]
    return torch.stack(sums).cpu().tolist(), frames, step_s


def entry_phase(recorded_stream, launches):
    """entry_fn_check() on the card against entry_fn_and_args on the CPU;
    then the dense frame_step on ENTRY_STREAMS, every picture's checksum
    against the recorded one, ms per frame and launches per frame; fails
    unless each of ENTRY_KERNELS launched. Then SPLIT_STREAM once more,
    each frame profiled: its device ms per frame by stage (frame_split),
    the checksums checked again."""
    from h264bsd_tpu_torch.models.entry import (entry_fn_and_args,
                                                entry_fn_check)

    card, _, total, _ = counted(entry_fn_check)
    fn, args = entry_fn_and_args(device="cpu")
    if not all(torch.equal(c.cpu(), w) for c, w in zip(card, fn(*args))):
        raise AssertionError("entry: entry_fn_check on the card differs "
                             "from entry_fn_and_args on the CPU")
    rec = {"entry_fn_check": "card equals cpu"}
    frames_all = k9_all = 0
    for name, stream, split in ([(n, n, None) for n in ENTRY_STREAMS]
                                + [("split", SPLIT_STREAM, [])]):
        e, data = recorded_stream(stream)
        (sums, frames, step_s), _, counts, _ = counted(
            lambda: entry_decode(data, split))
        if sums != e["checksums"]:
            raise AssertionError(f"entry {name}: frame_step checksums {sums} "
                                 f"!= recorded {e['checksums']}")
        frames_all += frames
        k9_all += counts["idct_blocks"]
        for k, v in counts.items():
            total[k] += v
        rec[name] = {"frames": frames, "pictures": len(sums),
                     "ms_per_frame": 1e3 * step_s / frames,
                     "launches_per_frame": {k: v / frames
                                            for k, v in counts.items() if v}}
        if split is not None:
            whole = [f for f, complete in split if complete]
            rec[name].update(
                stream=stream, frames_split=len(whole),
                device_ms_per_frame={
                    k: sum(f[k] for f in whole) / max(len(whole), 1) / 1e3
                    for k in SPLIT_STAGES},
                device_ms_by_frame=[{k: v / 1e3 for k, v in f.items()}
                                    for f, _ in split])
            rec[name]["device_busy_ms_per_frame"] = sum(
                rec[name]["device_ms_per_frame"].values())
    need_launched("entry", total, ENTRY_KERNELS)
    for k, v in total.items():
        launches[k] += v
    return {"checksums_ok": True, **rec, "launches": total}, \
        k9_all / frames_all


def multichip_phase(launches):
    """run_multichip_dryrun(2) and (4) on ["cuda:0"] * n: every phase
    byte-compared with the single-device result inside it."""
    from h264bsd_tpu_torch.models.entry import run_multichip_dryrun

    rec = {}
    for n in (2, 4):
        _, wall, counts, stats = counted(
            lambda: run_multichip_dryrun(n, devices=[CARD] * n))
        need_launched(f"multichip_dryrun({n})", counts, DRYRUN_KERNELS)
        for k, v in counts.items():
            launches[k] += v
        rec[f"devices_{n}"] = {"wall_s": wall, **stats,
                               "launches": {k: v for k, v in counts.items()
                                            if v}}
    return {"ok": True, **rec}


def cli_phase(recorded_stream, launches):
    """The CLI (python -m h264bsd_tpu_torch.cli) on the ippp_1080p file
    with -o, in a subprocess: the dump's per-picture checksums, over the
    cropped prefix as it writes it, against decode_stream's pictures
    checksummed on the card (and the recorded values), and its fps line;
    then -o, --rgba and --render in this process on a 4x4 stream, on the
    card against the CPU, byte for byte."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from h264bsd_tpu_torch import cli
    from h264bsd_tpu_torch.models.decoder import (decode_stream,
                                                  frame_checksum_device,
                                                  frame_checksum_host)
    from h264bsd_tpu_torch.utils import streamgen

    e, data = recorded_stream("ippp_1080p")
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = tmp / "ippp_1080p.h264"
        src.write_bytes(data)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "h264bsd_tpu_torch.cli", "-o",
             str(tmp / "out.yuv"), "--device", CARD, str(src)],
            capture_output=True,
            text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"cli: exit code {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        done = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("Test file complete.") and " fps (" in ln]
        if len(done) != 1:
            raise AssertionError(f"cli: no fps line in {proc.stdout!r}")
        pics, _, counts, _ = counted(lambda: list(decode_stream(
            data, device=CARD)))
        for k, v in counts.items():
            launches[k] += v
        sizes = [p.crop[1] * p.crop[3] * 3 // 2 for p in pics]
        want = torch.stack([frame_checksum_device(*p.planes, n) for p, n in
                            zip(pics, sizes)]).cpu().tolist()
        dump = (tmp / "out.yuv").read_bytes()
        if len(dump) != sum(sizes):
            raise AssertionError(f"cli: dump of {len(dump)} bytes, "
                                 f"expected {sum(sizes)}")
        offsets = np.cumsum([0] + sizes)
        got = [frame_checksum_host(dump[a:b])
               for a, b in zip(offsets[:-1], offsets[1:])]
        # the stream is not cropped: the dump holds whole pictures
        if not got == want == e["checksums"]:
            raise AssertionError(f"cli: dump checksums {got} != the card's "
                                 f"{want} (recorded {e['checksums']})")
        rec["ippp_1080p"] = {"pictures": len(got), "subprocess_s": wall,
                             "fps_line": done[0]}
        small = tmp / "ippp_4x4.h264"
        small.write_bytes(streamgen.make_ippp_stream(4, 4, 4))
        files = {}
        for tag, device in (("card", CARD), ("cpu", "cpu")):
            d = tmp / tag
            d.mkdir()
            argv = ["-o", str(d / "o.yuv"), "--rgba", str(d / "o.rgba"),
                    "--render", str(d / "ppm"), "--device", device,
                    str(small)]
            with contextlib.redirect_stdout(io.StringIO()):
                rc, _, counts, _ = counted(lambda: cli.main(argv))
            if tag == "card":
                for k, v in counts.items():
                    launches[k] += v
            files[tag] = {str(p.relative_to(d)): p.read_bytes()
                          for p in sorted(d.rglob("*")) if p.is_file()}
            if rc:
                raise AssertionError(f"cli on {device}: exit code {rc}")
        if files["card"] != files["cpu"] or len(files["card"]) != 2 + 4:
            raise AssertionError("cli: -o, --rgba and --render on the card "
                                 "differ from the CPU's")
        rec["ippp_4x4"] = {"files": sorted(files["card"])}
    return {"ok": True, **rec}


def bench_phase(launches):
    """bench_torch.py's main with a 30 s budget per stream on both bench
    streams; its JSON lines, printed as they are."""
    import bench_torch

    recs, _, counts = tool_phase(bench_torch, ["--budget", "30"])
    if len(recs) != len(bench_torch.STREAMS) or not all(
            r["value"] for r in recs):
        raise AssertionError(f"bench: records {recs}")
    for k, v in counts.items():
        launches[k] += v
    return {"streams": [r["stream"] for r in recs],
            "fps": [r["value"] for r in recs],
            "fps_all": [r["fps_all"] for r in recs],
            "launches": counts}


def tool_phase(tool, argv):
    """A script module's main(argv), its JSON lines printed as they are;
    fails on a non-zero exit or a line that is not bit-exact. Returns the
    lines, the seconds and the launch counts that are not 0."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, wall, counts, _ = counted(lambda: tool.main(argv))
    lines = out.getvalue().splitlines()
    for line in lines:
        print(line, flush=True)
    recs = [json.loads(line) for line in lines]
    if rc or not recs or not all(r.get("bit_exact", True) for r in recs):
        raise AssertionError(f"{tool.__name__}: exit code {rc}, records "
                             f"{recs}")
    return recs, wall, {k: v for k, v in counts.items() if v}


# the fuzz phase: the corrupted entries of reference_checksums.json
# (fuzz_<base>_s<seed>), and the 1080p ones that also go through
# MultiStreamDecoder (two rounds of N = 4, a motion stream first: its DPB
# sizes the ring) and framepipe at 2 replicas; the kernels the phase
# must launch on corrupted input
FUZZ_GROUPS = (("motion_1080p_s0", "ippp_1080p_s0", "motion_1080p_s1",
                "ippp_1080p_s1"),
               ("motion_1080p_s2", "ippp_1080p_s2", "motion_1080p_s1",
                "ippp_1080p_s0"))
FUZZ_KERNELS = ("deblock_wf", "deblock_raster", "intra_list", "intra_wf",
                "mc_recon", "residual_sparse")


def fuzz_phase(ref):
    """Every corrupted entry through decode_stream on the card, and the
    1080p ones through MultiStreamDecoder (round by round) and framepipe
    at 2 replicas of the card, each picture's checksum against the one
    the JAX package recorded; the launch counts set to 0 before each run
    and read after it, summed over the phase (kept apart from the clean
    paths' counts). Fails unless every kernel of FUZZ_KERNELS launched,
    or if a decode launched the MC kernels of the TPU signature. Returns
    the record and the phase's launch counts."""
    from h264bsd_tpu_torch.models.decoder import decode_stream
    from h264bsd_tpu_torch.parallel.framepipe import decode_stream_framepipe
    from h264bsd_tpu_torch.parallel.mesh import Mesh
    from h264bsd_tpu_torch.parallel.multistream import MultiStreamDecoder
    from h264bsd_tpu_torch.utils.recorded import (corrupt,
                                                  make_recorded_stream)

    bases = {}

    def stream(name):
        e = ref[name]
        base = name[len("fuzz_"):name.rindex("_s")]
        if base not in bases:
            bases[base] = make_recorded_stream(ref[base])
        data = corrupt(bases[base], e["corrupt"]["seed"])
        if hashlib.sha256(data).hexdigest() != e["sha256"]:
            raise AssertionError(f"{name}: stream bytes differ from the "
                                 "recorded stream")
        return e["checksums"], data

    total = {k: 0 for k in KERNELS}
    stats_total = {}

    def run(label, fn, want):
        got, wall, counts, stats = counted(fn)
        if got != want:
            raise AssertionError(f"fuzz {label}: checksums {got} != "
                                 f"recorded {want}")
        if counts["mc_uniform"] or counts["mc_exception"]:
            raise AssertionError(f"fuzz {label}: the MC kernels of the TPU "
                                 f"kernels' signature launched: {counts}")
        for k, v in counts.items():
            total[k] += v
        for k, v in stats.items():
            stats_total[k] = stats_total.get(k, 0) + v
        return wall

    names = [k for k in ref if k.startswith("fuzz_")]
    t0 = time.perf_counter()
    pictures = 0
    for name in names:
        want, data = stream(name)
        run(name, lambda: checksums_of(decode_stream(data, device=CARD)),
            want)
        pictures += len(want)
    decode_s = time.perf_counter() - t0
    rec = {"streams": len(names), "pictures": pictures,
           "decode_stream_s": decode_s}
    for k, group in enumerate(FUZZ_GROUPS):
        wants, streams = zip(*(stream(f"fuzz_{n}") for n in group))
        rec[f"multistream_4_{k}_s"] = run(
            f"multistream {group}", lambda: multistream_rounds(
                MultiStreamDecoder(list(streams), device=CARD))[0],
            list(wants))
    mesh = Mesh([CARD] * 2, ("pipe",))
    for name in sorted({n for g in FUZZ_GROUPS for n in g}):
        want, data = stream(f"fuzz_{name}")
        run(f"framepipe {name}", lambda: checksums_of(
            decode_stream_framepipe(data, mesh, "pipe")), want)
    need_launched("fuzz", total, FUZZ_KERNELS)
    return {**rec, "checksums_ok": True, **stats_total,
            "launches": {k: v for k, v in total.items() if v}}, total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from h264bsd_tpu_torch.frontend import binding as fe
    from h264bsd_tpu_torch.frontend import build as fe_build
    from h264bsd_tpu_torch.models.decoder import (Decoder, decode_stream,
                                                  frame_checksum_host)
    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
    from h264bsd_tpu_torch.models.state import tensor_from_numpy
    from h264bsd_tpu_torch.models.stream import StreamingDecoder
    from h264bsd_tpu_torch.ops import _kernels
    from h264bsd_tpu_torch.ops.cuda_deblock import (
        deblock_frame_cuda_from_bs, deblock_raster_plain)
    from h264bsd_tpu_torch.ops.cuda_deblock_wf import (
        deblock_frame_wavefront_from_bs, deblock_wavefront_plain)
    from h264bsd_tpu_torch.ops.cuda_intra import (intra_pass_cuda,
                                                  list_dependency_levels)
    from h264bsd_tpu_torch.ops.cuda_intra_wf import (
        intra_pass_wavefront_cuda, intra_pass_wavefront_plain)
    from h264bsd_tpu_torch.ops.cuda_mc import (mc_exception_cuda,
                                               mc_exception_plain,
                                               mc_predict_grids,
                                               mc_recon_cuda,
                                               mc_recon_plain,
                                               mc_uniform_cuda,
                                               mc_uniform_plain)
    from h264bsd_tpu_torch.ops.cuda_transform import (
        idct_blocks, residual_planes_sparse_cuda)
    from h264bsd_tpu_torch.ops.deblock import anti_diagonals
    from h264bsd_tpu_torch.ops.inter import mb_grid_to_plane
    from h264bsd_tpu_torch.ops.intra import intra_pass, intra_pass_list
    from h264bsd_tpu_torch.ops.transform import (idct_blocks_plain,
                                                 residual_blocks,
                                                 residual_planes_sparse)
    from h264bsd_tpu_torch.ops.unpack import (blob_words, unpack_blob,
                                              unpack_meta)
    from h264bsd_tpu_torch.utils import kernel_cases as kc
    from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

    dev = torch.device("cuda")
    smi = nvidia_smi()
    # the multistream phase's long streams, generated by worker processes
    # while the kernels build and the phases before it run
    makers = ProcessPoolExecutor(len(LONG_MIX),
                                 mp_context=get_context("spawn"))
    long_streams = [makers.submit(make_recorded_stream, e) for e in LONG_MIX]
    makers.shutdown(wait=False)

    # ---- env: build everything from the checkout's sources
    t0 = time.perf_counter()
    fe_build.build(force=True)
    t1 = time.perf_counter()
    _kernels.build(force=True)
    t2 = time.perf_counter()
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "frontend_build_s": t1 - t0,
          "kernel_build_s": t2 - t1})

    # the recorded streams (the JAX package's checksums) and their frames
    ref = json.loads(open("h264bsd_tpu_torch/testdata/"
                          "reference_checksums.json").read())
    launches = {k: 0 for k in KERNELS}
    per_frame = {}

    def recorded_stream(name):
        e = ref[name]
        data = make_recorded_stream(e)
        if hashlib.sha256(data).hexdigest() != e["sha256"]:
            raise AssertionError(f"{name}: stream bytes differ from the "
                                 "recorded stream")
        return e, data

    def frame_at(name, k):
        """A decoder stopped at frame k of stream `name`, and the frame's
        Decoder._prepare()."""
        data = recorded_stream(name)[1]
        dec = Decoder()
        pos = frames = 0
        while True:
            status, read = dec._fe.decode(data, 0, pos)
            pos += read
            if status == fe.PIC_RDY:
                prep = dec._prepare()
                while dec._fe.next_output() is not None:
                    pass
                if frames == k:
                    return dec, prep
                frames += 1

    def dense_blocks(name, k, first, rows):
        """K9's inputs on MB rows first..first+rows-1 of frame k of stream
        `name`, as residual_blocks makes them from the front-end's dense
        tensors (the dense frame_step's and the row-sharded dense step's
        blocks)."""
        dec, prep = frame_at(name, k)
        w = prep["w_mbs"]
        t = dec._fe.tensors(prep["n_mbs"])
        dec.close()
        cut = slice(first * w, (first + rows) * w)
        f = {field: tensor_from_numpy(t[field][cut], dev)
             for field in ("coeff", "luma_dc", "chroma_dc", "qp_y",
                           "chroma_qp_offset", "nnz", "nnz_dc",
                           "mb_class")}
        return residual_blocks(
            f["coeff"], f["luma_dc"], f["chroma_dc"], f["qp_y"],
            f["chroma_qp_offset"], f["nnz"], f["nnz_dc"],
            f["mb_class"] == 4)[:4]

    # ---- kernels: each CUDA kernel byte-equal to its plain version
    def plain_intra_list(y, cb, cr, *rest, ids):
        return intra_pass_list(y, cb, cr, ids, *rest)

    errs = {k: 0 for k in KERNELS}
    checks = []

    def check(name, kernel, plain, args, dims):
        got = kernel(*planes_copy(args), *dims)
        want = plain(*planes_copy(args), *dims)
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        checks.append({"kernel": name, "dims": list(dims), "max_abs_err": err})
        if err:
            raise AssertionError(f"{name} at {dims}: kernel differs from "
                                 f"its plain version (max |err| {err})")

    _kernels.reset_launches()
    # K1 on the narrowest frame it takes (the longest chain per MB), a
    # one-row frame and 1080p
    for seed, dims in enumerate([(6, 4), (9, 5), (3, 7), (20, 12), (3, 40),
                                 (40, 1), (120, 68)]):
        check("deblock_wf", deblock_frame_wavefront_from_bs,
              deblock_wavefront_plain,
              kc.deblock_inputs(kc.deblock_case(seed, *dims), *dims, dev),
              dims)
    # K1 on the row-sharded path's extended stripes of a 1080p frame: the
    # top stripe of 2 (34 MB rows + the dummy row), the second of 2, the
    # last of 4 (17 + 1), with the stripe's bS and halo rows
    stripe_case = kc.deblock_case(18, 120, 68)
    for first, n_rows in ((0, 34), (34, 34), (51, 17)):
        check("deblock_wf", deblock_frame_wavefront_from_bs,
              deblock_wavefront_plain,
              kc.deblock_stripe_inputs(stripe_case, 120, first, n_rows, dev),
              (120, n_rows + 1))
        checks[-1]["case"] = f"stripe at MB row {first}"
    # K8: one MB, one band of MB rows, a 1x68 column and a 32x1088 strip
    # (5 bands of 16 rows); the timing phase adds the tallest 2-MB-wide
    # frame of level 5.1, 2x543 (its plain version takes ~36 s a call)
    for seed, dims in enumerate([(2, 5), (1, 1), (2, 4), (1, 68), (2, 68),
                                 (1, 9)]):
        check("deblock_raster", deblock_frame_cuda_from_bs,
              deblock_raster_plain,
              kc.deblock_inputs(kc.deblock_case(seed, *dims), *dims, dev),
              dims)
    # K2 on raster lists, a shuffled one (an order the front-end never
    # ships), a sparse 1080p one (~3% intra, a P picture's share), one of
    # padding only and a dense 40x23 all-intra one padded to its cap
    intra_lists = [
        ("raster", (6, 4), kc.intra_case(0, 6, 4), 0, None),
        ("raster", (20, 12), kc.intra_case(1, 20, 12), 7, None),
        ("shuffled", (20, 12), kc.intra_case(2, 20, 12), 7, 2),
        ("sparse", (120, 68), kc.intra_case(3, 120, 68, intra_share=0.03),
         200, None),
        ("padding", (6, 4), kc.intra_case(4, 6, 4, intra_share=0.0), 16,
         None),
        ("dense", (40, 23), kc.intra_case(5, 40, 23, all_intra=True), 104,
         None)]
    for kind, dims, case, pad, shuffle in intra_lists:
        ids = kc.padded_intra_ids(case, pad, dev, shuffle_seed=shuffle)
        check("intra_list",
              lambda *a: intra_pass_cuda(*a, intra_ids=ids),
              lambda *a: plain_intra_list(*a[:-1], ids=ids),
              kc.intra_inputs(case, dev), dims)
        checks[-1]["list"] = kind
    for dims in [(12, 9), (16, 3), (5, 11), (3, 2), (20, 12), (120, 68)]:
        check("intra_wf", intra_pass_wavefront_cuda,
              intra_pass_wavefront_plain,
              kc.intra_inputs(kc.intra_case(7, *dims), dev), dims)
    # every above-right bit set: Intra_4x4 blocks 5 and 13 read the copy
    # of their MB taken before the 10-step chain (K7 and K2)
    all_c = kc.intra_case(8, 120, 68)
    all_c["i4_avail"] = all_c["i4_avail"] | 4
    check("intra_wf", intra_pass_wavefront_cuda, intra_pass_wavefront_plain,
          kc.intra_inputs(all_c, dev), (120, 68))
    checks[-1]["case"] = "all_c"
    ids = kc.padded_intra_ids(all_c, 0, dev)
    check("intra_list", lambda *a: intra_pass_cuda(*a, intra_ids=ids),
          lambda *a: plain_intra_list(*a[:-1], ids=ids),
          kc.intra_inputs(all_c, dev), (120, 68))
    checks[-1]["case"] = "all_c"
    # K2 as the row-sharded path runs it (every MB in raster order) on the
    # halo-extended stripes of the same frame: the top stripe of 4, the
    # second of 2 and the last of 4, the halo row read by above-right
    # blocks too
    for first, n_rows in ((0, 17), (34, 34), (51, 17)):
        check("intra_list", intra_pass_cuda,
              lambda *a: intra_pass(*a[:-1]),
              kc.intra_stripe_inputs(all_c, 120, first, n_rows, dev),
              (120, n_rows + 1))
        checks[-1]["case"] = f"all_c, stripe at MB row {first}"
    # MC at the decode tests' size, a mid size and 1080p, 1, 4 and 16
    # slots; the exception kernel over the uniform grids, once with the
    # real entry count and once walking the padding too; the main path's
    # MC stage on the same motion with classes and residuals, without and
    # with I_PCM MBs, and on every window across a frame edge and on
    # whole-pel MVs only
    for seed, (dims, n_slots) in enumerate([((6, 4), 1), ((20, 12), 4),
                                            ((120, 68), 16)]):
        case = kc.mc_case(seed, *dims, n_slots, 0.25)
        args = kc.mc_inputs(case, dev)
        check("mc_uniform", mc_uniform_cuda, mc_uniform_plain, args[:5],
              dims)
        grids = mc_uniform_plain(*args[:5], *dims)
        for n_exc in (case["n_exc"], None):
            check("mc_exception",
                  lambda *a: mc_exception_cuda(*a, n_exc=n_exc),
                  lambda *a: mc_exception_plain(*a, n_exc=n_exc),
                  grids + args, dims)
        for pcm, motion in ((False, "mixed"), (True, "mixed"),
                            (True, "edge"), (False, "integer")):
            check("mc_recon", mc_recon_cuda, mc_recon_plain,
                  kc.mc_recon_inputs(kc.mc_recon_case(
                      seed, *dims, n_slots, 0.25, pcm=pcm, motion=motion),
                      dev), dims)
            checks[-1]["case"] = f"{motion}, pcm {pcm}"
    # the MB-row offset of the row-sharded path: stripes of a 1080p frame
    # (those of 2 and 4 positions, and one across the middle) predicted
    # from the whole reference frames, windows across the frame's edges;
    # the TPU signature's kernels at offsets 0 and 3 of a 20x12 frame,
    # the exception ids rebased onto the stripe
    frame = kc.mc_recon_inputs(kc.mc_recon_case(
        18, 120, 68, 4, 0.25, pcm=True, motion="edge"), dev)
    for first, n_rows in ((0, 34), (34, 34), (51, 17), (20, 17)):
        check("mc_recon_stripe",
              lambda *a: mc_recon_cuda(*a, mb_row_offset=first),
              lambda *a: mc_recon_plain(*a, mb_row_offset=first),
              kc.mc_recon_stripe(frame, 120, first, n_rows), (120, n_rows))
        checks[-1]["case"] = f"edge, pcm, mb_row_offset {first}"
    for first in (0, 3):
        args = kc.mc_stripe(kc.mc_inputs(kc.mc_case(19, 20, 12, 4, 0.25),
                                         dev), 20, first, 5)
        check("mc_uniform",
              lambda *a: mc_uniform_cuda(*a, mb_row_offset=first),
              lambda *a: mc_uniform_plain(*a, mb_row_offset=first),
              args[:5], (20, 5))
        grids = mc_uniform_plain(*args[:5], 20, 5, mb_row_offset=first)
        check("mc_exception",
              lambda *a: mc_exception_cuda(*a, mb_row_offset=first),
              lambda *a: mc_exception_plain(*a, mb_row_offset=first),
              grids + args, (20, 5))
        checks[-1]["case"] = checks[-2]["case"] = f"mb_row_offset {first}"
    # K9 on N ragged against its four lanes a block and 64 blocks a CUDA
    # block, on two tiles of the TPU kernel and on 16; the residual stage
    # at the decode tests' size, a mid size and 1080p
    for n in (1, 3, 33, 512, 8191, 8192):
        check("idct_blocks", lambda *a: (idct_blocks(*a[:4]),),
              lambda *a: (idct_blocks_plain(*a[:4]),),
              kc.case_inputs(kc.idct_case(n, n), kc.IDCT_STATE, dev), (n,))
    # K9 on the dense frame_step's blocks: the whole first P picture of
    # the 1080p motion stream (8160 MBs x 24, 195,840 blocks)
    dense_k9 = dense_blocks("motion_1080p", 1, 0, 68)
    n = dense_k9[0].shape[0]
    check("idct_blocks", lambda *a: (idct_blocks(*a[:4]),),
          lambda *a: (idct_blocks_plain(*a[:4]),), dense_k9, (n,))
    checks[-1]["case"] = "motion_1080p frame 1, dense (frame_step)"
    for seed, dims in enumerate([(6, 4), (20, 12), (120, 68)]):
        n = dims[0] * dims[1]
        check("residual_sparse",
              lambda *a: residual_planes_sparse_cuda(*a[:6], n),
              lambda *a: residual_planes_sparse(*a[:6], n),
              kc.case_inputs(kc.residual_case(seed, *dims),
                             kc.RESIDUAL_STATE, dev), dims)
    # the fused stage's edge cases: ids in class order, nnz_dc-cleared
    # Intra_16x16 MBs, chroma QP offsets of +-12, qp_y at 0 and 51
    for qp, dims in ((None, (6, 4)), (0, (20, 12)), (51, (20, 12)),
                     (None, (120, 68))):
        n = dims[0] * dims[1]
        check("residual_sparse",
              lambda *a: residual_planes_sparse_cuda(*a[:6], n),
              lambda *a: residual_planes_sparse(*a[:6], n),
              kc.case_inputs(kc.residual_edge_case(4, *dims, qp=qp),
                             kc.RESIDUAL_STATE, dev), dims)
        checks[-1]["case"] = f"edge, qp {qp}"
    # races: K1, K2 and K7 replayed from a CUDA graph on fresh planes
    races = []

    def race(name, kernel, plain, args, dims):
        err = graph_replays_err(kernel, plain, args, dims, 50)
        errs[name] = max(errs[name], err)
        races.append({"kernel": name, "dims": list(dims), "replays": 50,
                      "max_abs_err": err})
        if err:
            raise AssertionError(f"{name} at {dims}: a graph replay differs "
                                 f"from the plain version (max |err| {err})")

    race("deblock_raster", deblock_frame_cuda_from_bs, deblock_raster_plain,
         kc.deblock_inputs(kc.deblock_case(8, 2, 68), 2, 68, dev), (2, 68))
    race("deblock_wf", deblock_frame_wavefront_from_bs,
         deblock_wavefront_plain,
         kc.deblock_inputs(kc.deblock_case(9, 120, 68), 120, 68, dev),
         (120, 68))
    for kind, dims, case, pad, _ in intra_lists:
        if kind in ("sparse", "dense"):
            ids = kc.padded_intra_ids(case, pad, dev)
            race("intra_list",
                 lambda *a: intra_pass_cuda(*a, intra_ids=ids),
                 lambda *a: plain_intra_list(*a[:-1], ids=ids),
                 kc.intra_inputs(case, dev), dims)
    race("intra_wf", intra_pass_wavefront_cuda, intra_pass_wavefront_plain,
         kc.intra_inputs(kc.intra_case(9, 120, 68, all_intra=True), dev),
         (120, 68))
    race("mc_recon", mc_recon_cuda, mc_recon_plain,
         kc.mc_recon_inputs(kc.mc_recon_case(9, 120, 68, 4, 0.06, pcm=True),
                            dev), (120, 68))
    race("mc_recon_stripe", lambda *a: mc_recon_cuda(*a, mb_row_offset=34),
         lambda *a: mc_recon_plain(*a, mb_row_offset=34),
         kc.mc_recon_stripe(frame, 120, 34, 34), (120, 34))
    races[-1]["mb_row_offset"] = 34
    emit({"phase": "kernels", "checks": checks, "graph_replays": races,
          "launches": dict(_kernels.LAUNCHES)})

    # ---- decodes: checksums against the JAX package's recorded values
    def drive(name, pictures_of):
        """Decode stream `name` with pictures_of(data) (an iterable of
        OutputPicture), the counts set to 0 just before and read just
        after; checks the checksums. Returns the record and the launch
        counts."""
        e, data = recorded_stream(name)
        _kernels.reset_launches()
        reset_stats()
        sums = [frame_checksum_host(p.yuv_bytes()) for p in pictures_of(data)]
        counts = dict(_kernels.LAUNCHES)
        stats = dict(STATS)
        for k, v in counts.items():
            launches[k] += v
        if sums != e["checksums"]:
            raise AssertionError(f"{name}: checksums {sums} != recorded "
                                 f"{e['checksums']}")
        if counts["residual_sparse"] == 0 or counts["mc_recon"] == 0:
            raise AssertionError(f"{name}: the residual or MC kernel never "
                                 f"launched: {counts}")
        if counts["mc_uniform"] or counts["mc_exception"]:
            raise AssertionError(f"{name}: the MC kernels of the TPU "
                                 f"kernels' signature launched: {counts}")
        rec = {"stream": name, "pictures": len(sums), "checksums_ok": True,
               **stats, "launches": counts}
        return rec, counts

    def decode(name, timed):
        rec, counts = drive(name, decode_stream)
        if timed:
            # a second decoder: its graphs are captured again, so this
            # includes one capture per frame shape
            data = recorded_stream(name)[1]
            t0 = time.perf_counter()
            n = sum(1 for _ in decode_stream(data))
            torch.cuda.synchronize()
            rec["fps"] = n / (time.perf_counter() - t0)
        return rec, counts

    def note_per_frame(phase, counts, pictures):
        for k, p in PER_FRAME_PHASE.items():
            if p == phase:
                per_frame[k] = counts[k] / pictures

    for phase, name, need in [
            ("decode_720p_all_i", "intra_720p",
             ("intra_wf", "deblock_wf", "mc_recon")),
            ("decode_1080p_all_i", "intra_1080p",
             ("intra_wf", "deblock_wf", "mc_recon")),
            ("decode_1080p_ippp", "ippp_1080p", ("mc_recon",)),
            ("decode_1080p_motion", "motion_1080p",
             ("mc_recon", "intra_list"))]:
        rec, counts = decode(name, timed=True)
        if not all(counts[k] > 0 for k in need):
            raise AssertionError(f"{name}: kernels {need} not all launched: "
                                 f"{counts}")
        if name.endswith("1080p") and rec["graph_replays"] == 0:
            raise AssertionError(f"{name}: no frame replayed a graph: {rec}")
        note_per_frame(phase, counts, rec["pictures"])
        emit({"phase": phase, **rec})
    for phase, names, need in [
            ("decode_small", ("intra_40x23", "lowqp_i", "intra_2x4",
                              "ippp_2x68"),
             ("intra_list", "deblock_raster")),
            ("decode_small_p",
             ("ippp_4x4", "six_ref_cycle", "frame_num_gap", "longterm",
              "intra_in_p", "intra_in_p_constrained", "pcm",
              "deblock_control", "slice_groups", "redundant", "motion_6x4",
              "loss_idr_slice", "loss_p_slice"),
             ("mc_recon", "intra_list", "deblock_wf"))]:
        runs = [decode(name, timed=False) for name in names]
        counts = {k: sum(c[k] for _, c in runs) for k in KERNELS}
        if not all(counts[k] > 0 for k in need):
            raise AssertionError(f"{phase}: kernels {need} not all "
                                 f"launched: {counts}")
        note_per_frame(phase, counts, sum(r["pictures"] for r, _ in runs))
        emit({"phase": phase, "streams": [r for r, _ in runs]})

    # SEI NAL units before every picture, through Decoder.decode (one
    # _decode_step per frame) and take_sei_messages
    sei_seen = []

    def decode_with_sei(data):
        dec = Decoder()
        pos = 0
        while pos < len(data):
            status, read = dec.decode(data, 0, pos)
            pos += read
            if status == fe.PIC_RDY:
                while (pic := dec.next_output_picture()) is not None:
                    yield pic
            sei_seen.extend([m.payload_type, m.name, m.payload.hex()]
                            for m in dec.take_sei_messages())
            if status >= fe.ERROR and read == 0:
                break

    rec, _ = drive("sei_20x12", decode_with_sei)
    if sei_seen != ref["sei_20x12"]["sei_messages"]:
        raise AssertionError(f"SEI messages {sei_seen} != recorded "
                             f"{ref['sei_20x12']['sei_messages']}")
    emit({"phase": "decode_sei_stream", **rec, "sei_messages": len(sei_seen)})

    # StreamingDecoder fed 64 KiB chunks
    def streamed(data):
        pics = []
        sd = StreamingDecoder(on_picture_ready=pics.append)
        for at in range(0, len(data), 1 << 16):
            sd.queue_input(data[at:at + (1 << 16)])
            sd.pump()
        sd.end_of_stream()
        sd.pump()
        return pics

    rec, _ = drive("stream_ippp_1080p", streamed)
    if rec["graph_replays"] == 0:
        raise AssertionError(f"stream_ippp_1080p: no frame replayed a "
                             f"graph: {rec}")
    emit({"phase": "stream_1080p_ippp", **rec})

    # N 1080p streams through MultiStreamDecoder: a motion stream first
    # (its ring has room for 4 references), then IPPP and motion streams
    # of other QPs and seeds, 4 to 12 pictures each round by round, and
    # LONG_PICTURES each timed
    long_streams = [f.result() for f in long_streams]
    for n_streams in (1, 2, 4, 8):
        rec = multistream(MULTISTREAM[:n_streams], long_streams,
                          recorded_stream, launches)
        emit({"phase": f"multistream_{n_streams}", **rec})
    emit({"phase": "multistream_eager",
          **multistream_eager(recorded_stream, launches)})

    # the multi-device decoders on device lists that repeat the card
    emit({"phase": "gop", **gop_phase(recorded_stream, launches)})
    emit({"phase": "rowshard",
          **rowshard_phase(recorded_stream, launches, per_frame)})
    emit({"phase": "framepipe", **framepipe_phase(
        recorded_stream, long_streams[1], launches)})
    emit({"phase": "multistream_mesh", **multistream_mesh_phase(
        recorded_stream, long_streams, launches)})

    # the entry hooks, the dense frame_step, the CLI and the bench script
    rec, dense_k9_per_frame = entry_phase(recorded_stream, launches)
    emit({"phase": "entry", **rec})
    emit({"phase": "multichip_dryrun", **multichip_phase(launches)})
    emit({"phase": "cli", **cli_phase(recorded_stream, launches)})
    emit({"phase": "bench", **bench_phase(launches)})
    # corrupted streams: their launches are kept apart from `launches`
    # (the clean paths'), and shown beside them in the kernels line
    rec, fuzz_launches = fuzz_phase(ref)
    emit({"phase": "fuzz", **rec})
    # the config matrix, the scaling axes on device lists that repeat the
    # card (no efficiency) and the graph keys of the bench streams, with
    # short budgets; their launches are not the kernels line's
    import importlib

    for phase, script, argv in (
            ("configs", "bench_configs_torch", ["--budget", "2"]),
            ("scaling", "bench_scaling_torch",
             ["--budget", "1", "--gop-copies", "2"]),
            ("graphs", "count_graphs_torch", [])):
        recs, wall, counts = tool_phase(
            importlib.import_module(f"tools.{script}"), argv)
        emit({"phase": phase, "lines": len(recs), "wall_s": wall,
              "launches": counts})
    missing = [k for k, v in launches.items() if v == 0 and k not in OFF_PATH]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # ---- timing at the main path's shapes (1080p for K1, K2 on a 1080p
    # motion picture's list, 720p for K7, 2x4 for K8, 1080p for MC and
    # K9), kernel vs plain on the same inputs; K1 at 720p and K2 at 40x23
    # all-intra too (earlier rows' shapes)
    def deblock_bound(args, dims):
        y, cb, cr, bs_left, bs_top, lt, ct = args
        lines = 4 * int((bs_left > 0).sum() + (bs_top > 0).sum())
        # chroma edges read the bS of luma block columns / rows 0 and 2
        c_lines = 2 * 2 * int((bs_left[:, [0, 2, 4, 6, 8, 10, 12, 14]] > 0)
                              .sum() + (bs_top[:, :4] > 0).sum()
                              + (bs_top[:, 8:12] > 0).sum())
        ops = lines * OPS_LUMA_LINE + c_lines * OPS_CHROMA_LINE
        byt = 2 * nbytes((y, cb, cr)) + nbytes((bs_left, bs_top, *lt, *ct))
        return byt, ops

    def intra_bound(args, dims, ids=None):
        mb_class, i4_avail, mb_avail = args[3], args[5], args[6]
        w, h = dims
        intra = (mb_class == 3) | (mb_class == 4)
        if ids is not None:
            real = ids[(ids >= 0) & (ids < mb_class.numel())].long()
            intra = torch.zeros_like(intra).index_fill_(0, real, True) \
                & intra
        n_intra = int(intra.sum())
        ops = n_intra * 384 * OPS_INTRA_PEL
        mb = torch.nonzero(intra).flatten()
        r, c = mb // w, mb % w
        av = mb_avail[mb].long()
        # the available neighbours' pels: left column (A), above row (B),
        # corner (D), and for an I4x4 MB the 4 above-right luma pels of
        # its top-right block (C)
        a = ((av & 1) != 0) & (c > 0)
        b = ((av & 2) != 0) & (r > 0)
        d = ((av & 8) != 0) & (r > 0) & (c > 0)
        ar = (mb_class[mb] == 3) & ((i4_avail[mb, 3].long() & 4) != 0) \
            & (r > 0) & (c < w - 1)
        own = intra.reshape(h, w)

        def edge_pels(s, above_right):
            """Pels of a plane of s x s pels per MB that the reconstructed
            MBs read, each counted once, outside the MBs this call
            reconstructs (those it writes before it reads them)."""
            mask = torch.zeros(h * s, w * s, dtype=torch.bool,
                               device=mb.device)
            k = torch.arange(s, device=mb.device)
            y0, x0 = (r * s)[:, None], (c * s)[:, None]
            for sel, ys, xs in ((a, y0 + k, x0 - 1), (b, y0 - 1, x0 + k),
                                (d, y0 - 1, x0 - 1),
                                (above_right, y0 - 1, x0 + s + k[:4])):
                flat = (ys * (w * s) + xs)[sel].reshape(-1)
                mask.view(-1).index_fill_(0, flat, True)
            inside = own.repeat_interleave(s, 0).repeat_interleave(s, 1)
            return int((mask & ~inside).sum())

        # per reconstructed MB its 384 pels written and its modes,
        # availability and residuals as int32 (2 x 16 + 4 + 256 + 128);
        # the neighbour pels read; the weight table (9x16x13 int32), and
        # the classes (K7) or the id list (K2)
        byt = n_intra * (384 + 4 * 420) + edge_pels(16, ar) \
            + 2 * edge_pels(8, torch.zeros_like(ar)) + 9 * 16 * 13 * 4 \
            + 4 * (mb_class.numel() if ids is None else ids.numel())
        return byt, ops

    def mc_uniform_bound(args, dims):
        mv = args[3]
        n = mv.shape[0]
        # one ring read per predicted pel, the grids written once, block
        # 0's MV and slot as int32
        byt = 2 * 384 * n + 12 * n
        return byt, mc_ops(mv[:, 0, 0], mv[:, 0, 1], 16)

    def mc_exception_bound(args, dims, n_exc):
        mv, ids = args[6], args[8][:n_exc].long()
        b = torch.as_tensor([[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13],
                             [10, 11, 14, 15]], device=ids.device)[ids % 4]
        m = mv[(ids // 4)[:, None], b].reshape(-1, 2)
        n_blk = m.shape[0]
        # per 4x4 block: 24 pels read and written, MV and slot, its id
        byt = 2 * 24 * n_blk + 12 * n_blk + 4 * n_exc
        return byt, mc_ops(m[:, 0], m[:, 1], 4)

    def residual_bound(args, n):
        ids, levels = args[0], args[1]
        # the shipped AC blocks this frame has, and the DC-only base
        blocks = int(((ids < n * 26) & (ids % 26 < 24)).sum())
        byt = 4 * ids.numel() + 2 * levels.numel() + 4 * n * (2 + 24) \
            + 4 * 384 * n
        return byt, blocks * OPS_IDCT_BLOCK + 384 * n * OPS_DC_PEL

    def frame_state(name, k):
        """Frame k of stream `name` as the main path unpacks it on the
        card: (unpack_meta's tensors, sparse ids, sparse levels, intra
        ids, MB count)."""
        dec, prep = frame_at(name, k)
        dec.close()
        n = prep["n_mbs"]
        (packed, stab, sids, slv, eids, epay, iids, ipay,
         slice_ids) = unpack_blob(blob_words(prep["blob"], dev), n,
                                  *prep["caps"])
        t = unpack_meta(packed, stab, eids, epay, iids, ipay, n, slice_ids,
                        sparse_ids=sids)
        return t, sids.reshape(-1), slv, iids.reshape(-1), n

    def residual_args(t, sids, slv):
        return (sids, slv, t["qp_y"], t["chroma_qp_offset"], t["nnz_dc"],
                t["mb_class"] == 4)

    def frame_intra_args(t, sids, slv, n, dims, seed):
        """K2's inputs on the frame: its per-MB state and residuals as the
        main path computes them, on seeded random planes."""
        res_l, res_c = residual_planes_sparse_cuda(*residual_args(
            t, sids, slv), n)
        rng = np.random.default_rng(seed)
        w, h = dims
        planes = [torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
                  .to(dev) for shape in ((16 * h, 16 * w),
                                         (8 * h, 8 * w), (8 * h, 8 * w))]
        return (*planes, t["mb_class"], t["i4_modes"], t["i4_avail"],
                t["mb_avail"], t["i16_mode"], t["chroma_mode"], res_l, res_c)

    rows, extra_rows = [], []

    def time_kernel(name, kernel, plain, args, dims, bound, serial,
                    plain_reps, extra=False, case=None, cold=False):
        """plain_reps: calls of the plain version timed, or 0 to time the
        one call the check makes. serial: the kernel's chain of dependent
        steps (MBs on the
        longest dependency chain for K1, K2 and K7 -- for K1 and K7 the
        anti-diagonals -- in their single launch; MBs walked by K8; 1
        for MC and K9). extra: a row at a second shape, kept out of the
        kernels line; case: what the row's inputs are, where not the
        kernel's usual case; cold: add the device time on inputs the L2
        cache does not hold (cold_ms, cold_device_ms) and the bound's
        share of it."""
        got = kernel(*planes_copy(args), *dims)
        copies = planes_copy(args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*copies, *dims)
        end.record()
        end.synchronize()
        check_ms = start.elapsed_time(end)
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        if err:
            raise AssertionError(f"{name} at {dims}: kernel differs from "
                                 f"its plain version (max |err| {err})")
        ms, recorded = device_ms(lambda *a: kernel(*a, *dims), args, 20,
                                 name)
        event_ms = timed_ms(lambda *a: kernel(*a, *dims), args, 20)
        plain_ms = timed_ms(lambda *a: plain(*a, *dims), args, plain_reps) \
            if plain_reps else check_ms
        byt, ops = bound
        t_bytes, t_ops = byt / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
        source, replaces = KERNELS[name]
        (extra_rows if extra else rows).append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "fuzz_launches": fuzz_launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "dims": list(dims), "event_ms": event_ms,
            "launches_per_frame": per_frame[name],
            "cuda_launches_per_call": len(DEVICE_FN[name]),
            "profiled_launches_per_call": recorded,
            "serial_steps": serial, "bytes": byt, "ops": ops,
            **({"case": case} if case else {})})
        if cold:
            row = (extra_rows if extra else rows)[-1]
            row["cold_ms"], row["cold_copies"] = cold_device_ms(
                lambda *a: kernel(*a, *dims), args, 20, name)
            row["cold_share_of_bound"] = row["bound_ms"] / row["cold_ms"]

    for seed, dims, extra in ((10, (120, 68), False), (11, (80, 45), True)):
        args = kc.deblock_inputs(kc.deblock_case(seed, *dims), *dims, dev)
        time_kernel("deblock_wf", deblock_frame_wavefront_from_bs,
                    deblock_wavefront_plain, args, dims,
                    deblock_bound(args, dims),
                    len([d for d in anti_diagonals(*dims) if d]), 1, extra)
    for dims, extra in (((80, 45), False), ((120, 68), True)):
        args = kc.intra_inputs(kc.intra_case(12, *dims, all_intra=True),
                               dev)
        time_kernel("intra_wf", intra_pass_wavefront_cuda,
                    intra_pass_wavefront_plain, args, dims,
                    intra_bound(args, dims), len(anti_diagonals(*dims)), 2,
                    extra)
    # where K7's chain step goes: one-row frames have no waits, so their
    # time over wm is the cost of an MB in a row, with every MB inter
    # (skipped: staging and publishing only), Intra_16x16 or Intra_4x4;
    # a frame 3 MBs wide adds to that a row-to-row hand-off per row
    for label, dims, cls in (("all inter", (120, 1), 2),
                             ("all I16x16", (120, 1), 4),
                             ("all I4x4", (120, 1), 3),
                             ("all-intra mix", (3, 68), None)):
        case = kc.intra_case(17, *dims, all_intra=True)
        if cls is not None:
            case["mb_class"][:] = cls
        args = kc.intra_inputs(case, dev)
        time_kernel("intra_wf", intra_pass_wavefront_cuda,
                    intra_pass_wavefront_plain, args, dims,
                    intra_bound(args, dims), len(anti_diagonals(*dims)), 2,
                    True, label)
    # K2 on the second picture (a P picture) of the 1080p motion stream,
    # and on a 40x23 all-intra frame
    motion = frame_state("motion_1080p", 1)
    t, sids, slv, ids, n = motion
    dims = (120, 68)
    args = frame_intra_args(t, sids, slv, n, dims, 13)
    lists = [(args, ids, dims, False)]
    dims = (40, 23)
    case = kc.intra_case(13, *dims, all_intra=True)
    lists.append((kc.intra_inputs(case, dev),
                  kc.padded_intra_ids(case, 0, dev), dims, True))
    for args, ids, dims, extra in lists:
        time_kernel("intra_list",
                    lambda *a: intra_pass_cuda(*a, intra_ids=ids),
                    lambda *a: plain_intra_list(*a[:-1], ids=ids), args,
                    dims, intra_bound(args, dims, ids),
                    len(list_dependency_levels(ids, args[3], *dims)), 1,
                    extra)
    # K8 at 2x4 (the earlier row) and on taller frames, which cross bands
    # of MB rows; beside each row, its device time on the same frame with
    # every bS 0 (no_edges_ms: staging, barriers and stores, no filter),
    # the floor of its chain of MBs as this run measures it; held to the
    # plain version below 1000 MBs (the plain version takes ~36 s at 2x543)
    for seed, dims, extra, reps in ((14, (2, 4), False, 3),
                                    (15, (1, 68), True, 1),
                                    (16, (2, 68), True, 1),
                                    (17, (2, 543), True, 0)):
        args = kc.deblock_inputs(kc.deblock_case(seed, *dims), *dims, dev)
        time_kernel("deblock_raster", deblock_frame_cuda_from_bs,
                    deblock_raster_plain, args, dims,
                    deblock_bound(args, dims), dims[0] * dims[1], reps,
                    extra)
        no_edges = args[:3] + (torch.zeros_like(args[3]),
                               torch.zeros_like(args[4])) + args[5:]
        if dims[0] * dims[1] < 1000:
            check("deblock_raster", deblock_frame_cuda_from_bs,
                  deblock_raster_plain, no_edges, dims)
            checks[-1]["case"] = "no edges"
        (extra_rows if extra else rows)[-1]["no_edges_ms"] = device_ms(
            lambda *a: deblock_frame_cuda_from_bs(*a, *dims), no_edges, 20,
            "deblock_raster")[0]
    # 1080p, 4 reference slots, 6% of the MBs with motion exceptions in
    # all four quads (the share pallas_mc.py:10-14 names)
    dims = (120, 68)
    case = kc.mc_case(15, *dims, 4, 0.06)
    args = kc.mc_inputs(case, dev)
    time_kernel("mc_uniform", mc_uniform_cuda, mc_uniform_plain, args[:5],
                dims, mc_uniform_bound(args, dims), 1, 5)
    n_exc = case["n_exc"]
    args = mc_uniform_plain(*args[:5], *dims) + args
    time_kernel("mc_exception",
                lambda *a: mc_exception_cuda(*a, n_exc=n_exc),
                lambda *a: mc_exception_plain(*a, n_exc=n_exc), args, dims,
                mc_exception_bound(args, dims, n_exc), 1, 5)
    # the main path's MC stage on the same motion, with MB classes and
    # residuals; then the route it replaced on the same inputs: K3+K4 and
    # K5+K6 into MB grids, the PyTorch combine and mb_grid_to_plane
    case = kc.mc_recon_case(15, *dims, 4, 0.06)
    args = kc.mc_recon_inputs(case, dev)
    time_kernel("mc_recon", mc_recon_cuda, mc_recon_plain, args, dims,
                mc_recon_bound(args), 1, 5)
    # where mc_recon's time goes: 1080p frames whose MBs all take one path
    for label, split_case in kc.mc_recon_kind_cases(*dims):
        split_args = kc.mc_recon_inputs(split_case, dev)
        time_kernel("mc_recon", mc_recon_cuda, mc_recon_plain, split_args,
                    dims, mc_recon_bound(split_args), 1, 2, True, label)
    exc_ids = kc.mc_inputs(case, dev)[5]

    def old_route(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, mb_class, res_l,
                  res_c, pcm, w, h):
        pred = mc_predict_grids(dpb_y, dpb_cb, dpb_cr, mv, ref_slot,
                                exc_ids, w, h, case["n_exc"])
        inter = ((mb_class == 1) | (mb_class == 2))[:, None, None]
        res = (res_l, res_c[:, 0], res_c[:, 1])
        return tuple(mb_grid_to_plane(torch.where(
            inter, (p.to(torch.int32) + r).clamp(0, 255), 0).to(
                torch.uint8), w, h) for p, r in zip(pred, res))

    old_err = max_abs_err(old_route(*args, *dims), mc_recon_cuda(*args,
                                                                 *dims))
    if old_err:
        raise AssertionError(f"mc_recon differs from the route it replaced "
                             f"(max |err| {old_err})")
    old_ms, old_events = route_device_ms(old_route, args + dims, 20)
    old_route_row = {"dims": list(dims), "device_ms": old_ms,
                     "device_events_per_call": old_events,
                     "event_ms": timed_ms(lambda *a: old_route(*a, *dims),
                                          args, 20),
                     "max_abs_err_vs_mc_recon": old_err}
    # the stripe kernel of the row-sharded path on the same motion: the
    # second of 2 stripes (34 MB rows at MB row 34) from the whole frames
    stripe_args = kc.mc_recon_stripe(args, 120, 34, 34)
    time_kernel("mc_recon_stripe",
                lambda *a: mc_recon_cuda(*a, mb_row_offset=34),
                lambda *a: mc_recon_plain(*a, mb_row_offset=34), stripe_args,
                (120, 34), mc_recon_bound(stripe_args), 1, 5)

    # K9 at the dense row-sharded step's sizes: the blocks of a stripe of
    # 34 and of 17 MB rows (2 and 4 positions; 97,920 and 48,960 blocks)
    # of the first two frames of the 1080p IPPP and motion streams (those
    # the rowshard phase's dense step decodes)
    def idct_bound(n):
        return (n * (16 * 4 * 2 + 8) + n * 64, n * OPS_IDCT_BLOCK)

    late_checks = len(checks)
    for name in ("ippp_1080p", "motion_1080p"):
        for k in (0, 1):
            for first, n_rows in ((34, 34), (51, 17)):
                args = dense_blocks(name, k, first, n_rows)
                n = args[0].shape[0]
                check("idct_blocks", lambda *a: (idct_blocks(*a[:4]),),
                      lambda *a: (idct_blocks_plain(*a[:4]),), args, (n,))
                checks[-1]["case"] = f"{name} frame {k}, MB rows " \
                    f"{first}-{first + n_rows - 1}"
    # the row: the second of 2 stripes of the motion stream's P picture;
    # and over 16 tiles of the TPU kernel (the earlier row's shape)
    args = dense_blocks("motion_1080p", 1, 34, 34)
    n = args[0].shape[0]
    time_kernel("idct_blocks", lambda *a: (idct_blocks(*a[:4]),),
                lambda *a: (idct_blocks_plain(*a[:4]),), args, (n,),
                idct_bound(n), 1, 5, cold=True)
    n = 8192
    args = kc.case_inputs(kc.idct_case(16, n), kc.IDCT_STATE, dev)
    time_kernel("idct_blocks", lambda *a: (idct_blocks(*a[:4]),),
                lambda *a: (idct_blocks_plain(*a[:4]),), args, (n,),
                idct_bound(n), 1, 5, True, cold=True)
    # the dense frame_step's blocks: the whole P picture (195,840 blocks),
    # one launch per frame on that path
    n = dense_k9[0].shape[0]
    time_kernel("idct_blocks", lambda *a: (idct_blocks(*a[:4]),),
                lambda *a: (idct_blocks_plain(*a[:4]),), dense_k9, (n,),
                idct_bound(n), 1, 5, True,
                "motion_1080p frame 1, dense (frame_step)", cold=True)
    extra_rows[-1]["launches_per_frame"] = dense_k9_per_frame
    # the residual stage on the second picture (a P picture) of the 1080p
    # motion stream
    t, sids, slv, _, n = motion
    args = residual_args(t, sids, slv)
    time_kernel("residual_sparse",
                lambda *a: residual_planes_sparse_cuda(*a[:6], n),
                lambda *a: residual_planes_sparse(*a[:6], n), args,
                (120, 68), residual_bound(args, n), 1, 5)
    emit({"phase": "timing", "gpu": smi, "checks": checks[late_checks:],
          "kernels": [{k: r[k] for k in ("name", "dims", "ms", "event_ms",
                                         "plain_ms", "bound_ms",
                                         "cuda_launches_per_call",
                                         "profiled_launches_per_call",
                                         "serial_steps",
                                         "launches_per_frame", "case",
                                         "no_edges_ms", "cold_ms",
                                         "cold_copies",
                                         "cold_share_of_bound")
                       if k in r}
                      for r in rows + extra_rows],
          "mc_old_route": old_route_row})

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
