"""Each hand-written CUDA kernel of the PyTorch port against its plain
PyTorch version, on the card, with zero tolerance (integer codec), and
the CUDA-graph replay of the frame body against its eager run.

Needs a CUDA device and nvcc: a CUDA kernel has no CPU mode, so every
test here skips without one. The repository's tests/conftest.py imports
JAX, which the port's GPU machine does not have; run there with

  python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest \
      -o addopts=""
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h264bsd_tpu_torch.ops import _kernels
from h264bsd_tpu_torch.ops.cuda_deblock import (deblock_frame_cuda_from_bs,
                                                deblock_raster_plain)
from h264bsd_tpu_torch.ops.cuda_deblock_wf import (
    deblock_frame_wavefront_from_bs, deblock_wavefront_plain)
from h264bsd_tpu_torch.ops.cuda_intra import intra_pass_cuda
from h264bsd_tpu_torch.ops.cuda_intra_wf import (intra_pass_wavefront_cuda,
                                                 intra_pass_wavefront_plain)
from h264bsd_tpu_torch.ops.cuda_mc import (mc_exception_cuda,
                                           mc_exception_plain,
                                           mc_recon_cuda, mc_recon_plain,
                                           mc_uniform_cuda, mc_uniform_plain)
from h264bsd_tpu_torch.ops.cuda_transform import (
    idct_blocks, residual_planes_sparse_cuda)
from h264bsd_tpu_torch.ops.intra import intra_pass_list
from h264bsd_tpu_torch.ops.transform import (idct_blocks_plain,
                                             residual_planes_sparse)
from h264bsd_tpu_torch.utils.kernel_cases import (IDCT_STATE,
                                                  RESIDUAL_STATE,
                                                  case_inputs, deblock_case,
                                                  deblock_inputs, idct_case,
                                                  intra_case, intra_inputs,
                                                  mc_case, mc_inputs,
                                                  mc_recon_case,
                                                  mc_recon_inputs,
                                                  mc_recon_stripe,
                                                  mc_stripe,
                                                  padded_intra_ids,
                                                  residual_case,
                                                  residual_edge_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _clone_planes(args):
    return tuple(a.clone() for a in args[:3]) + tuple(args[3:])


def _assert_planes_equal(got, want):
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        torch.cuda.synchronize()
        assert torch.equal(g, w), name


# the narrowest frame K1 takes (the longest chain per MB), one row, 1080p
@pytest.mark.parametrize("seed,dims", [(0, (6, 4)), (1, (9, 5)),
                                       (2, (3, 7)), (3, (20, 12)),
                                       (10, (3, 40)), (11, (40, 1)),
                                       (12, (120, 68))])
def test_deblock_wavefront_kernel(dev, seed, dims):
    args = deblock_inputs(deblock_case(seed, *dims), *dims, dev)
    before = _kernels.LAUNCHES["deblock_wf"]
    got = deblock_frame_wavefront_from_bs(*_clone_planes(args), *dims)
    want = deblock_wavefront_plain(*_clone_planes(args), *dims)
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["deblock_wf"] == before + 1


# one MB, one band, a 32x1088 strip and a 1x68 column (5 bands of 16 MB
# rows), the tallest 2-MB-wide frame of level 5.1 (34 bands)
@pytest.mark.parametrize("seed,dims", [(4, (2, 5)), (5, (1, 1)), (6, (2, 4)),
                                       (7, (2, 4)), (8, (1, 68)),
                                       (9, (1, 68)), (10, (2, 68)),
                                       (11, (2, 68)), (12, (2, 543)),
                                       (13, (2, 543))])
def test_deblock_raster_kernel(dev, seed, dims):
    args = deblock_inputs(deblock_case(seed, *dims), *dims, dev)
    before = _kernels.LAUNCHES["deblock_raster"]
    got = deblock_frame_cuda_from_bs(*_clone_planes(args), *dims)
    want = deblock_raster_plain(*_clone_planes(args), *dims)
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["deblock_raster"] == before + 1


@pytest.mark.parametrize("seed,dims,pad", [(0, (6, 4), 0),
                                           (1, (20, 12), 7)])
def test_intra_list_kernel(dev, seed, dims, pad):
    case = intra_case(seed, *dims)
    args = intra_inputs(case, dev)
    ids = padded_intra_ids(case, pad, dev)
    before = _kernels.LAUNCHES["intra_list"]
    got = intra_pass_cuda(*_clone_planes(args), *dims, intra_ids=ids)
    want = intra_pass_list(*_clone_planes(args)[:3], ids,
                           *_clone_planes(args)[3:], dims[0])
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["intra_list"] == before + 1


def _intra_list_case(kind):
    """(case, dims, padding, shuffle seed) of each kind of list K2 must
    walk: a shuffled order (one the front-end never ships), a sparse 1080p
    list (~3% intra, a P picture's share), padding only, and a dense
    40x23 all-intra list padded to its cap."""
    return {
        "shuffled": (intra_case(2, 20, 12), (20, 12), 7, 2),
        "sparse": (intra_case(3, 120, 68, intra_share=0.03), (120, 68),
                   200, None),
        "padding": (intra_case(4, 6, 4, intra_share=0.0), (6, 4), 16,
                    None),
        "dense": (intra_case(5, 40, 23, all_intra=True), (40, 23), 104,
                  None)}[kind]


@pytest.mark.parametrize("kind", ["shuffled", "sparse", "padding", "dense"])
def test_intra_list_kernel_lists(dev, kind):
    case, dims, pad, shuffle = _intra_list_case(kind)
    args = intra_inputs(case, dev)
    ids = padded_intra_ids(case, pad, dev, shuffle_seed=shuffle)
    before = _kernels.LAUNCHES["intra_list"]
    got = intra_pass_cuda(*_clone_planes(args), *dims, intra_ids=ids)
    want = intra_pass_list(*_clone_planes(args)[:3], ids,
                           *_clone_planes(args)[3:], dims[0])
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["intra_list"] == before + 1


def _replays_equal(kernel, args, want, replays):
    """Capture one call of kernel(*planes, ...) in a CUDA graph and replay
    it on fresh copies of the planes; every replay equals `want`. A race
    between the blocks of a dependency-driven kernel shows as a replay
    that differs."""
    static = _clone_planes(args)
    kernel(*_clone_planes(args))           # warm: libraries, tables
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernel(*static)
    for k in range(replays):
        for dst, src in zip(static[:3], args[:3]):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for g, w, name in zip(static[:3], want, ("y", "cb", "cr")):
            assert torch.equal(g, w), f"replay {k} {name}"


def test_deblock_wavefront_kernel_graph_replays(dev):
    dims = (120, 68)
    args = deblock_inputs(deblock_case(13, *dims), *dims, dev)
    want = deblock_wavefront_plain(*_clone_planes(args), *dims)
    _replays_equal(lambda *a: deblock_frame_wavefront_from_bs(*a, *dims),
                   args, want, 50)


def test_deblock_raster_kernel_graph_replays(dev):
    dims = (2, 543)
    args = deblock_inputs(deblock_case(14, *dims), *dims, dev)
    want = deblock_raster_plain(*_clone_planes(args), *dims)
    _replays_equal(lambda *a: deblock_frame_cuda_from_bs(*a, *dims),
                   args, want, 50)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_intra_list_kernel_graph_replays(dev, kind):
    case, dims, pad, shuffle = _intra_list_case(kind)
    args = intra_inputs(case, dev)
    ids = padded_intra_ids(case, pad, dev, shuffle_seed=shuffle)
    want = intra_pass_list(*_clone_planes(args)[:3], ids,
                           *_clone_planes(args)[3:], dims[0])
    _replays_equal(lambda *a: intra_pass_cuda(*a, *dims, intra_ids=ids),
                   args, want, 50)


# K2 with MB 0's position prefilled with -1 instead of INT32_MAX: its
# entry then reads as a repeat and is skipped without a done flag, while
# its right neighbour MB 1, listed after it, waits for that flag forever
_DEADLOCK = """
import torch
from h264bsd_tpu_torch.ops import _kernels
from h264bsd_tpu_torch.ops.cuda_intra import intra_args
from h264bsd_tpu_torch.utils.kernel_cases import intra_case, intra_inputs
dims = (2, 1)
case = intra_case(0, *dims, all_intra=True)
args = intra_inputs(case, torch.device("cuda"))
ids = torch.arange(2, dtype=torch.int32, device="cuda")
pos = torch.tensor([-1, 2 ** 31 - 1], dtype=torch.int32, device="cuda")
sync = torch.zeros(3, dtype=torch.int32, device="cuda")
ptrs, keep = intra_args(*args, *dims)
_kernels.launch("h264_intra_list", args[0].device, *ptrs, ids.data_ptr(),
                pos.data_ptr(), sync.data_ptr(), 2, *dims)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
"""


def test_a_wait_that_never_ends_traps(dev):
    """The bounded spin: a dependency that is never released aborts the
    kernel after the spin's limit (2 s) instead of hanging the card, and
    the fault is raised at the next synchronization. In a child process,
    whose CUDA context the fault ends."""
    out = subprocess.run([sys.executable, "-c", _DEADLOCK],
                         capture_output=True, text=True, timeout=300,
                         cwd=Path(__file__).parents[1])
    assert "raised:" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("dims", [(12, 9), (16, 3), (5, 11), (3, 2),
                                  (20, 12)])
def test_intra_wavefront_kernel(dev, dims):
    args = intra_inputs(intra_case(7, *dims), dev)
    before = _kernels.LAUNCHES["intra_wf"]
    got = intra_pass_wavefront_cuda(*_clone_planes(args), *dims)
    want = intra_pass_wavefront_plain(*_clone_planes(args), *dims)
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["intra_wf"] == before + 1


def _all_c_case(seed, w, h):
    """Every above-right bit set: blocks 5 and 13 of the Intra_4x4 chain
    then read the pels they must take from the copy made before it."""
    case = intra_case(seed, w, h)
    case["i4_avail"] = case["i4_avail"] | 4
    return case


@pytest.mark.parametrize("kind", ["random_c", "all_c", "all_intra"])
def test_intra_wavefront_kernel_1080p(dev, kind):
    dims = (120, 68)
    case = {"random_c": lambda: intra_case(14, *dims),
            "all_c": lambda: _all_c_case(14, *dims),
            "all_intra": lambda: intra_case(14, *dims, all_intra=True)}[kind]()
    args = intra_inputs(case, dev)
    before = _kernels.LAUNCHES["intra_wf"]
    got = intra_pass_wavefront_cuda(*_clone_planes(args), *dims)
    want = intra_pass_wavefront_plain(*_clone_planes(args), *dims)
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["intra_wf"] == before + 1


def test_intra_wavefront_kernel_graph_replays(dev):
    dims = (120, 68)
    args = intra_inputs(intra_case(15, *dims, all_intra=True), dev)
    want = intra_pass_wavefront_plain(*_clone_planes(args), *dims)
    _replays_equal(lambda *a: intra_pass_wavefront_cuda(*a, *dims), args,
                   want, 50)


def test_intra_list_kernel_all_c(dev):
    """K2 shares the Intra_4x4 chain of K7."""
    dims = (20, 12)
    case = _all_c_case(16, *dims)
    args = intra_inputs(case, dev)
    ids = padded_intra_ids(case, 5, dev)
    got = intra_pass_cuda(*_clone_planes(args), *dims, intra_ids=ids)
    want = intra_pass_list(*_clone_planes(args)[:3], ids,
                           *_clone_planes(args)[3:], dims[0])
    _assert_planes_equal(got, want)


def test_narrow_frames_go_to_the_raster_kernels(dev):
    """Under 3 MBs wide the wavefront wrappers hand off to K8 and K2."""
    dims = (2, 4)
    args = intra_inputs(intra_case(8, *dims), dev)
    before = dict(_kernels.LAUNCHES)
    got = intra_pass_wavefront_cuda(*_clone_planes(args), *dims)
    want = intra_pass_wavefront_plain(*_clone_planes(args), *dims)
    _assert_planes_equal(got, want)
    args = deblock_inputs(deblock_case(9, *dims), *dims, dev)
    got = deblock_frame_wavefront_from_bs(*_clone_planes(args), *dims)
    want = deblock_wavefront_plain(*_clone_planes(args), *dims)
    _assert_planes_equal(got, want)
    after = _kernels.LAUNCHES
    assert after["intra_list"] == before["intra_list"] + 1
    assert after["deblock_raster"] == before["deblock_raster"] + 1
    assert after["intra_wf"] == before["intra_wf"]
    assert after["deblock_wf"] == before["deblock_wf"]


# (seed, dims, slots): the decode tests' size, a mid size and 1080p, with
# 1, 4 and 16 reference slots
MC_CASES = [(0, (6, 4), 1), (1, (20, 12), 4), (2, (120, 68), 16)]


@pytest.mark.parametrize("seed,dims,n_slots", MC_CASES)
def test_mc_uniform_kernel(dev, seed, dims, n_slots):
    args = mc_inputs(mc_case(seed, *dims, n_slots, 0.25), dev)[:5]
    before = _kernels.LAUNCHES["mc_uniform"]
    got = mc_uniform_cuda(*args, *dims)
    want = mc_uniform_plain(*args, *dims)
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["mc_uniform"] == before + 1


@pytest.mark.parametrize("seed,dims,n_slots", MC_CASES)
@pytest.mark.parametrize("known_count", [True, False])
def test_mc_exception_kernel(dev, seed, dims, n_slots, known_count):
    """Over the uniform grids; without the count the kernel also walks
    the padding entries of exc_ids, which must leave the grids alone."""
    case = mc_case(seed, *dims, n_slots, 0.25)
    args = mc_inputs(case, dev)
    n_exc = case["n_exc"] if known_count else None
    grids = mc_uniform_plain(*args[:5], *dims)
    before = _kernels.LAUNCHES["mc_exception"]
    got = mc_exception_cuda(*(g.clone() for g in grids), *args, *dims,
                            n_exc=n_exc)
    want = mc_exception_plain(*(g.clone() for g in grids), *args, *dims,
                              n_exc=n_exc)
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["mc_exception"] == before + 1


def test_mc_exception_kernel_without_entries_does_not_launch(dev):
    case = mc_case(3, 6, 4, 2, 0.0)
    args = mc_inputs(case, dev)
    grids = mc_uniform_plain(*args[:5], 6, 4)
    before = _kernels.LAUNCHES["mc_exception"]
    got = mc_exception_cuda(*(g.clone() for g in grids), *args, 6, 4,
                            n_exc=case["n_exc"])
    _assert_planes_equal(got, grids)
    assert case["n_exc"] == 0
    assert _kernels.LAUNCHES["mc_exception"] == before


def _one_mc_recon_launch(args, dims):
    """mc_recon_cuda on args, counting launches: one of mc_recon, none of
    the other MC kernels."""
    before = dict(_kernels.LAUNCHES)
    got = mc_recon_cuda(*args, *dims)
    after = dict(_kernels.LAUNCHES)
    assert after["mc_recon"] == before["mc_recon"] + 1
    for k in ("mc_uniform", "mc_exception"):
        assert after[k] == before[k]
    return got


@pytest.mark.parametrize("seed,dims,n_slots", MC_CASES)
@pytest.mark.parametrize("pcm", [False, True])
def test_mc_recon_kernel(dev, seed, dims, n_slots, pcm):
    args = mc_recon_inputs(mc_recon_case(seed, *dims, n_slots, 0.25,
                                         pcm=pcm), dev)
    got = _one_mc_recon_launch(args, dims)
    _assert_planes_equal(got, mc_recon_plain(*args, *dims))


# every MB's (every split block's) window across a frame edge, and MVs of
# whole luma pels only (half of them whole chroma pels too)
@pytest.mark.parametrize("motion", ["edge", "integer"])
@pytest.mark.parametrize("seed,dims,n_slots", [(3, (20, 12), 4),
                                               (4, (120, 68), 16)])
def test_mc_recon_kernel_edge_and_integer(dev, motion, seed, dims, n_slots):
    args = mc_recon_inputs(mc_recon_case(seed, *dims, n_slots, 0.25,
                                         pcm=True, motion=motion), dev)
    got = _one_mc_recon_launch(args, dims)
    _assert_planes_equal(got, mc_recon_plain(*args, *dims))


def test_mc_recon_kernel_graph_replays(dev):
    """50 replays of one captured call at 1080p, each into planes filled
    with a sentinel first: every replay writes every pel, as the plain
    version does."""
    dims = (120, 68)
    args = mc_recon_inputs(mc_recon_case(5, *dims, 4, 0.06, pcm=True), dev)
    want = mc_recon_plain(*args, *dims)
    mc_recon_cuda(*args, *dims)                # warm: the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mc_recon_cuda(*args, *dims)
    for k in range(50):
        for o in out:
            o.fill_(0xA5)
        graph.replay()
        torch.cuda.synchronize()
        for g, w, name in zip(out, want, ("y", "cb", "cr")):
            assert torch.equal(g, w), f"replay {k} {name}"


def test_p_decode_runs_mc_recon_only(dev):
    """The 6x4 motion stream on the card: the same pictures as the CPU
    decode, through mc_recon and neither mc_uniform nor mc_exception."""
    from h264bsd_tpu_torch.models import decoder as tdec
    from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

    data = make_motion_stream(6, 4, 4, seed=0)
    before = dict(_kernels.LAUNCHES)
    got = [p.yuv_bytes() for p in tdec.decode_stream(data, device=dev)]
    after = dict(_kernels.LAUNCHES)
    want = [p.yuv_bytes() for p in tdec.decode_stream(data, device="cpu")]
    assert got == want and len(got) == 4
    assert after["mc_recon"] >= before["mc_recon"] + 4
    for k in ("mc_uniform", "mc_exception"):
        assert after[k] == before[k]


# N ragged against the kernel's four lanes a block and 64 blocks a CUDA
# block, two tiles of the TPU kernel, 16 of them, and a whole 1080p
# frame's blocks; the external DC on half, none or all of the blocks;
# the arrays as made, or rows 3.. of larger ones (16-byte aligned views)
@pytest.mark.parametrize("layout", ["own", "slice"])
@pytest.mark.parametrize("skip", ["half", "none", "all"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 31, 32, 33, 512, 1000, 8191, 8192,
                               195840])
def test_idct_blocks_kernel(dev, n, skip, layout):
    case = idct_case(n, n + 3)
    if skip != "half":
        case["skip_dc"][:] = skip == "all"
    args = case_inputs(case, IDCT_STATE, dev)
    args = tuple(a[3:] if layout == "slice" else a[:n] for a in args)
    if layout == "slice":
        assert args[0].data_ptr() % 16 == 0 and args[0].storage_offset()
    before = _kernels.LAUNCHES["idct_blocks"]
    got = idct_blocks(*args)
    want = idct_blocks_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (n, 16)
    assert torch.equal(got, want)
    assert _kernels.LAUNCHES["idct_blocks"] == before + 1


@pytest.mark.parametrize("name", ["coeff", "scales"])
def test_idct_blocks_kernel_refuses_a_misaligned_view(dev, name):
    """A (N, 16) int32 view 4 bytes off a 16-byte boundary raises; the
    plain version does not run in the kernel's place."""
    args = list(case_inputs(idct_case(5, 64), IDCT_STATE, dev))
    i = IDCT_STATE.index(name)
    flat = torch.empty(64 * 16 + 1, dtype=torch.int32, device=dev)
    view = flat[1:].view(64, 16)
    view.copy_(args[i])
    assert view.data_ptr() % 16 == 4
    args[i] = view
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match=f"{name}: expected a 16-byte"):
        idct_blocks(*args)
    assert _kernels.LAUNCHES == before


@pytest.mark.parametrize("seed,dims", [(0, (6, 4)), (1, (20, 12)),
                                       (2, (120, 68))])
def test_residual_sparse_kernel(dev, seed, dims):
    n = dims[0] * dims[1]
    args = case_inputs(residual_case(seed, *dims), RESIDUAL_STATE, dev)
    before = _kernels.LAUNCHES["residual_sparse"]
    got = residual_planes_sparse_cuda(*args, n)
    want = residual_planes_sparse(*args, n)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("res_l", "res_c")):
        assert torch.equal(g, w), name
    assert _kernels.LAUNCHES["residual_sparse"] == before + 1


# ids in class order, nnz_dc-cleared Intra_16x16 MBs, chroma QP offsets
# of +-12; qp_y as drawn, at 0 and at 51; 1080p
@pytest.mark.parametrize("qp,dims", [(None, (6, 4)), (0, (20, 12)),
                                     (51, (20, 12)), (None, (120, 68))])
def test_residual_sparse_kernel_edge_cases(dev, qp, dims):
    n = dims[0] * dims[1]
    args = case_inputs(residual_edge_case(4, *dims, qp=qp), RESIDUAL_STATE,
                       dev)
    before = _kernels.LAUNCHES["residual_sparse"]
    got = residual_planes_sparse_cuda(*args, n)
    want = residual_planes_sparse(*args, n)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("res_l", "res_c")):
        assert torch.equal(g, w), name
    assert _kernels.LAUNCHES["residual_sparse"] == before + 1


def test_graph_replay_matches_eager_body(dev):
    """Every windowable frame of a P stream with real motion through
    Decoder._decode_step (a capture, then replays) leaves the same ring
    as the eager frame body on a copy of the ring taken just before."""
    from h264bsd_tpu_torch.frontend import binding as fe
    from h264bsd_tpu_torch.models import decoder as tdec
    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
    from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

    data = make_motion_stream(6, 4, 8, seed=2)
    dec = tdec.Decoder(device=dev)
    reset_stats()
    pos = frames = 0
    while pos < len(data):
        status, read = dec._fe.decode(data, 0, pos)
        pos += read
        if status == fe.PIC_RDY:
            prep = dec._prepare()
            assert dec._windowable(prep)
            dec._ensure_dpb(prep["geom"])
            ring = tuple(p.clone() for p in dec._dpb)
            tdec._frame_decode_body(dec._stage([prep])[0], ring, None,
                                    **dec._body_args(prep))
            dec._decode_step(prep)
            torch.cuda.synchronize()
            for g, w, name in zip(dec._dpb, ring, ("y", "cb", "cr")):
                assert torch.equal(g, w), f"frame {frames} {name}"
            frames += 1
            while dec._fe.next_output() is not None:
                pass
    assert frames == 8
    assert STATS["graph_replays"] > 0
    assert STATS["graph_captures"] + STATS["graph_replays"] == frames


def test_multistream_graph_replays_match_the_eager_rounds(dev):
    """Three motion streams, an I_PCM stream and a lost IDR slice (the
    spiral concealment), all 4x4 MBs, through MultiStreamDecoder on the
    card (one graph per round key, the frame bodies on their own CUDA
    streams; the I_PCM and spiral frames run eagerly on their ring slice
    after the replay) give, round by round, the pictures of the same
    decoder's eager rounds on the CPU."""
    from h264bsd_tpu_torch.models.graphs import STATS, reset_stats
    from h264bsd_tpu_torch.parallel.multistream import MultiStreamDecoder
    from h264bsd_tpu_torch.utils import streamgen
    from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream
    from h264bsd_tpu_torch.utils.recorded import drop_nal

    streams = [make_motion_stream(4, 4, 8, seed=s) for s in (3, 4, 5)] + [
        streamgen.make_pcm_stream(4, 4),
        drop_nal(streamgen.make_conformance_stream(slices_per_frame=2), 3)]
    decs = [MultiStreamDecoder(streams, device=d) for d in (dev, "cpu")]
    card = dict.fromkeys(STATS, 0)
    rounds = 0
    try:
        while True:
            reset_stats()
            ready = decs[0].step()
            for k, v in STATS.items():
                card[k] += v
            assert decs[1].step() == ready
            if not ready:
                break
            rounds += 1
            for i in range(len(streams)):
                assert len(decs[0].outputs[i]) == len(decs[1].outputs[i])
                for j in range(len(decs[0].outputs[i])):
                    for g, w, name in zip(decs[0].picture(i, j),
                                          decs[1].picture(i, j),
                                          ("y", "cb", "cr")):
                        assert torch.equal(g.cpu(), w), \
                            f"round {rounds} stream {i} picture {j} {name}"
    finally:
        for d in decs:
            d.close()
    assert rounds == 8
    assert card["graph_replays"] > 0
    assert card["eager_frames"] > 0


# ---- the MB-row offset of the MC kernels, and the multi-device decoders on
# a device list that repeats the card

@pytest.mark.parametrize("first_row,rows", [(0, 17), (3, 5), (51, 17)])
def test_mc_recon_kernel_with_a_row_offset(dev, first_row, rows):
    """A stripe of `rows` MB rows at MB row first_row of 1080p, predicted
    from the whole reference frames: the plain version's bytes, and the
    whole frame's rows there; MVs cross the frame's edges. A stripe of a
    taller ring launches mc_recon_stripe_kernel, the whole frame
    mc_recon_kernel."""
    dims = (120, 68)
    args = mc_recon_inputs(mc_recon_case(6, *dims, 4, 0.25, pcm=True,
                                         motion="edge"), dev)
    stripe = mc_recon_stripe(args, dims[0], first_row, rows)
    before = dict(_kernels.LAUNCHES)
    got = mc_recon_cuda(*stripe, dims[0], rows, mb_row_offset=first_row)
    assert _kernels.LAUNCHES["mc_recon_stripe"] == \
        before["mc_recon_stripe"] + 1
    assert _kernels.LAUNCHES["mc_recon"] == before["mc_recon"]
    _assert_planes_equal(got, mc_recon_plain(*stripe, dims[0], rows,
                                             mb_row_offset=first_row))
    whole = mc_recon_cuda(*args, *dims)
    assert _kernels.LAUNCHES["mc_recon"] == before["mc_recon"] + 1
    for g, f, s in zip(got, whole, (16, 8, 8)):
        assert torch.equal(g, f[first_row * s:(first_row + rows) * s])


@pytest.mark.parametrize("first_row", [0, 3])
def test_mc_predict_grids_with_a_row_offset(dev, first_row):
    """mc_uniform and mc_exception (the TPU kernels' signature) on a
    stripe of 5 MB rows of a 20x12 frame at MB row first_row, the
    exception ids rebased onto the stripe: the plain versions' bytes."""
    dims, rows = (20, 12), 5
    args = mc_stripe(mc_inputs(mc_case(7, *dims, 4, 0.25), dev), dims[0],
                     first_row, rows)
    got = mc_uniform_cuda(*args[:5], dims[0], rows, mb_row_offset=first_row)
    want = mc_uniform_plain(*args[:5], dims[0], rows,
                            mb_row_offset=first_row)
    _assert_planes_equal(got, want)
    got = mc_exception_cuda(*got, *args, dims[0], rows,
                            mb_row_offset=first_row)
    want = mc_exception_plain(*want, *args, dims[0], rows,
                              mb_row_offset=first_row)
    _assert_planes_equal(got, want)


def _card_and_cpu(dev, n):
    from h264bsd_tpu_torch.parallel.mesh import Mesh
    return Mesh([dev] * n, ("row",)), Mesh(["cpu"] * n, ("row",))


@pytest.mark.parametrize("kind", ["blob", "dense"])
def test_row_sharded_step_on_the_card(dev, kind):
    """The 6x4 motion stream through the row-sharded step on ["cuda"] * 2
    and on two CPU positions, frame by frame: the same rings."""
    from h264bsd_tpu_torch.frontend import binding as fe
    from h264bsd_tpu_torch.models.decoder import Decoder
    from h264bsd_tpu_torch.models.state import new_ring
    from h264bsd_tpu_torch.ops.reconstruct import build_pcm_tensors
    from h264bsd_tpu_torch.parallel.rowshard import (
        make_row_sharded_blob_step, make_row_sharded_step)
    from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

    data = make_motion_stream(6, 4, 4, seed=0)
    meshes = _card_and_cpu(dev, 2)
    dec = Decoder(device="cpu")
    rings = None
    pos = frames = 0
    before = dict(_kernels.LAUNCHES)
    while pos < len(data):
        status, read = dec._fe.decode(data, 0, pos)
        pos += read
        if status != fe.PIC_RDY:
            continue
        prep = dec._prepare()
        g, n = prep["geom"], prep["n_mbs"]
        if rings is None:
            rings = [tuple(m.replicate(p) for p in new_ring(
                g["dpb_slots"], 4, 6, "cpu")) for m in meshes]
        pcm = build_pcm_tensors(n, *prep["ipcm"])
        t = dec._fe.tensors(n)
        t["pcm_y"], t["pcm_cb"], t["pcm_cr"] = pcm
        for m, ring in zip(meshes, rings):
            if kind == "blob":
                make_row_sharded_blob_step(m, "row", 6, 4, prep["caps"])(
                    prep["blob"], *map(torch.from_numpy, pcm), *ring,
                    prep["info"]["slot"])
            else:
                make_row_sharded_step(m, "row", 6, 4)(
                    t, *ring, prep["info"]["slot"])
        for card, cpu in zip(*rings):
            for a, b in zip(card, cpu):
                assert torch.equal(a.cpu(), b), f"frame {frames}"
        while dec._fe.next_output() is not None:
            pass
        frames += 1
    dec.close()
    assert frames == 4
    # every stripe through mc_recon_stripe_kernel, each frame's blocks
    # through K9 on the dense step
    after = dict(_kernels.LAUNCHES)
    assert after["mc_recon_stripe"] == before["mc_recon_stripe"] + 2 * 4
    assert after["mc_recon"] == before["mc_recon"]
    if kind == "dense":
        assert after["idct_blocks"] == before["idct_blocks"] + 2 * 4


def test_framepipe_and_gop_on_the_card(dev):
    """Framepipe over ["cuda"] * 2 (a graph per position, the hand-off
    between the positions' rings) on an IPPP stream and on one whose first
    slice is corrupted (the eviction), and GOP-parallel decode with two
    workers on the card: the CPU decoder's pictures."""
    from h264bsd_tpu_torch.models.decoder import decode_stream
    from h264bsd_tpu_torch.parallel.framepipe import decode_stream_framepipe
    from h264bsd_tpu_torch.parallel.gop import (_nal_positions,
                                                decode_stream_gop_parallel)
    from h264bsd_tpu_torch.parallel.mesh import Mesh
    from h264bsd_tpu_torch.utils import streamgen
    from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

    ippp = streamgen.make_ippp_stream(4, 4, 6)
    bad = bytearray(ippp)
    first = next(n for n in _nal_positions(ippp) if n[2] in (1, 5))
    nxt = next(n for n in _nal_positions(ippp) if n[1] > first[0])
    bad[first[0] + int((nxt[1] - first[0]) * 0.8)] ^= 0xFF
    for data in (ippp, bytes(bad)):
        want = [p.yuv_bytes() for p in decode_stream(data, device="cpu")]
        got = [p.yuv_bytes() for p in decode_stream_framepipe(
            data, Mesh([dev] * 2, ("pipe",)), "pipe")]
        assert got == want
    data = b"".join(make_motion_stream(6, 4, 3, seed=s) for s in range(3))
    want = [p.yuv_bytes() for p in decode_stream(data, device="cpu")]
    got = [p.yuv_bytes() for p in decode_stream_gop_parallel(
        data, devices=[dev], threads=2)]
    assert got == want


@pytest.mark.parametrize("kind,dims,n_frames", [
    ("intra", (40, 23), 2), ("motion", (40, 23), 3),
    ("motion", (120, 68), 2)])
def test_dense_frame_step_on_the_card(dev, kind, dims, n_frames):
    """models/entry.frame_step on the front-end's dense tensors, frame by
    frame on the card and on the CPU: the same rings, with K9 and
    mc_recon launched once per frame (and K2, or K7 on the 1080p I
    picture, and K1)."""
    from h264bsd_tpu_torch.models.entry import dense_frames, frame_step
    from h264bsd_tpu_torch.models.state import new_ring
    from h264bsd_tpu_torch.utils import streamgen
    from h264bsd_tpu_torch.utils.motion_stream import make_motion_stream

    data = streamgen.make_intra_stress_stream(*dims, n_frames) \
        if kind == "intra" else make_motion_stream(*dims, n_frames, seed=0)
    frames = list(dense_frames(data))
    assert len(frames) == n_frames
    g = frames[0][2]
    rings = [new_ring(g["dpb_slots"], dims[1], dims[0], d)
             for d in (dev, "cpu")]
    before = dict(_kernels.LAUNCHES)
    for k, (t, slot, _, _) in enumerate(frames):
        for ring in rings:
            frame_step(t, *ring, slot, *dims)
        for a, b in zip(*rings):
            assert torch.equal(a.cpu(), b), f"frame {k}"
    after = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()}
    assert after["idct_blocks"] == after["mc_recon"] == n_frames
    assert after["deblock_wf"] == n_frames
    assert after["intra_list"] + after["intra_wf"] >= 1


def test_frame_checksum_device_on_the_card(dev):
    """The checksum on the card equals frame_checksum_host on 1080p
    planes: seeded, and all 255 (the largest sum), whole and truncated as
    the reference app dumps 1080p."""
    import numpy as np

    from h264bsd_tpu_torch.models.decoder import (frame_checksum_device,
                                                  frame_checksum_host)

    rng = np.random.default_rng(7)
    shapes = ((1088, 1920), (544, 960), (544, 960))
    for planes in ([rng.integers(0, 256, s, np.uint8) for s in shapes],
                   [np.full(s, 255, np.uint8) for s in shapes]):
        for n in (1920 * 1088 * 3 // 2, 1920 * 1080 * 3 // 2):
            got = frame_checksum_device(
                *(torch.from_numpy(p).to(dev) for p in planes), n)
            assert got.device.type == "cuda"
            assert int(got) == frame_checksum_host(
                b"".join(p.tobytes() for p in planes)[:n])


# the corrupted streams of reference_checksums.json (fuzz_<base>_s<seed>)
_REF = json.loads(
    (Path(__file__).parents[1] / "h264bsd_tpu_torch" / "testdata" /
     "reference_checksums.json").read_text())
FUZZ = sorted(k for k in _REF if k.startswith("fuzz_"))


@pytest.mark.parametrize("name", FUZZ)
def test_corrupted_stream_on_the_card(dev, name):
    """A corrupted stream's decode on the card: every picture's checksum
    equal to the recorded one and, but for the 1080p streams (whose plain
    versions take minutes on the CPU; tests/test_torch_fuzz.py holds the
    4x4 ones to the same checksums there), byte-equal to the port's
    decode on the CPU. The dependency-driven kernels wait on flags a
    corrupted stream's lists and classes set: a wait that never ends
    traps."""
    import hashlib

    from h264bsd_tpu_torch.models.decoder import (decode_stream,
                                                  frame_checksum_host)
    from h264bsd_tpu_torch.utils.recorded import make_recorded_stream

    data = make_recorded_stream(_REF[name])
    assert hashlib.sha256(data).hexdigest() == _REF[name]["sha256"]
    got = [p.yuv_bytes() for p in decode_stream(data, device=dev)]
    torch.cuda.synchronize()
    assert [frame_checksum_host(g) for g in got] == _REF[name]["checksums"]
    if "1080p" not in name:
        assert got == [p.yuv_bytes()
                       for p in decode_stream(data, device="cpu")]
