"""Each hand-written CUDA kernel of the PyTorch port against its plain
PyTorch version, on the card, with zero tolerance (integer codec).

Needs a CUDA device and nvcc: a CUDA kernel has no CPU mode, so every
test here skips without one. The repository's tests/conftest.py imports
JAX, which the port's GPU machine does not have; run there with

  python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest \
      -o addopts=""
"""

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
from h264bsd_tpu_torch.ops.intra import intra_pass_list
from h264bsd_tpu_torch.utils.kernel_cases import (deblock_case,
                                                  deblock_inputs, intra_case,
                                                  intra_inputs,
                                                  padded_intra_ids)

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


@pytest.mark.parametrize("seed,dims", [(0, (6, 4)), (1, (9, 5)),
                                       (2, (3, 7)), (3, (20, 12))])
def test_deblock_wavefront_kernel(dev, seed, dims):
    args = deblock_inputs(deblock_case(seed, *dims), *dims, dev)
    before = _kernels.LAUNCHES["deblock_wf"]
    got = deblock_frame_wavefront_from_bs(*_clone_planes(args), *dims)
    want = deblock_wavefront_plain(*_clone_planes(args), *dims)
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["deblock_wf"] == before + 1


@pytest.mark.parametrize("seed,dims", [(4, (2, 5)), (5, (1, 1))])
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


@pytest.mark.parametrize("dims", [(12, 9), (16, 3), (5, 11), (3, 2),
                                  (20, 12)])
def test_intra_wavefront_kernel(dev, dims):
    args = intra_inputs(intra_case(7, *dims), dev)
    before = _kernels.LAUNCHES["intra_wf"]
    got = intra_pass_wavefront_cuda(*_clone_planes(args), *dims)
    want = intra_pass_wavefront_plain(*_clone_planes(args), *dims)
    _assert_planes_equal(got, want)
    assert _kernels.LAUNCHES["intra_wf"] == before + 1


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
