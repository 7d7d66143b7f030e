"""K9 (dequant + inverse transform) of the PyTorch port, on the CPU: its
plain version against the JAX package's Pallas kernel in interpret mode
and against the XLA idct4x4; the residual stage's wrapper, on CPU
tensors, against the JAX package's residual_planes_sparse, on random
cases and on the edge cases of the fused kernel (DC pass-through, chroma
QP offsets of +-12, ids in class order, qp 0 and 51); and the CUDA
source's constant tables against the Python ones. The kernels themselves
run on the card only (tests/test_torch_kernels_cuda.py)."""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264bsd_tpu.ops import transform as jtransform
from h264bsd_tpu_torch.ops import _kernels
from h264bsd_tpu_torch.ops import transform as ttransform
from h264bsd_tpu_torch.ops.cuda_transform import (idct_blocks,
                                                  residual_planes_sparse_cuda)
from h264bsd_tpu_torch.utils.kernel_cases import (IDCT_STATE, RESIDUAL_STATE,
                                                  case_inputs, idct_case,
                                                  residual_case,
                                                  residual_edge_case)

CPU = torch.device("cpu")
CSRC = Path(__file__).parents[1] / "h264bsd_tpu_torch" / "csrc"


def _eq(got, want, name):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), name)


@pytest.mark.parametrize("share", [0, 0.5, 1])
@pytest.mark.parametrize("n", [1024, 700])
def test_idct_blocks_plain_matches_pallas_interpret(n, share):
    """N = 1024 blocks (two of the TPU kernel's 512-block tiles) and 700
    (ragged: the Pallas kernel's input is padded with zero blocks to its
    tile here, and its output cut back to N), an external DC on none,
    half or all of them."""
    import jax.experimental.pallas as pl
    from h264bsd_tpu.ops import pallas_transform as pt
    case = idct_case(0, n)
    case["skip_dc"] = (np.random.default_rng(1).random(n) < share).astype(
        np.int32)
    pad = -n % pt.TILE
    padded = [np.pad(case[k], [(0, pad)] + [(0, 0)] * (case[k].ndim - 1))
              for k in IDCT_STATE]
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, interpret=True, **k)
    try:
        want = pt.idct_blocks_pallas(*(jnp.asarray(a) for a in padded))[:n]
    finally:
        pl.pallas_call = orig
    got = ttransform.idct_blocks_plain(*case_inputs(case, IDCT_STATE, CPU))
    assert got.dtype == torch.int32 and got.shape == (n, 16)
    _eq(got, want, "idct_blocks")


def test_idct_blocks_plain_matches_idct4x4():
    case = idct_case(1, 1024)
    d = case["coeff"] * case["scales"]
    d[:, 0] = np.where(case["skip_dc"] != 0, case["ext_dc"], d[:, 0])
    want = jtransform.idct4x4(jnp.asarray(d))
    args = case_inputs(case, IDCT_STATE, CPU)
    before = dict(_kernels.LAUNCHES)
    for fn in (ttransform.idct_blocks_plain, idct_blocks):
        _eq(fn(*args), want, fn.__name__)
    assert _kernels.LAUNCHES == before     # CPU tensors: plain versions


@partial(jax.jit, static_argnums=(6,))
def _jax_residual(ids, levels, qp, cqo, nnz_dc, is_i16, n):
    return jtransform.residual_planes_sparse(ids, levels, qp, cqo, nnz_dc,
                                             is_i16, n)


def _residual_matches_jax(case, n):
    want = _jax_residual(*(jnp.asarray(case[k]).astype(jnp.int32)
                           for k in RESIDUAL_STATE[:5]),
                         jnp.asarray(case["is_i16"]), n)
    args = case_inputs(case, RESIDUAL_STATE, CPU)
    before = dict(_kernels.LAUNCHES)
    for fn in (ttransform.residual_planes_sparse,
               residual_planes_sparse_cuda):
        res_l, res_c = fn(*args, n)
        _eq(res_l, want[0], f"{fn.__name__} res_l")
        _eq(res_c, want[1], f"{fn.__name__} res_c")
    assert _kernels.LAUNCHES == before     # CPU tensors: plain versions


@pytest.mark.parametrize("seed,dims", [(0, (6, 4)), (1, (9, 5))])
def test_residual_stage_matches_jax(seed, dims):
    _residual_matches_jax(residual_case(seed, *dims), dims[0] * dims[1])


@pytest.mark.parametrize("qp", [None, 0, 51])
def test_residual_stage_edge_case_matches_jax(qp):
    """Intra_16x16 MBs with nnz_dc[0] clear, chroma_qp_offset +-12, ids in
    class order (not sorted), and every qp_y at either end of its range."""
    dims = (6, 4)
    n = dims[0] * dims[1]
    case = residual_edge_case(3, *dims, qp=qp)
    ids = case["sparse_ids"][case["sparse_ids"] < n * 26]
    assert (np.diff(ids) < 0).any()
    i16 = case["is_i16"]
    assert (case["nnz_dc"][i16, 0] == 0).any()
    assert set(case["chroma_qp_offset"].tolist()) == {-12, 12}
    _residual_matches_jax(case, n)


def _cu_table(name, size):
    src = (CSRC / "transform.cu").read_text()
    body = re.search(re.escape(f"{name}{size} = {{") + r"(.*?)\};", src,
                     re.S).group(1)
    return np.array([int(v) for v in re.findall(r"\d+", body)])


def test_kernel_dc_tables_match_python():
    _eq(_cu_table("kQpC", "[52]"), ttransform.QP_C, "QP_C")
    _eq(_cu_table("kLevelScaleDc", "[6]"), ttransform.LEVEL_SCALE_DC,
        "LEVEL_SCALE_DC")


def test_kernel_scale_table_matches_python():
    src = (CSRC / "transform.cu").read_text()
    body = re.search(r"kLevelScalePos\[6\]\[16\] = \{(.*?)\};", src,
                     re.S).group(1)
    table = np.array([int(v) for v in re.findall(r"\d+", body)])
    _eq(table.reshape(6, 16), ttransform.LEVEL_SCALE_POS, "LEVEL_SCALE_POS")
