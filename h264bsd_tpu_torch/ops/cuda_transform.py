"""Dequant + inverse-transform kernel (K9): wrappers and plain versions.

Counterpart of the JAX package's ops/pallas_transform.py
(idct_blocks_pallas :64, _idct_kernel :25). The kernels are in
csrc/transform.cu, one block-transform body with two entry points:

- idct_blocks: K9 itself, (N, 16) levels and scales with an optional
  external DC per block; plain version transform.idct_blocks_plain.
- residual_planes_sparse_cuda: the residual stage of the main path. The
  DC gathering and the luma/chroma DC transforms stay PyTorch
  (transform.residual_dc); the kernel writes every block's DC-only
  residual, then transforms the shipped AC blocks over it. Plain version
  transform.residual_planes_sparse.
"""

from __future__ import annotations

import torch

from . import _kernels
from .transform import idct_blocks_plain, residual_dc, residual_planes_sparse


def idct_blocks(coeff, scales, ext_dc, skip_dc):
    """K9: (N, 16) levels * scales, position 0 replaced by ext_dc where
    skip_dc != 0, 4x4 IDCT, (x + 32) >> 6 -> (N, 16) int32. CPU tensors
    run the plain version."""
    if coeff.device.type == "cpu":
        return idct_blocks_plain(coeff, scales, ext_dc, skip_dc)
    n = coeff.shape[0]
    dev = coeff.device
    i32 = torch.int32
    # int32 copies where needed; they stay alive until the launch has
    # been enqueued
    c, s, dc, sk = (t.to(i32).contiguous() for t in
                    (coeff, scales, ext_dc, skip_dc))
    out = torch.empty((n, 16), dtype=i32, device=dev)
    _kernels.launch("h264_idct_blocks", dev,
                    _kernels.ptr(c, i32, (n, 16), "coeff"),
                    _kernels.ptr(s, i32, (n, 16), "scales"),
                    _kernels.ptr(dc, i32, (n,), "ext_dc"),
                    _kernels.ptr(sk, i32, (n,), "skip_dc"),
                    _kernels.ptr(out, i32, (n, 16), "out"), n)
    return out


def residual_planes_sparse_cuda(sparse_ids, sparse_levels, qp_y,
                                chroma_qp_offset, nnz_dc, is_i16, n_mb):
    """The residual stage (see transform.residual_planes_sparse):
    sparse_ids (cap,) mb*26 + b, sparse_levels (cap, 16) -> res_l
    (nMB, 16, 16), res_c (nMB, 2, 8, 8) int32. CPU tensors run the plain
    version."""
    if sparse_ids.device.type == "cpu":
        return residual_planes_sparse(sparse_ids, sparse_levels, qp_y,
                                      chroma_qp_offset, nnz_dc, is_i16, n_mb)
    dev = sparse_ids.device
    i32 = torch.int32
    dc, cqp = residual_dc(sparse_ids, sparse_levels, qp_y, chroma_qp_offset,
                          nnz_dc, is_i16, n_mb)
    ids = sparse_ids.reshape(-1).to(i32).contiguous()
    cap = ids.shape[0]
    lv = sparse_levels.to(torch.int16).contiguous()
    qp32, cqp32, dc32 = (t.to(i32).contiguous() for t in (qp_y, cqp, dc))
    res_l = torch.empty((n_mb, 16, 16), dtype=i32, device=dev)
    res_c = torch.empty((n_mb, 2, 8, 8), dtype=i32, device=dev)
    _kernels.launch("h264_residual_sparse", dev,
                    _kernels.ptr(ids, i32, (cap,), "sparse_ids"),
                    _kernels.ptr(lv, torch.int16, (cap, 16), "sparse_levels"),
                    _kernels.ptr(qp32, i32, (n_mb,), "qp_y"),
                    _kernels.ptr(cqp32, i32, (n_mb,), "chroma_qp"),
                    _kernels.ptr(dc32, i32, (n_mb, 24), "dc"),
                    _kernels.ptr(res_l, i32, (n_mb, 16, 16), "res_l"),
                    _kernels.ptr(res_c, i32, (n_mb, 2, 8, 8), "res_c"),
                    cap, n_mb)
    return res_l, res_c
