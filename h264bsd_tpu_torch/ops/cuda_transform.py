"""Dequant + inverse-transform kernel (K9): wrappers and plain versions.

Counterpart of the JAX package's ops/pallas_transform.py
(idct_blocks_pallas :64, _idct_kernel :25). The kernels are in
csrc/transform.cu, one block-transform body with two entry points:

- idct_blocks: K9 itself, (N, 16) levels and scales with an optional
  external DC per block; plain version transform.idct_blocks_plain.
- residual_transform_cuda: the dense residual transform (the JAX
  package's residual_transform, ops/transform.py:137) of the row-sharded
  stripe step, through idct_blocks: the DC transforms, dequant scales,
  external DC and skip flags in PyTorch, the nMB x 24 blocks in one
  launch of K9, then the empty-block mask; plain version
  transform.residual_transform.
- residual_planes_sparse_cuda: the whole residual stage of the main
  path in one memset and two launches: a map from block id to sparse
  entry, then one warp per MB that gathers and transforms its luma and
  chroma DC (transform.residual_dc's work), makes its 24 blocks and
  writes its residuals once. Plain version
  transform.residual_planes_sparse.
"""

from __future__ import annotations

import torch

from . import _kernels
from .transform import (idct_blocks_plain, residual_blocks,
                        residual_planes_sparse)


def idct_blocks(coeff, scales, ext_dc, skip_dc):
    """K9: (N, 16) levels * scales, position 0 replaced by ext_dc where
    skip_dc != 0, 4x4 IDCT, (x + 32) >> 6 -> (N, 16) int32. CPU tensors
    run the plain version. The kernel reads and writes the (N, 16) arrays
    16 bytes a lane: an int32 view of them that is not 16-byte aligned
    raises ValueError (other dtypes and layouts are copied first)."""
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
                    _kernels.ptr(c, i32, (n, 16), "coeff", 16),
                    _kernels.ptr(s, i32, (n, 16), "scales", 16),
                    _kernels.ptr(dc, i32, (n,), "ext_dc"),
                    _kernels.ptr(sk, i32, (n,), "skip_dc"),
                    _kernels.ptr(out, i32, (n, 16), "out", 16), n)
    return out


def residual_transform_cuda(coeff, luma_dc, chroma_dc, qp_y,
                            chroma_qp_offset, nnz, nnz_dc, is_i16):
    """The dense residual transform (see transform.residual_transform)
    with its blocks through K9 (idct_blocks). CPU tensors run the plain
    version."""
    n_mb = coeff.shape[0]
    *blocks, empty = residual_blocks(coeff, luma_dc, chroma_dc, qp_y,
                                     chroma_qp_offset, nnz, nnz_dc, is_i16)
    res = idct_blocks(*blocks).reshape(n_mb, 24, 16)
    return torch.where(empty[:, :, None], 0, res), empty


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
    # the main path's dtypes pass as they are (no copies); the int16
    # levels are read 16 bytes at a time
    ids = sparse_ids.reshape(-1).to(torch.int64).contiguous()
    cap = ids.shape[0]
    lv = sparse_levels.to(torch.int16).contiguous()
    qp = qp_y.to(torch.uint8).contiguous()
    cqo = chroma_qp_offset.to(torch.int8).contiguous()
    nnz = nnz_dc.to(i32).contiguous()
    i16 = is_i16.to(torch.bool).contiguous()
    slot = torch.empty(n_mb * 26, dtype=i32, device=dev)    # the id map
    res_l = torch.empty((n_mb, 16, 16), dtype=i32, device=dev)
    res_c = torch.empty((n_mb, 2, 8, 8), dtype=i32, device=dev)
    _kernels.launch("h264_residual_sparse", dev,
                    _kernels.ptr(ids, torch.int64, (cap,), "sparse_ids"),
                    _kernels.ptr(lv, torch.int16, (cap, 16), "sparse_levels",
                                 16),
                    _kernels.ptr(qp, torch.uint8, (n_mb,), "qp_y"),
                    _kernels.ptr(cqo, torch.int8, (n_mb,),
                                 "chroma_qp_offset"),
                    _kernels.ptr(nnz, i32, (n_mb, 3), "nnz_dc"),
                    _kernels.ptr(i16, torch.bool, (n_mb,), "is_i16"),
                    _kernels.ptr(slot, i32, (n_mb * 26,), "slot"),
                    _kernels.ptr(res_l, i32, (n_mb, 16, 16), "res_l", 16),
                    _kernels.ptr(res_c, i32, (n_mb, 2, 8, 8), "res_c", 16),
                    cap, n_mb)
    return res_l, res_c
