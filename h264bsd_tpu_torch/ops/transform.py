"""Inverse quantization + inverse transform of the sparse residual stream.

Behavioral parity: reference h264bsd_transform.c (h264bsdProcessBlock :97,
h264bsdProcessLumaDc :255, h264bsdProcessChromaDc :359) and the residual
orchestration in ProcessResidual (h264bsd_macroblock_layer.c:1340-1421).

Only the non-empty blocks the front-end shipped are dequantized and
butterflied; they are scattered into per-MB residual planes and the
externally transformed DC terms are added densely before the single
(x + 32) >> 6 rounding. Right shifts are arithmetic, as in the C.

This module is the plain PyTorch version of the residual stage; the
wrapper that launches its CUDA kernel (K9's body) on the card is
ops/cuda_transform.py. residual_transform is the dense counterpart (the
JAX package's ops/transform.py:137, on the front-end's dense per-MB
coefficients), which the row-sharded stripe step runs through K9,
ops/cuda_transform.residual_transform_cuda.
"""

from __future__ import annotations

import numpy as np
import torch

from .consts import const
from .unpack import scatter_present, scatter_unique

# level scale table, spec 8.5.9 (reference transform.c:58-59)
LEVEL_SCALE = np.array(
    [[10, 13, 16], [11, 14, 18], [13, 16, 20],
     [14, 18, 23], [16, 20, 25], [18, 23, 29]], np.int32)

# dequant scale column by raster position within the 4x4 block
# (reference transform.c:120-155 tmp1/tmp2/tmp3 assignment pattern)
SCALE_IDX = np.array([0, 1, 0, 1, 1, 2, 1, 2, 0, 1, 0, 1, 1, 2, 1, 2],
                     np.int32)

# chroma QP mapping, spec Table 8-15 (reference h264bsd_util.c:53)
QP_C = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30,
                 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
                 38, 39, 39, 39, 39], np.int32)

# levelScale[qp%6][SCALE_IDX] pre-expanded per raster position
LEVEL_SCALE_POS = LEVEL_SCALE[:, SCALE_IDX]             # (6, 16)
# levelScale[qp%6][0], the DC transforms' multiplier
LEVEL_SCALE_DC = LEVEL_SCALE[:, 0]

_TABLES = {"LEVEL_SCALE_POS": LEVEL_SCALE_POS,
           "LEVEL_SCALE_DC": LEVEL_SCALE_DC, "QP_C": QP_C}


def table(name: str, device) -> torch.Tensor:
    """The constant table `name` as an int64 tensor on `device`, cached
    (index tensors and table values share one dtype, so lookups need no
    casts)."""
    return const(name, _TABLES[name], device, torch.int64)


def chroma_qp(qp_y, chroma_qp_offset):
    """QP_C[clip(qp_y + offset, 0, 51)] for (nMB,) integer tensors."""
    idx = (qp_y.long() + chroma_qp_offset.long()).clamp(0, 51)
    return table("QP_C", qp_y.device)[idx]


def dequant_scales(qp):
    """Per-raster-position dequant multipliers for a (N,) qp vector ->
    (N, 16) int64 (levelScale[qp%6][SCALE_IDX] << qp//6)."""
    qp = qp.long()
    per_pos = table("LEVEL_SCALE_POS", qp.device)[qp % 6]
    return per_pos << (qp // 6)[:, None]


def _butterfly(d0, d1, d2, d3, half):
    """One 4-point pass; half=True is the IDCT's (x >> 1) odd terms,
    half=False the plain Hadamard of the DC transforms."""
    t0 = d0 + d2
    t1 = d0 - d2
    if half:
        t2 = (d1 >> 1) - d3
        t3 = d1 + (d3 >> 1)
    else:
        t2 = d1 - d3
        t3 = d1 + d3
    return t0 + t3, t1 + t2, t1 - t2, t0 - t3


def idct_butterflies(d):
    """The LINEAR part of the H.264 integer inverse transform on
    raster-ordered (..., 16) blocks, WITHOUT the final (x+32)>>6 rounding
    (reference transform.c:157-186). A DC-only input spreads to a
    constant block, so callers add an externally transformed DC after
    the butterflies and round once (residual_planes_sparse)."""
    d = d.reshape(d.shape[:-1] + (4, 4))
    d = torch.stack(_butterfly(d[..., 0], d[..., 1], d[..., 2], d[..., 3],
                               True), dim=-1)
    d = torch.stack(_butterfly(d[..., 0, :], d[..., 1, :], d[..., 2, :],
                               d[..., 3, :], True), dim=-2)
    return d.reshape(d.shape[:-2] + (16,))


def idct_blocks_plain(coeff, scales, ext_dc, skip_dc):
    """The plain PyTorch version of K9 (the JAX package's _idct_kernel,
    ops/pallas_transform.py:25): (N, 16) raster levels times (N, 16)
    dequant scales, position 0 replaced by ext_dc where skip_dc is
    non-zero, the 4x4 integer IDCT and (x + 32) >> 6. int32 throughout,
    as on the TPU. Returns (N, 16) int32."""
    d = coeff.to(torch.int32) * scales.to(torch.int32)
    d0 = torch.where(skip_dc != 0, ext_dc.to(torch.int32), d[:, 0])
    d = torch.cat([d0[:, None], d[:, 1:]], dim=1)
    return (idct_butterflies(d) + 32) >> 6


def luma_dc_transform(dc, qp):
    """4x4 Hadamard + scaling of the Intra_16x16 luma DC block
    (reference h264bsdProcessLumaDc transform.c:255-338). dc is
    raster-ordered (nMB, 16); qp is (nMB,)."""
    d = dc.long().reshape(-1, 4, 4)
    d = torch.stack(_butterfly(d[..., 0], d[..., 1], d[..., 2], d[..., 3],
                               False), dim=-1)
    d = torch.stack(_butterfly(d[..., 0, :], d[..., 1, :], d[..., 2, :],
                               d[..., 3, :], False), dim=-2)
    d = d.reshape(-1, 16)
    qp = qp.long()
    lev = table("LEVEL_SCALE_DC", qp.device)[qp % 6]
    qp_div = qp // 6
    hi = d * (lev << (qp_div - 2).clamp(min=0))[:, None]
    rnd = torch.where(qp_div == 1, 1, 2)
    lo = (d * lev[:, None] + rnd[:, None]) >> (2 - qp_div).clamp(min=0)[:, None]
    return torch.where((qp >= 12)[:, None], hi, lo)


def chroma_dc_transform(cdc, chroma_qp_):
    """2x2 transform + scaling of both chroma DC blocks
    (reference h264bsdProcessChromaDc transform.c:359-401). cdc is
    (nMB, 8) = cb[4] + cr[4]; chroma_qp_ is (nMB,)."""
    d = cdc.long().reshape(-1, 2, 4)
    t0 = d[..., 0] + d[..., 2]
    t1 = d[..., 0] - d[..., 2]
    t2 = d[..., 1] - d[..., 3]
    t3 = d[..., 1] + d[..., 3]
    out = torch.stack([t0 + t3, t0 - t3, t1 + t2, t1 - t2], dim=-1)
    out = out.reshape(-1, 8)
    q = chroma_qp_.long()
    lev = table("LEVEL_SCALE_DC", q.device)[q % 6]
    qp_div = q // 6
    hi = out * (lev << (qp_div - 1).clamp(min=0))[:, None]
    lo = out * lev[:, None] >> 1
    return torch.where((q >= 6)[:, None], hi, lo)


def mb_residual_planes(residual):
    """Scatter (nMB, 24, 16) block residuals into per-MB pixel layouts:
    luma (nMB, 16, 16) and chroma (nMB, 2, 8, 8)."""
    n_mb = residual.shape[0]
    luma = residual[:, :16].reshape(n_mb, 4, 4, 4, 4)      # (by, bx, y, x)
    luma = luma.permute(0, 1, 3, 2, 4).reshape(n_mb, 16, 16)
    chroma = residual[:, 16:].reshape(n_mb, 2, 2, 2, 4, 4)  # (pl, by, bx, y, x)
    chroma = chroma.permute(0, 1, 2, 4, 3, 5).reshape(n_mb, 2, 8, 8)
    return luma, chroma


def residual_dc(sparse_ids, sparse_levels, qp_y, chroma_qp_offset, nnz_dc,
                is_i16, n_mb):
    """The externally transformed DC term of every 4x4 block, from the
    sparse luma-DC (b = 24) and chroma-DC (b = 25) entries: (nMB, 24)
    int64, luma blocks 0-15 in raster order (Intra_16x16 MBs only, 0
    elsewhere) then cb 0-3 and cr 0-3; and the chroma QP per MB. The
    front-end ships a DC block untransformed when its MB's nnz_dc bit is
    clear (a single DC pass-through, the reference's ProcessLumaDc /
    ProcessChromaDc skip)."""
    dev = sparse_ids.device
    sparse_ids = sparse_ids.long()
    cqp = chroma_qp(qp_y, chroma_qp_offset)
    valid = sparse_ids < n_mb * 26
    ids = sparse_ids.clamp(max=n_mb * 26 - 1)
    mb = ids // 26
    b = ids % 26

    # dense DC arrays from the sparse DC entries: ONE scatter over the
    # stacked [luma DC | chroma DC] domain, other entries to spare rows
    dc_id = torch.where(valid & (b == 24), mb,
                        torch.where(valid & (b == 25), n_mb + mb, 2 * n_mb))
    dc_buf = scatter_unique(torch.zeros((2 * n_mb, 16), dtype=torch.int64,
                                        device=dev), dc_id,
                            sparse_levels.long(), 2 * n_mb)
    ldc_raw = dc_buf[:n_mb]
    cdc_raw = dc_buf[n_mb:, :8]

    nnz_dc = nnz_dc.long()
    ldc = torch.where((nnz_dc[:, 0] > 0)[:, None],
                      luma_dc_transform(ldc_raw, qp_y), ldc_raw)
    has_cdc = (nnz_dc[:, 1] > 0) | (nnz_dc[:, 2] > 0)
    cdc = torch.where(has_cdc[:, None],
                      chroma_dc_transform(cdc_raw, cqp), cdc_raw)
    dc_l = torch.where(is_i16[:, None], ldc, 0)
    return torch.cat([dc_l, cdc], dim=1), cqp


def residual_planes_sparse(sparse_ids, sparse_levels, qp_y,
                           chroma_qp_offset, nnz_dc, is_i16, n_mb):
    """Sparse-domain ProcessResidual: dequant+IDCT only the shipped
    blocks, then scatter pixel-domain residuals. The plain PyTorch version
    of the residual kernel (ops/cuda_transform.py).

    sparse_ids: (cap,) block ids (mb*26 + b, b 0..23 AC / 24 luma DC /
    25 chroma DC; padding >= nMB*26); sparse_levels: (cap, 16).
    Returns (res_l (nMB,16,16), res_c (nMB,2,8,8)) int32.

    A block carrying only an (externally transformed) DC has the closed
    form residual (dc + 32) >> 6 over the block (the reference's DC-only
    fast path, transform.c:191-229), so absent blocks of Intra_16x16 MBs
    and chroma blocks get their DC term densely; shipped AC entries add
    their butterflies on top.
    """
    dc, cqp = residual_dc(sparse_ids, sparse_levels, qp_y, chroma_qp_offset,
                          nnz_dc, is_i16, n_mb)
    sparse_ids = sparse_ids.long()
    valid = sparse_ids < n_mb * 26
    ids = sparse_ids.clamp(max=n_mb * 26 - 1)
    mb = ids // 26
    b = ids % 26

    # per-entry dequant + linear butterflies (DC and padding entries
    # compute garbage and are dropped by the scatter id below)
    qp_e = torch.where(b < 16, qp_y.long()[mb], cqp[mb])
    bf_e = idct_butterflies(sparse_levels.long() * dequant_scales(qp_e))
    scatter_id = torch.where(valid & (b < 24), mb * 24 + b, n_mb * 24)
    buf, _ = scatter_present(scatter_id, bf_e, n_mb * 24)
    residual = ((buf.reshape(n_mb, 24, 16) + dc[:, :, None] + 32) >> 6)
    res_l, res_c = mb_residual_planes(residual.to(torch.int32))
    return res_l.contiguous(), res_c.contiguous()


def residual_blocks(coeff, luma_dc, chroma_dc, qp_y, chroma_qp_offset, nnz,
                    nnz_dc, is_i16):
    """The dense residual transform's input to K9 (the JAX package's
    residual_transform, ops/transform.py:137-189, up to its IDCT) and its
    empty-block mask: (nMB*24, 16) levels and dequant scales, (nMB*24,)
    external DC and skip flags, (nMB, 24) bool. A block takes the
    externally transformed DC at position 0 on a luma block of an
    Intra_16x16 MB and on every chroma block."""
    n_mb = coeff.shape[0]
    cqp = chroma_qp(qp_y, chroma_qp_offset)
    nnz_dc = nnz_dc.long()
    ldc = torch.where((nnz_dc[:, 0] > 0)[:, None],
                      luma_dc_transform(luma_dc, qp_y), luma_dc.long())
    has_cdc = (nnz_dc[:, 1] > 0) | (nnz_dc[:, 2] > 0)
    cdc = torch.where(has_cdc[:, None], chroma_dc_transform(chroma_dc, cqp),
                      chroma_dc.long())
    is_i16 = is_i16.bool()
    scales = torch.cat([
        dequant_scales(qp_y)[:, None].expand(-1, 16, -1),
        dequant_scales(cqp)[:, None].expand(-1, 8, -1)], dim=1)
    ext_dc = torch.cat([torch.where(is_i16[:, None], ldc, 0), cdc], dim=1)
    skip = torch.cat([is_i16[:, None].expand(-1, 16),
                      torch.ones((n_mb, 8), dtype=torch.bool,
                                 device=coeff.device)], dim=1)
    nnz = nnz.long()
    luma_empty = torch.where(is_i16[:, None],
                             (ldc == 0) & (nnz[:, :16] == 0),
                             nnz[:, :16] == 0)
    chroma_empty = (cdc == 0) & (nnz[:, 16:] == 0)
    empty = torch.cat([luma_empty, chroma_empty], dim=1)
    return (coeff.to(torch.int32).reshape(-1, 16),
            scales.to(torch.int32).reshape(-1, 16),
            ext_dc.to(torch.int32).reshape(-1),
            skip.to(torch.int32).reshape(-1), empty)


def residual_transform(coeff, luma_dc, chroma_dc, qp_y, chroma_qp_offset,
                       nnz, nnz_dc, is_i16):
    """Full-frame residual processing on the dense per-MB coefficients
    (the JAX package's residual_transform, ops/transform.py:137).

    coeff (nMB, 24, 16) raw raster levels, blocks 0-15 luma, 16-19 cb,
    20-23 cr; luma_dc (nMB, 16) and chroma_dc (nMB, 8) raw DC levels;
    qp_y, chroma_qp_offset (nMB,); nnz (nMB, 24) and nnz_dc (nMB, 3)
    coefficient counts; is_i16 (nMB,) bool. Returns the (nMB, 24, 16)
    int32 residual, 0 on empty blocks, and the (nMB, 24) empty mask. The
    plain version of ops/cuda_transform.residual_transform_cuda."""
    n_mb = coeff.shape[0]
    *blocks, empty = residual_blocks(coeff, luma_dc, chroma_dc, qp_y,
                                     chroma_qp_offset, nnz, nnz_dc, is_i16)
    res = idct_blocks_plain(*blocks).reshape(n_mb, 24, 16)
    return torch.where(empty[:, :, None], 0, res), empty
