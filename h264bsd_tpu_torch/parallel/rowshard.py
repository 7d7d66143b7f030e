"""MB-row sharding of one frame across a mesh axis, with real halo
exchange: the counterpart of the JAX package's parallel/rowshard.py
(_stripe_step :91, _stripe_phases :107, make_row_sharded_step :304,
make_row_sharded_blob_step :329, make_batched_row_sharded_step :400).

Each position of the axis owns a contiguous stripe of MB rows and runs
it on its device (parallel/mesh.py; positions may share one card):

  phase A, every stripe: the residual, then mc_recon (K3-K6 with the
    inter combine and the I_PCM samples) with the stripe's MB-row offset
    into whole reference frames of the position's DPB replica;
  phase B, stripe after stripe: K2 (intra_pass_cuda, every MB of the
    list in raster order) on the stripe extended by one dummy MB row
    whose bottom pel row carries the halo, the bottom luma row and both
    chroma rows of the stripe above after its intra pass;
  phase C, stripe after stripe: boundary strengths and thresholds on the
    stripe's metadata extended by the real bottom MB row of the stripe
    above with deblocking disabled (its own edges get bS 0, the edge
    between the stripes keeps its exact bS and averaged QPs; stripe 0's
    first row gets no top edge, the picture's border), then K1, or K8
    under 3 MBs wide, on the extended stripe whose top rows carry the
    stripe above's filtered bottom 4 luma / 2 chroma rows; the 3 luma /
    1 chroma rows the filter wrote into them go back up to patch the
    stripe above.

Finally every replica's ring slot receives the whole frame (all-gather).
The JAX version runs each pipeline step on every device and lets only
the active stripe compute (lax.cond); the port loops over the stripes and
issues nothing for the others. The stripe phases run eagerly: a CUDA
graph cannot span devices, and the JAX package scopes this axis as a
latency and memory tool, not a throughput one (README.md:454-456,
rowshard.py:37-55): the stripes of a frame run one after another.

The blob step unpacks the frame's compact blob and runs the sparse
residual stage (K9's body) once per device, replicated as in the JAX
version; the dense step transforms each stripe's dense coefficients
with K9 itself (ops/cuda_transform.residual_transform_cuda). The DPB
replicas are an object array of ring planes, one per position
(Mesh.replicate; for the batched step Mesh.shard over the stream axis),
written in place and returned.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.state import as_tensor
from ..ops.cuda_deblock_wf import deblock_frame_wavefront_from_bs
from ..ops.cuda_intra import intra_pass_cuda
from ..ops.cuda_mc import mc_recon_cuda
from ..ops.cuda_transform import (residual_planes_sparse_cuda,
                                  residual_transform_cuda)
from ..ops.deblock import boundary_strengths, edge_thresholds
from ..ops.transform import mb_residual_planes
from ..ops.unpack import blob_words, unpack_blob, unpack_meta, widen_words
from .mesh import all_gather_into, ppermute

# per-MB metadata the deblocking filter needs from the stripe above
_DEBLOCK_FIELDS = ("mb_class", "nnz", "mv", "ref_slot", "slice_id",
                   "disable_dblk", "qp_y", "filter_off_a", "filter_off_b",
                   "chroma_qp_offset")
_INTRA_FIELDS = ("mb_class", "i4_modes", "i4_avail", "mb_avail",
                 "i16_mode", "chroma_mode")


def _ext0(x, width_mbs):
    """Prepend one zeroed MB row to a per-MB tensor."""
    return torch.cat([x.new_zeros((width_mbs,) + tuple(x.shape[1:])), x])


def _extend(planes):
    """The (y, cb, cr) planes of a stripe below one zeroed MB row."""
    return [torch.cat([p.new_zeros((s, p.shape[1])), p])
            for p, s in zip(planes, (16, 8, 8))]


def intra_stripe_args(t, res_l, res_c, planes, halo, width_mbs):
    """K2's arguments (intra_pass_cuda's, width_mbs and stripe_rows + 1
    follow) on a stripe extended by one dummy MB row: t, the stripe's
    per-MB tensors; planes, its (y, cb, cr) after MC. The dummy row's
    class is 0, so the pass never writes it; its bottom pel rows carry
    `halo`, the bottom luma row and chroma rows of the stripe above after
    its intra pass. The top stripe has none (halo None): its dummy row
    stays zero and the availability flags gate off every read of it
    (frame row 0 has no above neighbour)."""
    ext = _extend(planes)
    if halo is not None:
        for plane, row, h in zip(ext, (15, 7, 7), halo):
            plane[row].copy_(h)
    return (*ext, *(_ext0(t[f], width_mbs) for f in _INTRA_FIELDS),
            _ext0(res_l, width_mbs), _ext0(res_c, width_mbs))


def deblock_stripe_args(t, above, planes, halo4, width_mbs, stripe_rows):
    """K1's (or K8's) arguments (deblock_frame_wavefront_from_bs's,
    width_mbs and stripe_rows + 1 follow) on a stripe extended by one MB
    row: t, the stripe's per-MB tensors; above, the _DEBLOCK_FIELDS of
    the real bottom MB row of the stripe above, None for the top stripe;
    planes, the stripe's (y, cb, cr) after its intra pass; halo4, the
    stripe above's filtered bottom 4 luma / 2 chroma rows, None for the
    top stripe. The extended row has deblocking disabled, so its own
    edges get bS 0 and the edge between the stripes keeps its exact bS
    and averaged QPs; the top stripe's first real row gets no top edge,
    the picture's border."""
    top = above is None
    if top:
        above = {f: torch.zeros_like(t[f][:width_mbs])
                 for f in _DEBLOCK_FIELDS}
    above = dict(above, disable_dblk=torch.ones_like(above["disable_dblk"]))
    ext = {f: torch.cat([above[f], t[f]]) for f in _DEBLOCK_FIELDS}
    bs_left, bs_top = boundary_strengths(
        ext["mb_class"], ext["nnz"], ext["mv"], ext["ref_slot"],
        ext["slice_id"], ext["disable_dblk"], width_mbs, stripe_rows + 1)
    if top:
        # the picture's top row (GetMbFilteringFlags deblocking.c:280),
        # though in the extended grid it is row 1
        bs_top[width_mbs:2 * width_mbs, :4] = 0
    thr = [edge_thresholds(ext["qp_y"], ext["slice_id"],
                           ext["filter_off_a"], ext["filter_off_b"],
                           ext["chroma_qp_offset"], width_mbs,
                           stripe_rows + 1, chroma)
           for chroma in (False, True)]
    y_e, cb_e, cr_e = _extend(planes)
    if halo4 is not None:
        y_e[12:16].copy_(halo4[0])
        cb_e[6:8].copy_(halo4[1])
        cr_e[6:8].copy_(halo4[2])
    return (y_e, cb_e, cr_e, bs_left, bs_top, *thr)


def _stripe_rows(mesh, axis, height_mbs):
    n_row = mesh.shape[axis]
    if height_mbs % n_row:
        raise ValueError(f"height_mbs={height_mbs} not divisible by "
                         f"axis {axis!r} size {n_row}")
    return height_mbs // n_row


def _stripe_step(t, dpbs, slot, *, width_mbs, stripe_rows, devices):
    """The dense step on one frame: t, the dense per-MB tensors of the
    whole frame (the front-end's tensors plus pcm_y/pcm_cb/pcm_cr, numpy
    or tensors); stripe k's rows go to devices[k], where K9 transforms
    its dense coefficients (residual_transform_cuda). Then the stripe
    phases."""
    n_stripe = stripe_rows * width_mbs
    ts, res = [], []
    for k, dev in enumerate(devices):
        tk = {f: as_tensor(v[k * n_stripe:(k + 1) * n_stripe], dev)
              for f, v in t.items()}
        r, _ = residual_transform_cuda(
            tk["coeff"], tk["luma_dc"], tk["chroma_dc"], tk["qp_y"],
            tk["chroma_qp_offset"], tk["nnz"], tk["nnz_dc"],
            tk["mb_class"] == 4)
        res.append(tuple(p.contiguous() for p in mb_residual_planes(r)))
        tk["pcm"] = (tk["pcm_y"], tk["pcm_cb"], tk["pcm_cr"])
        ts.append(tk)
    _stripe_phases(ts, res, dpbs, slot, width_mbs=width_mbs,
                   stripe_rows=stripe_rows, devices=devices)


def _stripe_phases(ts, res, dpbs, slot, *, width_mbs, stripe_rows,
                   devices):
    """Phases A (MC and combine), B (intra) and C (deblock) of every
    stripe, then the frame into every replica's ring slot `slot`.

    ts[k]: stripe k's per-MB tensors on devices[k] (with "pcm": the
    stripe's I_PCM grids, or None); res[k]: its residual planes (res_l
    (n, 16, 16), res_c (n, 2, 8, 8) int32); dpbs[k]: the (y, cb, cr) ring
    replica of position k."""
    n_row = len(devices)

    # ---- phase A: MC + combine, each stripe from whole reference frames
    planes = []
    for k, (t, (res_l, res_c), dpb) in enumerate(zip(ts, res, dpbs)):
        planes.append(mc_recon_cuda(
            *dpb, t["mv"], t["ref_slot"], t["mb_class"], res_l, res_c,
            t["pcm"], width_mbs, stripe_rows,
            mb_row_offset=k * stripe_rows))

    # ---- phase B: the intra pipeline
    halo = None
    for k, (t, (res_l, res_c)) in enumerate(zip(ts, res)):
        y_e, cb_e, cr_e = intra_pass_cuda(
            *intra_stripe_args(t, res_l, res_c, planes[k], halo, width_mbs),
            width_mbs, stripe_rows + 1)
        planes[k] = (y_e[16:], cb_e[8:], cr_e[8:])
        if k < n_row - 1:
            halo = tuple(ppermute(p[-1], devices[k + 1])
                         for p in (y_e, cb_e, cr_e))

    # ---- phase C: the deblocking pipeline
    halo4 = None
    for k, (t, dev) in enumerate(zip(ts, devices)):
        above = None if k == 0 else {
            f: ppermute(ts[k - 1][f][-width_mbs:], dev)
            for f in _DEBLOCK_FIELDS}
        y_e, cb_e, cr_e = deblock_frame_wavefront_from_bs(
            *deblock_stripe_args(t, above, planes[k], halo4, width_mbs,
                                 stripe_rows),
            width_mbs, stripe_rows + 1)
        if k > 0:
            # the rows the boundary filter wrote into the halo: stripe
            # k-1's bottom 3 luma / 1 chroma rows
            up = devices[k - 1]
            for plane, new in zip(planes[k - 1], (y_e[13:16], cb_e[7:8],
                                                  cr_e[7:8])):
                plane[-new.shape[0]:].copy_(ppermute(new, up))
        planes[k] = (y_e[16:], cb_e[8:], cr_e[8:])
        if k < n_row - 1:
            halo4 = tuple(ppermute(p, devices[k + 1]) for p in
                          (y_e[-4:], cb_e[-2:], cr_e[-2:]))

    # ---- DPB hand-off: the frame from its stripes into every replica
    for c in range(3):
        all_gather_into([p[c] for p in planes],
                        [dpb[c][slot] for dpb in dpbs])


def _replicas(dpb_y, dpb_cb, dpb_cr):
    return [(y, cb, cr) for y, cb, cr in zip(dpb_y, dpb_cb, dpb_cr)]


def make_row_sharded_step(mesh, axis, width_mbs, height_mbs):
    """The row-sharded frame step on the dense per-MB tensors.

    Returns fn(tensors, dpb_y, dpb_cb, dpb_cr, slot) -> the DPB replicas,
    written in place. `tensors` is the dense per-MB dict (the front-end's
    FrontendDecoder.tensors plus pcm_y/pcm_cb/pcm_cr, numpy or tensors);
    dpb_*: one ring plane per position of `axis` (Mesh.replicate); slot:
    the frame's ring slot. height_mbs must be divisible by the axis
    size."""
    stripe_rows = _stripe_rows(mesh, axis, height_mbs)
    devices = mesh.axis_devices(axis)

    def step(tensors, dpb_y, dpb_cb, dpb_cr, slot):
        _stripe_step(tensors, _replicas(dpb_y, dpb_cb, dpb_cr), int(slot),
                     width_mbs=width_mbs, stripe_rows=stripe_rows,
                     devices=devices)
        return dpb_y, dpb_cb, dpb_cr

    return step


def make_row_sharded_blob_step(mesh, axis, width_mbs, height_mbs, caps):
    """The row-sharded frame step on the main path's transfer format: the
    frame's compact blob (Decoder._prepare's "blob", uint8 numpy or
    tensor, with section caps `caps`), unpacked with the sparse residual
    stage on every device, then the stripe phases.

    Returns fn(blob, pcm_y, pcm_cb, pcm_cr, dpb_y, dpb_cb, dpb_cr, slot,
    used_slots=None) -> the DPB replicas, written in place (pcm_*: the
    frame's (nMB, ...) I_PCM grids, or None without I_PCM MBs; dpb_*: one
    ring plane per position, Mesh.replicate). used_slots keeps the JAX
    signature: mc_recon reads every reference slot of the ring in place
    and needs no list of them. height_mbs must be divisible by the axis
    size."""
    stripe_rows = _stripe_rows(mesh, axis, height_mbs)
    devices = mesh.axis_devices(axis)
    n_mbs = width_mbs * height_mbs
    n_stripe = stripe_rows * width_mbs

    def unpack(blob, pcm, dev):
        if isinstance(blob, np.ndarray):
            words = blob_words(blob, dev)
        else:
            words = widen_words(blob.to(dev).view(torch.int32))
        (packed, stab, sp_ids, sp_lv, eids, epay, imbs, ipay,
         sids) = unpack_blob(words, n_mbs, *caps)
        t = unpack_meta(packed, stab, eids, epay, imbs, ipay, n_mbs, sids,
                        sparse_ids=sp_ids)
        res = residual_planes_sparse_cuda(
            sp_ids.reshape(-1), sp_lv, t["qp_y"], t["chroma_qp_offset"],
            t["nnz_dc"], t["mb_class"] == 4, n_mbs)
        pcm = None if pcm[0] is None else tuple(as_tensor(p, dev)
                                                for p in pcm)
        return t, res, pcm

    def step(blob, pcm_y, pcm_cb, pcm_cr, dpb_y, dpb_cb, dpb_cr, slot,
             used_slots=None):
        # the replicated unpack and residual stage, once per device
        full = {}
        ts, res = [], []
        for k, dev in enumerate(devices):
            if dev not in full:
                full[dev] = unpack(blob, (pcm_y, pcm_cb, pcm_cr), dev)
            t, (res_l, res_c), pcm = full[dev]
            rows = slice(k * n_stripe, (k + 1) * n_stripe)
            tk = {f: v[rows] for f, v in t.items()}
            tk["pcm"] = None if pcm is None else tuple(p[rows] for p in pcm)
            ts.append(tk)
            res.append((res_l[rows], res_c[rows]))
        _stripe_phases(ts, res, _replicas(dpb_y, dpb_cb, dpb_cr), int(slot),
                       width_mbs=width_mbs, stripe_rows=stripe_rows,
                       devices=devices)
        return dpb_y, dpb_cb, dpb_cr

    return step


def make_batched_row_sharded_step(mesh, stream_axis, row_axis, width_mbs,
                                  height_mbs):
    """2D variant: a batch of independent streams sharded over
    `stream_axis`, each frame's MB rows over `row_axis` with the stripe
    pipelines of make_row_sharded_step. The mesh's axes are
    (stream_axis, row_axis).

    fn(tensors, dpb_y, dpb_cb, dpb_cr, slots): tensors (B, nMB, ...);
    dpb_*[s][r] the (B / streams, nSlots, ...) ring planes of stream
    block s on position (s, r) (Mesh.shard over stream_axis); slots (B,).
    B must be divisible by the stream axis, height_mbs by the row axis.
    Returns the rings, written in place."""
    if mesh.axis_names != (stream_axis, row_axis):
        raise ValueError(f"expected a mesh of axes ({stream_axis!r}, "
                         f"{row_axis!r}), got {mesh.axis_names}")
    stripe_rows = _stripe_rows(mesh, row_axis, height_mbs)
    n_stream = mesh.shape[stream_axis]

    def step(tensors, dpb_y, dpb_cb, dpb_cr, slots):
        n_batch = len(slots)
        if n_batch % n_stream:
            raise ValueError(f"{n_batch} streams not divisible by axis "
                             f"{stream_axis!r} size {n_stream}")
        per = n_batch // n_stream
        for s in range(n_stream):
            devices = list(mesh.devices[s])
            for j in range(per):
                b = s * per + j
                _stripe_step(
                    {f: v[b] for f, v in tensors.items()},
                    [(y[j], cb[j], cr[j]) for y, cb, cr in
                     zip(dpb_y[s], dpb_cb[s], dpb_cr[s])],
                    int(slots[b]), width_mbs=width_mbs,
                    stripe_rows=stripe_rows, devices=devices)
        return dpb_y, dpb_cb, dpb_cr

    return step
