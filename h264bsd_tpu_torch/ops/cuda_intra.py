"""Intra list kernel (K2): wrapper, plain version and schedule.

Counterpart of the JAX package's ops/pallas_intra.py (intra_pass_pallas
:379). The kernel is intra_list_kernel in csrc/intra_list.cu, after the
pre-pass intra_list_pos_kernel: one launch, one thread block per list
entry, each taking its entry from a ticket counter and waiting on the
done flags of the neighbours listed before it (csrc/mb_sync.cuh), with
the per-MB device code of csrc/intra_mb.cuh. The result is that of
walking the list (the front-end's list is in raster order) one MB at a
time; list_dependency_levels gives the groups of MBs the flag rule lets
run together. It runs on frames with at most WF_THRESH intra MBs and on
every frame under 3 MBs wide.
"""

from __future__ import annotations

import torch

from . import _kernels
from .intra import i4_weights, intra_pass, intra_pass_list

INT32_MAX = 2 ** 31 - 1

# row, column offsets of the 8 neighbours whose footprints meet an MB's:
# it reads rows y-1..y+15 and columns x-1..x+19 and writes only itself
NEIGHBOURS = ((0, -1), (-1, -1), (-1, 0), (-1, 1),
              (0, 1), (1, -1), (1, 0), (1, 1))


def list_dependency_levels(ids, mb_class, width_mbs, height_mbs):
    """The groups of MBs that K2's flag rule lets run together, in order.

    The listed MBs are the entries 0 <= id < nMB of class 3 or 4 (the
    first entry where an MB repeats); an MB at list position k waits for
    each of its 8 neighbours listed at a position below k, so its level
    is 1 + the largest level among those (0 without one). MBs of one
    level are never neighbours, so their reads and writes are
    independent, and every pair of MBs whose footprints meet keeps its
    list order: walking the groups (ops.intra.intra_walk) gives the
    result of walking the list. The main path never calls this; it is
    the kernel's schedule in code the CPU tests reach."""
    n = width_mbs * height_mbs
    cls = torch.as_tensor(mb_class).reshape(-1).tolist()
    pos = {}
    for k, mb in enumerate(torch.as_tensor(ids).reshape(-1).tolist()):
        if 0 <= mb < n and cls[mb] in (3, 4) and mb not in pos:
            pos[mb] = k
    order = sorted(pos, key=pos.get)
    level = {}
    for mb in order:
        r, c = divmod(mb, width_mbs)
        before = [level[nb] for dr, dc in NEIGHBOURS
                  if 0 <= r + dr < height_mbs and 0 <= c + dc < width_mbs
                  and (nb := (r + dr) * width_mbs + c + dc) in level]
        level[mb] = 1 + max(before, default=-1)
    groups = [[] for _ in range(1 + max(level.values(), default=-1))]
    for mb in order:
        groups[level[mb]].append(mb)
    return groups


def intra_args(y, cb, cr, mb_class, i4_modes, i4_avail, mb_avail, i16_mode,
               chroma_mode, resid_luma, resid_chroma, width_mbs, height_mbs):
    """Checked device pointers of the intra entry points' common
    arguments, in their order (csrc/intra_mb.cuh IntraArgs). Per-MB
    inputs are made int32 and contiguous here (copies where needed)."""
    n = width_mbs * height_mbs
    H, W = 16 * height_mbs, 16 * width_mbs
    u8, i32 = torch.uint8, torch.int32
    # keep the int32 copies alive until the launch has been enqueued; the
    # caching allocator keeps their memory for the stream's pending work
    as32 = [t.to(i32).contiguous() for t in
            (mb_class, i4_modes, i4_avail, mb_avail, i16_mode, chroma_mode,
             resid_luma, resid_chroma)]
    shapes = [(n,), (n, 16), (n, 16), (n,), (n,), (n,), (n, 16, 16),
              (n, 2, 8, 8)]
    names = ["mb_class", "i4_modes", "i4_avail", "mb_avail", "i16_mode",
             "chroma_mode", "resid_luma", "resid_chroma"]
    # the kernels read and write the planes four pels at a time
    ptrs = [_kernels.ptr(y, u8, (H, W), "y", 4),
            _kernels.ptr(cb, u8, (H // 2, W // 2), "cb", 4),
            _kernels.ptr(cr, u8, (H // 2, W // 2), "cr", 4)]
    ptrs += [_kernels.ptr(t, i32, s, name)
             for t, s, name in zip(as32, shapes, names)]
    w = i4_weights(y.device)
    ptrs.append(_kernels.ptr(w, i32, (9, 16, 13), "i4_weights"))
    return ptrs, as32


def intra_pass_cuda(y, cb, cr, mb_class, i4_modes, i4_avail, mb_avail,
                    i16_mode, chroma_mode, resid_luma, resid_chroma,
                    width_mbs, height_mbs, intra_ids=None):
    """Reconstruct the intra MBs (class 3/4) in place (K2) and return the
    uint8 planes. With intra_ids (MB ids in the order to walk them, padded
    with ids outside 0..nMB-1) only those MBs are reconstructed, with the
    result of walking the list; without, every MB in raster order. CPU
    tensors run the plain version. An empty list launches nothing."""
    if y.device.type == "cpu":
        if intra_ids is None:
            return intra_pass(y, cb, cr, mb_class, i4_modes, i4_avail,
                              mb_avail, i16_mode, chroma_mode, resid_luma,
                              resid_chroma, width_mbs)
        return intra_pass_list(y, cb, cr, intra_ids, mb_class, i4_modes,
                               i4_avail, mb_avail, i16_mode, chroma_mode,
                               resid_luma, resid_chroma, width_mbs)
    n = width_mbs * height_mbs
    if intra_ids is None:
        intra_ids = torch.arange(n, device=y.device)
    ids = intra_ids.reshape(-1).to(torch.int32).contiguous()
    if ids.numel() == 0:
        return y, cb, cr
    ptrs, _keep = intra_args(y, cb, cr, mb_class, i4_modes, i4_avail,
                             mb_avail, i16_mode, chroma_mode, resid_luma,
                             resid_chroma, width_mbs, height_mbs)
    # the kernel's scratch: each MB's list position (INT32_MAX: not
    # listed), then its done flag with the ticket counter after them
    pos = torch.full((n,), INT32_MAX, dtype=torch.int32, device=y.device)
    sync = torch.zeros(n + 1, dtype=torch.int32, device=y.device)
    _kernels.launch("h264_intra_list", y.device, *ptrs,
                    _kernels.ptr(ids, torch.int32, ids.shape, "intra_ids"),
                    pos.data_ptr(), sync.data_ptr(), ids.shape[0],
                    width_mbs, height_mbs)
    return y, cb, cr
