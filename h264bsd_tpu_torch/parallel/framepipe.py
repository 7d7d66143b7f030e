"""Frame-pipelined decode of GOP-less streams across a mesh axis, the DPB
reference planes handed from device to device: the counterpart of the
JAX package's parallel/framepipe.py (make_framepipe_step :49,
decode_stream_framepipe :92), BASELINE.json config 4.

A GOP-less stream's frames form one reference chain, so frame i goes to
position i % n of the axis (its owner): one host front-end parses every
slice (the DPB bookkeeping is global state), the owner runs the main
path's frame body (models.decoder._frame_decode_body) on its own ring
replica, and the owner's new slot is then copied into every other
replica (the hand-off; the JAX version broadcasts it with a masked psum),
so the next owner predicts from reference pictures it never decoded.
On the card the body runs as a CUDA graph per (position, graph key),
since a graph is bound to the ring it was captured over; frames with
I_PCM samples run the body eagerly on their owner.

A partial loss without a usable reference is evicted from the pipeline,
as in the JAX version: the owner runs the body with the exact spiral
concealment on the host (spiral=, the eager path of the single-stream
decoder) and the repaired slot is copied to every replica.

The chain serializes the frames, so this axis adds no frames per second
on clean streams; its value is the hand-off itself (the JAX package's
own note, framepipe.py:20-25). parallel/gop.py is the throughput axis
for streams with closed GOPs.
"""

from __future__ import annotations

from functools import partial

import torch

from ..frontend import binding as fe
from ..models.decoder import (Decoder, _frame_decode_body,
                              pin_caps_for_stream, spiral_of, stage_rows)
from ..models.graphs import FrameGraph, count
from ..models.state import new_ring
from ..ops.reconstruct import build_pcm_tensors
from .mesh import broadcast_into


def _handoff(dpb_y, dpb_cb, dpb_cr, owner, slot):
    """The owner's ring slot `slot` into every other replica."""
    for replicas in (dpb_y, dpb_cb, dpb_cr):
        broadcast_into(replicas[owner][slot],
                       [r[slot] for r in replicas])


def make_framepipe_step(mesh, axis, width_mbs, height_mbs, caps,
                        wavefront):
    """The one-frame step: the `owner` position decodes the frame on its
    ring replica, then its new slot goes into every other replica.

    Returns fn(blob, dpb_y, dpb_cb, dpb_cr, pcm_y, pcm_cb, pcm_cr, owner,
    slot, cfr, crs, used_slots=None) -> the replicas, written in place:
    blob, the frame's compact blob (uint8 numpy); dpb_*: one ring plane
    per position (Mesh.replicate); pcm_*: the frame's I_PCM grids (numpy
    or tensors), or None without I_PCM MBs; cfr, crs: conceal_from_ref
    and conceal_ref_slot of the picture. used_slots keeps the JAX
    signature (mc_recon reads the ring in place)."""
    devices = mesh.axis_devices(axis)
    args = dict(width_mbs=width_mbs, height_mbs=height_mbs, caps=caps,
                intra_wavefront=wavefront)
    graphs = {}
    pools = {}

    def step(blob, dpb_y, dpb_cb, dpb_cr, pcm_y, pcm_cb, pcm_cr, owner,
             slot, cfr, crs, used_slots=None):
        owner, slot = int(owner), int(slot)
        dev = devices[owner]
        ring = (dpb_y[owner], dpb_cb[owner], dpb_cr[owner])
        row = stage_rows([dict(blob=blob, info=dict(
            slot=slot, conceal_from_ref=bool(cfr),
            conceal_ref_slot=int(crs)))], dev)[0]
        if pcm_y is not None or dev.type == "cpu":
            pcm = None if pcm_y is None else tuple(
                p.to(dev) if isinstance(p, torch.Tensor)
                else torch.from_numpy(p).to(dev)
                for p in (pcm_y, pcm_cb, pcm_cr))
            _frame_decode_body(row, ring, pcm, **args)
            count("eager_frames")
        else:
            # a graph holds the addresses of the ring it was captured over
            key = (owner, ring[0].data_ptr(), ring[0].shape[0], row.shape[0])
            with torch.cuda.device(dev):
                if key in graphs:
                    graphs[key].replay(row)
                else:
                    if dev not in pools:
                        pools[dev] = (torch.cuda.graph_pool_handle(),
                                      torch.cuda.Stream(dev))
                    graphs[key] = FrameGraph(
                        partial(_frame_decode_body, dpb=ring, pcm=None,
                                **args), row, *pools[dev])
        _handoff(dpb_y, dpb_cb, dpb_cr, owner, slot)
        return dpb_y, dpb_cb, dpb_cr

    return step


def decode_stream_framepipe(data: bytes, mesh, axis: str = "pipe",
                            max_pictures: int | None = None):
    """Decode a (typically GOP-less) stream with frames round-robined over
    `mesh`'s `axis`, the DPB replicas kept coherent by the hand-off.
    Yields OutputPicture in display order, byte-identical to the
    single-device decoder; a picture needing the host's exact spiral
    concealment is evicted (see the module docstring)."""
    devices = mesh.axis_devices(axis)
    n_dev = len(devices)
    dec = Decoder(caps_pin=pin_caps_for_stream(data), device=devices[0])
    steps: dict = {}
    dpb = None                  # (y, cb, cr): one ring plane per position
    frame_i = 0
    n_out = 0
    pos = 0
    try:
        while pos < len(data):
            status, read = dec._fe.decode(data, n_out, pos)
            pos += read
            if status == fe.HDRS_RDY:
                dec._geom = dec._fe.stream_info()
                dpb = None
                steps.clear()
            elif status == fe.PIC_RDY:
                prep = dec._prepare()
                info = prep["info"]
                g = prep["geom"]
                if dpb is None:
                    rings = [new_ring(g["dpb_slots"], g["height_mbs"],
                                      g["width_mbs"], d) for d in devices]
                    dpb = tuple(list(p) for p in zip(*rings))
                for s in prep["non_existing"]:
                    for replicas in dpb:
                        for r in replicas:
                            r[s].zero_()
                owner = frame_i % n_dev
                ipcm_mb, ipcm_data = prep["ipcm"]
                pcm = build_pcm_tensors(prep["n_mbs"], ipcm_mb, ipcm_data) \
                    if len(ipcm_mb) else (None, None, None)
                spiral = spiral_of(prep)
                if spiral is not None:
                    # eviction: the exact spiral concealment on the owner,
                    # eagerly, then the repaired slot to every replica
                    dev = devices[owner]
                    _frame_decode_body(
                        stage_rows([prep], dev)[0],
                        tuple(p[owner] for p in dpb),
                        None if pcm[0] is None else tuple(
                            torch.from_numpy(p).to(dev) for p in pcm),
                        width_mbs=prep["w_mbs"], height_mbs=prep["h_mbs"],
                        caps=prep["caps"], intra_wavefront=prep["wavefront"],
                        spiral=spiral)
                    count("eager_frames")
                    _handoff(*dpb, owner, info["slot"])
                else:
                    key = (prep["caps"], prep["wavefront"], prep["w_mbs"],
                           prep["h_mbs"])
                    if key not in steps:
                        steps[key] = make_framepipe_step(
                            mesh, axis, prep["w_mbs"], prep["h_mbs"],
                            prep["caps"], prep["wavefront"])
                    steps[key](prep["blob"], *dpb, *pcm, owner,
                               info["slot"], info["conceal_from_ref"],
                               info["conceal_ref_slot"])
                frame_i += 1
                # every replica holds every picture: read position 0's
                dec._dpb = tuple(p[0] for p in dpb)
                while (o := dec._fe.next_output()) is not None:
                    yield dec._make_output(o, dec._geom)
                    n_out += 1
                    if max_pictures is not None and n_out >= max_pictures:
                        return
            elif status >= fe.ERROR and read == 0:
                return
    finally:
        dec.close()

