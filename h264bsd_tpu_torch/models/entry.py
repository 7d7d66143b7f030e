"""Entry hooks: the single-device frame step on example inputs, and the
multi-device dry run.

Counterpart of the JAX package's models/entry.py.

frame_step: one frame end to end on the front-end's dense per-MB tensors
(ops.reconstruct.reconstruct_frame: K9, mc_recon, K2 or K7; then K1, or
K8 under 3 MBs wide; then the store into the ring slot), eager, on the
ring's device. entry_fn_and_args gives it with a 4x4-MB example.

run_multichip_dryrun(n): the decoder's parallel axes on an n-position
mesh (parallel/mesh.py), each byte-compared with the single-device
result: the batched dense row-sharded step on a ("stream", "row") mesh
against frame_step, the blob row-sharded step against the main path's
frame body, and framepipe against decode_stream.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda_deblock_wf import deblock_frame_wavefront
from ..ops.reconstruct import reconstruct_frame
from .state import from_numpy

TENSOR_SPECS = {
    "mb_class": ((), np.uint8), "qp_y": ((), np.uint8),
    "slice_id": ((), np.uint32), "decoded": ((), np.uint8),
    "disable_dblk": ((), np.uint8), "filter_off_a": ((), np.int8),
    "filter_off_b": ((), np.int8), "chroma_qp_offset": ((), np.int8),
    "i16_mode": ((), np.uint8), "chroma_mode": ((), np.uint8),
    "i4_modes": ((16,), np.uint8), "i4_avail": ((16,), np.uint8),
    "mb_avail": ((), np.uint8), "mv": ((16, 2), np.int16),
    "ref_slot": ((16,), np.int8), "nnz": ((24,), np.uint8),
    "nnz_dc": ((3,), np.uint8), "coeff": ((24, 16), np.int16),
    "luma_dc": ((16,), np.int16), "chroma_dc": ((8,), np.int16),
    "pcm_y": ((16, 16), np.uint8), "pcm_cb": ((8, 8), np.uint8),
    "pcm_cr": ((8, 8), np.uint8),
}


def example_tensors(n_mbs, batch=None, rng=None, device=None):
    """The JAX package's example inputs: every MB P_Skip except MB 0, an
    Intra_16x16 MB, at QP 26 in slice 1, every other field 0; tensors on
    `device` (see device.resolve_device). The values are fixed: the JAX
    version takes an np.random.Generator `rng` and draws nothing from
    it, and this one, which keeps the signature, raises ValueError when
    one is given rather than ignore it."""
    if rng is not None:
        raise ValueError("example_tensors draws no random values: rng "
                         "must be None")
    dev = resolve_device(device)
    pre = (batch,) if batch else ()
    t = {name: np.zeros(pre + (n_mbs,) + shape, dtype)
         for name, (shape, dtype) in TENSOR_SPECS.items()}
    t["mb_class"][:] = 1
    t["mb_class"][..., 0] = 4
    t["qp_y"][:] = 26
    t["slice_id"][:] = 1
    t["decoded"][:] = 1
    return from_numpy(t, dev)


def frame_step(tensors, dpb_y, dpb_cb, dpb_cr, slot, width_mbs, height_mbs):
    """One frame end to end on the ring's device: reconstruct_frame, the
    deblocking filter (K1, or K8 under 3 MBs wide), then the picture into
    ring slot `slot` (an int or a one-element tensor). tensors: the
    front-end's dense per-MB dict plus pcm_*, numpy arrays or tensors.
    Returns the ring planes, written in place."""
    y, cb, cr, t = reconstruct_frame(tensors, dpb_y, dpb_cb, dpb_cr,
                                     width_mbs, height_mbs)
    y, cb, cr = deblock_frame_wavefront(
        y, cb, cr, t["mb_class"], t["nnz"], t["mv"], t["ref_slot"],
        t["slice_id"], t["disable_dblk"], t["qp_y"], t["filter_off_a"],
        t["filter_off_b"], t["chroma_qp_offset"], width_mbs, height_mbs)
    at = torch.as_tensor(slot).reshape(1).to(dpb_y.device, torch.long)
    for ring, plane in zip((dpb_y, dpb_cb, dpb_cr), (y, cb, cr)):
        ring.index_copy_(0, at, plane[None])
    return dpb_y, dpb_cb, dpb_cr


def entry_fn_and_args(device=None):
    """frame_step on a 4x4-MB frame of example_tensors over a 3-slot ring
    of grey (128) pictures, as (fn, args) with fn(*args) the ring after
    the frame."""
    dev = resolve_device(device)
    w_mbs = h_mbs = 4
    h, w = h_mbs * 16, w_mbs * 16
    n_slots = 3
    tensors = example_tensors(w_mbs * h_mbs, device=dev)
    dpb_y = torch.full((n_slots, h, w), 128, dtype=torch.uint8, device=dev)
    dpb_cb = torch.full((n_slots, h // 2, w // 2), 128, dtype=torch.uint8,
                        device=dev)
    dpb_cr = dpb_cb.clone()
    fn = partial(frame_step, width_mbs=w_mbs, height_mbs=h_mbs)
    return fn, (tensors, dpb_y, dpb_cb, dpb_cr,
                torch.zeros((), dtype=torch.int32, device=dev))


def entry_fn_check(device=None):
    """Run entry_fn_and_args' step once, to its end on the device;
    returns the ring."""
    fn, args = entry_fn_and_args(device)
    out = fn(*args)
    if out[0].device.type == "cuda":
        torch.cuda.synchronize(out[0].device)
    return out


def dense_frames(data, frontend=None):
    """Parse `data` with the port's C++ front-end, picture by picture:
    yields (tensors, slot, geometry, released) for each picture, with
    tensors the front-end's dense per-MB dict plus pcm_* (numpy), slot
    its ring slot, geometry the front-end's stream_info and released the
    ring slots of the pictures the front-end gave out for display after
    it, in display order. Decode the picture (frame_step) before reading
    a released slot: it may be this picture's.

    frontend: a FrontendDecoder to parse with (the caller's to close,
    e.g. a Decoder's, whose _prepare then reads the same picture); by
    default a new one, closed at the end."""
    from ..frontend import binding as fe
    from ..ops.reconstruct import build_pcm_tensors

    d = frontend if frontend is not None else fe.FrontendDecoder()
    n_pics = pos = 0
    try:
        while pos < len(data):
            status, read = d.decode(data, n_pics, pos)
            pos += read
            if status == fe.PIC_RDY:
                g = d.stream_info()
                n_mbs = g["width_mbs"] * g["height_mbs"]
                t = d.tensors(n_mbs)
                t["pcm_y"], t["pcm_cb"], t["pcm_cr"] = build_pcm_tensors(
                    n_mbs, *d.ipcm())
                slot = int(d.pic_info()["slot"])
                released = []
                while (o := d.next_output()) is not None:
                    released.append(int(o["slot"]))
                n_pics += 1
                yield t, slot, g, released
            elif status >= fe.ERROR and read == 0:
                break
    finally:
        if frontend is None:
            d.close()


def _real_frame_tensors(w_mbs, h_mbs, n_frames=2):
    """The frames of a crafted stream as the port's C++ front-end parses
    them: [(dense tensor dict with pcm_*, ring slot)], an IDR intra frame
    then P frames whose MC reads the frames before, not synthetic
    zeros."""
    from ..utils.streamgen import make_conformance_stream

    data = make_conformance_stream(width_mbs=w_mbs, height_mbs=h_mbs,
                                   n_frames=n_frames)
    return [(t, slot) for t, slot, _, _ in dense_frames(data)]


def _dryrun_devices(n_devices, devices):
    """The dry run's n_devices devices: the first n_devices of `devices`,
    or with None the CUDA devices, repeated round-robin where the machine
    has fewer (never the CPU: resolve_device raises without a card)."""
    if devices is None:
        resolve_device(None)
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{i % n_cards}" for i in range(n_devices)]
    if len(devices) < n_devices:
        raise ValueError(f"{n_devices} devices asked, {len(devices)} given")
    return [torch.device(d) for d in devices[:n_devices]]


def run_multichip_dryrun(n_devices: int, devices=None) -> None:
    """Run the decoder's parallel axes on an n_devices mesh and assert each
    byte-identical to the single-device result (raises AssertionError):

    1. the batched dense row-sharded step (parallel/rowshard.py) on a
       ("stream", "row") mesh, n/2 x 2 for even n (else n x 1), one
       frame step per frame of a real crafted stream (2 MB rows per
       stripe), every stream replica against frame_step on devices[0];
    2. with 2 or more row positions, the blob row-sharded step on the
       main path's transfer format against the main path's frame body
       (models/decoder.py) on devices[0];
    3. decode_stream_framepipe on all n devices against decode_stream.

    devices: the mesh's devices, by default the CUDA devices round-robin
    (see _dryrun_devices); the list used is printed. The JAX version runs
    phase 2 on its XLA and its Pallas route; the port has one route, the
    kernels on the card and their plain versions on the CPU."""
    from ..parallel.mesh import Mesh
    from ..parallel.rowshard import make_batched_row_sharded_step

    devices = _dryrun_devices(n_devices, devices)
    print(f"run_multichip_dryrun({n_devices}): devices "
          f"{[str(d) for d in devices]}", flush=True)
    mesh_shape = (n_devices // 2, 2) if n_devices % 2 == 0 \
        else (n_devices, 1)
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices
    mesh = Mesh(grid.reshape(mesh_shape), ("stream", "row"))
    n_stream, n_row = mesh_shape

    w_mbs = 4
    h_mbs = 2 * n_row          # 2 MB rows per row-shard
    h, w = h_mbs * 16, w_mbs * 16
    n_slots = 2
    batch = n_stream

    frames = _real_frame_tensors(w_mbs, h_mbs)
    assert len(frames) >= 2, "dryrun stream must parse to >= 2 frames"

    def grey(*shape):
        return torch.full(shape, 128, dtype=torch.uint8)

    dpb = [mesh.shard(grey(batch, n_slots, *hw), "stream")
           for hw in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    # the single-device oracle's ring (one stream's worth)
    ref = tuple(grey(n_slots, *hw).to(devices[0])
                for hw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    step = make_batched_row_sharded_step(mesh, "stream", "row", w_mbs,
                                         h_mbs)
    for t, slot in frames:
        batched = {k: np.stack([v] * batch) for k, v in t.items()}
        step(batched, *dpb, np.full(batch, slot, np.int32))
        frame_step(t, *ref, slot, w_mbs, h_mbs)

    # every stream replica on every row position equals the
    # single-device result exactly
    per = batch // n_stream
    for idx in np.ndindex(*mesh_shape):
        for j in range(per):
            for plane, want in zip(dpb, ref):
                assert torch.equal(plane[idx][j].cpu(), want.cpu()), \
                    "sharded decode diverged from the single-device step"

    if n_row >= 2:
        _blob_step_dryrun(devices[:n_row], w_mbs, h_mbs)
    _framepipe_dryrun(devices)


def _framepipe_dryrun(devices) -> None:
    """decode_stream_framepipe over `devices` against decode_stream on
    devices[0], picture by picture."""
    from ..models.decoder import decode_stream
    from ..parallel.framepipe import decode_stream_framepipe
    from ..parallel.mesh import Mesh
    from ..utils.streamgen import make_ippp_stream

    data = make_ippp_stream(width_mbs=4, height_mbs=4, n_frames=5)
    want = [p.yuv_bytes() for p in decode_stream(data, pipelined=False,
                                                 device=devices[0])]
    got = [p.yuv_bytes() for p in decode_stream_framepipe(
        data, Mesh(devices, ("pipe",)), "pipe")]
    assert len(got) == len(want) == 5, (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"framepipe frame {i} diverged across DPB handoff"


def _blob_step_dryrun(devices, w_mbs, h_mbs) -> None:
    """The blob row-sharded step over `devices` (its "row" axis) against
    the main path's frame body on devices[0], frame by frame, on a
    3-frame crafted stream; compares the rings at the end."""
    from ..models.decoder import (Decoder, _frame_decode_body,
                                  pin_caps_for_stream, stage_rows)
    from ..models.state import new_ring
    from ..ops.reconstruct import build_pcm_tensors
    from ..parallel.mesh import Mesh
    from ..parallel.rowshard import make_row_sharded_blob_step
    from ..utils.streamgen import make_conformance_stream

    row_mesh = Mesh(devices, ("row",))
    data = make_conformance_stream(width_mbs=w_mbs, height_mbs=h_mbs,
                                   n_frames=3)
    dec = Decoder(caps_pin=pin_caps_for_stream(data), device=devices[0])
    single = sharded = None
    steps = {}
    try:
        # the dense tensors go unused: the blob path reads _prepare's blob
        for _ in dense_frames(data, dec._fe):
            prep = dec._prepare()
            if single is None:
                single = new_ring(prep["geom"]["dpb_slots"], h_mbs, w_mbs,
                                  devices[0])
                sharded = tuple(row_mesh.replicate(p) for p in single)
            pcm = (None,) * 3
            if len(prep["ipcm"][0]):
                pcm = tuple(torch.from_numpy(p) for p in
                            build_pcm_tensors(prep["n_mbs"], *prep["ipcm"]))
            _frame_decode_body(
                stage_rows([prep], devices[0])[0], single,
                None if pcm[0] is None else
                tuple(p.to(devices[0]) for p in pcm),
                **Decoder._body_args(prep))
            if prep["caps"] not in steps:
                steps[prep["caps"]] = make_row_sharded_blob_step(
                    row_mesh, "row", w_mbs, h_mbs, prep["caps"])
            steps[prep["caps"]](prep["blob"], *pcm, *sharded,
                                prep["info"]["slot"])
    finally:
        dec.close()
    for replicas, want in zip(sharded, single):
        for got in replicas:
            assert torch.equal(got.cpu(), want.cpu()), \
                "blob-path sharded decode diverged from the main path"
