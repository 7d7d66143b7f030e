"""A device mesh for the multi-device decoders (parallel/gop.py,
framepipe.py, rowshard.py, multistream.py): the port's stand-in for the
JAX package's jax.sharding.Mesh and the collectives the decoders use.

Mesh(devices, axis_names) lays torch devices out on named axes, as JAX's
Mesh does: devices is a nested list (or an object array) of torch
devices or device strings, one nesting level per axis name, and may
repeat one device, e.g. Mesh(["cuda:0"] * 4, ("row",)) or
Mesh([["cpu"] * 2] * 2, ("stream", "row")). mesh.shape[axis] is an
axis's size and mesh.devices the object array of devices. On one card a
repeated device runs every stripe, halo, hand-off and replica path of
the decoders; a machine with several cards runs the same code on them.

The port is single-process, as the JAX package is single-controller: one
host front-end and one DPB bookkeeping drive the whole axis
(h264bsd_tpu/parallel/framepipe.py:10-15), so there is no
torch.distributed process group. The collectives are tensor copies
between devices (Tensor.copy_, peer to peer between two cards):

- ppermute: a value of one position goes to another position's device
  (lax.ppermute down or up an axis: the row-sharded halos and patches);
- broadcast_into: the owner's value into every replica (framepipe's
  masked psum, which the owner alone feeds);
- all_gather_into: stripes along rows into every replica (lax.all_gather,
  tiled).

Ordering: every kernel and copy runs on its device's current CUDA
stream. A copy between two cards (copy_) makes the destination's current
stream wait on the source's, and the source's on the copy's end, so the
consumer of a hand-off waits on its producer on the device, not on the
host; a copy within one device is an ordinary copy on its stream.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_devices(devices) -> np.ndarray:
    """Nested lists or an array of devices -> an object array of
    torch.device."""
    arr = np.asarray(devices, dtype=object)
    out = np.empty(arr.shape, dtype=object)
    for idx in np.ndindex(arr.shape):
        out[idx] = torch.device(arr[idx])
    return out


class Mesh:
    """torch devices on named axes (see the module docstring)."""

    def __init__(self, devices, axis_names):
        self.devices = _as_devices(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices of a one-axis mesh, in axis order."""
        if self.axis_names != (axis,):
            raise ValueError(f"expected a mesh of the one axis {axis!r}, "
                             f"got axes {self.axis_names}")
        return list(self.devices)

    def replicate(self, x: torch.Tensor) -> np.ndarray:
        """x copied to every position: an object array of the mesh's
        shape (a replicated array, PartitionSpec())."""
        out = np.empty(self.devices.shape, dtype=object)
        for idx in np.ndindex(out.shape):
            out[idx] = x.to(self.devices[idx], copy=True)
        return out

    def shard(self, x: torch.Tensor, axis: str) -> np.ndarray:
        """x split along its first dimension into mesh.shape[axis] equal
        blocks, block i on the positions whose index along `axis` is i,
        replicated along the other axes (PartitionSpec(axis)): an object
        array of the mesh's shape."""
        k = self.axis_names.index(axis)
        n = self.devices.shape[k]
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} not divisible by axis {axis!r} "
                             f"size {n}")
        blocks = x.chunk(n)
        out = np.empty(self.devices.shape, dtype=object)
        for idx in np.ndindex(out.shape):
            out[idx] = blocks[idx[k]].to(self.devices[idx], copy=True)
        return out


def ppermute(x: torch.Tensor, device) -> torch.Tensor:
    """x as the position on `device` receives it from lax.ppermute: the
    tensor itself on its own device, else a copy (do not write to it)."""
    return x.to(device, non_blocking=True)


def broadcast_into(src: torch.Tensor, dsts) -> None:
    """The owner's src into every replica dst (in place) but its own."""
    for dst in dsts:
        if dst.data_ptr() != src.data_ptr() or dst.device != src.device:
            dst.copy_(src, non_blocking=True)


def all_gather_into(parts, dsts) -> None:
    """The stripes `parts` (one per position along an axis, in order),
    concatenated along their first dimension, into every dst (in
    place)."""
    for dst in dsts:
        at = 0
        for part in parts:
            dst[at:at + part.shape[0]].copy_(part, non_blocking=True)
            at += part.shape[0]
