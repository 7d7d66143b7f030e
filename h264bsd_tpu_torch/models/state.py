"""State the decoder carries from frame to frame, and its conversion from
the JAX package's numpy arrays.

The decoder has no weights. What it carries is the DPB ring: one uint8
(slots, H, W) tensor per plane on the device, written in place, one
picture per slot. Per-frame tensors (the unpacked MB metadata) live only
inside one frame's step.
"""

from __future__ import annotations

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy array as a port tensor on `device`. uint8, int8, int16,
    int32, int64 and bool keep their type; uint16 widens to int32 and
    uint32 to int64 (masked to 32 bits), types torch does not compute
    in."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64)).to(device) & _U32
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def as_tensor(x, device) -> torch.Tensor:
    """A numpy array (tensor_from_numpy) or a tensor on `device`; a
    tensor already there is returned as it is."""
    if isinstance(x, np.ndarray):
        return tensor_from_numpy(x, device)
    return x.to(device)


def from_numpy(arrays: dict, device) -> dict:
    """Each numpy array of `arrays` as a port tensor on `device` (see
    tensor_from_numpy); other values pass through."""
    return {k: tensor_from_numpy(v, device) if isinstance(v, np.ndarray)
            else v for k, v in arrays.items()}


def new_ring(n_slots, height_mbs, width_mbs, device):
    """Zeroed DPB ring planes (y, cb, cr): (n_slots, 16h, 16w) and
    (n_slots, 8h, 8w) uint8."""
    h, w = 16 * height_mbs, 16 * width_mbs
    return (torch.zeros((n_slots, h, w), dtype=torch.uint8, device=device),
            torch.zeros((n_slots, h // 2, w // 2), dtype=torch.uint8,
                        device=device),
            torch.zeros((n_slots, h // 2, w // 2), dtype=torch.uint8,
                        device=device))
