"""Exact fingerprints of decoded pictures, taken the same way from the
program's pictures on the device (inside the window, as each picture is
handed on) and from the reference's after it.

A picture's digest is, per plane, three weighted sums of its samples
with fixed pseudo-random integer weights below 2**20: float64 products
of integers, exact as every partial sum stays below 2**53 (255 * 2**20
* 2**21 samples), so two equal pictures give equal digests on any device
and in any summation order. Two pictures that differ give equal digests
only if the difference vector is orthogonal to three random weight
vectors in every plane it touches: a one-sample difference never is,
and any other about once in 2**60.
"""

from __future__ import annotations

import numpy as np
import torch

N_SUMS = 3
_WEIGHTS: dict = {}


def weights(n: int, device) -> torch.Tensor:
    """(n, N_SUMS) float64 weights for a plane of n samples."""
    key = (n, str(device))
    if key not in _WEIGHTS:
        rng = np.random.default_rng(271828 + n)
        w = rng.integers(1, 1 << 20, size=(n, N_SUMS)).astype(np.float64)
        _WEIGHTS[key] = torch.as_tensor(w, device=device)
    return _WEIGHTS[key]


def digest(planes) -> torch.Tensor:
    """planes: (y, cb, cr), each (B, H, W) uint8 on one device: the B
    pictures' digests, (B, 3, N_SUMS) float64 on that device."""
    out = []
    for p in planes:
        flat = p.reshape(p.shape[0], -1)
        out.append(flat.double() @ weights(flat.shape[1], p.device))
    return torch.stack(out, 1)
