"""Constant tables on the device, made once per (table, device) and cached.

A CUDA graph capture cannot copy from pageable host memory, so the frame
body must find every table it reads already on the device. The eager run
that precedes each capture (models/graphs.py) makes them; the capture and
every later frame read them from here.
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def const(name: str, arr, device, dtype=None) -> torch.Tensor:
    """The table `arr` (registered under `name`) as a tensor on `device`,
    of `dtype` (the array's own when None)."""
    key = (name, str(torch.device(device)), dtype)
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.as_tensor(np.asarray(arr), dtype=dtype,
                                          device=device)
    return t
