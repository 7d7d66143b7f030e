"""Device resolution for the port's entry points.

Every entry point takes `device=`. With None it runs on the card and
raises when there is none: the CPU is used only when the caller asks for
it (device="cpu"), as the CPU tests do. On a CPU tensor each kernel
wrapper runs its plain PyTorch version; on a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
