"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA device. Raises when
    CUDA is absent and no device was named, so nothing falls back to the
    CPU unless the caller asked for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_f32(x, device=None) -> torch.Tensor:
    """A float32 tensor of ``x``. A tensor keeps its device unless
    ``device`` names another; anything else goes to ``resolve_device``."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
        return x if device is None else x.to(device)
    return torch.as_tensor(x, dtype=torch.float32,
                           device=resolve_device(device))
