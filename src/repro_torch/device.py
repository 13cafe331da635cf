"""Where the port runs: the GPU, unless the caller names the CPU."""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA device.  Raises on a host without one: a caller
    that wants the CPU passes ``device="cpu"`` explicitly, so nothing
    falls back to the CPU silently."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means
    :func:`default_device`.  Every function that makes tensors from host
    values (seeds, numpy arrays) places them through this."""
    return default_device() if device is None else torch.device(device)
