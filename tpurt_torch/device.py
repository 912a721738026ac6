"""The port's default device: the CUDA card, never a silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means the CUDA card. Raises
    when there is no CUDA device and none was asked for: the CPU runs only
    when the caller passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpurt_torch runs on the CUDA device by default and found none: "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")
