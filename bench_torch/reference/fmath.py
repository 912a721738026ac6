"""Float helpers of the plain reference, and its working precision.

``F`` is the float type every tensor the reference makes takes: float32,
the precision the configurations state, or bfloat16 for the control
(``precision``). Python float constants follow the tensors they meet.
"""

from __future__ import annotations

import contextlib

import torch

F = torch.float32


@contextlib.contextmanager
def precision(dtype):
    """Run the reference in ``dtype`` inside the block."""
    global F
    old, F = F, dtype
    try:
        yield
    finally:
        F = old


def fdiv(num, den):
    """num / den as one correctly rounded division also when one side is a
    Python scalar: PyTorch computes ``scalar / t`` as ``reciprocal(t) *
    scalar``, and on CUDA ``t / scalar`` as ``t * (1 / scalar)``."""
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(den, num)
    if not isinstance(den, torch.Tensor):
        den = torch.full_like(num, den)
    return num / den


def fsqrt(x):
    """Correctly rounded square root: PyTorch's CPU kernel misses the
    rounding on about 0.7% of float32 inputs, through float64 it does not;
    on CUDA torch.sqrt is IEEE."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)
