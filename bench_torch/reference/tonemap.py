"""Resolve + tonemap of the plain reference (the port's plain blit,
``tpurt_torch/tonemap.py``, same op order)."""

from __future__ import annotations

import torch

LUMA = (0.2126, 0.7152, 0.0722)


def resolve(rgb_sum, n_samples):
    """Per-pixel average rgb_sum / max(n, 1)."""
    return rgb_sum / torch.clamp_min(n_samples, 1.0)[..., None]


def tonemap(avg, key=0.8, saturation=1.0):
    """c = avg*key, c/(1+c), then a saturation lerp around Rec.709 luma."""
    c = avg * key
    c = c / (1.0 + c)
    lum = (c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1]
           + c[..., 2] * LUMA[2])[..., None]
    return lum + saturation * (c - lum)
