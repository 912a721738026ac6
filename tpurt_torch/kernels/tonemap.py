"""Wrapper of the blit kernel (``csrc/tonemap.cu``): resolve + tonemap
of the first ``n_pixels`` of a state into a (n, 3) image, and tpurt's two
other routes to its blit (``tpurt/kernels/tonemap_pallas.py``):
``resolve_state_pallas`` (a RenderState, per-pixel sample counts) and
``image_from_planes`` (the (16, P) planes of ``render.state_to_planes``,
a scalar or per-pixel count).

On a CUDA tensor each launches the kernel or raises; on a CPU tensor it
runs the plain version (``tpurt_torch/tonemap.py``). ``LAUNCHES`` counts
kernel launches only, of every route.
"""

from __future__ import annotations

import torch

from tpurt_torch import tonemap as tm
from tpurt_torch.kernels import build

LAUNCHES = 0


def tonemap_pixels(rgb_sum: torch.Tensor, n_samples: torch.Tensor,
                   n_pixels: int, key: float, saturation: float
                   ) -> torch.Tensor:
    """rgb_sum (P, 3) and n_samples (P,) float32 -> (n_pixels, 3)."""
    global LAUNCHES
    if rgb_sum.dtype != torch.float32 or n_samples.dtype != torch.float32:
        raise ValueError("rgb_sum and n_samples must be float32")
    if rgb_sum.dim() != 2 or rgb_sum.shape[1] != 3 or n_samples.dim() != 1 \
            or n_samples.shape[0] != rgb_sum.shape[0] \
            or rgb_sum.shape[0] < n_pixels:
        raise ValueError(f"need rgb_sum (P, 3), n_samples (P,) with P >= "
                         f"{n_pixels}, got {tuple(rgb_sum.shape)}, "
                         f"{tuple(n_samples.shape)}")
    if rgb_sum.device != n_samples.device:
        raise ValueError("rgb_sum and n_samples on different devices")
    if rgb_sum.device.type == "cpu":
        return tm.tonemap(tm.resolve(rgb_sum[:n_pixels], n_samples[:n_pixels]),
                          key, saturation)
    if rgb_sum.device.type != "cuda":
        raise ValueError(f"unsupported device {rgb_sum.device}")
    if not (rgb_sum.is_contiguous() and n_samples.is_contiguous()):
        raise ValueError("rgb_sum and n_samples must be contiguous")
    lib = build.library()
    out = torch.empty((n_pixels, 3), dtype=torch.float32,
                      device=rgb_sum.device)
    stream = torch.cuda.current_stream(rgb_sum.device).cuda_stream
    err = lib.tpurt_tonemap_launch(rgb_sum.data_ptr(), n_samples.data_ptr(),
                                   out.data_ptr(), n_pixels, float(key),
                                   float(saturation), stream)
    build.check_launch(lib, err, "tpurt_tonemap_launch")
    LAUNCHES += 1
    return out


def resolve_state_pallas(cfg, state, key=None, saturation=None
                         ) -> torch.Tensor:
    """(H, W, 3) image of a RenderState through the blit
    (``tonemap_pallas.py:104``): each pixel divided by its own sample
    count, so a wavefront state stopped mid-drain resolves correctly.
    The kernel reads (P, 3) rows: a state left in planes has its rgb_sum
    copied to them first."""
    img = tonemap_pixels(
        state.rgb_sum.contiguous(), state.n_samples, cfg.n_pixels,
        cfg.tonemap_key if key is None else key,
        cfg.tonemap_saturation if saturation is None else saturation)
    return img.reshape(cfg.height, cfg.width, 3)


def image_from_planes(cfg, planes: torch.Tensor, n_samples, key=None,
                      saturation=None) -> torch.Tensor:
    """(H, W, 3) image of (C, P) planes (rows 0-2 the radiance sums, in
    linear pixel order) through the blit (``tonemap_pallas.py:89``).
    ``n_samples`` is a scalar (a uniform count) or (P,) per pixel. The
    port's planes are in linear order, so tpurt's ``planes_pixel_order``
    is the identity here; rows 0-2 are copied to the (P, 3) layout the
    kernel reads."""
    if planes.dim() != 2 or planes.shape[0] < 3:
        raise ValueError(f"need (C >= 3, P) planes, got "
                         f"{tuple(planes.shape)}")
    P = planes.shape[1]
    ns = torch.as_tensor(n_samples, dtype=torch.float32,
                         device=planes.device)
    ns = ns.expand(P) if ns.dim() == 0 else ns.reshape(P)
    img = tonemap_pixels(
        planes[0:3].T.contiguous(), ns.contiguous(), cfg.n_pixels,
        cfg.tonemap_key if key is None else key,
        cfg.tonemap_saturation if saturation is None else saturation)
    return img.reshape(cfg.height, cfg.width, 3)
