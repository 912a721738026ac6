"""Edge-aware denoising (``tpurt.denoise``): first-hit AOVs and an
à-trous wavelet filter over linear radiance.

``render_aovs`` shoots one unjittered center ray per pixel through the
ray-query intersector (``query.trace_rays``): albedo (1 on a miss), normal
and depth planes. ``atrous_denoise`` runs ``iterations`` passes of a
dilated 5x5 B3-spline filter whose 25 taps are weighted by color, normal
and depth edge-stopping terms (Dammertz et al. 2010), on radiance
demodulated by the albedo. ``denoise_image`` is ``render.resolve_image``
with the filter between the resolve and the tonemap.

Plain PyTorch on the image's device: tpurt computes the filter in jnp
outside any Pallas kernel (25 shifted multiply-adds a pass). The op order
is tpurt's: channel sums as (r + g) + b, ``_box5``'s shifted slices summed
in order and divided by 5 twice, the median as jnp.median's midpoint
(the mean of the two middle values at an even count, where torch.median
returns the lower one), divisions by a scalar through ``ops.fdiv``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpurt_torch import tonemap as tm
from tpurt_torch.camera import base_camera, generate_rays
from tpurt_torch.config import RenderConfig
from tpurt_torch.ops import fdiv, fsqrt


class AOVs(NamedTuple):
    """First-hit feature planes."""
    albedo: torch.Tensor   # (H, W, 3) material color at the first hit; 1 on a miss
    normal: torch.Tensor   # (H, W, 3) geometric normal at the first hit; 0 on a miss
    depth: torch.Tensor    # (H, W)    hit distance t; 0 on a miss


def pixel_centers(width: int, height: int, device):
    """(u, v), each (H, W) float32: (x + 0.5) / W and (y + 0.5) / H."""
    x = fdiv(torch.arange(width, dtype=torch.float32, device=device) + 0.5,
             float(width))
    y = fdiv(torch.arange(height, dtype=torch.float32, device=device) + 0.5,
             float(height))
    return torch.meshgrid(x, y, indexing="xy")


def render_aovs(scene, cfg: RenderConfig, camera) -> AOVs:
    """Deterministic feature pass on the scene's device: one center ray
    per pixel (a MotionCamera's shutter-open pose), no random draw."""
    from tpurt_torch.query import trace_rays
    W, H = cfg.width, cfg.height
    u, v = pixel_centers(W, H, scene.device)
    o, d = generate_rays(base_camera(camera), u.reshape(-1), v.reshape(-1))
    hits = trace_rays(scene, torch.stack(o, -1), torch.stack(d, -1), cfg)
    return AOVs(
        albedo=torch.where(hits.hit[:, None], hits.albedo, 1.0).reshape(
            H, W, 3),
        normal=hits.normal.reshape(H, W, 3),
        depth=torch.where(hits.hit, hits.t, 0.0).reshape(H, W))


# 1D B3-spline kernel; the 5x5 filter is its outer product (edge weights
# break separability, so the 25 taps are applied directly)
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def defocus_relax(cfg: RenderConfig, depth, clamp_px: float = 2.0):
    """Per-pixel feature-weight relaxation for depth-of-field renders: the
    thin-lens circle of confusion at each first hit in pixels (a pixel's
    footprint taken as z / width), over ``clamp_px``, in [0, 1]; 0 where
    in focus or missed, and everywhere for a pinhole config."""
    if cfg.aperture <= 0.0:
        return torch.zeros_like(depth)
    z = depth.clamp_min(1e-3)
    coc_world = (0.5 * cfg.aperture) * (1.0 - fdiv(z, cfg.focus_dist)).abs()
    px_size = fdiv(z, float(cfg.width))
    coc_px = coc_world / px_size
    relax = fdiv(coc_px, float(clamp_px)).clamp(0.0, 1.0)
    return torch.where(depth > 0, relax, 0.0)


def _sum3(x):
    """The sum over the trailing axis of 3, as (x0 + x1) + x2."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _pad_edge(a, top: int, bottom: int, left: int, right: int):
    """``a`` (H, W, ...) padded by repeating its edge rows and columns."""
    H, W = a.shape[:2]
    dev = a.device
    rows = torch.arange(-top, H + bottom, device=dev).clamp(0, H - 1)
    cols = torch.arange(-left, W + right, device=dev).clamp(0, W - 1)
    return a[rows][:, cols]


def _median(d):
    """jnp.median: the mean of the two middle values, as (lo + hi) * 0.5
    (one value at an odd count); NaN if any value is NaN."""
    s = torch.sort(d.reshape(-1)).values
    n = s.numel()
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(d).any(), float("nan"), med)


def _auto_sigma(img, H: int, W: int):
    """The per-pixel color sigma (``tpurt.denoise.atrous_denoise`` with
    ``sigma_color=None``): 2x the larger of the global median
    neighbour-pair color distance and the least of four diagonal 5x5
    quadrant box means of it, the latter gated by the image's
    noise-to-signal ratio; at least 1e-2."""
    d = fsqrt(_sum3((img[:, 1:] - img[:, :-1]) ** 2))
    d = _pad_edge(d, 0, 0, 0, 1)                       # (H, W)

    def box5(a):
        ap = _pad_edge(a, 2, 2, 2, 2)
        rows = ap[0:H]
        for k in range(1, 5):
            rows = rows + ap[k:k + H]
        rows = fdiv(rows, 5.0)
        out = rows[:, 0:W]
        for k in range(1, 5):
            out = out + rows[:, k:k + W]
        return fdiv(out, 5.0)

    bp = _pad_edge(box5(d), 3, 3, 3, 3)
    quad = torch.minimum(
        torch.minimum(bp[:H, :W], bp[:H, 6:6 + W]),
        torch.minimum(bp[6:6 + H, :W], bp[6:6 + H, 6:6 + W]))
    med = _median(d)
    ratio = med / img.abs().mean().clamp_min(1e-12)
    gate = fdiv(0.15 - ratio, 0.10).clamp(0.0, 1.0)
    return (2.0 * torch.maximum(med, quad * gate)).clamp_min(1e-2)


def atrous_denoise(radiance, albedo, normal, depth, *, iterations: int = 5,
                   sigma_color: float | None = None,
                   sigma_normal: float = 0.35, sigma_depth: float = 0.1,
                   relax=None):
    """Edge-avoiding à-trous filter over (H, W, 3) linear radiance.

    Tap weights relative to the center p, each a Gaussian in a squared
    feature distance: color with sigma_color / 2^i at pass i, normal with
    sigma_normal, depth relative to max(z_p, z_q, 1) with sigma_depth.
    ``sigma_color=None`` estimates a per-pixel sigma from the input
    (``_auto_sigma``). ``relax`` (H, W) in [0, 1] scales the feature terms
    down (``defocus_relax``). Radiance is demodulated by ``albedo`` before
    the filter and remodulated after.
    """
    H, W = depth.shape
    alb = albedo.clamp_min(1e-3)
    img = radiance / alb
    if sigma_color is None:
        sigma_color = _auto_sigma(img, H, W)
    keep = None if relax is None else 1.0 - relax
    s_n2 = float(torch.tensor(sigma_normal ** 2, dtype=torch.float32))

    for i in range(iterations):
        step = 1 << i
        r = 2 * step
        imgp = _pad_edge(img, r, r, r, r)
        np_ = _pad_edge(normal, r, r, r, r)
        zp_ = _pad_edge(depth, r, r, r, r)
        if isinstance(sigma_color, torch.Tensor):
            s_c2 = fdiv(sigma_color, float(1 << i)) ** 2
        else:
            s_c2 = float(torch.tensor((sigma_color / (1 << i)) ** 2,
                                      dtype=torch.float32))
        acc = torch.zeros_like(img)
        wsum = torch.zeros((H, W, 1), dtype=img.dtype, device=img.device)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                oy, ox = r + dy * step, r + dx * step
                c_q = imgp[oy:oy + H, ox:ox + W]
                n_q = np_[oy:oy + H, ox:ox + W]
                z_q = zp_[oy:oy + H, ox:ox + W]
                dc2 = _sum3((img - c_q) ** 2)
                dn2 = _sum3((normal - n_q) ** 2)
                zscale = sigma_depth * torch.maximum(depth, z_q).clamp_min(
                    1.0)
                dz2 = ((depth - z_q) / zscale) ** 2
                feat = fdiv(dn2, s_n2) + dz2
                if keep is not None:
                    feat = feat * keep
                w = (_B3[dy + 2] * _B3[dx + 2]
                     * torch.exp(fdiv(-dc2, s_c2) - feat))[..., None]
                acc = acc + w * c_q
                wsum = wsum + w
        img = acc / wsum.clamp_min(1e-8)
    return img * alb


def denoise_image(scene, cfg: RenderConfig, camera, state, *,
                  iterations: int = 5, sigma_color: float | None = None,
                  sigma_normal: float = 0.35, sigma_depth: float = 0.1,
                  key=None, saturation=None, aovs: AOVs | None = None,
                  tonemap: bool = True, defocus_clamp_px: float = 2.0):
    """``render.resolve_image`` with the filter: resolve the state to
    linear radiance (each pixel over its own count), filter it guided by
    the AOVs (``aovs``, or a fresh ``render_aovs``; with a lens the
    feature terms relaxed by ``defocus_relax``), then tonemap, or return
    the linear image with ``tonemap=False`` (for ``temporal``)."""
    n = cfg.n_pixels
    avg = tm.resolve(state.rgb_sum[:n].contiguous(),
                     state.n_samples[:n]).reshape(cfg.height, cfg.width, 3)
    if aovs is None:
        aovs = render_aovs(scene, cfg, camera)
    relax = (defocus_relax(cfg, aovs.depth, clamp_px=defocus_clamp_px)
             if cfg.aperture > 0.0 else None)
    den = atrous_denoise(avg, aovs.albedo, aovs.normal, aovs.depth,
                         iterations=iterations, sigma_color=sigma_color,
                         sigma_normal=sigma_normal, sigma_depth=sigma_depth,
                         relax=relax)
    if not tonemap:
        return den
    key = cfg.tonemap_key if key is None else key
    saturation = cfg.tonemap_saturation if saturation is None else saturation
    return tm.tonemap(den, key, saturation)
