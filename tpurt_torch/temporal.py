"""Temporal reuse for animation (``tpurt.temporal``): reproject the
previous frame's linear image into the current camera and blend.

``reproject`` takes each new pixel's first-hit world point (the AOV depth
along its center ray), projects it into the previous camera and samples
the previous image bilinearly; a sample is valid where the pixel hit
something, lands inside the previous frame, and the previous depth at the
nearest texel agrees with the reprojected distance (the disocclusion
test). ``temporal_blend`` lerps the current image toward the warped
history by ``alpha`` where valid. Biased, for previews and animation.

A world point P with Q = P - o projects to Qp = Q / dot(Q, fn), fn the
unit forward axis normalize(cross(v, h)), and u = (dot(Qp, hn) + |h|/2) /
|h| (v alike); dot(Q, fn) is the ray parameter t of the camera that
rendered the frame.

Plain PyTorch on the image's device: tpurt computes this in jnp outside
any Pallas kernel. The op order is tpurt's: channel sums as (x + y) + z,
the clamp before the floor, truncating int32 casts, round half to even.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpurt_torch.camera import Camera
from tpurt_torch.denoise import AOVs, _sum3, pixel_centers
from tpurt_torch.ops import fsqrt


class TemporalState(NamedTuple):
    """History carried between frames."""
    img: torch.Tensor     # (H, W, 3) linear radiance history
    depth: torch.Tensor   # (H, W) first-hit ray parameter of that frame
    camera: Camera        # the camera that rendered the history


def _vec(x, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.float32)


def _basis(cam: Camera, device):
    """(h, v, |h|, |v|, fn) of ``cam`` on ``device``, fn the unit forward
    axis normalize(cross(v, h))."""
    h, v = _vec(cam.horizontal, device), _vec(cam.vertical, device)
    fwd = torch.stack([v[1] * h[2] - v[2] * h[1],
                       v[2] * h[0] - v[0] * h[2],
                       v[0] * h[1] - v[1] * h[0]])
    fn = fwd / fsqrt(_sum3(fwd * fwd))
    return h, v, fsqrt(_sum3(h * h)), fsqrt(_sum3(v * v)), fn


def reproject(prev: TemporalState, cam_new: Camera, depth_new,
              depth_tol: float = 0.05):
    """Warp the history into the new camera. ``depth_new`` is the new
    frame's AOV depth (H, W). Returns (warped (H, W, 3), valid (H, W)
    bool)."""
    H, W = depth_new.shape
    dev = depth_new.device
    u, v = pixel_centers(W, H, dev)

    # the world point of each new first hit: P = o + t * dir(u, v)
    hN, vN, _, _, _ = _basis(cam_new, dev)
    oN = _vec(cam_new.origin, dev)
    dirN = (_vec(cam_new.lower_left, dev) + u[..., None] * hN
            + v[..., None] * vN - oN)
    P = oN + depth_new[..., None] * dirN

    # projected into the previous camera
    hP, vP, hlen, vlen, fnP = _basis(prev.camera, dev)
    Q = P - _vec(prev.camera.origin, dev)
    t_prev = _sum3(Q * fnP)                     # forward distance
    Qp = Q / t_prev.clamp_min(1e-6)[..., None]
    up = (_sum3(Qp * hP) / hlen + 0.5 * hlen) / hlen
    vp = (_sum3(Qp * vP) / vlen + 0.5 * vlen) / vlen

    # bilinear fetch from the history (the clamp before the floor: a
    # border coordinate just below 0 would floor to -1 otherwise)
    fx = (up * W - 0.5).clamp(0.0, W - 1.0)
    fy = (vp * H - 0.5).clamp(0.0, H - 1.0)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = x0.to(torch.int32).clamp(0, W - 1).long()
    y0i = y0.to(torch.int32).clamp(0, H - 1).long()
    x1i = (x0i + 1).clamp(0, W - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    img = prev.img
    warped = ((1 - wy) * ((1 - wx) * img[y0i, x0i] + wx * img[y0i, x1i])
              + wy * ((1 - wx) * img[y1i, x0i] + wx * img[y1i, x1i]))

    # valid: a hit, inside the frame, depth agreeing at the nearest texel
    yn = torch.round(fy).to(torch.int32).clamp(0, H - 1).long()
    xn = torch.round(fx).to(torch.int32).clamp(0, W - 1).long()
    z_hist = prev.depth[yn, xn]
    inside = (up >= 0) & (up <= 1) & (vp >= 0) & (vp <= 1) & (t_prev > 0)
    z_ok = (z_hist - t_prev).abs() <= depth_tol * t_prev.clamp_min(1e-3)
    valid = (depth_new > 0) & inside & z_ok & (z_hist > 0)
    return warped, valid


def temporal_blend(prev: TemporalState | None, cam: Camera, aovs: AOVs,
                   img_linear, alpha: float = 0.8, depth_tol: float = 0.05):
    """Blend the current LINEAR image with the reprojected history:
    (1 - a) * current + a * warped, a = alpha where valid, else 0; alpha
    clamped to [0, 1] (above 1 the history, which stores the blend, would
    grow without bound). The first frame (prev None) passes through.
    Returns (blended (H, W, 3), the TemporalState for the next frame)."""
    alpha = min(max(float(alpha), 0.0), 1.0)
    if prev is None:
        blended = img_linear
    else:
        warped, valid = reproject(prev, cam, aovs.depth, depth_tol)
        a = torch.where(valid, alpha, 0.0)[..., None]
        blended = (1.0 - a) * img_linear + a * warped
    return blended, TemporalState(img=blended, depth=aovs.depth, camera=cam)
