"""Ray queries (``tpurt.query``): batched closest hit, occlusion and a
direct-lighting probe at arbitrary points, through the render path's own
intersection, shadow and next-event code, so that the tracer serves
camera-less work (light-map and AO baking, visibility).

Plain PyTorch on the scene's device: tpurt computes these in jnp outside
any Pallas kernel. Rays are (N, 3); directions need not be unit length (t
comes back in units of |d|); hit points are pulled back as the render path
pulls them back; occlusion is the render path's shadow rule (opaque
geometry blocks, smooth dielectrics pass the squared Fresnel
transmission). Inputs are moved to the scene's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpurt_torch import integrate
from tpurt_torch.config import RenderConfig
from tpurt_torch.ops import fdiv
from tpurt_torch.ops.intersect import MISS
from tpurt_torch.ops.rng import frame_seed, rand_1f, seed_pixels
from tpurt_torch.ops.spectra import sample_wavelength
from tpurt_torch.scene import freeze_scene


class RayHits(NamedTuple):
    """Closest-hit results for a ray batch (all tensors length N)."""
    hit: torch.Tensor       # (N,)   bool, True where anything was hit
    t: torch.Tensor         # (N,)   f32 hit distance in units of |d|; MISS on a miss
    position: torch.Tensor  # (N, 3) hit point (pulled back like the render path); 0 on a miss
    normal: torch.Tensor    # (N, 3) outward geometric normal; 0 on a miss
    mat_id: torch.Tensor    # (N,)   i32 material index; -1 on a miss
    albedo: torch.Tensor    # (N, 3) material color at the hit; 0 on a miss
    mtype: torch.Tensor     # (N,)   i32 material type (0 diffuse / 1 dielectric / 2 metal / 3 emissive); -1 on a miss


def _rays(x, device) -> tuple:
    """(N, 3) float32 on ``device`` as a vec3 of (N,) planes."""
    t = torch.as_tensor(x, dtype=torch.float32).to(device).reshape(-1, 3)
    return tuple(t[:, c].contiguous() for c in range(3))


def _per_ray(x, n: int, device) -> torch.Tensor:
    """A scalar or (N,) value as (N,) float32 on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32).to(device).expand(
        n).contiguous()


def trace_rays(scene, origins, directions,
               cfg: RenderConfig | None = None) -> RayHits:
    """Closest hit for each ray, by the nearest-hit query of the XLA
    render path: the exact triangle sweep, or tpurt's per-ray BVH walk
    under ``cfg.use_bvh``. Equally near primitives go to the least (t,
    scene index)."""
    cfg = RenderConfig() if cfg is None else cfg
    fs = freeze_scene(scene)
    dev = scene.device
    o, d = _rays(origins, dev), _rays(directions, dev)
    tri = integrate.BVH if cfg.use_bvh else integrate.EXACT
    t, loc, nrm, mat = integrate.intersect_scene(fs, o, d, tri)
    found = t < MISS
    row = integrate.material_table(fs, dev)[mat]
    f3 = found[:, None]
    return RayHits(
        hit=found, t=t,
        position=torch.where(f3, torch.stack(loc, -1), 0.0),
        normal=torch.where(f3, torch.stack(nrm, -1), 0.0),
        mat_id=torch.where(found, mat, -1).to(torch.int32),
        albedo=torch.where(f3, row[:, 0:3], 0.0),
        mtype=torch.where(found, row[:, 5].to(torch.int32), -1))


def occlusion(scene, origins, directions, t_max,
              cfg: RenderConfig | None = None,
              lambda_nm=550.0) -> torch.Tensor:
    """Transmittance along ``origin + s*direction, s in (0, t_max)``: 0
    fully blocked, 1 clear; smooth dielectrics pass the squared Fresnel
    transmission at ``lambda_nm``. ``t_max`` and ``lambda_nm`` are
    scalars or (N,); t_max is in units of |d|. ``cfg`` is accepted for
    tpurt's signature: the shadow rule has no knob."""
    fs = freeze_scene(scene)
    dev = scene.device
    o, d = _rays(origins, dev), _rays(directions, dev)
    n = o[0].shape[0]
    return integrate._shadow(fs, o, d, _per_ray(t_max, n, dev), _per_ray(
        lambda_nm, n, dev))


def light_probe(scene, points, normals, samples: int = 16,
                cfg: RenderConfig | None = None, seed=0) -> torch.Tensor:
    """(N, 3) reflected radiance of a unit-albedo diffuse surface at each
    point: the render path's next-event estimate in ``cfg.light_sample``'s
    mode, averaged over ``samples`` spectral draws. Sample k of point i
    draws from the stream ``seed_pixels(frame_seed(seed, k), i, 0)``: one
    draw for the wavelength, then the NEE draws. Only the lights emit
    here (no sky, no emissive materials)."""
    if int(samples) < 1:
        raise ValueError("samples >= 1 required")
    cfg = RenderConfig() if cfg is None else cfg
    fs = freeze_scene(scene)
    dev = scene.device
    pos, nrm = _rays(points, dev), _rays(normals, dev)
    n = pos[0].shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(idx)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for k in range(int(samples)):
        rng = seed_pixels(frame_seed(int(seed), k), idx, zero)
        u_lam, rng = rand_1f(rng)
        lam = sample_wavelength(u_lam)
        direct, _ = integrate.sample_direct_lighting(
            fs, pos, nrm, lam, rng, integrate.light_emission_rgb(fs, lam),
            cfg.light_sample)
        acc = acc + torch.stack(direct, -1)
    return fdiv(acc, float(samples))
