"""Progressive renderer of the port (``tpurt/render.py``): the state, the
sample/seed/radius schedule, render entry points, resolve and checkpoints.

``backend="pallas"`` (with the default ``pallas_regen=True``) renders
through the regen kernel wrapper, which launches the CUDA kernel for a
state on the card and runs its plain PyTorch version for a state on the
CPU; ``backend="xla"`` always runs the plain version (the eager-torch
integrator). Both give the same streams, ray counts and images.

The wavefront backends trace camera paths only (no photon pass; the
vispoints and the photon radius stay as they are): ``"wavefront"`` is the
plain pool renderer, ``"wavefront_pallas"`` the pool driven by the sweep
kernel, ``"wavefront_fused"`` the fused kernel (``tpurt.render.
_wavefront_dispatch``). With photons off they trace the same segments as
``"xla"``.
"""

from __future__ import annotations

import ast
import dataclasses
import os

import numpy as np
import torch

from tpurt_torch import integrate, wavefront
from tpurt_torch import tonemap as tm
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, check_slice
from tpurt_torch.integrate import sppm_radius_step
from tpurt_torch.kernels import mega_regen
from tpurt_torch.kernels import tonemap as tonemap_kernel
from tpurt_torch.kernels import wavefront_fused, wavefront_sweep
from tpurt_torch.ops.rng import frame_seed as _frame_seed  # noqa: F401
from tpurt_torch.scene import Scene, freeze_scene

WAVEFRONT_BACKENDS = ("wavefront", "wavefront_pallas", "wavefront_fused")


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Everything that evolves across samples; the fields of
    ``tpurt.render.RenderState``. Arrays are (P, ...) in linear pixel
    order, P = padded_pixels(cfg); the scalars live on the host, except
    the ray count, which accumulates on the device without a sync."""
    rgb_sum: torch.Tensor     # (P, 3) f32, radiance sum
    n_samples: torch.Tensor   # (P,)   f32, sample count
    vis_pos: torch.Tensor     # (P, 3) f32, persistent vispoints
    vis_norm: torch.Tensor    # (P, 3) f32
    vis_wo: torch.Tensor      # (P, 3) f32
    vis_tp: torch.Tensor      # (P, 3) f32
    vis_mat: torch.Tensor     # (P,)   i32
    iteration: int            # samples taken so far
    photon_radius: float      # SPPM radius (a float32 value)
    rays: torch.Tensor        # ()     i64, traced segments

    @property
    def device(self) -> torch.device:
        return self.rgb_sum.device


def padded_pixels(cfg: RenderConfig) -> int:
    """tpurt's padded pixel count P for ``cfg`` (block grid included)."""
    n = cfg.n_pixels
    if cfg.backend == "pallas" and cfg.pallas_block_tiles:
        rows = cfg.pallas_lanes // 128
        nbx = -(-cfg.width // 128)
        nby = -(-cfg.height // rows)
        return nbx * nby * cfg.pallas_lanes
    if cfg.backend in ("pallas",) + WAVEFRONT_BACKENDS:
        t = cfg.pallas_lanes
    else:
        t = cfg.tile_size
    return ((n + t - 1) // t) * t


def init_state(cfg: RenderConfig, device="cpu") -> RenderState:
    """Fresh accumulation state on ``device``."""
    P = padded_pixels(cfg)
    z3 = lambda: torch.zeros((P, 3), dtype=torch.float32,  # noqa: E731
                             device=device)
    return RenderState(
        rgb_sum=z3(), n_samples=torch.zeros((P,), dtype=torch.float32,
                                            device=device),
        vis_pos=z3(), vis_norm=z3(), vis_wo=z3(), vis_tp=z3(),
        vis_mat=torch.zeros((P,), dtype=torch.int32, device=device),
        iteration=0, photon_radius=float(np.float32(cfg.photon_radius_init)),
        rays=torch.zeros((), dtype=torch.int64, device=device))


def radius_after(cfg: RenderConfig, iteration: int, radius: float,
                 spp: int) -> float:
    """The radius after ``spp`` more samples (the kernel's per-pixel
    schedule, on the host)."""
    r = np.float32(radius)
    for i in range(spp):
        r = sppm_radius_step(cfg, iteration + i + 1, r)
    return float(r)


def state_to_planes(state: RenderState) -> torch.Tensor:
    """(16, P) float32 planes: rgb_sum, vis_pos, vis_norm, vis_wo, vis_tp,
    vis_mat (as float)."""
    return torch.cat([state.rgb_sum.T, state.vis_pos.T, state.vis_norm.T,
                      state.vis_wo.T, state.vis_tp.T,
                      state.vis_mat.to(torch.float32)[None]]).contiguous()


def planes_to_state(state: RenderState, planes: torch.Tensor, spp: int,
                    radius: float, rays: torch.Tensor,
                    cfg: RenderConfig) -> RenderState:
    t3 = lambda a: planes[a:a + 3].T.contiguous()  # noqa: E731
    return RenderState(
        rgb_sum=t3(0), n_samples=state.n_samples + float(spp),
        vis_pos=t3(3), vis_norm=t3(6), vis_wo=t3(9), vis_tp=t3(12),
        vis_mat=planes[15].to(torch.int32),
        iteration=state.iteration + spp, photon_radius=radius,
        rays=state.rays + rays if cfg.count_rays else state.rays)


def _wavefront_dispatch(cfg: RenderConfig):
    """The renderer of a wavefront backend."""
    if cfg.backend == "wavefront":
        return wavefront.wavefront_render
    if cfg.backend == "wavefront_pallas":
        return wavefront_sweep.wavefront_render_pallas
    return wavefront_fused.wavefront_render_fused


def _check_call(scene: Scene, cfg: RenderConfig, state: RenderState,
                depth: int) -> None:
    if cfg.backend in WAVEFRONT_BACKENDS:
        wavefront.reject_camera_strata(cfg)
    check_slice(cfg)
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if state.rgb_sum.shape[0] != padded_pixels(cfg):
        raise ValueError(f"state has {state.rgb_sum.shape[0]} pixels, cfg "
                         f"pads to {padded_pixels(cfg)}: use init_state(cfg)")
    devices = {t.device for t in scene.tensors().values()}
    if devices != {state.device}:
        raise ValueError(f"scene on {sorted(map(str, devices))}, state on "
                         f"{state.device}: move them with .to(device)")


def _advance(scene, cfg, camera, state, base_seed, spp, depth):
    if cfg.backend in WAVEFRONT_BACKENDS:
        # depth is part of the config for the pool tracers, as in tpurt
        cfg = cfg if depth == cfg.depth else cfg.with_(depth=depth)
        return _wavefront_dispatch(cfg)(scene, cfg, camera, state,
                                        base_seed, spp)
    planes = state_to_planes(state)
    if cfg.backend == "pallas":
        rays = mega_regen.regen_call(scene, cfg, camera, planes,
                                     int(base_seed), spp, state.iteration,
                                     state.photon_radius, depth)
    else:
        rays = integrate.render_plain(freeze_scene(scene), cfg, camera,
                                      planes, int(base_seed), spp,
                                      state.iteration, state.photon_radius,
                                      depth)
    radius = radius_after(cfg, state.iteration, state.photon_radius, spp)
    return planes_to_state(state, planes, spp, radius, rays, cfg)


def render(scene: Scene, cfg: RenderConfig, camera: Camera,
           state: RenderState, base_seed, spp: int) -> RenderState:
    """Advance every pixel by ``spp`` progressive samples."""
    _check_call(scene, cfg, state, cfg.depth)
    return _advance(scene, cfg, camera, state, base_seed, int(spp),
                    cfg.depth)


def render_step(scene: Scene, cfg: RenderConfig, camera: Camera,
                state: RenderState, base_seed,
                depth: int | None = None) -> RenderState:
    """One progressive sample; ``depth`` overrides cfg.depth (preview)."""
    d = cfg.depth if depth is None else int(depth)
    _check_call(scene, cfg, state, d)
    return _advance(scene, cfg, camera, state, base_seed, 1, d)


def resolve_image(cfg: RenderConfig, state: RenderState, key=None,
                  saturation=None) -> torch.Tensor:
    """Resolve + tonemap to an (H, W, 3) image on the state's device, by
    the blit kernel on the card and its plain version on the CPU."""
    key = cfg.tonemap_key if key is None else key
    saturation = cfg.tonemap_saturation if saturation is None else saturation
    img = tonemap_kernel.tonemap_pixels(state.rgb_sum, state.n_samples,
                                        cfg.n_pixels, key, saturation)
    return img.reshape(cfg.height, cfg.width, 3)


def resolve_radiance(cfg: RenderConfig, state: RenderState) -> torch.Tensor:
    """(H, W, 3) mean radiance, untonemapped."""
    n = cfg.n_pixels
    return tm.resolve(state.rgb_sum[:n], state.n_samples[:n]).reshape(
        cfg.height, cfg.width, 3)


# ----- checkpoints, interchangeable with tpurt's .npz -----

def save_checkpoint(path: str, cfg: RenderConfig, state: RenderState) -> None:
    """Write the config and state as tpurt.render.save_checkpoint does."""
    from tpurt_torch.interop import state_to_numpy
    np.savez_compressed(path, __cfg__=np.frombuffer(
        repr(dataclasses.asdict(cfg)).encode(), dtype=np.uint8),
        **state_to_numpy(state))


def load_checkpoint(path: str, device="cpu"):
    """(cfg, state) from a checkpoint of either package."""
    from tpurt_torch.interop import state_from_numpy
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        cfg = RenderConfig(**ast.literal_eval(
            bytes(data["__cfg__"].tobytes()).decode()))
        fields = {f.name: data[f.name]
                  for f in dataclasses.fields(RenderState)}
    return cfg, state_from_numpy(fields, device)
