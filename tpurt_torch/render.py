"""Progressive renderer of the port (``tpurt/render.py``): the state, the
sample/seed/radius schedule, render entry points, resolve and checkpoints.

``backend="pallas"`` (with the default ``pallas_regen=True``) renders
through the regen kernel wrapper, which launches the CUDA kernel for a
state on the card and runs its plain PyTorch version for a state on the
CPU; with ``pallas_regen=False`` it calls the tile-synchronized kernel's
wrapper once per sample, stepping the seed, strata epoch and radius on the
host (``tpurt.kernels.mega_pallas._render_pallas_jit``);
``backend="xla"`` always runs the plain version (the eager-torch
integrator), through tpurt's per-ray BVH walk under ``use_bvh``. All three
give the same streams, ray counts and states, except that
``pallas_mxu_leaf`` changes the regen kernel's triangle test (tpurt's
G-matrix leaf, where ``kernels.bvh.mxu_leaf_engages`` holds).

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
import functools
import os
import weakref

import numpy as np
import torch

from tpurt_torch import integrate, tracing, wavefront
from tpurt_torch import tonemap as tm
from tpurt_torch.camera import Camera, check_camera
from tpurt_torch.config import RenderConfig, check_slice
from tpurt_torch.device import resolve_device
from tpurt_torch.integrate import sppm_radius_step
from tpurt_torch.kernels import mega_regen, mega_step
from tpurt_torch.kernels import tonemap as tonemap_kernel
from tpurt_torch.kernels import wavefront_fused, wavefront_sweep
from tpurt_torch.ops.rng import frame_seed as _frame_seed  # noqa: F401
from tpurt_torch.scene import Scene, freeze_scene

WAVEFRONT_BACKENDS = ("wavefront", "wavefront_pallas", "wavefront_fused")

PLANE_REUSES = 0   # state_to_planes calls that copied a state's own planes
PLANE_PACKS = 0    # state_to_planes calls that packed the fields

# the (P, 3) fields that view the planes, and their first rows
_VIEW_ROWS = (("rgb_sum", 0), ("vis_pos", 3), ("vis_norm", 6),
              ("vis_wo", 9), ("vis_tp", 12))
# the planes' attribute naming the vis_mat made from their row 15 and its
# version counter then
_ROW15 = "_tpurt_row15"


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Everything that evolves across samples; the fields of
    ``tpurt.render.RenderState``. Arrays are (P, ...) in linear pixel
    order, P = padded_pixels(cfg); the scalars live on the host, except
    the ray count, which accumulates on the device without a sync.

    Contiguity is not promised: a state that a render call returned
    through the (16, P) planes (``state_to_planes``) holds rgb_sum and
    the four vispoint fields as strided (P, 3) views of the planes the
    kernel wrote, and vis_mat as the int32 copy of their row 15, so the
    next call copies the planes whole instead of packing them. A reader
    that needs contiguous rows calls ``.contiguous()``, and so does one
    that keeps a field alone: a view holds all 16 rows of the planes.
    Under ``torch.inference_mode()`` every call packs (an inference
    tensor has no version counter to show ``vis_mat`` unwritten). A
    render call never writes its input state."""
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


def init_state(cfg: RenderConfig, device=None) -> RenderState:
    """Fresh accumulation state on ``device``, the CUDA card unless the
    caller asks for another (``device="cpu"``)."""
    device = resolve_device(device)
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


def resident_planes(state: RenderState) -> torch.Tensor | None:
    """The (16, P) planes that hold every plane field of ``state`` as
    ``plane_fields`` left them: rgb_sum and the vispoints (P, 3) views of
    rows 0-14 with strides (1, P), and vis_mat the int32 copy of row 15
    made with them and not written since. None for any other state (a
    fresh one, one whose fields ``dataclasses.replace`` swapped, a
    wavefront or loaded one)."""
    planes = state.rgb_sum._base
    tag = getattr(planes, _ROW15, None)
    if tag is None or tag[0]() is not state.vis_mat \
            or state.vis_mat._version != tag[1]:
        return None
    P = planes.shape[1]
    for name, row in _VIEW_ROWS:
        t = getattr(state, name)
        if t._base is not planes or t.shape != (P, 3) \
                or t.stride() != (1, P) \
                or t.storage_offset() != planes.storage_offset() + row * P:
            return None
    return planes


def state_to_planes(state: RenderState) -> torch.Tensor:
    """(16, P) float32 planes: rgb_sum, vis_pos, vis_norm, vis_wo, vis_tp,
    vis_mat (as float); new planes, never the state's own. A state that
    a render call left in planes (``resident_planes``) is copied in one
    pass (``PLANE_REUSES``), any other packed field by field
    (``PLANE_PACKS``)."""
    global PLANE_REUSES, PLANE_PACKS
    planes = resident_planes(state)
    if planes is not None:
        PLANE_REUSES += 1
        return planes.clone()
    PLANE_PACKS += 1
    return torch.cat([state.rgb_sum.T, state.vis_pos.T, state.vis_norm.T,
                      state.vis_wo.T, state.vis_tp.T,
                      state.vis_mat.to(torch.float32)[None]]).contiguous()


def plane_fields(planes: torch.Tensor) -> dict:
    """The RenderState fields the (16, P) planes hold, as ``state_to_planes``
    lays them out: views of the planes (vis_mat an int32 copy of row 15),
    which the next call recognises (``resident_planes``)."""
    fields = {name: planes[row:row + 3].T for name, row in _VIEW_ROWS}
    vis_mat = planes[15].to(torch.int32)
    if not vis_mat.is_inference():
        # an inference tensor has no version counter to show a later write
        setattr(planes, _ROW15, (weakref.ref(vis_mat), vis_mat._version))
    return dict(fields, vis_mat=vis_mat)


def planes_to_state(state: RenderState, planes: torch.Tensor, spp: int,
                    radius: float, rays: torch.Tensor,
                    cfg: RenderConfig) -> RenderState:
    return RenderState(
        **plane_fields(planes), n_samples=state.n_samples + float(spp),
        iteration=state.iteration + spp, photon_radius=radius,
        rays=state.rays + rays if cfg.count_rays else state.rays)


def _wavefront_dispatch(cfg: RenderConfig):
    """The renderer of a wavefront backend."""
    if cfg.backend == "wavefront":
        return functools.partial(wavefront.wavefront_render,
                                 step=wavefront.xla_stepper(cfg))
    if cfg.backend == "wavefront_pallas":
        return wavefront_sweep.wavefront_render_pallas
    return wavefront_fused.wavefront_render_fused


def _check_call(scene: Scene, cfg: RenderConfig, camera, state: RenderState,
                depth: int) -> None:
    if cfg.backend in WAVEFRONT_BACKENDS:
        wavefront.check_sampler(cfg)
    check_slice(cfg)
    check_camera(cfg, camera)
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
    with tracing.span("render.to_planes"):
        planes = state_to_planes(state)
    if cfg.backend == "pallas" and cfg.pallas_regen:
        rays = mega_regen.regen_call(scene, cfg, camera, planes,
                                     int(base_seed), spp, state.iteration,
                                     state.photon_radius, depth)
    elif cfg.backend == "pallas":
        # the tile-synchronized kernel: one launch per sample
        rays = torch.zeros((), dtype=torch.int64, device=planes.device)
        r = state.photon_radius
        for i in range(spp):
            rays = rays + mega_step.step_call(
                scene, cfg, camera, planes, int(base_seed),
                state.iteration + i, r, depth)
            r = radius_after(cfg, state.iteration + i, r, 1)
    else:
        # tpurt's XLA integrator walks the Scene's BVH per ray under use_bvh
        tri = integrate.BVH if cfg.use_bvh else integrate.EXACT
        rays = integrate.render_plain(freeze_scene(scene), cfg, camera,
                                      planes, int(base_seed), spp,
                                      state.iteration, state.photon_radius,
                                      depth, tri)
    with tracing.span("render.from_planes"):
        radius = radius_after(cfg, state.iteration, state.photon_radius, spp)
        return planes_to_state(state, planes, spp, radius, rays, cfg)


def _render(scene, cfg, camera, state, base_seed, spp, depth):
    with tracing.span("render"):
        with tracing.span("render.check"):
            _check_call(scene, cfg, camera, state, depth)
        return _advance(scene, cfg, camera, state, base_seed, spp, depth)


def render(scene: Scene, cfg: RenderConfig, camera: Camera,
           state: RenderState, base_seed, spp: int) -> RenderState:
    """Advance every pixel by ``spp`` progressive samples."""
    return _render(scene, cfg, camera, state, base_seed, int(spp),
                   cfg.depth)


def render_step(scene: Scene, cfg: RenderConfig, camera: Camera,
                state: RenderState, base_seed,
                depth: int | None = None) -> RenderState:
    """One progressive sample; ``depth`` overrides cfg.depth (preview)."""
    d = cfg.depth if depth is None else int(depth)
    return _render(scene, cfg, camera, state, base_seed, 1, d)


def render_until(scene: Scene, cfg: RenderConfig, camera: Camera,
                 state: RenderState, base_seed, *,
                 target_rel_err: float = 0.02, batch_spp: int = 8,
                 max_spp: int = 1024, min_batches: int = 2):
    """Render ``batch_spp``-sample batches through ``render`` until the
    image reaches a noise target (``tpurt.render.render_until``).

    After each batch the host reads the accumulated ``rgb_sum`` in float64
    and updates a spp-weighted Welford over the batch means; the error is
    mean(standard error of the accumulated mean) / mean(|mean|). Stops when
    it is at most ``target_rel_err`` (after ``min_batches`` batches) or
    when ``max_spp`` new samples have been added. The render itself is
    untouched: the final state equals one ``render`` of the same spp.

    Returns ``(state, info)``, info holding spp (new samples), batches,
    rel_err and converged.
    """
    if batch_spp < 1 or min_batches < 2:
        raise ValueError("batch_spp >= 1 and min_batches >= 2 required "
                         "(the batch variance divides by B-1)")
    n = cfg.n_pixels

    def host_sum(st):
        return st.rgb_sum[:n].contiguous().double().cpu().numpy()

    prev = host_sum(state)
    mean = np.zeros_like(prev)
    m2 = np.zeros_like(prev)
    done_spp, batches, rel_err = 0, 0, float("inf")
    while done_spp < max_spp:
        spp = min(batch_spp, max_spp - done_spp)
        state = render(scene, cfg, camera, state, base_seed, spp)
        done_spp += spp
        batches += 1
        with tracing.span("until.welford"):
            cur = host_sum(state)
            batch_mean = (cur - prev) / spp
            prev = cur
            delta = batch_mean - mean
            mean += delta * (spp / done_spp)
            m2 += spp * delta * (batch_mean - mean)
            if batches >= min_batches:
                sigma2 = m2 / (batches - 1)         # per-sample variance
                se = np.sqrt(sigma2 / done_spp)     # std error of accum mean
                rel_err = float(se.mean() / max(np.abs(mean).mean(), 1e-12))
                if rel_err <= target_rel_err:
                    break
    return state, {"spp": done_spp, "batches": batches,
                   "rel_err": rel_err,
                   "converged": rel_err <= target_rel_err}


def resolve_image(cfg: RenderConfig, state: RenderState, key=None,
                  saturation=None) -> torch.Tensor:
    """Resolve + tonemap to an (H, W, 3) image on the state's device, by
    the blit kernel on the card and its plain version on the CPU."""
    return tonemap_kernel.resolve_state_pallas(cfg, state, key, saturation)


def resolve_radiance(cfg: RenderConfig, state: RenderState) -> torch.Tensor:
    """(H, W, 3) mean radiance, untonemapped."""
    n = cfg.n_pixels
    return tm.resolve(state.rgb_sum[:n].contiguous(),
                      state.n_samples[:n]).reshape(cfg.height, cfg.width, 3)


# ----- checkpoints, interchangeable with tpurt's .npz -----

def save_checkpoint(path: str, cfg: RenderConfig, state: RenderState) -> None:
    """Write the config and state as tpurt.render.save_checkpoint does."""
    from tpurt_torch.interop import state_to_numpy
    np.savez_compressed(path, __cfg__=np.frombuffer(
        repr(dataclasses.asdict(cfg)).encode(), dtype=np.uint8),
        **state_to_numpy(state))


def load_checkpoint(path: str, device=None):
    """(cfg, state) from a checkpoint of either package; the state on
    ``device``, the CUDA card by default."""
    from tpurt_torch.interop import state_from_numpy
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        cfg = RenderConfig(**ast.literal_eval(
            bytes(data["__cfg__"].tobytes()).decode()))
        fields = {f.name: data[f.name]
                  for f in dataclasses.fields(RenderState)}
    return cfg, state_from_numpy(fields, device)
