"""Wrapper of the fused wavefront kernel (``csrc/wavefront_fused.cu``),
``backend="wavefront_fused"``: one thread per pixel renders that pixel's
camera-path samples back to back and adds them into its rgb_sum row.

Two modes, as tpurt's kernel has: uniform (every pixel ``spp`` samples
from the state's iteration) and budget (pixel p ``budgets[p]`` samples from
its own count n_samples[p]). On a CUDA state each launches the kernel or
raises; on a CPU state each runs the kernel's plain version, the pool
renderer ``wavefront.wavefront_render`` or
``adaptive.wavefront_render_budget``, which draws the same streams.
``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpurt_torch import adaptive, wavefront
from tpurt_torch.config import check_slice
from tpurt_torch.kernels import build, bvh
from tpurt_torch.kernels.mega_regen import CIE_HOST, scene_table
from tpurt_torch.scene import freeze_scene

LAUNCHES = 0


def _launch(scene, cfg, camera, state, base_seed, spp: int, budgets=None,
            base_counts=None):
    """The kernel on a copy of the state's rgb_sum. Returns (rgb_sum, rays
    int64 scalar)."""
    global LAUNCHES
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rgb = state.rgb_sum
    if rgb.dtype != torch.float32 or rgb.dim() != 2 or rgb.shape[1] != 3 \
            or rgb.shape[0] < cfg.n_pixels:
        raise ValueError(f"rgb_sum must be float32 (P, 3) with P >= "
                         f"{cfg.n_pixels}, got {tuple(rgb.shape)} {rgb.dtype}")
    rgb = rgb.contiguous().clone()
    fs = freeze_scene(scene)
    table, geo = scene_table(fs, cfg, camera, dev)
    lib = build.library()
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tpurt_wf_fused_launch(
        rgb.data_ptr(), cfg.n_pixels, cfg.width, cfg.height, table.data_ptr(),
        len(geo.flat_rows), len(fs.materials), len(fs.lights),
        int(base_seed) & 0xFFFFFFFF, spp, state.iteration, ptr(budgets),
        ptr(base_counts), cfg.depth, cfg.rr_threshold,
        ctypes.byref(geo.args()), rays.data_ptr(),
        CIE_HOST.ctypes.data_as(ctypes.c_void_p), stream)
    build.check_launch(lib, err, "tpurt_wf_fused_launch")
    LAUNCHES += 1
    bvh.count_walk(geo)
    return rgb, rays


def _check(scene, cfg, state) -> None:
    wavefront.reject_camera_strata(cfg)
    check_slice(cfg)
    wavefront._check_state(state, scene)


def wavefront_render_fused(scene, cfg, camera, state, base_seed, spp: int):
    """``spp`` samples for every pixel, from iteration state.iteration.
    On the card every row's n_samples grows by ``spp``, pad rows too, as
    in tpurt's fused kernel (the plain pool counts image rows only; no
    reader looks past them)."""
    _check(scene, cfg, state)
    if state.device.type == "cpu":
        return wavefront.wavefront_render(scene, cfg, camera, state,
                                          base_seed, spp)
    spp = int(spp)
    rgb, rays = _launch(scene, cfg, camera, state, base_seed, spp)
    return dataclasses.replace(
        state, rgb_sum=rgb, n_samples=state.n_samples + float(spp),
        iteration=state.iteration + spp,
        rays=state.rays + rays if cfg.count_rays else state.rays)


def wavefront_render_budget_fused(scene, cfg, camera, state, base_seed,
                                  budgets, max_budget: int):
    """``budgets[p]`` samples for pixel p (clipped to [0, max_budget], pad
    rows 0), continuing at its count n_samples[p]; ``iteration`` grows by
    ``max_budget``."""
    _check(scene, cfg, state)
    if budgets.shape != state.n_samples.shape:
        raise ValueError(f"budgets {tuple(budgets.shape)} do not match the "
                         f"state's {tuple(state.n_samples.shape)} rows")
    budgets = adaptive.clip_budgets(cfg, budgets.to(state.device),
                                    max_budget)
    if state.device.type == "cpu":
        return adaptive.wavefront_render_budget(scene, cfg, camera, state,
                                                base_seed, budgets,
                                                max_budget)
    b32 = budgets.to(torch.int32).contiguous()
    base = state.n_samples.to(torch.int32).contiguous()
    rgb, rays = _launch(scene, cfg, camera, state, base_seed, 0, b32, base)
    return dataclasses.replace(
        state, rgb_sum=rgb, n_samples=state.n_samples + b32.float(),
        iteration=state.iteration + int(max_budget),
        rays=state.rays + rays if cfg.count_rays else state.rays)
