"""Wrapper of the fused wavefront kernel (``csrc/wavefront_fused.cu``),
``backend="wavefront_fused"``: persistent blocks whose lanes fetch pixels
from a device counter and render each pixel's camera-path samples, adding
them into its rgb_sum row (``path.cuh run_pixels``, camera-only).

Two modes, as tpurt's kernel has: uniform (every pixel ``spp`` samples
from the state's iteration) and budget (pixel p ``budgets[p]`` samples from
its own count n_samples[p]). On a CUDA state each launches the kernel or
raises; on a CPU state each runs the kernel's plain version, the pool
renderer ``wavefront.wavefront_render`` or
``adaptive.wavefront_render_budget``, which draws the same streams.
Uniform launches keep a warp's lanes in lockstep, budget launches let them
run free (PERF.md has the A/B). A launch with hero wavelengths or
camera-path dispersion runs the kernel's sampler instance, one with the
sky, the legacy ramp, an emissive material or the clamp its emission
instance, one with a camera-spawn extension (the thin lens, a
MotionCamera's shutter, the Sobol spawn draws) a spawn instance: the
reference sampler's with the spawn flags alone, else the one with the
sampler flags and emission too (``mega_regen.camera_sampler_args``,
``emission_args``, ``spawn_args``). ``LAUNCHES`` counts kernel launches
only, ``SAMPLER_LAUNCHES`` those of the sampler instance,
``EMIT_LAUNCHES`` those with emission switches, ``SPAWN_LAUNCHES`` those
with spawn switches, ``LIGHTS_LAUNCHES`` those with lights switches (a
launch with several counts in each). A launch with light_sample "power"
or "spatial" runs a lights instance (``mega_regen.lights_args``; photons,
and so photon_aim, have no place here): the reference sampler's with the
mode alone (or with the spawn flags), else the one with the sampler flags
and emission too.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpurt_torch import adaptive, tracing, wavefront
from tpurt_torch.camera import check_camera
from tpurt_torch.config import check_slice
from tpurt_torch.kernels import build, bvh
from tpurt_torch.kernels.mega_regen import (camera_sampler_args, cie_table,
                                            emission_args, struct_ref,
                                            launch_counters, lights_args,
                                            sampler_on, scene_table,
                                            spawn_args)
from tpurt_torch.scene import freeze_scene

LAUNCHES = 0
SAMPLER_LAUNCHES = 0
EMIT_LAUNCHES = 0
SPAWN_LAUNCHES = 0
LIGHTS_LAUNCHES = 0


def _launch(scene, cfg, camera, state, base_seed, spp: int, aux=None):
    """The kernel on a copy of the state's rgb_sum; ``aux``: the (2, P)
    float32 budgets and counts of budget mode. Returns (rgb_sum, rays
    int64 scalar)."""
    global LAUNCHES, SAMPLER_LAUNCHES, EMIT_LAUNCHES, SPAWN_LAUNCHES, \
        LIGHTS_LAUNCHES
    dev = state.device
    with tracing.span("path.prepare"):
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        rgb = state.rgb_sum
        if rgb.dtype != torch.float32 or rgb.dim() != 2 \
                or rgb.shape[1] != 3 or rgb.shape[0] < cfg.n_pixels:
            raise ValueError(f"rgb_sum must be float32 (P, 3) with P >= "
                             f"{cfg.n_pixels}, got {tuple(rgb.shape)} "
                             f"{rgb.dtype}")
        rgb = rgb.clone(memory_format=torch.contiguous_format)
        fs = freeze_scene(scene)
        table, geo = scene_table(fs, cfg, camera, dev)
        args = geo.args()
        assert args.gmat is None    # tpurt never runs its G leaf here
        lib = build.library()
        counters = launch_counters(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        sampler = camera_sampler_args(fs, cfg)
        emission = emission_args(fs, cfg, wavefront=True)
        spawn = spawn_args(cfg, camera, dev, photons=False)
        lights = lights_args(cfg, photons=False)
    with tracing.span("path.launch", dev):
        err = lib.tpurt_wf_fused_launch(
            rgb.data_ptr(), rgb.shape[0], cfg.width, cfg.height,
            table.data_ptr(), len(geo.flat_rows), len(fs.materials),
            len(fs.lights), int(base_seed) & 0xFFFFFFFF, spp,
            state.iteration, None if aux is None else aux.data_ptr(),
            cfg.depth, cfg.rr_threshold, ctypes.byref(args),
            counters.data_ptr(), cie_table(dev).data_ptr(),
            ctypes.byref(sampler), struct_ref(emission), struct_ref(spawn),
            struct_ref(lights), stream)
        build.check_launch(lib, err, "tpurt_wf_fused_launch")
    LAUNCHES += 1
    if spawn is not None:
        SPAWN_LAUNCHES += 1
    if lights is not None:
        LIGHTS_LAUNCHES += 1
    if emission is not None:
        EMIT_LAUNCHES += 1
    elif spawn is None and lights is None and sampler_on(sampler):
        SAMPLER_LAUNCHES += 1
    bvh.count_walk(geo)
    return rgb, counters[0]


def _check(scene, cfg, camera, state) -> None:
    wavefront.check_sampler(cfg)
    check_slice(cfg)
    check_camera(cfg, camera)
    wavefront._check_state(state, scene)


def wavefront_render_fused(scene, cfg, camera, state, base_seed, spp: int):
    """``spp`` samples for every pixel, from iteration state.iteration.
    On the card every row's n_samples grows by ``spp``, pad rows too, as
    in tpurt's fused kernel (the plain pool counts image rows only; no
    reader looks past them)."""
    _check(scene, cfg, camera, state)
    if state.device.type == "cpu":
        with tracing.span("path.launch"):
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
    _check(scene, cfg, camera, state)
    if budgets.shape != state.n_samples.shape:
        raise ValueError(f"budgets {tuple(budgets.shape)} do not match the "
                         f"state's {tuple(state.n_samples.shape)} rows")
    budgets = adaptive.clip_budgets(cfg, budgets.to(state.device),
                                    max_budget)
    if state.device.type == "cpu":
        with tracing.span("path.launch"):
            return adaptive.wavefront_render_budget(scene, cfg, camera,
                                                    state, base_seed,
                                                    budgets, max_budget)
    aux = torch.stack([budgets.to(torch.float32),
                       state.n_samples.to(torch.float32)]).contiguous()
    rgb, rays = _launch(scene, cfg, camera, state, base_seed, 0, aux)
    return dataclasses.replace(
        state, rgb_sum=rgb, n_samples=state.n_samples + aux[0],
        iteration=state.iteration + int(max_budget),
        rays=state.rays + rays if cfg.count_rays else state.rays)
