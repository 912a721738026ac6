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
run free (PERF.md has the A/B). A uniform launch of ``TAIL_MIN_SPP``
samples a pixel or more under the reference sampler and without emission,
spawn or lights switches (``tail_engages``) runs the tail instance
(``csrc/fused_tail.cuh``): once at most a few lanes of a warp are on a
path, the others start their next sample and the stragglers finish theirs
beside them; ``tail_share`` reads the share of path segments traced by
such stragglers. Hero wavelengths or camera-path
dispersion, emission (the sky, the legacy ramp, an emissive material, the
clamp), the camera-spawn extensions (the thin lens, a MotionCamera's
shutter, the Sobol spawn draws) and light_sample "power" or "spatial"
select the kernel's sampler, emission, spawn and lights instances
(``mega_regen.kernel_instance``; photons, and so photon_aim, have no
place here). The launch reads its tables and switches from a
``mega_regen.launch_plan`` of kind ``CAMERA``. ``LAUNCHES`` counts kernel
launches only, ``mega_regen.INSTANCE_LAUNCHES`` them by the instance they
ran. Every launch counts its warps' trips and the lanes that traced a
segment in them (shadow segments aside) and adds them to a per-device
pair (``lane_counts``); ``lane_share`` reads the share of lanes at work,
which lockstep lowers.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpurt_torch import adaptive, tracing, wavefront
from tpurt_torch.camera import check_camera
from tpurt_torch.config import check_slice
from tpurt_torch.kernels.mega_regen import (
    CAMERA, TAIL_KERNEL, TAIL_MIN_SPP, camera_sampler_args, emission_args,
    kernel_instance, launch, launch_counters, launch_plan, lights_args,
    per_device, sampler_on, spawn_on, struct_ref)
from tpurt_torch.scene import freeze_scene

LAUNCHES = 0
_LANES = {}   # device -> int64 (warp trips, lanes that traced a segment)
              # of the fused launches on it, added to by every launch
_TAIL = {}    # device -> int64 (path segments, tail segments) of the
              # tail instance's launches on it


def lane_counts(device) -> torch.Tensor:
    """The fused kernel's (trips, lanes) accumulator on ``device``: made
    on the first call, then kept; every launch adds to it."""
    return per_device(_LANES, device, lambda: torch.zeros(
        (2,), dtype=torch.int64))


def lane_share():
    """The lanes that traced a segment over 32 times the warp trips,
    summed over every fused launch of the process (a fraction; reads the
    device, so it waits for the launches), or None if none ran."""
    if not LAUNCHES or not _LANES:
        return None
    trips, lanes = (int(x) for x in sum(t.cpu() for t in _LANES.values()))
    return lanes / (32 * trips) if trips else None


def tail_counts(device) -> torch.Tensor:
    """The tail instance's (path segments, tail segments) accumulator on
    ``device``: made on its first launch there, then kept; every launch of
    the instance adds to it. A tail segment is one of a path that went on
    after its warp moved on to its next sample."""
    return per_device(_TAIL, device, lambda: torch.zeros(
        (2,), dtype=torch.int64))


def tail_share():
    """The tail segments over all path segments, summed over every launch
    of the tail instance in the process (a fraction; reads the device), or
    None before any such launch."""
    if not _TAIL:
        return None
    paths, pooled = (int(x) for x in sum(t.cpu() for t in _TAIL.values()))
    return pooled / paths if paths else None


def tail_engages(fs, cfg, spp: int | None) -> bool:
    """Whether a fused launch of ``spp`` samples a pixel (None: a budget
    launch, which never does) runs the tail instance: a uniform launch of
    ``TAIL_MIN_SPP`` samples or more under the reference sampler, without
    emission, spawn or lights switches (``kernel_instance`` on the
    switches ``mega_regen.build_plan`` gives a ``CAMERA`` plan)."""
    return spp is not None and _instance(kernel_instance(
        "wf_fused", sampled=sampler_on(camera_sampler_args(fs, cfg)),
        emission=emission_args(fs, cfg, wavefront=True) is not None,
        spawn=spawn_on(cfg, photons=False),
        lights=lights_args(cfg, photons=False) is not None, gleaf=False,
        triangles=fs.triangles is not None and fs.triangles.count > 0),
        spp) == TAIL_KERNEL


def _instance(planned: str, spp: int) -> str:
    """The kernel a uniform launch of ``spp`` samples a pixel runs where
    its plan names ``planned``: tpurt_wf_fused_launch runs ``fused_kernel``
    in place of the tail instance below ``TAIL_MIN_SPP`` samples."""
    if planned == TAIL_KERNEL and spp < TAIL_MIN_SPP:
        return "fused_kernel"
    return planned


def _launch(scene, cfg, camera, state, base_seed, spp: int, aux=None):
    """The kernel on a copy of the state's rgb_sum; ``aux``: the (2, P)
    float32 budgets and counts of budget mode. Returns (rgb_sum, rays
    int64 scalar); adds the launch's (trips, lanes) to ``lane_counts`` and,
    for the tail instance, its (path segments, tail segments) to
    ``tail_counts``."""
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
        plan = launch_plan(fs, cfg, camera, dev, CAMERA)
        launcher = "wf_fused" if aux is None else "wf_fused_budget"
        counters = launch_counters(dev, 5)
        args = (rgb.data_ptr(), rgb.shape[0], cfg.width, cfg.height,
                plan.table.data_ptr(), len(plan.geo.flat_rows),
                len(fs.materials), len(fs.lights),
                int(base_seed) & 0xFFFFFFFF, spp, state.iteration,
                None if aux is None else aux.data_ptr(), cfg.depth,
                cfg.rr_threshold, ctypes.byref(plan.geo_args),
                counters.data_ptr(), plan.cie, ctypes.byref(plan.sampler),
                struct_ref(plan.emission), struct_ref(plan.spawn),
                struct_ref(plan.lights),
                torch.cuda.current_stream(dev).cuda_stream)
    instance = _instance(plan.instances[launcher], spp)
    launch(plan, launcher, args, dev, instance)
    lane_counts(dev).add_(counters[2:4])
    if instance == TAIL_KERNEL:
        tail_counts(dev).add_(counters[3:])
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
