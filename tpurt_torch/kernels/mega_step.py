"""Wrapper of the tile-synchronized kernel (``csrc/mega_step.cu``),
``backend="pallas", pallas_regen=False``: one launch advances every pixel
by exactly one sample, at the SPPM radius the host gives it
(``tpurt.kernels.mega_pallas.megakernel_step``); the kernel hashes the
sample's frame seed and strata seed from (base_seed, iteration) as the
regen kernel does, whose body it runs. The host loop that steps the radius
and the sample index between launches is ``render._advance``.

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the kernel's plain PyTorch version, ``integrate.render_plain`` with one
sample, which has the same contract. ``LAUNCHES`` counts kernel launches
only, ``EMIT_LAUNCHES`` those with emission switches
(``mega_regen.emission_args``), ``SPAWN_LAUNCHES`` those with spawn
switches (``spawn_args``) and ``LIGHTS_LAUNCHES`` those with lights
switches (``lights_args``: light_sample "power" or "spatial"; tpurt has no
photon_aim here, and ``config.check_slice`` refuses it), which ran a
lights instance, else a spawn instance where they had spawn switches;
under qmc the sample's Sobol index is its iteration.
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch import integrate, tracing
from tpurt_torch.kernels import build, bvh
from tpurt_torch.kernels.mega_regen import (checked_scene, launch_counters,
                                            launch_plan, struct_ref)

LAUNCHES = 0
EMIT_LAUNCHES = 0
SPAWN_LAUNCHES = 0
LIGHTS_LAUNCHES = 0


def step_call(scene, cfg, camera, planes: torch.Tensor, base_seed: int,
              iteration: int, radius: float, depth: int) -> torch.Tensor:
    """Advance the (16, P) state planes by one sample in place: the sample
    draws from frame seed (base_seed, iteration), its strata cells from
    that sample's strata seed, and gathers photons within ``radius``.
    Returns the traced segments as an int64 scalar on the planes'
    device."""
    global LAUNCHES, EMIT_LAUNCHES, SPAWN_LAUNCHES, LIGHTS_LAUNCHES
    with tracing.span("path.prepare"):
        fs = checked_scene(scene, planes, cfg)
        cpu = planes.device.type == "cpu"
        if not cpu:
            plan = launch_plan(fs, cfg, camera, planes.device)
            # tpurt never runs its G leaf here
            assert plan.geo_args.gmat is None
            counters = launch_counters(planes.device)
            stream = torch.cuda.current_stream(planes.device).cuda_stream
    with tracing.span("path.launch", planes.device):
        if cpu:
            return integrate.render_plain(fs, cfg, camera, planes, base_seed,
                                          1, iteration, radius, depth)
        err = plan.lib.tpurt_step_launch(
            planes.data_ptr(), planes.shape[1], cfg.width, cfg.height,
            plan.table.data_ptr(), len(plan.geo.flat_rows),
            len(fs.materials), len(fs.lights), int(base_seed) & 0xFFFFFFFF,
            iteration, depth, radius, plan.photons, cfg.max_photon_bounces,
            cfg.rr_threshold, cfg.photon_rr_threshold,
            ctypes.byref(plan.sampler), ctypes.byref(plan.geo_args),
            counters.data_ptr(), plan.cie, struct_ref(plan.emission),
            struct_ref(plan.spawn), struct_ref(plan.lights), stream)
        build.check_launch(plan.lib, err, "tpurt_step_launch")
    LAUNCHES += 1
    if plan.spawn is not None:
        SPAWN_LAUNCHES += 1
    if plan.lights is not None:
        LIGHTS_LAUNCHES += 1
    if plan.emission is not None:
        EMIT_LAUNCHES += 1
    bvh.count_walk(plan.geo)
    return counters[0]
