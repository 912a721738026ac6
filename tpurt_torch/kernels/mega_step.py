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
only, ``mega_regen.INSTANCE_LAUNCHES`` them by the instance they ran.
Its lights switches are light_sample "power" or "spatial" alone: tpurt
has no photon_aim here, and ``config.check_slice`` refuses it. Under qmc
the sample's Sobol index is its iteration.
"""

from __future__ import annotations

import torch

from tpurt_torch import integrate, tracing
from tpurt_torch.kernels.mega_regen import (PHOTON, checked_scene, launch,
                                            launch_plan, photon_args)

LAUNCHES = 0


def step_call(scene, cfg, camera, planes: torch.Tensor, base_seed: int,
              iteration: int, radius: float, depth: int) -> torch.Tensor:
    """Advance the (16, P) state planes by one sample in place: the sample
    draws from frame seed (base_seed, iteration), its strata cells from
    that sample's strata seed, and gathers photons within ``radius``.
    Returns the traced segments as an int64 scalar on the planes'
    device."""
    cpu = planes.device.type == "cpu"
    with tracing.span("path.prepare"):
        fs = checked_scene(scene, planes, cfg)
        if not cpu:
            plan = launch_plan(fs, cfg, camera, planes.device, PHOTON)
            # tpurt never runs its G leaf here
            assert plan.geo_args.gmat is None
            counters, args = photon_args(plan, "tile_sync", fs, cfg, planes,
                                         base_seed, 1, iteration, radius,
                                         depth, None)
    if cpu:
        with tracing.span("path.launch"):
            return integrate.render_plain(fs, cfg, camera, planes, base_seed,
                                          1, iteration, radius, depth)
    launch(plan, "tile_sync", args, planes.device)
    return counters[0]
