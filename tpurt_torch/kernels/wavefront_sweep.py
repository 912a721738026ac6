"""Wrapper of the sweep kernel (``csrc/wavefront_sweep.cu``): one whole
sweep of the wavefront pool in one launch (regeneration, one extend+shade
bounce of every active slot, the splat, the loop's control words and
test), and the ``backend="wavefront_pallas"`` renderer that drives the
pool with it.

``stepper`` is the step hook of ``wavefront.wavefront_render_slab`` and
``adaptive.wavefront_render_budget_slab``: on a CUDA pool each sweep
launches the kernel or raises; on a CPU pool it runs the kernel's plain
version, ``wavefront._step``, which has the same contract. The scene
table, the geometry tables and the launch constants are built once per
render, at the first sweep, so a sweep is one launch and no PyTorch op.
``LAUNCHES`` counts kernel launches only: one per sweep enqueued,
including those past the end of the loop, which return at once;
``SAMPLER_LAUNCHES`` counts those of the sampler instance (hero
wavelengths or camera-path dispersion), ``EMIT_LAUNCHES`` those with
emission switches (the sky, the legacy ramp, an emissive material, the
clamp), ``SPAWN_LAUNCHES`` those with spawn switches (the camera-spawn
extensions, ``mega_regen.spawn_args``), which run a spawn instance: the
reference bounce's with the spawn flags alone, else the one with the
sampler flags and emission too; ``LIGHTS_LAUNCHES`` those with lights
switches (light_sample "power" or "spatial", ``mega_regen.lights_args``),
which run the same pair with the NEE mode. A launch with several counts
in each.
``SWEEP_BATCH`` sweeps are enqueued per read of the loop test: at 1080p,
1 spp, 16 is within 2-12% of 32 and costs at most 15 empty launches at the
end of a render (PERF.md has the measurement).
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch import tracing, wavefront
from tpurt_torch.kernels import build, bvh
from tpurt_torch.kernels.mega_regen import (camera_sampler_args, cie_table,
                                            emission_args, lights_args,
                                            sampler_on, scene_table,
                                            spawn_args, struct_ref)

LAUNCHES = 0
SAMPLER_LAUNCHES = 0
EMIT_LAUNCHES = 0
SPAWN_LAUNCHES = 0
LIGHTS_LAUNCHES = 0
SWEEP_BATCH = 16


class PoolArgs(ctypes.Structure):
    """csrc/wavefront_sweep.cu ``struct PoolWork``, passed by address."""
    _fields_ = [(name, ctypes.c_longlong) for name in (
        "Q", "max_sweeps", "spp", "it0", "pix_offset", "n_valid")] + [
        (name, ctypes.c_void_p) for name in (
            "order", "cum", "base_counts")] + [
        (name, ctypes.c_int) for name in (
            "n_cum", "width", "height", "depth")] + [
        ("rr_thresh", ctypes.c_float), ("base_seed", ctypes.c_uint)]


def _check_pool(pool: wavefront.WavefrontPool) -> None:
    q = pool.rng.shape[0]
    if pool.pf.dtype != torch.float32 or pool.pf.shape != (wavefront.N_F, q) \
            or pool.pi.dtype != torch.int32 or pool.pi.shape != (3, q) \
            or pool.rng.dtype != torch.int64 or pool.rng.dim() != 1:
        raise ValueError(f"pool must be f32 ({wavefront.N_F}, Q), i32 (3, Q), "
                         f"i64 (Q,); got {tuple(pool.pf.shape)} "
                         f"{pool.pf.dtype}, {tuple(pool.pi.shape)} "
                         f"{pool.pi.dtype}, {tuple(pool.rng.shape)} "
                         f"{pool.rng.dtype}")
    if not (pool.pf.device == pool.pi.device == pool.rng.device):
        raise ValueError("pool planes on different devices")


def _check_step(pool, rgb, ns, ctl) -> None:
    """What the kernel updates in place: contiguous, on the pool's CUDA
    device, of the layouts of ``wavefront._step``."""
    _check_pool(pool)
    q = pool.rng.shape[0]
    rows = rgb.shape[0]
    words = wavefront.CTL_WORDS + -(-q // wavefront.POOL_CHUNK)
    if rgb.dtype != torch.float32 or rgb.shape != (rows, 3) \
            or ns.dtype != torch.float32 or ns.shape != (rows,) \
            or ctl.dtype != torch.int64 or ctl.shape != (words,):
        raise ValueError(f"rgb_sum must be f32 (P, 3), n_samples f32 (P,), "
                         f"ctl i64 ({words},); got {tuple(rgb.shape)} "
                         f"{rgb.dtype}, {tuple(ns.shape)} {ns.dtype}, "
                         f"{tuple(ctl.shape)} {ctl.dtype}")
    tensors = (pool.pf, pool.pi, pool.rng, rgb, ns, ctl)
    if any(t.device != pool.pf.device for t in tensors):
        raise ValueError("pool, image and control words on different "
                         "devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the sweep kernel updates its tensors in place: "
                         "they must be contiguous")


def stepper(fs, cfg, work: wavefront.PoolWork,
            batch: int = SWEEP_BATCH) -> wavefront.PoolStep:
    """The step hook of the kernel, as ``wavefront.plain_stepper``: one
    sweep, ``(pool, rgb_sum, n_samples, ctl) -> the same``, ``batch``
    sweeps per read of the loop test. On CUDA tensors the kernel updates
    them in place and the call returns them."""
    plain = wavefront.plain_stepper(fs, cfg, work).sweep
    launch = {}     # built at the first sweep on the card

    def step(pool, rgb, ns, ctl):
        global LAUNCHES, SAMPLER_LAUNCHES, EMIT_LAUNCHES, SPAWN_LAUNCHES, \
            LIGHTS_LAUNCHES
        dev = pool.pf.device
        if dev.type == "cpu":
            with tracing.span("path.launch"):
                return plain(pool, rgb, ns, ctl)
        with tracing.span("path.prepare"):
            if dev.type != "cuda":
                raise ValueError(f"unsupported device {dev}")
            if not launch:
                launch.update(_prepare(fs, cfg, work, pool.rng.shape[0],
                                       dev))
            # a loop passes back what the last sweep returned: checked once
            tensors = (pool.pf, pool.pi, pool.rng, rgb, ns, ctl)
            last = launch.get("last")
            if last is None or any(a is not b for a, b in zip(tensors,
                                                              last)):
                _check_step(pool, rgb, ns, ctl)
                launch["last"] = tensors
                launch["ptrs"] = tuple(t.data_ptr() for t in tensors)
            stream = torch.cuda.current_stream(dev).cuda_stream
        with tracing.span("path.launch", dev):
            err = launch["lib"].tpurt_wf_step_launch(
                *launch["ptrs"], launch["table"], launch["n_sph"],
                launch["n_mat"], launch["n_light"], launch["args_ref"],
                launch["geom_ref"], launch["cie"], launch["sampler_ref"],
                launch["emission_ref"], launch["spawn_ref"],
                launch["lights_ref"], stream)
            build.check_launch(launch["lib"], err, "tpurt_wf_step_launch")
        LAUNCHES += 1
        if launch["spawn"] is not None:
            SPAWN_LAUNCHES += 1
        if launch["lights"] is not None:
            LIGHTS_LAUNCHES += 1
        if launch["emission"] is not None:
            EMIT_LAUNCHES += 1
        elif launch["spawn"] is None and launch["lights"] is None \
                and sampler_on(launch["sampler"]):
            SAMPLER_LAUNCHES += 1
        bvh.count_walk(launch["geo"])
        return pool, rgb, ns, ctl

    return wavefront.PoolStep(step, batch)


def _prepare(fs, cfg, work: wavefront.PoolWork, q: int, dev) -> dict:
    """What every sweep of one render launches with: the tables on the
    device, kept alive here, and the launch constants."""
    table, geo = scene_table(fs, cfg, work.camera, dev)
    geom = geo.args()
    assert geom.gmat is None    # tpurt never runs its G leaf here
    keep = [table]
    ptrs = {}
    for name in ("order", "cum", "base_counts"):
        t = getattr(work, name)
        if t is not None:
            t = t.to(dev, torch.int64).contiguous()
            keep.append(t)
        ptrs[name] = None if t is None else t.data_ptr()
    args = PoolArgs(
        Q=q, max_sweeps=cfg.wf_max_sweeps, spp=work.spp, it0=work.it0,
        pix_offset=work.pix_offset, n_valid=work.n_valid,
        n_cum=0 if work.cum is None else work.cum.shape[0],
        width=cfg.width, height=cfg.height, depth=cfg.depth,
        rr_thresh=cfg.rr_threshold, base_seed=work.base_seed & 0xFFFFFFFF,
        **ptrs)
    sampler = camera_sampler_args(fs, cfg)
    emission = emission_args(fs, cfg, wavefront=True)
    spawn = spawn_args(cfg, work.camera, dev, photons=False)
    lights = lights_args(cfg, photons=False)
    return dict(lib=build.library(), table=table.data_ptr(), keep=keep,
                geo=geo, geom=geom, args=args, geom_ref=ctypes.byref(geom),
                args_ref=ctypes.byref(args), n_sph=len(geo.flat_rows),
                n_mat=len(fs.materials), n_light=len(fs.lights),
                cie=cie_table(dev).data_ptr(), sampler=sampler,
                emission=emission, sampler_ref=ctypes.byref(sampler),
                emission_ref=struct_ref(emission), spawn=spawn,
                spawn_ref=struct_ref(spawn), lights=lights,
                lights_ref=struct_ref(lights))


def wavefront_render_pallas(scene, cfg, camera, state, base_seed, spp: int):
    """The pool renderer with the sweep kernel (``backend=
    "wavefront_pallas"``): the same work enumeration, streams and ray
    counts as ``wavefront.wavefront_render``."""
    return wavefront.wavefront_render_slab(scene, cfg, camera, state,
                                           base_seed, spp, 0, cfg.n_pixels,
                                           step=stepper)
