"""Wrapper of the sweep kernel (``csrc/wavefront_sweep.cu``): one whole
sweep of the wavefront pool in one launch (regeneration, one extend+shade
bounce of every active slot, the splat, the loop's control words and
test), and the ``backend="wavefront_pallas"`` renderer that drives the
pool with it.

``stepper`` is the step hook of ``wavefront.wavefront_render_slab`` and
``adaptive.wavefront_render_budget_slab``: on a CUDA pool each sweep
launches the kernel or raises; on a CPU pool it runs the kernel's plain
version, ``wavefront._step``, which has the same contract. A render
takes its tables and switches from a ``mega_regen.launch_plan`` of kind
``CAMERA`` and builds its launch constants at its first sweep, so a sweep
is one launch and no PyTorch op. ``LAUNCHES`` counts kernel launches only:
one per sweep enqueued, including those past the end of the loop, which
return at once; ``mega_regen.INSTANCE_LAUNCHES`` counts them by the
instance they ran (``mega_regen.kernel_instance``: the sampler, emission,
spawn and lights switches of the fused kernel select the sweep's).
``SWEEP_BATCH`` sweeps are enqueued per read of the loop test: at 1080p,
1 spp, 16 is within 2-12% of 32 and costs at most 15 empty launches at the
end of a render (PERF.md has the measurement).
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch import tracing, wavefront
from tpurt_torch.kernels import mega_regen

LAUNCHES = 0
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
        mega_regen.launch(launch["plan"], "wf_sweep",
                          (*launch["ptrs"], *launch["consts"], stream), dev)
        return pool, rgb, ns, ctl

    return wavefront.PoolStep(step, batch)


def _prepare(fs, cfg, work: wavefront.PoolWork, q: int, dev) -> dict:
    """What every sweep of one render launches with: its plan, the work's
    index tensors on the device, kept alive here, and the launch
    constants that follow the pool's tensors."""
    plan = mega_regen.launch_plan(fs, cfg, work.camera, dev,
                                  mega_regen.CAMERA)
    keep, ptrs = [], {}
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
    consts = (plan.table.data_ptr(), len(plan.geo.flat_rows),
              len(fs.materials), len(fs.lights), ctypes.byref(args),
              ctypes.byref(plan.geo_args), plan.cie,
              ctypes.byref(plan.sampler),
              mega_regen.struct_ref(plan.emission),
              mega_regen.struct_ref(plan.spawn),
              mega_regen.struct_ref(plan.lights))
    return dict(plan=plan, keep=keep, args=args, consts=consts)


def wavefront_render_pallas(scene, cfg, camera, state, base_seed, spp: int):
    """The pool renderer with the sweep kernel (``backend=
    "wavefront_pallas"``): the same work enumeration, streams and ray
    counts as ``wavefront.wavefront_render``."""
    return wavefront.wavefront_render_slab(scene, cfg, camera, state,
                                           base_seed, spp, 0, cfg.n_pixels,
                                           step=stepper)
