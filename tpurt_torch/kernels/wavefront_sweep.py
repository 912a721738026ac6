"""Wrapper of the sweep kernel (``csrc/wavefront_sweep.cu``): one
extend+shade bounce of every slot of the wavefront pool, and the
``backend="wavefront_pallas"`` renderer that drives the pool with it.

On a CUDA tensor ``sweep`` launches the kernel or raises; on a CPU tensor
it runs the kernel's plain version, ``wavefront._sweep``, which has the
same contract. ``LAUNCHES`` counts kernel launches only: one per sweep.
The pool loop around it (regeneration by cumsum ranking, the splat by
``index_add_``) is PyTorch on the device, as tpurt keeps it in XLA around
its TPU kernel.
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch import wavefront
from tpurt_torch.kernels import build, bvh
from tpurt_torch.kernels.mega_regen import CIE_HOST, scene_table

LAUNCHES = 0


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


def sweep(fs, cfg, pool: wavefront.WavefrontPool):
    """One sweep over ``pool`` (left unchanged). Returns (new pool,
    terminated (Q,) bool, traced segments as an int64 scalar on the pool's
    device), as ``wavefront._sweep``."""
    global LAUNCHES
    _check_pool(pool)
    dev = pool.pf.device
    if dev.type == "cpu":
        return wavefront._sweep(fs, cfg, pool)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    pf, pi, rng = (t.contiguous() for t in (pool.pf, pool.pi, pool.rng))
    q = rng.shape[0]
    table, geo = scene_table(fs, cfg, None, dev)
    lib = build.library()
    out = wavefront.WavefrontPool(pf=torch.empty_like(pf),
                                  pi=torch.empty_like(pi),
                                  rng=torch.empty_like(rng))
    term = torch.empty((q,), dtype=torch.bool, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tpurt_wf_sweep_launch(
        pf.data_ptr(), pi.data_ptr(), rng.data_ptr(), out.pf.data_ptr(),
        out.pi.data_ptr(), out.rng.data_ptr(), term.data_ptr(), q,
        table.data_ptr(), len(geo.flat_rows), len(fs.materials),
        len(fs.lights), cfg.depth, cfg.rr_threshold,
        ctypes.byref(geo.args()), rays.data_ptr(),
        CIE_HOST.ctypes.data_as(ctypes.c_void_p), stream)
    build.check_launch(lib, err, "tpurt_wf_sweep_launch")
    LAUNCHES += 1
    bvh.count_walk(geo)
    return out, term, rays


def wavefront_render_pallas(scene, cfg, camera, state, base_seed, spp: int):
    """The pool renderer with the sweep kernel (``backend=
    "wavefront_pallas"``): the same work enumeration, streams and ray
    counts as ``wavefront.wavefront_render``."""
    return wavefront.wavefront_render_slab(scene, cfg, camera, state,
                                           base_seed, spp, 0, cfg.n_pixels,
                                           sweep=sweep)
