"""Wrapper of the regen kernel (``csrc/mega_regen.cu``): the regenerative
SPPM megakernel that advances every pixel by ``spp`` samples in one launch.

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the kernel's plain PyTorch version, ``integrate.render_plain``, which has
the same contract. ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpurt_torch import integrate
from tpurt_torch.kernels import build, bvh
from tpurt_torch.ops.spectra import CIE_RGB_TABLE
from tpurt_torch.scene import freeze_scene, photon_power, sphere_rows

LAUNCHES = 0

N_CHANNELS = 16
MAX_LIGHTS = 16       # csrc/device.cuh MAX_LIGHTS
CAM_FLOATS = 12
MAT_STRIDE = 8
LIGHT_STRIDE = 40
CIE_HOST = np.ascontiguousarray(CIE_RGB_TABLE, np.float32)


def pack_scene(fs, cfg, camera=None, sph_rows=None) -> np.ndarray:
    """The kernels' float32 parameter table (layout in csrc/device.cuh):
    camera rows (zeros without a camera), then the spheres of the flat
    sweep (``sph_rows``, all of them by default), materials and lights
    with every derived constant computed on the host as the plain version
    computes it."""
    sph = sphere_rows(fs.spheres) if sph_rows is None else sph_rows
    mat = np.zeros((len(fs.materials), MAT_STRIDE), np.float32)
    for i, m in enumerate(fs.materials):
        mat[i, :6] = (*m.color, m.rough, m.ior, m.mtype)
    lit = np.zeros((len(fs.lights), LIGHT_STRIDE), np.float32)
    for i, lt in enumerate(fs.lights):
        lit[i, :35] = (*lt.pos, lt.hw, lt.ltype, lt.temp, lt.two_hw,
                       lt.area_scale, *lt.normal, *lt.tangent, *lt.bitangent,
                       *lt.cone_axis, *lt.cone_t, *lt.cone_b, *lt.em_scale,
                       *lt.ph_origin, *photon_power(lt, cfg.k_photons))
    cam = (np.zeros((4, 3), np.float32) if camera is None
           else camera.rows())
    return np.concatenate([cam.ravel(), sph.ravel(), mat.ravel(),
                           lit.ravel()]).astype(np.float32)


def scene_table(fs, cfg, camera, device):
    """The kernels' inputs on ``device``: the parameter table
    (``pack_scene`` with the spheres of the flat sweep) and the geometry
    tables (``bvh.geometry``). Everything but the camera rows is built
    once per frozen scene and knob set. Raises past the kernels' light
    limit. Returns (table, geometry)."""
    if len(fs.lights) > MAX_LIGHTS:
        raise NotImplementedError(f"the kernels take at most {MAX_LIGHTS} "
                                  f"lights")
    geo = bvh.geometry(fs, cfg)
    key = ("table", cfg.k_photons, bvh.knobs(cfg))
    body = fs.cache.get(key)
    if body is None:
        body = fs.cache[key] = torch.from_numpy(pack_scene(
            fs, cfg, None, geo.flat_rows)[CAM_FLOATS:]).to(device)
    cam = (np.zeros((4, 3), np.float32) if camera is None
           else camera.rows())
    cam = torch.from_numpy(cam.ravel()).to(device)
    return torch.cat([cam, body]), geo


def _check_planes(planes: torch.Tensor, cfg) -> None:
    if planes.dtype != torch.float32 or planes.dim() != 2 \
            or planes.shape[0] != N_CHANNELS or not planes.is_contiguous():
        raise ValueError(f"state planes must be contiguous float32 "
                         f"({N_CHANNELS}, P), got {tuple(planes.shape)} "
                         f"{planes.dtype}")
    if planes.shape[1] < cfg.n_pixels:
        raise ValueError(f"state has {planes.shape[1]} pixels, the image "
                         f"{cfg.n_pixels}")


def regen_call(scene, cfg, camera, planes: torch.Tensor, base_seed: int,
               spp: int, iteration: int, radius: float,
               depth: int) -> torch.Tensor:
    """Advance the (16, P) state planes by ``spp`` samples in place;
    returns the traced segments as an int64 scalar on the planes' device.
    Sample s draws from frame seed (base_seed, iteration + s) and gathers
    photons within ``radius`` after s radius steps."""
    global LAUNCHES
    _check_planes(planes, cfg)
    if scene.device != planes.device:
        raise ValueError(f"scene on {scene.device}, state on {planes.device}")
    fs = freeze_scene(scene)
    if planes.device.type == "cpu":
        return integrate.render_plain(fs, cfg, camera, planes, base_seed,
                                      spp, iteration, radius, depth)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    table, geo = scene_table(fs, cfg, camera, planes.device)
    lib = build.library()
    rays = torch.zeros((), dtype=torch.int64, device=planes.device)
    k = cfg.k_photons if (cfg.enable_photons and fs.lights) else 0
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = lib.tpurt_regen_launch(
        planes.data_ptr(), planes.shape[1], cfg.width, cfg.height,
        table.data_ptr(), len(geo.flat_rows), len(fs.materials),
        len(fs.lights), int(base_seed) & 0xFFFFFFFF, spp, iteration, depth,
        radius, k, cfg.max_photon_bounces, cfg.rr_threshold,
        cfg.photon_rr_threshold, cfg.sppm_alpha, ctypes.byref(geo.args()),
        rays.data_ptr(), CIE_HOST.ctypes.data_as(ctypes.c_void_p), stream)
    build.check_launch(lib, err, "tpurt_regen_launch")
    LAUNCHES += 1
    bvh.count_walk(geo)
    return rays
