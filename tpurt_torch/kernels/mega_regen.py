"""Wrappers of the regen kernel (``csrc/mega_regen.cu``): the regenerative
SPPM megakernel that advances every pixel by its samples in one launch.

``regen_call`` is its uniform mode (every pixel ``spp`` samples),
``regen_budget_call`` its budget mode (pixel p ``budgets[p]`` samples from
its own count and radius) and ``render_budget_regen`` the state-level entry
of the budget mode (``tpurt.kernels.mega_regen.render_budget_regen``). On a
CUDA tensor each launches the kernel or raises; on a CPU tensor each runs
the kernel's plain PyTorch version, ``integrate.render_plain`` or
``integrate.render_plain_budget``, which have the same contracts.
``LAUNCHES`` and ``BUDGET_LAUNCHES`` count kernel launches only;
``POOL_LAUNCHES`` counts the uniform launches that ran the pool instance
(``pool_engages``: a scene without triangles, the reference sampler, no
emission, spawn or lights switches), which moves paths between a block's
warps (``csrc/path_pool.cuh``); ``lane_share`` reads the share of its warp
trips' lanes that held a path. ``INSTANCE_LAUNCHES`` counts the launches
of every path launcher by the kernel instance they ran
(``kernel_instance``).

The module also builds what every path kernel reads: the parameter table
(camera, spheres, materials, lights, each light's hero table, then those
of the sky and of the type-3 emission base), the CIE table on the device
(``cie_table``, uploaded once per device), the sampler switches
(``sampler_args``, ``camera_sampler_args``), the emission switches
(``emission_args``), the spawn switches (``spawn_args``: the thin lens,
a MotionCamera's shutter, the Sobol spawn draws with their direction table
on the device, ``sobol_table``, and the photon roulette scale) and the
lights switches (``lights_args``: the NEE mode, the photon aim), which
select the kernels' emission, spawn and lights instances. ``struct_ref``
passes any of them to a launcher. ``launch_plan`` keeps all of these for
a launch of one kind (``PHOTON``: this kernel and the tile-synchronized
one, on the planes; ``CAMERA``: the fused wavefront kernel and the sweep
kernel), per frozen scene, config, camera rows and device, so that a call
builds only its seed, counts, radius, planes and counters (``PLAN_HITS``,
``PLAN_BUILDS``); ``launch`` runs and counts a launch of any of the four
launchers.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import sys

import numpy as np
import torch

from tpurt_torch import integrate, tracing
from tpurt_torch.camera import MotionCamera, motion_rows
from tpurt_torch.kernels import build, bvh
from tpurt_torch.ops import qmc
from tpurt_torch.ops import rng as rngmod
from tpurt_torch.ops import sampling
from tpurt_torch.ops.spectra import (CIE_RGB_TABLE, VISIBLE_RANGE,
                                     hero_segments, sky_on)
from tpurt_torch.scene import freeze_scene, photon_power, sphere_rows

LAUNCHES = 0
BUDGET_LAUNCHES = 0
POOL_LAUNCHES = 0
# (launcher, kernel_instance) -> launches; the launchers are LAUNCHERS'
INSTANCE_LAUNCHES = collections.Counter()
PLAN_HITS = 0      # launch_plan calls that found their plan kept
PLAN_BUILDS = 0    # launch_plan calls that built one

PLAN_LIMIT = 4     # plans kept per frozen scene, the least recent leaving
PHOTON = "photon"  # plan kinds: the regen and tile-synchronized kernels,
CAMERA = "camera"  # the fused wavefront and sweep kernels
# launcher -> its plan kind, its C function and its total launch count
# (module of tpurt_torch.kernels, attribute)
LAUNCHERS = {
    "regen": (PHOTON, "tpurt_regen_launch", "mega_regen", "LAUNCHES"),
    "regen_budget": (PHOTON, "tpurt_regen_launch", "mega_regen",
                     "BUDGET_LAUNCHES"),
    "tile_sync": (PHOTON, "tpurt_step_launch", "mega_step", "LAUNCHES"),
    "wf_fused": (CAMERA, "tpurt_wf_fused_launch", "wavefront_fused",
                 "LAUNCHES"),
    "wf_fused_budget": (CAMERA, "tpurt_wf_fused_launch", "wavefront_fused",
                        "LAUNCHES"),
    "wf_sweep": (CAMERA, "tpurt_wf_step_launch", "wavefront_sweep",
                 "LAUNCHES"),
}
POOL_KERNEL = "regen_pool_kernel"
TAIL_KERNEL = "fused_tail_kernel"
TAIL_MIN_SPP = 8   # the fewest samples a pixel of a uniform fused launch
                   # the tail instance takes (csrc/fused_tail.cuh)
N_CHANNELS = 16
CAM_FLOATS = 12
MAT_STRIDE = 8
LIGHT_STRIDE = 40
_CIE = {}     # device -> the (81, 3) float32 CIE table on it
_SOBOL = {}   # device -> the (N_DIMS, 32) Sobol direction numbers on it
_LANES = {}   # device -> int64 (warp trips, lanes that held a path) of the
              # pool launches on it, added to by every such launch


def per_device(cache: dict, device, make) -> torch.Tensor:
    """``cache``'s tensor on ``device`` (a bare "cuda" is the current
    card): ``make()`` moved there on the first call, then kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    tab = cache.get(device)
    if tab is None:
        tab = cache[device] = make().to(device)
    return tab


def cie_table(device) -> torch.Tensor:
    """The CIE table the kernels read, on ``device``: uploaded on the
    first call, then kept."""
    return per_device(_CIE, device, lambda: torch.from_numpy(
        np.ascontiguousarray(CIE_RGB_TABLE, np.float32)))


def sobol_table(device) -> torch.Tensor:
    """``ops.qmc.DIRECTIONS`` as the kernels read it (int32 bits of the
    uint32 words), on ``device``: uploaded on the first call, then
    kept."""
    return per_device(_SOBOL, device, lambda: torch.from_numpy(
        np.ascontiguousarray(qmc.DIRECTIONS).view(np.int32)))


def lane_counts(device) -> torch.Tensor:
    """The pool instance's (trips, lanes) accumulator on ``device``: made
    on the first call, then kept; every pool launch adds to it."""
    return per_device(_LANES, device, lambda: torch.zeros(
        (2,), dtype=torch.int64))


def lane_share():
    """The lanes that held a path over 32 times the warp trips, summed
    over every pool launch of the process (a fraction; reads the device,
    so it waits for the launches), or None if none ran."""
    if not POOL_LAUNCHES:
        return None
    trips, lanes = (int(x) for x in sum(t.cpu() for t in _LANES.values()))
    return lanes / (32 * trips) if trips else None


class SamplerArgs(ctypes.Structure):
    """csrc/device.cuh ``struct Sampler``, passed to the path launchers by
    address."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n_pos", "n_dir", "shared_k", "window", "photon_bounce",
        "camera_bounce", "disp_cam", "hero", "hero_nseg")] + [
        ("hero_delta", ctypes.c_float), ("collapse", ctypes.c_int)]


def sampler_args(fs, cfg) -> SamplerArgs:
    """The sampler switches of cfg as the kernels read them: the strata
    counts (n_pos 0 with photon_strata off), epoch window, bounce-cell and
    dispersion switches, the hero count and its table geometry."""
    on = bool(cfg.photon_strata)
    n_pos, n_dir = rngmod.strata_counts(cfg) if on else (0, 0)
    c = integrate.hero_count(cfg)
    return SamplerArgs(
        n_pos=n_pos, n_dir=n_dir, shared_k=int(cfg.photon_strata_shared_k),
        window=max(1, int(cfg.photon_strata_window)) if on else 1,
        photon_bounce=int(on and cfg.photon_strata_bounce),
        camera_bounce=int(on and cfg.camera_strata_bounce),
        disp_cam=int(cfg.dispersion_in_camera_path), hero=c,
        hero_nseg=hero_segments(c),
        hero_delta=float(np.float32(VISIBLE_RANGE / c)),
        collapse=int(integrate.tracks_collapse(fs, cfg)))


def sampler_on(args: SamplerArgs) -> bool:
    """Whether a launch takes a kernel's sampler instance
    (csrc/device.cuh sampler_on)."""
    return args.n_pos > 0 or args.hero > 1 or bool(args.disp_cam)


def camera_sampler_args(fs, cfg) -> SamplerArgs:
    """The sampler switches of the wavefront kernels: hero wavelengths,
    camera-path dispersion and the collapse; the photon strata are off
    (no photons) and camera strata are rejected before a launch."""
    c = integrate.hero_count(cfg)
    return SamplerArgs(
        n_pos=0, n_dir=0, shared_k=0, window=1, photon_bounce=0,
        camera_bounce=0, disp_cam=int(cfg.dispersion_in_camera_path),
        hero=c, hero_nseg=hero_segments(c),
        hero_delta=float(np.float32(VISIBLE_RANGE / c)),
        collapse=int(integrate.tracks_collapse(fs, cfg)))


class EmissionArgs(ctypes.Structure):
    """csrc/device.cuh ``struct Emission``, passed by address."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "sky", "gradient", "legacy")] + [
        (name, ctypes.c_float) for name in (
            "sky_k", "sky_temp", "sky_r", "sky_g", "sky_b", "clamp")]


def emission_args(fs, cfg, wavefront: bool = False):
    """The emission switches of a launch (``integrate.emission_on``;
    ``wavefront``: the wavefront kernels, which also take the legacy sky
    ramp), or None: the launch runs an instance without emission."""
    if not integrate.emission_on(fs, cfg, wavefront):
        return None
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    on = sky_on(cfg)
    return EmissionArgs(
        sky=int(on), gradient=int(bool(cfg.sky_gradient)),
        legacy=int(wavefront and not on and bool(cfg.sky_gradient)),
        sky_k=f32(cfg.sky_intensity * VISIBLE_RANGE),
        sky_temp=f32(cfg.sky_temp), sky_r=f32(cfg.sky_color[0]),
        sky_g=f32(cfg.sky_color[1]), sky_b=f32(cfg.sky_color[2]),
        clamp=f32(cfg.radiance_clamp))


def struct_ref(args):
    """A launch's pointer argument for a switch struct or None
    (``emission_args``', ``spawn_args``', ``lights_args``' result): NULL
    for None."""
    return None if args is None else ctypes.byref(args)


class LightsArgs(ctypes.Structure):
    """csrc/device.cuh ``struct Lights``, passed by address."""
    _fields_ = [("mode", ctypes.c_int), ("q", ctypes.c_float),
                ("widen", ctypes.c_float)]


LIGHT_MODES = {"all": 0, "power": 1, "spatial": 2}


def lights_args(cfg, photons: bool = True):
    """The lights switches of a launch, or None: the launch runs an
    instance without them. The NEE mode of ``light_sample`` and, where
    photons walk (``photons``), photon_aim's q and f32(photon_aim_widen)
    (q 0: no aim)."""
    aim = photons and cfg.photon_aim > 0.0
    if cfg.light_sample == "all" and not aim:
        return None
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return LightsArgs(mode=LIGHT_MODES[cfg.light_sample],
                      q=f32(cfg.photon_aim) if aim else 0.0,
                      widen=f32(cfg.photon_aim_widen) if aim else 0.0)


class SpawnArgs(ctypes.Structure):
    """csrc/device.cuh ``struct Spawn``, passed by address."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "qmc", "motion", "lens")] + [
        (name, ctypes.c_float) for name in (
            "lens_r", "lens_finv", "rr_scale")] + [
        ("dcam", ctypes.c_float * 12), ("sobol", ctypes.c_void_p)]


def spawn_on(cfg, photons: bool = True) -> bool:
    """Whether a launch takes the spawn switches: the Sobol spawn, the
    shutter, the lens or, where it walks photons, a photon roulette
    scale."""
    return bool(cfg.qmc or cfg.motion_blur or cfg.aperture > 0.0
                or (photons and cfg.photon_rr_scale != 1.0))


def spawn_args(cfg, camera, device, photons: bool = True):
    """The spawn switches of a launch, or None: the launch runs an
    instance without them. ``photons`` False: a camera-path kernel, which
    a photon roulette scale alone leaves on its instance without them
    (the scale is then 1). The lens radius f32(0.5 * aperture) and
    f32(1 / focus_dist), as ``camera.lens_perturb_c`` rounds them; a
    MotionCamera's shutter-close deltas (``camera.motion_rows`` rows 4-7;
    the parameter table holds rows 0-3); the photon roulette scale."""
    if not spawn_on(cfg, photons):
        return None
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    lens = cfg.aperture > 0.0
    if lens and cfg.focus_dist <= 0.0:
        raise ValueError("aperture > 0 requires focus_dist > 0 "
                         "(the sharp-plane distance; see RenderConfig)")
    dcam = (motion_rows(camera)[4:].ravel()
            if isinstance(camera, MotionCamera) else np.zeros(12))
    return SpawnArgs(
        qmc=int(cfg.qmc), motion=int(cfg.motion_blur), lens=int(lens),
        lens_r=f32(0.5 * cfg.aperture),
        lens_finv=f32(1.0 / cfg.focus_dist) if lens else 0.0,
        rr_scale=f32(cfg.photon_rr_scale) if photons else 1.0,
        dcam=(ctypes.c_float * 12)(*(float(x) for x in dcam)),
        sobol=sobol_table(device).data_ptr())


def pack_scene(fs, cfg, camera=None, sph_rows=None) -> np.ndarray:
    """The kernels' float32 parameter table (layout in csrc/device.cuh):
    camera rows (zeros without a camera), then the spheres of the flat
    sweep (``sph_rows``, all of them by default), materials and lights
    with every derived constant computed on the host as the plain version
    computes it (a light's selection power ``ops.sampling.light_power``
    among them), then, with hero_wavelengths C > 1, each light's hero
    table (``integrate.hero_tables``) and, where the sky is on or the scene
    has an emissive material, the sky's and the emission base's
    (``integrate.emission_tables``)."""
    sph = sphere_rows(fs.spheres) if sph_rows is None else sph_rows
    mat = np.zeros((len(fs.materials), MAT_STRIDE), np.float32)
    for i, m in enumerate(fs.materials):
        mat[i, :6] = (*m.color, m.rough, m.ior, m.mtype)
    lit = np.zeros((len(fs.lights), LIGHT_STRIDE), np.float32)
    for i, lt in enumerate(fs.lights):
        lit[i, :36] = (*lt.pos, lt.hw, lt.ltype, lt.temp, lt.two_hw,
                       lt.area_scale, *lt.normal, *lt.tangent, *lt.bitangent,
                       *lt.cone_axis, *lt.cone_t, *lt.cone_b, *lt.em_scale,
                       *lt.ph_origin, *photon_power(lt, cfg.k_photons),
                       sampling.light_power(lt))
    cam = (np.zeros((4, 3), np.float32) if camera is None
           else camera.rows())
    c = integrate.hero_count(cfg)
    hero = [t.ravel() for t in integrate.hero_tables(fs, c)] if c > 1 else []
    if c > 1 and (sky_on(cfg) or integrate.any_emitter(fs)):
        hero += [t.ravel() for t in integrate.emission_tables(fs, cfg, c)]
    return np.concatenate([cam.ravel(), sph.ravel(), mat.ravel(),
                           lit.ravel(), *hero]).astype(np.float32)


def scene_table(fs, cfg, camera, device):
    """The kernels' inputs on ``device``: the parameter table
    (``pack_scene`` with the spheres of the flat sweep) and the geometry
    tables (``bvh.geometry``). Everything but the camera rows is built
    once per frozen scene, knob set, hero count and sky; a light is a row, so
    the kernels take any number (past the shared-memory budget of
    ``path.cuh staged_floats`` they read the rows from global memory).
    Returns (table, geometry)."""
    geo = bvh.geometry(fs, cfg)
    key = ("table", cfg.k_photons, integrate.hero_count(cfg),
           float(cfg.sky_intensity), float(cfg.sky_temp), bvh.knobs(cfg))
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


def photon_count(fs, cfg) -> int:
    """K as the kernels take it: 0 with photons off or no light."""
    return cfg.k_photons if (cfg.enable_photons and fs.lights) else 0


def checked_scene(scene, planes: torch.Tensor, cfg):
    """The frozen scene of a path kernel's call, after checking the planes
    and that scene and planes share a CPU or CUDA device."""
    _check_planes(planes, cfg)
    if scene.device != planes.device:
        raise ValueError(f"scene on {scene.device}, state on {planes.device}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {planes.device}")
    return freeze_scene(scene)


def launch_counters(device, words: int = 2) -> torch.Tensor:
    """The int64 words a path launch takes: [0] the traced segments, [1]
    the counter its lanes fetch their pixels from, and a fused launch's
    [2], [3] and [4] (``words`` 5), its warps' trips, the lanes that traced
    a segment in them and, in the tail instance, its tail segments (of
    paths that went on after their warp moved on). Fresh zeros, made on
    the current stream, so launches back to back on one stream each start
    from 0."""
    return torch.zeros((words,), dtype=torch.int64, device=device)


def kernel_instance(launcher: str, *, sampled: bool, emission: bool,
                    spawn: bool, lights: bool, gleaf: bool,
                    triangles: bool) -> str:
    """The kernel a launch of ``launcher`` (a key of ``LAUNCHERS``) runs,
    named as the profiler shows it less its namespace and arguments. The
    rule of the C launchers, in their order: csrc/mega_regen.cu
    ``tpurt_regen_launch`` and csrc/mega_step.cu ``tpurt_step_launch``
    with the ``launch_lights``, ``launch_spawn`` and ``launch_emit`` they
    call (csrc/path_lights.cu, path_spawn.cu, path_emit.cu),
    csrc/wavefront_fused.cu ``tpurt_wf_fused_launch`` and
    csrc/wavefront_sweep.cu ``tpurt_wf_step_launch``: lights switches,
    then spawn switches, then emission switches, then the pool (a uniform
    regen launch without triangle rows) or the tail instance (a uniform
    fused launch; the launcher runs it at ``TAIL_MIN_SPP`` samples a pixel
    or more, ``fused_kernel`` below, so a plan names the instance of such
    a launch), then the sampler or the reference instance. ``sampled``: ``sampler_on``; the lights and spawn
    instances
    take their full body where emission or the sampler is on; ``gleaf``:
    the G-matrix leaf test of the photon kernels."""
    b = lambda x: "true" if x else "false"  # noqa: E731
    full = b(emission or sampled)
    if launcher in ("wf_fused", "wf_fused_budget"):
        if lights:
            return f"fused_lights_kernel<{full}>"
        if spawn:
            return f"fused_spawn_kernel<{full}>"
        if emission or sampled:
            return f"fused_sampler_kernel<{b(emission)}>"
        if launcher == "wf_fused":
            return TAIL_KERNEL
        return "fused_kernel"
    if launcher == "wf_sweep":
        if lights or spawn:
            pack = "Spawn, Lights" if lights else "Spawn"
            return (f"pool_step_kernel<{full}, {full}, Sampler, Emission, "
                    f"{pack}>")
        if not (emission or sampled):
            return "pool_step_kernel<false, false>"
        return f"pool_step_kernel<true, {b(emission)}, Sampler, Emission>"
    if lights:
        return f"regen_lights_kernel<{full}, {b(gleaf)}>"
    if spawn:
        return f"regen_spawn_kernel<{full}, {b(gleaf)}>"
    if emission:
        return f"regen_emit_kernel<{b(gleaf)}>"
    if launcher == "tile_sync":
        return f"step_kernel<{b(sampled)}>"
    if launcher == "regen" and not sampled and not triangles:
        return POOL_KERNEL
    return f"regen_kernel<{b(sampled)}, {b(gleaf)}>"


def pool_engages(fs, cfg, uniform: bool = True) -> bool:
    """Whether a regen launch runs the pool instance (``kernel_instance``
    on the switches ``build_plan`` gives it): a uniform launch
    (``uniform``; budget launches never) on a scene without triangles,
    under the reference sampler, without emission, spawn or lights
    switches."""
    return kernel_instance(
        "regen" if uniform else "regen_budget",
        sampled=sampler_on(sampler_args(fs, cfg)),
        emission=emission_args(fs, cfg) is not None, spawn=spawn_on(cfg),
        lights=lights_args(cfg, photon_count(fs, cfg) > 0) is not None,
        gleaf=bvh.mxu_leaf_engages(fs, cfg),
        triangles=fs.triangles is not None and fs.triangles.count > 0,
    ) == POOL_KERNEL


def regen_tri_mode(fs, cfg) -> integrate.TriMode:
    """The regen kernel's closest-hit triangle test: tpurt's G-matrix leaf
    over ``bvh.gmat`` where ``bvh.mxu_leaf_engages``, else the exact one.
    Raises on the G leaf without a leaf cap, as tpurt asserts."""
    if not bvh.mxu_leaf_engages(fs, cfg):
        return integrate.EXACT
    if cfg.pallas_bvh_leaf <= 0:
        raise ValueError("pallas_mxu_leaf needs pallas_bvh_leaf > 0: tpurt's "
                         "G-matrix leaf test has no dynamic-count form")
    return integrate.TriMode("gleaf", bvh.gmat(fs, cfg))


@dataclasses.dataclass(frozen=True, eq=False)
class LaunchPlan:
    """What a launch of one kind (``PHOTON``: the regen kernel in either
    mode and the tile-synchronized kernel, on the (16, P) planes;
    ``CAMERA``: the fused wavefront and the sweep kernels) takes that
    depends only on the frozen scene, the config, the camera's rows and
    the device: built by ``launch_plan``, read by every launch that
    matches it."""
    table: torch.Tensor             # parameter table, camera rows first
    geo: bvh.Geometry               # geometry tables
    tri: integrate.TriMode          # closest-hit triangle test
    geo_args: bvh.GeomArgs          # geo.args(tri.gmat)
    sampler: SamplerArgs
    emission: EmissionArgs | None
    spawn: SpawnArgs | None
    lights: LightsArgs | None
    photons: int                    # photon_count; 0 for CAMERA
    cie: int                        # address of cie_table on the device
    lib: ctypes.CDLL | None         # the kernel library; None on the CPU
    lanes: int                      # address of lane_counts on the device
    instances: dict                 # launcher of the kind -> its kernel
                                    # (kernel_instance)


def camera_key(camera) -> bytes:
    """The bytes of the camera rows a plan depends on: a MotionCamera's
    both poses (the table holds the shutter-open rows, the spawn switches
    the deltas to shutter close), a Camera's four rows, none without a
    camera."""
    if camera is None:
        return b""
    poses = ((camera.cam0, camera.cam1) if isinstance(camera, MotionCamera)
             else (camera,))
    return b"".join(t.numpy(force=True).tobytes() for c in poses
                    for t in (c.origin, c.horizontal, c.vertical,
                              c.lower_left))


def build_plan(fs, cfg, camera, device, kind: str) -> LaunchPlan:
    """A fresh ``LaunchPlan`` of ``kind`` (``PHOTON`` or ``CAMERA``), on
    any device (the library only on the card). Raises what the triangle
    test and the spawn switches raise."""
    device = torch.device(device)
    if kind == PHOTON:
        tri = regen_tri_mode(fs, cfg)
        k = photon_count(fs, cfg)
        sampler, emission = sampler_args(fs, cfg), emission_args(fs, cfg)
        spawn, lights = spawn_args(cfg, camera, device), lights_args(cfg,
                                                                      k > 0)
    else:
        # no photons, and tpurt never runs its G leaf on camera paths
        tri, k = integrate.EXACT, 0
        sampler = camera_sampler_args(fs, cfg)
        emission = emission_args(fs, cfg, wavefront=True)
        spawn = spawn_args(cfg, camera, device, photons=False)
        lights = lights_args(cfg, photons=False)
    table, geo = scene_table(fs, cfg, camera, device)
    geo_args = geo.args(tri.gmat)
    instances = {launcher: kernel_instance(
        launcher, sampled=sampler_on(sampler), emission=emission is not None,
        spawn=spawn is not None, lights=lights is not None,
        gleaf=tri.gmat is not None, triangles=geo_args.n_tri > 0)
        for launcher, (of, *_) in LAUNCHERS.items() if of == kind}
    return LaunchPlan(
        table=table, geo=geo, tri=tri, geo_args=geo_args, sampler=sampler,
        emission=emission, spawn=spawn, lights=lights, photons=k,
        cie=cie_table(device).data_ptr(),
        lib=build.library() if device.type == "cuda" else None,
        lanes=lane_counts(device).data_ptr(), instances=instances)


def launch_plan(fs, cfg, camera, device, kind: str) -> LaunchPlan:
    """The ``LaunchPlan`` of a launch of ``kind``: built on the first call
    for this kind, frozen scene, config, camera rows and device
    (``PLAN_BUILDS``), then kept on the frozen scene, which holds the
    ``PLAN_LIMIT`` plans used last (``PLAN_HITS``). A moving camera builds
    anew on the cached body of the table (``scene_table``). The key holds
    the inputs, not the functions that build the plan from them: code that
    replaces one of them (a test's patch, an A/B's forced switch) drops
    the kept plans, ``fs.cache.pop("plans", None)``, before and after."""
    global PLAN_HITS, PLAN_BUILDS
    device = torch.device(device)
    plans = fs.cache.get("plans")
    if plans is None:
        plans = fs.cache["plans"] = collections.OrderedDict()
    key = (kind, cfg, device, camera_key(camera))
    plan = plans.get(key)
    if plan is not None:
        plans.move_to_end(key)
        PLAN_HITS += 1
        return plan
    plan = plans[key] = build_plan(fs, cfg, camera, device, kind)
    if len(plans) > PLAN_LIMIT:
        plans.popitem(last=False)
    PLAN_BUILDS += 1
    return plan


def photon_args(plan: LaunchPlan, launcher: str, fs, cfg, planes,
                base_seed: int, spp: int, iteration: int, radius: float,
                depth: int, aux) -> tuple:
    """The counters (``launch_counters``) and the argument list of a
    ``PHOTON`` launch on the planes: ``tpurt_regen_launch``'s, or for
    ``launcher`` "tile_sync" ``tpurt_step_launch``'s (one sample, so no
    ``spp``, SPPM alpha, budget rows or lane counter). ``aux``: None or
    the (3, P) budget rows of budget mode."""
    counters = launch_counters(planes.device)
    head = (planes.data_ptr(), planes.shape[1], cfg.width, cfg.height,
            plan.table.data_ptr(), len(plan.geo.flat_rows),
            len(fs.materials), len(fs.lights), int(base_seed) & 0xFFFFFFFF)
    walk = (depth, radius, plan.photons, cfg.max_photon_bounces,
            cfg.rr_threshold, cfg.photon_rr_threshold)
    tail = (counters.data_ptr(), plan.cie, struct_ref(plan.emission),
            struct_ref(plan.spawn), struct_ref(plan.lights))
    sampler, geom = ctypes.byref(plan.sampler), ctypes.byref(plan.geo_args)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    if launcher == "tile_sync":
        return counters, (*head, iteration, *walk, sampler, geom, *tail,
                          stream)
    return counters, (*head, spp, iteration, *walk, cfg.sppm_alpha, sampler,
                      None if aux is None else aux.data_ptr(), geom, *tail,
                      plan.lanes, stream)


def launch(plan: LaunchPlan, launcher: str, args: tuple, device,
           instance: str | None = None) -> None:
    """Run ``launcher``'s C function on ``args`` in the ``path.launch``
    span, raise its error, and count the launch: its instance (the plan's,
    or ``instance`` where the launch's own input picks it) in
    ``INSTANCE_LAUNCHES`` (and ``POOL_LAUNCHES``), ``bvh.count_walk`` and
    the launcher's total."""
    global POOL_LAUNCHES
    _, fn, module, total = LAUNCHERS[launcher]
    with tracing.span("path.launch", device):
        err = getattr(plan.lib, fn)(*args)
    build.check_launch(plan.lib, err, fn)
    instance = instance or plan.instances[launcher]
    INSTANCE_LAUNCHES[launcher, instance] += 1
    if instance == POOL_KERNEL:
        POOL_LAUNCHES += 1
    bvh.count_walk(plan.geo)
    mod = sys.modules[f"tpurt_torch.kernels.{module}"]
    setattr(mod, total, getattr(mod, total) + 1)


def regen_call(scene, cfg, camera, planes: torch.Tensor, base_seed: int,
               spp: int, iteration: int, radius: float,
               depth: int) -> torch.Tensor:
    """Advance the (16, P) state planes by ``spp`` samples in place;
    returns the traced segments as an int64 scalar on the planes' device.
    Sample s draws from frame seed (base_seed, iteration + s) and gathers
    photons within ``radius`` after s radius steps."""
    cpu = planes.device.type == "cpu"
    with tracing.span("path.prepare"):
        fs = checked_scene(scene, planes, cfg)
        if cpu:
            tri = regen_tri_mode(fs, cfg)
        else:
            plan = launch_plan(fs, cfg, camera, planes.device, PHOTON)
            counters, args = photon_args(plan, "regen", fs, cfg, planes,
                                         base_seed, spp, iteration, radius,
                                         depth, None)
    if cpu:
        with tracing.span("path.launch"):
            return integrate.render_plain(fs, cfg, camera, planes,
                                          base_seed, spp, iteration, radius,
                                          depth, tri)
    launch(plan, "regen", args, planes.device)
    return counters[0]


def regen_budget_call(scene, cfg, camera, planes: torch.Tensor,
                      base_seed: int, budgets: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """The budget mode on the (16, P) planes, in place: pixel p renders
    ``budgets[p]`` samples (integers, 0 on pad rows) continuing from its
    count ``counts[p]`` (the state's n_samples), with its own frame seeds,
    strata epochs and SPPM radius (``integrate.render_plain_budget``).
    Returns the traced segments as an int64 scalar."""
    cpu = planes.device.type == "cpu"
    with tracing.span("path.prepare"):
        fs = checked_scene(scene, planes, cfg)
        P = planes.shape[1]
        if budgets.shape != (P,) or counts.shape != (P,):
            raise ValueError(f"budgets {tuple(budgets.shape)} and counts "
                             f"{tuple(counts.shape)} must be ({P},)")
        if cpu:
            tri = regen_tri_mode(fs, cfg)
        else:
            plan = launch_plan(fs, cfg, camera, planes.device, PHOTON)
            cnt = counts.to(planes.device).long()
            radii = torch.from_numpy(integrate.radius_table(
                cfg, int(cnt.max()) if P else 0)).to(planes.device)[cnt]
            aux = torch.stack([budgets.to(planes.device).to(torch.float32),
                               counts.to(planes.device).to(torch.float32),
                               radii]).contiguous()
            counters, args = photon_args(plan, "regen_budget", fs, cfg,
                                         planes, base_seed, 0, 0, 0.0,
                                         cfg.depth, aux)
    if cpu:
        with tracing.span("path.launch"):
            return integrate.render_plain_budget(fs, cfg, camera, planes,
                                                 base_seed, budgets, counts,
                                                 tri)
    launch(plan, "regen_budget", args, planes.device)
    return counters[0]


def render_budget_regen(scene, cfg, camera, state, base_seed, budgets,
                        max_budget: int):
    """Render ``budgets[p]`` more samples for every pixel p through the
    regen kernel's budget mode (adaptive sampling with photons): budgets
    are clipped to [0, max_budget] and 0 on the pad rows; n_samples grows
    by them, ``iteration`` by max_budget, and the scalar radius follows the
    uniform schedule over max_budget samples (per-pixel radii come from
    n_samples, so chained calls stay exact). A uniform budget equals
    ``render`` bit for bit, two chained calls one combined call."""
    from tpurt_torch import adaptive
    from tpurt_torch.render import (_check_call, plane_fields, radius_after,
                                    state_to_planes)
    _check_call(scene, cfg, camera, state, cfg.depth)
    if budgets.shape != state.n_samples.shape:
        raise ValueError(f"budgets {tuple(budgets.shape)} do not match the "
                         f"state's {tuple(state.n_samples.shape)} rows")
    max_budget = int(max_budget)
    budgets = adaptive.clip_budgets(cfg, budgets.to(state.device),
                                    max_budget)
    planes = state_to_planes(state)
    rays = regen_budget_call(scene, cfg, camera, planes, int(base_seed),
                             budgets, state.n_samples)
    return dataclasses.replace(
        state, **plane_fields(planes),
        n_samples=state.n_samples + budgets.float(),
        iteration=state.iteration + max_budget,
        photon_radius=radius_after(cfg, state.iteration, state.photon_radius,
                                   max_budget),
        rays=state.rays + rays if cfg.count_rays else state.rays)
