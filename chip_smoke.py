"""Smoke test of tpurt_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, then drives the main paths
through ``tpurt_torch.render`` and ``resolve_image``: Cornell spheres at
1920x1080, depth 30, photons on, with ``backend="pallas"`` (the regen
kernel) and with ``pallas_regen=False`` (the tile-synchronized kernel);
``render_adaptive`` on Cornell at 1080p (the regen kernel's budget mode);
the dispersive scene at 1920x1080, depth 30, with
``backend="wavefront_pallas"`` (the sweep kernel) and with tpurt's bench
config 5, ``backend="wavefront_fused"`` (the fused kernel); tpurt's bench
config 6 as tpurt ships it (the 4050-triangle torus mesh, its photon,
bounce and camera strata and 4 hero wavelengths) at 1920x1080, depth 30,
through the regen kernel's BVH walk (csrc/bvh.cuh), beside the same scene
with the reference sampler; bench config 4 (hero wavelengths with the
dispersive collapse); the 64,800-triangle torus field and the
16,384-sphere instanced scene at 1 spp; and config 6's scene with
``pallas_mxu_leaf`` (tpurt's G-matrix leaf test in the regen kernel's
walk), with both samplers. The regen and tile-sync kernels run one body,
persistent blocks whose lanes fetch their pixels from a device counter
(csrc/path.cuh run_pixels); their phases also hold it on a size that is no
multiple of the block (50x30), on budget maps with long runs of zeros, and
on launches back to back on one stream.

The phases: [blit] (also its device time under torch.profiler against its
bound), [regen] (the regen kernel against its plain version),
[sampler] (the regen kernel with the sampler flags of bench configs 3, 4
and 6, every state plane bit for bit, config 6 at 1080p), [budget] (the
budget mode against ``render_plain_budget``, then ``render_adaptive``),
[tile-sync] (the
tile-synchronized kernel against ``render_plain`` and against the regen
kernel, then its 1080p path), [wf-sweep] (one whole sweep of the pool,
claim, bounce, splat and control words, against ``wavefront._step``),
[wf-pool], [wf-fused] (also against the regen kernel with photons off),
[wf-budget], [wf-pallas] (the 1080p path: sweeps, host reads, wall time
by sweeps per read), [config5], [wf-fused-tail] (the fused kernel's tail
instance, which uniform launches of ``TAIL_MIN_SPP`` samples a pixel or
more on config 5 run: against the plain pool and the regen kernel with
photons off at 1080p, its device time at that many samples and at 64,
and config 5 through the public entry points), [many-lights] (tpurt's
many-light scene with 20 lights, its rows in shared memory, and 128,
past that budget: the regen, fused and sweep kernels against their plain
versions), [wf-hero]
(bench config 4's hero wavelengths and dispersion on config 5's scene and
pool: the sweep and fused kernels' sampler instances, 4 spp, a budget
launch and wavefront_pallas at 1080p against their plain versions),
[emission] (an emitter added to the dispersive scene, the sky with its
blackbody and ramp and the radiance clamp, with config 4's flags: the
emission instances of the regen (uniform, budget; also with the G leaf),
tile-sync, fused and sweep kernels at 1080p against their plain
versions, the reference sampler and the legacy ramp at 256x144; every new
launch timed beside the same launch without the flags), [spawn] (tpurt's
"quality" and "fast" presets and the Sobol spawn with a thin lens and a
MotionCamera's shutter on Cornell: the spawn instances of the regen
(uniform, budget), tile-sync, fused and sweep kernels against their plain
versions at 256x144 and 1080p, each 1080p launch timed beside the same
launch without the flags, fast held to fewer segments than quality),
[lights] (tpurt's many-light NEE, light_sample "power" and "spatial", on
tpurt's many-light scene with 20 lights, rows staged, and 128, rows in
global memory: the lights instances of the regen (uniform, budget),
tile-sync, fused and sweep kernels against their plain versions at
256x144 and 1080p, each 1080p regen launch's segments and device ms
beside light_sample "all", then the main paths and render_adaptive),
[aim] (photon_aim 0.5 on Cornell at 1080p, K 4: the regen kernel's
lights instance, uniform and budget, against its plain versions, timed
beside photon_aim 0; the main path and render_adaptive),
[bvh-walk],
[mesh-regen], [mesh-wf],
[mesh] (config 6 with the reference sampler), [config6] (config 6 as
shipped), [config4], [mesh-field], [mesh-instanced], [mxu-leaf] (the
probe's warp G leaf against the plain G sweep on random rays, a count no
multiple of 32, leaf 128, the wide tree, rays that all reach one leaf,
config 6's 1080p pinhole rays and NaN-plane rays; its pairs tested on the
torus at leaf 64 held to the one-thread leaf's 6,432,004), [mesh-mxu] (the regen kernel
with the G leaf against ``render_plain``, both samplers, both modes, and
one depth-30 sample of config 6 as shipped at 1080p and of the reference
sampler at 512x288), [config6-mxu] (config 6 with the flag, both samplers,
timed against the exact leaf); then the API past render, on Cornell at
1920x1080: [blit-routes] (resolve_state_pallas on a wavefront state
stopped mid-drain and at 1080p, image_from_planes with scalar and
per-pixel counts and the tonemap knobs, against the plain resolve +
tonemap), [query] (trace_rays, occlusion, light_probe "all" and "spatial"
on the card against the CPU at 256x144, then timed at full size),
[denoise] (the AOVs, the à-trous filter, denoise_image, reproject and
temporal_blend, the same way), [animate] (the twin of tools/animate.py in
this process: 3 orbit frames of 4 spp, plain, resumed and with --denoise
--temporal 0.8, each stage timed, launches counted), [until]
(render_until to 0.02 in 4-spp batches, the share of its wall time outside
the regen kernel) and [bake-ao] (the twin of examples/bake_ao.py at its
defaults). The plain renders of the torus sweep all
4050 triangles for every pixel at every bounce, and set the run's length:
config 6 as shipped keeps 1080p with both leaf tests (the exact leaf at
depth 15 in [sampler], the G leaf at depth 30, 69 s), the reference
sampler, whose 1080p plain renders take 150 and 140 s, is held at 512x288
(and on Cornell at 1080p). Each group of phases ends with a [time]
line.

    python3 chip_smoke.py

Each phase prints one line; any failure raises and exits non-zero. The
line before the last two holds the kernels' JSON (launches on their main
paths, error against the plain version, times and bounds); then the GPU's
name and power limit; the last line is a JSON object with the device.
Needs a CUDA device, nvcc and a checkout of the repository around this
file; imports nothing of JAX.
"""

from __future__ import annotations

import functools
import itertools
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the least time the card could take for a kernel's work, and the work a
# path kernel's segment is counted as: the benchmark's yardstick
from bench_torch.roofline import (OPS_PER_BLIT_PIXEL, OPS_PER_SEGMENT,
                                  bound, path_bound)

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "cornell_64x32_s1234_8spp.npz"
CAM = dict(look_from=(0.0, 5.0, -12.0), look_at=(0.0, 5.0, 0.0), vfov=60.0)

# tpurt's bench configs as it ships them (bench.py): the sampler flags
CONFIG6 = dict(pallas_bvh=True, pallas_bvh_leaf=64, photon_strata=16,
               photon_strata_dir=4096, photon_strata_shared_k=True,
               photon_strata_bounce=True, camera_strata_bounce=True,
               photon_strata_window=1, pallas_regen_drift=1,
               hero_wavelengths=4)
CONFIG4 = dict(dispersion_in_camera_path=True, hero_wavelengths=4)
CONFIG3 = dict(pallas_static_unroll=512, pallas_cluster_size=32,
               pallas_cluster_ordered=True, photon_strata=16,
               photon_strata_dir=256, photon_strata_shared_k=True,
               photon_strata_bounce=True, camera_strata_bounce=True,
               photon_strata_window=16, pallas_regen_drift=1,
               hero_wavelengths=8)
TORUS_CAM = ((0.0, 3.0, -6.0), (0.0, 1.5, 0.0))
DISP_CAM = ((0.0, 3.0, -4.0), (0.0, 1.0, 5.0))
INST_CAM = ((0.0, 10.0, -14.0), (0.0, 1.0, 8.0))

# the instances each per-instance count sums (mega_regen.INSTANCE_LAUNCHES,
# keyed by launcher and mega_regen.kernel_instance): the launchers and a
# part of the kernel's name. GLEAF, the last flag of the regen kernel's
# instances, makes the G-leaf ones end in "true>".
REGEN_MODES = ("regen", "regen_budget")
FUSED_MODES = ("wf_fused", "wf_fused_budget")
INSTANCES = {
    "regen_emit": (REGEN_MODES, "regen_emit_kernel"),
    "tile_sync_emit": (("tile_sync",), "regen_emit_kernel"),
    "wf_sweep_sampler": (("wf_sweep",), "pool_step_kernel<true, false"),
    "wf_sweep_emit": (("wf_sweep",),
                      "pool_step_kernel<true, true, Sampler, Emission>"),
    "wf_fused_sampler": (FUSED_MODES, "fused_sampler_kernel<false>"),
    "wf_fused_emit": (FUSED_MODES, "fused_sampler_kernel<true>"),
    "regen_spawn": (REGEN_MODES, "regen_spawn_kernel"),
    "tile_sync_spawn": (("tile_sync",), "regen_spawn_kernel"),
    "wf_sweep_spawn": (("wf_sweep",), "Spawn>"),
    "wf_fused_spawn": (FUSED_MODES, "fused_spawn_kernel"),
    "regen_lights": (REGEN_MODES, "regen_lights_kernel"),
    "tile_sync_lights": (("tile_sync",), "regen_lights_kernel"),
    "wf_sweep_lights": (("wf_sweep",), "Lights>"),
    "wf_fused_lights": (FUSED_MODES, "fused_lights_kernel"),
    "wf_fused_tail": (("wf_fused",), "fused_tail_kernel"),
    "mxu_leaf": (REGEN_MODES, "true>"),
}


def counters() -> dict:
    """Each kernel's total launch count: (module, attribute); the counts
    by instance are ``INSTANCES``'."""
    from tpurt_torch.kernels import bvh, mega_regen, mega_step
    from tpurt_torch.kernels import tonemap as blit
    from tpurt_torch.kernels import wavefront_fused, wavefront_sweep
    return {"regen": (mega_regen, "LAUNCHES"),
            "regen_budget": (mega_regen, "BUDGET_LAUNCHES"),
            "tile_sync": (mega_step, "LAUNCHES"),
            "blit": (blit, "LAUNCHES"),
            "wf_sweep": (wavefront_sweep, "LAUNCHES"),
            "wf_fused": (wavefront_fused, "LAUNCHES"),
            "bvh_walk": (bvh, "WALKS")}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# kernel name -> launches the last profiled() session recorded: in a long
# run of this script torch.profiler records only some launches of the
# path kernels (PERF.md), so each profile says how many it saw
RECORDED = {}


def profiled(fn, reps: int = 1):
    """Run fn() reps times under torch.profiler, after one warm-up. Returns
    (wall ms per run, device ms per run by kernel name, device busy ms per
    run): the kernels' own device time, summed per name. RECORDED holds
    the launches of each kernel the session recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpurt_torch import tracing
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name = {}
    RECORDED.clear()
    for e in prof.key_averages():
        # device-side entries only (kernels, copies): a CPU op's own
        # device time repeats its kernels', as a span's range on the
        # device (tpurt_torch.tracing) repeats what it launched
        if e.device_type != DeviceType.CUDA \
                or e.key.startswith(tracing.PREFIX):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / reps
            RECORDED[e.key] = RECORDED.get(e.key, 0) + e.count
    if not by_name:
        print("  (torch.profiler saw no device time: CUDA-event and host "
              "times only)")
    return wall, by_name, sum(by_name.values())


def recorded(part: str) -> int:
    """Launches of the kernels named ``part`` the last session recorded."""
    return sum(v for k, v in RECORDED.items() if part in k)


def launch_device_ms(by_name: dict, part: str, reps: int) -> float:
    """The device ms of one launch of the kernels named ``part``: the mean
    over the launches the last session recorded (0.0 where it recorded
    none); ``by_name`` holds that session's ms per run of ``reps``."""
    n = recorded(part)
    return named_ms(by_name, part) * reps / n if n else 0.0


def launch_ms(fn, part: str, reps: int) -> list:
    """The device milliseconds of each launch of the kernels whose name
    holds part, under torch.profiler (device-side events only), over reps
    runs of fn after one warm-up. Fails where the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = [getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0)) / 1e3
           for e in prof.events()
           if e.device_type == DeviceType.CUDA and part in e.name]
    if not out:
        raise AssertionError(f"torch.profiler saw no {part} launch")
    return out


def ptxas_report(log: str) -> list:
    """One line per kernel of the build log's -Xptxas -v report: registers,
    stack frame and spill stores/loads."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            # template flags of the instance (regen: SAMPLER, GLEAF; the
            # emission instances: GLEAF or EMIT), as <0,1>
            flags = re.search(r"I((?:Lb[01]E)+)", name)
            for part, short in (("regen_emit", "regen_emit"),
                                ("regen_spawn", "regen_spawn"),
                                ("regen_lights", "regen_lights"),
                                ("regen", "regen"),
                                ("pool_step", "sweep"),
                                ("step", "step"),
                                ("fused_sampler", "fused_sampler"),
                                ("fused_spawn", "fused_spawn"),
                                ("fused_lights", "fused_lights"),
                                ("fused_tail", "fused_tail"),
                                ("fused", "fused"), ("probe", "probe"),
                                ("tonemap", "tonemap")):
                if part in name:
                    name = short
                    break
            if flags:
                name += "<" + ",".join(re.findall(r"Lb([01])E",
                                                  flags.group(1))) + ">"
            if name.startswith("sweep") and "5Spawn" in line:
                name += "+Spawn"  # the sweep's spawn instances
            if name.startswith("sweep") and "6Lights" in line:
                name += "+Lights"  # and its lights instances
        elif "bytes stack frame" in line and name:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            out.append(f"{name}: {regs}; {frame}")
            name, frame = None, ""
    return out


def named_ms(by_name: dict, part: str) -> float:
    return sum(v for k, v in by_name.items() if part in k)


def idle_share(wall: float, busy: float) -> str:
    """The device's idle share of a profiled wall time; "not measured"
    where the profiler saw no device time."""
    return f"{1.0 - busy / wall:.3f}" if busy > 0 else "not measured"


def image_gap(a: np.ndarray, b: np.ndarray):
    """(median |a-b|, share of pixels off by more than 1e-2, max |a-b|):
    the image rule of tests/test_golden.py."""
    diff = np.abs(a - b)
    return (float(np.median(diff)), float((diff.max(-1) > 1e-2).mean()),
            float(diff.max()))


def check_rays(name: str, got: int, want: int) -> None:
    """Ray counts are integer sums of the same draws: exact or wrong."""
    print(f"  {name}: rays {got} vs {want} (diff {got - want})")
    if got != want:
        raise AssertionError(f"{name}: ray count {got} is not {want}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import tpurt_torch as tt
    from tpurt_torch import integrate
    from tpurt_torch import tonemap as tm
    from tpurt_torch.kernels import build, mega_regen
    from tpurt_torch.kernels import tonemap as blit
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    # 1. environment
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} | {gpu}")

    # 2. build
    t0 = time.perf_counter()
    built = not build.library_path().exists()
    build.library()
    log = build.library_path().with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln] if log.exists() else []
    print(f"[build] {time.perf_counter() - t0:.1f} s (nvcc ran: {built}) "
          f"{' | '.join(regs)}")
    for line in ptxas_report(log.read_text() if log.exists() else ""):
        print(f"  {line}")

    report = {}
    clock = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[time] {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    # 3. blit kernel against its plain version, 1920x1080
    rs = np.random.default_rng(0)
    n = 1920 * 1080
    rgb = torch.from_numpy(rs.normal(0.0, 4.0, (n, 3)).astype(np.float32)
                           ).to(dev)
    cnt = torch.from_numpy(rs.integers(0, 17, n).astype(np.float32)).to(dev)
    worst = 0
    for key, sat in ((0.8, 1.0), (0.05, 1.3)):
        got = blit.tonemap_pixels(rgb, cnt, n, key, sat)
        want = tm.tonemap(tm.resolve(rgb, cnt), key, sat)
        ulp = (got.view(torch.int32).long()
               - want.view(torch.int32).long()).abs().max().item()
        worst = max(worst, ulp)
        print(f"[blit] key={key} sat={sat}: equal={torch.equal(got, want)} "
              f"max ulp {ulp}")
        if ulp > 1:
            raise AssertionError(f"blit differs by {ulp} ulp > 1")
    report["blit"] = dict(
        max_abs_err=float((blit.tonemap_pixels(rgb, cnt, n, 0.8, 1.0)
                           - tm.tonemap(tm.resolve(rgb, cnt), 0.8, 1.0)
                           ).abs().max()),
        ms=cuda_ms(lambda: blit.tonemap_pixels(rgb, cnt, n, 0.8, 1.0), 50),
        plain_ms=cuda_ms(
            lambda: tm.tonemap(tm.resolve(rgb, cnt), 0.8, 1.0), 50),
        # rgb_sum and n_samples in, the image out
        **bound(n * (12 + 4 + 12), n * OPS_PER_BLIT_PIXEL))
    dev_ms = launch_ms(lambda: blit.tonemap_pixels(rgb, cnt, n, 0.8, 1.0),
                       "tonemap", 50)
    med = float(np.median(dev_ms))
    print(f"[blit] 1080p: kernel {report['blit']['ms']:.4f} ms by CUDA "
          f"events, {med:.4f} ms device time (median of {len(dev_ms)} "
          f"launches under torch.profiler, min {min(dev_ms):.4f}) against "
          f"the {report['blit']['bound_ms']:.4f} ms bound ("
          f"{report['blit']['bound_ms'] / med:.2f} of it); plain "
          f"{report['blit']['plain_ms']:.4f} ms, max ulp {worst}")
    m = 256 * 144
    ms_small = cuda_ms(lambda: blit.tonemap_pixels(rgb, cnt, m, 0.8, 1.0), 50)
    plain_small = cuda_ms(
        lambda: tm.tonemap(tm.resolve(rgb[:m], cnt[:m]), 0.8, 1.0), 50)
    print(f"[blit] 256x144: kernel {ms_small:.4f} ms, plain "
          f"{plain_small:.4f} ms")

    # 4. regen kernel against its plain version on the card
    scene = tt.cornell_spheres_scene()
    fs = freeze_scene(scene)

    def both(cfg, seed, spp):
        cam = tt.make_camera(**CAM, aspect_ratio=cfg.width / cfg.height)
        planes = state_to_planes(tt.init_state(cfg))
        pk, pp = planes.clone(), planes.clone()
        rk = int(mega_regen.regen_call(scene, cfg, cam, pk, seed, spp, 0,
                                       cfg.photon_radius_init, cfg.depth))
        rp = int(integrate.render_plain(fs, cfg, cam, pp, seed, spp, 0,
                                        cfg.photon_radius_init, cfg.depth))
        torch.cuda.synchronize()
        bad = unequal_planes(pk, pp)
        print(f"[regen] {cfg.width}x{cfg.height} depth {cfg.depth} {spp} spp:"
              f" rays {rk} vs plain {rp}, unequal planes {bad}")
        if rk != rp or bad:
            raise AssertionError("the regen kernel differs from render_plain")
        n_px = cfg.n_pixels
        return (rk, rp, pk[0:3, :n_px].T.cpu().numpy(),
                pp[0:3, :n_px].T.cpu().numpy(), cam, planes)

    golden = np.load(GOLDEN)
    cfg_g = tt.RenderConfig(width=64, height=32, depth=6, tile_size=2048,
                            k_photons=2, max_photon_bounces=4,
                            backend="pallas")
    rk, rp, ik, ip, _, _ = both(cfg_g, 1234, 8)
    print("[regen] golden 64x32 depth 6 K=2 8 spp:")
    check_rays("kernel vs golden", rk, int(golden["rays"]))
    check_rays("kernel vs plain", rk, rp)
    med, frac, mx = image_gap(ik, golden["rgb_sum"])
    print(f"  kernel vs golden image: median {med:.2e}, {frac:.2%} pixels "
          f"> 1e-2, max {mx:.3g}")
    med2, frac2, mx2 = image_gap(ik, ip)
    print(f"  kernel vs plain image: median {med2:.2e}, {frac2:.2%} pixels "
          f"> 1e-2, max {mx2:.3g}")
    # tpurt's own regen kernel leaves 1.71% of this golden's pixels past
    # 1e-2 (float reassociation against the XLA integrator that wrote it)
    if not (med < 1e-4 and frac < 0.02 and med2 < 1e-4 and frac2 < 0.01):
        raise AssertionError("golden image outside tolerance")

    cfg_d = tt.RenderConfig(width=64, height=32, depth=3, backend="pallas")
    rk, rp, ik, ip, _, _ = both(cfg_d, 7, 1)
    print("[regen] dryrun 64x32 depth 3 seed 7 1 spp:")
    check_rays("kernel vs target", rk, 32698)
    check_rays("kernel vs plain", rk, rp)

    # a pixel count that is no multiple of the block, nor of a warp; then
    # two launches back to back on one stream, each with its own zeroed
    # work counter: the second must render every pixel too
    cfg_r = tt.RenderConfig(width=50, height=30, depth=30, backend="pallas")
    both(cfg_r, 99, 3)
    cam_r = tt.make_camera(**CAM, aspect_ratio=50 / 30)
    planes_r = state_to_planes(tt.init_state(cfg_r))
    pk, pp = planes_r.clone(), planes_r.clone()
    got = [mega_regen.regen_call(scene, cfg_r, cam_r, pk, 5, 2, 0, 2.0, 30),
           mega_regen.regen_call(scene, cfg_r, cam_r, pk, 5, 1, 2, 1.5, 30)]
    want = [int(integrate.render_plain(fs, cfg_r, cam_r, pp, 5, 2, 0, 2.0,
                                       30)),
            int(integrate.render_plain(fs, cfg_r, cam_r, pp, 5, 1, 2, 1.5,
                                       30))]
    got = [int(r) for r in got]
    bad = unequal_planes(pk, pp)
    print(f"[regen] 50x30 two launches back to back: rays {got} vs plain "
          f"{want}, unequal planes {bad}")
    if got != want or bad or min(got) <= 0:
        raise AssertionError("back-to-back regen launches differ from "
                             "render_plain")

    cfg_e = tt.RenderConfig(width=256, height=144, depth=8, backend="pallas")
    rk, rp, ik, ip, cam_e, planes_e = both(cfg_e, 1234, 2)
    print("[regen] 256x144 depth 8 2 spp:")
    check_rays("kernel vs plain", rk, rp)
    med, frac, mx = image_gap(ik, ip)
    print(f"  kernel vs plain image: median {med:.2e}, {frac:.2%} pixels "
          f"> 1e-2, max {mx:.3g}")
    if not (med < 1e-4 and frac < 0.01):
        raise AssertionError("256x144 image outside tolerance")
    ms_e = cuda_ms(lambda: mega_regen.regen_call(
        scene, cfg_e, cam_e, planes_e.clone(), 1234, 1, 0, 2.0, 8), 5)
    plain_e = cuda_ms(lambda: integrate.render_plain(
        fs, cfg_e, cam_e, planes_e.clone(), 1234, 1, 0, 2.0, 8), 2)
    print(f"  1 spp: kernel {ms_e:.3f} ms, plain {plain_e:.3f} ms")

    cfg = tt.RenderConfig(width=1920, height=1080, depth=30,
                          backend="pallas")
    rk, rp, ik, ip, cam, planes = both(cfg, 1234, 1)
    print("[regen] 1920x1080 depth 30 1 spp (main-path shapes):")
    check_rays("kernel vs plain", rk, rp)
    med, frac, mx = image_gap(ik, ip)
    print(f"  kernel vs plain image: median {med:.2e}, {frac:.2%} pixels "
          f"> 1e-2, max {mx:.3g}")
    if not (med < 1e-4 and frac < 0.01):
        raise AssertionError("1080p image outside tolerance")
    report["regen"] = dict(
        max_abs_err=mx,
        ms=cuda_ms(lambda: mega_regen.regen_call(
            scene, cfg, cam, planes.clone(), 1234, 1, 0, 2.0, 30), 3),
        plain_ms=cuda_ms(lambda: integrate.render_plain(
            fs, cfg, cam, planes.clone(), 1234, 1, 0, 2.0, 30), 1),
        **path_bound(cfg.n_pixels, rk))
    print(f"  1 spp: kernel {report['regen']['ms']:.2f} ms, plain "
          f"{report['regen']['plain_ms']:.2f} ms, bound "
          f"{report['regen']['bound_ms']:.4f} ms "
          f"({report['regen']['bound_by']})")

    # 5. the main path, through the public entry points
    launches = {}
    launches.update(drive("main", scene, cfg, cam, 4, ["regen", "blit"],
                          gpu))

    # 6. the regen kernel with tpurt's sampler flags; its budget mode; the
    #    tile-synchronized kernel
    lap("blit, regen, main")
    sampler_phases()
    lap("sampler")
    launches.update(budget_phases(report, gpu))
    launches.update(tile_sync_phases(report, gpu))
    lap("budget, adaptive, tile-sync")

    # 7. the wavefront kernels on the dispersive scene of tpurt's bench
    #    config 5, each against its plain version
    launches.update(wavefront_phases(dev, report, gpu))
    many_light_phases()
    lap("wavefront, many lights")

    # 7b. hero wavelengths and dispersion on the wavefront kernels; the
    #     emission instances of all four path kernels
    launches.update(wf_hero_phases(dev, report, gpu))
    lap("wf-hero")
    launches.update(emission_phases(dev, report, gpu))
    lap("emission")

    # 7c. tpurt's camera-spawn extensions (the Sobol spawn, the thin lens,
    #     the shutter) and photon_rr_scale, with its presets, in the
    #     spawn instances of all four path kernels
    launches.update(spawn_phases(dev, report, gpu))
    lap("spawn")

    # 7d. tpurt's many-light NEE (light_sample "power", "spatial") and
    #     aimed photons (photon_aim) in the lights instances
    launches.update(lights_phases(dev, report, gpu))
    launches.update(aim_phases(dev, report, gpu))
    lap("lights, aim")

    # 8. meshes: the BVH walks, bench config 6 (reference sampler and as
    #    shipped), config 4 and the scale paths
    launches.update(mesh_phases(dev, report, gpu))
    lap("meshes")

    # 9. tpurt's G-matrix leaf test (pallas_mxu_leaf): the probe, the regen
    #    kernel in both modes, config 6 with the flag
    launches.update(mxu_phases(dev, report, gpu))
    lap("G leaf")

    # 10. the rest of tpurt's API past render: the blit's two other
    #     routes, ray queries, the denoiser, temporal reuse, render_until
    #     and the twins of tools/animate.py and examples/bake_ao.py; the
    #     blit's routes and the animation's frames add to its launches
    launches["blit"] += api_phases(dev, gpu)

    src = {"regen": ("tpurt_torch/csrc/mega_regen.cu",
                     "tpurt/kernels/mega_regen.py:84"),
           "regen_budget": ("tpurt_torch/csrc/mega_regen.cu",
                            "tpurt/kernels/mega_regen.py:1024"),
           "tile_sync": ("tpurt_torch/csrc/mega_step.cu",
                         "tpurt/kernels/mega_pallas.py:1666"),
           "blit": ("tpurt_torch/csrc/tonemap.cu",
                    "tpurt/kernels/tonemap_pallas.py:31"),
           "wf_sweep": ("tpurt_torch/csrc/wavefront_sweep.cu",
                        "tpurt/kernels/wavefront_pallas.py:102"),
           "wf_fused": ("tpurt_torch/csrc/wavefront_fused.cu",
                        "tpurt/kernels/wavefront_pallas.py:572"),
           "wf_fused_tail": ("tpurt_torch/csrc/fused_tail.cu",
                             "tpurt/kernels/wavefront_pallas.py:903"),
           "regen_emit": ("tpurt_torch/csrc/path_emit.cu",
                          "tpurt/kernels/mega_regen.py:84"),
           "regen_emit_gleaf": ("tpurt_torch/csrc/path_emit.cu",
                                "tpurt/kernels/mega_regen.py:84"),
           "tile_sync_emit": ("tpurt_torch/csrc/path_emit.cu",
                              "tpurt/kernels/mega_pallas.py:1666"),
           "wf_sweep_sampler": ("tpurt_torch/csrc/wavefront_sweep.cu",
                                "tpurt/kernels/wavefront_pallas.py:102"),
           "wf_sweep_emit": ("tpurt_torch/csrc/wavefront_sweep.cu",
                             "tpurt/kernels/wavefront_pallas.py:102"),
           "wf_fused_sampler": ("tpurt_torch/csrc/wavefront_fused.cu",
                                "tpurt/kernels/wavefront_pallas.py:572"),
           "wf_fused_emit": ("tpurt_torch/csrc/wavefront_fused.cu",
                             "tpurt/kernels/wavefront_pallas.py:572"),
           "regen_spawn": ("tpurt_torch/csrc/path_spawn.cu",
                           "tpurt/kernels/mega_regen.py:84"),
           "tile_sync_spawn": ("tpurt_torch/csrc/path_spawn.cu",
                               "tpurt/kernels/mega_pallas.py:1666"),
           "wf_sweep_spawn": ("tpurt_torch/csrc/wavefront_sweep.cu",
                              "tpurt/kernels/wavefront_pallas.py:102"),
           "wf_fused_spawn": ("tpurt_torch/csrc/wavefront_fused.cu",
                              "tpurt/kernels/wavefront_pallas.py:572"),
           "regen_lights": ("tpurt_torch/csrc/path_lights.cu",
                            "tpurt/kernels/mega_regen.py:84"),
           "regen_lights_budget": ("tpurt_torch/csrc/path_lights.cu",
                                   "tpurt/kernels/mega_regen.py:1024"),
           "regen_aim": ("tpurt_torch/csrc/path_lights.cu",
                         "tpurt/kernels/mega_regen.py:84"),
           "tile_sync_lights": ("tpurt_torch/csrc/path_lights.cu",
                                "tpurt/kernels/mega_pallas.py:1666"),
           "wf_sweep_lights": ("tpurt_torch/csrc/wavefront_sweep.cu",
                               "tpurt/kernels/wavefront_pallas.py:102"),
           "wf_fused_lights": ("tpurt_torch/csrc/wavefront_fused.cu",
                               "tpurt/kernels/wavefront_pallas.py:572"),
           "bvh_walk": ("tpurt_torch/csrc/bvh.cuh",
                        "tpurt/kernels/bvh_pallas.py:466"),
           "mxu_leaf": ("tpurt_torch/csrc/bvh.cuh",
                        "tpurt/kernels/bvh_pallas.py:368")}
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src[k][0], replaces=src[k][1],
             launches=launches[k], library_ms=None, **report[k])
        for k in src]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _instance_keys(name) -> list:
    from tpurt_torch.kernels import mega_regen
    launchers, part = INSTANCES[name]
    return [key for key in mega_regen.INSTANCE_LAUNCHES
            if key[0] in launchers and part in key[1]]


def zero_counts(names) -> None:
    from tpurt_torch.kernels import mega_regen
    for k in names:
        if k in INSTANCES:
            for key in _instance_keys(k):
                del mega_regen.INSTANCE_LAUNCHES[key]
        else:
            mod, attr = counters()[k]
            setattr(mod, attr, 0)


def read_counts(names) -> dict:
    from tpurt_torch.kernels import mega_regen
    return {k: (sum(mega_regen.INSTANCE_LAUNCHES[key]
                    for key in _instance_keys(k)) if k in INSTANCES
                else getattr(*counters()[k])) for k in names}


def drive(name, scene, cfg, cam, spp, kernels, gpu) -> dict:
    """One main path through the public entry points: render ``spp``
    samples from a fresh state, then resolve_image, with the launch count
    of every kernel named in ``kernels`` set to 0 just before and read just
    after. Checks the image and that each kernel launched; returns the
    counts."""
    import tpurt_torch as tt
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = tt.render(scene, cfg, cam, tt.init_state(cfg), 1234, spp)
    img = tt.resolve_image(cfg, state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(kernels)
    rays = int(state.rays)
    # single-wavelength samples tonemap to out-of-gamut values (negative,
    # or past 1) at low spp, so "not black" is judged on what a display
    # shows and on the mean radiance
    shown = float(img.clamp(0.0, 1.0).mean())
    radiance = float(tt.resolve_radiance(cfg, state).mean())
    print(f"[{name}] {cfg.backend} render+resolve {cfg.width}x{cfg.height} "
          f"depth {cfg.depth} spp {spp}: {secs:.3f} s, rays {rays}, "
          f"{rays / secs / 1e6:.1f} Mrays/s, launches {launches}, image mean "
          f"{float(img.mean()):.4f} (in [0,1]: {shown:.4f}), radiance mean "
          f"{radiance:.4f} | {gpu}")
    if img.shape != (cfg.height, cfg.width, 3) \
            or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{name}: image is not finite "
                             f"({cfg.height}, {cfg.width}, 3)")
    n = cfg.n_pixels
    if not (shown > 0.0 and radiance > 0.0 and rays > 0
            and state.iteration == spp
            and bool((state.n_samples[:n] == spp).all())):
        raise AssertionError(f"{name}: traced nothing or lost samples")
    if min(launches.values()) < 1:
        raise AssertionError(f"{name}: a kernel of the path never launched: "
                             f"{launches}")
    return launches


def unequal_planes(a, b) -> list:
    """The indices of the state planes that differ anywhere."""
    return [i for i in range(a.shape[0]) if not torch.equal(a[i], b[i])]


def regen_vs_plain(label, scene, cfg, cam, seed, spp, it0, phase="sampler"):
    """The regen kernel against render_plain (with the kernel's triangle
    test, the G sweep where the G leaf engages) from a fresh state at
    iteration it0 (radius after it0 steps): rays and all 16 planes bit for
    bit. Returns (segments, kernel s, plain s)."""
    import tpurt_torch as tt
    from tpurt_torch import integrate
    from tpurt_torch.kernels import mega_regen
    from tpurt_torch.render import radius_after, state_to_planes
    from tpurt_torch.scene import freeze_scene
    fs = freeze_scene(scene)
    tri = mega_regen.regen_tri_mode(fs, cfg)
    planes = state_to_planes(tt.init_state(cfg))
    pk, pp = planes.clone(), planes.clone()
    r0 = radius_after(cfg, 0, cfg.photon_radius_init, it0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk = int(mega_regen.regen_call(scene, cfg, cam, pk, seed, spp, it0, r0,
                                   cfg.depth))
    t1 = time.perf_counter()
    rp = int(integrate.render_plain(fs, cfg, cam, pp, seed, spp, it0, r0,
                                    cfg.depth, tri))
    t2 = time.perf_counter()
    bad = unequal_planes(pk, pp)
    print(f"[{phase}] {label} ({tri.kind} leaf) {cfg.width}x{cfg.height} "
          f"depth {cfg.depth} {spp} spp from iteration {it0}: rays {rk} vs "
          f"plain {rp}, "
          f"unequal planes {bad}; kernel call {1e3 * (t1 - t0):.1f} ms, "
          f"plain {1e3 * (t2 - t1):.1f} ms")
    if rk != rp or bad:
        raise AssertionError(f"{label}: the regen kernel differs from "
                             f"render_plain")
    return rk, t1 - t0, t2 - t1


def sampler_phases() -> None:
    """[sampler] the regen kernel with the sampler flags of tpurt's bench
    configs 6 (photon strata 16/4096, shared k, bounce and camera strata,
    hero 4, on the torus mesh), 4 (hero 4 with the dispersive collapse) and
    3 (hero 8, strata 16/256, window 16, from iteration 14 so one call
    crosses a window) against render_plain; then config 6 at 1080p, depth
    15 (its plain render took 56 s at depth 30; config 6 runs at depth 30
    through the main path in [config6] and, with the G leaf, against its
    plain version in [mesh-mxu])."""
    import tpurt_torch as tt
    scenes = {"config 6": (tt.torus_mesh_scene(45, 45), CONFIG6, TORUS_CAM,
                           0, 2),
              "config 4": (tt.dispersive_scene(), CONFIG4, DISP_CAM, 0, 2),
              "config 3": (tt.instanced_scene(256), CONFIG3, INST_CAM, 14, 4)}
    for w, h in ((64, 32), (256, 144)):
        for label, (scene, flags, cam, it0, spp) in scenes.items():
            cfg = tt.RenderConfig(width=w, height=h, depth=8,
                                  backend="pallas", **flags)
            camera = tt.make_camera(*cam, vfov=55.0, aspect_ratio=w / h)
            regen_vs_plain(label, scene, cfg, camera, 1234, spp, it0)
    scene, flags, cam, _, _ = scenes["config 6"]
    cfg = tt.RenderConfig(width=1920, height=1080, depth=15,
                          backend="pallas", **flags)
    regen_vs_plain("config 6", scene, cfg,
                   tt.make_camera(*cam, vfov=55.0, aspect_ratio=16 / 9),
                   1234, 1, 0)


def budget_map(rows: int, n: int, hi: int, seed: int, dev) -> torch.Tensor:
    """Seeded budgets in [0, hi] on the image rows, 0 on the pad rows."""
    vals = np.random.default_rng(seed).integers(0, hi + 1, rows)
    vals[n:] = 0
    return torch.from_numpy(vals).to(dev)


def budget_phases(report, gpu) -> dict:
    """[budget] the regen kernel's budget mode against
    render_plain_budget, a uniform budget against the uniform render and
    two chained calls against one, at 256x144 on Cornell; the same shapes
    at 1080p; then render_adaptive(backend="pallas") at 1080p, 8 spp
    (pilot 2). Fills report["regen_budget"]; returns the adaptive path's
    launch counts."""
    import tpurt_torch as tt
    from tpurt_torch import integrate
    from tpurt_torch.kernels import mega_regen
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene

    scene = tt.cornell_spheres_scene()
    fs = freeze_scene(scene)
    dev = scene.device
    cfg = tt.RenderConfig(width=256, height=144, depth=30, backend="pallas")
    cam = tt.make_camera(**CAM, aspect_ratio=256 / 144)
    st0 = tt.init_state(cfg)
    rows = st0.n_samples.shape[0]
    # from a state with vispoints and counts of 2
    st1 = tt.render(scene, cfg, cam, st0, 1234, 2)
    b1 = budget_map(rows, cfg.n_pixels, 4, 5, dev)
    b2 = budget_map(rows, cfg.n_pixels, 4, 6, dev)

    def kernel_and_plain(c, st, budgets):
        planes = state_to_planes(st)
        pk, pp = planes.clone(), planes.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rk = int(mega_regen.regen_budget_call(scene, c, cam_of(c), pk, 1234,
                                              budgets, st.n_samples))
        t1 = time.perf_counter()
        rp = int(integrate.render_plain_budget(fs, c, cam_of(c), pp, 1234,
                                               budgets, st.n_samples))
        t2 = time.perf_counter()
        return rk, rp, pk, pp, t1 - t0, t2 - t1

    def cam_of(c):
        return tt.make_camera(**CAM, aspect_ratio=c.width / c.height)

    rk, rp, pk, pp, _, _ = kernel_and_plain(cfg, st1, b1)
    bad = unequal_planes(pk, pp)
    sb = mega_regen.render_budget_regen(scene, cfg, cam, st1, 1234, b1, 4)
    counts_ok = torch.equal(sb.n_samples, st1.n_samples + b1.float())
    print(f"[budget] 256x144 depth 30, budgets 0-4 after 2 spp: rays {rk} "
          f"vs plain {rp}, unequal planes {bad}, n_samples = 2 + budget: "
          f"{counts_ok}")
    if rk != rp or bad or not counts_ok:
        raise AssertionError("budget mode differs from render_plain_budget")
    # long runs of zeros (two pixels in three take no sample), also at a
    # size that is no multiple of the block: a pixel without budget costs
    # one fetch and keeps its planes
    for c in (cfg, tt.RenderConfig(width=50, height=30, depth=30,
                                   backend="pallas")):
        st_c = tt.render(scene, c, cam_of(c), tt.init_state(c), 1234, 2)
        n_rows = st_c.n_samples.shape[0]
        vals = np.random.default_rng(5).integers(0, 5, n_rows)
        vals[(np.arange(n_rows) // 97) % 3 != 0] = 0
        vals[c.n_pixels:] = 0
        bz = torch.from_numpy(vals).to(dev)
        rk, rp, pk, pp, _, _ = kernel_and_plain(c, st_c, bz)
        bad = unequal_planes(pk, pp)
        kept = torch.equal(pk[:, bz == 0], state_to_planes(st_c)[:, bz == 0])
        print(f"[budget] {c.width}x{c.height} zero-heavy budgets "
              f"({float((bz == 0).float().mean()):.2f} zero): rays {rk} vs "
              f"plain {rp}, unequal planes {bad}, zero-budget pixels "
              f"untouched: {kept}")
        if rk != rp or bad or not kept:
            raise AssertionError("zero-heavy budget map differs")
    uni = torch.where(torch.arange(rows, device=dev) < cfg.n_pixels, 2, 0)
    su = mega_regen.render_budget_regen(scene, cfg, cam, st0, 1234, uni, 2)
    sr = tt.render(scene, cfg, cam, st0, 1234, 2)
    same_u = (torch.equal(state_to_planes(su), state_to_planes(sr))
              and int(su.rays) == int(sr.rays)
              and su.photon_radius == sr.photon_radius)
    sa = mega_regen.render_budget_regen(scene, cfg, cam, st1, 1234, b1, 4)
    sa = mega_regen.render_budget_regen(scene, cfg, cam, sa, 1234, b2, 4)
    sc = mega_regen.render_budget_regen(scene, cfg, cam, st1, 1234, b1 + b2,
                                        8)
    same_c = (torch.equal(state_to_planes(sa), state_to_planes(sc))
              and int(sa.rays) == int(sc.rays)
              and torch.equal(sa.n_samples, sc.n_samples))
    print(f"  uniform budget 2 = uniform 2 spp bit for bit: {same_u}; two "
          f"chained calls, back to back on one stream = one combined: "
          f"{same_c}")
    if not (same_u and same_c):
        raise AssertionError("budget mode: uniform or chained calls differ")

    # the main path's shapes: 1080p planes and budgets, budgets 0-2
    cfg_f = tt.RenderConfig(width=1920, height=1080, depth=30,
                            backend="pallas")
    stf = tt.init_state(cfg_f)
    bf = budget_map(stf.n_samples.shape[0], cfg_f.n_pixels, 2, 7, dev)
    rk, rp, pk, pp, _, plain_s = kernel_and_plain(cfg_f, stf, bf)
    bad = unequal_planes(pk, pp)
    err = float((pk - pp).abs().max())
    planes_f = state_to_planes(stf)
    ms = cuda_ms(lambda: mega_regen.regen_budget_call(
        scene, cfg_f, cam_of(cfg_f), planes_f.clone(), 1234, bf,
        stf.n_samples), 3)
    print(f"[budget] 1080p depth 30, budgets 0-2: rays {rk} vs plain {rp}, "
          f"unequal planes {bad}; kernel {ms:.2f} ms, plain "
          f"{plain_s * 1e3:.1f} ms")
    if rk != rp or bad:
        raise AssertionError("1080p budget mode differs")
    report["regen_budget"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3,
        # the aux planes (budget, count, radius) in beside the state
        **bound((16 * 2 + 3) * 4 * cfg_f.n_pixels, rk * OPS_PER_SEGMENT))

    # [adaptive] the main path: pilots through the regen kernel, the rest
    # through its budget mode
    launches = adaptive_path("adaptive", scene, cfg_f, cam_of(cfg_f),
                             ["regen", "regen_budget", "blit"], gpu, spp=8)
    return {"regen_budget": launches["regen_budget"]}


def tile_sync_phases(report, gpu) -> dict:
    """[tile-sync] step_call against render_plain(spp=1), every plane bit
    for bit, at 64x32, 256x144 and 1080p on Cornell; 4 samples through
    pallas_regen=False against 4 through the regen kernel (Cornell, and
    config 6's flags on the torus); then Cornell at 1080p, depth 30, 4 spp
    through tt.render with pallas_regen=False. Fills report["tile_sync"];
    returns that path's launch counts."""
    import tpurt_torch as tt
    from tpurt_torch import integrate
    from tpurt_torch.kernels import mega_step
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene

    scene = tt.cornell_spheres_scene()
    fs = freeze_scene(scene)
    for w, h in ((64, 32), (50, 30), (256, 144), (1920, 1080)):
        cfg = tt.RenderConfig(width=w, height=h, depth=30, backend="pallas",
                              pallas_regen=False)
        cam = tt.make_camera(**CAM, aspect_ratio=w / h)
        planes = state_to_planes(tt.init_state(cfg))
        pk, pp = planes.clone(), planes.clone()
        rk = int(mega_step.step_call(scene, cfg, cam, pk, 1234, 3, 1.5, 30))
        rp = int(integrate.render_plain(fs, cfg, cam, pp, 1234, 1, 3, 1.5,
                                        30))
        bad = unequal_planes(pk, pp)
        print(f"[tile-sync] {w}x{h} depth 30, sample 3: rays {rk} vs plain "
              f"{rp}, unequal planes {bad}")
        if rk != rp or bad:
            raise AssertionError("the tile-sync kernel differs from "
                                 "render_plain")
    report["tile_sync"] = dict(
        max_abs_err=float((pk - pp).abs().max()),
        ms=cuda_ms(lambda: mega_step.step_call(
            scene, cfg, cam, planes.clone(), 1234, 3, 1.5, 30), 3),
        plain_ms=cuda_ms(lambda: integrate.render_plain(
            fs, cfg, cam, planes.clone(), 1234, 1, 3, 1.5, 30), 1),
        **path_bound(cfg.n_pixels, rk))
    print(f"  1080p: kernel {report['tile_sync']['ms']:.2f} ms per sample, "
          f"plain {report['tile_sync']['plain_ms']:.1f} ms")

    torus = tt.torus_mesh_scene(45, 45)
    for label, sc, flags, cam_at, (w, h) in (
            ("Cornell", scene, {}, (CAM["look_from"], CAM["look_at"]),
             (256, 144)),
            ("config 6 flags, torus", torus, CONFIG6, TORUS_CAM, (64, 32))):
        cfg = tt.RenderConfig(width=w, height=h, depth=30, backend="pallas",
                              **flags)
        cam = tt.make_camera(*cam_at, vfov=60.0, aspect_ratio=w / h)
        st_r = tt.render(sc, cfg, cam, tt.init_state(cfg), 1234, 4)
        c_t = cfg.with_(pallas_regen=False)
        st_t = tt.render(sc, c_t, cam, tt.init_state(c_t), 1234, 4)
        bad = unequal_planes(state_to_planes(st_t), state_to_planes(st_r))
        same = (int(st_t.rays) == int(st_r.rays) and not bad
                and st_t.photon_radius == st_r.photon_radius)
        print(f"[tile-sync] {label} {w}x{h} 4 spp, pallas_regen=False vs "
              f"True: rays {int(st_t.rays)} vs {int(st_r.rays)}, unequal "
              f"planes {bad}")
        if not same:
            raise AssertionError("tile-sync and regen renders differ")

    cfg = tt.RenderConfig(width=1920, height=1080, depth=30,
                          backend="pallas", pallas_regen=False)
    cam = tt.make_camera(**CAM, aspect_ratio=16 / 9)
    launches = drive("tile-sync", scene, cfg, cam, 4, ["tile_sync", "blit"],
                     gpu)
    return {"tile_sync": launches["tile_sync"]}


def sweep_vs_step(tag, fs, cfg, work, dev, part):
    """[tag] one sweep of the pool loop, whole (claim, bounce, splat,
    control words), on a pool in mid flight: camera rays from the middle
    rows of the image (the top rows see sky) after two plain sweeps; then
    one launch of the sweep kernel against one wavefront._step, every
    pool plane, the control words, the image and the rays bit for bit.
    Times the launch (device ms of the kernels named ``part``) and returns
    its report entry."""
    from tpurt_torch import wavefront
    from tpurt_torch.kernels import wavefront_sweep
    q = cfg.wf_pool
    rgb0 = torch.zeros((cfg.n_pixels, 3), device=dev)
    ctl = wavefront.new_ctl(q, True, dev)
    ctl[wavefront.NEXT_PIX] = max(cfg.n_pixels - q, 0) // 2
    start = (wavefront.new_pool(q, dev), rgb0,
             torch.zeros((cfg.n_pixels,), device=dev), ctl)
    for _ in range(2):
        start = wavefront._step(fs, cfg, work, *start)

    def copy(args):
        pool, *rest = args
        return (wavefront.WavefrontPool(pf=pool.pf.clone(), pi=pool.pi.clone(),
                                        rng=pool.rng.clone()),
                *(t.clone() for t in rest))

    step = wavefront_sweep.stepper(fs, cfg, work).sweep
    got = step(*copy(start))
    want = wavefront._step(fs, cfg, work, *copy(start))
    torch.cuda.synchronize()
    names = ("o/d/tp/rad/lam", "pix/bounce/state", "rng", "rgb_sum",
             "n_samples", "control words")
    flat = lambda r: (r[0].pf, r[0].pi, r[0].rng, *r[1:])  # noqa: E731
    equal = {k: torch.equal(a, b)
             for k, a, b in zip(names, flat(got), flat(want))}
    err = float((got[0].pf - want[0].pf).abs().max())
    pool0 = start[0]
    claimed = wavefront._claim(cfg, work, pool0, start[3])[0]
    n_old = int(pool0.active.sum())
    n_live = int(claimed.active.sum())
    n_term = int(want[2].sum() - start[2].sum())
    rays = int(want[3][wavefront.RAYS] - start[3][wavefront.RAYS])
    bounces = pool0.pi[wavefront.BOUNCE][pool0.active].float()
    print(f"[{tag}] {cfg.width}x{cfg.height} Q={q} ({n_old / q:.3f} active,"
          f" {int(pool0.coll.sum())} collapsed, mean bounce "
          f"{float(bounces.mean()):.2f}; {n_live - n_old} claimed, {n_term} "
          f"ended): equal {equal}, rays "
          f"{int(got[3][wavefront.RAYS] - start[3][wavefront.RAYS])} vs "
          f"{rays}, max |diff| {err}")
    if not all(equal.values()):
        raise AssertionError(f"{tag}: the sweep kernel differs from "
                             f"wavefront._step")
    call_ms, by_name, _ = profiled(lambda: step(*copy(start)), 20)
    # what the launch must move: every slot's state word; the planes of
    # the slots in flight read (13 f32, pix, bounce, the i64 PCG state)
    # and of every slot that bounces written (13 f32, 3 i32, the state);
    # rgb_sum and n_samples of each ended path read and written
    moved = q * 4 + n_old * (13 * 4 + 2 * 4 + 8) \
        + n_live * (13 * 4 + 3 * 4 + 8) + n_term * 16 * 2
    entry = dict(
        max_abs_err=err, ms=launch_device_ms(by_name, part, 20) or call_ms,
        plain_ms=cuda_ms(lambda: wavefront._step(fs, cfg, work,
                                                 *copy(start)), 3),
        **bound(moved, rays * OPS_PER_SEGMENT))
    print(f"  one sweep: kernel {entry['ms']:.4f} ms of device time "
          f"({recorded(part)} of 20 launches recorded; {call_ms:.4f} ms per "
          f"wrapper call with its input copies), "
          f"plain {entry['plain_ms']:.3f} ms; bound {entry['bound_ms']:.4f} "
          f"ms ({entry['bound_by']}, {moved} bytes)")
    return entry


def pool_pair(scene, cfg, cam, backend, spp, plain="wavefront"):
    """The kernel backend and the plain pool from fresh states: rays and
    sample counts exact, the image rule (median < 1e-4, < 2% of pixels
    past 1e-2). Returns (max |diff|, rays)."""
    import tpurt_torch as tt
    kcfg = cfg.with_(backend=backend)
    sk = tt.render(scene, kcfg, cam, tt.init_state(kcfg), 1234, spp)
    pcfg = cfg.with_(backend=plain)
    sp = tt.render(scene, pcfg, cam, tt.init_state(pcfg), 1234, spp)
    torch.cuda.synchronize()
    n = cfg.n_pixels
    med, frac, mx = image_gap(sk.rgb_sum[:n].cpu().numpy(),
                              sp.rgb_sum[:n].cpu().numpy())
    print(f"  {backend} {cfg.width}x{cfg.height} depth {cfg.depth} {spp} "
          f"spp: image median {med:.2e}, {frac:.2%} pixels > 1e-2, "
          f"max {mx:.3g}")
    check_rays(f"{backend} vs {plain}", int(sk.rays), int(sp.rays))
    if int(sk.rays) != int(sp.rays) \
            or not bool((sk.n_samples[:n] == spp).all()) \
            or not (med < 1e-4 and frac < 0.02):
        raise AssertionError(f"{backend} differs from {plain}")
    return mx, int(sk.rays)


def dispersive_camera(cfg):
    """tpurt's bench config 5 camera (bench.py:117-122)."""
    import tpurt_torch as tt
    return tt.make_camera((0.0, 3.0, -4.0), (0.0, 1.0, 5.0), vfov=55.0,
                          aspect_ratio=cfg.width / cfg.height)


def wavefront_phases(dev, report, gpu) -> dict:
    """The sweep kernel and the fused kernel (both modes) against their
    plain versions, then the wavefront_pallas and config 5 main paths.
    Fills ``report`` and returns the main paths' launch counts."""
    import tpurt_torch as tt
    from tpurt_torch import wavefront
    from tpurt_torch.kernels import mega_regen, wavefront_fused, wavefront_sweep
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene

    scene = tt.dispersive_scene()
    fs = freeze_scene(scene)
    # tpurt's bench config 5 (bench.py:117-122)
    cfg5 = tt.RenderConfig(width=1920, height=1080, depth=30,
                           backend="wavefront_fused", enable_photons=False,
                           wf_pool=262144)
    cam5 = dispersive_camera(cfg5)

    # [wf-sweep] one sweep of the pool loop, whole (claim, bounce, splat,
    # control words), on a 1080p pool in mid flight, against wavefront._step
    work = wavefront.PoolWork(camera=cam5, base_seed=1234, spp=1,
                              n_valid=cfg5.n_pixels)
    report["wf_sweep"] = sweep_vs_step("wf-sweep", fs, cfg5, work, dev,
                                       "pool_step_kernel")

    def pair(cfg, backend, spp, plain="wavefront"):
        return pool_pair(scene, cfg, dispersive_camera(cfg), backend, spp,
                         plain)

    # [wf-pool] the pool driven by the sweep kernel against the plain pool
    print("[wf-pool] wavefront_pallas vs wavefront:")
    pair(tt.RenderConfig(width=256, height=144, depth=8,
                         enable_photons=False, wf_pool=16384),
         "wavefront_pallas", 2)

    # [wf-fused] the fused kernel against the plain pool
    print("[wf-fused] wavefront_fused vs wavefront:")
    for w, h, depth in ((64, 32, 30), (256, 144, 30)):
        pair(cfg5.with_(width=w, height=h, depth=depth), "wavefront_fused", 1)
    err, fused_rays = pair(cfg5, "wavefront_fused", 1)
    # the same camera paths as the regen kernel with photons off, whose
    # lanes add each sample into the pixel's row in sample order
    st0 = tt.init_state(cfg5)
    planes = state_to_planes(st0)
    rr = int(mega_regen.regen_call(scene, cfg5.with_(backend="pallas"), cam5,
                                   planes, 1234, 2, 0, 2.0, cfg5.depth))
    sf = wavefront_fused.wavefront_render_fused(scene, cfg5, cam5, st0, 1234,
                                                2)
    same = torch.equal(sf.rgb_sum, planes[0:3].T) and int(sf.rays) == rr
    print(f"  1080p 2 spp: fused kernel = regen kernel with photons off, "
          f"rgb_sum bit for bit and rays: {same} ({int(sf.rays)} vs {rr})")
    if not same:
        raise AssertionError("the fused kernel differs from the regen kernel "
                             "with photons off")
    rows = st0.n_samples.shape[0]
    vals = np.random.default_rng(8).integers(0, 5, rows)
    vals[cfg5.n_pixels:] = 0
    budgets = torch.from_numpy(vals).to(dev)
    aux = torch.stack([budgets.float(), st0.n_samples]).contiguous()
    fused_ms = {}
    for mode, spp, aux_m in (("1 spp", 1, None), ("4 spp", 4, None),
                             ("budgets 0-4", 0, aux)):
        call_ms, by_name, _ = profiled(
            lambda: wavefront_fused._launch(scene, cfg5, cam5, st0, 1234,
                                            spp, aux_m), 3)
        fused_ms[mode] = launch_device_ms(by_name, "fused_kernel", 3) \
            or call_ms
        print(f"  1080p depth 30 {mode}: kernel {fused_ms[mode]:.4f} ms of "
              f"device time ({recorded('fused_kernel')} of 3 launches "
              f"recorded; {call_ms:.3f} ms per wrapper call)")
    kernel_ms = fused_ms["1 spp"]
    report["wf_fused"] = dict(
        max_abs_err=err, ms=kernel_ms,
        plain_ms=cuda_ms(lambda: wavefront.wavefront_render(
            scene, cfg5, cam5, st0, 1234, 1), 1),
        # rgb_sum (P, 3) read and written
        **bound(cfg5.n_pixels * 12 * 2, fused_rays * OPS_PER_SEGMENT))
    print(f"  1080p depth 30 1 spp: plain pool "
          f"{report['wf_fused']['plain_ms']:.1f} ms")

    # [wf-budget] the fused kernel's budget mode
    cfg_b = cfg5.with_(width=256, height=144)
    cam_b = dispersive_camera(cfg_b)
    st0 = tt.init_state(cfg_b)
    rows = st0.n_samples.shape[0]
    uni = torch.where(torch.arange(rows, device=dev) < cfg_b.n_pixels, 2, 0)
    su = wavefront_fused.wavefront_render_fused(scene, cfg_b, cam_b, st0,
                                                1234, 2)
    sb = wavefront_fused.wavefront_render_budget_fused(
        scene, cfg_b, cam_b, st0, 1234, uni, 2)
    same = torch.equal(su.rgb_sum, sb.rgb_sum) and int(su.rays) == int(
        sb.rays)
    vals = np.random.default_rng(8).integers(0, 5, rows).astype(np.int32)
    vals[cfg_b.n_pixels:] = 0       # the budget contract: pad rows take 0
    vals = torch.from_numpy(vals).to(dev)
    sk = wavefront_fused.wavefront_render_budget_fused(
        scene, cfg_b, cam_b, st0, 1234, vals, 4)
    sp = tt.wavefront_render_budget(scene, cfg_b, cam_b, st0, 1234, vals, 4)
    torch.cuda.synchronize()
    print(f"[wf-budget] 256x144 depth 30: uniform budget 2 = uniform 2 spp "
          f"bit for bit: {same}; budgets 0-4: rays {int(sk.rays)} vs plain "
          f"{int(sp.rays)}, sample counts equal "
          f"{torch.equal(sk.n_samples, sp.n_samples)}")
    if not (same and int(sk.rays) == int(sp.rays)
            and torch.equal(sk.n_samples, sp.n_samples)):
        raise AssertionError("fused budget mode differs")

    # [wf-pallas] the 1080p wavefront_pallas path; then the same render
    # under torch.profiler, for the share of wall time in the sweep kernel,
    # and the render's wall time with k sweeps enqueued per read of the
    # loop test (reads counted through wavefront._pool_live; the kernel's
    # step hook with its batch set to k)
    cfg_p = cfg5.with_(backend="wavefront_pallas")
    k = wavefront_sweep.SWEEP_BATCH
    reads = [0]
    live = wavefront._pool_live

    def counted(ctl):
        reads[0] += 1
        return live(ctl)

    wavefront._pool_live = counted
    try:
        launches = drive("wf-pallas", scene, cfg_p, cam5, 1,
                         ["wf_sweep", "blit"], gpu)
        enqueued, n_reads = launches["wf_sweep"], reads[0]

        def render_p(batch=k):
            return wavefront.wavefront_render(
                scene, cfg_p, cam5, tt.init_state(cfg_p), 1234, 1,
                step=functools.partial(wavefront_sweep.stepper, batch=batch))

        wall, by_name, busy = profiled(render_p, 2)
        in_sweep = named_ms(by_name, "pool_step_kernel")
        walls = {}
        for batch in (1, 2, 4, 8, 16, 32, k):
            render_p(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                render_p(batch)
            torch.cuda.synchronize()
            walls[batch] = (time.perf_counter() - t0) * 1e3 / 5
    finally:
        wavefront._pool_live = live
    st = tt.init_state(cfg_p)
    sweeps = int(wavefront._drain(fs, cfg_p, st, work,
                                  wavefront_sweep.stepper)[2][wavefront.SWEEPS])
    print(f"  1 spp: {sweeps} sweeps in {enqueued} launches, k = {k} sweeps "
          f"per read of the loop test, {n_reads} host reads; wall "
          f"{walls[k]:.3f} ms (mean of 5); under the profiler {wall:.3f} ms "
          f"wall, {in_sweep:.3f} ms in the sweep kernel "
          f"({1.0 - in_sweep / wall:.3f} of the wall time outside it), "
          f"device busy {busy:.3f} ms (idle share {idle_share(wall, busy)})")
    print("  wall ms by k: " + ", ".join(f"{b}: {t:.3f}"
                                         for b, t in sorted(walls.items())))
    if n_reads > -(-enqueued // k):
        raise AssertionError(f"{n_reads} reads of the loop test for "
                             f"{enqueued} launches in batches of {k}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print("  device ms by kernel: " + "; ".join(
        f"{k_[:60]} {v:.3f}" for k_, v in top))

    # [config5] tpurt's bench config 5 at 4 spp through the public entry
    # points: the fused kernel, then the blit
    launches.update(drive("config5", scene, cfg5, cam5, 4,
                          ["wf_fused", "blit"], gpu))
    launches.pop("blit")

    def config5():
        st = tt.render(scene, cfg5, cam5, tt.init_state(cfg5), 1234, 4)
        return tt.resolve_image(cfg5, st)

    wall, by_name, busy = profiled(config5, 3)
    print(f"  under the profiler: {wall:.2f} ms wall, fused kernel "
          f"{launch_device_ms(by_name, 'fused_kernel', 3):.2f} ms a launch "
          f"({recorded('fused_kernel')} of 3 recorded), blit "
          f"{named_ms(by_name, 'tonemap_kernel'):.3f} ms, device busy "
          f"{busy:.2f} ms (idle share {idle_share(wall, busy)}, of the "
          f"launches recorded)")
    launches.update(fused_tail_phase(scene, cfg5, cam5, report, gpu))
    return launches


def fused_tail_phase(scene, cfg5, cam5, report, gpu) -> dict:
    """[wf-fused-tail] the fused kernel's tail instance, which a uniform
    launch of ``mega_regen.TAIL_MIN_SPP`` samples a pixel or more runs on
    bench config 5: at 1080p and that many samples against the plain pool
    (rays and sample counts exact, the image rule; the pool's time is the
    row's plain time) and the regen kernel with photons off (rgb_sum and
    rays bit for bit), its device time at that many samples and at 64,
    then config 5 through the public entry points at that many samples.
    Fills ``report`` and returns the launch count."""
    import tpurt_torch as tt
    from tpurt_torch import wavefront
    from tpurt_torch.kernels import mega_regen, wavefront_fused
    from tpurt_torch.render import state_to_planes
    spp = mega_regen.TAIL_MIN_SPP
    st0 = tt.init_state(cfg5)
    n = cfg5.n_pixels
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sp = wavefront.wavefront_render(scene, cfg5, cam5, st0, 1234, spp)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    before = mega_regen.INSTANCE_LAUNCHES["wf_fused", "fused_tail_kernel"]
    sk = wavefront_fused.wavefront_render_fused(scene, cfg5, cam5, st0,
                                                1234, spp)
    planes = state_to_planes(st0)
    rr = int(mega_regen.regen_call(scene, cfg5.with_(backend="pallas"), cam5,
                                   planes, 1234, spp, 0, 2.0, cfg5.depth))
    torch.cuda.synchronize()
    ran = mega_regen.INSTANCE_LAUNCHES[
        "wf_fused", "fused_tail_kernel"] - before
    med, frac, mx = image_gap(sk.rgb_sum[:n].cpu().numpy(),
                              sp.rgb_sum[:n].cpu().numpy())
    same = torch.equal(sk.rgb_sum, planes[0:3].T) and int(sk.rays) == rr
    print(f"[wf-fused-tail] 1080p depth 30 {spp} spp: {ran} launch of the "
          f"tail instance; against the plain pool: image median {med:.2e}, "
          f"{frac:.2%} pixels > 1e-2, max {mx:.3g}; = regen kernel with "
          f"photons off, rgb_sum bit for bit and rays: {same} "
          f"({int(sk.rays)} vs {rr})")
    check_rays("tail instance vs plain pool", int(sk.rays), int(sp.rays))
    if not (ran == 1 and same and med < 1e-4 and frac < 0.02
            and bool((sk.n_samples[:n] == spp).all())):
        raise AssertionError("the tail instance differs")
    tail_ms = {}
    for s in (spp, 64):
        lanes0 = wavefront_fused.lane_counts(st0.device).clone()
        call_ms, by_name, _ = profiled(
            lambda s=s: wavefront_fused._launch(scene, cfg5, cam5, st0, 1234,
                                                s), 3)
        trips, lanes = (wavefront_fused.lane_counts(st0.device)
                        - lanes0).tolist()
        tail_ms[s] = launch_device_ms(by_name, "fused_tail_kernel", 3) \
            or call_ms
        print(f"  {s} spp: kernel {tail_ms[s]:.4f} ms of device time "
              f"({recorded('fused_tail_kernel')} of 3 launches recorded; "
              f"{call_ms:.3f} ms per wrapper call), lane share "
              f"{lanes / (32 * trips):.4f}")
    report["wf_fused_tail"] = dict(
        max_abs_err=mx, ms=tail_ms[spp], plain_ms=plain_ms,
        # rgb_sum (P, 3) read and written
        **bound(n * 12 * 2, int(sk.rays) * OPS_PER_SEGMENT))
    print(f"  {spp} spp: plain pool {plain_ms:.1f} ms; bound "
          f"{report['wf_fused_tail']['bound_ms']:.4f} ms")
    return drive("config5-tail", scene, cfg5, cam5, spp, ["wf_fused_tail"],
                 gpu)


def many_light_phases() -> None:
    """[many-lights] tpurt's many-light scene (a Cornell room under a grid
    of area lights) past the 16 lights the kernels once took: 20 lights at
    256x144, depth 30, with the scene rows staged in shared memory, and 128
    at 128x72, depth 4, past path.cuh STAGE_MAX_FLOATS (4096 floats; a
    light row is 40), so the kernels read the rows from global memory. The
    regen kernel against render_plain, every plane bit for bit; the fused
    kernel and the pool with the sweep kernel against the plain pool, rays
    and sample counts exact and the image rule."""
    import tpurt_torch as tt
    for n_lights, (w, h), depth in ((20, (256, 144), 30),
                                    (128, (128, 72), 4)):
        scene = tt.many_light_scene(n_lights)
        cfg = tt.RenderConfig(width=w, height=h, depth=depth, k_photons=2,
                              max_photon_bounces=3, wf_pool=16384,
                              backend="pallas")
        cam = tt.make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                             aspect_ratio=w / h)
        light_floats = 40 * n_lights
        where = ("past the shared-memory budget: rows read from global "
                 "memory" if light_floats > 4096 else "rows staged")
        regen_vs_plain(f"{n_lights} lights ({light_floats} floats of light "
                       f"rows, {where})", scene, cfg, cam, 5, 2, 0,
                       phase="many-lights")
        c = cfg.with_(enable_photons=False, backend="wavefront")
        plain = tt.render(scene, c, cam, tt.init_state(c), 5, 2)
        n = c.n_pixels
        for backend in ("wavefront_pallas", "wavefront_fused"):
            kc = c.with_(backend=backend)
            st = tt.render(scene, kc, cam, tt.init_state(kc), 5, 2)
            torch.cuda.synchronize()
            med, frac, mx = image_gap(st.rgb_sum[:n].cpu().numpy(),
                                      plain.rgb_sum[:n].cpu().numpy())
            same_n = torch.equal(st.n_samples[:n], plain.n_samples[:n])
            print(f"[many-lights] {n_lights} lights {backend} vs wavefront "
                  f"2 spp: rays {int(st.rays)} vs {int(plain.rays)}, sample "
                  f"counts equal {same_n}, image median {med:.2e}, "
                  f"{frac:.2%} pixels > 1e-2")
            if int(st.rays) != int(plain.rays) or not same_n \
                    or not (med < 1e-4 and frac < 0.01):
                raise AssertionError(f"{backend} differs from the plain pool "
                                     f"with {n_lights} lights")


# the emission flags of [emission] (the sky with its blackbody and ramp,
# the clamp), beside bench config 4's sampler flags
EMIT_FLAGS = dict(sky_intensity=0.2, sky_temp=6500.0, sky_gradient=True,
                  radiance_clamp=20.0)


def emission_scene():
    """tpurt_torch.scene.dispersive_scene's materials, spheres and lights
    (tpurt's bench configs 4 and 5) plus one emitter, a sphere of radius
    0.5 at (0, 3, 2) in view of config 5's camera."""
    import tpurt_torch as tt
    from tpurt_torch.scene import Light, Material, Sphere
    materials = [Material.diffuse((0.8, 0.8, 0.8)),
                 Material.dielectric(1.52, 0.0),
                 Material.dielectric(1.72, 0.0),
                 Material.metal((1.0, 0.71, 0.29), 0.05),
                 Material.diffuse((0.3, 0.3, 0.8)),
                 Material.emissive((0.4, 0.8, 1.0), 8.0)]
    spheres = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
               Sphere(1, 1.0, (-2.2, 1.0, 4.0)),
               Sphere(2, 1.0, (0.0, 1.0, 4.5)),
               Sphere(3, 1.0, (2.2, 1.0, 4.0)),
               Sphere(4, 0.7, (0.0, 0.7, 7.0)),
               Sphere(5, 0.5, (0.0, 3.0, 2.0))]
    lights = [Light.point([0.0, 8.0, 0.0], [1.0, 1.0, 1.0], 60.0, 5500.0),
              Light.square_area([6.0, 4.0, 4.0], [-1.0, -0.3, 0.0], 2.0,
                                [1.0, 1.0, 1.0], 4.0, 3200.0)]
    return tt.build_scene(materials, spheres, (), lights)


def launch_times(label, fn, part, base=None, base_part=None) -> float:
    """CUDA-event ms of fn (mean of 3 after a warm-up), the device ms of a
    launch of the kernels named ``part`` under torch.profiler (3 runs; the
    mean of the launches the session recorded: chip_ab.py, whose fresh
    processes record every launch, gives the device ms of these launches
    too) and the idle share of the profiled wall time; the same for
    ``base``, the launch without the flags, in the same call. Returns the
    events' ms."""
    out = []
    for name, f, kpart in ((label, fn, part),
                           ("without the flags", base, base_part)):
        if f is None:
            continue
        ev = cuda_ms(f, 3)
        wall, by_name, busy = profiled(f, 3)
        out.append(ev)
        print(f"  {name}: {ev:.4f} ms by CUDA events; under torch.profiler "
              f"{launch_device_ms(by_name, kpart, 3):.4f} ms of device time "
              f"a launch ({kpart}, mean of the {recorded(kpart)} launches "
              f"recorded in 3 runs), idle share {idle_share(wall, busy)}")
    return out[0]


def fused_budget_pair(scene, cfg, cam, dev):
    """The fused kernel's budget launch (budgets 0-4, seed 8, the
    [wf-fused] map) against its plain version, the budget pool: rays and
    sample counts exact, the image rule. Returns the budgets."""
    import tpurt_torch as tt
    from tpurt_torch.kernels import wavefront_fused
    st0 = tt.init_state(cfg)
    budgets = budget_map(st0.n_samples.shape[0], cfg.n_pixels, 4, 8, dev)
    sk = wavefront_fused.wavefront_render_budget_fused(scene, cfg, cam, st0,
                                                       1234, budgets, 4)
    sp = tt.wavefront_render_budget(scene, cfg, cam, st0, 1234, budgets, 4)
    torch.cuda.synchronize()
    n = cfg.n_pixels
    med, frac, mx = image_gap(sk.rgb_sum[:n].cpu().numpy(),
                              sp.rgb_sum[:n].cpu().numpy())
    same_n = torch.equal(sk.n_samples, sp.n_samples)
    print(f"  fused budget launch {cfg.width}x{cfg.height} budgets 0-4: "
          f"rays {int(sk.rays)} vs plain {int(sp.rays)}, sample counts "
          f"equal {same_n}, image median {med:.2e}, {frac:.2%} pixels > "
          f"1e-2")
    if int(sk.rays) != int(sp.rays) or not same_n \
            or not (med < 1e-4 and frac < 0.02):
        raise AssertionError("the fused budget launch differs from the "
                             "budget pool")
    return budgets


def fused_equals_regen(scene, cfg, cam, spp) -> None:
    """The fused kernel against the regen kernel with photons off, which
    adds each pixel's samples in the same order: rgb_sum and rays bit for
    bit."""
    import tpurt_torch as tt
    from tpurt_torch.kernels import mega_regen, wavefront_fused
    from tpurt_torch.render import state_to_planes
    st0 = tt.init_state(cfg)
    planes = state_to_planes(st0)
    rr = int(mega_regen.regen_call(scene, cfg.with_(backend="pallas"), cam,
                                   planes, 1234, spp, 0, 2.0, cfg.depth))
    sf = wavefront_fused.wavefront_render_fused(scene, cfg, cam, st0, 1234,
                                                spp)
    same = torch.equal(sf.rgb_sum, planes[0:3].T) and int(sf.rays) == rr
    print(f"  {cfg.width}x{cfg.height} {spp} spp: fused kernel = regen "
          f"kernel with photons off, rgb_sum and rays bit for bit: {same} "
          f"({int(sf.rays)} vs {rr})")
    if not same:
        raise AssertionError("the fused kernel differs from the regen "
                             "kernel with photons off")


def wf_hero_phases(dev, report, gpu) -> dict:
    """[wf-hero] bench config 4's sampler flags (4 hero wavelengths,
    camera-path dispersion, the collapse) on config 5's scene, camera and
    pool (1080p, depth 30, photons off, wf_pool=262144): one sweep of the
    sweep kernel's sampler instance against wavefront._step bit for bit;
    the fused kernel's sampler instance at 4 spp and in a budget launch
    and wavefront_pallas at 1 spp against the plain pool (rays exact, the
    image rule); the fused kernel against the regen kernel with photons
    off bit for bit; each launch timed beside config 5's own; then the two
    main paths through the public entry points."""
    import tpurt_torch as tt
    from tpurt_torch import wavefront
    from tpurt_torch.kernels import wavefront_fused
    from tpurt_torch.scene import freeze_scene
    scene = tt.dispersive_scene()
    fs = freeze_scene(scene)
    cfg = tt.RenderConfig(width=1920, height=1080, depth=30,
                          backend="wavefront_fused", enable_photons=False,
                          wf_pool=262144, **CONFIG4)
    cfg5 = cfg.with_(hero_wavelengths=1, dispersion_in_camera_path=False)
    cam = dispersive_camera(cfg)
    work = wavefront.PoolWork(camera=cam, base_seed=1234, spp=1,
                              n_valid=cfg.n_pixels)
    entry = sweep_vs_step("wf-hero", fs, cfg, work, dev,
                          "pool_step_kernel<true")
    report["wf_sweep_sampler"] = entry
    print("[wf-hero] wavefront_fused and wavefront_pallas vs wavefront:")
    err, rays = pool_pair(scene, cfg, cam, "wavefront_fused", 4)
    pool_pair(scene, cfg, cam, "wavefront_pallas", 1)
    budgets = fused_budget_pair(scene, cfg, cam, dev)
    fused_equals_regen(scene, cfg, cam, 1)
    st0 = tt.init_state(cfg)
    aux = torch.stack([budgets.float(), st0.n_samples]).contiguous()
    ms = {}
    for mode, spp, aux_m in (("1 spp", 1, None), ("4 spp", 4, None),
                             ("budgets 0-4", 0, aux)):
        print(f"[wf-hero] fused kernel 1080p depth 30 {mode}:")
        ms[mode] = launch_times(
            "hero 4, dispersion", lambda: wavefront_fused._launch(
                scene, cfg, cam, st0, 1234, spp, aux_m),
            "fused_sampler_kernel",
            lambda: wavefront_fused._launch(scene, cfg5, cam, st0, 1234, spp,
                                            aux_m), "fused_kernel")
    one = tt.init_state(cfg)
    report["wf_fused_sampler"] = dict(
        max_abs_err=err, ms=ms["4 spp"],
        plain_ms=cuda_ms(lambda: wavefront.wavefront_render(
            scene, cfg, cam, one, 1234, 4), 1),
        **bound(cfg.n_pixels * 12 * 2, rays * OPS_PER_SEGMENT))
    print(f"  4 spp: plain pool {report['wf_fused_sampler']['plain_ms']:.1f}"
          f" ms; bound {report['wf_fused_sampler']['bound_ms']:.4f} ms")
    print("[wf-hero] wavefront_pallas render 1080p 1 spp (sweep launches):")
    cfg_p = cfg.with_(backend="wavefront_pallas")
    launch_times(
        "hero 4, dispersion", lambda: tt.render(scene, cfg_p, cam,
                                                tt.init_state(cfg_p), 1234,
                                                1),
        "pool_step_kernel<true",
        lambda: tt.render(scene, cfg5.with_(backend="wavefront_pallas"), cam,
                          tt.init_state(cfg_p), 1234, 1), "pool_step_kernel")
    launches = drive("wf-hero", scene, cfg, cam, 4,
                     ["wf_fused_sampler", "blit"], gpu)
    launches.update(drive("wf-hero", scene, cfg_p, cam, 1,
                          ["wf_sweep_sampler", "blit"], gpu))
    launches.pop("blit")
    return launches


def emission_phases(dev, report, gpu) -> dict:
    """[emission] the kernels' emission instances on emission_scene() with
    EMIT_FLAGS and bench config 4's sampler flags at tpurt's bench shapes
    (1080p, depth 30): the regen kernel (1 spp, then one budget launch of
    budgets 0-2), the tile-sync kernel (1 sample), against render_plain
    and render_plain_budget on every plane bit for bit; with photons off
    the fused kernel (1 spp; also against the regen kernel bit for bit)
    and wavefront_pallas (1 spp) against the plain pool, and one sweep
    against wavefront._step bit for bit. Then the reference sampler with
    the emission flags and sky_gradient alone (the wavefront tracers'
    legacy ramp) at 256x144; the G leaf with the emission flags (config
    6 as shipped, sky and clamp) at 256x144; each launch timed beside
    config 4's or 5's without the flags; then the main paths."""
    import tpurt_torch as tt
    from tpurt_torch import wavefront
    from tpurt_torch.kernels import mega_regen, mega_step, wavefront_fused
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene
    scene = emission_scene()
    fs = freeze_scene(scene)
    disp = tt.dispersive_scene()
    flags = dict(CONFIG4, **EMIT_FLAGS)
    cfg = tt.RenderConfig(width=1920, height=1080, depth=30,
                          backend="pallas", wf_pool=262144, **flags)
    cfg4 = tt.RenderConfig(width=1920, height=1080, depth=30,
                           backend="pallas", **CONFIG4)
    cam = dispersive_camera(cfg)

    # the regen kernel, uniform and budget mode, and the tile-sync kernel
    rk, _, p_s = regen_vs_plain("hero 4, dispersion, emission", scene,
                                cfg, cam, 1234, 1, 0, phase="emission")
    planes = state_to_planes(tt.init_state(cfg))
    print("[emission] regen kernel 1080p 1 spp:")
    ms = launch_times("emission", lambda: mega_regen.regen_call(
        scene, cfg, cam, planes.clone(), 1234, 1, 0, 2.0, 30),
        "regen_emit_kernel", lambda: mega_regen.regen_call(
            disp, cfg4, cam, planes.clone(), 1234, 1, 0, 2.0, 30),
        "regen_")
    report["regen_emit"] = dict(max_abs_err=0.0, ms=ms, plain_ms=p_s * 1e3,
                                **path_bound(cfg.n_pixels, rk))
    budget_vs_plain("emission", scene, cfg, cam, dev)
    rk1, plain_step = step_vs_plain("emission", scene, cfg, cam, 3, 1.5)
    ms = launch_times("emission", lambda: mega_step.step_call(
        scene, cfg, cam, planes.clone(), 1234, 3, 1.5, 30),
        "regen_emit_kernel", lambda: mega_step.step_call(
            disp, cfg4, cam, planes.clone(), 1234, 3, 1.5, 30),
        "step_kernel")
    report["tile_sync_emit"] = dict(max_abs_err=0.0, ms=ms,
                                    plain_ms=plain_step,
                                    **path_bound(cfg.n_pixels, rk1))

    # the wavefront kernels, photons off
    cfg_w = cfg.with_(enable_photons=False, backend="wavefront_fused")
    cfg5 = tt.RenderConfig(width=1920, height=1080, depth=30,
                           backend="wavefront_fused", enable_photons=False,
                           wf_pool=262144)
    work = wavefront.PoolWork(camera=cam, base_seed=1234, spp=1,
                              n_valid=cfg.n_pixels)
    report["wf_sweep_emit"] = sweep_vs_step(
        "emission", fs, cfg_w, work, dev, "pool_step_kernel<true")
    print("[emission] wavefront_fused and wavefront_pallas vs wavefront:")
    err, rays = pool_pair(scene, cfg_w, cam, "wavefront_fused", 1)
    pool_pair(scene, cfg_w, cam, "wavefront_pallas", 1)
    fused_equals_regen(scene, cfg_w, cam, 1)
    st0 = tt.init_state(cfg_w)
    print("[emission] fused kernel 1080p 1 spp:")
    ms = launch_times("emission", lambda: wavefront_fused._launch(
        scene, cfg_w, cam, st0, 1234, 1), "fused_sampler_kernel",
        lambda: wavefront_fused._launch(disp, cfg5, cam, st0, 1234, 1),
        "fused_kernel")
    report["wf_fused_emit"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=cuda_ms(lambda: wavefront.wavefront_render(
            scene, cfg_w, cam, st0, 1234, 1), 1),
        **bound(cfg.n_pixels * 12 * 2, rays * OPS_PER_SEGMENT))
    print("[emission] wavefront_pallas render 1080p 1 spp:")
    cfg_p = cfg_w.with_(backend="wavefront_pallas")
    launch_times(
        "emission", lambda: tt.render(scene, cfg_p, cam, tt.init_state(cfg_p),
                                      1234, 1), "pool_step_kernel<true",
        lambda: tt.render(disp, cfg5.with_(backend="wavefront_pallas"), cam,
                          tt.init_state(cfg_p), 1234, 1), "pool_step_kernel")

    # the reference sampler with the emission flags, and the legacy ramp
    small = dict(width=256, height=144, depth=30, wf_pool=16384)
    ref = tt.RenderConfig(backend="pallas", **small, **EMIT_FLAGS)
    cam_s = dispersive_camera(ref)
    regen_vs_plain("reference sampler, emission", scene, ref, cam_s, 1234, 2,
                   0, phase="emission")
    step_vs_plain("emission", scene, ref, cam_s, 0, 2.0)
    for label, c in (("reference sampler, emission",
                      ref.with_(enable_photons=False)),
                     ("sky_gradient alone (legacy ramp)",
                      tt.RenderConfig(enable_photons=False, sky_gradient=True,
                                      **small))):
        print(f"[emission] {label}:")
        for backend in ("wavefront_fused", "wavefront_pallas"):
            pool_pair(scene, c, cam_s, backend, 2)
        w = wavefront.PoolWork(camera=cam_s, base_seed=1234, spp=1,
                               n_valid=c.n_pixels)
        sweep_vs_step("emission", fs, c, w, dev, "pool_step_kernel<true")

    # the G leaf with the emission flags: config 6 as shipped, sky, clamp
    torus = tt.torus_mesh_scene(45, 45)
    g_flags = dict(CONFIG6, pallas_mxu_leaf=True, sky_intensity=0.2,
                   sky_temp=6500.0, radiance_clamp=20.0)
    g_cfg = tt.RenderConfig(backend="pallas", **{**small, **g_flags})
    cam_g = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=256 / 144)
    g_emit = ("regen", "regen_emit_kernel<true>")
    before = mega_regen.INSTANCE_LAUNCHES[g_emit]
    rg, _, g_p = regen_vs_plain("config 6 as shipped, G leaf, sky, clamp",
                                torus, g_cfg, cam_g, 1234, 1, 0,
                                phase="emission")
    if mega_regen.INSTANCE_LAUNCHES[g_emit] != before + 1:
        raise AssertionError("the G-leaf emission instance did not run")
    pl_g = state_to_planes(tt.init_state(g_cfg))
    g_ms = cuda_ms(lambda: mega_regen.regen_call(
        torus, g_cfg, cam_g, pl_g.clone(), 1234, 1, 0, 2.0, 30), 3)
    g_main = tt.RenderConfig(width=1920, height=1080, depth=30,
                             backend="pallas", **g_flags)
    cam6 = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=16 / 9)
    pl6 = state_to_planes(tt.init_state(g_main))
    print("[emission] G-leaf regen kernel 1080p 1 spp:")
    ms = launch_times("G leaf, emission", lambda: mega_regen.regen_call(
        torus, g_main, cam6, pl6.clone(), 1234, 1, 0, 2.0, 30),
        "regen_emit_kernel", lambda: mega_regen.regen_call(
            torus, g_main.with_(sky_intensity=0.0, radiance_clamp=0.0), cam6,
            pl6.clone(), 1234, 1, 0, 2.0, 30), "regen_")
    # held against the plain G sweep at 256x144 (whose 1080p render takes
    # ~70 s): ms, plain_ms and the bound there, the 1080p device ms beside
    report["regen_emit_gleaf"] = dict(
        max_abs_err=0.0, ms=g_ms, plain_ms=g_p * 1e3, ms_1080p=ms,
        **path_bound(g_cfg.n_pixels, rg))

    # the main paths through the public entry points
    launches = drive("emission", scene, cfg, cam, 4, ["regen_emit", "blit"],
                     gpu)
    launches.update(drive("emission", scene, cfg.with_(pallas_regen=False),
                          cam, 4, ["tile_sync_emit", "blit"], gpu))
    launches.update(drive("emission", scene, cfg_w, cam, 4,
                          ["wf_fused_emit", "blit"], gpu))
    launches.update(drive("emission", scene, cfg_p, cam, 1,
                          ["wf_sweep_emit", "blit"], gpu))
    g_launch = drive("emission", torus, g_main, cam6, 1,
                     ["regen_emit", "mxu_leaf", "blit"], gpu)
    launches["regen_emit_gleaf"] = min(g_launch["regen_emit"],
                                       g_launch["mxu_leaf"])
    launches.pop("blit")
    return launches


# the camera flags of [spawn]: the Sobol spawn, the thin lens and the
# shutter of a MotionCamera together
SPAWN_FLAGS = dict(qmc=True, aperture=0.1, focus_dist=12.0, motion_blur=True)


def cornell_camera(cfg, motion: bool = False):
    """The Cornell camera (CAM); with ``motion`` a MotionCamera whose
    shutter-close pose moves to (0.4, 5.2, -11.8), still aimed at the
    box."""
    import tpurt_torch as tt
    c0 = tt.make_camera(**CAM, aspect_ratio=cfg.width / cfg.height)
    if not motion:
        return c0
    c1 = tt.make_camera((0.4, 5.2, -11.8), CAM["look_at"], vfov=CAM["vfov"],
                        aspect_ratio=cfg.width / cfg.height)
    return tt.MotionCamera(c0, c1)


def spawn_phases(dev, report, gpu) -> dict:
    """[spawn] the spawn instances with tpurt's camera-spawn extensions on
    Cornell: tpurt's "quality" and "fast" presets (hero 4 and the Sobol
    spawn; fast also photon_rr_scale 0.5: the instances with the sampler
    flags) and SPAWN_FLAGS (Sobol spawn, thin lens, shutter: the reference
    sampler's instances). At 256x144, depth 8: the regen kernel under each
    against render_plain, its budget mode and the tile-sync kernel under
    qmc and the lens against their plain versions, every plane bit for
    bit; with photons off under SPAWN_FLAGS and under quality the fused
    kernel against the regen kernel bit for bit and against the plain
    pool, wavefront_pallas against the plain pool, one sweep against
    wavefront._step bit for bit. At 1080p, depth 30 (the main path's
    shapes): the regen kernel under each of the three and the tile-sync
    kernel under SPAWN_FLAGS against render_plain, the fused kernel against
    the regen kernel and one sweep against wavefront._step, bit for bit;
    each launch timed beside the same launch without the flags; then the
    main paths."""
    import tpurt_torch as tt
    from tpurt_torch import wavefront
    from tpurt_torch.kernels import mega_regen, mega_step, wavefront_fused
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene
    scene = tt.cornell_spheres_scene()
    fs = freeze_scene(scene)
    presets = {"quality": tt.RenderConfig.PRESETS["quality"],
               "fast": tt.RenderConfig.PRESETS["fast"],
               "qmc+lens+shutter": SPAWN_FLAGS}
    qmc_lens = dict(qmc=True, aperture=0.1, focus_dist=12.0)

    # 256x144, depth 8: each spawn instance against its plain version
    small = dict(width=256, height=144, depth=8, backend="pallas",
                 wf_pool=16384)
    for label, flags in presets.items():
        cfg = tt.RenderConfig(**small, **flags)
        regen_vs_plain(label, scene, cfg,
                       cornell_camera(cfg, cfg.motion_blur), 1234, 2, 3,
                       phase="spawn")
    cfg = tt.RenderConfig(**small, **qmc_lens)
    cam = cornell_camera(cfg)
    budget_vs_plain("spawn", scene, cfg, cam, dev)
    step_vs_plain("spawn", scene, cfg, cam, 1, 1.5,
                  tt.render(scene, cfg, cam, tt.init_state(cfg), 1234, 1))
    for label in ("qmc+lens+shutter", "quality"):
        cfg_w = tt.RenderConfig(**dict(small, backend="wavefront_fused"),
                                enable_photons=False, **presets[label])
        cam_w = cornell_camera(cfg_w, cfg_w.motion_blur)
        print(f"[spawn] {label} wavefront_fused and wavefront_pallas vs "
              f"wavefront, 256x144:")
        pool_pair(scene, cfg_w, cam_w, "wavefront_fused", 2)
        pool_pair(scene, cfg_w, cam_w, "wavefront_pallas", 2)
        fused_equals_regen(scene, cfg_w, cam_w, 2)
        sweep_vs_step("spawn", fs, cfg_w, wavefront.PoolWork(
            camera=cam_w, base_seed=1234, spp=1, n_valid=cfg_w.n_pixels),
            dev, "tpurt::Spawn>")

    # 1080p, depth 30: the main path's shapes
    big = dict(width=1920, height=1080, depth=30, wf_pool=262144)
    cfg = tt.RenderConfig(backend="pallas", **big, **SPAWN_FLAGS)
    cam = cornell_camera(cfg, True)
    rk, _, p_s = regen_vs_plain("qmc+lens+shutter", scene, cfg, cam, 1234,
                                1, 0, phase="spawn")
    for label in ("quality", "fast"):
        c = tt.RenderConfig.preset(label, backend="pallas", **big)
        regen_vs_plain(label, scene, c, cornell_camera(c), 1234, 1, 0,
                       phase="spawn")
    cfg_w = cfg.with_(backend="wavefront_fused", enable_photons=False)
    fused_equals_regen(scene, cfg_w, cam, 1)
    work = wavefront.PoolWork(camera=cam, base_seed=1234, spp=1,
                              n_valid=cfg.n_pixels)
    report["wf_sweep_spawn"] = sweep_vs_step("spawn", fs, cfg_w, work, dev,
                                             "tpurt::Spawn>")
    ref = tt.RenderConfig(backend="pallas", **big)
    cam0 = cornell_camera(ref)
    planes = state_to_planes(tt.init_state(ref))
    rk1, plain_step = step_vs_plain("spawn", scene, cfg, cam, 3, 1.5)

    # each launch at 1080p beside the same launch without the flags
    ms = {}
    for label, flags in presets.items():
        # the same launch without the spawn flags: hero 4 alone (the
        # sampler instance) for the presets, the reference for the rest
        c = ref.with_(**flags)
        base = ref.with_(hero_wavelengths=c.hero_wavelengths)
        cm = cornell_camera(c, c.motion_blur)
        print(f"[spawn] regen kernel 1080p 1 spp, {label}:")
        ms[label] = launch_times(
            label, lambda: mega_regen.regen_call(
                scene, c, cm, planes.clone(), 1234, 1, 0, 2.0, 30),
            "regen_spawn_kernel", lambda: mega_regen.regen_call(
                scene, base, cam0, planes.clone(), 1234, 1, 0, 2.0, 30),
            "regen_")
    report["regen_spawn"] = dict(
        max_abs_err=0.0, ms=ms["qmc+lens+shutter"], ms_quality=ms["quality"],
        ms_fast=ms["fast"], plain_ms=p_s * 1e3,
        **path_bound(cfg.n_pixels, rk))
    print("[spawn] tile-sync kernel 1080p sample 3, qmc+lens+shutter:")
    report["tile_sync_spawn"] = dict(
        max_abs_err=0.0, plain_ms=plain_step,
        ms=launch_times("qmc+lens+shutter", lambda: mega_step.step_call(
            scene, cfg, cam, planes.clone(), 1234, 3, 1.5, 30),
            "regen_spawn_kernel", lambda: mega_step.step_call(
                scene, ref, cam0, planes.clone(), 1234, 3, 1.5, 30),
            "step_kernel"), **path_bound(cfg.n_pixels, rk1))
    st0 = tt.init_state(cfg_w)
    ref_w = ref.with_(backend="wavefront_fused", enable_photons=False)
    print("[spawn] fused kernel 1080p 1 spp, qmc+lens+shutter:")
    f_ms = launch_times("qmc+lens+shutter", lambda: wavefront_fused._launch(
        scene, cfg_w, cam, st0, 1234, 1), "fused_spawn_kernel",
        lambda: wavefront_fused._launch(scene, ref_w, cam0, st0, 1234, 1),
        "fused_kernel")
    err, rays = pool_pair(scene, cfg_w, cam, "wavefront_fused", 1)
    report["wf_fused_spawn"] = dict(
        max_abs_err=err, ms=f_ms,
        plain_ms=cuda_ms(lambda: wavefront.wavefront_render(
            scene, cfg_w, cam, st0, 1234, 1), 1),
        **bound(cfg.n_pixels * 12 * 2, rays * OPS_PER_SEGMENT))
    print("[spawn] wavefront_pallas render 1080p 1 spp, qmc+lens+shutter:")
    cfg_p = cfg_w.with_(backend="wavefront_pallas")
    launch_times(
        "qmc+lens+shutter", lambda: tt.render(scene, cfg_p, cam,
                                              tt.init_state(cfg_p), 1234, 1),
        "tpurt::Spawn>",
        lambda: tt.render(scene, ref_w.with_(backend="wavefront_pallas"),
                          cam0, tt.init_state(cfg_p), 1234, 1),
        "pool_step_kernel")

    # the main paths through the public entry points: tpurt's presets on
    # the regen kernel (fast traces fewer photon segments than quality) and
    # the tile-sync kernel, the camera flags on all four kernels
    launches, segs = {}, {}
    for label in ("quality", "fast"):
        c = tt.RenderConfig.preset(label, backend="pallas", **big)
        got = drive("spawn", scene, c, cam0, 1, ["regen_spawn", "blit"], gpu)
        segs[label] = int(tt.render(scene, c, cam0, tt.init_state(c), 1234,
                                    1).rays)
        launches["regen_spawn"] = min(launches.get("regen_spawn", 1 << 30),
                                      got["regen_spawn"])
    print(f"[spawn] 1080p 1 spp segments: quality {segs['quality']}, fast "
          f"{segs['fast']} ({segs['fast'] / segs['quality'] - 1:+.1%})")
    if not segs["fast"] < segs["quality"]:
        raise AssertionError("photon_rr_scale 0.5 did not thin the photon "
                             "walks")
    launches["regen_spawn"] = min(launches["regen_spawn"], drive(
        "spawn", scene, cfg, cam, 1, ["regen_spawn", "blit"],
        gpu)["regen_spawn"])
    launches.update(drive("spawn", scene, cfg.with_(pallas_regen=False), cam,
                          1, ["tile_sync_spawn", "blit"], gpu))
    launches.update(drive("spawn", scene, cfg_w, cam, 1,
                          ["wf_fused_spawn", "blit"], gpu))
    launches.update(drive("spawn", scene, cfg_p, cam, 1,
                          ["wf_sweep_spawn", "blit"], gpu))
    launches.pop("blit")
    return launches


def step_vs_plain(tag, scene, cfg, cam, it: int, radius: float,
                  state=None):
    """[tag] one tile-sync launch (sample ``it`` at ``radius``, on the
    planes of ``state``, a fresh state by default) against render_plain
    with one sample, every plane bit for bit. Returns (rays, plain ms)."""
    import tpurt_torch as tt
    from tpurt_torch import integrate
    from tpurt_torch.kernels import mega_step
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene
    planes = state_to_planes(tt.init_state(cfg) if state is None else state)
    pk, pp = planes.clone(), planes.clone()
    rk = int(mega_step.step_call(scene, cfg, cam, pk, 1234, it, radius,
                                 cfg.depth))
    t0 = time.perf_counter()
    rp = int(integrate.render_plain(freeze_scene(scene), cfg, cam, pp, 1234,
                                    1, it, radius, cfg.depth))
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = unequal_planes(pk, pp)
    print(f"[{tag}] tile-sync kernel {cfg.width}x{cfg.height} depth "
          f"{cfg.depth} sample {it}: rays {rk} vs plain {rp}, unequal planes "
          f"{bad}")
    if rk != rp or bad:
        raise AssertionError(f"{tag}: the tile-sync kernel differs from "
                             f"render_plain")
    return rk, plain_ms


def budget_vs_plain(tag, scene, cfg, cam, dev, hi: int = 2):
    """[tag] one budget launch of the regen kernel (budgets 0-hi after one
    uniform sample) against render_plain_budget, every plane bit for bit.
    Returns (rays, kernel ms by CUDA events, plain ms)."""
    import tpurt_torch as tt
    from tpurt_torch import integrate
    from tpurt_torch.kernels import mega_regen
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene
    st1 = tt.render(scene, cfg, cam, tt.init_state(cfg), 1234, 1)
    b = budget_map(st1.n_samples.shape[0], cfg.n_pixels, hi, 5, dev)
    pl = state_to_planes(st1)
    bk, bp = pl.clone(), pl.clone()
    rk = int(mega_regen.regen_budget_call(scene, cfg, cam, bk, 1234, b,
                                          st1.n_samples))
    t0 = time.perf_counter()
    rp = int(integrate.render_plain_budget(freeze_scene(scene), cfg, cam, bp,
                                           1234, b, st1.n_samples))
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = unequal_planes(bk, bp)
    print(f"[{tag}] regen budget launch {cfg.width}x{cfg.height} depth "
          f"{cfg.depth}, budgets 0-{hi} after 1 spp: rays {rk} vs plain "
          f"{rp}, unequal planes {bad}")
    if rk != rp or bad:
        raise AssertionError(f"{tag}: the regen kernel's budget mode differs "
                             f"from render_plain_budget")
    ms = cuda_ms(lambda: mega_regen.regen_budget_call(
        scene, cfg, cam, pl.clone(), 1234, b, st1.n_samples), 3)
    return rk, ms, plain_ms


def adaptive_path(tag, scene, cfg, cam, kernels, gpu, spp: int = 4) -> dict:
    """[tag] render_adaptive(backend="pallas") through the public entry
    points, ``spp`` samples, pilot 2, with the launch counts of ``kernels``
    set to 0 just before and read just after; checks the sample counts,
    the image and that each kernel launched. Returns the counts."""
    import tpurt_torch as tt
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, budgets = tt.render_adaptive(scene, cfg, cam, base_seed=1234,
                                     spp=spp, pilot_spp=2)
    img = tt.resolve_image(cfg, st)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(kernels)
    n = cfg.n_pixels
    ok = bool((st.n_samples[:n] == 2 + budgets[:n].float()).all())
    print(f"[{tag}] render_adaptive pallas {cfg.width}x{cfg.height} depth "
          f"{cfg.depth}, spp {spp} pilot 2: {secs:.3f} s, rays "
          f"{int(st.rays)}, {int(st.rays) / secs / 1e6:.1f} Mrays/s, "
          f"budgets mean {float(budgets[:n].float().mean()):.3f} max "
          f"{int(budgets[:n].max())}, n_samples = 2 + budget: {ok}, "
          f"launches {launches} | {gpu}")
    if not ok or not bool(torch.isfinite(img).all()) \
            or min(launches.values()) < 1:
        raise AssertionError(f"{tag}: render_adaptive (pallas) failed")
    return launches


def lights_phases(dev, report, gpu) -> dict:
    """[lights] the lights instances with tpurt's many-light NEE
    (light_sample "power" and "spatial": one light a diffuse hit, chosen by
    power) on tpurt's many-light scene with 20 lights (rows staged in
    shared memory) and 128 (rows read from global memory), bench config
    1's photons (K 4). At 256x144, depth 8, for both scenes: the regen
    kernel under both modes against render_plain, the tile-sync kernel
    and a budget launch against their plain versions, every plane bit for
    bit; with photons off the fused kernel against the regen kernel bit
    for bit and the fused and wavefront_pallas backends against the plain
    pool, one sweep against wavefront._step bit for bit. At 1080p, depth
    30 (the main path's shapes): the regen kernel (20 lights "spatial",
    128 "power"), the tile-sync kernel, a budget launch, the fused kernel
    and one sweep the same way; every 1080p regen launch's segments and
    device ms beside the same launch with "all"; then the main paths,
    render_adaptive among them."""
    import tpurt_torch as tt
    from tpurt_torch import wavefront
    from tpurt_torch.kernels import mega_regen, mega_step, wavefront_fused
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene
    scenes = {n: tt.many_light_scene(n) for n in (20, 128)}

    small = dict(width=256, height=144, depth=8, backend="pallas",
                 wf_pool=16384)
    for n, sc in scenes.items():
        fs = freeze_scene(sc)
        for mode in ("power", "spatial"):
            cfg = tt.RenderConfig(**small, light_sample=mode)
            regen_vs_plain(f"{n} lights {mode}", sc, cfg, cornell_camera(cfg),
                           1234, 2, 3, phase="lights")
        cfg = tt.RenderConfig(**small, light_sample="spatial" if n == 20
                              else "power")
        cam = cornell_camera(cfg)
        step_vs_plain("lights", sc, cfg, cam, 3, 1.5)
        budget_vs_plain("lights", sc, cfg, cam, dev)
        cfg_w = cfg.with_(backend="wavefront_fused", enable_photons=False)
        print(f"[lights] {n} lights {cfg.light_sample} wavefront_fused and "
              f"wavefront_pallas vs wavefront, 256x144:")
        pool_pair(sc, cfg_w, cam, "wavefront_fused", 2)
        pool_pair(sc, cfg_w, cam, "wavefront_pallas", 2)
        fused_equals_regen(sc, cfg_w, cam, 2)
        sweep_vs_step("lights", fs, cfg_w, wavefront.PoolWork(
            camera=cam, base_seed=1234, spp=1, n_valid=cfg_w.n_pixels), dev,
            "tpurt::Lights>")

    # 1080p, depth 30: the main path's shapes
    big = dict(width=1920, height=1080, depth=30, wf_pool=262144)
    sc20, sc128 = scenes[20], scenes[128]
    cfg = tt.RenderConfig(backend="pallas", light_sample="spatial", **big)
    cam = cornell_camera(cfg)
    rk, _, p_s = regen_vs_plain("20 lights spatial", sc20, cfg, cam, 1234, 1,
                                0, phase="lights")
    regen_vs_plain("128 lights power", sc128, cfg.with_(light_sample="power"),
                   cam, 1234, 1, 0, phase="lights")
    c_pow = cfg.with_(light_sample="power")
    rk1, plain_step = step_vs_plain("lights", sc20, c_pow, cam, 3, 1.5)
    rb, b_ms, b_plain = budget_vs_plain("lights", sc20, cfg, cam, dev)
    cfg_w = cfg.with_(backend="wavefront_fused", enable_photons=False)
    fused_equals_regen(sc20, cfg_w, cam, 1)
    report["wf_sweep_lights"] = sweep_vs_step(
        "lights", freeze_scene(sc128), cfg_w, wavefront.PoolWork(
            camera=cam, base_seed=1234, spp=1, n_valid=cfg.n_pixels), dev,
        "tpurt::Lights>")

    # each 1080p launch's segments and device ms beside mode "all"
    planes = state_to_planes(tt.init_state(cfg))
    regen = lambda sc, c: lambda: mega_regen.regen_call(  # noqa: E731
        sc, c, cam, planes.clone(), 1234, 1, 0, 2.0, 30)
    ms = {}
    for n, sc in scenes.items():
        segs = {m: int(regen(sc, cfg.with_(light_sample=m))())
                for m in ("all", "power", "spatial")}
        print(f"[lights] regen kernel 1080p 1 spp, {n} lights, segments: "
              + ", ".join(f"{m} {v}" for m, v in segs.items()))
        for i, mode in enumerate(("spatial", "power")):
            print(f"[lights] regen kernel 1080p 1 spp, {n} lights {mode}:")
            ms[n, mode] = launch_times(
                mode, regen(sc, cfg.with_(light_sample=mode)),
                "regen_lights_kernel",
                regen(sc, cfg.with_(light_sample="all")) if i == 0 else None,
                "regen_")
    report["regen_lights"] = dict(
        max_abs_err=0.0, ms=ms[20, "spatial"], ms_power=ms[20, "power"],
        ms_128_spatial=ms[128, "spatial"], ms_128_power=ms[128, "power"],
        plain_ms=p_s * 1e3, **path_bound(cfg.n_pixels, rk))
    report["regen_lights_budget"] = dict(
        max_abs_err=0.0, ms=b_ms, plain_ms=b_plain,
        **bound((16 * 2 + 3) * 4 * cfg.n_pixels, rb * OPS_PER_SEGMENT))
    print("[lights] tile-sync kernel 1080p sample 3, 20 lights power:")
    report["tile_sync_lights"] = dict(
        max_abs_err=0.0, plain_ms=plain_step,
        ms=launch_times("power", lambda: mega_step.step_call(
            sc20, c_pow, cam, planes.clone(), 1234, 3, 1.5, 30),
            "regen_lights_kernel", lambda: mega_step.step_call(
                sc20, c_pow.with_(light_sample="all"), cam, planes.clone(),
                1234, 3, 1.5, 30), "step_kernel"),
        **path_bound(cfg.n_pixels, rk1))
    st0 = tt.init_state(cfg_w)
    print("[lights] fused kernel 1080p 1 spp, 20 lights spatial:")
    f_ms = launch_times("spatial", lambda: wavefront_fused._launch(
        sc20, cfg_w, cam, st0, 1234, 1), "fused_lights_kernel",
        lambda: wavefront_fused._launch(
            sc20, cfg_w.with_(light_sample="all"), cam, st0, 1234, 1),
        "fused_kernel")
    err, rays = pool_pair(sc20, cfg_w, cam, "wavefront_fused", 1)
    report["wf_fused_lights"] = dict(
        max_abs_err=err, ms=f_ms,
        plain_ms=cuda_ms(lambda: wavefront.wavefront_render(
            sc20, cfg_w, cam, st0, 1234, 1), 1),
        **bound(cfg.n_pixels * 12 * 2, rays * OPS_PER_SEGMENT))
    cfg_p = cfg_w.with_(backend="wavefront_pallas")
    print("[lights] wavefront_pallas render 1080p 1 spp, 20 lights spatial:")
    pool_pair(sc20, cfg_w, cam, "wavefront_pallas", 1)
    launch_times(
        "spatial", lambda: tt.render(sc20, cfg_p, cam, tt.init_state(cfg_p),
                                     1234, 1), "tpurt::Lights>",
        lambda: tt.render(sc20, cfg_p.with_(light_sample="all"), cam,
                          tt.init_state(cfg_p), 1234, 1), "pool_step_kernel")

    # the main paths through the public entry points
    launches = {}
    launches.update(drive("lights", sc20, cfg, cam, 1,
                          ["regen_lights", "blit"], gpu))
    launches.update(drive("lights", sc20, c_pow.with_(pallas_regen=False),
                          cam, 1, ["tile_sync_lights", "blit"], gpu))
    launches.update(drive("lights", sc20, cfg_w, cam, 1,
                          ["wf_fused_lights", "blit"], gpu))
    launches.update(drive("lights", sc128, cfg_p, cam, 1,
                          ["wf_sweep_lights", "blit"], gpu))
    got = adaptive_path("lights", sc20, cfg, cam,
                        ["regen_lights", "regen_budget"], gpu)
    launches["regen_lights_budget"] = got["regen_budget"]
    launches.pop("blit")
    return launches


def aim_phases(dev, report, gpu) -> dict:
    """[aim] tpurt's aimed photon emission (photon_aim 0.5: an area light's
    photon aims at the pixel's vispoint half the time) in the regen
    kernel's lights instance, on Cornell at 1080p, depth 30, K 4: a
    uniform launch from iteration 2 and a budget launch (budgets 0-2)
    against render_plain and render_plain_budget, every plane bit for
    bit; the launch's device ms beside photon_aim 0; then the main path
    and render_adaptive."""
    import tpurt_torch as tt
    from tpurt_torch.kernels import mega_regen
    from tpurt_torch.render import radius_after, state_to_planes
    scene = tt.cornell_spheres_scene()
    cfg = tt.RenderConfig(width=1920, height=1080, depth=30, backend="pallas",
                          photon_aim=0.5)
    cam = cornell_camera(cfg)
    rk, _, p_s = regen_vs_plain("photon_aim 0.5", scene, cfg, cam, 1234, 1,
                                2, phase="aim")
    rb, b_ms, b_plain = budget_vs_plain("aim", scene, cfg, cam, dev)
    planes = state_to_planes(tt.init_state(cfg))
    r2 = radius_after(cfg, 0, cfg.photon_radius_init, 2)
    regen = lambda c: lambda: mega_regen.regen_call(  # noqa: E731
        scene, c, cam, planes.clone(), 1234, 1, 2, r2, 30)
    segs = {q: int(regen(cfg.with_(photon_aim=q))()) for q in (0.0, 0.5)}
    print(f"[aim] regen kernel 1080p 1 spp from iteration 2, segments: "
          f"photon_aim 0 {segs[0.0]}, 0.5 {segs[0.5]}")
    ms = launch_times("photon_aim 0.5", regen(cfg), "regen_lights_kernel",
                      regen(cfg.with_(photon_aim=0.0)), "regen_")
    report["regen_aim"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=p_s * 1e3, ms_budget=b_ms,
        plain_ms_budget=b_plain, **path_bound(cfg.n_pixels, rk))
    launches = {"regen_aim": drive("aim", scene, cfg, cam, 1,
                                   ["regen_lights", "blit"],
                                   gpu)["regen_lights"]}
    launches["regen_aim"] = min(launches["regen_aim"], adaptive_path(
        "aim", scene, cfg, cam, ["regen_lights", "regen_budget"],
        gpu)["regen_lights"])
    return launches


def probe_rays(scene, n: int, seed: int, dev):
    """n seeded rays through the scene's triangle (or sphere) bounds, from
    origins up to twice its extent away: o, d (3, n) with unit d, t_max and
    lam (n,), float32 on dev."""
    rs = np.random.default_rng(seed)
    pts = (scene.tri_a.cpu().numpy() if scene.num_triangles
           else scene.sph_center.cpu().numpy()[1:])
    lo, hi = pts.min(0), pts.max(0)
    c, ext = (lo + hi) / 2, (hi - lo) / 2 + 0.5
    o = c + rs.uniform(-2, 2, (n, 3)) * ext
    tgt = c + rs.uniform(-1, 1, (n, 3)) * ext
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 2.0, n) * np.linalg.norm(tgt - o, axis=1)
    lam = rs.uniform(380.0, 780.0, n)
    f = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, np.float32)).to(dev)
    return f(o.T), f(d.T), f(t_max), f(lam)


def camera_rays(cam, width: int, height: int, dev):
    """Unit pinhole rays through the pixel centres of ``cam`` in linear
    pixel order (a warp's lanes are neighbours in a row): o, d (3, P),
    t_max 1e3 and lam 550 (P,), float32 on dev."""
    px = (np.arange(width * height) % width + 0.5) / width
    py = (np.arange(width * height) // width + 0.5) / height
    rows = cam.rows().astype(np.float64)
    d = rows[3] + px[:, None] * rows[1] + py[:, None] * rows[2] - rows[0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = width * height
    f = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, np.float32)).to(dev)
    return (f(np.broadcast_to(rows[0], d.shape).T), f(d.T),
            f(np.full(n, 1e3)), f(np.full(n, 550.0)))


def one_leaf_rays(scene, n: int, seed: int, dev):
    """n rays from a small patch in front of one triangle of the scene,
    aimed at a small disk around its centroid: they walk the same nodes and
    reach the same leaves, so every lane of a warp holds the same leaf."""
    rs = np.random.default_rng(seed)
    k = scene.num_triangles // 3
    a, e1, e2, nrm = (x[k].cpu().numpy().astype(np.float64) for x in (
        scene.tri_a, scene.tri_e1, scene.tri_e2, scene.tri_n))
    c = a + (e1 + e2) / 3.0
    size = min(np.linalg.norm(e1), np.linalg.norm(e2))
    o = c + 2.0 * nrm + rs.uniform(-1e-3, 1e-3, (n, 3))
    tgt = c + rs.uniform(-0.05, 0.05, (n, 3)) * size
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    f = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, np.float32)).to(dev)
    return f(o.T), f(d.T), f(np.full(n, 3.0)), f(rs.uniform(380, 780, n))


def torus_only_scene(dev=None):
    """Bench config 6's torus alone (no spheres): every probe hit is a
    triangle's."""
    import tpurt_torch as tt
    verts, faces = tt.scene._torus(45, 45)
    mesh = tt.MeshData(material_id=2, translation=(0.0, 0.0, 6.0))
    mesh.add_triangles(verts, faces)
    return tt.build_scene([tt.Material.diffuse((0.5, 0.5, 0.5))] * 3, [],
                          [mesh], [], device=dev)


def nan_plane_rays(dev, n: int = 65536):
    """Rays straight down +z whose x and y sit exactly on the integer box
    planes of the quad grid (0 * inf in the slab test) or between them
    (tpurt's test_wide_walk_nan_slab_votes_hit)."""
    xs = (np.arange(n) % 7).astype(np.float32)
    ys = ((np.arange(n) // 7) % 12).astype(np.float32) / 2.0
    o = np.stack([xs, ys, np.full(n, -3.0, np.float32)])
    d = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, n))
    f = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return f(o), f(d), f(np.full(n, 5.5, np.float32)), f(
        np.full(n, 550.0, np.float32))


def grid_quads():
    """A 6x6 quad grid at z = 1..4: 288 axis-aligned triangles."""
    import tpurt_torch as tt
    mesh = tt.MeshData(material_id=0)
    verts, faces = [], []
    for z in range(1, 5):
        for i in range(6):
            for j in range(6):
                b = len(verts)
                verts += [(i, j, z), (i + 1, j, z), (i + 1, j + 1, z),
                          (i, j + 1, z)]
                faces += [(b, b + 1, b + 3), (b + 2, b + 3, b + 1)]
    mesh.add_triangles(np.asarray(verts, np.float32),
                       np.asarray(faces, np.int32))
    return tt.build_scene([tt.Material.diffuse((0.5, 0.5, 0.5))], [], [mesh],
                          [])


def walk_vs_plain(name, scene, cfg, rays, exact_atten=True):
    """The walk probe against the brute-force sweeps on the same rays: t,
    point, normal and material bit for bit; the shadow factor bit for bit,
    or within 1e-6 relative for a sphere tree (walk-order product).
    Returns (max |diff| of the outputs, kernel ms, plain ms)."""
    from tpurt_torch import integrate
    from tpurt_torch.kernels import bvh
    from tpurt_torch.scene import freeze_scene
    fs = freeze_scene(scene)
    o, d, tm, lam = rays
    got = bvh.probe(scene, cfg, o, d, tm, lam)

    def plain():
        t, loc, n, mat = integrate.intersect_scene(fs, tuple(o), tuple(d))
        return (t, torch.stack(loc), torch.stack(n), mat.to(torch.int32),
                integrate._shadow(fs, tuple(o), tuple(d), tm, lam))

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    equal = [torch.equal(a, b) for a, b in zip(got, want)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    rel = float(((got[4] - want[4]).abs()
                 / want[4].abs().clamp_min(1e-30)).max())
    hit = float((want[0] < 1e29).float().mean())
    occ = float((want[4] == 0.0).float().mean())
    ms = cuda_ms(lambda: bvh.probe(scene, cfg, o, d, tm, lam), 5)
    print(f"[bvh-walk] {name}: {o.shape[1]} rays ({hit:.3f} hit, {occ:.3f} "
          f"occluded): t/loc/n/mat/atten equal {equal}, atten max rel "
          f"{rel:.3g}; walk {ms:.3f} ms, brute force {plain_ms:.1f} ms")
    if not all(equal[:4]) or not (equal[4] or (not exact_atten
                                               and rel <= 1e-6)):
        bad = torch.nonzero((got[0] != want[0]) | (got[3] != want[3]))[:4, 0]
        raise AssertionError(
            f"{name}: the walk differs from the brute-force sweep, e.g. rays "
            f"{bad.tolist()}: t {got[0][bad].tolist()} vs "
            f"{want[0][bad].tolist()}")
    return err, ms, plain_ms


def mesh_phases(dev, report, gpu) -> dict:
    """[bvh-walk] the walks against the brute-force sweeps; [mesh-regen]
    the regen kernel through the walk against render_plain; [mesh-wf] the
    wavefront kernels against the plain pool; [mesh] tpurt's bench config
    6 at 1080p, depth 30, 4 spp, and the two scale paths at 1 spp. Fills
    ``report`` and returns the config-6 path's launch counts."""
    import tpurt_torch as tt
    from tpurt_torch import integrate
    from tpurt_torch.kernels import mega_regen
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene

    base = tt.RenderConfig(backend="pallas")
    torus = tt.torus_mesh_scene(45, 45)
    torus_only = torus_only_scene()
    field = tt.torus_field_scene(16, 45, 45)
    inst = tt.instanced_scene(16384)
    cfg_field = base.with_(pallas_bvh_leaf=16, pallas_bvh_chunk=1024,
                           pallas_bvh_width=8)
    cfg_inst = base.with_(pallas_sphere_bvh=True, pallas_bvh_leaf=16,
                          pallas_bvh_width=8)

    # [bvh-walk] 65,536 seeded rays each
    n = 65536
    errs = []
    rays = probe_rays(torus_only, n, 1, dev)
    err, ms64, plain64 = walk_vs_plain(
        "torus 4050 tris, binary leaf 64", torus_only,
        base.with_(pallas_bvh_leaf=64), rays)
    errs.append(err)
    errs.append(walk_vs_plain("torus 4050 tris, width 8 leaf 64", torus_only,
                              base.with_(pallas_bvh_leaf=64,
                                         pallas_bvh_width=8), rays)[0])
    errs.append(walk_vs_plain("torus scene (spheres + 4050 tris), leaf 4",
                              torus, base.with_(pallas_bvh_leaf=4),
                              probe_rays(torus, n, 2, dev))[0])
    errs.append(walk_vs_plain("torus field 64,800 tris, width 8 leaf 16",
                              field, cfg_field,
                              probe_rays(field, n, 3, dev))[0])
    errs.append(walk_vs_plain("instanced 16,384 spheres, width 8 leaf 16",
                              inst, cfg_inst, probe_rays(inst, n, 4, dev),
                              exact_atten=False)[0])
    grid = grid_quads()
    for width in (0, 8):
        errs.append(walk_vs_plain(
            f"NaN-plane rays, quad grid, width {width}", grid,
            base.with_(pallas_bvh_leaf=8, pallas_bvh_width=width,
                       pallas_static_unroll=8), nan_plane_rays(dev))[0])

    # [mesh-regen] the regen kernel against render_plain, state planes
    # bit for bit (one plain render serves both leaf sizes)
    fs = freeze_scene(torus)
    regen_ms = {}
    for w, h in ((64, 32), (256, 144)):
        cfg = tt.RenderConfig(width=w, height=h, depth=8, backend="pallas")
        cam = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=w / h)
        planes = state_to_planes(tt.init_state(cfg))
        pp = planes.clone()
        t0 = time.perf_counter()
        rp = int(integrate.render_plain(fs, cfg, cam, pp, 1234, 2, 0, 2.0, 8))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for leaf in (64, 4):
            c = cfg.with_(pallas_bvh_leaf=leaf)
            pk = planes.clone()
            rk = int(mega_regen.regen_call(torus, c, cam, pk, 1234, 2, 0,
                                           2.0, 8))
            ms = cuda_ms(lambda: mega_regen.regen_call(
                torus, c, cam, planes.clone(), 1234, 2, 0, 2.0, 8), 3)
            regen_ms[(w, leaf)] = ms
            unequal = [i for i in range(16) if not torch.equal(pk[i], pp[i])]
            print(f"[mesh-regen] {w}x{h} depth 8 2 spp leaf {leaf}: rays "
                  f"{rk} vs plain {rp}, unequal planes {unequal}; kernel "
                  f"{ms:.3f} ms, plain {plain_s * 1e3:.1f} ms")
            if rk != rp or unequal:
                raise AssertionError("regen kernel differs from render_plain "
                                     "on the mesh")

    # the walk under the reference sampler at full depth; 512x288 keeps
    # the blocks persistent (more pixels than resident threads), and the
    # 1080p plain render of this case takes 150 s ([sampler] holds the walk
    # at 1080p, depth 15, under config 6's sampler, [regen] the reference
    # sampler)
    cfg_m = tt.RenderConfig(width=512, height=288, depth=30,
                            backend="pallas", pallas_bvh_leaf=64)
    regen_vs_plain("config 6 scene, reference sampler", torus, cfg_m,
                   tt.make_camera(*TORUS_CAM, vfov=55.0,
                                  aspect_ratio=512 / 288),
                   1234, 1, 0, phase="mesh-regen")

    # [mesh-wf] the wavefront kernels against the plain pool
    cfg_wf = tt.RenderConfig(width=256, height=144, depth=30,
                             enable_photons=False, wf_pool=65536)
    cam_wf = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=256 / 144)
    rays_wf = {}
    for backend in ("wavefront", "wavefront_pallas", "wavefront_fused"):
        c = cfg_wf.with_(backend=backend)
        st = tt.render(torus, c, cam_wf, tt.init_state(c), 1234, 1)
        rays_wf[backend] = int(st.rays)
    print(f"[mesh-wf] 256x144 depth 30 1 spp, rays: {rays_wf}")
    if len(set(rays_wf.values())) != 1:
        raise AssertionError("wavefront kernels differ from the plain pool "
                             "on the mesh")

    # [mesh] bench config 6 with the reference sampler through the public
    # entry points, then [config6] as tpurt ships it, [config4] and the
    # scale paths; each with its kernel counts zeroed just before
    cfg6 = tt.RenderConfig(width=1920, height=1080, depth=30,
                           backend="pallas", pallas_bvh=True,
                           pallas_bvh_leaf=64)
    cam6 = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=16 / 9)
    drive("mesh", torus, cfg6, cam6, 4, ["regen", "blit", "bvh_walk"], gpu)
    mesh_profile("config 6, reference sampler", torus, cfg6, cam6, 4)
    cfg6s = tt.RenderConfig(width=1920, height=1080, depth=30,
                            backend="pallas", **CONFIG6)
    launches = drive("config6", torus, cfg6s, cam6, 4,
                     ["regen", "blit", "bvh_walk"], gpu)
    launches = {"bvh_walk": launches["bvh_walk"]}
    mesh_profile("config 6 as shipped", torus, cfg6s, cam6, 4)
    disp = tt.dispersive_scene()
    cfg4 = tt.RenderConfig(width=1920, height=1080, depth=30,
                           backend="pallas", **CONFIG4)
    cam4 = tt.make_camera(*DISP_CAM, vfov=55.0, aspect_ratio=16 / 9)
    drive("config4", disp, cfg4, cam4, 4, ["regen", "blit"], gpu)
    mesh_profile("config 4", disp, cfg4, cam4, 4)
    planes = state_to_planes(tt.init_state(cfg6))
    for leaf in (4, 16, 64):
        c = cfg6.with_(pallas_bvh_leaf=leaf)
        ms = cuda_ms(lambda: mega_regen.regen_call(
            torus, c, cam6, planes.clone(), 1234, 1, 0, 2.0, 30), 3)
        print(f"  leaf {leaf}: regen kernel {ms:.2f} ms per 1080p sample")
    for name, scene, cfg, cam in (
            ("field", field, cfg_field.with_(width=1920, height=1080,
                                             depth=30),
             ((0.0, 14.0, -16.0), (0.0, 1.0, 10.0))),
            ("instanced", inst, cfg_inst.with_(width=1920, height=1080,
                                               depth=30),
             ((0.0, 18.0, -30.0), (0.0, 1.0, 8.0)))):
        camera = tt.make_camera(*cam, vfov=55.0, aspect_ratio=16 / 9)
        drive(f"mesh-{name}", scene, cfg, camera, 1,
              ["regen", "blit", "bvh_walk"], gpu)
        mesh_profile(name, scene, cfg, camera, 1)
    # per probe ray: o, d, t_max and lam in; t, point, normal, material and
    # shadow factor out; a nearest-hit walk and a shadow walk
    report["bvh_walk"] = dict(max_abs_err=max(errs), ms=ms64,
                              plain_ms=plain64,
                              **bound(n * (32 + 36), 2 * n * OPS_PER_SEGMENT))
    return launches


def mesh_profile(name, scene, cfg, cam, spp) -> None:
    """The render + resolve of a mesh path under torch.profiler (wall ms,
    the regen kernel's device ms, device busy and idle share), and the
    path and the kernel alone timed by CUDA events."""
    import tpurt_torch as tt
    from tpurt_torch.kernels import mega_regen
    from tpurt_torch.render import state_to_planes

    def path():
        st = tt.render(scene, cfg, cam, tt.init_state(cfg), 1234, spp)
        return tt.resolve_image(cfg, st)

    wall, by_name, busy = profiled(path, 1)
    planes = state_to_planes(tt.init_state(cfg))
    ev_path = cuda_ms(path, 2)

    def kernel():
        return mega_regen.regen_call(scene, cfg, cam, planes.clone(), 1234,
                                     spp, 0, 2.0, cfg.depth)

    ev_kernel = cuda_ms(kernel, 2)
    print(f"  {name} under the profiler: {wall:.2f} ms wall, "
          f"{kernel_share(wall, by_name, busy)}; by CUDA events: render + "
          f"resolve {ev_path:.2f} ms, regen kernel {ev_kernel:.2f} ms "
          f"({ev_kernel / spp:.2f} ms per sample)")


def kernel_share(wall: float, by_name: dict, busy: float) -> str:
    """The regen kernel's profiled device ms, device busy ms and idle
    share; "not measured" where the profiler saw no regen kernel."""
    kernel = named_ms(by_name, "regen_")
    n = recorded("regen_")
    if kernel <= 0:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        return ("regen kernel not in the profile: device time not measured"
                f" (device entries: {len(by_name)}; "
                + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top) + ")")
    return (f"regen kernel {kernel:.2f} ms ({n} launch{'es' * (n != 1)} "
            f"recorded), device busy {busy:.2f} ms (idle share "
            f"{idle_share(wall, busy)})")


def mxu_phases(dev, report, gpu) -> dict:
    """[mxu-leaf] the probe's G leaf against the plain G sweep on
    [bvh-walk]'s 65,536-ray sets, with the hit/miss agreement against the
    exact walk; [mesh-mxu] the regen kernel with pallas_mxu_leaf against
    render_plain with the G sweep, with the reference sampler and with
    config 6's, uniform and budget mode at 64x32 and 256x144;
    [config6-mxu] config 6's scene at 1080p with the flag through
    tt.render (reference sampler, then as shipped) and the regen kernel's
    time per sample, G leaf against exact leaf in turns; then [mesh-mxu]
    at depth 30, one sample of config 6 as shipped at 1080p and of the
    reference sampler at 512x288. Fills
    report["mxu_leaf"]; returns the shipped path's G-leaf launch count."""
    import tpurt_torch as tt
    from tpurt_torch import integrate
    from tpurt_torch.kernels import mega_regen
    from tpurt_torch.render import state_to_planes
    from tpurt_torch.scene import freeze_scene

    base = tt.RenderConfig(backend="pallas", pallas_mxu_leaf=True)
    torus_only = torus_only_scene()
    n = 65536
    rays = probe_rays(torus_only, n, 1, dev)
    grid = grid_quads()
    torus = tt.torus_mesh_scene(45, 45)
    cam6 = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=16 / 9)
    errs = []
    for name, scene, cfg, rs in (
            ("torus 4050 tris, binary leaf 64", torus_only,
             base.with_(pallas_bvh_leaf=64), rays),
            ("torus 4050 tris, width 8 leaf 64", torus_only,
             base.with_(pallas_bvh_leaf=64, pallas_bvh_width=8), rays),
            ("torus, binary leaf 64, 65,499 rays (no multiple of 32)",
             torus_only, base.with_(pallas_bvh_leaf=64),
             probe_rays(torus_only, n - 37, 5, dev)),
            ("torus, binary leaf 128", torus_only,
             base.with_(pallas_bvh_leaf=128), probe_rays(torus_only, n, 6,
                                                         dev)),
            ("torus, rays into one leaf", torus_only,
             base.with_(pallas_bvh_leaf=64), one_leaf_rays(torus_only, n, 7,
                                                           dev)),
            ("config 6 scene, 1080p pinhole rays, leaf 64", torus,
             base.with_(pallas_bvh_leaf=64), camera_rays(cam6, 1920, 1080,
                                                         dev)),
            ("NaN-plane rays, quad grid, width 0", grid,
             base.with_(pallas_bvh_leaf=8, pallas_static_unroll=8),
             nan_plane_rays(dev)),
            ("NaN-plane rays, quad grid, width 8", grid,
             base.with_(pallas_bvh_leaf=8, pallas_static_unroll=8,
                        pallas_bvh_width=8), nan_plane_rays(dev))):
        res = g_leaf_vs_plain(name, scene, cfg, rs, timed=not errs)
        if not errs:
            _, ms, plain_ms, pairs = res
        errs.append(res[0])
    # the pairs the one-thread G leaf tested on this set: the warp leaf
    # visits the same leaves
    if pairs != 6432004:
        raise AssertionError(f"the G leaf tested {pairs} pairs on the torus "
                             f"at leaf 64, not 6432004")
    # per probe ray: o, d, t_max and lam in; t, point, normal, material and
    # shadow factor out; ~50 operations per pair tested (19 products and
    # their sums, o x d shared per ray, the sign fold, a divide, 6 compares)
    report["mxu_leaf"] = dict(max_abs_err=max(errs), ms=ms,
                              plain_ms=plain_ms,
                              **bound(n * (32 + 36), pairs * 50))
    print(f"  pairs tested on the torus, binary leaf 64: {pairs} "
          f"({pairs / n:.1f} a ray); bound "
          f"{report['mxu_leaf']['bound_ms']:.4f} ms "
          f"({report['mxu_leaf']['bound_by']})")

    # [mesh-mxu] the regen kernel's two G instances (the reference sampler
    # and config 6's) against render_plain with the G sweep, uniform and
    # budget mode; then each at the main path's 1080p shape
    fs = freeze_scene(torus)
    samplers = (("reference sampler", dict(pallas_bvh_leaf=64)),
                ("as shipped", CONFIG6))
    for (label, flags), (w, h) in itertools.product(
            samplers, ((64, 32), (256, 144))):
        cfg = tt.RenderConfig(width=w, height=h, depth=8, backend="pallas",
                              pallas_mxu_leaf=True, **flags)
        cam = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=w / h)
        tri = mega_regen.regen_tri_mode(fs, cfg)
        if tri.kind != "gleaf":
            raise AssertionError("the G leaf does not engage on config 6")
        st = tt.init_state(cfg)
        planes = state_to_planes(st)
        pk, pp = planes.clone(), planes.clone()
        before = read_counts(["mxu_leaf"])["mxu_leaf"]
        rk = int(mega_regen.regen_call(torus, cfg, cam, pk, 1234, 2, 0, 2.0,
                                       8))
        rp = int(integrate.render_plain(fs, cfg, cam, pp, 1234, 2, 0, 2.0, 8,
                                        tri))
        bad = unequal_planes(pk, pp)
        st1 = tt.render(torus, cfg, cam, st, 1234, 1)
        b = budget_map(st1.n_samples.shape[0], cfg.n_pixels, 3, 9, dev)
        planes = state_to_planes(st1)
        bk, bp = planes.clone(), planes.clone()
        rbk = int(mega_regen.regen_budget_call(torus, cfg, cam, bk, 1234, b,
                                               st1.n_samples))
        rbp = int(integrate.render_plain_budget(fs, cfg, cam, bp, 1234, b,
                                                st1.n_samples, tri))
        bad_b = unequal_planes(bk, bp)
        runs = read_counts(["mxu_leaf"])["mxu_leaf"] - before
        print(f"[mesh-mxu] {label} {w}x{h} depth 8, uniform 2 spp: rays "
              f"{rk} vs plain {rp}, unequal planes {bad}; budgets 0-3 after "
              f"1 spp: rays {rbk} vs plain {rbp}, unequal planes {bad_b}; "
              f"G-leaf launches {runs}")
        if rk != rp or bad or rbk != rbp or bad_b or runs != 3:
            raise AssertionError("the regen kernel's G leaf differs from "
                                 "render_plain")

    # [config6-mxu] config 6's scene at 1080p with the flag, through the
    # public entry points; then the regen kernel per sample, exact leaf
    # against G leaf in turns (exact, G, G, exact)
    names = ["regen", "blit", "bvh_walk", "mxu_leaf"]
    launches = {}
    for label, flags in samplers:
        cfg = tt.RenderConfig(width=1920, height=1080, depth=30,
                              backend="pallas", **flags)
        g_cfg = cfg.with_(pallas_mxu_leaf=True)
        launches = drive(f"config6-mxu {label}", torus, g_cfg, cam6, 4,
                         names, gpu)
        st_g = tt.render(torus, g_cfg, cam6, tt.init_state(g_cfg), 1234, 4)
        st_e = tt.render(torus, cfg, cam6, tt.init_state(cfg), 1234, 4)
        rg, rx = int(st_g.rays), int(st_e.rays)
        med, frac, mx = image_gap(
            tt.resolve_image(g_cfg, st_g).cpu().numpy(),
            tt.resolve_image(cfg, st_e).cpu().numpy())
        planes = state_to_planes(tt.init_state(cfg))
        times = []
        for c in (cfg, g_cfg, g_cfg, cfg):
            times.append(cuda_ms(lambda: mega_regen.regen_call(
                torus, c, cam6, planes.clone(), 1234, 4, 0, 2.0, 30), 2) / 4)
        def g_path():
            return tt.resolve_image(g_cfg, tt.render(
                torus, g_cfg, cam6, tt.init_state(g_cfg), 1234, 4))

        wall, by_name, busy = profiled(g_path, 1)
        print(f"  {label}: G leaf rays {rg} vs exact {rx} (rel "
              f"{(rg - rx) / rx:.2e}); image G vs exact: median {med:.2e},"
              f" {frac:.2%} pixels > 1e-2, max {mx:.3g}; regen kernel per "
              f"1080p sample exact/G/G/exact "
              f"{'/'.join(f'{t:.3f}' for t in times)} ms; G path "
              f"render + resolve by CUDA events {cuda_ms(g_path, 2):.2f} ms;"
              f" under the profiler {wall:.2f} ms wall, "
              f"{kernel_share(wall, by_name, busy)} | {gpu}")
        if abs(rg - rx) > 1e-2 * rx:
            raise AssertionError("the G leaf moves the ray count by > 1%")

    # [mesh-mxu] at full depth: one depth-30 sample of each G instance,
    # config 6 as shipped at the main path's 1080p, the reference sampler
    # (whose 1080p plain render with the G sweep takes 140 s) at 512x288
    for (label, flags), (w, h) in zip(samplers, ((512, 288), (1920, 1080))):
        cfg = tt.RenderConfig(width=w, height=h, depth=30, backend="pallas",
                              pallas_mxu_leaf=True, **flags)
        cam = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=w / h)
        before = read_counts(["mxu_leaf"])["mxu_leaf"]
        regen_vs_plain(label, torus, cfg, cam, 1234, 1, 0, phase="mesh-mxu")
        if read_counts(["mxu_leaf"])["mxu_leaf"] != before + 1:
            raise AssertionError("the depth-30 comparison ran no G leaf")
    return {"mxu_leaf": launches["mxu_leaf"]}


def g_leaf_vs_plain(name, scene, cfg, rays, timed=False):
    """The probe's G leaf against the plain G sweep on the same rays: t,
    point, normal, material and shadow factor bit for bit; the hit/miss
    agreement with the exact walk. Returns (max |diff|, probe ms, plain
    ms or None where not timed, pairs tested)."""
    from tpurt_torch import integrate
    from tpurt_torch.kernels import bvh
    from tpurt_torch.scene import freeze_scene
    fs = freeze_scene(scene)
    o, d, tm, lam = rays
    got = bvh.probe(scene, cfg, o, d, tm, lam, gleaf=True)
    exact = bvh.probe(scene, cfg, o, d, tm, lam)
    tri = integrate.TriMode("gleaf", bvh.gmat(fs, cfg))

    def plain():
        t, loc, n, mat = integrate.intersect_scene(fs, tuple(o), tuple(d),
                                                   tri)
        return (t, torch.stack(loc), torch.stack(n), mat.to(torch.int32),
                integrate._shadow(fs, tuple(o), tuple(d), tm, lam))

    want = plain()
    equal = [torch.equal(a, b) for a, b in zip(got, want)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    plain_ms = cuda_ms(plain, 3) if timed else None
    hit_g, hit_e = got[0] < 1e29, exact[0] < 1e29
    agree = float((hit_g == hit_e).float().mean())
    pairs = torch.zeros((1,), dtype=torch.int64, device=o.device)
    bvh.probe(scene, cfg, o, d, tm, lam, gleaf=True, pairs=pairs)
    ms = cuda_ms(lambda: bvh.probe(scene, cfg, o, d, tm, lam, gleaf=True), 5)
    ms_exact = cuda_ms(lambda: bvh.probe(scene, cfg, o, d, tm, lam), 5)
    print(f"[mxu-leaf] {name}: {o.shape[1]} rays "
          f"({float(hit_g.float().mean()):.3f} hit): t/loc/n/mat/atten "
          f"equal {equal}; hit/miss agreement with the exact walk "
          f"{agree:.5f} ({int((hit_g != hit_e).sum())} rays differ); G "
          f"walk {ms:.3f} ms, exact walk {ms_exact:.3f} ms"
          + (f", plain G sweep {plain_ms:.1f} ms" if timed else ""))
    if not all(equal):
        bad = torch.nonzero((got[0] != want[0]) | (got[3] != want[3]))[:4, 0]
        raise AssertionError(
            f"{name}: the G leaf differs from the plain G sweep, e.g. rays "
            f"{bad.tolist()}: t {got[0][bad].tolist()} vs "
            f"{want[0][bad].tolist()}")
    return err, ms, plain_ms, int(pairs)



# ----- the rest of tpurt's API past render: the blit's routes, ray
#       queries, the denoiser, temporal reuse, render_until, the twins of
#       tools/animate.py and examples/bake_ao.py -----

# the shape of the API phases' full-size runs (tpurt's bench shape) and the
# bake's grid (examples/bake_ao.py's defaults)
FULL = (1920, 1080)
BAKE = (128, 64)


def report_close(tag, got, want, rtol: float, exact: bool = False) -> int:
    """Elements of ``got`` (card) off ``want`` (CPU) by more than rtol
    times |want| plus rtol times want's largest |value| (the second term
    for values near 0 where single-wavelength RGB cancels); exact: any
    difference. Prints and returns the count."""
    a, b = got.detach().cpu(), want.detach().cpu()
    if exact or a.dtype in (torch.bool, torch.int32, torch.int64):
        bad = int((a != b).sum())
        err = 0.0 if bad == 0 else float((a.double() - b.double()).abs().max())
    else:
        diff = (a - b).abs()
        bad = int((diff > rtol * (b.abs() + float(b.abs().max()))).sum())
        err = float(diff.max())
    print(f"  {tag}: {bad} of {b.numel()} off (max |diff| {err:.3g})")
    return bad


def sync_ms(fn):
    """(result, wall ms) of fn(), the device synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def blit_route_phases(dev, gpu) -> int:
    """[blit-routes] resolve_state_pallas on a wavefront state stopped
    mid-drain (64x32, tests/test_tonemap_pallas.py's shape; per-pixel
    counts) and on a 1080p Cornell state, image_from_planes with a scalar
    and a per-pixel count and with key/saturation overrides, each against
    the plain resolve + tonemap, atol 1e-5 (the [blit] phase's). The
    routes' calls are this phase's paths: their blit launches are counted
    (zeroed before, read after) and returned."""
    import dataclasses
    import tpurt_torch as tt
    from tpurt_torch import tonemap as tm
    from tpurt_torch.kernels import tonemap as blit
    from tpurt_torch.render import state_to_planes

    def plain(cfg, rgb, ns, key=0.8, sat=1.0):
        n = cfg.n_pixels
        return tm.tonemap(tm.resolve(rgb[:n], ns[:n]), key, sat).reshape(
            cfg.height, cfg.width, 3)

    cfg_w = tt.RenderConfig(width=64, height=32, depth=4, tile_size=2048,
                            enable_photons=False, wf_pool=256,
                            backend="wavefront")
    st_w = tt.wavefront_render(tt.cornell_spheres_scene(), cfg_w,
                               cornell_camera(cfg_w),
                               tt.init_state(cfg_w), 11, 3)
    ns = st_w.n_samples.clone()
    ns[::3] = (ns[::3] - 1.0).clamp_min(0.0)
    st_w = dataclasses.replace(st_w, n_samples=ns)
    W, H = FULL
    cfg = tt.RenderConfig(width=W, height=H, depth=30, backend="pallas")
    st = tt.render(tt.cornell_spheres_scene(), cfg, cornell_camera(cfg),
                   tt.init_state(cfg), 1234, 4)
    planes = state_to_planes(st)
    four = torch.full_like(st.n_samples, 4.0)
    cases = [
        ("resolve_state_pallas 64x32 mid-drain", cfg_w,
         lambda: blit.resolve_state_pallas(cfg_w, st_w),
         plain(cfg_w, st_w.rgb_sum, st_w.n_samples)),
        (f"resolve_state_pallas {W}x{H}", cfg,
         lambda: blit.resolve_state_pallas(cfg, st),
         plain(cfg, st.rgb_sum, st.n_samples)),
        (f"image_from_planes {W}x{H} n=4", cfg,
         lambda: blit.image_from_planes(cfg, planes, 4.0),
         plain(cfg, st.rgb_sum, four)),
        (f"image_from_planes {W}x{H} per-pixel n", cfg,
         lambda: blit.image_from_planes(cfg, planes, st.n_samples),
         plain(cfg, st.rgb_sum, st.n_samples)),
        (f"image_from_planes {W}x{H} key 0.05 sat 1.3", cfg,
         lambda: blit.image_from_planes(cfg, planes, 4.0, key=0.05,
                                        saturation=1.3),
         plain(cfg, st.rgb_sum, four, 0.05, 1.3)),
    ]
    print(f"[blit-routes] the wavefront state's counts: "
          f"{sorted(set(st_w.n_samples[:cfg_w.n_pixels].tolist()))}")
    launches = 0
    for tag, c, route, want in cases:
        zero_counts(["blit"])
        got = route()
        torch.cuda.synchronize()
        launches += read_counts(["blit"])["blit"]
        err = float((got - want).abs().max())
        print(f"[blit-routes] {tag}: max |diff| {err:.3g}, equal "
              f"{torch.equal(got, want)}")
        if got.shape != (c.height, c.width, 3) or not err <= 1e-5:
            raise AssertionError(f"{tag}: the route differs from the plain "
                                 f"resolve + tonemap")
    if launches != len(cases):
        raise AssertionError(f"the routes launched the blit {launches} "
                             f"times, not {len(cases)}")
    ms_state = cuda_ms(lambda: blit.resolve_state_pallas(cfg, st), 20)
    ms_planes = cuda_ms(lambda: blit.image_from_planes(cfg, planes, 4.0), 20)
    print(f"[blit-routes] {W}x{H}: resolve_state_pallas {ms_state:.4f} ms, "
          f"image_from_planes {ms_planes:.4f} ms (the (16, P) planes' rows "
          f"0-2 copied to (P, 3) first) by CUDA events | {gpu}")
    return launches


def query_phases(dev, gpu) -> None:
    """[query] trace_rays on the 2,073,600 center rays of Cornell's 1080p
    camera, occlusion on the bake's 1,048,576 probes, light_probe at 16
    samples on 16,384 receivers (the bake's finder hits on
    many_light_scene(20)) in modes "all" and "spatial": each held at
    256x144 (and on the bake's res-32 grid) against the same call on the
    CPU (hit, mat_id, mtype exact; t, position, normal, albedo and the
    probe within 1e-5 relative, ``report_close``), then timed at full
    size."""
    import tpurt_torch as tt
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.denoise import pixel_centers
    from tpurt_torch.tools import bake_ao

    def center_rays(cfg, device):
        u, v = pixel_centers(cfg.width, cfg.height, device)
        o, d = generate_rays(cornell_camera(cfg), u.reshape(-1),
                             v.reshape(-1))
        return torch.stack(o, -1), torch.stack(d, -1)

    def receivers(scene, res):
        h = tt.trace_rays(scene, *bake_ao.finders(res))
        return h.position, h.normal

    small = tt.RenderConfig(width=256, height=144)
    bad = 0
    out = []
    for device in (dev, torch.device("cpu")):
        scene = tt.cornell_spheres_scene(device=device)
        many = tt.many_light_scene(20, device=device)
        o, d = center_rays(small, device)
        h = tt.trace_rays(scene, o, d)
        _, org, dirs = bake_ao.probes(scene, 32, 36)
        occ = tt.occlusion(scene, org, dirs, 4.0)
        pos, nrm = receivers(many, 32)
        probe = {m: tt.light_probe(many, pos, nrm, 16,
                                   tt.RenderConfig(light_sample=m))
                 for m in ("all", "spatial")}
        out.append((h, occ, probe))
    (hg, occ_g, pr_g), (hc, occ_c, pr_c) = out
    print(f"[query] 256x144 center rays ({float(hc.hit.float().mean()):.3f} "
          f"hit), the card against the CPU:")
    for f in ("hit", "mat_id", "mtype"):
        bad += report_close(f, getattr(hg, f), getattr(hc, f), 0, True)
    hit = hc.hit
    bad += report_close("t (hits)", hg.t.cpu()[hit], hc.t[hit], 1e-5)
    for f in ("position", "normal", "albedo"):
        bad += report_close(f, getattr(hg, f), getattr(hc, f), 1e-5)
    bad += report_close("occlusion (36,864 probes)", occ_g, occ_c, 1e-5)
    for m in ("all", "spatial"):
        bad += report_close(f"light_probe {m} (1024 receivers, 16 samples)",
                            pr_g[m], pr_c[m], 1e-5)
    if bad:
        raise AssertionError(f"[query]: {bad} values differ between the "
                             f"card and the CPU")
    cfg = tt.RenderConfig(width=FULL[0], height=FULL[1])
    scene = tt.cornell_spheres_scene()
    many = tt.many_light_scene(20)
    o, d = center_rays(cfg, dev)
    _, org, dirs = bake_ao.probes(scene, *BAKE)
    org_t = torch.from_numpy(org).to(dev)
    dirs_t = torch.from_numpy(dirs).to(dev)
    pos, nrm = receivers(many, BAKE[0])
    h = tt.trace_rays(scene, o, d)
    ms = {"trace_rays": cuda_ms(lambda: tt.trace_rays(scene, o, d), 3),
          "occlusion": cuda_ms(lambda: tt.occlusion(scene, org_t, dirs_t,
                                                    4.0), 3)}
    for m in ("all", "spatial"):
        c = tt.RenderConfig(light_sample=m)
        ms[f"light_probe {m}"] = cuda_ms(
            lambda: tt.light_probe(many, pos, nrm, 16, c), 2)
    print(f"[query] full size, device ms by CUDA events: trace_rays "
          f"{o.shape[0]} rays ({float(h.hit.float().mean()):.3f} hit) "
          f"{ms['trace_rays']:.2f}; occlusion {org.shape[0]} probes "
          f"{ms['occlusion']:.2f}; light_probe {pos.shape[0]} receivers x 16 "
          f"samples, 20 lights: all {ms['light_probe all']:.2f}, spatial "
          f"{ms['light_probe spatial']:.2f} | {gpu}")


def denoise_phases(dev, gpu) -> None:
    """[denoise] render_aovs, atrous_denoise (5 iterations, sigma_color
    None) and denoise_image on a 4-spp Cornell state, reproject and
    temporal_blend between two orbit cameras one frame apart: at 256x144
    on the card against the CPU on the same state (AOV albedo, depth and
    reproject's valid exact; the rest within 1e-4 relative,
    ``report_close``: the card's exp and the auto sigma's mean differ from
    PyTorch's CPU ones in the last bits), then each timed at 1080p."""
    import dataclasses
    import tpurt_torch as tt
    from tpurt_torch.temporal import reproject, temporal_blend
    from tpurt_torch.tools.animate import orbit_camera

    def run(device, cfg, st):
        scene = tt.cornell_spheres_scene(device=device)
        st = dataclasses.replace(st, rgb_sum=st.rgb_sum.to(device),
                                 n_samples=st.n_samples.to(device))
        cams = [orbit_camera(f, 24, CAM["look_from"], CAM["look_at"],
                             CAM["vfov"], cfg.width / cfg.height)
                for f in (0, 1)]
        a0, a1 = (tt.render_aovs(scene, cfg, c) for c in cams)
        lin = tt.resolve_radiance(cfg, st)
        den = tt.atrous_denoise(lin, a1.albedo, a1.normal, a1.depth)
        img = tt.denoise_image(scene, cfg, cams[1], st, aovs=a1)
        _, hist = temporal_blend(None, cams[0], a0, lin)
        warped, valid = reproject(hist, cams[1], a1.depth)
        blend, _ = temporal_blend(hist, cams[1], a1, den)
        return dict(scene=scene, st=st, cams=cams, a0=a0, a1=a1, lin=lin,
                    den=den, img=img, hist=hist, warped=warped, valid=valid,
                    blend=blend)

    small = tt.RenderConfig(width=256, height=144, depth=30,
                            backend="pallas")
    st_s = tt.render(tt.cornell_spheres_scene(), small, cornell_camera(small),
                     tt.init_state(small), 1234, 4)
    g, c = run(dev, small, st_s), run(torch.device("cpu"), small, st_s)
    print("[denoise] 256x144, 4 spp, the card against the CPU:")
    bad = sum(report_close(f"aov {f}", getattr(g["a1"], f),
                           getattr(c["a1"], f), 0, True)
              for f in ("albedo", "depth"))
    bad += report_close("aov normal", g["a1"].normal, c["a1"].normal, 1e-5)
    bad += report_close("reproject valid", g["valid"], c["valid"], 0, True)
    for f in ("den", "img", "warped", "blend"):
        bad += report_close(f, g[f], c[f], 1e-4)
    if bad:
        raise AssertionError(f"[denoise]: {bad} values differ between the "
                             f"card and the CPU")
    print(f"  valid share {float(c['valid'].float().mean()):.4f}")
    cfg = tt.RenderConfig(width=FULL[0], height=FULL[1], depth=30,
                          backend="pallas")
    st = tt.render(tt.cornell_spheres_scene(), cfg, cornell_camera(cfg),
                   tt.init_state(cfg), 1234, 4)
    r = run(dev, cfg, st)
    ms = {
        "render_aovs": cuda_ms(lambda: tt.render_aovs(
            r["scene"], cfg, r["cams"][1]), 3),
        "atrous_denoise": cuda_ms(lambda: tt.atrous_denoise(
            r["lin"], r["a1"].albedo, r["a1"].normal, r["a1"].depth), 3),
        "denoise_image": cuda_ms(lambda: tt.denoise_image(
            r["scene"], cfg, r["cams"][1], r["st"]), 3),
        "reproject": cuda_ms(lambda: reproject(r["hist"], r["cams"][1],
                                               r["a1"].depth), 3),
        "temporal_blend": cuda_ms(lambda: temporal_blend(
            r["hist"], r["cams"][1], r["a1"], r["den"]), 3)}
    if not bool(torch.isfinite(r["img"]).all()):
        raise AssertionError("[denoise]: the full-size image is not finite")
    print(f"[denoise] {cfg.width}x{cfg.height}, device ms by CUDA events: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; valid share {float(r['valid'].float().mean()):.4f} | {gpu}")


def animate_phases(dev, gpu) -> int:
    """[animate] the twin of tools/animate.py in this process on Cornell
    at 1920x1080, depth 30, --orbit --frames 3 --spp 4: once plain (a
    regen and a blit launch a frame), again to see the resume skip every
    frame, once --denoise --temporal 0.8 (a regen launch a frame, no
    blit). Each run is a path: the counts are zeroed before it and read
    after. Returns the blit launches."""
    import tempfile
    from tpurt_torch.tools import animate
    argv = ["--scene", "cornell", "--width", str(FULL[0]), "--height",
            str(FULL[1]), "--depth", "30", "--orbit", "--frames", "3",
            "--spp", "4"]
    blit_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for tag, extra, want in (("plain", [], {"regen": 3, "blit": 3}),
                                 ("resume", [], {"regen": 0, "blit": 0}),
                                 ("--denoise --temporal 0.8",
                                  ["--denoise", "--temporal", "0.8"],
                                  {"regen": 3, "blit": 0})):
            out_dir = f"{tmp}/{'t' if extra else 'p'}"
            zero_counts(["regen", "blit"])
            stats, wall = sync_ms(lambda: animate.main(
                argv + extra + ["--out-dir", out_dir]))
            got = read_counts(["regen", "blit"])
            blit_launches += got["blit"]
            print(f"[animate] {tag}: {stats['frames_rendered']} frames in "
                  f"{wall / 1e3:.2f} s, launches {got} | {gpu}")
            for fr in stats["frames"]:
                m = fr["ms"]
                print(f"  frame {fr['frame']}: render {m['render']:.1f} aov "
                      f"{m['aov']:.1f} denoise {m['denoise']:.1f} temporal "
                      f"{m['temporal']:.1f} png {m['png']:.1f} total "
                      f"{m['total']:.1f} ms, {fr['rays']} rays, "
                      f"{fr['rays'] / m['total'] / 1e3:.1f} Mrays/s")
            frames = [f"{out_dir}/frame_{i:04d}.png" for i in range(3)]
            if got != want or stats["frames_rendered"] != want["regen"] \
                    or not all(pathlib.Path(f).stat().st_size > 0
                               for f in frames):
                raise AssertionError(f"[animate] {tag}: launches {got}, "
                                     f"{stats['frames_rendered']} frames "
                                     f"(want {want})")
    return blit_launches


def until_phases(dev, gpu) -> None:
    """[until] render_until on Cornell at 1080p, depth 30, batch_spp 4,
    target_rel_err 0.02, max_spp 32: info, wall time, and the share of it
    outside the regen kernel (each regen_call bracketed by CUDA events)."""
    import tpurt_torch as tt
    from tpurt_torch.kernels import mega_regen
    cfg = tt.RenderConfig(width=FULL[0], height=FULL[1], depth=30,
                          backend="pallas")
    scene = tt.cornell_spheres_scene()
    cam = cornell_camera(cfg)
    orig = mega_regen.regen_call
    spans = []

    def timed(*a, **k):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig(*a, **k)
        e.record()
        spans.append((s, e))
        return out

    mega_regen.regen_call = timed
    try:
        zero_counts(["regen"])
        (st, info), wall = sync_ms(lambda: tt.render_until(
            scene, cfg, cam, tt.init_state(cfg), 1234, target_rel_err=0.02,
            batch_spp=4, max_spp=32))
    finally:
        mega_regen.regen_call = orig
    kernel = sum(s.elapsed_time(e) for s, e in spans)
    launches = read_counts(["regen"])["regen"]
    print(f"[until] Cornell {cfg.width}x{cfg.height} depth 30, batch 4, "
          f"target 0.02, max 32: "
          f"info {info}, {wall / 1e3:.3f} s wall, {launches} regen launches "
          f"({kernel:.1f} ms in the kernel), share outside the kernel "
          f"{1.0 - kernel / wall:.3f}, rays {int(st.rays)} | {gpu}")
    if launches != info["batches"] or st.iteration != info["spp"] \
            or not np.isfinite(info["rel_err"]):
        raise AssertionError(f"[until]: {launches} launches for {info}")


def bake_phases(dev, gpu) -> None:
    """[bake-ao] the twin of examples/bake_ao.py at its defaults (res 128,
    64 probes a texel: 1,064,960 rays) on the card, after its res-16,
    8-probe map on the card against the CPU's (exact)."""
    from tpurt_torch.tools import bake_ao
    g = bake_ao.bake(None, 16, 8, device=dev)
    c = bake_ao.bake(None, 16, 8, device="cpu")
    print(f"[bake-ao] res 16, 8 probes: the card against the CPU, max "
          f"|diff| {float(np.abs(g - c).max()):.3g}")
    if not np.array_equal(g, c):
        raise AssertionError("[bake-ao]: the card's AO map is not the CPU's")
    res, rays = BAKE
    ao, wall = sync_ms(lambda: bake_ao.bake(None, res, rays, device=dev))
    print(f"[bake-ao] res {res}, {rays} probes ({res * res * (rays + 1)} "
          f"rays): {wall / 1e3:.3f} s wall, mean AO {ao.mean():.4f} | {gpu}")
    if ao.shape != (res, res) or not (0.0 < ao.mean() < 1.0):
        raise AssertionError(f"[bake-ao]: AO map {ao.shape}, mean "
                             f"{ao.mean()}")


def api_phases(dev, gpu) -> int:
    """The phases of the API past render, in order; returns the blit
    launches of their paths. Alone: python3 -c "import torch, chip_smoke
    as cs; cs.api_phases(torch.device('cuda'), cs.gpu_line())"."""
    t0 = time.perf_counter()
    launches = blit_route_phases(dev, gpu)
    query_phases(dev, gpu)
    denoise_phases(dev, gpu)
    launches += animate_phases(dev, gpu)
    until_phases(dev, gpu)
    bake_phases(dev, gpu)
    torch.cuda.synchronize()
    print(f"[time] blit-routes, query, denoise, animate, until, bake-ao: "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


if __name__ == "__main__":
    sys.exit(main())
