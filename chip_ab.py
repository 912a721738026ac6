"""Same-card A/B of the path kernels between checkouts of tpurt_torch.

    python3 chip_ab.py PARENT_DIR . . PARENT_DIR

For each checkout given, in the order given (run parent, change, change,
parent), builds that checkout's kernels and prints one line: the regen
kernel per 1080p sample (depth 30, 1 spp, mean of 3 wrapper calls after a
warm-up) on Cornell, on bench config 6's torus with the reference sampler,
and on the torus with config 6's sampler flags (a checkout whose kernel
takes no flags ignores them: its wrapper is called directly); then one
budget launch on Cornell (seeded budgets 0-2, as many samples as one
uniform sample), and both torus cells again with ``pallas_mxu_leaf`` (the
G leaf). On Cornell also the pool cell: the uniform launch's kernel (the
pool instance, ``csrc/path_pool.cu``, where the checkout has it, else
``regen_kernel<false, false>``) with its ptxas registers, spills and static
shared memory, its launch's shared memory, blocks per SM and grid from the
profiler's record, its median device ms over 5 launches and the lane share
(``mega_regen.lane_share``). Each of these six cells gives three milliseconds:
CUDA events around the calls, the kernel's device time under
torch.profiler, and the host's time to issue the calls (no wait for the
card), so a cell whose events time the host shows it. Then bench config 5
(the dispersive scene, photons off, 1080p, depth 30): the fused kernel's
device milliseconds under torch.profiler at 1 and 4 spp and for one budget
launch (seeded budgets 0-4), the fused tail cell (the uniform launches'
kernel at 4, 7, 8, 64 and 1024 spp: the tail instance,
``csrc/fused_tail.cu``, where the checkout has it and the launch takes it,
else ``fused_kernel``, each with its median device ms over 9, 7 or 5
launches and its lane share; the tail instance's ptxas registers, spills
and static shared memory, its launch's shared memory, blocks per SM and
grid, and the tail share of its launches), the wall milliseconds of a
1-spp ``wavefront_pallas`` render (``tt.render``, synchronised; mean of 3
after a warm-up) and its sweep launches' device milliseconds, and the wall
milliseconds of a 1-spp render of the plain pool (``backend=
"wavefront"``; mean of 2). Then the device milliseconds of the hero and
emission instances at chip_smoke's [wf-hero] and [emission] shapes (the
fused kernel at 1 and 4 spp and in a budget launch, and the sweeps of a
1-spp ``wavefront_pallas`` render, with bench config 4's sampler flags on
config 5; the regen kernel at 1 spp, one tile-sync sample, the fused
kernel and the sweeps with chip_smoke's emission scene and flags; the G
leaf with the sky and the clamp on config 6 as shipped); then the same
for the camera-spawn extensions at chip_smoke's [spawn] shapes (Cornell,
1080p, depth 30, 1 spp: the regen kernel with hero 4 alone, with the
emission instance doing nothing more than the reference (a clamp no
sample reaches), with each spawn flag alone, the three together, and
tpurt's "quality" and "fast" presets; the fused kernel with photons off
the same way, from the reference instance; the three flags on one
tile-sync sample; the sweeps of a ``wavefront_pallas`` render without and
with the three flags), "n/a"
in a checkout that rejects those flags or has no MotionCamera; then the
same for the lights instances at chip_smoke's [lights] and [aim] shapes
(the regen kernel's lights instance forced to mode "all" on Cornell,
beside the reference instance; ``many_light_scene`` with 20 and 128
lights under light_sample "all", "power" and "spatial" on the regen
kernel, 20 lights on the tile-sync kernel and, photons off, on the fused
kernel and the sweeps of a ``wavefront_pallas`` render; Cornell with
photon_aim 0.5 beside 0, uniform and in a budget launch), "n/a" in a
checkout without them. Between
the two, the walk probe's device
milliseconds per launch under torch.profiler with the G leaf and with the
exact leaf, and the pairs its G leaf tested, on chip_smoke's 65,536 random
rays through bench config 6's torus alone (binary leaf 64, and width 8), on
65,536 rays that all reach one leaf of it, and on config 6's scene with
its 1080p pinhole rays. Before that line, a hash of each kernel's
machine code (``cuobjdump -sass`` of the checkout's library, runs of
blanks taken as one), so two checkouts show which kernels they compile
alike; after the runs, the SASS gate: every kernel of the first checkout
must have its hash in every later run (a new kernel may be added), else
the script exits 1. Then the card's name and power limit. Needs one CUDA
device.
"""

from __future__ import annotations

import subprocess
import sys

SCRIPT = r'''
import sys
sys.path.insert(0, sys.argv[1])
import torch
import tpurt_torch as tt
from tpurt_torch.kernels import build, mega_regen
from tpurt_torch.render import state_to_planes

dev = torch.device("cuda")


def sass_hashes():
    """kernel name -> a hash of its SASS in this checkout's library: every
    instruction with its encoding (scheduling bits included), with runs of
    blanks taken as one and the blank lines at its end dropped: cuobjdump
    aligns its columns across all kernels of a source, and the last kernel
    of a source ends in a blank line the others lack, so without that one
    kernel's hash would move when another kernel of its source gets a
    longer instruction or comes after it."""
    import hashlib
    import pathlib
    import re
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(build.library_path())],
                          capture_output=True, text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        body = re.sub(r"[ \t]+", " ", body).rstrip()
        out[name.strip()] = hashlib.sha256(body.encode()).hexdigest()[:12]
    return out


build.library()
print(f"SASS {sys.argv[1]}: " + " ".join(
    f"{k}={v}" for k, v in sorted(sass_hashes().items())), flush=True)


def ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, part, reps=3):
    """Device milliseconds per run of the kernels whose name holds part."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and part in e.key
               ) / 1e3 / reps


def wall_ms(fn, reps=3):
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def host_ms(fn, reps=3):
    """The host's milliseconds to issue one call, not waiting for the
    card."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def three(fn):
    """CUDA-event, regen-kernel device and host-issue ms of fn (any regen
    instance: a checkout with the pool instance runs the uniform Cornell
    launch there)."""
    return (f"{ms(fn):.3f} (device {device_ms(fn, 'regen'):.3f}, "
            f"host {host_ms(fn):.3f})")


def launch_shape(fn, part, reps=5):
    """The median device ms of one launch of the kernel whose name holds
    part, over reps launches under torch.profiler, and the trace's record
    of its first launch (grid, registers, shared memory, blocks per SM)."""
    import json
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(tempfile.mkdtemp(), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("cat") == "kernel" and part in e.get("name", "")]
    durs = sorted(e["dur"] / 1e3 for e in ev)
    return (durs[len(durs) // 2] if durs else float("nan"),
            ev[0].get("args", {}) if ev else {})


def ptxas(mangled_part):
    """ptxas's registers, spill stores and loads and static shared memory
    of the kernel whose mangled name holds mangled_part, from this
    checkout's build log."""
    import re
    log = build.library_path().with_suffix(".log").read_text()
    at = log.find(mangled_part)
    if at < 0:
        return "ptxas n/a"
    text = log[at:at + 2000]
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
    regs = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", text)
    return (f"{regs.group(1)} registers, spill {spill.group(1)}/"
            f"{spill.group(2)} B, static smem {regs.group(2)} B"
            if spill and regs else "ptxas n/a")


torus_cam = ((0, 3, -6), (0, 1.5, 0), 55.0)
shipped = dict(pallas_bvh_leaf=64, photon_strata=16, photon_strata_dir=4096,
               photon_strata_shared_k=True, photon_strata_bounce=True,
               camera_strata_bounce=True, hero_wavelengths=4)
cases = [
    ("cornell", tt.cornell_spheres_scene, {}, ((0, 5, -12), (0, 5, 0), 60.0)),
    ("torus-reference", lambda: tt.torus_mesh_scene(45, 45),
     dict(pallas_bvh_leaf=64), torus_cam),
    ("torus-shipped", lambda: tt.torus_mesh_scene(45, 45), shipped,
     torus_cam),
]
out = []
for name, make, kw, cam in cases:
    cfg = tt.RenderConfig(width=1920, height=1080, depth=30,
                          backend="pallas", **kw)
    scene = make().to(dev)
    camera = tt.make_camera(cam[0], cam[1], vfov=cam[2],
                            aspect_ratio=16 / 9)
    planes = state_to_planes(tt.init_state(cfg, dev))
    fn = lambda: mega_regen.regen_call(scene, cfg, camera,  # noqa: E731
                                       planes.clone(), 1234, 1, 0, 2.0, 30)
    out.append(f"{name} {three(fn)}")
    if name.startswith("torus"):  # the same with the G leaf
        g_cfg = cfg.with_(pallas_mxu_leaf=True)
        fn = lambda: mega_regen.regen_call(  # noqa: E731
            scene, g_cfg, camera, planes.clone(), 1234, 1, 0, 2.0, 30)
        out.append(f"{name}-g {three(fn)}")
    if name == "cornell":
        # the pool cell: the uniform Cornell launch's kernel (the pool
        # instance where the checkout has it, else regen_kernel<false,
        # false>): ptxas, its launch shape, its median device ms
        pool = hasattr(mega_regen, "pool_engages")
        part = "regen_pool_kernel" if pool else "regen_kernel<false, false>"
        med, args = launch_shape(fn, part)
        share = mega_regen.lane_share() if pool else None
        out.append(
            f"pool-cell {part} median {med:.4f} ms; "
            + ptxas("17regen_pool_kernel" if pool
                    else "12regen_kernelILb0ELb0E")
            + f"; shared memory a block {args.get('shared memory')} B, "
            f"{args.get('blocks per SM')} blocks per SM, grid "
            f"{args.get('grid')}, {args.get('registers per thread')} "
            f"registers; lane share "
            + ("n/a" if share is None else f"{share:.4f}"))
        import numpy as np
        counts = tt.init_state(cfg, dev).n_samples
        vals = np.random.default_rng(7).integers(0, 3, counts.shape[0])
        vals[cfg.n_pixels:] = 0
        budgets = torch.from_numpy(vals).to(dev)
        fn = lambda: mega_regen.regen_budget_call(  # noqa: E731
            scene, cfg, camera, planes.clone(), 1234, budgets, counts)
        out.append(f"cornell-budget {three(fn)}")


# the G probe: one launch's device ms (a nearest-hit walk with the G leaf
# and an exact shadow walk a ray) and the pairs its G leaf tested, on the
# torus alone with chip_smoke's 65,536 random rays (binary leaf 64, and
# width 8) and on config 6's scene with its 1080p pinhole rays
import importlib.util
import numpy as np
from tpurt_torch.kernels import bvh
spec = importlib.util.spec_from_file_location("smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
torus_only = smoke.torus_only_scene()
torus = tt.torus_mesh_scene(45, 45).to(dev)
camera = tt.make_camera((0, 3, -6), (0, 1.5, 0), vfov=55.0,
                        aspect_ratio=16 / 9)
for name, scene, kw, rays in (
        ("probe-random", torus_only, {}, smoke.probe_rays(torus_only, 65536,
                                                          1, dev)),
        ("probe-random-w8", torus_only, dict(pallas_bvh_width=8),
         smoke.probe_rays(torus_only, 65536, 1, dev)),
        ("probe-one-leaf", torus_only, {}, smoke.one_leaf_rays(
            torus_only, 65536, 7, dev)),
        ("probe-camera", torus, {}, smoke.camera_rays(camera, 1920, 1080,
                                                      dev))):
    cfg = tt.RenderConfig(backend="pallas", pallas_bvh_leaf=64, **kw)
    pairs = torch.zeros((1,), dtype=torch.int64, device=dev)
    bvh.probe(scene, cfg, *rays, gleaf=True, pairs=pairs)
    t_g = device_ms(lambda: bvh.probe(scene, cfg, *rays, gleaf=True),
                    "probe_kernel", 5)
    t_x = device_ms(lambda: bvh.probe(scene, cfg, *rays), "probe_kernel", 5)
    out.append(f"{name} G {t_g:.4f} exact {t_x:.4f} pairs {int(pairs)}")

from tpurt_torch.kernels import wavefront_fused
scene = tt.dispersive_scene().to(dev)
cfg = tt.RenderConfig(width=1920, height=1080, depth=30,
                      backend="wavefront_fused", enable_photons=False,
                      wf_pool=262144)
camera = tt.make_camera((0, 3, -4), (0, 1, 5), vfov=55.0, aspect_ratio=16 / 9)
st0 = tt.init_state(cfg, dev)
for spp in (1, 4):
    t = device_ms(lambda: wavefront_fused.wavefront_render_fused(
        scene, cfg, camera, st0, 1234, spp), "fused_kernel")
    out.append(f"config5-fused-{spp}spp {t:.4f}")
vals = np.random.default_rng(8).integers(0, 5, st0.n_samples.shape[0])
vals[cfg.n_pixels:] = 0
budgets = torch.from_numpy(vals).to(dev)
t = device_ms(lambda: wavefront_fused.wavefront_render_budget_fused(
    scene, cfg, camera, st0, 1234, budgets, 4), "fused_kernel")
out.append(f"config5-fused-budget {t:.4f}")
# the fused tail cell: the uniform launches' kernel (the tail instance,
# csrc/fused_tail.cu, where the checkout has it and the launch takes it,
# else fused_kernel) at 4, 7, 8, 64 and 1024 spp, each with the kernel
# that ran, its median device ms and its lane share, the tail instance's
# ptxas registers, spills and static shared memory and its launch shape,
# and the tail share of its launches
from tpurt_torch.scene import freeze_scene
tail = hasattr(wavefront_fused, "tail_engages")
tail0 = wavefront_fused.tail_counts(dev).clone() if tail else None
cell, args = [], {}
for spp, reps in ((4, 9), (7, 9), (8, 9), (64, 7), (1024, 5)):
    lanes0 = wavefront_fused.lane_counts(dev).clone()
    ran = "fused_kernel"
    if tail and wavefront_fused.tail_engages(
            freeze_scene(scene), cfg, spp):
        ran = "fused_tail_kernel"
    med, shape = launch_shape(
        lambda: wavefront_fused.wavefront_render_fused(
            scene, cfg, camera, st0, 1234, spp), ran, reps)
    if ran == "fused_tail_kernel":
        args = shape
    trips, lanes = (wavefront_fused.lane_counts(dev) - lanes0).tolist()
    cell.append(f"{spp}spp {ran} {med:.4f} ms lanes "
                f"{lanes / (32 * trips):.4f}")
share = "n/a"
if tail:
    paths, tails = (wavefront_fused.tail_counts(dev) - tail0).tolist()
    share = f"{tails / paths:.4f}" if paths else "n/a"
out.append(
    "fused-tail-cell " + "; ".join(cell) + "; tail instance "
    + ptxas("17fused_tail_kernel")
    + f"; shared memory a block {args.get('shared memory')} B, "
    f"{args.get('blocks per SM')} blocks per SM, grid {args.get('grid')}, "
    f"{args.get('registers per thread')} registers; tail share {share}")
cfg_p = cfg.with_(backend="wavefront_pallas")
t = wall_ms(lambda: tt.render(scene, cfg_p, camera, tt.init_state(cfg_p, dev),
                              1234, 1))
out.append(f"wf-pallas-1spp-wall {t:.3f}")
t = device_ms(lambda: tt.render(scene, cfg_p, camera,
                                tt.init_state(cfg_p, dev), 1234, 1),
              "pool_step_kernel")
out.append(f"wf-pallas-1spp-sweeps {t:.4f}")
cfg_w = cfg.with_(backend="wavefront")
t = wall_ms(lambda: tt.render(scene, cfg_w, camera, tt.init_state(cfg_w, dev),
                              1234, 1), 2)
out.append(f"wf-plain-1spp-wall {t:.1f}")

# the hero and emission instances (chip_smoke [wf-hero], [emission]):
# device ms of each launch; "n/a" in a checkout without them
hero = cfg.with_(**smoke.CONFIG4)
cells = [("hero-fused-1spp", "fused", lambda: (
              wavefront_fused.wavefront_render_fused(scene, hero, camera, st0,
                                                     1234, 1))),
         ("hero-fused-4spp", "fused", lambda: (
              wavefront_fused.wavefront_render_fused(scene, hero, camera, st0,
                                                     1234, 4))),
         ("hero-fused-budget", "fused", lambda: (
              wavefront_fused.wavefront_render_budget_fused(
                  scene, hero, camera, st0, 1234, budgets, 4))),
         ("hero-pallas-1spp-sweeps", "pool_step", lambda: tt.render(
             scene, hero.with_(backend="wavefront_pallas"), camera,
             tt.init_state(hero, dev), 1234, 1))]
try:
    emit_scene = smoke.emission_scene().to(dev)
except AttributeError:      # no emissive materials in this checkout
    emit_scene = None
emit = tt.RenderConfig(width=1920, height=1080, depth=30, backend="pallas",
                       wf_pool=262144, **smoke.CONFIG4, **smoke.EMIT_FLAGS)
emit_w = emit.with_(enable_photons=False, backend="wavefront_fused")
g_emit = tt.RenderConfig(width=1920, height=1080, depth=30, backend="pallas",
                         pallas_mxu_leaf=True, sky_intensity=0.2,
                         sky_temp=6500.0, radiance_clamp=20.0,
                         **smoke.CONFIG6)
torus6 = tt.make_camera((0, 3, -6), (0, 1.5, 0), vfov=55.0,
                        aspect_ratio=16 / 9)
planes = state_to_planes(tt.init_state(emit, dev))
cells += [("emission-regen-1spp", "regen", lambda: mega_regen.regen_call(
              emit_scene, emit, camera, planes.clone(), 1234, 1, 0, 2.0,
              30)),
          ("emission-tile-sync", "regen", lambda: mega_step.step_call(
              emit_scene, emit, camera, planes.clone(), 1234, 3, 1.5, 30)),
          ("emission-fused-1spp", "fused", lambda: (
              wavefront_fused.wavefront_render_fused(
                  emit_scene, emit_w, camera, st0, 1234, 1))),
          ("emission-pallas-1spp-sweeps", "pool_step", lambda: tt.render(
              emit_scene, emit_w.with_(backend="wavefront_pallas"), camera,
              tt.init_state(emit_w, dev), 1234, 1)),
          ("emission-g-leaf-1spp", "regen", lambda: mega_regen.regen_call(
              torus, g_emit, torus6, planes.clone(), 1234, 1, 0, 2.0, 30))]
# the camera-spawn extensions (chip_smoke [spawn]) on Cornell: the regen
# kernel with hero 4 alone (the sampler instance), the emission instance
# with no flag doing work (a clamp no sample reaches), each spawn flag
# alone, all three, and tpurt's "quality" and "fast" presets; all three on
# the tile-sync kernel; the fused kernel the same way (photons off, from
# the reference instance) and the sweeps of a wavefront_pallas render
# without and with all three.
# A checkout without MotionCamera, or one whose check_slice rejects a
# flag, reports "n/a"
from tpurt_torch.config import check_slice
cornell = tt.cornell_spheres_scene().to(dev)
spawn = tt.RenderConfig(width=1920, height=1080, depth=30, backend="pallas",
                        wf_pool=262144)
spawn_w = spawn.with_(enable_photons=False, backend="wavefront_fused")
flag_sets = [("ref", {}), ("hero4", dict(hero_wavelengths=4)),
             ("clamp", dict(radiance_clamp=1e30)),
             ("qmc", dict(qmc=True)),
             ("lens", dict(aperture=0.1, focus_dist=12.0)),
             ("motion", dict(motion_blur=True)), ("all", smoke.SPAWN_FLAGS),
             ("quality", dict(hero_wavelengths=4, qmc=True)),
             ("fast", dict(hero_wavelengths=4, qmc=True,
                           photon_rr_scale=0.5))]


def spawn_cell(c, call):
    """Check c as the entry points do, then call(c, camera)."""
    check_slice(c)
    if c.motion_blur and not hasattr(tt, "MotionCamera"):
        raise NotImplementedError   # a checkout from before the shutter
    return call(c, smoke.cornell_camera(c, c.motion_blur))


for name, kw in flag_sets:
    if name != "ref":
        cells.append((f"spawn-regen-{name}", "regen", lambda c=spawn.with_(
            **kw): spawn_cell(c, lambda c, cam: mega_regen.regen_call(
                cornell, c, cam, planes.clone(), 1234, 1, 0, 2.0, 30))))
    if name not in ("quality", "fast"):
        cells.append((f"spawn-fused-{name}", "fused", lambda c=spawn_w.with_(
            **kw): spawn_cell(c, lambda c, cam: (
                wavefront_fused.wavefront_render_fused(cornell, c, cam, st0,
                                                       1234, 1)))))
cells += [("spawn-tile-sync-all", "regen", lambda: spawn_cell(
              spawn.with_(**smoke.SPAWN_FLAGS), lambda c, cam: (
                  mega_step.step_call(cornell, c, cam, planes.clone(), 1234,
                                      3, 1.5, 30)))),
          ("spawn-pallas-ref-1spp-sweeps", "pool_step", lambda: spawn_cell(
              spawn_w.with_(backend="wavefront_pallas"),
              lambda c, cam: tt.render(cornell, c, cam,
                                       tt.init_state(c, dev), 1234, 1))),
          ("spawn-pallas-all-1spp-sweeps", "pool_step", lambda: spawn_cell(
              spawn_w.with_(backend="wavefront_pallas", **smoke.SPAWN_FLAGS),
              lambda c, cam: tt.render(cornell, c, cam,
                                       tt.init_state(c, dev), 1234, 1)))]
# the lights instances (chip_smoke [lights], [aim]), 1080p, depth 30, 1
# spp: the regen kernel's lights instance forced to mode "all" on Cornell
# (its body's cost beside spawn-regen-ref's reference instance);
# many_light_scene with 20 and 128 lights under "all", "power" and
# "spatial" on the regen kernel (photons on), 20 lights on the tile-sync
# kernel ("power") and, photons off, on the fused kernel and the sweeps of
# a wavefront_pallas render ("all", "spatial"); Cornell with photon_aim
# 0.5 (from iteration 2) beside 0, uniform and in a budget launch.
# "n/a" in a checkout without the lights instances or that rejects a flag


def forced_all(c, cam):
    """The regen launch of c on the lights instance with mode "all". The
    launch plans kept on the scene (of every kind, in a checkout that
    keeps them: the fused and sweep launchers read plans too) are dropped
    before and after, so neither this launch nor a later cell's meets a
    plan built with the other lights switches."""
    if not hasattr(mega_regen, "lights_args"):
        raise NotImplementedError   # a checkout without lights instances
    from tpurt_torch.scene import freeze_scene
    plans = freeze_scene(cornell).cache
    keep = mega_regen.lights_args
    mega_regen.lights_args = lambda cfg, photons=True: (
        mega_regen.LightsArgs(mode=0, q=0.0, widen=0.0))
    plans.pop("plans", None)
    try:
        return mega_regen.regen_call(cornell, c, cam, planes.clone(), 1234,
                                     1, 0, 2.0, 30)
    finally:
        mega_regen.lights_args = keep
        plans.pop("plans", None)


cells.append(("lights-regen-forced-all", "regen", lambda: spawn_cell(
    spawn, forced_all)))
many = {n: tt.many_light_scene(n).to(dev) for n in (20, 128)}
for n, sc in many.items():
    for mode in ("all", "power", "spatial"):
        cells.append((f"lights-regen-{n}-{mode}", "regen",
                      lambda c=spawn.with_(light_sample=mode), sc=sc:
                      spawn_cell(c, lambda c, cam: mega_regen.regen_call(
                          sc, c, cam, planes.clone(), 1234, 1, 0, 2.0, 30))))
cells.append(("lights-tile-sync-20-power", "regen", lambda: spawn_cell(
    spawn.with_(light_sample="power"), lambda c, cam: mega_step.step_call(
        many[20], c, cam, planes.clone(), 1234, 3, 1.5, 30))))
for mode in ("all", "spatial"):
    cells.append((f"lights-fused-20-{mode}", "fused",
                  lambda c=spawn_w.with_(light_sample=mode): spawn_cell(
                      c, lambda c, cam: wavefront_fused.wavefront_render_fused(
                          many[20], c, cam, st0, 1234, 1))))
    cells.append((f"lights-pallas-20-{mode}-1spp-sweeps", "pool_step",
                  lambda c=spawn_w.with_(backend="wavefront_pallas",
                                         light_sample=mode): spawn_cell(
                      c, lambda c, cam: tt.render(many[20], c, cam,
                                                  tt.init_state(c, dev), 1234,
                                                  1))))
aim_counts = tt.init_state(spawn, dev).n_samples + 1.0
aim_budgets = torch.from_numpy(np.random.default_rng(7).integers(
    0, 3, aim_counts.shape[0]) * (np.arange(aim_counts.shape[0])
                                  < spawn.n_pixels)).to(dev)
for q in (0.0, 0.5):
    cells.append((f"aim-regen-{q}", "regen",
                  lambda c=spawn.with_(photon_aim=q): spawn_cell(
                      c, lambda c, cam: mega_regen.regen_call(
                          cornell, c, cam, planes.clone(), 1234, 1, 2, 1.8,
                          30))))
    cells.append((f"aim-regen-budget-{q}", "regen",
                  lambda c=spawn.with_(photon_aim=q): spawn_cell(
                      c, lambda c, cam: mega_regen.regen_budget_call(
                          cornell, c, cam, planes.clone(), 1234, aim_budgets,
                          aim_counts))))
from tpurt_torch.kernels import mega_step
for name, part, fn in cells:
    try:
        if emit_scene is None and name.startswith("emission"):
            raise NotImplementedError
        out.append(f"{name} {device_ms(fn, part):.4f}")
    except NotImplementedError:     # flags this checkout rejects
        out.append(f"{name} n/a")
print(f"AB {sys.argv[1]}: " + " | ".join(out), flush=True)
'''


def sass_gate(lines) -> tuple:
    """The SASS lines of the runs, in order: (ok, message). ok: every
    kernel of the first run has the first run's hash in every later run."""
    runs = []
    for line in lines:
        tree, _, rest = line[len("SASS "):].partition(": ")
        runs.append((tree, dict(kv.split("=", 1) for kv in rest.split())))
    if not runs:
        return True, "SASS gate: no SASS line"
    first_tree, first = runs[0]
    changed = [(tree, sorted(k for k, v in first.items() if h.get(k) != v))
               for tree, h in runs[1:]]
    changed = [(tree, ks) for tree, ks in changed if ks]
    if not changed:
        return True, (f"SASS gate: passed, every kernel of {first_tree} "
                      f"({len(first)}) has its hash in all {len(runs)} runs")
    return False, "SASS gate: FAILED, changed or missing: " + "; ".join(
        f"{tree}: {' '.join(ks)}" for tree, ks in changed)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sass = []
    for tree in sys.argv[1:]:
        # one process per checkout: each imports its own tpurt_torch
        proc = subprocess.Popen([sys.executable, "-c", SCRIPT, tree],
                                stdout=subprocess.PIPE, text=True)
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith("SASS "):
                sass.append(line.strip())
        if proc.wait():
            raise subprocess.CalledProcessError(proc.returncode, tree)
    ok, message = sass_gate(sass)
    print(message)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
