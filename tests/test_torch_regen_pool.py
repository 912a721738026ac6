"""The regen kernel's pool instance (``csrc/path_pool.cuh``,
``csrc/path_pool.cu regen_pool_kernel``) and the instance rule of the four
path launchers (``mega_regen.kernel_instance``): which kernel each
launcher's plan names for each flag set, which launches take the pool
(``mega_regen.pool_engages``) and the fused kernel's tail pool
(``wavefront_fused.tail_engages``), its launch count and lane counter on the
CPU; and, on a CUDA device, the kernel the profiler sees each launcher run
against its plan's name, and the pool instance against the plain version
(``integrate.render_plain``), all 16 state planes and the ray count bit
for bit.

No JAX here: the GPU cases run where it is not installed,
``python -m pytest tests/test_torch_regen_pool.py -m gpu --noconftest``.
"""

import pathlib
import re

import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate, wavefront
from tpurt_torch.kernels import (mega_regen, mega_step, wavefront_fused,
                                 wavefront_sweep)
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

CPU = "cpu"
CAM = dict(look_from=(0.0, 5.0, -12.0), look_at=(0.0, 5.0, 0.0), vfov=60.0)
CSRC = pathlib.Path(mega_regen.__file__).resolve().parent.parent / "csrc"

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_regen_pool.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _cornell_cfg(**kw):
    return tt.RenderConfig(**{"width": 64, "height": 32, "depth": 8,
                              "backend": "pallas", **kw})


# ----- which launches take the pool instance (CPU) -----

@pytest.mark.parametrize("flags", [
    {}, dict(depth=30, k_photons=4), dict(enable_photons=False),
    dict(rr_threshold=0.05), dict(pallas_sphere_bvh=True),
    dict(width=8, height=4), dict(width=13, height=11),
    dict(width=1, height=1)],
    ids=["default", "k4", "no-photons", "rr", "sphere-bvh", "8x4", "13x11",
         "1x1"])
def test_pool_engages_on_spheres_under_the_reference_sampler(flags):
    """Images with fewer pixels than a block's slots take the pool too
    (the GPU cases below run such launches)."""
    fs = freeze_scene(tt.cornell_spheres_scene(device=CPU))
    assert mega_regen.pool_engages(fs, _cornell_cfg(**flags))


@pytest.mark.parametrize("flags", [
    dict(hero_wavelengths=4), dict(photon_strata=16),
    dict(dispersion_in_camera_path=True), dict(sky_intensity=0.2),
    dict(radiance_clamp=20.0), dict(qmc=True),
    dict(aperture=0.1, focus_dist=12.0), dict(photon_rr_scale=0.5),
    dict(light_sample="power"), dict(light_sample="spatial"),
    dict(photon_aim=0.5)],
    ids=["hero", "strata", "disp-cam", "sky", "clamp", "qmc", "lens",
         "rr-scale", "power", "spatial", "aim"])
def test_pool_does_not_engage_with_switches(flags):
    """Sampler flags, emission, spawn and lights switches keep their
    instances."""
    fs = freeze_scene(tt.cornell_spheres_scene(device=CPU))
    assert not mega_regen.pool_engages(fs, _cornell_cfg(**flags))


def test_pool_does_not_engage_on_meshes_or_in_budget_mode():
    fs = freeze_scene(tt.cornell_spheres_scene(device=CPU))
    assert not mega_regen.pool_engages(fs, _cornell_cfg(), uniform=False)
    mesh = freeze_scene(tt.torus_mesh_scene(8, 6, device=CPU))
    for kw in ({}, dict(pallas_bvh_leaf=64)):
        assert not mega_regen.pool_engages(mesh, _cornell_cfg(**kw))


SCENES = {"cornell": tt.cornell_spheres_scene,
          "dispersive": tt.dispersive_scene,
          "lights20": lambda device: tt.many_light_scene(20, device=device),
          "torus": lambda device: tt.torus_mesh_scene(8, 6, device=device)}
HERO, SKY, QMC = (dict(hero_wavelengths=4), dict(sky_intensity=0.2),
                  dict(qmc=True))
POWER = dict(light_sample="power")
GLEAF = dict(pallas_bvh_leaf=64, pallas_mxu_leaf=True)
POOL = mega_regen.POOL_KERNEL
# the kernel instance each launcher runs (mega_regen.kernel_instance),
# written out by hand from the C launchers: (scene, flags) -> names
PHOTON_INSTANCES = {   # regen, regen_budget, tile_sync (pallas_regen off)
    ("cornell", "ref"): ({}, POOL, "regen_kernel<false, false>",
                         "step_kernel<false>"),
    ("dispersive", "ref"): ({}, POOL, "regen_kernel<false, false>",
                            "step_kernel<false>"),
    ("lights20", "ref"): ({}, POOL, "regen_kernel<false, false>",
                          "step_kernel<false>"),
    ("cornell", "hero"): (HERO, "regen_kernel<true, false>",
                          "regen_kernel<true, false>", "step_kernel<true>"),
    ("cornell", "strata"): (dict(photon_strata=16),
                            "regen_kernel<true, false>",
                            "regen_kernel<true, false>", "step_kernel<true>"),
    ("cornell", "sky"): (SKY, *["regen_emit_kernel<false>"] * 3),
    ("cornell", "qmc"): (QMC, *["regen_spawn_kernel<false, false>"] * 3),
    ("cornell", "rr-scale"): (dict(photon_rr_scale=0.5),
                              *["regen_spawn_kernel<false, false>"] * 3),
    ("cornell", "hero-qmc"): ({**HERO, **QMC},
                              *["regen_spawn_kernel<true, false>"] * 3),
    ("cornell", "sky-qmc"): ({**SKY, **QMC},
                             *["regen_spawn_kernel<true, false>"] * 3),
    ("cornell", "power"): (POWER, *["regen_lights_kernel<false, false>"] * 3),
    ("lights20", "spatial"): (dict(light_sample="spatial"),
                              *["regen_lights_kernel<false, false>"] * 3),
    ("cornell", "power-qmc"): ({**POWER, **QMC},
                               *["regen_lights_kernel<false, false>"] * 3),
    ("cornell", "power-hero"): ({**POWER, **HERO},
                                *["regen_lights_kernel<true, false>"] * 3),
    ("torus", "ref"): ({}, "regen_kernel<false, false>",
                       "regen_kernel<false, false>", "step_kernel<false>"),
    ("torus", "gleaf"): (GLEAF, "regen_kernel<false, true>",
                         "regen_kernel<false, true>", "step_kernel<false>"),
    ("torus", "gleaf-hero"): ({**GLEAF, **HERO}, "regen_kernel<true, true>",
                              "regen_kernel<true, true>", "step_kernel<true>"),
    ("torus", "gleaf-sky"): ({**GLEAF, **SKY}, "regen_emit_kernel<true>",
                             "regen_emit_kernel<true>",
                             "regen_emit_kernel<false>"),
    ("torus", "gleaf-qmc"): ({**GLEAF, **QMC},
                             "regen_spawn_kernel<false, true>",
                             "regen_spawn_kernel<false, true>",
                             "regen_spawn_kernel<false, false>"),
    ("torus", "gleaf-power"): ({**GLEAF, **POWER},
                               "regen_lights_kernel<false, true>",
                               "regen_lights_kernel<false, true>",
                               "regen_lights_kernel<false, false>"),
}
for scene in ("dispersive", "lights20", "torus"):   # each switch alone
    PHOTON_INSTANCES.update({
        (scene, "hero"): (HERO, "regen_kernel<true, false>",
                          "regen_kernel<true, false>", "step_kernel<true>"),
        (scene, "sky"): (SKY, *["regen_emit_kernel<false>"] * 3),
        (scene, "qmc"): (QMC, *["regen_spawn_kernel<false, false>"] * 3),
        (scene, "power"): (POWER,
                           *["regen_lights_kernel<false, false>"] * 3)})
SWEEP = "pool_step_kernel<{}, {}, Sampler, Emission{}>"
TAIL = mega_regen.TAIL_KERNEL
CAMERA_INSTANCES = {   # wf_fused, wf_fused_budget, wf_sweep
    ("cornell", "ref"): ({}, TAIL, "fused_kernel",
                         "pool_step_kernel<false, false>"),
    ("cornell", "hero"): (HERO, *["fused_sampler_kernel<false>"] * 2,
                          SWEEP.format("true", "false", "")),
    ("dispersive", "disp-cam"): (dict(dispersion_in_camera_path=True),
                                 *["fused_sampler_kernel<false>"] * 2,
                                 SWEEP.format("true", "false", "")),
    ("cornell", "sky"): (SKY, *["fused_sampler_kernel<true>"] * 2,
                         SWEEP.format("true", "true", "")),
    ("cornell", "ramp"): (dict(sky_gradient=True),
                          *["fused_sampler_kernel<true>"] * 2,
                          SWEEP.format("true", "true", "")),
    ("cornell", "qmc"): (QMC, *["fused_spawn_kernel<false>"] * 2,
                         SWEEP.format("false", "false", ", Spawn")),
    ("cornell", "rr-scale"): (dict(photon_rr_scale=0.5), TAIL,
                              "fused_kernel",
                              "pool_step_kernel<false, false>"),
    ("cornell", "hero-qmc"): ({**HERO, **QMC},
                              *["fused_spawn_kernel<true>"] * 2,
                              SWEEP.format("true", "true", ", Spawn")),
    ("cornell", "power"): (POWER, *["fused_lights_kernel<false>"] * 2,
                           SWEEP.format("false", "false", ", Spawn, Lights")),
    ("cornell", "power-sky"): ({**POWER, **SKY},
                               *["fused_lights_kernel<true>"] * 2,
                               SWEEP.format("true", "true",
                                            ", Spawn, Lights")),
    ("torus", "ref"): ({}, TAIL, "fused_kernel",
                       "pool_step_kernel<false, false>"),
    ("torus", "gleaf"): (GLEAF, TAIL, "fused_kernel",
                         "pool_step_kernel<false, false>"),
}
PHOTON_LAUNCHERS = ("regen", "regen_budget", "tile_sync")
CAMERA_LAUNCHERS = ("wf_fused", "wf_fused_budget", "wf_sweep")
INSTANCE_CASES = [
    pytest.param(launcher, case, id=f"{launcher}-{case[0]}-{case[1]}")
    for table, launchers in ((PHOTON_INSTANCES, PHOTON_LAUNCHERS),
                             (CAMERA_INSTANCES, CAMERA_LAUNCHERS))
    for case in table for launcher in launchers]


def _instance_case(launcher, case, device):
    """The scene, config and expected kernel of a launcher in a case of
    the tables above; the tile-sync kernel runs with pallas_regen off, the
    camera-path kernels with photons off."""
    scene, _ = case
    if launcher in PHOTON_LAUNCHERS:
        flags, *names = PHOTON_INSTANCES[case]
        kw = dict(pallas_regen=False) if launcher == "tile_sync" else {}
        want = names[PHOTON_LAUNCHERS.index(launcher)]
    else:
        flags, *names = CAMERA_INSTANCES[case]
        kw = dict(enable_photons=False, backend=(
            "wavefront_pallas" if launcher == "wf_sweep"
            else "wavefront_fused"))
        want = names[CAMERA_LAUNCHERS.index(launcher)]
    return SCENES[scene](device), _cornell_cfg(**{**flags, **kw}), want


@pytest.mark.parametrize("launcher, case", INSTANCE_CASES)
def test_pool_engages_is_the_launchers_rule(launcher, case):
    """The plan records the kernel each launcher of its kind runs, as the C
    launchers choose it from their input (lights, spawn, emission, the
    pool on a uniform regen launch without triangle rows, the sampler or
    the reference instance; full bodies with emission or the sampler; the
    G leaf); pool_engages is the rule's pool."""
    scene, cfg, want = _instance_case(launcher, case, CPU)
    fs = freeze_scene(scene)
    kind = (mega_regen.PHOTON if launcher in PHOTON_LAUNCHERS
            else mega_regen.CAMERA)
    plan = mega_regen.build_plan(fs, cfg, tt.make_camera(
        **CAM, aspect_ratio=2.0), CPU, kind)
    assert plan.instances[launcher] == want
    assert set(plan.instances) == set(
        PHOTON_LAUNCHERS if kind == mega_regen.PHOTON else CAMERA_LAUNCHERS)
    if launcher in ("regen", "regen_budget"):
        assert mega_regen.pool_engages(
            fs, cfg, launcher == "regen") == (want == POOL)
    if launcher in ("wf_fused", "wf_fused_budget"):
        assert wavefront_fused.tail_engages(
            fs, cfg, mega_regen.TAIL_MIN_SPP if launcher == "wf_fused"
            else None) == (want == TAIL)


def test_lane_share_is_none_before_a_pool_launch(monkeypatch):
    """No pool launch: no share (a CPU render runs the plain version and
    counts none)."""
    monkeypatch.setattr(mega_regen, "POOL_LAUNCHES", 0)
    cfg = _cornell_cfg()
    tt.render(tt.cornell_spheres_scene(device=CPU), cfg,
              tt.make_camera(**CAM, aspect_ratio=2.0),
              tt.init_state(cfg, device=CPU), 3, 1)
    assert mega_regen.POOL_LAUNCHES == 0
    assert mega_regen.lane_share() is None


def test_lane_share_reads_the_accumulators(monkeypatch):
    """lanes / (32 * trips), summed over the devices' accumulators."""
    monkeypatch.setattr(mega_regen, "POOL_LAUNCHES", 2)
    monkeypatch.setattr(mega_regen, "_LANES", {
        torch.device(CPU): torch.tensor([10, 256], dtype=torch.int64),
        torch.device(CPU, 1): torch.tensor([6, 128], dtype=torch.int64)})
    assert mega_regen.lane_share() == 384 / (32 * 16)
    monkeypatch.setattr(mega_regen, "_LANES", {
        torch.device(CPU): torch.zeros((2,), dtype=torch.int64)})
    assert mega_regen.lane_share() is None     # launches without a trip


def test_lane_counts_is_one_kept_pair(monkeypatch):
    """The accumulator a pool launch adds its (trips, lanes) to: two int64
    zeros made on the first call, then the same tensor; lane_share reads
    what the launches added."""
    monkeypatch.setattr(mega_regen, "_LANES", {})
    monkeypatch.setattr(mega_regen, "POOL_LAUNCHES", 1)
    acc = mega_regen.lane_counts(CPU)
    assert acc.dtype == torch.int64 and acc.tolist() == [0, 0]
    assert mega_regen.lane_counts(CPU) is acc
    assert mega_regen.lane_share() is None     # no trip yet
    acc += torch.tensor([3, 70])
    assert mega_regen.lane_share() == 70 / (32 * 3)


def test_source_notes():
    """The instance's module says which TPU kernel it replaces, what
    bounds it and what its design does about that; the launcher names
    it."""
    note = (CSRC / "path_pool.cu").read_text().split("#include")[0]
    for words in ("tpurt/kernels/mega_regen.py:_make_regen_kernel",
                  "What bounds it", "render_plain", "bit for bit"):
        assert words in note
    loop = (CSRC / "path_pool.cuh").read_text().split("#pragma once")[0]
    assert "lockstep" in loop and "shared memory" in loop
    assert "launch_pool" in (CSRC / "mega_regen.cu").read_text()


# ----- the rule against the kernels the profiler sees (GPU only) -----

def _kernels_run(fn) -> set:
    """The port's kernels the profiler saw ``fn`` launch, named as
    ``kernel_instance`` names them (no return type, namespace or
    arguments)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |tpurt::|\(.*", "", e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "tpurt::" in e.key}


def _of(launchers):
    return [p for p in INSTANCE_CASES if p.values[0] in launchers]


@pytest.mark.gpu
@pytest.mark.parametrize("launcher, case", _of(PHOTON_LAUNCHERS))
def test_photon_instances_are_the_profilers(cuda, launcher, case):
    """One launch of the regen kernel (uniform or budget) or of the
    tile-sync kernel runs the kernel its plan names, and counts it."""
    scene, cfg, want = _instance_case(launcher, case, cuda)
    cam = tt.make_camera(**CAM, aspect_ratio=2.0)
    planes = state_to_planes(tt.init_state(cfg, cuda))
    P = planes.shape[1]
    if launcher == "regen":
        def call():
            mega_regen.regen_call(scene, cfg, cam, planes, 7, 1, 0, 2.0,
                                  cfg.depth)
    elif launcher == "regen_budget":
        budgets = (torch.arange(P, device=cuda) < cfg.n_pixels).long()
        counts = torch.zeros((P,), device=cuda)

        def call():
            mega_regen.regen_budget_call(scene, cfg, cam, planes, 7, budgets,
                                         counts)
    else:
        def call():
            mega_step.step_call(scene, cfg, cam, planes, 7, 0, 2.0,
                                cfg.depth)
    before = mega_regen.INSTANCE_LAUNCHES[launcher, want]
    ran = _kernels_run(call)
    plan = mega_regen.launch_plan(freeze_scene(scene), cfg, cam, cuda,
                                  mega_regen.PHOTON)
    assert ran == {plan.instances[launcher]} == {want}
    assert mega_regen.INSTANCE_LAUNCHES[launcher, want] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("launcher, case", _of(CAMERA_LAUNCHERS))
def test_camera_instances_are_the_profilers(cuda, launcher, case):
    """One launch of the fused kernel (uniform, of the fewest samples a
    pixel the tail instance takes, or a budget launch) or one sweep of the
    sweep kernel runs the kernel its plan names, and counts it; a second
    fused launch with the same scene, config and camera finds its plan
    kept."""
    scene, cfg, want = _instance_case(launcher, case, cuda)
    cfg = cfg.with_(wf_pool=2048)
    fs = freeze_scene(scene)
    cam = tt.make_camera(**CAM, aspect_ratio=2.0)
    st = tt.init_state(cfg, cuda)
    if launcher == "wf_fused":
        def call():
            wavefront_fused.wavefront_render_fused(
                scene, cfg, cam, st, 7, mega_regen.TAIL_MIN_SPP)
    elif launcher == "wf_fused_budget":
        budgets = torch.ones_like(st.n_samples)

        def call():
            wavefront_fused.wavefront_render_budget_fused(
                scene, cfg, cam, st, 7, budgets, 1)
    else:
        work = wavefront.PoolWork(camera=cam, base_seed=7, spp=1,
                                  n_valid=cfg.n_pixels)
        sweep = wavefront_sweep.stepper(fs, cfg, work).sweep
        pool = (wavefront.new_pool(cfg.wf_pool, cuda),
                torch.zeros((cfg.n_pixels, 3), device=cuda),
                torch.zeros((cfg.n_pixels,), device=cuda),
                wavefront.new_ctl(cfg.wf_pool, True, cuda))

        def call():
            sweep(*pool)
    before = mega_regen.INSTANCE_LAUNCHES[launcher, want]
    ran = _kernels_run(call)
    plan = mega_regen.launch_plan(fs, cfg, cam, cuda, mega_regen.CAMERA)
    assert ran == {plan.instances[launcher]} == {want}
    assert mega_regen.INSTANCE_LAUNCHES[launcher, want] == before + 1
    if launcher != "wf_sweep":
        hits, builds = mega_regen.PLAN_HITS, mega_regen.PLAN_BUILDS
        call()
        assert (mega_regen.PLAN_HITS - hits,
                mega_regen.PLAN_BUILDS - builds) == (1, 0)


# ----- the instance against the plain version (GPU only) -----

def _pool_and_plain(dev, scene, cfg, cam, seed, spp, it0=0, radius=None,
                    planes=None):
    """One regen launch (which must take the pool instance) and the plain
    version on copies of the same planes: (rays, rays, planes, planes)."""
    if planes is None:
        planes = state_to_planes(tt.init_state(cfg, dev))
    radius = cfg.photon_radius_init if radius is None else radius
    fs = freeze_scene(scene)
    assert mega_regen.pool_engages(fs, cfg)
    pk, pp = planes.clone(), planes.clone()
    before = mega_regen.POOL_LAUNCHES
    rk = int(mega_regen.regen_call(scene, cfg, cam, pk, seed, spp, it0,
                                   radius, cfg.depth))
    assert mega_regen.POOL_LAUNCHES == before + 1
    rp = int(integrate.render_plain(fs, cfg, cam, pp, seed, spp, it0,
                                    radius, cfg.depth))
    torch.cuda.synchronize()
    return rk, rp, pk, pp


def _assert_equal(rk, rp, pk, pp):
    assert rk == rp > 0
    assert torch.equal(pk, pp)


def _counts_since(before):
    """The pool accumulators' growth since ``before`` (a clone of them):
    (trips, lanes) on the one card."""
    return [int(x) for x in mega_regen.lane_counts("cuda") - before]


def _assert_counts(trips, lanes):
    """A launch's counters: every trip ran a lane, no more than 32."""
    assert 0 < trips <= lanes <= 32 * trips


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 4])
def test_pool_cornell_1080p_matches_plain(cuda, spp):
    """The benchmark's Cornell launch (1080p, depth 30, K=4): rays and all
    16 planes bit for bit; the lane counter reads a share in (0, 1] and
    the launch's trips and lanes hold their bounds."""
    cfg = tt.RenderConfig(width=1920, height=1080, depth=30, k_photons=4,
                          backend="pallas")
    cam = tt.make_camera(**CAM, aspect_ratio=16 / 9)
    before = mega_regen.lane_counts(cuda).clone()
    _assert_equal(*_pool_and_plain(cuda, tt.cornell_spheres_scene(
        device=cuda), cfg, cam, 1234 + spp, spp))
    share = mega_regen.lane_share()
    assert share is not None and 0.0 < share <= 1.0
    _assert_counts(*_counts_since(before))


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(50, 30), (33, 7)], ids=["50x30", "33x7"])
def test_pool_ragged_size_matches_plain(cuda, size):
    """A pixel count that is no multiple of a warp or of a block's slots:
    every pixel fetched once, none past the image."""
    cfg = tt.RenderConfig(width=size[0], height=size[1], depth=30,
                          backend="pallas")
    cam = tt.make_camera(**CAM, aspect_ratio=cfg.width / cfg.height)
    _assert_equal(*_pool_and_plain(cuda, tt.cornell_spheres_scene(
        device=cuda), cfg, cam, 99, 3))


@pytest.mark.gpu
def test_pool_launches_back_to_back(cuda):
    """Two pool launches queued on one stream, the second from the first's
    planes at iteration 2 and radius 1.5: each starts from its own zeroed
    work counter. Rays and planes equal two plain calls'."""
    cfg = tt.RenderConfig(width=50, height=30, depth=30, backend="pallas")
    scene = tt.cornell_spheres_scene(device=cuda)
    fs = freeze_scene(scene)
    cam = tt.make_camera(**CAM, aspect_ratio=cfg.width / cfg.height)
    planes = state_to_planes(tt.init_state(cfg, cuda))
    pk, pp = planes.clone(), planes.clone()
    before = mega_regen.POOL_LAUNCHES
    r1 = mega_regen.regen_call(scene, cfg, cam, pk, 5, 2, 0, 2.0, cfg.depth)
    r2 = mega_regen.regen_call(scene, cfg, cam, pk, 5, 1, 2, 1.5, cfg.depth)
    want = int(integrate.render_plain(fs, cfg, cam, pp, 5, 2, 0, 2.0,
                                      cfg.depth))
    want2 = int(integrate.render_plain(fs, cfg, cam, pp, 5, 1, 2, 1.5,
                                       cfg.depth))
    torch.cuda.synchronize()
    assert mega_regen.POOL_LAUNCHES == before + 2
    assert (int(r1), int(r2)) == (want, want2) and want2 > 0
    assert torch.equal(pk, pp)


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 64])
@pytest.mark.parametrize("scene", ["cornell", "lights20"])
@pytest.mark.parametrize("size", [(8, 4), (13, 11), (1, 1)],
                         ids=["8x4", "13x11", "1x1"])
def test_pool_small_images_match_plain(cuda, scene, spp, size):
    """Fewer pixels than a block's slots: most slots retire at once, the
    lists run dry, warps claim short lists and wait for the few live
    slots; Cornell and many_light_scene(20) (NEE over every light). Rays
    and planes bit for bit, and the launch's counters within their bounds:
    trips <= lanes <= 32 trips."""
    sc = (tt.cornell_spheres_scene(device=cuda) if scene == "cornell"
          else tt.many_light_scene(20, device=cuda))
    cfg = tt.RenderConfig(width=size[0], height=size[1], depth=30,
                          k_photons=4, backend="pallas")
    cam = tt.make_camera(**CAM, aspect_ratio=cfg.width / cfg.height)
    before = mega_regen.lane_counts(cuda).clone()
    _assert_equal(*_pool_and_plain(cuda, sc, cfg, cam, 2**31 + 17 * spp,
                                   spp))
    _assert_counts(*_counts_since(before))


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["dispersive", "lights20", "lights128"])
def test_pool_other_sphere_scenes_match_plain(cuda, scene):
    """The dispersive scene (point and square light, dielectrics, metal)
    and many_light_scene with 20 lights (rows staged) and 128 (past the
    shared-memory budget: rows read from global memory), NEE over every
    light: rays and planes bit for bit."""
    sc = {"dispersive": lambda: tt.dispersive_scene(device=cuda),
          "lights20": lambda: tt.many_light_scene(20, device=cuda),
          "lights128": lambda: tt.many_light_scene(128, device=cuda)}[scene]()
    cfg = tt.RenderConfig(width=256, height=144, depth=30, backend="pallas")
    cam = (tt.make_camera((0.0, 3.0, -4.0), (0.0, 1.0, 5.0), vfov=55.0,
                          aspect_ratio=cfg.width / cfg.height)
           if scene == "dispersive" else
           tt.make_camera(**CAM, aspect_ratio=cfg.width / cfg.height))
    fs = freeze_scene(sc)
    plan = mega_regen.launch_plan(fs, cfg, cam, cuda, mega_regen.PHOTON)
    # the floats path.cuh staged_floats stages (up to 4096) or leaves
    rows = (mega_regen.CAM_FLOATS + 8 * len(plan.geo.flat_rows)
            + mega_regen.MAT_STRIDE * len(fs.materials)
            + mega_regen.LIGHT_STRIDE * len(fs.lights))
    assert (rows > 4096) == (scene == "lights128")
    _assert_equal(*_pool_and_plain(cuda, sc, cfg, cam, 1234, 2))
