"""The regen kernel's pool instance (``csrc/path_pool.cuh``,
``csrc/path_pool.cu regen_pool_kernel``): which launches take it
(``mega_regen.pool_engages``, the launcher's rule), its launch count and
lane counter on the CPU; and, on a CUDA device, the instance against the
plain version (``integrate.render_plain``), all 16 state planes and the
ray count bit for bit.

No JAX here: the GPU cases run where it is not installed,
``python -m pytest tests/test_torch_regen_pool.py -m gpu --noconftest``.
"""

import pathlib

import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import mega_regen
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
    dict(rr_threshold=0.05), dict(pallas_sphere_bvh=True)],
    ids=["default", "k4", "no-photons", "rr", "sphere-bvh"])
def test_pool_engages_on_spheres_under_the_reference_sampler(flags):
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


@pytest.mark.parametrize("scene", ["cornell", "dispersive", "lights20",
                                   "torus"])
@pytest.mark.parametrize("flags", [{}, dict(hero_wavelengths=4),
                                   dict(qmc=True), dict(light_sample="power"),
                                   dict(sky_intensity=0.2)],
                         ids=["ref", "hero", "qmc", "power", "sky"])
def test_pool_engages_is_the_launchers_rule(scene, flags):
    """pool_engages is what the launcher sees in its input: no emission,
    spawn or lights struct, the sampler switches off, no triangle rows;
    the launch plan carries it."""
    make = {"cornell": tt.cornell_spheres_scene,
            "dispersive": tt.dispersive_scene,
            "lights20": lambda device: tt.many_light_scene(20, device=device),
            "torus": lambda device: tt.torus_mesh_scene(8, 6, device=device)}
    fs = freeze_scene(make[scene](device=CPU))
    cfg = _cornell_cfg(**flags)
    plan = mega_regen.build_plan(fs, cfg, tt.make_camera(
        **CAM, aspect_ratio=2.0), CPU)
    rule = (plan.emission is None and plan.spawn is None
            and plan.lights is None
            and not mega_regen.sampler_on(plan.sampler)
            and plan.geo_args.n_tri == 0)
    assert plan.pool == rule == mega_regen.pool_engages(fs, cfg)
    assert plan.pool == (scene != "torus" and not flags)


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


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 4])
def test_pool_cornell_1080p_matches_plain(cuda, spp):
    """The benchmark's Cornell launch (1080p, depth 30, K=4): rays and all
    16 planes bit for bit; the lane counter reads a share in (0, 1]."""
    cfg = tt.RenderConfig(width=1920, height=1080, depth=30, k_photons=4,
                          backend="pallas")
    cam = tt.make_camera(**CAM, aspect_ratio=16 / 9)
    _assert_equal(*_pool_and_plain(cuda, tt.cornell_spheres_scene(
        device=cuda), cfg, cam, 1234 + spp, spp))
    share = mega_regen.lane_share()
    assert share is not None and 0.0 < share <= 1.0


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
    plan = mega_regen.launch_plan(fs, cfg, cam, cuda)
    # the floats path.cuh staged_floats stages (up to 4096) or leaves
    rows = (mega_regen.CAM_FLOATS + 8 * len(plan.geo.flat_rows)
            + mega_regen.MAT_STRIDE * len(fs.materials)
            + mega_regen.LIGHT_STRIDE * len(fs.lights))
    assert (rows > 4096) == (scene == "lights128")
    _assert_equal(*_pool_and_plain(cuda, sc, cfg, cam, 1234, 2))
