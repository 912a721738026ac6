"""The reference's scene twins, found by name, and the paths of the one
integrator they share, each held to the port's plain path on the CPU.

- ``dispersive_scene`` (tpurt's bench configs 4 and 5: a metal, a point
  light beside a square one) at 16x8, depth 3, 3 spp, two seeds, with
  photons on and off on the progressive estimator (``backend="xla"``) and
  on the wavefront tracers' camera-paths-only estimator at two pool sizes:
  equal ray counts, state rows within 1e-4 of each value's largest
  magnitude (the cells' ``state_gap`` limit), the vispoints left zero by
  the wavefront tracers.
- The reference sees each of these paths: with the gold made diffuse, the
  point light taken out, its photons' cone fraction dropped, or the other
  estimator, its rows lie more than 1e-4 from the port's.
- The check end to end (``check.reference_outputs``, ``check.compare``) on
  bench config 5 cut to 16x8, depth 3, against the port's plain
  ``wavefront`` render; a state 1% high fails it. The harness's whole run
  of a cell of that configuration is correct, and not correct under each
  fault of ``test_faults.py``.
- ``scenes.twin`` finds each configuration's twin and names the file it
  looked for where there is none; ``check_cfg`` and ``render_lanes`` still
  refuse what the reference does not implement.
"""

import dataclasses
import json
import pathlib
import time

import pytest
import torch

import tpurt_torch as tt
from bench_torch import check, harness, loop
from bench_torch.reference import integrate as ref
from bench_torch.reference import scene as ref_scene
from bench_torch.reference import scenes
from bench_torch.reference.scenes import dispersive_scene
from bench_torch.tests import test_faults

CPU = "cpu"
GAP = 1e-4
SEEDS = [5, 3000000019]
SPP = 3
# tpurt's bench config 5 (bench.py): the fused wavefront kernel on the
# dispersive scene, photons off, a pool of 262,144 slots, 1080p, depth 30
CONFIG5 = {
    "scene": {"builder": "dispersive_scene", "args": {}},
    "camera": {"look_from": [0.0, 3.0, -4.0], "look_at": [0.0, 1.0, 5.0],
               "vfov": 55.0},
    "render": {"width": 1920, "height": 1080, "depth": 30,
               "backend": "wavefront_fused", "enable_photons": False,
               "wf_pool": 262144},
    "reference_lanes": 4096,
}
SMALL = dict(width=16, height=8, depth=3)
MODES = {
    "xla": dict(backend="xla"),
    "xla_photons_off": dict(backend="xla", enable_photons=False),
    "wavefront": dict(backend="wavefront"),
    "wavefront_pool_64": dict(backend="wavefront", enable_photons=False,
                              wf_pool=64),
    "wavefront_pool_4096": dict(backend="wavefront", enable_photons=False,
                                wf_pool=4096),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain pool's 262,144-slot planes run ~25x
    slower with a thread a core on a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_state(render: dict, seed: int, spp: int = SPP):
    """The port's plain render of a fresh state, and its config."""
    cfg = tt.RenderConfig(**render)
    c = CONFIG5["camera"]
    cam = tt.make_camera(tuple(c["look_from"]), tuple(c["look_at"]),
                         vfov=c["vfov"], aspect_ratio=cfg.width / cfg.height)
    st = tt.render(tt.dispersive_scene(device=CPU), cfg, cam,
                   tt.init_state(cfg, device=CPU), seed, spp)
    return st, cfg


def reference_rows(render: dict, pixels, seed: int, desc=None, rcfg=None):
    """The reference's state rows at ``pixels`` and its ray count."""
    rcfg = rcfg or ref.check_cfg(render)
    desc = desc or dispersive_scene.build()
    want = ref.render_lanes(ref_scene.freeze(desc, CPU), rcfg,
                            check.camera_rows(dict(CONFIG5, render=render),
                                              rcfg), pixels, seed, SPP)
    rows = torch.cat([want["rgb_sum"], want["n_samples"][:, None],
                      want["vis"]], 1)
    return rows, int(want["rays"].sum())


def gap(got, rows) -> float:
    scale = rows.abs().amax(dim=0).clamp_min(1e-30)
    return float(((got - rows).abs().amax(dim=0) / scale).max())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", MODES)
def test_dispersive_scene_matches_the_port(mode, seed):
    render = dict(MODES[mode], **SMALL)
    st, cfg = port_state(render, seed)
    pixels = torch.arange(cfg.n_pixels)
    rows, rays = reference_rows(render, pixels, seed)
    got = loop.state_rows(st, pixels)
    assert gap(got, rows) <= GAP
    assert int(st.rays) == rays > 0
    vis = rows[:, 4:]
    if mode.startswith("wavefront"):
        assert not got[:, 4:].any() and not vis.any()
    else:
        assert vis.abs().amax() > 0


def _gold_diffuse():
    d = dispersive_scene.build()
    m = list(d.materials)
    assert m[3].mtype == 2
    m[3] = ref_scene.diffuse(m[3].color, m[3].roughness)
    return dataclasses.replace(d, materials=tuple(m))


def _no_point_light():
    d = dispersive_scene.build()
    assert d.lights[0].ltype == 0
    return dataclasses.replace(d, lights=d.lights[1:])


def _area_photon_power(light, k_photons):
    return tuple(ref_scene._f32(light.color[c] * light.intensity / k_photons)
                 for c in range(3))


# (mode, what the reference is given in place of the sound twin or cfg)
BLIND = {
    "gold_diffuse": ("xla", dict(desc=_gold_diffuse)),
    "gold_diffuse_wavefront": ("wavefront", dict(desc=_gold_diffuse)),
    "no_point_light": ("xla", dict(desc=_no_point_light)),
    "no_point_light_wavefront": ("wavefront", dict(desc=_no_point_light)),
    "point_photons_without_cone": ("xla", dict(power=_area_photon_power)),
    "photons_on_for_photons_off": ("xla_photons_off",
                                   dict(cfg=dict(enable_photons=True))),
    "progressive_for_wavefront": ("wavefront",
                                  dict(cfg=dict(camera_only=False))),
    "wavefront_for_progressive": ("xla_photons_off",
                                  dict(cfg=dict(camera_only=True))),
}


@pytest.mark.parametrize("case", BLIND)
def test_the_reference_sees_each_path(case, monkeypatch):
    mode, broken = BLIND[case]
    render = dict(MODES[mode], **SMALL)
    st, cfg = port_state(render, SEEDS[0])
    pixels = torch.arange(cfg.n_pixels)
    if "power" in broken:
        monkeypatch.setattr(ref, "photon_power", broken["power"])
    rcfg = dataclasses.replace(ref.check_cfg(render),
                               **broken.get("cfg", {}))
    desc = broken["desc"]() if "desc" in broken else None
    rows, _ = reference_rows(render, pixels, SEEDS[0], desc, rcfg)
    assert gap(loop.state_rows(st, pixels), rows) > GAP


def _program_outputs(config: dict, seed: int) -> dict:
    """What ``check.program_outputs`` keeps of a job: the port's state rows
    and image at the check's grid pixels."""
    render = dict(config["render"], backend="wavefront")
    st, cfg = port_state(render, seed)
    pixels = check.grid_pixels(seed, cfg.width, cfg.height,
                               check.pixel_count(config, SPP, 1))
    image = tt.resolve_image(cfg, st).reshape(-1, 3)[pixels]
    return {"pixels": pixels, "jobs": [dict(
        seed=seed, spp=SPP, rows=loop.state_rows(st, pixels).float(),
        image=image.float())]}


@pytest.mark.parametrize("seed", SEEDS)
def test_check_passes_bench_config_5_and_fails_a_state_1pc_high(seed):
    config = dict(CONFIG5, render=dict(CONFIG5["render"], **SMALL))
    prog = _program_outputs(config, seed)
    want = check.reference_outputs(config, prog, CPU)
    numbers = check.compare(prog, want)
    assert numbers["state_gap"] <= GAP and numbers["image_gap"] <= GAP, \
        numbers
    assert not want["jobs"][0]["rows"][:, 4:].any()
    prog["jobs"][0]["rows"][:, 0:3] *= 1.01
    assert check.compare(prog, want)["state_gap"] > GAP


def _with_a_wavefront_cell(monkeypatch) -> str:
    """``harness.load`` knows one more cell: bench config 5 under the
    still mix, with the limits of ``cornell.still``."""
    real = harness.load

    def load(workload):
        if workload != "dispersive.fused":
            return real(workload)
        bench, _, _, mix, limits = real("cornell.still")
        entry = {"name": workload, "config": "dispersive",
                 "traffic": "still", "chips": 1}
        return (bench, entry, dict(CONFIG5, reference_full_frame=False),
                mix, limits)
    monkeypatch.setattr(harness, "load", load)
    return "dispersive.fused"


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_of_a_wavefront_cell_is_correct(traced, monkeypatch):
    name = _with_a_wavefront_cell(monkeypatch)
    out = harness.run(name, 2**31 + 77, 0.0, traced, time.perf_counter(),
                      device="cpu", shrink=test_faults.shrink(name))
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", test_faults.FAULTS,
                         ids=lambda f: f.__name__)
def test_each_fault_reaches_a_wavefront_cell(fault, monkeypatch):
    name = _with_a_wavefront_cell(monkeypatch)
    fault(monkeypatch)
    out = harness.run(name, 2**31 + 77, 0.0, False, time.perf_counter(),
                      device="cpu", shrink=test_faults.shrink(name))
    assert out["correct"] is False, out["checks"]


CONFIGS = harness.HERE / "configs"


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        CONFIGS.glob("*.json")))
def test_every_configuration_has_a_twin(name):
    scene = json.loads((CONFIGS / f"{name}.json").read_text())["scene"]
    mod = scenes.twin(scene["builder"])
    assert isinstance(mod.SMALL_ARGS, dict)
    assert isinstance(mod.TINY_ARGS, dict)
    assert isinstance(mod.build(**mod.TINY_ARGS), ref_scene.Desc)
    assert ref_scene.BUILDERS[scene["builder"]] is mod.build


def test_twins_are_found_by_name():
    assert set(scenes.names()) >= {"cornell_spheres_scene",
                                   "dispersive_scene", "torus_mesh_scene"}
    assert sorted(ref_scene.BUILDERS) == scenes.names()
    d = scenes.twin("dispersive_scene").build()
    assert [m.mtype for m in d.materials] == [0, 1, 1, 2, 0]
    assert [lt.ltype for lt in d.lights] == [0, 1]
    assert len(d.spheres) == 5 and d.tri_a.shape[0] == 0


@pytest.mark.parametrize("name", ["no_such_scene", "__init__", "../scene",
                                  "scene.py"])
def test_an_unknown_builder_names_the_file(name):
    with pytest.raises(LookupError) as e:
        scenes.twin(name)
    assert str(pathlib.Path(scenes.HERE) / f"{name}.py") in str(e.value)
    with pytest.raises(KeyError):
        ref_scene.BUILDERS[name]


def test_check_cfg_reads_backend_and_takes_the_pool_at_any_size():
    base = dict(SMALL, enable_photons=False)
    assert not ref.check_cfg(dict(base, backend="pallas")).camera_only
    assert not ref.check_cfg(dict(base, backend="xla")).camera_only
    for b in ("wavefront", "wavefront_pallas", "wavefront_fused"):
        assert ref.check_cfg(dict(base, backend=b)).camera_only
    for q in (1, 64, 262144):
        cfg = ref.check_cfg(dict(base, backend="wavefront_fused", wf_pool=q,
                                 wf_max_sweeps=100000))
        assert cfg == ref.check_cfg(dict(base, backend="wavefront_fused"))
    assert not ref.check_cfg(base).enable_photons
    with pytest.raises(NotImplementedError):
        ref.check_cfg(dict(base, camera_only=True))


REFUSED = {
    "light_sample": dict(light_sample="power"),
    "dispersion_in_camera_path": dict(dispersion_in_camera_path=True),
    "pallas_mxu_leaf": dict(pallas_mxu_leaf=True),
    "qmc": dict(qmc=True),
    "aperture": dict(aperture=0.1),
    "motion_blur": dict(motion_blur=True),
    "sky_intensity": dict(sky_intensity=1.0),
    "sky_gradient": dict(sky_gradient=True),
    "radiance_clamp": dict(radiance_clamp=10.0),
    "photon_aim": dict(photon_aim=0.5),
    "wf_max_sweeps": dict(wf_max_sweeps=1000),
}


@pytest.mark.parametrize("knob", REFUSED)
def test_check_cfg_refuses(knob):
    with pytest.raises(NotImplementedError, match=knob):
        ref.check_cfg(dict(SMALL, backend="wavefront_fused",
                           **REFUSED[knob]))


def test_render_lanes_refuses_more_than_64_spheres():
    d = dispersive_scene.build()
    many = d.spheres + tuple((0, 0.1, (0.3 * i, 0.1, 9.0))
                             for i in range(65 - len(d.spheres)))
    fs = ref_scene.freeze(dataclasses.replace(d, spheres=many), CPU)
    assert len(fs.spheres) == 65
    render = dict(SMALL, backend="xla")
    rcfg = ref.check_cfg(render)
    with pytest.raises(NotImplementedError, match="64 spheres"):
        ref.render_lanes(fs, rcfg, check.camera_rows(
            dict(CONFIG5, render=render), rcfg), torch.arange(4), 1, 1)
