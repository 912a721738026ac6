"""The fused wavefront kernel's tail instance (``csrc/fused_tail.cuh``,
``csrc/fused_tail.cu fused_tail_kernel``): which fused launches take it
(``wavefront_fused.tail_engages``, the launch plan's instance and the
launcher's rule on samples a pixel), its counter of tail segments and the
share it reads (``wavefront_fused.tail_counts``, ``tail_share``), the
benchmark's metric
of it, on the CPU; and, on a CUDA device, the uniform launch (the tail
instance from ``TAIL_MIN_SPP`` samples a pixel, ``fused_kernel`` below)
against ``fused_kernel`` (a budget launch with uniform budgets) and the
regen kernel with photons off, rgb_sum and rays bit for bit, and its
counters.

No JAX here: the GPU cases run where it is not installed,
``python -m pytest tests/test_torch_fused_tail.py -m gpu --noconftest``.
"""

import json
import pathlib

import pytest
import torch

import tpurt_torch as tt
from tpurt_torch.kernels import mega_regen, wavefront_fused
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import Scene, freeze_scene

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "tpurt_torch" / "csrc"
TAIL = mega_regen.TAIL_KERNEL
MIN_SPP = mega_regen.TAIL_MIN_SPP
DISP_CAM = ((0.0, 3.0, -4.0), (0.0, 1.0, 5.0), 55.0)
CORNELL_CAM = ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), 60.0)
TORUS_CAM = ((0.0, 3.0, -6.0), (0.0, 1.5, 0.0), 55.0)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_fused_tail.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _cfg(**kw):
    return tt.RenderConfig(**{"width": 64, "height": 32, "depth": 8,
                              "enable_photons": False,
                              "backend": "wavefront_fused", **kw})


def _camera(cfg, cam=DISP_CAM):
    return tt.make_camera(cam[0], cam[1], vfov=cam[2],
                          aspect_ratio=cfg.width / cfg.height)


# ----- which fused launches take the tail instance (CPU) -----

SCENES = {"cornell": tt.cornell_spheres_scene,
          "dispersive": tt.dispersive_scene,
          "lights20": lambda device: tt.many_light_scene(20, device=device),
          "torus": lambda device: tt.torus_mesh_scene(8, 6, device=device)}
SWITCHES = {"ref": {}, "hero": dict(hero_wavelengths=4),
            "sky": dict(sky_intensity=0.2), "qmc": dict(qmc=True),
            "power": dict(light_sample="power")}


LAUNCH_SPP = {"uniform-1spp": 1, "uniform-below": MIN_SPP - 1,
              "uniform-min": MIN_SPP, "uniform-1024spp": 1024,
              "budget": None}


@pytest.mark.parametrize("launch", list(LAUNCH_SPP))
@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("scene", list(SCENES))
def test_tail_engages_is_the_plans_instance(scene, switches, launch):
    """A uniform launch of TAIL_MIN_SPP samples a pixel or more under the
    reference sampler and without switches, on a sphere or a mesh scene,
    runs the tail instance; the plan of a CAMERA launch names it for
    "wf_fused" exactly where the switches allow it, the launch
    runs it exactly where tail_engages says so (fused_kernel at fewer
    samples), and "wf_fused_budget" never takes it."""
    fs = freeze_scene(SCENES[scene](device=CPU))
    cfg = _cfg(**SWITCHES[switches])
    plan = mega_regen.build_plan(fs, cfg, _camera(cfg), CPU,
                                 mega_regen.CAMERA)
    spp = LAUNCH_SPP[launch]
    launcher = "wf_fused" if spp is not None else "wf_fused_budget"
    planned = plan.instances[launcher]
    allowed = spp is not None and switches == "ref"
    assert (planned == TAIL) == allowed
    engages = wavefront_fused.tail_engages(fs, cfg, spp)
    assert engages == (allowed and spp >= MIN_SPP)
    ran = planned if spp is None else wavefront_fused._instance(planned, spp)
    assert (ran == TAIL) == engages
    if not engages and switches == "ref":
        assert ran == "fused_kernel"


def test_the_spp_rule_is_the_launchers():
    """The Python mirror's fewest samples a pixel is the C launcher's
    literal, which the launcher tests before it runs the tail instance."""
    import re
    loop = (CSRC / "fused_tail.cuh").read_text()
    assert int(re.search(r"constexpr int TAIL_MIN_SPP = (\d+);",
                         loop).group(1)) == MIN_SPP > 1
    fused = (CSRC / "wavefront_fused.cu").read_text()
    assert "spp >= TAIL_MIN_SPP" in fused


# ----- the tail-segment counter (CPU) -----

def test_tail_share_reads_the_accumulators(monkeypatch):
    """Tail segments over path segments, summed over the devices'
    accumulators; None where the launches traced no path segment."""
    monkeypatch.setattr(wavefront_fused, "_TAIL", {
        torch.device(CPU): torch.tensor([400, 20], dtype=torch.int64),
        torch.device(CPU, 1): torch.tensor([100, 5], dtype=torch.int64)})
    assert wavefront_fused.tail_share() == 25 / 500
    monkeypatch.setattr(wavefront_fused, "_TAIL", {
        torch.device(CPU): torch.zeros((2,), dtype=torch.int64)})
    assert wavefront_fused.tail_share() is None


def test_tail_share_is_none_before_a_launch_of_the_instance(monkeypatch):
    """A CPU render runs the plain pool and launches nothing, so no
    accumulator is made."""
    monkeypatch.setattr(wavefront_fused, "_TAIL", {})
    cfg = _cfg(width=8, height=4, depth=3)
    tt.render(tt.dispersive_scene(device=CPU), cfg, _camera(cfg),
              tt.init_state(cfg, device=CPU), 5, 1)
    assert wavefront_fused._TAIL == {}
    assert wavefront_fused.tail_share() is None


def test_tail_counts_is_one_kept_pair_per_device(monkeypatch):
    """Two int64 zeros made on the first call, then the same tensor,
    apart from both lane counters' pairs; the share reads what the
    launches added."""
    monkeypatch.setattr(wavefront_fused, "_TAIL", {})
    acc = wavefront_fused.tail_counts(CPU)
    assert acc.dtype == torch.int64 and acc.tolist() == [0, 0]
    assert wavefront_fused.tail_counts(torch.device(CPU)) is acc
    assert acc is not wavefront_fused.lane_counts(CPU)
    assert acc is not mega_regen.lane_counts(CPU)
    assert wavefront_fused.tail_share() is None     # no segment yet
    acc += torch.tensor([96, 12])
    assert wavefront_fused.tail_share() == 12 / 96


def test_a_fused_launch_takes_five_counter_words():
    """rays, the work counter, trips, lanes, tail segments: fresh
    zeros."""
    c = mega_regen.launch_counters(CPU, 5)
    assert c.dtype == torch.int64 and c.tolist() == [0] * 5


def test_the_benchmark_reads_the_share_in_the_dispersive_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metric = {m["name"]: m for m in bench["per_layer"]}["fused_tail_share"]
    assert metric == {
        "name": "fused_tail_share", "unit": "%", "better": "higher",
        "source": "program_span",
        "layer": "path kernels (kernels/mega_regen.py, csrc/)",
        "moves": "mrays_s", "workloads": ["dispersive.still_1024"]}
    assert (ROOT / "bench_torch" / "metrics" /
            "fused_tail_share.py").is_file()


def test_source_notes():
    """The loop says why the stragglers stay in their lanes and not in a
    pool, and how the warp stays coherent; the kernel's module which TPU
    kernel it replaces, what bounds it and its engagement rule; the fused
    launcher dispatches to it."""
    loop = (CSRC / "fused_tail.cuh").read_text().split("#pragma once")[0]
    for words in ("lockstep", "Why the stragglers stay in their lanes",
                  "consecutive", "bit for bit", "sample order"):
        assert words in loop
    note = (CSRC / "fused_tail.cu").read_text().split("#include")[0]
    for words in ("tpurt/kernels/wavefront_pallas.py:_make_fused_kernel",
                  "What bounds it", "tail_engages", "wavefront_render"):
        assert words in note
    fused = (CSRC / "wavefront_fused.cu").read_text()
    assert "launch_fused_tail" in fused and "fused_tail_kernel" in fused


# ----- the instance on the card (GPU only) -----

def _dark_scene(device):
    """The dispersive scene without its lights: every traced segment is
    a path's."""
    t = tt.dispersive_scene(device=device).tensors()
    return Scene(**{k: v[:0] if k.startswith("light_") else v
                    for k, v in t.items()})


def _tail_fused_regen(scene, cfg, cam, st, seed, spp):
    """The uniform launch from ``st`` (the tail instance from TAIL_MIN_SPP
    samples a pixel, fused_kernel below), the budget launch with uniform
    budgets (fused_kernel) and the regen kernel with photons off on the
    state's planes: each result's rgb_sum and rays must be equal. Returns
    the uniform launch's state and its counters' growth (trips, lanes,
    path segments, tail segments)."""
    dev = st.device
    want = TAIL if spp >= MIN_SPP else "fused_kernel"
    assert wavefront_fused.tail_engages(freeze_scene(scene), cfg,
                                        spp) == (want == TAIL)
    lanes0 = wavefront_fused.lane_counts(dev).clone()
    tail0 = wavefront_fused.tail_counts(dev).clone()
    n_tail = mega_regen.INSTANCE_LAUNCHES["wf_fused", want]
    n_fused = mega_regen.INSTANCE_LAUNCHES["wf_fused_budget", "fused_kernel"]
    got = wavefront_fused.wavefront_render_fused(scene, cfg, cam, st, seed,
                                                 spp)
    torch.cuda.synchronize()
    trips, lanes = (int(x) for x in
                    wavefront_fused.lane_counts(dev) - lanes0)
    paths, tail = (int(x) for x in
                   wavefront_fused.tail_counts(dev) - tail0)
    budgets = torch.full_like(st.n_samples, float(spp))
    ref = wavefront_fused.wavefront_render_budget_fused(
        scene, cfg, cam, st, seed, budgets, spp)
    planes = state_to_planes(st)
    rays = mega_regen.regen_call(scene, cfg.with_(backend="pallas"), cam,
                                 planes, seed, spp, st.iteration, 2.0,
                                 cfg.depth)
    assert mega_regen.INSTANCE_LAUNCHES["wf_fused", want] == n_tail + 1
    assert mega_regen.INSTANCE_LAUNCHES[
        "wf_fused_budget", "fused_kernel"] == n_fused + 1
    n = cfg.n_pixels
    prior = int(st.rays)
    assert int(got.rays) - prior == int(ref.rays) - prior == int(rays) > 0
    assert torch.equal(got.rgb_sum[:n], ref.rgb_sum[:n])
    assert torch.equal(got.rgb_sum[:n], planes[0:3].T[:n])
    assert 0 < trips <= lanes <= 32 * trips
    if want == TAIL:
        assert paths == lanes and 0 <= tail <= paths
    else:
        assert (paths, tail) == (0, 0)
    return got, (trips, lanes, paths, tail)


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 4, MIN_SPP - 1, MIN_SPP, 64])
def test_bench_config5_at_1080p(cuda, spp):
    cfg = _cfg(width=1920, height=1080, depth=30)
    _tail_fused_regen(tt.dispersive_scene(device=cuda), cfg, _camera(cfg),
                      tt.init_state(cfg, cuda), 3000000019, spp)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(1, 1), (8, 4), (13, 11), (50, 30)],
                         ids=["1x1", "8x4", "13x11", "50x30"])
def test_small_images(cuda, size):
    cfg = _cfg(width=size[0], height=size[1], depth=30)
    _tail_fused_regen(tt.dispersive_scene(device=cuda), cfg, _camera(cfg),
                      tt.init_state(cfg, cuda), 77, MIN_SPP)


@pytest.mark.gpu
def test_a_state_with_prior_samples(cuda):
    """From iteration 5 with rows that are not zero."""
    cfg = _cfg(width=160, height=90, depth=30)
    scene, cam = tt.dispersive_scene(device=cuda), _camera(cfg)
    st = wavefront_fused.wavefront_render_fused(
        scene, cfg, cam, tt.init_state(cfg, cuda), 11, 5)
    assert st.iteration == 5 and bool(st.rgb_sum.abs().sum() > 0)
    _tail_fused_regen(scene, cfg, cam, st, 12, MIN_SPP + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n_lights", [20, 128])
def test_many_lights_all(cuda, n_lights):
    cfg = _cfg(width=96, height=48, depth=12, light_sample="all")
    _tail_fused_regen(tt.many_light_scene(n_lights, device=cuda), cfg,
                      _camera(cfg), tt.init_state(cfg, cuda), 21, MIN_SPP)


@pytest.mark.gpu
def test_torus_mesh(cuda):
    """A mesh scene: the walks keep their stacks in the launch's shared
    memory, as fused_kernel's do."""
    cfg = _cfg(width=96, height=48, depth=30, pallas_bvh_leaf=64)
    _tail_fused_regen(tt.torus_mesh_scene(45, 45, device=cuda), cfg,
                      _camera(cfg, TORUS_CAM), tt.init_state(cfg, cuda),
                      13, MIN_SPP)


@pytest.mark.gpu
def test_cornell_photons_off(cuda):
    cfg = _cfg(width=128, height=64, depth=30)
    _tail_fused_regen(tt.cornell_spheres_scene(device=cuda), cfg,
                      _camera(cfg, CORNELL_CAM), tt.init_state(cfg, cuda),
                      9, MIN_SPP)


@pytest.mark.gpu
def test_two_launches_back_to_back(cuda):
    """Each equals its references, and the accumulator grows by both."""
    cfg = _cfg(width=320, height=180, depth=30)
    scene, cam = tt.dispersive_scene(device=cuda), _camera(cfg)
    st = tt.init_state(cfg, cuda)
    tail0 = wavefront_fused.tail_counts(cuda).clone()
    _, first = _tail_fused_regen(scene, cfg, cam, st, 3, MIN_SPP)
    _, second = _tail_fused_regen(scene, cfg, cam, st, 4, MIN_SPP)
    grown = (wavefront_fused.tail_counts(cuda) - tail0).tolist()
    assert grown == [first[2] + second[2], first[3] + second[3]]
    share = wavefront_fused.tail_share()
    assert share is not None and 0.0 <= share <= 1.0


@pytest.mark.gpu
def test_lanes_are_the_segments_without_lights(cuda):
    """No next-event estimation: every traced segment is a path segment,
    in a tail or not; some are in tails."""
    cfg = _cfg(width=480, height=270, depth=30)
    scene = _dark_scene(cuda)
    st, (trips, lanes, paths, tail) = _tail_fused_regen(
        scene, cfg, _camera(cfg), tt.init_state(cfg, cuda), 5, MIN_SPP)
    assert lanes == int(st.rays)
    assert 0 < tail < paths
