"""Bench config 5 through the port: the configuration
``bench_torch/configs/dispersive.json`` (the dispersive scene through the
fused wavefront kernel, photons off, 1080p, depth 30), its cell
``dispersive.still_1024`` and the fused kernel's lane counter.

- The configuration is tpurt's ``bench.py`` config 5 field for field; the
  mix ``still_1024`` is ``still.json`` at the spec's 1024 spp; the cell's
  limits are every cell's.
- The harness's whole run of the cell on the CPU (set-up, window, check)
  reads correct, traced and not, at ``test_faults.py``'s 16x8, depth 3,
  4 spp. Not at ``rehearse.py``'s 64x32: there the CPU's plain pool, which
  adds a pixel's samples as its paths end and not in sample order, puts
  some pixel near the tonemap's pole (a radiance of -1 after the key) in
  every job seed tried, and that pixel's image lies 4e-4 to 0.05 from the
  reference's. The card's kernel adds them in sample order.
- The port's ``render`` with the configuration's render keys against the
  reference's camera-paths-only estimator, 16x8, depth 3, 3 spp, two
  seeds: equal rays, state within 1e-6 of each value's largest magnitude
  (the plain pool's order), image within 1e-4; the reference computed in
  bfloat16 lies beyond a limit of the cell.
- The configuration's launch plan names ``fused_tail_kernel`` for its
  uniform launches, the instance bench config 5's still runs, and
  ``fused_kernel`` for its budget launches.
- ``wavefront_fused.lane_share`` and the ``fused_lane_share`` reader on
  the CPU; on a CUDA device, the counter of fused launches: lanes equal to
  the traced segments on a scene without lights (no shadow segments),
  fewer elsewhere, a share in (0, 1], and launches that add.

The GPU cases run where JAX is not installed:
``python -m pytest tests/test_torch_dispersive_config.py -m gpu
--noconftest``.
"""

import importlib
import json
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from bench_torch import check, harness, loop
from bench_torch.reference import integrate as ref
from bench_torch.reference import scene as ref_scene
from bench_torch.reference import tonemap as ref_tm
from bench_torch.reference.scenes import dispersive_scene
from tpurt_torch.config import check_slice
from tpurt_torch.kernels import mega_regen, wavefront_fused
from tpurt_torch.scene import Scene, freeze_scene

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_torch"
CELL = "dispersive.still_1024"
CONFIG5 = json.loads((BENCH / "configs" / "dispersive.json").read_text())
SMALL = dict(width=16, height=8, depth=3)
SPP = 3
LIMIT = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain pool's 262,144-slot planes run many
    times slower with a thread a core on a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_dispersive_config.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _camera(cfg):
    c = CONFIG5["camera"]
    return tt.make_camera(tuple(c["look_from"]), tuple(c["look_at"]),
                          vfov=c["vfov"],
                          aspect_ratio=cfg.width / cfg.height)


# ----- the configuration, its mix and limits -----

def test_config5_is_bench_config_5():
    """Every RenderConfig field, the scene and the camera as tpurt's
    bench.py sets them for config 5."""
    import bench
    from tpurt import RenderConfig
    want_cfg, want_scene, want_cam = bench.build_bench(5, small=False)
    mine = RenderConfig(**CONFIG5["render"])
    for f in type(want_cfg).__dataclass_fields__:
        assert getattr(mine, f) == getattr(want_cfg, f), f
    assert CONFIG5["scene"] == {"builder": "dispersive_scene", "args": {}}
    assert int(want_scene.sph_center.shape[0]) == 5
    cam = _camera(tt.RenderConfig(**CONFIG5["render"]))
    np.testing.assert_array_equal(
        cam.rows(), np.stack([np.asarray(getattr(want_cam, k), np.float32)
                              for k in ("origin", "horizontal", "vertical",
                                        "lower_left")]))
    assert CONFIG5["reduced"] == []
    assert CONFIG5["reference_full_frame"] is False
    # at least torus_mesh_64k's 85 pixels under the mix's 1024 x 3 lanes
    assert CONFIG5["reference_lanes"] // (1024 * 3) >= 85


def test_the_mix_is_still_at_1024_spp_and_the_limits_every_cells():
    mix = json.loads((BENCH / "traffic" / "still_1024.json").read_text())
    still = json.loads((BENCH / "traffic" / "still.json").read_text())
    assert mix["spp"] == 1024
    drop = lambda m: {k: v for k, v in m.items()  # noqa: E731
                      if k not in ("name", "why", "spp")}
    assert drop(mix) == drop(still)
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    assert limits == {"state_gap": LIMIT, "image_gap": LIMIT}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "dispersive", "still_1024", 1)
    metric = {m["name"]: m for m in bench["per_layer"]}["fused_lane_share"]
    assert metric["workloads"] == [CELL] and metric["moves"] == "mrays_s"


def test_both_checks_take_the_configuration():
    render = CONFIG5["render"]
    check_slice(tt.RenderConfig(**render))
    rcfg = ref.check_cfg(render)
    assert rcfg.camera_only and not rcfg.enable_photons


# ----- the harness's whole run on the CPU -----

@pytest.fixture
def harness_here(monkeypatch):
    """The harness refuses to run in a process that imported JAX, tpurt or
    tpurt's bench, which this test process may have done before the
    benchmark ran: the names already imported are the test runner's."""
    monkeypatch.setattr(harness, "FORBIDDEN", tuple(
        m for m in harness.FORBIDDEN if m not in sys.modules))


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_correct_on_the_cpu(traced, harness_here):
    shrink = {"size": (16, 8, 3), "args": {},
              "mix": {"spp": 4, "trace": {"skip_jobs": 1, "jobs": 2}}}
    out = harness.run(CELL, 2**31 + 77, 0.0, traced, time.perf_counter(),
                      device=CPU, shrink=shrink)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"state_gap", "image_gap"}
    assert out["attempted"] >= (3 if traced else 1)


# ----- the port against the reference -----

def _port(seed: int):
    render = dict(CONFIG5["render"], **SMALL)
    cfg = tt.RenderConfig(**render)
    st = tt.render(tt.dispersive_scene(device=CPU), cfg, _camera(cfg),
                   tt.init_state(cfg, device=CPU), seed, SPP)
    return st, cfg, render


@pytest.mark.parametrize("seed", [7, 3000000019])
def test_the_port_matches_the_camera_only_reference(seed):
    st, cfg, render = _port(seed)
    config = dict(CONFIG5, render=render)
    pixels = torch.arange(cfg.n_pixels)
    image = tt.resolve_image(cfg, st).reshape(-1, 3)[pixels]
    prog = {"pixels": pixels, "jobs": [dict(
        seed=seed, spp=SPP, rows=loop.state_rows(st, pixels).float(),
        image=image.float())]}
    rcfg = ref.check_cfg(render)
    got = ref.render_lanes(ref_scene.freeze(dispersive_scene.build(), CPU),
                           rcfg, check.camera_rows(config, rcfg), pixels,
                           seed, SPP)
    assert int(st.rays) == int(got["rays"].sum()) > 0
    want = check.reference_outputs(config, prog, CPU)
    img = ref_tm.tonemap(ref_tm.resolve(got["rgb_sum"], got["n_samples"]))
    assert torch.equal(want["jobs"][0]["image"], img.float())
    numbers = check.compare(prog, want)
    assert numbers["state_gap"] <= 1e-6, numbers
    assert numbers["image_gap"] <= LIMIT, numbers
    assert not st.vis_pos[:cfg.n_pixels].any()    # camera paths only
    control = check.reference_outputs(config, prog, CPU, torch.bfloat16)
    ctrl = check.compare(control, want)
    assert ctrl["state_gap"] > LIMIT or ctrl["image_gap"] > LIMIT, ctrl


# ----- the kernel the configuration's launch runs -----

def test_the_launch_plan_names_fused_kernel():
    cfg = tt.RenderConfig(**CONFIG5["render"])
    fs = freeze_scene(tt.dispersive_scene(device=CPU))
    plan = mega_regen.build_plan(fs, cfg, _camera(cfg), CPU,
                                 mega_regen.CAMERA)
    assert plan.instances["wf_fused"] == mega_regen.TAIL_KERNEL
    assert plan.instances["wf_fused_budget"] == "fused_kernel"
    for launcher, want in (("wf_fused", mega_regen.TAIL_KERNEL),
                           ("wf_fused_budget", "fused_kernel")):
        assert mega_regen.kernel_instance(
            launcher, sampled=False, emission=False, spawn=False,
            lights=False, gleaf=False, triangles=False) == want


# ----- the lane counter and its reader (CPU) -----

def _reader(rec):
    return importlib.import_module(
        "bench_torch.metrics.fused_lane_share").read(rec)


def test_reader_none_without_the_counter(monkeypatch):
    monkeypatch.delattr(wavefront_fused, "lane_share")
    assert _reader({}) is None


def test_reader_none_before_a_fused_launch(monkeypatch):
    """A CPU render runs the plain pool and launches nothing."""
    monkeypatch.setattr(wavefront_fused, "LAUNCHES", 0)
    _port(5)
    assert wavefront_fused.LAUNCHES == 0
    assert wavefront_fused.lane_share() is None
    assert _reader({}) is None


def test_reader_reads_percent(monkeypatch):
    monkeypatch.setattr(wavefront_fused, "lane_share", lambda: 0.375)
    assert _reader({}) == pytest.approx(37.5)


def test_lane_share_reads_the_accumulators(monkeypatch):
    """lanes / (32 * trips), summed over the devices' accumulators; None
    where the launches made no trip."""
    monkeypatch.setattr(wavefront_fused, "LAUNCHES", 2)
    monkeypatch.setattr(wavefront_fused, "_LANES", {
        torch.device(CPU): torch.tensor([10, 200], dtype=torch.int64),
        torch.device(CPU, 1): torch.tensor([6, 120], dtype=torch.int64)})
    assert wavefront_fused.lane_share() == 320 / (32 * 16)
    monkeypatch.setattr(wavefront_fused, "_LANES", {
        torch.device(CPU): torch.zeros((2,), dtype=torch.int64)})
    assert wavefront_fused.lane_share() is None


def test_lane_counts_is_one_kept_pair(monkeypatch):
    """Two int64 zeros made on the first call, then the same tensor, apart
    from the pool instance's pair."""
    monkeypatch.setattr(wavefront_fused, "_LANES", {})
    monkeypatch.setattr(wavefront_fused, "LAUNCHES", 1)
    acc = wavefront_fused.lane_counts(CPU)
    assert acc.dtype == torch.int64 and acc.tolist() == [0, 0]
    assert wavefront_fused.lane_counts(CPU) is acc
    assert acc is not mega_regen.lane_counts(CPU)
    assert wavefront_fused.lane_share() is None     # no trip yet
    acc += torch.tensor([4, 96])
    assert wavefront_fused.lane_share() == 96 / (32 * 4)


# ----- the counter on the card (GPU only) -----

def _dark_scene(device):
    """The dispersive scene without its lights: no next-event estimation,
    so every traced segment is a path's."""
    t = tt.dispersive_scene(device=device).tensors()
    return Scene(**{k: v[:0] if k.startswith("light_") else v
                    for k, v in t.items()})


def _fused(scene, cfg, seed, spp, device):
    """One fused launch from a fresh state: (rays, trips, lanes)."""
    before = wavefront_fused.lane_counts(device).clone()
    n = wavefront_fused.LAUNCHES
    st = wavefront_fused.wavefront_render_fused(
        scene, cfg, _camera(cfg), tt.init_state(cfg, device), seed, spp)
    torch.cuda.synchronize()
    assert wavefront_fused.LAUNCHES == n + 1
    trips, lanes = (int(x) for x in
                    wavefront_fused.lane_counts(device) - before)
    return int(st.rays), trips, lanes


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(64, 32), (33, 7)], ids=["64x32", "33x7"])
def test_lanes_are_the_segments_without_lights(cuda, size):
    cfg = tt.RenderConfig(**dict(CONFIG5["render"], width=size[0],
                                 height=size[1]))
    scene = _dark_scene(cuda)
    rays, trips, lanes = _fused(scene, cfg, 11, 4, cuda)
    assert lanes == rays > 0
    assert 0 < trips and lanes <= 32 * trips


@pytest.mark.gpu
def test_lane_counter_on_the_dispersive_scene_and_launches_add(cuda):
    cfg = tt.RenderConfig(**dict(CONFIG5["render"], width=160, height=90))
    scene = tt.dispersive_scene(device=cuda)
    first = _fused(scene, cfg, 3, 4, cuda)
    second = _fused(scene, cfg, 4, 2, cuda)
    for rays, trips, lanes in (first, second):
        # each diffuse hit adds one shadow segment a light to the rays
        assert 0 < lanes < rays <= 3 * lanes
        assert 0 < trips and lanes <= 32 * trips
    before = wavefront_fused.lane_counts(cuda).clone()
    for seed, spp in ((3, 4), (4, 2)):
        wavefront_fused.wavefront_render_fused(
            scene, cfg, _camera(cfg), tt.init_state(cfg, cuda), seed, spp)
    torch.cuda.synchronize()
    grown = (wavefront_fused.lane_counts(cuda) - before).tolist()
    assert grown == [first[1] + second[1], first[2] + second[2]]
    share = wavefront_fused.lane_share()
    assert share is not None and 0.0 < share <= 1.0
    assert 0.0 < _reader({}) <= 100.0
