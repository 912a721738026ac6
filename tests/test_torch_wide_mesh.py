"""Bench config 7's mesh through the port: the configuration
``bench_torch/configs/torus_mesh_64k.json`` (a 64,800-triangle torus, an
8-ary BVH with leaves of 16) at a small size against the benchmark's plain
reference, and the counters and spans of the port's tree builds.

- The port's ``render`` with the configuration's render keys, on
  ``torus_mesh_scene(24, 24)`` (1,152 triangles: the 8-ary tree at leaf 16
  has more than one level), 64x32, depth 4, 2 spp, against
  ``bench_torch.reference.integrate.render_lanes`` at every pixel: state
  rows within 1e-4 of each value's largest magnitude (the benchmark's
  ``state_gap`` limit) and equal ray counts. On the CPU the port runs its
  plain integrator; the card's walk is held to it by the GPU tests of
  ``tests/test_torch_mesh_render.py``.
- The configuration is tpurt's ``bench.py`` config 7 but for
  ``pallas_bvh_chunk`` (TPU scheduling), and both the port's
  ``check_slice`` and the reference's ``check_cfg`` take it.
- ``accel.TREE_BUILDS`` and ``accel.BUILD_NS`` count the scene's tree and
  one walk tree per scene and knob set; the
  ``scene.geometry`` and ``scene.bvh`` spans record only under a profiler.
- The ``tree_build_s`` reader returns None without the counter.
"""

import json
import pathlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

import tpurt_torch as tt
from bench_torch import check, loop
from bench_torch.metrics import tree_build_s
from bench_torch.reference import integrate as ref
from bench_torch.reference import scene as ref_scene
from tpurt_torch import accel, tracing
from tpurt_torch.config import check_slice
from tpurt_torch.kernels import bvh, mega_regen
from tpurt_torch.scene import freeze_scene

CPU = "cpu"
torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "bench_torch" / "configs"
CONFIG7 = json.loads((CONFIGS / "torus_mesh_64k.json").read_text())
SMALL = dict(width=64, height=32, depth=4)


def _camera(config, cfg):
    c = config["camera"]
    return tt.make_camera(tuple(c["look_from"]), tuple(c["look_at"]),
                          vfov=c["vfov"],
                          aspect_ratio=cfg.width / cfg.height)


@pytest.fixture
def empty():
    tracing.clear()
    yield
    tracing.clear()


@pytest.mark.parametrize("seed", [5, 3000000019])
def test_config7_render_matches_the_plain_reference(seed):
    render = dict(CONFIG7["render"], **SMALL)
    cfg = tt.RenderConfig(**render)
    scene = tt.torus_mesh_scene(24, 24, device=CPU)
    tree = bvh.geometry(freeze_scene(scene), cfg).tri_tree
    assert (tree.prims, tree.width) == (1152, 8)
    assert tree.inner > 1       # the root's children are not all leaves
    st = tt.render(scene, cfg, _camera(CONFIG7, cfg),
                   tt.init_state(cfg, device=CPU), seed, 2)

    rcfg = ref.check_cfg(render)
    fs = ref_scene.freeze(ref_scene.BUILDERS["torus_mesh_scene"](24, 24),
                          CPU)
    pixels = torch.arange(cfg.width * cfg.height)
    want = ref.render_lanes(fs, rcfg,
                            check.camera_rows(dict(CONFIG7, render=render),
                                              rcfg), pixels, seed, 2)
    rows = torch.cat([want["rgb_sum"], want["n_samples"][:, None],
                      want["vis"]], 1)
    got = loop.state_rows(st, pixels)
    scale = rows.abs().amax(dim=0).clamp_min(1e-30)
    gap = float(((got - rows).abs().amax(dim=0) / scale).max())
    assert gap <= 1e-4
    assert int(st.rays) == int(want["rays"].sum()) > 0


def test_config7_is_bench_config_7():
    """Every RenderConfig field and the camera as tpurt's bench.py sets
    them for config 7, but for pallas_bvh_chunk, which schedules the TPU's
    SMEM slabs and which the port does not have."""
    import bench
    from tpurt import RenderConfig
    want_cfg, want_scene, want_cam = bench.build_bench(7, small=False)
    mine = RenderConfig(**CONFIG7["render"])
    for f in type(want_cfg).__dataclass_fields__:
        if f != "pallas_bvh_chunk":
            assert getattr(mine, f) == getattr(want_cfg, f), f
    assert CONFIG7["scene"] == {"builder": "torus_mesh_scene",
                                "args": {"nu": 180, "nv": 180}}
    assert int(want_scene.tri_a.shape[0]) == 64800
    cam = _camera(CONFIG7, tt.RenderConfig(**CONFIG7["render"]))
    np.testing.assert_array_equal(
        cam.rows(), np.stack([np.asarray(getattr(want_cam, k), np.float32)
                              for k in ("origin", "horizontal", "vertical",
                                        "lower_left")]))


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        CONFIGS.glob("*.json")))
def test_configurations_pass_both_checks(name):
    """The port's check_slice and the reference's check_cfg take every
    configuration's render keys as the cells run them."""
    render = json.loads((CONFIGS / f"{name}.json").read_text())["render"]
    check_slice(tt.RenderConfig(**render))
    ref.check_cfg(render)


@pytest.mark.parametrize("leaf,width", [(16, 8), (4, 0), (64, 0), (4, 3)])
def test_tree_stats_count_the_collapsed_tree(leaf, width):
    scene = tt.torus_mesh_scene(24, 24, device=CPU)
    cfg = tt.RenderConfig(width=16, height=8, backend="pallas",
                          pallas_bvh=True, pallas_bvh_leaf=leaf,
                          pallas_bvh_width=width)
    fs = freeze_scene(scene)
    geo = bvh.geometry(fs, cfg)
    t = fs.triangles
    binary = bvh.tri_bvh(t.a.numpy(), t.e1.numpy(), t.e2.numpy(), leaf)
    tree = accel.collapse_wide(binary, width) if width >= 3 else binary
    leaves = int((tree.count > 0).sum())
    kids = (tree.children != 0).sum(1).max() if width >= 3 else 2
    assert geo.tri_tree == bvh.TreeStats(
        prims=1152, inner=tree.count.shape[0] - leaves, leaves=leaves,
        width=int(kids), stack=geo.stack,
        table_bytes=4 * (geo.tri.numel() + geo.tri_nodes.numel()))


def test_one_build_per_scene_and_knob_set():
    cfg = tt.RenderConfig(**dict(CONFIG7["render"], width=16, height=8,
                                 depth=2))
    trees = accel.TREE_BUILDS
    scene = tt.torus_mesh_scene(24, 24, device=CPU)
    assert accel.TREE_BUILDS - trees == 1
    cam = _camera(CONFIG7, cfg)
    st = tt.init_state(cfg, device=CPU)
    st = tt.render(scene, cfg, cam, st, 1, 1)
    tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 2, 1)
    # on the CPU the plain integrator sweeps every triangle: no tables
    assert accel.TREE_BUILDS - trees == 1
    # what each launch on the card prepares (mega_regen.build_plan)
    fs = freeze_scene(scene)
    other = tt.make_camera((0.5, 3.0, -6.0), (0.0, 1.5, 0.0), vfov=55.0,
                           aspect_ratio=2.0)
    for c in (cam, other, cam):
        mega_regen.scene_table(fs, cfg, c, CPU)
    assert accel.TREE_BUILDS - trees == 2
    assert freeze_scene(scene) is fs
    leaf8 = tt.RenderConfig(**dict(CONFIG7["render"], width=16, height=8,
                                   depth=2, pallas_bvh_leaf=8))
    mega_regen.scene_table(fs, leaf8, cam, CPU)
    mega_regen.scene_table(fs, leaf8, other, CPU)
    assert accel.TREE_BUILDS - trees == 3


@pytest.mark.gpu
def test_one_build_across_render_calls_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_wide_mesh.py -m gpu "
                    "--noconftest")
    cfg = tt.RenderConfig(**dict(CONFIG7["render"], width=64, height=32,
                                 depth=4))
    scene = tt.torus_mesh_scene(24, 24, device="cuda")
    cam = _camera(CONFIG7, cfg)
    trees = accel.TREE_BUILDS
    st = tt.render(scene, cfg, cam, tt.init_state(cfg, device="cuda"), 1, 2)
    st = tt.render(scene, cfg, cam, st, 2, 2)
    tt.render(scene, cfg, cam, tt.init_state(cfg, device="cuda"), 3, 2)
    torch.cuda.synchronize()
    assert accel.TREE_BUILDS - trees == 1


def test_build_spans_record_under_a_profiler_only(empty):
    cfg = tt.RenderConfig(**dict(CONFIG7["render"], width=16, height=8,
                                 depth=2))
    fs = freeze_scene(tt.torus_mesh_scene(24, 24, device=CPU))
    bvh.geometry(fs, cfg)
    assert tracing.spans() == []

    fs = freeze_scene(tt.torus_mesh_scene(24, 24, device=CPU))
    ns, t0 = accel.BUILD_NS, time.perf_counter_ns()
    with profile():
        geo = bvh.geometry(fs, cfg)
        bvh.geometry(fs, cfg)           # cached: no span, no time
    wall = time.perf_counter_ns() - t0
    spans = tracing.spans()
    assert [s.name for s in spans] == ["scene.geometry", "scene.bvh"]
    outer, inner = spans
    assert inner.parent == outer.id and inner.call == outer.id
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    # the nested tree build's time is counted once, in the outer build
    assert 0 < accel.BUILD_NS - ns <= wall
    assert geo.tri_tree.width == 8


def test_tree_build_s_reads_the_counter(monkeypatch):
    monkeypatch.setattr(accel, "BUILD_NS", 2_500_000_000)
    assert tree_build_s.read({}) == pytest.approx(2.5)
    monkeypatch.delattr(accel, "BUILD_NS")
    assert tree_build_s.read({}) is None
