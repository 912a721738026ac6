"""tpurt_torch.utils.scene_io (JSON scenes), RenderConfig.parse_overrides
and the tools' scene setup against tpurt's.

The cases of tests/test_scene_io.py on the port, then the port against
tpurt: every Scene field of the three examples/*.json files and of a scene
with an OBJ mesh (MTL materials on and off) equal to tpurt's load, exactly
(the same NumPy build: triangles in BVH leaf order); the camera metadata
equal; save_scene_json writing tpurt's JSON text.
"""

import argparse
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch.tools import scenes
from tpurt_torch.utils.scene_io import load_scene_json, save_scene_json

CPU = "cpu"
torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*.json"))


@pytest.fixture(scope="module")
def tp():
    import tpurt
    from tpurt.utils import scene_io
    return types.SimpleNamespace(tpurt=tpurt, scene_io=scene_io)


def _fields(scene) -> dict:
    return {f.name: getattr(scene, f.name).cpu().numpy()
            for f in dataclasses.fields(tt.Scene)}


def _assert_scene_is_tpurts(got, want):
    for name, a in _fields(got).items():
        b = np.asarray(getattr(want, name))
        if name == "bvh_max_leaf":   # a scalar (tpurt) or a 1-vector
            a = a.reshape(b.shape)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


# ----- the cases of tests/test_scene_io.py -----

def test_roundtrip_render_identical(tmp_path):
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    p = tmp_path / "scene.json"
    save_scene_json(str(p), scene, camera={"eye": [0, 3, -6],
                                           "look_at": [0, 1.5, 0],
                                           "vfov": 55.0})
    loaded, cam_meta = load_scene_json(str(p), device=CPU)
    assert cam_meta["vfov"] == 55.0
    a, b = _fields(scene), _fields(loaded)
    for f in ("mat_color", "mat_rough", "mat_ior", "mat_type",
              "sph_center", "sph_radius", "sph_mat",
              "light_pos", "light_hw", "light_color", "light_intensity",
              "light_temp", "light_type", "light_normal"):
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-6, err_msg=f)
    assert loaded.num_triangles == scene.num_triangles
    cfg = tt.RenderConfig(width=32, height=16, depth=3, tile_size=512)
    cam = tt.make_camera((0, 3, -6), (0, 1.5, 0), vfov=55.0,
                         aspect_ratio=2.0)
    st0 = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 9, 2)
    st1 = tt.render(loaded, cfg, cam, tt.init_state(cfg, device=CPU), 9, 2)
    assert int(st0.rays) == int(st1.rays) != 0
    np.testing.assert_allclose(st0.rgb_sum.numpy(), st1.rgb_sum.numpy(),
                               rtol=0, atol=1e-5)


def _schema_doc():
    return {
        "materials": [
            {"type": "diffuse", "color": [0.8, 0.7, 0.6]},
            {"type": "dielectric", "ior": 1.5, "roughness": 0.02},
            {"type": "metal", "color": [1.0, 0.71, 0.29], "roughness": 0.1},
            {"type": "emissive", "color": [1.0, 0.5, 0.25], "intensity": 4},
        ],
        "spheres": [{"material": 0, "radius": 1000.0,
                     "center": [0, -1000, 0]},
                    {"material": 1, "radius": 1.0, "center": [0, 1, 0]}],
        "meshes": [{"material": 2,
                    "positions": [[-1, 0, 3], [1, 0, 3], [0, 2, 3]],
                    "indices": [[0, 1, 2]]}],
        "lights": [
            {"type": "point", "position": [0, 5, 0],
             "color": [1, 1, 1], "intensity": 10, "color_temp": 5500},
            {"type": "square", "position": [0, 8, 0],
             "normal": [0, -1, 0], "half_width": 2.0,
             "color": [1, 1, 1], "intensity": 5, "color_temp": 6500},
        ],
    }


def test_schema_fields(tmp_path):
    p = tmp_path / "s.json"
    p.write_text(json.dumps(_schema_doc()))
    scene, cam = load_scene_json(str(p), device=CPU)
    assert cam is None
    assert scene.num_spheres == 2 and scene.num_triangles == 1
    assert scene.num_lights == 2
    assert int(scene.mat_type[2]) == 2 and int(scene.mat_type[3]) == 3


def test_bad_material_index_rejected(tmp_path):
    doc = {"materials": [{"type": "diffuse", "color": [1, 1, 1]}],
           "meshes": [{"material": 7,
                       "positions": [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                       "indices": [[0, 1, 2]]}]}
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="material 7 out of range"):
        load_scene_json(str(p), device=CPU)


class TestConfigOverrides:
    def test_parses_and_validates(self):
        kw = tt.RenderConfig.parse_overrides(
            ["qmc=True", "photon_strata=16", "backend=wavefront",
             "sky_color=(1.0, 0.5, 0.25)"])
        assert kw == {"qmc": True, "photon_strata": 16,
                      "backend": "wavefront", "sky_color": (1.0, 0.5, 0.25)}
        cfg = tt.RenderConfig(**kw)
        assert cfg.qmc and cfg.photon_strata == 16
        assert tt.RenderConfig.parse_overrides(None) == {}

    def test_unknown_field_fails_fast(self):
        with pytest.raises(SystemExit, match="not a RenderConfig field"):
            tt.RenderConfig.parse_overrides(["qcm=True"])

    def test_tools_build_applies_set(self):
        ns = argparse.Namespace(
            scene="cornell", scene_file=None, width=64, height=32,
            depth=2, backend="xla", hero=1, dispersion=False,
            aperture=None, focus=None, clamp=0.0, shutter=0.0,
            set=["qmc=True", "tile_size=2048"])
        cfg, scene, cam, *_ = scenes.build(ns, CPU)
        assert cfg.qmc is True and cfg.tile_size == 2048
        assert scene.device.type == "cpu"


def test_torus_field_scene_builds_and_hits():
    """Downward rays on a ring over each torus of torus_field_scene(4, 8,
    6) hit a triangle above the ground; one far off hits the ground only
    (through trace_rays with use_bvh)."""
    import math
    scene = tt.torus_field_scene(4, 8, 6, device=CPU)
    assert scene.num_triangles == 4 * 2 * 8 * 6
    assert scene.num_spheres == 2 and scene.num_lights == 1
    origins, dirs = [], []
    for gx, gz in ((0, 0), (1, 0), (0, 1), (1, 1)):
        x = (gx - 0.5) * 7.0
        z = (gz - 0.5) * 7.0 + 10.0
        for a in range(16):
            th = 2 * math.pi * a / 16
            origins.append((x + 1.6 * math.cos(th), 20.0,
                            z + 1.6 * math.sin(th)))
            dirs.append((0.0, -1.0, 0.0))
    origins.append((40.0, 20.0, 40.0))
    dirs.append((0.0, -1.0, 0.0))
    hits = tt.trace_rays(scene, np.asarray(origins, np.float32),
                         np.asarray(dirs, np.float32),
                         cfg=tt.RenderConfig(use_bvh=True))
    t = hits.t.numpy()
    assert np.all(np.isfinite(t)), t
    assert np.all(t[:64].reshape(4, 16).min(axis=1) < 19.1)
    assert t[64] > 19.5
    s2 = tt.torus_field_scene(4, 8, 6, device=CPU)
    assert torch.equal(scene.tri_a, s2.tri_a)


# ----- the port against tpurt -----

@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_examples_load_as_tpurts(tp, path):
    assert len(EXAMPLES) == 3
    got, cam_t = load_scene_json(str(path), device=CPU)
    want, cam_j = tp.scene_io.load_scene_json(str(path))
    _assert_scene_is_tpurts(got, want)
    assert cam_t == cam_j


_OBJ = """mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
usemtl red
f 1 2 3 4
usemtl nope
f 1 2 5
"""
_MTL = """newmtl red
Kd 0.9 0.1 0.1
"""


@pytest.mark.parametrize("use_mtl", [False, True])
def test_obj_mesh_loads_as_tpurts(tp, tmp_path, use_mtl):
    """An OBJ path resolves relative to the JSON file; with use_mtl the MTL
    materials append to the document's."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "m.obj").write_text(_OBJ)
    (tmp_path / "sub" / "m.mtl").write_text(_MTL)
    doc = _schema_doc()
    doc["meshes"].append({"material": 0, "translation": [0.5, 0, 2],
                          "rotation_deg": 30.0, "scale": 2.0,
                          "obj": "sub/m.obj", "use_mtl": use_mtl})
    p = tmp_path / "s.json"
    p.write_text(json.dumps(doc))
    got, _ = load_scene_json(str(p), device=CPU)
    want, _ = tp.scene_io.load_scene_json(str(p))
    _assert_scene_is_tpurts(got, want)
    assert got.num_triangles == 4 and got.mat_type.shape[0] == 4 + use_mtl


def test_save_writes_tpurts_json(tp, tmp_path):
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    cam = {"eye": [0, 3, -6], "look_at": [0, 1.5, 0], "vfov": 55.0}
    save_scene_json(str(tmp_path / "t.json"), scene, camera=cam)
    tp.scene_io.save_scene_json(str(tmp_path / "j.json"),
                                tp.tpurt.torus_mesh_scene(8, 4), camera=cam)
    assert (tmp_path / "t.json").read_text() == (
        tmp_path / "j.json").read_text()


def test_load_defaults_to_the_card(monkeypatch):
    """Like build_scene: no CUDA device and no device= raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_scene_json(str(EXAMPLES[0]))
