"""tpurt_torch's config, scenes, camera and padding against tpurt's.

Everything here is host data, compared exactly (tolerance 0).
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import tpurt
from tpurt.render import padded_pixels as tpurt_padded
import tpurt_torch as tt
from tpurt_torch.config import check_slice
from tpurt_torch.interop import camera_from_numpy, scene_from_numpy
from tpurt_torch.render import padded_pixels


def test_render_config_fields_and_defaults():
    want = [(f.name, f.default) for f in dataclasses.fields(tpurt.RenderConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tt.RenderConfig)]
    assert got == want
    assert repr(dataclasses.asdict(tt.RenderConfig())) == repr(
        dataclasses.asdict(tpurt.RenderConfig()))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(backend="pallas"),
    dict(width=64, height=32, tile_size=2048),
    dict(width=64, height=32, tile_size=256),
    dict(width=64, height=32, backend="pallas"),
    dict(width=64, height=32, backend="pallas", pallas_lanes=512),
    dict(width=100, height=37, backend="pallas", pallas_block_tiles=False),
    dict(width=256, height=144, backend="pallas", pallas_lanes=2048),
    dict(width=1920, height=1080, backend="wavefront_fused"),
    dict(width=333, height=77, tile_size=1000),
])
def test_padded_pixels(kw):
    assert padded_pixels(tt.RenderConfig(**kw)) == tpurt_padded(
        tpurt.RenderConfig(**kw))


def _scene_arrays(scene):
    return {f.name: np.asarray(getattr(scene, f.name))
            for f in dataclasses.fields(tt.Scene)}


@pytest.mark.parametrize("name", ["cornell_spheres_scene", "default_scene"])
def test_stock_scenes_equal(name):
    want = _scene_arrays(getattr(tpurt, name)())
    got = _scene_arrays(getattr(tt, name)())
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_scene_equal_with_metal_and_point_light():
    def build(pkg):
        mats = [pkg.Material.diffuse((0.5, 0.6, 0.7), 0.3),
                pkg.Material.metal((1.0, 0.71, 0.29), 0.2),
                pkg.Material.dielectric(1.33, 0.1)]
        sph = [pkg.Sphere(0, 100.0, (0.0, -100.0, 0.0)),
               pkg.Sphere(1, 1.0, (1.0, 1.0, 0.5)),
               pkg.Sphere(2, 0.7, (-1.0, 0.7, 0.0))]
        lights = [pkg.Light.point((0.0, 6.0, 0.0), (1.0, 0.9, 0.8), 40.0),
                  pkg.Light.square_area((2.0, 5.0, 1.0), (0.3, 1.0, 0.1),
                                        0.8, (1.0, 1.0, 1.0), 5.0, 4000.0)]
        return pkg.build_scene(mats, sph, [], lights)
    want = _scene_arrays(build(tpurt))
    got = _scene_arrays(build(tt))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    # and through the NumPy interchange
    via = _scene_arrays(scene_from_numpy(
        {k: np.asarray(v) for k, v in vars(build(tpurt)).items()}))
    for k in want:
        np.testing.assert_array_equal(np.asarray(via[k]), want[k], err_msg=k)


def test_meshes_load(tmp_path):
    """default_scene with an OBJ mesh, and tpurt's mesh scene through the
    NumPy interchange: every array equal to tpurt's (exact)."""
    obj = tmp_path / "model.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nv 0.5 2 0\n"
                   "f 1 2 3 4\nf -3 -2 -1\n")
    want = _scene_arrays(tpurt.default_scene(str(obj)))
    got = _scene_arrays(tt.default_scene(str(obj)))
    assert want["tri_a"].shape == (3, 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    j_tri = tpurt.scene.tri_test_scene()
    via = _scene_arrays(scene_from_numpy(
        {k: np.asarray(v) for k, v in vars(j_tri).items()}))
    for k, v in _scene_arrays(j_tri).items():
        np.testing.assert_array_equal(via[k], v, err_msg=k)


@pytest.mark.parametrize("args", [
    ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), (0.0, 1.0, 0.0), 60.0, 2.0),
    ((1.0, 2.0, 3.0), (-2.0, 0.5, 7.0), (0.0, 1.0, 0.0), 75.0, 16 / 9),
])
def test_make_camera_equal(args):
    want = tpurt.make_camera(*args)
    got = tt.make_camera(*args)
    for f in ("origin", "horizontal", "vertical", "lower_left"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    via = camera_from_numpy(*(np.asarray(getattr(want, f)) for f in
                              ("origin", "horizontal", "vertical",
                               "lower_left")))
    np.testing.assert_array_equal(via.rows(), got.rows())


@pytest.mark.parametrize("kw", [
    dict(hero_wavelengths=4), dict(photon_strata=16), dict(qmc=True),
    dict(aperture=0.3), dict(light_sample="power"), dict(use_bvh=True),
    dict(pallas_mxu_leaf=True),
    dict(backend="wavefront_fused", sky_intensity=1.0),
    dict(backend="pallas", pallas_regen=False),
    dict(count_iters=True), dict(photon_rr_scale=0.5),
])
def test_flags_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError):
        check_slice(tt.RenderConfig(**kw))


def test_slice_and_scheduling_flags_accepted():
    check_slice(tt.RenderConfig(
        width=64, height=32, depth=5, k_photons=3, max_photon_bounces=2,
        enable_photons=False, photon_radius_init=1.0, sppm_alpha=0.5,
        rr_threshold=0.01, photon_rr_threshold=0.1, count_rays=False,
        tonemap_key=0.5, tonemap_saturation=1.2, backend="pallas",
        tile_size=1024, pallas_lanes=1024, pallas_block_tiles=False,
        pallas_regen_drift=1, pallas_regen_drift_cam=2,
        pallas_cluster_size=0, pallas_tri_clip=False, wf_chunk_sort=True,
        wf_pool=4096, wf_max_sweeps=64))


def test_import_leaves_jax_out():
    code = ("import sys, tpurt_torch, tpurt_torch.interop, "
            "tpurt_torch.kernels.mega_regen, tpurt_torch.kernels.tonemap, "
            "tpurt_torch.kernels.wavefront_sweep, "
            "tpurt_torch.kernels.wavefront_fused, tpurt_torch.adaptive, "
            "tpurt_torch.accel, tpurt_torch.utils.obj, "
            "tpurt_torch.kernels.bvh; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'tpurt.')) or m == 'tpurt']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
