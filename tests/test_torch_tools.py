"""The port's tools: the animation twin (``python -m
tpurt_torch.tools.animate``), the AO-bake twin (``python -m
tpurt_torch.tools.bake_ao``) and their shared scene setup
(``tpurt_torch.tools.scenes``), against tpurt's tools/animate.py,
examples/bake_ao.py and viewer._build.

The cases of tests/test_animate.py on the twin (the camera paths, then an
end-to-end run at 32x16 and its resume), then: the twin's orbit and path
cameras equal tpurt's bit for bit; scenes.build gives viewer._build's
config and camera; the bake twin writes the PNG bytes of
examples/bake_ao.py --cpu --res 16 --rays 8 (exact: the same probes from
the same NumPy draws, hit points equal to tpurt's eager intersector, no
probe landing on a threshold at this size).
"""

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tpurt_torch.tools import animate, bake_ao, scenes

CPU = "cpu"
torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tp():
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(ROOT))
    import animate as j_animate
    import viewer
    return types.SimpleNamespace(animate=j_animate, viewer=viewer)


def _vecs(cam):
    return [np.asarray(getattr(cam, f)) for f in (
        "origin", "horizontal", "vertical", "lower_left")]


# ----- the cases of tests/test_animate.py -----

def test_orbit_full_revolution_returns_to_start():
    eye0, at = (0.0, 5.0, -12.0), (0.0, 5.0, 0.0)
    c0 = animate.orbit_camera(0, 8, eye0, at, 60.0, 16 / 9)
    c8 = animate.orbit_camera(8, 8, eye0, at, 60.0, 16 / 9)
    np.testing.assert_allclose(c0.origin.numpy(), c8.origin.numpy(),
                               atol=1e-5)
    c4 = animate.orbit_camera(4, 8, eye0, at, 60.0, 16 / 9)
    np.testing.assert_allclose(c4.origin.numpy(), [0.0, 5.0, 12.0],
                               atol=1e-5)
    for f in range(8):
        o = animate.orbit_camera(f, 8, eye0, at, 60.0,
                                 16 / 9).origin.numpy().astype(np.float64)
        assert abs(np.linalg.norm(o - np.asarray(at)) - 12.0) < 1e-4
        assert abs(o[1] - 5.0) < 1e-5


KEYS = [
    {"frame": 10, "eye": [0, 0, -10], "look_at": [0, 0, 0], "vfov": 60.0},
    {"frame": 20, "eye": [10, 0, -10], "look_at": [0, 2, 0], "vfov": 40.0},
]


def test_path_interpolation_and_clamping():
    mid = animate.path_camera(15, KEYS, 16 / 9)
    np.testing.assert_allclose(mid.origin.numpy(), [5, 0, -10], atol=1e-5)
    before = animate.path_camera(0, KEYS, 16 / 9)
    after = animate.path_camera(99, KEYS, 16 / 9)
    np.testing.assert_allclose(before.origin.numpy(), [0, 0, -10], atol=1e-6)
    np.testing.assert_allclose(after.origin.numpy(), [10, 0, -10],
                               atol=1e-6)
    hv = [float(np.linalg.norm(c.vertical.numpy()))
          for c in (before, mid, after)]
    assert hv[2] < hv[1] < hv[0]


def _twin(tmp_path, *extra):
    return [sys.executable, "-m", "tpurt_torch.tools.animate", "--scene",
            "cornell", "--orbit", "--frames", "2", "--spp", "1", "--width",
            "32", "--height", "16", "--depth", "2", "--backend", "xla",
            "--cpu", "--out-dir", str(tmp_path), *extra]


def test_end_to_end_render_and_resume(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(_twin(tmp_path), cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["frames_rendered"] == 2
    assert (tmp_path / "frame_0000.png").exists()
    assert (tmp_path / "frame_0001.png").exists()
    out2 = subprocess.run(_twin(tmp_path), cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=env)
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert json.loads(out2.stdout.strip().splitlines()[-1])[
        "frames_rendered"] == 0


# ----- against tpurt's tools -----

@pytest.mark.parametrize("frame", [0, 3, 10, 13, 20, 25])
def test_cameras_are_tpurts(tp, frame):
    got = animate.orbit_camera(frame, 24, (0, 5, -12), (0, 5, 0), 60.0, 2.0)
    want = tp.animate.orbit_camera(frame, 24, (0, 5, -12), (0, 5, 0), 60.0,
                                   2.0)
    for a, b in zip(_vecs(got), _vecs(want)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_vecs(animate.path_camera(frame, KEYS, 1.5)),
                    _vecs(tp.animate.path_camera(frame, KEYS, 1.5))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(scene="cornell"),
    dict(scene="mesh", backend="wavefront"),
    dict(scene="mesh", set=["backend=wavefront_fused", "qmc=True"]),
    dict(scene="dispersive", aperture=0.2, clamp=8.0, shutter=0.5),
    dict(scene="cornell", scene_file=str(ROOT / "examples" /
                                         "cornell_dof.json")),
    dict(scene="cornell", scene_file=str(ROOT / "examples" /
                                         "cornell_dof.json"),
         aperture=0.0, focus=4.0),
])
def test_build_is_viewers(tp, kw):
    args = dict(scene="cornell", scene_file=None, width=48, height=24,
                depth=3, backend="xla", hero=1, dispersion=False,
                aperture=None, focus=None, clamp=0.0, shutter=0.0, set=None)
    args.update(kw)
    cfg, _, cam, vfov, eye, at = scenes.build(argparse.Namespace(**args),
                                              CPU)
    jcfg, _, jcam, jvfov, jeye, jat = tp.viewer._build(
        argparse.Namespace(**args))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (vfov, tuple(eye), tuple(at)) == (jvfov, tuple(jeye), tuple(jat))
    for a, b in zip(_vecs(cam), _vecs(jcam)):
        np.testing.assert_array_equal(a, b)


def test_bake_ao_writes_tpurts_png(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, "examples/bake_ao.py", "--cpu", "--res", "16",
         "--rays", "8", "--out", str(tmp_path / "j.png")], cwd=ROOT,
        capture_output=True, text=True, timeout=300, env=env)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ao = bake_ao.main(["--cpu", "--res", "16", "--rays", "8", "--out",
                       str(tmp_path / "t.png")])
    assert ao.shape == (16, 16) and 0.2 < ao.mean() < 1.0
    assert (tmp_path / "t.png").read_bytes() == (
        tmp_path / "j.png").read_bytes()
    assert f"mean AO {ao.mean():.3f}" in ref.stdout


def test_animate_denoise_temporal_in_process(tmp_path):
    """--denoise --temporal: every stage timed, the history chained (the
    resume is off), the frames written."""
    argv = ["--scene", "cornell", "--orbit", "--frames", "2", "--spp", "1",
            "--width", "32", "--height", "16", "--depth", "2", "--cpu",
            "--denoise", "--temporal", "0.8", "--out-dir", str(tmp_path)]
    for _ in range(2):
        stats = animate.main(argv)
        assert stats["frames_rendered"] == 2
    ms = stats["frames"][1]["ms"]
    assert min(ms[k] for k in ("render", "aov", "denoise", "temporal",
                               "png")) > 0.0
    assert stats["frames"][1]["rays"] > 0
    assert (tmp_path / "frame_0001.png").exists()


def test_twins_need_the_card_without_cpu(monkeypatch, tmp_path):
    """No --cpu and no CUDA device: the twins raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        animate.main(["--frames", "1", "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bake_ao.main(["--res", "4", "--out", str(tmp_path / "a.png")])
