"""tpurt_torch.temporal (reprojection and the temporal blend) against
tpurt's.

The cases of tests/test_temporal.py on the port, then the port against
tpurt on the same history, cameras and depths (tpurt's AOV depths, carried
over by interop). Tolerances:
- ``valid``: exact, against tpurt jitted and run eagerly, on a translated
  camera and on two orbit cameras of tools/animate.py one frame apart; no
  pixel flips on these inputs.
- ``warped`` and the blend: exact against tpurt run eagerly
  (jax.disable_jit, the same float32 operations); against the jitted
  version atol 1e-4 on images in [0, 1] (XLA contracts the bilinear
  lerps and the projection's dot products into FMAs).
"""

import pathlib
import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import tonemap as tm
from tpurt_torch.interop import (aovs_from_numpy, camera_from_numpy,
                                 temporal_state_from_numpy)
from tpurt_torch.temporal import TemporalState, reproject, temporal_blend
from tpurt_torch.tools.animate import orbit_camera

CPU = "cpu"
torch.set_num_threads(1)
W, H = 96, 64


@pytest.fixture(scope="module")
def tp():
    import jax
    import jax.numpy as jnp

    import tpurt
    import tpurt.denoise
    import tpurt.temporal
    return types.SimpleNamespace(jax=jax, jnp=jnp, tpurt=tpurt,
                                 denoise=sys.modules["tpurt.denoise"],
                                 temporal=sys.modules["tpurt.temporal"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_temporal.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _setup(w=W, h=H):
    cfg = tt.RenderConfig(width=w, height=h, depth=3, backend="xla",
                          enable_photons=False)
    cam = tt.make_camera((0., 5., -12.), (0., 5., 0.), vfov=60.0,
                         aspect_ratio=w / h)
    return cfg, tt.cornell_spheres_scene(device=CPU), cam


def _linear(cfg, st):
    n = cfg.n_pixels
    return tm.resolve(st.rgb_sum[:n], st.n_samples[:n]).reshape(
        cfg.height, cfg.width, 3)


# ----- the cases of tests/test_temporal.py -----

class TestReproject:
    def test_static_camera_is_identity(self):
        cfg, scene, cam = _setup()
        aovs = tt.render_aovs(scene, cfg, cam)
        img = torch.from_numpy(np.random.default_rng(0).random(
            (H, W, 3), np.float32))
        prev = TemporalState(img=img, depth=aovs.depth, camera=cam)
        warped, valid = reproject(prev, cam, aovs.depth)
        hit = aovs.depth > 0
        assert float(valid[hit].float().mean()) > 0.99
        assert float((warped - img).abs()[valid].max()) < 1e-3

    def test_translated_camera_shifts_lookup(self):
        cfg, scene, cam = _setup()
        cam2 = tt.make_camera((0.4, 5., -12.), (0.4, 5., 0.), vfov=60.0,
                              aspect_ratio=W / H)
        aovs1 = tt.render_aovs(scene, cfg, cam)
        aovs2 = tt.render_aovs(scene, cfg, cam2)
        img = torch.from_numpy(np.random.default_rng(1).random(
            (H, W, 3), np.float32))
        prev = TemporalState(img=img, depth=aovs1.depth, camera=cam)
        warped, valid = reproject(prev, cam2, aovs2.depth)
        assert 0.5 < float(valid.float().mean()) < 1.0
        assert bool(torch.isfinite(warped).all())

    def test_miss_pixels_invalid(self):
        cfg, scene, cam = _setup()
        aovs = tt.render_aovs(scene, cfg, cam)
        prev = TemporalState(img=torch.zeros((H, W, 3)), depth=aovs.depth,
                             camera=cam)
        _, valid = reproject(prev, cam, torch.zeros((H, W)))
        assert not bool(valid.any())


class TestTemporalBlend:
    def test_first_frame_passthrough(self):
        cfg, scene, cam = _setup()
        aovs = tt.render_aovs(scene, cfg, cam)
        img = torch.full((H, W, 3), 0.3)
        out, ts = temporal_blend(None, cam, aovs, img, alpha=0.8)
        assert bool((out == img).all())
        assert ts.camera is cam

    def test_alpha_clamped_no_feedback_blowup(self):
        cfg, scene, cam = _setup()
        aovs = tt.render_aovs(scene, cfg, cam)
        ts = None
        img = torch.full((H, W, 3), 0.5)
        for _ in range(12):
            out, ts = temporal_blend(ts, cam, aovs, img, alpha=1.7)
        assert bool(torch.isfinite(out).all())
        assert 0.0 <= float(out.min()) and float(out.max()) <= 0.5 + 1e-5

    def test_static_accumulation_reduces_noise(self):
        cfg, scene, cam = _setup()
        aovs = tt.render_aovs(scene, cfg, cam)
        gt = _linear(cfg, tt.render(scene, cfg, cam,
                                    tt.init_state(cfg, device=CPU), 777, 96))
        ts = None
        for f in range(8):
            st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                           10 + f, 2)
            lin = _linear(cfg, st)
            out, ts = temporal_blend(ts, cam, aovs, lin, alpha=0.8)
        mse_single = float(((lin - gt) ** 2).mean())
        mse_temporal = float(((out - gt) ** 2).mean())
        assert mse_temporal < mse_single / 3.0


# ----- the port against tpurt -----

def _j_orbit(f):
    """tools/animate.py's orbit camera (tpurt's) at frame f of 24."""
    tools = str(pathlib.Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from animate import orbit_camera as j_orbit
    return j_orbit(f, 24, (0, 5, -12), (0, 5, 0), 60.0, W / H)


def _port_cam(jcam):
    return camera_from_numpy(*(np.asarray(getattr(jcam, f)) for f in (
        "origin", "horizontal", "vertical", "lower_left")))


def _camera_pairs(tp):
    mk = lambda x: tp.tpurt.make_camera(  # noqa: E731
        (x, 5., -12.), (x, 5., 0.), vfov=60.0, aspect_ratio=W / H)
    return {"translated": (mk(0.0), mk(0.4)),
            "orbit": (_j_orbit(0), _j_orbit(1))}


@pytest.mark.parametrize("pair", ["translated", "orbit"])
def test_reproject_matches_tpurt(tp, pair):
    cam1, cam2 = _camera_pairs(tp)[pair]
    js = tp.tpurt.cornell_spheres_scene()
    jcfg = tp.tpurt.RenderConfig(width=W, height=H)
    a1 = tp.denoise.render_aovs(js, jcfg, cam1)
    a2 = tp.denoise.render_aovs(js, jcfg, cam2)
    img = np.random.default_rng(2).random((H, W, 3), np.float32)
    jprev = tp.temporal.TemporalState(img=tp.jnp.asarray(img), depth=a1.depth,
                                      camera=cam1)
    w_jit, v_jit = tp.temporal.reproject(jprev, cam2, a2.depth)
    with tp.jax.disable_jit():
        w_eag, v_eag = tp.temporal.reproject(jprev, cam2, a2.depth)
    prev = temporal_state_from_numpy(img, a1.depth, _port_cam(cam1),
                                     device=CPU)
    warped, valid = reproject(prev, _port_cam(cam2),
                              torch.from_numpy(np.array(a2.depth)))
    assert 0.5 < float(valid.float().mean()) < 1.0
    np.testing.assert_array_equal(valid.numpy(), np.asarray(v_eag))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(v_jit))
    np.testing.assert_array_equal(warped.numpy(), np.asarray(w_eag))
    np.testing.assert_allclose(warped.numpy(), np.asarray(w_jit), rtol=0,
                               atol=1e-4)


def test_temporal_blend_matches_tpurt(tp):
    """Three frames along the orbit, alpha 0.8, against tpurt's chain."""
    js = tp.tpurt.cornell_spheres_scene()
    jcfg = tp.tpurt.RenderConfig(width=W, height=H)
    rs = np.random.default_rng(3)
    jts = ts = None
    for f in range(3):
        jcam = _j_orbit(f)
        ja = tp.denoise.render_aovs(js, jcfg, jcam)
        img = rs.random((H, W, 3), np.float32)
        with tp.jax.disable_jit():
            jout, jts = tp.temporal.temporal_blend(
                jts, jcam, ja, tp.jnp.asarray(img), alpha=0.8)
        aovs = aovs_from_numpy(ja.albedo, ja.normal, ja.depth, device=CPU)
        out, ts = temporal_blend(ts, _port_cam(jcam), aovs,
                                 torch.from_numpy(img), alpha=0.8)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert torch.equal(ts.img, out)


def test_orbit_camera_is_tpurts(tp):
    for f in (0, 1, 7):
        got = orbit_camera(f, 24, (0, 5, -12), (0, 5, 0), 60.0, W / H)
        want = _j_orbit(f)
        for name in ("origin", "horizontal", "vertical", "lower_left"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))


# ----- on the card -----

@pytest.mark.gpu
def test_temporal_on_the_card_matches_the_cpu(cuda):
    """reproject and temporal_blend between two orbit cameras on the card
    against the CPU: valid exact, the blend atol 1e-5 on images in
    [0, 1]."""
    cfg = tt.RenderConfig(width=64, height=32)
    cams = [orbit_camera(f, 24, (0, 5, -12), (0, 5, 0), 60.0, 2.0)
            for f in (0, 1)]
    img = torch.from_numpy(np.random.default_rng(4).random((32, 64, 3),
                                                           np.float32))
    out = {}
    for dev in (CPU, cuda):
        scene = tt.cornell_spheres_scene(device=dev)
        a0, a1 = (tt.render_aovs(scene, cfg, c) for c in cams)
        _, ts = temporal_blend(None, cams[0], a0, img.to(dev))
        warped, valid = reproject(ts, cams[1], a1.depth)
        blend, _ = temporal_blend(ts, cams[1], a1, img.flip(0).to(dev))
        out[str(dev)] = (warped.cpu(), valid.cpu(), blend.cpu())
    a, b = out[CPU], out[str(cuda)]
    assert torch.equal(a[1], b[1]) and float(a[1].float().mean()) > 0.5
    torch.testing.assert_close(b[0], a[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(b[2], a[2], rtol=0, atol=1e-5)
