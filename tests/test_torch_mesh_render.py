"""Mesh and many-sphere renders of tpurt_torch against tpurt's XLA backend
at tpurt's own pinned settings (tests/test_bvh_pallas.py:184-201, 342-360,
476-503): exact ray counts and the image rule of tests/test_golden.py
(median |diff| < 1e-4, fewer than 1% of pixels off by more than 1e-2).
On the CPU the kernel backends run their plain versions; on a CUDA device
(marker ``gpu``) the regen kernel is held to its plain version.

tpurt is imported inside the fixture ``tp`` so the GPU case also runs
where JAX is not installed:
``python -m pytest tests/test_torch_mesh_render.py -m gpu --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import mega_regen
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"


torch.set_num_threads(1)

TORUS_CAM = ((0.0, 3.0, -6.0), (0.0, 1.5, 0.0))
FIELD_CAM = ((0.0, 10.0, -14.0), (0.0, 1.0, 8.0))


@pytest.fixture(scope="module")
def tp():
    import tpurt
    return types.SimpleNamespace(tpurt=tpurt)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_mesh_render.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _render_both(tp, scene, kw, port_kw, cam, seed, spp):
    """tpurt's XLA backend and the port with ``port_kw``, from the same
    settings. Returns (tpurt rays, port state, port config, tpurt image,
    port image)."""
    aspect = kw["width"] / kw["height"]
    cfg_j = tp.tpurt.RenderConfig(backend="xla", **kw)
    st_j = tp.tpurt.render(getattr(tp.tpurt.scene, scene[0])(*scene[1]),
                           cfg_j, tp.tpurt.make_camera(*cam, vfov=55.0,
                                                       aspect_ratio=aspect),
                           tp.tpurt.init_state(cfg_j), seed, spp)
    cfg = tt.RenderConfig(**kw, **port_kw)
    st = tt.render(getattr(tt, scene[0])(*scene[1], device=CPU), cfg,
                   tt.make_camera(*cam, vfov=55.0, aspect_ratio=aspect),
                   tt.init_state(cfg, device=CPU), seed, spp)
    return (int(float(st_j.rays)), st, cfg,
            np.asarray(tp.tpurt.resolve_image(cfg_j, st_j)),
            tt.resolve_image(cfg, st).numpy())


def _image_rule(got, want):
    diff = np.abs(got - want)
    frac = (diff.max(axis=-1) > 1e-2).mean()
    print(f"median |diff| {np.median(diff):.3g}, {frac:.2%} pixels > 1e-2")
    assert np.median(diff) < 1e-4
    assert frac < 0.01


def test_torus_bvh_render_matches_tpurt(tp):
    """torus_mesh_scene(8, 4) through the triangle walk's settings
    (pallas_static_unroll=8, pallas_bvh_leaf=8), 128x64, depth 5, seed 77,
    2 spp: tpurt counts 117899 segments."""
    kw = dict(width=128, height=64, depth=5)
    rays_j, st, cfg, img_j, img = _render_both(
        tp, ("torus_mesh_scene", (8, 4)), kw,
        dict(backend="pallas", pallas_static_unroll=8, pallas_bvh=True,
             pallas_bvh_leaf=8), TORUS_CAM, 77, 2)
    assert int(st.rays) == rays_j == 117899
    _image_rule(img, img_j)
    assert mega_regen.LAUNCHES == 0


def test_mesh_backends_agree_on_cpu():
    """backend="xla" and "pallas" run the same plain code on the CPU: the
    same state bit for bit on a mesh scene, whatever the walk knobs."""
    cam = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=2.0)
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    out = []
    for kw in (dict(backend="xla"),
               dict(backend="pallas", pallas_bvh_width=8,
                    pallas_static_unroll=8, pallas_bvh_sah=True)):
        cfg = tt.RenderConfig(width=24, height=12, depth=4, k_photons=2,
                              max_photon_bounces=3, **kw)
        out.append(tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 5, 2))
    assert int(out[0].rays) == int(out[1].rays) > 0
    n = 24 * 12     # the two backends pad the state to other sizes
    assert torch.equal(out[0].rgb_sum[:n], out[1].rgb_sum[:n])
    assert torch.equal(out[0].vis_pos[:n], out[1].vis_pos[:n])


def test_wavefront_backends_on_mesh_match_tpurt(tp):
    """The three wavefront backends on torus_mesh_scene(8, 4), 48x24,
    depth 4, seed 42, 3 spp, photons off: tpurt's XLA backend's segments
    on each."""
    kw = dict(width=48, height=24, depth=4, enable_photons=False)
    rays_j, st, _, img_j, img = _render_both(
        tp, ("torus_mesh_scene", (8, 4)), kw, dict(backend="wavefront"),
        TORUS_CAM, 42, 3)
    assert int(st.rays) == rays_j > 0
    _image_rule(img, img_j)
    cam = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=2.0)
    for backend in ("wavefront_pallas", "wavefront_fused"):
        cfg = tt.RenderConfig(backend=backend, wf_pool=512, **kw)
        sk = tt.render(tt.torus_mesh_scene(8, 4, device=CPU), cfg, cam,
                       tt.init_state(cfg, device=CPU), 42, 3)
        assert int(sk.rays) == rays_j, backend
        assert torch.equal(sk.n_samples[:cfg.n_pixels], st.n_samples[
            :cfg.n_pixels])


@pytest.mark.slow
def test_matches_tpurt_regen_kernel_bvh_interpret(tp):
    """tpurt's regen kernel in Pallas interpret mode through its triangle
    walk (pallas_bvh=True, static_unroll 8) on torus_mesh_scene(8, 4),
    32x16, 1 spp: the same segments."""
    from tpurt.kernels.mega_regen import render_regen
    kw = dict(width=32, height=16, depth=4, backend="pallas",
              pallas_lanes=512, pallas_bvh=True, pallas_static_unroll=8,
              pallas_bvh_leaf=8)
    cfg_j = tp.tpurt.RenderConfig(**kw)
    st_j = render_regen(tp.tpurt.scene.torus_mesh_scene(8, 4), cfg_j,
                        tp.tpurt.make_camera(*TORUS_CAM, vfov=55.0,
                                             aspect_ratio=2.0),
                        tp.tpurt.init_state(cfg_j), 1234, 1)
    cfg = tt.RenderConfig(**kw)
    st = tt.render(tt.torus_mesh_scene(8, 4, device=CPU), cfg,
                   tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=2.0),
                   tt.init_state(cfg, device=CPU), 1234, 1)
    assert int(st.rays) == int(float(st_j.rays)) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("leaf,width", [(64, 0), (4, 0), (16, 8)])
def test_mesh_regen_kernel_matches_plain(cuda, leaf, width):
    """The regen kernel through the triangle walk against render_plain on
    the card: the same segments and every state plane bit for bit."""
    scene = tt.torus_mesh_scene(45, 45, device=cuda)
    cfg = tt.RenderConfig(width=64, height=32, depth=8, backend="pallas",
                          pallas_bvh_leaf=leaf, pallas_bvh_width=width)
    cam = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=2.0)
    planes = state_to_planes(tt.init_state(cfg, cuda))
    pk, pp = planes.clone(), planes.clone()
    before = mega_regen.LAUNCHES
    rk = int(mega_regen.regen_call(scene, cfg, cam, pk, 1234, 2, 0, 2.0, 8))
    assert mega_regen.LAUNCHES == before + 1
    rp = int(integrate.render_plain(freeze_scene(scene), cfg, cam, pp, 1234,
                                    2, 0, 2.0, 8))
    assert rk == rp > 0
    assert torch.equal(pk, pp)
