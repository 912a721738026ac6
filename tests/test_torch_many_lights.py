"""tpurt_torch past the 16 lights its kernels once took: tpurt's
many-light scene (a Cornell room under a grid of small area lights),
ported as ``tpurt_torch.many_light_scene``, against tpurt's XLA integrator;
and, on a CUDA device, the regen, fused and sweep kernels against their
plain versions on it, with 20 lights (the scene rows staged in shared
memory) and 128 (past the staging budget: read from global memory).

tpurt is imported inside the fixture ``tp`` so the GPU cases (marker
``gpu``) also run where JAX is not installed:
``python3 -m pytest tests/test_torch_many_lights.py -m gpu --noconftest``.

Tolerances: the scene arrays exact; ray counts exact (every backend draws
the same per-(pixel, sample, phase) PCG streams, two numbers per light at
every camera hit); images the golden rule of tests/test_golden.py: median
|diff| < 1e-4 and fewer than 1% of pixels off by more than 1e-2; a kernel
against its plain version on the card: rays and sample counts exact, every
state plane of the regen kernel bit for bit.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch.render import state_to_planes

CPU = "cpu"
N_LIGHTS = 20
W, H = 48, 24
CAM = dict(look_from=(0.0, 5.0, -12.0), look_at=(0.0, 5.0, 0.0), vfov=60.0,
           aspect_ratio=W / H)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tp():
    import tpurt
    import tpurt.render
    return types.SimpleNamespace(tpurt=tpurt,
                                 render=sys.modules["tpurt.render"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_many_lights.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _image_rule(a, b):
    diff = np.abs(a - b)
    med, frac = float(np.median(diff)), float((diff.max(-1) > 1e-2).mean())
    print(f"median |diff| {med:.3g}, {frac:.2%} pixels > 1e-2")
    assert med < 1e-4
    assert frac < 0.01


def _cfg(pkg, backend, photons):
    kw = dict(width=W, height=H, depth=4, tile_size=2048, pallas_lanes=512,
              wf_pool=1024, backend=backend)
    kw.update(dict(k_photons=2, max_photon_bounces=3) if photons
              else dict(enable_photons=False))
    return pkg.RenderConfig(**kw)


def test_scene_has_more_lights_than_the_old_cap(tp):
    """The port's many_light_scene(20) is tpurt's, array for array."""
    scene = tt.many_light_scene(N_LIGHTS, device=CPU)
    assert scene.num_lights == N_LIGHTS > 16
    want = tp.tpurt.many_light_scene(N_LIGHTS)
    for f in dataclasses.fields(tt.Scene):
        np.testing.assert_array_equal(np.asarray(getattr(scene, f.name)),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("backend,photons", [
    ("xla", True), ("pallas", True), ("wavefront", False),
    ("wavefront_pallas", False), ("wavefront_fused", False)])
def test_many_lights_match_tpurt_xla(tp, backend, photons):
    """Each backend of the port (on the CPU, the kernels' plain versions)
    against tpurt's XLA integrator on the 20-light scene, 2 spp: rays
    exact, the golden image rule; photons on for the SPPM backends, off
    for the wavefront ones (which trace none, in tpurt as here)."""
    cfg_j = _cfg(tp.tpurt, "xla", photons)
    st_j = tp.render.render(tp.tpurt.many_light_scene(N_LIGHTS), cfg_j,
                            tp.tpurt.make_camera(**CAM),
                            tp.render.init_state(cfg_j), 5, 2)
    cfg = _cfg(tt, backend, photons)
    st = tt.render(tt.many_light_scene(N_LIGHTS, device=CPU), cfg,
                   tt.make_camera(**CAM), tt.init_state(cfg, device=CPU), 5, 2)
    want, got = int(float(st_j.rays)), int(st.rays)
    print(f"rays {got} vs tpurt {want}")
    assert got == want > 0
    n = W * H
    assert np.array_equal(st.n_samples.numpy()[:n],
                          np.asarray(st_j.n_samples)[:n])
    _image_rule(st.rgb_sum.numpy()[:n], np.asarray(st_j.rgb_sum)[:n])


@pytest.mark.gpu
@pytest.mark.parametrize("n_lights,size", [(N_LIGHTS, (256, 144)),
                                           (128, (128, 72))])
def test_many_lights_kernels_match_plain(cuda, n_lights, size):
    """On the card, depth 8: the regen kernel against render_plain (every
    plane bit for bit), the fused kernel and the pool with the sweep kernel
    against the plain pool (rays and sample counts exact, the image rule).
    128 lights put the scene rows past the shared-memory budget."""
    from tpurt_torch import integrate
    from tpurt_torch.kernels import mega_regen
    from tpurt_torch.scene import freeze_scene
    # 40 floats a light row: 128 lights pass path.cuh STAGE_MAX_FLOATS
    # (4096), 20 with the other rows stay under it
    scene = tt.many_light_scene(n_lights, device=cuda)
    w, h = size
    cfg = tt.RenderConfig(width=w, height=h, depth=8, k_photons=2,
                          max_photon_bounces=3, wf_pool=16384)
    cam = tt.make_camera(**{**CAM, "aspect_ratio": w / h})
    planes = state_to_planes(tt.init_state(cfg, cuda))
    pk, pp = planes.clone(), planes.clone()
    rk = mega_regen.regen_call(scene, cfg, cam, pk, 5, 2, 0, 2.0, 8)
    rp = integrate.render_plain(freeze_scene(scene), cfg, cam, pp, 5, 2, 0,
                                2.0, 8)
    assert int(rk) == int(rp) > 0 and torch.equal(pk, pp)
    c = cfg.with_(enable_photons=False, backend="wavefront")
    plain = tt.render(scene, c, cam, tt.init_state(c, cuda), 5, 2)
    n = c.n_pixels
    for backend in ("wavefront_pallas", "wavefront_fused"):
        kc = c.with_(backend=backend)
        st = tt.render(scene, kc, cam, tt.init_state(kc, cuda), 5, 2)
        assert int(st.rays) == int(plain.rays) > 0, backend
        assert torch.equal(st.n_samples[:n], plain.n_samples[:n]), backend
        _image_rule(st.rgb_sum[:n].cpu().numpy(),
                    plain.rgb_sum[:n].cpu().numpy())
