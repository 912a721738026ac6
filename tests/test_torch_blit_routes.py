"""The blit's routes from a state and from planes
(``kernels.tonemap.resolve_state_pallas``, ``image_from_planes``) against
tpurt's Pallas blit in interpret mode and against ``resolve_image``.

The cases of tests/test_tonemap_pallas.py on the port, then tpurt's
routes on the same planes and counts. Tolerances: against the port's own
resolve_image, exact (the same plain operations on the CPU, the same
kernel on the card); against tpurt's interpret-mode kernel atol 1e-5 and
rtol 1e-4, as tpurt's own test holds it: single-wavelength sums go
negative and the tonemap's v / (1 + v) near v = -1 amplifies the last bit
of XLA's fused saturation lerp.

tpurt is imported inside the fixture ``tp``, so the GPU cases (marker
``gpu``) run where JAX is not installed.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import tonemap as tm
from tpurt_torch.interop import state_from_numpy
from tpurt_torch.kernels import tonemap as blit
from tpurt_torch.render import state_to_planes

CPU = "cpu"
torch.set_num_threads(1)
CAM = ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0))


@pytest.fixture(scope="module")
def tp():
    import jax.numpy as jnp

    import tpurt
    from tpurt.kernels import mega_pallas, tonemap_pallas
    return types.SimpleNamespace(jnp=jnp, tpurt=tpurt, mp=mega_pallas,
                                 pallas=tonemap_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_blit_routes.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _cam(w, h):
    return tt.make_camera(*CAM, vfov=60.0, aspect_ratio=w / h)


# ----- the cases of tests/test_tonemap_pallas.py -----

def test_matches_resolve_image():
    cfg = tt.RenderConfig(width=64, height=32, depth=3, backend="pallas",
                          pallas_lanes=512, k_photons=1, max_photon_bounces=2)
    st = tt.render(tt.cornell_spheres_scene(device=CPU), cfg, _cam(64, 32),
                   tt.init_state(cfg, device=CPU), 5, 4)
    ref = tt.resolve_image(cfg, st)
    planes = state_to_planes(st)
    out = blit.image_from_planes(cfg, planes, 4.0)
    assert torch.equal(out, ref)
    assert torch.equal(blit.image_from_planes(cfg, planes, st.n_samples), ref)
    # live knobs
    dark = blit.image_from_planes(cfg, planes, 4.0, key=0.05)
    assert float((dark - out).abs().max()) > 1e-3
    gray = blit.image_from_planes(cfg, planes, 4.0, saturation=0.0)
    assert float((gray[..., 0] - gray[..., 2]).abs().max()) < 1e-4
    assert blit.LAUNCHES == 0


def test_per_pixel_counts_half_drained_wavefront():
    """A wavefront state stopped mid-drain has per-pixel counts; the route
    divides each pixel by its own count, like resolve_image."""
    cfg = tt.RenderConfig(width=64, height=32, depth=4, tile_size=2048,
                          enable_photons=False, wf_pool=256,
                          backend="wavefront")
    st = tt.wavefront_render(tt.cornell_spheres_scene(device=CPU), cfg,
                             _cam(64, 32), tt.init_state(cfg, device=CPU),
                             11, 3)
    ns = st.n_samples.clone()
    ns[::3] = (ns[::3] - 1.0).clamp_min(0.0)
    st = dataclasses.replace(st, n_samples=ns)
    assert len(torch.unique(ns)) > 1
    assert torch.equal(blit.resolve_state_pallas(cfg, st),
                       tt.resolve_image(cfg, st))


# ----- against tpurt's routes -----

def _random_state(P: int, seed: int):
    rs = np.random.default_rng(seed)
    rgb = rs.normal(0.0, 3.0, (P, 3)).astype(np.float32)
    cnt = rs.integers(0, 9, P).astype(np.float32)
    return rgb, cnt


@pytest.mark.parametrize("key,sat", [(None, None), (0.05, 1.3), (2.0, 0.0)])
def test_image_from_planes_matches_tpurt(tp, key, sat):
    """Scalar and per-pixel counts, tpurt's planes (16, TR, 128) against
    the port's (16, P): pallas_block_tiles off, so both are in linear
    order."""
    kw = dict(width=64, height=24, backend="pallas", pallas_lanes=512,
              pallas_block_tiles=False)
    cfg, jcfg = tt.RenderConfig(**kw), tp.tpurt.RenderConfig(**kw)
    P = tt.init_state(cfg, device=CPU).rgb_sum.shape[0]
    rgb, cnt = _random_state(P, 1)
    jst = dataclasses.replace(tp.tpurt.init_state(jcfg),
                              rgb_sum=tp.jnp.asarray(rgb),
                              n_samples=tp.jnp.asarray(cnt))
    jplanes = tp.mp.state_to_planes(jst, jcfg)
    st = state_from_numpy({f.name: np.asarray(getattr(jst, f.name))
                           for f in dataclasses.fields(jst)}, device=CPU)
    planes = state_to_planes(st)
    for ns_t, ns_j in ((3.0, 3.0), (st.n_samples, tp.jnp.asarray(cnt))):
        want = np.asarray(tp.pallas.image_from_planes(
            jcfg, jplanes, ns_j, key=key, saturation=sat, interpret=True))
        got = blit.image_from_planes(cfg, planes, ns_t, key=key,
                                     saturation=sat)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_resolve_state_pallas_matches_tpurt(tp):
    kw = dict(width=48, height=24, depth=4, enable_photons=False,
              backend="wavefront", wf_pool=256)
    cfg, jcfg = tt.RenderConfig(**kw), tp.tpurt.RenderConfig(**kw)
    P = tt.init_state(cfg, device=CPU).rgb_sum.shape[0]
    rgb, cnt = _random_state(P, 2)
    jst = dataclasses.replace(tp.tpurt.init_state(jcfg),
                              rgb_sum=tp.jnp.asarray(rgb),
                              n_samples=tp.jnp.asarray(cnt))
    want = np.asarray(tp.pallas.resolve_state_pallas(jcfg, jst, key=0.5,
                                                     interpret=True))
    st = state_from_numpy({f.name: np.asarray(getattr(jst, f.name))
                           for f in dataclasses.fields(jst)}, device=CPU)
    got = blit.resolve_state_pallas(cfg, st, key=0.5)
    assert got.shape == (24, 48, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_image_from_planes_rejects_bad_planes():
    cfg = tt.RenderConfig(width=8, height=4)
    with pytest.raises(ValueError, match="planes"):
        blit.image_from_planes(cfg, torch.zeros((2, 32)), 1.0)


# ----- on the card -----

@pytest.mark.gpu
def test_routes_launch_the_kernel(cuda):
    """On CUDA tensors each route launches the blit once and equals the
    plain version bit for bit."""
    cfg = tt.RenderConfig(width=64, height=32, backend="pallas")
    P = tt.init_state(cfg, device=CPU).rgb_sum.shape[0]
    rgb, cnt = _random_state(P, 3)
    st = dataclasses.replace(tt.init_state(cfg, device=cuda),
                             rgb_sum=torch.from_numpy(rgb).to(cuda),
                             n_samples=torch.from_numpy(cnt).to(cuda))
    n = cfg.n_pixels
    plain = tm.tonemap(tm.resolve(st.rgb_sum[:n], st.n_samples[:n]), 0.8,
                       1.0).reshape(32, 64, 3)
    planes = state_to_planes(st)
    before = blit.LAUNCHES
    assert torch.equal(blit.resolve_state_pallas(cfg, st), plain)
    assert torch.equal(blit.image_from_planes(cfg, planes, st.n_samples),
                       plain)
    uni = blit.image_from_planes(cfg, planes, 2.0, key=0.3, saturation=0.5)
    assert blit.LAUNCHES == before + 3
    assert torch.equal(uni, tm.tonemap(tm.resolve(
        st.rgb_sum[:n], torch.full((n,), 2.0, device=cuda)), 0.3,
        0.5).reshape(32, 64, 3))
