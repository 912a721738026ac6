"""tpurt_torch.denoise (the AOV pass and the à-trous filter) against
tpurt's.

The cases of tests/test_denoise.py on the port, then the port against
tpurt on the same inputs. Tolerances:
- AOVs: albedo and depth exact and normals within 2 ulps of 1 (atol
  2.4e-7; the port normalizes by a reciprocal) against tpurt run eagerly
  (jax.disable_jit); against tpurt's jitted pass at most 0.2% of pixels
  take another primitive (corner pixels where two radius-1000 walls meet
  and XLA's FMA moves t).
- The filter and denoise_image: rtol 1e-4 with atol 1e-5 of the image's
  largest value, against tpurt's jitted filter on the same inputs (XLA
  contracts the taps' multiply-adds into FMAs; exp differs in the last
  bits); denoise_image rtol 1e-3 (negative radiance, below). Against tpurt
  run eagerly on small inputs the filter is within 1e-6 relative.
  defocus_relax exact.
- The median of the sigma estimate: exact, jnp.median's midpoint at an
  even count.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import denoise as dn
from tpurt_torch.interop import (aovs_from_numpy, camera_from_numpy,
                                 state_from_numpy)

CPU = "cpu"
torch.set_num_threads(1)
CAM = ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0))


@pytest.fixture(scope="module")
def tp():
    import jax
    import jax.numpy as jnp

    import tpurt
    import tpurt.denoise
    import tpurt.render
    return types.SimpleNamespace(jax=jax, jnp=jnp, tpurt=tpurt,
                                 denoise=sys.modules["tpurt.denoise"],
                                 render=sys.modules["tpurt.render"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_denoise.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _setup(w=96, h=64, **kw):
    cfg = tt.RenderConfig(width=w, height=h, depth=4, backend="xla",
                          enable_photons=False, **kw)
    cam = tt.make_camera(*CAM, vfov=60.0, aspect_ratio=w / h)
    return cfg, tt.cornell_spheres_scene(device=CPU), cam


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _flat_features(h, w):
    albedo = torch.full((h, w, 3), 0.8)
    normal = torch.zeros((h, w, 3))
    normal[..., 1] = 1.0
    return albedo, normal, torch.full((h, w), 5.0)


# ----- the cases of tests/test_denoise.py -----

class TestAOVs:
    def test_shapes_and_ranges(self):
        cfg, scene, cam = _setup()
        aov = tt.render_aovs(scene, cfg, cam)
        assert aov.albedo.shape == (64, 96, 3)
        assert aov.normal.shape == (64, 96, 3)
        assert aov.depth.shape == (64, 96)
        a = aov.albedo.numpy()
        assert np.isfinite(a).all() and (a >= 0).all() and (a <= 1).all()
        d = aov.depth.numpy()
        assert np.isfinite(d).all() and (d >= 0).all()
        assert (d > 0).mean() > 0.95   # the box fills the frame

    def test_normals_unit_where_hit(self):
        cfg, scene, cam = _setup()
        aov = tt.render_aovs(scene, cfg, cam)
        d = aov.depth.numpy()
        ln = np.linalg.norm(aov.normal.numpy(), axis=-1)
        assert np.abs(ln[d > 0] - 1.0).max() < 1e-3
        assert (ln[d == 0] == 0).all()

    def test_deterministic(self):
        cfg, scene, cam = _setup()
        a1 = tt.render_aovs(scene, cfg, cam)
        a2 = tt.render_aovs(scene, cfg, cam)
        assert torch.equal(a1.albedo, a2.albedo)
        assert torch.equal(a1.depth, a2.depth)


class TestAtrous:
    def test_noise_reduction_preserves_mean(self):
        h = w = 64
        rng = np.random.default_rng(0)
        noisy = _t(0.5 + rng.normal(0, 0.25, (h, w, 3)))
        out = tt.atrous_denoise(noisy, *_flat_features(h, w),
                                sigma_color=2.0).numpy()
        inner = out[8:-8, 8:-8]
        assert inner.std() < float(noisy[8:-8, 8:-8].std()) / 5.0
        assert abs(inner.mean() - 0.5) < 0.02

    def test_edges_preserved_by_features(self):
        h = w = 64
        rng = np.random.default_rng(1)
        img = np.full((h, w, 3), 0.2, np.float32)
        img[:, w // 2:] = 1.0
        img += rng.normal(0, 0.05, img.shape).astype(np.float32)
        normal = np.zeros((h, w, 3), np.float32)
        normal[:, :w // 2, 1] = 1.0
        normal[:, w // 2:, 0] = 1.0
        depth = np.full((h, w), 3.0, np.float32)
        depth[:, w // 2:] = 8.0
        out = tt.atrous_denoise(_t(img), torch.full((h, w, 3), 0.8),
                                _t(normal), _t(depth),
                                sigma_color=2.0).numpy()
        left = out[:, : w // 2 - 4].mean()
        right = out[:, w // 2 + 4:].mean()
        assert right - left > 0.8 * (1.0 - 0.2) * 0.9
        assert out[8:-8, 8: w // 2 - 8].std() < 0.02

    def test_albedo_demodulation_keeps_texture(self):
        h = w = 64
        checker = ((np.arange(h)[:, None] // 4 + np.arange(w)[None, :] // 4)
                   % 2).astype(np.float32)
        albedo = _t(np.repeat((0.2 + 0.6 * checker)[..., None], 3, -1))
        _, normal, depth = _flat_features(h, w)
        img = albedo * 0.7
        out = tt.atrous_denoise(img, albedo, normal, depth)
        assert float((out - img).abs().max()) < 1e-3


class TestDefocusRelax:
    def test_relax_map_shape(self):
        cfg = tt.RenderConfig(width=64, height=32, aperture=0.5,
                              focus_dist=10.0)
        z = torch.full((32, 64), 10.0)
        assert float(dn.defocus_relax(cfg, z).max()) == 0.0
        z_far = torch.full((32, 64), 40.0)
        assert float(dn.defocus_relax(cfg, z_far).min()) > 0.5
        assert float(dn.defocus_relax(cfg, torch.zeros((32, 64))).max()) == 0
        assert float(dn.defocus_relax(cfg.with_(aperture=0.0),
                                      z_far).max()) == 0.0

    def test_relax_smooths_across_feature_edges(self):
        h = w = 64
        rng = np.random.default_rng(2)
        img = _t(0.5 + rng.normal(0, 0.2, (h, w, 3)))
        normal = np.zeros((h, w, 3), np.float32)
        normal[:, : w // 2, 1] = 1.0
        normal[:, w // 2:, 0] = 1.0
        depth = np.full((h, w), 3.0, np.float32)
        depth[:, w // 2:] = 9.0
        albedo = torch.full((h, w, 3), 0.8)
        out_stop = tt.atrous_denoise(img, albedo, _t(normal), _t(depth),
                                     sigma_color=2.0).numpy()
        out_relax = tt.atrous_denoise(img, albedo, _t(normal), _t(depth),
                                      relax=torch.ones((h, w)),
                                      sigma_color=2.0).numpy()
        band = slice(w // 2 - 2, w // 2 + 2)
        assert out_relax[8:-8, band].std() < out_stop[8:-8, band].std()

    def test_local_sigma_smooths_heterogeneous_speckle(self):
        h = w = 64
        rng = np.random.default_rng(3)
        img = np.full((h, w, 3), 2.0, np.float32)
        img[:, w // 2:] = 4.0
        img[8:24, 8:24] = np.maximum(rng.normal(3.0, 1.5, (16, 16, 3)), 0.0)
        normal = _t(np.tile([0.0, 0.0, 1.0], (h, w, 1)))
        out = tt.atrous_denoise(_t(img), torch.ones((h, w, 3)), normal,
                                torch.full((h, w), 5.0)).numpy()
        inner = (slice(11, 21), slice(11, 21))
        assert out[inner].std() < img[inner].std() * 0.3
        left = out[40:60, w // 2 - 8:w // 2 - 2].mean()
        right = out[40:60, w // 2 + 2:w // 2 + 8].mean()
        assert right / left > 1.7, (left, right)


class TestDenoiseImage:
    def test_end_to_end_reduces_noise(self):
        cfg, scene, cam = _setup()
        st_lo = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                          11, 4)
        st_hi = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                          500, 64)
        ref = tt.resolve_image(cfg, st_hi).numpy()
        raw = tt.resolve_image(cfg, st_lo).numpy()
        den = tt.denoise_image(scene, cfg, cam, st_lo).numpy()
        assert den.shape == raw.shape and np.isfinite(den).all()
        assert ((den - ref) ** 2).mean() < ((raw - ref) ** 2).mean() / 2.0

    def test_aov_reuse_matches(self):
        cfg, scene, cam = _setup()
        st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 11, 2)
        aovs = tt.render_aovs(scene, cfg, cam)
        a = tt.denoise_image(scene, cfg, cam, st)
        b = tt.denoise_image(scene, cfg, cam, st, aovs=aovs)
        assert torch.equal(a, b)


# ----- the port against tpurt -----

def _j_cam(tp, w, h):
    return tp.tpurt.make_camera(*CAM, vfov=60.0, aspect_ratio=w / h)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("w,h", [(96, 64), (256, 144)])
def test_aovs_match_tpurt(tp, w, h):
    cfg, scene, cam = _setup(w, h)
    got = tt.render_aovs(scene, cfg, cam)
    js = tp.tpurt.cornell_spheres_scene()
    jcfg = tp.tpurt.RenderConfig(width=w, height=h)
    with tp.jax.disable_jit():
        eager = tp.denoise.render_aovs(js, jcfg, _j_cam(tp, w, h))
    np.testing.assert_array_equal(got.albedo.numpy(), np.asarray(eager.albedo))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(eager.depth))
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(eager.normal),
                               rtol=0, atol=2.4e-7)
    jit = tp.denoise.render_aovs(js, jcfg, _j_cam(tp, w, h))
    other = (got.albedo.numpy() != np.asarray(jit.albedo)).any(-1)
    assert other.mean() <= 0.002


def _seeded_inputs(h, w, seed):
    rs = np.random.default_rng(seed)
    img = rs.gamma(0.6, 2.0, (h, w, 3)).astype(np.float32)
    img[: h // 2] *= 0.1
    alb = rs.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
    nrm = rs.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dep = rs.uniform(0.0, 20.0, (h, w)).astype(np.float32)
    return img, alb, nrm, dep


@pytest.mark.parametrize("sigma,relax", [(None, False), (2.0, False),
                                         (None, True)])
def test_atrous_matches_tpurt(tp, sigma, relax):
    """5 iterations on seeded inputs (48x40: an even count, so the median
    is the mean of two values)."""
    h, w = 40, 48
    img, alb, nrm, dep = _seeded_inputs(h, w, 7)
    rel = (np.random.default_rng(8).uniform(0, 1, (h, w)).astype(np.float32)
           if relax else None)
    jnp = tp.jnp
    want = tp.denoise.atrous_denoise(
        jnp.asarray(img), jnp.asarray(alb), jnp.asarray(nrm),
        jnp.asarray(dep), sigma_color=sigma,
        relax=None if rel is None else jnp.asarray(rel))
    got = tt.atrous_denoise(_t(img), _t(alb), _t(nrm), _t(dep),
                            sigma_color=sigma,
                            relax=None if rel is None else _t(rel))
    _close(got.numpy(), want)


def test_atrous_matches_tpurt_op_by_op(tp):
    h, w = 16, 24
    img, alb, nrm, dep = _seeded_inputs(h, w, 9)
    with tp.jax.disable_jit():
        want = np.asarray(tp.denoise.atrous_denoise(
            *(tp.jnp.asarray(x) for x in (img, alb, nrm, dep)),
            iterations=3))
    got = tt.atrous_denoise(_t(img), _t(alb), _t(nrm), _t(dep),
                            iterations=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_median_is_jnp_median_at_an_even_count(tp):
    """jnp.median averages the two middle values; torch.median returns the
    lower one. The port takes jnp's, bit for bit."""
    rs = np.random.default_rng(10)
    for n in (2, 6, 3072, 3071):
        d = rs.uniform(0.0, 5.0, n).astype(np.float32)
        got = dn._median(torch.from_numpy(d))
        want = np.asarray(tp.jnp.median(tp.jnp.asarray(d)))
        assert got.numpy() == want, n
        if n % 2 == 0:
            assert got != torch.median(torch.from_numpy(d))
    d = rs.uniform(0.0, 5.0, 6).astype(np.float32)
    d[2] = np.nan
    assert bool(torch.isnan(dn._median(torch.from_numpy(d))))


def test_defocus_relax_matches_tpurt(tp):
    rs = np.random.default_rng(11)
    z = rs.uniform(0.0, 40.0, (32, 64)).astype(np.float32)
    z[::5] = 0.0
    for ap, fd in ((0.5, 10.0), (0.1, 12.0), (0.0, 10.0)):
        kw = dict(width=64, height=32, aperture=ap, focus_dist=fd)
        got = dn.defocus_relax(tt.RenderConfig(**kw), _t(z), clamp_px=1.5)
        want = tp.denoise.defocus_relax(tp.tpurt.RenderConfig(**kw),
                                        tp.jnp.asarray(z), clamp_px=1.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("aperture", [0.0, 0.2])
def test_denoise_image_matches_tpurt(tp, aperture):
    """denoise_image on tpurt's own 2-spp state and AOVs (carried over by
    interop), tonemapped and linear (tonemap=False)."""
    w, h = 64, 32
    kw = dict(width=w, height=h, depth=4, backend="xla",
              enable_photons=False, aperture=aperture, focus_dist=12.0)
    js = tp.tpurt.cornell_spheres_scene()
    jcfg = tp.tpurt.RenderConfig(**kw)
    jcam = _j_cam(tp, w, h)
    st = tp.tpurt.render(js, jcfg, jcam, tp.render.init_state(jcfg), 5, 2)
    aj = tp.denoise.render_aovs(js, jcfg, jcam)
    fields = {f.name: np.asarray(getattr(st, f.name))
              for f in dataclasses.fields(st)}
    state = state_from_numpy(fields, device=CPU)
    aovs = aovs_from_numpy(aj.albedo, aj.normal, aj.depth, device=CPU)
    cfg = tt.RenderConfig(**kw)
    cam = camera_from_numpy(*(np.asarray(getattr(jcam, f)) for f in (
        "origin", "horizontal", "vertical", "lower_left")))
    scene = tt.cornell_spheres_scene(device=CPU)
    for tonemap in (True, False):
        want = tp.denoise.denoise_image(js, jcfg, jcam, st, aovs=aj,
                                        tonemap=tonemap)
        got = tt.denoise_image(scene, cfg, cam, state, aovs=aovs,
                               tonemap=tonemap)
        # rtol 1e-3: out-of-gamut single-wavelength sums go negative, so
        # taps of opposite sign cancel, and the tonemap's v / (1 + v) near
        # v = -1 amplifies what is left of XLA's FMA rounding
        _close(got.numpy(), want, rtol=1e-3)


# ----- on the card -----

@pytest.mark.gpu
def test_denoise_on_the_card_matches_the_cpu(cuda):
    """render_aovs, atrous_denoise and denoise_image on the card against
    the CPU on the same state: AOV albedo and depth exact, the filtered
    image rtol 1e-4, atol 1e-5 of its largest value (exp and the
    reductions differ in the last bits)."""
    cfg, _, cam = _setup(64, 32)
    st = tt.render(tt.cornell_spheres_scene(device=CPU), cfg, cam,
                   tt.init_state(cfg, device=CPU), 3, 4)
    out = {}
    for dev in (CPU, cuda):
        scene = tt.cornell_spheres_scene(device=dev)
        state = dataclasses.replace(
            st, rgb_sum=st.rgb_sum.to(dev), n_samples=st.n_samples.to(dev))
        aovs = tt.render_aovs(scene, cfg, cam)
        lin = tt.denoise_image(scene, cfg, cam, state, aovs=aovs,
                               tonemap=False)
        out[str(dev)] = [x.cpu() for x in (*aovs, lin)]
    a, b = out[CPU], out[str(cuda)]
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    _close(b[3].numpy(), a[3].numpy())
