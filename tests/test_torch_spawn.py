"""tpurt's camera-spawn extensions in the port: the Owen-scrambled Sobol
spawn draws (``qmc``, ``tpurt_torch/ops/qmc.py``), the thin lens
(``aperture``/``focus_dist``), the shutter (``motion_blur`` with a
``MotionCamera``), the camera module's host math (``set_vfov``,
``CameraController``) and ``RenderConfig.preset``, against tpurt
(tests/test_qmc.py, test_dof.py, test_motion.py, test_camera.py:11-66,
test_presets_until.py:32-54); and, on a CUDA device, the path kernels'
spawn instances against their plain versions.

Tolerances: the Sobol points, scrambles and spawn-stream draws bit for bit
(uint32 arithmetic); the spawn rays bit for bit without the lens, and with
it within 2**-23 of the ray's norm, component by component (measured: 0.45
of that): tpurt's lens takes XLA's rsqrt, cos and sin, the port 1/sqrt and
PyTorch's cos and sin, which differ from XLA's in the last bit on ~36% and
~5% of inputs; the wavelength and the path's PCG state bit for bit. Renders
against tpurt's XLA integrator: ray counts exact on tpurt's pinned seeds;
images with the median |diff| < 1e-4 of tests/test_golden.py and fewer than
2% of pixels off by more than 1e-2 in rgb_sum, the bound tpurt's own tests
hold its XLA integrator and its kernels to for these flags
(tests/test_qmc.py:214, test_dof.py:175, test_motion.py:89): at these
shapes tpurt's XLA and Pallas backends themselves differ on 0.6-1.2% of
pixels. One ray-count difference is pinned to its operation
(``test_dof_golden_seed_flip_is_the_normalize_form``). The port's own
backends bit for bit where they run one function; on the card every
spawn instance bit for bit against its plain version.

tpurt is imported inside the fixture ``tp``, so the GPU cases (marker
``gpu``) run where JAX is not installed:
``python3 -m pytest tests/test_torch_spawn.py -m gpu --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import camera as tcam
from tpurt_torch import integrate, wavefront
from tpurt_torch.interop import camera_from_numpy, motion_camera_from_numpy
from tpurt_torch.kernels import (mega_regen, mega_step, wavefront_fused,
                                 wavefront_sweep)
from tpurt_torch.ops import qmc as tqmc
from tpurt_torch.ops import rng as trng
from tpurt_torch.ops import soa
from tpurt_torch.render import radius_after, state_to_planes
from tpurt_torch.scene import freeze_scene

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)

W, H = 64, 32
EYE = ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0))
EYE1 = ((0.4, 5.2, -11.8), (0.0, 5.0, 0.0))
LENS = dict(aperture=0.4, focus_dist=12.0)
FLAGS = {
    "qmc": dict(qmc=True),
    "dof": dict(LENS),
    "motion": dict(motion_blur=True),
    "qmc+dof": dict(qmc=True, **LENS),
    "qmc+motion": dict(qmc=True, motion_blur=True),
    "dof+motion": dict(motion_blur=True, **LENS),
    "all": dict(qmc=True, motion_blur=True, **LENS),
}


@pytest.fixture(scope="module")
def tp():
    import jax.numpy as jnp

    import tpurt
    from tpurt import camera as jcam
    from tpurt.ops import qmc as jqmc
    from tpurt.ops import rng as jrng
    from tpurt.ops import spectra as jspec
    return types.SimpleNamespace(jnp=jnp, tpurt=tpurt, cam=jcam, qmc=jqmc,
                                 rng=jrng, spec=jspec)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_spawn.py -m gpu --noconftest")
    return torch.device("cuda")


def _image_rule(a, b):
    diff = np.abs(a - b)
    med, frac = float(np.median(diff)), float((diff.max(-1) > 1e-2).mean())
    print(f"median |diff| {med:.3g}, {frac:.2%} pixels > 1e-2")
    assert med < 1e-4
    assert frac < 0.02


def _camera(pkg, motion: bool, aspect=W / H):
    c0 = pkg.make_camera(*EYE, vfov=60.0, aspect_ratio=aspect)
    if not motion:
        return c0
    c1 = pkg.make_camera(*EYE1, vfov=60.0, aspect_ratio=aspect)
    mc = pkg.camera.MotionCamera if pkg is not tt else tt.MotionCamera
    return mc(c0, c1)


# ----- ops/qmc: bit for bit -----

def test_direction_table_matches_tpurt(tp):
    np.testing.assert_array_equal(tqmc.DIRECTIONS, tp.qmc._DIRS)
    assert tqmc.N_DIMS == tp.qmc.N_DIMS == 6


@pytest.mark.parametrize("dim", range(6))
def test_sobol_and_scramble_match_tpurt(tp, dim):
    """sobol_u32, reverse_bits_u32 and owen_scramble_u32 on seeded random
    indices and seeds, bit for bit."""
    g = np.random.default_rng(dim)
    idx = g.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    seed = g.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    jn = tp.jnp
    want = np.asarray(tp.qmc.sobol_u32(jn.asarray(idx), dim))
    got = tqmc.sobol_u32(torch.from_numpy(idx.astype(np.int64)), dim)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        tqmc.reverse_bits_u32(torch.from_numpy(idx.astype(np.int64))).numpy(),
        np.asarray(tp.qmc.reverse_bits_u32(jn.asarray(idx))).astype(np.int64))
    np.testing.assert_array_equal(
        tqmc.owen_scramble_u32(got, torch.from_numpy(
            seed.astype(np.int64))).numpy(),
        np.asarray(tp.qmc.owen_scramble_u32(
            jn.asarray(want), jn.asarray(seed))).astype(np.int64))


def test_sobol_matches_torch_engine():
    """The direction numbers reproduce PyTorch's Joe-Kuo Sobol (first 128
    points, all 6 dims); PyTorch enumerates in Gray-code order, its point i
    is the natural-order point i ^ (i >> 1)."""
    want = torch.quasirandom.SobolEngine(tqmc.N_DIMS, scramble=False).draw(
        128, dtype=torch.float64).numpy()
    i = torch.arange(128)
    got = np.stack([tqmc.sobol_u32(i ^ (i >> 1), d).numpy() / 2.0 ** 32
                    for d in range(tqmc.N_DIMS)], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_spawn_stream_draws_match_tpurt(tp):
    """Every dimension of spawn_stream for seeded pixels, sample indices
    (one per lane) and base seeds, bit for bit; rand_2f stacks like
    tpurt's; a draw past N_DIMS raises."""
    g = np.random.default_rng(5)
    px, py = g.integers(0, 1920, 2048), g.integers(0, 1080, 2048)
    idx = g.integers(0, 1 << 20, 2048)
    jn = tp.jnp
    for base in (0, 9, 0xDEADBEEF):
        js = tp.qmc.spawn_stream(base, jn.asarray(idx, jn.int32),
                                 jn.asarray(px), jn.asarray(py))
        ts = tqmc.spawn_stream(base, torch.from_numpy(idx),
                               torch.from_numpy(px), torch.from_numpy(py))
        u2j, js = tp.rng.rand_2f(js)
        u2t, ts = trng.rand_2f(ts)
        np.testing.assert_array_equal(u2t.numpy(), np.asarray(u2j))
        for _ in range(tqmc.N_DIMS - 2):
            uj, js = tp.rng.rand_1f(js)
            ut, ts = trng.rand_1f(ts)
            np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
        assert ts.dim == js.dim == tqmc.N_DIMS
    with pytest.raises(ValueError, match="exhausted"):
        trng.rand_1f(ts)
    # one index for every lane, as the progressive renderer passes it
    ts = tqmc.spawn_stream(3, 17, torch.from_numpy(px), torch.from_numpy(py))
    js = tp.qmc.spawn_stream(3, 17, jn.asarray(px), jn.asarray(py))
    np.testing.assert_array_equal(trng.rand_1f(ts)[0].numpy(),
                                  np.asarray(tp.rng.rand_1f(js)[0]))


def test_sobol_stream_stratifies_a_pixel():
    """16 consecutive samples of one pixel's jitter x land one per 1/16
    bin (the scramble keeps the elementary intervals)."""
    us = [float(trng.rand_1f(tqmc.spawn_stream(
        42, s, torch.tensor([7]), torch.tensor([11])))[0][0])
        for s in range(16)]
    assert sorted(int(u * 16) for u in us) == list(range(16))


# ----- camera: the lens, the shutter and the spawn against tpurt -----

def _tpurt_spawn(tp, cfg, camera, px, py, seed, base_seed, sample):
    """tpurt's XLA spawn block (tpurt/integrate.py render_tile :904-925),
    run eagerly: returns (o, d, lam, rng) as NumPy."""
    jn, rng_ = tp.jnp, tp.rng
    px, py = jn.asarray(px), jn.asarray(py)
    rng = rng_.seed_pixels(jn.uint32(seed), px, py)
    src = (tp.qmc.spawn_stream(base_seed, jn.asarray(sample, jn.int32), px,
                               py) if cfg.qmc else rng)
    u_jit, src = rng_.rand_2f(src)
    u = (px.astype(jn.float32) + u_jit[:, 0]) / jn.float32(cfg.width)
    v = (py.astype(jn.float32) + u_jit[:, 1]) / jn.float32(cfg.height)
    o, d, src = tp.cam.spawn_camera_rays(cfg, camera, u, v, src)
    u_lam, src = rng_.rand_1f(src)
    if not cfg.qmc:
        rng = src
    return (np.asarray(o), np.asarray(d),
            np.asarray(tp.spec.sample_wavelength(u_lam)), np.asarray(rng))


@pytest.mark.parametrize("flags", list(FLAGS))
def test_spawn_rays_match_tpurt(tp, flags):
    """integrate.spawn_camera against tpurt's spawn on 4096 seeded (pixel,
    sample) pairs: the draws, the wavelength and the PCG state the path
    goes on with bit for bit; the rays bit for bit without the lens, with
    it within 2**-23 of each ray's norm (tpurt's rsqrt, cos and sin are
    XLA's; the port's are 1/sqrt and PyTorch's)."""
    kw = dict(width=W, height=H, **FLAGS[flags])
    cfg_j, cfg = tp.tpurt.RenderConfig(**kw), tt.RenderConfig(**kw)
    g = np.random.default_rng(11)
    px, py = g.integers(0, W, 4096), g.integers(0, H, 4096)
    sample = g.integers(0, 1000, 4096)
    oj, dj, lj, rj = _tpurt_spawn(
        tp, cfg_j, _camera(tp.tpurt, cfg.motion_blur), px, py, 123456789, 7,
        sample)
    o, d, lam, rng = integrate.spawn_camera(
        cfg, _camera(tt, cfg.motion_blur), torch.from_numpy(px),
        torch.from_numpy(py), 123456789, (7, torch.from_numpy(sample)))
    o, d = torch.stack(o, -1).numpy(), torch.stack(d, -1).numpy()
    np.testing.assert_array_equal(lam.numpy(), lj)
    np.testing.assert_array_equal(rng.numpy(), rj.astype(np.int64))
    if not cfg.aperture:
        np.testing.assert_array_equal(o, oj)
        np.testing.assert_array_equal(d, dj)
        return
    eps = float(np.float32(2.0 ** -23))
    for got, want in ((o, oj), (d, dj)):
        norm = np.linalg.norm(want, axis=-1, keepdims=True)
        assert (np.abs(got - want) <= eps * norm).all()


def test_lens_and_shutter_match_tpurt(tp):
    """The component helpers on one seeded set of rays: motion_rows and
    the shutter lerp bit for bit; lens_perturb_c's draws bit for bit, its
    rays within 2**-23 of their norm; the focal point o + F d kept within
    float32 rounding; focus_dist <= 0 raises."""
    jn = tp.jnp
    mc_j, mc = _camera(tp.tpurt, True), _camera(tt, True)
    np.testing.assert_array_equal(tcam.motion_rows(mc),
                                  np.asarray(tp.cam.motion_rows(mc_j)))
    g = np.random.default_rng(3)
    ut = g.random(1024, dtype=np.float32)
    want = tp.cam.lerp_components_c(mc_j, jn.asarray(ut))
    got = tcam.lerp_components_c(mc, torch.from_numpy(ut))
    for wv, gv in zip(want, got):
        for c in range(3):
            np.testing.assert_array_equal(gv[c].numpy(), np.asarray(wv[c]))
    o0 = tuple(torch.from_numpy(g.normal(size=1024).astype(np.float32))
               for _ in range(3))
    d0 = tuple(torch.from_numpy(g.normal(size=1024).astype(np.float32))
               for _ in range(3))
    h, v = tuple(got[1]), tuple(got[2])
    seed = trng.seed_pixels(5, torch.arange(1024), torch.zeros(1024))
    o, d, st = tcam.lens_perturb_c(0.4, 12.0, seed, o0, d0, h, v)
    oj, dj, sj = tp.cam.lens_perturb_c(
        0.4, 12.0, jn.asarray(seed.numpy().astype(np.uint32)),
        tuple(jn.asarray(x.numpy()) for x in o0),
        tuple(jn.asarray(x.numpy()) for x in d0),
        tuple(jn.asarray(x.numpy()) for x in h),
        tuple(jn.asarray(x.numpy()) for x in v), tp.rng.rand_1f)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).astype(np.int64))
    eps = float(np.float32(2.0 ** -23))
    for got3, want3 in ((o, oj), (d, dj)):
        a = torch.stack(got3, -1).numpy()
        b = np.stack([np.asarray(x) for x in want3], -1)
        assert (np.abs(a - b) <= eps * np.linalg.norm(b, axis=-1,
                                                      keepdims=True)).all()
    focal0 = torch.stack([o0[c] + 12.0 * d0[c] for c in range(3)], -1)
    focal = torch.stack([o[c] + 12.0 * d[c] for c in range(3)], -1)
    torch.testing.assert_close(focal, focal0, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="focus_dist"):
        tcam.lens_perturb_c(0.4, 0.0, seed, o0, d0, h, v)


def test_lens_offsets_fill_the_disc():
    """Offsets |o - o0| stay inside the aperture's disc and fill it: the
    largest reaches 90% of its radius (tests/test_dof.py:39)."""
    cam = _camera(tt, False)
    u = torch.linspace(0.1, 0.9, 4096)
    v = torch.full((4096,), 0.4)
    o0, d0 = tcam.generate_rays(cam, u, v)
    rng = trng.seed_pixels(7, torch.arange(4096), torch.zeros(4096))
    o, _, _ = tcam.lens_perturb(cam, 0.6, 8.0, o0, d0, rng)
    r = torch.stack([o[c] - o0[c] for c in range(3)], -1).norm(dim=-1)
    assert float(r.max()) <= 0.3 * (1 + 1e-5)
    assert float(r.max()) > 0.27


@pytest.mark.parametrize("args", [
    ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), (0.0, 1.0, 0.0), 60.0, 2.0),
    ((1.0, 2.0, 3.0), (-2.0, 0.5, 7.0), (0.0, 1.0, 0.0), 75.0, 16 / 9)])
def test_camera_host_math_matches_tpurt(tp, args):
    """tests/test_camera.py:11-66: set_vfov, and the controller's dolly,
    boost and yaw, against tpurt's (float64 host math, rounded to
    float32), and that a press flags the change."""
    want, got = tp.tpurt.make_camera(*args), tt.make_camera(*args)
    pairs = [(tp.cam.set_vfov(want, 30.0, 1.5), tcam.set_vfov(got, 30.0,
                                                              1.5))]
    for keys, mouse in ((("forward",), None), (("right", "boost"), None),
                        (("up",), None), ((), (120.0, 0.0)),
                        ((), (0.0, 80.0))):
        cj, ct = tp.cam.CameraController(), tt.CameraController()
        for k in keys:
            cj.set_key(k, True)
            ct.set_key(k, True)
        if mouse:
            cj.mouse_move(*mouse)
            ct.mouse_move(*mouse)
        (nj, chj), (nt, cht) = cj.update(want, 1e5), ct.update(got, 1e5)
        assert chj == cht is True
        pairs.append((nj, nt))
    for cj_, ct_ in pairs:
        for f in ("origin", "horizontal", "vertical", "lower_left"):
            np.testing.assert_allclose(getattr(ct_, f).numpy(),
                                       np.asarray(getattr(cj_, f)),
                                       rtol=1e-6, atol=1e-6)
    idle = tt.CameraController().update(got, 1e5)
    assert idle[1] is False
    np.testing.assert_array_equal(idle[0].rows(), got.rows())
    with pytest.raises(KeyError):
        tt.CameraController().set_key("jump", True)


def test_motion_camera_interop_and_base_camera(tp):
    mc_j = _camera(tp.tpurt, True)
    mc = motion_camera_from_numpy(
        *[[np.asarray(getattr(c, f)) for f in
           ("origin", "horizontal", "vertical", "lower_left")]
          for c in (mc_j.cam0, mc_j.cam1)])
    np.testing.assert_array_equal(tcam.motion_rows(mc),
                                  np.asarray(tp.cam.motion_rows(mc_j)))
    assert tt.base_camera(mc) is mc.cam0
    cam = camera_from_numpy(*mc.cam0.rows())
    assert tt.base_camera(cam) is cam


# ----- RenderConfig.preset -----

def test_presets_are_tpurts(tp):
    assert tt.RenderConfig.PRESETS == tp.tpurt.RenderConfig.PRESETS
    assert tt.RenderConfig.preset("reference") == tt.RenderConfig()
    q = tt.RenderConfig.preset("quality", width=64)
    assert q.hero_wavelengths == 4 and q.qmc and q.width == 64
    f = tt.RenderConfig.preset("fast", photon_rr_scale=0.7)
    assert f.photon_rr_scale == 0.7 and f.qmc and f.hero_wavelengths == 4
    with pytest.raises(ValueError, match="reference"):
        tt.RenderConfig.preset("qualtiy")


# ----- renders against tpurt's XLA integrator -----

_XLA = {}


def _tpurt_render(tp, kw, seed, spp):
    """tpurt's XLA integrator, cached per case: (rays, rgb_sum)."""
    key = (tuple(sorted(kw.items())), seed, spp)
    if key not in _XLA:
        cfg = tp.tpurt.RenderConfig(backend="xla", **kw)
        st = tp.tpurt.render(tp.tpurt.cornell_spheres_scene(), cfg,
                             _camera(tp.tpurt, cfg.motion_blur),
                             tp.tpurt.init_state(cfg), seed, spp)
        _XLA[key] = (int(float(st.rays)),
                     np.asarray(st.rgb_sum)[:cfg.n_pixels])
    return _XLA[key]


def _port_render(backend, kw, seed, spp, state=None):
    extra = (dict(backend="pallas", pallas_regen=False)
             if backend == "tile-sync" else dict(backend=backend))
    cfg = tt.RenderConfig(wf_pool=1024, **extra, **kw)
    st = tt.init_state(cfg, device=CPU) if state is None else state
    return tt.render(tt.cornell_spheres_scene(device=CPU), cfg,
                     _camera(tt, cfg.motion_blur), st, seed, spp)


BACKENDS = ("xla", "pallas", "tile-sync", "wavefront", "wavefront_pallas",
            "wavefront_fused")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("flags", ["qmc", "dof", "motion", "all"])
def test_backends_match_tpurt_xla(tp, backend, flags):
    """tests/test_qmc.py's and test_dof.py's setup (Cornell 64x32, depth 4,
    photons off, seed 9, 4 spp) on every backend of the port with each
    flag alone and all three together: rays exact, the image by the
    rule."""
    kw = dict(width=W, height=H, depth=4, enable_photons=False,
              **FLAGS[flags])
    rays_j, rgb_j = _tpurt_render(tp, kw, 9, 4)
    st = _port_render(backend, kw, 9, 4)
    assert int(st.rays) == rays_j
    _image_rule(st.rgb_sum.numpy()[:W * H], rgb_j)


@pytest.mark.parametrize("flags", ["all"])
def test_photon_pass_with_the_flags_matches_tpurt(tp, flags):
    """The photon pass under the spawn flags (K 2, 3 bounces; the PCG
    streams start at position 0 under qmc), seed 7, 4 spp (tests/
    test_motion.py's seed): rays exact, the image by the rule, on the
    regen kernel's plain path. The lens and the shutter without qmc trace
    3 segments fewer here: test_dof_motion_seed7_flip_is_xla_contraction
    pins them."""
    kw = dict(width=W, height=H, depth=4, k_photons=2, max_photon_bounces=3,
              **FLAGS[flags])
    rays_j, rgb_j = _tpurt_render(tp, kw, 7, 4)
    st = _port_render("pallas", kw, 7, 4)
    assert int(st.rays) == rays_j
    _image_rule(st.rgb_sum.numpy()[:W * H], rgb_j)


@pytest.mark.parametrize("name", ["reference", "quality", "fast", "walk"])
def test_presets_render_like_tpurt(tp, name):
    """Each preset (tests/test_presets_until.py:46: 32x16, depth 2, seed
    5, 2 spp; here K 2, 3 photon bounces) through backend "pallas" (the
    regen kernel's plain path here): rays exact against tpurt's XLA
    integrator, the image by the rule."""
    kw = dict(tp.tpurt.RenderConfig.PRESETS[name], width=32, height=16,
              depth=2, k_photons=2, max_photon_bounces=3)
    rays_j, rgb_j = _tpurt_render(tp, kw, 5, 2)
    st = _port_render("pallas", kw, 5, 2)
    assert int(st.rays) == rays_j
    _image_rule(st.rgb_sum.numpy()[:32 * 16], rgb_j)


@pytest.mark.parametrize("backend", ["pallas", "tile-sync", "wavefront",
                                     "wavefront_fused"])
def test_progressive_continuation_is_exact(backend):
    """Under qmc with the lens and the shutter, one 4-spp call equals two
    2-spp calls bit for bit: the Sobol index is the global sample number
    (tests/test_qmc.py:154)."""
    kw = dict(width=W, height=H, depth=3, enable_photons=False,
              **FLAGS["all"])
    a = _port_render(backend, kw, 9, 4)
    b = _port_render(backend, kw, 9, 2, _port_render(backend, kw, 9, 2))
    assert int(a.rays) == int(b.rays) > 0
    assert torch.equal(a.rgb_sum, b.rgb_sum)


def test_aperture_zero_is_the_pinhole():
    """aperture 0 draws nothing more whatever focus_dist says
    (tests/test_dof.py:136), and qmc changes the image."""
    kw = dict(width=W, height=H, depth=3, enable_photons=False)
    a = _port_render("xla", dict(kw, focus_dist=5.0), 9, 2)
    b = _port_render("xla", kw, 9, 2)
    assert torch.equal(a.rgb_sum, b.rgb_sum) and int(a.rays) == int(b.rays)
    q = _port_render("xla", dict(kw, qmc=True), 9, 2)
    assert (q.rgb_sum - b.rgb_sum).abs().max() > 1e-3


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_adaptive_matches_tpurt(tp, backend):
    """render_adaptive with qmc, the lens and the shutter on
    tests/test_torch_adaptive.py's pinned case (48x24, depth 4, photons
    off, spp 8, pilot 4, seed 11), the pilots' and the budget pass's draws
    following each pixel's global sample index. On the plain pool ("xla";
    on the CPU "wavefront_fused" runs it too) the budgets, sample counts
    and ray count are tpurt's exactly, the image by the rule. tpurt runs
    "pallas" through its jitted regen kernel, whose pilots XLA contracts
    differently (ROADMAP C3): there, as tests/test_torch_adaptive.py holds
    it, at most 1% of the
    budgets differ, by one sample, and the ray count by no more than those
    samples' longest paths."""
    kw = dict(width=48, height=24, depth=4, tile_size=1152,
              enable_photons=False, **FLAGS["all"])
    cfg_j = tp.tpurt.RenderConfig(backend=backend, wf_pool=1024,
                                  pallas_lanes=512, **kw)
    st_j, b_j = tp.tpurt.render_adaptive(
        tp.tpurt.cornell_spheres_scene(), cfg_j,
        _camera(tp.tpurt, True, 2.0), 11, 8, 4)
    cfg = tt.RenderConfig(backend=backend, wf_pool=1024, **kw)
    st, b = tt.render_adaptive(tt.cornell_spheres_scene(device=CPU), cfg,
                               _camera(tt, True, 2.0), 11, 8, 4)
    n = cfg.n_pixels
    b, b_j = b.numpy()[:n].astype(np.int64), np.asarray(b_j)[:n]
    np.testing.assert_array_equal(st.n_samples.numpy()[:n], 4 + b)
    if backend == "xla":
        np.testing.assert_array_equal(b, b_j)
        assert int(st.rays) == int(float(st_j.rays)) > 0
        _image_rule(st.rgb_sum.numpy()[:n], np.asarray(st_j.rgb_sum)[:n])
        return
    off = np.abs(b - b_j)
    print(f"{(off > 0).sum()} of {off.size} budgets differ")
    assert off.max() <= 1 and (off > 0).mean() <= 0.01
    assert abs(int(st.rays) - int(float(st_j.rays))) \
        <= int(off.sum()) * cfg.depth * 2


def test_dof_golden_seed_flip_is_the_normalize_form(tp, monkeypatch):
    """tests/test_golden.py's shape (depth 6, photons off) with the lens,
    seed 1234, 8 spp: the port traces one segment fewer than tpurt's XLA
    integrator (71191 against 71192). Pinned: at pixel (8, 23) of sample 7
    the spawn ray is tpurt's bit for bit; the paths part at the first
    diffuse scatter, whose direction differs by one ulp because tpurt's
    XLA integrator normalizes by dividing by the norm (tpurt/ops/bsdf.py
    normalize) where the port, like tpurt's kernel device code
    (tpurt/ops/soa.py vnormalize), multiplies by its reciprocal; five
    bounces later the port's path grazes a sphere and ends. With the
    division form the port traces tpurt's 71192."""
    kw = dict(width=W, height=H, depth=6, tile_size=2048,
              enable_photons=False, **LENS)
    rays_j, _ = _tpurt_render(tp, kw, 1234, 8)
    assert rays_j == 71192
    assert int(_port_render("xla", kw, 1234, 8).rays) == 71191
    seed = trng.frame_seed(1234, 7)
    cfg_j, cfg = tp.tpurt.RenderConfig(**kw), tt.RenderConfig(**kw)
    oj, dj, _, _ = _tpurt_spawn(tp, cfg_j, _camera(tp.tpurt, False), [8],
                                [23], seed, 1234, 7)
    o, d, _, _ = integrate.spawn_camera(cfg, _camera(tt, False),
                                        torch.tensor([8]), torch.tensor([23]),
                                        seed)
    np.testing.assert_array_equal(torch.stack(o, -1).numpy(), oj)
    np.testing.assert_array_equal(torch.stack(d, -1).numpy(), dj)

    def normalize_by_division(a, eps=0.0):
        n = integrate.fsqrt(soa.vdot(a, a).clamp_min(eps))
        return tuple(x / n for x in a)

    monkeypatch.setattr(soa, "vnormalize", normalize_by_division)
    assert int(_port_render("xla", kw, 1234, 8).rays) == 71192


def test_dof_motion_seed7_flip_is_xla_contraction(tp):
    """The lens and the shutter without qmc, seed 7, depth 4, 4 spp: the
    port traces 3 camera segments fewer than tpurt's XLA integrator
    (photons off: 33124 against 33127; with K 2 photons, which these
    camera paths do not change, 74562 against 74565). Pinned: all 3 are
    pixel (37, 28) of sample 3, where tpurt's jitted render_tile traces 7
    segments and the same function run eagerly (no XLA fusion) 4, as the
    port does: XLA's contraction of tpurt's jitted graph, ROADMAP C3's
    kind."""
    import jax

    from tpurt import integrate as jint
    kw = dict(width=W, height=H, depth=4, enable_photons=False,
              **FLAGS["dof+motion"])
    assert _tpurt_render(tp, kw, 7, 4)[0] == 33127
    assert int(_port_render("pallas", kw, 7, 4).rays) == 33124
    cfg_j = tp.tpurt.RenderConfig(**kw)
    cfg = tt.RenderConfig(**kw)
    seed = trng.frame_seed(7, 3)
    jn = tp.jnp
    vis0 = {k: jn.zeros((1, 3)) for k in ("pos", "norm", "wo", "tp")}
    vis0["mat"] = jn.zeros((1,), jn.int32)
    mc_j = _camera(tp.tpurt, True)

    def rays_j():
        return jint.render_tile(
            tp.tpurt.cornell_spheres_scene(), cfg_j, mc_j, jn.asarray([37]),
            jn.asarray([28]), jn.uint32(seed), jn.float32(2.0), 4, vis0)[2]

    assert float(jax.jit(rays_j)()) == 7.0
    with jax.disable_jit():
        assert float(rays_j()) == 4.0
    fs = freeze_scene(tt.cornell_spheres_scene(device=CPU))
    got = integrate.render_tile(
        fs, cfg, integrate.material_table(fs, CPU), _camera(tt, True),
        torch.tensor([37]), torch.tensor([28]), torch.tensor([True]), seed,
        np.float32(2.0), 4, [torch.zeros(1) for _ in range(13)])[2]
    assert int(got) == 4


# ----- the checks of tpurt/render.py:145-160 -----

@pytest.mark.parametrize("backend", BACKENDS)
def test_camera_kind_and_scale_checks(backend):
    kw = dict(width=16, height=8, depth=2, enable_photons=False)
    mc = _camera(tt, True, 2.0)
    with pytest.raises(TypeError, match="MotionCamera"):
        _port_render_cam(backend, dict(kw, motion_blur=True), mc.cam0)
    with pytest.raises(TypeError, match="motion_blur"):
        _port_render_cam(backend, kw, mc)
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="photon_rr_scale"):
            _port_render_cam(backend, dict(kw, photon_rr_scale=bad), mc.cam0)


def _port_render_cam(backend, kw, camera):
    extra = (dict(backend="pallas", pallas_regen=False)
             if backend == "tile-sync" else dict(backend=backend))
    cfg = tt.RenderConfig(wf_pool=256, **extra, **kw)
    return tt.render(tt.cornell_spheres_scene(device=CPU), cfg, camera,
                     tt.init_state(cfg, device=CPU), 1, 1)


def test_qmc_without_context_raises():
    cfg = tt.RenderConfig(width=8, height=4, qmc=True)
    with pytest.raises(ValueError, match="qmc_ctx"):
        integrate.spawn_camera(cfg, _camera(tt, False), torch.arange(4),
                               torch.zeros(4, dtype=torch.int64), 1)


# ----- the kernels' spawn instances (GPU only) -----

GPU_FLAGS = {
    "quality": dict(hero_wavelengths=4, qmc=True),
    "fast": dict(hero_wavelengths=4, qmc=True, photon_rr_scale=0.5),
    "all": FLAGS["all"],
    "dof": dict(LENS),
}


@pytest.mark.gpu
@pytest.mark.parametrize("flags", list(GPU_FLAGS))
def test_regen_and_step_spawn_instances_match_plain(cuda, flags):
    """The regen kernel (uniform and budget) and the tile-sync kernel with
    the spawn flags (the reference sampler's spawn instance) and tpurt's
    presets (the one with the sampler flags) against their plain versions
    at 64x32, depth 8, K 2: rays and every state plane bit for bit."""
    kw = GPU_FLAGS[flags]
    cfg = tt.RenderConfig(width=W, height=H, depth=8, backend="pallas",
                          k_photons=2, **kw)
    scene = tt.cornell_spheres_scene(device=cuda)
    cam = _camera(tt, cfg.motion_blur)
    fs = freeze_scene(scene)
    planes = state_to_planes(tt.init_state(cfg, device=cuda))
    r0 = radius_after(cfg, 0, 2.0, 3)
    pk, pp = planes.clone(), planes.clone()
    # the reference sampler's spawn instance, or the one with the sampler
    spawn = ("regen_spawn_kernel<true, false>" if "hero_wavelengths" in kw
             else "regen_spawn_kernel<false, false>")
    ran = mega_regen.INSTANCE_LAUNCHES
    before = ran["regen", spawn]
    rk = int(mega_regen.regen_call(scene, cfg, cam, pk, 77, 2, 3, r0, 8))
    rp = int(integrate.render_plain(fs, cfg, cam, pp, 77, 2, 3, r0, 8))
    assert ran["regen", spawn] == before + 1
    assert rk == rp > 0 and torch.equal(pk, pp)
    counts = torch.from_numpy(np.random.default_rng(2).integers(
        0, 5, planes.shape[1]).astype(np.float32)).to(cuda)
    budgets = torch.from_numpy(np.random.default_rng(3).integers(
        0, 3, planes.shape[1])).to(cuda)
    budgets[cfg.n_pixels:] = 0
    pk, pp = planes.clone(), planes.clone()
    rk = int(mega_regen.regen_budget_call(scene, cfg, cam, pk, 77, budgets,
                                          counts))
    rp = int(integrate.render_plain_budget(fs, cfg, cam, pp, 77, budgets,
                                           counts))
    assert rk == rp > 0 and torch.equal(pk, pp)
    pk, pp = planes.clone(), planes.clone()
    before = ran["tile_sync", spawn]
    rk = int(mega_step.step_call(scene, cfg, cam, pk, 77, 5, r0, 8))
    rp = int(integrate.render_plain(fs, cfg, cam, pp, 77, 1, 5, r0, 8))
    assert ran["tile_sync", spawn] == before + 1
    assert rk == rp > 0 and torch.equal(pk, pp)


@pytest.mark.gpu
def test_unit_roulette_scale_is_the_reference(cuda, monkeypatch):
    """The spawn instances' scaled roulette at photon_rr_scale 1 is the
    reference roulette bit for bit: a launch given spawn switches that are
    all off (scale 1) equals the launch without them, on the reference
    sampler's spawn instance and on the one with the sampler flags. The
    launch plans kept on the scene are dropped around the patch, so the
    reference launch builds its own switches (the pool instance on the
    reference sampler, the sampler instance with hero 4)."""
    off = mega_regen.SpawnArgs(rr_scale=1.0)
    scene = tt.cornell_spheres_scene(device=cuda)
    fs = freeze_scene(scene)
    cam = _camera(tt, False)
    ran = mega_regen.INSTANCE_LAUNCHES
    for kw, spawn, ref in (
            ({}, "regen_spawn_kernel<false, false>", "regen_pool_kernel"),
            (dict(hero_wavelengths=4), "regen_spawn_kernel<true, false>",
             "regen_kernel<true, false>")):
        cfg = tt.RenderConfig(width=W, height=H, depth=8, backend="pallas",
                              k_photons=2, **kw)
        planes = state_to_planes(tt.init_state(cfg, device=cuda))
        pa, pb = planes.clone(), planes.clone()
        with monkeypatch.context() as m:
            m.setattr(mega_regen, "spawn_args", lambda *a, **k: off)
            fs.cache.pop("plans", None)
            before = ran["regen", spawn]
            ra = int(mega_regen.regen_call(scene, cfg, cam, pa, 3, 2, 0, 2.0,
                                           8))
            assert ran["regen", spawn] == before + 1
        fs.cache.pop("plans", None)
        before = ran["regen", spawn], ran["regen", ref]
        rb = int(mega_regen.regen_call(scene, cfg, cam, pb, 3, 2, 0, 2.0, 8))
        assert (ran["regen", spawn], ran["regen", ref]) == (before[0],
                                                             before[1] + 1)
        assert ra == rb > 0 and torch.equal(pa, pb)


@pytest.mark.gpu
def test_regen_gleaf_spawn_instances_match_plain(cuda):
    """The G-leaf spawn instances with qmc and the lens on the torus (leaf
    64), on the reference sampler and with hero 4, against render_plain
    with the G sweep, bit for bit."""
    scene = tt.torus_mesh_scene(8, 4, device=cuda)
    cam = tt.make_camera((0.0, 3.0, -6.0), (0.0, 1.5, 0.0), vfov=55.0,
                         aspect_ratio=2.0)
    fs = freeze_scene(scene)
    for hero in (1, 4):
        cfg = tt.RenderConfig(width=W, height=H, depth=8, backend="pallas",
                              k_photons=2, pallas_bvh_leaf=64,
                              pallas_mxu_leaf=True, qmc=True, aperture=0.2,
                              focus_dist=6.0, hero_wavelengths=hero)
        tri = mega_regen.regen_tri_mode(fs, cfg)
        assert tri.kind == "gleaf"
        planes = state_to_planes(tt.init_state(cfg, device=cuda))
        pk, pp = planes.clone(), planes.clone()
        spawn = f"regen_spawn_kernel<{'true' if hero > 1 else 'false'}, true>"
        before = mega_regen.INSTANCE_LAUNCHES["regen", spawn]
        rk = int(mega_regen.regen_call(scene, cfg, cam, pk, 5, 2, 0, 2.0, 8))
        rp = int(integrate.render_plain(fs, cfg, cam, pp, 5, 2, 0, 2.0, 8,
                                        tri))
        assert mega_regen.INSTANCE_LAUNCHES["regen", spawn] == before + 1
        assert rk == rp > 0 and torch.equal(pk, pp)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", ["all", "quality"])
def test_fused_spawn_instances_match_regen(cuda, flags):
    """The fused kernel's spawn instances (the flags alone: the reference
    sampler's; quality: with the sampler flags), uniform and budget, against
    the regen kernel with photons off (the same per-pixel sample order):
    rgb_sum and rays bit for bit; against the plain pool, rays exact and
    the image by the rule."""
    kw = GPU_FLAGS[flags]
    scene = tt.cornell_spheres_scene(device=cuda)
    cfg = tt.RenderConfig(width=W, height=H, depth=8, enable_photons=False,
                          wf_pool=2048, backend="wavefront_fused", **kw)
    cam = _camera(tt, cfg.motion_blur)
    st = tt.init_state(cfg, device=cuda)
    spawn = ("wf_fused", "fused_spawn_kernel<true>" if flags == "quality"
             else "fused_spawn_kernel<false>")
    before = mega_regen.INSTANCE_LAUNCHES[spawn]
    got = wavefront_fused.wavefront_render_fused(scene, cfg, cam, st, 9, 3)
    assert mega_regen.INSTANCE_LAUNCHES[spawn] == before + 1
    planes = state_to_planes(st)
    rays = mega_regen.regen_call(scene, cfg.with_(backend="pallas"), cam,
                                 planes, 9, 3, 0, 2.0, cfg.depth)
    assert int(got.rays) == int(rays) > 0
    assert torch.equal(got.rgb_sum, planes[0:3].T)
    pool = wavefront.wavefront_render(scene, cfg, cam, st, 9, 3)
    assert int(pool.rays) == int(got.rays)
    n = cfg.n_pixels
    _image_rule(got.rgb_sum.cpu().numpy()[:n], pool.rgb_sum.cpu().numpy()[:n])
    budgets = torch.from_numpy(np.random.default_rng(4).integers(
        0, 4, st.n_samples.shape[0])).to(cuda)
    st2 = got
    got_b = wavefront_fused.wavefront_render_budget_fused(
        scene, cfg, cam, st2, 9, budgets, 3)
    planes = state_to_planes(st2)
    counts = st2.n_samples
    rays = mega_regen.regen_budget_call(
        scene, cfg.with_(backend="pallas"), cam, planes, 9,
        torch.where(torch.arange(budgets.shape[0], device=cuda) < n, budgets,
                    0), counts)
    assert int(got_b.rays) - int(got.rays) == int(rays)
    assert torch.equal(got_b.rgb_sum, planes[0:3].T)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", ["all", "quality"])
def test_sweep_spawn_instances_match_step(cuda, flags):
    """Sweeps of the sweep kernel's spawn instances (the flags alone: on
    the reference bounce; quality: with the sampler flags) from a fresh pool
    (every slot spawns) and on, against wavefront._step: every pool plane,
    the control words and n_samples bit for bit; rgb_sum by atomics, so at
    rtol 1e-6."""
    kw = GPU_FLAGS[flags]
    scene = tt.cornell_spheres_scene(device=cuda)
    cfg = tt.RenderConfig(width=48, height=24, depth=4, wf_pool=2048, **kw)
    cam = _camera(tt, cfg.motion_blur, 2.0)
    fs = freeze_scene(scene)
    work = wavefront.PoolWork(camera=cam, base_seed=42, spp=3, it0=5,
                              n_valid=48 * 24)

    def fresh():
        q = cfg.wf_pool
        return (wavefront.new_pool(q, cuda),
                torch.zeros((48 * 24, 3), device=cuda),
                torch.zeros((48 * 24,), device=cuda),
                wavefront.new_ctl(q, True, cuda))

    want, got = fresh(), fresh()
    plain = wavefront.plain_stepper(fs, cfg, work).sweep
    kernel = wavefront_sweep.stepper(fs, cfg, work).sweep
    full = "true" if flags == "quality" else "false"
    spawn = ("wf_sweep", f"pool_step_kernel<{full}, {full}, Sampler, "
                         f"Emission, Spawn>")
    before = mega_regen.INSTANCE_LAUNCHES[spawn]
    for _ in range(3):
        want = plain(*want)
        got = kernel(*got)
        torch.cuda.synchronize()
        for x, y in zip((got[0].pf, got[0].pi, got[0].rng, got[2], got[3]),
                        (want[0].pf, want[0].pi, want[0].rng, want[2],
                         want[3])):
            assert torch.equal(x, y)
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
    assert mega_regen.INSTANCE_LAUNCHES[spawn] == before + 3
