"""``photon_rr_scale`` in the port: the photon walks' Russian roulette
thinned by a scale s in (0, 1] (survive with min(prob, 1) * s, reweight by
1 / (prob * s)), against tpurt (tests/test_photon_rr.py); on a CUDA device
the path kernels' spawn instances against their plain versions.

Tolerances: the roulette step bit for bit against tpurt's kernel form
(``mega_pallas.scatter_rr_c``) on smooth metal hits, whose scatter takes
no transcendental; ray counts exact against tpurt's XLA integrator on its
pinned seeds; images with the median |diff| < 1e-4 of tests/test_golden.py
and fewer than 2% of pixels off by more than 1e-2, the bound tpurt's own
cross-backend tests use (tests/test_torch_spawn.py says why); the mean
radiance of scale 0.5 within 5% of scale 1 at 128 spp, as tpurt holds it.

tpurt is imported inside the fixture ``tp``, so the GPU cases (marker
``gpu``) run where JAX is not installed:
``python3 -m pytest tests/test_torch_photon_rr.py -m gpu --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import mega_regen, mega_step, wavefront_fused
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

CPU = "cpu"
W, H = 32, 16

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tp():
    import jax.numpy as jnp

    import tpurt
    from tpurt.kernels import mega_pallas
    from tpurt.ops import rng as jrng
    return types.SimpleNamespace(jnp=jnp, tpurt=tpurt, mp=mega_pallas,
                                 rng=jrng)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_photon_rr.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _photon_scene(pkg, **dev):
    """tests/test_photon_rr.py's closed diffuse scene under a bright area
    light: photon walks live long enough for the roulette to end them."""
    mats = [pkg.Material.diffuse((0.80, 0.80, 0.80)),
            pkg.Material.diffuse((0.70, 0.35, 0.35))]
    sph = [pkg.Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
           pkg.Sphere(0, 1000.0, (0.0, 1012.0, 0.0)),
           pkg.Sphere(1, 1.5, (0.0, 1.5, 5.0)),
           pkg.Sphere(0, 1.0, (-2.5, 1.0, 4.0))]
    lights = [pkg.Light.square_area([0.0, 9.0, 5.0], [0.0, -1.0, 0.0], 1.5,
                                    [1.0, 0.9, 0.8], 20.0, 5500.0)]
    return pkg.build_scene(mats, sph, [], lights, **dev)


def _cam(pkg):
    return pkg.make_camera((0.0, 3.0, -6.0), (0.0, 1.5, 5.0), vfov=55.0,
                           aspect_ratio=W / H)


def _render(pkg, backend, seed, spp, **kw):
    dev = {"device": CPU} if pkg is tt else {}
    extra = (dict(backend="pallas", pallas_regen=False)
             if backend == "tile-sync" else dict(backend=backend))
    cfg = pkg.RenderConfig(width=W, height=H, tile_size=512,
                           pallas_lanes=512, **extra, **kw)
    st = pkg.render(_photon_scene(pkg, **dev), cfg, _cam(pkg),
                    pkg.init_state(cfg, **dev), seed, spp)
    return int(float(st.rays)), np.asarray(st.rgb_sum)[:W * H]


def _image_rule(a, b):
    diff = np.abs(a - b)
    med, frac = float(np.median(diff)), float((diff.max(-1) > 1e-2).mean())
    print(f"median |diff| {med:.3g}, {frac:.2%} pixels > 1e-2")
    assert med < 1e-4
    assert frac < 0.02


def test_scale_reduces_segments_like_tpurt(tp):
    """tests/test_photon_rr.py:55 (depth 4, K 2, 6 bounces, seed 77, 4
    spp): smaller scales trace strictly fewer segments, each count equal
    to tpurt's."""
    kw = dict(depth=4, k_photons=2, max_photon_bounces=6)
    rays = {}
    for scale in (1.0, 0.5, 0.25):
        rays_j, _ = _render(tp.tpurt, "xla", 77, 4, photon_rr_scale=scale,
                            **kw)
        rays[scale], _ = _render(tt, "xla", 77, 4, photon_rr_scale=scale,
                                 **kw)
        assert rays[scale] == rays_j
    assert 0 < rays[0.25] < rays[0.5] < rays[1.0]


@pytest.mark.parametrize("backend", ["xla", "pallas", "tile-sync"])
def test_cross_backend_matches_tpurt(tp, backend):
    """tests/test_photon_rr.py:88 (depth 3, K 2, 4 bounces, scale 0.5, seed
    99, 2 spp): every photon backend of the port against tpurt's XLA
    integrator, rays exact, the image by the rule."""
    kw = dict(depth=3, k_photons=2, max_photon_bounces=4,
              photon_rr_scale=0.5)
    rays_j, rgb_j = _render(tp.tpurt, "xla", 99, 2, **kw)
    rays, rgb = _render(tt, backend, 99, 2, **kw)
    assert rays == rays_j > 0
    _image_rule(rgb, rgb_j)


def test_unbiased_against_the_reference_roulette():
    """The thinned roulette converges to the reference's image: mean
    radiance per channel within 5% at 128 spp, seed 345 (tests/
    test_photon_rr.py:75)."""
    kw = dict(depth=4, k_photons=2, max_photon_bounces=6)
    means = {}
    for scale in (1.0, 0.5):
        _, rgb = _render(tt, "xla", 345, 128, photon_rr_scale=scale, **kw)
        img = rgb / 128.0
        assert np.isfinite(img).all()
        means[scale] = img.mean(axis=0)
    np.testing.assert_allclose(means[0.5], means[1.0], rtol=0.05)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25])
def test_roulette_step_matches_tpurt_kernel_form(tp, scale):
    """scatter_and_rr on photon lanes against tpurt's scatter_rr_c with its
    rr_scale_fn (None at scale 1, as tpurt's kernels emit it), on 4096
    seeded smooth-metal hits with throughputs below and above 1: the
    survivors, the continuation and the reweighted throughput bit for
    bit."""
    g = np.random.default_rng(int(scale * 100))
    n = 4096

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    nrm = unit(g.normal(size=(n, 3))).astype(np.float32)
    wo = unit(nrm + 0.8 * g.normal(size=(n, 3))).astype(np.float32)
    loc = g.normal(size=(n, 3)).astype(np.float32)
    color = g.uniform(0.2, 0.95, (n, 3)).astype(np.float32)
    tp_in = g.uniform(0.001, 3.0, (n, 3)).astype(np.float32)
    rng0 = g.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    cfg = tt.RenderConfig(photon_rr_scale=scale)
    col = lambda a: tuple(torch.from_numpy(a[:, c]) for c in range(3))  # noqa
    wi, new_tp, new_o, ok, live, rng = integrate.scatter_and_rr(
        cfg, col(wo), col(nrm), col(loc), col(color),
        torch.zeros(n), torch.full((n,), 1.5), torch.zeros(n, dtype=bool),
        torch.ones(n, dtype=bool), col(tp_in),
        torch.from_numpy(rng0.astype(np.int64)), camera_path=False,
        any_dielectric=False, any_metal=True)
    jn = tp.jnp
    jc = lambda a: tuple(jn.asarray(a[:, c]) for c in range(3))  # noqa
    out = tp.mp.scatter_rr_c(
        tp.tpurt.RenderConfig(photon_rr_scale=scale), jc(wo), jc(nrm),
        jc(loc), jc(color), jn.zeros(n), jn.zeros(n, bool),
        jn.ones(n, bool), jc(tp_in), jn.asarray(rng0),
        any_dielectric=False, any_metal=True,
        eta_fn=lambda: jn.full((n,), 1.5), camera_pdf=False,
        rr_thresh_fn=lambda: np.float32(cfg.photon_rr_threshold),
        rr_scale_fn=None if scale == 1.0
        else (lambda: jn.float32(scale)))
    for got, want in ((wi, out[0]), (new_tp, out[1]), (new_o, out[2])):
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(),
                                          np.asarray(want[c]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(out[3]))
    np.testing.assert_array_equal(live.numpy(), np.asarray(out[4]))
    np.testing.assert_array_equal(rng.numpy(),
                                  np.asarray(out[5]).astype(np.int64))
    assert 0.1 < live.float().mean() < 0.95


def test_budget_entry_points_check_the_scale():
    """The budget entry points refuse a scale outside (0, 1] too."""
    cfg = tt.RenderConfig(width=8, height=4, backend="pallas",
                          photon_rr_scale=1.5)
    st = tt.init_state(cfg, device=CPU)
    with pytest.raises(ValueError, match="photon_rr_scale"):
        mega_regen.render_budget_regen(
            _photon_scene(tt, device=CPU), cfg, _cam(tt), st, 1,
            torch.ones_like(st.n_samples, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="photon_rr_scale"):
        tt.wavefront_render_budget(
            _photon_scene(tt, device=CPU), cfg.with_(backend="wavefront"),
            _cam(tt), st, 1, torch.ones_like(st.n_samples,
                                             dtype=torch.int64), 1)


def test_camera_kernels_take_no_scale_switch():
    """The scale travels in the spawn switches of the kernels that walk
    photons; a camera-path kernel (photons=False), which walks none, takes
    no spawn switch for the scale alone and stays on its instance without
    them; with a spawn flag beside it its scale is 1."""
    cfg = tt.RenderConfig(width=W, height=H, photon_rr_scale=0.5)
    args = mega_regen.spawn_args(cfg, _cam(tt), CPU)
    assert (args.qmc, args.motion, args.lens) == (0, 0, 0)
    assert args.rr_scale == 0.5
    assert mega_regen.spawn_args(cfg, _cam(tt), CPU, photons=False) is None
    both = mega_regen.spawn_args(cfg.with_(qmc=True), _cam(tt), CPU,
                                 photons=False)
    assert (both.qmc, both.rr_scale) == (1, 1.0)


@pytest.mark.gpu
def test_fused_kernel_ignores_the_scale(cuda):
    """The fused kernel with photon_rr_scale alone runs the instance
    without spawn switches and equals the launch without the scale."""
    cfg = tt.RenderConfig(width=W, height=H, depth=4, enable_photons=False,
                          backend="wavefront_fused")
    scene = _photon_scene(tt, device=cuda)
    st = tt.init_state(cfg, device=cuda)
    ref = ("wf_fused", "fused_kernel")
    before = mega_regen.INSTANCE_LAUNCHES[ref]
    a = wavefront_fused.wavefront_render_fused(
        scene, cfg.with_(photon_rr_scale=0.5), _cam(tt), st, 7, 2)
    assert mega_regen.INSTANCE_LAUNCHES[ref] == before + 1
    b = wavefront_fused.wavefront_render_fused(scene, cfg, _cam(tt), st, 7, 2)
    assert int(a.rays) == int(b.rays) > 0
    assert torch.equal(a.rgb_sum, b.rgb_sum)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.5, 0.25])
def test_kernels_match_plain_with_the_scale(cuda, scale):
    """The regen kernel (uniform and budget) and the tile-sync kernel with
    photon_rr_scale alone on the photon scene (K 2, 6 bounces) against
    their plain versions: rays and every state plane bit for bit."""
    cfg = tt.RenderConfig(width=W, height=H, depth=4, backend="pallas",
                          k_photons=2, max_photon_bounces=6,
                          photon_rr_scale=scale)
    scene = _photon_scene(tt, device=cuda)
    fs = freeze_scene(scene)
    planes = state_to_planes(tt.init_state(cfg, device=cuda))
    pk, pp = planes.clone(), planes.clone()
    spawn = ("regen", "regen_spawn_kernel<false, false>")
    before = mega_regen.INSTANCE_LAUNCHES[spawn]
    rk = int(mega_regen.regen_call(scene, cfg, _cam(tt), pk, 77, 3, 0, 2.0,
                                   4))
    rp = int(integrate.render_plain(fs, cfg, _cam(tt), pp, 77, 3, 0, 2.0, 4))
    assert mega_regen.INSTANCE_LAUNCHES[spawn] == before + 1
    assert rk == rp > 0 and torch.equal(pk, pp)
    budgets = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4, planes.shape[1])).to(cuda)
    budgets[cfg.n_pixels:] = 0
    counts = torch.full((planes.shape[1],), 2.0, device=cuda)
    pk, pp = planes.clone(), planes.clone()
    rk = int(mega_regen.regen_budget_call(scene, cfg, _cam(tt), pk, 77,
                                          budgets, counts))
    rp = int(integrate.render_plain_budget(fs, cfg, _cam(tt), pp, 77,
                                           budgets, counts))
    assert rk == rp > 0 and torch.equal(pk, pp)
    pk, pp = planes.clone(), planes.clone()
    rk = int(mega_step.step_call(scene, cfg, _cam(tt), pk, 77, 4, 1.5, 4))
    rp = int(integrate.render_plain(fs, cfg, _cam(tt), pp, 77, 1, 4, 1.5, 4))
    assert rk == rp > 0 and torch.equal(pk, pp)
