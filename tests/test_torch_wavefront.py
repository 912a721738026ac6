"""The port's wavefront backends (tpurt_torch.wavefront, the sweep kernel's
and the fused kernel's wrappers) against tpurt's wavefront tracers; and, on
a CUDA device, each kernel against its plain version.

tpurt is imported inside the fixture ``tp`` so the GPU cases (marker
``gpu``) also run where JAX is not installed:
``python3 -m pytest tests/test_torch_wavefront.py -m gpu --noconftest``.

Tolerances:
- ray counts exact (every backend draws the same per-(pixel, sample) PCG
  streams), sample counts exact, PCG states and masks exact;
- one sweep on the same pool against tpurt's XLA _sweep: the discrete
  outputs exact, the throughput at rtol 1e-5, atol 1e-6 (PyTorch and XLA
  round sin/cos/exp differently by an ulp), the other float planes at
  rtol 1e-4, atol 1e-4 and on small spheres only (tpurt's XLA sweep is
  not the kernel-form code the port follows; on the R=1000 walls of
  Cornell and of the dispersive floor, hit points of random rays move by
  up to ~1e-3 with the rounding of |oc|^2 ~ 1e6);
- whole images: the rule of tpurt's own wavefront parity tests
  (tests/test_wavefront.py): fewer than 2% of pixels off by more than 1e-2,
  median |diff| < 1e-4. A dielectric branch flips under float
  reassociation and moves a whole pixel; pool renders also sum a pixel's
  samples in the order their paths end;
- renders of one implementation that only reschedule work (pool size,
  continuation): atol 2e-2, rtol 1e-3 and 1e-5 as in test_wavefront.py;
  the same schedule (dispatch against a direct call): bit-exact.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import wavefront
from tpurt_torch.interop import scene_from_numpy
from tpurt_torch.kernels import wavefront_fused, wavefront_sweep
from tpurt_torch.ops.rng import frame_seed
from tpurt_torch.scene import freeze_scene

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"


def _dev(pkg):
    """device=CPU for the port's scene builders; tpurt's take none."""
    return {"device": CPU} if pkg is tt else {}


# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores that pytest-xdist's workers share
torch.set_num_threads(1)

CORNELL_CAM = dict(look_from=(0.0, 5.0, -12.0), look_at=(0.0, 5.0, 0.0),
                   vfov=60.0)
DISP_CAM = dict(look_from=(0.0, 3.0, -4.0), look_at=(0.0, 1.0, 5.0),
                vfov=55.0)
SCENES = {"cornell": ("cornell_spheres_scene", CORNELL_CAM),
          "dispersive": ("dispersive_scene", DISP_CAM)}
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def tp():
    import jax.numpy as jnp

    import tpurt
    import tpurt.render
    import tpurt.wavefront
    from tpurt.kernels import wavefront_pallas
    return types.SimpleNamespace(jnp=jnp, tpurt=tpurt,
                                 render=sys.modules["tpurt.render"],
                                 wf=sys.modules["tpurt.wavefront"],
                                 wfp=wavefront_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_wavefront.py "
                    "tests/test_torch_adaptive.py -m gpu --noconftest")
    return torch.device("cuda")


def _setup(pkg, scene="cornell", **kw):
    """tpurt's wavefront test setup (48x24, depth 4, photons off) for
    either package."""
    kw = {"width": 48, "height": 24, "depth": 4, "tile_size": 1152,
          "enable_photons": False, **kw}
    name, cam = SCENES[scene]
    return (pkg.RenderConfig(**kw), getattr(pkg, name)(**_dev(pkg)),
            pkg.make_camera(**cam, aspect_ratio=kw["width"] / kw["height"]))


def _image_rule(a, b):
    diff = np.abs(a - b)
    frac = (diff.max(axis=-1) > 1e-2).mean()
    print(f"median |diff| {np.median(diff):.3g}, {frac:.2%} pixels > 1e-2")
    assert np.median(diff) < 1e-4
    assert frac < 0.02


def test_dispersive_scene_equal_through_interop(tp):
    want = tp.tpurt.dispersive_scene()
    got = scene_from_numpy({f.name: np.asarray(getattr(want, f.name))
                            for f in dataclasses.fields(want)}, device=CPU)
    mine = tt.dispersive_scene(device=CPU)
    for f in dataclasses.fields(tt.Scene):
        a, b = getattr(mine, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_frame_seed_tensor_matches_tpurt(tp):
    """The per-slot seed is bit-equal to tpurt.render._frame_seed, also for
    iterations whose Weyl product passes 2**32."""
    rs = np.random.default_rng(0)
    it = np.concatenate([np.arange(64), rs.integers(0, 2 ** 31 - 1, 512)])
    base = 0xDEADBEEF
    want = np.asarray(tp.render._frame_seed(
        tp.jnp.uint32(base), tp.jnp.asarray(it.astype(np.int32))))
    got = frame_seed(base, torch.from_numpy(it))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert frame_seed(base, 37) == int(want[37])


@pytest.mark.parametrize("scene", ["cornell", "dispersive"])
def test_wavefront_matches_tpurt(tp, scene):
    cfg_j, scene_j, cam_j = _setup(tp.tpurt, scene, wf_pool=2048)
    st_j = tp.wf.wavefront_render(scene_j, cfg_j, cam_j,
                                  tp.render.init_state(cfg_j), 42, 3)
    cfg, sc, cam = _setup(tt, scene, wf_pool=2048)
    st = tt.wavefront_render(sc, cfg, cam, tt.init_state(cfg, device=CPU), 42, 3)
    assert int(st.rays) == int(float(st_j.rays)) > 0
    n = cfg.n_pixels
    np.testing.assert_array_equal(st.n_samples.numpy(),
                                  np.asarray(st_j.n_samples))
    _image_rule(st.rgb_sum.numpy()[:n], np.asarray(st_j.rgb_sum)[:n])
    assert st.iteration == 3


@pytest.mark.parametrize("backend", ["xla", "wavefront", "wavefront_pallas",
                                     "wavefront_fused"])
def test_ray_count_14210(backend):
    """Cornell 48x24, depth 4, seed 42, 3 spp, photons off: every backend
    traces tpurt's 14210 segments (tpurt's XLA renderer and its wavefront
    trace 14210 too)."""
    cfg, scene, cam = _setup(tt, wf_pool=2048, pallas_lanes=512,
                             backend=backend)
    st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 3)
    assert int(st.rays) == 14210
    assert bool((st.n_samples[:cfg.n_pixels] == 3.0).all())


def test_pool_size_invariance():
    """The pool capacity changes the schedule, not the result."""
    out = []
    for q in (256, 4096):
        cfg, scene, cam = _setup(tt, wf_pool=q)
        out.append(tt.wavefront_render(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                                       9, 2))
    assert int(out[0].rays) == int(out[1].rays) > 0
    n = cfg.n_pixels
    np.testing.assert_allclose(out[0].rgb_sum.numpy()[:n],
                               out[1].rgb_sum.numpy()[:n], atol=2e-2,
                               rtol=1e-3)


def test_continuation_2_plus_2_equals_4():
    """The second call's samples continue at the carried iteration."""
    cfg, scene, cam = _setup(tt, wf_pool=2048)
    st_a = tt.wavefront_render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 2)
    st_a = tt.wavefront_render(scene, cfg, cam, st_a, 42, 2)
    st_b = tt.wavefront_render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 4)
    assert st_a.iteration == st_b.iteration == 4
    assert int(st_a.rays) == int(st_b.rays) > 0
    n = cfg.n_pixels
    np.testing.assert_allclose(st_a.rgb_sum.numpy()[:n],
                               st_b.rgb_sum.numpy()[:n], atol=1e-5,
                               rtol=1e-5)


def test_every_pixel_gets_spp_samples():
    cfg, scene, cam = _setup(tt, wf_pool=512)   # pool << pixel count
    st = tt.wavefront_render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 7, 2)
    assert bool((st.n_samples[:cfg.n_pixels] == 2.0).all())
    assert bool((st.vis_pos == 0.0).all())      # no photon pass
    assert st.photon_radius == tt.init_state(cfg, device=CPU).photon_radius


def test_slabs_draw_the_whole_image_samples():
    """wavefront_render_slab over two pixel slabs and an all-padding one
    (state rows local, RNG and camera global through pix_offset) traces the
    whole-image render's segments; each slab's image equals the whole
    image's rows up to the order of the splat (rtol 1e-5, atol 1e-5)."""
    cfg, scene, cam = _setup(tt, wf_pool=512)
    whole = tt.wavefront_render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 2)
    n, half = cfg.n_pixels, cfg.n_pixels // 2
    rays = 0
    for off, n_valid in ((0, half), (half, n - half), (n, 0)):
        st = tt.init_state(cfg, device=CPU)
        st = dataclasses.replace(st, rgb_sum=st.rgb_sum[:half].clone(),
                                 n_samples=st.n_samples[:half].clone())
        st = wavefront.wavefront_render_slab(scene, cfg, cam, st, 42, 2, off,
                                             n_valid)
        rays += int(st.rays)
        assert bool((st.n_samples[:n_valid] == 2.0).all())
        assert float(st.n_samples[n_valid:].sum()) == 0.0
        np.testing.assert_allclose(st.rgb_sum[:n_valid].numpy(),
                                   whole.rgb_sum[off:off + n_valid].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert rays == int(whole.rays) > 0


def test_max_sweeps_bounds_the_loop():
    cfg, scene, cam = _setup(tt, wf_pool=512, wf_max_sweeps=3)
    st = tt.wavefront_render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 7, 2)
    assert 0 < int(st.rays) <= 3 * 512 * 2
    assert float(st.n_samples.sum()) < 2 * cfg.n_pixels


@pytest.mark.parametrize("backend", ["wavefront", "wavefront_pallas",
                                     "wavefront_fused"])
def test_render_dispatch(backend):
    """render and render_step route the backend: render equals the
    backend's own entry point bit for bit, render_step takes one sample and
    a depth override previews."""
    cfg, scene, cam = _setup(tt, wf_pool=1024, pallas_lanes=512,
                             backend=backend)
    direct = {"wavefront": tt.wavefront_render,
              "wavefront_pallas": wavefront_sweep.wavefront_render_pallas,
              "wavefront_fused": wavefront_fused.wavefront_render_fused
              }[backend]
    before = (wavefront_sweep.LAUNCHES, wavefront_fused.LAUNCHES)
    st_d = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 2)
    st_w = direct(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 2)
    assert torch.equal(st_d.rgb_sum, st_w.rgb_sum)
    assert int(st_d.rays) == int(st_w.rays) > 0
    step = tt.render_step(scene, cfg, cam, tt.init_state(cfg, device=CPU), 7)
    preview = tt.render_step(scene, cfg, cam, tt.init_state(cfg, device=CPU), 7,
                             depth=1)
    assert step.iteration == preview.iteration == 1
    assert 0 < int(preview.rays) < int(step.rays)
    assert bool(torch.isfinite(tt.resolve_image(cfg, step)).all())
    assert (wavefront_sweep.LAUNCHES, wavefront_fused.LAUNCHES) == before


def test_camera_strata_rejected():
    cfg, scene, cam = _setup(tt, backend="wavefront",
                             camera_strata_bounce=True)
    with pytest.raises(ValueError, match="camera_strata_bounce"):
        tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 1, 1)


def _spheres_scene(pkg):
    """Every slice material and both light types on spheres of radius at
    most 2: hit points are well conditioned (no R=1000 walls, where |oc|^2
    ~ 1e6 leaves a near root that moves by ~1e-3 with the rounding)."""
    mats = [pkg.Material.diffuse((0.7, 0.6, 0.5)),
            pkg.Material.diffuse((0.2, 0.8, 0.3), 0.6),
            pkg.Material.dielectric(1.52, 0.0),
            pkg.Material.dielectric(1.4, 0.09),
            pkg.Material.metal((1.0, 0.71, 0.29), 0.05),
            pkg.Material.metal((0.9, 0.9, 0.9), 0.0)]
    sph = [pkg.Sphere(0, 2.0, (0.0, -1.5, 0.0)),
           pkg.Sphere(1, 1.0, (-2.5, 1.0, 0.5)),
           pkg.Sphere(2, 1.0, (0.0, 1.0, 2.0)),
           pkg.Sphere(3, 0.8, (2.2, 0.8, 0.0)),
           pkg.Sphere(4, 1.0, (1.0, 2.5, -2.0)),
           pkg.Sphere(5, 0.7, (-1.0, 2.8, -1.5))]
    lights = [pkg.Light.point([0.0, 6.0, 0.0], [1.0, 1.0, 1.0], 60.0,
                              5500.0),
              pkg.Light.square_area([4.0, 4.0, 2.0], [-1.0, -0.3, 0.0], 1.5,
                                    [1.0, 1.0, 1.0], 4.0, 3200.0)]
    return pkg.build_scene(mats, sph, [], lights, **_dev(pkg))


POOL_BOX = {"cornell": ((-4.0, 0.5, -4.0), (4.0, 9.5, 4.0)),
            "dispersive": ((-4.0, 0.2, -3.0), (4.0, 4.0, 8.0)),
            "spheres": ((-4.0, -1.0, -4.0), (4.0, 5.0, 4.0))}


def _scene(pkg, scene):
    return (_spheres_scene(pkg) if scene == "spheres"
            else getattr(pkg, SCENES[scene][0])(**_dev(pkg)))


def _seeded_pool(scene: str, q: int, seed: int):
    """A pool of q slots in mid-flight, from numpy: origins in a box around
    the scene, unit directions, throughput, partial radiance, wavelength,
    PCG states, bounces below the depth, ~80% of slots active."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(*POOL_BOX[scene], (q, 3)).astype(np.float32)
    d = rs.normal(size=(q, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return dict(
        o=o, d=d, tp=rs.uniform(0.05, 2.0, (q, 3)).astype(np.float32),
        rad=rs.uniform(0.0, 0.5, (q, 3)).astype(np.float32),
        lam=rs.uniform(380.0, 780.0, q).astype(np.float32),
        rng=rs.integers(0, 2 ** 32, q, dtype=np.uint64).astype(np.uint32),
        bounce=rs.integers(0, 4, q).astype(np.int32),
        active=rs.uniform(size=q) < 0.8,
        pix=rs.integers(0, 1152, q).astype(np.int32))


def _port_pool(a, device="cpu") -> wavefront.WavefrontPool:
    pf = np.concatenate([a["o"].T, a["d"].T, a["tp"].T, a["rad"].T,
                         a["lam"][None]])
    pi = np.stack([a["pix"], a["bounce"], a["active"].astype(np.int32)])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    return wavefront.WavefrontPool(pf=t(pf), pi=t(pi),
                                   rng=t(a["rng"].astype(np.int64)))


def _both_sweeps(tp, scene, q=2048, seed=11):
    """One sweep of tpurt's _sweep and of the port's on the same pool."""
    a = _seeded_pool(scene, q, seed)
    jn = tp.jnp
    pool_j = tp.wf.WavefrontPool(
        pix=jn.asarray(a["pix"]), o=jn.asarray(a["o"]), d=jn.asarray(a["d"]),
        tp=jn.asarray(a["tp"]), rad=jn.asarray(a["rad"]),
        lam=jn.asarray(a["lam"]), rng=jn.asarray(a["rng"]),
        bounce=jn.asarray(a["bounce"]), active=jn.asarray(a["active"]),
        coll=jn.zeros(a["active"].shape, bool))
    want = tp.wf._sweep(_scene(tp.tpurt, scene),
                        tp.tpurt.RenderConfig(depth=4), pool_j)
    got = wavefront._sweep(freeze_scene(_scene(tt, scene)),
                           tt.RenderConfig(depth=4), _port_pool(a))
    return a, got, want


@pytest.mark.parametrize("scene", ["cornell", "dispersive", "spheres"])
def test_sweep_matches_tpurt_sweep(tp, scene):
    """The discrete outputs of one sweep against tpurt's _sweep on the same
    seeded pool, exact: segment count, terminated mask, active, bounce and
    pix planes, the PCG states of the active slots (tpurt also advances the
    dead slots' states, which regeneration overwrites), the wavelength."""
    a, (out, term, rays), (out_j, term_j, rays_j) = _both_sweeps(tp, scene)
    act = a["active"]
    assert int(rays) == int(float(rays_j)) > 0
    np.testing.assert_array_equal(term.numpy(), np.asarray(term_j))
    assert 0.2 < term.numpy().mean() < 0.8
    np.testing.assert_array_equal(out.pi[wavefront.ACTIVE].numpy(),
                                  np.asarray(out_j.active).astype(np.int32))
    np.testing.assert_array_equal(out.pi[wavefront.BOUNCE].numpy(),
                                  np.asarray(out_j.bounce))
    np.testing.assert_array_equal(out.pi[wavefront.PIX].numpy(), a["pix"])
    np.testing.assert_array_equal(out.rng.numpy()[act],
                                  np.asarray(out_j.rng)[act].astype(np.int64))
    np.testing.assert_array_equal(out.rng.numpy()[~act],
                                  a["rng"][~act].astype(np.int64))
    np.testing.assert_array_equal(out.pf[wavefront.LAM].numpy(), a["lam"])
    np.testing.assert_allclose(out.pf[wavefront.TP:wavefront.TP + 3].numpy().T,
                               np.asarray(out_j.tp), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [11, 12])
def test_sweep_planes_match_tpurt_sweep(tp, seed):
    """The float planes of one sweep against tpurt's _sweep on the
    small-sphere scene: rtol 1e-4, atol 1e-4. tpurt's XLA sweep is not the
    kernel-form device code the port follows (another hit-point, GGX and
    refraction op order); measured over 4096 slots: 1.3e-5 in directions,
    1.2e-5 in positions, 2.7e-4 in radiance of magnitude ~10."""
    a, (out, _, _), (out_j, _, _) = _both_sweeps(tp, "spheres", 4096, seed)
    for name, base in (("o", wavefront.O), ("d", wavefront.D),
                       ("tp", wavefront.TP), ("rad", wavefront.RAD)):
        np.testing.assert_allclose(out.pf[base:base + 3].numpy().T,
                                   np.asarray(getattr(out_j, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_sweep_wrapper_on_cpu_runs_plain():
    a = _seeded_pool("dispersive", 512, 5)
    cfg, sc, _ = _setup(tt, "dispersive")
    fs = freeze_scene(sc)
    want = wavefront._sweep(fs, cfg, _port_pool(a))
    before = wavefront_sweep.LAUNCHES
    got = wavefront_sweep.sweep(fs, cfg, _port_pool(a))
    for x, y in zip((got[0].pf, got[0].pi, got[0].rng, got[1], got[2]),
                    (want[0].pf, want[0].pi, want[0].rng, want[1], want[2])):
        assert torch.equal(x, y)
    assert wavefront_sweep.LAUNCHES == before


def test_matches_tpurt_sweep_kernel_interpret(tp):
    """tpurt's pool with its Pallas sweep kernel (interpret mode) against
    the port's wavefront_pallas backend on the dispersive scene."""
    cfg_j, scene_j, cam_j = _setup(tp.tpurt, "dispersive", wf_pool=1024,
                                   pallas_lanes=512)
    st_j = tp.wfp.wavefront_render_pallas(
        scene_j, cfg_j, cam_j, tp.render.init_state(cfg_j), 42, 2,
        interpret=True)
    cfg, sc, cam = _setup(tt, "dispersive", wf_pool=1024, pallas_lanes=512,
                          backend="wavefront_pallas")
    st = tt.render(sc, cfg, cam, tt.init_state(cfg, device=CPU), 42, 2)
    assert int(st.rays) == int(float(st_j.rays)) > 0
    n = cfg.n_pixels
    _image_rule(st.rgb_sum.numpy()[:n], np.asarray(st_j.rgb_sum)[:n])


def test_matches_tpurt_fused_kernel_interpret(tp):
    """tpurt's fused kernel (interpret mode) against the port's
    wavefront_fused backend, on the CPU its plain version."""
    cfg_j, scene_j, cam_j = _setup(tp.tpurt, "dispersive", pallas_lanes=512,
                                   backend="wavefront_fused")
    st_j = tp.wfp.wavefront_render_fused(
        scene_j, cfg_j, cam_j, tp.render.init_state(cfg_j), 42, 2,
        interpret=True)
    cfg, sc, cam = _setup(tt, "dispersive", pallas_lanes=512,
                          backend="wavefront_fused")
    st = tt.render(sc, cfg, cam, tt.init_state(cfg, device=CPU), 42, 2)
    assert int(st.rays) == int(float(st_j.rays)) > 0
    n = cfg.n_pixels
    np.testing.assert_array_equal(st.n_samples.numpy()[:n],
                                  np.asarray(st_j.n_samples)[:n])
    _image_rule(st.rgb_sum.numpy()[:n], np.asarray(st_j.rgb_sum)[:n])


# ----- the CUDA kernels against their plain versions (GPU only) -----

@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["cornell", "dispersive"])
def test_sweep_kernel_matches_plain(cuda, scene):
    """The sweep kernel and wavefront._sweep on the card, on the same
    seeded pool: the same bits on every output plane, the same mask and
    segment count."""
    a = _seeded_pool(scene, 1 << 16, 3)
    cfg, sc, _ = _setup(tt, scene)
    fs = freeze_scene(sc.to(cuda))
    pool = _port_pool(a, cuda)
    before = wavefront_sweep.LAUNCHES
    got = wavefront_sweep.sweep(fs, cfg, pool)
    assert wavefront_sweep.LAUNCHES == before + 1
    want = wavefront._sweep(fs, cfg, pool)
    torch.cuda.synchronize()
    for x, y in zip((got[0].pf, got[0].pi, got[0].rng, got[1], got[2]),
                    (want[0].pf, want[0].pi, want[0].rng, want[1], want[2])):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["wavefront_pallas", "wavefront_fused"])
def test_kernel_backend_matches_plain_pool(cuda, backend):
    """Each kernel's backend against the plain pool on the card, dispersive
    scene at 256x144, depth 8, 2 spp: rays and sample counts exact, the
    image rule."""
    kw = dict(width=256, height=144, depth=8, wf_pool=16384)
    cfg, sc, cam = _setup(tt, "dispersive", **kw)
    sc = sc.to(cuda)
    plain = tt.wavefront_render(sc, cfg, cam, tt.init_state(cfg, cuda),
                                1234, 2)
    kcfg = cfg.with_(backend=backend)
    mod = {"wavefront_pallas": wavefront_sweep,
           "wavefront_fused": wavefront_fused}[backend]
    before = mod.LAUNCHES
    st = tt.render(sc, kcfg, cam, tt.init_state(kcfg, cuda), 1234, 2)
    torch.cuda.synchronize()
    assert mod.LAUNCHES > before
    assert int(st.rays) == int(plain.rays) > 0
    n = cfg.n_pixels
    assert torch.equal(st.n_samples[:n], plain.n_samples[:n])
    _image_rule(st.rgb_sum[:n].cpu().numpy(), plain.rgb_sum[:n].cpu().numpy())
