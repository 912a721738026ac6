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
import functools
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


def _ctl(q, next_sample=0, next_pix=0, go=1, sweeps=0, rays=0):
    ctl = wavefront.new_ctl(q, go, CPU)
    ctl[wavefront.NEXT], ctl[wavefront.NEXT_PIX] = next_sample, next_pix
    ctl[wavefront.SWEEPS], ctl[wavefront.RAYS] = sweeps, rays
    return ctl


def _work(cam, spp=2, **kw):
    return wavefront.PoolWork(camera=cam, base_seed=42, spp=spp,
                              n_valid=48 * 24, **kw)


def test_sweep_wrapper_on_cpu_runs_plain():
    """The sweep kernel's step hook on CPU tensors runs wavefront._step:
    the same pool, image, counts and control words bit for bit, no
    launch."""
    a = _seeded_pool("dispersive", 512, 5)
    cfg, sc, cam = _setup(tt, "dispersive")
    fs = freeze_scene(sc)
    work = _work(cam)
    args = lambda: (_port_pool(a), torch.zeros((1152, 3)),  # noqa: E731
                    torch.zeros((1152,)), _ctl(512, 1, 700, rays=5))
    want = wavefront._step(fs, cfg, work, *args())
    before = wavefront_sweep.LAUNCHES
    got = wavefront_sweep.stepper(fs, cfg, work).sweep(*args())
    for x, y in zip((got[0].pf, got[0].pi, got[0].rng, *got[1:]),
                    (want[0].pf, want[0].pi, want[0].rng, *want[1:])):
        assert torch.equal(x, y)
    assert wavefront_sweep.LAUNCHES == before


def _old_drain(fs, cfg, state, work):
    """The pool loop with one read of the device per sweep: while work is
    pending or a slot is active, at most cfg.wf_max_sweeps times, claim,
    sweep and splat."""
    pool = wavefront.new_pool(cfg.wf_pool, CPU)
    rgb, ns = state.rgb_sum.clone(), state.n_samples.clone()
    ctl = _ctl(cfg.wf_pool)
    rays, sweeps = 0, 0
    while sweeps < cfg.wf_max_sweeps:
        if not bool(work.pending(ctl[wavefront.NEXT]) | pool.active.any()):
            break
        pool, nxt, nxt_pix = wavefront._claim(cfg, work, pool, ctl)
        ctl[wavefront.NEXT], ctl[wavefront.NEXT_PIX] = nxt, nxt_pix
        pool, term, n = wavefront._sweep(fs, cfg, pool)
        pix = pool.pi[wavefront.PIX].long()
        rgb.index_add_(0, pix, torch.where(term[:, None],
                                           pool.pf[wavefront.RAD:
                                                   wavefront.RAD + 3].T, 0.0))
        ns.index_add_(0, pix, term.to(torch.float32))
        rays += int(n)
        sweeps += 1
    return rgb, ns, rays, sweeps


@pytest.mark.parametrize("batch,mode,max_sweeps", [
    (1, "uniform", 100000), (3, "uniform", 100000), (8, "uniform", 100000),
    (1, "budget", 100000), (3, "budget", 100000), (8, "budget", 100000),
    (8, "uniform", 3), (8, "budget", 3)])
def test_batched_loop_test_equals_a_read_per_sweep(monkeypatch, batch, mode,
                                                   max_sweeps):
    """_drain with the loop test read once per batch of sweeps gives the
    loop that reads it every sweep bit for bit (image, counts, rays), also
    when wf_max_sweeps cuts the loop inside a batch; it reads the device
    once per batch."""
    from tpurt_torch import adaptive
    cfg, sc, cam = _setup(tt, wf_pool=256, wf_max_sweeps=max_sweeps)
    fs = freeze_scene(sc)
    state = tt.init_state(cfg, device=CPU)
    if mode == "uniform":
        work = _work(cam)
    else:
        b = torch.from_numpy(np.random.default_rng(3).integers(
            0, 4, state.n_samples.shape[0]))
        b[cfg.n_pixels:] = 0
        order, cum, _ = adaptive._round_major_tables(b, 3)
        work = wavefront.PoolWork(camera=cam, base_seed=42, order=order,
                                  cum=cum, base_counts=state.n_samples.long())
    want_rgb, want_ns, want_rays, sweeps = _old_drain(fs, cfg, state, work)
    reads = []
    live = wavefront._pool_live
    monkeypatch.setattr(wavefront, "_pool_live",
                        lambda ctl: reads.append(1) or live(ctl))
    rgb, ns, ctl = wavefront._drain(
        fs, cfg, state, work,
        functools.partial(wavefront.plain_stepper, batch=batch))
    assert torch.equal(rgb, want_rgb) and torch.equal(ns, want_ns)
    assert int(ctl[wavefront.RAYS]) == want_rays > 0
    assert int(ctl[wavefront.SWEEPS]) == sweeps > 0
    assert max_sweeps > 3 or sweeps == 3
    assert len(reads) == -(-sweeps // batch)


@pytest.mark.parametrize("mode", ["uniform", "budget"])
def test_plain_pool_reads_every_sweep(monkeypatch, mode):
    """The plain step hook takes one sweep per read of the loop test, so
    the plain pool runs no sweep past the end of the loop; the kernel's
    hook enqueues SWEEP_BATCH."""
    from tpurt_torch import adaptive
    cfg, sc, cam = _setup(tt, wf_pool=256)
    fs = freeze_scene(sc)
    state = tt.init_state(cfg, device=CPU)
    if mode == "uniform":
        work = _work(cam)
    else:
        b = torch.from_numpy(np.random.default_rng(4).integers(
            0, 3, state.n_samples.shape[0]))
        b[cfg.n_pixels:] = 0
        order, cum, _ = adaptive._round_major_tables(b, 2)
        work = wavefront.PoolWork(camera=cam, base_seed=42, order=order,
                                  cum=cum, base_counts=state.n_samples.long())
    assert wavefront.plain_stepper(fs, cfg, work).batch == 1
    assert wavefront_sweep.stepper(fs, cfg, work).batch == \
        wavefront_sweep.SWEEP_BATCH > 1
    reads, steps = [], []
    live, step = wavefront._pool_live, wavefront._step
    monkeypatch.setattr(wavefront, "_pool_live",
                        lambda ctl: reads.append(1) or live(ctl))
    monkeypatch.setattr(wavefront, "_step",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    _, _, ctl = wavefront._drain(fs, cfg, state, work,
                                 wavefront.plain_stepper)
    sweeps = int(ctl[wavefront.SWEEPS])
    assert len(reads) == len(steps) == sweeps > 1


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_step_matches_tpurt_regen_sweep_splat(tp, seed):
    """One whole sweep, wavefront._step, against tpurt's pool loop body on
    the same seeded pool in mid flight: _regen_planar, sweep_pallas
    (interpret mode) and the splat. Exact: the segments, the work counters,
    the pix and active planes, the bounce planes and PCG states of the
    slots that took the bounce (tpurt also counts a bounce for the others,
    the port leaves their planes alone), the wavelengths, n_samples. The
    float planes and the image at rtol 1e-4, atol 1e-4 (tpurt's kernel runs
    as XLA ops here), on the small-sphere scene (on an R=1000 wall hit
    points of random rays move by up to ~1e-3, and a shadow test with
    them)."""
    wfp, jnp = tp.wfp, tp.jnp
    scene = "spheres"
    q, n_pix, spp = 2048, 48 * 24, 2
    a = _seeded_pool(scene, q, seed)
    kw = dict(width=48, height=24, depth=4, pallas_lanes=512,
              enable_photons=False)
    cam_kw = dict(**DISP_CAM, aspect_ratio=2.0)
    # tpurt: emission planes of the slots in flight, as its regen fills them
    scene_j = _scene(tp.tpurt, scene)
    cfg_j = tp.tpurt.RenderConfig(**kw)
    from tpurt.integrate import light_emission_rgb
    ems = light_emission_rgb(scene_j, jnp.asarray(a["lam"]))
    planar = lambda x: jnp.asarray(x).reshape(-1, q // 128, 128)  # noqa
    pf = planar(np.concatenate(
        [a["o"].T, a["d"].T, a["tp"].T, a["rad"].T, a["lam"][None]]
        + [np.asarray(e).T for e in ems]))
    pi = planar(np.stack([a["pix"], a["bounce"],
                          a["active"].astype(np.int32)]))
    rng = planar(a["rng"])[0]
    pf, pi, rng, nxt, nxt_pix = wfp._regen_planar(
        scene_j, cfg_j, tp.tpurt.make_camera(**cam_kw), pf, pi, rng,
        jnp.int32(0), jnp.int32(700), jnp.int32(spp), jnp.uint32(42), 3)
    live_j = np.asarray(pi[2]).reshape(-1) > 0
    pf, pi, rng, term, trays = wfp.sweep_pallas(
        wfp.freeze_scene(scene_j), cfg_j, pf, pi, rng, interpret=True)
    t = np.asarray(term).reshape(-1) > 0
    pix = np.asarray(pi[0]).reshape(-1)
    rad = np.asarray(pf[wavefront.RAD:wavefront.RAD + 3]).reshape(3, -1).T
    rgb_j = np.zeros((n_pix, 3), np.float32)
    ns_j = np.zeros((n_pix,), np.float32)
    np.add.at(rgb_j, pix[t], rad[t])
    np.add.at(ns_j, pix[t], 1.0)
    # the port
    cfg = tt.RenderConfig(**kw)
    work = wavefront.PoolWork(camera=tt.make_camera(**cam_kw), base_seed=42,
                              spp=spp, it0=3, n_valid=n_pix)
    pool0 = _port_pool(a)
    pool, rgb, ns, ctl = wavefront._step(
        freeze_scene(_scene(tt, scene)), cfg, work, pool0,
        torch.zeros((n_pix, 3)), torch.zeros((n_pix,)), _ctl(q, 0, 700))
    assert int(ctl[wavefront.RAYS]) == int(np.asarray(trays).sum()) > 0
    assert (int(ctl[wavefront.NEXT]), int(ctl[wavefront.NEXT_PIX])) == \
        (int(nxt), int(nxt_pix))
    assert int(ctl[wavefront.SWEEPS]) == 1 and int(ctl[wavefront.GO]) == 1
    flat = lambda x: np.asarray(x).reshape(x.shape[0], -1)  # noqa: E731
    pi_j, pf_j = flat(pi), flat(pf)
    for row in (wavefront.PIX, wavefront.ACTIVE):
        np.testing.assert_array_equal(pool.pi[row].numpy(), pi_j[row])
    np.testing.assert_array_equal(pool.pi[wavefront.BOUNCE].numpy()[live_j],
                                  pi_j[wavefront.BOUNCE][live_j])
    np.testing.assert_array_equal(
        pool.pi[wavefront.BOUNCE].numpy()[~live_j], a["bounce"][~live_j])
    np.testing.assert_array_equal(
        pool.rng.numpy()[live_j],
        np.asarray(rng).reshape(-1).astype(np.int64)[live_j])
    np.testing.assert_array_equal(pool.pf[wavefront.LAM].numpy(),
                                  pf_j[wavefront.LAM])
    np.testing.assert_array_equal(ns.numpy(), ns_j)
    for name, base in (("o", wavefront.O), ("d", wavefront.D),
                       ("tp", wavefront.TP), ("rad", wavefront.RAD)):
        np.testing.assert_allclose(pool.pf[base:base + 3].numpy(),
                                   pf_j[base:base + 3], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(rgb.numpy(), rgb_j, rtol=1e-4, atol=1e-4)


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
    """One launch of the sweep kernel and wavefront._step on the card, on
    the same seeded pool in mid flight with work pending: the same bits on
    every pool plane and control word, the same image and counts (each
    path here is a distinct pixel: the seeded slots hold rows 0-16383, the
    claims start at row 20000), then the same after a second sweep."""
    q = 1 << 14
    a = _seeded_pool(scene, q, 3)
    a["pix"] = np.arange(q, dtype=np.int32)
    cfg, sc, cam = _setup(tt, scene, width=256, height=144)
    fs = freeze_scene(sc.to(cuda))
    work = wavefront.PoolWork(camera=cam, base_seed=42, spp=1,
                              n_valid=cfg.n_pixels)
    rows = cfg.n_pixels
    ctl = _ctl(q, 0, 20000).to(cuda)
    start = (_port_pool(a, cuda), torch.zeros((rows, 3), device=cuda),
             torch.zeros((rows,), device=cuda), ctl)
    got = [t.clone() for t in (start[0].pf, start[0].pi, start[0].rng,
                               *start[1:])]
    got = (wavefront.WavefrontPool(*got[:3]), *got[3:])
    want = start
    step = wavefront_sweep.stepper(fs, cfg, work).sweep
    for _ in range(2):
        before = wavefront_sweep.LAUNCHES
        got = step(*got)
        assert wavefront_sweep.LAUNCHES == before + 1
        want = wavefront._step(fs, cfg, work, *want)
        torch.cuda.synchronize()
        for x, y in zip((got[0].pf, got[0].pi, got[0].rng, *got[1:]),
                        (want[0].pf, want[0].pi, want[0].rng, *want[1:])):
            assert torch.equal(x, y)


@pytest.mark.gpu
def test_sweep_kernel_budget_matches_plain(cuda):
    """The budget pool through the sweep kernel against the plain budget
    pool on the card, dispersive scene at 256x144, depth 8: rays and
    sample counts exact, the image rule."""
    from tpurt_torch import adaptive
    kw = dict(width=256, height=144, depth=8, wf_pool=16384)
    cfg, sc, cam = _setup(tt, "dispersive", **kw)
    sc = sc.to(cuda)
    st0 = tt.init_state(cfg, cuda)
    b = torch.from_numpy(np.random.default_rng(8).integers(
        0, 4, st0.n_samples.shape[0])).to(cuda)
    b[cfg.n_pixels:] = 0
    plain = adaptive.wavefront_render_budget(sc, cfg, cam, st0, 42, b, 3)
    before = wavefront_sweep.LAUNCHES
    st = adaptive.wavefront_render_budget(sc, cfg, cam, st0, 42, b, 3,
                                          step=wavefront_sweep.stepper)
    torch.cuda.synchronize()
    assert wavefront_sweep.LAUNCHES > before
    assert int(st.rays) == int(plain.rays) > 0
    assert torch.equal(st.n_samples, plain.n_samples)
    n = cfg.n_pixels
    _image_rule(st.rgb_sum[:n].cpu().numpy(), plain.rgb_sum[:n].cpu().numpy())


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
