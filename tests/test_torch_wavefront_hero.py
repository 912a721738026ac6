"""Hero wavelengths and camera-path dispersion on the port's wavefront
tracers (``backend="wavefront"``, ``"wavefront_pallas"``,
``"wavefront_fused"``, and the budget pool of ``render_adaptive``) against
tpurt's, with the sky, emissive materials and the radiance clamp on the
same slots; and, on a CUDA device, the sweep and fused kernels' sampler
instances against their plain versions.

Tolerances:
- ray counts exact: hero wavelengths add no draws, and the port's eager
  wavelength ``380 + u * 400`` equals tpurt's on these pinned seeds, also
  against tpurt's jitted pool (ROADMAP C3: XLA may contract it into a
  fused multiply-add and move the wavelength by an ulp; no test here
  shows a flipped path);
- one sweep on the same seeded pool against tpurt's XLA ``_sweep``: the
  discrete outputs exact (segments, terminated mask, active flags,
  collapse bits of the slots that go on, bounces, PCG states), the float
  planes at rtol 1e-4, atol 1e-4 on small spheres only, as
  tests/test_torch_wavefront.py holds them (tpurt's XLA sweep is not the
  kernel-form code the port follows, and it builds its hero tables in
  float32 in the graph where the port rounds the float64 host table
  once);
- whole images: tests/test_golden.py's rule as tests/test_torch_wavefront.py
  applies it (median |diff| < 1e-4, fewer than 2% of pixels off by more
  than 1e-2);
- the port's own backends: bit for bit where they run one function (the
  wrappers on CPU tensors), rays exact and the image rule between the
  pool and the path integrator, which sum a pixel's samples in another
  order.

tpurt is imported inside the fixture ``tp``, so the GPU cases (marker
``gpu``) run where JAX is not installed:
``python3 -m pytest tests/test_torch_wavefront_hero.py -m gpu --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import adaptive, integrate, wavefront
from tpurt_torch.kernels import mega_regen, wavefront_fused, wavefront_sweep
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)

W, H = 64, 32
DISP_CAM = ((0.0, 3.0, -4.0), (0.0, 1.0, 5.0))
HERO = dict(hero_wavelengths=4, dispersion_in_camera_path=True)
EMIT = dict(sky_intensity=0.3, sky_temp=6500.0, sky_gradient=True,
            radiance_clamp=3.0)
WF = ("wavefront", "wavefront_pallas", "wavefront_fused")


@pytest.fixture(scope="module")
def tp():
    import sys

    import jax.numpy as jnp

    import tpurt
    import tpurt.render
    import tpurt.wavefront
    from tpurt.ops.spectra import hero_emission_table_jnp
    return types.SimpleNamespace(
        jnp=jnp, tpurt=tpurt, render=sys.modules["tpurt.render"],
        wf=sys.modules["tpurt.wavefront"], hero_table=hero_emission_table_jnp)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_wavefront_hero.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _dev(pkg):
    return {"device": CPU} if pkg is tt else {}


def _image_rule(a, b):
    diff = np.abs(a - b)
    frac = (diff.max(axis=-1) > 1e-2).mean()
    print(f"median |diff| {np.median(diff):.3g}, {frac:.2%} pixels > 1e-2")
    assert np.median(diff) < 1e-4
    assert frac < 0.02


def _render(scene, cam, backend, seed, spp, **kw):
    cfg = tt.RenderConfig(width=W, height=H, depth=3, enable_photons=False,
                          wf_pool=2048, backend=backend, **kw)
    return tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), seed,
                     spp)


@pytest.mark.parametrize("flags", ["hero", "hero+emission"])
@pytest.mark.parametrize("seed", [9, 77])
def test_wavefront_hero_matches_tpurt(tp, flags, seed):
    """tpurt's shape (tests/test_hero_wavelengths.py:63, the dispersive
    scene at 64x32, depth 3, 2 spp, photons off): the port's three
    wavefront backends against tpurt's jitted pool and its XLA
    integrator, rays exact; the image by the rule; the port's backends bit
    for bit (on CPU tensors the kernels' wrappers run the plain pool)."""
    kw = dict(HERO, **(EMIT if flags == "hero+emission" else {}))
    cfg_j = tp.tpurt.RenderConfig(width=W, height=H, depth=3,
                                  enable_photons=False, wf_pool=2048, **kw)
    cam_j = tp.tpurt.make_camera(*DISP_CAM, vfov=55.0, aspect_ratio=W / H)
    want = tp.wf.wavefront_render(tp.tpurt.dispersive_scene(), cfg_j, cam_j,
                                  tp.render.init_state(cfg_j), seed, 2)
    want_x = tp.render.render(tp.tpurt.dispersive_scene(), cfg_j, cam_j,
                              tp.render.init_state(cfg_j), seed, 2)
    assert float(want.rays) == float(want_x.rays)
    scene = tt.dispersive_scene(device=CPU)
    cam = tt.make_camera(*DISP_CAM, vfov=55.0, aspect_ratio=W / H)
    got = [_render(scene, cam, b, seed, 2, **kw) for b in WF]
    for st in got:
        assert int(st.rays) == int(float(want.rays)) > 0
        assert torch.equal(st.rgb_sum, got[0].rgb_sum)
        assert torch.equal(st.n_samples, got[0].n_samples)
    n = W * H
    _image_rule(got[0].rgb_sum.numpy()[:n], np.asarray(want.rgb_sum)[:n])
    # the path integrator of the port, photons off: the same streams
    xla = _render(scene, cam, "xla", seed, 2, **kw)
    assert int(xla.rays) == int(got[0].rays)
    _image_rule(got[0].rgb_sum.numpy()[:n], xla.rgb_sum.numpy()[:n])


def test_budget_pool_hero_matches_the_regen_budget_mode():
    """The budget pool (render_adaptive's wavefront phase, and the fused
    kernel's budget wrapper on CPU tensors) with hero wavelengths,
    dispersion and the emission flags: the rays of the regen kernel's
    budget mode with photons off, which draws the same streams; the image
    by the rule."""
    scene = tt.dispersive_scene(device=CPU)
    cam = tt.make_camera(*DISP_CAM, vfov=55.0, aspect_ratio=2.0)
    cfg = tt.RenderConfig(width=32, height=16, depth=4, enable_photons=False,
                          wf_pool=256, backend="wavefront_fused", **HERO,
                          **EMIT)
    st = tt.init_state(cfg, device=CPU)
    b = torch.from_numpy(np.random.default_rng(4).integers(
        0, 4, st.n_samples.shape[0]))
    b[cfg.n_pixels:] = 0
    pool = adaptive.wavefront_render_budget(scene, cfg, cam, st, 21, b, 3)
    fused = wavefront_fused.wavefront_render_budget_fused(scene, cfg, cam, st,
                                                          21, b, 3)
    assert torch.equal(pool.rgb_sum, fused.rgb_sum)
    planes = state_to_planes(st)
    rays = integrate.render_plain_budget(freeze_scene(scene), cfg, cam,
                                         planes, 21, b, st.n_samples)
    assert int(pool.rays) == int(rays) > 0
    n = cfg.n_pixels
    _image_rule(pool.rgb_sum.numpy()[:n], planes[0:3].T.numpy()[:n])


@pytest.mark.parametrize("backend", WF)
def test_render_adaptive_takes_hero_and_emission(backend):
    """render_adaptive on every wavefront backend with hero wavelengths,
    dispersion and the emission flags: one result for all three (on CPU
    tensors they run the same pool)."""
    scene = tt.dispersive_scene(device=CPU)
    cam = tt.make_camera(*DISP_CAM, vfov=55.0, aspect_ratio=2.0)
    out = []
    for be in ("wavefront", backend):
        cfg = tt.RenderConfig(width=24, height=12, depth=3,
                              enable_photons=False, wf_pool=256, backend=be,
                              **HERO, **EMIT)
        out.append(tt.render_adaptive(scene, cfg, cam, 5, spp=4,
                                      pilot_spp=2)[0])
    assert int(out[0].rays) == int(out[1].rays) > 0
    assert torch.equal(out[0].rgb_sum, out[1].rgb_sum)
    assert bool(torch.isfinite(out[0].rgb_sum).all())


# ----- one sweep against tpurt's _sweep -----

def _emit_spheres_scene(pkg):
    """Small spheres of every material type, a dispersive glass among
    them and an emitter, under a point and a square light."""
    mats = [pkg.Material.diffuse((0.7, 0.6, 0.5)),
            pkg.Material.dielectric(1.52, 0.0),
            pkg.Material.dielectric(1.4, 0.09),
            pkg.Material.metal((1.0, 0.71, 0.29), 0.05),
            pkg.Material.emissive((0.4, 0.8, 1.0), 8.0)]
    sph = [pkg.Sphere(0, 2.0, (0.0, -1.5, 0.0)),
           pkg.Sphere(1, 1.0, (0.0, 1.0, 2.0)),
           pkg.Sphere(2, 0.8, (2.2, 0.8, 0.0)),
           pkg.Sphere(3, 1.0, (1.0, 2.5, -2.0)),
           pkg.Sphere(4, 0.9, (-2.3, 1.2, 0.4))]
    lights = [pkg.Light.point([0.0, 6.0, 0.0], [1.0, 1.0, 1.0], 60.0,
                              5500.0),
              pkg.Light.square_area([4.0, 4.0, 2.0], [-1.0, -0.3, 0.0], 1.5,
                                    [1.0, 1.0, 1.0], 4.0, 3200.0)]
    return pkg.build_scene(mats, sph, [], lights, **_dev(pkg))


def _seeded_pool(q, seed):
    """A pool of q slots in mid-flight, from numpy (as in
    tests/test_torch_wavefront.py), with a random collapse bit on a third
    of the slots."""
    rs = np.random.default_rng(seed)
    o = rs.uniform((-4.0, -1.0, -4.0), (4.0, 5.0, 4.0), (q, 3))
    d = rs.normal(size=(q, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return dict(
        o=o.astype(np.float32), d=d.astype(np.float32),
        tp=rs.uniform(0.05, 2.0, (q, 3)).astype(np.float32),
        rad=rs.uniform(0.0, 0.5, (q, 3)).astype(np.float32),
        lam=rs.uniform(380.0, 780.0, q).astype(np.float32),
        rng=rs.integers(0, 2 ** 32, q, dtype=np.uint64).astype(np.uint32),
        bounce=rs.integers(0, 4, q).astype(np.int32),
        active=rs.uniform(size=q) < 0.8,
        coll=rs.uniform(size=q) < 1 / 3,
        pix=rs.integers(0, 1152, q).astype(np.int32))


def _port_pool(a, device="cpu"):
    state = np.where(a["active"], np.where(a["coll"], 1 | wavefront.COLLAPSED,
                                           1), 0)
    pf = np.concatenate([a["o"].T, a["d"].T, a["tp"].T, a["rad"].T,
                         a["lam"][None]])
    pi = np.stack([a["pix"], a["bounce"], state]).astype(np.int32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    return wavefront.WavefrontPool(pf=t(pf), pi=t(pi),
                                   rng=t(a["rng"].astype(np.int64)))


def _tpurt_sweep(tp, a, kw):
    jn = tp.jnp
    cfg = tp.tpurt.RenderConfig(depth=4, **kw)
    scene = _emit_spheres_scene(tp.tpurt)
    c = max(1, cfg.hero_wavelengths)
    tabs = None if c == 1 else [
        tp.hero_table(scene.light_color[i], scene.light_intensity[i],
                      scene.light_temp[i], c)
        for i in range(scene.num_lights)]
    pool = tp.wf.WavefrontPool(
        pix=jn.asarray(a["pix"]), o=jn.asarray(a["o"]), d=jn.asarray(a["d"]),
        tp=jn.asarray(a["tp"]), rad=jn.asarray(a["rad"]),
        lam=jn.asarray(a["lam"]), rng=jn.asarray(a["rng"]),
        bounce=jn.asarray(a["bounce"]), active=jn.asarray(a["active"]),
        coll=jn.asarray(a["coll"]))
    return tp.wf._sweep(scene, cfg, pool, tabs)


SWEEP_FLAGS = {
    "hero": HERO,
    "hero+sky": dict(HERO, sky_intensity=0.4, sky_temp=5000.0,
                     sky_gradient=True, sky_color=(1.0, 0.9, 0.7)),
    "legacy": dict(HERO, sky_gradient=True),
    "reference+sky": dict(sky_intensity=0.4, dispersion_in_camera_path=True),
}


@pytest.mark.parametrize("flags", list(SWEEP_FLAGS))
@pytest.mark.parametrize("seed", [11, 12])
def test_sweep_planes_match_tpurt_sweep_hero(tp, flags, seed):
    """One sweep of the plain _sweep against tpurt's _sweep on one seeded
    pool with hero tables, collapse bits, the sky (or the legacy ramp) and
    an emitter: discrete outputs exact, float planes at rtol 1e-4, atol
    1e-4."""
    kw = SWEEP_FLAGS[flags]
    a = _seeded_pool(4096, seed)
    out_j, term_j, rays_j = _tpurt_sweep(tp, a, kw)
    out, term, rays = wavefront._sweep(
        freeze_scene(_emit_spheres_scene(tt)), tt.RenderConfig(depth=4, **kw),
        _port_pool(a))
    act = a["active"]
    cont = np.asarray(out_j.active)
    assert int(rays) == int(float(rays_j)) > 0
    np.testing.assert_array_equal(term.numpy(), np.asarray(term_j))
    assert 0.2 < term.numpy().mean() < 0.8
    np.testing.assert_array_equal(out.active.numpy(), cont)
    # the collapse bit of the slots that go on (a dead slot's is cleared
    # when it claims work; tpurt keeps it)
    np.testing.assert_array_equal(out.coll.numpy()[cont],
                                  np.asarray(out_j.coll)[cont])
    if flags != "reference+sky":
        assert (np.asarray(out_j.coll)[cont] & ~a["coll"][cont]).any()
    np.testing.assert_array_equal(out.pi[wavefront.BOUNCE].numpy(),
                                  np.asarray(out_j.bounce))
    np.testing.assert_array_equal(out.rng.numpy()[act],
                                  np.asarray(out_j.rng)[act].astype(np.int64))
    for name, base in (("o", wavefront.O), ("d", wavefront.D),
                       ("tp", wavefront.TP), ("rad", wavefront.RAD)):
        np.testing.assert_allclose(out.pf[base:base + 3].numpy().T,
                                   np.asarray(getattr(out_j, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # ended paths gain radiance on the emitter and, with a sky, on misses
    gain = (out.pf[wavefront.RAD:wavefront.RAD + 3].numpy().T
            - a["rad"]).sum(1)[act & term.numpy()]
    assert (gain != 0).mean() > (0.2 if "sky" in flags or flags == "legacy"
                                 else 0.0)


def test_collapse_keeps_full_hero_weight():
    """A collapsed slot carries the hero wavelength alone at full weight
    (tests/test_hero_wavelengths.py:101): one sweep of a pool whose slots
    all collapsed, C = 4, equals the same sweep at C = 1 on every plane
    (the lights', the sky's and the emitter's emission alike, no 1/C), and
    differs from the sweep of the uncollapsed pool."""
    fs = freeze_scene(_emit_spheres_scene(tt))
    a = _seeded_pool(2048, 5)
    sky = dict(sky_intensity=0.4, sky_temp=5000.0,
               dispersion_in_camera_path=True)
    outs = {}
    for name, c, coll in (("c4-collapsed", 4, True), ("c1", 1, False),
                          ("c4", 4, False)):
        a["coll"] = np.full_like(a["active"], coll)
        outs[name] = wavefront._sweep(
            fs, tt.RenderConfig(depth=4, hero_wavelengths=c, **sky),
            _port_pool(a))[0]
    got, want, apart = outs["c4-collapsed"], outs["c1"], outs["c4"]
    assert torch.equal(got.pf, want.pf) and torch.equal(got.rng, want.rng)
    assert torch.equal(got.active, want.active)
    assert not torch.equal(apart.pf, want.pf)


# ----- the kernels' sampler instances (GPU only) -----

def _seeded_step_args(a, device, rows=1152):
    q = a["rng"].shape[0]
    ctl = wavefront.new_ctl(q, True, device)
    ctl[wavefront.NEXT], ctl[wavefront.NEXT_PIX] = 1, 700
    return (_port_pool(a, device), torch.zeros((rows, 3), device=device),
            torch.zeros((rows,), device=device), ctl)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", ["hero", "hero+emission"])
def test_sweep_kernel_sampler_instance_matches_step(cuda, flags):
    """One sweep of the sweep kernel's sampler instance (and with the
    emission flags its emission instance) on a seeded pool with collapse
    bits against wavefront._step: every pool plane, the control words and
    n_samples bit for bit; rgb_sum by atomics, so at rtol 1e-6."""
    kw = dict(HERO, **(EMIT if flags == "hero+emission" else {}))
    scene = _emit_spheres_scene(tt).to(cuda)
    cfg = tt.RenderConfig(width=48, height=24, depth=4, **kw)
    cam = tt.make_camera(*DISP_CAM, vfov=55.0, aspect_ratio=2.0)
    fs = freeze_scene(scene)
    work = wavefront.PoolWork(camera=cam, base_seed=42, spp=2,
                              n_valid=48 * 24)
    a = _seeded_pool(4096, 3)
    want = wavefront._step(fs, cfg, work, *_seeded_step_args(a, cuda))
    before = wavefront_sweep.LAUNCHES
    got = wavefront_sweep.stepper(fs, cfg, work).sweep(
        *_seeded_step_args(a, cuda))
    torch.cuda.synchronize()
    assert wavefront_sweep.LAUNCHES == before + 1
    for x, y in zip((got[0].pf, got[0].pi, got[0].rng, got[2], got[3]),
                    (want[0].pf, want[0].pi, want[0].rng, want[2],
                     want[3])):
        assert torch.equal(x, y)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", ["hero", "hero+emission"])
def test_fused_sampler_instance_matches_regen(cuda, flags):
    """The fused kernel's sampler instance (with the emission flags its
    emission instance) against the regen kernel with photons off, which
    adds each pixel's samples in the same order: rgb_sum and rays bit for
    bit; against the plain pool, rays exact and the image by the rule."""
    kw = dict(HERO, **(EMIT if flags == "hero+emission" else {}))
    scene = tt.dispersive_scene(device=cuda)
    cam = tt.make_camera(*DISP_CAM, vfov=55.0, aspect_ratio=2.0)
    cfg = tt.RenderConfig(width=64, height=32, depth=8, enable_photons=False,
                          wf_pool=2048, backend="wavefront_fused", **kw)
    st = tt.init_state(cfg, device=cuda)
    before = wavefront_fused.LAUNCHES
    got = wavefront_fused.wavefront_render_fused(scene, cfg, cam, st, 9, 3)
    assert wavefront_fused.LAUNCHES == before + 1
    planes = state_to_planes(st)
    rays = mega_regen.regen_call(scene, cfg.with_(backend="pallas"), cam,
                                 planes, 9, 3, 0, 2.0, cfg.depth)
    assert int(got.rays) == int(rays) > 0
    assert torch.equal(got.rgb_sum, planes[0:3].T)
    pool = wavefront.wavefront_render(scene, cfg, cam, st, 9, 3)
    assert int(pool.rays) == int(got.rays)
    n = cfg.n_pixels
    _image_rule(got.rgb_sum.cpu().numpy()[:n], pool.rgb_sum.cpu().numpy()[:n])
