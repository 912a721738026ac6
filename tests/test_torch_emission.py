"""Emission besides the lights in the port: emissive materials (type 3),
the sky (``sky_intensity``, ``sky_temp``, ``sky_color``, ``sky_gradient``,
and on the wavefront tracers the legacy ramp of ``sky_gradient`` alone)
and the per-sample ``radiance_clamp``, on every backend, against tpurt
(tests/test_emissive.py, tests/test_sky.py, tests/test_clamp.py); and, on
a CUDA device, the path kernels' emission instances against their plain
versions.

Tolerances: ray counts exact (the sky, the emitters and the clamp add no
draws and no segments; an emitter ends a camera path and absorbs a
photon, in tpurt and here alike); images by tests/test_golden.py's rule
(median |diff| < 1e-4, fewer than 1% of pixels off by more than 1e-2) on
rgb_sum against tpurt's XLA integrator, which forms the sky's emission and
tint in another op order and builds its hero tables in float32 in the
graph, where the port follows tpurt's kernels and rounds the float64 host
table once; the eager helpers against tpurt's kernel-form ones at rtol
2e-6 (PyTorch and XLA may round exp by an ulp); the port's own backends
bit for bit where they run one function, and where an identity is exact
(the furnace, a huge clamp).

tpurt is imported inside the fixture ``tp``, so the GPU cases (marker
``gpu``) run where JAX is not installed:
``python3 -m pytest tests/test_torch_emission.py -m gpu --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate, wavefront
from tpurt_torch.interop import scene_from_numpy
from tpurt_torch.kernels import mega_regen, mega_step, wavefront_fused
from tpurt_torch.ops import rng as trng
from tpurt_torch.ops import spectra as tspec
from tpurt_torch.render import radius_after, state_to_planes
from tpurt_torch.scene import freeze_scene

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)

MEGA = ("xla", "pallas", "tile-sync")
WF = ("wavefront", "wavefront_pallas", "wavefront_fused")
EMIT_CAM = ((0.0, 1.2, 0.0), (0.0, 1.2, 4.0), 50.0)


@pytest.fixture(scope="module")
def tp():
    import dataclasses

    import jax.numpy as jnp

    import tpurt
    from tpurt.kernels import mega_pallas
    from tpurt.ops import spectra as jspec
    from tpurt.render import init_state, render
    return types.SimpleNamespace(jnp=jnp, tpurt=tpurt, spec=jspec,
                                 mp=mega_pallas, init_state=init_state,
                                 render=render, fields=dataclasses.fields)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_emission.py -m gpu --noconftest")
    return torch.device("cuda")


def _dev(pkg):
    return {"device": CPU} if pkg is tt else {}


def _image_rule(a, b, frac_max=0.01):
    diff = np.abs(a - b)
    frac = (diff.max(axis=-1) > 1e-2).mean()
    print(f"median |diff| {np.median(diff):.3g}, {frac:.2%} pixels > 1e-2")
    assert np.median(diff) < 1e-4
    assert frac < frac_max


def _emitter_scene(pkg, intensity=12.0):
    """tests/test_emissive.py's scene: an emitter above a diffuse floor,
    lit by a point light."""
    return pkg.build_scene(
        materials=[pkg.Material.diffuse((0.7, 0.7, 0.7)),
                   pkg.Material.emissive((1.0, 0.6, 0.2), intensity)],
        spheres=[pkg.Sphere(material_id=0, scale=1000.0,
                            translation=(0, -1000, 0)),
                 pkg.Sphere(material_id=1, scale=0.7,
                            translation=(0, 1.2, 4))],
        lights=[pkg.Light.point((3, 4, 2), (1, 1, 1), 3.0, 5500.0)],
        **_dev(pkg))


def _hero_scene(pkg):
    """tests/test_emissive.py:127: a dispersive glass beside an emitter."""
    return pkg.build_scene(
        materials=[pkg.Material.diffuse((0.7, 0.7, 0.7)),
                   pkg.Material.dielectric(1.5, 0.0),
                   pkg.Material.emissive((0.4, 0.8, 1.0), 8.0)],
        spheres=[pkg.Sphere(material_id=0, scale=1000.0,
                            translation=(0, -1000, 0)),
                 pkg.Sphere(material_id=1, scale=0.8,
                            translation=(-0.9, 1, 4)),
                 pkg.Sphere(material_id=2, scale=0.6,
                            translation=(1.1, 1, 4))],
        lights=[pkg.Light.point((3, 4, 2), (1, 1, 1), 3.0, 5500.0)],
        **_dev(pkg))


def _furnace_scene(pkg):
    """tests/test_sky.py's furnace: an albedo-1 diffuse sphere, no
    light."""
    return pkg.build_scene(
        materials=[pkg.Material.diffuse((1.0, 1.0, 1.0))],
        spheres=[pkg.Sphere(material_id=0, scale=1.0,
                            translation=(0, 0, 3))],
        lights=[], **_dev(pkg))


def _cam(pkg, at=EMIT_CAM, aspect=1.0):
    return pkg.make_camera(at[0], at[1], vfov=at[2], aspect_ratio=aspect)


def _port(scene, backend, seed, spp, **kw):
    """A port render on CPU tensors; tile-sync is backend "pallas" with
    pallas_regen=False."""
    at = kw.pop("_cam", EMIT_CAM)
    extra = dict(backend="pallas", pallas_regen=False) \
        if backend == "tile-sync" else dict(backend=backend)
    cfg = tt.RenderConfig(wf_pool=512, **extra, **kw)
    cam = _cam(tt, at, cfg.width / cfg.height)
    return tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), seed,
                     spp)


def _tpurt_xla(tp, scene, seed, spp, cam=EMIT_CAM, **kw):
    cfg = tp.tpurt.RenderConfig(backend="xla", **kw)
    st = tp.render(scene, cfg, _cam(tp.tpurt, cam, cfg.width / cfg.height),
                   tp.init_state(cfg), seed, spp)
    return int(float(st.rays)), np.asarray(st.rgb_sum)


# ----- the scene and the eager helpers -----

def test_emissive_material_matches_tpurt(tp):
    """Material.emissive folds the intensity into the color, type 3, as
    tpurt's; the scene arrays equal tpurt's, also through interop."""
    want_m = tp.tpurt.Material.emissive((0.4, 0.8, 1.0), 8.0)
    got_m = tt.Material.emissive((0.4, 0.8, 1.0), 8.0)
    assert (got_m.color, got_m.roughness, got_m.ior, got_m.mtype) == \
        (want_m.color, want_m.roughness, want_m.ior, want_m.mtype) and \
        got_m.mtype == 3
    want = _hero_scene(tp.tpurt)
    via = scene_from_numpy({f.name: np.asarray(getattr(want, f.name))
                            for f in tp.fields(want)}, device=CPU)
    mine = _hero_scene(tt)
    for f in tp.fields(tt.Scene):
        a, b = getattr(mine, f.name), getattr(via, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    assert [m.mtype for m in freeze_scene(via).materials] == [0, 1, 3]


@pytest.mark.parametrize("c", [2, 4, 8])
def test_emission_hero_tables_match_tpurt(tp, c):
    """The sky's and the emission base's hero tables are tpurt's host
    tables (mega_regen.py:118, :124) bit for bit."""
    cfg = tt.RenderConfig(sky_intensity=0.7, sky_temp=4500.0)
    np.testing.assert_array_equal(
        tspec.sky_hero_table(cfg, c),
        tp.spec.hero_emission_table((1.0, 1.0, 1.0), 0.7, 4500.0, c))
    np.testing.assert_array_equal(
        tspec.flat_hero_table(c),
        tp.spec.hero_emission_table((1.0, 1.0, 1.0), 1.0, 0.0, c))


@pytest.mark.parametrize("sky", [
    dict(sky_intensity=0.7), dict(sky_intensity=0.7, sky_temp=4500.0),
    dict(sky_intensity=1.3, sky_gradient=True, sky_color=(1.0, 0.5, 0.2))])
def test_eager_sky_helpers_match_tpurt_kernel_form(tp, sky):
    """sky_emission, sky_tint and flat_emission against tpurt's kernel
    forms _sky_em_c, _sky_tint_c and _flat_em_c on 4096 seeded lanes."""
    rs = np.random.default_rng(3)
    lam = rs.uniform(380.0, 780.0, 4096).astype(np.float32)
    d = rs.normal(size=(3, 4096)).astype(np.float32)
    cfg_t, cfg_j = tt.RenderConfig(**sky), tp.tpurt.RenderConfig(**sky)
    lam_t, lam_j = torch.from_numpy(lam), tp.jnp.asarray(lam)
    d_t = tuple(torch.from_numpy(x) for x in d)
    d_j = tuple(tp.jnp.asarray(x) for x in d)
    pairs = [(tspec.sky_emission(cfg_t, lam_t), tp.mp._sky_em_c(cfg_j, lam_j)),
             (tspec.flat_emission(lam_t), tp.mp._flat_em_c(lam_j)),
             (tspec.sky_tint(cfg_t, d_t), tp.mp._sky_tint_c(cfg_j, d_j))]
    for got, want in pairs:
        for g, w in zip(got, want):
            g = np.broadcast_to(np.asarray(g, np.float32), (4096,))
            np.testing.assert_allclose(g, np.broadcast_to(
                np.asarray(w, np.float32), (4096,)), rtol=2e-6, atol=0)


# ----- renders against tpurt's XLA integrator -----

FLAGS = {
    "emitter": ("emitter", {}),
    "sky": ("emitter", dict(sky_intensity=0.2, sky_temp=6500.0,
                            sky_gradient=True, sky_color=(1.0, 0.8, 0.6))),
    "clamp": ("emitter", dict(radiance_clamp=2.0)),
    "hero": ("hero", dict(hero_wavelengths=4, dispersion_in_camera_path=True,
                          sky_intensity=0.2, sky_temp=6500.0,
                          sky_gradient=True, radiance_clamp=2.0)),
}
SCENES = {"emitter": _emitter_scene, "hero": _hero_scene}


@pytest.mark.parametrize("family", ["mega", "wavefront"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_backends_match_tpurt_xla(tp, flags, family):
    """Every ported backend with the flags at 32x32, depth 5, 4 spp
    against tpurt's XLA integrator (photons on, K 2, for the path
    kernels' family; off for the wavefront family): rays exact, the image
    by the rule; the port's backends of a family bit for bit, and
    render_adaptive runs."""
    name, kw = FLAGS[flags]
    base = dict(width=32, height=32, depth=5, k_photons=2,
                max_photon_bounces=3, enable_photons=family == "mega", **kw)
    rays_j, rgb_j = _tpurt_xla(tp, SCENES[name](tp.tpurt), 3, 4, **base)
    scene = SCENES[name](tt)
    got = [_port(scene, b, 3, 4, **base)
           for b in (MEGA if family == "mega" else WF)]
    n = 32 * 32
    for st in got:
        assert int(st.rays) == rays_j > 0
        assert torch.equal(st.rgb_sum[:n], got[0].rgb_sum[:n])
    _image_rule(got[0].rgb_sum.numpy()[:n], rgb_j[:n])
    backend = "pallas" if family == "mega" else "wavefront_fused"
    cfg = tt.RenderConfig(backend=backend, wf_pool=512, **dict(
        base, width=16, height=16))
    st, budgets = tt.render_adaptive(scene, cfg, _cam(tt), 3, spp=4,
                                     pilot_spp=2)
    assert int(st.rays) > 0 and bool(torch.isfinite(st.rgb_sum).all())


# ----- emitters (tests/test_emissive.py) -----

@pytest.mark.parametrize("backend", MEGA + WF)
def test_camera_terminates_at_emitter(backend):
    """An emitter filling the view: one segment per sample on every
    backend, no NEE, no photons; the channel means positive."""
    scene = tt.build_scene(
        materials=[tt.Material.emissive((1.0, 1.0, 1.0), 1.0)],
        spheres=[tt.Sphere(material_id=0, scale=50.0,
                           translation=(0, 1.2, 55))],
        lights=[], device=CPU)
    st = _port(scene, backend, 5, 4, width=16, height=16, depth=30)
    assert int(st.rays) == 16 * 16 * 4
    rad = (st.rgb_sum[:256] / st.n_samples[:256, None]).numpy()
    assert np.isfinite(rad).all() and (rad.mean(0) > 0).all()


def test_emission_is_linear_and_lights_the_floor():
    """Doubling the emitter's intensity doubles the image (emission never
    enters a path decision: the same rays), and the floor is lit by the
    emitter alone (tests/test_emissive.py:43)."""
    out = []
    for intensity in (6.0, 12.0):
        scene = tt.build_scene(
            materials=[tt.Material.diffuse((0.7, 0.7, 0.7)),
                       tt.Material.emissive((1.0, 0.6, 0.2), intensity)],
            spheres=[tt.Sphere(material_id=0, scale=1000.0,
                               translation=(0, -1000, 0)),
                     tt.Sphere(material_id=1, scale=0.7,
                               translation=(0, 1.2, 4))],
            lights=[], device=CPU)
        out.append(_port(scene, "xla", 3, 4, width=32, height=32, depth=5))
    assert int(out[0].rays) == int(out[1].rays) > 0
    img1, img2 = (o.rgb_sum[:1024].numpy().reshape(32, 32, 3) for o in out)
    np.testing.assert_allclose(img2, 2.0 * img1, rtol=1e-5, atol=1e-6)
    em = img2[12:20, 12:20].mean((0, 1))
    assert em[0] > em[1] > em[2] > 0
    assert img2[-6:].mean() > 0.0


def test_emitter_occludes_shadow_rays():
    """A shadow ray through an emitter sees a full occluder
    (tests/test_emissive.py:93), as through a diffuse sphere."""
    scene = tt.build_scene(
        materials=[tt.Material.diffuse((0.7, 0.7, 0.7)),
                   tt.Material.emissive((1.0, 1.0, 1.0), 1.0)],
        spheres=[tt.Sphere(material_id=0, scale=1000.0,
                           translation=(0, -1000, 0)),
                 tt.Sphere(material_id=1, scale=1.0, translation=(0, 2, 0))],
        lights=[], device=CPU)
    fs = freeze_scene(scene)
    o = tuple(torch.tensor([x]) for x in (0.0, 0.01, 0.0))
    up = tuple(torch.tensor([x]) for x in (0.0, 1.0, 0.0))
    atten = integrate._shadow(fs, o, up, torch.tensor([10.0]),
                              torch.tensor([550.0]))
    assert float(atten[0]) == 0.0


def test_photons_are_absorbed_by_emitters(tp):
    """A photon that hits an emitter ends there (tpurt integrate.py:870):
    the photon pass over one set of vispoints traces fewer segments with
    the sphere emissive than with it diffuse, and the whole render's rays
    equal tpurt's."""
    def scene(pkg, emissive):
        mat = (pkg.Material.emissive((1.0, 0.9, 0.8), 2.0) if emissive
               else pkg.Material.diffuse((1.0, 0.9, 0.8)))
        return pkg.build_scene(
            materials=[pkg.Material.diffuse((0.7, 0.7, 0.7)), mat],
            spheres=[pkg.Sphere(material_id=0, scale=1000.0,
                                translation=(0, -1000, 0)),
                     pkg.Sphere(material_id=1, scale=1.5,
                                translation=(0, 2.5, 4))],
            lights=[pkg.Light.point((0, 5, 4), (1, 1, 1), 8.0, 5500.0)],
            **_dev(pkg))
    kw = dict(width=24, height=24, depth=4, k_photons=4, max_photon_bounces=6)
    st = _port(scene(tt, True), "xla", 7, 1, **kw)
    assert int(st.rays) == _tpurt_xla(tp, scene(tp.tpurt, True), 7, 1,
                                      **kw)[0]
    cfg = tt.RenderConfig(**kw)
    rays = []
    for emissive in (True, False):
        fs = freeze_scene(scene(tt, emissive))
        px, py, valid = integrate._pixels(cfg, cfg.n_pixels, CPU)
        vis = list(state_to_planes(st)[3:16, :cfg.n_pixels].unbind(0))
        lam = tspec.sample_wavelength(torch.full((cfg.n_pixels,), 0.4))
        rays.append(int(integrate.trace_photons(
            fs, cfg, integrate.material_table(fs, CPU), lam, 99, px, py,
            vis, 0.5, valid, (torch.zeros(cfg.n_pixels),) * 3)[1]))
    assert 0 < rays[0] < rays[1]


# ----- the sky (tests/test_sky.py) -----

def _lam_of_samples(cfg, seed, spp):
    """(spp, P) wavelengths of every pixel's camera samples: the spawn's
    third draw (2 jitter draws, the pinhole ray draws none)."""
    px, py, _ = integrate._pixels(cfg, cfg.n_pixels, CPU)
    out = []
    for smp in range(spp):
        rng = trng.seed_pixels(trng.frame_seed(seed, smp), px, py)
        for _ in range(2):
            _, rng = trng.rand_1f(rng)
        u, rng = trng.rand_1f(rng)
        out.append(tspec.sample_wavelength(u))
    return out


@pytest.mark.parametrize("backend", ("xla",) + WF)
@pytest.mark.parametrize("c", [1, 4])
def test_furnace_sphere_is_the_sky(backend, c):
    """The furnace (tests/test_sky.py:47) without the wait: an albedo-1
    diffuse sphere under a constant sky returns, sample by sample, the
    sky's radiance at the sample's wavelength (its scatter keeps the
    throughput at exactly 1 and the next segment leaves the convex sphere
    for the sky), so every pixel, sphere or sky, holds the sum of the
    sky's emission over its samples' wavelengths, bit for bit."""
    cfg_kw = dict(width=24, height=24, depth=4, sky_intensity=1.0,
                  hero_wavelengths=c)
    st = _port(_furnace_scene(tt), backend, 11, 3,
               _cam=((0, 0, 0), (0, 0, 3), 45.0), **cfg_kw)
    cfg = tt.RenderConfig(**cfg_kw)
    fs = freeze_scene(_furnace_scene(tt))
    want = torch.zeros((cfg.n_pixels, 3))
    for lam in _lam_of_samples(cfg, 11, 3):
        em = integrate.camera_emission(fs, cfg, lam)[2].sky
        want = want + torch.stack(em, 1)
    hit = int(st.rays) - 3 * cfg.n_pixels   # second segments: sphere hits
    assert hit > 0.1 * 3 * cfg.n_pixels
    assert torch.equal(st.rgb_sum[:cfg.n_pixels], want)


def test_furnace_cross_backend_matches_tpurt(tp):
    """tests/test_sky.py:62 at 32x32, depth 6, 4 spp: the sky adds no
    draws or segments (rays unchanged by the flag and equal to tpurt's),
    a black image without it, the radiance within tpurt's atol 5e-3 of
    tpurt's (the rule's absolute 1e-4 is below an ulp of these sums)."""
    kw = dict(width=32, height=32, depth=6)
    cam = ((0, 0, 0), (0, 0, 3), 45.0)
    rays_j, rgb_j = _tpurt_xla(tp, _furnace_scene(tp.tpurt), 11, 4, cam=cam,
                               sky_intensity=1.0, **kw)
    for backend in MEGA + WF:
        on = _port(_furnace_scene(tt), backend, 11, 4, _cam=cam,
                   sky_intensity=1.0, **kw)
        off = _port(_furnace_scene(tt), backend, 11, 4, _cam=cam, **kw)
        assert int(on.rays) == int(off.rays) == rays_j > 0, backend
        assert float(off.rgb_sum.abs().max()) == 0.0, backend
        # tpurt's own tolerance there: radiance ~300 at atol 5e-3
        np.testing.assert_allclose(on.rgb_sum.numpy()[:1024] / 4,
                                   rgb_j[:1024] / 4, atol=5e-3, rtol=0)


def test_blackbody_and_gradient_tints():
    """tests/test_sky.py:85-120: a 2500 K sky is warm (R > B), a 10000 K
    one cold (B > R); under sky_gradient the upper rows are bluer than the
    lower ones; sky_color (1, 0, 0) leaves G and B exactly 0."""
    means = {}
    for temp in (2500.0, 10000.0):
        st = _port(_furnace_scene(tt), "xla", 11, 4, width=32, height=32,
                   depth=4, sky_intensity=1.0, sky_temp=temp,
                   _cam=((0, 0, 0), (0, 0, 3), 45.0))
        means[temp] = st.rgb_sum[:1024].mean(0).numpy()
    assert means[2500.0][0] > means[2500.0][2]
    assert means[10000.0][2] > means[10000.0][0]
    empty = tt.build_scene(materials=[tt.Material.diffuse((0.5, 0.5, 0.5))],
                           spheres=[], lights=[], device=CPU)
    look = ((0, 0, 0), (0, 0, 1), 90.0)
    st = _port(empty, "xla", 3, 4, width=32, height=32, depth=2,
               sky_intensity=1.0, sky_gradient=True, hero_wavelengths=4,
               _cam=look)
    rad = st.rgb_sum[:1024].numpy().reshape(32, 32, 3)
    top, bot = rad[:8].mean((0, 1)), rad[-8:].mean((0, 1))
    assert top[2] / top[0] > bot[2] / bot[0] * 1.2
    red = _port(empty, "xla", 3, 4, width=32, height=32, depth=2,
                sky_intensity=1.0, sky_color=(1.0, 0.0, 0.0), _cam=look)
    assert float(red.rgb_sum[:1024, 0].mean()) > 0.0
    assert float(red.rgb_sum[:1024, 1:].abs().max()) == 0.0


def test_legacy_gradient_on_the_wavefront_tracers_only(tp):
    """sky_gradient alone: the wavefront tracers add tpurt's legacy RGB
    ramp on a miss (equal to tpurt's pool: rays exact, the image by the
    rule), the path kernels' backends ignore it (the image of a black sky,
    bit for bit), as in tpurt."""
    kw = dict(width=32, height=16, depth=3, enable_photons=False)
    cam = ((0.0, 3.0, -4.0), (0.0, 1.0, 5.0), 55.0)
    from tpurt.wavefront import wavefront_render
    cfg_j = tp.tpurt.RenderConfig(sky_gradient=True, wf_pool=512, **kw)
    want = wavefront_render(tp.tpurt.dispersive_scene(), cfg_j,
                            _cam(tp.tpurt, cam, 2.0), tp.init_state(cfg_j),
                            5, 2)
    scene = tt.dispersive_scene(device=CPU)
    for backend in MEGA + WF:
        on = _port(scene, backend, 5, 2, sky_gradient=True, _cam=cam, **kw)
        off = _port(scene, backend, 5, 2, _cam=cam, **kw)
        assert int(on.rays) == int(off.rays) == int(float(want.rays))
        if backend in WF:
            _image_rule(on.rgb_sum.numpy()[:512],
                        np.asarray(want.rgb_sum)[:512])
            assert not torch.equal(on.rgb_sum, off.rgb_sum)
        else:
            assert torch.equal(on.rgb_sum, off.rgb_sum)


# ----- the clamp (tests/test_clamp.py) -----

CLAMP = dict(width=64, height=32, depth=4, k_photons=2, max_photon_bounces=3)
CORNELL = ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), 60.0)


@pytest.mark.parametrize("backend", ["xla", "wavefront"])
def test_clamp_bounds_each_sample(backend):
    """Each sample is capped channel by channel before it is added: a
    1-spp sum is at most the clamp and at most the unclamped sum, rays
    are unchanged, and the Cornell box has fireflies to cap."""
    scene = tt.cornell_spheres_scene(device=CPU)
    kw = dict(CLAMP, _cam=CORNELL,
              enable_photons=backend == "xla")
    a = _port(scene, backend, 11, 1, radiance_clamp=2.0, **kw).rgb_sum
    st_u = _port(scene, backend, 11, 1, **kw)
    st_c = _port(scene, backend, 11, 1, radiance_clamp=2.0, **kw)
    b = st_u.rgb_sum
    assert torch.equal(a, st_c.rgb_sum)
    assert bool((a <= b + 1e-6).all()) and float(a.max()) <= 2.0
    assert int(st_c.rays) == int(st_u.rays) > 0
    assert not torch.equal(a, b)


@pytest.mark.parametrize("backend", ["xla", "wavefront"])
def test_huge_clamp_is_identity(backend):
    scene = tt.cornell_spheres_scene(device=CPU)
    kw = dict(CLAMP, _cam=CORNELL, enable_photons=backend == "xla")
    st_c = _port(scene, backend, 11, 2, radiance_clamp=1e9, **kw)
    st_u = _port(scene, backend, 11, 2, **kw)
    assert torch.equal(st_c.rgb_sum, st_u.rgb_sum)


# ----- the kernels' emission instances (GPU only) -----

GPU_CASES = {
    # (scene, camera, flags)
    "hero": (_hero_scene, EMIT_CAM,
             dict(hero_wavelengths=4, dispersion_in_camera_path=True,
                  sky_intensity=0.2, sky_temp=6500.0, sky_gradient=True,
                  radiance_clamp=2.0)),
    "reference": (_hero_scene, EMIT_CAM,
                  dict(sky_intensity=0.2, sky_temp=6500.0, sky_gradient=True,
                       radiance_clamp=2.0)),
    "clamp-only": (lambda pkg: pkg.cornell_spheres_scene(**_dev(pkg)),
                   CORNELL, dict(radiance_clamp=1.0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(GPU_CASES))
def test_regen_and_step_emission_instances_match_plain(cuda, which):
    """The regen kernel (uniform and budget) and the tile-sync kernel with
    the emission flags against their plain versions at 64x32: rays and
    every state plane bit for bit."""
    make, at, flags = GPU_CASES[which]
    cfg = tt.RenderConfig(width=64, height=32, depth=8, backend="pallas",
                          k_photons=2, **flags)
    scene = make(tt).to(cuda)
    cam = _cam(tt, at, 2.0)
    fs = freeze_scene(scene)
    planes = state_to_planes(tt.init_state(cfg, device=cuda))
    r0 = radius_after(cfg, 0, 2.0, 3)
    pk, pp = planes.clone(), planes.clone()
    rk = int(mega_regen.regen_call(scene, cfg, cam, pk, 77, 2, 3, r0, 8))
    rp = int(integrate.render_plain(fs, cfg, cam, pp, 77, 2, 3, r0, 8))
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
    before = mega_step.LAUNCHES
    rk = int(mega_step.step_call(scene, cfg, cam, pk, 77, 5, r0, 8))
    rp = int(integrate.render_plain(fs, cfg, cam, pp, 77, 1, 5, r0, 8))
    assert mega_step.LAUNCHES == before + 1
    assert rk == rp > 0 and torch.equal(pk, pp)


@pytest.mark.gpu
def test_regen_gleaf_emission_instance_matches_plain(cuda):
    """tpurt takes pallas_mxu_leaf with the emission flags: the regen
    kernel's G-leaf emission instance against render_plain with the G
    sweep on the torus, bit for bit."""
    cfg = tt.RenderConfig(width=64, height=32, depth=8, backend="pallas",
                          k_photons=2, pallas_bvh_leaf=64,
                          pallas_mxu_leaf=True, sky_intensity=0.5,
                          radiance_clamp=4.0)
    scene = tt.torus_mesh_scene(8, 4, device=cuda)
    cam = tt.make_camera((0.0, 3.0, -6.0), (0.0, 1.5, 0.0), vfov=55.0,
                         aspect_ratio=2.0)
    fs = freeze_scene(scene)
    tri = mega_regen.regen_tri_mode(fs, cfg)
    assert tri.kind == "gleaf"
    planes = state_to_planes(tt.init_state(cfg, device=cuda))
    pk, pp = planes.clone(), planes.clone()
    emit = ("regen", "regen_emit_kernel<true>")   # the G-leaf instance
    before = mega_regen.INSTANCE_LAUNCHES[emit]
    rk = int(mega_regen.regen_call(scene, cfg, cam, pk, 5, 2, 0, 2.0, 8))
    rp = int(integrate.render_plain(fs, cfg, cam, pp, 5, 2, 0, 2.0, 8, tri))
    assert mega_regen.INSTANCE_LAUNCHES[emit] == before + 1
    assert rk == rp > 0 and torch.equal(pk, pp)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [
    dict(sky_gradient=True),
    dict(sky_intensity=0.2, sky_temp=6500.0, radiance_clamp=2.0)])
def test_fused_emission_instance_matches_regen(cuda, flags):
    """The fused kernel's emission instance (reference sampler; the legacy
    ramp, or the sky with the clamp) against the plain pool, rays exact and
    the image by the rule, and, where the path kernels add the same
    emission (not the legacy ramp), against the regen kernel with photons
    off bit for bit."""
    scene = _hero_scene(tt).to(cuda)
    cam = _cam(tt, EMIT_CAM, 2.0)
    cfg = tt.RenderConfig(width=64, height=32, depth=8, enable_photons=False,
                          wf_pool=2048, backend="wavefront_fused", **flags)
    st = tt.init_state(cfg, device=cuda)
    got = wavefront_fused.wavefront_render_fused(scene, cfg, cam, st, 9, 3)
    pool = wavefront.wavefront_render(scene, cfg, cam, st, 9, 3)
    assert int(pool.rays) == int(got.rays) > 0
    n = cfg.n_pixels
    _image_rule(got.rgb_sum.cpu().numpy()[:n], pool.rgb_sum.cpu().numpy()[:n])
    if not cfg.sky_gradient:
        planes = state_to_planes(st)
        mega_regen.regen_call(scene, cfg.with_(backend="pallas"), cam,
                              planes, 9, 3, 0, 2.0, cfg.depth)
        assert torch.equal(got.rgb_sum, planes[0:3].T)
