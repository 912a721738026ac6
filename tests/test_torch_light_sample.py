"""Many-light NEE in the port: ``light_sample`` "power" and "spatial" (one
light a diffuse hit, chosen in proportion to its power, over the squared
distance to its centre in "spatial", weighed by 1/pmf) against tpurt
(tests/test_light_sample.py); on a CUDA device the path kernels' lights
instances against their plain versions.

Tolerances: ``ops.sampling`` bit for bit against tpurt's (the selection
planes and 1/pmf are one float32 chain in tpurt's order); ray counts exact
against tpurt's XLA integrator on its pinned seeds (55 for camera paths,
99 with photons; every backend draws u_sel and the light sample's pair at
every camera hit); images under tpurt's own cross-backend rule (mean within
5e-3 relative, fewer than 2% of pixels off by more than 1e-3); a kernel
against its plain version on the card: rays and every state plane bit for
bit.

tpurt is imported inside the fixture ``tp``, so the GPU cases (marker
``gpu``) run where JAX is not installed:
``python3 -m pytest tests/test_torch_light_sample.py -m gpu --noconftest``.
"""

import functools
import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import mega_regen, mega_step
from tpurt_torch.ops import sampling
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

CPU = "cpu"
W, H = 32, 16
MODES = ("power", "spatial")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tp():
    import jax.numpy as jnp

    import tpurt
    import tpurt.adaptive
    import tpurt.render
    from tpurt.ops import sampling as jsampling
    ns = types.SimpleNamespace(jnp=jnp, tpurt=tpurt, sampling=jsampling,
                               render=sys.modules["tpurt.render"],
                               adaptive=sys.modules["tpurt.adaptive"])
    ns.xla = functools.cache(functools.partial(_tpurt_xla, ns))
    return ns


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_light_sample.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _scene(pkg, **dev):
    """tests/test_light_sample.py's room under 4 lights of very unequal
    power, two area lights and two points."""
    mats = [pkg.Material.diffuse((0.73, 0.73, 0.73)),
            pkg.Material.diffuse((0.65, 0.30, 0.30))]
    sph = [pkg.Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
           pkg.Sphere(0, 1000.0, (0.0, 1012.0, 0.0)),
           pkg.Sphere(1, 1.5, (0.0, 1.5, 5.0)),
           pkg.Sphere(0, 1.0, (-2.5, 1.0, 4.0))]
    lights = [
        pkg.Light.square_area([0.0, 9.0, 5.0], [0.0, -1.0, 0.0], 1.5,
                              [1.0, 0.9, 0.8], 20.0, 5500.0),
        pkg.Light.point([4.0, 3.0, 2.0], [0.2, 0.4, 1.0], 0.5, 0.0),
        pkg.Light.point([-4.0, 2.0, 6.0], [1.0, 0.2, 0.2], 2.0, 0.0),
        pkg.Light.square_area([3.0, 7.0, 8.0], [0.0, -1.0, 0.0], 0.5,
                              [0.5, 1.0, 0.5], 1.0, 3000.0),
    ]
    return pkg.build_scene(mats, sph, [], lights, **dev)


def _dark_scene(pkg, **dev):
    """tests/test_light_sample.py's floor without a light."""
    return pkg.build_scene([pkg.Material.diffuse((0.7, 0.7, 0.7))],
                           [pkg.Sphere(0, 1000.0, (0.0, -1000.0, 0.0))], [],
                           [], **dev)


def _cam(pkg, w=W, h=H):
    return pkg.make_camera((0.0, 3.0, -6.0), (0.0, 1.5, 5.0), vfov=55.0,
                           aspect_ratio=w / h)


def _kw(mode, photons):
    kw = dict(width=W, height=H, depth=3, light_sample=mode, tile_size=512,
              pallas_lanes=512, wf_pool=512)
    kw.update(dict(k_photons=1, max_photon_bounces=2) if photons
              else dict(enable_photons=False))
    return kw


def _tpurt_xla(tp, mode, photons, seed):
    """tpurt's XLA integrator on the 4-light scene, 2 spp: (rays, rgb)."""
    cfg = tp.tpurt.RenderConfig(backend="xla", **_kw(mode, photons))
    st = tp.render.render(_scene(tp.tpurt), cfg, _cam(tp.tpurt),
                          tp.render.init_state(cfg), seed, 2)
    return int(float(st.rays)), np.asarray(st.rgb_sum)[:W * H]


def _port(backend, kw, seed, spp=2, scene=_scene):
    extra = (dict(backend="pallas", pallas_regen=False)
             if backend == "tile-sync" else dict(backend=backend))
    cfg = tt.RenderConfig(**kw, **extra)
    return tt.render(scene(tt, device=CPU), cfg, _cam(tt),
                     tt.init_state(cfg, device=CPU), seed, spp)


def _golden_rule(img, ref):
    """tests/test_golden.py's rule with tpurt's 2% bound between backends
    (tests/test_torch_spawn.py says why): median |diff| < 1e-4, fewer
    than 2% of pixels off by more than 1e-2."""
    diff = np.abs(img - ref)
    med, frac = float(np.median(diff)), float((diff.max(-1) > 1e-2).mean())
    print(f"median |diff| {med:.3g}, {frac:.2%} pixels > 1e-2")
    assert med < 1e-4 and frac < 0.02


def _cross_backend_rule(img, ref):
    """tests/test_light_sample.py's image rule between backends."""
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 5e-3 * max(ref.mean(), 1e-3)
    diverged = np.abs(img - ref).max(axis=-1) > 1e-3
    print(f"{diverged.mean():.2%} pixels off by more than 1e-3")
    assert diverged.mean() < 0.02


# ----- ops.sampling against tpurt's, bit for bit -----

def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("n", [1, 4, 17])
def test_light_powers_match_tpurt(tp, n):
    r = np.random.default_rng(n)
    inten = r.uniform(0.0, 30.0, n).astype(np.float32)
    hws = r.uniform(0.0, 2.0, n).astype(np.float32)
    areas = list(r.random(n) < 0.5)
    got = sampling.light_powers(inten, hws, areas)
    want = tp.sampling.light_powers(list(inten), list(hws), areas)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _u_sel(n_lanes, seed):
    u = np.random.default_rng(seed).random(n_lanes).astype(np.float32)
    # the ends of [0, 1): u 0 and u within an ulp of 1 (the open bucket)
    u[:2] = (0.0, np.float32(1.0) - np.float32(6e-8))
    return u


@pytest.mark.parametrize("planes", [False, True], ids=["scalars", "planes"])
@pytest.mark.parametrize("n", [1, 3, 17])
def test_select_from_powers_matches_tpurt(tp, n, planes):
    """The selection planes and 1/pmf, from float32 scalar powers (mode
    "power") or per-lane planes (mode "spatial"), some of them 0 (the
    1e-20 floor) and some tiny beside the total (buckets an ulp wide)."""
    r = np.random.default_rng(100 + n)
    u = _u_sel(4096, n)
    if planes:
        pw = r.uniform(0.0, 5.0, (n, u.size)).astype(np.float32)
        pw[:, ::7] = 0.0
        pw[0, ::5] = 1e-30
        powers_t = [torch.from_numpy(p) for p in pw]
        powers_j = [tp.jnp.asarray(p) for p in pw]
    else:
        pw = r.uniform(0.0, 5.0, n).astype(np.float32)
        pw[::3] = 0.0
        powers_t = list(pw)
        powers_j = [np.float32(p) for p in pw]
    sels, inv = sampling.select_from_powers(torch.from_numpy(u), powers_t)
    sels_j, inv_j = tp.sampling.select_from_powers(tp.jnp.asarray(u),
                                                   powers_j)
    got = np.stack([s.numpy() for s in sels])
    want = np.stack([np.broadcast_to(np.asarray(s), u.shape) for s in sels_j])
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=0) == 1).all()
    np.testing.assert_array_equal(_bits(inv.numpy()), _bits(inv_j))


def test_select_chain_matches_tpurt(tp):
    r = np.random.default_rng(3)
    u = _u_sel(512, 3)
    pw = [np.float32(x) for x in r.uniform(0.1, 4.0, 5)]
    sels, _ = sampling.select_from_powers(torch.from_numpy(u), pw)
    sels_j, _ = tp.sampling.select_from_powers(tp.jnp.asarray(u), pw)
    rows = r.normal(size=(5, 1, 3)).astype(np.float32)
    planes = r.normal(size=(5, u.size)).astype(np.float32)
    for vals in (rows, planes, list(r.normal(size=5).astype(np.float32))):
        got = sampling.select_chain(sels, [torch.as_tensor(v) for v in vals])
        want = tp.sampling.select_chain(sels_j, [tp.jnp.asarray(v)
                                                 for v in vals])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_light_select_power_frequencies():
    """tests/test_light_sample.py's unit case: the selection frequencies
    are the powers' shares, 1/pmf the selected share's inverse, and u
    within an ulp of 1 still selects one light."""
    inten = [np.float32(10.0), np.float32(0.5), np.float32(2.0)]
    hws = [np.float32(1.5), np.float32(0.0), np.float32(0.0)]
    areas = [True, False, False]
    powers = np.array([10.0 * 4 * 1.5 * 1.5, 0.5, 2.0])
    pmf = powers / powers.sum()
    n = 200_000
    u = torch.from_numpy(((np.arange(n) + 0.5) / n).astype(np.float32))
    sels, inv = sampling.light_select_power(u, inten, hws, areas)
    sels = np.stack([s.numpy() for s in sels])
    assert (sels.sum(axis=0) == 1).all()
    np.testing.assert_allclose(sels.mean(axis=1), pmf, atol=2e-4)
    np.testing.assert_allclose(inv.numpy(), (1.0 / pmf)[sels.argmax(0)],
                               rtol=1e-5)
    top, _ = sampling.light_select_power(
        torch.tensor([np.float32(1.0) - np.float32(6e-8)]), inten, hws,
        areas)
    assert sum(bool(s[0]) for s in top) == 1


# ----- renders against tpurt's XLA integrator -----

@pytest.mark.parametrize("backend", ["xla", "pallas", "tile-sync",
                                     "wavefront", "wavefront_pallas",
                                     "wavefront_fused"])
@pytest.mark.parametrize("mode", MODES)
def test_camera_paths_match_tpurt_xla(tp, mode, backend):
    """tests/test_light_sample.py's cross-backend case (32x16, depth 3,
    photons off, seed 55, 2 spp): each backend of the port (on the CPU,
    the kernels' plain versions) against tpurt's XLA integrator, rays
    exact and tpurt's image rule."""
    rays_j, img_j = tp.xla(mode, False, 55)
    st = _port(backend, _kw(mode, False), 55)
    print(f"rays {int(st.rays)} vs tpurt {rays_j}")
    assert int(st.rays) == rays_j > 0
    _cross_backend_rule(st.rgb_sum.numpy()[:W * H], img_j)


@pytest.mark.parametrize("backend", ["xla", "pallas", "tile-sync"])
@pytest.mark.parametrize("mode", MODES)
def test_photons_match_tpurt_xla(tp, mode, backend):
    """With the photon pass (K 1, 2 photon bounces, seed 99): the camera
    path's 3 NEE draws leave the photon streams as they are."""
    rays_j, img_j = tp.xla(mode, True, 99)
    st = _port(backend, _kw(mode, True), 99)
    print(f"rays {int(st.rays)} vs tpurt {rays_j}")
    assert int(st.rays) == rays_j > 0
    _cross_backend_rule(st.rgb_sum.numpy()[:W * H], img_j)


def test_one_shadow_segment_per_diffuse_hit():
    """tests/test_light_sample.py's floor under 3 lights at depth 1: both
    modes hit the same diffuse lanes, so rays = N + L*D in mode "all" and
    N + D in mode "power"."""
    def floor(pkg, **dev):
        lights = [pkg.Light.point([0.0, 5.0, 0.0], [1, 1, 1], 5.0, 0.0),
                  pkg.Light.point([3.0, 2.0, 0.0], [1, 1, 1], 1.0, 0.0),
                  pkg.Light.square_area([0.0, 6.0, 5.0], [0.0, -1.0, 0.0],
                                        1.0, [1, 1, 1], 2.0, 0.0)]
        return pkg.build_scene([pkg.Material.diffuse((0.7, 0.7, 0.7))],
                               [pkg.Sphere(0, 1000.0, (0.0, -1000.0, 0.0))],
                               [], lights, **dev)
    rays = {m: int(_port("xla", dict(width=W, height=H, depth=1,
                                     enable_photons=False, light_sample=m),
                         7, 1, floor).rays) for m in ("all", "power")}
    d = rays["power"] - W * H
    assert 0 < d <= W * H
    assert rays["all"] == W * H + 3 * d


@pytest.mark.parametrize("backend", ["xla", "pallas", "wavefront_fused"])
def test_no_light_draws_nothing(tp, backend):
    """A scene without a light: NEE is off in every mode (no draw, no
    shadow segment), so every mode traces the camera segments of "all",
    as tpurt's XLA integrator does."""
    kw = dict(width=W, height=H, depth=2, enable_photons=False,
              tile_size=512, pallas_lanes=512, wf_pool=512)
    cfg_j = tp.tpurt.RenderConfig(backend="xla", **kw)
    st_j = tp.render.render(_dark_scene(tp.tpurt), cfg_j, _cam(tp.tpurt),
                            tp.render.init_state(cfg_j), 7, 1)
    states = [_port(backend, dict(kw, light_sample=m), 7, 1, _dark_scene)
              for m in ("all", "power", "spatial")]
    assert {int(s.rays) for s in states} == {int(float(st_j.rays))}
    assert int(states[0].rays) > 0
    for s in states[1:]:
        assert torch.equal(s.rgb_sum, states[0].rgb_sum)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_adaptive_matches_tpurt(tp, backend):
    """render_adaptive under "spatial" (48x24, depth 3, photons off, spp
    8, pilot 4, seed 11), the mode passed to the pilots and the budget
    pass. On the plain pool ("xla") the budgets, sample counts and rays
    are tpurt's exactly, the image (sums of up to 8 + 64 samples) by the
    golden rule; tpurt runs "pallas"
    through its jitted regen kernel, whose pilots XLA contracts otherwise
    (ROADMAP C3): there at most 1% of the budgets differ, by one sample,
    and the rays by no more than those samples' longest paths."""
    kw = dict(width=48, height=24, depth=3, tile_size=1152,
              enable_photons=False, light_sample="spatial", wf_pool=1024)
    cfg_j = tp.tpurt.RenderConfig(backend=backend, pallas_lanes=512, **kw)
    st_j, b_j = tp.adaptive.render_adaptive(
        _scene(tp.tpurt), cfg_j, _cam(tp.tpurt, 48, 24), 11, 8, 4)
    cfg = tt.RenderConfig(backend=backend, **kw)
    st, b = tt.render_adaptive(_scene(tt, device=CPU), cfg,
                               _cam(tt, 48, 24), 11, 8, 4)
    n = cfg.n_pixels
    b, b_j = b.numpy()[:n].astype(np.int64), np.asarray(b_j)[:n]
    np.testing.assert_array_equal(st.n_samples.numpy()[:n], 4 + b)
    if backend == "xla":
        np.testing.assert_array_equal(b, b_j)
        assert int(st.rays) == int(float(st_j.rays)) > 0
        _golden_rule(st.rgb_sum.numpy()[:n], np.asarray(st_j.rgb_sum)[:n])
        return
    off = np.abs(b - b_j)
    print(f"{(off > 0).sum()} of {off.size} budgets differ")
    assert off.max() <= 1 and (off > 0).mean() <= 0.01
    assert abs(int(st.rays) - int(float(st_j.rays))) \
        <= int(off.sum()) * cfg.depth * 2


def test_light_sample_validated():
    with pytest.raises(ValueError, match="light_sample"):
        _port("xla", dict(width=W, height=H, light_sample="bogus"), 1, 1)
    with pytest.raises(ValueError, match="light_sample"):
        tt.render_adaptive(_scene(tt, device=CPU),
                           tt.RenderConfig(width=W, height=H,
                                           backend="wavefront",
                                           light_sample="nearest"),
                           _cam(tt), 1, 4, 2)


def test_modes_need_no_launch_switch_when_off():
    """Mode "all" without photon_aim keeps every launch on the instances
    it ran before (no lights switches); "power" on a camera-path kernel
    takes them, a photon_aim there does not (no photons)."""
    assert mega_regen.lights_args(tt.RenderConfig()) is None
    a = mega_regen.lights_args(tt.RenderConfig(light_sample="spatial"))
    assert (a.mode, a.q) == (2, 0.0)
    a = mega_regen.lights_args(tt.RenderConfig(photon_aim=0.5,
                                               photon_aim_widen=2.0))
    assert (a.mode, a.q, a.widen) == (0, 0.5, 2.0)
    assert mega_regen.lights_args(tt.RenderConfig(photon_aim=0.5),
                                  photons=False) is None


def test_table_carries_the_selection_power():
    """The light rows' slot L_SEL_POWER (35) holds ops.sampling's power."""
    fs = freeze_scene(_scene(tt, device=CPU))
    cfg = tt.RenderConfig()
    table = mega_regen.pack_scene(fs, cfg)
    n_mat = len(fs.materials)
    start = mega_regen.CAM_FLOATS + 8 * len(fs.spheres) + \
        mega_regen.MAT_STRIDE * n_mat
    rows = table[start:start + 40 * len(fs.lights)].reshape(-1, 40)
    want = np.array([sampling.light_power(lt) for lt in fs.lights],
                    np.float32)
    np.testing.assert_array_equal(rows[:, 35], want)


# ----- the kernels on the card -----

@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_lights", [20, 128])
def test_lights_kernels_match_plain(cuda, mode, n_lights):
    """tpurt's many-light scene (20 lights staged, 128 read from global
    memory) at 128x72, depth 6: the regen kernel's lights instance against
    render_plain (every plane bit for bit), the tile-sync kernel against
    render_plain at one sample, the fused kernel against the regen kernel
    with photons off (rgb_sum and rays bit for bit)."""
    from tpurt_torch.kernels import wavefront_fused
    scene = tt.many_light_scene(n_lights, device=cuda)
    fs = freeze_scene(scene)
    cfg = tt.RenderConfig(width=128, height=72, depth=6, k_photons=2,
                          max_photon_bounces=3, light_sample=mode,
                          backend="pallas")
    cam = tt.make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                         aspect_ratio=128 / 72)
    planes = state_to_planes(tt.init_state(cfg, cuda))
    lights = ("regen", "regen_lights_kernel<false, false>")
    n0 = mega_regen.INSTANCE_LAUNCHES[lights]
    pk, pp = planes.clone(), planes.clone()
    rk = mega_regen.regen_call(scene, cfg, cam, pk, 5, 2, 0, 2.0, 6)
    rp = integrate.render_plain(fs, cfg, cam, pp, 5, 2, 0, 2.0, 6)
    assert int(rk) == int(rp) > 0 and torch.equal(pk, pp)
    assert mega_regen.INSTANCE_LAUNCHES[lights] == n0 + 1
    pk, pp = planes.clone(), planes.clone()
    rk = mega_step.step_call(scene, cfg, cam, pk, 5, 1, 1.5, 6)
    rp = integrate.render_plain(fs, cfg, cam, pp, 5, 1, 1, 1.5, 6)
    assert int(rk) == int(rp) > 0 and torch.equal(pk, pp)
    c = cfg.with_(enable_photons=False)
    st0 = tt.init_state(c, cuda)
    pr = state_to_planes(st0)
    rr = mega_regen.regen_call(scene, c, cam, pr, 5, 2, 0, 2.0, 6)
    sf = wavefront_fused.wavefront_render_fused(
        scene, c.with_(backend="wavefront_fused"), cam, st0, 5, 2)
    assert int(sf.rays) == int(rr) and torch.equal(sf.rgb_sum, pr[0:3].T)
