"""Aimed photon emission in the port: ``photon_aim`` q and
``photon_aim_widen`` (an area light's photon aims at the pixel's vispoint
with probability q, inside the cone that subtends widen * radius there,
its throughput weighed by the defensive mixture p_cos / p_mix), against
tpurt (tests/test_photon_aim.py); on a CUDA device the regen kernel's
lights instances against their plain versions.

Tolerances: ``ops.soa.aimed_cone_c`` and ``aim_mixture_weight_c`` bit for
bit against tpurt's given the same cosine and sine (PyTorch's CPU cos and
sin and XLA's differ by an ulp on ~5% of inputs, so the direction is held
with tpurt's own transcendentals patched in, and within 2**-23 of its
norm without); the mixture's normalization and the cone's geometry as
tpurt holds them; ray counts exact against tpurt's XLA integrator and its
regen kernel on the pinned seed 99; images under tpurt's cross-backend
rule (mean within 5e-3 relative, fewer than 2% of pixels off by more than
1e-3); a kernel against its plain version on the card: rays and every
state plane bit for bit.

tpurt is imported inside the fixture ``tp``, so the GPU cases (marker
``gpu``) run where JAX is not installed:
``python3 -m pytest tests/test_torch_photon_aim.py -m gpu --noconftest``.
"""

import functools
import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import mega_regen
from tpurt_torch.ops import soa
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

CPU = "cpu"
W, H = 32, 16

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tp():
    import jax.numpy as jnp

    import tpurt
    import tpurt.adaptive
    import tpurt.render
    from tpurt.ops import soa as jsoa
    ns = types.SimpleNamespace(jnp=jnp, tpurt=tpurt, soa=jsoa,
                               render=sys.modules["tpurt.render"],
                               adaptive=sys.modules["tpurt.adaptive"])
    ns.ref = functools.cache(functools.partial(_tpurt_render, ns))
    return ns


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_photon_aim.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _room(pkg):
    mats = [pkg.Material.diffuse((0.80, 0.80, 0.80)),
            pkg.Material.diffuse((0.70, 0.35, 0.35))]
    sph = [pkg.Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
           pkg.Sphere(0, 1000.0, (0.0, 1012.0, 0.0)),
           pkg.Sphere(1, 1.5, (0.0, 1.5, 5.0)),
           pkg.Sphere(0, 1.0, (-2.5, 1.0, 4.0))]
    return mats, sph


def _scene(pkg, **dev):
    """tests/test_photon_aim.py's closed room under a bright area light:
    photons are a visible share of the image."""
    lights = [pkg.Light.square_area([0.0, 9.0, 5.0], [0.0, -1.0, 0.0], 1.5,
                                    [1.0, 0.9, 0.8], 20.0, 5500.0)]
    return pkg.build_scene(*_room(pkg), [], lights, **dev)


def _two_light_scene(pkg, **dev):
    """The room with a point light added: photon k of the point light
    draws the aim's 3 numbers and ignores them."""
    lights = [pkg.Light.square_area([0.0, 9.0, 5.0], [0.0, -1.0, 0.0], 1.5,
                                    [1.0, 0.9, 0.8], 20.0, 5500.0),
              pkg.Light.point([3.0, 6.0, 2.0], [0.4, 0.6, 1.0], 8.0, 0.0)]
    return pkg.build_scene(*_room(pkg), [], lights, **dev)


def _cam(pkg, w=W, h=H):
    return pkg.make_camera((0.0, 3.0, -6.0), (0.0, 1.5, 5.0), vfov=55.0,
                           aspect_ratio=w / h)


KW = dict(width=W, height=H, depth=3, photon_aim=0.5, tile_size=512,
          pallas_lanes=512, k_photons=2, max_photon_bounces=4)


def _tpurt_render(tp, backend, scene="one", **kw):
    """tpurt's render of test_photon_aim.py's cross-backend case, seed 99,
    2 spp: (rays, rgb)."""
    mk = _scene if scene == "one" else _two_light_scene
    cfg = tp.tpurt.RenderConfig(backend=backend, **{**KW, **kw})
    st = tp.render.render(mk(tp.tpurt), cfg, _cam(tp.tpurt),
                          tp.render.init_state(cfg), 99, 2)
    return int(float(st.rays)), np.asarray(st.rgb_sum)[:W * H]


def _port(backend, seed=99, spp=2, scene=_scene, **kw):
    cfg = tt.RenderConfig(backend=backend, **{**KW, **kw})
    return tt.render(scene(tt, device=CPU), cfg, _cam(tt),
                     tt.init_state(cfg, device=CPU), seed, spp)


def _cross_backend_rule(img, ref):
    """tests/test_photon_aim.py's image rule between backends."""
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 5e-3 * max(ref.mean(), 1e-3)
    diverged = np.abs(img - ref).max(axis=-1) > 1e-3
    print(f"{diverged.mean():.2%} pixels off by more than 1e-3")
    assert diverged.mean() < 0.02


# ----- ops.soa against tpurt's -----

def _planes(r, n, scale=1.0):
    return r.normal(size=(3, n)).astype(np.float32) * np.float32(scale)


@pytest.fixture(params=["scalar", "per-lane"])
def cone_inputs(request):
    n = 20_000
    r = np.random.default_rng(7)
    o, aim = _planes(r, n), _planes(r, n, 3.0)
    aim[:, :64] = o[:, :64]          # aim at the origin: the 1e-12 floor
    radius = (np.float32(0.7) if request.param == "scalar"
              else r.uniform(1e-4, 4.0, n).astype(np.float32))
    ua, ub = (r.random(n).astype(np.float32) for _ in range(2))
    return o, aim, radius, ua, ub


def _jax_trig(tp, monkeypatch):
    """PyTorch's cos and sin replaced by XLA's for the CPU tensors of a
    call, so the port's op order is held alone."""
    def wrap(fn):
        return lambda t: torch.from_numpy(np.asarray(fn(tp.jnp.asarray(
            t.numpy()))))
    monkeypatch.setattr(torch, "cos", wrap(tp.jnp.cos))
    monkeypatch.setattr(torch, "sin", wrap(tp.jnp.sin))


def _cones(tp, o, aim, radius, ua, ub, widen=3.0):
    t = lambda a: tuple(torch.from_numpy(x) for x in a)  # noqa: E731
    j = lambda a: tuple(tp.jnp.asarray(x) for x in a)  # noqa: E731
    rad_t = (torch.from_numpy(radius) if isinstance(radius, np.ndarray)
             else float(radius))
    got = soa.aimed_cone_c(t(o), t(aim), rad_t, widen, torch.from_numpy(ua),
                           torch.from_numpy(ub))
    want = tp.soa.aimed_cone_c(j(o), j(aim), tp.jnp.asarray(radius),
                               tp.jnp.float32(widen), tp.jnp.asarray(ua),
                               tp.jnp.asarray(ub))
    return got, want


def test_aimed_cone_matches_tpurt(tp, cone_inputs, monkeypatch):
    """axis and cos_a bit for bit; the direction bit for bit with XLA's
    cos and sin."""
    (d, axis, cos_a), (dj, axj, caj) = _cones(tp, *cone_inputs)
    for a, b in zip(axis, axj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(cos_a.numpy(),
                                  np.broadcast_to(np.asarray(caj),
                                                  cos_a.shape))
    err = np.max(np.abs(np.stack([a.numpy() - np.asarray(b)
                                  for a, b in zip(d, dj)])))
    assert err <= 2.0 ** -23
    _jax_trig(tp, monkeypatch)
    (d, _, _), (dj, _, _) = _cones(tp, *cone_inputs)
    for a, b in zip(d, dj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mixture_weight_matches_tpurt(tp, cone_inputs, monkeypatch):
    """The weight bit for bit on aimed and cosine directions, for a q
    plane with zeros (lanes that cannot aim: weight exactly 1 where the
    cosine density is positive)."""
    _jax_trig(tp, monkeypatch)
    (d, axis, cos_a), _ = _cones(tp, *cone_inputs)
    n = d[0].shape[0]
    r = np.random.default_rng(11)
    q = np.where(r.random(n) < 0.2, 0.0, r.uniform(0.05, 0.95, n)
                 ).astype(np.float32)
    lnorm = (0.0, -1.0, 0.0)
    for dd in (d, _cosine_dirs(r, n)):
        got = soa.aim_mixture_weight_c(dd, lnorm, axis, cos_a,
                                       torch.from_numpy(q))
        want = tp.soa.aim_mixture_weight_c(
            tuple(tp.jnp.asarray(c.numpy()) for c in dd),
            tuple(tp.jnp.float32(c) for c in lnorm),
            tuple(tp.jnp.asarray(c.numpy()) for c in axis),
            tp.jnp.asarray(cos_a.numpy()), tp.jnp.asarray(q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cosine_dirs(r, n):
    """Cosine-hemisphere directions about the normal (0, -1, 0), in the
    frame of an area light facing down: T = (1, 0, 0), B = n x T."""
    u1, u2 = (torch.from_numpy(r.random(n).astype(np.float32))
              for _ in range(2))
    theta = 6.283185307179586 * u1
    rr = integrate.fsqrt(u2)
    z = integrate.fsqrt((1.0 - rr * rr).clamp_min(0.0))
    return (rr * torch.cos(theta), -z, -rr * torch.sin(theta))


def test_mixture_weight_normalizes():
    """E_mix[p_cos / p_mix] = 1 (tests/test_photon_aim.py): directions
    drawn from the mixture, for several q and cone widths."""
    n = 200_000
    lnorm = (0.0, -1.0, 0.0)
    o = tuple(torch.zeros(n) for _ in range(3))
    for q, aim, radius in ((0.5, (0.8, -3.0, 0.4), 0.5),
                           (0.9, (0.0, -2.0, 0.0), 2.0),
                           (0.3, (4.0, -1.0, -3.0), 0.05)):
        r = np.random.default_rng(5)
        uch, ua, ub = (torch.from_numpy(r.random(n).astype(np.float32))
                       for _ in range(3))
        aim_c = tuple(torch.full((n,), v) for v in aim)
        d_aim, ax, cos_a = soa.aimed_cone_c(o, aim_c, radius, 3.0, ua, ub)
        d = soa.vwhere(uch < q, d_aim, _cosine_dirs(r, n))
        w = soa.aim_mixture_weight_c(d, lnorm, ax, cos_a,
                                     torch.full((n,), q)).numpy()
        assert np.isfinite(w).all()
        se = w.std() / np.sqrt(n)
        assert abs(w.mean() - 1.0) < max(4.0 * se, 5e-3), (q, w.mean(), se)


def test_aimed_cone_geometry():
    """Aimed draws stay inside the cone, unit length, uniform in the polar
    cosine; huge and tiny radii clamp the sine at AIM_SIN_MAX and
    AIM_SIN_MIN."""
    n = 50_000
    r = np.random.default_rng(9)
    ua, ub = (torch.from_numpy(r.random(n).astype(np.float32))
              for _ in range(2))
    o = tuple(torch.zeros(n) for _ in range(3))
    aim = tuple(torch.full((n,), v) for v in (1.0, -4.0, 2.0))
    d, ax, cos_a = soa.aimed_cone_c(o, aim, 0.8, 3.0, ua, ub)
    ct = soa.vdot(d, ax).numpy()
    ca = float(cos_a[0])
    assert (ct >= ca - 1e-5).all()
    np.testing.assert_allclose(integrate.fsqrt(soa.vdot(d, d)).numpy(), 1.0,
                               atol=1e-5)
    assert abs(ct.mean() - (1.0 + ca) / 2.0) < 2e-3
    _, _, wide = soa.aimed_cone_c(o, aim, 1e6, 3.0, ua, ub)
    _, _, tight = soa.aimed_cone_c(o, aim, 1e-9, 3.0, ua, ub)
    np.testing.assert_allclose(wide.numpy(), np.sqrt(1 - soa.AIM_SIN_MAX ** 2),
                               atol=1e-6)
    np.testing.assert_allclose(tight.numpy(),
                               np.sqrt(1 - soa.AIM_SIN_MIN ** 2), atol=1e-6)


# ----- renders against tpurt -----

@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("scene", ["one", "two"])
def test_renders_match_tpurt(tp, backend, scene):
    """tests/test_photon_aim.py's cross-backend case (depth 3, q 0.5, K 2,
    4 photon bounces, seed 99, 2 spp) on the XLA twin and the regen
    kernel's plain version, against tpurt's XLA integrator ("one") and,
    with a point light added, against tpurt's regen kernel ("two"): rays
    exact; the image by tpurt's rule, and with the point light by the
    golden rule (median |diff| < 1e-4, fewer than 2% of pixels off by more
    than 1e-2): its photons leave in a cone whose cosine and sine differ
    by an ulp between PyTorch and XLA, and tpurt's own two backends
    already differ by more than 1e-3 on 1.8% of its pixels."""
    if scene == "one":
        rays_j, img_j = tp.ref("xla")
    else:
        rays_j, img_j = tp.ref("pallas", "two")
    st = _port(backend, scene=_scene if scene == "one" else _two_light_scene)
    print(f"rays {int(st.rays)} vs tpurt {rays_j}")
    assert int(st.rays) == rays_j > 0
    img = st.rgb_sum.numpy()[:W * H]
    if scene == "one":
        _cross_backend_rule(img, img_j)
        return
    diff = np.abs(img - img_j)
    assert np.median(diff) < 1e-4 and (diff.max(-1) > 1e-2).mean() < 0.02


def test_aim_changes_only_the_photons():
    """q 0.5 against q 0 on the same seed: the camera term is the same
    draw for draw (with photons off the states are equal), the photon term
    is not."""
    off = dict(enable_photons=False)
    a = _port("xla", **off)
    b = _port("xla", photon_aim=0.0, **off)
    assert torch.equal(a.rgb_sum, b.rgb_sum) and int(a.rays) == int(b.rays)
    c = _port("xla")
    d = _port("xla", photon_aim=0.0)
    assert (c.rgb_sum - d.rgb_sum).abs().max() > 1e-3


def test_unbiased_vs_reference_sampling():
    """tests/test_photon_aim.py: q 0.5 converges to the q 0 image at equal
    spp (depth 4, K 2, 6 photon bounces, seed 345, 128 spp; mean radiance
    within 5%)."""
    means = {}
    for q in (0.0, 0.5):
        st = _port("xla", seed=345, spp=128, photon_aim=q, depth=4,
                   max_photon_bounces=6)
        img = st.rgb_sum.numpy()[:W * H] / 128.0
        assert np.isfinite(img).all()
        means[q] = img.mean(axis=0)
    np.testing.assert_allclose(means[0.5], means[0.0], rtol=0.05)


def test_budget_mode_matches_tpurt(tp):
    """render_adaptive with q 0.5 on "pallas" (the regen kernel's budget
    mode, photons on; spp 8, pilot 4, seed 11) against tpurt's, held as
    tests/test_torch_adaptive.py holds it (ROADMAP C3: tpurt's jitted
    pilots round a wavelength differently): at most 1% of the budgets
    differ, by one sample, and the rays by no more than those samples'
    longest paths."""
    kw = dict(KW, backend="pallas", k_photons=1, max_photon_bounces=2)
    cfg_j = tp.tpurt.RenderConfig(**kw)
    st_j, b_j = tp.adaptive.render_adaptive(_scene(tp.tpurt), cfg_j,
                                            _cam(tp.tpurt), 11, 8, 4)
    cfg = tt.RenderConfig(**kw)
    st, b = tt.render_adaptive(_scene(tt, device=CPU), cfg, _cam(tt), 11, 8,
                               4)
    n = cfg.n_pixels
    b, b_j = b.numpy()[:n].astype(np.int64), np.asarray(b_j)[:n]
    np.testing.assert_array_equal(st.n_samples.numpy()[:n], 4 + b)
    off = np.abs(b - b_j)
    print(f"{(off > 0).sum()} of {off.size} budgets differ; rays "
          f"{int(st.rays)} vs {int(float(st_j.rays))}")
    assert off.max() <= 1 and (off > 0).mean() <= 0.01
    per_sample = cfg.depth * 2 + cfg.k_photons * cfg.max_photon_bounces
    assert abs(int(st.rays) - int(float(st_j.rays))) \
        <= int(off.sum()) * per_sample


# ----- validation: tpurt's errors where tpurt raises them -----

@pytest.mark.parametrize("bad", [1.0, 1.5, -0.2])
def test_aim_out_of_range(bad):
    with pytest.raises(ValueError, match="photon_aim"):
        _port("xla", photon_aim=bad)


@pytest.mark.parametrize("widen", [0.0, -1.0])
def test_aim_widen_must_be_positive(widen):
    with pytest.raises(ValueError, match="photon_aim_widen"):
        _port("pallas", photon_aim_widen=widen)
    # with aim off the widen value is never read
    _port("pallas", photon_aim=0.0, photon_aim_widen=widen, spp=1)


@pytest.mark.parametrize("extra", [
    dict(backend="wavefront_fused"), dict(backend="wavefront"),
    dict(backend="wavefront_pallas"),
    dict(backend="pallas", pallas_regen=False)])
def test_aim_not_implemented_where_tpurt_has_none(extra):
    cfg = tt.RenderConfig(**{**KW, "wf_pool": 1024, **extra})
    with pytest.raises(NotImplementedError, match="photon_aim"):
        tt.render(_scene(tt, device=CPU), cfg, _cam(tt),
                  tt.init_state(cfg, device=CPU), 1, 1)


@pytest.mark.parametrize("backend,error", [
    ("wavefront_fused", NotImplementedError),
    ("wavefront", NotImplementedError),
    ("wavefront_pallas", NotImplementedError), ("xla", None),
    ("pallas", None)])
def test_render_adaptive_aim_where_tpurt_takes_it(tp, backend, error):
    """render_adaptive refuses photon_aim where tpurt's does (the
    wavefront routes) and takes it on "xla" (tpurt's plain pool, which
    traces no photons: aim changes nothing) and "pallas" (the regen
    kernel; tpurt's takes it there in test_budget_mode_matches_tpurt);
    with pallas_regen=False tpurt refuses adaptive sampling first."""
    kw = dict(width=16, height=8, depth=2, photon_aim=0.5, k_photons=1,
              max_photon_bounces=2, wf_pool=256, tile_size=128)
    cfg = tt.RenderConfig(backend=backend, **kw)
    cfg_j = tp.tpurt.RenderConfig(backend=backend, pallas_lanes=128, **kw)
    run = lambda pkg, c, **dev: pkg.render_adaptive(  # noqa: E731
        _scene(pkg, **dev), c, _cam(pkg, 16, 8), 3, 4, 2)
    if error is None:
        run(tt, cfg, device=CPU)
        if backend == "xla":
            run(tp.tpurt, cfg_j)
        return
    with pytest.raises(error, match="photon_aim"):
        run(tt, cfg, device=CPU)
    with pytest.raises(error, match="photon_aim"):
        run(tp.tpurt, cfg_j)
    with pytest.raises(ValueError, match="pallas_regen"):
        run(tt, cfg.with_(backend="pallas", pallas_regen=False), device=CPU)


# ----- the regen kernel on the card -----

@pytest.mark.gpu
@pytest.mark.parametrize("light_sample", ["all", "spatial"])
def test_aim_kernel_matches_plain(cuda, light_sample):
    """Cornell spheres at 128x72, depth 6, K 4, q 0.5: the regen kernel's
    lights instance against render_plain, uniform from iteration 2 and a
    budget launch (budgets 0-2) against render_plain_budget, every plane
    bit for bit."""
    scene = tt.cornell_spheres_scene(device=cuda)
    fs = freeze_scene(scene)
    cfg = tt.RenderConfig(width=128, height=72, depth=6, photon_aim=0.5,
                          light_sample=light_sample, backend="pallas")
    cam = tt.make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                         aspect_ratio=128 / 72)
    planes = state_to_planes(tt.init_state(cfg, cuda))
    pk, pp = planes.clone(), planes.clone()
    rk = mega_regen.regen_call(scene, cfg, cam, pk, 7, 2, 2, 1.5, 6)
    rp = integrate.render_plain(fs, cfg, cam, pp, 7, 2, 2, 1.5, 6)
    assert int(rk) == int(rp) > 0 and torch.equal(pk, pp)
    counts = torch.ones(pk.shape[1], device=cuda)
    g = torch.Generator().manual_seed(3)
    budgets = torch.randint(0, 3, (pk.shape[1],), generator=g).to(cuda)
    budgets[cfg.n_pixels:] = 0
    bk, bp = pk.clone(), pk.clone()
    rk = mega_regen.regen_budget_call(scene, cfg, cam, bk, 7, budgets, counts)
    rp = integrate.render_plain_budget(fs, cfg, cam, bp, 7, budgets, counts)
    assert int(rk) == int(rp) > 0 and torch.equal(bk, bp)
