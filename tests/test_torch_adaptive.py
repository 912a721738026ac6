"""Adaptive sampling of the port (tpurt_torch.adaptive and the fused
kernel's budget mode) against tpurt.adaptive; and, on a CUDA device, the
fused kernel's budget mode against its plain version.

tpurt is imported inside the fixture ``tp`` so the GPU cases (marker
``gpu``) also run where JAX is not installed:
``python3 -m pytest tests/test_torch_adaptive.py -m gpu --noconftest``.

Tolerances:
- enumeration tables, budgets, sample counts and ray counts exact;
- the variance proxy rtol 1e-5, atol 1e-7 (XLA and PyTorch sum the luma
  dot product and the mean in another order);
- a uniform budget against the uniform renderer of the same
  implementation: bit-exact (same enumeration, schedule and float adds);
- budget renders against tpurt: the image rule of tpurt's parity tests,
  fewer than 2% of pixels off by more than 1e-2 and median |diff| < 1e-4;
  continuation (two budget calls against one): rtol 1e-5, atol 1e-5, as
  tests/test_adaptive.py;
- render_adaptive end to end against tpurt's: at most 1% of the budgets
  off, by one sample (the pilots' images differ within the image rule, so
  a budget rounding near .5 can move), exact on a pinned seed; on tpurt's
  own pilot sums the port's budgets are tpurt's exactly.
"""

import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import adaptive
from tpurt_torch.kernels import wavefront_fused

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"


def _dev(pkg):
    """device=CPU for the port's scene builders; tpurt's take none."""
    return {"device": CPU} if pkg is tt else {}


torch.set_num_threads(1)

CAM = dict(look_from=(0.0, 5.0, -12.0), look_at=(0.0, 5.0, 0.0), vfov=60.0,
           aspect_ratio=2.0)


@pytest.fixture(scope="module")
def tp():
    import jax.numpy as jnp

    import tpurt
    import tpurt.adaptive
    import tpurt.render
    return types.SimpleNamespace(jnp=jnp, tpurt=tpurt,
                                 ad=sys.modules["tpurt.adaptive"],
                                 render=sys.modules["tpurt.render"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_wavefront.py "
                    "tests/test_torch_adaptive.py -m gpu --noconftest")
    return torch.device("cuda")


def _setup(pkg, **kw):
    cfg = pkg.RenderConfig(width=48, height=24, depth=4, tile_size=1152,
                           enable_photons=False, **kw)
    return cfg, pkg.cornell_spheres_scene(**_dev(pkg)), pkg.make_camera(**CAM)


def _budgets(cfg, values, device="cpu"):
    """One budget per state row, pad rows 0."""
    from tpurt_torch.render import padded_pixels
    b = np.zeros((padded_pixels(cfg),), np.int32)
    b[:cfg.n_pixels] = values
    return torch.from_numpy(b).to(device)


@pytest.mark.parametrize("seed,max_budget", [(0, 4), (1, 9), (2, 1)])
def test_round_major_tables_match(tp, seed, max_budget):
    b = np.random.default_rng(seed).integers(0, max_budget + 1, 1152)
    b = b.astype(np.int32)
    order_j, cum_j, total_j = tp.ad._round_major_tables(tp.jnp.asarray(b),
                                                        max_budget)
    order, cum, total = adaptive._round_major_tables(torch.from_numpy(b),
                                                     max_budget)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(cum.numpy(), np.asarray(cum_j))
    assert int(total) == int(total_j) == int(b.sum())


@pytest.mark.parametrize("smooth", [True, False])
def test_variance_proxy_matches(tp, smooth):
    cfg, _, _ = _setup(tt)
    rs = np.random.default_rng(4)
    P = 1152
    sa = rs.uniform(0.0, 3.0, (P, 3)).astype(np.float32)
    sb = rs.uniform(0.0, 3.0, (P, 3)).astype(np.float32)
    na = rs.integers(0, 5, P).astype(np.float32)
    nb = rs.integers(1, 5, P).astype(np.float32)
    want = tp.ad.variance_proxy(tp.tpurt.RenderConfig(width=48, height=24),
                                *(tp.jnp.asarray(x) for x in (sa, na, sb, nb)),
                                smooth)
    got = adaptive.variance_proxy(cfg, *(torch.from_numpy(x)
                                         for x in (sa, na, sb, nb)), smooth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("power", [0.5, 1.0])
def test_allocate_budgets_matches(tp, power):
    rs = np.random.default_rng(5)
    proxy = rs.uniform(0.0, 1.0, 1152).astype(np.float32)
    proxy[1100:] = 0.0
    want = np.asarray(tp.ad.allocate_budgets(tp.jnp.asarray(proxy), 4608,
                                             64, power))
    got = adaptive.allocate_budgets(torch.from_numpy(proxy), 4608, 64, power)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[1100:] == 0).all()


def test_uniform_budget_bit_identical():
    """budgets == spp everywhere reproduces wavefront_render exactly."""
    cfg, scene, cam = _setup(tt, wf_pool=512)
    st_u = tt.wavefront_render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 3)
    st_b = tt.wavefront_render_budget(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                                      42, _budgets(cfg, 3), 3)
    assert torch.equal(st_u.rgb_sum, st_b.rgb_sum)
    assert torch.equal(st_u.n_samples, st_b.n_samples)
    assert int(st_u.rays) == int(st_b.rays) > 0
    assert st_u.iteration == st_b.iteration == 3


def test_budget_matches_tpurt(tp):
    """Non-uniform budgets: the same per-pixel sample counts and rays as
    tpurt's budget renderer, and its image."""
    vals = np.random.default_rng(8).integers(0, 5, 48 * 24)
    cfg_j, scene_j, cam_j = _setup(tp.tpurt, wf_pool=1024)
    st_j = tp.ad.wavefront_render_budget(
        scene_j, cfg_j, cam_j, tp.render.init_state(cfg_j), 42,
        tp.jnp.asarray(_budgets(cfg_j, vals).numpy()), max_budget=4)
    cfg, scene, cam = _setup(tt, wf_pool=1024)
    st = tt.wavefront_render_budget(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42,
                                    _budgets(cfg, vals), 4)
    n = cfg.n_pixels
    assert int(st.rays) == int(float(st_j.rays)) > 0
    np.testing.assert_array_equal(st.n_samples.numpy(),
                                  np.asarray(st_j.n_samples))
    assert (st.n_samples.numpy()[:n] == vals).all()
    diff = np.abs(st.rgb_sum.numpy()[:n] - np.asarray(st_j.rgb_sum)[:n])
    assert np.median(diff) < 1e-4
    assert (diff.max(axis=-1) > 1e-2).mean() < 0.02
    assert st.iteration == 4


def test_budget_continuation_draws_new_samples():
    """Two budget calls equal one call with the summed budgets: each
    call continues at the pixel's own count."""
    rs = np.random.default_rng(9)
    b1, b2 = rs.integers(0, 3, 48 * 24), rs.integers(0, 3, 48 * 24)
    cfg, scene, cam = _setup(tt, wf_pool=512)
    st_a = tt.wavefront_render_budget(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                                      3, _budgets(cfg, b1), 2)
    st_a = tt.wavefront_render_budget(scene, cfg, cam, st_a, 3,
                                      _budgets(cfg, b2), 2)
    st_b = tt.wavefront_render_budget(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                                      3, _budgets(cfg, b1 + b2), 4)
    assert int(st_a.rays) == int(st_b.rays) > 0
    assert torch.equal(st_a.n_samples, st_b.n_samples)
    n = cfg.n_pixels
    np.testing.assert_allclose(st_a.rgb_sum.numpy()[:n],
                               st_b.rgb_sum.numpy()[:n], rtol=1e-5, atol=1e-5)


def test_zero_budget_is_noop():
    cfg, scene, cam = _setup(tt, wf_pool=256)
    st = tt.wavefront_render_budget(scene, cfg, cam, tt.init_state(cfg, device=CPU), 1,
                                    _budgets(cfg, 0), 1)
    assert float(st.n_samples.sum()) == 0.0 and int(st.rays) == 0
    assert float(st.rgb_sum.abs().sum()) == 0.0


def test_fused_budget_wrapper_on_cpu_runs_plain():
    """On the CPU the fused kernel's budget mode runs the plain budget
    renderer on the clipped budgets (pad rows 0, at most max_budget); a
    uniform budget equals the uniform fused wrapper bit for bit."""
    cfg, scene, cam = _setup(tt, backend="wavefront_fused", pallas_lanes=512,
                             wf_pool=1024)
    vals = np.random.default_rng(3).integers(0, 7, 48 * 24)
    raw = _budgets(cfg, vals)
    raw[cfg.n_pixels:] = 5                      # pad rows: ignored
    before = wavefront_fused.LAUNCHES
    st_f = wavefront_fused.wavefront_render_budget_fused(
        scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, raw, 4)
    st_p = tt.wavefront_render_budget(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                                      42, _budgets(cfg, np.minimum(vals, 4)),
                                      4)
    assert torch.equal(st_f.rgb_sum, st_p.rgb_sum)
    assert torch.equal(st_f.n_samples, st_p.n_samples)
    assert int(st_f.rays) == int(st_p.rays) > 0
    st_u = wavefront_fused.wavefront_render_fused(
        scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 2)
    st_b = wavefront_fused.wavefront_render_budget_fused(
        scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, _budgets(cfg, 2), 2)
    assert torch.equal(st_u.rgb_sum, st_b.rgb_sum)
    assert int(st_u.rays) == int(st_b.rays) > 0
    assert wavefront_fused.LAUNCHES == before


@pytest.mark.parametrize("backend", ["wavefront", "wavefront_pallas",
                                     "wavefront_fused", "xla"])
def test_render_adaptive_end_to_end(backend):
    cfg, scene, cam = _setup(tt, wf_pool=1024, pallas_lanes=512,
                             backend=backend)
    spp, pilot = 6, 2
    st, budgets = tt.render_adaptive(scene, cfg, cam, base_seed=17, spp=spp,
                                     pilot_spp=pilot)
    n = cfg.n_pixels
    ns = st.n_samples.numpy()[:n]
    b = budgets.numpy()[:n]
    assert (ns == pilot + b).all()
    assert abs(int(b.sum()) - (spp - pilot) * n) <= n   # rounding slack
    assert bool(torch.isfinite(tt.resolve_image(cfg, st)).all())


def _adaptive_pair(tp, seed):
    cfg_j, scene_j, cam_j = _setup(tp.tpurt, wf_pool=1024)
    st_j, b_j = tp.ad.render_adaptive(scene_j, cfg_j, cam_j, base_seed=seed,
                                      spp=8, pilot_spp=4)
    cfg, scene, cam = _setup(tt, wf_pool=1024)
    st, b = tt.render_adaptive(scene, cfg, cam, base_seed=seed, spp=8,
                               pilot_spp=4)
    n = cfg.n_pixels
    assert (st.n_samples.numpy()[:n] == 4 + b.numpy()[:n]).all()
    assert st.iteration == st_j.iteration
    return cfg, st, b.numpy(), st_j, np.asarray(b_j)


def test_render_adaptive_matches_tpurt(tp):
    """render_adaptive end to end against tpurt's on the plain pool. The
    pilots' ray counts are exact, but their images differ (tpurt's jitted
    integrator and the port's round some sums differently: the image rule
    of the parity tests allows it), so the proxy differs and a budget that
    rounds near .5 can move by one: at most 1% of the budgets may differ,
    by one sample, and the ray count by no more than those samples' longest
    paths (a segment and a shadow segment per light at each bounce)."""
    cfg, st, b, st_j, b_j = _adaptive_pair(tp, 17)
    off = np.abs(b.astype(np.int64) - b_j)
    print(f"{(off > 0).sum()} of {off.size} budgets differ")
    assert off.max() <= 1 and (off > 0).mean() <= 0.01
    n_lights = 1
    assert 0 < int(st.rays)
    assert abs(int(st.rays) - int(float(st_j.rays))) \
        <= int(off.sum()) * cfg.depth * (1 + n_lights)


def test_render_adaptive_exact_on_pinned_seed(tp):
    """On seed 11 no budget sits near .5: the budgets, the sample counts
    and the ray count of the whole adaptive render are tpurt's exactly."""
    _, st, b, st_j, b_j = _adaptive_pair(tp, 11)
    assert np.array_equal(b, b_j)
    assert np.array_equal(st.n_samples.numpy(), np.asarray(st_j.n_samples))
    assert int(st.rays) == int(float(st_j.rays)) > 0


@pytest.mark.parametrize("seed", [17, 2, 7, 11])
def test_budgets_from_tpurt_pilots_are_tpurts(tp, seed):
    """Where render_adaptive's budgets differ from tpurt's, the pilots do:
    on tpurt's own pilot sums (which differ from the port's on most rows,
    ray counts equal) the port's proxy and allocation give tpurt's budgets
    exactly, also on the seeds where the end-to-end budgets differ by one
    (17, 2, 7)."""
    from tpurt import wavefront as wf_j
    from tpurt_torch import wavefront as wf_t
    cfg_j, scene_j, cam_j = _setup(tp.tpurt, wf_pool=1024)
    cfg, scene, cam = _setup(tt, wf_pool=1024)
    sj = wf_j.wavefront_render(scene_j, cfg_j, cam_j,
                               tp.tpurt.init_state(cfg_j), seed, 2)
    sum_a, n_a = np.array(sj.rgb_sum), np.array(sj.n_samples)
    rays_a = int(float(sj.rays))
    sj = wf_j.wavefront_render(scene_j, cfg_j, cam_j, sj, seed, 2)
    sum_b = np.array(sj.rgb_sum - sum_a)
    n_b = np.array(sj.n_samples - n_a)
    st = wf_t.wavefront_render(scene, cfg, cam, tt.init_state(cfg, device=CPU),
                               seed, 2, step=wf_t.xla_stepper(cfg))
    assert int(st.rays) == rays_a
    assert (st.rgb_sum.numpy() != sum_a).any()
    total, cap = 4 * cfg.n_pixels, 4 * 16
    want = np.asarray(tp.ad.allocate_budgets(
        tp.ad.variance_proxy(cfg_j, sum_a, n_a, sum_b, n_b, True), total, cap))
    proxy = adaptive.variance_proxy(
        cfg, *(torch.from_numpy(x) for x in (sum_a, n_a, sum_b, n_b)), True)
    got = adaptive.allocate_budgets(proxy, total, cap).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [17, 2, 7, 11])
def test_pilots_differ_where_xla_contracts_the_wavelength(tp, seed):
    """Where render_adaptive's pilots differ from tpurt's (ROADMAP C3): not
    in the pool's regeneration or splat. On an empty pool of the pilots'
    shape the port's _regen equals tpurt's _regen run eagerly, every plane
    bit for bit. tpurt's wavefront_render runs it under jit, where XLA
    contracts the wavelength draw 380 + u * 400 (tpurt's
    sample_wavelength) into one fused multiply-add: the jitted wavelengths
    are fma(u, 400, 380), rounded once, and differ from the eager ones on
    a share of the slots. (Its jitted sweep adds more of the same, and
    forms hit points in another order than the kernel-form code the port
    follows.)"""
    import jax
    from tpurt_torch import wavefront as wf_t
    from tpurt_torch.ops.rng import frame_seed, rand_1f, seed_pixels
    jnp, wf_j = tp.jnp, sys.modules["tpurt.wavefront"]
    cfg_j, _, cam_j = _setup(tp.tpurt, wf_pool=1024)
    cfg, _, cam = _setup(tt, wf_pool=1024)
    q, n = 1024, cfg.n_pixels
    z = lambda *shape: jnp.zeros((q, *shape))  # noqa: E731
    pool_j = wf_j.WavefrontPool(
        pix=jnp.zeros((q,), jnp.int32), o=z(3), d=z(3), tp=z(3), rad=z(3),
        lam=z(), rng=jnp.zeros((q,), jnp.uint32),
        bounce=jnp.zeros((q,), jnp.int32), active=jnp.zeros((q,), bool),
        coll=jnp.zeros((q,), bool))

    def regen(pool):
        return wf_j._regen(cfg_j, cam_j, pool, jnp.int32(0), jnp.int32(0),
                           jnp.int32(2), jnp.uint32(seed), 0, jnp.int32(0),
                           jnp.int32(n))[0]

    eager, jitted = regen(pool_j), jax.jit(regen)(pool_j)
    zero = torch.zeros((), dtype=torch.int64)
    mine = wf_t._regen(cfg, cam, wf_t.new_pool(q, CPU), zero, zero, 2, seed,
                       0, 0, n)[0]
    for name, base in (("o", wf_t.O), ("d", wf_t.D), ("tp", wf_t.TP),
                       ("rad", wf_t.RAD)):
        assert np.array_equal(mine.pf[base:base + 3].numpy().T,
                              np.asarray(getattr(eager, name))), name
    assert np.array_equal(mine.pf[wf_t.LAM].numpy(), np.asarray(eager.lam))
    assert np.array_equal(mine.rng.numpy(),
                          np.asarray(eager.rng).astype(np.int64))
    assert np.array_equal(mine.pi[wf_t.PIX].numpy(), np.asarray(eager.pix))
    # the wavelength draw of every slot: the third number of its stream
    pix = mine.pi[wf_t.PIX].long()
    rng = seed_pixels(frame_seed(seed, torch.zeros_like(pix)),
                      pix % cfg.width, pix // cfg.width)
    for _ in range(2):
        _, rng = rand_1f(rng)
    u, _ = rand_1f(rng)
    fused = adaptive._fma(u, torch.full_like(u, 400.0),
                          torch.full_like(u, 380.0)).numpy()
    lam_j = np.asarray(jitted.lam)
    assert np.array_equal(lam_j, fused)
    off = (lam_j != np.asarray(eager.lam)).mean()
    print(f"{off:.1%} of the jitted wavelengths differ from the eager ones")
    assert 0.05 < off < 0.3


def test_luma_fma_rounds_once():
    """adaptive._fma equals the exact a * b + c rounded once to float32,
    also where rounding through float64 first would round twice (the
    float64 sum a tie of float32 that the exact sum is not)."""
    from fractions import Fraction
    f32 = np.float32
    rs = np.random.default_rng(4)
    a = rs.normal(0, 1, 256).astype(f32)
    b = rs.normal(0, 1, 256).astype(f32)
    c = rs.normal(0, 1, 256).astype(f32)
    eps = f32(2.0 ** -23)
    # 1 + eps + 2^-24 (1 - 2^-46): below the tie; float64 rounds onto it
    a[:2] = f32(1) + eps, -(f32(1) + eps)
    b[:2] = f32(2.0 ** -24) * (f32(1) - eps)
    c[:2] = f32(1) + eps, -(f32(1) + eps)
    got = adaptive._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    twice = (a.astype(np.float64) * b + c).astype(f32)
    assert got[0] == f32(1) + eps and twice[0] != got[0]
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo, hi = sorted((float(g), float(np.nextafter(g, f32(np.sign(
            float(exact - Fraction(float(g)))) * np.inf)))))
        # g is the float32 nearest to the exact sum
        assert abs(exact - Fraction(float(g))) * 2 <= Fraction(hi) - Fraction(lo)


def test_variance_proxy_pieces_match_tpurt(tp):
    """On the same seeded half-sums the port's luma gap and box filter
    equal tpurt's jitted ones bit for bit (the luma as XLA's chain of
    fused multiply-adds, the box scaled by float32(1/9)); the whole proxy
    then differs by at most one ulp, the floor's mean being summed in
    another order; and the allocation of one proxy gives equal budgets."""
    import jax
    jnp = tp.jnp
    rs = np.random.default_rng(0)
    cfg_j, _, _ = _setup(tp.tpurt, wf_pool=1024)
    cfg, _, _ = _setup(tt, wf_pool=1024)
    rows = 1152
    sa, sb = (rs.normal(0, 2, (rows, 3)).astype(np.float32) for _ in "ab")
    na, nb = (rs.integers(0, 4, rows).astype(np.float32) for _ in "ab")
    t = lambda *xs: [torch.from_numpy(x) for x in xs]  # noqa: E731

    def gap_j(sa, na, sb, nb):
        ma = sa / jnp.maximum(na, 1.0)[:, None]
        mb = sb / jnp.maximum(nb, 1.0)[:, None]
        return jnp.abs((ma - mb) @ jnp.asarray(tp.ad.LUMA, jnp.float32))

    gap = adaptive.luma_gap(*t(sa, na, sb, nb)).numpy()
    assert gap.tobytes() == np.asarray(jax.jit(gap_j)(sa, na, sb, nb)
                                       ).tobytes()
    img = gap.reshape(24, 48)
    box = adaptive._box3(torch.from_numpy(img)).numpy()
    assert box.tobytes() == np.asarray(jax.jit(tp.ad._box3)(img)).tobytes()
    for smooth in (True, False):
        pj = np.array(tp.ad.variance_proxy(cfg_j, sa, na, sb, nb, smooth))
        pt = adaptive.variance_proxy(cfg, *t(sa, na, sb, nb), smooth).numpy()
        ulps = np.abs(pj.view(np.int32).astype(np.int64)
                      - pt.view(np.int32))
        # smoothed: the floor's ulp; unsmoothed the sum below it is
        # smaller, so the same ulp of the floor is two of the sum
        assert ulps.max() <= (1 if smooth else 2)
        bj = np.asarray(tp.ad.allocate_budgets(jnp.asarray(pj), 4 * rows, 64))
        bt = adaptive.allocate_budgets(torch.from_numpy(pj), 4 * rows, 64)
        assert np.array_equal(bj, bt.numpy())


def test_render_adaptive_pallas_not_ported():
    """The regen kernel's budget mode is ported now: backend="pallas"
    spends the budgets through it (tests/test_torch_budget_regen.py holds
    it to tpurt), and pallas_regen=False raises tpurt's ValueError."""
    cfg, scene, cam = _setup(tt, backend="pallas")
    st, b = tt.render_adaptive(scene, cfg, cam, spp=4, pilot_spp=2)
    n = cfg.n_pixels
    assert (st.n_samples.numpy()[:n] == 2 + b.numpy()[:n]).all()
    assert int(st.rays) > 0 and st.iteration == 2 + 2 * 16
    with pytest.raises(ValueError, match="pallas_regen"):
        tt.render_adaptive(scene, cfg.with_(pallas_regen=False), cam, spp=4,
                           pilot_spp=2)


# ----- the fused kernel's budget mode against its plain version (GPU) -----

@pytest.mark.gpu
def test_fused_budget_kernel_matches_plain(cuda):
    """Non-uniform budgets at 256x144, depth 8, dispersive scene: the
    kernel's rays and sample counts equal the plain budget pool's; a
    uniform budget equals the uniform kernel bit for bit."""
    cfg = tt.RenderConfig(width=256, height=144, depth=8,
                          enable_photons=False, wf_pool=16384,
                          backend="wavefront_fused")
    scene = tt.dispersive_scene(device=cuda)
    cam = tt.make_camera((0.0, 3.0, -4.0), (0.0, 1.0, 5.0), vfov=55.0,
                         aspect_ratio=256 / 144)
    vals = np.random.default_rng(8).integers(0, 4, cfg.n_pixels)
    bud = _budgets(cfg, vals, cuda)
    before = wavefront_fused.LAUNCHES
    st_k = wavefront_fused.wavefront_render_budget_fused(
        scene, cfg, cam, tt.init_state(cfg, cuda), 42, bud, 3)
    assert wavefront_fused.LAUNCHES == before + 1
    st_p = tt.wavefront_render_budget(scene, cfg, cam,
                                      tt.init_state(cfg, cuda), 42, bud, 3)
    torch.cuda.synchronize()
    assert int(st_k.rays) == int(st_p.rays) > 0
    assert torch.equal(st_k.n_samples, st_p.n_samples)
    st_u = wavefront_fused.wavefront_render_fused(
        scene, cfg, cam, tt.init_state(cfg, cuda), 42, 2)
    st_b = wavefront_fused.wavefront_render_budget_fused(
        scene, cfg, cam, tt.init_state(cfg, cuda), 42, _budgets(cfg, 2, cuda),
        2)
    assert torch.equal(st_u.rgb_sum, st_b.rgb_sum)
    assert int(st_u.rays) == int(st_b.rays) > 0
