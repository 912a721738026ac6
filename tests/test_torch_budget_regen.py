"""The regen kernel's budget mode (adaptive sampling with photons):
the port's plain version ``integrate.render_plain_budget``, through
``kernels.mega_regen.render_budget_regen``, against tpurt's
``render_budget_regen`` in Pallas interpret mode at the shape of
tests/test_adaptive.py:193-261 (64x32, depth 3, K=2, 3 photon bounces,
budgets in [0, 3]); then the port alone: the per-pixel uniform prefix
(tpurt's oracle), two calls against one, a uniform budget against
``render``, ``render_adaptive(backend="pallas")``; and, on a CUDA device,
the kernel's budget mode against the plain version.

Tolerances: sample counts and ray counts exact; rgb_sum by the image rule
of tests/test_golden.py (median |diff| < 1e-4, fewer than 1% of pixels off
by more than 1e-2: tpurt's kernel and the port round in other orders);
inside the port, bit for bit.

``python -m pytest tests/test_torch_budget_regen.py -m gpu --noconftest``
runs the GPU cases where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import mega_regen
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)

CAM = ((0.0, 5.0, -12.0), (0.0, 5.0, 0.0))
KW = dict(width=64, height=32, depth=3, backend="pallas", pallas_lanes=512,
          k_photons=2, max_photon_bounces=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_budget_regen.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _setup(device=CPU, **kw):
    cfg = tt.RenderConfig(**{**KW, **kw})
    cam = tt.make_camera(*CAM, vfov=60.0, aspect_ratio=2.0)
    return cfg, tt.cornell_spheres_scene(device=device), cam


def _pad(cfg, rows, vals):
    """Budgets for every state row: vals on the image, 0 on the pad."""
    out = np.zeros((rows,), np.int64)
    out[:cfg.n_pixels] = vals
    return out


def test_matches_tpurt_budget_regen_interpret():
    """tpurt's regen kernel in budget mode (Pallas interpret mode) against
    the port's plain version, from a fresh state."""
    from tpurt import RenderConfig as JConfig
    from tpurt import cornell_spheres_scene as j_cornell
    from tpurt import init_state as j_init
    from tpurt import make_camera as j_camera
    from tpurt.kernels.mega_regen import render_budget_regen
    cfg, scene, cam = _setup()
    st0 = tt.init_state(cfg, device=CPU)
    rows = st0.n_samples.shape[0]
    budgets = _pad(cfg, rows,
                   np.random.default_rng(3).integers(0, 4, cfg.n_pixels))
    cfg_j = JConfig(**KW)
    st_j = render_budget_regen(j_cornell(), cfg_j,
                               j_camera(*CAM, vfov=60.0, aspect_ratio=2.0),
                               j_init(cfg_j), 42,
                               budgets.astype(np.int32), 3)
    st = mega_regen.render_budget_regen(scene, cfg, cam, st0, 42,
                                        torch.from_numpy(budgets), 3)
    np.testing.assert_array_equal(st.n_samples.numpy(),
                                  np.asarray(st_j.n_samples))
    assert int(st.rays) == float(st_j.rays) > 0
    assert st.iteration == int(st_j.iteration) == 3
    assert st.photon_radius == float(st_j.photon_radius)
    n = cfg.n_pixels
    diff = np.abs(st.rgb_sum.numpy()[:n] - np.asarray(st_j.rgb_sum)[:n])
    frac = (diff.max(-1) > 1e-2).mean()
    print(f"median |diff| {np.median(diff):.3g}, {frac:.2%} pixels > 1e-2")
    assert np.median(diff) < 1e-4
    assert frac < 0.01


def test_budget_equals_uniform_prefix_per_pixel():
    """tpurt's oracle: pixels are independent, so pixel p after budget b_p
    equals pixel p of a uniform render after b_p samples, bit for bit,
    photon pass and radius schedule included; also from a state that
    already holds samples."""
    cfg, scene, cam = _setup()
    st0 = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 42, 1)
    rows = st0.n_samples.shape[0]
    vals = np.random.default_rng(3).integers(0, 4, cfg.n_pixels)
    st_b = mega_regen.render_budget_regen(
        scene, cfg, cam, st0, 42, torch.from_numpy(_pad(cfg, rows, vals)), 3)
    prefix = [state_to_planes(st0).numpy()]
    st = st0
    for _ in range(3):
        st = tt.render(scene, cfg, cam, st, 42, 1)
        prefix.append(state_to_planes(st).numpy())
    n = cfg.n_pixels
    got = state_to_planes(st_b).numpy()[:, :n]
    want = np.stack(prefix)[vals, :, np.arange(n)].T
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(st_b.n_samples.numpy()[:n], 1 + vals)


def test_two_budget_calls_equal_one():
    cfg, scene, cam = _setup()
    st0 = tt.init_state(cfg, device=CPU)
    rows = st0.n_samples.shape[0]
    rs = np.random.default_rng(4)
    b1 = _pad(cfg, rows, rs.integers(0, 3, cfg.n_pixels))
    b2 = _pad(cfg, rows, rs.integers(0, 3, cfg.n_pixels))
    t = torch.from_numpy
    st_a = mega_regen.render_budget_regen(scene, cfg, cam, st0, 7, t(b1), 2)
    st_a = mega_regen.render_budget_regen(scene, cfg, cam, st_a, 7, t(b2), 2)
    st_c = mega_regen.render_budget_regen(scene, cfg, cam, st0, 7,
                                          t(b1 + b2), 4)
    assert torch.equal(state_to_planes(st_a), state_to_planes(st_c))
    assert torch.equal(st_a.n_samples, st_c.n_samples)
    assert int(st_a.rays) == int(st_c.rays) > 0
    assert st_a.iteration == st_c.iteration == 4


@pytest.mark.parametrize("flags", [{}, dict(photon_strata=8,
                                            photon_strata_dir=64,
                                            photon_strata_window=2,
                                            photon_strata_bounce=True,
                                            hero_wavelengths=4)],
                         ids=["reference", "sampler"])
def test_uniform_budget_equals_render(flags):
    cfg, scene, cam = _setup(**flags)
    st0 = tt.init_state(cfg, device=CPU)
    rows = st0.n_samples.shape[0]
    st_u = tt.render(scene, cfg, cam, st0, 42, 2)
    st_b = mega_regen.render_budget_regen(
        scene, cfg, cam, st0, 42,
        torch.from_numpy(_pad(cfg, rows, np.full(cfg.n_pixels, 2))), 2)
    assert torch.equal(state_to_planes(st_u), state_to_planes(st_b))
    assert int(st_u.rays) == int(st_b.rays) > 0
    assert st_u.photon_radius == st_b.photon_radius
    assert st_u.iteration == st_b.iteration


def test_budgets_are_clipped_and_padding_zeroed():
    cfg, scene, cam = _setup(width=16, height=8)
    st0 = tt.init_state(cfg, device=CPU)
    rows = st0.n_samples.shape[0]
    raw = torch.full((rows,), 9, dtype=torch.int64)
    raw[:4] = -2
    st = mega_regen.render_budget_regen(scene, cfg, cam, st0, 1, raw, 2)
    want = np.where(np.arange(rows) < cfg.n_pixels, 2.0, 0.0)
    want[:4] = 0.0
    np.testing.assert_array_equal(st.n_samples.numpy(), want)
    assert st.iteration == 2


def test_render_adaptive_pallas_runs_the_budget_mode():
    cfg, scene, cam = _setup()
    before = mega_regen.BUDGET_LAUNCHES
    st, budgets = tt.render_adaptive(scene, cfg, cam, base_seed=5, spp=5,
                                     pilot_spp=2)
    n = cfg.n_pixels
    np.testing.assert_array_equal(st.n_samples.numpy()[:n],
                                  2 + budgets.numpy()[:n])
    assert int(budgets.sum()) > 0
    assert bool(torch.isfinite(tt.resolve_image(cfg, st)).all())
    assert mega_regen.BUDGET_LAUNCHES == before   # the CPU runs the plain
    with pytest.raises(ValueError, match="pallas_regen"):
        tt.render_adaptive(scene, cfg.with_(pallas_regen=False), cam,
                           spp=5, pilot_spp=2)


# ----- the kernel's budget mode against its plain version (GPU only) -----

@pytest.mark.gpu
@pytest.mark.parametrize("flags", [{}, dict(photon_strata=16,
                                            photon_strata_dir=4096,
                                            photon_strata_window=4,
                                            photon_strata_bounce=True,
                                            camera_strata_bounce=True,
                                            hero_wavelengths=4)],
                         ids=["reference", "sampler"])
def test_kernel_budget_matches_plain(cuda, flags):
    """Rays and every state plane bit for bit, from a state with counts."""
    cfg, scene, cam = _setup(device=cuda, **flags)
    st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=cuda), 42, 1)
    rows = st.n_samples.shape[0]
    b = torch.from_numpy(_pad(cfg, rows, np.random.default_rng(5).integers(
        0, 5, cfg.n_pixels))).to(cuda)
    planes = state_to_planes(st)
    pk, pp = planes.clone(), planes.clone()
    before = mega_regen.BUDGET_LAUNCHES
    rk = int(mega_regen.regen_budget_call(scene, cfg, cam, pk, 42, b,
                                          st.n_samples))
    assert mega_regen.BUDGET_LAUNCHES == before + 1
    rp = int(integrate.render_plain_budget(freeze_scene(scene), cfg, cam, pp,
                                           42, b, st.n_samples))
    assert rk == rp > 0
    assert torch.equal(pk, pp)


@pytest.mark.gpu
def test_kernel_uniform_budget_equals_render(cuda):
    cfg, scene, cam = _setup(device=cuda)
    st0 = tt.init_state(cfg, device=cuda)
    rows = st0.n_samples.shape[0]
    uni = torch.from_numpy(_pad(cfg, rows, np.full(cfg.n_pixels, 2)))
    st_b = mega_regen.render_budget_regen(scene, cfg, cam, st0, 42,
                                          uni.to(cuda), 2)
    st_u = tt.render(scene, cfg, cam, st0, 42, 2)
    assert torch.equal(state_to_planes(st_u), state_to_planes(st_b))
    assert int(st_u.rays) == int(st_b.rays) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(64, 32), (50, 30)], ids=["64x32", "50x30"])
def test_kernel_zero_heavy_budget_matches_plain(cuda, size):
    """A budget map with long runs of zeros (two pixels in three take no
    sample) on a size that is and one that is not a multiple of the block:
    a pixel without budget costs its lane one fetch and keeps its planes;
    rays and all 16 planes equal the plain version bit for bit."""
    cfg, scene, cam = _setup(device=cuda, width=size[0], height=size[1])
    st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=cuda), 42, 2)
    rows = st.n_samples.shape[0]
    vals = np.random.default_rng(5).integers(0, 5, cfg.n_pixels)
    vals[(np.arange(cfg.n_pixels) // 97) % 3 != 0] = 0
    b = torch.from_numpy(_pad(cfg, rows, vals)).to(cuda)
    planes = state_to_planes(st)
    pk, pp = planes.clone(), planes.clone()
    rk = int(mega_regen.regen_budget_call(scene, cfg, cam, pk, 42, b,
                                          st.n_samples))
    rp = int(integrate.render_plain_budget(freeze_scene(scene), cfg, cam, pp,
                                           42, b, st.n_samples))
    assert rk == rp > 0
    assert torch.equal(pk, pp)
    untouched = torch.from_numpy(_pad(cfg, rows, vals) == 0).to(cuda)
    assert torch.equal(pk[:, untouched], planes[:, untouched])


@pytest.mark.gpu
def test_kernel_budget_launches_back_to_back(cuda):
    """Two budget launches queued on one stream equal one launch of the
    summed budgets: the work counter starts from 0 in each."""
    cfg, scene, cam = _setup(device=cuda)
    st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=cuda), 42, 1)
    rows = st.n_samples.shape[0]
    rs = np.random.default_rng(6)
    b1, b2 = (torch.from_numpy(_pad(cfg, rows, rs.integers(0, 3,
                                                           cfg.n_pixels))
                               ).to(cuda) for _ in range(2))
    two = mega_regen.render_budget_regen(scene, cfg, cam, st, 42, b1, 2)
    two = mega_regen.render_budget_regen(scene, cfg, cam, two, 42, b2, 2)
    one = mega_regen.render_budget_regen(scene, cfg, cam, st, 42, b1 + b2, 4)
    torch.cuda.synchronize()
    assert torch.equal(state_to_planes(two), state_to_planes(one))
    assert int(two.rays) == int(one.rays) > 0
    assert torch.equal(two.n_samples, one.n_samples)
