"""tpurt_torch.render: continuation, checkpoints interchangeable with tpurt,
and the blit (resolve + tonemap) against tpurt's jnp and Pallas versions.

tpurt is imported inside the fixture ``tp`` so the GPU case (marker
``gpu``) runs where JAX is not installed. Tolerances are stated per test.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import tonemap as tm
from tpurt_torch.interop import state_to_numpy
from tpurt_torch.kernels import tonemap as blit

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"


# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores that pytest-xdist's workers share
torch.set_num_threads(1)

CAM = dict(look_from=(0.0, 5.0, -12.0), look_at=(0.0, 5.0, 0.0), vfov=60.0)


@pytest.fixture(scope="module")
def tp():
    import jax.numpy as jnp

    import tpurt
    import tpurt.render
    import tpurt.tonemap
    from tpurt.kernels import tonemap_pallas
    return types.SimpleNamespace(jnp=jnp, tpurt=tpurt,
                                 render=sys.modules["tpurt.render"],
                                 tonemap=sys.modules["tpurt.tonemap"],
                                 pallas=tonemap_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_mega_regen.py "
                    "tests/test_torch_render.py -m gpu --noconftest")
    return torch.device("cuda")


def _small(backend="pallas", **kw):
    cfg = tt.RenderConfig(width=32, height=16, depth=4, k_photons=2,
                          max_photon_bounces=3, backend=backend, **kw)
    cam = tt.make_camera(**CAM, aspect_ratio=2.0)
    return cfg, tt.cornell_spheres_scene(device=CPU), cam


def _assert_states_equal(a, b):
    for f in dataclasses.fields(tt.RenderState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_continuation_4_plus_4_equals_8(backend):
    """Exact (tolerance 0): sample seeds come from the iteration count."""
    cfg, scene, cam = _small(backend)
    st8 = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 1234, 8)
    st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 1234, 4)
    for _ in range(4):
        st = tt.render_step(scene, cfg, cam, st, 1234)
    _assert_states_equal(st, st8)
    assert st8.iteration == 8 and int(st8.rays) > 0


def test_preview_depth_and_uncounted_rays():
    cfg, scene, cam = _small()
    st = tt.render_step(scene, cfg, cam, tt.init_state(cfg, device=CPU), 3, depth=1)
    full = tt.render_step(scene, cfg, cam, tt.init_state(cfg, device=CPU), 3)
    assert st.iteration == 1 and 0 < int(st.rays) < int(full.rays)
    assert bool(torch.isfinite(tt.resolve_image(cfg, st)).all())
    off = cfg.with_(count_rays=False)
    assert int(tt.render(scene, off, cam, tt.init_state(off, device=CPU), 3, 1).rays) == 0
    with pytest.raises(ValueError):
        tt.render_step(scene, cfg, cam, tt.init_state(cfg, device=CPU), 3, depth=0)


def test_checkpoint_from_tpurt(tp, tmp_path):
    """tpurt.save_checkpoint -> tpurt_torch.load_checkpoint, then resume:
    equal to rendering straight through (exact)."""
    cfg, scene, cam = _small()
    st4 = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 99, 4)
    j_state = tp.render.RenderState(**{
        k: tp.jnp.asarray(v) for k, v in state_to_numpy(st4).items()})
    path = str(tmp_path / "from_tpurt")
    tp.render.save_checkpoint(path, tp.tpurt.RenderConfig(
        **dataclasses.asdict(cfg)), j_state)
    cfg2, st = tt.load_checkpoint(path, device=CPU)
    assert cfg2 == cfg
    # tpurt's own float32 ray count holds this small count exactly
    _assert_states_equal(st, st4)
    resumed = tt.render(scene, cfg2, cam, st, 99, 4)
    _assert_states_equal(resumed, tt.render(scene, cfg, cam,
                                            tt.init_state(cfg, device=CPU), 99, 8))


def test_checkpoint_to_tpurt(tp, tmp_path):
    """tpurt_torch.save_checkpoint -> tpurt.load_checkpoint (exact)."""
    cfg, scene, cam = _small()
    st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 5, 3)
    path = str(tmp_path / "to_tpurt.npz")
    tt.save_checkpoint(path, cfg, st)
    cfg_j, st_j = tp.render.load_checkpoint(path)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg)
    want = state_to_numpy(st)
    for k, v in want.items():
        got = np.asarray(getattr(st_j, k))
        np.testing.assert_array_equal(got, v.astype(got.dtype), err_msg=k)


@pytest.mark.parametrize("key,sat", [(0.8, 1.0), (0.05, 1.3), (2.0, 0.0)])
def test_resolve_image_matches_tpurt_blit(tp, key, sat):
    """The plain blit against tpurt.tonemap (bit-exact: the same IEEE
    operations) and against the Pallas blit in interpret mode (rtol 1e-6:
    XLA may fuse lum + sat*(c - lum) into one FMA)."""
    rs = np.random.default_rng(17)
    cfg = tt.RenderConfig(width=64, height=8, backend="pallas",
                          pallas_lanes=512, pallas_block_tiles=False)
    P = 512
    rgb = rs.normal(0.0, 3.0, (P, 3)).astype(np.float32)
    cnt = rs.integers(0, 9, P).astype(np.float32)
    st = tt.init_state(cfg, device=CPU)
    st = dataclasses.replace(st, rgb_sum=torch.from_numpy(rgb),
                             n_samples=torch.from_numpy(cnt))
    got = tt.resolve_image(cfg, st, key=key, saturation=sat).numpy()
    n = cfg.n_pixels
    want = np.asarray(tp.tonemap.tonemap(
        tp.tonemap.resolve(tp.jnp.asarray(rgb[:n]), tp.jnp.asarray(cnt[:n])),
        key, sat)).reshape(cfg.height, cfg.width, 3)
    np.testing.assert_array_equal(got, want)
    planes = tp.jnp.asarray(rgb.T.reshape(3, P // 128, 128))
    pal = np.asarray(tp.pallas.tonemap_planes(planes, tp.jnp.asarray(cnt),
                                              key, sat, interpret=True))
    pal = pal.reshape(3, P)[:, :n].T.reshape(cfg.height, cfg.width, 3)
    np.testing.assert_allclose(got, pal, rtol=1e-6, atol=1e-6)
    assert blit.LAUNCHES == 0


def test_resolve_radiance():
    cfg, scene, cam = _small()
    st = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 8, 2)
    rad = tt.resolve_radiance(cfg, st)
    n = cfg.n_pixels
    want = (st.rgb_sum[:n] / 2.0).reshape(cfg.height, cfg.width, 3)
    assert torch.equal(rad, want)
    assert float(rad.mean()) > 0.0


def test_state_size_mismatch_raises():
    cfg, scene, cam = _small()
    with pytest.raises(ValueError):
        tt.render(scene, cfg, cam, tt.init_state(cfg.with_(height=64), device=CPU), 1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("key,sat", [(0.8, 1.0), (0.05, 1.3)])
def test_blit_kernel_bit_exact(cuda, key, sat):
    """The CUDA blit against the plain version on the card: equal bits."""
    rs = np.random.default_rng(3)
    P, n = 1920 * 1088, 1920 * 1080
    rgb = torch.from_numpy(rs.normal(0.0, 4.0, (P, 3)).astype(np.float32)
                           ).to(cuda)
    cnt = torch.from_numpy(rs.integers(0, 17, P).astype(np.float32)).to(cuda)
    before = blit.LAUNCHES
    got = blit.tonemap_pixels(rgb, cnt, n, key, sat)
    assert blit.LAUNCHES == before + 1
    want = tm.tonemap(tm.resolve(rgb[:n], cnt[:n]), key, sat)
    assert torch.equal(got, want)


def test_default_device_needs_cuda(monkeypatch):
    """The entry points build on the card unless asked for the CPU: with
    no CUDA device they raise, never fall back."""
    from tpurt_torch.interop import state_from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.RenderConfig(width=16, height=8)
    for make in (lambda: tt.init_state(cfg), tt.cornell_spheres_scene,
                 lambda: tt.torus_mesh_scene(4, 3),
                 lambda: state_from_numpy(state_to_numpy(
                     tt.init_state(cfg, device=CPU)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert tt.init_state(cfg, device=CPU).device.type == "cpu"
    assert tt.cornell_spheres_scene(device=CPU).device.type == "cpu"


@pytest.mark.gpu
def test_default_device_is_the_card(cuda):
    cfg = tt.RenderConfig(width=16, height=8)
    assert tt.init_state(cfg).device == torch.device("cuda:0")
    assert tt.cornell_spheres_scene().device == torch.device("cuda:0")
