"""render_until, RenderConfig.parse_overrides and tpurt_torch.utils.image
against tpurt's.

- The four ``test_until_*`` cases of tests/test_presets_until.py on the
  port (32x16 Cornell, depth 3), exact as there, on backend "pallas" (on
  the CPU the regen kernel's plain version: the same states as "xla", in
  a third of the time).
- render_until's host loop against tpurt's, bit for bit: the port's loop
  driven over tpurt's own renders (carried over by interop) gives tpurt's
  ``info`` (rel_err to the last bit: the same float32 sums widened to
  float64 in the same order) and tpurt's final state; the port's own renders
  give tpurt's spp, batches, converged and ray count exactly on seed 11
  (tpurt's own pinned seed; on seeds 7 and 9 one roulette test in ~10^5
  lands on the other side of its threshold, ROADMAP's "RR boundary
  flips"), rel_err within rtol 1e-3 (the images agree by the golden rule,
  not bit for bit).
- parse_overrides: tpurt's dict on the same pairs.
- The image writers: tpurt's bytes exactly (NumPy on both sides), also
  from a torch tensor.
"""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch.interop import state_from_numpy
from tpurt_torch.utils import image

CPU = "cpu"
torch.set_num_threads(1)
W, H = 32, 16


@pytest.fixture(scope="module")
def tp():
    import tpurt
    import tpurt.render
    from tpurt.utils import image as jimage
    return types.SimpleNamespace(tpurt=tpurt, image=jimage,
                                 render=sys.modules["tpurt.render"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_until.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _setup(device=CPU, **kw):
    scene = tt.cornell_spheres_scene(device=device)
    cam = tt.make_camera((0, 5, -12), (0, 5, 0), vfov=60.0,
                         aspect_ratio=W / H)
    cfg = tt.RenderConfig(width=W, height=H, depth=3, backend="pallas",
                          **kw)
    return scene, cfg, cam


def _fields(st) -> dict:
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


# ----- the until cases of tests/test_presets_until.py -----

def test_until_loose_target_stops_at_min_batches():
    scene, cfg, cam = _setup()
    st, info = tt.render_until(scene, cfg, cam, tt.init_state(cfg, CPU), 7,
                               target_rel_err=1e9, batch_spp=2, max_spp=64)
    assert info["converged"] and info["batches"] == 2 and info["spp"] == 4
    assert st.iteration == 4


def test_until_unreachable_target_hits_max():
    scene, cfg, cam = _setup()
    st, info = tt.render_until(scene, cfg, cam, tt.init_state(cfg, CPU), 7,
                               target_rel_err=0.0, batch_spp=3, max_spp=8)
    assert not info["converged"] and info["spp"] == 8
    assert st.iteration == 8          # 3 + 3 + 2: capped exactly


def test_until_state_equals_plain_render():
    scene, cfg, cam = _setup()
    st_u, info = tt.render_until(scene, cfg, cam, tt.init_state(cfg, CPU),
                                 11, target_rel_err=1e9, batch_spp=2,
                                 max_spp=32)
    st_p = tt.render(scene, cfg, cam, tt.init_state(cfg, CPU), 11,
                     info["spp"])
    for f in dataclasses.fields(st_p):
        a, b = getattr(st_u, f.name), getattr(st_p, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name


def test_until_rel_err_shrinks():
    scene, cfg, cam = _setup()
    _, lo = tt.render_until(scene, cfg, cam, tt.init_state(cfg, CPU), 3,
                            target_rel_err=0.0, batch_spp=2, max_spp=4)
    _, hi = tt.render_until(scene, cfg, cam, tt.init_state(cfg, CPU), 3,
                            target_rel_err=0.0, batch_spp=2, max_spp=32)
    assert hi["rel_err"] < lo["rel_err"]


def test_until_rejects_bad_batches():
    scene, cfg, cam = _setup()
    for kw in (dict(batch_spp=0), dict(min_batches=1)):
        with pytest.raises(ValueError, match="min_batches >= 2"):
            tt.render_until(scene, cfg, cam, tt.init_state(cfg, CPU), 1,
                            **kw)


# ----- against tpurt -----

def _tpurt_setup(tp):
    kw = dict(width=W, height=H, depth=3, backend="xla")
    return (tp.tpurt.cornell_spheres_scene(), tp.tpurt.RenderConfig(**kw),
            tp.tpurt.make_camera((0, 5, -12), (0, 5, 0), vfov=60.0,
                                 aspect_ratio=W / H))


@pytest.mark.parametrize("target,max_spp", [(0.7, 24), (0.0, 11)])
def test_until_loop_is_tpurts(tp, monkeypatch, target, max_spp):
    """The port's loop over tpurt's renders: tpurt's info and state."""
    js, jcfg, jcam = _tpurt_setup(tp)
    want_st, want = tp.tpurt.render_until(
        js, jcfg, jcam, tp.render.init_state(jcfg), 5,
        target_rel_err=target, batch_spp=3, max_spp=max_spp)
    carried = [tp.render.init_state(jcfg)]

    def tpurts_render(scene, cfg, camera, state, base_seed, spp):
        carried[0] = tp.render.render(js, jcfg, jcam, carried[0],
                                      base_seed, spp)
        return state_from_numpy(_fields(carried[0]), device=CPU)

    # the module (tpurt_torch.render the attribute is the function)
    monkeypatch.setattr(sys.modules["tpurt_torch.render"], "render",
                        tpurts_render)
    scene, cfg, cam = _setup()
    st, info = tt.render_until(scene, cfg, cam, tt.init_state(cfg, CPU), 5,
                               target_rel_err=target, batch_spp=3,
                               max_spp=max_spp)
    assert info == want
    assert 1 < info["batches"] and (info["converged"] == (target > 0))
    np.testing.assert_array_equal(st.rgb_sum.numpy(),
                                  np.asarray(want_st.rgb_sum))


def test_until_matches_tpurt(tp):
    """The port's own renders: the same stopping point and ray count."""
    js, jcfg, jcam = _tpurt_setup(tp)
    want_st, want = tp.tpurt.render_until(
        js, jcfg, jcam, tp.render.init_state(jcfg), 11, target_rel_err=0.3,
        batch_spp=2, max_spp=16)
    scene, cfg, cam = _setup()
    st, info = tt.render_until(scene, cfg, cam, tt.init_state(cfg, CPU), 11,
                               target_rel_err=0.3, batch_spp=2, max_spp=16)
    assert {k: info[k] for k in ("spp", "batches", "converged")} == {
        k: want[k] for k in ("spp", "batches", "converged")}
    assert int(st.rays) == int(float(want_st.rays))
    np.testing.assert_allclose(info["rel_err"], want["rel_err"], rtol=1e-3)


def test_parse_overrides_is_tpurts(tp):
    pairs = ["qmc=True", "photon_strata=16", "backend=wavefront_fused",
             "sky_color=(1.0, 0.5, 0.25)", "light_sample=spatial",
             "tonemap_key=0.05"]
    assert tt.RenderConfig.parse_overrides(pairs) == \
        tp.tpurt.RenderConfig.parse_overrides(pairs)


# ----- utils.image -----

def _img(seed):
    return np.random.default_rng(seed).uniform(
        -0.2, 1.3, (7, 9, 3)).astype(np.float32)


def test_png_bytes_are_tpurts(tp):
    img = _img(0)
    u8 = (np.random.default_rng(1).random((7, 9, 3)) * 255).astype(np.uint8)
    gray = _img(2)[..., 0]
    for x in (img, u8, gray):
        assert image.png_bytes(x) == tp.image.png_bytes(x)
    assert image.png_bytes(torch.from_numpy(img)) == tp.image.png_bytes(img)
    np.testing.assert_array_equal(image.to_srgb8(img),
                                  tp.image.to_srgb8(img))


def test_pfm_and_ppm_files_are_tpurts(tp, tmp_path):
    img = _img(3)
    image.write_pfm(str(tmp_path / "t.pfm"), torch.from_numpy(img))
    tp.image.write_pfm(str(tmp_path / "j.pfm"), img)
    assert (tmp_path / "t.pfm").read_bytes() == (
        tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(image.read_pfm(str(tmp_path / "j.pfm")),
                                  img)
    image.write_ppm(str(tmp_path / "t.ppm"), img)
    tp.image.write_ppm(str(tmp_path / "j.ppm"), img)
    assert (tmp_path / "t.ppm").read_bytes() == (
        tmp_path / "j.ppm").read_bytes()
    image.write_png(str(tmp_path / "t.png"), img)
    assert (tmp_path / "t.png").read_bytes() == tp.image.png_bytes(img)
    with pytest.raises(ValueError, match="write_pfm needs"):
        image.write_pfm(str(tmp_path / "bad.pfm"), np.zeros((2, 2, 4)))


# ----- on the card -----

@pytest.mark.gpu
def test_until_on_the_card(cuda):
    """backend "pallas" on the card (the regen kernel): the final state
    equals one render of the same spp, bit for bit, and the stopping
    point is the CPU's (the card's plain arithmetic and the CPU's differ in
    the last bits of exp and sin, so rel_err within rtol 1e-3)."""
    scene, cfg, cam = _setup(cuda)
    st, info = tt.render_until(scene, cfg, cam, tt.init_state(cfg, cuda), 5,
                               target_rel_err=0.3, batch_spp=2, max_spp=16)
    st_p = tt.render(scene, cfg, cam, tt.init_state(cfg, cuda), 5,
                     info["spp"])
    assert st.rgb_sum.is_cuda
    for f in dataclasses.fields(st_p):
        a, b = getattr(st, f.name), getattr(st_p, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name
    scene_c, cfg_c, _ = _setup()
    _, info_c = tt.render_until(scene_c, cfg_c, cam,
                                tt.init_state(cfg_c, CPU), 5,
                                target_rel_err=0.3, batch_spp=2, max_spp=16)
    assert {k: info[k] for k in ("spp", "batches", "converged")} == {
        k: info_c[k] for k in ("spp", "batches", "converged")}
    np.testing.assert_allclose(info["rel_err"], info_c["rel_err"],
                               rtol=1e-3)
    # the blit kernel's image from the card, written as PNG bytes
    png = image.png_bytes(tt.resolve_image(cfg, st))
    assert png == image.png_bytes(tt.resolve_image(cfg, st_p).cpu())
