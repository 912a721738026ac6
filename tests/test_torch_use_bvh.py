"""``cfg.use_bvh`` in tpurt_torch against tpurt: the per-ray BVH walk of
tpurt's XLA integrator (``ops.intersect.bvh_hit`` against
``tpurt.ops.intersect.bvh_hit``) and renders with ``backend="xla"`` against
tpurt's XLA backend with the flag; the kernels ignore the flag, as
tpurt's do.

Tolerances: the walk's t against tpurt rtol 1e-5 (tpurt's walk runs under
jit, where XLA's CPU compiler may contract a product and a sum into an
FMA: 2.3e-6 relative on one near hit of 528), its normal and material
exact; against the port's own brute-force sweep, t exact (the same
Moller-Trumbore arithmetic); ray counts exact and images by the rule of
tests/test_golden.py.
"""

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.ops import intersect
from tpurt_torch.render import state_to_planes
from tpurt_torch.scene import freeze_scene

from test_torch_mesh import _rays
from test_torch_mesh_render import TORUS_CAM, _image_rule, _render_both

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tp():
    import types

    import tpurt
    import tpurt.ops.intersect
    return types.SimpleNamespace(tpurt=tpurt, isect=tpurt.ops.intersect)


@pytest.mark.parametrize("nu,nv,seed", [(8, 4, 31), (16, 8, 32)])
def test_bvh_hit_matches_tpurt(tp, nu, nv, seed):
    """The walk against tpurt's on 1024 seeded rays through the mesh:
    the same hit or miss, t rtol 1e-5, normal and material exact."""
    scene = tt.torus_mesh_scene(nu, nv, device=CPU)
    fs = freeze_scene(scene)
    o, d, _, _ = _rays(scene, 1024, seed)
    t, loc, n, mat, _ = intersect.bvh_hit(
        fs.triangles, tuple(torch.from_numpy(o)), tuple(torch.from_numpy(d)))
    j = tp.tpurt.scene.torus_mesh_scene(nu, nv)
    want = tp.isect.bvh_hit(o.T, d.T, j.bvh_dict(), max_leaf=j.bvh_max_leaf)
    w_t = np.asarray(want["t"])
    hit = w_t < 1e29
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(t.numpy() < 1e29, hit)
    np.testing.assert_allclose(t.numpy()[hit], w_t[hit], rtol=1e-5)
    np.testing.assert_array_equal(torch.stack(n).numpy().T,
                                  np.asarray(want["normal"]))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(want["mat"]))
    np.testing.assert_allclose(torch.stack(loc).numpy().T[hit],
                               np.asarray(want["loc"])[hit], rtol=1e-5,
                               atol=1e-5)


def test_bvh_hit_finds_the_sweeps_nearest_t():
    """On the port's own arithmetic the walk and the brute-force sweep
    find the same nearest t, bit for bit, and the same triangle wherever
    the nearest t is unique."""
    scene = tt.torus_mesh_scene(16, 8, device=CPU)
    fs = freeze_scene(scene)
    o, d = (tuple(torch.from_numpy(x)) for x in _rays(scene, 2048, 33)[:2])
    walk = intersect.bvh_hit(fs.triangles, o, d)
    sweep = intersect.closest_triangle(fs.triangles, o, d)
    assert torch.equal(walk[0], sweep[0])
    hit = sweep[0] < 1e29
    assert hit.float().mean() > 0.2
    # a tie on a shared edge goes to the first visited in the walk
    same = (walk[4] == sweep[4])[hit].float().mean()
    assert same > 0.99


def test_xla_use_bvh_render_matches_tpurt(tp):
    """backend="xla" with use_bvh against tpurt's XLA backend with it:
    torus_mesh_scene(8, 4), 128x64, depth 5, seed 77, 2 spp, 117899
    segments."""
    kw = dict(width=128, height=64, depth=5, use_bvh=True)
    rays_j, st, _, img_j, img = _render_both(
        tp, ("torus_mesh_scene", (8, 4)), kw, {}, TORUS_CAM, 77, 2)
    assert int(st.rays) == rays_j == 117899
    _image_rule(img, img_j)


def test_use_bvh_takes_the_walk_on_the_xla_paths_only(monkeypatch):
    """The walk runs for backend="xla" and the plain "wavefront" pool
    (tpurt's XLA paths); the kernels' plain versions keep the sweep."""
    calls = []
    walk = intersect.bvh_hit

    def counted(*a):
        calls.append(1)
        return walk(*a)

    monkeypatch.setattr(integrate, "bvh_hit", counted)
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    cam = tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=2.0)
    seen = {}
    for backend in ("xla", "wavefront", "pallas", "wavefront_fused"):
        cfg = tt.RenderConfig(width=24, height=12, depth=3, k_photons=2,
                              max_photon_bounces=2, backend=backend,
                              enable_photons=backend != "wavefront_fused",
                              wf_pool=256, use_bvh=True)
        calls.clear()
        a = tt.render(scene, cfg, cam, tt.init_state(cfg, device=CPU), 3, 1)
        seen[backend] = bool(calls)
        off = cfg.with_(use_bvh=False)
        b = tt.render(scene, off, cam, tt.init_state(off, device=CPU), 3, 1)
        assert int(a.rays) == int(b.rays) > 0, backend
        if not seen[backend]:
            assert torch.equal(state_to_planes(a), state_to_planes(b))
    assert seen == {"xla": True, "wavefront": True, "pallas": False,
                    "wavefront_fused": False}
