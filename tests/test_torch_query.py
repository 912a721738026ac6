"""tpurt_torch.query (trace_rays, occlusion, light_probe) against tpurt's.

The cases of tests/test_query.py on the port, then the port against
tpurt on the same seeded rays. Tolerances:
- hit, mat_id, mtype and albedo: exact, against tpurt's jitted queries.
- t and position: exact against tpurt run eagerly (jax.disable_jit, the
  same float32 operations in the same order); against the jitted queries
  within rtol 2e-4, since XLA contracts ``half_b*half_b - a*c`` into an FMA
  and the Cornell walls (radius 1000) amplify that in t. tpurt's per-ray
  BVH walk (use_bvh) orders its Moller-Trumbore terms otherwise: rtol
  1e-5 on t there.
- normal: within 2 float32 ulps of 1 (atol 2.4e-7) eagerly. The port
  normalizes by a reciprocal times the vector (the kernels' form), tpurt's
  XLA sphere sweep by a division.
- occlusion: exact in which segments are blocked, rtol 1e-6 on the
  Fresnel factor.
- light_probe: atol 1e-5 of the largest value, rtol 1e-4. The probe sums
  single-wavelength RGB whose CIE lobes cancel, and tpurt's jitted
  estimator contracts its products into FMAs.

tpurt is imported inside the fixture ``tp``, so the GPU cases (marker
``gpu``) run where JAX is not installed.
"""

import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch.interop import ray_hits_from_numpy

CPU = "cpu"
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tp():
    import jax
    import jax.numpy as jnp

    import tpurt
    return types.SimpleNamespace(jax=jax, jnp=jnp, tpurt=tpurt)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_query.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _scene(pkg, extra_mats=(), extra_sph=(), **dev):
    mats = [pkg.Material.diffuse((0.8, 0.2, 0.1)),
            pkg.Material.dielectric(ior=1.5, roughness=0.0)] + [
        m(pkg) for m in extra_mats]
    sph = [pkg.Sphere(0, 1.0, (0.0, 0.0, 5.0))] + [
        pkg.Sphere(*s) for s in extra_sph]
    lights = [pkg.Light.point([0.0, 5.0, 0.0], [1, 1, 1], 1.0, 0.0)]
    return pkg.build_scene(mats, sph, [], lights, **dev)


def _port_scene(**kw):
    return _scene(tt, device=CPU, **kw)


def _rays(n: int, seed: int):
    """Origins inside the Cornell box, directions of random length."""
    rs = np.random.default_rng(seed)
    o = np.stack([rs.uniform(-4, 4, n), rs.uniform(1, 9, n),
                  rs.uniform(-4, 4, n)], -1).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return o, d


# ----- the cases of tests/test_query.py -----

def test_closest_hit_analytic():
    scene = _port_scene()
    o = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    d = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    h = tt.trace_rays(scene, o, d)
    assert h.hit.tolist() == [True, False, False]
    # unit sphere at z=5: entry at t=4 (t is the exact root; the position
    # is pulled back by 0.9999)
    assert abs(float(h.t[0]) - 4.0) < 1e-4
    np.testing.assert_allclose(h.normal[0].numpy(), [0, 0, -1], atol=1e-3)
    np.testing.assert_allclose(h.albedo[0].numpy(), [0.8, 0.2, 0.1],
                               atol=1e-5)
    assert int(h.mat_id[0]) == 0 and int(h.mtype[0]) == 0
    assert int(h.mat_id[1]) == -1 and int(h.mtype[1]) == -1
    assert bool((h.position[1] == 0.0).all())
    assert bool((h.albedo[2] == 0.0).all())
    assert h.mat_id.dtype == h.mtype.dtype == torch.int32


def test_unnormalized_direction_scales_t():
    scene = _port_scene()
    o = np.zeros((1, 3))
    h1 = tt.trace_rays(scene, o, [[0.0, 0.0, 1.0]])
    h2 = tt.trace_rays(scene, o, [[0.0, 0.0, 2.0]])
    assert abs(float(h2.t[0]) * 2.0 - float(h1.t[0])) < 1e-4
    np.testing.assert_allclose(h1.position[0].numpy(),
                               h2.position[0].numpy(), atol=1e-4)


def test_matches_aov_pass():
    """The AOV pass's center-ray depths equal trace_rays on the same rays
    (exact: the same intersector)."""
    from tpurt_torch.camera import generate_rays
    from tpurt_torch.denoise import pixel_centers
    scene = _port_scene()
    cfg = tt.RenderConfig(width=16, height=8)
    cam = tt.make_camera((0, 0, 0), (0, 0, 5), vfov=60.0, aspect_ratio=2.0)
    aovs = tt.render_aovs(scene, cfg, cam)
    u, v = pixel_centers(16, 8, torch.device(CPU))
    o, d = generate_rays(cam, u.reshape(-1), v.reshape(-1))
    h = tt.trace_rays(scene, torch.stack(o, -1), torch.stack(d, -1), cfg)
    depth = torch.where(h.hit, h.t, 0.0).reshape(8, 16)
    assert torch.equal(depth, aovs.depth)
    assert bool((depth > 0).any())


def test_light_probe_inverse_square():
    """Point light straight above: radiance scales as 1/d^2 (one lane per
    call, so both draw the same stream)."""
    scene = _port_scene()
    nrm = np.array([[0.0, 1.0, 0.0]], np.float32)
    e1 = tt.light_probe(scene, [[0.0, 4.0, 0.0]], nrm, samples=4).numpy()
    e2 = tt.light_probe(scene, [[0.0, 2.5, 0.0]], nrm, samples=4).numpy()
    assert e1.shape == (1, 3) and np.isfinite(e1).all()
    assert float(e1.mean()) > 0.0
    np.testing.assert_allclose(e1[0], e2[0] * 2.5 ** 2, rtol=1e-3)
    e3 = tt.light_probe(scene, [[0.0, 4.0, 0.0]], -nrm, samples=4).numpy()
    assert float(np.abs(e3).max()) == 0.0


def test_light_probe_rejects_zero_samples():
    with pytest.raises(ValueError, match="samples"):
        tt.light_probe(_port_scene(), [[0.0, 4.0, 0.0]], [[0.0, 1.0, 0.0]],
                       samples=0)


def test_light_probe_shadowed():
    scene = _port_scene()   # opaque unit sphere at (0,0,5), light (0,5,0)
    pts = np.array([[0.0, -1.5, 5.0], [3.0, -1.5, 5.0]], np.float32)
    nrm = np.tile([[0.0, 1.0, 0.0]], (2, 1)).astype(np.float32)
    e = tt.light_probe(scene, pts, nrm, samples=8).numpy()
    assert float(np.abs(e[0]).max()) == 0.0       # fully blocked
    assert float(e[1].mean()) > 0.0


def test_occlusion_rules():
    scene = _port_scene(extra_sph=[(1, 1.0, (0.0, 0.0, -5.0))])  # glass
    o = np.zeros((3, 3))
    d = np.array([[0.0, 0.0, 1.0],    # through the diffuse sphere
                  [0.0, 1.0, 0.0],    # empty space
                  [0.0, 0.0, -1.0]])  # through smooth glass
    a = tt.occlusion(scene, o, d, t_max=10.0).numpy()
    assert a[0] == 0.0 and a[1] == 1.0
    # (1 - R)^2 with R = 0.04 at normal incidence for ior 1.5
    assert abs(a[2] - 0.96 ** 2) < 5e-3
    a2 = tt.occlusion(scene, o[:1], d[:1], t_max=3.5).numpy()
    assert a2[0] == 1.0


# ----- the port against tpurt -----

def _tpurt_hits(tp, scene, o, d, cfg=None, eager=False):
    if eager:
        with tp.jax.disable_jit():
            h = tp.tpurt.trace_rays(scene, o, d, cfg)
    else:
        h = tp.tpurt.trace_rays(scene, o, d, cfg)
    return {f: np.asarray(getattr(h, f)) for f in h._fields}


def test_trace_rays_matches_tpurt(tp):
    o, d = _rays(4096, 0)
    got = tt.trace_rays(tt.cornell_spheres_scene(device=CPU), o, d)
    js = tp.tpurt.cornell_spheres_scene()
    want = _tpurt_hits(tp, js, o, d)
    assert 0.3 < want["hit"].mean()
    for f in ("hit", "mat_id", "mtype", "albedo"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f)
    np.testing.assert_allclose(got.t.numpy(), want["t"], rtol=2e-4)
    np.testing.assert_allclose(got.position.numpy(), want["position"],
                               rtol=2e-4, atol=5e-4)
    eager = _tpurt_hits(tp, js, o, d, eager=True)
    for f in ("hit", "t", "position", "mat_id", "albedo", "mtype"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), eager[f],
                                      err_msg=f)
    np.testing.assert_allclose(got.normal.numpy(), eager["normal"], rtol=0,
                               atol=2.4e-7)
    # the interop carries tpurt's hits over unchanged
    back = ray_hits_from_numpy(want, device=CPU)
    assert torch.equal(back.hit, got.hit) and torch.equal(back.mat_id,
                                                          got.mat_id)


@pytest.mark.parametrize("use_bvh", [False, True])
def test_trace_rays_mesh_matches_tpurt(tp, use_bvh):
    """Triangles: the exact sweep and, under use_bvh, tpurt's per-ray BVH
    walk, against tpurt run eagerly; equally near triangles go to the
    least (t, scene index), as in tpurt's XLA sweep. t exact for the sweep
    and rtol 1e-5 for the walk."""
    o, _ = _rays(2048, 1)
    # aimed at the torus (centred at (0, ~1, 6)), a third of them missing
    target = np.random.default_rng(6).uniform(-2.0, 2.0, (2048, 3))
    d = (target + [0.0, 1.0, 6.0] - o).astype(np.float32)
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    got = tt.trace_rays(scene, o, d, tt.RenderConfig(use_bvh=use_bvh))
    js = tp.tpurt.torus_mesh_scene(8, 4)
    want = _tpurt_hits(tp, js, o, d, tp.tpurt.RenderConfig(use_bvh=use_bvh),
                       eager=True)
    tri = want["mat_id"] == int(np.asarray(js.tri_mat)[0])
    assert tri.mean() > 0.2
    for f in ("hit", "mat_id", "mtype", "albedo"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f)
    # the sweep: tpurt's arithmetic op by op; tpurt's walk forms its
    # Moller-Trumbore terms per ray in another order (2 ulps of t,
    # tests/test_torch_use_bvh.py)
    rtol = 1e-5 if use_bvh else 0.0
    np.testing.assert_allclose(got.t.numpy(), want["t"], rtol=rtol)
    np.testing.assert_allclose(got.position.numpy(), want["position"],
                               rtol=max(rtol, 1e-6), atol=1e-6)
    np.testing.assert_allclose(got.normal.numpy(), want["normal"], rtol=0,
                               atol=2.4e-7)


def test_occlusion_matches_tpurt(tp):
    o, d = _rays(4096, 2)
    rs = np.random.default_rng(3)
    t_max = rs.uniform(0.5, 20.0, 4096).astype(np.float32)
    lam = rs.uniform(380.0, 780.0, 4096).astype(np.float32)
    scene = tt.dispersive_scene(device=CPU)
    got = tt.occlusion(scene, o, d, t_max, lambda_nm=lam).numpy()
    want = np.asarray(tp.tpurt.occlusion(tp.tpurt.scene.dispersive_scene(),
                                         o, d, t_max, lambda_nm=lam))
    assert 0.05 < (want == 0.0).mean() < 0.95
    assert ((want > 0.0) & (want < 1.0)).any()      # through glass
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # a scalar t_max and wavelength broadcast
    np.testing.assert_array_equal(
        tt.occlusion(scene, o, d, 5.0).numpy(),
        tt.occlusion(scene, o, d, np.full(4096, 5.0, np.float32),
                     lambda_nm=np.full(4096, 550.0, np.float32)).numpy())


@pytest.mark.parametrize("mode", ["all", "power", "spatial"])
def test_light_probe_matches_tpurt(tp, mode):
    """light_probe in each light_sample mode on many_light_scene(20): the
    same streams, lights and shadows as tpurt's."""
    rs = np.random.default_rng(4)
    n = 512
    pts = np.stack([rs.uniform(-4, 4, n), rs.uniform(0.1, 5.0, n),
                    rs.uniform(-4, 4, n)], -1).astype(np.float32)
    nrm = rs.normal(size=(n, 3)).astype(np.float32)
    nrm[:, 1] = np.abs(nrm[:, 1]) + 0.5
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    got = tt.light_probe(tt.many_light_scene(20, device=CPU), pts, nrm,
                         samples=4, cfg=tt.RenderConfig(light_sample=mode),
                         seed=3).numpy()
    want = np.asarray(tp.tpurt.light_probe(
        tp.tpurt.many_light_scene(20), pts, nrm, samples=4,
        cfg=tp.tpurt.RenderConfig(light_sample=mode), seed=3))
    assert (want != 0.0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


# ----- on the card: the same calls on the GPU against the CPU -----

@pytest.mark.gpu
def test_queries_on_the_card_match_the_cpu(cuda):
    """trace_rays, occlusion and light_probe on CUDA tensors against the
    same calls on the CPU: hit, mat_id and mtype exact, the rest within
    1e-5 relative (the card's float32 ops are IEEE, its exp and sin are
    not PyTorch's CPU ones)."""
    cfg = tt.RenderConfig(width=64, height=32)
    cam = tt.make_camera((0, 5, -12), (0, 5, 0), vfov=60.0, aspect_ratio=2.0)
    out = {}
    for dev in (CPU, cuda):
        scene = tt.cornell_spheres_scene(device=dev)
        aovs = tt.render_aovs(scene, cfg, cam)
        o, d = _rays(4096, 5)
        h = tt.trace_rays(scene, o, d)
        occ = tt.occlusion(scene, o, d, 6.0)
        pts = h.position[h.hit][:256]
        nrm = h.normal[h.hit][:256]
        probe = tt.light_probe(scene, pts, nrm, samples=4)
        out[str(dev)] = [x.cpu() for x in (*h, occ, probe, *aovs)]
    for a, b in zip(out[CPU], out[str(cuda)]):
        if a.dtype in (torch.bool, torch.int32):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5 * float(
                a.abs().max()))
