"""The G leaf of tpurt_torch's walks. On the CPU: its plain version, the
G sweep (``ops.intersect.closest_triangle_g``), against tpurt's G leaf in
an interpret-mode ``pallas_call`` on coherent rays of the kinds the GPU
cases use. On a CUDA device (marker ``gpu``):
the probe's warp-cooperative G leaf (``csrc/bvh.cuh closest_triangle_g``)
against the plain G sweep (``ops.intersect.closest_triangle_g`` through
``integrate.intersect_scene``) on ray sets that stress its schedule: a ray
count that is no multiple of the warp (the last warp's idle lanes only
help), leaves of 128 triangles, the wide tree, rays that all reach the
same leaves (every lane holds the same leaf: the shared sweep), pinhole
camera rays of bench config 6 (coherent neighbours), and the flat sweep
where no tree is walked.

Run on a GPU machine with
``python3 -m pytest tests/test_torch_gleaf.py -m gpu --noconftest``.

Tolerance: against tpurt, t bit for bit with the sweep's sums fused as
XLA's CPU dot fuses them. On the card, bit for bit (t, point, normal,
material and shadow factor): the cooperative leaf tests the same pairs with
the same sums as the plain sweep and takes the least (t, scene index), a
total order.
"""

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import integrate
from tpurt_torch.kernels import bvh
from tpurt_torch.ops import intersect
from tpurt_torch.scene import freeze_scene

from test_torch_mesh import _rays
from test_torch_mesh_render import TORUS_CAM
from test_torch_mxu_leaf import _tpurt_g_walk, tp  # noqa: F401 (fixture)


# the port builds on the CUDA card by default: the CPU tests ask for the CPU
CPU = "cpu"

torch.set_num_threads(1)


# ----- the plain G sweep against tpurt on the card's ray sets -----

@pytest.mark.parametrize("leaf", [8, 32])
@pytest.mark.parametrize("rays", ["one-leaf", "camera"])
def test_g_sweep_matches_tpurt_on_coherent_rays(tp, rays, leaf):
    """The plain G sweep (the kernel's reference) against tpurt's G leaf in
    its walk, in an interpret-mode pallas_call, on torus_mesh_scene(8, 4)
    with 512 coherent rays of the kinds the GPU cases give the warp leaf:
    rays into one leaf, and pinhole camera rays. With its sums fused as
    XLA's CPU dot fuses them, t bit for bit. (Rays aimed at edges and
    vertices are left out: on ~8% of them tpurt's walk returns a farther
    hit, or none, where the brute-force sweep finds a nearer one; the
    port's walk is held to that sweep, on the card.)"""
    scene = tt.torus_mesh_scene(8, 4, device=CPU)
    if rays == "one-leaf":
        o, d = _one_leaf_rays(scene, 512, 51)[:2]
    else:
        # a camera that frames the torus (centre (0, 1.5, 6))
        o, d = camera_rays(tt.make_camera((0.0, 4.0, 0.0), (0.0, 1.5, 6.0),
                                          vfov=30.0, aspect_ratio=2.0),
                           32, 16)[:2]
    want = _tpurt_g_walk(tp, tp.mp.freeze_scene(
        tp.tpurt.scene.torus_mesh_scene(8, 4)), leaf, o, d)
    cfg = tt.RenderConfig(backend="pallas", pallas_static_unroll=8,
                          pallas_bvh_leaf=leaf, pallas_mxu_leaf=True)
    fs = freeze_scene(scene)
    to = lambda x: tuple(torch.from_numpy(np.ascontiguousarray(x)))  # noqa: E731
    got = intersect.closest_triangle_g(bvh.gmat(fs, cfg), fs.triangles,
                                       to(o), to(d), fused=True)[0].numpy()
    assert (want < 1e29).mean() > 0.2
    np.testing.assert_array_equal(got, want)


# ----- on the card -----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run python3 -m "
                    "pytest tests/test_torch_gleaf.py -m gpu --noconftest")
    return torch.device("cuda")


def _one_leaf_rays(scene, n, seed):
    """n rays from a small patch in front of one triangle of the scene,
    aimed at points of a small disk around its centroid: they walk the same
    nodes and reach the same leaves."""
    rs = np.random.default_rng(seed)
    k = scene.num_triangles // 3
    a, e1, e2, nrm = (x[k].cpu().numpy().astype(np.float64) for x in (
        scene.tri_a, scene.tri_e1, scene.tri_e2, scene.tri_n))
    c = a + (e1 + e2) / 3.0
    size = min(np.linalg.norm(e1), np.linalg.norm(e2))
    o = c + 2.0 * nrm + rs.uniform(-1e-3, 1e-3, (n, 3))
    tgt = c + rs.uniform(-0.05, 0.05, (n, 3)) * size
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    t_max = np.full(n, 3.0)
    lam = rs.uniform(380.0, 780.0, n)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return f32(o.T), f32(d.T), f32(t_max), f32(lam)


def camera_rays(cam, width, height):
    """Unit pinhole rays through the pixel centres of ``cam`` in linear
    pixel order (a warp's lanes are neighbours in a row): o, d (3, P)
    float32, t_max 1e3 and lam 550 (P,)."""
    px = (np.arange(width * height) % width + 0.5) / width
    py = (np.arange(width * height) // width + 0.5) / height
    rows = cam.rows().astype(np.float64)
    d = (rows[3] + px[:, None] * rows[1] + py[:, None] * rows[2]
         - rows[0])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(rows[0], d.shape)
    n = width * height
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return (f32(o.T), f32(d.T), np.full(n, 1e3, np.float32),
            np.full(n, 550.0, np.float32))


def _g_probe_equals_plain(scene, cfg, rays):
    """The probe's G leaf against the plain G sweep, every output bit for
    bit; returns (t, pairs tested)."""
    o, d, tm, lam = rays
    before = bvh.LAUNCHES
    pairs = torch.zeros((1,), dtype=torch.int64, device=o.device)
    got = bvh.probe(scene, cfg, o, d, tm, lam, gleaf=True, pairs=pairs)
    assert bvh.LAUNCHES == before + 1
    fs = freeze_scene(scene)
    tri = integrate.TriMode("gleaf", bvh.gmat(fs, cfg))
    t, loc, n, mat = integrate.intersect_scene(fs, tuple(o), tuple(d), tri)
    want = (t, torch.stack(loc), torch.stack(n), mat.int(),
            integrate._shadow(fs, tuple(o), tuple(d), tm, lam))
    for name, g, w in zip(("t", "loc", "n", "mat", "atten"), got, want):
        assert torch.equal(g, w), name
    return t, int(pairs)


def _torus_only(dev):
    """bench config 6's torus alone (no spheres): every hit is the G
    leaf's."""
    verts, faces = tt.scene._torus(45, 45)
    mesh = tt.MeshData(material_id=2, translation=(0.0, 0.0, 6.0))
    mesh.add_triangles(verts, faces)
    return tt.build_scene([tt.Material.diffuse((0.5, 0.5, 0.5))] * 3, [],
                          [mesh], [], device=dev)


_SETS = {
    # name: (scene, leaf, width, walk, rays): the torus alone, or bench
    # config 6's scene (spheres and the torus) seen by its camera
    "ragged": ("torus", 64, 0, True, lambda s: _rays(s, 65536 - 37, 31)),
    "leaf128": ("torus", 128, 0, True, lambda s: _rays(s, 65536, 32)),
    "width8-leaf128": ("torus", 128, 8, True, lambda s: _rays(s, 40000, 33)),
    "one-leaf": ("torus", 64, 0, True, lambda s: _one_leaf_rays(s, 65536, 34)),
    "one-leaf-width8": ("torus", 64, 8, True,
                        lambda s: _one_leaf_rays(s, 4099, 35)),
    "camera": ("config6", 64, 0, True, lambda s: camera_rays(
        tt.make_camera(*TORUS_CAM, vfov=55.0, aspect_ratio=16 / 9), 480,
        270)),
    "flat": ("torus", 64, 0, False, lambda s: _rays(s, 2048 - 5, 36)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_SETS))
def test_g_probe_sets_bit_for_bit(cuda, case):
    kind, leaf, width, walk, make = _SETS[case]
    scene = (_torus_only(cuda) if kind == "torus"
             else tt.torus_mesh_scene(45, 45, device=cuda))
    cfg = tt.RenderConfig(backend="pallas", pallas_bvh=walk,
                          pallas_bvh_leaf=leaf, pallas_bvh_width=width,
                          pallas_mxu_leaf=True)
    rays = [torch.from_numpy(x).to(cuda) for x in make(scene)]
    t, pairs = _g_probe_equals_plain(scene, cfg, rays)
    hit = float((t < 1e29).float().mean())
    assert hit > (0.9 if case.startswith("one-leaf") else 0.2), hit
    if not walk:    # the flat sweep tests every triangle for every ray
        assert pairs == rays[0].shape[1] * scene.num_triangles
