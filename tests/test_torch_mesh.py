"""Meshes in tpurt_torch against tpurt: the BVH builder, the OBJ/MTL
parsers, the mesh presets, the triangle sweeps, the walk's host tables;
and, on a CUDA device, the BVH walks (csrc/bvh.cuh) against their plain
version, the brute-force sweeps.

tpurt is imported inside the fixture ``tp`` so the GPU cases (marker
``gpu``) also run where JAX is not installed:
``python -m pytest tests/test_torch_mesh.py -m gpu --noconftest``.

Tolerances: builder output, scene arrays, triangle t and material exact;
normals and shadow factors against tpurt rtol 1e-6 (XLA may contract a
product and a sum into an FMA); the walks against the brute-force sweeps
on the card bit for bit, except the sphere tree's shadow factor, which
multiplies in walk order (rtol 1e-6).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import accel, integrate
from tpurt_torch.interop import scene_from_numpy
from tpurt_torch.kernels import bvh
from tpurt_torch.ops import intersect
from tpurt_torch.scene import freeze_scene
from tpurt_torch.utils import obj

from test_torch_mesh_render import (FIELD_CAM, TORUS_CAM, _image_rule,
                                    _render_both)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tp():
    import jax
    import jax.numpy as jnp

    import tpurt
    import tpurt.accel
    import tpurt.ops.intersect
    import tpurt.utils.obj
    from tpurt.kernels import bvh_pallas
    return types.SimpleNamespace(jax=jax, jnp=jnp, tpurt=tpurt,
                                 accel=tpurt.accel, obj=tpurt.utils.obj,
                                 isect=tpurt.ops.intersect, bp=bvh_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU machine run "
                    "python3 -m pytest tests/test_torch_mesh.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def _soup(T, seed):
    """T random triangles: (tri_min, tri_max) boxes and a, e1, e2."""
    rs = np.random.default_rng(seed)
    a = rs.uniform(-6, 6, (T, 3)).astype(np.float32)
    e1 = rs.uniform(-0.6, 0.6, (T, 3)).astype(np.float32)
    e2 = rs.uniform(-0.6, 0.6, (T, 3)).astype(np.float32)
    v1, v2 = a + e1, a + e2
    return (np.minimum(a, np.minimum(v1, v2)),
            np.maximum(a, np.maximum(v1, v2)), a, e1, e2)


def _assert_fields_equal(got, want):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


# ----- the builder -----

@pytest.mark.parametrize("T,leaf,sah", [
    (1, 2, False), (7, 1, False), (64, 2, False), (700, 4, False),
    (700, 16, False), (5, 2, True), (64, 4, True), (700, 8, True)])
def test_build_bvh_equals_tpurt(tp, T, leaf, sah):
    lo, hi, *_ = _soup(T, seed=T + leaf)
    _assert_fields_equal(accel.build_bvh(lo, hi, leaf, sah=sah),
                         tp.accel.build_bvh(lo, hi, leaf, sah=sah))


@pytest.mark.parametrize("width", [4, 8])
def test_collapse_wide_equals_tpurt(tp, width):
    lo, hi, *_ = _soup(500, seed=width)
    got = accel.collapse_wide(accel.build_bvh(lo, hi, 4), width)
    want = tp.accel.collapse_wide(tp.accel.build_bvh(lo, hi, 4), width)
    _assert_fields_equal(got, want)
    assert accel.wide_max_stack(got) == tp.accel.wide_max_stack(want)
    accel.validate_wide_bvh(got, accel.build_bvh(lo, hi, 4))


# ----- OBJ / MTL -----

MTL = """newmtl red
Kd 0.7 0.1 0.1
Ns 10
newmtl glass
Ni 1.5
d 0.0
illum 7
newmtl gold
Ks 1.0 0.71 0.29
Pm 1.0
Pr 0.1
newmtl tr
Kd 1 1 1
Tr 0.8
"""

OBJ = """mtllib m.mtl missing.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
usemtl red
v 0 0 1
v 1 0 1
v 1 1 1
f -3 -2 -1
usemtl glass
f 1/1 2/2 5/5
usemtl gold
f 2//1 3//1 5//1 6//1
usemtl nosuch
f 2 3 5
"""


def _write_obj(tmp_path):
    (tmp_path / "m.mtl").write_text(MTL)
    (tmp_path / "m.obj").write_text(OBJ)
    return str(tmp_path / "m.obj")


def test_obj_and_mtl_parsers_equal_tpurt(tp, tmp_path):
    path = _write_obj(tmp_path)
    for got, want in zip(obj.parse_obj(path), tp.obj.parse_obj(path)):
        np.testing.assert_array_equal(got, want)
    got, want = obj.parse_obj_mtl(path), tp.obj.parse_obj_mtl(path)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]
    defs = obj.parse_mtl(str(tmp_path / "m.mtl"))
    assert defs == tp.obj.parse_mtl(str(tmp_path / "m.mtl"))
    for name, fields in defs.items():
        assert dataclasses.astuple(obj.mtl_to_material(fields)) == \
            dataclasses.astuple(tp.obj.mtl_to_material(fields)), name


def test_load_obj_with_mtl_equals_tpurt(tp, tmp_path):
    path = _write_obj(tmp_path)

    def scene(pkg):
        mats = [pkg.Material.diffuse((0.8, 0.8, 0.8))]
        mesh = pkg.scene.MeshData(material_id=0, translation=(0.5, 1.0, 2.0),
                                  rotation_deg=30.0, scale=2.0)
        mesh.load_obj(path, materials=mats)
        lights = [pkg.Light.point((0.0, 5.0, 0.0), (1.0, 1.0, 1.0), 10.0)]
        return pkg.build_scene(mats, [], [mesh], lights, max_leaf_prims=3)

    _assert_fields_equal(scene(tt), scene(tp.tpurt))


# ----- scenes -----

@pytest.mark.parametrize("name,args", [
    ("tri_test_scene", ()), ("torus_mesh_scene", (8, 4)),
    ("torus_field_scene", (2, 8, 4)), ("instanced_scene", (48,))])
def test_mesh_scenes_equal(tp, name, args):
    want = getattr(tp.tpurt.scene, name)(*args)
    _assert_fields_equal(getattr(tt, name)(*args), want)
    via = scene_from_numpy({f.name: np.asarray(getattr(want, f.name))
                            for f in dataclasses.fields(want)})
    _assert_fields_equal(via, want)
    assert via.to("cpu").num_triangles == want.num_triangles


# ----- the plain sweeps against tpurt -----

def _rays(scene, n, seed):
    """Seeded rays through the scene's triangle (or sphere) bounds: o, d
    (3, n) float32 with unit d, t_max and lam (n,)."""
    rs = np.random.default_rng(seed)
    pts = (scene.tri_a.cpu().numpy() if scene.num_triangles
           else scene.sph_center.cpu().numpy()[1:])
    lo, hi = pts.min(0), pts.max(0)
    c, ext = (lo + hi) / 2, (hi - lo) / 2 + 0.5
    o = c + rs.uniform(-2, 2, (n, 3)) * ext
    tgt = c + rs.uniform(-1, 1, (n, 3)) * ext
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    t_max = rs.uniform(0.1, 2.0, n) * np.linalg.norm(tgt - o, axis=1)
    lam = rs.uniform(380.0, 780.0, n)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return f32(o.T), f32(d.T), f32(t_max), f32(lam)


@pytest.mark.parametrize("seed", [1, 2])
def test_triangle_sweeps_match_tpurt(tp, seed):
    """closest_triangle / occluded_triangle against tpurt's
    closest_triangle_hit / shadow_attenuation, run op by op (no jit, so no
    FMA contraction): t, mat and occlusion exact, normals rtol 1e-6."""
    scene = tt.torus_mesh_scene(8, 4)
    o, d, tm, lam = _rays(scene, 2048, seed)
    fs = freeze_scene(scene)
    to = lambda x: tuple(torch.from_numpy(x))  # noqa: E731
    t, _, n, mat, _ = intersect.closest_triangle(fs.triangles, to(o), to(d))
    occ = intersect.occluded_triangle(fs.triangles, to(o), to(d),
                                      torch.from_numpy(tm))
    j = tp.tpurt.scene.torus_mesh_scene(8, 4)
    with tp.jax.disable_jit():
        want = tp.isect.closest_triangle_hit(
            o.T, d.T, j.tri_a, j.tri_e1, j.tri_e2, j.tri_n, j.tri_mat,
            chunk=100)
        w_occ = tp.isect.shadow_attenuation(
            o.T, d.T, tm, lam, j.sph_center[:0], j.sph_radius[:0],
            j.sph_mtype[:0], j.sph_ior[:0], j.tri_a, j.tri_e1, j.tri_e2,
            tri_chunk=100)
    hit = np.asarray(want["t"]) < 1e29
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(t.numpy(), np.asarray(want["t"]))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(want["mat"]))
    np.testing.assert_allclose(torch.stack(n).numpy().T[hit],
                               np.asarray(want["normal"])[hit], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(w_occ) == 0.0)


def test_scene_shadow_matches_tpurt(tp):
    """integrate._shadow (spheres with Fresnel, then triangles) against
    tpurt's shadow_attenuation: rtol 1e-6."""
    scene = tt.torus_mesh_scene(8, 4)
    o, d, tm, lam = _rays(scene, 2048, 3)
    got = integrate._shadow(freeze_scene(scene), tuple(torch.from_numpy(o)),
                            tuple(torch.from_numpy(d)), torch.from_numpy(tm),
                            torch.from_numpy(lam))
    j = tp.tpurt.scene.torus_mesh_scene(8, 4)
    with tp.jax.disable_jit():
        want = np.asarray(tp.isect.shadow_attenuation(
            o.T, d.T, tm, lam, j.sph_center, j.sph_radius, j.sph_mtype,
            j.sph_ior, j.tri_a, j.tri_e1, j.tri_e2))
    assert 0.1 < (want == 0.0).mean() < 0.9 and (want == 1.0).mean() > 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_chunked_sphere_sweeps_match_the_loop():
    """Past SPHERE_LOOP_MAX spheres the sweeps run chunked: the same
    nearest sphere bit for bit, the shadow product within rtol 1e-6."""
    scene = tt.instanced_scene(120)
    fs = freeze_scene(scene)
    o, d, tm, lam = (torch.from_numpy(x) for x in _rays(scene, 1024, 4))
    o, d = tuple(o), tuple(d)
    small = intersect.SPHERE_LOOP_MAX
    try:
        intersect.SPHERE_LOOP_MAX = 10 ** 6
        want = intersect.closest_sphere(fs.spheres, o, d)
        want_at = intersect.shadow_spheres(fs.spheres, o, d, tm, lam)
    finally:
        intersect.SPHERE_LOOP_MAX = small
    got = intersect.closest_sphere(fs.spheres, o, d, fs.sph_rows)
    got_at = intersect.shadow_spheres(fs.spheres, o, d, tm, lam, fs.sph_rows)
    assert (want[0] < 1e29).float().mean() > 0.3
    for g, w in zip(got, want):
        g, w = (torch.stack(g), torch.stack(w)) if isinstance(g, tuple) \
            else (g, w)
        assert torch.equal(g, w)
    np.testing.assert_allclose(got_at.numpy(), want_at.numpy(), rtol=1e-6)


# ----- the walk's host tables -----

def _leaf_rows(nodes):
    leaf = nodes[:, 7] > 0
    return [(int(f), int(c)) for f, c in zip(nodes[leaf, 6], nodes[leaf, 7])]


@pytest.mark.parametrize("leaf,width,sah", [
    (8, 0, False), (8, 8, False), (4, 4, True), (64, 0, False)])
def test_tri_tables_invariants(leaf, width, sah):
    """Every triangle in exactly one leaf, its record equal to the scene's
    arrays at its scene index; every child box inside its parent's and
    every leaf box around its triangles."""
    scene = tt.torus_mesh_scene(16, 8)
    a, e1, e2, n, mat = (getattr(scene, f"tri_{k}").numpy()
                         for k in ("a", "e1", "e2", "n", "mat"))
    rec, nodes = bvh.build_tri_bvh_tables(a, e1, e2, n, mat, leaf, sah,
                                          width)
    rows = sorted(i for f, c in _leaf_rows(nodes) for i in range(f, f + c))
    assert rows == list(range(a.shape[0]))
    idx = rec[:, 13].astype(np.int64)
    assert sorted(idx) == list(range(a.shape[0]))
    for k, (lo, arr) in enumerate(((0, a), (3, e1), (6, e2), (9, n))):
        np.testing.assert_array_equal(rec[:, lo:lo + 3], arr[idx])
    np.testing.assert_array_equal(rec[:, 12], mat[idx])
    for i in range(nodes.shape[0]):
        if nodes[i, 7] > 0:
            f, c = int(nodes[i, 6]), int(nodes[i, 7])
            verts = np.concatenate([rec[f:f + c, 0:3],
                                    rec[f:f + c, 0:3] + rec[f:f + c, 3:6],
                                    rec[f:f + c, 0:3] + rec[f:f + c, 6:9]])
            assert (verts >= nodes[i, 0:3]).all()
            assert (verts <= nodes[i, 3:6]).all()
            assert c <= leaf
            continue
        kids = [int(k) for k in nodes[i, 8:] if k != 0]
        assert 2 <= len(kids) <= max(width, 2)
        for k in kids:
            assert (nodes[k, 0:3] >= nodes[i, 0:3]).all()
            assert (nodes[k, 3:6] <= nodes[i, 3:6]).all()


def _reachable_leaves(nodes, o, d, cap):
    """The leaves a ray can reach in csrc/bvh.cuh's walk when its cap is
    ``cap`` throughout (a walk's cap never drops below its final best):
    the node test node_hit in float32, NaN axes skipped."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _reachable(nodes, o, d, np.float32(1.0) / d, cap)


def _reachable(nodes, o, d, inv, cap):
    out, stack = [], [0]
    while stack:
        nd = nodes[stack.pop()]
        if nd[7] > 0:
            out.append((int(nd[6]), int(nd[7])))
            continue
        for k in nd[8:]:
            if k == 0:
                break
            box = nodes[int(k)]
            t0 = (box[0:3] - o) * inv
            t1 = (box[3:6] - o) * inv
            ok = ~(np.isnan(t0) | np.isnan(t1))
            lo = max([np.float32(-np.inf)] + list(np.minimum(t0, t1)[ok]))
            hi = min([np.float32(np.inf)] + list(np.maximum(t0, t1)[ok]))
            if not (lo > hi or hi <= 0.0 or lo > cap):
                stack.append(int(k))
    return out


def _grid_quads():
    """tpurt's NaN-slab regression scene (tests/test_bvh_pallas.py:853):
    a 6x6 quad grid at z = 1..4, 288 axis-aligned triangles."""
    mesh = tt.MeshData(material_id=0)
    verts, faces = [], []
    for z in range(1, 5):
        for i in range(6):
            for j in range(6):
                b = len(verts)
                verts += [(i, j, z), (i + 1, j, z), (i + 1, j + 1, z),
                          (i, j + 1, z)]
                faces += [(b, b + 1, b + 3), (b + 2, b + 3, b + 1)]
    mesh.add_triangles(np.asarray(verts, np.float32),
                       np.asarray(faces, np.int32))
    return tt.build_scene([tt.Material.diffuse((0.5, 0.5, 0.5))], [], [mesh],
                          [])


def _nan_plane_rays(n=256):
    """Rays straight down +z whose x/y sit exactly on integer box planes
    (0 * inf in the slab test) and between them."""
    xs = (np.arange(n) % 7).astype(np.float32)
    ys = ((np.arange(n) // 7) % 12).astype(np.float32) / 2.0
    o = np.stack([xs, ys, np.full(n, -3.0, np.float32)])
    d = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, n))
    return o, d


@pytest.mark.parametrize("width", [0, 8])
@pytest.mark.parametrize("rays", ["random", "nan_planes"])
def test_walk_reaches_every_winner(width, rays):
    """The pruning of the walk on CPU: for every ray, the brute-force
    nearest triangle lies in a leaf the walk reaches under the final cap,
    and so does an occluder whenever one exists under t_max."""
    scene = _grid_quads() if rays == "nan_planes" \
        else tt.torus_mesh_scene(16, 8)
    fs = freeze_scene(scene)
    if rays == "random":
        o, d, tm, _ = _rays(scene, 400, 7)
    else:
        o, d = _nan_plane_rays()
        tm = np.full(o.shape[1], 5.5, np.float32)
    host = [getattr(scene, f"tri_{k}").numpy()
            for k in ("a", "e1", "e2", "n", "mat")]
    rec, nodes = bvh.build_tri_bvh_tables(*host, 8, False, width)
    row_of = np.argsort(rec[:, 13])            # scene index -> record row
    to = lambda x: tuple(x_[:, None] for x_ in torch.from_numpy(x))  # noqa
    t_all, valid = intersect._tri_hits(fs.triangles, 0, fs.triangles.count,
                                       to(o), to(d))
    t, *_, best = intersect.closest_triangle(
        fs.triangles, tuple(torch.from_numpy(o)), tuple(torch.from_numpy(d)))
    occluders = valid & (t_all < torch.from_numpy(tm)[:, None])
    hits = 0
    for r in range(o.shape[1]):
        if float(t[r]) < 1e29:
            hits += 1
            row = row_of[int(best[r])]
            leaves = _reachable_leaves(nodes, o[:, r], d[:, r], t[r].numpy())
            assert any(f <= row < f + c for f, c in leaves), r
        if occluders[r].any():
            rows = row_of[torch.nonzero(occluders[r])[:, 0].numpy()]
            leaves = _reachable_leaves(nodes, o[:, r], d[:, r], tm[r])
            assert any(((f <= rows) & (rows < f + c)).any()
                       for f, c in leaves), r
    assert hits > o.shape[1] // 4


def test_sphere_split_and_tables_equal_tpurt(tp):
    fs = freeze_scene(tt.instanced_scene(200))
    from tpurt.kernels import mega_pallas
    j_fs = mega_pallas.freeze_scene(tp.tpurt.scene.instanced_scene(200))
    always, tree = bvh.split_huge_spheres(fs.spheres)
    j_always, j_tree = tp.bp.split_huge_spheres(j_fs.spheres)
    assert [fs.spheres[i].c for i in always] == [s.c for s in j_always]
    assert [fs.spheres[i].c for i in tree] == [s.c for s in j_tree]
    r = np.asarray([s.r for s in fs.spheres], np.float32)
    assert bvh.n_tree_spheres(r) == tp.bp.n_tree_spheres(r) == len(tree)
    cfg = tt.RenderConfig(pallas_sphere_bvh=True, pallas_bvh_leaf=8)
    geo = bvh.geometry(fs, cfg)
    assert geo.flat_rows[:, 7].tolist() == always.tolist()
    assert sorted(geo.sph[:, 7].long().tolist()) == tree.tolist()
    assert bvh.geometry(fs, cfg) is geo           # built once, then cached
    assert geo.tri is None and bvh.use_sph_walk(fs, cfg)
    assert not bvh.use_sph_walk(fs, cfg.with_(pallas_sphere_bvh=False))


def _chain(depth):
    """A binary tree ``depth`` inner nodes deep: inner node 2k has leaf
    2k+1 on its left and node 2k+2 on its right; node 2*depth is a leaf."""
    B = 2 * depth + 1
    idx = np.arange(B, dtype=np.int32)
    inner = (idx % 2 == 0) & (idx < 2 * depth)
    z3 = np.zeros((B, 3), np.float32)
    return accel.BVH(z3, z3 + 1.0, np.where(inner, idx + 1, 0),
                     np.where(inner, idx + 2, 0),
                     np.where(inner, 0, (idx + 1) // 2).astype(np.int32),
                     np.where(inner, 0, 1).astype(np.int32),
                     np.arange(depth + 1, dtype=np.int32))


def test_stack_proofs_raise():
    """A push past the walk's 64-entry stack must be unreachable: the
    table builders refuse a tree whose worst case could need one."""
    assert bvh.pack_nodes(_chain(61)).shape == (123, 16)
    with pytest.raises(ValueError, match="stack"):
        bvh.pack_nodes(_chain(62))
    with pytest.raises(ValueError, match="stack"):
        bvh.pack_nodes(_chain(70), width=3)
    assert bvh.pack_nodes(_chain(20), width=3).shape[1] == 16


def test_walk_modes_follow_tpurt_predicates():
    fs = freeze_scene(tt.torus_mesh_scene(8, 4))        # 64 triangles
    cfg = tt.RenderConfig(backend="pallas")
    assert bvh.use_tri_walk(fs, cfg)
    assert not bvh.use_tri_walk(fs, cfg.with_(pallas_static_unroll=64))
    assert not bvh.use_tri_walk(fs, cfg.with_(pallas_bvh=False))
    flat = bvh.geometry(fs, cfg.with_(pallas_bvh=False))
    assert flat.tri_nodes is None and flat.tri[:, 13].tolist() == \
        list(range(64))
    assert len(flat.flat_rows) == 3 and flat.sph is None
    assert not bvh.use_sph_walk(fs, cfg.with_(pallas_sphere_bvh=True))
    with pytest.raises(ValueError):
        tt.config.check_slice(cfg.with_(pallas_bvh_width=9))
    tt.config.check_slice(cfg.with_(
        pallas_bvh_width=8, pallas_bvh_sah=True, pallas_bvh_leaf=4,
        pallas_sphere_bvh=True, pallas_static_unroll=8, tri_chunk=64,
        sphere_chunk=64, pallas_bvh_chunk_threshold=100))


def test_probe_on_cpu_is_the_plain_version():
    scene = tt.torus_mesh_scene(8, 4)
    o, d, tm, lam = (torch.from_numpy(x) for x in _rays(scene, 512, 5))
    before = bvh.LAUNCHES
    t, loc, n, mat, atten = bvh.probe(scene, tt.RenderConfig(), o, d, tm,
                                      lam)
    fs = freeze_scene(scene)
    want = integrate.intersect_scene(fs, tuple(o), tuple(d))
    assert torch.equal(t, want[0]) and torch.equal(mat, want[3].int())
    assert torch.equal(loc, torch.stack(want[1]))
    assert torch.equal(atten, integrate._shadow(fs, tuple(o), tuple(d), tm,
                                                lam))
    assert bvh.LAUNCHES == before


# ----- renders against tpurt's XLA backend (the rest are in
# tests/test_torch_mesh_render.py, which splits the CPU time) -----

def test_sphere_bvh_render_matches_tpurt(tp):
    """instanced_scene(48) with pallas_sphere_bvh=True, leaf 8, 128x64,
    depth 5, seed 77, 2 spp."""
    kw = dict(width=128, height=64, depth=5)
    rays_j, st, _, img_j, img = _render_both(
        tp, ("instanced_scene", (48,)), kw,
        dict(backend="pallas", pallas_sphere_bvh=True, pallas_bvh_leaf=8),
        FIELD_CAM, 77, 2)
    assert int(st.rays) == rays_j > 0
    _image_rule(img, img_j)


def test_wide_walk_render_matches_tpurt(tp):
    """torus_mesh_scene(16, 8) (256 triangles) at pallas_bvh_width=8,
    64x32, depth 4, seed 77, 2 spp."""
    kw = dict(width=64, height=32, depth=4)
    rays_j, st, _, img_j, img = _render_both(
        tp, ("torus_mesh_scene", (16, 8)), kw,
        dict(backend="pallas", pallas_static_unroll=8, pallas_bvh_leaf=16,
             pallas_bvh_width=8), TORUS_CAM, 77, 2)
    assert int(st.rays) == rays_j > 0
    _image_rule(img, img_j)


# ----- the walks on the card against the brute-force sweeps -----

def _walk_vs_plain(scene, cfg, o, d, tm, lam, exact_atten=True):
    before = bvh.LAUNCHES
    got = bvh.probe(scene, cfg, o, d, tm, lam)
    assert bvh.LAUNCHES == before + 1
    fs = freeze_scene(scene)
    t, loc, n, mat = integrate.intersect_scene(fs, tuple(o), tuple(d))
    atten = integrate._shadow(fs, tuple(o), tuple(d), tm, lam)
    want = (t, torch.stack(loc), torch.stack(n), mat.int())
    for g, w in zip(got[:4], want):
        assert torch.equal(g, w)
    if exact_atten:
        assert torch.equal(got[4], atten)
    else:
        np.testing.assert_allclose(got[4].cpu().numpy(),
                                   atten.cpu().numpy(), rtol=1e-6)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("leaf,width", [(64, 0), (64, 8), (4, 0)])
def test_walk_matches_brute_force_on_cuda(cuda, leaf, width):
    scene = tt.torus_mesh_scene(45, 45).to(cuda)
    cfg = tt.RenderConfig(backend="pallas", pallas_bvh_leaf=leaf,
                          pallas_bvh_width=width)
    rays = [torch.from_numpy(x).to(cuda) for x in _rays(scene, 65536, 11)]
    t = _walk_vs_plain(scene, cfg, *rays)
    assert (t < 1e29).float().mean() > 0.5


@pytest.mark.gpu
def test_sphere_walk_matches_brute_force_on_cuda(cuda):
    scene = tt.instanced_scene(4096).to(cuda)
    cfg = tt.RenderConfig(backend="pallas", pallas_sphere_bvh=True,
                          pallas_bvh_leaf=16, pallas_bvh_width=8)
    rays = [torch.from_numpy(x).to(cuda) for x in _rays(scene, 65536, 12)]
    _walk_vs_plain(scene, cfg, *rays, exact_atten=False)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [0, 4, 8])
def test_nan_plane_rays_on_cuda(cuda, width):
    """tpurt's test_wide_walk_nan_slab_votes_hit on the card: rays on exact
    box planes lose no subtree."""
    scene = _grid_quads().to(cuda)
    o, d = (torch.from_numpy(x).to(cuda) for x in _nan_plane_rays())
    n = o.shape[1]
    tm = torch.full((n,), 5.5, device=cuda)
    lam = torch.full((n,), 550.0, device=cuda)
    cfg = tt.RenderConfig(backend="pallas", pallas_bvh_leaf=8,
                          pallas_bvh_width=width, pallas_static_unroll=8)
    t = _walk_vs_plain(scene, cfg, o, d, tm, lam)
    assert (t < 1e29).float().mean() > 0.5
