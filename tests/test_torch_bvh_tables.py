"""The node tables of the CUDA walk (``tpurt_torch/kernels/bvh.py
pack_tree``: each child's padded box and ref in its parent, leaves packed
into refs) against the trees they are built from, on the CPU.

The tables must decode to the tree ``accel.build_bvh`` (and
``accel.collapse_wide``) built: every child box equal to the padded box of
that tree's node bit for bit, the same leaf ranges, the same record order,
hence the same G rows. And a NumPy copy of the walk of ``csrc/bvh.cuh``
(one ref a trip, the near child next and the others stacked far-first,
ties in slot order, pruning on tn > cap only, NaN slab axes skipped) over
the table must return the brute-force nearest hit, with a stack no deeper
than the host proved. Everything here is exact: no tolerance.
"""

import numpy as np
import pytest
import torch

import tpurt_torch as tt
from tpurt_torch import accel
from tpurt_torch.kernels import bvh
from tpurt_torch.ops import intersect
from tpurt_torch.scene import freeze_scene, sphere_rows

CPU = "cpu"
torch.set_num_threads(1)
SPHERE_GROW = np.float32(2e-3)      # csrc/bvh.cuh kSphereGrow


def _tri_arrays(scene):
    return [getattr(scene, f"tri_{k}").numpy()
            for k in ("a", "e1", "e2", "n", "mat")]


def _tree(bvh_, width):
    """(tree, children lists) as pack_tree sees them."""
    if width >= 3:
        tree = accel.collapse_wide(bvh_, width)
        kids = [[int(c) for c in row if c != 0] for row in tree.children]
    else:
        tree = bvh_
        kids = [[int(l), int(r)] for l, r in zip(bvh_.left, bvh_.right)]
    return tree, kids


def _check_decodes(table, bvh_, width):
    """The table, walked from the root, is the tree: boxes bit for bit,
    leaf ranges, child order."""
    tree, kids = _tree(bvh_, width)
    lo, hi = bvh._pad_boxes(tree.bbox_min, tree.bbox_max)
    rec = bvh.unpack_nodes(table)
    seen = 0
    stack = [(0, 0)]                 # (record row, tree node)
    while stack:
        row, node = stack.pop()
        seen += 1
        if row != 0:                 # the root's own box is not stored
            assert rec[row, 0:3].tobytes() == lo[node].tobytes()
            assert rec[row, 3:6].tobytes() == hi[node].tobytes()
        if tree.count[node] > 0:
            assert (int(rec[row, 6]), int(rec[row, 7])) == \
                (int(tree.first[node]), int(tree.count[node]))
            continue
        assert rec[row, 7] == 0
        rows = [int(r) for r in rec[row, 8:] if r != 0]
        assert len(rows) == len(kids[node]) >= 2
        stack.extend(zip(rows, kids[node]))
    assert seen == rec.shape[0] == tree.count.shape[0]


TRI_TREES = [(8, 0, False), (8, 0, True), (4, 4, False), (4, 4, True),
             (2, 8, False), (16, 8, True), (200, 0, False), (1000, 0, False)]


@pytest.mark.parametrize("leaf,width,sah", TRI_TREES)
def test_tri_table_decodes_to_the_tree(leaf, width, sah):
    scene = tt.torus_mesh_scene(16, 8, device=CPU)       # 256 triangles
    a, e1, e2, n, mat = _tri_arrays(scene)
    rec, table, need = bvh.build_tri_bvh_tables(a, e1, e2, n, mat, leaf, sah,
                                                width)
    tree = bvh.tri_bvh(a, e1, e2, leaf, sah)
    assert table.dtype == np.float32 and table.shape[1] == 4
    assert table.shape[0] % 2 == 0
    _check_decodes(table, tree, width)
    # the records stay in the tree's leaf order
    assert rec[:, 13].astype(np.int64).tolist() == tree.order.tolist()
    np.testing.assert_array_equal(rec[:, 0:3], a[tree.order])
    assert 1 <= need <= bvh.STACK_DEPTH - 1
    if leaf >= 256:                  # one leaf: a leaf record at the root
        assert table.shape == (2, 4)
        assert table.view(np.int32)[:, 3].tolist() == [0, -256]


@pytest.mark.parametrize("leaf,width,sah", [(4, 0, False), (4, 8, False),
                                            (8, 4, True)])
def test_sphere_table_decodes_to_the_tree(leaf, width, sah):
    fs = freeze_scene(tt.instanced_scene(200, device=CPU))
    _, tree_idx = bvh.split_huge_spheres(fs.spheres)
    rows = sphere_rows(fs.spheres)[tree_idx]
    radius = np.asarray([fs.spheres[i].r for i in tree_idx], np.float32)
    got_rows, table, need = bvh.build_sphere_bvh_tables(rows, radius, leaf,
                                                        sah, width)
    tree = bvh.sphere_bvh(rows, radius, leaf, sah)
    _check_decodes(table, tree, width)
    np.testing.assert_array_equal(got_rows, rows[tree.order])
    assert 1 <= need <= bvh.STACK_DEPTH - 1


@pytest.mark.parametrize("leaf,width", [(8, 0), (4, 8)])
def test_g_rows_follow_the_records(leaf, width):
    """The G rows are built from the records row for row, so the new node
    table leaves them as they were: the rows of the tree-ordered
    triangles."""
    scene = tt.torus_mesh_scene(16, 8, device=CPU)
    a, e1, e2, n, mat = _tri_arrays(scene)
    rec, _, _ = bvh.build_tri_bvh_tables(a, e1, e2, n, mat, leaf, False,
                                         width)
    o = bvh.tri_bvh(a, e1, e2, leaf).order
    want = intersect.build_gmat(bvh.tri_records(a[o], e1[o], e2[o], n[o],
                                                mat[o], o))
    assert intersect.build_gmat(rec).tobytes() == want.tobytes()


# ----- a NumPy copy of the walk -----

def _node_hit(lo, hi, o, inv, cap, grow):
    lo, hi = lo.copy(), hi.copy()
    if grow > 0:
        m = grow * max(np.abs(o - lo).max(), np.abs(o - hi).max())
        lo, hi = lo - np.float32(m), hi + np.float32(m)
    with np.errstate(invalid="ignore", over="ignore"):
        t0, t1 = (lo - o) * inv, (hi - o) * inv
    ok = ~(np.isnan(t0) | np.isnan(t1))
    tn = max([np.float32(-np.inf)] + list(np.minimum(t0, t1)[ok]))
    tf = min([np.float32(np.inf)] + list(np.maximum(t0, t1)[ok]))
    return not (tn > tf or tf <= 0.0 or tn > cap), tn


def _walk(table, o, d, visit, cap, grow=np.float32(0)):
    """csrc/bvh.cuh bvh_walk for one ray. ``visit(first, count)`` sweeps a
    leaf, ``cap()`` is the current pruning distance. Returns the deepest
    stack it held."""
    bits = table.view(np.int32)
    with np.errstate(divide="ignore"):
        inv = np.float32(1.0) / d
    stack, deepest, ref = [], 0, 0
    while True:
        nxt = None
        if ref < 0:
            visit(~ref & 0xFFFFFF, (~ref >> 24) + 1)
        else:
            k = int(bits[2 * ref + 1, 3])
            if k < 0:
                visit(int(bits[2 * ref, 3]), -k)
            else:
                c = cap()
                hits = []
                for s in range(k):
                    row = 2 * (ref + s)
                    ok, tn = _node_hit(table[row, 0:3], table[row + 1, 0:3],
                                       o, inv, c, grow)
                    if ok:
                        hits.append((tn, s, int(bits[row, 3])))
                hits.sort(key=lambda h: (h[0], h[1]))   # ties: slot order
                if hits:
                    nxt = hits[0][2]
                    stack.extend(h[2] for h in reversed(hits[1:]))
                    deepest = max(deepest, len(stack))
        if nxt is None:
            if not stack:
                return deepest
            nxt = stack.pop()
        ref = nxt


def _rays(lo, hi, n, seed):
    rs = np.random.default_rng(seed)
    c, ext = (lo + hi) / 2, (hi - lo) / 2 + 0.5
    o = c + rs.uniform(-2, 2, (n, 3)) * ext
    tgt = c + rs.uniform(-1, 1, (n, 3)) * ext
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grid_quads():
    """A 6x6 quad grid at z = 1..4: 288 axis-aligned triangles."""
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
                          [], device=CPU)


@pytest.mark.parametrize("case,leaf,width,sah", [
    ("torus", 8, 0, False), ("torus", 4, 4, False), ("torus", 2, 8, True),
    ("torus", 200, 0, False), ("nan_planes", 8, 0, False),
    ("nan_planes", 8, 8, False)])
def test_numpy_walk_finds_the_brute_force_triangle(case, leaf, width, sah):
    """The walk over the new table takes the brute-force sweep's winner,
    the least (t, scene index), on seeded rays and on rays whose slab test
    gives NaN; its stack stays within the proven need."""
    if case == "torus":
        scene = tt.torus_mesh_scene(16, 8, device=CPU)
        pts = scene.tri_a.numpy()
        o, d = _rays(pts.min(0), pts.max(0), 300, 11)
    else:
        scene = _grid_quads()
        n = 200
        o = np.stack([(np.arange(n) % 7), ((np.arange(n) // 7) % 12) / 2.0,
                      np.full(n, -3.0)], 1).astype(np.float32)
        d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    fs = freeze_scene(scene)
    rec, table, need = bvh.build_tri_bvh_tables(*_tri_arrays(scene), leaf,
                                                sah, width)
    to = lambda x: tuple(c[:, None] for c in torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x.T)))
    t_all, valid = intersect._tri_hits(fs.triangles, 0, fs.triangles.count,
                                       to(o), to(d))
    t_all, valid = t_all.numpy(), valid.numpy()
    want_t, *_, want_i = intersect.closest_triangle(
        fs.triangles, tuple(torch.from_numpy(np.ascontiguousarray(o.T))),
        tuple(torch.from_numpy(np.ascontiguousarray(d.T))))
    index = rec[:, 13].astype(np.int64)
    hits = 0
    for r in range(o.shape[0]):
        best = [np.float32(intersect.MISS), 2 ** 31 - 1]

        def visit(first, count):
            for i in index[first:first + count]:
                if valid[r, i] and (t_all[r, i], i) < tuple(best):
                    best[:] = [t_all[r, i], int(i)]

        deepest = _walk(table, o[r], d[r], visit, lambda: best[0])
        assert deepest <= need
        assert best[0] == want_t[r].numpy()
        if best[0] < intersect.HIT:
            hits += 1
            assert best[1] == int(want_i[r])
    assert hits > o.shape[0] // 4


@pytest.mark.parametrize("leaf,width", [(4, 0), (4, 8)])
def test_numpy_walk_finds_the_brute_force_sphere(leaf, width):
    """The sphere tree, its boxes grown as the kernel grows them: the walk
    takes the least (t, scene index) of a float32 sweep over every row."""
    fs = freeze_scene(tt.instanced_scene(200, device=CPU))
    _, tree_idx = bvh.split_huge_spheres(fs.spheres)
    all_rows = sphere_rows(fs.spheres)[tree_idx]
    radius = np.asarray([fs.spheres[i].r for i in tree_idx], np.float32)
    rows, table, need = bvh.build_sphere_bvh_tables(all_rows, radius, leaf,
                                                    False, width)
    c = rows[:, 0:3]
    o, d = _rays(c.min(0), c.max(0), 200, 5)
    hits = 0
    for r in range(o.shape[0]):
        oc = o[r] - c
        a = np.float32(d[r] @ d[r])
        half_b = (oc * d[r]).sum(1, dtype=np.float32)
        disc = half_b * half_b - a * ((oc * oc).sum(1, dtype=np.float32)
                                      - rows[:, 3])
        t = (-half_b - np.sqrt(np.maximum(disc, 0))) / a
        t = np.where((disc > 0) & (t > 0), t, np.float32(intersect.MISS)
                     ).astype(np.float32)
        key = sorted(zip(t, rows[:, 7]))[0]
        best = [np.float32(intersect.MISS), 2 ** 31 - 1]

        def visit(first, count):
            for i in range(first, first + count):
                if t[i] < intersect.MISS and (t[i], rows[i, 7]) < tuple(best):
                    best[:] = [t[i], rows[i, 7]]

        assert _walk(table, o[r], d[r], visit, lambda: best[0],
                     SPHERE_GROW) <= need
        assert best[0] == key[0]
        if key[0] < intersect.HIT:
            hits += 1
            assert best[1] == key[1]
    assert hits > o.shape[0] // 4
