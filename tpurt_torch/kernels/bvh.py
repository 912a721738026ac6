"""Host tables of the BVH walks (``csrc/bvh.cuh``) and the wrapper of the
walk probe (``csrc/bvh_probe.cu``).

Ported from ``tpurt/kernels/bvh_pallas.py:59-246``: the triangle and
sphere trees (``build_tri_bvh_tables``, ``build_sphere_bvh_tables``), the
node packing (``pack_nodes``, binary or wide), the stack proofs
(``assert_stack_fits``, ``accel.wide_max_stack``) and the split of the
scene-spanning spheres (``huge_sphere_mask``, ``n_tree_spheres``,
``split_huge_spheres``). The record layout is the port's own: flat
(N, 16) float32 records in global memory (tpurt's 8-records-per-128-lane
packing and guard rows are SMEM workarounds); node boxes are padded
outward so that the walk never prunes a hit the triangle test accepts.

The node table (``pack_nodes``) holds each child's padded box in its
parent: an inner node with k children is 2k rows of 16 bytes, two per
child, ``[lo.xyz, ref]`` and ``[hi.xyz, aux]``, so a binary node is 64
bytes and one vector fetch per level gives the walk both boxes and both
ids. ``ref`` and ``aux`` are int32 bit patterns. ``ref >= 0`` names a node
by the index of its first row pair; ``ref < 0`` is a leaf packed in place,
``~ref = first | (count - 1) << 24`` (a leaf of up to 128 primitives costs
no second fetch). ``aux`` of a node's first child is k; a leaf too long to
pack, or a tree that is one leaf, is a leaf record: one row pair with
``ref = first`` and ``aux = -count``. The root is node 0 and its own box
is not stored (the walk never tests it). ``unpack_nodes`` decodes a table
back into one record per node. The walk keeps its stack in shared memory,
sized per launch by the occupancy the host proves for the tree
(``pack_tree``).

The mode of each primitive kind follows tpurt's predicates
(``mega_pallas._use_tri_bvh`` / ``_use_sph_bvh``; the chunked modes,
which exist for the TPU's SMEM budget, are served by the same walk):
triangles are walked when ``cfg.pallas_bvh`` and there are more than
``cfg.pallas_static_unroll`` of them, else swept flat; spheres are walked
when ``cfg.pallas_sphere_bvh`` and more than 16 are left after the
scene-spanning ones, which stay in the flat sweep. ``geometry`` builds the
tables once per frozen scene (so once per Scene) and knob set, and caches
them on it: ``accel.BUILD_NS`` counts their host time, ``accel.TREE_BUILDS``
their trees, and under a profiler each is a ``scene.geometry`` span of
``tracing`` around the ``scene.bvh`` spans of its trees. A ``Geometry``
keeps what its triangle tree holds (``TreeStats``).

``cfg.pallas_mxu_leaf`` swaps the closest-hit leaf test of the regen
kernel's triangle walk for tpurt's G-matrix form
(``bvh_pallas.build_tri_gmat`` and ``_make_mxu_leaf_fn``), where
``mxu_leaf_engages`` says tpurt runs it: ``gmat`` holds its rows, built
from the walk's own leaf-ordered records and cached beside them. On the
card a warp sweeps each G leaf its rays reach together, lane j on rows
first + j, first + j + 32, ... (``csrc/bvh.cuh closest_triangle_g``), so a
leaf's rows are read contiguously in the table's own order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings

import numpy as np
import torch

from tpurt_torch import accel
from tpurt_torch.kernels import build
from tpurt_torch.ops.intersect import build_gmat
from tpurt_torch.scene import FrozenScene, Scene, freeze_scene, sphere_rows

STACK_DEPTH = 64          # csrc/bvh.cuh STACK_DEPTH
MAX_BVH_TRIS = 8192       # tpurt's single-table walk (bvh_pallas.py)
TRI_STRIDE = 16           # a e1 e2 n mat index - -
LEAF_PACK_MAX = 128       # primitives of a leaf packed into a child's ref
MAX_ALWAYS_SPHERES = 8
MIN_TREE_SPHERES = 16     # tpurt walks spheres only past this many
# node boxes grow by this share of their largest coordinate and extent,
# plus one float step: far more than the triangle test's rounding
BOX_PAD = 1e-4

LAUNCHES = 0   # probe launches
WALKS = 0      # path-kernel launches whose geometry walks a tree


def count_walk(geo) -> None:
    """Called by a path kernel's wrapper after each launch: counts the
    launch in WALKS when its geometry walks a triangle or sphere tree."""
    global WALKS
    if geo.walks:
        WALKS += 1


class GeomArgs(ctypes.Structure):
    """csrc/bvh.cuh ``struct Geom``, passed to every launcher by address."""
    _fields_ = [("tri", ctypes.c_void_p), ("tri_nodes", ctypes.c_void_p),
                ("sph", ctypes.c_void_p), ("sph_nodes", ctypes.c_void_p),
                ("gmat", ctypes.c_void_p),   # G rows; NULL: the exact leaf
                ("n_tri", ctypes.c_int), ("tri_walk", ctypes.c_int),
                ("n_sph_tree", ctypes.c_int),
                ("stack", ctypes.c_int)]     # stack entries a walk may hold


# ----- trees -----

def _tree_depth(bvh) -> int:
    """Max root-to-leaf depth of a binary tree."""
    if bvh.count.shape[0] == 0:
        return 0
    depth, stack = 0, [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if bvh.count[node] == 0:
            stack.append((int(bvh.left[node]), d + 1))
            stack.append((int(bvh.right[node]), d + 1))
    return depth


def assert_stack_fits(bvh) -> None:
    """A push past the walk's stack would skip geometry, so prove on the
    host that the worst case (one stacked entry per level plus both
    children at the deepest inner node) fits, as tpurt's
    ``_assert_stack_fits`` does."""
    d = _tree_depth(bvh)
    if d + 1 > STACK_DEPTH - 1:
        raise ValueError(f"BVH depth {d} can overflow the {STACK_DEPTH}-deep "
                         f"traversal stack; raise the leaf size")


def _pad_boxes(lo: np.ndarray, hi: np.ndarray):
    """Boxes grown outward by BOX_PAD of their scale, then one float step."""
    lo64, hi64 = lo.astype(np.float64), hi.astype(np.float64)
    scale = np.maximum(np.abs(lo64), np.abs(hi64)).max(axis=1, keepdims=True)
    extent = (hi64 - lo64).max(axis=1, keepdims=True)
    pad = BOX_PAD * (scale + extent)
    lo = np.nextafter((lo64 - pad).astype(np.float32), np.float32(-np.inf))
    hi = np.nextafter((hi64 + pad).astype(np.float32), np.float32(np.inf))
    return lo, hi


def _collapse(bvh, width: int):
    """(tree, children (B, k), stack need) of the walk over ``bvh``, binary
    or collapsed to ``width`` >= 3. The need is the stack entries the walk
    of csrc/bvh.cuh can hold at once: one per level for the binary walk,
    which keeps the near child in a register and stacks the far one;
    ``accel.wide_max_stack`` for the wide walk. Raises when it could pass
    STACK_DEPTH."""
    if width >= 3:
        tree = accel.collapse_wide(bvh, width)
        hw = accel.wide_max_stack(tree)
        if hw > STACK_DEPTH - 1:
            raise ValueError(f"wide BVH worst-case stack {hw} can overflow "
                             f"the {STACK_DEPTH}-deep traversal stack")
        return tree, tree.children, hw
    assert_stack_fits(bvh)
    return (bvh, np.stack([bvh.left, bvh.right], axis=1),
            max(1, _tree_depth(bvh)))


def pack_leaf(first: int, count: int) -> int:
    """A leaf's range as a child ref: ~(first | (count - 1) << 24)."""
    return ~(int(first) | (int(count) - 1) << 24)


def pack_nodes(bvh, width: int = 0) -> np.ndarray:
    """The node table alone (``pack_tree``)."""
    return pack_tree(bvh, width)[0]


def pack_tree(bvh, width: int = 0):
    """The (R, 4) float32 node table of a binary tree, or of its collapse
    into an up-to-``width``-ary tree (``accel.collapse_wide``) when width
    >= 3: each child's padded box and ref in its parent, two rows a child
    (the layout in this module's header); and the walk's stack need.
    Raises when the walk's stack could overflow."""
    tree, children, need = _collapse(bvh, width)
    count = np.asarray(tree.count)
    B = count.shape[0]
    kids = [[int(c) for c in children[i] if c != 0] if count[i] == 0 else []
            for i in range(B)]
    # a leaf gets a record of its own only where no ref can hold it
    record = [count[i] > 0 and (i == 0 or count[i] > LEAF_PACK_MAX)
              for i in range(B)]
    pairs = np.asarray([len(kids[i]) if count[i] == 0 else int(record[i])
                        for i in range(B)])
    at = np.concatenate([[0], np.cumsum(pairs)])    # node -> first row pair
    if at[-1] >= 1 << 24:
        raise ValueError(f"{at[-1]} node rows: the table is too large")
    lo, hi = _pad_boxes(tree.bbox_min, tree.bbox_max)
    nodes = np.zeros((2 * int(at[-1]), 4), np.float32)
    bits = nodes.view(np.int32)
    for i in range(B):
        if record[i]:
            bits[2 * at[i], 3] = tree.first[i]
            bits[2 * at[i] + 1, 3] = -int(count[i])
        for s, c in enumerate(kids[i]):
            row = 2 * (int(at[i]) + s)
            nodes[row, 0:3], nodes[row + 1, 0:3] = lo[c], hi[c]
            bits[row, 3] = (at[c] if count[c] == 0 or record[c]
                            else pack_leaf(tree.first[c], count[c]))
        if kids[i]:
            bits[2 * at[i] + 1, 3] = len(kids[i])
    return nodes, need


def unpack_nodes(nodes: np.ndarray) -> np.ndarray:
    """A node table decoded into one (16,) record per node, in the walk's
    depth-first order from the root: padded bmin, bmax, first, count,
    children (record rows, 0 = absent); a node is a leaf iff count > 0.
    The root's box, which the table does not hold, is the union of its
    children's (that of its range's record is left infinite)."""
    bits = nodes.view(np.int32)
    out = []

    def leaf(box, first, count):
        out.append(np.concatenate([box, [first, count], np.zeros(8)]))

    def visit(ref, box):
        me = len(out)
        if ref < 0:
            leaf(box, ~ref & 0xFFFFFF, (~ref >> 24) + 1)
            return me
        aux = int(bits[2 * ref + 1, 3])
        if aux < 0:
            leaf(box, int(bits[2 * ref, 3]), -aux)
            return me
        out.append(None)
        kids = []
        for s in range(aux):
            row = 2 * (ref + s)
            kids.append(visit(int(bits[row, 3]), np.concatenate(
                [nodes[row, 0:3], nodes[row + 1, 0:3]])))
        out[me] = np.concatenate([box, [0, 0], kids,
                                  np.zeros(8 - len(kids))])
        return me

    visit(0, np.asarray([-np.inf] * 3 + [np.inf] * 3))
    rec = np.stack(out).astype(np.float32)
    if rec[0, 7] == 0:
        kids = rec[rec[0, 8:][rec[0, 8:] > 0].astype(np.int64)]
        rec[0, 0:3], rec[0, 3:6] = kids[:, 0:3].min(0), kids[:, 3:6].max(0)
    return rec


def _check_exact(n: int) -> None:
    if n >= 1 << 24:
        raise ValueError(f"{n} primitives: indices past 2^24 are not exact "
                         f"in float32 records")


def tri_records(a, e1, e2, n, mat, index) -> np.ndarray:
    """(T, 16) triangle records: a, e1, e2, n, mat, scene index."""
    rec = np.zeros((a.shape[0], TRI_STRIDE), np.float32)
    rec[:, 0:3], rec[:, 3:6], rec[:, 6:9], rec[:, 9:12] = a, e1, e2, n
    rec[:, 12] = mat
    rec[:, 13] = index
    return rec


def build_tri_bvh_tables(a, e1, e2, n, mat, leaf_size: int,
                         sah: bool = False, width: int = 0):
    """The triangle tree (``bvh_pallas.build_tri_bvh_tables``): a BVH over
    the triangles' boxes (a, a+e1, a+e2), leaves of at most ``leaf_size``
    (``cfg.pallas_bvh_leaf``), median or SAH splits, binary or wide.
    Returns (records (T, 16) in the tree's leaf order, the node table
    (R, 4), the walk's stack need)."""
    _check_exact(a.shape[0])
    bvh = tri_bvh(a, e1, e2, leaf_size, sah)
    o = bvh.order
    return (tri_records(a[o], e1[o], e2[o], n[o], mat[o], o),
            *pack_tree(bvh, width))


def tri_bvh(a, e1, e2, leaf_size: int, sah: bool = False):
    """The binary tree over the triangles' boxes (a, a+e1, a+e2)."""
    v1, v2 = a + e1, a + e2
    return accel.build_bvh(np.minimum(a, np.minimum(v1, v2)),
                           np.maximum(a, np.maximum(v1, v2)),
                           max_prims=max(1, int(leaf_size)), sah=sah)


def build_sphere_bvh_tables(rows: np.ndarray, radius: np.ndarray,
                            leaf_size: int, sah: bool = False,
                            width: int = 0):
    """The sphere tree (``bvh_pallas.build_sphere_bvh_tables``) over
    sphere rows (``scene.sphere_rows``) with radii ``radius``: boxes
    c -+ r. Returns (rows (S, 8) in leaf order, the node table (R, 4), the
    walk's stack need)."""
    _check_exact(rows.shape[0])
    bvh = sphere_bvh(rows, radius, leaf_size, sah)
    return (rows[bvh.order], *pack_tree(bvh, width))


def sphere_bvh(rows: np.ndarray, radius: np.ndarray, leaf_size: int,
               sah: bool = False):
    """The binary tree over the spheres' boxes c -+ r."""
    c = rows[:, 0:3]
    r = radius.reshape(-1, 1).astype(np.float32)
    return accel.build_bvh(c - r, c + r, max_prims=max(1, int(leaf_size)),
                           sah=sah)


# ----- the scene-spanning spheres (bvh_pallas.py:167-219) -----

def huge_sphere_mask(r: np.ndarray) -> np.ndarray:
    """Which radii count as scene-spanning: more than 10x the median."""
    med = float(np.median(r))
    return r > max(10.0 * med, 1e-3)


def n_tree_spheres(r: np.ndarray) -> int:
    """How many of the radii ``r`` (r > 0 only) land on the tree side of
    split_huge_spheres."""
    r = np.asarray(r, np.float32)
    r = r[r > 0.0]
    if r.size == 0:
        return 0
    return int(r.size - min(int(huge_sphere_mask(r).sum()),
                            MAX_ALWAYS_SPHERES))


def split_huge_spheres(spheres):
    """(always, tree) index arrays into ``spheres``: the scene-spanning
    ones (at most MAX_ALWAYS_SPHERES, the largest radii first) stay in the
    flat sweep, the rest go into the tree."""
    if not spheres:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    r = np.asarray([sp.r for sp in spheres], np.float32)
    huge = huge_sphere_mask(r)
    if int(huge.sum()) > MAX_ALWAYS_SPHERES:
        warnings.warn(
            f"{int(huge.sum())} scene-spanning spheres exceed the "
            f"{MAX_ALWAYS_SPHERES}-sphere flat-sweep cap; the overflow goes "
            f"into the BVH, where each one bloats its ancestors' boxes",
            stacklevel=2)
        idx = np.flatnonzero(huge)
        keep = idx[np.argsort(-r[idx], kind="stable")[:MAX_ALWAYS_SPHERES]]
        huge = np.zeros_like(huge)
        huge[keep] = True
    return np.flatnonzero(huge), np.flatnonzero(~huge)


# ----- the tables of a scene, per knob set -----

def use_tri_walk(fs: FrozenScene, cfg) -> bool:
    """``mega_pallas._use_tri_bvh`` without its table budget."""
    return (fs.triangles is not None and cfg.pallas_bvh
            and fs.triangles.count > cfg.pallas_static_unroll)


def mxu_leaf_engages(fs: FrozenScene, cfg) -> bool:
    """Whether the path runs tpurt's G-matrix leaf test: the regen kernel
    (``backend="pallas"``, ``pallas_regen``, either mode) with
    ``mega_pallas._use_mxu_leaf``, i.e. ``pallas_mxu_leaf`` on tpurt's
    single-table triangle walk (``pallas_bvh``, static_unroll < T <=
    MAX_BVH_TRIS, the chunk predicate false). Everywhere else tpurt
    accepts the flag and keeps the exact leaf, and so does the port."""
    n = 0 if fs.triangles is None else fs.triangles.count
    thresh = cfg.pallas_bvh_chunk_threshold or MAX_BVH_TRIS
    chunked = cfg.pallas_bvh_chunk > 0 and n > max(thresh,
                                                   cfg.pallas_static_unroll)
    return bool(cfg.pallas_mxu_leaf and cfg.backend == "pallas"
                and cfg.pallas_regen and cfg.pallas_bvh
                and cfg.pallas_static_unroll < n <= MAX_BVH_TRIS
                and not chunked)


def use_sph_walk(fs: FrozenScene, cfg) -> bool:
    """``mega_pallas._use_sph_bvh`` without its table budget."""
    return cfg.pallas_sphere_bvh and n_tree_spheres(
        np.asarray([sp.r for sp in fs.spheres], np.float32)) \
        > MIN_TREE_SPHERES


@dataclasses.dataclass(frozen=True)
class TreeStats:
    """What a walk's tree holds: its primitives, inner nodes and leaves,
    the most children of an inner node (2 binary, up to 8 wide), the stack
    entries proved for its walk, and the bytes of its records and node
    table."""
    prims: int
    inner: int
    leaves: int
    width: int
    stack: int
    table_bytes: int


def tree_stats(records: np.ndarray, nodes: np.ndarray,
               stack: int) -> TreeStats:
    """The ``TreeStats`` of a tree's leaf-ordered records and its node
    table (``pack_tree``'s layout): a row pair with aux >= 0 is a child
    slot, one with aux < 0 a leaf record; a slot's ref < 0 is a packed
    leaf, else the pair of a node or of a leaf record."""
    bits = nodes.view(np.int32)
    ref, aux = bits[0::2, 3], bits[1::2, 3]
    slot = aux >= 0
    into = ref[slot & (ref >= 0)]
    inner = int((aux[into] >= 0).sum()) + int(aux[0] >= 0)
    leaves = (int((ref[slot] < 0).sum()) + int((aux[into] < 0).sum())
              + int(aux[0] < 0))
    return TreeStats(prims=int(records.shape[0]), inner=inner,
                     leaves=leaves, width=int(aux.max(initial=0)),
                     stack=int(stack),
                     table_bytes=int(records.nbytes + nodes.nbytes))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A scene's geometry tables on one device for one knob set: the rows
    of the spheres swept flat (they go into the kernels' scene table), and
    the triangle and sphere records and nodes. Keeps every tensor the
    ``GeomArgs`` pointers name alive."""
    flat_rows: np.ndarray                # (S_flat, 8) rows, scene indices
    tri: torch.Tensor | None             # (T, 16) records
    tri_nodes: torch.Tensor | None       # (R, 4), None: a flat sweep
    sph: torch.Tensor | None             # (S_tree, 8) rows, leaf order
    sph_nodes: torch.Tensor | None
    stack: int = 0                       # stack entries a walk may hold
    tri_tree: TreeStats | None = None    # the triangle walk's tree

    @property
    def walks(self) -> bool:
        return self.tri_nodes is not None or self.sph_nodes is not None

    def args(self, gmat: torch.Tensor | None = None) -> GeomArgs:
        """The launch's GeomArgs; ``gmat`` (the G rows of ``tri``) selects
        the G-matrix leaf test of the closest-hit walk."""
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        return GeomArgs(
            ptr(self.tri), ptr(self.tri_nodes), ptr(self.sph),
            ptr(self.sph_nodes), ptr(gmat),
            0 if self.tri is None else self.tri.shape[0],
            int(self.tri_nodes is not None),
            0 if self.sph is None else self.sph.shape[0], self.stack)


def knobs(cfg) -> tuple:
    """The config fields the geometry tables depend on."""
    return (cfg.pallas_bvh, cfg.pallas_static_unroll, cfg.pallas_bvh_leaf,
            cfg.pallas_bvh_sah, cfg.pallas_bvh_width, cfg.pallas_sphere_bvh)


def geometry(fs: FrozenScene, cfg) -> Geometry:
    """The geometry tables of the frozen scene ``fs`` for ``cfg``'s tree
    knobs, on its device: built on the first call (``accel.building``,
    span ``scene.geometry``: trees, collapse, stack proof, packing and
    upload), then cached on it."""
    key = ("geometry", knobs(cfg))
    geo = fs.cache.get(key)
    if geo is None:
        with accel.building("scene.geometry"):
            geo = fs.cache[key] = _build_geometry(fs, cfg)
    return geo


def gmat(fs: FrozenScene, cfg) -> torch.Tensor:
    """The G rows (``ops.intersect.build_gmat``) of ``geometry(fs, cfg)``'s
    triangle records, row for row, on the scene's device: built on the
    first call, then cached on the frozen scene under their own key (the
    walk's tables stay as they are)."""
    key = ("gmat", knobs(cfg))
    g = fs.cache.get(key)
    if g is None:
        rec = geometry(fs, cfg).tri.cpu().numpy()
        g = fs.cache[key] = torch.from_numpy(build_gmat(rec)).to(fs.device)
    return g


def _build_geometry(fs: FrozenScene, cfg) -> Geometry:
    dev = fs.device
    to_dev = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    rows = sphere_rows(fs.spheres)
    flat = np.arange(len(fs.spheres))
    sph = sph_nodes = tri_tree = None
    stack = 0
    if use_sph_walk(fs, cfg):
        flat, tree = split_huge_spheres(fs.spheres)
        radius = np.asarray([fs.spheres[i].r for i in tree], np.float32)
        srec, snodes, stack = build_sphere_bvh_tables(
            rows[tree], radius, cfg.pallas_bvh_leaf, cfg.pallas_bvh_sah,
            cfg.pallas_bvh_width)
        sph, sph_nodes = to_dev(srec), to_dev(snodes)
    tri = tri_nodes = None
    if fs.triangles is not None:
        host = {k: getattr(fs.triangles, k).detach().cpu().numpy()
                for k in ("a", "e1", "e2", "n", "mat")}
        if use_tri_walk(fs, cfg):
            rec, nodes, need = build_tri_bvh_tables(
                host["a"], host["e1"], host["e2"], host["n"], host["mat"],
                cfg.pallas_bvh_leaf, cfg.pallas_bvh_sah, cfg.pallas_bvh_width)
            tri_nodes, stack = to_dev(nodes), max(stack, need)
            tri_tree = tree_stats(rec, nodes, need)
        else:
            _check_exact(host["a"].shape[0])
            rec = tri_records(host["a"], host["e1"], host["e2"], host["n"],
                              host["mat"], np.arange(host["a"].shape[0]))
        tri = to_dev(rec)
    return Geometry(flat_rows=rows[flat], tri=tri, tri_nodes=tri_nodes,
                    sph=sph, sph_nodes=sph_nodes, stack=stack,
                    tri_tree=tri_tree)


# ----- the walk probe -----

def probe(scene: Scene, cfg, o, d, t_max, lam, gleaf: bool = False,
          pairs: torch.Tensor | None = None):
    """The nearest hit and shadow factor of a batch of rays by the
    kernels' walks: o, d (3, N) float32, t_max, lam (N,), all on the
    scene's device. Returns (t, loc (3, N), n (3, N), mat int32, atten).
    ``gleaf`` takes tpurt's G-matrix leaf test for the nearest hit (over
    ``gmat``); ``pairs``, an int64 (1,) tensor on the card, then has the
    ray-triangle pairs the G leaf tested added to it.
    On a CUDA scene it launches csrc/bvh_probe.cu or raises; on a CPU
    scene it runs the plain version (``integrate.intersect_scene``,
    ``integrate._shadow``)."""
    global LAUNCHES
    from tpurt_torch import integrate
    dev = scene.device
    o, d, t_max, lam = (x.to(dev, torch.float32).contiguous()
                        for x in (o, d, t_max, lam))
    if o.dim() != 2 or o.shape[0] != 3 or d.shape != o.shape \
            or t_max.shape != o.shape[1:] or lam.shape != o.shape[1:]:
        raise ValueError(f"rays must be (3, N) o, d and (N,) t_max, lam; got "
                         f"{tuple(o.shape)} {tuple(d.shape)} "
                         f"{tuple(t_max.shape)} {tuple(lam.shape)}")
    fs = freeze_scene(scene)
    gm = gmat(fs, cfg) if gleaf and fs.triangles is not None else None
    if dev.type == "cpu":
        tri = integrate.EXACT if gm is None else integrate.TriMode("gleaf",
                                                                   gm)
        t, loc, nrm, mat = integrate.intersect_scene(fs, tuple(o),
                                                     tuple(d), tri)
        atten = integrate._shadow(fs, tuple(o), tuple(d), t_max, lam)
        return (t, torch.stack(loc), torch.stack(nrm), mat.to(torch.int32),
                atten)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if pairs is not None and (pairs.dtype != torch.int64
                              or pairs.device != dev or pairs.numel() != 1):
        raise ValueError("pairs must be one int64 on the scene's device")
    geo = geometry(fs, cfg)
    n = o.shape[1]
    flat = torch.from_numpy(geo.flat_rows).to(dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    loc = torch.empty((3, n), dtype=torch.float32, device=dev)
    nrm = torch.empty((3, n), dtype=torch.float32, device=dev)
    mat = torch.empty((n,), dtype=torch.int32, device=dev)
    atten = torch.empty((n,), dtype=torch.float32, device=dev)
    args = geo.args(gm)
    lib = build.library()
    err = lib.tpurt_bvh_probe_launch(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), lam.data_ptr(), n,
        flat.data_ptr(), flat.shape[0], ctypes.byref(args), t.data_ptr(),
        loc.data_ptr(), nrm.data_ptr(), mat.data_ptr(), atten.data_ptr(),
        None if pairs is None else pairs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(lib, err, "tpurt_bvh_probe_launch")
    LAUNCHES += 1
    return t, loc, nrm, mat, atten
