"""Host-side BVH construction in NumPy: a copy of ``tpurt.accel``.

The port carries its own copy because importing any ``tpurt`` module
imports JAX. Same algorithm, same output bit for bit (tests/
test_torch_mesh.py holds it to tpurt's builder): recursive median split on
the longest centroid-bounds axis (the reference's src/instance.rs:175-310),
or binned SAH splits; leaves hold at most ``max_prims`` triangles; the flat
node layout is {bbox_min, bbox_max, left, right, first, count}, a node is a
leaf iff count > 0; ``order`` is the permutation of triangles into leaf
order, so a leaf is the contiguous range [first, first + count) of the
permuted arrays. ``collapse_wide`` makes up-to-8-ary trees with the same
leaves; ``wide_max_stack`` is the exact worst-case stack occupancy of a
walk over one.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BVH:
    bbox_min: np.ndarray  # (B, 3) f32
    bbox_max: np.ndarray  # (B, 3) f32
    left: np.ndarray      # (B,) i32
    right: np.ndarray     # (B,) i32
    first: np.ndarray     # (B,) i32
    count: np.ndarray     # (B,) i32
    order: np.ndarray     # (T,) i32 — triangle permutation into leaf order


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray, max_prims: int = 2,
              sah: bool = False) -> BVH:
    """Build a BVH from per-triangle AABBs (``tpurt.accel.build_bvh``).

    tri_min/tri_max: (T, 3) float arrays. max_prims >= 1 triangles per leaf.

    sah=False (default): the reference's median split (instance.rs:160-310).
    sah=True: binned surface-area-heuristic splits; same node layout and
    leaf-order contract, only the split positions differ. A SAH tree with
    more than 2*ceil(T/K) nodes is replaced by the median tree, as tpurt
    does. tpurt's optional native builder gives the same output
    (tests/test_native.py); the port carries only this NumPy path.
    """
    max_prims = max(int(max_prims), 1)
    T = int(tri_min.shape[0])
    if sah and T > 0:
        bvh = _build_bvh_py(np.asarray(tri_min, np.float32),
                            np.asarray(tri_max, np.float32), max_prims,
                            sah=True)
        if bvh.bbox_min.shape[0] <= 2 * max(1, -(-T // max_prims)):
            return bvh
    return _build_bvh_py(tri_min, tri_max, max_prims, sah=False)


_SAH_BINS = 16
# Past this depth an SAH subtree switches to median splits: median halving
# bounds the remaining depth by log2(n), keeping the deepest possible tree
# well inside the kernels' 64-deep traversal stack (bvh_pallas.STACK_DEPTH).
_SAH_DEPTH_CAP = 40


# The "always visited" floor in the split cost, as a fraction of the ROOT
# box area: the whole-tile Pallas walk visits a node when ANY of the tile's
# 4096 rays votes for it, so for incoherent tiles a leaf costs one full
# sweep almost regardless of its box area. The floor steers the heuristic
# toward FEWER (fuller) leaves when area differences are small, matching
# the tile-union behavior; pure per-ray SAH is the alpha -> 0 limit.
_SAH_FLOOR = 0.25


def _leaf_area_cost(lo, hi, n, max_prims, floor):
    d = np.maximum(hi - lo, 0.0)
    area = d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]
    return (area + floor) * -(-n // max_prims)


def _sah_split(tri_min, tri_max, centroid, idx, max_prims, floor):
    """Best binned-SAH split of `idx`: returns (left_idx, right_idx) or
    None when the median split scores at least as well under the same cost
    model (or every candidate is degenerate), in which case the caller
    median-splits — SAH is never worse than median under the model."""
    c = centroid[idx]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    ext = cmax - cmin
    best_cost, best, best_b = np.inf, None, None
    for dim in range(3):
        if ext[dim] <= 0.0:
            continue
        b = np.minimum((_SAH_BINS * (c[:, dim] - cmin[dim]) / ext[dim])
                       .astype(np.int64), _SAH_BINS - 1)
        counts = np.bincount(b, minlength=_SAH_BINS)
        bmin = np.full((_SAH_BINS, 3), np.inf, np.float64)
        bmax = np.full((_SAH_BINS, 3), -np.inf, np.float64)
        np.minimum.at(bmin, b, tri_min[idx])
        np.maximum.at(bmax, b, tri_max[idx])
        # prefix/suffix boxes give every plane's child areas in one sweep
        lmin, lmax = np.minimum.accumulate(bmin), np.maximum.accumulate(bmax)
        rmin = np.minimum.accumulate(bmin[::-1])[::-1]
        rmax = np.maximum.accumulate(bmax[::-1])[::-1]
        nl = np.cumsum(counts)[:-1]
        nr = len(idx) - nl
        valid = (nl > 0) & (nr > 0)
        if not valid.any():
            continue
        cost = np.where(
            valid,
            _leaf_area_cost(lmin[:-1], lmax[:-1], nl, max_prims, floor)
            + _leaf_area_cost(rmin[1:], rmax[1:], nr, max_prims, floor),
            np.inf)
        k = int(np.argmin(cost))
        if cost[k] < best_cost:
            best_cost, best, best_b = float(cost[k]), (dim, k), b
    if best is None:
        return None

    # Median candidate under the SAME cost model: take SAH only if it wins.
    dmed = 0 if (ext[0] >= ext[1] and ext[0] >= ext[2]) else (
        1 if ext[1] >= ext[2] else 2)
    srt = np.argsort(c[:, dmed], kind="stable")
    mid = len(idx) // 2
    lo, hi = srt[:mid], srt[mid:]
    med_cost = float(
        _leaf_area_cost(tri_min[idx[lo]].min(0), tri_max[idx[lo]].max(0),
                        mid, max_prims, floor)
        + _leaf_area_cost(tri_min[idx[hi]].min(0), tri_max[idx[hi]].max(0),
                          len(idx) - mid, max_prims, floor))
    if med_cost <= best_cost:
        return None

    _, k = best
    go_left = best_b <= k
    return idx[go_left], idx[~go_left]


def _build_bvh_py(tri_min: np.ndarray, tri_max: np.ndarray, max_prims: int,
                  sah: bool) -> BVH:
    T = int(tri_min.shape[0])
    if T == 0:
        z3 = np.zeros((1, 3), np.float32)
        zi = np.zeros((1,), np.int32)
        return BVH(z3, z3, zi, zi, zi, zi, np.zeros((0,), np.int32))

    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    centroid = 0.5 * tri_min + 0.5 * tri_max

    nodes_min, nodes_max = [], []
    nodes_left, nodes_right, nodes_first, nodes_count = [], [], [], []
    order: list[int] = []

    # Depth-first build with an explicit stack of (node_idx, index_array)
    # entries: each pop allocates/splits its node in a single visit and the
    # PARENT writes its children's indices (left = next alloc, right after
    # the left subtree), reproducing the reference's recursive control flow
    # and leaf order exactly.
    def alloc():
        nodes_min.append(np.zeros(3, np.float32))
        nodes_max.append(np.zeros(3, np.float32))
        nodes_left.append(0)
        nodes_right.append(0)
        nodes_first.append(0)
        nodes_count.append(0)
        return len(nodes_min) - 1

    if sah:
        d = np.maximum(tri_max.max(axis=0).astype(np.float64)
                       - tri_min.min(axis=0), 0.0)
        floor = _SAH_FLOOR * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
    root = alloc()
    stack = [(root, np.arange(T, dtype=np.int64), 0)]
    # Pushing right-then-left pops the left subtree first, so leaf triangles
    # land in `order` in the reference's depth-first left-to-right sequence.
    while stack:
        node, idx, depth = stack.pop()
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        nodes_min[node] = bmin
        nodes_max[node] = bmax
        n = len(idx)
        if n <= max_prims:
            nodes_first[node] = len(order)
            nodes_count[node] = n
            order.extend(idx.tolist())
            continue

        split = None
        if sah and depth < _SAH_DEPTH_CAP:
            split = _sah_split(tri_min, tri_max, centroid, idx, max_prims,
                               floor)
        if split is None:
            c = centroid[idx]
            cmin, cmax = c.min(axis=0), c.max(axis=0)
            d = cmax - cmin
            # Longest-axis rule with the reference's >= tie-breaking
            # (x wins ties with y and z; y wins ties with z).
            # instance.rs:167-172.
            if d[0] >= d[1] and d[0] >= d[2]:
                dim = 0
            elif d[1] >= d[2]:
                dim = 1
            else:
                dim = 2
            srt = idx[np.argsort(c[:, dim], kind="stable")]
            split = (srt[:n // 2], srt[n // 2:])

        lchild = alloc()
        rchild = alloc()
        nodes_left[node] = lchild
        nodes_right[node] = rchild
        # Push right first so left is processed (and numbered) first.
        stack.append((rchild, split[1], depth + 1))
        stack.append((lchild, split[0], depth + 1))

    return BVH(
        bbox_min=np.stack(nodes_min).astype(np.float32),
        bbox_max=np.stack(nodes_max).astype(np.float32),
        left=np.asarray(nodes_left, np.int32),
        right=np.asarray(nodes_right, np.int32),
        first=np.asarray(nodes_first, np.int32),
        count=np.asarray(nodes_count, np.int32),
        order=np.asarray(order, np.int32),
    )


@dataclasses.dataclass
class WideBVH:
    """W-ary collapse of a binary BVH (SURVEY §7 "shallow wide-branching
    BVH … instead of binary stack traversal"): same leaves (identical
    `first`/`count` ranges and triangle `order` permutation as the binary
    tree), but inner nodes hold up to `width` children so a walk takes
    ~log_W(T) dependent node steps instead of ~log_2(T) (tpurt's TPU walk
    is bound by them; csrc/bvh.cuh walks this tree per ray)."""
    bbox_min: np.ndarray   # (B, 3) f32
    bbox_max: np.ndarray   # (B, 3) f32
    children: np.ndarray   # (B, width) i32, 0 = absent slot
    first: np.ndarray      # (B,) i32
    count: np.ndarray      # (B,) i32 — leaf iff count > 0
    order: np.ndarray      # (T,) i32 — SAME permutation as the binary tree


def _box_area(bmin: np.ndarray, bmax: np.ndarray) -> float:
    d = np.maximum(np.asarray(bmax, np.float64) - bmin, 0.0)
    return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def collapse_wide(bvh: BVH, width: int) -> WideBVH:
    """Greedy area-first collapse: a wide node starts from a binary inner
    node's two children and repeatedly replaces the largest-surface-area
    inner member with ITS two children until `width` members or all
    members are leaves.  Expanding the biggest box first maximizes the
    overlap-pruning value of each extra child slot.  Leaves are carried
    over verbatim, so the primitive tables built for the binary tree are
    reused unchanged."""
    width = int(width)
    assert 2 <= width <= 8, "wide nodes pack at most 8 child slots"
    bcount = np.asarray(bvh.count)
    bleft = np.asarray(bvh.left)
    bright = np.asarray(bvh.right)
    bmin = np.asarray(bvh.bbox_min)
    bmax = np.asarray(bvh.bbox_max)

    nmin, nmax, nchild, nfirst, ncount = [], [], [], [], []

    def alloc():
        nmin.append(np.zeros(3, np.float32))
        nmax.append(np.zeros(3, np.float32))
        nchild.append([0] * width)
        nfirst.append(0)
        ncount.append(0)
        return len(nmin) - 1

    root = alloc()
    # (wide_idx, binary_idx); left-to-right child allocation keeps the
    # near-to-far default order deterministic
    stack = [(root, 0)]
    while stack:
        w, b = stack.pop()
        nmin[w] = bmin[b]
        nmax[w] = bmax[b]
        if bcount[b] > 0:
            nfirst[w] = int(bvh.first[b])
            ncount[w] = int(bcount[b])
            continue
        group = [int(bleft[b]), int(bright[b])]
        while len(group) < width:
            inner = [g for g in group if bcount[g] == 0]
            if not inner:
                break
            g = max(inner, key=lambda n: _box_area(bmin[n], bmax[n]))
            i = group.index(g)
            # splice in place to keep spatial siblings adjacent
            group[i:i + 1] = [int(bleft[g]), int(bright[g])]
        kids = []
        for g in group:
            cw = alloc()
            kids.append(cw)
            stack.append((cw, g))
        nchild[w][:len(kids)] = kids

    wide = WideBVH(
        bbox_min=np.stack(nmin).astype(np.float32),
        bbox_max=np.stack(nmax).astype(np.float32),
        children=np.asarray(nchild, np.int32),
        first=np.asarray(nfirst, np.int32),
        count=np.asarray(ncount, np.int32),
        order=np.asarray(bvh.order, np.int32),
    )
    return wide


def wide_max_stack(wide: WideBVH) -> int:
    """Exact worst-case traversal-stack occupancy: when the walk visits a
    node it pops 1 and pushes up to k (its child count), so the high-water
    mark down a root-to-leaf path is 1 + sum over strict ancestors of
    (k_anc - 1) + (k_node - 1) + 1 at the deepest push.  Computed by DFS
    with the running sum."""
    count = wide.count
    children = wide.children
    if count.shape[0] == 0:
        return 1
    best = 1
    stack = [(0, 1)]  # (node, occupancy right after this node was popped+pushed-over)
    while stack:
        node, occ = stack.pop()
        if count[node] > 0:
            best = max(best, occ)
            continue
        kids = [int(c) for c in children[node] if c != 0]
        best = max(best, occ + len(kids))
        for c in kids:
            stack.append((c, occ + len(kids) - 1))
    return best


def validate_wide_bvh(wide: WideBVH, bvh: BVH) -> None:
    """Invariants of the collapse: identical leaf set (first/count pairs),
    identical order, parent boxes contain child boxes, every node
    reachable exactly once."""
    if not np.array_equal(wide.order, bvh.order):
        raise AssertionError("collapse changed the leaf-order permutation")
    want = sorted((int(f), int(c)) for f, c in
                  zip(bvh.first[bvh.count > 0], bvh.count[bvh.count > 0]))
    got = sorted((int(f), int(c)) for f, c in
                 zip(wide.first[wide.count > 0], wide.count[wide.count > 0]))
    if want != got:
        raise AssertionError("collapse changed the leaf set")
    seen = np.zeros(wide.count.shape[0], bool)
    stack = [0]
    while stack:
        n = stack.pop()
        if seen[n]:
            raise AssertionError(f"wide node {n} reachable twice")
        seen[n] = True
        if wide.count[n] > 0:
            continue
        kids = [int(c) for c in wide.children[n] if c != 0]
        if not kids:
            raise AssertionError(f"wide inner node {n} has no children")
        for c in kids:
            if (wide.bbox_min[c] < wide.bbox_min[n] - 1e-5).any() or \
               (wide.bbox_max[c] > wide.bbox_max[n] + 1e-5).any():
                raise AssertionError(f"wide node {n} does not contain {c}")
            stack.append(c)
    if not seen.all():
        raise AssertionError("unreachable wide nodes")


def validate_bvh(bvh: BVH, tri_min: np.ndarray, tri_max: np.ndarray, eps=1e-5) -> None:
    """Structural invariants: every triangle in exactly one leaf; parent boxes
    contain child boxes; leaf boxes contain their triangles. Raises on breach."""
    T = tri_min.shape[0]
    if T == 0:
        return
    seen = np.sort(bvh.order)
    if not np.array_equal(seen, np.arange(T)):
        raise AssertionError("BVH leaf order is not a permutation of triangles")
    B = bvh.bbox_min.shape[0]
    for i in range(B):
        if bvh.count[i] > 0:
            f, c = int(bvh.first[i]), int(bvh.count[i])
            tris = bvh.order[f:f + c]
            if (tri_min[tris] < bvh.bbox_min[i] - eps).any() or (tri_max[tris] > bvh.bbox_max[i] + eps).any():
                raise AssertionError(f"leaf {i} does not contain its triangles")
        else:
            for ch in (int(bvh.left[i]), int(bvh.right[i])):
                if ch == 0 and i != 0:
                    raise AssertionError(f"inner node {i} has null child")
                if (bvh.bbox_min[ch] < bvh.bbox_min[i] - eps).any() or (bvh.bbox_max[ch] > bvh.bbox_max[i] + eps).any():
                    raise AssertionError(f"node {i} does not contain child {ch}")
