"""Sphere and triangle hits and shadow factors, component form: the
plain PyTorch versions of the kernels' intersection code.

Spheres are ported from ``tpurt.kernels.mega_pallas._closest_sphere_static``
and ``_shadow_static``: host constants (``scene.FSphere``) against ray
planes, with one reciprocal of |d|^2 per ray, the ``disc > 0 & t > 0``
root test, the hit point pulled back to ``o + d * (t * 0.9999)``, and
Fresnel transmission through dielectric occluders only. Past
``SPHERE_LOOP_MAX`` spheres the same arithmetic runs as a chunked sweep of
rays x spheres; its shadow product is then taken in torch.prod's order,
not index order (last-bit differences in the attenuation).

Triangles are ``tpurt.ops.soa.triangle_hit_c`` (Moller-Trumbore with the
1.17549435e-38 epsilon on |det| and on t, cross products in its operand
order) as a brute-force sweep in chunks of rays x triangles. The closest
hit is the least (t, scene index): equally near triangles (a shared edge of
a watertight mesh) go to the lower row of the Scene's triangle arrays,
whatever order a BVH walk visits them in. Its point is
``o + n * 1e-5 + d * t`` with the unflipped geometric normal
(``mega_pallas._tri_state_finish``); occlusion is any-hit, and triangles
occlude fully.

Two more closest-hit queries replace that sweep where tpurt replaces it:
``closest_triangle_g``, the brute-force sweep of tpurt's G-matrix leaf
test (``cfg.pallas_mxu_leaf``, ``bvh_pallas._make_mxu_leaf_fn``: linear in
f = [d | o x d | o | 1], not bit-identical to Moller-Trumbore at grazing
rays), and ``bvh_hit``, tpurt's per-ray walk of the Scene's own BVH
(``cfg.use_bvh``, ``tpurt.ops.intersect.bvh_hit``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.ops import fdiv, fsqrt
from tpurt_torch.ops import soa as s
from tpurt_torch.ops.bsdf import fr_dielectric
from tpurt_torch.ops.spectra import DISPERSION_B

MISS = 1e30
HIT = MISS * 0.5   # any t below this is a real hit
TRI_EPS = 1.17549435e-38   # 2^-126, the reference's MT epsilon
BIG = 3.402823e38          # the slab test's open end (tpurt's BIG)
STACK_DEPTH = 64           # tpurt.ops.intersect.STACK_DEPTH
SPHERE_LOOP_MAX = 64       # more spheres than this: the chunked sweep
CHUNK_ELEMS = 1 << 22      # rays x primitives per chunk of a sweep


def _chunk(n_rays: int, n_prims: int) -> int:
    return max(1, min(n_prims, CHUNK_ELEMS // max(n_rays, 1)))


def _cols(x, lo, hi):
    """Columns lo:hi of a (P, 3) tensor as a vec3 of (1, C) rows."""
    return tuple(x[lo:hi, k][None] for k in range(3))


def closest_sphere(spheres, o, d, table=None):
    """Nearest sphere along (o, d). Returns (t, loc, normal, mat); t is
    MISS where nothing is hit. ``table`` is the spheres' (S, 8) rows
    (``scene.sphere_rows``), needed past SPHERE_LOOP_MAX spheres."""
    if len(spheres) > SPHERE_LOOP_MAX:
        return _closest_sphere_chunked(table, o, d)
    a = s.vdot(d, d)
    inv_a = 1.0 / a
    best_t = torch.full_like(o[0], MISS)
    best_c = (torch.zeros_like(o[0]),) * 3
    best_mat = torch.zeros_like(o[0], dtype=torch.int64)
    for sp in spheres:
        oc = (o[0] - sp.c[0], o[1] - sp.c[1], o[2] - sp.c[2])
        half_b = s.vdot(oc, d)
        c = s.vdot(oc, oc) - sp.r2
        disc = half_b * half_b - a * c
        sq = fsqrt(disc.clamp_min(0.0))
        t = (-half_b - sq) * inv_a
        t = torch.where((disc > 0.0) & (t > 0.0), t, MISS)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_c = tuple(torch.where(better, sp.c[k], best_c[k])
                       for k in range(3))
        best_mat = torch.where(better, sp.mat, best_mat)
    loc = s.vadd(o, s.vscale(d, best_t * 0.9999))
    nrm = s.vnormalize(s.vsub(loc, best_c), eps=1e-30)
    return best_t, loc, nrm, best_mat


def _closest_sphere_chunked(table, o, d):
    """closest_sphere over (N, C) chunks: per-sphere arithmetic as in the
    loop, the first least t of a chunk (argmin), strict < across chunks,
    so the same winner as the loop."""
    a = s.vdot(d, d)
    inv_a = (1.0 / a)[:, None]
    oc1 = tuple(x[:, None] for x in o)
    d1 = tuple(x[:, None] for x in d)
    best_t = torch.full_like(o[0], MISS)
    best_i = torch.zeros_like(o[0], dtype=torch.int64)
    n, S = o[0].shape[0], table.shape[0]
    step = _chunk(n, S)
    for lo in range(0, S, step):
        hi = min(lo + step, S)
        c = _cols(table, lo, hi)
        oc = s.vsub(oc1, c)
        half_b = s.vdot(oc, d1)
        cc = s.vdot(oc, oc) - table[lo:hi, 3][None]
        disc = half_b * half_b - a[:, None] * cc
        sq = fsqrt(disc.clamp_min(0.0))
        t = (-half_b - sq) * inv_a
        t = torch.where((disc > 0.0) & (t > 0.0), t, MISS)
        arg = torch.argmin(t, dim=1)
        tmin = t.gather(1, arg[:, None])[:, 0]
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, arg + lo, best_i)
    hit = best_t < MISS
    row = table[best_i]
    best_c = tuple(torch.where(hit, row[:, k], 0.0) for k in range(3))
    best_mat = torch.where(hit, row[:, 4].to(torch.int64), 0)
    loc = s.vadd(o, s.vscale(d, best_t * 0.9999))
    nrm = s.vnormalize(s.vsub(loc, best_c), eps=1e-30)
    return best_t, loc, nrm, best_mat


def shadow_spheres(spheres, o, d, t_max, lam, table=None):
    """Transmission of the segment o + d*[0, t_max]: diffuse and metal
    spheres block it, dielectric ones pass (1-R1)(1-R2) at the
    dispersed IOR of wavelength ``lam``. ``table`` as closest_sphere."""
    if len(spheres) > SPHERE_LOOP_MAX:
        return _shadow_spheres_chunked(table, o, d, t_max, lam)
    a = s.vdot(d, d)
    inv_a = 1.0 / a
    atten = torch.ones_like(o[0])
    for sp in spheres:
        oc = (o[0] - sp.c[0], o[1] - sp.c[1], o[2] - sp.c[2])
        half_b = s.vdot(oc, d)
        c = s.vdot(oc, oc) - sp.r2
        disc = half_b * half_b - a * c
        sq = fsqrt(disc.clamp_min(0.0))
        t0 = (-half_b - sq) * inv_a
        t1 = (-half_b + sq) * inv_a
        overlap = (disc > 0.0) & (t1 > 0.0) & (t0 < t_max)
        if sp.mtype != 1:
            atten = atten * torch.where(overlap, 0.0, 1.0)
            continue
        t_entry = t0.clamp_min(0.0)
        t_exit = torch.minimum(t1, t_max)
        segment = t_entry < t_exit
        lam_um = lam * 1e-3
        eta = sp.ior + fdiv(DISPERSION_B, lam_um * lam_um)
        p1 = s.vadd(o, s.vscale(d, t_entry))
        n1 = s.vnormalize(s.vsub(p1, sp.c), eps=1e-30)
        r1 = fr_dielectric(-s.vdot(n1, d), eta)
        p2 = s.vadd(o, s.vscale(d, t_exit))
        n2 = s.vnormalize(s.vsub(p2, sp.c), eps=1e-30)
        r2 = fr_dielectric(-s.vdot(n2, d), eta)
        f = torch.where(segment, (1.0 - r1) * (1.0 - r2), 1.0)
        atten = atten * torch.where(overlap, f, 1.0)
    return atten


def _shadow_spheres_chunked(table, o, d, t_max, lam):
    """shadow_spheres over (N, C) chunks; the factors of a chunk are
    multiplied in torch.prod's order."""
    a = s.vdot(d, d)
    inv_a = (1.0 / a)[:, None]
    o1 = tuple(x[:, None] for x in o)
    d1 = tuple(x[:, None] for x in d)
    tm = t_max[:, None]
    lam_um = lam * 1e-3
    cauchy = fdiv(DISPERSION_B, lam_um * lam_um)[:, None]
    atten = torch.ones_like(o[0])
    n, S = o[0].shape[0], table.shape[0]
    step = _chunk(n, S)
    for lo in range(0, S, step):
        hi = min(lo + step, S)
        c = _cols(table, lo, hi)
        oc = s.vsub(o1, c)
        half_b = s.vdot(oc, d1)
        cc = s.vdot(oc, oc) - table[lo:hi, 3][None]
        disc = half_b * half_b - a[:, None] * cc
        sq = fsqrt(disc.clamp_min(0.0))
        t0 = (-half_b - sq) * inv_a
        t1 = (-half_b + sq) * inv_a
        overlap = (disc > 0.0) & (t1 > 0.0) & (t0 < tm)
        t_entry = t0.clamp_min(0.0)
        t_exit = torch.minimum(t1, tm)
        segment = t_entry < t_exit
        eta = table[lo:hi, 6][None] + cauchy
        n1 = s.vnormalize(s.vsub(s.vadd(o1, s.vscale(d1, t_entry)), c),
                          eps=1e-30)
        r1 = fr_dielectric(-s.vdot(n1, d1), eta)
        n2 = s.vnormalize(s.vsub(s.vadd(o1, s.vscale(d1, t_exit)), c),
                          eps=1e-30)
        r2 = fr_dielectric(-s.vdot(n2, d1), eta)
        f = torch.where(segment, (1.0 - r1) * (1.0 - r2), 1.0)
        f = torch.where(table[lo:hi, 5][None] == 1.0, f, 0.0)
        atten = atten * torch.where(overlap, f, 1.0).prod(dim=1)
    return atten


def _tri_hits(tri, lo: int, hi: int, o1, d1):
    """(t, valid), each (N, C), of rays (vec3s of (N, 1) columns) against
    triangles lo:hi."""
    return _mt(*(_cols(x, lo, hi) for x in (tri.a, tri.e1, tri.e2)), o1, d1)


def _mt(a, e1, e2, o1, d1):
    """(t, valid) of Moller-Trumbore on broadcasting vec3s:
    ``soa.triangle_hit_c`` term for term."""
    h = s.vcross(d1, e2)
    det = s.vdot(e1, h)
    small = det.abs() < TRI_EPS
    inv_det = fdiv(1.0, torch.where(small, 1.0, det))
    sv = s.vsub(o1, a)
    u = inv_det * s.vdot(sv, h)
    q = s.vcross(sv, e1)
    v = inv_det * s.vdot(d1, q)
    t = inv_det * s.vdot(e2, q)
    valid = (~small & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > TRI_EPS))
    return t, valid


def closest_triangle(tri, o, d):
    """Nearest triangle of ``tri`` (a ``scene.FTriangles``) along (o, d):
    the least (t, scene index). Returns (t, loc, normal, mat, index); t is
    MISS, normal 0 and mat 0 where nothing is hit."""
    o1 = tuple(x[:, None] for x in o)
    d1 = tuple(x[:, None] for x in d)
    best_t = torch.full_like(o[0], MISS)
    best_i = torch.zeros_like(o[0], dtype=torch.int64)
    n, T = o[0].shape[0], tri.count
    step = _chunk(n, T)
    for lo in range(0, T, step):
        t, valid = _tri_hits(tri, lo, min(lo + step, T), o1, d1)
        t = torch.where(valid, t, MISS)
        arg = torch.argmin(t, dim=1)      # the first least t of the chunk
        tmin = t.gather(1, arg[:, None])[:, 0]
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, arg + lo, best_i)
    return _tri_finish(tri, o, d, best_t, best_i)


def occluded_triangle(tri, o, d, t_max):
    """Whether any triangle of ``tri`` is hit at t < t_max."""
    o1 = tuple(x[:, None] for x in o)
    d1 = tuple(x[:, None] for x in d)
    tm = t_max[:, None]
    occ = torch.zeros_like(o[0], dtype=torch.bool)
    n, T = o[0].shape[0], tri.count
    step = _chunk(n, T)
    for lo in range(0, T, step):
        t, valid = _tri_hits(tri, lo, min(lo + step, T), o1, d1)
        occ = occ | (valid & (t < tm)).any(dim=1)
    return occ


# ----- pallas_mxu_leaf: tpurt's G-matrix leaf test -----

# The G row, mirrored by csrc/bvh.cuh GField: the non-zero coefficients of
# tpurt's four 16-float blocks over f = [d | o x d | o | 1] (det of d; u
# numerator of d and of o x d; v numerator of d and of o x d; t numerator
# of o and of 1), the scene index, then the unit normal and the material.
G_DET, G_UD, G_UX, G_VD, G_VX, G_TO, G_TC = 0, 3, 6, 9, 12, 15, 18
G_INDEX, G_N, G_MAT = 19, 20, 23
G_STRIDE = 24


def build_gmat(rec: np.ndarray) -> np.ndarray:
    """(T, G_STRIDE) G rows of the triangle records ``rec``
    (``kernels.bvh.tri_records`` layout, in the walk's leaf order): the
    non-zero coefficients of ``bvh_pallas.build_tri_gmat``'s blocks,
    computed as it computes them (N = e1 x e2 unnormalised; det = d.(-N),
    u*det = d.(a x e2) + (o x d).e2, v*det = d.(e1 x a) + (o x d).(-e1),
    t*det = o.N - a.N), then the scene index, the unit normal and the
    material."""
    a, e1, e2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    N = np.cross(e1, e2)
    g = np.zeros((rec.shape[0], G_STRIDE), np.float32)
    g[:, G_DET:G_DET + 3] = -N
    g[:, G_UD:G_UD + 3] = np.cross(a, e2)
    g[:, G_UX:G_UX + 3] = e2
    g[:, G_VD:G_VD + 3] = np.cross(e1, a)
    g[:, G_VX:G_VX + 3] = -e1
    g[:, G_TO:G_TO + 3] = N
    g[:, G_TC] = -np.einsum("ij,ij->i", a, N)
    g[:, G_INDEX] = rec[:, 13]
    g[:, G_N:G_N + 3] = rec[:, 9:12]
    g[:, G_MAT] = rec[:, 12]
    return g


def _gsum(terms, fused: bool):
    """The sum of the products a * b of ``terms`` in their order. Unfused,
    each product and each sum rounds to float32 (csrc/bvh.cuh, built
    without FMA); ``fused`` rounds each multiply-add once, as a fused
    multiply-add (the product is exact in float64), which is how XLA's CPU
    dot forms tpurt's sums in Pallas interpret mode."""
    (a, b), *rest = terms
    acc = a * b
    for a, b in rest:
        acc = ((acc.double() + a.double() * b.double()).float() if fused
               else acc + a * b)
    return acc


def _g_hits(g, o1, d1, x1, fused: bool = False):
    """(t, valid), each (N, C), of rays against G rows ``g`` (C, G_STRIDE)
    (``build_gmat``): the four sums of tpurt's leaf test over
    f = [d | o x d | o | 1], each term by term in ascending feature order
    with zero coefficients skipped (a matmul's summation order is not
    fixed, and csrc/bvh.cuh sums in this one; ``fused`` as in ``_gsum``),
    then its epilogue (``_make_mxu_leaf_fn``): the sign of det folded into
    u and v, t = t_num / det, a hit when |det| >= eps, 0 <= u, 0 <= v,
    u <= |det|, u + v <= |det| and t > eps. o1, d1, x1 = o x d: vec3s of
    (N, 1)."""
    c = lambda k: tuple(g[:, k + i][None] for i in range(3))  # noqa: E731
    det = _gsum(zip(c(G_DET), d1), fused)
    un = _gsum([*zip(c(G_UD), d1), *zip(c(G_UX), x1)], fused)
    vn = _gsum([*zip(c(G_VD), d1), *zip(c(G_VX), x1)], fused)
    tn = _gsum(zip(c(G_TO), o1), fused) + g[:, G_TC][None]
    sgn = torch.where(det >= 0.0, 1.0, -1.0)
    ad, us, vs = det * sgn, un * sgn, vn * sgn
    t = tn / torch.where(ad >= TRI_EPS, det, 1.0)
    valid = ((ad >= TRI_EPS) & (us >= 0.0) & (vs >= 0.0) & (us <= ad)
             & (us + vs <= ad) & (t > TRI_EPS))
    return t, valid


def closest_triangle_g(g, tri, o, d, fused: bool = False):
    """Nearest triangle along (o, d) by tpurt's G-matrix leaf test, swept
    brute force over the G rows ``g`` of ``tri``'s triangles (any row
    order): the least (t, scene index), as ``closest_triangle``. Returns
    (t, loc, normal, mat, index) as it does. ``fused`` forms the sums with
    fused multiply-adds (``_gsum``); the kernel and the path never do."""
    o1 = tuple(x[:, None] for x in o)
    d1 = tuple(x[:, None] for x in d)
    x1 = tuple(x[:, None] for x in s.vcross(o, d))
    idx = g[:, G_INDEX].to(torch.int64)
    best_t = torch.full_like(o[0], MISS)
    best_i = torch.zeros_like(o[0], dtype=torch.int64)
    n, T = o[0].shape[0], g.shape[0]
    step = _chunk(n, T)
    for lo in range(0, T, step):
        hi = min(lo + step, T)
        t, valid = _g_hits(g[lo:hi], o1, d1, x1, fused)
        t = torch.where(valid, t, MISS)
        tmin = t.amin(dim=1)
        imin = torch.where(t == tmin[:, None], idx[lo:hi][None],
                           T).amin(dim=1)
        better = (tmin < MISS) & ((tmin < best_t)
                                  | ((tmin == best_t) & (imin < best_i)))
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, imin, best_i)
    return _tri_finish(tri, o, d, best_t, best_i)


def _tri_finish(tri, o, d, best_t, best_i):
    """(t, loc, normal, mat, index) of the winners best_i at best_t."""
    hit = best_t < MISS
    nrm = tuple(torch.where(hit, tri.n[best_i, k], 0.0) for k in range(3))
    mat = torch.where(hit, tri.mat[best_i].to(torch.int64), 0)
    loc = s.vadd(s.vadd(o, s.vscale(nrm, 1e-5)), s.vscale(d, best_t))
    return best_t, loc, nrm, mat, best_i


# ----- use_bvh: tpurt's per-ray walk (XLA path) -----

def _aabb_entry(o, d, inv, par, bmin, bmax):
    """``tpurt.ops.intersect.ray_aabb_entry`` per ray against one box each
    (bmin, bmax (N, 3)): (box reached, entry distance). ``inv`` and ``par``
    are the ray's guarded reciprocal and parallel-axis mask."""
    lo, hi, ok = [], [], torch.ones_like(par[0])
    for k in range(3):
        t0 = (bmin[:, k] - o[k]) * inv[k]
        t1 = (bmax[:, k] - o[k]) * inv[k]
        lo.append(torch.where(par[k], 0.0, torch.minimum(t0, t1)))
        hi.append(torch.where(par[k], BIG, torch.maximum(t0, t1)))
        ok = ok & (~par[k] | ((o[k] >= bmin[:, k]) & (o[k] <= bmax[:, k])))
    tmin = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2]).clamp_min(0.0)
    tmax = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    return (tmax >= tmin) & ok, tmin


def bvh_hit(tri, o, d):
    """Nearest triangle along (o, d) by ``tpurt.ops.intersect.bvh_hit``:
    a per-ray stack walk (64 deep) of the Scene's own BVH (``tri.bvh``,
    whose leaves index tri's rows), vectorised over the rays. A node is
    entered when its slab test passes with entry t_entry < the best t so
    far; an inner node pushes right, then left; a leaf sweeps
    ``tri.max_leaf`` slots masked by its count, and a triangle wins on a
    strict t < best, so the first visited keeps a tie. Returns (t, loc,
    normal, mat, index) as ``closest_triangle``."""
    bmin, bmax, left, right, first, count = tri.bvh
    n, T = o[0].shape[0], tri.count
    dev = o[0].device
    par = tuple(x.abs() < 1e-20 for x in d)
    inv = tuple(fdiv(1.0, torch.where(p, 1.0, x)) for p, x in zip(par, d))
    rows = torch.arange(n, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = torch.full_like(o[0], MISS)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    while True:
        live = sp > 0
        if not bool(live.any()):
            break
        sp = sp - live.long()
        node = stack[rows, sp.clamp_min(0)]
        reach, t_entry = _aabb_entry(o, d, inv, par, bmin[node], bmax[node])
        go = live & reach & (t_entry < best_t)
        cnt = count[node].long()
        leaf = go & (cnt > 0)
        if bool(leaf.any()):
            f0 = first[node].long()
            for i in range(tri.max_leaf):
                ti = (f0 + i).clamp_max(T - 1)
                t, valid = _mt(*(tuple(x[ti, k] for k in range(3))
                                 for x in (tri.a, tri.e1, tri.e2)), o, d)
                t = torch.where(valid & leaf & (i < cnt), t, MISS)
                better = t < best_t
                best_t = torch.where(better, t, best_t)
                best_i = torch.where(better, ti, best_i)
        inner = go & (cnt == 0)
        if bool(inner.any()):
            r, at = rows[inner], sp[inner]
            stack[r, at] = right[node[inner]].long()
            stack[r, at + 1] = left[node[inner]].long()
            sp = sp + 2 * inner.long()
    return _tri_finish(tri, o, d, best_t, best_i)
