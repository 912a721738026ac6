"""Sphere and triangle hits and shadow factors of the plain reference, in
component form: a copy of the port's plain intersection code
(``tpurt_torch/ops/intersect.py``) for scenes of at most
``SPHERE_LOOP_MAX`` spheres, with the exact triangle sweep only.

Spheres: one reciprocal of |d|^2 per ray, the ``disc > 0 & t > 0`` root
test, the hit point pulled back to ``o + d * (t * 0.9999)``, Fresnel
transmission through dielectric occluders only. Triangles: Moller-Trumbore
with the 1.17549435e-38 epsilon on |det| and on t, as a brute-force sweep
in chunks of rays x triangles; the closest hit is the least (t, scene
index), whatever the chunking. Its point is ``o + n * 1e-5 + d * t`` with
the unflipped geometric normal; occlusion is any-hit.
"""

from __future__ import annotations

import torch

from bench_torch.reference import soa as s
from bench_torch.reference.bsdf import fr_dielectric
from bench_torch.reference.fmath import fdiv, fsqrt
from bench_torch.reference.spectra import DISPERSION_B

MISS = 1e30
HIT = MISS * 0.5   # any t below this is a real hit
TRI_EPS = 1.17549435e-38   # 2^-126, the reference's MT epsilon
SPHERE_LOOP_MAX = 64       # the scenes' spheres are swept one by one
CHUNK_ELEMS = 1 << 24      # rays x triangles per chunk of a sweep


def _check_spheres(spheres) -> None:
    if len(spheres) > SPHERE_LOOP_MAX:
        raise NotImplementedError(f"the reference sweeps at most "
                                  f"{SPHERE_LOOP_MAX} spheres")


def _chunk(n_rays: int, n_prims: int) -> int:
    return max(1, min(n_prims, CHUNK_ELEMS // max(n_rays, 1)))


def _cols(x, lo, hi):
    """Columns lo:hi of a (P, 3) tensor as a vec3 of (1, C) rows."""
    return tuple(x[lo:hi, k][None] for k in range(3))


def closest_sphere(spheres, o, d):
    """Nearest sphere along (o, d). Returns (t, loc, normal, mat); t is
    MISS where nothing is hit."""
    _check_spheres(spheres)
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


def shadow_spheres(spheres, o, d, t_max, lam):
    """Transmission of the segment o + d*[0, t_max]: diffuse and metal
    spheres block it, dielectric ones pass (1-R1)(1-R2) at the
    dispersed IOR of wavelength ``lam``."""
    _check_spheres(spheres)
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


def _tri_finish(tri, o, d, best_t, best_i):
    """(t, loc, normal, mat, index) of the winners best_i at best_t."""
    hit = best_t < MISS
    nrm = tuple(torch.where(hit, tri.n[best_i, k], 0.0) for k in range(3))
    mat = torch.where(hit, tri.mat[best_i].to(torch.int64), 0)
    loc = s.vadd(s.vadd(o, s.vscale(nrm, 1e-5)), s.vscale(d, best_t))
    return best_t, loc, nrm, mat, best_i
