"""Component-form physics, ported from ``tpurt.ops.soa``.

A vec3 is a tuple of three same-shape float32 tensors (or Python floats
for scene constants), as in tpurt's kernels, so every function here keeps
the op order of its tpurt twin and of the CUDA kernel (``csrc/device.cuh``).
"""

from __future__ import annotations

import torch

import numpy as np

from tpurt_torch.ops import fdiv, fsqrt

from tpurt_torch.ops.bsdf import INV_PI, PI, TWO_PI
from tpurt_torch.ops.spectra import cie_to_rgb

# ----- vec3 as a tuple of planes -----


def vbroadcast(scalar3, like):
    """A (3,)-indexable of scalars as planes shaped like ``like``."""
    return tuple(torch.full_like(like, float(scalar3[c])) for c in range(3))


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vnormalize(a, eps=0.0):
    inv = 1.0 / fsqrt(vdot(a, a).clamp_min(eps))
    return vscale(a, inv)


def vwhere(m, a, b):
    return tuple(torch.where(m, a[c], b[c]) for c in range(3))


def vmax_comp(a):
    return torch.maximum(torch.maximum(a[0], a[1]), a[2])


# ----- shading frames -----

def build_tangent_frame_c(n):
    """T = normalize((nz, 0, -nx)); +X when n ~ +/-Y."""
    zero = torch.zeros_like(n[0])
    one = torch.ones_like(n[0])
    t_raw = vnormalize((n[2], zero, -n[0]), eps=1e-30)
    near_y = n[1].abs() > 0.99999
    return vwhere(near_y, (one, zero, zero), t_raw)


def to_local_c(w, n, t, b):
    return (vdot(w, t), vdot(w, b), vdot(w, n))


def to_world_c(w, n, t, b):
    return vadd(vadd(vscale(t, w[0]), vscale(b, w[1])), vscale(n, w[2]))


def unit_vec_from_u_c(u1, u2):
    """Uniform direction on the sphere (cos(acos z) folded to z)."""
    theta = TWO_PI * u1
    z = (1.0 - 2.0 * u2).clamp(-1.0, 1.0)
    sp = fsqrt((1.0 - z * z).clamp_min(0.0))
    return (sp * torch.cos(theta), sp * torch.sin(theta), z)


# ----- Oren-Nayar -----

def oren_nayar_c(wo, wi, n, albedo, sigma):
    """Oren-Nayar BRDF; albedo a vec3, returns albedo * f / pi."""
    ndotv = vdot(n, wo).clamp_min(0.0)
    ndotl = vdot(n, wi).clamp_min(0.0)

    sig2 = sigma * sigma
    A = 1.0 - 0.5 * sig2 / (sig2 + 0.33)
    B = 0.45 * sig2 / (sig2 + 0.09)

    sin_v = fsqrt((1.0 - ndotv * ndotv).clamp_min(0.0))
    sin_l = fsqrt((1.0 - ndotl * ndotl).clamp_min(0.0))

    wo_t = vsub(wo, vscale(n, ndotv))
    wi_t = vsub(wi, vscale(n, ndotl))
    denom = (sin_v * sin_l).clamp_min(1e-20)
    cos_phi_raw = (vdot(wo_t, wi_t) / denom).clamp(-1.0, 1.0)
    cos_phi_diff = torch.where((sin_v > 1e-6) & (sin_l > 1e-6),
                               cos_phi_raw, 1.0)

    sin_alpha = torch.maximum(sin_v, sin_l)
    tan_beta = torch.minimum(sin_v, sin_l) / torch.maximum(
        ndotv, ndotl).clamp_min(1e-20)

    scale = INV_PI * (A + B * cos_phi_diff.clamp_min(0.0) * sin_alpha
                      * tan_beta)
    valid = (ndotv >= 1e-6) & (ndotl >= 1e-6)
    scale = torch.where(valid, scale, 0.0)
    return vscale(albedo, scale)


# ----- GGX / Trowbridge-Reitz -----

def tan2_theta_z(wz):
    c2 = wz * wz
    t2 = (1.0 - c2) / c2.clamp_min(1e-10)
    return torch.where(c2 < 1e-10, 1e20, t2)


def tr_d_c(wmz, alpha):
    tan2 = tan2_theta_z(wmz)
    cos4 = (wmz * wmz) * (wmz * wmz)
    a2 = alpha * alpha
    e = tan2 / a2.clamp_min(1e-20)
    d = 1.0 / (PI * a2 * cos4 * (1.0 + e) * (1.0 + e)).clamp_min(1e-30)
    return torch.where(tan2 > 1e20, 0.0, d)


def tr_lambda_c(wz, alpha):
    tan2 = tan2_theta_z(wz)
    a2 = alpha * alpha
    lam = (fsqrt(1.0 + a2 * tan2) - 1.0) * 0.5
    return torch.where(tan2 > 1e20, 0.0, lam)


def tr_g_c(woz, wiz, alpha):
    return 1.0 / (1.0 + tr_lambda_c(woz, alpha) + tr_lambda_c(wiz, alpha))


def tr_g1_c(wz, alpha):
    return 1.0 / (1.0 + tr_lambda_c(wz, alpha))


def tr_sample_wm_c(wo, u1, u2, alpha):
    """VNDF sample (Heitz 2018) in the local frame; wo a local vec3."""
    wh = vnormalize((alpha * wo[0], alpha * wo[1], wo[2]), eps=1e-30)
    wh = vwhere(wh[2] < 0.0, vneg(wh), wh)

    zero = torch.zeros_like(wh[0])
    one = torch.ones_like(wh[0])
    t1_raw = vnormalize((-wh[1], wh[0], zero), eps=1e-30)
    t1 = vwhere(wh[2].abs() > 0.99999, (one, zero, zero), t1_raw)
    t2 = vcross(wh, t1)

    r = fsqrt(u2)
    phi = TWO_PI * u1
    px = r * torch.cos(phi)
    py = r * torch.sin(phi)
    h = fsqrt((1.0 - px * px).clamp_min(0.0))
    py = h + ((1.0 + wh[2]) * 0.5) * (py - h)

    pz = fsqrt((1.0 - px * px - py * py).clamp_min(0.0))
    nh = vadd(vadd(vscale(t1, px), vscale(t2, py)), vscale(wh, pz))

    wm = (alpha * nh[0], alpha * nh[1], nh[2].clamp_min(1e-6))
    return vnormalize(wm, eps=1e-30)


# ----- reflect / refract -----

def reflect_c(wo, n):
    return vsub(vscale(n, 2.0 * vdot(wo, n)), wo)


def refract_c(wo, n, eta):
    """Returns (wi, ok); wi is zero under total internal reflection."""
    ct = vdot(n, wo)
    inside = ct < 0.0
    e = torch.where(inside, 1.0 / eta, eta)
    na = vwhere(inside, vneg(n), n)
    ct = ct.abs()
    sin2_tt = (1.0 - ct * ct).clamp_min(0.0) / (e * e)
    tir = sin2_tt >= 1.0
    ct_t = fsqrt((1.0 - sin2_tt).clamp_min(0.0))
    wi = vadd(vscale(wo, -1.0 / e), vscale(na, ct / e - ct_t))
    zero = torch.zeros_like(wi[0])
    wi = vwhere(tir, (zero, zero, zero), wi)
    return wi, ~tir


def cone_toward_c(axis, uc, u1, cos_half):
    """Direction in the cone of half-angle cosine ``cos_half`` (a scalar
    or one per lane) about ``axis``: polar uc, azimuth u1."""
    T = build_tangent_frame_c(axis)
    B = vcross(axis, T)
    ct = 1.0 - uc * (1.0 - cos_half)
    st = fsqrt((1.0 - ct * ct).clamp_min(0.0))
    phi = TWO_PI * u1
    return vadd(vadd(vscale(T, st * torch.cos(phi)),
                     vscale(B, st * torch.sin(phi))), vscale(axis, ct))


# ----- aimed photon emission (photon_aim) -----

# The aim cone's half-angle sine: never tighter than ~1.1 degrees (bounds
# the aimed pdf), never wider than 45 degrees.
AIM_SIN_MIN = 0.02
AIM_SIN_MAX = 0.7071


def aimed_cone_c(o, aim, radius, widen, ua, ub):
    """A uniform direction in the cone from ``o`` toward ``aim`` whose
    half-angle subtends ``widen * radius`` at the aim's distance (radius a
    float32 scalar or one per lane; widen a float32 scalar). Returns (dir,
    axis, cos_a) for ``aim_mixture_weight_c``."""
    dv = vsub(aim, o)
    dist = fsqrt(vdot(dv, dv).clamp_min(1e-12))
    axis = vscale(dv, 1.0 / dist)
    if isinstance(radius, torch.Tensor):
        reach = float(np.float32(widen)) * radius
    else:
        reach = np.float32(widen) * np.float32(radius)
    sin_a = fdiv(reach, dist).clamp(AIM_SIN_MIN, AIM_SIN_MAX)
    cos_a = fsqrt(1.0 - sin_a * sin_a)
    return cone_toward_c(axis, ua, ub, cos_a), axis, cos_a


def aim_mixture_weight_c(d, lnorm, axis, cos_a, q):
    """p_cos / p_mix of the defensive emission mixture q * U(aim cone) +
    (1 - q) * cos(theta_n) / pi about the light normal ``lnorm``: 1 where
    q is 0, at most 1 / (1 - q) outside the cone. The cone test allows
    1e-6 below cos_a, for aimed directions that round just outside it."""
    p_cos = vdot(d, lnorm).clamp_min(0.0) * INV_PI
    in_cone = vdot(d, axis) >= cos_a - float(np.float32(1e-6))
    p_aim = torch.where(in_cone, fdiv(1.0, TWO_PI * (1.0 - cos_a)
                                      .clamp_min(1e-7)), 0.0)
    denom = q * p_aim + (1.0 - q) * p_cos
    return torch.where(denom > 0.0, fdiv(p_cos, denom.clamp_min(1e-30)), 0.0)


def cie_to_rgb_c(lambda_nm):
    """CIE -> sRGB response as a vec3 of planes."""
    return tuple(cie_to_rgb(lambda_nm).unbind(-1))
