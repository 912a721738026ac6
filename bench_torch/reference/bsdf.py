"""Scalar-polymorphic BSDF helpers of the plain reference, copied from
the port's ``tpurt_torch/ops/bsdf.py``."""

from __future__ import annotations

import torch

from bench_torch.reference.fmath import fsqrt

PI = 3.14159265358979
INV_PI = 0.3183098861837907
TWO_PI = 6.283185307179586


def fr_dielectric(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel reflectance; rays from inside
    (cos < 0) use 1/eta, total internal reflection returns 1."""
    ct = cos_theta_i.clamp(-1.0, 1.0)
    inside = ct < 0.0
    e = torch.where(inside, 1.0 / eta, eta)
    ct = ct.abs()
    sin2_ti = 1.0 - ct * ct
    sin2_tt = sin2_ti / (e * e)
    tir = sin2_tt >= 1.0
    ct_t = fsqrt((1.0 - sin2_tt).clamp_min(0.0))
    r_parl = (e * ct - ct_t) / (e * ct + ct_t).clamp_min(1e-20)
    r_perp = (ct - e * ct_t) / (ct + e * ct_t).clamp_min(1e-20)
    fr = (r_parl * r_parl + r_perp * r_perp) * 0.5
    return torch.where(tir, 1.0, fr)
