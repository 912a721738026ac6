"""Spectral support of the plain reference, copied from the port's
``tpurt_torch/ops/spectra.py``: the CIE 1931 tables, Planck blackbody,
wavelength sampling and the hero-wavelength emission tables, in the op
order of the kernels' device code."""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.reference import fmath
from bench_torch.reference.fmath import fdiv

VISIBLE_MIN = 380.0
VISIBLE_MAX = 780.0
VISIBLE_RANGE = 400.0  # uniform-lambda pdf normalization = 1/range
N_CIE = 81
CIE_STEP = 5.0
DISPERSION_B = 0.004  # Cauchy B coefficient, um^2

# CIE 1931 2-deg standard observer, 380..780nm @ 5nm (public data).
CIE_X = np.array([
    0.001368000, 0.002236000, 0.004243000, 0.007650000, 0.01431000,
    0.02319000, 0.04351000, 0.07763000, 0.1343800, 0.2147700,
    0.2839000, 0.3285000, 0.3482800, 0.3480600, 0.3362000,
    0.3187000, 0.2908000, 0.2511000, 0.1953600, 0.1421000,
    0.09564000, 0.05795001, 0.03201000, 0.01470000, 0.004900000,
    0.002400000, 0.009300000, 0.02910000, 0.06327000, 0.1096000,
    0.1655000, 0.2257499, 0.2904000, 0.3597000, 0.4334499,
    0.5120501, 0.5945000, 0.6784000, 0.7621000, 0.8425000,
    0.9163000, 0.9786000, 1.0263000, 1.0567000, 1.0622000,
    1.0456000, 1.0026000, 0.9384000, 0.8544499, 0.7514000,
    0.6424000, 0.5419000, 0.4479000, 0.3608000, 0.2835000,
    0.2187000, 0.1649000, 0.1212000, 0.08740000, 0.06360000,
    0.04677000, 0.03290000, 0.02270000, 0.01584000, 0.01135916,
    0.008110916, 0.005790346, 0.004109457, 0.002899327, 0.002049190,
    0.001439971, 0.0009999493, 0.0006900786, 0.0004760213, 0.0003323011,
    0.0002348261, 0.0001661505, 0.0001174130, 0.00008307527, 0.00005870652,
    0.00004150994,
], dtype=np.float32)

CIE_Y = np.array([
    0.00003900000, 0.00006400000, 0.0001200000, 0.0002170000, 0.0003960000,
    0.0006400000, 0.001210000, 0.002180000, 0.004000000, 0.007300000,
    0.01160000, 0.01684000, 0.02300000, 0.02980000, 0.03800000,
    0.04800000, 0.06000000, 0.07390000, 0.09098000, 0.1126000,
    0.1390200, 0.1693000, 0.2080200, 0.2586000, 0.3230000,
    0.4073000, 0.5030000, 0.6082000, 0.7100000, 0.7932000,
    0.8620000, 0.9148501, 0.9540000, 0.9803000, 0.9949501,
    1.0000000, 0.9950000, 0.9786000, 0.9520000, 0.9154000,
    0.8700000, 0.8163000, 0.7570000, 0.6949000, 0.6310000,
    0.5668000, 0.5030000, 0.4412000, 0.3810000, 0.3210000,
    0.2650000, 0.2170000, 0.1750000, 0.1382000, 0.1070000,
    0.08160000, 0.06100000, 0.04458000, 0.03200000, 0.02320000,
    0.01700000, 0.01192000, 0.008210000, 0.005723000, 0.004102000,
    0.002929000, 0.002091000, 0.001484000, 0.001047000, 0.0007400000,
    0.0005200000, 0.0003611000, 0.0002492000, 0.0001719000, 0.0001200000,
    0.00008480000, 0.00006000000, 0.00004240000, 0.00003000000, 0.00002120000,
    0.00001499000,
], dtype=np.float32)

CIE_Z = np.array([
    0.006450001, 0.01054999, 0.02005001, 0.03621000, 0.06785001,
    0.1102000, 0.2074000, 0.3713000, 0.6456000, 1.0390501,
    1.3856000, 1.6229600, 1.7470600, 1.7826000, 1.7721100,
    1.7441000, 1.6692000, 1.5281000, 1.2876400, 1.0419000,
    0.8129501, 0.6162000, 0.4651800, 0.3533000, 0.2720000,
    0.2123000, 0.1582000, 0.1117000, 0.07824999, 0.05725001,
    0.04216000, 0.02984000, 0.02030000, 0.01340000, 0.008749999,
    0.005749999, 0.003900000, 0.002749999, 0.002100000, 0.001800000,
    0.001650001, 0.001400000, 0.001100000, 0.0008000000, 0.0006000000,
    0.0003400000, 0.0002400000, 0.0001900000, 0.0001000000, 0.00004999999,
    0.00003000000, 0.00002000000, 0.00001000000, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0,
], dtype=np.float32)

# XYZ -> linear sRGB (D65) (ref: spectrum.rs:260-264).
XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], dtype=np.float32)

# Precomputed per-wavelength sRGB response: (81, 3), the matrix baked in so
# a lookup is one lerp per channel.
CIE_RGB_TABLE = np.stack([CIE_X, CIE_Y, CIE_Z], axis=-1) @ XYZ_TO_SRGB.T


def cie_to_rgb(lambda_nm):
    """Piecewise-linear CIE -> linear sRGB response, (..., 3) float32.
    The index is truncated and clamped to [0, 80] like tpurt's
    component-form lookup (``ops/soa.cie_to_rgb_c``)."""
    table = torch.as_tensor(CIE_RGB_TABLE, dtype=fmath.F,
                            device=lambda_nm.device)
    t = fdiv(lambda_nm - VISIBLE_MIN, CIE_STEP)
    i = t.to(torch.int32)
    f = (t - i.to(fmath.F))[..., None]
    a = i.clamp(0, N_CIE - 1).long()
    b = (i + 1).clamp(0, N_CIE - 1).long()
    return table[a] * (1.0 - f) + table[b] * f


# Planck constants, combined in double like tpurt then used as float32
_H, _C, _K = 6.62607015e-34, 2.99792458e8, 1.380649e-23
BB_C1 = float(np.float32(2.0 * _H * _C * _C))
BB_C2 = float(np.float32(_H * _C / _K))


def blackbody(lambda_nm, temp_k):
    """Planck spectral radiance scaled by 1e-14; l**5 multiplies in
    JAX's integer_pow order, l * ((l*l) * (l*l))."""
    l = lambda_nm * 1e-9
    l2 = l * l
    l5 = l * (l2 * l2)
    return fdiv(BB_C1, l5 * (torch.exp(fdiv(BB_C2, l * temp_k)) - 1.0)) * 1e-14


def sample_wavelength(u):
    """Uniform wavelength in [380, 780] nm from a U[0,1] draw."""
    return VISIBLE_MIN + u * VISIBLE_RANGE


# ----- hero wavelengths (tpurt.ops.spectra.hero_emission_table) -----

def _cie_rgb_np(lam_nm):
    """Float64 NumPy mirror of cie_to_rgb (host table precomputation)."""
    t = (np.asarray(lam_nm, np.float64) - VISIBLE_MIN) / CIE_STEP
    i = np.clip(t.astype(np.int32), 0, N_CIE - 1)
    j = np.clip(i + 1, 0, N_CIE - 1)
    f = np.clip(t - i, 0.0, 1.0)[..., None]
    return CIE_RGB_TABLE[i] * (1.0 - f) + CIE_RGB_TABLE[j] * f


def _blackbody_np(lam_nm, temp_k):
    """Float64 NumPy mirror of blackbody."""
    h, c, k = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    l = np.asarray(lam_nm, np.float64) * 1e-9
    c1, c2 = 2.0 * h * c * c, h * c / k
    return c1 / (l ** 5 * (np.exp(c2 / (l * temp_k)) - 1.0)) * 1e-14


def hero_segments(c: int) -> int:
    """Segments of a C-wavelength hero table: 2.5 nm nodes over one period
    range/C."""
    return max(1, int(round(2.0 * (VISIBLE_RANGE / c) / CIE_STEP)))


def hero_emission_table(color, intensity, temp, c: int) -> np.ndarray:
    """The C-averaged spectral emission of one light over one period
    range/C of its hero rotation set, computed in float64 on the host and
    rounded to float32: (hero_segments(c) + 1, 3). The plain version and
    the kernels both read this table, so they stay bit-equal."""
    delta = VISIBLE_RANGE / c
    n_seg = hero_segments(c)
    lam0 = VISIBLE_MIN + np.arange(n_seg + 1) * (delta / n_seg)
    tab = np.zeros((n_seg + 1, 3), np.float64)
    base = np.asarray(color, np.float64) * intensity * VISIBLE_RANGE / c
    for j in range(c):
        # no wrap: the last node carries em(780), the first em(380)
        lj = lam0 + j * delta
        spd = _blackbody_np(lj, temp) if temp > 0.0 else np.ones_like(lj)
        tab += base[None, :] * spd[:, None] * _cie_rgb_np(lj)
    return tab.astype(np.float32)


def hero_emission_lookup(tab, c: int, lam):
    """Periodic lerp into a hero table (a float32 tensor on lam's device):
    lam (...) -> (..., 3), in the op order of tpurt's kernel lookup
    (``ops/soa.hero_em_lookup_c``)."""
    n_seg = tab.shape[0] - 1
    t = fdiv(lam - VISIBLE_MIN, float(np.float32(VISIBLE_RANGE / c)))
    u = (t - torch.floor(t)) * float(n_seg)
    i = u.to(torch.int32).clamp(0, n_seg - 1)
    f = (u - i.to(fmath.F))[..., None]
    i = i.long()
    return tab[i] * (1.0 - f) + tab[i + 1] * f
