"""tpurt_torch.ops (spectra, bsdf/soa helpers, sphere intersection) against
tpurt's component-form functions on the same seeded NumPy inputs.

Tolerance: rtol 1e-5, atol 1e-6 on floats (PyTorch and XLA round
transcendentals differently by an ulp or so); tables, masks and integer
results are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.kernels import mega_pallas
from tpurt.ops import bsdf as jbsdf
from tpurt.ops import soa as js
from tpurt.ops import spectra as jspec
from tpurt.scene import cornell_spheres_scene as j_cornell
from tpurt_torch.ops import bsdf as tbsdf
from tpurt_torch.ops import intersect as tint
from tpurt_torch.ops import soa as ts
from tpurt_torch.ops import spectra as tspec
from tpurt_torch.scene import cornell_spheres_scene, freeze_scene

# the port builds on the CUDA card by default: these tests ask for the CPU
CPU = "cpu"


# small tensors: one intra-op thread per test worker avoids oversubscribing
# the cores that pytest-xdist's workers share
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def close(got, want, mask=None):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def vclose(got, want, mask=None):
    for g, w in zip(got, want):
        close(g, w, mask)


def planes(rs, n=N, lo=-1.0, hi=1.0):
    a = rs.uniform(lo, hi, n).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def unit_vecs(rs, n=N):
    v = rs.normal(size=(3, n)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    v = v.astype(np.float32)
    return (tuple(torch.from_numpy(c) for c in v),
            tuple(jnp.asarray(c) for c in v))


@pytest.mark.parametrize("name", ["CIE_X", "CIE_Y", "CIE_Z", "XYZ_TO_SRGB",
                                  "CIE_RGB_TABLE"])
def test_spectra_tables_equal(name):
    want = getattr(jspec, name)
    got = getattr(tspec, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_spectra_constants_equal():
    for name in ("VISIBLE_MIN", "VISIBLE_MAX", "VISIBLE_RANGE", "N_CIE",
                 "CIE_STEP", "DISPERSION_B"):
        assert getattr(tspec, name) == getattr(jspec, name), name


def test_cie_to_rgb():
    rs = np.random.default_rng(0)
    lam_t, lam_j = planes(rs, lo=380.0, hi=780.0)
    got = tspec.cie_to_rgb(lam_t)
    close(got, jspec.cie_to_rgb(lam_j))
    vclose(ts.cie_to_rgb_c(lam_t), js.cie_to_rgb_c(lam_j))


@pytest.mark.parametrize("temp", [2700.0, 5500.0, 9000.0])
def test_blackbody(temp):
    rs = np.random.default_rng(1)
    lam_t, lam_j = planes(rs, lo=380.0, hi=780.0)
    close(tspec.blackbody(lam_t, temp),
          jspec.blackbody(lam_j, np.float32(temp)))


def test_cauchy_and_wavelength():
    rs = np.random.default_rng(2)
    lam_t, lam_j = planes(rs, lo=380.0, hi=780.0)
    close(tspec.cauchy_ior(1.5, lam_t), jspec.cauchy_ior(1.5, lam_j))
    u_t, u_j = planes(rs, lo=0.0, hi=1.0)
    close(tspec.sample_wavelength(u_t), jspec.sample_wavelength(u_j))


def test_fr_dielectric():
    rs = np.random.default_rng(3)
    c_t, c_j = planes(rs, lo=-1.2, hi=1.2)
    e_t, e_j = planes(rs, lo=1.0, hi=2.5)
    close(tbsdf.fr_dielectric(c_t, e_t), jbsdf.fr_dielectric(c_j, e_j))


def test_oren_nayar():
    rs = np.random.default_rng(4)
    (wo_t, wo_j), (wi_t, wi_j), (n_t, n_j) = (unit_vecs(rs) for _ in "abc")
    col_t, col_j = zip(*(planes(rs, lo=0.0, hi=1.0) for _ in range(3)))
    sig_t, sig_j = planes(rs, lo=0.0, hi=1.0)
    vclose(ts.oren_nayar_c(wo_t, wi_t, n_t, col_t, sig_t),
           js.oren_nayar_c(wo_j, wi_j, n_j, col_j, sig_j))


def test_ggx_terms():
    rs = np.random.default_rng(5)
    z_t, z_j = planes(rs, lo=-1.0, hi=1.0)
    z2_t, z2_j = planes(rs, lo=-1.0, hi=1.0)
    a_t, a_j = planes(rs, lo=0.0, hi=1.0)
    close(ts.tr_d_c(z_t, a_t), js.tr_d_c(z_j, a_j))
    close(ts.tr_lambda_c(z_t, a_t), js.tr_lambda_c(z_j, a_j))
    close(ts.tr_g_c(z_t, z2_t, a_t), js.tr_g_c(z_j, z2_j, a_j))
    close(ts.tr_g1_c(z_t, a_t), js.tr_g1_c(z_j, a_j))
    (wo_t, wo_j) = unit_vecs(rs)
    u1_t, u1_j = planes(rs, lo=0.0, hi=1.0)
    u2_t, u2_j = planes(rs, lo=0.0, hi=1.0)
    vclose(ts.tr_sample_wm_c(wo_t, u1_t, u2_t, a_t),
           js.tr_sample_wm_c(wo_j, u1_j, u2_j, a_j))


def test_reflect_refract_frames():
    rs = np.random.default_rng(6)
    (wo_t, wo_j), (n_t, n_j) = unit_vecs(rs), unit_vecs(rs)
    vclose(ts.reflect_c(wo_t, n_t), js.reflect_c(wo_j, n_j))
    e_t, e_j = planes(rs, lo=1.0, hi=2.0)
    wi_t, ok_t = ts.refract_c(wo_t, n_t, e_t)
    wi_j, ok_j = js.refract_c(wo_j, n_j, e_j)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    vclose(wi_t, wi_j)
    T_t, T_j = ts.build_tangent_frame_c(n_t), js.build_tangent_frame_c(n_j)
    vclose(T_t, T_j)
    B_t, B_j = ts.vcross(n_t, T_t), js.vcross(n_j, T_j)
    loc_t = ts.to_local_c(wo_t, n_t, T_t, B_t)
    vclose(loc_t, js.to_local_c(wo_j, n_j, T_j, B_j))
    vclose(ts.to_world_c(loc_t, n_t, T_t, B_t),
           js.to_world_c(js.to_local_c(wo_j, n_j, T_j, B_j), n_j, T_j, B_j))
    u1_t, u1_j = planes(rs, lo=0.0, hi=1.0)
    u2_t, u2_j = planes(rs, lo=0.0, hi=1.0)
    vclose(ts.unit_vec_from_u_c(u1_t, u2_t), js.unit_vec_from_u_c(u1_j, u2_j))


def _rays(seed):
    """Rays from random points inside the Cornell box, random directions
    (unnormalized, like camera rays)."""
    rs = np.random.default_rng(seed)
    o = np.stack([rs.uniform(-4.5, 4.5, N), rs.uniform(0.5, 9.5, N),
                  rs.uniform(-8.0, 4.5, N)]).astype(np.float32)
    d = (rs.normal(size=(3, N)) * rs.uniform(0.5, 2.0, N)).astype(np.float32)
    return ((tuple(torch.from_numpy(c) for c in o),
             tuple(torch.from_numpy(c) for c in d)),
            (tuple(jnp.asarray(c) for c in o),
             tuple(jnp.asarray(c) for c in d)))


@pytest.mark.parametrize("seed", [10, 11])
def test_closest_sphere_matches_static_sweep(seed):
    (o_t, d_t), (o_j, d_j) = _rays(seed)
    t_t, loc_t, n_t, m_t = tint.closest_sphere(
        freeze_scene(cornell_spheres_scene(device=CPU)).spheres, o_t, d_t)
    t_j, loc_j, n_j, m_j = mega_pallas._closest_sphere_static(
        mega_pallas.freeze_scene(j_cornell()).spheres, o_j, d_j)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    close(t_t, t_j)
    hit = np.asarray(t_j) < mega_pallas._HIT
    assert hit.mean() > 0.9
    vclose(loc_t, loc_j, hit)
    vclose(n_t, n_j, hit)


@pytest.mark.parametrize("seed", [12, 13])
def test_shadow_matches_static_sweep(seed):
    (o_t, d_t), (o_j, d_j) = _rays(seed)
    rs = np.random.default_rng(seed + 100)
    tmax = rs.uniform(0.1, 20.0, N).astype(np.float32)
    lam = rs.uniform(380.0, 780.0, N).astype(np.float32)
    got = tint.shadow_spheres(freeze_scene(cornell_spheres_scene(device=CPU)).spheres,
                              o_t, d_t, torch.from_numpy(tmax),
                              torch.from_numpy(lam))
    want = mega_pallas._shadow_static(
        mega_pallas.freeze_scene(j_cornell()).spheres, o_j, d_j,
        jnp.asarray(tmax), jnp.asarray(lam))
    close(got, want)
    # the dielectric balls transmit part of the light on some segments
    assert ((np.asarray(want) > 0.0) & (np.asarray(want) < 1.0)).any()
