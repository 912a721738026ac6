"""The eager-torch lockstep integrator: spectral path tracing with
next-event estimation plus the per-pixel SPPM photon pass.

This is the plain PyTorch version of the path kernels
(``csrc/mega_regen.cu``: the regen kernel in both modes, and the
tile-synchronized kernel ``csrc/mega_step.cu``) and the port's
``backend="xla"``. It ports ``tpurt/integrate.py`` for sphere and mesh
scenes with tpurt's sampler flags (hero wavelengths with the collapse bit,
dispersion on camera paths, photon emission and bounce strata, camera
bounce strata), tpurt's emission besides the lights (the sky on a miss,
emissive materials, the per-sample radiance clamp), tpurt's camera-spawn
extensions (the thin lens, the shutter, the Sobol spawn draws), the
photon walks' roulette thinning (photon_rr_scale), tpurt's many-light NEE
(light_sample "power" and "spatial", ``_nee_select``) and aimed photon
emission (photon_aim), in the component form and op order of tpurt's
kernel device code (``tpurt/kernels/mega_pallas.py``: ``nee_direct_c``,
``_nee_direct_power_c``,
``scatter_rr_c``, ``_evaluate_bsdf_c``, ``_single_lambda_em_c``), so that
it, tpurt and the CUDA kernels draw the same PCG streams and take the same
branches. The hero emission comes from the host table
(``ops.spectra.hero_emission_table``) that the kernels read too.

All pixels advance in lockstep: per sample, the camera path of every
pixel, then photon walk k = 0..K-1 of every pixel, then the accumulation.
Dead lanes keep computing under masks (``torch.where``), like tpurt's
tiles; a bounce loop stops early once every lane is dead.

The nearest-hit query takes its triangle test from a ``TriMode``: the
exact sweep (the kernels' walks), the sweep of tpurt's G-matrix leaf test
(the regen kernel under ``pallas_mxu_leaf``) or tpurt's per-ray BVH walk
(``use_bvh`` on backend="xla" and the plain wavefront pool). The caller
that knows the backend picks it; shadow segments always take the exact
any-hit sweep, as in tpurt.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch.camera import spawn_camera_rays
from tpurt_torch.ops import fdiv, fsqrt
from tpurt_torch.ops import soa as s
from tpurt_torch.ops.bsdf import INV_PI, TWO_PI, fr_dielectric
from tpurt_torch.ops.intersect import (HIT, bvh_hit, closest_sphere,
                                      closest_triangle, closest_triangle_g,
                                      occluded_triangle, shadow_spheres)
from tpurt_torch.ops import qmc as qmcmod
from tpurt_torch.ops import rng as rngmod
from tpurt_torch.ops import sampling
from tpurt_torch.ops.rng import frame_seed, photon_stream, rand_1f, seed_pixels
from tpurt_torch.ops.spectra import (DISPERSION_B, blackbody,
                                     flat_emission, flat_hero_table,
                                     hero_emission_lookup,
                                     hero_emission_table, legacy_sky,
                                     sample_wavelength, sky_emission,
                                     sky_hero_table, sky_on, sky_tint)
from tpurt_torch.scene import EPS, PHOTON_CONE_COS, photon_power


def material_table(fs, device) -> torch.Tensor:
    """(M, 6) float32 rows r, g, b, roughness, ior, type."""
    rows = [[*m.color, m.rough, m.ior, float(m.mtype)] for m in fs.materials]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def material_lookup(mats, mat_id):
    """Per-lane (color, rough, ior, is_diffuse, is_metal)."""
    row = mats[mat_id]
    mtype = row[:, 5]
    return ((row[:, 0], row[:, 1], row[:, 2]), row[:, 3], row[:, 4],
            mtype == 0.0, mtype == 2.0)


def is_emitter(mats, mat_id):
    """Per-lane: the hit material is emissive (type 3)."""
    return mats[mat_id][:, 5] == 3.0


@dataclasses.dataclass(frozen=True)
class TriMode:
    """The triangle test of the nearest-hit query: ``"exact"``, the
    brute-force Moller-Trumbore sweep; ``"gleaf"``, the brute-force sweep
    of tpurt's G-matrix leaf test over the G rows ``gmat``
    (``kernels.bvh.gmat``); ``"bvh"``, tpurt's XLA per-ray walk of the
    Scene's BVH."""
    kind: str = "exact"
    gmat: torch.Tensor | None = None


EXACT = TriMode()
BVH = TriMode("bvh")


def intersect_scene(fs, o, d, tri: TriMode = EXACT):
    """Nearest hit, (t, loc, normal, mat): spheres, then the triangles by
    ``tri``'s test; a triangle wins only on a strict t_tri < t_sph
    (``mega_pallas._combine_nearest``). With the exact or the G sweep, the
    plain version of the kernels' BVH walks (csrc/bvh.cuh)."""
    hit = closest_sphere(fs.spheres, o, d, fs.sph_rows)
    if fs.triangles is None:
        return hit
    if tri.kind == "gleaf":
        tri = closest_triangle_g(tri.gmat, fs.triangles, o, d)
    elif tri.kind == "bvh":
        tri = bvh_hit(fs.triangles, o, d)
    else:
        tri = closest_triangle(fs.triangles, o, d)
    take = tri[0] < hit[0]
    return (torch.where(take, tri[0], hit[0]), s.vwhere(take, tri[1], hit[1]),
            s.vwhere(take, tri[2], hit[2]), torch.where(take, tri[3], hit[3]))


def _shadow(fs, o, d, t_max, lam):
    """Shadow factor of o + d*[0, t_max]: the spheres' transmission, 0
    where a triangle occludes."""
    atten = shadow_spheres(fs.spheres, o, d, t_max, lam, fs.sph_rows)
    if fs.triangles is None:
        return atten
    return torch.where(occluded_triangle(fs.triangles, o, d, t_max), 0.0,
                       atten)


def light_emission_rgb(fs, lam):
    """Per-light spectral emission at one wavelength, a list of L vec3s:
    color*intensity*range * blackbody(lam, T) * cie_rgb(lam)."""
    cie = s.cie_to_rgb_c(lam)
    out = []
    for lt in fs.lights:
        if lt.temp > 0.0:
            spd = blackbody(lam, lt.temp)
            out.append(tuple(lt.em_scale[c] * spd * cie[c]
                             for c in range(3)))
        else:
            out.append(tuple(lt.em_scale[c] * cie[c] for c in range(3)))
    return out


def hero_count(cfg) -> int:
    """C, the wavelengths that share a camera path (1: the reference)."""
    return max(1, int(cfg.hero_wavelengths))


def tracks_collapse(fs, cfg) -> bool:
    """Whether a camera path can collapse to its hero wavelength: hero on,
    dispersion on camera paths, and a dielectric in the scene (tpurt's
    kernels' rule; without a dielectric the bit never sets)."""
    return (hero_count(cfg) > 1 and cfg.dispersion_in_camera_path
            and any(m.mtype == 1 for m in fs.materials))


def hero_tables(fs, c: int) -> list:
    """Each light's hero emission table for C wavelengths (host float32
    NumPy), built once per frozen scene and C."""
    key = ("hero", c)
    if key not in fs.cache:
        fs.cache[key] = [hero_emission_table(lt.color, lt.intensity, lt.temp,
                                             c) for lt in fs.lights]
    return fs.cache[key]


def hero_emission_rgb(fs, cfg, lam):
    """Per-light C-averaged emission at the hero wavelength, a list of L
    vec3s: the lookup into each light's hero table."""
    c = hero_count(cfg)
    return [hero_emission_lookup(torch.from_numpy(tab).to(lam.device), c,
                                 lam).unbind(-1)
            for tab in hero_tables(fs, c)]


def any_emitter(fs) -> bool:
    return any(m.mtype == 3 for m in fs.materials)


def emission_on(fs, cfg, wavefront: bool = False) -> bool:
    """Whether a render adds emission besides the lights' or clamps its
    samples: the sky, an emissive material, the radiance clamp and, on the
    wavefront tracers (``wavefront``), the legacy sky ramp. It selects the
    kernels' emission instances."""
    return (sky_on(cfg) or any_emitter(fs) or cfg.radiance_clamp > 0.0
            or (wavefront and bool(cfg.sky_gradient)))


def emission_tables(fs, cfg, c: int) -> tuple:
    """The sky's and the type-3 base's hero tables for C wavelengths (host
    float32 NumPy), built once per frozen scene, C and sky."""
    key = ("emit", c, float(cfg.sky_intensity), float(cfg.sky_temp))
    if key not in fs.cache:
        fs.cache[key] = (sky_hero_table(cfg, c), flat_hero_table(c))
    return fs.cache[key]


@dataclasses.dataclass(frozen=True)
class Emit:
    """A camera path's emission besides the lights, per lane, as a render
    adds it. ``sky``: the sky's untinted emission (None: a black sky);
    ``base``: the type-3 emission base (None: no emitter in the scene);
    each hero-averaged when C > 1, and ``*_hero`` its single-wavelength
    form that a collapsed path takes (None without collapse tracking).
    ``legacy``: the wavefront tracers' RGB ramp on a miss instead (the sky
    off, sky_gradient on)."""
    sky: tuple | None = None
    sky_hero: tuple | None = None
    base: tuple | None = None
    base_hero: tuple | None = None
    legacy: bool = False


def camera_emission(fs, cfg, lam, wavefront: bool = False):
    """The emission a camera path of wavelength lam adds: (em, em_hero,
    emit). ``em``: the lights' emission for NEE (hero-averaged when C > 1),
    ``em_hero`` its single-wavelength form a collapsed path takes (None
    without collapse tracking), ``emit`` the rest (``Emit``; the legacy
    ramp only with ``wavefront``)."""
    c = hero_count(cfg)
    track = tracks_collapse(fs, cfg)
    em, em_hero = light_emission_rgb(fs, lam), None
    if c > 1:
        em, em_hero = hero_emission_rgb(fs, cfg, lam), (em if track
                                                         else None)
    sky = sky_hero = base = base_hero = None
    if sky_on(cfg):
        sky = sky_emission(cfg, lam)
    if any_emitter(fs):
        base = flat_emission(lam)
    if c > 1 and (sky is not None or base is not None):
        tabs = [hero_emission_lookup(torch.from_numpy(t).to(lam.device), c,
                                     lam).unbind(-1)
                for t in emission_tables(fs, cfg, c)]
        if sky is not None:
            sky, sky_hero = tabs[0], (sky if track else None)
        if base is not None:
            base, base_hero = tabs[1], (base if track else None)
    return em, em_hero, Emit(
        sky=sky, sky_hero=sky_hero, base=base, base_hero=base_hero,
        legacy=wavefront and sky is None and bool(cfg.sky_gradient))


def _collapsed(coll, hero, avg):
    return avg if hero is None else s.vwhere(coll, hero, avg)


def add_sky(cfg, emit: Emit, rad, tp, d, miss, coll):
    """rad plus the sky's radiance along d where ``miss`` (camera lanes
    that hit nothing): tp * emission * tint, or tp * the legacy ramp."""
    if emit.sky is not None:
        em = _collapsed(coll, emit.sky_hero, emit.sky)
        tint = sky_tint(cfg, d)
        add = tuple(rad[c] + tp[c] * em[c] * tint[c] for c in range(3))
    elif emit.legacy:
        ramp = legacy_sky(d)
        add = tuple(rad[c] + tp[c] * ramp[c] for c in range(3))
    else:
        return rad
    return s.vwhere(miss, add, rad)


def add_emitters(emit: Emit, rad, tp, color, hit_em, coll):
    """rad plus tp * color * the emission base where ``hit_em`` (camera
    lanes that hit an emissive material)."""
    if emit.base is None:
        return rad
    em = _collapsed(coll, emit.base_hero, emit.base)
    return s.vwhere(hit_em, tuple(rad[c] + tp[c] * color[c] * em[c]
                                  for c in range(3)), rad)


def clamp_sample(cfg, rad):
    """A sample's radiance capped channel by channel at radiance_clamp (0:
    off). Only what is added to the image is capped, never the radiance a
    path carries."""
    if cfg.radiance_clamp <= 0.0:
        return rad
    cl = float(np.float32(cfg.radiance_clamp))
    return tuple(torch.clamp_max(r, cl) for r in rad)


def sample_direct_lighting(fs, loc, n, lam, rng, em, mode: str = "all"):
    """Next-event estimation (``nee_direct_c``). Mode "all": every light,
    2 draws and one shadow segment each. Modes "power" and "spatial"
    (``_nee_select``): one light per lane, 3 draws. No light: no draw.
    Every lane draws; the caller keeps the result of live diffuse lanes
    and counts ``shadow_segments`` per such lane."""
    if mode != "all" and fs.lights:
        return _nee_select(fs, mode, loc, n, lam, rng, em)
    zero = torch.zeros_like(loc[0])
    direct = (zero, zero, zero)
    for li, lt in enumerate(fs.lights):
        u1, rng = rand_1f(rng)
        u2, rng = rand_1f(rng)
        if lt.ltype == 1:
            su = (u1 - 0.5) * lt.two_hw
            sv = (u2 - 0.5) * lt.two_hw
            lp = tuple(lt.pos[c] + su * lt.tangent[c] + sv * lt.bitangent[c]
                       for c in range(3))
        else:
            lp = s.vbroadcast(lt.pos, u1)
        to_light = s.vsub(lp, loc)
        dist = fsqrt(s.vdot(to_light, to_light).clamp_min(1e-30))
        ldir = s.vscale(to_light, 1.0 / dist)
        ndotl = s.vdot(n, ldir)
        live = (dist >= EPS) & (ndotl > 0.0)
        if lt.ltype == 1:
            cos_light = (-(lt.normal[0] * ldir[0] + lt.normal[1] * ldir[1]
                           + lt.normal[2] * ldir[2])).clamp_min(0.0)
            live = live & (cos_light > 0.0) & (lt.hw > 0.0)
            geom = ndotl * cos_light * lt.area_scale
        else:
            geom = ndotl
        so = s.vadd(loc, s.vscale(n, EPS))
        atten = _shadow(fs, so, ldir, dist - EPS, lam)
        w = torch.where(live, geom * atten / (dist * dist), 0.0)
        direct = s.vadd(direct, s.vscale(em[li], w))
    return direct, rng


def shadow_segments(fs, cfg) -> int:
    """Shadow segments a diffuse camera hit traces: one per light in mode
    "all", else one (none without a light)."""
    n = len(fs.lights)
    return n if cfg.light_sample == "all" else min(1, n)


# the light rows _nee_select gathers: pos, normal, tangent, bitangent,
# two_hw, hw, is_area
_ROW_POS, _ROW_NORMAL, _ROW_T, _ROW_B = 0, 3, 6, 9
_ROW_TWO_HW, _ROW_HW, _ROW_AREA = 12, 13, 14


def light_rows(fs, device) -> torch.Tensor:
    """(L, 15) float32 rows of the frozen lights (``_ROW_*``), built once
    per scene and device."""
    key = ("light_rows", str(device))
    if key not in fs.cache:
        fs.cache[key] = torch.tensor(
            [[*lt.pos, *lt.normal, *lt.tangent, *lt.bitangent, lt.two_hw,
              lt.hw, float(lt.ltype == 1)] for lt in fs.lights],
            dtype=torch.float32, device=device)
    return fs.cache[key]


def _nee_select(fs, mode, loc, n, lam, rng, em):
    """Next-event estimation with one light per lane (modes "power" and
    "spatial", tpurt's ``_nee_direct_power_c``): 3 draws, u_sel then the
    light sample's pair. The lane picks light i in proportion to its power
    (``ops.sampling.light_power``), divided in mode "spatial" by
    max(d^2, 1e-4), d the distance to the light's centre, and weighs it by
    1/pmf: em * geom * atten * inv_pdf * inv_pmf / dist^2."""
    u_sel, rng = rand_1f(rng)
    powers = [sampling.light_power(lt) for lt in fs.lights]
    if mode == "spatial":
        floor = float(np.float32(1e-4))

        def power_of(i):
            pos = fs.lights[i].pos
            dx = pos[0] - loc[0]
            dy = pos[1] - loc[1]
            dz = pos[2] - loc[2]
            return fdiv(powers[i], (dx * dx + dy * dy + dz * dz)
                        .clamp_min(floor))
    else:
        def power_of(i):
            return powers[i]
    idx, inv_pmf = sampling.select_light(u_sel, power_of, len(powers))
    u1, rng = rand_1f(rng)
    u2, rng = rand_1f(rng)
    row = light_rows(fs, loc[0].device)[idx]
    col = lambda j: row[:, j]  # noqa: E731
    area = col(_ROW_AREA) > 0.5
    hw = col(_ROW_HW)
    su = (u1 - 0.5) * col(_ROW_TWO_HW)
    sv = (u2 - 0.5) * col(_ROW_TWO_HW)
    pos = tuple(col(_ROW_POS + c) for c in range(3))
    lp = s.vwhere(area, tuple(pos[c] + su * col(_ROW_T + c)
                              + sv * col(_ROW_B + c) for c in range(3)), pos)
    to_light = s.vsub(lp, loc)
    dist = fsqrt(s.vdot(to_light, to_light).clamp_min(1e-30))
    ldir = s.vscale(to_light, 1.0 / dist)
    ndotl = s.vdot(n, ldir)
    cos_light = (-(col(_ROW_NORMAL) * ldir[0] + col(_ROW_NORMAL + 1) * ldir[1]
                   + col(_ROW_NORMAL + 2) * ldir[2])).clamp_min(0.0)
    live = ((dist >= EPS) & (ndotl > 0.0)
            & (~area | ((cos_light > 0.0) & (hw > 0.0))))
    inv_pdf = torch.where(area, (4.0 * hw * hw).clamp_min(1e-10), 1.0)
    geom = ndotl * torch.where(area, cos_light, 1.0)
    so = s.vadd(loc, s.vscale(n, EPS))
    atten = _shadow(fs, so, ldir, dist - EPS, lam)
    w = torch.where(live, geom * atten * inv_pdf * inv_pmf / (dist * dist),
                    0.0)
    sels = [idx == i for i in range(len(powers))]
    emv = tuple(sampling.select_chain(sels, [e[c] for e in em])
                for c in range(3))
    return s.vscale(emv, w), rng


def _schlick(cos_t, f0):
    c = cos_t.abs().clamp(0.0, 1.0)
    m = 1.0 - c
    w = m * m * m * m * m
    return tuple(f0[i] + (1.0 - f0[i]) * w for i in range(3))


def _diffuse_scatter(wo, n, color, rough, u2a, u2b):
    """Cosine scatter with the Oren-Nayar throughput."""
    rn = s.unit_vec_from_u_c(u2a, u2b)
    wi_d = s.vnormalize(s.vadd(n, rn), eps=1e-30)
    cosw = s.vdot(n, wi_d).clamp_min(1e-10)
    pdf_d = cosw * INV_PI
    f_diff = s.oren_nayar_c(s.vnormalize(wo, eps=1e-30), wi_d, n, color,
                            rough)
    return wi_d, s.vscale(f_diff, cosw / pdf_d.clamp_min(1e-10))


def _scatter_metal(wo, normal, f0, alpha, u2a, u2b):
    """GGX conductor: mirror + Schlick when smooth, VNDF sample with
    weight F * G2/G1 when rough. Returns (wi, tp vec3, valid)."""
    cos_t = s.vdot(wo, normal)
    wi_sm = s.reflect_c(wo, normal)
    tp_sm = _schlick(cos_t, f0)
    valid_sm = s.vdot(wi_sm, normal) * cos_t > 0.0

    T = s.build_tangent_frame_c(normal)
    B = s.vcross(normal, T)
    wo_l = s.to_local_c(wo, normal, T, B)
    wm = s.tr_sample_wm_c(wo_l, u2a, u2b, alpha)
    wi_l = s.reflect_c(wo_l, wm)
    valid_r = wo_l[2] * wi_l[2] > 0.0
    F = _schlick(s.vdot(wo_l, wm), f0)
    G2 = s.tr_g_c(wo_l[2], wi_l[2], alpha)
    G1 = s.tr_g1_c(wo_l[2], alpha)
    tp_r = s.vscale(F, G2 / G1.clamp_min(1e-10))
    wi_rough = s.to_world_c(wi_l, normal, T, B)

    smooth = alpha < 1e-3
    return (s.vwhere(smooth, wi_sm, wi_rough), s.vwhere(smooth, tp_sm, tp_r),
            (smooth & valid_sm) | (~smooth & valid_r))


def _scatter_dielectric(wo, normal, eta, alpha, u2a, u2b, u_choice,
                        camera_pdf: bool):
    """Smooth or rough GGX dielectric. camera_pdf selects the VNDF pdf of
    the camera path, else the photon path's Lambda+1 approximation.
    Returns (wi, tp_mult, offset, valid)."""
    cos_t = s.vdot(wo, normal)
    R_s = fr_dielectric(cos_t.abs(), eta)
    reflect_s = u_choice < R_s
    wi_refl_s = s.reflect_c(wo, normal)
    wi_refr_s, refr_ok = s.refract_c(wo, normal, eta)
    etap_s = torch.where(cos_t < 0.0, 1.0 / eta, eta)
    tp_refr_s = 1.0 / (etap_s * etap_s)
    wi_smooth = s.vwhere(reflect_s, wi_refl_s, wi_refr_s)
    tp_smooth = torch.where(reflect_s, 1.0, tp_refr_s)
    off_smooth = torch.where(reflect_s, EPS, -EPS)
    valid_smooth = reflect_s | refr_ok

    T = s.build_tangent_frame_c(normal)
    B = s.vcross(normal, T)
    wo_l = s.to_local_c(wo, normal, T, B)
    wm = s.tr_sample_wm_c(wo_l, u2a, u2b, alpha)
    dot_wowm = s.vdot(wo_l, wm).abs()
    R = fr_dielectric(dot_wowm, eta)
    Tns = 1.0 - R
    choose_reflect = u_choice < R / (R + Tns).clamp_min(1e-10)

    D = s.tr_d_c(wm[2], alpha)

    wi_l_refl = s.reflect_c(wo_l, wm)
    refl_ok = wo_l[2] * wi_l_refl[2] > 0.0
    G_r = s.tr_g_c(wo_l[2], wi_l_refl[2], alpha)
    ct_i_r = wi_l_refl[2].abs()
    ct_o = wo_l[2].abs()
    bsdf_r = D * G_r * R / (4.0 * ct_i_r * ct_o).clamp_min(1e-10)
    if camera_pdf:
        G1 = s.tr_g1_c(wo_l[2], alpha)
        pdf_wm = (G1 / ct_o.clamp_min(1e-10)) * D * dot_wowm
        pdf_r = (pdf_wm / (4.0 * dot_wowm).clamp_min(1e-10)).clamp_min(
            1e-10) * (R / (R + Tns).clamp_min(1e-10))
    else:
        pdf_r = s.tr_lambda_c(wo_l[2], alpha) + 1.0
    tp_r = bsdf_r * ct_i_r / pdf_r.clamp_min(1e-10)

    wi_l_refr, refr_l_ok = s.refract_c(wo_l, wm, eta)
    trans_ok = refr_l_ok & ~(wo_l[2] * wi_l_refr[2] > 0.0)
    G_t = s.tr_g_c(wo_l[2], wi_l_refr[2], alpha)
    ct_i_t = wi_l_refr[2].abs()
    denom = s.vdot(wi_l_refr, wm) + s.vdot(wo_l, wm) / eta
    bsdf_t = Tns * D * G_t * (
        s.vdot(wi_l_refr, wm) * s.vdot(wo_l, wm)
        / (ct_i_t * ct_o * denom * denom).clamp_min(1e-10)).abs()
    if camera_pdf:
        dwm_dwi = s.vdot(wi_l_refr, wm).abs() / (denom * denom).clamp_min(
            1e-10)
        G1 = s.tr_g1_c(wo_l[2], alpha)
        pdf_t = ((G1 / ct_o.clamp_min(1e-10)) * D * dot_wowm * dwm_dwi
                 * (Tns / (R + Tns).clamp_min(1e-10))).clamp_min(1e-10)
    else:
        pdf_t = s.tr_lambda_c(wo_l[2], alpha) + 1.0
    etap_t = torch.where(wo_l[2] < 0.0, 1.0 / eta, eta)
    tp_t = bsdf_t * ct_i_t / pdf_t.clamp_min(1e-10) / (etap_t * etap_t)

    wi_l = s.vwhere(choose_reflect, wi_l_refl, wi_l_refr)
    wi_rough = s.to_world_c(wi_l, normal, T, B)
    tp_rough = torch.where(choose_reflect, tp_r, tp_t)
    off_rough = torch.where(choose_reflect, EPS, -EPS)
    valid_rough = (choose_reflect & refl_ok) | (~choose_reflect & trans_ok)

    smooth = alpha < 1e-3
    return (s.vwhere(smooth, wi_smooth, wi_rough),
            torch.where(smooth, tp_smooth, tp_rough),
            torch.where(smooth, off_smooth, off_rough),
            (smooth & valid_smooth) | (~smooth & valid_rough))


def evaluate_bsdf(wo, wi, n, color, rough, eta, is_diff, is_metal):
    """Photon-gather BSDF: Oren-Nayar for diffuse, GGX reflection only
    for dielectrics (at the dispersed ``eta``) and metals."""
    f_diff = s.oren_nayar_c(wo, wi, n, color, rough)
    refl = s.vdot(n, wo) * s.vdot(n, wi) > 0.0
    alpha = fsqrt(rough)
    wm = s.vnormalize(s.vadd(wi, wo), eps=1e-30)
    R = fr_dielectric(s.vdot(wo, wm), eta)
    T = s.build_tangent_frame_c(n)
    B = s.vcross(n, T)
    wo_l = s.to_local_c(wo, n, T, B)
    wi_l = s.to_local_c(wi, n, T, B)
    wm_l = s.to_local_c(wm, n, T, B)
    D = s.tr_d_c(wm_l[2], alpha)
    G = s.tr_g_c(wo_l[2], wi_l[2], alpha)
    denom = (4.0 * wi_l[2].abs() * wo_l[2].abs()).clamp_min(1e-10)
    spec = torch.where(refl, D * G * R / denom, 0.0)
    F_m = _schlick(s.vdot(wo, wm), color)
    dg = torch.where(refl, D * G / denom, 0.0)
    f_spec = s.vwhere(is_metal, s.vscale(F_m, dg), (spec, spec, spec))
    return s.vwhere(is_diff, f_diff, f_spec)


def scatter_and_rr(cfg, wo, n, loc, color, rough, eta, is_diffuse, is_metal,
                   tp, rng, camera_path: bool, any_dielectric: bool = True,
                   any_metal: bool = True, bounce_strata=None):
    """The scatter + Russian roulette step (``scatter_rr_c``): 4 draws
    (u2a, u2b, u_choice, u_rr). ``eta`` is the dielectric IOR: the base
    IOR on camera paths (dispersed under dispersion_in_camera_path), the
    dispersed one on photon walks. ``bounce_strata`` (strata seed, k,
    bounce) moves (u2a, u2b, u_choice) into that bounce cell
    (``rng.apply_bounce_strata``). Returns (wi, new_tp, new_o, scat_ok,
    rr_live, rng)."""
    u2a, rng = rand_1f(rng)
    u2b, rng = rand_1f(rng)
    u_choice, rng = rand_1f(rng)
    u_rr, rng = rand_1f(rng)
    if bounce_strata is not None:
        b_seed, b_k, b_bounce = bounce_strata
        u2a, u2b, u_choice = rngmod.apply_bounce_strata(
            b_seed, b_k, b_bounce, rngmod.strata_counts(cfg)[1], u2a, u2b,
            u_choice)

    wi, tpm = _diffuse_scatter(wo, n, color, rough, u2a, u2b)
    off = torch.full_like(u2a, EPS)
    scat_ok = torch.ones_like(u2a, dtype=torch.bool)
    alpha = fsqrt(rough)
    if any_dielectric:
        wi_s, tpm_s, off_s, valid_s = _scatter_dielectric(
            wo, n, eta, alpha, u2a, u2b, u_choice, camera_pdf=camera_path)
        is_diel = ~(is_diffuse | is_metal)
        wi = s.vwhere(is_diel, wi_s, wi)
        tpm = s.vwhere(is_diel, (tpm_s, tpm_s, tpm_s), tpm)
        off = torch.where(is_diel, off_s, off)
        scat_ok = (is_diel & valid_s) | (~is_diel & scat_ok)
    if any_metal:
        wi_m, tpm_m, valid_m = _scatter_metal(wo, n, color, alpha, u2a, u2b)
        wi = s.vwhere(is_metal, wi_m, wi)
        tpm = s.vwhere(is_metal, tpm_m, tpm)
        scat_ok = (is_metal & valid_m) | (~is_metal & scat_ok)

    new_tp = s.vmul(tp, tpm)
    new_o = s.vadd(loc, s.vscale(n, off))
    prob = s.vmax_comp(new_tp)
    thr = cfg.rr_threshold if camera_path else cfg.photon_rr_threshold
    scale = 1.0 if camera_path else cfg.photon_rr_scale
    if scale == 1.0:
        rr_live = (prob >= thr) & (u_rr <= prob)
        new_tp = s.vscale(new_tp, 1.0 / prob.clamp_min(1e-30))
    else:
        # photon_rr_scale: survive with min(prob, 1) * scale, reweight by
        # 1 / (prob * scale), in the op order of tpurt's kernels
        sc = float(np.float32(scale))
        rr_live = (prob >= thr) & (u_rr <= prob.clamp_max(1.0) * sc)
        new_tp = s.vscale(new_tp, 1.0 / (prob * sc).clamp_min(1e-30))
    return wi, new_tp, new_o, scat_ok, rr_live, rng


def _material_kinds(fs):
    return (any(m.mtype == 1 for m in fs.materials),
            any(m.mtype == 2 for m in fs.materials))


def trace_camera_paths(fs, cfg, mats, o, d, lam, rng, depth: int, vis,
                       valid, em, em_hero=None, strata_seed=None,
                       tri: TriMode = EXACT, emit: Emit = Emit()):
    """One camera path per lane, up to ``depth`` bounces. The first
    diffuse hit of the path overwrites the lane's vispoint (``vis``, 13
    planes: pos 3, norm 3, wo 3, tp 3, mat 1). ``em`` is the per-light
    emission NEE adds (hero-averaged when C > 1); with ``em_hero`` (the
    single-wavelength emission) a lane collapses to it on its first
    dielectric hit, and so do ``emit``'s sky and emission base. A miss adds
    ``emit``'s sky; a hit on an emissive material adds its emission and
    ends the path, with no vispoint and no collapse. ``strata_seed`` keys
    the camera bounce cells under camera_strata_bounce; ``tri`` is the
    nearest hit's triangle test. Returns (rad, vis, rays)."""
    zero = torch.zeros_like(o[0])
    one = torch.ones_like(o[0])
    tp = (one, one, one)
    rad = (zero, zero, zero)
    vis = list(vis)
    active = valid.clone()
    vp_stored = torch.zeros_like(valid)
    coll = torch.zeros_like(valid)
    rays = torch.zeros((), dtype=torch.int64, device=valid.device)
    n_shadow = shadow_segments(fs, cfg)
    any_diel, any_metal = _material_kinds(fs)
    cam_strata = bool(cfg.photon_strata and cfg.camera_strata_bounce)
    if cfg.dispersion_in_camera_path:
        lam_um = lam * 1e-3
        cauchy_add = fdiv(DISPERSION_B, lam_um * lam_um)
    for b in range(depth):
        if not bool(active.any()):
            break
        rays = rays + active.sum()
        t, loc, n, mat = intersect_scene(fs, o, d, tri)
        found = t < HIT
        color, rough, ior, is_diffuse, is_metal = material_lookup(mats, mat)
        is_em = is_emitter(mats, mat)
        wo = s.vneg(d)
        rad = add_sky(cfg, emit, rad, tp, d, active & ~found, coll)
        rad = add_emitters(emit, rad, tp, color, active & found & is_em,
                           coll)

        store = active & found & is_diffuse & ~vp_stored
        for base, val in ((0, loc), (3, n), (6, wo), (9, tp)):
            for c in range(3):
                vis[base + c] = torch.where(store, val[c], vis[base + c])
        vis[12] = torch.where(store, mat.to(torch.float32), vis[12])
        vp_stored = vp_stored | store

        em_b = em if em_hero is None else [
            s.vwhere(coll, h, a) for h, a in zip(em_hero, em)]
        direct, rng = sample_direct_lighting(fs, loc, n, lam, rng, em_b,
                                             cfg.light_sample)
        lane_d = active & found & is_diffuse
        nee = s.vmul(s.vmul(tp, color), direct)
        rad = s.vwhere(lane_d, s.vadd(rad, nee), rad)
        rays = rays + lane_d.sum() * n_shadow

        eta = ior + cauchy_add if cfg.dispersion_in_camera_path else ior
        wi, new_tp, new_o, scat_ok, rr_live, rng = scatter_and_rr(
            cfg, wo, n, loc, color, rough, eta, is_diffuse, is_metal, tp,
            rng, camera_path=True, any_dielectric=any_diel,
            any_metal=any_metal, bounce_strata=(
                (strata_seed, rngmod.CAMERA_STRATA_K, b) if cam_strata
                else None))
        if em_hero is not None:
            coll = coll | (active & found & ~(is_diffuse | is_metal | is_em))
        cont = active & found & scat_ok & rr_live & ~is_em
        o = s.vwhere(cont, new_o, o)
        d = s.vwhere(cont, wi, d)
        tp = s.vwhere(cont, new_tp, tp)
        active = cont
    return rad, vis, rays


def _photon_emission(lt, cfg, u):
    """Photon origin, direction and throughput from the 7 emission draws
    (uc, up1, unused, ue1, ue2, uh1, uh2)."""
    uc, up1, _, ue1, ue2, uh1, uh2 = u
    if lt.ltype == 0:
        ct = 1.0 - uc * float(np.float32(1.0 - PHOTON_CONE_COS))
        stn = fsqrt((1.0 - ct * ct).clamp_min(0.0))
        phi = TWO_PI * up1
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        kd = tuple(stn * cphi * lt.cone_t[c] + stn * sphi * lt.cone_b[c]
                   + ct * lt.cone_axis[c] for c in range(3))
        ko = s.vbroadcast(lt.pos, uc)
    else:
        su = (ue1 - 0.5) * lt.two_hw
        sv = (ue2 - 0.5) * lt.two_hw
        ko = tuple(lt.ph_origin[c] + su * lt.tangent[c] + sv * lt.bitangent[c]
                   for c in range(3))
        theta = TWO_PI * uh1
        r_ = fsqrt(uh2)
        x_ = r_ * torch.cos(theta)
        y_ = r_ * torch.sin(theta)
        z_ = fsqrt((1.0 - r_ * r_).clamp_min(0.0))
        kd = tuple(x_ * lt.tangent[c] + y_ * lt.bitangent[c]
                   + z_ * lt.normal[c] for c in range(3))
    kt = s.vbroadcast(photon_power(lt, cfg.k_photons), uc)
    return ko, kd, kt


def trace_photons(fs, cfg, mats, lam, seed, px, py, vis, radius, valid, rad,
                  strata_seed=None, tri: TriMode = EXACT):
    """The SPPM photon pass: K photons per lane, emitted round-robin over
    the lights, each from its own stream ``photon_stream(seed, px, py, k)``,
    adding density-estimated radiance into ``rad`` wherever they land
    within ``radius`` (a float32 scalar, or one radius per lane) of the
    lane's vispoint. Lanes with no vispoint (|pos| <= 0.001) emit nothing.
    Under photon_strata the emission uniforms (and, with
    photon_strata_bounce, each bounce's scatter uniforms) move into the
    cells of ``strata_seed`` (default ``seed``). Under photon_aim every
    photon draws 3 more numbers after its 7 emission draws (choice, cone
    pair), and an area light's photon aims at the lane's vispoint with
    probability photon_aim, its throughput weighed by the mixture
    (``ops.soa.aimed_cone_c``, ``aim_mixture_weight_c``). ``seed`` is an
    int or one seed per lane; ``tri`` is the nearest hit's triangle test.
    Returns (rad, rays)."""
    rays = torch.zeros((), dtype=torch.int64, device=valid.device)
    L = len(fs.lights)
    K = cfg.k_photons if (cfg.enable_photons and L > 0) else 0
    if K == 0:
        return rad, rays
    vpos, vnorm, vwo, vtp = vis[0:3], vis[3:6], vis[6:9], vis[9:12]
    vp_ok = (fsqrt(s.vdot(vpos, vpos)) > 0.001) & valid
    v_color, v_rough, v_ior, v_isdiff, v_ismetal = material_lookup(
        mats, vis[12].to(torch.int64))
    lam_um = lam * 1e-3
    cauchy_add = fdiv(DISPERSION_B, lam_um * lam_um)
    v_eta = v_ior + cauchy_add
    if isinstance(radius, torch.Tensor):   # one radius per lane
        r = radius
        inv_pi_r2 = fdiv(1.0, (float(np.float32(np.pi)) * r * r)
                         .clamp_min(1e-10))
    else:
        r32 = np.float32(radius)
        r = float(r32)
        inv_pi_r2 = float(np.float32(1.0) / np.maximum(
            np.float32(np.pi) * r32 * r32, np.float32(1e-10)))
    any_diel, any_metal = _material_kinds(fs)
    strata_seed = seed if strata_seed is None else strata_seed
    aim = cfg.photon_aim > 0.0
    for k in range(K):
        rng = photon_stream(seed, px, py, k)
        u = []
        for _ in range(7):
            x, rng = rand_1f(rng)
            u.append(x)
        if aim:
            uch, rng = rand_1f(rng)
            ua1, rng = rand_1f(rng)
            ua2, rng = rand_1f(rng)
        if cfg.photon_strata:
            u[0], u[1], u[3], u[4], u[5], u[6] = \
                rngmod.apply_emission_strata(
                    strata_seed, rngmod.strata_k(cfg, k),
                    *rngmod.strata_counts(cfg), u[0], u[1], u[3], u[4],
                    u[5], u[6])
        lt = fs.lights[k % L]
        o, d, tp = _photon_emission(lt, cfg, u)
        if aim and lt.ltype == 1:
            # aim at the lane's own vispoint with probability q, weighed
            # by the defensive mixture (tpurt's trace_photons)
            q_lane = torch.where(vp_ok, float(np.float32(cfg.photon_aim)),
                                 0.0)
            d_aim, axis, cos_a = s.aimed_cone_c(o, vpos, r,
                                                cfg.photon_aim_widen, ua1,
                                                ua2)
            d = s.vwhere(uch < q_lane, d_aim, d)
            tp = s.vscale(tp, s.aim_mixture_weight_c(d, lt.normal, axis,
                                                     cos_a, q_lane))
        active = vp_ok.clone()
        ph_strata = bool(cfg.photon_strata and cfg.photon_strata_bounce)
        for b in range(cfg.max_photon_bounces):
            if not bool(active.any()):
                break
            rays = rays + active.sum()
            t, loc, n, mat = intersect_scene(fs, o, d, tri)
            found = t < HIT

            dvec = s.vsub(loc, vpos)
            dist = fsqrt(s.vdot(dvec, dvec).clamp_min(0.0))
            near = dist < r
            f = evaluate_bsdf(vwo, s.vneg(d), vnorm, v_color, v_rough, v_eta,
                              v_isdiff, v_ismetal)
            kern = (1.0 - fdiv(dist, r)) * inv_pi_r2
            dens = s.vscale(s.vmul(s.vmul(vtp, f), tp), kern)
            rad = s.vwhere(active & found & near, s.vadd(rad, dens), rad)

            color, rough, ior, is_diffuse, is_metal = material_lookup(mats,
                                                                      mat)
            wi, new_tp, new_o, scat_ok, rr_live, rng = scatter_and_rr(
                cfg, s.vneg(d), n, loc, color, rough, ior + cauchy_add,
                is_diffuse, is_metal, tp, rng, camera_path=False,
                any_dielectric=any_diel, any_metal=any_metal,
                bounce_strata=((strata_seed, rngmod.strata_k(cfg, k), b)
                               if ph_strata else None))
            # an emissive material absorbs the photon
            cont = active & found & scat_ok & rr_live & ~is_emitter(mats, mat)
            o = s.vwhere(cont, new_o, o)
            d = s.vwhere(cont, wi, d)
            tp = s.vwhere(cont, new_tp, tp)
            active = cont
    return rad, rays


def spawn_camera(cfg, camera, px, py, seed, qmc_ctx=None):
    """The camera spawn of a sample for the pixels (px, py): 2 jitter
    draws, the shutter time under motion_blur, the 2 lens draws when
    aperture > 0 (``camera.spawn_camera_rays``), the wavelength. Under qmc
    they come from the Sobol stream of ``qmc_ctx`` = (base_seed, global
    sample index: an int or one per pixel), and the PCG stream of
    ``seed`` that the path goes on with starts at position 0; else from
    that PCG stream, which goes on after them. Returns (o, d, lam, rng)."""
    rng = seed_pixels(seed, px, py)
    if cfg.qmc:
        if qmc_ctx is None:
            raise ValueError("cfg.qmc=True requires qmc_ctx="
                             "(base_seed, global_sample_index)")
        src = qmcmod.spawn_stream(qmc_ctx[0], qmc_ctx[1], px, py)
    else:
        src = rng
    uj1, src = rand_1f(src)
    uj2, src = rand_1f(src)
    u = fdiv(px.to(torch.float32) + uj1, float(cfg.width))
    v = fdiv(py.to(torch.float32) + uj2, float(cfg.height))
    o, d, src = spawn_camera_rays(cfg, camera, u, v, src)
    ulam, src = rand_1f(src)
    return o, d, sample_wavelength(ulam), rng if cfg.qmc else src


def render_tile(fs, cfg, mats, camera, px, py, valid, seed, radius,
                depth: int, vis, strata_seed=None, tri: TriMode = EXACT,
                qmc_ctx=None):
    """One progressive sample for the pixels (px, py): camera spawn
    (``spawn_camera``; ``qmc_ctx`` under qmc), camera path, photon pass.
    ``seed`` and ``strata_seed`` (default ``seed``) are ints or one per
    pixel, ``radius`` a float or one per pixel; ``tri`` is the nearest
    hit's triangle test. The color is the sample's radiance under the
    radiance clamp. Returns (color vec3, vis, rays)."""
    strata_seed = seed if strata_seed is None else strata_seed
    o, d, lam, rng = spawn_camera(cfg, camera, px, py, seed, qmc_ctx)
    em, em_hero, emit = camera_emission(fs, cfg, lam)
    rad, vis, rays = trace_camera_paths(fs, cfg, mats, o, d, lam, rng, depth,
                                        vis, valid, em, em_hero, strata_seed,
                                        tri, emit)
    rad, prays = trace_photons(fs, cfg, mats, lam, seed, px, py, vis, radius,
                               valid, rad, strata_seed, tri)
    return clamp_sample(cfg, rad), vis, rays + prays


def sppm_radius_step(cfg, k, radius):
    """r * sqrt((k + alpha) / (k + 1)) in float32, k the 1-based sample
    index (``tpurt.render.sppm_radius_step``)."""
    kf = np.float32(k)
    return np.float32(np.float32(radius) * np.sqrt(
        (kf + np.float32(cfg.sppm_alpha)) / (kf + np.float32(1.0))))


def sample_strata_seed(cfg, base_seed: int, iteration, seed):
    """The seed the strata cells of sample ``iteration`` hash: the frame
    seed of its window epoch under photon_strata_window > 1, else the
    sample's own ``seed`` (``tpurt/render.py``). ``iteration`` and ``seed``
    are ints or tensors."""
    if cfg.photon_strata and cfg.photon_strata_window > 1:
        return frame_seed(base_seed, rngmod.strata_epoch(cfg, iteration))
    return seed


def _pixels(cfg, P: int, dev):
    idx = torch.arange(P, device=dev)
    return (idx % cfg.width, torch.clamp_max(idx // cfg.width, cfg.height - 1),
            idx < cfg.n_pixels)


def render_plain(fs, cfg, camera, planes, base_seed: int, spp: int,
                 iteration: int, radius: float, depth: int,
                 tri: TriMode = EXACT) -> torch.Tensor:
    """``spp`` samples into the (16, P) float32 state planes, in place:
    rgb_sum 0-2, vis_pos 3-5, vis_norm 6-8, vis_wo 9-11, vis_tp 12-14,
    vis_mat 15. The same contract as the regen kernel's launch: sample s
    draws from ``frame_seed(base_seed, iteration + s)`` and gathers photons
    within the radius after s schedule steps; ``tri`` is the nearest
    hit's triangle test. Returns the traced segments as an int64 scalar
    tensor on the planes' device."""
    dev = planes.device
    px, py, valid = _pixels(cfg, planes.shape[1], dev)
    mats = material_table(fs, dev)
    vis = list(planes[3:16].unbind(0))
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    r = np.float32(radius)
    for smp in range(spp):
        seed = frame_seed(base_seed, iteration + smp)
        rad, vis, srays = render_tile(
            fs, cfg, mats, camera, px, py, valid, seed, r, depth, vis,
            sample_strata_seed(cfg, base_seed, iteration + smp, seed), tri,
            (base_seed, iteration + smp))
        for c in range(3):
            planes[c] += rad[c]
        rays = rays + srays
        r = sppm_radius_step(cfg, np.float32(iteration) + np.float32(smp + 1),
                             r)
    planes[3:16] = torch.stack(vis)
    return rays


def radius_table(cfg, n: int) -> np.ndarray:
    """(n + 1,) float32: the SPPM radius after c = 0..n samples from
    photon_radius_init (tpurt's ``budget_radius_plane``: the schedule's
    float sequence, so a pixel's radius depends on its own count only)."""
    out = np.empty((n + 1,), np.float32)
    out[0] = np.float32(cfg.photon_radius_init)
    for c in range(1, n + 1):
        out[c] = sppm_radius_step(cfg, c, out[c - 1])
    return out


def render_plain_budget(fs, cfg, camera, planes, base_seed: int, budgets,
                        counts, tri: TriMode = EXACT) -> torch.Tensor:
    """The regen kernel's budget mode, in place on the (16, P) planes:
    pixel p renders ``budgets[p]`` samples (an integer tensor, 0 on pad
    rows) continuing its own sequence: its sample s draws from
    ``frame_seed(base_seed, counts[p] + s)`` (counts = the state's
    n_samples) with its own strata epoch, and gathers photons within its
    own SPPM radius, which starts at the schedule's value after counts[p]
    samples and steps after each of its samples; ``tri`` is the nearest
    hit's triangle test. Returns the traced segments as an int64 scalar
    tensor."""
    dev = planes.device
    px, py, valid = _pixels(cfg, planes.shape[1], dev)
    mats = material_table(fs, dev)
    vis = list(planes[3:16].unbind(0))
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    budgets = budgets.to(dev).long()
    cnt = counts.to(dev).long()
    cnt_f = counts.to(dev).to(torch.float32)
    r = torch.from_numpy(radius_table(cfg, int(cnt.max()) if cnt.numel()
                                      else 0)).to(dev)[cnt]
    for smp in range(int(budgets.max()) if budgets.numel() else 0):
        live = valid & (smp < budgets)
        it = cnt + smp
        seed = frame_seed(base_seed, it)
        rad, vis, srays = render_tile(
            fs, cfg, mats, camera, px, py, live, seed, r, cfg.depth, vis,
            sample_strata_seed(cfg, base_seed, it, seed), tri,
            (base_seed, it))
        for c in range(3):
            planes[c] = torch.where(live, planes[c] + rad[c], planes[c])
        rays = rays + srays
        k = cnt_f + float(np.float32(smp + 1))
        r = torch.where(live, r * fsqrt(fdiv(k + cfg.sppm_alpha, k + 1.0)),
                        r)
    planes[3:16] = torch.stack(vis)
    return rays
