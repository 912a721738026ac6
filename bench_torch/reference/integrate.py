"""The plain reference's integrator: a copy of the port's eager PyTorch
integrator (``tpurt_torch/integrate.py``, the plain version of its path
kernels) for what the benchmark's configurations use: sphere and mesh
scenes with square area lights, diffuse and dielectric materials, NEE over
every light, hero wavelengths, photon emission and bounce strata and camera
bounce strata, the exact triangle sweep, the reference roulette. Every
other knob is refused (``check_cfg``). Spectral path tracing with
next-event estimation plus the per-pixel SPPM photon pass, in the op order
of the kernels' device code, so that it draws the same PCG streams and
takes the same branches.

``render_lanes`` traces one lane per (sample, pixel) of a fresh state at
once: the camera paths of every lane, then each lane's vispoint as the
state would hold it after its camera path (its own, else that of the
pixel's latest earlier sample that stored one), then the photon passes, and
the radiance summed per pixel in sample order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_torch.reference import fmath
from bench_torch.reference import rng as rngmod
from bench_torch.reference import soa as s
from bench_torch.reference.bsdf import INV_PI, TWO_PI, fr_dielectric
from bench_torch.reference.fmath import fdiv, fsqrt
from bench_torch.reference.intersect import (HIT, closest_sphere,
                                             closest_triangle,
                                             occluded_triangle,
                                             shadow_spheres)
from bench_torch.reference.rng import (frame_seed, photon_stream, rand_1f,
                                       seed_pixels)
from bench_torch.reference.scene import EPS, photon_power
from bench_torch.reference.spectra import (DISPERSION_B, blackbody,
                                           hero_emission_lookup,
                                           hero_emission_table,
                                           sample_wavelength)

# RenderConfig fields the reference implements, and the value every other
# field must keep (the port's defaults)
_DEFAULTS = dict(
    rr_threshold=0.001, photon_rr_threshold=0.01, photon_rr_scale=1.0,
    photon_aim=0.0, dispersion_in_camera_path=False, aperture=0.0,
    light_sample="all", qmc=False, motion_blur=False, use_bvh=False,
    pallas_mxu_leaf=False, sky_gradient=False, sky_intensity=0.0,
    radiance_clamp=0.0, count_rays=True, tonemap_key=0.8,
    tonemap_saturation=1.0, enable_photons=True)


@dataclasses.dataclass(frozen=True)
class Cfg:
    """The render settings the reference reads."""
    width: int
    height: int
    depth: int
    k_photons: int = 4
    max_photon_bounces: int = 8
    photon_radius_init: float = 2.0
    sppm_alpha: float = 0.67
    rr_threshold: float = 0.001
    photon_rr_threshold: float = 0.01
    photon_strata: int = 0
    photon_strata_dir: int = 0
    photon_strata_shared_k: bool = False
    photon_strata_bounce: bool = False
    photon_strata_window: int = 1
    camera_strata_bounce: bool = False
    hero_wavelengths: int = 1
    tonemap_key: float = 0.8
    tonemap_saturation: float = 1.0


def check_cfg(render_kwargs: dict) -> Cfg:
    """The reference's settings from a configuration's RenderConfig
    keywords; raises on a knob it does not implement."""
    fields = {f.name for f in dataclasses.fields(Cfg)}
    kw = {}
    for k, v in render_kwargs.items():
        if k in fields:
            kw[k] = v
        elif k in _DEFAULTS:
            if v != _DEFAULTS[k]:
                raise NotImplementedError(f"the reference has no {k}={v!r}")
        elif not k.startswith(("pallas_", "backend", "tile_size")):
            raise NotImplementedError(f"the reference has no {k}")
    cfg = Cfg(**kw)
    if cfg.photon_strata_window != 1:
        raise NotImplementedError("the reference has photon_strata_window 1")
    return cfg


def material_table(fs, device) -> torch.Tensor:
    """(M, 6) rows r, g, b, roughness, ior, type."""
    rows = [[*m.color, m.rough, m.ior, float(m.mtype)] for m in fs.materials]
    return torch.tensor(rows, dtype=fmath.F, device=device)


def material_lookup(mats, mat_id):
    """Per-lane (color, rough, ior, is_diffuse, is_metal)."""
    row = mats[mat_id]
    mtype = row[:, 5]
    return ((row[:, 0], row[:, 1], row[:, 2]), row[:, 3], row[:, 4],
            mtype == 0.0, mtype == 2.0)


def intersect_scene(fs, o, d):
    """Nearest hit, (t, loc, normal, mat): spheres, then the triangles; a
    triangle wins only on a strict t_tri < t_sph."""
    hit = closest_sphere(fs.spheres, o, d)
    if fs.triangles is None:
        return hit
    tri = closest_triangle(fs.triangles, o, d)
    take = tri[0] < hit[0]
    return (torch.where(take, tri[0], hit[0]), s.vwhere(take, tri[1], hit[1]),
            s.vwhere(take, tri[2], hit[2]), torch.where(take, tri[3], hit[3]))


def _shadow(fs, o, d, t_max, lam):
    """Shadow factor of o + d*[0, t_max]: the spheres' transmission, 0
    where a triangle occludes."""
    atten = shadow_spheres(fs.spheres, o, d, t_max, lam)
    if fs.triangles is None:
        return atten
    return torch.where(occluded_triangle(fs.triangles, o, d, t_max), 0.0,
                       atten)


def light_emission_rgb(fs, lam):
    """Per-light spectral emission at one wavelength, a list of vec3s."""
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
    return max(1, int(cfg.hero_wavelengths))


def hero_emission_rgb(fs, cfg, lam):
    """Per-light C-averaged emission at the hero wavelength: the lookup
    into each light's hero table, built once per scene, C and precision."""
    c = hero_count(cfg)
    key = ("hero", c, fmath.F)
    if key not in fs.cache:
        fs.cache[key] = [torch.from_numpy(hero_emission_table(
            lt.color, lt.intensity, lt.temp, c)).to(lam.device, fmath.F)
            for lt in fs.lights]
    return [hero_emission_lookup(tab, c, lam).unbind(-1)
            for tab in fs.cache[key]]


def sample_direct_lighting(fs, loc, n, lam, rng, em):
    """Next-event estimation over every light: 2 draws and one shadow
    segment each."""
    zero = torch.zeros_like(loc[0])
    direct = (zero, zero, zero)
    for li, lt in enumerate(fs.lights):
        u1, rng = rand_1f(rng)
        u2, rng = rand_1f(rng)
        su = (u1 - 0.5) * lt.two_hw
        sv = (u2 - 0.5) * lt.two_hw
        lp = tuple(lt.pos[c] + su * lt.tangent[c] + sv * lt.bitangent[c]
                   for c in range(3))
        to_light = s.vsub(lp, loc)
        dist = fsqrt(s.vdot(to_light, to_light).clamp_min(1e-30))
        ldir = s.vscale(to_light, 1.0 / dist)
        ndotl = s.vdot(n, ldir)
        live = (dist >= EPS) & (ndotl > 0.0)
        cos_light = (-(lt.normal[0] * ldir[0] + lt.normal[1] * ldir[1]
                       + lt.normal[2] * ldir[2])).clamp_min(0.0)
        live = live & (cos_light > 0.0) & (lt.hw > 0.0)
        geom = ndotl * cos_light * lt.area_scale
        so = s.vadd(loc, s.vscale(n, EPS))
        atten = _shadow(fs, so, ldir, dist - EPS, lam)
        w = torch.where(live, geom * atten / (dist * dist), 0.0)
        direct = s.vadd(direct, s.vscale(em[li], w))
    return direct, rng


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


def _scatter_dielectric(wo, normal, eta, alpha, u2a, u2b, u_choice,
                        camera_pdf: bool):
    """Smooth or rough GGX dielectric. Returns (wi, tp_mult, offset,
    valid)."""
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
                   tp, rng, camera_path: bool, any_dielectric: bool,
                   bounce_strata=None):
    """The scatter + Russian roulette step: 4 draws (u2a, u2b, u_choice,
    u_rr); ``bounce_strata`` (strata seed, k, bounce) moves the first
    three into that bounce cell. Returns (wi, new_tp, new_o, scat_ok,
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

    new_tp = s.vmul(tp, tpm)
    new_o = s.vadd(loc, s.vscale(n, off))
    prob = s.vmax_comp(new_tp)
    thr = cfg.rr_threshold if camera_path else cfg.photon_rr_threshold
    rr_live = (prob >= thr) & (u_rr <= prob)
    new_tp = s.vscale(new_tp, 1.0 / prob.clamp_min(1e-30))
    return wi, new_tp, new_o, scat_ok, rr_live, rng


def trace_camera_paths(fs, cfg, mats, o, d, lam, rng, depth: int, valid, em,
                       strata_seed):
    """One camera path per lane, up to ``depth`` bounces. The first diffuse
    hit stores the lane's vispoint (13 planes: pos 3, norm 3, wo 3, tp 3,
    mat 1). Returns (rad, vis, stored, rays): ``stored`` marks the lanes
    that stored one, ``rays`` the segments of each lane."""
    zero = torch.zeros_like(o[0])
    one = torch.ones_like(o[0])
    tp = (one, one, one)
    rad = (zero, zero, zero)
    vis = [zero] * 13
    active = valid.clone()
    vp_stored = torch.zeros_like(valid)
    rays = torch.zeros_like(valid, dtype=torch.int64)
    n_shadow = len(fs.lights)
    any_diel = any(m.mtype == 1 for m in fs.materials)
    cam_strata = bool(cfg.photon_strata and cfg.camera_strata_bounce)
    for b in range(depth):
        if not bool(active.any()):
            break
        rays = rays + active.long()
        t, loc, n, mat = intersect_scene(fs, o, d)
        found = t < HIT
        color, rough, ior, is_diffuse, is_metal = material_lookup(mats, mat)
        wo = s.vneg(d)

        store = active & found & is_diffuse & ~vp_stored
        for base, val in ((0, loc), (3, n), (6, wo), (9, tp)):
            for c in range(3):
                vis[base + c] = torch.where(store, val[c], vis[base + c])
        vis[12] = torch.where(store, mat.to(fmath.F), vis[12])
        vp_stored = vp_stored | store

        direct, rng = sample_direct_lighting(fs, loc, n, lam, rng, em)
        lane_d = active & found & is_diffuse
        nee = s.vmul(s.vmul(tp, color), direct)
        rad = s.vwhere(lane_d, s.vadd(rad, nee), rad)
        rays = rays + lane_d.long() * n_shadow

        wi, new_tp, new_o, scat_ok, rr_live, rng = scatter_and_rr(
            cfg, wo, n, loc, color, rough, ior, is_diffuse, is_metal, tp,
            rng, camera_path=True, any_dielectric=any_diel, bounce_strata=(
                (strata_seed, rngmod.CAMERA_STRATA_K, b) if cam_strata
                else None))
        cont = active & found & scat_ok & rr_live
        o = s.vwhere(cont, new_o, o)
        d = s.vwhere(cont, wi, d)
        tp = s.vwhere(cont, new_tp, tp)
        active = cont
    return rad, vis, vp_stored, rays


def _photon_emission(lt, cfg, u):
    """An area light's photon origin, direction and throughput from the 7
    emission draws (uc, up1, unused, ue1, ue2, uh1, uh2)."""
    uc, up1, _, ue1, ue2, uh1, uh2 = u
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
                  strata_seed):
    """The SPPM photon pass: K photons per lane, emitted round-robin over
    the lights, each from its own stream, adding density-estimated
    radiance into ``rad`` wherever they land within ``radius`` (one per
    lane) of the lane's vispoint. Lanes with no vispoint (|pos| <= 0.001)
    emit nothing. Returns (rad, rays per lane)."""
    rays = torch.zeros_like(valid, dtype=torch.int64)
    L = len(fs.lights)
    K = cfg.k_photons if L > 0 else 0
    if K == 0:
        return rad, rays
    vpos, vnorm, vwo, vtp = vis[0:3], vis[3:6], vis[6:9], vis[9:12]
    vp_ok = (fsqrt(s.vdot(vpos, vpos)) > 0.001) & valid
    v_color, v_rough, v_ior, v_isdiff, v_ismetal = material_lookup(
        mats, vis[12].to(torch.int64))
    lam_um = lam * 1e-3
    cauchy_add = fdiv(DISPERSION_B, lam_um * lam_um)
    v_eta = v_ior + cauchy_add
    r = radius
    inv_pi_r2 = fdiv(1.0, (float(np.float32(np.pi)) * r * r)
                     .clamp_min(1e-10))
    any_diel = any(m.mtype == 1 for m in fs.materials)
    ph_strata = bool(cfg.photon_strata and cfg.photon_strata_bounce)
    for k in range(K):
        rng = photon_stream(seed, px, py, k)
        u = []
        for _ in range(7):
            x, rng = rand_1f(rng)
            u.append(x)
        if cfg.photon_strata:
            u[0], u[1], u[3], u[4], u[5], u[6] = \
                rngmod.apply_emission_strata(
                    strata_seed, rngmod.strata_k(cfg, k),
                    *rngmod.strata_counts(cfg), u[0], u[1], u[3], u[4],
                    u[5], u[6])
        lt = fs.lights[k % L]
        o, d, tp = _photon_emission(lt, cfg, u)
        active = vp_ok.clone()
        for b in range(cfg.max_photon_bounces):
            if not bool(active.any()):
                break
            rays = rays + active.long()
            t, loc, n, mat = intersect_scene(fs, o, d)
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
                any_dielectric=any_diel,
                bounce_strata=((strata_seed, rngmod.strata_k(cfg, k), b)
                               if ph_strata else None))
            cont = active & found & scat_ok & rr_live
            o = s.vwhere(cont, new_o, o)
            d = s.vwhere(cont, wi, d)
            tp = s.vwhere(cont, new_tp, tp)
            active = cont
    return rad, rays


def generate_rays(cam_rows, u, v):
    """Primary rays at fractional pixel coords: (origin, direction), the
    direction unnormalized."""
    o, h, vv, ll = (tuple(float(x) for x in row) for row in cam_rows)
    d = tuple(ll[c] + u * h[c] + v * vv[c] - o[c] for c in range(3))
    return tuple(torch.full_like(u, o[c]) for c in range(3)), d


def sppm_radius_step(cfg, k, radius):
    """r * sqrt((k + alpha) / (k + 1)) in float32, k the 1-based sample
    index."""
    kf = np.float32(k)
    return np.float32(np.float32(radius) * np.sqrt(
        (kf + np.float32(cfg.sppm_alpha)) / (kf + np.float32(1.0))))


def radii(cfg, spp: int) -> np.ndarray:
    """(spp,) float32: the radius each sample of a fresh state gathers
    within."""
    out = np.empty((spp,), np.float32)
    r = np.float32(cfg.photon_radius_init)
    for smp in range(spp):
        out[smp] = r
        r = sppm_radius_step(cfg, np.float32(smp + 1), r)
    return out


def render_lanes(fs, cfg, cam_rows, pixels: torch.Tensor, base_seed: int,
                 spp: int):
    """Samples 0..spp-1 of a fresh state at the linear pixel indices
    ``pixels`` (S,), one lane per (sample, pixel). Returns a dict of
    per-pixel results: rgb_sum (S, 3) summed in sample order, n_samples
    (S,), vis (S, 13) as the state holds it after the last sample, and
    rays (S,) int64, the segments each pixel traced."""
    if any(m.mtype not in (0, 1) for m in fs.materials) or any(
            lt.ltype != 1 for lt in fs.lights):
        raise NotImplementedError("the reference renders diffuse and "
                                  "dielectric materials under area lights")
    dev = pixels.device
    S = pixels.shape[0]
    mats = material_table(fs, dev)
    smp = torch.arange(spp, device=dev).repeat_interleave(S)
    pix = pixels.long().repeat(spp)
    px, py = pix % cfg.width, pix // cfg.width
    valid = torch.ones_like(pix, dtype=torch.bool)
    seed = frame_seed(base_seed, smp)
    radius = torch.from_numpy(radii(cfg, spp)).to(dev, fmath.F)[smp]

    rng = seed_pixels(seed, px, py)
    uj1, rng = rand_1f(rng)
    uj2, rng = rand_1f(rng)
    u = fdiv(px.to(fmath.F) + uj1, float(cfg.width))
    v = fdiv(py.to(fmath.F) + uj2, float(cfg.height))
    o, d = generate_rays(cam_rows, u, v)
    ulam, rng = rand_1f(rng)
    lam = sample_wavelength(ulam)
    em = (light_emission_rgb(fs, lam) if hero_count(cfg) == 1
          else hero_emission_rgb(fs, cfg, lam))
    rad, vis, stored, rays = trace_camera_paths(
        fs, cfg, mats, o, d, lam, rng, cfg.depth, valid, em, seed)

    # the state's vispoint after each lane's camera path: its own, else the
    # pixel's latest earlier stored one, else the fresh state's zeros
    last = torch.where(stored, smp, -1).reshape(spp, S).cummax(dim=0).values
    src = (last.clamp_min(0) * S
           + torch.arange(S, device=dev)[None]).reshape(-1)
    have = (last >= 0).reshape(-1)
    vis = [torch.where(have, p[src], torch.zeros_like(p)) for p in vis]

    rad, prays = trace_photons(fs, cfg, mats, lam, seed, px, py, vis, radius,
                               valid, rad, seed)
    rad = torch.stack(rad).reshape(3, spp, S)
    acc = torch.zeros((3, S), dtype=rad.dtype, device=dev)
    for i in range(spp):
        acc = acc + rad[:, i]
    return dict(
        rgb_sum=acc.T.contiguous(),
        n_samples=torch.full((S,), float(spp), dtype=fmath.F, device=dev),
        vis=torch.stack([p.reshape(spp, S)[-1] for p in vis], dim=1),
        rays=(rays + prays).reshape(spp, S).sum(dim=0))
