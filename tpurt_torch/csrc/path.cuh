// Camera- and photon-path device code shared by the regen, tile-sync,
// wavefront sweep and fused wavefront kernels: the scene's nearest hit and
// shadow factor (spheres and triangles, flat or through the BVH walks of
// bvh.cuh), the camera spawn, per-light emission at one wavelength or
// hero-averaged, next-event estimation over every light, the BSDF
// scatters with Russian roulette and tpurt's strata cells, the
// photon-gather BSDF, and one whole SPPM sample of a pixel
// (sample_pixel), the body of the regen and tile-sync kernels.
//
// Ported from tpurt's component-form kernel code in
// tpurt/kernels/mega_pallas.py (nee_direct_c, scatter_rr_c,
// _diffuse_scatter_c, _scatter_dielectric_c, _scatter_metal_c,
// _evaluate_bsdf_c, _single_lambda_em_c), in the op order of their plain
// PyTorch twins in tpurt_torch/integrate.py, so that every kernel draws
// the same PCG streams and takes the same branches as its plain version.
#pragma once

#include "bvh.cuh"

namespace tpurt {

struct Scatter {
  V3 wi;
  V3 tpm;
  float off;
  bool ok;
};

__device__ __forceinline__ Scatter diffuse_scatter(V3 wo, V3 n, V3 color,
                                                   float rough, float u2a,
                                                   float u2b) {
  float theta = kTWO_PI() * u2a;
  float z = fminf(fmaxf(1.0f - 2.0f * u2b, -1.0f), 1.0f);
  float sp = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  V3 rn = v3(sp * cosf(theta), sp * sinf(theta), z);
  Scatter s;
  s.wi = vnormalize(vadd(n, rn), F(1e-30));
  float cosw = fmaxf(vdot(n, s.wi), F(1e-10));
  float pdf_d = cosw * kINV_PI();
  V3 f = oren_nayar(vnormalize(wo, F(1e-30)), s.wi, n, color, rough);
  s.tpm = vscale(f, cosw / fmaxf(pdf_d, F(1e-10)));
  s.off = kEPS();
  s.ok = true;
  return s;
}

__device__ __forceinline__ Scatter metal_scatter(V3 wo, V3 n, V3 f0,
                                                 float alpha, float u2a,
                                                 float u2b) {
  Scatter s;
  s.off = kEPS();
  if (alpha < F(1e-3)) {
    float cos_t = vdot(wo, n);
    s.wi = reflect(wo, n);
    s.tpm = schlick(cos_t, f0);
    s.ok = vdot(s.wi, n) * cos_t > 0.0f;
    return s;
  }
  V3 T = tangent_frame(n);
  V3 B = vcross(n, T);
  V3 wo_l = to_local(wo, n, T, B);
  V3 wm = tr_sample_wm(wo_l, u2a, u2b, alpha);
  V3 wi_l = reflect(wo_l, wm);
  s.ok = wo_l.z * wi_l.z > 0.0f;
  V3 Fr = schlick(vdot(wo_l, wm), f0);
  float G2 = tr_g(wo_l.z, wi_l.z, alpha);
  float G1 = tr_g1(wo_l.z, alpha);
  s.tpm = vscale(Fr, G2 / fmaxf(G1, F(1e-10)));
  s.wi = to_world(wi_l, n, T, B);
  return s;
}

__device__ __forceinline__ Scatter dielectric_scatter(V3 wo, V3 n, float eta,
                                                      float alpha, float u2a,
                                                      float u2b,
                                                      float u_choice,
                                                      bool camera_pdf) {
  Scatter s;
  if (alpha < F(1e-3)) {  // effectively smooth
    float cos_t = vdot(wo, n);
    float R_s = fr_dielectric(fabsf(cos_t), eta);
    if (u_choice < R_s) {
      s.wi = reflect(wo, n);
      s.tpm = v3(1.0f, 1.0f, 1.0f);
      s.off = kEPS();
      s.ok = true;
    } else {
      s.ok = refract(wo, n, eta, s.wi);
      float etap = cos_t < 0.0f ? 1.0f / eta : eta;
      float t = 1.0f / (etap * etap);
      s.tpm = v3(t, t, t);
      s.off = -kEPS();
    }
    return s;
  }
  V3 T = tangent_frame(n);
  V3 B = vcross(n, T);
  V3 wo_l = to_local(wo, n, T, B);
  V3 wm = tr_sample_wm(wo_l, u2a, u2b, alpha);
  float dot_wowm = fabsf(vdot(wo_l, wm));
  float R = fr_dielectric(dot_wowm, eta);
  float Tns = 1.0f - R;
  bool choose_reflect = u_choice < R / fmaxf(R + Tns, F(1e-10));
  float D = tr_d(wm.z, alpha);
  float ct_o = fabsf(wo_l.z);
  float tp;
  V3 wi_l;
  if (choose_reflect) {
    wi_l = reflect(wo_l, wm);
    s.ok = wo_l.z * wi_l.z > 0.0f;
    float G_r = tr_g(wo_l.z, wi_l.z, alpha);
    float ct_i_r = fabsf(wi_l.z);
    float bsdf_r = D * G_r * R / fmaxf(4.0f * ct_i_r * ct_o, F(1e-10));
    float pdf_r;
    if (camera_pdf) {
      float G1 = tr_g1(wo_l.z, alpha);
      float pdf_wm = (G1 / fmaxf(ct_o, F(1e-10))) * D * dot_wowm;
      pdf_r = fmaxf(pdf_wm / fmaxf(4.0f * dot_wowm, F(1e-10)), F(1e-10)) *
              (R / fmaxf(R + Tns, F(1e-10)));
    } else {
      pdf_r = tr_lambda(wo_l.z, alpha) + 1.0f;
    }
    tp = bsdf_r * ct_i_r / fmaxf(pdf_r, F(1e-10));
    s.off = kEPS();
  } else {
    bool refr_ok = refract(wo_l, wm, eta, wi_l);
    s.ok = refr_ok && !(wo_l.z * wi_l.z > 0.0f);
    float G_t = tr_g(wo_l.z, wi_l.z, alpha);
    float ct_i_t = fabsf(wi_l.z);
    float denom = vdot(wi_l, wm) + vdot(wo_l, wm) / eta;
    float bsdf_t =
        Tns * D * G_t *
        fabsf(vdot(wi_l, wm) * vdot(wo_l, wm) /
              fmaxf(ct_i_t * ct_o * denom * denom, F(1e-10)));
    float pdf_t;
    if (camera_pdf) {
      float dwm_dwi = fabsf(vdot(wi_l, wm)) / fmaxf(denom * denom, F(1e-10));
      float G1 = tr_g1(wo_l.z, alpha);
      pdf_t = fmaxf((G1 / fmaxf(ct_o, F(1e-10))) * D * dot_wowm * dwm_dwi *
                        (Tns / fmaxf(R + Tns, F(1e-10))),
                    F(1e-10));
    } else {
      pdf_t = tr_lambda(wo_l.z, alpha) + 1.0f;
    }
    float etap_t = wo_l.z < 0.0f ? 1.0f / eta : eta;
    tp = bsdf_t * ct_i_t / fmaxf(pdf_t, F(1e-10)) / (etap_t * etap_t);
    s.off = -kEPS();
  }
  s.wi = to_world(wi_l, n, T, B);
  s.tpm = v3(tp, tp, tp);
  return s;
}

// Photon-gather BSDF at the vispoint: Oren-Nayar, or GGX reflection only.
__device__ __forceinline__ V3 evaluate_bsdf(V3 wo, V3 wi, V3 n, V3 color,
                                            float rough, float eta,
                                            int mtype) {
  if (mtype == 0) return oren_nayar(wo, wi, n, color, rough);
  bool refl = vdot(n, wo) * vdot(n, wi) > 0.0f;
  float alpha = sqrtf(rough);
  V3 wm = vnormalize(vadd(wi, wo), F(1e-30));
  V3 T = tangent_frame(n);
  V3 B = vcross(n, T);
  V3 wo_l = to_local(wo, n, T, B);
  V3 wi_l = to_local(wi, n, T, B);
  V3 wm_l = to_local(wm, n, T, B);
  float D = tr_d(wm_l.z, alpha);
  float G = tr_g(wo_l.z, wi_l.z, alpha);
  float denom = fmaxf(4.0f * fabsf(wi_l.z) * fabsf(wo_l.z), F(1e-10));
  if (mtype == 2) {
    V3 Fm = schlick(vdot(wo, wm), color);
    return vscale(Fm, refl ? D * G / denom : 0.0f);
  }
  float R = fr_dielectric(vdot(wo, wm), eta);
  float spec = refl ? D * G * R / denom : 0.0f;
  return v3(spec, spec, spec);
}

// The scene as read from the float32 parameter table (layout in
// device.cuh, packed by tpurt_torch/kernels/mega_regen.py:pack_scene) and
// the geometry tables (kernels/bvh.py).
struct Params {
  const float* sph;
  const float* mat;
  const float* light;
  const float* hero;  // each light's hero table, when C > 1
  int n_sph, n_mat, n_light;
  Geom geom;
};

__device__ __forceinline__ Params scene_params(const float* table, int n_sph,
                                               int n_mat, int n_light,
                                               const Geom& geom) {
  Params p;
  p.sph = table + CAM_FLOATS;
  p.mat = p.sph + n_sph * SPH_STRIDE;
  p.light = p.mat + n_mat * MAT_STRIDE;
  p.hero = p.light + n_light * LIGHT_STRIDE;
  p.n_sph = n_sph;
  p.n_mat = n_mat;
  p.n_light = n_light;
  p.geom = geom;
  return p;
}

// The scene's nearest hit (mega_pallas._make_scene_fns' intersect); GLEAF
// takes the G leaf for the triangles (bvh.cuh scene_hit).
template <bool GLEAF = false>
__device__ __forceinline__ Hit intersect(const Params& P, V3 o, V3 d) {
  return scene_hit<GLEAF>(P.sph, P.n_sph, P.geom, o, d);
}

// Camera spawn of one (pixel, sample): 2 jitter draws, the pinhole ray
// through the jittered pixel, 1 wavelength draw. `table` starts with the
// camera rows origin, horizontal, vertical, lower_left.
__device__ __forceinline__ void spawn_camera(const float* table, uint32_t px,
                                             uint32_t py, int width,
                                             int height, uint32_t& rng,
                                             V3& o, V3& d, float& lam) {
  const V3 cam_o = load3(table), cam_h = load3(table + 3),
           cam_v = load3(table + 6), cam_ll = load3(table + 9);
  float uj1 = rand_1f(rng);
  float uj2 = rand_1f(rng);
  float u = ((float)px + uj1) / (float)width;
  float v = ((float)py + uj2) / (float)height;
  o = cam_o;
  d = v3(cam_ll.x + u * cam_h.x + v * cam_v.x - cam_o.x,
         cam_ll.y + u * cam_h.y + v * cam_v.y - cam_o.y,
         cam_ll.z + u * cam_h.z + v * cam_v.z - cam_o.z);
  lam = F(380.0) + rand_1f(rng) * F(400.0);
}

// Per-light emission at wavelength lam into em[3 * n_light]:
// color*intensity*range (* blackbody(lam, T)) * cie_rgb(lam).
__device__ __forceinline__ void light_emission(const Params& P, float lam,
                                               float* em) {
  V3 cie = cie_to_rgb(lam);
  for (int li = 0; li < P.n_light; ++li) {
    const float* L = P.light + li * LIGHT_STRIDE;
    float temp = L[L_TEMP];
    float spd = temp > 0.0f ? blackbody(lam, temp) : 1.0f;
    em[3 * li] = temp > 0.0f ? L[L_EM_SCALE] * spd * cie.x
                             : L[L_EM_SCALE] * cie.x;
    em[3 * li + 1] = temp > 0.0f ? L[L_EM_SCALE + 1] * spd * cie.y
                                 : L[L_EM_SCALE + 1] * cie.y;
    em[3 * li + 2] = temp > 0.0f ? L[L_EM_SCALE + 2] * spd * cie.z
                                 : L[L_EM_SCALE + 2] * cie.z;
  }
}

// Per-light C-averaged emission at hero wavelength lam into em[3 * n_light]:
// the lookup into each light's hero table.
__device__ __forceinline__ void hero_emission(const Params& P,
                                              const Sampler& S, float lam,
                                              float* em) {
  const int stride = 3 * (S.hero_nseg + 1);
  for (int li = 0; li < P.n_light; ++li) {
    V3 e = hero_lookup(P.hero + li * stride, S.hero_nseg, S.hero_delta, lam);
    em[3 * li] = e.x;
    em[3 * li + 1] = e.y;
    em[3 * li + 2] = e.z;
  }
}

// Next-event estimation over every light (mode "all"): 2 draws per light
// whatever the surface; the shadow segments are traced, and the light
// added, only at a diffuse hit.
__device__ __forceinline__ V3 nee_direct(const Params& P, const Hit& h,
                                         bool diffuse, float lam,
                                         const float* em, uint32_t& rng) {
  V3 direct = v3(0.0f, 0.0f, 0.0f);
  for (int li = 0; li < P.n_light; ++li) {
    float u1 = rand_1f(rng);
    float u2 = rand_1f(rng);
    if (!diffuse) continue;
    const float* L = P.light + li * LIGHT_STRIDE;
    bool area = (int)L[L_TYPE] == 1;
    V3 lp;
    if (area) {
      float su = (u1 - 0.5f) * L[L_TWO_HW];
      float sv = (u2 - 0.5f) * L[L_TWO_HW];
      lp = v3(L[L_POS] + su * L[L_TANGENT] + sv * L[L_BITANGENT],
              L[L_POS + 1] + su * L[L_TANGENT + 1] + sv * L[L_BITANGENT + 1],
              L[L_POS + 2] + su * L[L_TANGENT + 2] + sv * L[L_BITANGENT + 2]);
    } else {
      lp = load3(L + L_POS);
    }
    V3 to_light = vsub(lp, h.loc);
    float dist = sqrtf(fmaxf(vdot(to_light, to_light), F(1e-30)));
    V3 ldir = vscale(to_light, 1.0f / dist);
    float ndotl = vdot(h.n, ldir);
    bool live = dist >= kEPS() && ndotl > 0.0f;
    float geom = ndotl;
    if (area) {
      float cos_light =
          fmaxf(-(L[L_NORMAL] * ldir.x + L[L_NORMAL + 1] * ldir.y +
                  L[L_NORMAL + 2] * ldir.z),
                0.0f);
      live = live && cos_light > 0.0f && L[L_HW] > 0.0f;
      geom = ndotl * cos_light * L[L_AREA_SCALE];
    }
    if (!live) continue;
    V3 so = vadd(h.loc, vscale(h.n, kEPS()));
    float atten = scene_shadow(P.sph, P.n_sph, P.geom, so, ldir,
                               dist - kEPS(), lam);
    float w = geom * atten / (dist * dist);
    direct = vadd(direct, vscale(load3(em + 3 * li), w));
  }
  return direct;
}

// Scatter + Russian roulette: exactly 4 draws. With cell_ndir > 0 the
// scatter uniforms move into the bounce cell of cell_key (the roulette
// draw never does). Writes the continuation ray and the reweighted
// throughput; returns false when the path ends (invalid scatter or
// roulette kill).
__device__ __forceinline__ bool scatter_rr(const Params& P, int mat, V3 wo,
                                           V3 n, V3 loc, float lam_eta_add,
                                           bool camera, float rr_thresh,
                                           uint32_t& rng, V3& o, V3& d,
                                           V3& tp, int cell_ndir = 0,
                                           uint32_t cell_key = 0) {
  float u2a = rand_1f(rng);
  float u2b = rand_1f(rng);
  float u_choice = rand_1f(rng);
  float u_rr = rand_1f(rng);
  if (cell_ndir > 0) bounce_cells(cell_key, cell_ndir, u2a, u2b, u_choice);
  const float* m = P.mat + mat * MAT_STRIDE;
  V3 color = load3(m);
  float rough = m[3];
  int mtype = (int)m[5];
  Scatter s;
  if (mtype == 0) {
    s = diffuse_scatter(wo, n, color, rough, u2a, u2b);
  } else if (mtype == 2) {
    s = metal_scatter(wo, n, color, sqrtf(rough), u2a, u2b);
  } else {
    s = dielectric_scatter(wo, n, m[4] + lam_eta_add, sqrtf(rough), u2a,
                           u2b, u_choice, camera);
  }
  V3 new_tp = vmul(tp, s.tpm);
  float prob = vmax_comp(new_tp);
  bool live = s.ok && prob >= rr_thresh && u_rr <= prob;
  o = vadd(loc, vscale(n, s.off));
  d = s.wi;
  tp = vscale(new_tp, 1.0f / fmaxf(prob, F(1e-30)));
  return live;
}

// The shading of one camera-path hit: NEE (added to `rad` at a diffuse
// hit, with one shadow segment per light counted in `rays`), then scatter
// + RR at the dielectric IOR plus eta_add (the Cauchy term under
// dispersion on camera paths, else 0), in the bounce cell of cell_key when
// cell_ndir > 0. Writes the continuation into (o, d, tp); returns whether
// the path continues (before any depth limit).
__device__ __forceinline__ bool shade_camera_hit(
    const Params& P, const Hit& h, V3 wo, float lam, const float* em,
    float rr_thresh, uint32_t& rng, V3& o, V3& d, V3& tp, V3& rad,
    unsigned long long& rays, float eta_add = 0.0f, int cell_ndir = 0,
    uint32_t cell_key = 0) {
  const float* m = P.mat + h.mat * MAT_STRIDE;
  bool diffuse = (int)m[5] == 0;
  V3 direct = nee_direct(P, h, diffuse, lam, em, rng);
  if (diffuse) {
    rad = vadd(rad, vmul(vmul(tp, load3(m)), direct));
    rays += (unsigned long long)P.n_light;
  }
  return scatter_rr(P, h.mat, wo, h.n, h.loc, eta_add, true, rr_thresh, rng,
                    o, d, tp, cell_ndir, cell_key);
}

// Photon k's emission from the light row L: the 7 emission draws (uc,
// up1, one drawn and unused, ue1, ue2, uh1, uh2), the six used ones moved
// into their stratum cell under photon strata; a point light emits into
// the cone about its axis, an area light from a point of its square into
// the cosine hemisphere about its normal.
__device__ __forceinline__ void emit_photon(const float* L, const Sampler& S,
                                            bool cells, uint32_t strata_seed,
                                            uint32_t k, uint32_t& prng,
                                            V3& ph_o, V3& ph_d, V3& ph_tp) {
  float uc = rand_1f(prng);
  float up1 = rand_1f(prng);
  rand_1f(prng);  // drawn and unused, as in the reference layout
  float ue1 = rand_1f(prng);
  float ue2 = rand_1f(prng);
  float uh1 = rand_1f(prng);
  float uh2 = rand_1f(prng);
  if (cells)
    emission_cells(strata_seed, S.shared_k ? 0u : k, S.n_pos, S.n_dir, uc,
                   up1, ue1, ue2, uh1, uh2);
  if ((int)L[L_TYPE] == 0) {
    float ct = 1.0f - uc * F(1.0 - 0.707);
    float stn = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
    float phi = kTWO_PI() * up1;
    float cphi = cosf(phi), sphi = sinf(phi);
    ph_d = v3(stn * cphi * L[L_CONE_T] + stn * sphi * L[L_CONE_B] +
                  ct * L[L_CONE_AXIS],
              stn * cphi * L[L_CONE_T + 1] + stn * sphi * L[L_CONE_B + 1] +
                  ct * L[L_CONE_AXIS + 1],
              stn * cphi * L[L_CONE_T + 2] + stn * sphi * L[L_CONE_B + 2] +
                  ct * L[L_CONE_AXIS + 2]);
    ph_o = load3(L + L_POS);
  } else {
    float su = (ue1 - 0.5f) * L[L_TWO_HW];
    float sv = (ue2 - 0.5f) * L[L_TWO_HW];
    ph_o = v3(L[L_PH_ORIGIN] + su * L[L_TANGENT] + sv * L[L_BITANGENT],
              L[L_PH_ORIGIN + 1] + su * L[L_TANGENT + 1] +
                  sv * L[L_BITANGENT + 1],
              L[L_PH_ORIGIN + 2] + su * L[L_TANGENT + 2] +
                  sv * L[L_BITANGENT + 2]);
    float theta = kTWO_PI() * uh1;
    float r_ = sqrtf(uh2);
    float x_ = r_ * cosf(theta);
    float y_ = r_ * sinf(theta);
    float z_ = sqrtf(fmaxf(1.0f - r_ * r_, 0.0f));
    ph_d = v3(x_ * L[L_TANGENT] + y_ * L[L_BITANGENT] + z_ * L[L_NORMAL],
              x_ * L[L_TANGENT + 1] + y_ * L[L_BITANGENT + 1] +
                  z_ * L[L_NORMAL + 1],
              x_ * L[L_TANGENT + 2] + y_ * L[L_BITANGENT + 2] +
                  z_ * L[L_NORMAL + 2]);
  }
  ph_tp = load3(L + L_PH_POWER);
}

// A pixel's persistent state: the radiance sum and its vispoint, the 16
// float32 planes of the render state (rgb_sum 0-2, vis_pos 3-5, vis_norm
// 6-8, vis_wo 9-11, vis_tp 12-14, vis_mat 15), stride P.
struct PixelState {
  V3 rgb, vpos, vnorm, vwo, vtp;
  float vmat;
};

__device__ __forceinline__ PixelState load_pixel(const float* pl,
                                                 long long P) {
  PixelState s;
  s.rgb = v3(pl[0], pl[P], pl[2 * P]);
  s.vpos = v3(pl[3 * P], pl[4 * P], pl[5 * P]);
  s.vnorm = v3(pl[6 * P], pl[7 * P], pl[8 * P]);
  s.vwo = v3(pl[9 * P], pl[10 * P], pl[11 * P]);
  s.vtp = v3(pl[12 * P], pl[13 * P], pl[14 * P]);
  s.vmat = pl[15 * P];
  return s;
}

__device__ __forceinline__ void store_pixel(float* pl, long long P,
                                            const PixelState& s) {
  pl[0] = s.rgb.x; pl[P] = s.rgb.y; pl[2 * P] = s.rgb.z;
  pl[3 * P] = s.vpos.x; pl[4 * P] = s.vpos.y; pl[5 * P] = s.vpos.z;
  pl[6 * P] = s.vnorm.x; pl[7 * P] = s.vnorm.y; pl[8 * P] = s.vnorm.z;
  pl[9 * P] = s.vwo.x; pl[10 * P] = s.vwo.y; pl[11 * P] = s.vwo.z;
  pl[12 * P] = s.vtp.x; pl[13 * P] = s.vtp.y; pl[14 * P] = s.vtp.z;
  pl[15 * P] = s.vmat;
}

// The launch constants of the SPPM sample (sample_pixel).
struct SampleConsts {
  const float* table;  // the parameter table, camera rows first
  int width, height, depth, k_photons, max_photon_bounces;
  float rr_thresh, photon_rr_thresh;
};

// One progressive SPPM sample of pixel (px, py), drawing from frame seed
// `seed`, strata cells keyed by `strata_seed`: the camera spawn (2 jitter
// draws, 1 wavelength draw), the camera path (up to `depth` bounces:
// nearest hit, vispoint at the first diffuse hit, next-event estimation
// over every light with the hero-averaged emission until a dielectric hit
// collapses the path to its hero wavelength, scatter + Russian roulette),
// then, if the pixel has a vispoint, K photon walks (light k % L, up to
// `max_photon_bounces` bounces) that add density-estimated radiance when
// they land within `radius` of that vispoint; the sample's radiance is
// added into st.rgb, its segments into `rays`. The plain version is
// tpurt_torch/integrate.py:render_tile. SAMPLER false compiles the
// reference sampler alone (S is then not read): the kernels instantiate
// both and pick one per launch, so a launch without the flags pays nothing
// for them. GLEAF: every nearest hit takes the G leaf (pallas_mxu_leaf;
// the regen kernel alone instantiates it).
template <bool SAMPLER, bool GLEAF = false>
__device__ __forceinline__ void sample_pixel(const Params& prm,
                                             const Sampler& S,
                                             const SampleConsts& c,
                                             uint32_t px, uint32_t py,
                                             uint32_t seed,
                                             uint32_t strata_seed,
                                             float radius, PixelState& st,
                                             unsigned long long& rays) {
  float em[3 * MAX_LIGHTS];
  float emh[3 * MAX_LIGHTS];  // single-wavelength emission, after collapse
  // ---- camera spawn: 2 jitter draws, 1 wavelength draw
  uint32_t rng = seed_pixels(seed, px, py);
  V3 o, d;
  float lam;
  spawn_camera(c.table, px, py, c.width, c.height, rng, o, d, lam);
  if (SAMPLER && S.hero > 1) {
    hero_emission(prm, S, lam, em);
    if (S.collapse) light_emission(prm, lam, emh);
  } else {
    light_emission(prm, lam, em);
  }
  float lam_um = lam * F(1e-3);
  float cauchy_add = F(0.004) / (lam_um * lam_um);
  const float cam_eta_add = SAMPLER && S.disp_cam ? cauchy_add : 0.0f;
  const int cam_cells = SAMPLER && S.camera_bounce ? S.n_dir : 0;

  // ---- camera path
  V3 tp = v3(1.0f, 1.0f, 1.0f);
  V3 rad = v3(0.0f, 0.0f, 0.0f);
  bool vp_stored = false;
  bool coll = false;
  for (int b = 0;; ++b) {
    rays += 1;
    Hit h = intersect<GLEAF>(prm, o, d);
    if (!(h.t < kHIT())) break;
    const int mtype = (int)prm.mat[h.mat * MAT_STRIDE + 5];
    V3 wo = vneg(d);
    if (mtype == 0 && !vp_stored) {
      st.vpos = h.loc;
      st.vnorm = h.n;
      st.vwo = wo;
      st.vtp = tp;
      st.vmat = (float)h.mat;
      vp_stored = true;
    }
    bool cont = shade_camera_hit(
        prm, h, wo, lam, SAMPLER && coll ? emh : em, c.rr_thresh, rng, o, d,
        tp, rad,
        rays, cam_eta_add, cam_cells,
        bounce_key(strata_seed, CAMERA_STRATA_K, (uint32_t)b));
    // a dielectric steered the path by eta(lam): only the hero goes on
    if (SAMPLER && S.collapse && mtype == 1) coll = true;
    if (!(cont && b + 1 < c.depth)) break;
  }

  // ---- photon walks, gathered at this pixel's vispoint
  if (c.k_photons > 0 && sqrtf(vdot(st.vpos, st.vpos)) > F(0.001)) {
    const float* vm = prm.mat + (int)st.vmat * MAT_STRIDE;
    const V3 v_color = load3(vm);
    const float v_rough = vm[3];
    const float v_eta = vm[4] + cauchy_add;
    const int v_type = (int)vm[5];
    const float inv_pi_r2 =
        1.0f / fmaxf(F(3.141592653589793) * radius * radius, F(1e-10));
    const int ph_cells = SAMPLER && S.photon_bounce ? S.n_dir : 0;
    for (int k = 0; k < c.k_photons; ++k) {
      uint32_t prng = photon_stream(seed, px, py, (uint32_t)k);
      V3 ph_o, ph_d, ph_tp;
      emit_photon(prm.light + (k % prm.n_light) * LIGHT_STRIDE, S,
                  SAMPLER && S.n_pos > 0, strata_seed, (uint32_t)k, prng,
                  ph_o, ph_d, ph_tp);
      const uint32_t cell_k = SAMPLER && S.shared_k ? 0u : (uint32_t)k;
      for (int b = 0;; ++b) {
        rays += 1;
        Hit h = intersect<GLEAF>(prm, ph_o, ph_d);
        if (!(h.t < kHIT())) break;
        V3 dvec = vsub(h.loc, st.vpos);
        float dist = sqrtf(fmaxf(vdot(dvec, dvec), 0.0f));
        if (dist < radius) {
          V3 f = evaluate_bsdf(st.vwo, vneg(ph_d), st.vnorm, v_color,
                               v_rough, v_eta, v_type);
          float kern = (1.0f - dist / radius) * inv_pi_r2;
          rad = vadd(rad, vscale(vmul(vmul(st.vtp, f), ph_tp), kern));
        }
        bool cont = scatter_rr(prm, h.mat, vneg(ph_d), h.n, h.loc,
                               cauchy_add, false, c.photon_rr_thresh, prng,
                               ph_o, ph_d, ph_tp, ph_cells,
                               bounce_key(strata_seed, cell_k, (uint32_t)b));
        if (!(cont && b + 1 < c.max_photon_bounces)) break;
      }
    }
  }
  st.rgb = vadd(st.rgb, rad);
}

// Per-block reduction of a per-thread segment count, one atomic per block
// (integer sums: the total does not depend on the order blocks finish).
// Every thread of the block must call it; blockDim.x == 32 * WARPS.
template <int WARPS>
__device__ __forceinline__ void add_block_rays(unsigned long long rays,
                                               unsigned long long* out) {
  __shared__ unsigned long long warp_sums[WARPS];
  for (int off = 16; off > 0; off >>= 1)
    rays += __shfl_down_sync(0xffffffffu, rays, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = rays;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_sums[w];
    if (total) atomicAdd(out, total);
  }
}

}  // namespace tpurt
