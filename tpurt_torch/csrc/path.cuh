// Camera- and photon-path device code shared by the regen, tile-sync,
// wavefront sweep and fused wavefront kernels: the scene's nearest hit and
// shadow factor (spheres and triangles, flat or through the BVH walks of
// bvh.cuh), the camera spawn, per-light emission at one wavelength or
// hero-averaged, the sky's and the emissive materials' emission,
// next-event estimation over every light or over one light chosen by
// power, the BSDF scatters with Russian roulette and tpurt's strata cells,
// the photon emission (aimed at the vispoint under photon_aim), the
// photon-gather BSDF, and the samples of a launch's pixels (run_pixels),
// the body of the regen, tile-sync and fused wavefront kernels.
//
// Ported from tpurt's component-form kernel code in
// tpurt/kernels/mega_pallas.py (nee_direct_c, _nee_direct_power_c,
// scatter_rr_c, _diffuse_scatter_c, _scatter_dielectric_c,
// _scatter_metal_c, _evaluate_bsdf_c, _single_lambda_em_c), the aimed
// emission of tpurt/kernels/mega_regen.py, in the op order of their plain
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
// the geometry tables (kernels/bvh.py). The pointers are generic: every
// path kernel stages the rows into shared memory where they fit
// (stage_scene), else reads them where they lie.
struct Params {
  const float* table;  // the whole table, in global memory
  const float* rows;   // its camera, sphere, material and light rows
  const float* cie_;   // the (N_CIE, 3) CIE table
  int n_sph, n_mat, n_light;
  Geom geom;
  WalkStack stack;

  // Each row block is an offset from `rows`, formed where it is read: one
  // pointer stays live across the kernels' loops, not six.
  __device__ __forceinline__ const float* cam() const { return rows; }
  __device__ __forceinline__ const float* sph() const {
    return rows + CAM_FLOATS;
  }
  __device__ __forceinline__ const float* mat() const {
    return rows + CAM_FLOATS + n_sph * SPH_STRIDE;
  }
  __device__ __forceinline__ const float* light() const {
    return rows + CAM_FLOATS + n_sph * SPH_STRIDE + n_mat * MAT_STRIDE;
  }
  // each light's hero table, when C > 1: after the rows, in global memory;
  // with the emission instances' tables after them, the sky's (hero table
  // n_light) and the emission base's (n_light + 1)
  __device__ __forceinline__ const float* hero() const {
    return table + CAM_FLOATS + n_sph * SPH_STRIDE + n_mat * MAT_STRIDE +
           n_light * LIGHT_STRIDE;
  }
  __device__ __forceinline__ const float* cie() const { return cie_; }
};

// Floats of the table before the hero tables: what stage_scene copies.
__host__ __device__ inline int scene_floats(int n_sph, int n_mat,
                                            int n_light) {
  return CAM_FLOATS + n_sph * SPH_STRIDE + n_mat * MAT_STRIDE +
         n_light * LIGHT_STRIDE;
}

// `table` and `cie` in global memory; `rows`: where the camera, sphere,
// material and light rows are read (the table itself, or its staged copy).
__device__ __forceinline__ Params scene_params(const float* table,
                                               const float* rows,
                                               const float* cie, int n_sph,
                                               int n_mat, int n_light,
                                               const Geom& geom,
                                               const WalkStack& stack) {
  Params p;
  p.table = table;
  p.rows = rows;
  p.cie_ = cie;
  p.n_sph = n_sph;
  p.n_mat = n_mat;
  p.n_light = n_light;
  p.geom = geom;
  p.stack = stack;
  return p;
}

// The nearest hit of the scene (mega_pallas._make_scene_fns' intersect).
__device__ __forceinline__ Hit intersect(const Params& P, V3 o, V3 d) {
  return scene_hit(P.sph(), P.n_sph, P.geom, P.stack, o, d);
}

// The same with the G leaf for the triangles (bvh.cuh scene_hit_g): every
// lane of the warp calls it, `active` false where it has no segment.
__device__ __forceinline__ Hit intersect_g(const Params& P, V3 o, V3 d,
                                           bool active) {
  return scene_hit_g(P.sph(), P.n_sph, P.geom, P.stack, o, d, active);
}

// Camera spawn of one (pixel, sample) without tpurt's spawn extensions
// (spawn_camera_ext has the full draw order): 2 jitter draws, the pinhole
// ray through the jittered pixel, 1 wavelength draw. `table`: the camera
// rows origin, horizontal, vertical, lower_left.
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

// Camera spawn of sample `sample` of pixel (px, py) with tpurt's spawn
// extensions (tpurt/camera.py spawn_camera_rays, lens_perturb_c): the draws
// in this order, each present only under its switch: 2 jitter draws; the
// shutter time t (motion), which lerps the basis to row + t * dcam; the 2
// lens draws (lens), which move the origin by a point `off` of the disc of
// radius lens_r in the (lerped) basis h, v and the direction by -off /
// focus_dist; the wavelength. Under qmc every draw comes from the pixel's
// Owen-scrambled Sobol stream of `sample` (one dimension a draw, in draw
// order) and `rng`, the path's PCG stream, stays at position 0; else from
// `rng`, which goes on after them. The lens takes 1/sqrt, as the plain
// version (tpurt_torch/camera.py) does for tpurt's rsqrt.
__device__ __forceinline__ void spawn_camera_ext(
    const float* table, const Spawn& X, uint32_t base_seed, uint32_t sample,
    uint32_t px, uint32_t py, int width, int height, uint32_t& rng, V3& o,
    V3& d, float& lam) {
  const V3 cam_o = load3(table), cam_h = load3(table + 3),
           cam_v = load3(table + 6), cam_ll = load3(table + 9);
  const uint32_t qpix = X.qmc ? qmc_pixel(base_seed, px, py) : 0u;
  int dim = 0;
  auto draw = [&]() -> float {
    return X.qmc ? qmc_1f(X.sobol, sample, qpix, dim++) : rand_1f(rng);
  };
  const float uj1 = draw();
  const float uj2 = draw();
  const float u = ((float)px + uj1) / (float)width;
  const float v = ((float)py + uj2) / (float)height;
  V3 ch = cam_h, cv = cam_v;
  if (X.motion) {
    const float ut = draw();
    const float* dc = X.dcam;
    o = v3(cam_o.x + ut * dc[0], cam_o.y + ut * dc[1], cam_o.z + ut * dc[2]);
    ch = v3(cam_h.x + ut * dc[3], cam_h.y + ut * dc[4], cam_h.z + ut * dc[5]);
    cv = v3(cam_v.x + ut * dc[6], cam_v.y + ut * dc[7], cam_v.z + ut * dc[8]);
    d = v3(cam_ll.x + ut * dc[9] + u * ch.x + v * cv.x - o.x,
           cam_ll.y + ut * dc[10] + u * ch.y + v * cv.y - o.y,
           cam_ll.z + ut * dc[11] + u * ch.z + v * cv.z - o.z);
  } else {
    o = cam_o;
    d = v3(cam_ll.x + u * cam_h.x + v * cam_v.x - cam_o.x,
           cam_ll.y + u * cam_h.y + v * cam_v.y - cam_o.y,
           cam_ll.z + u * cam_h.z + v * cam_v.z - cam_o.z);
  }
  if (X.lens) {
    const float u1 = draw();
    const float u2 = draw();
    const float hinv = 1.0f / sqrtf(ch.x * ch.x + ch.y * ch.y + ch.z * ch.z);
    const float vinv = 1.0f / sqrtf(cv.x * cv.x + cv.y * cv.y + cv.z * cv.z);
    const float r = sqrtf(u1) * X.lens_r;
    const float phi = u2 * kTWO_PI();
    const float a = r * cosf(phi) * hinv;
    const float b = r * sinf(phi) * vinv;
    const V3 off = v3(a * ch.x + b * cv.x, a * ch.y + b * cv.y,
                      a * ch.z + b * cv.z);
    o = v3(o.x + off.x, o.y + off.y, o.z + off.z);
    d = v3(d.x - off.x * X.lens_finv, d.y - off.y * X.lens_finv,
           d.z - off.z * X.lens_finv);
  }
  lam = F(380.0) + draw() * F(400.0);
}

// Light li's emission as a camera path of wavelength lam sees it. While
// `hero` (SAMPLER instances with C > 1, until the path collapses): the
// C-averaged emission, a lookup into the light's hero table. Else the
// single wavelength: color*intensity*range (* blackbody(lam, T)) *
// cie_rgb(lam), with cie = cie_to_rgb(lam). It is a pure function of the
// light and lam, computed where a light is added and kept nowhere.
template <bool SAMPLER>
__device__ __forceinline__ V3 light_em(const Params& P, const Sampler& S,
                                       bool hero, int li, float lam,
                                       V3 cie) {
  if (SAMPLER && hero)
    return hero_lookup(P.hero() + li * 3 * (S.hero_nseg + 1), S.hero_nseg,
                       S.hero_delta, lam);
  const float* L = P.light() + li * LIGHT_STRIDE;
  float temp = L[L_TEMP];
  float spd = temp > 0.0f ? blackbody(lam, temp) : 1.0f;
  return temp > 0.0f ? v3(L[L_EM_SCALE] * spd * cie.x,
                          L[L_EM_SCALE + 1] * spd * cie.y,
                          L[L_EM_SCALE + 2] * spd * cie.z)
                     : v3(L[L_EM_SCALE] * cie.x, L[L_EM_SCALE + 1] * cie.y,
                          L[L_EM_SCALE + 2] * cie.z);
}

// The sky's and the emissive materials' emission as a camera path of
// wavelength lam sees it (tpurt's _sky_em_c and _flat_em_c): while `hero`,
// the C-averaged emission, a lookup into hero table n_light (the sky) or
// n_light + 1 (the base); else the sky's f32(intensity * range)
// (* blackbody(lam, T)) * cie_rgb(lam), and the base's range *
// cie_rgb(lam), which the hit material's color scales.
template <bool SAMPLER>
__device__ __forceinline__ V3 sky_emission(const Params& P, const Sampler& S,
                                           const Emission& E, bool hero,
                                           float lam) {
  if (SAMPLER && hero)
    return hero_lookup(P.hero() + P.n_light * 3 * (S.hero_nseg + 1),
                       S.hero_nseg, S.hero_delta, lam);
  const V3 cie = cie_to_rgb(P.cie(), lam);
  if (E.sky_temp > 0.0f) {
    const float spd = blackbody(lam, E.sky_temp);
    return v3(E.sky_k * spd * cie.x, E.sky_k * spd * cie.y,
              E.sky_k * spd * cie.z);
  }
  return v3(E.sky_k * cie.x, E.sky_k * cie.y, E.sky_k * cie.z);
}

template <bool SAMPLER>
__device__ __forceinline__ V3 flat_emission(const Params& P, const Sampler& S,
                                            bool hero, float lam) {
  if (SAMPLER && hero)
    return hero_lookup(P.hero() + (P.n_light + 1) * 3 * (S.hero_nseg + 1),
                       S.hero_nseg, S.hero_delta, lam);
  const V3 cie = cie_to_rgb(P.cie(), lam);
  return v3(F(400.0) * cie.x, F(400.0) * cie.y, F(400.0) * cie.z);
}

// The sky gradient's ramp parameter along d: 0.5 * (normalize(d).y + 1).
__device__ __forceinline__ float sky_height(V3 d) {
  const float inv = 1.0f / sqrtf(fmaxf(vdot(d, d), F(1e-30)));
  return 0.5f * (d.y * inv + 1.0f);
}

// rad plus what a camera path of throughput tp that missed along d sees:
// tp * the sky's emission * its tint (sky_color, lerped toward (.5, .7,
// 1) by height under the gradient), or tp * the wavefront tracers' legacy
// RGB ramp, or nothing.
template <bool SAMPLER>
__device__ __forceinline__ V3 add_sky(const Params& P, const Sampler& S,
                                      const Emission& E, bool hero, float lam,
                                      V3 d, V3 tp, V3 rad) {
  if (E.sky) {
    const V3 em = sky_emission<SAMPLER>(P, S, E, hero, lam);
    V3 tint = v3(E.sky_r, E.sky_g, E.sky_b);
    if (E.gradient) {
      const float t = sky_height(d);
      tint = v3(E.sky_r * ((1.0f - t) + t * F(0.5)),
                E.sky_g * ((1.0f - t) + t * F(0.7)),
                E.sky_b * ((1.0f - t) + t * F(1.0)));
    }
    return v3(rad.x + tp.x * em.x * tint.x, rad.y + tp.y * em.y * tint.y,
              rad.z + tp.z * em.z * tint.z);
  }
  if (E.legacy) {
    const float t = sky_height(d);
    return v3(rad.x + tp.x * ((1.0f - t) + t * F(0.5)),
              rad.y + tp.y * ((1.0f - t) + t * F(0.7)),
              rad.z + tp.z * ((1.0f - t) + t * F(1.0)));
  }
  return rad;
}

// rad plus tp * color * the emission base: a camera path hits material
// `mat` of type 3.
template <bool SAMPLER>
__device__ __forceinline__ V3 add_emitter(const Params& P, const Sampler& S,
                                          bool hero, int mat, float lam,
                                          V3 tp, V3 rad) {
  const V3 color = load3(P.mat() + mat * MAT_STRIDE);
  const V3 em = flat_emission<SAMPLER>(P, S, hero, lam);
  return v3(rad.x + tp.x * color.x * em.x, rad.y + tp.y * color.y * em.y,
            rad.z + tp.z * color.z * em.z);
}

// The switches an emission or spawn instance passes its body (run_block,
// run_pixels) as its last arguments `em`: an Emission, and in the spawn
// instances a Spawn after it; the instances without them pass none, so
// their bodies are what they were before the switches existed.
__device__ __forceinline__ const Emission& emission(const Emission& E) {
  return E;
}
__device__ __forceinline__ const Emission& emission(const Emission& E,
                                                    const Spawn&) {
  return E;
}
__device__ __forceinline__ const Spawn& spawn_of(const Emission&,
                                                 const Spawn& X) {
  return X;
}
// The lights instances pass a Lights after the Spawn.
__device__ __forceinline__ const Emission& emission(const Emission& E,
                                                    const Spawn&,
                                                    const Lights&) {
  return E;
}
__device__ __forceinline__ const Spawn& spawn_of(const Emission&,
                                                 const Spawn& X,
                                                 const Lights&) {
  return X;
}
__device__ __forceinline__ const Lights& lights_of(const Emission&,
                                                   const Spawn&,
                                                   const Lights& Lt) {
  return Lt;
}

// A sample's radiance as it is added to the image: capped channel by
// channel at E.clamp when it is on (a NaN stays NaN).
__device__ __forceinline__ V3 clamp_sample(const Emission& E, V3 r) {
  if (!(E.clamp > 0.0f)) return r;
  const float c = E.clamp;
  return v3(r.x > c ? c : r.x, r.y > c ? c : r.y, r.z > c ? c : r.z);
}

// Next-event estimation over every light (mode "all"): 2 draws per light
// whatever the surface; the shadow segments are traced, and the light
// added (light_em), only at a diffuse hit.
template <bool SAMPLER>
__device__ __forceinline__ V3 nee_direct(const Params& P, const Sampler& S,
                                         bool hero, const Hit& h,
                                         bool diffuse, float lam,
                                         uint32_t& rng) {
  V3 direct = v3(0.0f, 0.0f, 0.0f);
  V3 cie = v3(0.0f, 0.0f, 0.0f);
  if (diffuse && !(SAMPLER && hero)) cie = cie_to_rgb(P.cie(), lam);
  for (int li = 0; li < P.n_light; ++li) {
    float u1 = rand_1f(rng);
    float u2 = rand_1f(rng);
    if (!diffuse) continue;
    const float* L = P.light() + li * LIGHT_STRIDE;
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
    float atten = scene_shadow(P.sph(), P.n_sph, P.geom, P.stack, so, ldir,
                               dist - kEPS(), lam);
    float w = geom * atten / (dist * dist);
    direct = vadd(direct,
                  vscale(light_em<SAMPLER>(P, S, hero, li, lam, cie), w));
  }
  return direct;
}

// Scatter + Russian roulette: exactly 4 draws. With cell_ndir > 0 the
// scatter uniforms move into the bounce cell of cell_key (the roulette
// draw never does). Writes the continuation ray and the reweighted
// throughput; returns false when the path ends (invalid scatter or
// roulette kill). SCALE (the spawn instances): the roulette thinned
// by rr_scale (photon_rr_scale on photon lanes, 1 on camera lanes, where
// it is the reference roulette bit for bit): survive if u_rr <= min(prob,
// 1) * rr_scale, reweight by 1 / (prob * rr_scale), in tpurt's kernel
// order (mega_pallas.py scatter_rr_c).
template <bool SCALE = false>
__device__ __forceinline__ bool scatter_rr(const Params& P, int mat, V3 wo,
                                           V3 n, V3 loc, float lam_eta_add,
                                           bool camera, float rr_thresh,
                                           uint32_t& rng, V3& o, V3& d,
                                           V3& tp, int cell_ndir = 0,
                                           uint32_t cell_key = 0,
                                           float rr_scale = 1.0f) {
  float u2a = rand_1f(rng);
  float u2b = rand_1f(rng);
  float u_choice = rand_1f(rng);
  float u_rr = rand_1f(rng);
  if (cell_ndir > 0) bounce_cells(cell_key, cell_ndir, u2a, u2b, u_choice);
  const float* m = P.mat() + mat * MAT_STRIDE;
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
  if constexpr (SCALE) {
    const bool live =
        s.ok && prob >= rr_thresh && u_rr <= fminf(prob, 1.0f) * rr_scale;
    o = vadd(loc, vscale(n, s.off));
    d = s.wi;
    tp = vscale(new_tp, 1.0f / fmaxf(prob * rr_scale, F(1e-30)));
    return live;
  }
  bool live = s.ok && prob >= rr_thresh && u_rr <= prob;
  o = vadd(loc, vscale(n, s.off));
  d = s.wi;
  tp = vscale(new_tp, 1.0f / fmaxf(prob, F(1e-30)));
  return live;
}

// Next-event estimation at one camera-path hit: the draws of every light,
// and at a diffuse hit the direct light added to `rad` and one shadow
// segment per light counted in `rays`. `hero`: the lights' emission is the
// hero-averaged one (light_em; S is read by the SAMPLER instances only).
template <bool SAMPLER = false>
__device__ __forceinline__ void camera_direct(const Params& P,
                                              const Sampler& S, bool hero,
                                              const Hit& h, float lam, V3 tp,
                                              uint32_t& rng, V3& rad,
                                              unsigned long long& rays) {
  const float* m = P.mat() + h.mat * MAT_STRIDE;
  const bool diffuse = (int)m[5] == 0;
  V3 direct = nee_direct<SAMPLER>(P, S, hero, h, diffuse, lam, rng);
  if (diffuse) {
    rad = vadd(rad, vmul(vmul(tp, load3(m)), direct));
    rays += (unsigned long long)P.n_light;
  }
}

// The shading of one camera-path hit: camera_direct, then scatter + RR at
// the dielectric IOR plus eta_add (the Cauchy term under dispersion on
// camera paths, else 0), in the bounce cell of cell_key when cell_ndir >
// 0. Writes the continuation into (o, d, tp); returns whether the path
// continues (before any depth limit).
template <bool SAMPLER = false>
__device__ __forceinline__ bool shade_camera_hit(
    const Params& P, const Sampler& S, bool hero, const Hit& h, V3 wo,
    float lam, float rr_thresh, uint32_t& rng, V3& o, V3& d, V3& tp, V3& rad,
    unsigned long long& rays, float eta_add = 0.0f, int cell_ndir = 0,
    uint32_t cell_key = 0) {
  camera_direct<SAMPLER>(P, S, hero, h, lam, tp, rng, rad, rays);
  return scatter_rr(P, h.mat, wo, h.n, h.loc, eta_add, true, rr_thresh, rng,
                    o, d, tp, cell_ndir, cell_key);
}

// Light row L's weight in the lights instances' selection: L_SEL_POWER,
// in mode "spatial" over max(d^2, 1e-4), d the distance from loc to the
// light's centre; floored at 1e-20 (tpurt/ops/sampling.py
// select_from_powers, the spatial heuristic of _nee_direct_power_c).
__device__ __forceinline__ float select_power(const float* L, int mode,
                                              V3 loc) {
  float p = L[L_SEL_POWER];
  if (mode == 2) {
    const float dx = L[L_POS] - loc.x;
    const float dy = L[L_POS + 1] - loc.y;
    const float dz = L[L_POS + 2] - loc.z;
    p = p / fmaxf(dx * dx + dy * dy + dz * dz, F(1e-4));
  }
  return fmaxf(p, F(1e-20));
}

// Next-event estimation with one light a hit (modes "power" and
// "spatial", tpurt's _nee_direct_power_c): 3 draws whatever the surface,
// u_sel then the light sample's pair; at a diffuse hit the light whose
// bucket holds u_sel * total (two passes over the rows: the running
// total, then the first running total above it, the last bucket open), its
// sample point, one shadow segment and its emission weighed by 1/pmf =
// total / p: em * geom * atten * inv_pdf * inv_pmf / dist^2. The plain
// version is tpurt_torch/integrate.py _nee_select. Needs a light.
template <bool SAMPLER>
__device__ __forceinline__ V3 nee_select(const Params& P, const Sampler& S,
                                         int mode, bool hero, const Hit& h,
                                         bool diffuse, float lam,
                                         uint32_t& rng) {
  const float u_sel = rand_1f(rng);
  const float u1 = rand_1f(rng);
  const float u2 = rand_1f(rng);
  if (!diffuse) return v3(0.0f, 0.0f, 0.0f);
  const float* rows = P.light();
  const int n = P.n_light;
  float tot = 0.0f;
  for (int li = 0; li < n; ++li)
    tot += select_power(rows + li * LIGHT_STRIDE, mode, h.loc);
  const float r = u_sel * tot;
  int sel = n - 1;
  float p_sel = 0.0f, cdf = 0.0f;
  bool found = false;
  for (int li = 0; li < n - 1; ++li) {
    const float p = select_power(rows + li * LIGHT_STRIDE, mode, h.loc);
    cdf += p;
    if (r < cdf) {
      sel = li;
      p_sel = p;
      found = true;
      break;
    }
  }
  if (!found) p_sel = select_power(rows + sel * LIGHT_STRIDE, mode, h.loc);
  const float inv_pmf = tot / p_sel;
  const float* L = rows + sel * LIGHT_STRIDE;
  const bool area = (int)L[L_TYPE] == 1;
  V3 lp = load3(L + L_POS);
  if (area) {
    const float su = (u1 - 0.5f) * L[L_TWO_HW];
    const float sv = (u2 - 0.5f) * L[L_TWO_HW];
    lp = v3(lp.x + su * L[L_TANGENT] + sv * L[L_BITANGENT],
            lp.y + su * L[L_TANGENT + 1] + sv * L[L_BITANGENT + 1],
            lp.z + su * L[L_TANGENT + 2] + sv * L[L_BITANGENT + 2]);
  }
  const V3 to_light = vsub(lp, h.loc);
  const float dist = sqrtf(fmaxf(vdot(to_light, to_light), F(1e-30)));
  const V3 ldir = vscale(to_light, 1.0f / dist);
  const float ndotl = vdot(h.n, ldir);
  const float cos_light =
      fmaxf(-(L[L_NORMAL] * ldir.x + L[L_NORMAL + 1] * ldir.y +
              L[L_NORMAL + 2] * ldir.z),
            0.0f);
  const float hw = L[L_HW];
  if (!(dist >= kEPS() && ndotl > 0.0f &&
        (!area || (cos_light > 0.0f && hw > 0.0f))))
    return v3(0.0f, 0.0f, 0.0f);
  const float inv_pdf = area ? fmaxf(4.0f * hw * hw, F(1e-10)) : 1.0f;
  const float geom = ndotl * (area ? cos_light : 1.0f);
  const V3 so = vadd(h.loc, vscale(h.n, kEPS()));
  const float atten = scene_shadow(P.sph(), P.n_sph, P.geom, P.stack, so,
                                   ldir, dist - kEPS(), lam);
  const float w = geom * atten * inv_pdf * inv_pmf / (dist * dist);
  const V3 cie =
      SAMPLER && hero ? v3(0.0f, 0.0f, 0.0f) : cie_to_rgb(P.cie(), lam);
  return vscale(light_em<SAMPLER>(P, S, hero, sel, lam, cie), w);
}

// camera_direct in the lights instances: mode "all" (or no light) as
// camera_direct; else nee_select, and at a diffuse hit one shadow segment.
template <bool SAMPLER>
__device__ __forceinline__ void camera_direct_sel(
    const Params& P, const Sampler& S, const Lights& Lt, bool hero,
    const Hit& h, float lam, V3 tp, uint32_t& rng, V3& rad,
    unsigned long long& rays) {
  if (Lt.mode == 0 || P.n_light == 0) {
    camera_direct<SAMPLER>(P, S, hero, h, lam, tp, rng, rad, rays);
    return;
  }
  const float* m = P.mat() + h.mat * MAT_STRIDE;
  const bool diffuse = (int)m[5] == 0;
  const V3 direct = nee_select<SAMPLER>(P, S, Lt.mode, hero, h, diffuse, lam,
                                        rng);
  if (diffuse) {
    rad = vadd(rad, vmul(vmul(tp, load3(m)), direct));
    rays += 1ull;
  }
}

// shade_camera_hit in the lights instances.
template <bool SAMPLER = false>
__device__ __forceinline__ bool shade_camera_hit_sel(
    const Params& P, const Sampler& S, const Lights& Lt, bool hero,
    const Hit& h, V3 wo, float lam, float rr_thresh, uint32_t& rng, V3& o,
    V3& d, V3& tp, V3& rad, unsigned long long& rays,
    float eta_add = 0.0f) {
  camera_direct_sel<SAMPLER>(P, S, Lt, hero, h, lam, tp, rng, rad, rays);
  return scatter_rr(P, h.mat, wo, h.n, h.loc, eta_add, true, rr_thresh, rng,
                    o, d, tp);
}

// The draws of next-event estimation at one camera hit in the lights
// instances: 2 a light in mode "all", else 3 (none without a light).
__device__ __forceinline__ int nee_draws(const Lights& Lt, int n_light) {
  return Lt.mode == 0 ? 2 * n_light : (n_light > 0 ? 3 : 0);
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

// A direction in the cone of half-angle cosine cos_half about `axis`:
// polar uc, azimuth u1 (tpurt/ops/soa.py cone_toward_c).
__device__ __forceinline__ V3 cone_toward(V3 axis, float uc, float u1,
                                          float cos_half) {
  const V3 T = tangent_frame(axis);
  const V3 B = vcross(axis, T);
  const float ct = 1.0f - uc * (1.0f - cos_half);
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float phi = kTWO_PI() * u1;
  return vadd(vadd(vscale(T, st * cosf(phi)), vscale(B, st * sinf(phi))),
              vscale(axis, ct));
}

// p_cos / p_mix of the defensive emission mixture q * U(aim cone) +
// (1 - q) * cos / pi about the light normal (tpurt/ops/soa.py
// aim_mixture_weight_c, with its 1e-6 cone tolerance).
__device__ __forceinline__ float aim_weight(V3 d, V3 lnorm, V3 axis,
                                            float cos_a, float q) {
  const float p_cos = fmaxf(vdot(d, lnorm), 0.0f) * kINV_PI();
  const bool in_cone = vdot(d, axis) >= cos_a - F(1e-6);
  const float p_aim =
      in_cone ? 1.0f / (kTWO_PI() * fmaxf(1.0f - cos_a, F(1e-7))) : 0.0f;
  const float denom = q * p_aim + (1.0f - q) * p_cos;
  return denom > 0.0f ? p_cos / fmaxf(denom, F(1e-30)) : 0.0f;
}

// photon_aim after emit_photon (the lights instances, Lt.q > 0): 3 more
// draws (choice, cone pair) whatever the light; an area light's photon
// takes, with probability q, a direction of the cone from its origin
// toward the pixel's vispoint `vpos` that subtends widen * radius
// (tpurt/ops/soa.py aimed_cone_c, sine clamped to [0.02, 0.7071]), and
// its throughput is weighed by aim_weight. Run only for a pixel whose
// vispoint passed the |vpos| > 0.001 gate, so q is the lane's q.
__device__ __forceinline__ void aim_photon(const float* L, const Lights& Lt,
                                           V3 vpos, float radius,
                                           uint32_t& prng, V3 ph_o, V3& ph_d,
                                           V3& ph_tp) {
  const float uch = rand_1f(prng);
  const float ua = rand_1f(prng);
  const float ub = rand_1f(prng);
  if ((int)L[L_TYPE] != 1) return;
  const V3 dv = vsub(vpos, ph_o);
  const float dist = sqrtf(fmaxf(vdot(dv, dv), F(1e-12)));
  const V3 axis = vscale(dv, 1.0f / dist);
  const float sin_a =
      fminf(fmaxf(Lt.widen * radius / dist, F(0.02)), F(0.7071));
  const float cos_a = sqrtf(1.0f - sin_a * sin_a);
  if (uch < Lt.q) ph_d = cone_toward(axis, ua, ub, cos_a);
  ph_tp = vscale(ph_tp,
                 aim_weight(ph_d, load3(L + L_NORMAL), axis, cos_a, Lt.q));
}

// The calling warp's tally in run_pixels' CAM instances: its trips of the
// loop in the high word, the lanes that traced a segment in them in the
// low word (a launch gives a warp fewer than 2^32 of each), in static
// shared memory, written by the warp's lane 0 alone. Two words, or two
// registers a lane, cost the loop more (PERF.md). WARPS: the most warps a
// block has; a template, so that only the CAM instances hold the array.
template <int WARPS = 32>
__device__ __forceinline__ unsigned long long* cam_tally() {
  __shared__ unsigned long long tally[WARPS];
  return &tally[threadIdx.x >> 5];
}

// The launch constants of the SPPM samples (run_pixels).
struct SampleConsts {
  long long P;    // pixel stride of the planes
  int width, height, depth, k_photons, max_photon_bounces;
  float rr_thresh, photon_rr_thresh, sppm_alpha;
  uint32_t base_seed;
  // uniform mode: every pixel takes spp samples from iteration it0 and
  // radius radius0. Budget mode (aux not null): pixel p takes aux[p]
  // samples from its own count aux[P + p] and its own radius aux[2P + p].
  int spp, it0;
  float radius0;
  const float* aux;
  // a lane whose path ended enters its next phase (photon k, the next
  // sample) only once no lane of its warp is still on a path; false: it
  // never waits (run_pixels). The launchers set it to "not budget mode".
  bool lockstep;
};

// The seed the strata cells of sample `it` hash: the frame seed of its
// window epoch (samples in one window share their cells).
template <bool SAMPLER>
__device__ __forceinline__ uint32_t strata_seed_of(const SampleConsts& c,
                                                   const Sampler& S,
                                                   uint32_t it) {
  if (!SAMPLER) return 0u;
  return frame_seed(c.base_seed,
                    S.window > 1 ? it & ~(uint32_t)(S.window - 1) : it);
}

// Shared memory of a block of run_pixels, in floats: the CIE table, the
// staged scene rows (`staged` floats, 0: read from global memory), the
// lanes' vispoint fields (`vis` a lane: VIS_FIELDS in the SPPM kernels, 0
// in the camera-only ones), then the walk stacks (ints).
constexpr int CIE_FLOATS = (N_CIE * 3 + 3) / 4 * 4;
constexpr int VIS_FIELDS = 10;  // vis_norm, vis_wo, vis_tp, vis_mat
inline size_t run_pixels_smem(int staged, const Geom& g, int threads,
                              int vis = VIS_FIELDS) {
  return sizeof(float) * (CIE_FLOATS + (staged + 3) / 4 * 4 + vis * threads) +
         walk_stack_bytes(g, threads);
}

// The SPPM samples of a launch's pixels: the body of the regen kernel
// (uniform and budget mode) and of the tile-sync kernel (one sample a
// pixel). Per pixel it computes what one thread per pixel computed,
// draw for draw and sum for sum (the plain version is
// tpurt_torch/integrate.py:render_tile, looped by render_plain and
// render_plain_budget): per sample the camera spawn (2 jitter draws, 1
// wavelength draw; SPAWN: spawn_camera_ext's draws), the camera path (up
// to `depth` bounces: nearest hit,
// vispoint at the first diffuse hit, next-event estimation over every
// light with the hero-averaged emission until a dielectric hit collapses
// the path to its hero wavelength, scatter + Russian roulette), then, if
// the pixel has a vispoint, photon walks k = 0..K-1 in order (light k % L,
// up to `max_photon_bounces` bounces) that add density-estimated radiance
// when they land within the radius of that vispoint; the sample's radiance
// added into rgb_sum once, then the per-pixel SPPM radius step.
//
// What changes is which lane runs which pixel when. Every lane is a small
// state machine: it holds one ray and its phase (camera bounce b, or
// photon k at bounce b), and one trip of the one loop traces one segment
// for it, runs that phase's shading (next-event estimation for a camera
// hit, the gather test for a photon; scatter + Russian roulette once for
// both) and advances the phase; photon, sample and pixel boundaries are
// short branches between trips (Aila and Laine's persistent threads;
// tpurt's TPU kernel has the same form in its tile-wide while loop with
// spawn gates). Blocks are persistent: a lane that has finished its pixel
// takes the next from the counter `work` (one atomicAdd per warp,
// consecutive pixels to the waiting lanes in lane order), so a pixel with
// no budget costs one fetch. A pixel is owned by one lane from fetch to
// store, so the planes need no synchronisation.
//
// `lockstep` sets whether the lanes of a warp may drift apart. Without it
// a lane never waits: lanes in different phases, samples and pixels share
// every trip's trace, a warp fetches the moment a lane falls idle, and a
// warp's time is its longest lane's total. With it a lane whose path ended
// enters its next phase only once no lane of its warp is still on a path:
// the warp's 32 neighbouring pixels stay at one sample and phase, their
// rays coherent, one kind of shading per trip, their planes loaded and
// stored together, and a warp's time is the sum over phases of its longest
// lane, as with nested loops. On the H100 lockstep measures faster on
// every uniform launch but the sphere-only Cornell box, where the two tie,
// and anything in between is slower than both (PERF.md), so uniform
// launches run in lockstep. In budget mode the pixels' sample counts
// differ, lockstep would wait for the largest budget of each warp, and the
// lanes never wait.
//
// Live state is kept small: the ray, throughput, sample radiance, vispoint
// position and radius in registers; vis_norm, vis_wo, vis_tp and vis_mat,
// read on a gather hit only, in shared memory (`vis`, field f of thread t
// at f * blockDim.x + t); rgb_sum in the planes, updated once per sample;
// the lights' emission recomputed where it is added (light_em).
//
// SAMPLER false compiles the reference sampler alone (S is then not read):
// the kernels instantiate both and pick one per launch, so a launch
// without the flags pays nothing for them. GLEAF: every nearest hit takes
// the G leaf (pallas_mxu_leaf; the regen kernel alone instantiates it),
// which the warp's lanes sweep together: every lane of the warp takes part
// in every trip's trace, a lane without a segment only to help.
// CAM: the camera-path instance of the fused wavefront kernel: no
// vispoint, no photon phase, no radius; `planes` is then the (P, 3)
// rgb_sum, row p at planes + 3p, budget-mode aux (2, P) budget and count;
// each warp counts its trips and the lanes that traced a segment in them
// (cam_tally; shadow segments aside) and adds them to work[1] and work[2].
// `em`: the switches the sampler, emission, spawn and lights instances
// pass: an Emission (read with EMIT), a Spawn after it in the spawn and
// lights instances (SPAWN: two switches or more), and a Lights after that
// in the lights instances (LIGHTS: three switches).
// EMIT: the emission instances: a camera path that misses adds the sky
// (add_sky); a camera path that hits an emissive material (type 3) adds
// its emission and ends there, with no vispoint and no collapse; a photon
// that hits one is gathered and absorbed; each sample's radiance is capped
// by the clamp as it is added (the sample is over: the radiance a path
// carries is never capped). SPAWN: the spawn instances: the spawn takes
// tpurt's shutter, lens and Sobol draws (spawn_camera_ext; the Sobol index
// is the sample's iteration `it`, the pixel's base count plus its sample
// in budget mode); photon lanes thin their roulette by the scale
// (scatter_rr<true>). LIGHTS: the lights instances (their spawn switches
// may be all off): next-event estimation by the Lights' mode
// (camera_direct_sel: every light, or one light a hit chosen by power)
// and, under photon_aim, the aimed photon emission (aim_photon).
// Every thread of the block must call it; blockDim.x is a multiple of 32.
template <bool SAMPLER, bool GLEAF, bool CAM = false, bool EMIT = false,
          class... Em>
__device__ __forceinline__ void run_pixels(float* planes, const Params& prm,
                                           const Sampler& S,
                                           const SampleConsts& c, float* vis,
                                           unsigned long long* work,
                                           unsigned long long& rays,
                                           const Em&... em) {
  const unsigned FULL = 0xffffffffu;
  const unsigned long long n_pix =
      (unsigned long long)c.width * (unsigned long long)c.height;
  const int vstride = blockDim.x;
  float* myvis = vis + threadIdx.x;
  bool more = true;   // the counter may still hold pixels (warp-uniform)
  int idx = -1;       // this lane's pixel; < 0: it waits for one
  bool spawn = false; // the next trip begins a sample
  bool live = false;  // the lane is inside a sample
  bool done = false;  // its path ended: it enters its next phase
  uint32_t it = 0, it_end = 0;
  float radius = 0.0f;
  int k = -1, b = 0;  // phase: camera path (k < 0) or photon k, bounce b
  bool vp_stored = false, coll = false;
  uint32_t rng = 0;
  float lam = 0.0f;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o, tp = o, rad = o, vpos = o;
  if constexpr (CAM) {
    if ((threadIdx.x & 31) == 0) *cam_tally<>() = 0ull;
  }

  for (;;) {
    // ---- fetch: the waiting lanes take consecutive pixels
    const unsigned want = __ballot_sync(FULL, idx < 0);
    if (more && want) {
      const int leader = __ffs(want) - 1;
      unsigned long long first = 0;
      if ((int)(threadIdx.x & 31) == leader)
        first = atomicAdd(work, (unsigned long long)__popc(want));
      first = __shfl_sync(FULL, first, leader);
      more = first + (unsigned long long)__popc(want) < n_pix;
      const unsigned long long mine =
          first + __popc(want & ((1u << (threadIdx.x & 31)) - 1u));
      if (idx < 0 && mine < n_pix) {
        idx = (int)mine;
        int n_smp = c.spp;
        uint32_t base = (uint32_t)c.it0;
        if (!CAM) radius = c.radius0;
        if (c.aux) {  // budget mode: the pixel's own budget, count, radius
          n_smp = (int)rintf(c.aux[idx]);
          base = (uint32_t)(int)rintf(c.aux[c.P + idx]);
          if (!CAM) radius = c.aux[2 * c.P + idx];
        }
        if (n_smp <= 0) {
          idx = -1;  // nothing to render: the planes stay as they are
        } else {
          if (!CAM) {
            const float* pl = planes + idx;
            vpos = v3(pl[3 * c.P], pl[4 * c.P], pl[5 * c.P]);
#pragma unroll
            for (int f = 0; f < VIS_FIELDS; ++f)
              myvis[f * vstride] = pl[(6 + f) * c.P];
          }
          it = base;
          it_end = base + (uint32_t)n_smp;
          spawn = true;
        }
      }
    } else if (!more && want == FULL) {
      break;  // no pixel left and no lane of the warp at work
    }

    // ---- lockstep: the lanes of the warp enter their next phase together
    const bool go =
        !c.lockstep || __ballot_sync(FULL, live && !done) == 0u;

    // ---- the path ended: the next photon, or the end of the sample
    if (done && go) {
      done = false;
      k += 1;
      if (CAM) {  // the end of a camera-path sample: its row, in sample order
        live = false;
        float* row = planes + 3 * idx;
        if constexpr (EMIT) rad = clamp_sample(emission(em...), rad);
        row[0] += rad.x;
        row[1] += rad.y;
        row[2] += rad.z;
        it += 1;
        if (it < it_end)
          spawn = true;
        else
          idx = -1;
      } else if (k < c.k_photons && sqrtf(vdot(vpos, vpos)) > F(0.001)) {
        const uint32_t seed = frame_seed(c.base_seed, it);
        rng = photon_stream(seed, (uint32_t)(idx % c.width),
                            (uint32_t)(idx / c.width), (uint32_t)k);
        emit_photon(prm.light() + (k % prm.n_light) * LIGHT_STRIDE, S,
                    SAMPLER && S.n_pos > 0, strata_seed_of<SAMPLER>(c, S, it),
                    (uint32_t)k, rng, o, d, tp);
        if constexpr (sizeof...(Em) == 3) {  // LIGHTS: photon_aim
          if (lights_of(em...).q > 0.0f)
            aim_photon(prm.light() + (k % prm.n_light) * LIGHT_STRIDE,
                       lights_of(em...), vpos, radius, rng, o, d, tp);
        }
        b = 0;
      } else if (c.lockstep && k < c.k_photons) {
        done = true;  // no vispoint: it sits out photon k with its warp
      } else {
        live = false;
        float* pl = planes + idx;
        if constexpr (EMIT) rad = clamp_sample(emission(em...), rad);
        pl[0] += rad.x;
        pl[c.P] += rad.y;
        pl[2 * c.P] += rad.z;
        // the per-pixel SPPM radius step
        const float base_f = c.aux ? c.aux[c.P + idx] : (float)c.it0;
        const uint32_t base = (uint32_t)(int)rintf(base_f);
        it += 1;
        const float itf = base_f + (float)(int)(it - base);
        radius = radius * sqrtf((itf + c.sppm_alpha) / (itf + 1.0f));
        if (it < it_end) {
          spawn = true;
        } else {  // the pixel is done: its vispoint goes back to the planes
          pl[3 * c.P] = vpos.x; pl[4 * c.P] = vpos.y; pl[5 * c.P] = vpos.z;
#pragma unroll
          for (int f = 0; f < VIS_FIELDS; ++f)
            pl[(6 + f) * c.P] = myvis[f * vstride];
          idx = -1;
        }
      }
    }

    // ---- a sample begins: 2 jitter draws, 1 wavelength draw (SPAWN: the
    // shutter, lens and Sobol draws too)
    if (spawn) {
      const uint32_t px = (uint32_t)(idx % c.width);
      const uint32_t py = (uint32_t)(idx / c.width);
      rng = seed_pixels(frame_seed(c.base_seed, it), px, py);
      if constexpr (sizeof...(Em) >= 2)  // SPAWN
        spawn_camera_ext(prm.cam(), spawn_of(em...), c.base_seed, it, px, py,
                         c.width, c.height, rng, o, d, lam);
      else
        spawn_camera(prm.cam(), px, py, c.width, c.height, rng, o, d, lam);
      tp = v3(1.0f, 1.0f, 1.0f);
      rad = v3(0.0f, 0.0f, 0.0f);
      vp_stored = false;
      coll = false;
      k = -1;
      b = 0;
      spawn = false;
      live = true;
    }
    // GLEAF: the G leaf sweeps leaves with the whole warp, so every lane
    // traces, those without a segment this trip only to help
    Hit hg;
    if constexpr (GLEAF) hg = intersect_g(prm, o, d, live && !done);
    if constexpr (CAM) {  // the trip, and its lanes with a segment
      const unsigned busy = __ballot_sync(FULL, live && !done);
      if ((threadIdx.x & 31) == 0)
        *cam_tally<>() += (1ull << 32) | (unsigned long long)__popc(busy);
    }
    if (!live || done) continue;

    // ---- one segment, whatever the phase
    rays += 1;
    const Hit h = GLEAF ? hg : intersect(prm, o, d);
    if (!(h.t < kHIT())) {
      if constexpr (EMIT) {
        if (CAM || k < 0)
          rad = add_sky<SAMPLER>(prm, S, emission(em...),
                                 SAMPLER && S.hero > 1 && !coll, lam, d, tp,
                                 rad);
      }
      done = true;
      continue;
    }
    const bool camera = CAM || k < 0;
    const V3 wo = vneg(d);
    const float lam_um = lam * F(1e-3);
    const float cauchy_add = F(0.004) / (lam_um * lam_um);
    const int mtype = (int)prm.mat()[h.mat * MAT_STRIDE + 5];
    if (camera) {
      // ---- camera bounce b: an emitter's emission; the vispoint at the
      // first diffuse hit, then next-event estimation, added at a diffuse
      // hit with one shadow segment per light
      if constexpr (EMIT) {
        if (mtype == 3)
          rad = add_emitter<SAMPLER>(prm, S, SAMPLER && S.hero > 1 && !coll,
                                     h.mat, lam, tp, rad);
      }
      if (!CAM && mtype == 0 && !vp_stored) {
        vpos = h.loc;
        myvis[0] = h.n.x; myvis[vstride] = h.n.y; myvis[2 * vstride] = h.n.z;
        myvis[3 * vstride] = wo.x; myvis[4 * vstride] = wo.y;
        myvis[5 * vstride] = wo.z;
        myvis[6 * vstride] = tp.x; myvis[7 * vstride] = tp.y;
        myvis[8 * vstride] = tp.z;
        myvis[9 * vstride] = (float)h.mat;
        vp_stored = true;
      }
      if constexpr (sizeof...(Em) == 3)  // LIGHTS
        camera_direct_sel<SAMPLER>(prm, S, lights_of(em...),
                                   SAMPLER && S.hero > 1 && !coll, h, lam, tp,
                                   rng, rad, rays);
      else
        camera_direct<SAMPLER>(prm, S, SAMPLER && S.hero > 1 && !coll, h,
                               lam, tp, rng, rad, rays);
      // a dielectric steers the path by eta(lam): only the hero goes on
      if (SAMPLER && S.collapse && mtype == 1) coll = true;
    } else {
      // ---- photon k, bounce b: gathered at this pixel's vispoint
      const V3 dvec = vsub(h.loc, vpos);
      const float dist = sqrtf(fmaxf(vdot(dvec, dvec), 0.0f));
      if (dist < radius) {
        const V3 vnorm = v3(myvis[0], myvis[vstride], myvis[2 * vstride]);
        const V3 vwo = v3(myvis[3 * vstride], myvis[4 * vstride],
                          myvis[5 * vstride]);
        const V3 vtp = v3(myvis[6 * vstride], myvis[7 * vstride],
                          myvis[8 * vstride]);
        const float* vm = prm.mat() + (int)myvis[9 * vstride] * MAT_STRIDE;
        const V3 f = evaluate_bsdf(vwo, wo, vnorm, load3(vm), vm[3],
                                   vm[4] + cauchy_add, (int)vm[5]);
        const float inv_pi_r2 =
            1.0f / fmaxf(F(3.141592653589793) * radius * radius, F(1e-10));
        const float kern = (1.0f - dist / radius) * inv_pi_r2;
        rad = vadd(rad, vscale(vmul(vmul(vtp, f), tp), kern));
      }
    }
    if constexpr (EMIT) {
      if (mtype == 3) {  // an emitter ends a camera path, absorbs a photon
        done = true;
        b += 1;
        continue;
      }
    }
    // ---- scatter + Russian roulette, once for the lanes of either phase:
    // camera paths at the IOR plus the Cauchy term only under dispersion
    // on camera paths, photons always; each in its own bounce cell
    int cells = 0;
    uint32_t key = 0;
    if (SAMPLER && (camera ? S.camera_bounce : S.photon_bounce)) {
      cells = S.n_dir;
      key = bounce_key(strata_seed_of<SAMPLER>(c, S, it),
                       camera ? CAMERA_STRATA_K
                              : (S.shared_k ? 0u : (uint32_t)k),
                       (uint32_t)b);
    }
    bool cont;
    if constexpr (sizeof...(Em) >= 2)  // SPAWN
      cont = scatter_rr<true>(
          prm, h.mat, wo, h.n, h.loc,
          camera ? (SAMPLER && S.disp_cam ? cauchy_add : 0.0f) : cauchy_add,
          camera, camera ? c.rr_thresh : c.photon_rr_thresh, rng, o, d, tp,
          cells, key, camera ? 1.0f : spawn_of(em...).rr_scale);
    else
      cont = scatter_rr(
          prm, h.mat, wo, h.n, h.loc,
          camera ? (SAMPLER && S.disp_cam ? cauchy_add : 0.0f) : cauchy_add,
          camera, camera ? c.rr_thresh : c.photon_rr_thresh, rng, o, d, tp,
          cells, key);
    if (!(cont && b + 1 < (camera ? c.depth : c.max_photon_bounces)))
      done = true;
    b += 1;
  }
  if constexpr (CAM) {
    if ((threadIdx.x & 31) == 0) {
      const unsigned long long t = *cam_tally<>();
      atomicAdd(work + 1, t >> 32);
      atomicAdd(work + 2, t & 0xffffffffull);
    }
  }
}

// The staged copy of the launch's tables in a block's shared memory `mem`
// (run_pixels_smem with VIS vispoint fields a lane): the CIE table, and
// the scene rows when staged > 0. Returns the Params of the block; ends
// with a __syncthreads().
template <int VIS = VIS_FIELDS>
__device__ __forceinline__ Params stage_scene(float* mem, const float* table,
                                              const float* cie, int staged,
                                              int n_sph, int n_mat,
                                              int n_light, const Geom& geom) {
  float* s_cie = mem;
  float* s_rows = mem + CIE_FLOATS;
  const int staged4 = (staged + 3) / 4;
  for (int i = threadIdx.x; i < N_CIE * 3; i += blockDim.x)
    s_cie[i] = __ldg(cie + i);
  for (int i = threadIdx.x; i < staged4; i += blockDim.x)
    reinterpret_cast<float4*>(s_rows)[i] =
        __ldg(reinterpret_cast<const float4*>(table) + i);
  __syncthreads();
  float* vis = s_rows + 4 * staged4;
  int* stacks = reinterpret_cast<int*>(vis + VIS * blockDim.x);
  return scene_params(table, staged > 0 ? s_rows : table, s_cie, n_sph,
                      n_mat, n_light, geom, walk_stack(stacks, geom));
}

// The floats of the table a launch stages into shared memory: the camera,
// sphere, material and light rows where they fit the budget (a Cornell
// box is ~100 floats, 64 flat spheres and 16 lights ~1200; every light
// adds 40), else 0 and the kernel reads them from global memory.
constexpr int STAGE_MAX_FLOATS = 4096;
inline int staged_floats(int n_sph, int n_mat, int n_light) {
  const int n = scene_floats(n_sph, n_mat, n_light);
  return n <= STAGE_MAX_FLOATS ? n : 0;
}

// The blocks of `threads` threads of `kernel` that stay resident on the
// current device with `smem` bytes of dynamic shared memory each, in
// `blocks` (all SMs). The runtime is asked once per kernel, device and
// size, and the kernel's dynamic shared memory limit is raised only past
// the largest size it was launched with: a launch's host work is a table
// lookup.
inline int resident_blocks(const void* kernel, size_t smem, int threads,
                           long long* blocks) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    long long blocks;
  };
  static Entry seen[256];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  size_t limit = 0;
  for (int i = 0; i < n_seen; ++i) {
    const Entry& e = seen[i];
    if (e.kernel != kernel || e.dev != dev) continue;
    if (e.smem == smem && e.threads == threads) {
      *blocks = e.blocks;
      return 0;
    }
    if (e.smem > limit) limit = e.smem;
  }
  if (smem > limit &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *blocks = (long long)sms * per_sm;
  if (n_seen < 256) seen[n_seen++] = {kernel, dev, threads, smem, *blocks};
  return 0;
}

// Launches `kernel` with as many blocks of 128 threads as stay resident
// (the lanes fetch their pixels), at most one thread a pixel.
template <class Kernel, class... Args>
inline int launch_persistent(Kernel kernel, size_t smem, long long n_pix,
                             cudaStream_t s, Args... args) {
  const int threads = 128;
  long long resident = 0;
  const int err = resident_blocks((const void*)kernel, smem, threads,
                                  &resident);
  if (err) return err;
  const long long want = (n_pix + threads - 1) / threads;
  const unsigned int blocks =
      (unsigned int)(want < resident ? (want > 0 ? want : 1) : resident);
  kernel<<<blocks, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
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

// Blocks of 128 threads an SM must hold: the register cap of the
// reference-sampler instances of the regen and tile-sync kernels (8: 64
// registers a thread) and of the instances with tpurt's sampler flags (6:
// 80 registers); PERF.md has the caps that were tried.
#define TPURT_REGEN_BOUNDS(SAMPLER) __launch_bounds__(128, SAMPLER ? 6 : 8)

// One block of the regen, tile-sync or fused wavefront kernel (CAM): stage
// the tables, run the lanes' pixels, add the block's segments to
// counters[0]; counters[1] is the work counter. `staged`: the floats of
// `table` to stage into shared memory, 0 where they do not fit
// (staged_floats). `em`: the emission and spawn instances' switches.
template <bool SAMPLER, bool GLEAF, bool CAM = false, bool EMIT = false,
          class... Em>
__device__ __forceinline__ void run_block(
    float* planes, const float* table, const float* cie, int staged,
    int n_sph, int n_mat, int n_light, const SampleConsts& c,
    const Sampler& S, const Geom& geom, unsigned long long* counters,
    const Em&... em) {
  extern __shared__ float4 smem4[];
  float* mem = reinterpret_cast<float*>(smem4);
  const Params prm = stage_scene<CAM ? 0 : VIS_FIELDS>(
      mem, table, cie, staged, n_sph, n_mat, n_light, geom);
  unsigned long long rays = 0;
  run_pixels<SAMPLER, GLEAF, CAM, EMIT>(
      planes, prm, S, c, mem + CIE_FLOATS + (staged + 3) / 4 * 4, counters + 1,
      rays, em...);
  add_block_rays<4>(rays, counters);
}

// One launch of the emission instances of the regen and tile-sync
// kernels (path_emit.cu), with the G leaf where geom.gmat is set.
int launch_emit(float* planes, const float* table, const float* cie,
                int staged, int n_sph, int n_mat, int n_light,
                const SampleConsts& c, const Sampler& S, const Emission& E,
                const Geom& geom, unsigned long long* counters,
                cudaStream_t stream);

// One launch of the spawn instances of the regen and tile-sync kernels
// (path_spawn.cu): with the sampler flags or emission (E not null) the
// one with both, else the reference sampler's; the G leaf where geom.gmat
// is set.
int launch_spawn(float* planes, const float* table, const float* cie,
                 int staged, int n_sph, int n_mat, int n_light,
                 const SampleConsts& c, const Sampler& S, const Emission* E,
                 const Spawn& X, const Geom& geom,
                 unsigned long long* counters, cudaStream_t stream);

// One launch of the lights instances of the regen and tile-sync kernels
// (path_lights.cu): with the sampler flags or emission (E not null) the
// one with both, else the reference sampler's; the spawn switches X, all
// off where null; the G leaf where geom.gmat is set.
int launch_lights(float* planes, const float* table, const float* cie,
                  int staged, int n_sph, int n_mat, int n_light,
                  const SampleConsts& c, const Sampler& S, const Emission* E,
                  const Spawn* X, const Lights& Lt, const Geom& geom,
                  unsigned long long* counters, cudaStream_t stream);

// The emission switches of a spawn launch without emission: all off.
inline Emission emission_or_off(const Emission* E) {
  return E ? *E : Emission{};
}

// The spawn switches of a lights launch without them: all off (the
// pinhole spawn from the PCG stream, the reference roulette).
inline Spawn spawn_or_off(const Spawn* X) {
  if (X) return *X;
  Spawn off = {};
  off.rr_scale = 1.0f;
  return off;
}

}  // namespace tpurt
