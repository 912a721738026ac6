// Camera- and photon-path device code shared by the regen, wavefront sweep
// and fused wavefront kernels: the scene's nearest hit and shadow factor
// (spheres and triangles, flat or through the BVH walks of bvh.cuh), the
// camera spawn, per-light emission at one wavelength, next-event
// estimation over every light, the BSDF scatters with Russian roulette,
// and the photon-gather BSDF.
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
  p.n_sph = n_sph;
  p.n_mat = n_mat;
  p.n_light = n_light;
  p.geom = geom;
  return p;
}

// The scene's nearest hit (mega_pallas._make_scene_fns' intersect).
__device__ __forceinline__ Hit intersect(const Params& P, V3 o, V3 d) {
  return scene_hit(P.sph, P.n_sph, P.geom, o, d);
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

// Scatter + Russian roulette: exactly 4 draws. Writes the continuation ray
// and the reweighted throughput; returns false when the path ends (invalid
// scatter or roulette kill).
__device__ __forceinline__ bool scatter_rr(const Params& P, int mat, V3 wo,
                                           V3 n, V3 loc, float lam_eta_add,
                                           bool camera, float rr_thresh,
                                           uint32_t& rng, V3& o, V3& d,
                                           V3& tp) {
  float u2a = rand_1f(rng);
  float u2b = rand_1f(rng);
  float u_choice = rand_1f(rng);
  float u_rr = rand_1f(rng);
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
// + RR. Writes the continuation into (o, d, tp); returns whether the path
// continues (before any depth limit).
__device__ __forceinline__ bool shade_camera_hit(
    const Params& P, const Hit& h, V3 wo, float lam, const float* em,
    float rr_thresh, uint32_t& rng, V3& o, V3& d, V3& tp, V3& rad,
    unsigned long long& rays) {
  const float* m = P.mat + h.mat * MAT_STRIDE;
  bool diffuse = (int)m[5] == 0;
  V3 direct = nee_direct(P, h, diffuse, lam, em, rng);
  if (diffuse) {
    rad = vadd(rad, vmul(vmul(tp, load3(m)), direct));
    rays += (unsigned long long)P.n_light;
  }
  return scatter_rr(P, h.mat, wo, h.n, h.loc, 0.0f, true, rr_thresh, rng, o,
                    d, tp);
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
