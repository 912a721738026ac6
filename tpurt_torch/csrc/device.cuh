// Device math of the path kernels: vec3 helpers, the PCG stream, CIE and
// blackbody emission, Fresnel, GGX, Oren-Nayar, sphere hits and shadows.
//
// Each function is the scalar twin of a plain PyTorch function of the port
// (tpurt_torch/ops/*.py, tpurt_torch/integrate.py), itself a port of
// tpurt's component-form kernel code (tpurt/ops/soa.py and the device
// functions of tpurt/kernels/mega_pallas.py). Operation order is kept
// term for term, and the build uses -fmad=false without fast math, so
// kernel and plain version take the same branches (same Russian-roulette
// kills, same reflect/refract choices, same ray counts).
//
// Constants are written F(double literal): the plain version rounds a
// Python double to float32, and a decimal float literal could round
// differently.
#pragma once

#include <cstdint>

#define F(x) ((float)(x))

namespace tpurt {

constexpr int N_CIE = 81;
constexpr int MAX_LIGHTS = 16;

// scene table layout (float32), packed by tpurt_torch/kernels/mega_regen.py
constexpr int CAM_FLOATS = 12;     // origin, horizontal, vertical, lower_left
constexpr int SPH_STRIDE = 8;      // cx cy cz r2 mat mtype ior index
constexpr int MAT_STRIDE = 8;      // r g b rough ior mtype - -
constexpr int LIGHT_STRIDE = 40;
enum LightField {
  L_POS = 0, L_HW = 3, L_TYPE = 4, L_TEMP = 5, L_TWO_HW = 6,
  L_AREA_SCALE = 7, L_NORMAL = 8, L_TANGENT = 11, L_BITANGENT = 14,
  L_CONE_AXIS = 17, L_CONE_T = 20, L_CONE_B = 23, L_EM_SCALE = 26,
  L_PH_ORIGIN = 29, L_PH_POWER = 32,
};

__device__ __forceinline__ float kEPS() { return F(1e-5); }
__device__ __forceinline__ float kMISS() { return F(1e30); }
__device__ __forceinline__ float kHIT() { return F(1e30 * 0.5); }
__device__ __forceinline__ float kINF() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float kPI() { return F(3.14159265358979); }
__device__ __forceinline__ float kINV_PI() { return F(0.3183098861837907); }
__device__ __forceinline__ float kTWO_PI() { return F(6.283185307179586); }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x; r.y = y; r.z = z;
  return r;
}
__device__ __forceinline__ V3 load3(const float* p) {
  return v3(p[0], p[1], p[2]);
}
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 vmul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 vscale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 vneg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 vnormalize(V3 a, float eps) {
  float inv = 1.0f / sqrtf(fmaxf(vdot(a, a), eps));
  return vscale(a, inv);
}
__device__ __forceinline__ float vmax_comp(V3 a) {
  return fmaxf(fmaxf(a.x, a.y), a.z);
}

// ----- PCG RXS-M-XS 32/32 (tpurt/ops/rng.py) -----

__device__ __forceinline__ uint32_t rand_u32(uint32_t& state) {
  uint32_t old = state;
  uint32_t shift = (old >> 28) + 4u;
  uint32_t res = ((old >> shift) ^ old) * 277803737u;
  state = old * 747796405u + 2891336453u;
  return (res >> 22) ^ res;
}
__device__ __forceinline__ float rand_1f(uint32_t& state) {
  return __uint2float_rn(rand_u32(state)) * 0x1p-32f;
}
__device__ __forceinline__ uint32_t seed_pixels(uint32_t seed, uint32_t x,
                                                uint32_t y) {
  return seed + 1203793u * x + 7u * y;
}
__device__ __forceinline__ uint32_t photon_stream(uint32_t seed, uint32_t x,
                                                  uint32_t y, uint32_t k) {
  return seed_pixels(seed + (0x9E3779B9u + k * 0x85EBCA6Bu), x, y);
}
__device__ __forceinline__ uint32_t frame_seed(uint32_t base, uint32_t it) {
  uint32_t x = base + 2654435761u * it;
  return rand_u32(x);
}

// ----- spectra (tpurt/ops/spectra.py) -----

// internal linkage: each translation unit that includes this header has
// its own copy, filled by the launcher that uses it
static __constant__ float c_cie[N_CIE * 3];

__device__ __forceinline__ V3 cie_to_rgb(float lam) {
  float t = (lam - F(380.0)) / F(5.0);
  int i = __float2int_rz(t);
  float f = t - (float)i;
  int a = min(max(i, 0), N_CIE - 1);
  int b = min(max(i + 1, 0), N_CIE - 1);
  float g = 1.0f - f;
  return v3(c_cie[3 * a] * g + c_cie[3 * b] * f,
            c_cie[3 * a + 1] * g + c_cie[3 * b + 1] * f,
            c_cie[3 * a + 2] * g + c_cie[3 * b + 2] * f);
}

__device__ __forceinline__ float blackbody(float lam, float temp) {
  constexpr double H = 6.62607015e-34, C = 2.99792458e8, K = 1.380649e-23;
  float l = lam * F(1e-9);
  float l2 = l * l;
  float l5 = l * (l2 * l2);
  return F(2.0 * H * C * C) / (l5 * (expf(F(H * C / K) / (l * temp)) - 1.0f))
         * F(1e-14);
}

// ----- BSDF pieces (tpurt/ops/bsdf.py, tpurt/ops/soa.py) -----

__device__ __forceinline__ float fr_dielectric(float cos_i, float eta) {
  float ct = fminf(fmaxf(cos_i, -1.0f), 1.0f);
  bool inside = ct < 0.0f;
  float e = inside ? 1.0f / eta : eta;
  ct = fabsf(ct);
  float sin2_ti = 1.0f - ct * ct;
  float sin2_tt = sin2_ti / (e * e);
  if (sin2_tt >= 1.0f) return 1.0f;
  float ct_t = sqrtf(fmaxf(1.0f - sin2_tt, 0.0f));
  float r_parl = (e * ct - ct_t) / fmaxf(e * ct + ct_t, F(1e-20));
  float r_perp = (ct - e * ct_t) / fmaxf(ct + e * ct_t, F(1e-20));
  return (r_parl * r_parl + r_perp * r_perp) * 0.5f;
}

__device__ __forceinline__ V3 tangent_frame(V3 n) {
  if (fabsf(n.y) > F(0.99999)) return v3(1.0f, 0.0f, 0.0f);
  return vnormalize(v3(n.z, 0.0f, -n.x), F(1e-30));
}
__device__ __forceinline__ V3 to_local(V3 w, V3 n, V3 t, V3 b) {
  return v3(vdot(w, t), vdot(w, b), vdot(w, n));
}
__device__ __forceinline__ V3 to_world(V3 w, V3 n, V3 t, V3 b) {
  return vadd(vadd(vscale(t, w.x), vscale(b, w.y)), vscale(n, w.z));
}

__device__ __forceinline__ V3 oren_nayar(V3 wo, V3 wi, V3 n, V3 albedo,
                                         float sigma) {
  float ndotv = fmaxf(vdot(n, wo), 0.0f);
  float ndotl = fmaxf(vdot(n, wi), 0.0f);
  float sig2 = sigma * sigma;
  float A = 1.0f - 0.5f * sig2 / (sig2 + F(0.33));
  float B = F(0.45) * sig2 / (sig2 + F(0.09));
  float sin_v = sqrtf(fmaxf(1.0f - ndotv * ndotv, 0.0f));
  float sin_l = sqrtf(fmaxf(1.0f - ndotl * ndotl, 0.0f));
  V3 wo_t = vsub(wo, vscale(n, ndotv));
  V3 wi_t = vsub(wi, vscale(n, ndotl));
  float denom = fmaxf(sin_v * sin_l, F(1e-20));
  float cos_phi_raw = fminf(fmaxf(vdot(wo_t, wi_t) / denom, -1.0f), 1.0f);
  float cos_phi_diff =
      (sin_v > F(1e-6) && sin_l > F(1e-6)) ? cos_phi_raw : 1.0f;
  float sin_alpha = fmaxf(sin_v, sin_l);
  float tan_beta = fminf(sin_v, sin_l) / fmaxf(fmaxf(ndotv, ndotl), F(1e-20));
  float scale = kINV_PI() *
                (A + B * fmaxf(cos_phi_diff, 0.0f) * sin_alpha * tan_beta);
  if (!(ndotv >= F(1e-6) && ndotl >= F(1e-6))) scale = 0.0f;
  return vscale(albedo, scale);
}

__device__ __forceinline__ float tan2_theta_z(float wz) {
  float c2 = wz * wz;
  float t2 = (1.0f - c2) / fmaxf(c2, F(1e-10));
  return c2 < F(1e-10) ? F(1e20) : t2;
}
__device__ __forceinline__ float tr_d(float wmz, float alpha) {
  float tan2 = tan2_theta_z(wmz);
  float cos4 = (wmz * wmz) * (wmz * wmz);
  float a2 = alpha * alpha;
  float e = tan2 / fmaxf(a2, F(1e-20));
  float d = 1.0f / fmaxf(kPI() * a2 * cos4 * (1.0f + e) * (1.0f + e),
                         F(1e-30));
  return tan2 > F(1e20) ? 0.0f : d;
}
__device__ __forceinline__ float tr_lambda(float wz, float alpha) {
  float tan2 = tan2_theta_z(wz);
  float a2 = alpha * alpha;
  float lam = (sqrtf(1.0f + a2 * tan2) - 1.0f) * 0.5f;
  return tan2 > F(1e20) ? 0.0f : lam;
}
__device__ __forceinline__ float tr_g(float woz, float wiz, float alpha) {
  return 1.0f / (1.0f + tr_lambda(woz, alpha) + tr_lambda(wiz, alpha));
}
__device__ __forceinline__ float tr_g1(float wz, float alpha) {
  return 1.0f / (1.0f + tr_lambda(wz, alpha));
}

// VNDF sample (Heitz 2018) in the local frame
__device__ __forceinline__ V3 tr_sample_wm(V3 wo, float u1, float u2,
                                           float alpha) {
  V3 wh = vnormalize(v3(alpha * wo.x, alpha * wo.y, wo.z), F(1e-30));
  if (wh.z < 0.0f) wh = vneg(wh);
  V3 t1 = fabsf(wh.z) > F(0.99999)
              ? v3(1.0f, 0.0f, 0.0f)
              : vnormalize(v3(-wh.y, wh.x, 0.0f), F(1e-30));
  V3 t2 = vcross(wh, t1);
  float r = sqrtf(u2);
  float phi = kTWO_PI() * u1;
  float px = r * cosf(phi);
  float py = r * sinf(phi);
  float h = sqrtf(fmaxf(1.0f - px * px, 0.0f));
  py = h + ((1.0f + wh.z) * 0.5f) * (py - h);
  float pz = sqrtf(fmaxf(1.0f - px * px - py * py, 0.0f));
  V3 nh = vadd(vadd(vscale(t1, px), vscale(t2, py)), vscale(wh, pz));
  return vnormalize(v3(alpha * nh.x, alpha * nh.y, fmaxf(nh.z, F(1e-6))),
                    F(1e-30));
}

__device__ __forceinline__ V3 reflect(V3 wo, V3 n) {
  return vsub(vscale(n, 2.0f * vdot(wo, n)), wo);
}
// Returns false (and a zero vector) under total internal reflection.
__device__ __forceinline__ bool refract(V3 wo, V3 n, float eta, V3& wi) {
  float ct = vdot(n, wo);
  bool inside = ct < 0.0f;
  float e = inside ? 1.0f / eta : eta;
  V3 na = inside ? vneg(n) : n;
  ct = fabsf(ct);
  float sin2_tt = fmaxf(1.0f - ct * ct, 0.0f) / (e * e);
  if (sin2_tt >= 1.0f) {
    wi = v3(0.0f, 0.0f, 0.0f);
    return false;
  }
  float ct_t = sqrtf(fmaxf(1.0f - sin2_tt, 0.0f));
  wi = vadd(vscale(wo, -1.0f / e), vscale(na, ct / e - ct_t));
  return true;
}

__device__ __forceinline__ V3 schlick(float cos_t, V3 f0) {
  float c = fminf(fmaxf(fabsf(cos_t), 0.0f), 1.0f);
  float m = 1.0f - c;
  float w = m * m * m * m * m;
  return v3(f0.x + (1.0f - f0.x) * w, f0.y + (1.0f - f0.y) * w,
            f0.z + (1.0f - f0.z) * w);
}

// ----- spheres (tpurt_torch/ops/intersect.py) -----

struct Hit {
  float t;
  V3 loc, n;
  int mat;
};

// Near root of the ray (o, d) on one sphere row (cx cy cz r2 mat mtype ior
// index), or MISS; a = |d|^2, inv_a = 1 / a.
__device__ __forceinline__ float sphere_t(const float* sp, V3 o, V3 d,
                                          float a, float inv_a) {
  V3 oc = v3(o.x - sp[0], o.y - sp[1], o.z - sp[2]);
  float half_b = vdot(oc, d);
  float c = vdot(oc, oc) - sp[3];
  float disc = half_b * half_b - a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = (-half_b - sq) * inv_a;
  return (disc > 0.0f && t > 0.0f) ? t : kMISS();
}

// The nearest sphere so far: the least (t, scene index).
struct SphBest {
  float t;
  int index;
  const float* row;
};

__device__ __forceinline__ void sphere_take(const float* sp, V3 o, V3 d,
                                            float a, float inv_a,
                                            SphBest& b) {
  float t = sphere_t(sp, o, d, a, inv_a);
  int index = (int)sp[7];
  if (t < kMISS() && (t < b.t || (t == b.t && index < b.index))) {
    b.t = t;
    b.index = index;
    b.row = sp;
  }
}

__device__ __forceinline__ Hit sphere_finish(const SphBest& b, V3 o, V3 d) {
  V3 c = b.row ? load3(b.row) : v3(0.0f, 0.0f, 0.0f);
  Hit h;
  h.t = b.t;
  h.loc = vadd(o, vscale(d, b.t * F(0.9999)));
  h.n = vnormalize(vsub(h.loc, c), F(1e-30));
  h.mat = b.row ? (int)b.row[4] : 0;
  return h;
}

// Transmission factor of one sphere row for the segment o + d*[0, t_max]:
// 0 for an overlapping diffuse or metal sphere, (1-R1)(1-R2) at the
// dispersed IOR of wavelength lam for a dielectric one, 1 otherwise.
__device__ __forceinline__ float sphere_factor(const float* sp, V3 o, V3 d,
                                               float a, float inv_a,
                                               float t_max, float lam) {
  V3 c0 = load3(sp);
  V3 oc = v3(o.x - sp[0], o.y - sp[1], o.z - sp[2]);
  float half_b = vdot(oc, d);
  float c = vdot(oc, oc) - sp[3];
  float disc = half_b * half_b - a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t0 = (-half_b - sq) * inv_a;
  float t1 = (-half_b + sq) * inv_a;
  bool overlap = disc > 0.0f && t1 > 0.0f && t0 < t_max;
  if ((int)sp[5] != 1) return overlap ? 0.0f : 1.0f;
  float t_entry = fmaxf(t0, 0.0f);
  float t_exit = fminf(t1, t_max);
  bool segment = t_entry < t_exit;
  float lam_um = lam * F(1e-3);
  float eta = sp[6] + F(0.004) / (lam_um * lam_um);
  V3 n1 = vnormalize(vsub(vadd(o, vscale(d, t_entry)), c0), F(1e-30));
  float r1 = fr_dielectric(-vdot(n1, d), eta);
  V3 n2 = vnormalize(vsub(vadd(o, vscale(d, t_exit)), c0), F(1e-30));
  float r2 = fr_dielectric(-vdot(n2, d), eta);
  float f = segment ? (1.0f - r1) * (1.0f - r2) : 1.0f;
  return overlap ? f : 1.0f;
}

}  // namespace tpurt
