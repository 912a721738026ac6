// Device math of the path kernels: vec3 helpers, the PCG stream, tpurt's
// strata cells and hero-wavelength tables, CIE and blackbody emission,
// Fresnel, GGX, Oren-Nayar, sphere hits and shadows.
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

// scene table layout (float32), packed by tpurt_torch/kernels/mega_regen.py:
// camera, spheres, materials, lights, then each light's hero table
constexpr int CAM_FLOATS = 12;     // origin, horizontal, vertical, lower_left
constexpr int SPH_STRIDE = 8;      // cx cy cz r2 mat mtype ior index
constexpr int MAT_STRIDE = 8;      // r g b rough ior mtype - -
constexpr int LIGHT_STRIDE = 40;
enum LightField {
  L_POS = 0, L_HW = 3, L_TYPE = 4, L_TEMP = 5, L_TWO_HW = 6,
  L_AREA_SCALE = 7, L_NORMAL = 8, L_TANGENT = 11, L_BITANGENT = 14,
  L_CONE_AXIS = 17, L_CONE_T = 20, L_CONE_B = 23, L_EM_SCALE = 26,
  L_PH_ORIGIN = 29, L_PH_POWER = 32,
  // the light's weight in light_sample "power" (the lights instances):
  // f32 intensity * f32(f32(4 hw) hw) for an area light, the intensity
  // for a point (tpurt/ops/sampling.py light_powers)
  L_SEL_POWER = 35,
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

// ----- tpurt's sampler flags (tpurt/ops/rng.py, tpurt/ops/spectra.py) -----

// Host-computed switches of a launch, filled by
// tpurt_torch/kernels/mega_regen.py:sampler_args.
struct Sampler {
  int n_pos;          // emission position cells per axis (0: strata off)
  int n_dir;          // direction cells per axis, emission and bounce
  int shared_k;       // one emission cell for all K photons of a sample
  int window;         // samples per strata epoch (a power of two)
  int photon_bounce;  // photon bounce cells (photon_strata_bounce)
  int camera_bounce;  // camera bounce cells (camera_strata_bounce)
  int disp_cam;       // Cauchy IOR on camera paths
  int hero;           // hero wavelengths C (1: one wavelength a sample)
  int hero_nseg;      // segments of each light's hero table
  float hero_delta;   // f32(400 / C): the table's period in nm
  int collapse;       // track the collapse to the hero wavelength
};

// Whether a launch needs the sampler instance of a path kernel.
inline bool sampler_on(const Sampler& S) {
  return S.n_pos > 0 || S.hero > 1 || S.disp_cam;
}

// Emission besides the lights and the radiance clamp (tpurt's sky,
// type-3 materials and radiance_clamp): the switches of a path kernel's
// emission instance, filled by tpurt_torch/kernels/mega_regen.py:
// emission_args. A launch without any of them passes none and runs an
// instance that has no code for them.
struct Emission {
  int sky;         // a camera path that misses adds the sky
  int gradient;    // the sky's tint lerps toward (.5, .7, 1) by height
  int legacy;      // wavefront tracers: the legacy RGB ramp on a miss
  float sky_k;     // f32(sky_intensity * 400)
  float sky_temp;  // the sky's blackbody temperature, 0: a flat spectrum
  float sky_r, sky_g, sky_b;  // sky_color
  float clamp;     // each sample's radiance cap per channel, 0: off
};

// ----- tpurt's camera-spawn extensions and photon roulette thinning -----
// (tpurt/camera.py, tpurt/ops/qmc.py, photon_rr_scale)

// The switches of the spawn instances, filled by
// tpurt_torch/kernels/mega_regen.py:spawn_args: the thin lens, the
// shutter, the Owen-scrambled Sobol spawn draws and the photon roulette
// scale. A launch without them passes none and runs an instance that has
// no code for them.
struct Spawn {
  int qmc;          // the spawn draws come from the Sobol stream
  int motion;       // one shutter-time draw t; the basis is row + t * dcam
  int lens;         // two lens draws (aperture > 0)
  float lens_r;     // f32(0.5 * aperture): the lens disc's radius
  float lens_finv;  // f32(1 / focus_dist)
  float rr_scale;   // photon lanes survive with min(prob, 1) * rr_scale
  float dcam[12];   // shutter close minus open: origin, h, v, lower_left
  const uint32_t* sobol;  // (qmc.N_DIMS, 32) direction numbers, on the device
};

// ----- tpurt's many-light NEE and aimed photon emission -----
// (light_sample, photon_aim, photon_aim_widen)

// The switches of the lights instances, filled by
// tpurt_torch/kernels/mega_regen.py:lights_args: how next-event estimation
// picks its lights and whether photons aim. A launch without them passes
// none and runs an instance that has no code for them.
struct Lights {
  int mode;     // 0: every light ("all"); 1 "power", 2 "spatial": one
                // light a hit, in proportion to L_SEL_POWER (2: over the
                // squared distance to the light's centre)
  float q;      // photon_aim: an area light's photon aims at the pixel's
                // vispoint with probability q (0: off)
  float widen;  // photon_aim_widen: the aim cone subtends widen * radius
};

constexpr uint32_t QMC_SALT = 0x5173B0C1u;
constexpr uint32_t QMC_DIM_STEP = 0x9E3779B9u;

// The Laine-Karras permutation (tpurt/ops/qmc.py _laine_karras).
__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

// The per-pixel scramble base of the Sobol stream (qmc.spawn_stream).
__device__ __forceinline__ uint32_t qmc_pixel(uint32_t base_seed, uint32_t px,
                                              uint32_t py) {
  uint32_t s = seed_pixels(base_seed ^ QMC_SALT, px, py);
  return rand_u32(s);
}

// Draw `dim` of sample `idx` of a pixel's Sobol stream (QmcStream.next_1f):
// the Sobol point's bits, Owen-scrambled with the (pixel, dim) seed.
__device__ __forceinline__ float qmc_1f(const uint32_t* sobol, uint32_t idx,
                                        uint32_t pix, int dim) {
  const uint32_t* v = sobol + dim * 32;
  uint32_t bits = 0u;
  for (int b = 0; idx != 0u; ++b, idx >>= 1)
    if (idx & 1u) bits ^= __ldg(v + b);
  uint32_t s = pix + (uint32_t)dim * QMC_DIM_STEP;
  const uint32_t sd = rand_u32(s);
  bits = __brev(laine_karras(__brev(bits), sd));
  return __uint2float_rn(bits) * 0x1p-32f;
}

constexpr uint32_t STRATA_OFFSET = 0xA511E9B3u;
constexpr uint32_t STRATA_K_STEP = 0x632BE5ABu;
constexpr uint32_t BOUNCE_OFFSET = 0x7F4A7C15u;
constexpr uint32_t BOUNCE_STEP = 0x94D049BBu;
constexpr uint32_t CAMERA_STRATA_K = 0x5BD1u;

// (s + u) / n for cell s of n (inv = 1/n, exact: n is a power of two),
// kept below 1: s + u rounds up to n when u is within an ulp of 1
__device__ __forceinline__ float cell_remap(float u, uint32_t s, float inv) {
  return fminf(((float)s + u) * inv, __int_as_float(0x3f7fffff));
}

// Photon k's emission uniforms moved into the (sample, k) cell of
// `seed`, shared by every pixel (rng.apply_emission_strata): cone polar
// uc and hemisphere angle uh1 share dir_a, cone azimuth up1 and
// hemisphere radius uh2 dir_b, the quad position (ue1, ue2) (pos_u,
// pos_v). Direction counts past 256 take their fields from a second word.
__device__ __forceinline__ void emission_cells(uint32_t seed, uint32_t k,
                                               int n_pos, int n_dir,
                                               float& uc, float& up1,
                                               float& ue1, float& ue2,
                                               float& uh1, float& uh2) {
  uint32_t s = seed + (STRATA_OFFSET + k * STRATA_K_STEP);
  const uint32_t h = rand_u32(s);
  const uint32_t mp = (uint32_t)n_pos - 1u, md = (uint32_t)n_dir - 1u;
  uint32_t da, db;
  if (n_dir <= 256) {
    da = (h >> 16) & md;
    db = (h >> 24) & md;
  } else {
    const uint32_t h2 = rand_u32(s);
    da = h2 & md;
    db = (h2 >> 16) & md;
  }
  const float inv_p = 1.0f / (float)n_pos, inv_d = 1.0f / (float)n_dir;
  uc = cell_remap(uc, da, inv_d);
  up1 = cell_remap(up1, db, inv_d);
  ue1 = cell_remap(ue1, h & mp, inv_p);
  ue2 = cell_remap(ue2, (h >> 8) & mp, inv_p);
  uh1 = cell_remap(uh1, da, inv_d);
  uh2 = cell_remap(uh2, db, inv_d);
}

// The hash key of the (sample, k, bounce) cell (rng.apply_bounce_strata);
// camera paths use k = CAMERA_STRATA_K.
__device__ __forceinline__ uint32_t bounce_key(uint32_t seed, uint32_t k,
                                               uint32_t bounce) {
  return seed + BOUNCE_OFFSET + k * STRATA_K_STEP + bounce * BOUNCE_STEP;
}

// A bounce's scatter uniforms (the u2 pair and the reflect/refract
// choice) moved into the cell of `key`.
__device__ __forceinline__ void bounce_cells(uint32_t key, int n_dir,
                                             float& ua, float& ub,
                                             float& uch) {
  uint32_t s = key;
  const uint32_t h = rand_u32(s);
  const uint32_t md = (uint32_t)n_dir - 1u;
  uint32_t a, b, c;
  if (n_dir <= 256) {
    a = h & md;
    b = (h >> 8) & md;
    c = (h >> 16) & md;
  } else {
    const uint32_t h2 = rand_u32(s);
    a = h & md;
    b = (h >> 16) & md;
    c = h2 & md;
  }
  const float inv = 1.0f / (float)n_dir;
  ua = cell_remap(ua, a, inv);
  ub = cell_remap(ub, b, inv);
  uch = cell_remap(uch, c, inv);
}

// Periodic lerp into one light's hero table, (n_seg + 1) rows of rgb over
// one period `delta` (spectra.hero_emission_lookup).
__device__ __forceinline__ V3 hero_lookup(const float* tab, int n_seg,
                                          float delta, float lam) {
  float t = (lam - F(380.0)) / delta;
  float u = (t - floorf(t)) * (float)n_seg;
  int i = min(max(__float2int_rz(u), 0), n_seg - 1);
  float f = u - (float)i;
  float g = 1.0f - f;
  const float* a = tab + 3 * i;
  return v3(a[0] * g + a[3] * f, a[1] * g + a[4] * f, a[2] * g + a[5] * f);
}

// ----- spectra (tpurt/ops/spectra.py) -----

// `cie`: the (N_CIE, 3) table of the launch, in shared or global memory
// (each lane has its own wavelength, so its own rows: constant memory
// would serve a warp one address at a time).
__device__ __forceinline__ V3 cie_to_rgb(const float* cie, float lam) {
  float t = (lam - F(380.0)) / F(5.0);
  int i = __float2int_rz(t);
  float f = t - (float)i;
  int a = min(max(i, 0), N_CIE - 1);
  int b = min(max(i + 1, 0), N_CIE - 1);
  float g = 1.0f - f;
  return v3(cie[3 * a] * g + cie[3 * b] * f,
            cie[3 * a + 1] * g + cie[3 * b + 1] * f,
            cie[3 * a + 2] * g + cie[3 * b + 2] * f);
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

// The first half of a sphere row, cx cy cz r2, in one 16-byte load. The
// rows are 32-byte aligned, in shared memory (the staged scene table) or
// in global memory (the table itself, the tree's rows).
__device__ __forceinline__ float4 sphere_geom(const float* sp) {
  return *reinterpret_cast<const float4*>(sp);
}

// Near root of the ray (o, d) on one sphere row (cx cy cz r2 mat mtype ior
// index), or MISS; a = |d|^2, inv_a = 1 / a.
__device__ __forceinline__ float sphere_t(const float* sp, V3 o, V3 d,
                                          float a, float inv_a) {
  const float4 g = sphere_geom(sp);
  V3 oc = v3(o.x - g.x, o.y - g.y, o.z - g.z);
  float half_b = vdot(oc, d);
  float c = vdot(oc, oc) - g.w;
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
  if (!(t < kMISS() && t <= b.t)) return;
  int index = (int)sp[7];  // read only for a candidate
  if (t < b.t || index < b.index) {
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
  const float4 g = sphere_geom(sp);
  V3 c0 = v3(g.x, g.y, g.z);
  V3 oc = v3(o.x - g.x, o.y - g.y, o.z - g.z);
  float half_b = vdot(oc, d);
  float c = vdot(oc, oc) - g.w;
  float disc = half_b * half_b - a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t0 = (-half_b - sq) * inv_a;
  float t1 = (-half_b + sq) * inv_a;
  bool overlap = disc > 0.0f && t1 > 0.0f && t0 < t_max;
  if (!overlap) return 1.0f;  // the row's second half is not read
  if ((int)sp[5] != 1) return 0.0f;
  float t_entry = fmaxf(t0, 0.0f);
  float t_exit = fminf(t1, t_max);
  bool segment = t_entry < t_exit;
  float lam_um = lam * F(1e-3);
  float eta = sp[6] + F(0.004) / (lam_um * lam_um);
  V3 n1 = vnormalize(vsub(vadd(o, vscale(d, t_entry)), c0), F(1e-30));
  float r1 = fr_dielectric(-vdot(n1, d), eta);
  V3 n2 = vnormalize(vsub(vadd(o, vscale(d, t_exit)), c0), F(1e-30));
  float r2 = fr_dielectric(-vdot(n2, d), eta);
  return segment ? (1.0f - r1) * (1.0f - r2) : 1.0f;
}

}  // namespace tpurt
