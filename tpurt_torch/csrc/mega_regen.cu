// The regenerative SPPM megakernel on Hopper: one thread per pixel runs
// all of that pixel's samples of a render call.
//
// Replaces tpurt's TPU kernel tpurt/kernels/mega_regen.py:
// _make_regen_kernel (launched by regen_call), with the device functions it
// inlines from tpurt/kernels/mega_pallas.py for sphere scenes:
// _closest_sphere_static, _shadow_static, nee_direct_c (mode "all"),
// scatter_rr_c, _diffuse_scatter_c, _scatter_dielectric_c,
// _scatter_metal_c, _evaluate_bsdf_c and _single_lambda_em_c, whose
// counterparts it shares with the wavefront kernels (path.cuh).
//
// A sample of a pixel: the camera path (up to `depth` bounces: nearest
// sphere, vispoint at the first diffuse hit, next-event estimation over
// every light, scatter + Russian roulette), then, if the pixel has a
// vispoint, K photon walks (light k % L, up to `max_photon_bounces`
// bounces) that add density-estimated radiance when they land within the
// SPPM radius of that vispoint, then the accumulation and the per-pixel
// radius step. A photon gathers only at its own pixel's vispoint, so the
// pixels are independent: the TPU kernel's tile-wide while loop, spawn
// gates and drift gate (which keep 128-lane vector tiles busy) have no
// counterpart here. Draws follow tpurt's per-(pixel, sample, phase, k)
// PCG streams exactly, so ray counts match the plain version.
//
// State: (16, P) float32 planes in linear pixel order (rgb_sum 0-2,
// vis_pos 3-5, vis_norm 6-8, vis_wo 9-11, vis_tp 12-14, vis_mat 15), read
// once and written once per launch, in place; threads past the last pixel
// do nothing. Traced segments are counted per thread in 64 bits, reduced
// per block and added with one atomicAdd per block: integer sums, so the
// count does not depend on the order blocks finish.
//
// What bounds it: not bytes (a 1080p launch moves ~133 MB of state in and
// out once, against tens of millions of traced segments) but divergence
// (neighbouring pixels follow paths of different length and material)
// and register pressure (path state, vispoint and per-light emission
// live across the whole sample loop). This first version takes neither
// into account: no path sorting or regrouping, scene tables read from
// global memory, emission in a local array.

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

__global__ void __launch_bounds__(128)
    regen_kernel(float* __restrict__ planes, long long P, int width,
                 int height, const float* __restrict__ table, int n_sph,
                 int n_mat, int n_light, uint32_t base_seed, int spp,
                 int it0, int depth, float radius0, int k_photons,
                 int max_photon_bounces, float rr_thresh,
                 float photon_rr_thresh, float sppm_alpha,
                 unsigned long long* __restrict__ rays_out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long rays = 0;
  if (idx < (long long)width * height) {
    const Params prm = scene_params(table, n_sph, n_mat, n_light);
    const uint32_t px = (uint32_t)(idx % width);
    const uint32_t py = (uint32_t)(idx / width);

    float* pl = planes + idx;
    V3 rgb = v3(pl[0], pl[P], pl[2 * P]);
    V3 vpos = v3(pl[3 * P], pl[4 * P], pl[5 * P]);
    V3 vnorm = v3(pl[6 * P], pl[7 * P], pl[8 * P]);
    V3 vwo = v3(pl[9 * P], pl[10 * P], pl[11 * P]);
    V3 vtp = v3(pl[12 * P], pl[13 * P], pl[14 * P]);
    float vmat = pl[15 * P];
    float radius = radius0;
    float em[3 * MAX_LIGHTS];

    for (int smp = 0; smp < spp; ++smp) {
      const uint32_t seed = frame_seed(base_seed, (uint32_t)(it0 + smp));
      // ---- camera spawn: 2 jitter draws, 1 wavelength draw
      uint32_t rng = seed_pixels(seed, px, py);
      V3 o, d;
      float lam;
      spawn_camera(table, px, py, width, height, rng, o, d, lam);
      light_emission(prm, lam, em);
      float lam_um = lam * F(1e-3);
      float cauchy_add = F(0.004) / (lam_um * lam_um);

      // ---- camera path
      V3 tp = v3(1.0f, 1.0f, 1.0f);
      V3 rad = v3(0.0f, 0.0f, 0.0f);
      bool vp_stored = false;
      for (int b = 0;; ++b) {
        rays += 1;
        Hit h = closest_sphere(prm.sph, n_sph, o, d);
        if (!(h.t < kHIT())) break;
        const float* m = prm.mat + h.mat * MAT_STRIDE;
        bool diffuse = (int)m[5] == 0;
        V3 wo = vneg(d);
        if (diffuse && !vp_stored) {
          vpos = h.loc;
          vnorm = h.n;
          vwo = wo;
          vtp = tp;
          vmat = (float)h.mat;
          vp_stored = true;
        }
        bool cont = shade_camera_hit(prm, h, wo, lam, em, rr_thresh, rng, o,
                                     d, tp, rad, rays);
        if (!(cont && b + 1 < depth)) break;
      }

      // ---- photon walks, gathered at this pixel's vispoint
      if (k_photons > 0 && sqrtf(vdot(vpos, vpos)) > F(0.001)) {
        const float* vm = prm.mat + (int)vmat * MAT_STRIDE;
        const V3 v_color = load3(vm);
        const float v_rough = vm[3];
        const float v_eta = vm[4] + cauchy_add;
        const int v_type = (int)vm[5];
        const float inv_pi_r2 =
            1.0f / fmaxf(F(3.141592653589793) * radius * radius, F(1e-10));
        for (int k = 0; k < k_photons; ++k) {
          uint32_t prng = photon_stream(seed, px, py, (uint32_t)k);
          float uc = rand_1f(prng);
          float up1 = rand_1f(prng);
          rand_1f(prng);  // drawn and unused, as in the reference layout
          float ue1 = rand_1f(prng);
          float ue2 = rand_1f(prng);
          float uh1 = rand_1f(prng);
          float uh2 = rand_1f(prng);
          const float* L = prm.light + (k % n_light) * LIGHT_STRIDE;
          V3 ph_o, ph_d;
          if ((int)L[L_TYPE] == 0) {
            float ct = 1.0f - uc * F(1.0 - 0.707);
            float stn = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
            float phi = kTWO_PI() * up1;
            float cphi = cosf(phi), sphi = sinf(phi);
            ph_d = v3(stn * cphi * L[L_CONE_T] + stn * sphi * L[L_CONE_B] +
                          ct * L[L_CONE_AXIS],
                      stn * cphi * L[L_CONE_T + 1] +
                          stn * sphi * L[L_CONE_B + 1] +
                          ct * L[L_CONE_AXIS + 1],
                      stn * cphi * L[L_CONE_T + 2] +
                          stn * sphi * L[L_CONE_B + 2] +
                          ct * L[L_CONE_AXIS + 2]);
            ph_o = load3(L + L_POS);
          } else {
            float su = (ue1 - 0.5f) * L[L_TWO_HW];
            float sv = (ue2 - 0.5f) * L[L_TWO_HW];
            ph_o = v3(
                L[L_PH_ORIGIN] + su * L[L_TANGENT] + sv * L[L_BITANGENT],
                L[L_PH_ORIGIN + 1] + su * L[L_TANGENT + 1] +
                    sv * L[L_BITANGENT + 1],
                L[L_PH_ORIGIN + 2] + su * L[L_TANGENT + 2] +
                    sv * L[L_BITANGENT + 2]);
            float theta = kTWO_PI() * uh1;
            float r_ = sqrtf(uh2);
            float x_ = r_ * cosf(theta);
            float y_ = r_ * sinf(theta);
            float z_ = sqrtf(fmaxf(1.0f - r_ * r_, 0.0f));
            ph_d = v3(x_ * L[L_TANGENT] + y_ * L[L_BITANGENT] +
                          z_ * L[L_NORMAL],
                      x_ * L[L_TANGENT + 1] + y_ * L[L_BITANGENT + 1] +
                          z_ * L[L_NORMAL + 1],
                      x_ * L[L_TANGENT + 2] + y_ * L[L_BITANGENT + 2] +
                          z_ * L[L_NORMAL + 2]);
          }
          V3 ph_tp = load3(L + L_PH_POWER);
          for (int b = 0;; ++b) {
            rays += 1;
            Hit h = closest_sphere(prm.sph, n_sph, ph_o, ph_d);
            if (!(h.t < kHIT())) break;
            V3 dvec = vsub(h.loc, vpos);
            float dist = sqrtf(fmaxf(vdot(dvec, dvec), 0.0f));
            if (dist < radius) {
              V3 f = evaluate_bsdf(vwo, vneg(ph_d), vnorm, v_color, v_rough,
                                   v_eta, v_type);
              float kern = (1.0f - dist / radius) * inv_pi_r2;
              rad = vadd(rad, vscale(vmul(vmul(vtp, f), ph_tp), kern));
            }
            bool cont = scatter_rr(prm, h.mat, vneg(ph_d), h.n, h.loc,
                                   cauchy_add, false, photon_rr_thresh,
                                   prng, ph_o, ph_d, ph_tp);
            if (!(cont && b + 1 < max_photon_bounces)) break;
          }
        }
      }

      // ---- accumulate, then the per-pixel SPPM radius step
      rgb = vadd(rgb, rad);
      float itf = (float)it0 + (float)(smp + 1);
      radius = radius * sqrtf((itf + sppm_alpha) / (itf + 1.0f));
    }

    pl[0] = rgb.x; pl[P] = rgb.y; pl[2 * P] = rgb.z;
    pl[3 * P] = vpos.x; pl[4 * P] = vpos.y; pl[5 * P] = vpos.z;
    pl[6 * P] = vnorm.x; pl[7 * P] = vnorm.y; pl[8 * P] = vnorm.z;
    pl[9 * P] = vwo.x; pl[10 * P] = vwo.y; pl[11 * P] = vwo.z;
    pl[12 * P] = vtp.x; pl[13 * P] = vtp.y; pl[14 * P] = vtp.z;
    pl[15 * P] = vmat;
  }

  add_block_rays<4>(rays, rays_out);
}

}  // namespace tpurt

extern "C" int tpurt_regen_launch(float* planes, long long P, int width,
                                  int height, const float* table, int n_sph,
                                  int n_mat, int n_light, unsigned int seed,
                                  int spp, int it0, int depth, float radius0,
                                  int k_photons, int max_photon_bounces,
                                  float rr_thresh, float photon_rr_thresh,
                                  float sppm_alpha,
                                  unsigned long long* rays,
                                  const float* cie_host, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(
      tpurt::c_cie, cie_host, sizeof(float) * tpurt::N_CIE * 3, 0,
      cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const long long n = (long long)width * height;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  tpurt::regen_kernel<<<blocks, threads, 0, s>>>(
      planes, P, width, height, table, n_sph, n_mat, n_light, seed, spp,
      it0, depth, radius0, k_photons, max_photon_bounces, rr_thresh,
      photon_rr_thresh, sppm_alpha, rays);
  return (int)cudaGetLastError();
}

extern "C" const char* tpurt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
