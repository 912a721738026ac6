// The regenerative SPPM megakernel on Hopper: one thread per pixel runs
// all of that pixel's samples of a render call.
//
// Replaces tpurt's TPU kernel tpurt/kernels/mega_regen.py:
// _make_regen_kernel (launched by regen_call), in both of its modes, with
// the device functions it inlines from tpurt/kernels/mega_pallas.py for
// sphere and mesh scenes: the sphere sweeps, nee_direct_c (mode "all"),
// scatter_rr_c, _diffuse_scatter_c, _scatter_dielectric_c,
// _scatter_metal_c, _evaluate_bsdf_c and _single_lambda_em_c, the hero
// lookup hero_em_lookup_c, tpurt's strata remaps (tpurt/ops/rng.py), and
// the triangle and sphere BVH walks of tpurt/kernels/bvh_pallas.py, whose
// counterparts it shares with the other path kernels (path.cuh, bvh.cuh).
//
// A sample of a pixel is path.cuh:sample_pixel, the body the
// tile-synchronized kernel (mega_step.cu) runs once per launch: the two
// kernels cannot drift apart. Between samples the per-pixel SPPM radius
// steps. A photon gathers only at its own pixel's vispoint, so the pixels
// are independent: the TPU kernel's tile-wide while loop, spawn gates and
// drift gate (which keep 128-lane vector tiles busy) have no counterpart
// here. Draws follow tpurt's per-(pixel, sample, phase, k) PCG streams
// exactly, so ray counts match the plain version.
//
// Uniform mode: every pixel takes `spp` samples from iteration `it0` and
// radius `radius0`. Budget mode (`aux` not null, tpurt's budget_mode, for
// adaptive sampling): pixel p takes aux[0][p] samples from its own count
// aux[1][p] (its n_samples) and its own radius aux[2][p]; `aux` is (3, P)
// float32 in the planes' pixel order.
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

// SAMPLER: the instance with tpurt's sampler flags (sample_pixel). The
// reference instance is held to 64 registers (8 blocks of 128 threads an
// SM), the sampler instance to 80 (6 blocks): left free, the first takes
// 72 and runs ~5% slower, the second 115 and runs bench config 4 ~18%
// slower (H100 80GB HBM3, 700 W; PERF.md). GLEAF: the instances with
// tpurt's G-matrix leaf test (pallas_mxu_leaf, geom.gmat set), under the
// same bounds; the GLEAF false instances compile as they did without it.
template <bool SAMPLER, bool GLEAF>
__global__ void __launch_bounds__(128, SAMPLER ? 6 : 8)
    regen_kernel(float* __restrict__ planes, long long P, int width,
                 int height, const float* __restrict__ table, int n_sph,
                 int n_mat, int n_light, uint32_t base_seed, int spp,
                 int it0, int depth, float radius0, int k_photons,
                 int max_photon_bounces, float rr_thresh,
                 float photon_rr_thresh, float sppm_alpha, Sampler S,
                 const float* __restrict__ aux, Geom geom,
                 unsigned long long* __restrict__ rays_out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long rays = 0;
  if (idx < (long long)width * height) {
    const Params prm = scene_params(table, n_sph, n_mat, n_light, geom);
    const SampleConsts c = {table, width, height, depth, k_photons,
                            max_photon_bounces, rr_thresh, photon_rr_thresh};
    const uint32_t px = (uint32_t)(idx % width);
    const uint32_t py = (uint32_t)(idx / width);
    PixelState st = load_pixel(planes + idx, P);
    int n_smp = spp;
    int base = it0;
    float base_f = (float)it0;
    float radius = radius0;
    if (aux) {  // budget mode: the pixel's own budget, count and radius
      n_smp = (int)rintf(aux[idx]);
      base_f = aux[P + idx];
      base = (int)rintf(base_f);
      radius = aux[2 * P + idx];
    }
    for (int smp = 0; smp < n_smp; ++smp) {
      const uint32_t it = (uint32_t)(base + smp);
      const uint32_t seed = frame_seed(base_seed, it);
      // strata epoch: samples in one window share their cells
      const uint32_t strata_seed =
          SAMPLER && S.window > 1
              ? frame_seed(base_seed, it & ~(uint32_t)(S.window - 1))
              : seed;
      sample_pixel<SAMPLER, GLEAF>(prm, S, c, px, py, seed, strata_seed,
                                   radius, st, rays);
      // the per-pixel SPPM radius step
      float itf = base_f + (float)(smp + 1);
      radius = radius * sqrtf((itf + sppm_alpha) / (itf + 1.0f));
    }
    store_pixel(planes + idx, P, st);
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
                                  const tpurt::Sampler* sampler,
                                  const float* aux,
                                  const tpurt::Geom* geom,
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
  const bool on = tpurt::sampler_on(*sampler);
  auto kernel = geom->gmat ? (on ? tpurt::regen_kernel<true, true>
                                 : tpurt::regen_kernel<false, true>)
                           : (on ? tpurt::regen_kernel<true, false>
                                 : tpurt::regen_kernel<false, false>);
  kernel<<<blocks, threads, 0, s>>>(
      planes, P, width, height, table, n_sph, n_mat, n_light, seed, spp,
      it0, depth, radius0, k_photons, max_photon_bounces, rr_thresh,
      photon_rr_thresh, sppm_alpha, *sampler, aux, *geom, rays);
  return (int)cudaGetLastError();
}

extern "C" const char* tpurt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
