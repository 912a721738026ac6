// The tile-synchronized SPPM megakernel on Hopper: one thread per pixel,
// exactly one progressive sample per launch.
//
// Replaces tpurt's TPU kernel tpurt/kernels/mega_pallas.py:_make_kernel
// (launched by megakernel_step, the backend="pallas", pallas_regen=False
// path of render_pallas and render_step_pallas). tpurt's kernel advances
// every pixel of a 128-lane tile by one sample: the tile waits for its
// longest camera path, then for the longest walk of each photon, with the
// host's seed and radius; the loop bound over the tile and the `anylive`
// exit are TPU scheduling. Here each thread runs its own pixel's sample to
// its end: the body is path.cuh:sample_pixel, the same function the regen
// kernel (mega_regen.cu) loops over, so the two kernels give the same
// state planes and ray counts bit for bit. The host (render.py) computes
// the frame seed, the strata seed and the SPPM radius of the sample and
// steps the radius between launches; the kernel does no radius step.
//
// State: the (16, P) float32 planes of mega_regen.cu, read once and
// written once, in place. What bounds it is what bounds the regen kernel
// (divergence, registers), plus one launch and one state round trip per
// sample where the regen kernel has one per call.

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

// SAMPLER: the instance with tpurt's sampler flags (sample_pixel). The
// reference instance is held to 64 registers (8 blocks of 128 threads an
// SM), the sampler instance to 80 (6 blocks): left free, the first takes
// 72 and runs ~5% slower, the second 115 and runs bench config 4 ~18%
// slower (H100 80GB HBM3, 700 W; PERF.md).
template <bool SAMPLER>
__global__ void __launch_bounds__(128, SAMPLER ? 6 : 8)
    step_kernel(float* __restrict__ planes, long long P, int width,
                int height, const float* __restrict__ table, int n_sph,
                int n_mat, int n_light, uint32_t seed, uint32_t strata_seed,
                int depth, float radius, int k_photons,
                int max_photon_bounces, float rr_thresh,
                float photon_rr_thresh, Sampler S, Geom geom,
                unsigned long long* __restrict__ rays_out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long rays = 0;
  if (idx < (long long)width * height) {
    const Params prm = scene_params(table, n_sph, n_mat, n_light, geom);
    const SampleConsts c = {table, width, height, depth, k_photons,
                            max_photon_bounces, rr_thresh, photon_rr_thresh};
    PixelState st = load_pixel(planes + idx, P);
    sample_pixel<SAMPLER>(prm, S, c, (uint32_t)(idx % width),
                          (uint32_t)(idx / width), seed, strata_seed, radius,
                          st, rays);
    store_pixel(planes + idx, P, st);
  }

  add_block_rays<4>(rays, rays_out);
}

}  // namespace tpurt

extern "C" int tpurt_step_launch(float* planes, long long P, int width,
                                 int height, const float* table, int n_sph,
                                 int n_mat, int n_light, unsigned int seed,
                                 unsigned int strata_seed, int depth,
                                 float radius, int k_photons,
                                 int max_photon_bounces, float rr_thresh,
                                 float photon_rr_thresh,
                                 const tpurt::Sampler* sampler,
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
  auto kernel = tpurt::sampler_on(*sampler) ? tpurt::step_kernel<true>
                                            : tpurt::step_kernel<false>;
  kernel<<<blocks, threads, 0, s>>>(
      planes, P, width, height, table, n_sph, n_mat, n_light, seed,
      strata_seed, depth, radius, k_photons, max_photon_bounces, rr_thresh,
      photon_rr_thresh, *sampler, *geom, rays);
  return (int)cudaGetLastError();
}
