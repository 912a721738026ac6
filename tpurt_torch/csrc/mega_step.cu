// The tile-synchronized SPPM megakernel on Hopper: exactly one progressive
// sample of every pixel per launch.
//
// Replaces tpurt's TPU kernel tpurt/kernels/mega_pallas.py:_make_kernel
// (launched by megakernel_step, the backend="pallas", pallas_regen=False
// path of render_pallas and render_step_pallas). tpurt's kernel advances
// every pixel of a 128-lane tile by one sample: the tile waits for its
// longest camera path, then for the longest walk of each photon, with the
// host's seed and radius; the loop bound over the tile and the `anylive`
// exit are TPU scheduling. Here the launch is a thin launcher over
// path.cuh:run_pixels, the body of the regen kernel (mega_regen.cu), in
// uniform mode with one sample a pixel: the same persistent blocks, flat
// per-lane state machine, pixel fetch and shared-memory tables, so the two
// kernels give the same state planes and ray counts bit for bit and cannot
// drift apart. The sample's frame seed and strata seed are hashed on the
// device from (base_seed, iteration) as the regen kernel hashes them; the
// host (render.py) gives the SPPM radius of the sample and steps it
// between launches.
//
// State and `counters`: as in mega_regen.cu. What bounds it is what bounds
// the regen kernel, plus one launch and one state round trip per sample
// where the regen kernel has one per call.

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

// SAMPLER: the instance with tpurt's sampler flags, under the regen
// kernel's register caps.
template <bool SAMPLER>
__global__ void TPURT_REGEN_BOUNDS(SAMPLER)
    step_kernel(float* planes, const float* __restrict__ table,
                const float* __restrict__ cie, int staged, int n_sph,
                int n_mat, int n_light, SampleConsts c, Sampler S, Geom geom,
                unsigned long long* __restrict__ counters) {
  run_block<SAMPLER, false>(planes, table, cie, staged, n_sph, n_mat, n_light,
                            c, S, geom, counters);
}

}  // namespace tpurt

extern "C" int tpurt_step_launch(float* planes, long long P, int width,
                                 int height, const float* table, int n_sph,
                                 int n_mat, int n_light, unsigned int seed,
                                 int iteration, int depth, float radius,
                                 int k_photons, int max_photon_bounces,
                                 float rr_thresh, float photon_rr_thresh,
                                 const tpurt::Sampler* sampler,
                                 const tpurt::Geom* geom,
                                 unsigned long long* counters,
                                 const float* cie,
                                 const tpurt::Emission* emission,
                                 const tpurt::Spawn* spawn,
                                 const tpurt::Lights* lights, void* stream) {
  using namespace tpurt;
  // one sample: the radius step after it is the host's
  const SampleConsts c = {P, width, height, depth, k_photons,
                          max_photon_bounces, rr_thresh, photon_rr_thresh,
                          0.0f, seed, 1, iteration, radius, nullptr,
                          /*lockstep=*/true};
  const int staged = staged_floats(n_sph, n_mat, n_light);
  if (lights)  // the lights instances of path_lights.cu, one sample
    return launch_lights(planes, table, cie, staged, n_sph, n_mat, n_light,
                         c, *sampler, emission, spawn, *lights, *geom,
                         counters, static_cast<cudaStream_t>(stream));
  if (spawn)  // the spawn instances of path_spawn.cu, one sample
    return launch_spawn(planes, table, cie, staged, n_sph, n_mat, n_light, c,
                        *sampler, emission, *spawn, *geom, counters,
                        static_cast<cudaStream_t>(stream));
  if (emission)  // the emission instances of path_emit.cu, one sample
    return launch_emit(planes, table, cie, staged, n_sph, n_mat, n_light, c,
                       *sampler, *emission, *geom, counters,
                       static_cast<cudaStream_t>(stream));
  auto kernel = sampler_on(*sampler) ? step_kernel<true> : step_kernel<false>;
  return launch_persistent(kernel, run_pixels_smem(staged, *geom, 128),
                           (long long)width * height,
                           static_cast<cudaStream_t>(stream), planes, table,
                           cie, staged, n_sph, n_mat, n_light, c, *sampler,
                           *geom, counters);
}
