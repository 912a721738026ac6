// The regenerative SPPM megakernel on Hopper: persistent blocks whose
// lanes fetch pixels from a device counter and run all of a pixel's
// samples of a render call, one traced segment per trip of one flat loop.
//
// Replaces tpurt's TPU kernel tpurt/kernels/mega_regen.py:
// _make_regen_kernel (launched by regen_call), in both of its modes, with
// the device functions it inlines from tpurt/kernels/mega_pallas.py for
// sphere and mesh scenes: the sphere sweeps, nee_direct_c (mode "all";
// the others in path_lights.cu),
// scatter_rr_c, _diffuse_scatter_c, _scatter_dielectric_c,
// _scatter_metal_c, _evaluate_bsdf_c and _single_lambda_em_c, the hero
// lookup hero_em_lookup_c, tpurt's strata remaps (tpurt/ops/rng.py), and
// the triangle and sphere BVH walks of tpurt/kernels/bvh_pallas.py, whose
// counterparts it shares with the other path kernels (path.cuh, bvh.cuh).
//
// The body is path.cuh:run_pixels, which the tile-synchronized kernel
// (mega_step.cu) runs with one sample a pixel: the two kernels cannot
// drift apart. It is the counterpart of the TPU kernel's tile-wide while
// loop with spawn gates: there 128-lane vector tiles are kept busy by
// regenerating finished lanes in place; here each of a warp's 32 lanes is
// a state machine that holds one ray and its phase (camera bounce, or
// photon k at bounce b) and one trip of one flat loop traces one segment
// for it. A photon gathers only at its own pixel's vispoint, so pixels are
// independent and a lane that finishes one takes the next from a counter
// in global memory. Per pixel, the draws follow tpurt's per-(pixel,
// sample, phase, k) PCG streams and every float operation and sum keeps
// its order, so state planes and ray counts equal the plain version's bit
// for bit.
//
// Emission (tpurt's sky on a camera miss, emissive materials that end a
// camera path and absorb a photon, the per-sample radiance clamp) runs in
// the emission instances of path_emit.cu, which a launch takes when it
// passes `emission` (not null); tpurt's camera-spawn extensions (thin
// lens, shutter, Sobol spawn draws) and the photon roulette scale in the
// spawn instances of path_spawn.cu, which a launch takes when it passes
// `spawn`, with or without emission; tpurt's many-light NEE (light_sample
// "power", "spatial") and aimed photon emission (photon_aim) in the lights
// instances of path_lights.cu, which a launch takes when it passes
// `lights`, with or without the others.
//
// Uniform mode: every pixel takes `spp` samples from iteration `it0` and
// radius `radius0`. Budget mode (`aux` not null, tpurt's budget_mode, for
// adaptive sampling): pixel p takes aux[0][p] samples from its own count
// aux[1][p] (its n_samples) and its own radius aux[2][p]; `aux` is (3, P)
// float32 in the planes' pixel order. A pixel with budget 0 costs one
// fetch of the counter and touches no plane.
//
// State: (16, P) float32 planes in linear pixel order (rgb_sum 0-2, vis_pos
// 3-5, vis_norm 6-8, vis_wo 9-11, vis_tp 12-14, vis_mat 15), updated in
// place by the one lane that owns the pixel; pixels past width * height
// are never fetched. `counters`: two uint64 on the device, [0] the traced
// segments, added to (per thread in 64 bits, reduced per block, one
// atomicAdd per block: integer sums, so the count does not depend on the
// order blocks finish), [1] the work counter, which the caller zeroes on
// the launch's stream before every launch.
//
// What bounds it: not bytes (a 1080p launch moves ~133 MB of state in and
// out once, against tens of millions of traced segments) but divergence
// and latency. What the design does about them: the work fetch removes
// the wait for a warp's slowest pixel (budget mode: 18.8 -> 10.6 ms at
// 1080p on an H100 80GB HBM3 at 700 W); the camera, sphere, material and
// light rows and the CIE table are staged into shared memory once per
// block (a warp reads them at one address; stage_scene); the vispoint
// fields a gather needs wait in shared memory and the lights' emission is
// recomputed where it is added, so no array lives in local memory; scatter
// + roulette is one call site for camera and photon lanes. Whether a
// warp's lanes drift apart is a launch constant (`lockstep`, run_pixels):
// uniform launches keep warps in lockstep, which measured faster than free-running lanes on the H100 wherever rays
// walk a tree or the sampler makes them coherent; budget launches, whose
// pixels differ in sample count, never wait (PERF.md has the sweep). A
// lockstep warp waits for its longest path in each phase, and free-running
// lanes pay for it with incoherent rays and mixed shading: uniform launches
// on scenes without triangles, under the reference sampler and without
// emission, spawn or lights switches, run the pool instance instead
// (path_pool.cu: paths move between a block's warps through lists in
// shared memory, each trip one kind of step), and count its warp trips and
// busy lanes into `lanes` (two uint64 on the device, added to). What
// remains: no ray sorting.

#include <cuda_runtime.h>

#include "path_pool.cuh"

namespace tpurt {

// SAMPLER: the instance with tpurt's sampler flags (run_pixels). GLEAF:
// the instances with tpurt's G-matrix leaf test (pallas_mxu_leaf,
// geom.gmat set).
template <bool SAMPLER, bool GLEAF>
__global__ void TPURT_REGEN_BOUNDS(SAMPLER)
    regen_kernel(float* planes, const float* __restrict__ table,
                 const float* __restrict__ cie, int staged, int n_sph,
                 int n_mat, int n_light, SampleConsts c, Sampler S, Geom geom,
                 unsigned long long* __restrict__ counters) {
  run_block<SAMPLER, GLEAF>(planes, table, cie, staged, n_sph, n_mat, n_light,
                            c, S, geom, counters);
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
                                  unsigned long long* counters,
                                  const float* cie,
                                  const tpurt::Emission* emission,
                                  const tpurt::Spawn* spawn,
                                  const tpurt::Lights* lights,
                                  unsigned long long* lanes, void* stream) {
  using namespace tpurt;
  const SampleConsts c = {P, width, height, depth, k_photons,
                          max_photon_bounces, rr_thresh, photon_rr_thresh,
                          sppm_alpha, seed, spp, it0, radius0, aux,
                          /*lockstep=*/aux == nullptr};
  const int staged = staged_floats(n_sph, n_mat, n_light);
  if (lights)
    return launch_lights(planes, table, cie, staged, n_sph, n_mat, n_light,
                         c, *sampler, emission, spawn, *lights, *geom,
                         counters, static_cast<cudaStream_t>(stream));
  if (spawn)
    return launch_spawn(planes, table, cie, staged, n_sph, n_mat, n_light, c,
                        *sampler, emission, *spawn, *geom, counters,
                        static_cast<cudaStream_t>(stream));
  if (emission)
    return launch_emit(planes, table, cie, staged, n_sph, n_mat, n_light, c,
                       *sampler, *emission, *geom, counters,
                       static_cast<cudaStream_t>(stream));
  const bool on = sampler_on(*sampler);
  if (!aux && !on && geom->n_tri == 0)
    return launch_pool(planes, table, cie, staged, n_sph, n_mat, n_light, c,
                       *sampler, *geom, counters, lanes,
                       static_cast<cudaStream_t>(stream));
  auto kernel = geom->gmat ? (on ? regen_kernel<true, true>
                                 : regen_kernel<false, true>)
                           : (on ? regen_kernel<true, false>
                                 : regen_kernel<false, false>);
  return launch_persistent(kernel, run_pixels_smem(staged, *geom, 128),
                           (long long)width * height,
                           static_cast<cudaStream_t>(stream), planes, table,
                           cie, staged, n_sph, n_mat, n_light, c, *sampler,
                           *geom, counters);
}

extern "C" const char* tpurt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
