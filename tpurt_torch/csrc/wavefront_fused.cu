// The fused wavefront on Hopper: persistent blocks whose lanes fetch pixels
// from a device counter and run each pixel's camera-path samples, one
// traced segment per trip of one flat loop, adding each sample's radiance
// into the pixel's rgb_sum row.
//
// Replaces tpurt's TPU kernel tpurt/kernels/wavefront_pallas.py:
// _make_fused_kernel, in both of its launches: _fused_wavefront_jit (every
// pixel takes `spp` samples from iteration it0) and _fused_budget_jit
// (budget mode: pixel p takes budgets[p] samples from its own base count
// base_counts[p]), for sphere and mesh scenes, with tpurt's camera-path
// sampler flags (hero wavelengths, camera-path dispersion), emission
// (the sky or the legacy ramp on a miss, emissive materials, the
// per-sample radiance clamp), the camera-spawn extensions (thin lens,
// shutter, Sobol spawn draws indexed by the sample's iteration) and the
// many-light NEE modes (light_sample "power", "spatial"). Its
// plain PyTorch versions are the pool renderers tpurt_torch/wavefront.py:
// wavefront_render and tpurt_torch/adaptive.py:wavefront_render_budget,
// which draw the same per-(pixel, sample) PCG streams, so ray counts are
// equal; the image differs only in the order each pixel's samples are
// summed (the pool adds them as paths finish).
//
// A sample: the frame seed (base_seed, sample iteration), the camera
// spawn (2 jitter draws, 1 wavelength draw; in the spawn and lights
// instances path.cuh spawn_camera_ext's order), then up to `depth`
// bounces (nearest hit, NEE over every light or, in the lights instances,
// by their mode, scatter + Russian roulette). Camera
// paths only: no vispoints, no photon pass.
//
// Eight instances: fused_tail_kernel (fused_tail.cu), the uniform
// launches of TAIL_MIN_SPP samples a pixel or more under the reference
// sampler and without switches, bench config 5's still as shipped;
// fused_kernel, the reference sampler without emission for the other
// launches without switches (budget launches, fewer samples), which keep
// its machine code;
// fused_sampler_kernel<EMIT>, with the sampler flags (the hero's averaged
// emission until a dielectric collapses the path, the Cauchy IOR) and,
// with EMIT, the emission (run_pixels' EMIT); fused_spawn_kernel<SAMPLER>,
// with the camera-spawn extensions (run_pixels with a Spawn): <false> the
// reference sampler's body, for launches with the spawn flags alone,
// <true> with the sampler flags and the emission too (either may be off);
// fused_lights_kernel<SAMPLER>, the same pair with tpurt's many-light NEE
// (light_sample "power", "spatial": one light a diffuse hit, run_pixels
// with a Lights; the spawn switches may be all off). tpurt has no aimed
// photons here: the wavefront tracers trace none.
//
// The body is path.cuh:run_pixels in its camera-only instance (CAM), the
// machine of the regen and tile-sync kernels: persistent blocks sized to
// the SMs, pixels fetched from a device counter (one atomicAdd a warp),
// the scene rows and the CIE table staged in shared memory, each lane a
// state machine that traces one segment a trip. The TPU kernel keeps
// (R, 128) lane tiles busy with a tile-wide while loop and lax.cond spawn
// gates; here a lane whose sample ends spawns the next. A pixel is owned
// by one lane from fetch to store and its samples are added into its row in
// sample order, so the result is the one of one thread a pixel looping
// over its samples, and that of the regen kernel with photons off.
//
// What bounds it: divergence and latency, not bytes (the state is read and
// written once a sample, 12 bytes a pixel). What the design does about
// them: the work fetch removes the wait for a warp's slowest pixel (most
// in budget mode, where pixels differ in samples); uniform launches keep a
// warp's lanes in lockstep and budget launches let them drift apart
// (SampleConsts.lockstep, set from the mode as in the regen kernel:
// PERF.md has the A/B). A lockstep warp still waits for its longest path:
// on bench config 5 its lanes were busy in 70% of their trips, the idle
// ones in tail trips where a few stragglers chain through glass. So the
// tail instance (fused_tail.cuh) lets the rest of a warp start its next
// sample once at most a few of its lanes are on a path, the stragglers
// finishing theirs beside it, and fetches pixels for the whole warp at
// once: only the tails leave lockstep. A block-wide pool of the tails
// (its first design) and a pool for the whole kernel (path_pool.cuh) each
// cost more than lockstep loses here (PERF.md). It engages on observable
// input alone (aux null, spp at least TAIL_MIN_SPP, no switches;
// wavefront_fused.py tail_engages): budget launches already run free, a
// launch of few samples a pixel has few tails to take out, and the flag
// instances sit at their register caps.
//
// Modes: uniform (aux null: `spp` samples from iteration `it0`) and budget
// (aux (2, P) float32: pixel p takes aux[p] samples from its count
// aux[P + p]). `counters`: five uint64 on the device, zero before the
// launch: [0] the traced segments, [1] the work counter, [2] the warps'
// trips of the loop and [3] the lanes that traced a segment in them
// (shadow segments aside), so that [3] / (32 [2]) is the share of lanes at
// work, which lockstep lowers, and [4] the tail instance's tail segments:
// those of paths that went on after their warp moved on (which [3] counts
// too). Each warp keeps its counts in shared memory (path.cuh cam_tally,
// fused_tail.cuh's own words) and adds them once; no other instance of
// run_pixels counts them.

#include <cuda_runtime.h>

#include "fused_tail.cuh"

namespace tpurt {

__global__ void TPURT_REGEN_BOUNDS(false)
    fused_kernel(float* rgb, const float* __restrict__ table,
                 const float* __restrict__ cie, int staged, int n_sph,
                 int n_mat, int n_light, SampleConsts c, Geom geom,
                 unsigned long long* __restrict__ counters) {
  const Sampler none = {};
  run_block<false, false, true>(rgb, table, cie, staged, n_sph, n_mat,
                                n_light, c, none, geom, counters);
}

template <bool EMIT>
__global__ void TPURT_REGEN_BOUNDS(false)
    fused_sampler_kernel(float* rgb, const float* __restrict__ table,
                         const float* __restrict__ cie, int staged, int n_sph,
                         int n_mat, int n_light, SampleConsts c, Sampler S,
                         Emission E, Geom geom,
                         unsigned long long* __restrict__ counters) {
  run_block<true, false, true, EMIT>(rgb, table, cie, staged, n_sph, n_mat,
                                     n_light, c, S, geom, counters, E);
}

template <bool SAMPLER>
__global__ void TPURT_REGEN_BOUNDS(false)
    fused_spawn_kernel(float* rgb, const float* __restrict__ table,
                       const float* __restrict__ cie, int staged, int n_sph,
                       int n_mat, int n_light, SampleConsts c, Sampler S,
                       Emission E, const __grid_constant__ Spawn X,
                       Geom geom, unsigned long long* __restrict__ counters) {
  if constexpr (SAMPLER)
    run_block<true, false, true, true>(rgb, table, cie, staged, n_sph, n_mat,
                                       n_light, c, S, geom, counters, E, X);
  else
    run_block<false, false, true>(rgb, table, cie, staged, n_sph, n_mat,
                                  n_light, c, S, geom, counters, E, X);
}

template <bool SAMPLER>
__global__ void TPURT_REGEN_BOUNDS(false)
    fused_lights_kernel(float* rgb, const float* __restrict__ table,
                        const float* __restrict__ cie, int staged, int n_sph,
                        int n_mat, int n_light, SampleConsts c, Sampler S,
                        Emission E, const __grid_constant__ Spawn X,
                        Lights Lt, Geom geom,
                        unsigned long long* __restrict__ counters) {
  if constexpr (SAMPLER)
    run_block<true, false, true, true>(rgb, table, cie, staged, n_sph, n_mat,
                                       n_light, c, S, geom, counters, E, X,
                                       Lt);
  else
    run_block<false, false, true>(rgb, table, cie, staged, n_sph, n_mat,
                                  n_light, c, S, geom, counters, E, X, Lt);
}

}  // namespace tpurt

// `sampler`: the camera-path sampler flags; `emission`, `spawn`, `lights`:
// null, or the emission, the spawn and the lights switches. With none on,
// the reference instance runs.
extern "C" int tpurt_wf_fused_launch(
    float* rgb, long long P, int width, int height, const float* table,
    int n_sph, int n_mat, int n_light, unsigned int seed, int spp, int it0,
    const float* aux, int depth, float rr_thresh, const tpurt::Geom* geom,
    unsigned long long* counters, const float* cie,
    const tpurt::Sampler* sampler, const tpurt::Emission* emission,
    const tpurt::Spawn* spawn, const tpurt::Lights* lights, void* stream) {
  using namespace tpurt;
  const SampleConsts c = {P, width, height, depth, /*k_photons=*/0,
                          /*max_photon_bounces=*/0, rr_thresh,
                          /*photon_rr_thresh=*/0.0f, /*sppm_alpha=*/0.0f,
                          seed, spp, it0, /*radius0=*/0.0f, aux,
                          /*lockstep=*/aux == nullptr};
  const int staged = staged_floats(n_sph, n_mat, n_light);
  const size_t smem = run_pixels_smem(staged, *geom, 128, 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lights)
    return launch_persistent(
        emission || sampler_on(*sampler) ? fused_lights_kernel<true>
                                         : fused_lights_kernel<false>,
        smem, (long long)width * height, s, rgb, table, cie, staged, n_sph,
        n_mat, n_light, c, *sampler, emission_or_off(emission),
        spawn_or_off(spawn), *lights, *geom, counters);
  if (spawn)
    return launch_persistent(
        emission || sampler_on(*sampler) ? fused_spawn_kernel<true>
                                         : fused_spawn_kernel<false>,
        smem, (long long)width * height, s, rgb, table, cie, staged, n_sph,
        n_mat, n_light, c, *sampler, emission_or_off(emission), *spawn,
        *geom, counters);
  if (emission || sampler_on(*sampler)) {
    const Emission none = {};
    return launch_persistent(
        emission ? fused_sampler_kernel<true> : fused_sampler_kernel<false>,
        smem, (long long)width * height, s, rgb, table, cie, staged, n_sph,
        n_mat, n_light, c, *sampler, emission ? *emission : none, *geom,
        counters);
  }
  if (!aux && spp >= TAIL_MIN_SPP)
    return launch_fused_tail(rgb, table, cie, staged, n_sph, n_mat, n_light,
                             c, *geom, counters, s);
  return launch_persistent(fused_kernel, smem, (long long)width * height, s,
                           rgb, table, cie, staged, n_sph, n_mat, n_light, c,
                           *geom, counters);
}
