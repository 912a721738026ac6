// The spawn instances of the regen and tile-sync kernels: run_pixels with a
// Spawn, for launches with tpurt's camera-spawn extensions (the thin lens,
// the shutter of a MotionCamera, the Owen-scrambled Sobol spawn draws) or
// the photon walks' roulette scale (photon_rr_scale), any of them.
//
// Replaces, for those flags, the same TPU kernels as mega_regen.cu (tpurt/
// kernels/mega_regen.py:_make_regen_kernel, both modes) and mega_step.cu
// (tpurt/kernels/mega_pallas.py:_make_kernel), whose launchers call
// launch_spawn when they are given spawn switches, as path_emit.cu's
// instances serve them for emission. Their plain PyTorch versions are
// those of the two kernels (tpurt_torch/integrate.py render_plain,
// render_plain_budget), which they match bit for bit on every state plane.
//
// Two instances a leaf test: regen_spawn_kernel<false, GLEAF>, the
// reference sampler without emission, for launches with the spawn flags
// alone, under the reference instances' register cap (8 blocks an SM);
// regen_spawn_kernel<true, GLEAF>, with tpurt's sampler (S may leave its
// flags off) and emission (E may be all off) too, as tpurt's "quality" and
// "fast" presets (hero wavelengths and the Sobol spawn) need, under the
// sampler instances' cap (6). So a launch with emission and no spawn flag
// keeps path_emit.cu's instance, one with the spawn flags and nothing else
// the reference sampler's body, and no launch pays for code it does not
// run beyond one of the two. They live in a module of their own for the
// reason path_emit.cu's do: the flag-off instances' machine code.
//
// What bounds them is what bounds the regen kernel; the spawn costs a few
// dozen operations a sample (up to 6 Sobol draws, each a fold of the
// index's bits over a direction table read through the cache, and a hash;
// the lens's square roots, sine and cosine).

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

template <bool SAMPLER, bool GLEAF>
__global__ void TPURT_REGEN_BOUNDS(SAMPLER)
    regen_spawn_kernel(float* planes, const float* __restrict__ table,
                       const float* __restrict__ cie, int staged, int n_sph,
                       int n_mat, int n_light, SampleConsts c, Sampler S,
                       Emission E, const __grid_constant__ Spawn X,
                       Geom geom, unsigned long long* __restrict__ counters) {
  if constexpr (SAMPLER)
    run_block<true, GLEAF, false, true>(planes, table, cie, staged, n_sph,
                                        n_mat, n_light, c, S, geom, counters,
                                        E, X);
  else
    run_block<false, GLEAF>(planes, table, cie, staged, n_sph, n_mat,
                            n_light, c, S, geom, counters, E, X);
}

int launch_spawn(float* planes, const float* table, const float* cie,
                 int staged, int n_sph, int n_mat, int n_light,
                 const SampleConsts& c, const Sampler& S, const Emission* E,
                 const Spawn& X, const Geom& geom,
                 unsigned long long* counters, cudaStream_t stream) {
  const bool full = E || sampler_on(S);
  auto kernel = geom.gmat ? (full ? regen_spawn_kernel<true, true>
                                  : regen_spawn_kernel<false, true>)
                          : (full ? regen_spawn_kernel<true, false>
                                  : regen_spawn_kernel<false, false>);
  return launch_persistent(kernel, run_pixels_smem(staged, geom, 128),
                           (long long)c.width * c.height, stream, planes,
                           table, cie, staged, n_sph, n_mat, n_light, c, S,
                           emission_or_off(E), X, geom, counters);
}

}  // namespace tpurt
