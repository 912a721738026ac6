// The lights instances of the regen and tile-sync kernels: run_pixels with
// an Emission, a Spawn and a Lights, for launches with tpurt's many-light
// next-event estimation (light_sample "power" or "spatial": one light a
// diffuse hit, chosen in proportion to its power, over the squared
// distance to its centre in "spatial", weighed by 1/pmf) or its aimed
// photon emission (photon_aim, photon_aim_widen: an area light's photon
// aims at the pixel's vispoint with probability q, weighed by the
// defensive mixture), either of them.
//
// Replaces, for those flags, the same TPU kernels as mega_regen.cu (tpurt/
// kernels/mega_regen.py:_make_regen_kernel, both modes: the light choice
// of its nee_direct_c call, mega_regen.py:638-648, and the aim of its
// photon spawn, mega_regen.py:435-510) and mega_step.cu (tpurt/kernels/
// mega_pallas.py:_make_kernel, the choice alone: tpurt has no aim there),
// whose launchers call launch_lights when they are given lights switches.
// Their plain PyTorch versions are those of the two kernels
// (tpurt_torch/integrate.py render_plain, render_plain_budget, with
// _nee_select and the aim in trace_photons), which they match bit for bit
// on every state plane.
//
// Two instances a leaf test, as path_spawn.cu has: regen_lights_kernel<
// false, GLEAF>, the reference sampler without emission, for launches with
// the lights flags alone (or with the spawn flags), under the reference
// instances' register cap (8 blocks an SM); regen_lights_kernel<true,
// GLEAF>, with tpurt's sampler and emission too (either may be off), under
// the sampler instances' cap (6). Both carry the spawn switches, all off
// where the launch has none. So a launch without the lights flags keeps
// the machine code it ran before they existed.
//
// What bounds them is what bounds the regen kernel. The choice costs two
// passes over the light rows a diffuse hit (a load and, in "spatial", a
// squared distance and a division a light each pass; the rows staged in
// shared memory up to path.cuh STAGE_MAX_FLOATS, else read from global
// memory); it saves the shadow segments of every other light. The aim
// costs a square root, a division, a sine and a cosine a photon of an area
// light.

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

template <bool SAMPLER, bool GLEAF>
__global__ void TPURT_REGEN_BOUNDS(SAMPLER)
    regen_lights_kernel(float* planes, const float* __restrict__ table,
                        const float* __restrict__ cie, int staged, int n_sph,
                        int n_mat, int n_light, SampleConsts c, Sampler S,
                        Emission E, const __grid_constant__ Spawn X,
                        Lights Lt, Geom geom,
                        unsigned long long* __restrict__ counters) {
  if constexpr (SAMPLER)
    run_block<true, GLEAF, false, true>(planes, table, cie, staged, n_sph,
                                        n_mat, n_light, c, S, geom, counters,
                                        E, X, Lt);
  else
    run_block<false, GLEAF>(planes, table, cie, staged, n_sph, n_mat,
                            n_light, c, S, geom, counters, E, X, Lt);
}

int launch_lights(float* planes, const float* table, const float* cie,
                  int staged, int n_sph, int n_mat, int n_light,
                  const SampleConsts& c, const Sampler& S, const Emission* E,
                  const Spawn* X, const Lights& Lt, const Geom& geom,
                  unsigned long long* counters, cudaStream_t stream) {
  const bool full = E || sampler_on(S);
  auto kernel = geom.gmat ? (full ? regen_lights_kernel<true, true>
                                  : regen_lights_kernel<false, true>)
                          : (full ? regen_lights_kernel<true, false>
                                  : regen_lights_kernel<false, false>);
  return launch_persistent(kernel, run_pixels_smem(staged, geom, 128),
                           (long long)c.width * c.height, stream, planes,
                           table, cie, staged, n_sph, n_mat, n_light, c, S,
                           emission_or_off(E), spawn_or_off(X), Lt, geom,
                           counters);
}

}  // namespace tpurt
