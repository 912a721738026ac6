// The emission instances of the regen and tile-sync kernels: run_pixels'
// EMIT instances, with and without the G leaf, for launches with tpurt's
// emission besides the lights (the sky on a camera miss, emissive
// materials that end a camera path and absorb a photon, the per-sample
// radiance clamp).
//
// Replaces, for those flags, the same TPU kernels as mega_regen.cu (tpurt/
// kernels/mega_regen.py:_make_regen_kernel, both modes) and mega_step.cu
// (tpurt/kernels/mega_pallas.py:_make_kernel), whose launchers call
// launch_emit when they are given emission switches: the tile-sync kernel
// is the regen kernel's body at one sample, so one pair of instances serves
// both. Their plain PyTorch versions are those of the two kernels
// (tpurt_torch/integrate.py render_plain, render_plain_budget), which they
// match bit for bit on every state plane.
//
// They carry tpurt's sampler (S may leave its flags off): hero wavelengths
// average the sky's and the emission base's emission, which collapse with
// the lights' at a dispersive hit (tables n_light and n_light + 1 of the
// parameter table's hero block). They live in a module of their own:
// beside the flag-off instances in one module they changed how ptxas laid
// out some of those, whose machine code launches without the flags keep.
//
// What bounds them is what bounds the regen kernel; the emission costs a
// CIE lookup (or a hero-table lookup) on a miss or an emitter hit, and
// registers: they run at the sampler instances' cap (6 blocks an SM).

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

template <bool GLEAF>
__global__ void TPURT_REGEN_BOUNDS(true)
    regen_emit_kernel(float* planes, const float* __restrict__ table,
                      const float* __restrict__ cie, int staged, int n_sph,
                      int n_mat, int n_light, SampleConsts c, Sampler S,
                      Emission E, Geom geom,
                      unsigned long long* __restrict__ counters) {
  run_block<true, GLEAF, false, true>(planes, table, cie, staged, n_sph,
                                      n_mat, n_light, c, S, geom, counters,
                                      E);
}

int launch_emit(float* planes, const float* table, const float* cie,
                int staged, int n_sph, int n_mat, int n_light,
                const SampleConsts& c, const Sampler& S, const Emission& E,
                const Geom& geom, unsigned long long* counters,
                cudaStream_t stream) {
  auto kernel = geom.gmat ? regen_emit_kernel<true>
                          : regen_emit_kernel<false>;
  return launch_persistent(kernel, run_pixels_smem(staged, geom, 128),
                           (long long)c.width * c.height, stream, planes,
                           table, cie, staged, n_sph, n_mat, n_light, c, S, E,
                           geom, counters);
}

}  // namespace tpurt
