// The tail instance of the fused wavefront kernel on Hopper: the uniform
// launches of several samples a pixel under the reference sampler and
// without emission, spawn or lights switches (bench config 5 as shipped),
// with a warp's last few straggling paths of a sample finished in their
// own lanes while the rest of the warp starts its next sample
// (fused_tail.cuh run_tail).
//
// Replaces, for those launches, tpurt's TPU kernel
// tpurt/kernels/wavefront_pallas.py:_make_fused_kernel in its uniform
// launch _fused_wavefront_jit, as fused_kernel (wavefront_fused.cu) does
// for the others. Its plain PyTorch version is the pool renderer
// tpurt_torch/wavefront.py:wavefront_render, which draws the same
// per-(pixel, sample) PCG streams; the kernel's rgb_sum and ray count equal
// fused_kernel's and the regen kernel's with photons off bit for bit.
//
// What bounds it: divergence and latency, not bytes (12 bytes a pixel
// read and written once). A lockstep warp waits for its longest path, and
// on bench config 5 kept 69.95% of its lanes busy a trip, a quarter of its
// trips carrying 8 lanes or fewer (PERF.md). What the design does about
// it: once at most TAIL_LANES lanes of a warp are on a path, the others
// start their next sample; the fetch of 32 consecutive pixels once the
// whole warp is free keeps its rays coherent.
//
// The engagement rule is the C launcher's (tpurt_wf_fused_launch: no
// lights, spawn, emission or sampler switches, aux null, spp at least
// TAIL_MIN_SPP), mirrored by
// tpurt_torch/kernels/wavefront_fused.py:tail_engages and named by
// mega_regen.kernel_instance. Budget launches run free and have no
// lockstep tails; a launch of few samples a pixel has few tails to take
// out and keeps the warp's wait at each pixel's end; the flag instances
// sit at their register caps with spills: each keeps fused_kernel or its
// flag instance. Sphere and mesh scenes both take it (its walks use the
// dynamic shared memory fused_kernel's do; on the torus it gained too,
// PERF.md).

#include <cuda_runtime.h>

#include "fused_tail.cuh"

namespace tpurt {

__global__ void TPURT_REGEN_BOUNDS(false)
    fused_tail_kernel(float* rgb, const float* __restrict__ table,
                      const float* __restrict__ cie, int staged, int n_sph,
                      int n_mat, int n_light, SampleConsts c, Geom geom,
                      unsigned long long* __restrict__ counters) {
  extern __shared__ float4 smem4[];
  float* mem = reinterpret_cast<float*>(smem4);
  const Params prm = stage_scene<0>(mem, table, cie, staged, n_sph, n_mat,
                                    n_light, geom);
  unsigned long long rays = 0;
  run_tail(rgb, prm, c, counters + 1, rays);
  add_block_rays<TAIL_WARPS>(rays, counters);
}

int launch_fused_tail(float* rgb, const float* table, const float* cie,
                      int staged, int n_sph, int n_mat, int n_light,
                      const SampleConsts& c, const Geom& geom,
                      unsigned long long* counters, cudaStream_t stream) {
  return launch_persistent(fused_tail_kernel,
                           run_pixels_smem(staged, geom, 32 * TAIL_WARPS, 0),
                           (long long)c.width * c.height, stream, rgb, table,
                           cie, staged, n_sph, n_mat, n_light, c, geom,
                           counters);
}

}  // namespace tpurt
