// The pool instance of the regen kernel (regen_pool_kernel): the uniform
// launches of a scene without triangles under the reference sampler and
// without emission, spawn or lights switches, which run path_pool.cuh's
// run_pool in place of run_pixels.
//
// Replaces, for those launches, the same TPU kernel as mega_regen.cu
// (tpurt/kernels/mega_regen.py:_make_regen_kernel, uniform mode), whose
// launcher calls launch_pool when its input shows the case; its plain
// PyTorch version is the regen kernel's (tpurt_torch/integrate.py
// render_plain), which it matches bit for bit on every state plane and
// in the ray count.
//
// What bounds it: not bytes (a 1080p sample moves ~133 MB of state in and
// out, against ~35 M traced segments) but the trips the warps take for
// those segments. The lockstep instance runs about 2.5 times the warp
// trips its segments need, because each phase costs a warp its longest
// lane; the pool fills every trip with live paths of one kind (path_pool.
// cuh). It lives in a module of its own, so that the instances of
// mega_regen.cu keep their machine code.

#include <cuda_runtime.h>

#include "path_pool.cuh"

namespace tpurt {

__global__ void __launch_bounds__(POOL_THREADS, POOL_MIN_BLOCKS)
    regen_pool_kernel(float* planes, const float* __restrict__ table,
                      const float* __restrict__ cie, int staged, int n_sph,
                      int n_mat, int n_light, SampleConsts c, Sampler S,
                      Geom geom, unsigned long long* __restrict__ counters,
                      unsigned long long* __restrict__ lanes) {
  extern __shared__ float4 smem4[];
  float* mem = reinterpret_cast<float*>(smem4);
  const Params prm = stage_scene<POOL_VIS>(mem, table, cie, staged, n_sph,
                                           n_mat, n_light, geom);
  unsigned long long rays = 0;
  run_pool<POOL_SLOTS>(planes, prm, S, c,
                       mem + CIE_FLOATS + (staged + 3) / 4 * 4, counters + 1,
                       rays, lanes);
  add_block_rays<POOL_THREADS / 32>(rays, counters);
}

int launch_pool(float* planes, const float* table, const float* cie,
                int staged, int n_sph, int n_mat, int n_light,
                const SampleConsts& c, const Sampler& S, const Geom& geom,
                unsigned long long* counters, unsigned long long* lanes,
                cudaStream_t stream) {
  return launch_persistent(regen_pool_kernel,
                           run_pixels_smem(staged, geom, POOL_THREADS,
                                           POOL_VIS),
                           (long long)c.width * c.height, stream, planes,
                           table, cie, staged, n_sph, n_mat, n_light, c, S,
                           geom, counters, lanes);
}

}  // namespace tpurt
