// The fused wavefront on Hopper: one thread per pixel runs that pixel's
// camera paths back to back, spawning the next sample the moment a path
// dies, and adds each path's radiance into its own rgb_sum row.
//
// Replaces tpurt's TPU kernel tpurt/kernels/wavefront_pallas.py:
// _make_fused_kernel, in both of its launches: _fused_wavefront_jit (every
// pixel takes `spp` samples from iteration it0) and _fused_budget_jit
// (budget mode: pixel p takes budgets[p] samples from its own base count
// base_counts[p]), for sphere and mesh scenes with default flags. Its
// plain PyTorch versions are the pool renderers tpurt_torch/wavefront.py:
// wavefront_render and tpurt_torch/adaptive.py:wavefront_render_budget,
// which draw the same per-(pixel, sample) PCG streams, so ray counts are
// equal; the image differs only in the order each pixel's samples are
// summed (the pool adds them as paths finish).
//
// A sample: the frame seed (base_seed, sample iteration), the camera
// spawn (2 jitter draws, 1 wavelength draw), then up to `depth` bounces
// (nearest hit, NEE over every light, scatter + Russian roulette), as
// in the sweep kernel. Camera paths only: no vispoints, no photon pass.
//
// The TPU kernel keeps (R, 128) lane tiles busy with a tile-wide while
// loop and lax.cond spawn gates; on the GPU a pixel's samples are simply
// a loop in its thread. What bounds it: divergence, as in the regen
// kernel before its redesign: a warp runs until its longest sample chain
// ends. The state is read and written once per launch (12 bytes per
// pixel). The scene table and the CIE table are read from global memory;
// each thread's walk stack lies in dynamic shared memory.

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

__global__ void __launch_bounds__(128)
    fused_kernel(float* __restrict__ rgb, long long n_pix, int width,
                 int height, const float* __restrict__ table,
                 const float* __restrict__ cie, int n_sph,
                 int n_mat, int n_light, uint32_t base_seed, int spp,
                 int it0, const int* __restrict__ budgets,
                 const int* __restrict__ base_counts, int depth,
                 float rr_thresh, Geom geom,
                 unsigned long long* __restrict__ rays_out) {
  extern __shared__ int stacks[];
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long rays = 0;
  if (idx < n_pix) {
    const Params prm = scene_params(table, table, cie, n_sph, n_mat, n_light,
                                    geom, walk_stack(stacks, geom));
    const Sampler none = {};
    const uint32_t px = (uint32_t)(idx % width);
    const uint32_t py = (uint32_t)(idx / width);
    const int n = budgets ? budgets[idx] : spp;
    const int base = budgets ? base_counts[idx] : it0;
    float* row = rgb + 3 * idx;
    V3 acc = v3(row[0], row[1], row[2]);
    for (int smp = 0; smp < n; ++smp) {
      const uint32_t seed = frame_seed(base_seed, (uint32_t)(base + smp));
      uint32_t rng = seed_pixels(seed, px, py);
      V3 o, d;
      float lam;
      spawn_camera(table, px, py, width, height, rng, o, d, lam);
      V3 tp = v3(1.0f, 1.0f, 1.0f);
      V3 rad = v3(0.0f, 0.0f, 0.0f);
      for (int b = 0;; ++b) {
        rays += 1;
        Hit h = intersect(prm, o, d);
        if (!(h.t < kHIT())) break;
        bool cont = shade_camera_hit(prm, none, false, h, vneg(d), lam,
                                     rr_thresh, rng, o, d, tp, rad, rays);
        if (!(cont && b + 1 < depth)) break;
      }
      acc = vadd(acc, rad);
    }
    row[0] = acc.x;
    row[1] = acc.y;
    row[2] = acc.z;
  }
  add_block_rays<4>(rays, rays_out);
}

}  // namespace tpurt

extern "C" int tpurt_wf_fused_launch(
    float* rgb, long long n_pix, int width, int height, const float* table,
    int n_sph, int n_mat, int n_light, unsigned int seed, int spp, int it0,
    const int* budgets, const int* base_counts, int depth, float rr_thresh,
    const tpurt::Geom* geom, unsigned long long* rays, const float* cie,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n_pix + threads - 1) / threads);
  const size_t smem = tpurt::walk_stack_bytes(*geom, threads);
  cudaError_t err = cudaFuncSetAttribute(
      tpurt::fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tpurt::fused_kernel<<<blocks, threads, smem, s>>>(
      rgb, n_pix, width, height, table, cie, n_sph, n_mat, n_light, seed, spp,
      it0, budgets, base_counts, depth, rr_thresh, *geom, rays);
  return (int)cudaGetLastError();
}
