// A batch of rays against the scene geometry: the nearest hit and the
// shadow factor of each ray, by the walks and sweeps of bvh.cuh that the
// path kernels use. It lets the walks be held against their plain version
// (tpurt_torch/integrate.py intersect_scene and _shadow, brute-force
// sweeps) on rays of any distribution, without a path around them; the
// path kernels' results depend on the same two functions.
//
// Rays: o, d (3, N) float32 planes, t_max and lam (N,). Outputs: t (N,),
// loc and n (3, N), mat (N,) int32, atten (N,).

#include <cuda_runtime.h>

#include "bvh.cuh"

namespace tpurt {

__global__ void __launch_bounds__(128)
    probe_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max,
                 const float* __restrict__ lam, long long n,
                 const float* __restrict__ sph, int n_sph, Geom geom,
                 float* __restrict__ t_out, float* __restrict__ loc_out,
                 float* __restrict__ n_out, int* __restrict__ mat_out,
                 float* __restrict__ atten_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 ro = v3(o[i], o[n + i], o[2 * n + i]);
  const V3 rd = v3(d[i], d[n + i], d[2 * n + i]);
  Hit h = scene_hit(sph, n_sph, geom, ro, rd);
  t_out[i] = h.t;
  loc_out[i] = h.loc.x;
  loc_out[n + i] = h.loc.y;
  loc_out[2 * n + i] = h.loc.z;
  n_out[i] = h.n.x;
  n_out[n + i] = h.n.y;
  n_out[2 * n + i] = h.n.z;
  mat_out[i] = h.mat;
  atten_out[i] = scene_shadow(sph, n_sph, geom, ro, rd, t_max[i], lam[i]);
}

}  // namespace tpurt

extern "C" int tpurt_bvh_probe_launch(
    const float* o, const float* d, const float* t_max, const float* lam,
    long long n, const float* sph, int n_sph, const tpurt::Geom* geom,
    float* t, float* loc, float* nrm, int* mat, float* atten, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  tpurt::probe_kernel<<<blocks, threads, 0, s>>>(
      o, d, t_max, lam, n, sph, n_sph, *geom, t, loc, nrm, mat, atten);
  return (int)cudaGetLastError();
}
