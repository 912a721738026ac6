// The wavefront pool's extend+shade sweep on Hopper: one thread per pool
// slot takes that slot's path one bounce further.
//
// Replaces tpurt's TPU kernel tpurt/kernels/wavefront_pallas.py:
// _make_sweep_kernel (launched by sweep_pallas) for sphere and mesh scenes
// with default flags. Its plain PyTorch version is tpurt_torch/wavefront.py:
// _sweep, which it matches bit for bit on every output plane.
//
// A bounce of an active slot: nearest hit; on a miss the path ends
// (black sky); on a hit, next-event estimation over every light (added at
// a diffuse hit), scatter + Russian roulette, and the depth gate
// bounce + 1 < depth. A slot whose path ends is marked terminated and keeps
// its radiance for the splat; the pool loop (tpurt_torch/wavefront.py)
// adds it to the image and refills the slot. Every active slot draws
// 2 * n_light + 4 numbers per sweep, hit or miss, as the plain version
// does for every lane; inactive slots keep their PCG state. Emission is
// recomputed from the slot's wavelength each sweep, as in the plain
// version (tpurt's TPU kernel precomputes it into pool planes at regen).
//
// Pool layout (Q slots): f32 planes (13, Q) o xyz | d xyz | tp rgb |
// rad rgb | lam; i32 planes (3, Q) pix | bounce | active; the PCG state as
// int64 (Q,) holding a uint32. Input and output are separate buffers.
//
// What bounds it: per slot it reads and writes ~80 bytes against one
// bounce of intersection tests, shadow segments and BSDF math, so compute and
// divergence (neighbouring slots hold unrelated paths of different
// materials) rather than bytes; the pool's regeneration keeps every slot
// busy, which is the point of the wavefront form. This first version does
// nothing about divergence (no sorting of slots by material).

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

enum PoolF { PF_O = 0, PF_D = 3, PF_TP = 6, PF_RAD = 9, PF_LAM = 12 };
enum PoolI { PI_PIX = 0, PI_BOUNCE = 1, PI_ACTIVE = 2 };

__global__ void __launch_bounds__(128)
    sweep_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
                 const long long* __restrict__ rng_in,
                 float* __restrict__ pf_out, int* __restrict__ pi_out,
                 long long* __restrict__ rng_out,
                 unsigned char* __restrict__ term, long long Q,
                 const float* __restrict__ table, int n_sph, int n_mat,
                 int n_light, int depth, float rr_thresh, Geom geom,
                 unsigned long long* __restrict__ rays_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long rays = 0;
  if (i < Q) {
    const float* f = pf + i;
    float* fo = pf_out + i;
    V3 o = v3(f[PF_O * Q], f[(PF_O + 1) * Q], f[(PF_O + 2) * Q]);
    V3 d = v3(f[PF_D * Q], f[(PF_D + 1) * Q], f[(PF_D + 2) * Q]);
    V3 tp = v3(f[PF_TP * Q], f[(PF_TP + 1) * Q], f[(PF_TP + 2) * Q]);
    V3 rad = v3(f[PF_RAD * Q], f[(PF_RAD + 1) * Q], f[(PF_RAD + 2) * Q]);
    const float lam = f[PF_LAM * Q];
    const int bounce = pi[PI_BOUNCE * Q + i];
    const bool active = pi[PI_ACTIVE * Q + i] != 0;
    long long rng_word = rng_in[i];
    bool cont = false;
    if (active) {
      const Params prm = scene_params(table, n_sph, n_mat, n_light, geom);
      uint32_t rng = (uint32_t)rng_word;
      rays += 1;
      Hit h = intersect(prm, o, d);
      if (h.t < kHIT()) {
        float em[3 * MAX_LIGHTS];
        light_emission(prm, lam, em);
        V3 o2 = o, d2 = d, tp2 = tp;
        cont = shade_camera_hit(prm, h, vneg(d), lam, em, rr_thresh, rng, o2,
                                d2, tp2, rad, rays) &&
               bounce + 1 < depth;
        if (cont) {
          o = o2;
          d = d2;
          tp = tp2;
        }
      } else {
        // a miss draws what a hit would: NEE and the scatter + RR step
        for (int k = 0; k < 2 * n_light + 4; ++k) rand_u32(rng);
      }
      rng_word = (long long)rng;
    }
    fo[PF_O * Q] = o.x; fo[(PF_O + 1) * Q] = o.y; fo[(PF_O + 2) * Q] = o.z;
    fo[PF_D * Q] = d.x; fo[(PF_D + 1) * Q] = d.y; fo[(PF_D + 2) * Q] = d.z;
    fo[PF_TP * Q] = tp.x; fo[(PF_TP + 1) * Q] = tp.y;
    fo[(PF_TP + 2) * Q] = tp.z;
    fo[PF_RAD * Q] = rad.x; fo[(PF_RAD + 1) * Q] = rad.y;
    fo[(PF_RAD + 2) * Q] = rad.z;
    fo[PF_LAM * Q] = lam;
    pi_out[PI_PIX * Q + i] = pi[PI_PIX * Q + i];
    pi_out[PI_BOUNCE * Q + i] = bounce + 1;
    pi_out[PI_ACTIVE * Q + i] = cont ? 1 : 0;
    rng_out[i] = rng_word;
    term[i] = (active && !cont) ? 1 : 0;
  }
  add_block_rays<4>(rays, rays_out);
}

}  // namespace tpurt

extern "C" int tpurt_wf_sweep_launch(
    const float* pf, const int* pi, const long long* rng, float* pf_out,
    int* pi_out, long long* rng_out, unsigned char* term, long long Q,
    const float* table, int n_sph, int n_mat, int n_light, int depth,
    float rr_thresh, const tpurt::Geom* geom, unsigned long long* rays,
    const float* cie_host, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(
      tpurt::c_cie, cie_host, sizeof(float) * tpurt::N_CIE * 3, 0,
      cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((Q + threads - 1) / threads);
  tpurt::sweep_kernel<<<blocks, threads, 0, s>>>(
      pf, pi, rng, pf_out, pi_out, rng_out, term, Q, table, n_sph, n_mat,
      n_light, depth, rr_thresh, *geom, rays);
  return (int)cudaGetLastError();
}
