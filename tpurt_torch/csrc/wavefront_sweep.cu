// One sweep of the wavefront pool on Hopper, whole: regeneration, one
// extend+shade bounce and the splat in one launch, with the pool loop's
// test evaluated on the device, so sweeps follow one another with no host
// work between them.
//
// Replaces tpurt's TPU kernel tpurt/kernels/wavefront_pallas.py:
// _make_sweep_kernel (launched by sweep_pallas) for sphere and mesh scenes,
// with tpurt's camera-path sampler flags and emission, together with the
// XLA stages tpurt keeps around it in
// its pool loop (_wavefront_pallas_jit's while_loop: _regen_planar, the
// splat's scatter-adds, the loop test). Its plain PyTorch version is
// tpurt_torch/wavefront.py:_step (_regen or _regen_budget, then _sweep,
// then the splat), which it matches bit for bit on every pool plane, the
// control words and the ray count; rgb_sum and n_samples are added with
// atomics, so where two paths of one pixel end in one sweep their order,
// and the last bits of rgb_sum, may differ.
//
// A sweep, in a launch that finds the loop test true (else it returns at
// once and counts nothing):
// - regeneration: a dead slot claims the work item of its rank among the
//   dead slots (the plain version's cumsum), in one of two enumerations:
//   uniform (work item w -> sample w / n_pix, pixel w % n_pix, as a
//   (next_sample, next_pix) counter pair) or budget (round-major over
//   per-pixel budgets: round s = the first with cum[s] > w, pixel
//   order[w - cum[s-1]]), and becomes a camera ray: frame seed, 2 jitter
//   draws, the pinhole ray, 1 wavelength draw (in the spawn instances
//   with the shutter and lens draws between, from the Sobol stream under
//   qmc: path.cuh spawn_camera_ext);
// - the bounce of every active slot: nearest hit; on a miss the path ends
//   (a black sky, or the sky or the legacy ramp with emission); on a hit,
//   next-event estimation over every light (added at a diffuse hit),
//   scatter + Russian roulette, the depth gate bounce + 1 < depth; an
//   emissive hit instead adds its emission and ends the path. Every
//   active slot draws 2 * n_light + 4 numbers, whatever it hits, as the
//   plain version does for every lane. Emission is recomputed from the
//   slot's wavelength with the CIE table in shared memory (tpurt's TPU
//   kernel precomputes it into pool planes at regen, one set of planes per
//   emitter that its collapse rewrites); a slot keeps only its collapse
//   bit, beside its active flag;
// - the splat: a slot whose path ended adds its radiance (capped by the
//   radiance clamp) into rgb_sum[pix] and 1 into n_samples[pix];
// - the loop's control words: the next work item, the sweep count, and
//   the test of the next sweep, (work pending or a slot active) and
//   sweeps < max_sweeps.
// A dead slot that claims no work is not read past its active flag, and
// not written.
//
// The rank among dead slots is a scan over the pool, done in the launch:
// blocks take chunks of 128 slots in ticket order; a chunk publishes its
// dead count, then its inclusive prefix once the chunks before it are
// summed (Merrill and Garland's decoupled look-back, a warp reading 32
// predecessors at a time). The last block to finish closes the sweep: it
// updates the control words and clears the chunks' words for the next
// launch.
//
// Pool layout (Q slots), updated in place: f32 planes (13, Q) o xyz |
// d xyz | tp rgb | rad rgb | lam; i32 planes (3, Q) pix | bounce | state
// (0 dead, else 1 | COLLAPSED); the PCG state as int64 (Q,) holding a
// uint32. Control words: int64, wavefront.py CTL_*, then one look-back
// word a chunk, all zero between launches past C_RAYS.
//
// Five instances of pool_step_kernel: pool_step_kernel<> (no template
// arguments), the reference sampler without emission, as bench config 5
// ships, whose machine code is what it was before the others existed;
// <true, false, Sampler, Emission>, with the sampler flags (hero
// wavelengths, whose averaged emission a dielectric collapses to the
// hero's under camera-path dispersion, and the Cauchy IOR); <true, true,
// Sampler, Emission>, with the emission too; and the spawn instances,
// with the camera-spawn extensions (thin lens, shutter, Sobol spawn
// draws): <false, false, Sampler, Emission, Spawn> on the reference
// bounce, for launches with the spawn flags alone, and <true, true,
// Sampler, Emission, Spawn> with the sampler flags and the emission
// (either may be off); and the lights instances, the same pair with a
// Lights after the Spawn (whose switches may then be all off), for
// tpurt's many-light NEE (light_sample "power", "spatial": one light a
// diffuse hit, 3 draws a bounce where "all" draws 2 a light).

#include <cuda_runtime.h>

#include "path.cuh"

namespace tpurt {

enum PoolF { PF_O = 0, PF_D = 3, PF_TP = 6, PF_RAD = 9, PF_LAM = 12 };
enum PoolI { PI_PIX = 0, PI_BOUNCE = 1, PI_ACTIVE = 2 };
constexpr int COLLAPSED = 2;  // the state word's collapse bit
// control words (tpurt_torch/wavefront.py CTL_*): the loop's state, then
// the launch's scratch, zero between launches
enum Ctl {
  C_SWEEPS = 0, C_NEXT = 1, C_NEXT_PIX = 2, C_GO = 3, C_RAYS = 4,
  C_TICKET = 5, C_DONE = 6, C_DEAD = 7, C_ALIVE = 8, C_WORDS = 9
};
constexpr int CHUNK = 128;  // slots a block ranks at once: its threads
constexpr unsigned long long LB_AGG = 1ull << 62;  // the chunk's own count
constexpr unsigned long long LB_PRE = 2ull << 62;  // its inclusive prefix
constexpr unsigned long long LB_VAL = (1ull << 62) - 1;

// The launch constants of a sweep (tpurt_torch/kernels/wavefront_sweep.py
// PoolArgs): the pool, the image, and the work enumeration.
struct PoolWork {
  long long Q;
  long long max_sweeps;
  // uniform: samples per pixel, their first iteration, the slab
  long long spp, it0, pix_offset, n_valid;
  // budget (cum not null): pixels in descending-budget order, cumulative
  // pixels per round (n_cum rounds), each state row's sample count
  const long long* order;
  const long long* cum;
  const long long* base_counts;
  int n_cum;
  int width, height, depth;
  float rr_thresh;
  unsigned int base_seed;
};

__device__ __forceinline__ long long ld_volatile(const long long* p) {
  return *reinterpret_cast<const volatile long long*>(p);
}

// The exclusive prefix of chunk `chunk`'s dead slots over the chunks
// before it; publishes the chunk's count `agg` and then its inclusive
// prefix. Called by the 32 lanes of one warp.
__device__ __forceinline__ long long look_back(unsigned long long* words,
                                               long long chunk, int agg) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* w = words;
  if (chunk == 0) {
    if (lane == 0) w[0] = LB_PRE | (unsigned long long)agg;
    return 0;
  }
  if (lane == 0) w[chunk] = LB_AGG | (unsigned long long)agg;
  long long excl = 0;
  for (long long j = chunk - 1 - lane;; j -= 32) {
    unsigned long long s = LB_PRE;  // before chunk 0: a prefix of 0
    if (j >= 0) {
      do {
        s = w[j];
      } while (s == 0);
    }
    // lane 0 reads the nearest chunk: sum up to the nearest prefix
    const unsigned pre = __ballot_sync(FULL, (s & LB_PRE) != 0);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    long long v = (lane <= stop && j >= 0) ? (long long)(s & LB_VAL) : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    excl += __shfl_sync(FULL, v, 0);
    if (pre) break;
  }
  if (lane == 0) w[chunk] = LB_PRE | (unsigned long long)(excl + agg);
  return excl;
}

// Round s of budget work item wk: the first s with cum[s] > wk.
__device__ __forceinline__ int budget_round(const long long* cum, int n,
                                            long long wk) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] > wk)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// The switches of the sampler instances' `sw` (Sampler, Emission) and of
// the spawn instances' (Sampler, Emission, Spawn).
__device__ __forceinline__ const Emission& emission(const Sampler&,
                                                    const Emission& E) {
  return E;
}
__device__ __forceinline__ const Sampler& sampler_of(const Sampler& S,
                                                     const Emission&,
                                                     const Spawn&) {
  return S;
}
__device__ __forceinline__ const Emission& emission(const Sampler&,
                                                    const Emission& E,
                                                    const Spawn&) {
  return E;
}
__device__ __forceinline__ const Spawn& spawn_of(const Sampler&,
                                                 const Emission&,
                                                 const Spawn& X) {
  return X;
}
// ... and of the lights instances' (Sampler, Emission, Spawn, Lights).
__device__ __forceinline__ const Sampler& sampler_of(const Sampler& S,
                                                     const Emission&,
                                                     const Spawn&,
                                                     const Lights&) {
  return S;
}
__device__ __forceinline__ const Emission& emission(const Sampler&,
                                                    const Emission& E,
                                                    const Spawn&,
                                                    const Lights&) {
  return E;
}
__device__ __forceinline__ const Spawn& spawn_of(const Sampler&,
                                                 const Emission&,
                                                 const Spawn& X,
                                                 const Lights&) {
  return X;
}
__device__ __forceinline__ const Lights& lights_of(const Sampler&,
                                                   const Emission&,
                                                   const Spawn&,
                                                   const Lights& Lt) {
  return Lt;
}

// The bounce of an active slot in the sampler instances: on a hit,
// next-event estimation with the hero-averaged emission until the slot
// collapses (a dielectric under camera-path dispersion, which also bends
// the path by the Cauchy IOR), scatter + Russian roulette and the depth
// gate; with EMIT, a miss adds the sky (or the legacy ramp) and an
// emissive hit its emission, and both end the path drawing what a hit
// would. Returns whether the path goes on, its ray in (o, d, tp). `lt`:
// the lights instance's Lights (next-event estimation by its mode), or
// none.
template <bool EMIT, class... Lt>
__device__ __forceinline__ bool sampled_bounce(
    const Params& prm, const Sampler& S, const Emission& E, const Hit& h,
    float lam, const PoolWork& w, int bounce, int n_light, uint32_t& rng,
    bool& coll, V3& o, V3& d, V3& tp, V3& rad, unsigned long long& rays,
    const Lt&... lt) {
  const bool hero = S.hero > 1 && !coll;
  const int mtype =
      h.t < kHIT() ? (int)prm.mat()[h.mat * MAT_STRIDE + 5] : -1;
  if (h.t < kHIT() && !(EMIT && mtype == 3)) {
    V3 o2 = o, d2 = d, tp2 = tp;
    float eta_add = 0.0f;
    if (S.disp_cam) {
      const float lam_um = lam * F(1e-3);
      eta_add = F(0.004) / (lam_um * lam_um);
    }
    bool cont;
    if constexpr (sizeof...(Lt) == 1)
      cont = shade_camera_hit_sel<true>(prm, S, lt..., hero, h, vneg(d), lam,
                                        w.rr_thresh, rng, o2, d2, tp2, rad,
                                        rays, eta_add) &&
             bounce + 1 < w.depth;
    else
      cont = shade_camera_hit<true>(prm, S, hero, h, vneg(d), lam,
                                    w.rr_thresh, rng, o2, d2, tp2, rad, rays,
                                    eta_add) &&
             bounce + 1 < w.depth;
    // a dielectric steers the path by eta(lam): only the hero goes on
    if (S.collapse && mtype == 1) coll = true;
    if (cont) {
      o = o2;
      d = d2;
      tp = tp2;
    }
    return cont;
  }
  if constexpr (EMIT)
    rad = mtype == 3 ? add_emitter<true>(prm, S, hero, h.mat, lam, tp, rad)
                     : add_sky<true>(prm, S, E, hero, lam, d, tp, rad);
  // a miss or an emitter draws what a hit would: NEE and the scatter + RR
  if constexpr (sizeof...(Lt) == 1) {
    for (int k = 0; k < nee_draws(lt..., n_light) + 4; ++k) rand_u32(rng);
  } else {
    for (int k = 0; k < 2 * n_light + 4; ++k) rand_u32(rng);
  }
  return false;
}

// One sweep. The instance without template arguments is the reference
// sampler without emission and takes nothing more; the sampler instances
// (SAMPLER) take the switches `sw`, a Sampler and an Emission (read with
// EMIT), and run their own copy of the bounce, so that the reference
// instance's code is what it was before they existed. The spawn instances
// take a Spawn after them, read at the spawn (spawn_camera_ext: the Sobol
// index is the item's sample iteration `it`): <true, true, Sampler,
// Emission, Spawn> with the sampled bounce, <false, false, Sampler,
// Emission, Spawn> on the reference bounce (its Sampler and Emission
// unread).
template <bool SAMPLER = false, bool EMIT = false, class... Sw>
__global__ void __launch_bounds__(CHUNK)
    pool_step_kernel(float* __restrict__ pf, int* __restrict__ pi,
                     long long* __restrict__ rng_pl, float* rgb, float* ns,
                     long long* ctl, const float* __restrict__ table,
                     const float* __restrict__ cie, int staged, int n_sph,
                     int n_mat, int n_light, PoolWork w, Geom geom,
                     Sw... sw) {
  // the loop test: a launch past the end does nothing
  if (ld_volatile(ctl + C_GO) == 0) return;
  extern __shared__ float4 smem4[];
  __shared__ long long s_chunk, s_excl;
  __shared__ int s_warp[CHUNK / 32];
  __shared__ bool s_last;
  const unsigned FULL = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Params prm = stage_scene<0>(reinterpret_cast<float*>(smem4), table,
                                    cie, staged, n_sph, n_mat, n_light, geom);
  const Sampler none = {};
  const long long Q = w.Q;
  const long long n_chunks = (Q + CHUNK - 1) / CHUNK;
  unsigned long long* words =
      reinterpret_cast<unsigned long long*>(ctl + C_WORDS);
  const long long next0 = ctl[C_NEXT], pix0 = ctl[C_NEXT_PIX];
  const long long n_pix = w.n_valid > 1 ? w.n_valid : 1;
  unsigned long long rays = 0, alive = 0;

  for (;;) {
    if (tid == 0)
      s_chunk = (long long)atomicAdd(
          reinterpret_cast<unsigned long long*>(ctl + C_TICKET), 1ull);
    __syncthreads();
    const long long chunk = s_chunk;
    if (chunk >= n_chunks) break;
    const long long i = chunk * CHUNK + tid;
    const bool in = i < Q;
    const bool was_active = in && pi[PI_ACTIVE * Q + i] != 0;
    const bool dead = in && !was_active;

    // ---- the slot's rank among the pool's dead slots
    const unsigned bal = __ballot_sync(FULL, dead);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int before = __popc(bal & ((1u << lane) - 1u)), agg = 0;
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k) {
      if (k < warp) before += s_warp[k];
      agg += s_warp[k];
    }
    if (warp == 0) {
      const long long excl = look_back(words, chunk, agg);
      if (lane == 0) {
        s_excl = excl;
        if (chunk == n_chunks - 1) ctl[C_DEAD] = excl + agg;
      }
    }
    __syncthreads();
    const long long rank = s_excl + before;

    // ---- regeneration: a dead slot claims work item `rank` of this sweep
    bool live = was_active;
    V3 o, d, tp, rad;
    float lam = 0.0f;
    int pix = 0, bounce = 0;
    uint32_t rng = 0;
    [[maybe_unused]] bool coll = false;  // the path carries its hero alone
    if (dead) {
      long long row = -1, gpix = 0, it = 0;
      if (w.cum == nullptr) {
        const long long p = pix0 + rank;
        const long long sample = next0 + p / n_pix;
        if (sample < w.spp && w.n_valid > 0) {
          row = p % n_pix;
          gpix = w.pix_offset + row;
          it = w.it0 + sample;
        }
      } else {
        const long long wk = next0 + rank;
        if (wk < w.cum[w.n_cum - 1]) {
          const int s = budget_round(w.cum, w.n_cum, wk);
          row = w.order[wk - (s > 0 ? w.cum[s - 1] : 0)];
          gpix = w.pix_offset + row;
          it = w.base_counts[row] + s;
        }
      }
      if (row >= 0) {
        live = true;
        const uint32_t px = (uint32_t)(gpix % w.width);
        const uint32_t py = (uint32_t)(gpix / w.width);
        rng = seed_pixels(frame_seed(w.base_seed, (uint32_t)it), px, py);
        if constexpr (sizeof...(Sw) >= 3)  // a spawn or lights instance
          spawn_camera_ext(prm.cam(), spawn_of(sw...), w.base_seed,
                           (uint32_t)it, px, py, w.width, w.height, rng, o, d,
                           lam);
        else
          spawn_camera(prm.cam(), px, py, w.width, w.height, rng, o, d, lam);
        tp = v3(1.0f, 1.0f, 1.0f);
        rad = v3(0.0f, 0.0f, 0.0f);
        pix = (int)row;
        bounce = 0;
      }
    } else if (was_active) {
      if constexpr (SAMPLER)
        coll = (pi[PI_ACTIVE * Q + i] & COLLAPSED) != 0;
      const float* f = pf + i;
      o = v3(f[PF_O * Q], f[(PF_O + 1) * Q], f[(PF_O + 2) * Q]);
      d = v3(f[PF_D * Q], f[(PF_D + 1) * Q], f[(PF_D + 2) * Q]);
      tp = v3(f[PF_TP * Q], f[(PF_TP + 1) * Q], f[(PF_TP + 2) * Q]);
      rad = v3(f[PF_RAD * Q], f[(PF_RAD + 1) * Q], f[(PF_RAD + 2) * Q]);
      lam = f[PF_LAM * Q];
      pix = pi[PI_PIX * Q + i];
      bounce = pi[PI_BOUNCE * Q + i];
      rng = (uint32_t)rng_pl[i];
    }

    // ---- the bounce, then the slot's planes and the splat
    if (live) {
      rays += 1;
      bool cont = false;
      const Hit h = intersect(prm, o, d);
      if constexpr (SAMPLER) {
        if constexpr (sizeof...(Sw) == 4)  // the lights instance's
          cont = sampled_bounce<EMIT>(prm, sampler_of(sw...), emission(sw...),
                                      h, lam, w, bounce, n_light, rng, coll,
                                      o, d, tp, rad, rays, lights_of(sw...));
        else if constexpr (sizeof...(Sw) == 3)  // the spawn instance's
          cont = sampled_bounce<EMIT>(prm, sampler_of(sw...), emission(sw...),
                                      h, lam, w, bounce, n_light, rng, coll,
                                      o, d, tp, rad, rays);
        else
          cont = sampled_bounce<EMIT>(prm, sw..., h, lam, w, bounce, n_light,
                                      rng, coll, o, d, tp, rad, rays);
      } else if (h.t < kHIT()) {
        V3 o2 = o, d2 = d, tp2 = tp;
        if constexpr (sizeof...(Sw) == 4)  // the lights instance
          cont = shade_camera_hit_sel(prm, none, lights_of(sw...), false, h,
                                      vneg(d), lam, w.rr_thresh, rng, o2, d2,
                                      tp2, rad, rays) &&
                 bounce + 1 < w.depth;
        else
          cont = shade_camera_hit(prm, none, false, h, vneg(d), lam,
                                  w.rr_thresh, rng, o2, d2, tp2, rad, rays) &&
                 bounce + 1 < w.depth;
        if (cont) {
          o = o2;
          d = d2;
          tp = tp2;
        }
      } else if constexpr (sizeof...(Sw) == 4) {
        // a miss draws what a hit would: NEE and the scatter + RR step
        for (int k = 0; k < nee_draws(lights_of(sw...), n_light) + 4; ++k)
          rand_u32(rng);
      } else {
        // a miss draws what a hit would: NEE and the scatter + RR step
        for (int k = 0; k < 2 * n_light + 4; ++k) rand_u32(rng);
      }
      float* f = pf + i;
      f[PF_O * Q] = o.x; f[(PF_O + 1) * Q] = o.y; f[(PF_O + 2) * Q] = o.z;
      f[PF_D * Q] = d.x; f[(PF_D + 1) * Q] = d.y; f[(PF_D + 2) * Q] = d.z;
      f[PF_TP * Q] = tp.x; f[(PF_TP + 1) * Q] = tp.y;
      f[(PF_TP + 2) * Q] = tp.z;
      f[PF_RAD * Q] = rad.x; f[(PF_RAD + 1) * Q] = rad.y;
      f[(PF_RAD + 2) * Q] = rad.z;
      f[PF_LAM * Q] = lam;
      pi[PI_PIX * Q + i] = pix;
      pi[PI_BOUNCE * Q + i] = bounce + 1;
      if constexpr (SAMPLER)
        pi[PI_ACTIVE * Q + i] = cont ? (coll ? 1 | COLLAPSED : 1) : 0;
      else
        pi[PI_ACTIVE * Q + i] = cont ? 1 : 0;
      rng_pl[i] = (long long)rng;
      if (cont) {
        alive += 1;
      } else {  // the pool keeps rad; the image takes it capped
        if constexpr (EMIT) rad = clamp_sample(emission(sw...), rad);
        atomicAdd(rgb + 3 * (long long)pix, rad.x);
        atomicAdd(rgb + 3 * (long long)pix + 1, rad.y);
        atomicAdd(rgb + 3 * (long long)pix + 2, rad.z);
        atomicAdd(ns + pix, 1.0f);
      }
    }
    __syncthreads();  // s_chunk, s_warp and s_excl are reused
  }

  // ---- the block's counts; the last block to finish closes the sweep
  add_block_rays<CHUNK / 32>(rays, reinterpret_cast<unsigned long long*>(
                                       ctl + C_RAYS));
  __syncthreads();
  add_block_rays<CHUNK / 32>(alive, reinterpret_cast<unsigned long long*>(
                                        ctl + C_ALIVE));
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(reinterpret_cast<unsigned long long*>(ctl + C_DONE),
                       1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) {
    __threadfence();
    const long long dead_total = ld_volatile(ctl + C_DEAD);
    const long long n_alive = ld_volatile(ctl + C_ALIVE);
    const long long sweeps = ctl[C_SWEEPS] + 1;
    bool pending;
    if (w.cum == nullptr) {
      // the dead slots with work: ranks below the items left
      long long issued = 0;
      if (w.n_valid > 0 && next0 < w.spp) {
        const long long left = (w.spp - next0) * n_pix - pix0;
        issued = dead_total < left ? dead_total : left;
      }
      const long long np2 = pix0 + issued;
      ctl[C_NEXT] = next0 + np2 / n_pix;
      ctl[C_NEXT_PIX] = np2 % n_pix;
      pending = ctl[C_NEXT] < w.spp && w.n_valid > 0;
    } else {
      const long long total = w.cum[w.n_cum - 1];
      const long long left = total > next0 ? total - next0 : 0;
      ctl[C_NEXT] = next0 + (dead_total < left ? dead_total : left);
      pending = ctl[C_NEXT] < total;
    }
    ctl[C_SWEEPS] = sweeps;
    ctl[C_GO] = ((pending || n_alive > 0) && sweeps < w.max_sweeps) ? 1 : 0;
    ctl[C_TICKET] = 0;
    ctl[C_DONE] = 0;
    ctl[C_DEAD] = 0;
    ctl[C_ALIVE] = 0;
  }
  for (long long j = tid; j < n_chunks; j += CHUNK) words[j] = 0ull;
}

}  // namespace tpurt

// `sampler`: the camera-path sampler flags; `emission`, `spawn`, `lights`:
// null, or the emission, the spawn and the lights switches. With none on,
// the reference instance runs.
extern "C" int tpurt_wf_step_launch(float* pf, int* pi, long long* rng,
                                    float* rgb, float* ns, long long* ctl,
                                    const float* table, int n_sph, int n_mat,
                                    int n_light, const tpurt::PoolWork* work,
                                    const tpurt::Geom* geom, const float* cie,
                                    const tpurt::Sampler* sampler,
                                    const tpurt::Emission* emission,
                                    const tpurt::Spawn* spawn,
                                    const tpurt::Lights* lights,
                                    void* stream) {
  using namespace tpurt;
  const int staged = staged_floats(n_sph, n_mat, n_light);
  const size_t smem = run_pixels_smem(staged, *geom, CHUNK, 0);
  const bool sampled = emission || sampler_on(*sampler);
  const void* kernel =
      lights ? (sampled ? (const void*)pool_step_kernel<true, true, Sampler,
                                                        Emission, Spawn,
                                                        Lights>
                        : (const void*)pool_step_kernel<false, false, Sampler,
                                                        Emission, Spawn,
                                                        Lights>)
      : spawn ? (sampled ? (const void*)pool_step_kernel<true, true, Sampler,
                                                         Emission, Spawn>
                         : (const void*)pool_step_kernel<false, false,
                                                         Sampler, Emission,
                                                         Spawn>)
      : !sampled ? (const void*)pool_step_kernel<>
      : emission ? (const void*)pool_step_kernel<true, true, Sampler,
                                                  Emission>
                 : (const void*)pool_step_kernel<true, false, Sampler,
                                                  Emission>;
  long long resident = 0;
  const int err = resident_blocks(kernel, smem, CHUNK, &resident);
  if (err) return err;
  const long long n_chunks = (work->Q + CHUNK - 1) / CHUNK;
  const unsigned int blocks =
      (unsigned int)(n_chunks < resident ? n_chunks : resident);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Emission off = {};
  const Emission& E = emission ? *emission : off;
  if (lights) {
    auto k = sampled ? pool_step_kernel<true, true, Sampler, Emission, Spawn,
                                        Lights>
                     : pool_step_kernel<false, false, Sampler, Emission,
                                        Spawn, Lights>;
    k<<<blocks, CHUNK, smem, s>>>(pf, pi, rng, rgb, ns, ctl, table, cie,
                                  staged, n_sph, n_mat, n_light, *work,
                                  *geom, *sampler, E, spawn_or_off(spawn),
                                  *lights);
  } else if (spawn) {
    auto k = sampled ? pool_step_kernel<true, true, Sampler, Emission, Spawn>
                     : pool_step_kernel<false, false, Sampler, Emission,
                                        Spawn>;
    k<<<blocks, CHUNK, smem, s>>>(pf, pi, rng, rgb, ns, ctl, table, cie,
                                  staged, n_sph, n_mat, n_light, *work,
                                  *geom, *sampler, E, *spawn);
  } else if (!sampled) {
    pool_step_kernel<><<<blocks, CHUNK, smem, s>>>(
        pf, pi, rng, rgb, ns, ctl, table, cie, staged, n_sph, n_mat, n_light,
        *work, *geom);
  } else {
    auto k = emission ? pool_step_kernel<true, true, Sampler, Emission>
                      : pool_step_kernel<true, false, Sampler, Emission>;
    k<<<blocks, CHUNK, smem, s>>>(pf, pi, rng, rgb, ns, ctl, table, cie,
                                  staged, n_sph, n_mat, n_light, *work,
                                  *geom, *sampler, E);
  }
  return (int)cudaGetLastError();
}
