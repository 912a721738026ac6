// The regen kernel's pool loop (run_pool): the SPPM samples of a uniform
// launch on a scene without triangles, under the reference sampler and
// without emission, spawn or lights switches, computed as run_pixels
// computes them, with the pixels' paths kept in a block-wide pool of
// slots in shared memory in place of one lane per pixel.
//
// run_pixels pins a pixel to a lane, and a uniform launch keeps a warp's
// lanes in lockstep: a lane whose path ended waits for the warp's longest
// path before its next phase (the camera path, then photons 0..K-1). With
// Russian roulette in a closed box path lengths are close to geometric, so
// the longest of 32 is several times the mean, and a lockstep warp keeps
// about 39% of its lanes busy a trip on the Cornell box at 1080p (a count
// of the plain version's segments per lane and phase). Free-running lanes
// fill the warp but mix every phase in one trip, and on spheres they tie
// with lockstep (PERF.md).
//
// Here a block holds POOL_SLOTS slots, each the whole live state of one
// pixel's chain of samples (pixel, sample, photon k, bounce b, ray,
// throughput, sample radiance, PCG state, wavelength, radius, vispoint
// position and the vispoint fields run_pixels keeps in `vis`), as a
// structure of arrays (field f of slot s at f * POOL_SLOTS + s). Each slot
// waits on one of three FIFO lists of slot indices: camera bounce, photon
// bounce, and transition (the start of photon k + 1, the end of a sample,
// the end of a pixel, an empty slot to fill). A warp trip claims up to 32
// slots of one list, loads them, runs one kind of step on them (a camera
// segment with its next-event estimation and scatter; a photon segment
// with its gather and scatter; or the transition), stores them back and
// pushes each onto the list of its next step. So every trip of a warp is
// one kind of shading and, while the lists hold 32 slots, every lane of it
// is busy: a path that ended gives its lane to another slot at once. Every
// slot a warp held goes back through the lists after each trip: a warp
// that kept the paths going on with its kind (in registers, or only their
// slots) and refilled just its ended lanes ran 5-15% slower on the H100 at
// the same lane share and spills (PERF.md). The
// two segment kinds share one code path (one call site for the nearest hit
// and one for scatter + roulette, as in run_pixels): two copies of it ran
// the kernel 1.55 times slower on the H100, the instruction cache's doing
// (PERF.md). The lists are the only state the warps share; one warp at a
// time pushes and claims, under a lock word that the converged warp takes
// (lane 0 tries, the warp learns by a shuffle: with lane 0 spinning alone
// while the rest of its warp waited at a barrier, blocks stalled on a lock
// that no warp held), and no trip waits for a block-wide barrier. Transitions run in trips of their own: a warp adds
// its slots' sample radiance into rgb_sum, stores their vispoints and
// fetches the next pixels with one atomicAdd for all its lanes, as
// run_pixels' fetch does.
//
// Results equal run_pixels' and render_plain's bit for bit: one slot owns
// a pixel from its fetch to its store, and runs its samples, photons and
// bounces in order with the same PCG streams, the same device functions
// and the same float operations.
//
// A block also counts its warp trips and the lanes that held a slot in
// them, each warp's pair in shared memory (in registers they added to the
// loop's spills, as a 64-bit segment count did: PERF.md); the launch adds
// both to a (trips, lanes) pair in global memory, one atomicAdd each per
// block. Each busy lane but the S a block retires pushes its slot after
// its trip, so the slots moved through the lists are the lanes less S,
// and one critical section precedes each trip: neither needs a counter.
#pragma once

#include "path.cuh"

namespace tpurt {

// Blocks of POOL_THREADS threads, POOL_MIN_BLOCKS of them an SM (the
// register cap), POOL_SLOTS slots each (PERF.md has what was measured).
constexpr int POOL_THREADS = 128;
constexpr int POOL_MIN_BLOCKS = 8;
constexpr int POOL_SLOTS = 192;

// A slot's fields, one 32-bit word each (ints as their bits).
enum PoolField : int {
  PF_PIX = 0,   // pixel; -1: empty
  PF_IT,        // the sample's iteration
  PF_K,         // phase: -1 the camera path, else photon k
  PF_B,         // bounce b, and in bit 31 whether the sample stored its
                // vispoint
  PF_RNG,       // PCG state
  PF_O,         // ray origin (3)
  PF_D = PF_O + 3,          // ray direction (3)
  PF_TP = PF_D + 3,         // throughput (3)
  PF_RAD = PF_TP + 3,       // the sample's radiance (3)
  PF_VPOS = PF_RAD + 3,     // vispoint position (3)
  PF_LAM = PF_VPOS + 3,     // wavelength
  PF_RADIUS,                // gather radius
  PF_VIS,                   // vis_norm, vis_wo, vis_tp, vis_mat
  POOL_FIELDS = PF_VIS + VIS_FIELDS
};

// The lists a slot waits on; POOL_DONE: retired (no pixel left).
enum PoolKind : int { POOL_CAM = 0, POOL_PHOTON, POOL_TRANS, POOL_DONE };

// The lists of a block, in static shared memory.
template <int S>
struct PoolLists {
  int lock;
  int head[3], count[3];
  int live;    // slots not retired
  int more;    // the work counter may still hold pixels
  unsigned long long trips, lanes;
  // each warp's (trips, lanes), added to by its lane 0
  unsigned long long warp_tally[POOL_THREADS / 32][2];
  unsigned char q[3][S];
};

// The floats of a block's dynamic shared memory that stage_scene lays
// out as vispoint fields: here the slots, VIS words a thread.
constexpr int POOL_VIS = POOL_FIELDS * POOL_SLOTS / POOL_THREADS;
static_assert(POOL_FIELDS * POOL_SLOTS % POOL_THREADS == 0,
              "the slots fill whole words a thread");
static_assert(POOL_SLOTS <= 256, "slot indices are bytes");

template <int S>
struct Slot {
  float* f;
  int s;
  __device__ __forceinline__ float ld(int field) const {
    return f[field * S + s];
  }
  __device__ __forceinline__ void st(int field, float v) const {
    f[field * S + s] = v;
  }
  __device__ __forceinline__ int ldi(int field) const {
    return __float_as_int(ld(field));
  }
  __device__ __forceinline__ void sti(int field, int v) const {
    st(field, __int_as_float(v));
  }
  __device__ __forceinline__ V3 ld3(int field) const {
    return v3(ld(field), ld(field + 1), ld(field + 2));
  }
  __device__ __forceinline__ void st3(int field, V3 v) const {
    st(field, v.x);
    st(field + 1, v.y);
    st(field + 2, v.z);
  }
};

// A sample begins at iteration `it` of pixel `pix`: run_pixels' spawn.
template <int S>
__device__ __forceinline__ void pool_spawn(const Params& prm,
                                           const SampleConsts& c,
                                           const Slot<S>& sl, int pix,
                                           uint32_t it) {
  const uint32_t px = (uint32_t)(pix % c.width);
  const uint32_t py = (uint32_t)(pix / c.width);
  uint32_t rng = seed_pixels(frame_seed(c.base_seed, it), px, py);
  V3 o, d;
  float lam;
  spawn_camera(prm.cam(), px, py, c.width, c.height, rng, o, d, lam);
  sl.sti(PF_IT, (int)it);
  sl.sti(PF_K, -1);
  sl.sti(PF_B, 0);
  sl.sti(PF_RNG, (int)rng);
  sl.st3(PF_O, o);
  sl.st3(PF_D, d);
  sl.st3(PF_TP, v3(1.0f, 1.0f, 1.0f));
  sl.st3(PF_RAD, v3(0.0f, 0.0f, 0.0f));
  sl.st(PF_LAM, lam);
}

// One segment of a slot on a camera path (`camera`) or a photon path:
// run_pixels' trip for one lane (SAMPLER, EMIT and the switches off), with
// one call site for the nearest hit and one for scatter + roulette, as
// there. A camera hit stores the sample's vispoint at its first diffuse
// hit and adds next-event estimation; a photon hit is gathered at the
// slot's own vispoint. `rays`: the lane's segments, added to (a launch
// traces fewer than 2^32 a lane). Returns the slot's next list.
template <int S>
__device__ __forceinline__ int pool_segment(const Params& prm,
                                            const Sampler& Sm,
                                            const SampleConsts& c,
                                            const Slot<S>& sl, bool camera,
                                            unsigned& rays) {
  const V3 d = sl.ld3(PF_D);
  rays += 1;
  const Hit h = intersect(prm, sl.ld3(PF_O), d);
  if (!(h.t < kHIT())) return POOL_TRANS;
  const int bw = sl.ldi(PF_B);
  const int b = bw & 0x7fffffff;
  int vp_bit = bw & (int)0x80000000u;
  V3 tp = sl.ld3(PF_TP);
  uint32_t rng = (uint32_t)sl.ldi(PF_RNG);
  const float lam = sl.ld(PF_LAM);
  const V3 wo = vneg(d);
  const float lam_um = lam * F(1e-3);
  const float cauchy_add = F(0.004) / (lam_um * lam_um);
  if (camera) {
    // ---- camera bounce b: the vispoint at the first diffuse hit, then
    // next-event estimation
    const int mtype = (int)prm.mat()[h.mat * MAT_STRIDE + 5];
    if (mtype == 0 && !vp_bit) {
      sl.st3(PF_VPOS, h.loc);
      sl.st3(PF_VIS, h.n);
      sl.st3(PF_VIS + 3, wo);
      sl.st3(PF_VIS + 6, tp);
      sl.st(PF_VIS + 9, (float)h.mat);
      vp_bit = (int)0x80000000u;
    }
    V3 rad = sl.ld3(PF_RAD);
    unsigned long long shadow = 0;  // its shadow segments
    camera_direct<false>(prm, Sm, false, h, lam, tp, rng, rad, shadow);
    rays += (unsigned)shadow;
    sl.st3(PF_RAD, rad);
  } else {
    // ---- photon k, bounce b: gathered at this pixel's vispoint
    const V3 dvec = vsub(h.loc, sl.ld3(PF_VPOS));
    const float dist = sqrtf(fmaxf(vdot(dvec, dvec), 0.0f));
    const float radius = sl.ld(PF_RADIUS);
    if (dist < radius) {
      const V3 vnorm = sl.ld3(PF_VIS), vwo = sl.ld3(PF_VIS + 3),
               vtp = sl.ld3(PF_VIS + 6);
      const float* vm = prm.mat() + (int)sl.ld(PF_VIS + 9) * MAT_STRIDE;
      const V3 f = evaluate_bsdf(vwo, wo, vnorm, load3(vm), vm[3],
                                 vm[4] + cauchy_add, (int)vm[5]);
      const float inv_pi_r2 =
          1.0f / fmaxf(F(3.141592653589793) * radius * radius, F(1e-10));
      const float kern = (1.0f - dist / radius) * inv_pi_r2;
      sl.st3(PF_RAD,
             vadd(sl.ld3(PF_RAD), vscale(vmul(vmul(vtp, f), tp), kern)));
    }
  }
  // ---- scatter + Russian roulette, one call site for both kinds: camera
  // paths at the IOR, photons at the IOR plus the Cauchy term
  V3 on, dn;
  const bool cont = scatter_rr(
      prm, h.mat, wo, h.n, h.loc, camera ? 0.0f : cauchy_add, camera,
      camera ? c.rr_thresh : c.photon_rr_thresh, rng, on, dn, tp);
  sl.st3(PF_O, on);
  sl.st3(PF_D, dn);
  sl.st3(PF_TP, tp);
  sl.sti(PF_RNG, (int)rng);
  sl.sti(PF_B, (b + 1) | vp_bit);
  const int kind = camera ? POOL_CAM : POOL_PHOTON;
  return cont && b + 1 < (camera ? c.depth : c.max_photon_bounces)
             ? kind
             : POOL_TRANS;
}

// The transition trip of a warp, every lane calling it (`has`: the lane
// holds slot sl): a path that ended starts photon k + 1 or ends its
// sample (rgb_sum, the radius step), then spawns the next sample or ends
// its pixel (the vispoint back to the planes); lanes without a pixel
// fetch consecutive pixels with one atomicAdd for the warp. Returns the
// slot's next list.
template <int S>
__device__ __forceinline__ int pool_transition(float* planes,
                                               const Params& prm,
                                               const Sampler& Sm,
                                               const SampleConsts& c,
                                               PoolLists<S>& L,
                                               const Slot<S>& sl, bool has,
                                               unsigned long long* work) {
  const unsigned FULL = 0xffffffffu;
  const unsigned long long n_pix =
      (unsigned long long)c.width * (unsigned long long)c.height;
  const uint32_t it_end = (uint32_t)c.it0 + (uint32_t)c.spp;
  bool need = false;
  int next = POOL_DONE;
  if (has) {
    const int pix = sl.ldi(PF_PIX);
    if (pix < 0) {
      need = true;
    } else {
      const int k = sl.ldi(PF_K) + 1;
      const V3 vpos = sl.ld3(PF_VPOS);
      const uint32_t it = (uint32_t)sl.ldi(PF_IT);
      if (k < c.k_photons && sqrtf(vdot(vpos, vpos)) > F(0.001)) {
        const uint32_t seed = frame_seed(c.base_seed, it);
        uint32_t rng = photon_stream(seed, (uint32_t)(pix % c.width),
                                     (uint32_t)(pix / c.width), (uint32_t)k);
        V3 o, d, tp;
        emit_photon(prm.light() + (k % prm.n_light) * LIGHT_STRIDE, Sm, false,
                    0u, (uint32_t)k, rng, o, d, tp);
        sl.sti(PF_K, k);
        sl.sti(PF_B, sl.ldi(PF_B) & (int)0x80000000u);
        sl.sti(PF_RNG, (int)rng);
        sl.st3(PF_O, o);
        sl.st3(PF_D, d);
        sl.st3(PF_TP, tp);
        next = POOL_PHOTON;
      } else {
        const V3 rad = sl.ld3(PF_RAD);
        float* pl = planes + pix;
        pl[0] += rad.x;
        pl[c.P] += rad.y;
        pl[2 * c.P] += rad.z;
        // the per-pixel SPPM radius step
        const float base_f = (float)c.it0;
        const uint32_t base = (uint32_t)(int)rintf(base_f);
        const uint32_t it1 = it + 1;
        const float itf = base_f + (float)(int)(it1 - base);
        const float radius =
            sl.ld(PF_RADIUS) * sqrtf((itf + c.sppm_alpha) / (itf + 1.0f));
        if (it1 < it_end) {
          sl.st(PF_RADIUS, radius);
          pool_spawn(prm, c, sl, pix, it1);
          next = POOL_CAM;
        } else {  // the pixel is done: its vispoint goes back to the planes
          pl[3 * c.P] = vpos.x;
          pl[4 * c.P] = vpos.y;
          pl[5 * c.P] = vpos.z;
#pragma unroll
          for (int f = 0; f < VIS_FIELDS; ++f)
            pl[(6 + f) * c.P] = sl.ld(PF_VIS + f);
          sl.sti(PF_PIX, -1);
          need = true;
        }
      }
    }
  }
  // ---- fetch: the lanes without a pixel take consecutive pixels
  const unsigned want = __ballot_sync(FULL, need);
  if (!want) return next;
  const int lane = (int)(threadIdx.x & 31);
  const int more = __shfl_sync(FULL, *(volatile int*)&L.more, 0);
  if (!more) return next;
  const int leader = __ffs(want) - 1;
  unsigned long long first = 0;
  if (lane == leader) {
    first = atomicAdd(work, (unsigned long long)__popc(want));
    if (first + (unsigned long long)__popc(want) >= n_pix)
      *(volatile int*)&L.more = 0;
  }
  first = __shfl_sync(FULL, first, leader);
  if (!need) return next;
  const unsigned long long mine =
      first + __popc(want & ((1u << lane) - 1u));
  if (mine >= n_pix) return POOL_DONE;
  const int pix = (int)mine;
  if (c.spp <= 0) return POOL_TRANS;  // nothing to render: fetch again
  const float* pl = planes + pix;
  sl.sti(PF_PIX, pix);
  sl.st3(PF_VPOS, v3(pl[3 * c.P], pl[4 * c.P], pl[5 * c.P]));
#pragma unroll
  for (int f = 0; f < VIS_FIELDS; ++f) sl.st(PF_VIS + f, pl[(6 + f) * c.P]);
  sl.st(PF_RADIUS, c.radius0);
  pool_spawn(prm, c, sl, pix, (uint32_t)c.it0);
  return POOL_CAM;
}

// A warp pushes the slots of the lanes with `on` onto list k (head h,
// count n), in lane order; n grows by them.
template <int S>
__device__ __forceinline__ void pool_push(volatile unsigned char* q, int k,
                                          int h, int& n, bool on, int slot,
                                          unsigned lt) {
  const unsigned m = __ballot_sync(0xffffffffu, on);
  if (on) q[k * S + (h + n + __popc(m & lt)) % S] = (unsigned char)slot;
  n += __popc(m);
}

// The list a warp claims from, given the lists' counts: the transition
// list once it holds a warp's worth or nothing else waits, else the
// fuller of the two bounce lists.
__device__ __forceinline__ int pool_pick(int n_cam, int n_photon,
                                         int n_trans) {
  if (n_trans >= 32 || (n_cam == 0 && n_photon == 0)) return POOL_TRANS;
  return n_cam >= n_photon ? POOL_CAM : POOL_PHOTON;
}

// A fault in the lists' bookkeeping would leave warps waiting forever: a
// warp that waits this many times in a row, for the lock or for a slot,
// traps, and the launch fails.
constexpr unsigned POOL_MAX_WAITS = 1u << 26;

// The samples of a uniform launch's pixels through the block's pool.
// `slots`: POOL_FIELDS * S floats of shared memory; `work`: the launch's
// pixel counter; `rays`: the thread's segments, added to; `lanes_out`:
// (trips, lanes) in global memory, added to. Every thread of the block
// must call it; blockDim.x == POOL_THREADS.
template <int S>
__device__ __forceinline__ void run_pool(float* planes, const Params& prm,
                                         const Sampler& Sm,
                                         const SampleConsts& c, float* slots,
                                         unsigned long long* work,
                                         unsigned long long& rays,
                                         unsigned long long* lanes_out) {
  const unsigned FULL = 0xffffffffu;
  __shared__ PoolLists<S> L;
  if (threadIdx.x == 0) {
    L.lock = 0;
    for (int q = 0; q < 3; ++q) L.head[q] = 0;
    L.count[POOL_CAM] = 0;
    L.count[POOL_PHOTON] = 0;
    L.count[POOL_TRANS] = S;
    L.live = S;
    L.more = 1;
    L.trips = 0;
    L.lanes = 0;
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    L.q[POOL_TRANS][s] = (unsigned char)s;
    slots[PF_PIX * S + s] = __int_as_float(-1);
  }
  __syncthreads();

  volatile int* head = L.head;
  volatile int* count = L.count;
  volatile unsigned char* q = &L.q[0][0];
  const int lane = (int)(threadIdx.x & 31);
  const unsigned lt = (1u << lane) - 1u;
  int my = -1;           // the slot this lane holds
  int next = POOL_DONE;  // where it goes after the trip
  unsigned long long* tally = L.warp_tally[threadIdx.x >> 5];
  if (lane == 0) tally[0] = tally[1] = 0;
  unsigned seg_rays = 0;  // the lane's segments
  unsigned waits = 0;  // claims in a row that found every list empty
  for (;;) {
    // ---- push the trip's slots and claim the next trip's, under the lock,
    // which the converged warp takes (lane 0 tries, the warp learns): the
    // slots' stores of the trip land before the push
    __threadfence_block();
    for (unsigned spins = 0;; ++spins) {
      int got = 0;
      if (lane == 0) got = atomicCAS(&L.lock, 0, 1) == 0;
      if (__shfl_sync(FULL, got, 0)) break;
      if (spins > POOL_MAX_WAITS) __trap();
      __nanosleep(32);
    }
    __threadfence_block();
    int h0 = head[POOL_CAM], h1 = head[POOL_PHOTON], h2 = head[POOL_TRANS];
    int n0 = count[POOL_CAM], n1 = count[POOL_PHOTON], n2 = count[POOL_TRANS];
    const bool held = my >= 0;
    pool_push<S>(q, POOL_CAM, h0, n0, held && next == POOL_CAM, my, lt);
    pool_push<S>(q, POOL_PHOTON, h1, n1, held && next == POOL_PHOTON, my, lt);
    pool_push<S>(q, POOL_TRANS, h2, n2, held && next == POOL_TRANS, my, lt);
    const int retired = __popc(__ballot_sync(FULL, held && next == POOL_DONE));
    __syncwarp();
    const int kind = pool_pick(n0, n1, n2);
    const int hk = kind == POOL_CAM ? h0 : kind == POOL_PHOTON ? h1 : h2;
    const int nk = kind == POOL_CAM ? n0 : kind == POOL_PHOTON ? n1 : n2;
    const int take = min(32, nk);
    my = lane < take ? (int)q[kind * S + (hk + lane) % S] : -1;
    __syncwarp();
    int live = 0;
    if (lane == 0) {
      head[kind] = (hk + take) % S;
      count[POOL_CAM] = kind == POOL_CAM ? n0 - take : n0;
      count[POOL_PHOTON] = kind == POOL_PHOTON ? n1 - take : n1;
      count[POOL_TRANS] = kind == POOL_TRANS ? n2 - take : n2;
      live = *(volatile int*)&L.live - retired;
      *(volatile int*)&L.live = live;
      __threadfence_block();
      atomicExch(&L.lock, 0);
    }
    live = __shfl_sync(FULL, live, 0);
    if (take == 0) {
      next = POOL_DONE;
      if (live == 0) break;  // every slot retired: the block is done
      if (++waits > POOL_MAX_WAITS) __trap();
      __nanosleep(256);  // the other warps hold the live slots
      continue;
    }
    waits = 0;
    if (lane == 0) {
      tally[0] += 1;
      tally[1] += (unsigned long long)take;
    }

    // ---- the trip: one kind of step on the claimed slots
    const Slot<S> sl = {slots, my};
    if (kind == POOL_TRANS)
      next = pool_transition(planes, prm, Sm, c, L, sl, my >= 0, work);
    else if (my >= 0)
      next = pool_segment(prm, Sm, c, sl, kind == POOL_CAM, seg_rays);
  }
  rays += seg_rays;
  if (lane == 0) {
    atomicAdd(&L.trips, tally[0]);
    atomicAdd(&L.lanes, tally[1]);
  }
  __syncthreads();
  if (threadIdx.x == 0 && lanes_out) {
    atomicAdd(lanes_out, L.trips);
    atomicAdd(lanes_out + 1, L.lanes);
  }
}

// One launch of the pool instance of the regen kernel (path_pool.cu):
// uniform, no triangles, the reference sampler, no emission, spawn or
// lights switches. `lanes`: (trips, lanes) on the device, added to.
int launch_pool(float* planes, const float* table, const float* cie,
                int staged, int n_sph, int n_mat, int n_light,
                const SampleConsts& c, const Sampler& S, const Geom& geom,
                unsigned long long* counters, unsigned long long* lanes,
                cudaStream_t stream);

}  // namespace tpurt
