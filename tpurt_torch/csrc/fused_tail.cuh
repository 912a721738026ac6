// The fused wavefront kernel's tail loop (run_tail): the camera-path
// samples of a uniform launch of several samples a pixel, under the
// reference sampler and without emission, spawn or lights switches,
// computed as run_pixels' camera-only instance computes them, with a
// warp's last few straggling paths of a sample finished in their own lanes
// while the rest of the warp starts its next sample.
//
// run_pixels pins a pixel to a lane and a uniform launch keeps a warp's
// lanes in lockstep: a lane whose path ended waits for the warp's longest
// path before its next sample. That keeps the 32 neighbouring pixels'
// rays coherent and one kind of shading a trip, and on the H100 it beat
// free-running lanes on every uniform fused launch measured (PERF.md). But
// most camera paths of a scene like bench config 5's are one or two
// segments (a miss into the sky, a floor hit and a miss) while a few chain
// through glass for many, so a warp spends its last trips of a sample on
// a few stragglers, with the other lanes waiting: on bench config 5 a
// quarter of the trips carried 8 lanes or fewer (PERF.md).
//
// Here a lane whose path ended waits for its warp only while more than
// TAIL_LANES lanes of the warp are on a path. Once at most TAIL_LANES are
// left, the others add their sample into its row and start their pixel's
// next sample at once, and the stragglers finish their paths beside them.
// So the dense trips stay in lockstep and only the tails leave it.
//
// Why the stragglers stay in their lanes, and not in a pool: the paths of
// a sample's tail are few and long, and a block-wide pool of them (the
// first design, PERF.md) made each stray path's lane wait, idle, for the
// pool to finish it, let the warp's lanes fall out of step and fetch
// pixels apart, and cost registers in every trip: on the H100 it ran
// bench config 5 1.26 to 1.6 times slower than lockstep. A pool for the
// whole kernel (path_pool.cuh, the regen kernel's) costs about 1.4 lockstep
// trips a trip and wins only where lockstep keeps far fewer lanes busy
// than it does here.
//
// What keeps the warp coherent is the fetch: a warp takes new pixels, 32
// consecutive ones, only once every lane of it has finished its pixel.
// Lanes that finish early wait; a lane that took its own pixel apart from
// its warp (fetching as soon as it was free) ran bench config 5 18%
// slower than lockstep (PERF.md).
//
// Results equal run_pixels' bit for bit: a lane owns its pixel from fetch
// to store and runs its samples in order, adding each into the pixel's
// row as it ends, so rows are added in sample order, with the same PCG
// stream, device functions and float operations; every segment is
// counted once.
//
// Each warp keeps its trips and the lanes that traced a segment in them
// in one packed word of shared memory, as run_pixels' cam_tally does, and
// the segments of paths that went on after their warp moved on (the tail
// segments) in another; the launch adds them to its counters [2], [3] and
// [4].
#pragma once

#include "path.cuh"

namespace tpurt {

// The most lanes of a warp still on a path that the warp moves on
// without (PERF.md has the values measured), the fewest samples a pixel a
// launch takes this loop at (below it, on bench config 5, the loop's
// ballots cost more than the few tails a pixel's samples leave to take
// out, and fused_kernel runs; PERF.md has the sweep), and the warps of a
// block (launch_persistent's 128 threads).
constexpr int TAIL_LANES = 16;
constexpr int TAIL_MIN_SPP = 8;
constexpr int TAIL_WARPS = 4;

// The camera-path samples of a uniform launch's pixels (run_pixels with
// CAM, the reference sampler, no G leaf, no switches), with the tails
// outside lockstep. `planes`: the (P, 3) rgb_sum, row p at planes + 3p;
// `work`: the pixel counter, then the (trips, lanes) and tail-segment
// counters; `rays`: the thread's segments, added to. Every thread of the
// block must call it; blockDim.x == 32 * TAIL_WARPS.
__device__ __forceinline__ void run_tail(float* planes, const Params& prm,
                                         const SampleConsts& c,
                                         unsigned long long* work,
                                         unsigned long long& rays) {
  const unsigned FULL = 0xffffffffu;
  // each warp's trips << 32 | lanes, and its tail segments
  __shared__ unsigned long long tally[TAIL_WARPS][2];
  const int lane = (int)(threadIdx.x & 31);
  unsigned long long* my_tally = tally[threadIdx.x >> 5];
  const unsigned long long n_pix =
      (unsigned long long)c.width * (unsigned long long)c.height;
  const Sampler none = {};
  bool more = true;    // the counter may still hold pixels (warp-uniform)
  int idx = -1;        // this lane's pixel; < 0: it waits for one
  bool spawn = false;  // the next trip begins a sample
  bool live = false;   // the lane is inside a sample
  bool done = false;   // its path ended
  bool tail = false;   // its path went on after the warp moved on
  uint32_t it = 0, it_end = 0;
  int b = 0;
  uint32_t rng = 0;
  float lam = 0.0f;
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o, tp = o, rad = o;
  if (lane == 0) {
    my_tally[0] = 0ull;
    my_tally[1] = 0ull;
  }

  for (;;) {
    // ---- fetch: once no lane of the warp has a pixel, 32 consecutive ones
    const unsigned want = __ballot_sync(FULL, idx < 0);
    if (more && want == FULL) {
      unsigned long long first = 0;
      if (lane == 0) first = atomicAdd(work, 32ull);
      first = __shfl_sync(FULL, first, 0);
      more = first + 32ull < n_pix;
      const unsigned long long mine = first + (unsigned long long)lane;
      if (mine < n_pix && c.spp > 0) {
        idx = (int)mine;
        it = (uint32_t)c.it0;
        it_end = it + (uint32_t)c.spp;
        spawn = true;
      }
    } else if (!more && want == FULL) {
      break;  // no pixel left and no lane of the warp at work
    }

    // ---- the lanes whose path ended go on once at most TAIL_LANES lanes
    // of the warp are on a path; those become the tail
    const bool go =
        __popc(__ballot_sync(FULL, live && !done)) <= TAIL_LANES;
    if (go && live && !done) tail = true;
    if (done && go) {  // the end of a sample: its row, in sample order
      done = false;
      live = false;
      float* row = planes + 3 * idx;
      row[0] += rad.x;
      row[1] += rad.y;
      row[2] += rad.z;
      it += 1;
      if (it < it_end)
        spawn = true;
      else
        idx = -1;
    }

    // ---- a sample begins: 2 jitter draws, 1 wavelength draw
    if (spawn) {
      const uint32_t px = (uint32_t)(idx % c.width);
      const uint32_t py = (uint32_t)(idx / c.width);
      rng = seed_pixels(frame_seed(c.base_seed, it), px, py);
      spawn_camera(prm.cam(), px, py, c.width, c.height, rng, o, d, lam);
      tp = v3(1.0f, 1.0f, 1.0f);
      rad = v3(0.0f, 0.0f, 0.0f);
      b = 0;
      spawn = false;
      live = true;
      tail = false;
    }
    // ---- the trip, its lanes with a segment and those of them in a tail
    const unsigned busy = __ballot_sync(FULL, live && !done);
    if (!busy) continue;  // a warp without pixels: no trip
    const unsigned late = __ballot_sync(FULL, tail) & busy;
    if (lane == 0) {
      my_tally[0] += (1ull << 32) | (unsigned long long)__popc(busy);
      my_tally[1] += (unsigned long long)__popc(late);
    }
    if (!live || done) continue;

    // ---- one segment
    rays += 1;
    const Hit h = intersect(prm, o, d);
    if (!(h.t < kHIT())) {
      done = true;
      continue;
    }
    const V3 wo = vneg(d);
    camera_direct<false>(prm, none, false, h, lam, tp, rng, rad, rays);
    const bool cont = scatter_rr(prm, h.mat, wo, h.n, h.loc, 0.0f, true,
                                 c.rr_thresh, rng, o, d, tp);
    if (!(cont && b + 1 < c.depth)) done = true;
    b += 1;
  }
  if (lane == 0) {
    const unsigned long long t = my_tally[0];
    atomicAdd(work + 1, t >> 32);
    atomicAdd(work + 2, t & 0xffffffffull);
    atomicAdd(work + 3, my_tally[1]);
  }
}

// One launch of the tail instance of the fused wavefront kernel
// (fused_tail.cu): uniform, at least TAIL_MIN_SPP samples a pixel, the
// reference sampler, no emission, spawn or lights switches. `counters`: five uint64, as tpurt_wf_fused_launch takes them.
int launch_fused_tail(float* rgb, const float* table, const float* cie,
                      int staged, int n_sph, int n_mat, int n_light,
                      const SampleConsts& c, const Geom& geom,
                      unsigned long long* counters, cudaStream_t stream);

}  // namespace tpurt
