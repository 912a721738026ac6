// BVH walks of the path kernels: closest hit and occlusion against the
// triangle tree, closest hit and shadow factor against the sphere tree,
// one thread per ray (the G leaf: a warp per leaf).
//
// Replaces the device code tpurt inlines into its TPU path kernels for
// meshes and many-sphere scenes: tpurt/kernels/bvh_pallas.py _bvh_walk
// (binary inner_case and wide inner_case_wide), closest_tri_bvh,
// tri_shadow_bvh, closest_sphere_bvh and sphere_shadow_bvh with their leaf
// bodies, the chunked walks (closest_tri_bvh_chunked and the rest, which
// exist for the TPU's SMEM budget; here every table lives in global memory
// and one walk serves every size), and the flat table sweeps of
// tpurt/kernels/mega_pallas.py (_closest_tri_dyn, _tri_shadow_dyn and
// their static and clustered forms).
//
// The walk is the reference's own form (mega_kernel.wgsl:395-428): a
// per-thread stack, leaves swept by their runtime count, children visited
// near-first by this ray's own entry distance. It is not the TPU's
// tile-wide walk, which votes per tile, takes a majority near child and
// gates leaves with lax.cond. It computes what tpurt's walk computes: the
// nearest hit, and the attenuation over (0, t_max). Its plain version is a
// brute-force sweep (tpurt_torch/ops/intersect.py), and it equals it bit
// for bit:
// - a hit is taken on the least (t, scene index), whatever the visit
//   order, so a tie on a shared edge goes to the lower Scene row in both;
// - a node is pruned only when its entry lies strictly beyond the cap
//   (tn > cap), so an equally near, lower-index triangle is never pruned;
// - node boxes are padded on the host (kernels/bvh.py), so a hit that the
//   triangle test accepts is not lost to the slab test's rounding;
// - an axis on which the slab test gives NaN (an axis-aligned ray with its
//   origin on a box plane: 0 * inf) is skipped, which keeps the box (tpurt:
//   NaN votes hit; bvh_pallas.py:540,598).
// The triangle walk is clipped at the sphere hit (cap = min(best, t_sph),
// tpurt's pallas_tri_clip), which is safe because the combine takes a
// triangle only on a strict t_tri < t_sph. Stack overflow is unreachable:
// the host proves each tree's worst-case occupancy (kernels/bvh.py
// pack_tree: assert_stack_fits, accel.wide_max_stack) and sizes the
// launch's stack by it; the trap below never fires.
//
// What bounds it: divergence (neighbouring rays take other paths through
// the tree) and the latency of one dependent fetch per level. The design
// keeps that fetch to one: a node holds its children's boxes and refs
// (kernels/bvh.py pack_tree: two 16-byte rows a child, so a binary node is
// one 64-byte fetch), and a leaf of up to 128 primitives is packed into
// its parent's ref, so reaching it costs no fetch of its own. The stack
// lives in shared memory, one word an entry, interleaved by thread
// (entry e of thread t at e * blockDim.x + t: no bank conflicts), sized per
// launch by the proven depth. The binary walk keeps its two candidates in
// registers and stacks only the far one; the wide walk sorts its up to
// eight candidates in registers with an unrolled odd-even transposition
// network (adjacent swaps on a strict compare: stable, so ties keep slot
// order as the insertion sort before it did). Nodes, triangle records, G
// rows and sphere rows are read as float4; a record's normal, material and
// index are read only once it wins. Still absent: ray sorting, treelets in
// shared memory, a sphere-only instance of the kernels.
//
// The G leaf (cfg.pallas_mxu_leaf; replaces tpurt/kernels/bvh_pallas.py
// _make_mxu_leaf_fn with build_tri_gmat): tpurt's closest-hit leaf test in
// the form linear in f = [d | o x d | o | 1], four dot products per
// triangle against a row of its G matrix and a divide/compare epilogue
// (g_hit). It is not bit-identical to Moller-Trumbore at grazing rays. The
// TPU ran it as four (leaf, 16) x (16, 128) MXU products per 128-lane row
// because the walk left the MXU idle. Here the sums are formed in float32
// without FMA, term by term in the order of the plain version
// (ops/intersect.py _g_hits), so the leaf equals that sweep bit for bit.
// What bounds it is not arithmetic (~50 operations a pair) but how a warp
// reaches its leaves: one thread per ray sweeping its own leaf of up to 64
// (config 6) or 128 rows leaves the warp's other lanes waiting (at inner
// nodes, done, or, in the regen kernel, without a segment this trip), and
// each trip of the sweep reads 32 unrelated 96-byte rows. So the warp
// sweeps together (closest_triangle_g): each lane walks its inner nodes
// and holds the leaf it reaches; the warp takes the held leaves one after
// another, lane j testing rows first + j, first + j + 32, ... (neighbouring
// rows, so a warp's reads of a leaf are contiguous), reduces the least
// (t, scene index) by shuffles, and the leaf's lane takes it and goes on.
// Every lane of the warp helps, with or without a ray of its own: the
// regen kernel's GLEAF instances and the probe call it from all 32 lanes.
// A ray visits the leaves the one-thread walk visits, in the same order
// and with the same cap, so results and pairs tested are unchanged. What
// it costs: a leaf that all 32 lanes reach together, which the one-thread
// sweep read in lockstep at one address, now takes 32 sweeps with a
// shuffle reduction each. A tensor-core form of tpurt's MXU products
// (TF32 mma.sync over the rows of a leaf that several lanes hold, as a
// filter that drops only provable misses before the exact sums) was
// measured beside this design on an H100 and removed: its registers cost
// the regen kernel more than it saved, even where no leaf engaged it
// (PERF.md has the numbers).
#pragma once

#include "device.cuh"

namespace tpurt {

constexpr int TRI_STRIDE = 16;
constexpr int MAX_CHILDREN = 8;
// triangle record: a, e1, e2, unit geometric normal, material, scene index
enum TriField { T_A = 0, T_E1 = 3, T_E2 = 6, T_N = 9, T_MAT = 12,
                T_INDEX = 13 };

// G row (ops/intersect.py G_* and build_gmat): the non-zero coefficients of tpurt's
// four blocks over f = [d | o x d | o | 1] (det of d; u_num of d and of
// o x d; v_num of d and of o x d; t_num of o and of 1), the scene index,
// then the unit normal and material; 96 bytes, 16-byte aligned
enum GField { G_DET = 0, G_UD = 3, G_UX = 6, G_VD = 9, G_VX = 12, G_TO = 15,
              G_TC = 18, G_INDEX = 19, G_N = 20, G_MAT = 23 };
constexpr int G_STRIDE = 24;

// The geometry tables of a launch (kernels/bvh.py GeomArgs). Triangles:
// n_tri records, walked through tri_nodes when tri_walk, else swept flat;
// gmat, their G rows row for row, where the G leaf runs (set by the
// wrappers of the regen kernel and the probe, read only by scene_hit_g).
// Spheres: the flat
// sphere rows of the scene table, plus n_sph_tree rows walked through
// sph_nodes. Node tables: kernels/bvh.py pack_tree. `stack`: the entries a
// walk of either tree may hold, proven on the host; every kernel that
// walks gives each thread that many words of shared memory (WalkStack).
struct Geom {
  const float* tri;
  const float* tri_nodes;
  const float* sph;
  const float* sph_nodes;
  const float* gmat;
  int n_tri;
  int tri_walk;
  int n_sph_tree;
  int stack;
};

// A thread's traversal stack in shared memory: entry e at base[e * stride],
// stride the block's thread count, so a warp's pushes fall in 32 banks.
struct WalkStack {
  int* base;
  int stride;
  int cap;
};

// The stack of the calling thread in a block's region `mem` of
// geom.stack * blockDim.x words.
__device__ __forceinline__ WalkStack walk_stack(int* mem, const Geom& g) {
  WalkStack st;
  st.base = mem + threadIdx.x;
  st.stride = blockDim.x;
  st.cap = g.stack;
  return st;
}

// Bytes of shared memory a block of `threads` needs for its walk stacks.
inline size_t walk_stack_bytes(const Geom& g, int threads) {
  return sizeof(int) * (size_t)g.stack * threads;
}

struct Ray {
  V3 o, d, inv;
};

__device__ __forceinline__ Ray make_ray(V3 o, V3 d) {
  Ray r;
  r.o = o;
  r.d = d;
  r.inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  return r;
}

__device__ __forceinline__ void slab_axis(float bmin, float bmax, float o,
                                          float inv, float& lo, float& hi) {
  float t0 = (bmin - o) * inv;
  float t1 = (bmax - o) * inv;
  if (t0 == t0 && t1 == t1) {
    lo = fmaxf(lo, fminf(t0, t1));
    hi = fminf(hi, fmaxf(t0, t1));
  }
}

// Whether the ray may meet a primitive of the box (lo, hi: the xyz of a
// child's two rows) at t in (0, cap]; tn is the entry distance (the
// near-to-far key). `grow` widens the box by that share of the farthest
// distance (L-inf) from the ray origin to the box: the sphere test's
// discriminant loses a few ulps of |o - c|^2, so a far ray "hits" a sphere
// up to ~5e-4 |o - c| outside its geometric bounds, and at that distance t
// errs by as much; the tree must not prune what the plain sweep accepts.
__device__ __forceinline__ bool node_hit(float4 lo4, float4 hi4, const Ray& r,
                                         float cap, float grow, float& tn) {
  V3 bmin = v3(lo4.x, lo4.y, lo4.z), bmax = v3(hi4.x, hi4.y, hi4.z);
  if (grow > 0.0f) {
    float m = grow * fmaxf(fmaxf(fmaxf(fabsf(r.o.x - bmin.x),
                                       fabsf(r.o.x - bmax.x)),
                                 fmaxf(fabsf(r.o.y - bmin.y),
                                       fabsf(r.o.y - bmax.y))),
                           fmaxf(fabsf(r.o.z - bmin.z),
                                 fabsf(r.o.z - bmax.z)));
    bmin = v3(bmin.x - m, bmin.y - m, bmin.z - m);
    bmax = v3(bmax.x + m, bmax.y + m, bmax.z + m);
  }
  float lo = -kINF(), hi = kINF();
  slab_axis(bmin.x, bmax.x, r.o.x, r.inv.x, lo, hi);
  slab_axis(bmin.y, bmax.y, r.o.y, r.inv.y, lo, hi);
  slab_axis(bmin.z, bmax.z, r.o.z, r.inv.z, lo, hi);
  tn = lo;
  return !(lo > hi || hi <= 0.0f || lo > cap);
}

constexpr int NO_REF = (int)0x80000000;  // no child: never a packed leaf

// Swap two candidates when the first lies strictly farther: adjacent
// swaps on a strict compare keep equal keys in slot order.
__device__ __forceinline__ void order_pair(float& ka, int& ra, float& kb,
                                           int& rb) {
  if (ka > kb) {
    float k = ka; ka = kb; kb = k;
    int r = ra; ra = rb; rb = r;
  }
}

// One ref of bvh_walk's loop, for the G leaf's walk (closest_triangle_g),
// which must stop at a leaf and go on later: a leaf sets first and count;
// an inner node's children are tested against the cap as it stands at
// that moment, the nearest (ties: the lower slot) is returned as the next
// ref and the others stacked far-first. Returns NO_REF where the ref leads
// nowhere further (a leaf, or an inner node whose children all miss). It
// repeats bvh_walk's body rather than serve it, so that the kernels
// without the G leaf keep their machine code.
template <class Query>
__device__ __forceinline__ int walk_ref(const float4* nodes, int ref,
                                        const Ray& r, const Query& q,
                                        const WalkStack& st, int& sp,
                                        int& first, int& count) {
  int next = NO_REF;
  if (ref < 0) {  // a leaf packed into its parent's ref
    first = ~ref & 0xffffff;
    count = (~ref >> 24) + 1;
  } else {
    const float4* nd = nodes + 2 * ref;
    const float4 lo0 = __ldg(nd), hi0 = __ldg(nd + 1);
    const int k = __float_as_int(hi0.w);
    if (k < 0) {  // a leaf record
      first = __float_as_int(lo0.w);
      count = -k;
    } else if (k == 2) {
      const float4 lo1 = __ldg(nd + 2), hi1 = __ldg(nd + 3);
      const float cap = q.cap();
      float t0, t1;
      const bool h0 = node_hit(lo0, hi0, r, cap, Query::kGrow, t0);
      const bool h1 = node_hit(lo1, hi1, r, cap, Query::kGrow, t1);
      const int r0 = __float_as_int(lo0.w), r1 = __float_as_int(lo1.w);
      if (h0 && h1) {
        const bool swap = t1 < t0;  // a tie keeps slot order
        if (sp >= st.cap) __trap();  // unreachable, see the header
        st.base[sp++ * st.stride] = swap ? r0 : r1;
        next = swap ? r1 : r0;
      } else if (h0 || h1) {
        next = h0 ? r0 : r1;
      }
    } else {
      const float cap = q.cap();
      float key[MAX_CHILDREN];
      int rf[MAX_CHILDREN];
#pragma unroll
      for (int c = 0; c < MAX_CHILDREN; ++c) {
        key[c] = kINF();
        rf[c] = NO_REF;
        if (c < k) {
          const float4 lo = c == 0 ? lo0 : __ldg(nd + 2 * c);
          const float4 hi = c == 0 ? hi0 : __ldg(nd + 2 * c + 1);
          float tn;
          if (node_hit(lo, hi, r, cap, Query::kGrow, tn)) {
            key[c] = tn;
            rf[c] = __float_as_int(lo.w);
          }
        }
      }
      // odd-even transposition: MAX_CHILDREN passes sort any input; a
      // missed child keeps key +inf and NO_REF and is skipped below
#pragma unroll
      for (int pass = 0; pass < MAX_CHILDREN; ++pass) {
#pragma unroll
        for (int c = pass & 1; c + 1 < MAX_CHILDREN; c += 2)
          order_pair(key[c], rf[c], key[c + 1], rf[c + 1]);
      }
#pragma unroll
      for (int c = MAX_CHILDREN - 1; c >= 0; --c) {
        if (rf[c] == NO_REF) continue;
        if (next != NO_REF) {
          if (sp >= st.cap) __trap();  // unreachable, see the header
          st.base[sp++ * st.stride] = next;
        }
        next = rf[c];
      }
    }
  }
  return next;
}

// The stack walk shared by the four queries, over a node table of
// kernels/bvh.py pack_tree. `q` supplies kGrow (see node_hit), cap() (the
// distance beyond which nothing can change its answer) and visit(first,
// count), which sweeps a leaf and returns true to end the walk. One trip
// of the loop handles one ref: a leaf is swept, an inner node's children
// are tested against the cap as it stands at that moment, the nearest
// (ties: the lower slot) is taken next and the others stacked far-first.
template <class Query>
__device__ __forceinline__ void bvh_walk(const float* table, const Ray& r,
                                         Query& q, const WalkStack& st) {
  const float4* nodes = reinterpret_cast<const float4*>(table);
  int sp = 0;
  int ref = 0;  // the root
  for (;;) {
    int next = NO_REF;
    int first = 0, count = 0;
    if (ref < 0) {  // a leaf packed into its parent's ref
      first = ~ref & 0xffffff;
      count = (~ref >> 24) + 1;
    } else {
      const float4* nd = nodes + 2 * ref;
      const float4 lo0 = __ldg(nd), hi0 = __ldg(nd + 1);
      const int k = __float_as_int(hi0.w);
      if (k < 0) {  // a leaf record
        first = __float_as_int(lo0.w);
        count = -k;
      } else if (k == 2) {
        const float4 lo1 = __ldg(nd + 2), hi1 = __ldg(nd + 3);
        const float cap = q.cap();
        float t0, t1;
        const bool h0 = node_hit(lo0, hi0, r, cap, Query::kGrow, t0);
        const bool h1 = node_hit(lo1, hi1, r, cap, Query::kGrow, t1);
        const int r0 = __float_as_int(lo0.w), r1 = __float_as_int(lo1.w);
        if (h0 && h1) {
          const bool swap = t1 < t0;  // a tie keeps slot order
          if (sp >= st.cap) __trap();  // unreachable, see the header
          st.base[sp++ * st.stride] = swap ? r0 : r1;
          next = swap ? r1 : r0;
        } else if (h0 || h1) {
          next = h0 ? r0 : r1;
        }
      } else {
        const float cap = q.cap();
        float key[MAX_CHILDREN];
        int rf[MAX_CHILDREN];
#pragma unroll
        for (int c = 0; c < MAX_CHILDREN; ++c) {
          key[c] = kINF();
          rf[c] = NO_REF;
          if (c < k) {
            const float4 lo = c == 0 ? lo0 : __ldg(nd + 2 * c);
            const float4 hi = c == 0 ? hi0 : __ldg(nd + 2 * c + 1);
            float tn;
            if (node_hit(lo, hi, r, cap, Query::kGrow, tn)) {
              key[c] = tn;
              rf[c] = __float_as_int(lo.w);
            }
          }
        }
        // odd-even transposition: MAX_CHILDREN passes sort any input; a
        // missed child keeps key +inf and NO_REF and is skipped below
#pragma unroll
        for (int pass = 0; pass < MAX_CHILDREN; ++pass) {
#pragma unroll
          for (int c = pass & 1; c + 1 < MAX_CHILDREN; c += 2)
            order_pair(key[c], rf[c], key[c + 1], rf[c + 1]);
        }
#pragma unroll
        for (int c = MAX_CHILDREN - 1; c >= 0; --c) {
          if (rf[c] == NO_REF) continue;
          if (next != NO_REF) {
            if (sp >= st.cap) __trap();  // unreachable, see the header
            st.base[sp++ * st.stride] = next;
          }
          next = rf[c];
        }
      }
    }
    if (count > 0 && q.visit(first, count)) return;
    if (next == NO_REF) {
      if (sp == 0) return;
      next = st.base[--sp * st.stride];
    }
    ref = next;
  }
}

// ----- triangles (tpurt_torch/ops/intersect.py _tri_hits) -----

// Moller-Trumbore against one record, in soa.triangle_hit_c's operand
// order; returns whether it is a hit, with its distance in t. The vertex
// and edges come in three 16-byte loads; the fourth row of the record
// (material, index) is left to the caller.
__device__ __forceinline__ bool tri_hit(const float* rec, V3 o, V3 d,
                                        float& t) {
  const float4* p = reinterpret_cast<const float4*>(rec);
  const float4 r0 = __ldg(p), r1 = __ldg(p + 1), r2 = __ldg(p + 2);
  const V3 a = v3(r0.x, r0.y, r0.z), e1 = v3(r0.w, r1.x, r1.y),
           e2 = v3(r1.z, r1.w, r2.x);
  V3 h = vcross(d, e2);
  float det = vdot(e1, h);
  bool small = fabsf(det) < F(1.17549435e-38);
  float inv_det = 1.0f / (small ? 1.0f : det);
  V3 s = vsub(o, a);
  float u = inv_det * vdot(s, h);
  V3 q = vcross(s, e1);
  float v = inv_det * vdot(d, q);
  t = inv_det * vdot(e2, q);
  return !small && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > F(1.17549435e-38);
}

// The nearest triangle so far: the least (t, scene index).
struct TriClosest {
  static constexpr float kGrow = 0.0f;
  const float* tri;
  V3 o, d;
  float clip;  // the sphere hit: nothing beyond it can win the combine
  float t;
  int index;
  const float* rec;

  __device__ __forceinline__ float cap() const { return fminf(t, clip); }
  __device__ __forceinline__ bool visit(int first, int count) {
#pragma unroll 1  // unrolled sweeps cost the path kernels registers
    for (int i = first; i < first + count; ++i) {
      const float* r = tri + i * TRI_STRIDE;
      float ti;
      if (!tri_hit(r, o, d, ti)) continue;
      int idx = (int)__ldg(r + T_INDEX);
      if (ti < t || (ti == t && idx < index)) {
        t = ti;
        index = idx;
        rec = r;
      }
    }
    return false;
  }
};

// tpurt's G-matrix leaf test against one G row (ops/intersect.py _g_hits):
// each sum term by term over ascending features, x = o x d, then the
// epilogue; returns whether it is a hit, with its distance in t and the
// triangle's scene index in idx.
__device__ __forceinline__ bool g_hit(const float* row, V3 o, V3 d, V3 x,
                                      float& t, int& idx) {
  const float4* p = reinterpret_cast<const float4*>(row);
  const float4 c0 = __ldg(p), c1 = __ldg(p + 1), c2 = __ldg(p + 2),
               c3 = __ldg(p + 3), c4 = __ldg(p + 4);
  float det = c0.x * d.x + c0.y * d.y + c0.z * d.z;
  float un = c0.w * d.x + c1.x * d.y + c1.y * d.z + c1.z * x.x + c1.w * x.y +
             c2.x * x.z;
  float vn = c2.y * d.x + c2.z * d.y + c2.w * d.z + c3.x * x.x + c3.y * x.y +
             c3.z * x.z;
  float tn = c3.w * o.x + c4.x * o.y + c4.y * o.z + c4.z;
  const float eps = F(1.17549435e-38);
  float sg = det >= 0.0f ? 1.0f : -1.0f;
  float ad = det * sg, us = un * sg, vs = vn * sg;
  t = tn / (ad >= eps ? det : 1.0f);
  idx = (int)c4.w;
  return ad >= eps && us >= 0.0f && vs >= 0.0f && us <= ad &&
         us + vs <= ad && t > eps;
}

struct TriAny {
  static constexpr float kGrow = 0.0f;
  const float* tri;
  V3 o, d;
  float t_max;
  bool hit;

  __device__ __forceinline__ float cap() const { return t_max; }
  __device__ __forceinline__ bool visit(int first, int count) {
#pragma unroll 1  // unrolled sweeps cost the path kernels registers
    for (int i = first; i < first + count; ++i) {
      float t;
      if (tri_hit(tri + i * TRI_STRIDE, o, d, t) && t < t_max) {
        hit = true;
        break;
      }
    }
    return hit;
  }
};

__device__ __forceinline__ TriClosest closest_triangle(const Geom& g, V3 o,
                                                       V3 d, float clip,
                                                       const WalkStack& st) {
  TriClosest q;
  q.tri = g.tri;
  q.o = o;
  q.d = d;
  q.clip = clip;
  q.t = kMISS();
  q.index = 0x7fffffff;
  q.rec = nullptr;
  if (g.tri_walk) {
    bvh_walk(g.tri_nodes, make_ray(o, d), q, st);
  } else {
    q.visit(0, g.n_tri);
  }
  return q;
}

__device__ __forceinline__ bool occluded_triangle(const Geom& g, V3 o, V3 d,
                                                  float t_max,
                                                  const WalkStack& st) {
  TriAny q;
  q.tri = g.tri;
  q.o = o;
  q.d = d;
  q.t_max = t_max;
  q.hit = false;
  if (g.tri_walk)
    bvh_walk(g.tri_nodes, make_ray(o, d), q, st);
  else
    q.visit(0, g.n_tri);
  return q.hit;
}

// ----- the G leaf: a warp sweeps one leaf at a time -----

// The nearest triangle of a ray by the G leaf: the least (t, scene index)
// and its G row; `pairs` counts the triangles tested (the probe reads it).
struct TriClosestG {
  static constexpr float kGrow = 0.0f;
  float clip;  // the sphere hit, as in TriClosest
  float t;
  int index;
  unsigned pairs;
  const float* row;

  __device__ __forceinline__ float cap() const { return fminf(t, clip); }
};

// Whether (t, i) comes before (bt, bi) in the nearest-hit order.
__device__ __forceinline__ bool g_before(float t, int i, float bt, int bi) {
  return t < bt || (t == bt && i < bi);
}

// The rows [first, first + count) of the G table `g` swept by the whole
// warp for one ray (o, d, x = o x d) whose best so far is (bt, bi): lane j
// tests rows first + j, first + j + 32, ... Returns, alike on every lane,
// whether some row comes before (bt, bi); then (bt, bi) is the least
// (t, scene index) of the rows and brow its row.
__device__ __forceinline__ bool g_sweep_warp(const float* g, int first,
                                             int count, V3 o, V3 d, V3 x,
                                             float& bt, int& bi, int& brow) {
  const unsigned FULL = 0xffffffffu;
  brow = -1;
#pragma unroll 1
  for (int i = first + (int)(threadIdx.x & 31); i < first + count; i += 32) {
    float ti;
    int idx;
    if (g_hit(g + i * G_STRIDE, o, d, x, ti, idx) &&
        g_before(ti, idx, bt, bi)) {
      bt = ti;
      bi = idx;
      brow = i;
    }
  }
  if (!__ballot_sync(FULL, brow >= 0)) return false;
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(FULL, bt, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    const int orow = __shfl_xor_sync(FULL, brow, off);
    if (g_before(ot, oi, bt, bi)) {
      bt = ot;
      bi = oi;
      brow = orow;
    }
  }
  return true;
}

// The nearest triangle of each lane's ray by the G leaf. Every lane of the
// warp calls it at one point; `active` is false on lanes without a ray,
// which only help. Each lane walks its tree (walk_ref) down to its next
// leaf and holds it; the warp then sweeps the held leaves one after
// another, all 32 lanes on each (g_sweep_warp), and each lane goes on
// from its stack with its cap updated. So every ray visits the leaves the
// one-thread walk visits, in the same order, with the same cap, and takes
// the least (t, scene index) of the same pairs: the results are the
// one-thread walk's (and the plain G sweep's) bit for bit. Without a tree
// (tri_walk 0) each ray's one leaf is the whole table.
__device__ __forceinline__ TriClosestG closest_triangle_g(const Geom& g, V3 o,
                                                          V3 d, float clip,
                                                          const WalkStack& st,
                                                          bool active) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const V3 x = vcross(o, d);
  TriClosestG q;
  q.clip = clip;
  q.t = kMISS();
  q.index = 0x7fffffff;
  q.pairs = 0;
  q.row = nullptr;
  const float4* nodes = reinterpret_cast<const float4*>(g.tri_nodes);
  const Ray r = make_ray(o, d);
  bool walking = active && g.tri_walk;
  int first = 0, count = active && !g.tri_walk ? g.n_tri : 0;
  int ref = 0, sp = 0;
  for (;;) {
    // down to this lane's next leaf, or to the end of its walk
    while (walking && count == 0) {
      int next = walk_ref(nodes, ref, r, q, st, sp, first, count);
      if (count > 0) break;
      if (next == NO_REF) {
        if (sp == 0) {
          walking = false;
          break;
        }
        next = st.base[--sp * st.stride];
      }
      ref = next;
    }
    unsigned pend = __ballot_sync(FULL, count > 0);
    if (!pend) return q;
    do {  // the held leaves, one after another, lowest lane first
      const int s = __ffs(pend) - 1;
      pend &= pend - 1;
      const V3 so = v3(__shfl_sync(FULL, o.x, s), __shfl_sync(FULL, o.y, s),
                       __shfl_sync(FULL, o.z, s));
      const V3 sd = v3(__shfl_sync(FULL, d.x, s), __shfl_sync(FULL, d.y, s),
                       __shfl_sync(FULL, d.z, s));
      const V3 sx = v3(__shfl_sync(FULL, x.x, s), __shfl_sync(FULL, x.y, s),
                       __shfl_sync(FULL, x.z, s));
      float bt = __shfl_sync(FULL, q.t, s);
      int bi = __shfl_sync(FULL, q.index, s), brow;
      if (g_sweep_warp(g.gmat, __shfl_sync(FULL, first, s),
                       __shfl_sync(FULL, count, s), so, sd, sx, bt, bi,
                       brow) &&
          lane == s) {
        q.t = bt;
        q.index = bi;
        q.row = g.gmat + brow * G_STRIDE;
      }
    } while (pend);
    if (count > 0) {  // the leaf is swept: on from the stack's top
      q.pairs += (unsigned)count;
      count = 0;
      if (walking && sp > 0)
        ref = st.base[--sp * st.stride];
      else
        walking = false;
    }
  }
}

// ----- spheres: the flat rows, then the tree (tpurt's split_huge_spheres:
// scene-spanning spheres stay flat, the rest are walked) -----

// Sphere trees widen their boxes by kSphereGrow of the distance (node_hit).
constexpr float kSphereGrow = 2e-3f;

struct SphClosest {
  static constexpr float kGrow = kSphereGrow;
  const float* sph;
  V3 o, d;
  float a, inv_a;
  SphBest best;

  __device__ __forceinline__ float cap() const { return best.t; }
  __device__ __forceinline__ bool visit(int first, int count) {
    for (int i = first; i < first + count; ++i)
      sphere_take(sph + i * SPH_STRIDE, o, d, a, inv_a, best);
    return false;
  }
};

struct SphShadow {
  static constexpr float kGrow = kSphereGrow;
  const float* sph;
  V3 o, d;
  float a, inv_a, t_max, lam, atten;

  __device__ __forceinline__ float cap() const { return t_max; }
  __device__ __forceinline__ bool visit(int first, int count) {
    for (int i = first; i < first + count; ++i)
      atten = atten * sphere_factor(sph + i * SPH_STRIDE, o, d, a, inv_a,
                                    t_max, lam);
    return !(atten > 0.0f);
  }
};

template <class Query>
__device__ __forceinline__ void walk_sphere_tree(const Geom& g, Query& q,
                                                 const WalkStack& st) {
  q.sph = g.sph;
  bvh_walk(g.sph_nodes, make_ray(q.o, q.d), q, st);
}

// Nearest sphere of the flat rows (n_flat of them) and the tree.
__device__ __forceinline__ Hit closest_sphere(const float* flat, int n_flat,
                                              const Geom& g, V3 o, V3 d,
                                              const WalkStack& st) {
  SphClosest q;
  q.sph = flat;
  q.o = o;
  q.d = d;
  q.a = vdot(d, d);
  q.inv_a = 1.0f / q.a;
  q.best.t = kMISS();
  q.best.index = 0x7fffffff;
  q.best.row = nullptr;
  q.visit(0, n_flat);
  if (g.n_sph_tree) walk_sphere_tree(g, q, st);
  return sphere_finish(q.best, o, d);
}

// Transmission of o + d*[0, t_max] through the flat rows, in index order,
// then the tree, in walk order.
__device__ __forceinline__ float shadow_spheres(const float* flat, int n_flat,
                                                const Geom& g, V3 o, V3 d,
                                                float t_max, float lam,
                                                const WalkStack& st) {
  SphShadow q;
  q.sph = flat;
  q.o = o;
  q.d = d;
  q.a = vdot(d, d);
  q.inv_a = 1.0f / q.a;
  q.t_max = t_max;
  q.lam = lam;
  q.atten = 1.0f;
  for (int i = 0; i < n_flat; ++i)
    q.atten = q.atten * sphere_factor(flat + i * SPH_STRIDE, o, d, q.a,
                                      q.inv_a, t_max, lam);
  if (g.n_sph_tree && q.atten > 0.0f) walk_sphere_tree(g, q, st);
  return q.atten;
}

// ----- the scene: mega_pallas._make_scene_fns -----

// The triangle at t takes the nearest hit: its point o + n*1e-5 + d*t
// (_tri_state_finish), its unit normal and material read from nm, which
// points at [nx ny nz mat] in a record (T_N) or a G row (G_N): read only
// now, for the one record that won.
static_assert(T_MAT == T_N + 3 && G_MAT == G_N + 3, "normal, then material");
__device__ __forceinline__ void take_triangle(Hit& h, V3 o, V3 d, float t,
                                              const float* nm) {
  h.t = t;
  h.n = v3(__ldg(nm), __ldg(nm + 1), __ldg(nm + 2));
  h.loc = vadd(vadd(o, vscale(h.n, F(1e-5))), vscale(d, t));
  h.mat = (int)__ldg(nm + 3);
}

// Nearest hit: spheres first, then the triangles clipped at the sphere
// hit; a triangle wins only on a strict t_tri < t_sph (_combine_nearest).
__device__ __forceinline__ Hit scene_hit(const float* flat, int n_flat,
                                         const Geom& g, const WalkStack& st,
                                         V3 o, V3 d) {
  Hit h = closest_sphere(flat, n_flat, g, o, d, st);
  if (g.n_tri) {
    TriClosest tc = closest_triangle(g, o, d, h.t, st);
    if (tc.t < h.t) take_triangle(h, o, d, tc.t, tc.rec + T_N);
  }
  return h;
}

// The nearest hit with the G leaf for the triangles (g.gmat; the kernels'
// GLEAF instances), which adds its pairs tested to *pairs when pairs is
// not null. Every lane of the warp calls it at one point; `active` is
// false on lanes without a ray, which only help sweep the others' leaves
// (closest_triangle_g) and get a miss.
__device__ __forceinline__ Hit scene_hit_g(const float* flat, int n_flat,
                                           const Geom& g, const WalkStack& st,
                                           V3 o, V3 d, bool active,
                                           unsigned* pairs = nullptr) {
  Hit h;
  h.t = kMISS();
  h.loc = h.n = v3(0.0f, 0.0f, 0.0f);
  h.mat = 0;
  if (active) h = closest_sphere(flat, n_flat, g, o, d, st);
  if (g.n_tri) {
    const TriClosestG tc = closest_triangle_g(g, o, d, h.t, st, active);
    if (pairs) *pairs += tc.pairs;
    if (tc.t < h.t) take_triangle(h, o, d, tc.t, tc.row + G_N);
  }
  return h;
}

// Shadow factor: the spheres' transmission, 0 where a triangle occludes
// (a segment the spheres already block is not walked).
__device__ __forceinline__ float scene_shadow(const float* flat, int n_flat,
                                              const Geom& g,
                                              const WalkStack& st, V3 o, V3 d,
                                              float t_max, float lam) {
  float atten = shadow_spheres(flat, n_flat, g, o, d, t_max, lam, st);
  if (g.n_tri && atten != 0.0f && occluded_triangle(g, o, d, t_max, st))
    return 0.0f;
  return atten;
}

}  // namespace tpurt
