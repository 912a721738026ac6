// BVH walks of the path kernels: closest hit and occlusion against the
// triangle tree, closest hit and shadow factor against the sphere tree,
// one thread per ray.
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
// per-thread stack of STACK_DEPTH entries, leaves swept by their runtime
// count, children pushed far-first so the nearest (by this ray's own
// entry distance) pops first. It is not the TPU's tile-wide walk, which
// votes per tile, takes a majority near child and gates leaves with
// lax.cond. It computes what tpurt's walk computes: the nearest hit, and
// the attenuation over (0, t_max). Its plain version is a brute-force
// sweep (tpurt_torch/ops/intersect.py), and it equals it bit for bit:
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
// the host proves each tree's worst-case occupancy fits (kernels/bvh.py
// assert_stack_fits, accel.wide_max_stack); the trap below never fires.
//
// What bounds it: divergence (neighbouring rays take other paths through
// the tree), dependent loads (each pop waits on a node record from global
// memory) and the stack in local memory. This first version keeps nodes
// and records in global memory (through L1/L2) and the stack in local
// memory, with no shared-memory stack, no treelets, no ray sorting.
#pragma once

#include "device.cuh"

namespace tpurt {

constexpr int STACK_DEPTH = 64;
constexpr int TRI_STRIDE = 16;
constexpr int NODE_STRIDE = 16;
constexpr int MAX_CHILDREN = 8;
// node record: padded box, leaf range, children (0 = absent; binary
// nodes use the first two slots); a node is a leaf iff count > 0
enum NodeField { N_BMIN = 0, N_BMAX = 3, N_FIRST = 6, N_COUNT = 7,
                 N_CHILD = 8 };
// triangle record: a, e1, e2, unit geometric normal, material, scene index
enum TriField { T_A = 0, T_E1 = 3, T_E2 = 6, T_N = 9, T_MAT = 12,
                T_INDEX = 13 };

// The geometry tables of a launch (kernels/bvh.py GeomArgs). Triangles:
// n_tri records, walked through tri_nodes when tri_walk, else swept flat.
// Spheres: the flat sphere rows of the scene table, plus n_sph_tree rows
// walked through sph_nodes.
struct Geom {
  const float* tri;
  const float* tri_nodes;
  const float* sph;
  const float* sph_nodes;
  int n_tri;
  int tri_walk;
  int n_sph_tree;
};

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

// Whether the ray may meet a primitive of the node at t in (0, cap]; tn
// is the entry distance (the near-to-far key). `grow` widens the box by
// that share of the farthest distance (L-inf) from the ray origin to the
// box: the sphere test's discriminant loses a few ulps of |o - c|^2, so a
// far ray "hits" a sphere up to ~5e-4 |o - c| outside its geometric
// bounds, and at that distance t errs by as much; the tree must not prune
// what the plain sweep accepts.
__device__ __forceinline__ bool node_hit(const float* nd, const Ray& r,
                                         float cap, float grow, float& tn) {
  V3 bmin = load3(nd + N_BMIN), bmax = load3(nd + N_BMAX);
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

// The stack walk shared by the four queries. `q` supplies kGrow (see
// node_hit), cap() (the distance beyond which nothing can change its
// answer) and visit(first, count), which sweeps a leaf and returns true to
// end the walk.
template <class Query>
__device__ __forceinline__ void bvh_walk(const float* nodes, const Ray& r,
                                         Query& q) {
  int stack[STACK_DEPTH];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const float* nd = nodes + stack[--sp] * NODE_STRIDE;
    const int count = (int)nd[N_COUNT];
    if (count > 0) {
      if (q.visit((int)nd[N_FIRST], count)) return;
      continue;
    }
    const float cap = q.cap();
    int ids[MAX_CHILDREN];
    float keys[MAX_CHILDREN];
    int n = 0;
    for (int c = 0; c < MAX_CHILDREN; ++c) {
      const int id = (int)nd[N_CHILD + c];
      if (id == 0) break;
      float tn;
      if (!node_hit(nodes + id * NODE_STRIDE, r, cap, Query::kGrow, tn))
        continue;
      int k = n++;
      for (; k > 0 && keys[k - 1] > tn; --k) {  // stable: ties keep slot order
        keys[k] = keys[k - 1];
        ids[k] = ids[k - 1];
      }
      keys[k] = tn;
      ids[k] = id;
    }
    if (sp + n > STACK_DEPTH) __trap();  // unreachable, see the header
    for (int k = n - 1; k >= 0; --k) stack[sp++] = ids[k];
  }
}

// ----- triangles (tpurt_torch/ops/intersect.py _tri_hits) -----

// Moller-Trumbore against one record, in soa.triangle_hit_c's operand
// order; returns whether it is a hit, with its distance in t.
__device__ __forceinline__ bool tri_hit(const float* rec, V3 o, V3 d,
                                        float& t) {
  const V3 a = load3(rec + T_A), e1 = load3(rec + T_E1),
           e2 = load3(rec + T_E2);
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
    for (int i = first; i < first + count; ++i) {
      const float* r = tri + i * TRI_STRIDE;
      float ti;
      if (!tri_hit(r, o, d, ti)) continue;
      int idx = (int)r[T_INDEX];
      if (ti < t || (ti == t && idx < index)) {
        t = ti;
        index = idx;
        rec = r;
      }
    }
    return false;
  }
};

struct TriAny {
  static constexpr float kGrow = 0.0f;
  const float* tri;
  V3 o, d;
  float t_max;
  bool hit;

  __device__ __forceinline__ float cap() const { return t_max; }
  __device__ __forceinline__ bool visit(int first, int count) {
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
                                                       V3 d, float clip) {
  TriClosest q;
  q.tri = g.tri;
  q.o = o;
  q.d = d;
  q.clip = clip;
  q.t = kMISS();
  q.index = 0x7fffffff;
  q.rec = nullptr;
  if (g.tri_walk) {
    bvh_walk(g.tri_nodes, make_ray(o, d), q);
  } else {
    q.visit(0, g.n_tri);
  }
  return q;
}

__device__ __forceinline__ bool occluded_triangle(const Geom& g, V3 o, V3 d,
                                                  float t_max) {
  TriAny q;
  q.tri = g.tri;
  q.o = o;
  q.d = d;
  q.t_max = t_max;
  q.hit = false;
  if (g.tri_walk)
    bvh_walk(g.tri_nodes, make_ray(o, d), q);
  else
    q.visit(0, g.n_tri);
  return q.hit;
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
__device__ __forceinline__ void walk_sphere_tree(const Geom& g, Query& q) {
  q.sph = g.sph;
  bvh_walk(g.sph_nodes, make_ray(q.o, q.d), q);
}

// Nearest sphere of the flat rows (n_flat of them) and the tree.
__device__ __forceinline__ Hit closest_sphere(const float* flat, int n_flat,
                                              const Geom& g, V3 o, V3 d) {
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
  if (g.n_sph_tree) walk_sphere_tree(g, q);
  return sphere_finish(q.best, o, d);
}

// Transmission of o + d*[0, t_max] through the flat rows, in index order,
// then the tree, in walk order.
__device__ __forceinline__ float shadow_spheres(const float* flat, int n_flat,
                                                const Geom& g, V3 o, V3 d,
                                                float t_max, float lam) {
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
  if (g.n_sph_tree && q.atten > 0.0f) walk_sphere_tree(g, q);
  return q.atten;
}

// ----- the scene: mega_pallas._make_scene_fns -----

// Nearest hit: spheres first, then the triangles clipped at the sphere
// hit; a triangle wins only on a strict t_tri < t_sph (_combine_nearest),
// its point o + n*1e-5 + d*t (_tri_state_finish).
__device__ __forceinline__ Hit scene_hit(const float* flat, int n_flat,
                                         const Geom& g, V3 o, V3 d) {
  Hit h = closest_sphere(flat, n_flat, g, o, d);
  if (g.n_tri) {
    TriClosest tc = closest_triangle(g, o, d, h.t);
    if (tc.t < h.t) {
      h.t = tc.t;
      h.n = load3(tc.rec + T_N);
      h.loc = vadd(vadd(o, vscale(h.n, F(1e-5))), vscale(d, tc.t));
      h.mat = (int)tc.rec[T_MAT];
    }
  }
  return h;
}

// Shadow factor: the spheres' transmission, 0 where a triangle occludes
// (a segment the spheres already block is not walked).
__device__ __forceinline__ float scene_shadow(const float* flat, int n_flat,
                                              const Geom& g, V3 o, V3 d,
                                              float t_max, float lam) {
  float atten = shadow_spheres(flat, n_flat, g, o, d, t_max, lam);
  if (g.n_tri && atten != 0.0f && occluded_triangle(g, o, d, t_max))
    return 0.0f;
  return atten;
}

}  // namespace tpurt
