// The ONE device copy of the two-level cluster walk (kernel 2's kCull
// instantiations, kernel 1's clustered entry, kernel 4).
//
// Port of the TPU kernels' cluster-culled sphere and quad loops
// (raytracer_tpu/ops/persistent_kernel.py:457-545, 571-602) for scenes that
// geometry/bvh.py:cluster_scene permuted into cluster order. The cluster
// table (ops/persistent_kernel.py:ClusterTable) holds, per kind, super rows
// whose [start, count) index fine rows and fine rows whose [start, count)
// index the primitive table, each with its AABB. Per ray and kind, in row
// order: slab-test each super; if it can be hit, slab-test its fine rows;
// for each fine row that can be hit, test its primitives
// (closest_hit.cuh's *_candidates_range). With no super level the fine rows
// are walked directly; with no rows of a kind its dense loop runs.
//
// Culling only skips clusters that cannot hold a strictly closer hit, and a
// strict `<` keeps the first minimal candidate, so the result equals the
// dense search in the visit order (supers, their fine rows, each row's
// range), ties included: ops/cluster_visit.py:ClusterVisit.hit is the twin
// of every caller's closest hit. Entering more clusters than a lane's own
// tests ask for never changes that result (the minimum over a superset of
// the rows that holds the winner is the winner), which is what lets a warp
// vote.
//
// Two walk policies (a template parameter):
// * WALK_PER_LANE: each lane branches on its own slab tests. A warp runs a
//   loop while any of its lanes is in it. Needed wherever lanes leave at
//   different times (kernel 2's early return and queue break): a __any_sync
//   over exited lanes is undefined. Kernel 2 and kernel 1's bounce rays.
// * WALK_WARP_VOTE: the warp enters a super or a fine row when any of its
//   lanes' tests does (__any_sync), so every branch of the walk is uniform.
//   Every lane of the warp must be alive to the end of the walk. Kernel 4's
//   coherent camera rays, where a warp's lanes enter nearly the same rows.
#pragma once

#include "closest_hit.cuh"

namespace rt {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int WALK_PER_LANE = 0;
constexpr int WALK_WARP_VOTE = 1;

// Padding (in t) of a cluster's slab interval on each side. A bounce ray
// starts on a surface, and the expanded-form sphere test can re-hit that
// surface just past T_MIN at a point outside the sphere's own box, where
// the TPU kernel's unpadded test would cull a candidate that the dense
// search keeps. Padding only enters more clusters, so the result stays the
// dense search's. ops/persistent_kernel.py:CLUSTER_SLAB_PAD.
constexpr float SLAB_PAD = 4e-3f;

// Cluster inputs: (R, 8) rows, two float4 a row [min.x min.y min.z max.x]
// [max.y max.z start count], in the sections [sphere supers | sphere fine |
// quad supers | quad fine] of the given lengths.
struct CullArgs {
  const float4* rows;
  int s_super, s_fine, q_super, q_fine;
};

// Can the ray hit the AABB of cluster row `row` before its current best
// (scaled t)? The TPU kernel's _can_hit, per lane, on the padded interval:
// nudged inverse direction (rt::slab_inv), lo clamped to T_MIN, and
// `lo*a < min(hi*a, t_best)` in scaled-t space.
static __device__ __forceinline__ bool cluster_enters(float4 b0, float4 b1, const RayTerms& r,
                                                      float ix, float iy, float iz,
                                                      float t_best) {
  const float tx0 = (b0.x - r.ox) * ix;
  const float tx1 = (b0.w - r.ox) * ix;
  float lo = fminf(tx0, tx1);
  float hi = fmaxf(tx0, tx1);
  const float ty0 = (b0.y - r.oy) * iy;
  const float ty1 = (b1.x - r.oy) * iy;
  lo = fmaxf(lo, fminf(ty0, ty1));
  hi = fminf(hi, fmaxf(ty0, ty1));
  const float tz0 = (b0.z - r.oz) * iz;
  const float tz1 = (b1.y - r.oz) * iz;
  lo = fmaxf(lo, fminf(tz0, tz1));
  hi = fminf(hi, fmaxf(tz0, tz1));
  lo = fmaxf(lo - SLAB_PAD, T_MIN);
  return lo * r.a < fminf((hi + SLAB_PAD) * r.a, t_best);
}

// A lane's decision to enter a row under the walk policy.
template <int kWalk>
static __device__ __forceinline__ bool walk_enters(bool mine) {
  return kWalk == WALK_WARP_VOTE ? __any_sync(FULL_MASK, mine) : mine;
}

// One kind's two-level walk: supers at rows [super_base, super_base +
// n_super) (none: every fine row), fine rows at fine_base + their index;
// test(begin, end) runs the primitive range of each fine row entered.
// `t_best` is the caller's running best, which test() lowers.
template <int kWalk = WALK_PER_LANE, typename Test>
static __device__ __forceinline__ void cluster_walk(const float4* __restrict__ rows,
                                                    int super_base, int n_super, int fine_base,
                                                    int n_fine, const RayTerms& r, float ix,
                                                    float iy, float iz, const float& t_best,
                                                    Test test) {
  const int n_outer = n_super > 0 ? n_super : 1;
  for (int si = 0; si < n_outer; ++si) {
    int f_lo = 0, f_hi = n_fine;
    if (n_super > 0) {
      const float4 s0 = __ldg(rows + 2 * (super_base + si));
      const float4 s1 = __ldg(rows + 2 * (super_base + si) + 1);
      if (!walk_enters<kWalk>(cluster_enters(s0, s1, r, ix, iy, iz, t_best))) continue;
      f_lo = (int)s1.z;
      f_hi = f_lo + (int)s1.w;
    }
    for (int fi = f_lo; fi < f_hi; ++fi) {
      const float4 b0 = __ldg(rows + 2 * (fine_base + fi));
      const float4 b1 = __ldg(rows + 2 * (fine_base + fi) + 1);
      if (walk_enters<kWalk>(cluster_enters(b0, b1, r, ix, iy, iz, t_best))) {
        const int start = (int)b1.z;
        test(start, start + (int)b1.w);
      }
    }
  }
}

// The closest hit of one ray over cluster-ordered sphere and quad tables:
// each kind's two-level walk, or its dense loop where the table has no
// rows of that kind. `t_best` (scaled t) and `p_best` (table row; quads
// after the ns spheres) carry the running best in and the winner out.
template <int kWalk = WALK_PER_LANE>
static __device__ __forceinline__ void clustered_candidates(
    const CullArgs& cull, const float4* __restrict__ sph, int ns,
    const float4* __restrict__ quad, int nq, const RayTerms& r, float& t_best, int& p_best) {
  const float ix = slab_inv(r.dx);
  const float iy = slab_inv(r.dy);
  const float iz = slab_inv(r.dz);
  if (cull.s_fine > 0) {
    cluster_walk<kWalk>(cull.rows, 0, cull.s_super, cull.s_super, cull.s_fine, r, ix, iy, iz,
                        t_best, [&](int b, int e) {
                          sphere_candidates_range(sph, b, e, r, t_best, p_best);
                        });
  } else {
    sphere_candidates(sph, ns, r, t_best, p_best);
  }
  if (cull.q_fine > 0) {
    const int q_base = cull.s_super + cull.s_fine;
    cluster_walk<kWalk>(cull.rows, q_base, cull.q_super, q_base + cull.q_super, cull.q_fine, r,
                        ix, iy, iz, t_best, [&](int b, int e) {
                          quad_candidates_range(quad, b, e, ns, r, t_best, p_best);
                        });
  } else {
    quad_candidates(quad, nq, ns, r, t_best, p_best);
  }
}

}  // namespace rt
