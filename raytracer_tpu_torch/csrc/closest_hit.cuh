// The ONE device copy of the per-primitive closest-hit candidate math.
//
// Port of raytracer_tpu/ops/closest_hit_body.py (make_sphere_body,
// make_quad_body). Every kernel (intersect, persistent, wavefront-step and
// culled) includes it, so a numerical fix cannot drift between them. Its plain twin is
// raytracer_tpu_torch/ops/intersect_kernel.py:closest_hit_scaled.
//
// It also holds the nudged inverse direction of the cluster slab tests
// (kernels 2 and 4).
//
// Conventions:
// * spheres are float4 rows [cx, cy, cz, |c|^2 - r^2] (1e30 for dummy rows);
//   quads are three float4 per row: [n.x n.y n.z n.Q] [av.x av.y av.z bv.x]
//   [bv.y bv.z Q.av Q.bv] (zero normal for dummy rows);
// * candidates compare in scaled t-space, t' = t*a with a = |d|^2 > 0; the
//   caller rescales the winner once;
// * a sphere whose discriminant is not >= 0 (negative, or NaN) is missed:
//   the root is taken of 1.0 instead and the candidate is +inf. That keeps
//   misses, nearly every candidate, off the IEEE square root's slow path:
//   on sm_90 sqrtf is MUFU.RSQ plus a range check that CALLs a subroutine
//   for any argument outside the positive normal range (22 instructions and
//   a branch pair per candidate; utils/sass_loop.py counts them). The bits
//   are the twin's (ops/intersect_kernel.py:candidates_scaled), which takes
//   torch.sqrt of a negative discriminant and lets its NaN compares fall
//   through to +inf: for disc >= 0 (+-0 included) every operation is the
//   same, and for the rest both give +inf. sqrtf stays IEEE (correctly
//   rounded, as torch.sqrt): never --use_fast_math, rsqrtf or __fsqrt_*;
// * strict open interval t > T_MIN, and a strict `<` keeps the first minimal
//   candidate on ties (spheres before quads, lower row first). Sphere rows
//   go in groups of four: a group whose four discriminants are all
//   negative takes no root and no compare (sphere_candidates_range).
//
// All threads of a warp read the same table row in the same step, so the
// __ldg loads are broadcasts served from L1. (Staging the tables in shared
// memory measured slower on an H100: PERF.md, section 6.)
#pragma once

#include <math.h>

namespace rt {

constexpr float T_MIN = 1e-3f;
constexpr float QUAD_DENOM_EPS = 1e-8f;
// Sign-preserving stand-in for a zero direction component in a slab test:
// (bmin - o) * (1/0) is 0 * inf = NaN for an origin on the box plane, and a
// NaN compare would cull a box the ray hits.
constexpr float SLAB_TINY = 1e-30f;

// 1 / d with |d| < SLAB_TINY nudged to +-SLAB_TINY (the TPU kernels' _safe).
static __device__ __forceinline__ float slab_inv(float d) {
  const float safe = fabsf(d) < SLAB_TINY ? (d < 0.0f ? -SLAB_TINY : SLAB_TINY) : d;
  return 1.0f / safe;
}

struct RayTerms {
  float ox, oy, oz, dx, dy, dz;
  float a;        // |d|^2
  float d_dot_o;  // d.o
  float o_sq;     // |o|^2
  float tmin_a;   // T_MIN * a
};

static __device__ __forceinline__ RayTerms ray_terms(float ox, float oy, float oz,
                                                     float dx, float dy, float dz) {
  RayTerms r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.a = dx * dx + dy * dy + dz * dz;
  r.d_dot_o = dx * ox + dy * oy + dz * oz;
  r.o_sq = ox * ox + oy * oy + oz * oz;
  r.tmin_a = T_MIN * r.a;
  return r;
}

// The discriminant terms of one sphere row: half_b and disc of the scaled
// quadratic.
static __device__ __forceinline__ void sphere_disc(const float4 s, const RayTerms& r,
                                                   float& half_b, float& disc) {
  const float d_dot_c = r.dx * s.x + r.dy * s.y + r.dz * s.z;
  const float o_dot_c = r.ox * s.x + r.oy * s.y + r.oz * s.z;
  half_b = r.d_dot_o - d_dot_c;
  const float c = r.o_sq - 2.0f * o_dot_c + s.w;
  disc = half_b * half_b - r.a * c;
}

// The scaled-t candidate of a sphere row from its discriminant terms (+inf
// when missed).
static __device__ __forceinline__ float sphere_root(float half_b, float disc,
                                                    const RayTerms& r) {
  const bool real = disc >= 0.0f;  // false for NaN too
  const float sq = sqrtf(real ? disc : 1.0f);
  const float nhb = -half_b;
  const float t0s = nhb - sq;
  const float t1s = nhb + sq;
  const float t_cand = (t0s > r.tmin_a) ? t0s : ((t1s > r.tmin_a) ? t1s : INFINITY);
  return real ? t_cand : INFINITY;
}

// The scaled t of a sphere winner recomputed from its centre (row s) and
// radius by the stable quadratic: oc = o - c, and the discriminant from the
// perpendicular l = oc - (d.oc / |d|^2) d as |d|^2 (radius^2 - |l|^2), which
// keeps its digits where |c|^2 - r^2 (the table's fold) has lost them: a
// grazing hit of a small sphere far from the origin then lies on its sphere,
// not up to ~5e-4 inside it, and the path does not re-hit it. The fold
// rounds at about |o|^2 + |c|^2, the stable form at about r (|oc| + r), so
// the stable root is taken only for a sphere with 4 r^2 < |o|^2 + |c|^2: a
// ground sphere (r = 1000 at |c| = 1000, whose fold is exactly 0) keeps the
// search's t_best, as does a winner whose two stable roots are both <=
// T_MIN. Twin: ops/intersect_kernel.py:refine_sphere_winners (the same
// operations, in order).
static __device__ __forceinline__ float sphere_winner_t(const float4 s, float radius,
                                                        const RayTerms& r, float t_best) {
  const float ocx = r.ox - s.x;
  const float ocy = r.oy - s.y;
  const float ocz = r.oz - s.z;
  const float hb = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float k = hb / r.a;
  const float lx = ocx - k * r.dx;
  const float ly = ocy - k * r.dy;
  const float lz = ocz - k * r.dz;
  const float h2 = radius * radius - (lx * lx + ly * ly + lz * lz);
  const float sq = sqrtf(r.a * fmaxf(h2, 0.0f));
  const float nhb = -hb;
  const float t0s = nhb - sq;
  const float t1s = nhb + sq;
  const float t_new = (t0s > r.tmin_a) ? t0s : ((t1s > r.tmin_a) ? t1s : t_best);
  const float c_sq = s.x * s.x + s.y * s.y + s.z * s.z;
  return (4.0f * radius * radius < r.o_sq + c_sq) ? t_new : t_best;
}

// Sphere rows per group of sphere_candidates_range.
constexpr int SPHERE_GROUP = 4;

// Sphere candidates of table rows [begin, end); the recorded prim id is the
// table row. Rows go in groups of SPHERE_GROUP: the discriminants of a
// group first, then, only if one of them is >= 0, the roots and the compare
// chain in row order. Nearly every group misses, so a lane pays the
// discriminants and one branch for most of the table.
static __device__ __forceinline__ void sphere_candidates_range(
    const float4* __restrict__ sph, int begin, int end, const RayTerms& r,
    float& t_best, int& p_best) {
  int i = begin;
  for (; i + SPHERE_GROUP <= end; i += SPHERE_GROUP) {
    float half_b[SPHERE_GROUP], disc[SPHERE_GROUP];
    bool any_real = false;
#pragma unroll
    for (int k = 0; k < SPHERE_GROUP; ++k) {
      sphere_disc(__ldg(sph + i + k), r, half_b[k], disc[k]);
      any_real |= disc[k] >= 0.0f;
    }
    if (!any_real) continue;  // every row of the group missed: no root
#pragma unroll
    for (int k = 0; k < SPHERE_GROUP; ++k) {
      const float t_cand = sphere_root(half_b[k], disc[k], r);
      if (t_cand < t_best) {
        t_best = t_cand;
        p_best = i + k;
      }
    }
  }
  for (; i < end; ++i) {
    float half_b, disc;
    sphere_disc(__ldg(sph + i), r, half_b, disc);
    const float t_cand = sphere_root(half_b, disc, r);
    if (t_cand < t_best) {
      t_best = t_cand;
      p_best = i;
    }
  }
}

// Sphere candidates of the whole table.
static __device__ __forceinline__ void sphere_candidates(
    const float4* __restrict__ sph, int ns, const RayTerms& r,
    float& t_best, int& p_best) {
  sphere_candidates_range(sph, 0, ns, r, t_best, p_best);
}

// Quad candidates of table rows [begin, end); the recorded prim id is
// prim_offset + row (callers pass their sphere count, so quads number after
// spheres).
static __device__ __forceinline__ void quad_candidates_range(
    const float4* __restrict__ quad, int begin, int end, int prim_offset, const RayTerms& r,
    float& t_best, int& p_best) {
  for (int qi = begin; qi < end; ++qi) {
    const float4 q0 = __ldg(quad + 3 * qi);
    const float4 q1 = __ldg(quad + 3 * qi + 1);
    const float4 q2 = __ldg(quad + 3 * qi + 2);
    const float d_n = r.dx * q0.x + r.dy * q0.y + r.dz * q0.z;
    const float o_n = r.ox * q0.x + r.oy * q0.y + r.oz * q0.z;
    const bool denom_ok = fabsf(d_n) >= QUAD_DENOM_EPS;
    const float t = (q0.w - o_n) / (denom_ok ? d_n : 1.0f);
    // av = (q1.x, q1.y, q1.z), bv = (q1.w, q2.x, q2.y)
    const float alpha = (r.ox * q1.x + r.oy * q1.y + r.oz * q1.z) +
                        t * (r.dx * q1.x + r.dy * q1.y + r.dz * q1.z) - q2.z;
    const float beta = (r.ox * q1.w + r.oy * q2.x + r.oz * q2.y) +
                       t * (r.dx * q1.w + r.dy * q2.x + r.dz * q2.y) - q2.w;
    const bool ok = denom_ok && (t > T_MIN) && (alpha >= 0.0f) && (alpha <= 1.0f) &&
                    (beta >= 0.0f) && (beta <= 1.0f);
    const float t_cand = ok ? t * r.a : INFINITY;
    if (t_cand < t_best) {
      t_best = t_cand;
      p_best = prim_offset + qi;
    }
  }
}

// Quad candidates of the whole table.
static __device__ __forceinline__ void quad_candidates(
    const float4* __restrict__ quad, int nq, int prim_offset, const RayTerms& r,
    float& t_best, int& p_best) {
  quad_candidates_range(quad, 0, nq, prim_offset, r, t_best, p_best);
}

}  // namespace rt
