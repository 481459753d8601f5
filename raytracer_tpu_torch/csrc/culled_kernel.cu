// Kernel 4: cluster-culled closest hit for coherent camera rays in large
// scenes.
//
// Replaces raytracer_tpu/ops/culled_kernel.py:intersect_pallas_culled
// (_culled_kernel), which slab-tested a (128 x 128)-ray VMEM tile against
// each cluster AABB and skipped the cluster's sphere loop with a
// tile-uniform lax.cond when no ray of the tile could hit it.
//
// What bounds it on an H100: arithmetic, ~21 FP32 operations per sphere
// test of a cluster that is entered, plus ~30 per slab test. Each ray reads
// 24 bytes and writes 8, so bytes are far below it. With perfect per-ray
// culling a camera ray tests only the spheres of the clusters its own slab
// test enters; a warp runs a cluster's loop when any of its 32 rays enters.
//
// Design (right before fast): one thread per ray. Every thread walks the G
// clusters in the front-to-back order of its warp's octant, taken from the
// warp's first ray (the TPU took the tile's first ray), so the loop and the
// warp vote stay uniform; the ragged last warp keeps its lanes alive on the
// last ray and writes nothing for them. Per cluster: the conservative slab
// test (zero direction components nudged to +-1e-30, as in the TPU kernel)
// against the ray's own running best hit; `__any_sync` over the warp decides
// whether the warp runs the cluster's sphere loop (csrc/closest_hit.cuh,
// the same scaled-t arithmetic as kernel 1, so each candidate t is
// bit-identical to kernel 1's). Then the quads, brute force. The winning
// cluster-ordered row maps to its global sphere id by a per-lane gather,
// which is cheap here (the TPU did it in XLA). Shared-memory staging of the
// cluster table is later work.
//
// Plain twin (and spec): raytracer_tpu_torch/ops/culled_kernel.py:
// intersect_culled_plain, the same search without culling.

#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

using rt::slab_inv;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// clusters: G rows of two float4, [min.x min.y min.z max.x] [max.y max.z start count].
__global__ void culled_kernel(const float4* __restrict__ clusters, int g,
                              const int* __restrict__ order,
                              const float4* __restrict__ sph_cl,
                              const int* __restrict__ orig_ids, int ns_total,
                              const float4* __restrict__ quad, int nq,
                              const float* __restrict__ origin,
                              const float* __restrict__ direction, int n,
                              float* __restrict__ t_out, int* __restrict__ prim_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  const int j = valid ? i : n - 1;  // the ragged warp's extra lanes ride along
  const rt::RayTerms r = rt::ray_terms(origin[3 * j], origin[3 * j + 1], origin[3 * j + 2],
                                       direction[3 * j], direction[3 * j + 1],
                                       direction[3 * j + 2]);
  const float inv_a = 1.0f / r.a;
  const float inv_dx = slab_inv(r.dx);
  const float inv_dy = slab_inv(r.dy);
  const float inv_dz = slab_inv(r.dz);

  // Octant of the warp's first ray (blockDim is a multiple of 32).
  const float dx0 = __shfl_sync(FULL_MASK, r.dx, 0);
  const float dy0 = __shfl_sync(FULL_MASK, r.dy, 0);
  const float dz0 = __shfl_sync(FULL_MASK, r.dz, 0);
  const int oct = (dx0 > 0.0f ? 1 : 0) + (dy0 > 0.0f ? 2 : 0) + (dz0 > 0.0f ? 4 : 0);
  const int* __restrict__ ord = order + oct * g;

  float t_best = INFINITY;
  int p_best = -1;
  for (int ci = 0; ci < g; ++ci) {
    const int c = __ldg(ord + ci);
    const float4 b0 = __ldg(clusters + 2 * c);
    const float4 b1 = __ldg(clusters + 2 * c + 1);
    // Slab test in plain t against the running best (t_best is scaled).
    const float tx0 = (b0.x - r.ox) * inv_dx;
    const float tx1 = (b0.w - r.ox) * inv_dx;
    float lo = fminf(tx0, tx1);
    float hi = fmaxf(tx0, tx1);
    const float ty0 = (b0.y - r.oy) * inv_dy;
    const float ty1 = (b1.x - r.oy) * inv_dy;
    lo = fmaxf(lo, fminf(ty0, ty1));
    hi = fminf(hi, fmaxf(ty0, ty1));
    const float tz0 = (b0.z - r.oz) * inv_dz;
    const float tz1 = (b1.y - r.oz) * inv_dz;
    lo = fmaxf(lo, fminf(tz0, tz1));
    hi = fminf(hi, fmaxf(tz0, tz1));
    lo = fmaxf(lo, rt::T_MIN);
    hi = fminf(hi, t_best * inv_a);
    if (__any_sync(FULL_MASK, valid && lo < hi)) {
      const int start = (int)b1.z;
      rt::sphere_candidates_range(sph_cl, start, start + (int)b1.w, r, t_best, p_best);
    }
  }
  rt::quad_candidates(quad, nq, ns_total, r, t_best, p_best);
  if (valid) {
    t_out[i] = t_best * inv_a;  // back from scaled-t space (INF stays INF)
    prim_out[i] = (p_best >= 0 && p_best < ns_total) ? __ldg(orig_ids + p_best) : p_best;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_intersect_culled(const void* clusters, int g, const void* order,
                                   const void* sph_cl, const void* orig_ids, int ns_total,
                                   const void* quad, int nq, const void* origin,
                                   const void* direction, int n, void* t_out,
                                   void* prim_out, int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  culled_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)clusters, g, (const int*)order, (const float4*)sph_cl,
      (const int*)orig_ids, ns_total, (const float4*)quad, nq, (const float*)origin,
      (const float*)direction, n, (float*)t_out, (int*)prim_out);
  return (int)cudaGetLastError();
}
