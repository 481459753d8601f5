// Kernel 4: cluster-culled closest hit for coherent camera rays in large
// scenes.
//
// Replaces raytracer_tpu/ops/culled_kernel.py:intersect_pallas_culled
// (_culled_kernel), which slab-tested a (128 x 128)-ray VMEM tile against
// each cluster AABB of a flat table (clusters of <= 128 spheres, ordered
// front to back per direction octant) and skipped the cluster's sphere loop
// with a tile-uniform lax.cond when no ray of the tile could hit it.
//
// What bounds it on an H100: arithmetic, 23 FP32 operations per slab test
// and ~21 per sphere test of a cluster that is entered. Each ray reads 24
// bytes and writes 8, so bytes are far below it. On the TPU's flat table
// every ray paid every cluster's slab test (128 on rand_spheres_large,
// about half its operations) and a warp the whole loop of each cluster any
// of its rays entered.
//
// Design: one thread per ray, the two-level walk of csrc/cluster_walk.cuh
// over the render's own cluster table (ops/persistent_kernel.py:
// ClusterTable: 64-sphere fine rows under supers of 16, each sorted front
// to back from the eye, render/driver.py:cluster_for_render) and its
// cluster-ordered sphere and quad tables, so the prim ids are that permuted
// scene's. Every camera ray starts at the eye, so that order is front to
// back for each of them: the nearest hit comes early and culls what lies
// behind it. The walk runs under the warp-vote policy: a warp's 32 rays
// are neighbouring pixels of one row and enter nearly the same rows, so
// the warp enters a super or fine row when any of its lanes does and every
// branch of the walk is uniform. Every lane must reach every vote, so the
// ragged last warp keeps its lanes alive on the last ray and writes nothing
// for them (blockDim is a multiple of 32). Entering a row that a lane's
// own test would skip never changes its result. On an H100 the vote takes
// ~1.8% less time than the per-lane walk on rand_spheres_large's camera
// rays (utils/time_kernels.py, cell k4_large, patch `perlane`).
//
// Plain twin: raytracer_tpu_torch/ops/cluster_visit.py:ClusterVisit.hit,
// the dense search in the walk's visit order. The TPU kernel's own spec
// (the flat table and its search) stays as ops/culled_kernel.py:
// build_clusters and intersect_culled_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"
#include "cluster_walk.cuh"

namespace {

__global__ void culled_kernel(rt::CullArgs cull, const float4* __restrict__ sph, int ns,
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
  float t_best = INFINITY;
  int p_best = -1;
  rt::clustered_candidates<rt::WALK_WARP_VOTE>(cull, sph, ns, quad, nq, r, t_best, p_best);
  if (valid) {
    const float inv_a = 1.0f / r.a;
    t_out[i] = t_best * inv_a;  // back from scaled-t space (INF stays INF)
    prim_out[i] = p_best;
  }
}

}  // namespace

// clusters as ops/persistent_kernel.py:ClusterTable (rows and the four
// section lengths), sph and quad the cluster-ordered tables; threads a
// multiple of 32. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int rt_intersect_culled(const void* clusters, int s_super, int s_fine, int q_super,
                                   int q_fine, const void* sph, int ns, const void* quad, int nq,
                                   const void* origin, const void* direction, int n,
                                   void* t_out, void* prim_out, int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  const rt::CullArgs cull{(const float4*)clusters, s_super, s_fine, q_super, q_fine};
  culled_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cull, (const float4*)sph, ns, (const float4*)quad, nq, (const float*)origin,
      (const float*)direction, n, (float*)t_out, (int*)prim_out);
  return (int)cudaGetLastError();
}
