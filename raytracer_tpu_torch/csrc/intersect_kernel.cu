// Kernel 1: closest hit of a flat ray batch over all spheres, then all quads.
//
// Replaces raytracer_tpu/ops/intersect_kernel.py:intersect_pallas
// (_intersect_kernel), which held (rows, 128) ray tiles in VMEM and broadcast
// primitive parameters from SMEM scalars.
//
// What bounds it on an H100: instruction issue. Each ray reads 24 bytes and
// writes 8, then runs ~20 FP32 operations per primitive, each its own
// instruction with contraction off, so at 488 primitives the kernel issues
// ~10^4 instructions per 32 bytes of device memory. The table rows are the
// same address for every thread of a warp in a given loop step: broadcast
// loads from L1 (the 8 KB sphere table of rand_spheres stays resident).
//
// Design: one thread per ray (the math is csrc/closest_hit.cuh, shared with
// every other kernel: misses stay off the square root's slow path, groups
// of four rows branch past their roots), the ragged edge masked instead of
// padding N to a tile. Three entries:
//
// * rt_intersect, one pass: a sequential loop over the whole table, for a
//   launch whose blocks fill the card.
// * rt_intersect, split (slice_rows > 0): a launch of too few rays to fill
//   the card (a compacted bounce) would leave most SMs idle while each of
//   its threads walks every row. The table is cut along the grid's second
//   axis into slices of slice_rows sphere rows (a multiple of
//   SPHERE_GROUP); the quads go to the last slice. Each slice folds its
//   winner into one 64-bit word per ray with atomicMin on
//   (bits of the scaled t << 32) | prim. Candidates are positive floats,
//   which order as their bits, and the low word keeps the lowest row among
//   equal t (quads number after spheres), so the minimum is exactly the
//   sequential scan's first minimal candidate, whatever order the slices
//   run in. A slice without a finite candidate writes nothing; a second,
//   tiny kernel turns each word into t and prim. The words are the
//   caller's scratch, set to all ones (a miss) first.
// * rt_intersect_clustered: the per-lane two-level cluster walk
//   (csrc/cluster_walk.cuh) over cluster-ordered sphere and quad tables,
//   for the large-scene path's incoherent bounce rays, which a dense walk
//   would take over every one of thousands of rows.
//
// With a `radius` table (the spheres' radii, row for row), both dense entries
// recompute a sphere winner's t by the stable quadratic
// (closest_hit.cuh:sphere_winner_t) before they write it; the search and its
// winner are the same with or without it. The edge terms' traces ask for it
// (diff/boundary.py:trace_edge_rays): they start a hair from a silhouette,
// where the folded test puts the hit inside a small sphere.
//
// Plain twins: raytracer_tpu_torch/ops/intersect_kernel.py:intersect_plain
// (one pass and split; intersect_split_plain models the split's combine),
// ops/cluster_visit.py:ClusterVisit.hit (clustered).

#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"
#include "cluster_walk.cuh"

namespace {

using Word = unsigned long long;
constexpr Word MISS_WORD = ~0ull;

__device__ __forceinline__ rt::RayTerms ray_at(const float* __restrict__ origin,
                                               const float* __restrict__ direction, int i) {
  return rt::ray_terms(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2], direction[3 * i],
                       direction[3 * i + 1], direction[3 * i + 2]);
}

// t_best of prim p_best back from scaled-t space (INF stays INF), a sphere
// winner's by the stable quadratic where `radius` is given.
__device__ __forceinline__ float winner_t(const float4* __restrict__ sph,
                                          const float* __restrict__ radius, int ns,
                                          const rt::RayTerms& r, float t_best, int p_best) {
  if (radius != nullptr && p_best >= 0 && p_best < ns) {
    t_best = rt::sphere_winner_t(__ldg(sph + p_best), __ldg(radius + p_best), r, t_best);
  }
  const float inv_a = 1.0f / r.a;
  return t_best * inv_a;
}

__global__ void intersect_kernel(const float4* __restrict__ sph,
                                 const float* __restrict__ radius, int ns,
                                 const float4* __restrict__ quad, int nq,
                                 const float* __restrict__ origin,
                                 const float* __restrict__ direction, int n,
                                 float* __restrict__ t_out, int* __restrict__ prim_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rt::RayTerms r = ray_at(origin, direction, i);
  float t_best = INFINITY;
  int p_best = -1;
  rt::sphere_candidates(sph, ns, r, t_best, p_best);
  rt::quad_candidates(quad, nq, ns, r, t_best, p_best);
  t_out[i] = winner_t(sph, radius, ns, r, t_best, p_best);
  prim_out[i] = p_best;
}

// Slice blockIdx.y of the split table: sphere rows [y * slice_rows, ...),
// and the quads in the last slice.
__global__ void intersect_kernel_slice(const float4* __restrict__ sph, int ns,
                                       const float4* __restrict__ quad, int nq,
                                       const float* __restrict__ origin,
                                       const float* __restrict__ direction, int n,
                                       int slice_rows, Word* __restrict__ words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rt::RayTerms r = ray_at(origin, direction, i);
  const int begin = (int)blockIdx.y * slice_rows;
  float t_best = INFINITY;
  int p_best = -1;
  rt::sphere_candidates_range(sph, begin, min(ns, begin + slice_rows), r, t_best, p_best);
  if (blockIdx.y == gridDim.y - 1) rt::quad_candidates(quad, nq, ns, r, t_best, p_best);
  if (t_best < INFINITY) {
    atomicMin(words + i, ((Word)__float_as_uint(t_best) << 32) | (Word)(uint32_t)p_best);
  }
}

// The split's second pass: each ray's word to t (the one-pass kernel's
// winner_t, INF * (1/a) on a miss) and prim (-1 on a miss).
__global__ void intersect_kernel_finish(const float4* __restrict__ sph,
                                        const float* __restrict__ radius, int ns,
                                        const float* __restrict__ origin,
                                        const float* __restrict__ direction, int n,
                                        const Word* __restrict__ words,
                                        float* __restrict__ t_out, int* __restrict__ prim_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rt::RayTerms r = ray_at(origin, direction, i);
  const Word w = words[i];
  const bool hit = w != MISS_WORD;
  const float t_best = hit ? __uint_as_float((uint32_t)(w >> 32)) : INFINITY;
  const int p_best = hit ? (int)(uint32_t)(w & 0xFFFFFFFFull) : -1;
  t_out[i] = winner_t(sph, radius, ns, r, t_best, p_best);
  prim_out[i] = p_best;
}

__global__ void intersect_kernel_clustered(rt::CullArgs cull, const float4* __restrict__ sph,
                                           int ns, const float4* __restrict__ quad, int nq,
                                           const float* __restrict__ origin,
                                           const float* __restrict__ direction, int n,
                                           float* __restrict__ t_out,
                                           int* __restrict__ prim_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rt::RayTerms r = ray_at(origin, direction, i);
  float t_best = INFINITY;
  int p_best = -1;
  rt::clustered_candidates<rt::WALK_PER_LANE>(cull, sph, ns, quad, nq, r, t_best, p_best);
  const float inv_a = 1.0f / r.a;
  t_out[i] = t_best * inv_a;
  prim_out[i] = p_best;
}

}  // namespace

// Kernel 1 dense: one pass when slice_rows <= 0, else split into
// ceil(ns / slice_rows) slices folded through `words` (n 64-bit words of
// the caller's). `radius` (ns floats, or null) asks for the stable t of
// sphere winners. Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int rt_intersect(const void* sph, const void* radius, int ns, const void* quad,
                            int nq, const void* origin, const void* direction, int n,
                            void* t_out, void* prim_out, int slice_rows, void* words,
                            int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (slice_rows <= 0) {
    intersect_kernel<<<blocks, threads, 0, s>>>(
        (const float4*)sph, (const float*)radius, ns, (const float4*)quad, nq,
        (const float*)origin, (const float*)direction, n, (float*)t_out, (int*)prim_out);
    return (int)cudaGetLastError();
  }
  const int slices = ns > 0 ? (ns + slice_rows - 1) / slice_rows : 1;
  const cudaError_t err = cudaMemsetAsync(words, 0xFF, sizeof(Word) * (size_t)n, s);
  if (err != cudaSuccess) return (int)err;
  intersect_kernel_slice<<<dim3(blocks, slices), threads, 0, s>>>(
      (const float4*)sph, ns, (const float4*)quad, nq, (const float*)origin,
      (const float*)direction, n, slice_rows, (Word*)words);
  intersect_kernel_finish<<<blocks, threads, 0, s>>>(
      (const float4*)sph, (const float*)radius, ns, (const float*)origin,
      (const float*)direction, n, (const Word*)words, (float*)t_out, (int*)prim_out);
  return (int)cudaGetLastError();
}

// Kernel 1 clustered: clusters as ops/persistent_kernel.py:ClusterTable
// (rows and the four section lengths), sph and quad the cluster-ordered
// tables. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_intersect_clustered(const void* clusters, int s_super, int s_fine,
                                      int q_super, int q_fine, const void* sph, int ns,
                                      const void* quad, int nq, const void* origin,
                                      const void* direction, int n, void* t_out,
                                      void* prim_out, int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  const rt::CullArgs cull{(const float4*)clusters, s_super, s_fine, q_super, q_fine};
  intersect_kernel_clustered<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cull, (const float4*)sph, ns, (const float4*)quad, nq, (const float*)origin,
      (const float*)direction, n, (float*)t_out, (int*)prim_out);
  return (int)cudaGetLastError();
}
