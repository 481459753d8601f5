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
// Design: one thread per ray, a sequential loop over the table (the math is
// csrc/closest_hit.cuh, shared with every other kernel: misses stay off the
// square root's slow path, groups of four rows branch past their roots), the ragged edge masked
// instead of padding N to a tile. Shared-memory staging (kernels 2 and 3)
// and coherent ray ordering are not done here.
//
// Plain twin: raytracer_tpu_torch/ops/intersect_kernel.py:intersect_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

__global__ void intersect_kernel(const float4* __restrict__ sph, int ns,
                                 const float4* __restrict__ quad, int nq,
                                 const float* __restrict__ origin,
                                 const float* __restrict__ direction, int n,
                                 float* __restrict__ t_out, int* __restrict__ prim_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rt::RayTerms r = rt::ray_terms(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2],
                                       direction[3 * i], direction[3 * i + 1],
                                       direction[3 * i + 2]);
  float t_best = INFINITY;
  int p_best = -1;
  rt::sphere_candidates(sph, ns, r, t_best, p_best);
  rt::quad_candidates(quad, nq, ns, r, t_best, p_best);
  const float inv_a = 1.0f / r.a;
  t_out[i] = t_best * inv_a;  // back from scaled-t space (INF stays INF)
  prim_out[i] = p_best;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_intersect(const void* sph, int ns, const void* quad, int nq,
                            const void* origin, const void* direction, int n,
                            void* t_out, void* prim_out, int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  intersect_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)sph, ns, (const float4*)quad, nq, (const float*)origin,
      (const float*)direction, n, (float*)t_out, (int*)prim_out);
  return (int)cudaGetLastError();
}
