// Kernel 5: the front half of one iteration of the wavefront-step path.
//
// Replaces raytracer_tpu/ops/wavefront_kernel.py:wavefront_step_pallas
// (_wavefront_kernel): per lane, regeneration (an idle lane that owes
// samples advances its strided pixel and starts its next sample), the
// thin-lens camera ray, the closest hit, and the lane's draws for the
// PyTorch shading epilogue (integrator/wavefront.py:wavefront_step_loop).
//
// What bounds it on an H100: bytes at the scenes this path serves. A lane
// reads 49 bytes of state and writes 65 (t, prim, origin, direction, grant,
// remaining, px, py, sample_k, four uniforms); the noise and image scenes
// have 2-4 primitives, so the closest hit is ~100 FP32 operations a lane.
// Loads and stores are per lane, neighbouring threads on neighbouring
// words (origin and direction as three strided floats, like kernel 1).
//
// Design (right before fast): one thread per lane, no shared memory. The
// TPU kernel's hardware PRNG becomes the ctr_rng counter hash keyed by the
// sample id lane + sample_k*N (csrc/ctr_rng.cuh): camera draws at counters
// 0-3 (csrc/camera.cuh, kernel 2's camera code), shading draws at
// shading_ctr(depth, j) and the russian-roulette coin at rr_ctr(depth,
// max_depth), depth 0 on a granted lane, so the path realises kernel 2's
// estimator. Lanes with no path in flight skip the closest hit and report
// a miss (the TPU kernel searched for them too; the epilogue never reads
// them).
//
// Plain twin (and spec): raytracer_tpu_torch/ops/wavefront_kernel.py:
// wavefront_step_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "camera.cuh"
#include "closest_hit.cuh"
#include "ctr_rng.cuh"

namespace {

__global__ void wavefront_step_kernel(
    const float4* __restrict__ sph, int ns, const float4* __restrict__ quad, int nq,
    const float* __restrict__ cam, uint32_t seed, const float* __restrict__ o_in,
    const float* __restrict__ d_in, const bool* __restrict__ active,
    const int* __restrict__ rem_in, const int* __restrict__ px_in,
    const int* __restrict__ py_in, const int* __restrict__ sk_in,
    const int* __restrict__ depth_in, int n, int width, int height, int jump_px,
    int jump_py, int max_depth, float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ o_out, float* __restrict__ d_out, bool* __restrict__ grant_out,
    int* __restrict__ rem_out, int* __restrict__ px_out, int* __restrict__ py_out,
    int* __restrict__ sk_out, float* __restrict__ uni_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const bool act = active[lane];
  int rem = rem_in[lane];
  int px = px_in[lane];
  int py = py_in[lane];
  int sk = sk_in[lane];
  int depth = depth_in[lane];
  float ox = o_in[3 * lane], oy = o_in[3 * lane + 1], oz = o_in[3 * lane + 2];
  float dx = d_in[3 * lane], dy = d_in[3 * lane + 1], dz = d_in[3 * lane + 2];

  // ---- regeneration: strided pixel advance + camera ray ----
  const bool grant = !act && rem > 0;
  if (grant) {
    if (sk >= 0) {
      px += jump_px;
      py += jump_py;
      if (px >= width) {
        px -= width;
        py += 1;
      }
      if (py >= height) py -= height;
    }
    sk += 1;
    rem -= 1;
    depth = 0;
  }
  const uint32_t key = rt::sample_key(seed, (uint32_t)lane + (uint32_t)sk * (uint32_t)n);
  if (grant) {
    const bool use_disk = __ldg(cam + rt::CAM_DEFOCUS) > 0.0f;
    rt::camera_ray(cam, px, py, key, use_disk, ox, oy, oz, dx, dy, dz);
  }

  // ---- closest hit (scaled-t compare space), lanes in flight only ----
  float t = INFINITY;
  int prim = -1;
  if (act || grant) {
    const rt::RayTerms r = rt::ray_terms(ox, oy, oz, dx, dy, dz);
    float t_s = INFINITY;
    rt::sphere_candidates(sph, ns, r, t_s, prim);
    rt::quad_candidates(quad, nq, ns, r, t_s, prim);
    t = t_s * (1.0f / r.a);  // back from scaled-t space (INF stays INF)
  }

  // ---- outputs ----
  t_out[lane] = t;
  prim_out[lane] = prim;
  o_out[3 * lane] = ox;
  o_out[3 * lane + 1] = oy;
  o_out[3 * lane + 2] = oz;
  d_out[3 * lane] = dx;
  d_out[3 * lane + 1] = dy;
  d_out[3 * lane + 2] = dz;
  grant_out[lane] = grant;
  rem_out[lane] = rem;
  px_out[lane] = px;
  py_out[lane] = py;
  sk_out[lane] = sk;
  const float4 u = make_float4(rt::key_uniform(key, rt::shading_ctr(depth, 0)),
                               rt::key_uniform(key, rt::shading_ctr(depth, 1)),
                               rt::key_uniform(key, rt::shading_ctr(depth, 2)),
                               rt::key_uniform(key, rt::rr_ctr(depth, max_depth)));
  reinterpret_cast<float4*>(uni_out)[lane] = u;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rt_wavefront_step(
    const void* sph, int ns, const void* quad, int nq, const void* cam, int seed,
    const void* origin, const void* direction, const void* active, const void* remaining,
    const void* px, const void* py, const void* sample_k, const void* depth, int n,
    int width, int height, int jump_px, int jump_py, int max_depth, void* t_out,
    void* prim_out, void* o_out, void* d_out, void* grant_out, void* rem_out, void* px_out,
    void* py_out, void* sk_out, void* uni_out, int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  wavefront_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)sph, ns, (const float4*)quad, nq, (const float*)cam, (uint32_t)seed,
      (const float*)origin, (const float*)direction, (const bool*)active,
      (const int*)remaining, (const int*)px, (const int*)py, (const int*)sample_k,
      (const int*)depth, n, width, height, jump_px, jump_py, max_depth, (float*)t_out,
      (int*)prim_out, (float*)o_out, (float*)d_out, (bool*)grant_out, (int*)rem_out,
      (int*)px_out, (int*)py_out, (int*)sk_out, (float*)uni_out);
  return (int)cudaGetLastError();
}
