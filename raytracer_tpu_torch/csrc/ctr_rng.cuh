// Counter-based RNG: the device copy of raytracer_tpu_torch/ops/ctr_rng.py,
// bit-identical to it and to raytracer_tpu/ops/ctr_rng.py.
//
// u = uniform(seed, lane, ctr): two rounds of the murmur3 finalizer over
// (seed ^ c) + lane*phi, then state ^ ctr*m1; the low 23 bits scaled by 2^-23.
// `lane` is the global sample id. The split into a per-sample key and a
// per-draw mix lets a kernel hash (seed, sample) once per sample.
#pragma once

#include <stdint.h>

namespace rt {

// Draw-index layout, the contract with ops/ctr_rng.py (a CPU test parses
// these two lines and compares them with the Python constants):
constexpr int CAM_DRAWS = 4;
constexpr int UNIFORMS_PER_BOUNCE = 3;

static __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// First round: the key of one sample stream.
static __device__ __forceinline__ uint32_t sample_key(uint32_t seed, uint32_t lane) {
  return fmix32((seed ^ 0x3C6EF372u) + lane * 0x9E3779B9u);
}

// Second round: draw `ctr` of that stream as U[0,1).
static __device__ __forceinline__ float key_uniform(uint32_t key, uint32_t ctr) {
  const uint32_t bits = fmix32(key ^ (ctr * 0x85EBCA6Bu));
  return (float)(bits & 0x7FFFFFu) * (1.0f / 8388608.0f);
}

// Counter of shading uniform j at bounce `bounce`.
static __device__ __forceinline__ uint32_t shading_ctr(int bounce, int j) {
  return (uint32_t)(CAM_DRAWS + UNIFORMS_PER_BOUNCE * bounce + j);
}

// Counter of the russian-roulette coin at bounce `bounce` (outside the
// shading range).
static __device__ __forceinline__ uint32_t rr_ctr(int bounce, int max_depth) {
  return (uint32_t)(CAM_DRAWS + UNIFORMS_PER_BOUNCE * max_depth + bounce);
}

// Counter of the stochastic bilinear tap's uniform j (0: column, 1: row) at
// bounce `bounce` (after the russian-roulette coins).
static __device__ __forceinline__ uint32_t tap_ctr(int bounce, int max_depth, int j) {
  return (uint32_t)(CAM_DRAWS + (UNIFORMS_PER_BOUNCE + 1) * max_depth + 2 * bounce + j);
}

}  // namespace rt
