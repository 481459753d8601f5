// The device copy of the thin-lens camera ray (camera.go:265-299), shared by
// the persistent kernel and the wavefront-step kernel. Its plain twin is
// raytracer_tpu_torch/core/camera.py:camera_rays fed
// ops/ctr_rng.py:camera_uniforms; the arithmetic is the same, operation
// for operation.
#pragma once

#include <math.h>
#include <stdint.h>

#include "ctr_rng.cuh"

namespace rt {

// Camera/config scalars (ops/persistent_kernel.py pack_camera_scalars_bg).
constexpr int CAM_PIXEL00 = 0;
constexpr int CAM_DU = 3;
constexpr int CAM_DV = 6;
constexpr int CAM_CENTER = 9;
constexpr int CAM_DISK_U = 12;
constexpr int CAM_DISK_V = 15;
constexpr int CAM_DEFOCUS = 18;
constexpr int CAM_BG = 19;

constexpr float TWO_PI = 6.283185307179586f;

// Camera ray of pixel (px, py) from the sample's key (draws 0-3: jitter x,
// jitter y, disk radius-u, disk phi-u). The direction is unnormalized.
static __device__ __forceinline__ void camera_ray(const float* __restrict__ cam, int px,
                                                  int py, uint32_t key, bool use_disk,
                                                  float& ox, float& oy, float& oz,
                                                  float& dx, float& dy, float& dz) {
  const float jx = key_uniform(key, 0) - 0.5f;
  const float jy = key_uniform(key, 1) - 0.5f;
  const float r_disk = sqrtf(key_uniform(key, 2));
  const float phi = TWO_PI * key_uniform(key, 3);
  const float disk_x = r_disk * cosf(phi);
  const float disk_y = r_disk * sinf(phi);
  const float fx = (float)px + jx;
  const float fy = (float)py + jy;
  const float pcx = __ldg(cam + CAM_PIXEL00 + 0) + fx * __ldg(cam + CAM_DU + 0) +
                    fy * __ldg(cam + CAM_DV + 0);
  const float pcy = __ldg(cam + CAM_PIXEL00 + 1) + fx * __ldg(cam + CAM_DU + 1) +
                    fy * __ldg(cam + CAM_DV + 1);
  const float pcz = __ldg(cam + CAM_PIXEL00 + 2) + fx * __ldg(cam + CAM_DU + 2) +
                    fy * __ldg(cam + CAM_DV + 2);
  ox = __ldg(cam + CAM_CENTER + 0);
  oy = __ldg(cam + CAM_CENTER + 1);
  oz = __ldg(cam + CAM_CENTER + 2);
  if (use_disk) {
    ox = ox + disk_x * __ldg(cam + CAM_DISK_U + 0) + disk_y * __ldg(cam + CAM_DISK_V + 0);
    oy = oy + disk_x * __ldg(cam + CAM_DISK_U + 1) + disk_y * __ldg(cam + CAM_DISK_V + 1);
    oz = oz + disk_x * __ldg(cam + CAM_DISK_U + 2) + disk_y * __ldg(cam + CAM_DISK_V + 2);
  }
  dx = pcx - ox;
  dy = pcy - oy;
  dz = pcz - oz;
}

}  // namespace rt
