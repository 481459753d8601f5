// Noise and image textures inside the persistent kernel (kernels 2 and 3).
//
// Replaces the texture half of raytracer_tpu/ops/persistent_kernel.py
// (_persistent_kernel): the procedural Perlin marble (:670-678), sphere and
// quad UV, and the nearest (:679-731), stochastic single-tap (:732-765) and
// 4-tap bilinear (:792-840) image lookups. The TPU kernel's workarounds are
// not carried over: it recomputed the Perlin tables' entries with an int32
// hash at every lattice corner (:144-218, materials/perlin_hash.py), since
// gathers from tiny tables were slow on the TPU; here the textured kernels
// gather them from the block's shared memory (PerlinTables, filled from the
// same hash); ops/invtrig.py becomes acosf/atan2f; the f32-mantissa texel
// packing and the chunk-band texel scans become direct reads of the
// scene's float32 (I, H, W, 3) texels, the same tensor the plain twin
// indexes.
//
// What bounds the marble on an H100: instruction issue over 7 octaves of 8
// lattice corners. The hash took ~53 SASS instructions a corner, most of
// them integer, which an SM issues at half its FP32 rate; from the tables
// a corner is one LDS.128 of its gradient, two XORs and the dot product
// (~18 instructions, utils/sass_loop.py --marble). It is still the largest
// part of a noise scene's call. A warp evaluates a marble when any of its
// lanes hits noise, so on perlin about half its lanes idle through each
// one (SIMT efficiency ~0.5, integrator/wavefront.py:TextureWork); tracing
// a missed path's next camera ray inside the iteration raised that to
// ~0.8 but cost more in added closest hits than it saved, and was dropped
// (PERF.md, section 6).
//
// Plain twin (and spec): raytracer_tpu_torch/materials/textures.py
// (perlin_noise with perlin=None, marble, image_lookup,
// image_lookup_bilinear, image_tap_stochastic) and geometry/intersect.py
// (sphere_uv, quad_uv). Every expression keeps the twin's order of float
// operations, and a division by a Python scalar is a multiply by its float
// reciprocal, as PyTorch's CUDA division by a scalar computes it; with
// contraction off (ops/build.py) kernel and twin round alike.
#pragma once

#include <math.h>
#include <stdint.h>

#include "ctr_rng.cuh"

namespace rt {

// Texture kinds (geometry/scene.py) and image filter modes
// (materials/packed.py FILTER_*).
constexpr int TEX_IMAGE = 2;
constexpr int TEX_NOISE = 3;
constexpr int FILTER_BILINEAR = 1;
constexpr int FILTER_STOCHASTIC = 2;

// Texture-table row (materials/packed.py, 12 floats = 3 float4):
//   [type scale image 0] [av.x av.y av.z Q.av] [bv.x bv.y bv.z Q.bv]

// perlin_hash.py's constants (a CPU test parses these lines).
constexpr uint32_t AXIS_MUL1_0 = 167u;
constexpr uint32_t AXIS_MUL1_1 = 139u;
constexpr uint32_t AXIS_MUL1_2 = 101u;
constexpr uint32_t AXIS_MUL2_0 = 91u;
constexpr uint32_t AXIS_MUL2_1 = 197u;
constexpr uint32_t AXIS_MUL2_2 = 213u;
constexpr uint32_t AXIS_ADD_0 = 11u;
constexpr uint32_t AXIS_ADD_1 = 157u;
constexpr uint32_t AXIS_ADD_2 = 223u;
constexpr uint32_t GRAD_SEED_0 = 0x68E31DA4u;
constexpr uint32_t GRAD_SEED_1 = 0xB5297A4Du;
constexpr uint32_t GRAD_SEED_2 = 0x1B56C4E9u;
constexpr int TURBULENCE_OCTAVES = 7;

// Sphere UV constants as PyTorch rounds its Python scalars: float(pi),
// float(5 pi / 12), and the reciprocals of float(pi) and float(2 pi).
constexpr float UV_PI = (float)3.141592653589793;
constexpr float UV_PHI_OFFSET = (float)(5.0 * 3.141592653589793 / 12.0);
constexpr float UV_INV_PI = 1.0f / UV_PI;
constexpr float UV_INV_TWO_PI = 1.0f / (float)(2.0 * 3.141592653589793);

// perlin_hash.perm_u8: bijective on 8 bits, x in [0, 256).
template <int kAxis>
static __device__ __forceinline__ uint32_t perm_u8(uint32_t x) {
  const uint32_t m1 = kAxis == 0 ? AXIS_MUL1_0 : (kAxis == 1 ? AXIS_MUL1_1 : AXIS_MUL1_2);
  const uint32_t m2 = kAxis == 0 ? AXIS_MUL2_0 : (kAxis == 1 ? AXIS_MUL2_1 : AXIS_MUL2_2);
  const uint32_t add = kAxis == 0 ? AXIS_ADD_0 : (kAxis == 1 ? AXIS_ADD_1 : AXIS_ADD_2);
  uint32_t h = (x * m1 + add) & 255u;
  h = h ^ (h >> 4);
  h = (h * m2) & 255u;
  return h ^ (h >> 4);
}

// perlin_hash.grad_component: component kK of gradient vector h in [-1, 1).
template <int kK>
static __device__ __forceinline__ float grad_component(uint32_t h) {
  const uint32_t seed = kK == 0 ? GRAD_SEED_0 : (kK == 1 ? GRAD_SEED_1 : GRAD_SEED_2);
  uint32_t u = (h + (uint32_t)(kK + 1) * 0x9E3779B9u) ^ seed;
  u = (u ^ 61u) ^ (u >> 16);
  u = u * 9u;
  u = u ^ (u >> 4);
  u = u * 0x27D4EB2Du;
  u = u ^ (u >> 15);
  return (float)(u & 0xFFFFFFu) * (1.0f / 8388608.0f) - 1.0f;
}

// The Perlin tables in the block's shared memory, filled once per block
// (fill_perlin_tables) from perm_u8 and grad_component themselves, so every
// entry is the bits the hash computes (materials/perlin_hash.py:
// build_tables materializes the same arrays). The three gradient components
// sit in one float4 per entry (one LDS.128 a corner); each axis has one
// word per lattice coordinate i holding perm(i) | perm((i + 1) & 255) << 8,
// so an octave's six permutations are three loads.
constexpr int PERLIN_SIZE = 256;

struct PerlinTables {
  float4 grad[PERLIN_SIZE];
  uint32_t pair[3][PERLIN_SIZE];
};

template <int kAxis>
static __device__ __forceinline__ uint32_t perm_pair(uint32_t i) {
  return perm_u8<kAxis>(i) | (perm_u8<kAxis>((i + 1u) & 255u) << 8);
}

// Every thread of the block takes part; the caller syncs the block after.
static __device__ void fill_perlin_tables(PerlinTables& tab) {
  for (int i = threadIdx.x; i < PERLIN_SIZE; i += blockDim.x) {
    const uint32_t h = (uint32_t)i;
    tab.grad[i] = make_float4(grad_component<0>(h), grad_component<1>(h),
                              grad_component<2>(h), 0.0f);
    tab.pair[0][i] = perm_pair<0>(h);
    tab.pair[1][i] = perm_pair<1>(h);
    tab.pair[2][i] = perm_pair<2>(h);
  }
}

// perm(i) and perm((i + 1) & 255) of axis kAxis.
template <int kAxis>
static __device__ __forceinline__ void lattice_perm(const PerlinTables& tab, uint32_t i,
                                                    uint32_t& p0, uint32_t& p1) {
  const uint32_t w = tab.pair[kAxis][i];
  p0 = w & 255u;
  p1 = w >> 8;
}

// Gradient dot product at lattice corner (cx, cy, cz) of hash h, in the
// twin's order of operations.
static __device__ __forceinline__ float perlin_corner(const PerlinTables& tab, uint32_t h,
                                                      float tx, float ty, float tz, float cx,
                                                      float cy, float cz) {
  const float4 g = tab.grad[h];
  return g.x * (tx - cx) + g.y * (ty - cy) + g.z * (tz - cz);
}

static __device__ __forceinline__ float c_lerp(float t, float a, float b) {
  return a * (1.0f - t) + b * t;
}

// textures.perlin_noise with the procedural tables (materials.go:222-249).
static __device__ __forceinline__ float perlin_noise(const PerlinTables& tab, float x, float y,
                                                     float z) {
  const float pfx = floorf(x), pfy = floorf(y), pfz = floorf(z);
  const float tx = x - pfx, ty = y - pfy, tz = z - pfz;
  const uint32_t ix = (uint32_t)(int)pfx & 255u;
  const uint32_t iy = (uint32_t)(int)pfy & 255u;
  const uint32_t iz = (uint32_t)(int)pfz & 255u;
  uint32_t hx0, hx1, hy0, hy1, hz0, hz1;
  lattice_perm<0>(tab, ix, hx0, hx1);
  lattice_perm<1>(tab, iy, hy0, hy1);
  lattice_perm<2>(tab, iz, hz0, hz1);
  const float fx = tx * tx * (3.0f - 2.0f * tx);
  const float fy = ty * ty * (3.0f - 2.0f * ty);
  const float fz = tz * tz * (3.0f - 2.0f * tz);
  const float c00 = c_lerp(fx, perlin_corner(tab, hx0 ^ hy0 ^ hz0, tx, ty, tz, 0.0f, 0.0f, 0.0f),
                           perlin_corner(tab, hx1 ^ hy0 ^ hz0, tx, ty, tz, 1.0f, 0.0f, 0.0f));
  const float c10 = c_lerp(fx, perlin_corner(tab, hx0 ^ hy1 ^ hz0, tx, ty, tz, 0.0f, 1.0f, 0.0f),
                           perlin_corner(tab, hx1 ^ hy1 ^ hz0, tx, ty, tz, 1.0f, 1.0f, 0.0f));
  const float c01 = c_lerp(fx, perlin_corner(tab, hx0 ^ hy0 ^ hz1, tx, ty, tz, 0.0f, 0.0f, 1.0f),
                           perlin_corner(tab, hx1 ^ hy0 ^ hz1, tx, ty, tz, 1.0f, 0.0f, 1.0f));
  const float c11 = c_lerp(fx, perlin_corner(tab, hx0 ^ hy1 ^ hz1, tx, ty, tz, 0.0f, 1.0f, 1.0f),
                           perlin_corner(tab, hx1 ^ hy1 ^ hz1, tx, ty, tz, 1.0f, 1.0f, 1.0f));
  return c_lerp(fz, c_lerp(fy, c00, c10), c_lerp(fy, c01, c11));
}

// textures.marble: 0.5 * (1 + sin(sp_z + 10 * |7 halving octaves|)), sp =
// point * scale (materials.go:251-262, 285-288).
static __device__ __forceinline__ float marble(const PerlinTables& tab, float px, float py,
                                               float pz, float scale) {
  const float spx = px * scale, spy = py * scale, spz = pz * scale;
  float x = spx, y = spy, z = spz;
  float total = 0.0f;
  float weight = 1.0f;
  for (int o = 0; o < TURBULENCE_OCTAVES; ++o) {
    total = total + weight * perlin_noise(tab, x, y, z);
    weight *= 0.5f;
    x = x * 2.0f;
    y = y * 2.0f;
    z = z * 2.0f;
  }
  return 0.5f * (1.0f + sinf(spz + 10.0f * fabsf(total)));
}

// geometry.intersect.sphere_uv of the outward unit normal, with the
// reference's phi offset (hittables.go:122-126).
static __device__ __forceinline__ void sphere_uv(float nx, float ny, float nz, float& u,
                                                 float& v) {
  const float cy = fminf(fmaxf(ny, -1.0f), 1.0f);
  const float theta = acosf(-cy);
  const float phi = atan2f(-nz, nx) + UV_PI;
  u = (phi + UV_PHI_OFFSET) * UV_INV_TWO_PI;
  v = theta * UV_INV_PI;
}

// Texel (c0, c1, c2) at integer coordinates clamped into image `id`'s true
// dims (dh, dw); images are (I, img_h, img_w, 3) with padded img_h, img_w.
struct Texel {
  float r, g, b;
};

static __device__ __forceinline__ Texel texel(const float* __restrict__ images, int img_h,
                                              int img_w, int id, int dh, int dw, int xi,
                                              int yi) {
  const int i = min(max(xi, 0), dw - 1);
  const int j = min(max(yi, 0), dh - 1);
  const float* p = images + (((size_t)id * img_h + j) * img_w + i) * 3;
  return Texel{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// The image texture at (u, v): clamp u, flip v; then nearest-neighbour
// (materials.go:176-193), the 4-tap bilinear filter, or one bilinear tap
// drawn with its weight from the sample's tap_ctr uniforms.
static __device__ __forceinline__ Texel image_texel(
    const float* __restrict__ images, const int* __restrict__ image_dims, int img_h,
    int img_w, int id, float u, float v, int filter, uint32_t key, int bounce,
    int max_depth) {
  const int dh = __ldg(image_dims + 2 * id);
  const int dw = __ldg(image_dims + 2 * id + 1);
  const float h = (float)dh;
  const float w = (float)dw;
  const float uu = fminf(fmaxf(u, 0.0f), 1.0f);
  const float vv = 1.0f - fminf(fmaxf(v, 0.0f), 1.0f);
  if (filter != FILTER_BILINEAR && filter != FILTER_STOCHASTIC) {
    return texel(images, img_h, img_w, id, dh, dw, (int)(uu * w), (int)(vv * h));
  }
  const float x = uu * w - 0.5f;
  const float y = vv * h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  if (filter == FILTER_STOCHASTIC) {
    const float ux = key_uniform(key, tap_ctr(bounce, max_depth, 0));
    const float uy = key_uniform(key, tap_ctr(bounce, max_depth, 1));
    return texel(images, img_h, img_w, id, dh, dw, (int)x0 + (ux < fx ? 1 : 0),
                 (int)y0 + (uy < fy ? 1 : 0));
  }
  const Texel c00 = texel(images, img_h, img_w, id, dh, dw, (int)x0, (int)y0);
  const Texel c01 = texel(images, img_h, img_w, id, dh, dw, (int)(x0 + 1.0f), (int)y0);
  const Texel c10 = texel(images, img_h, img_w, id, dh, dw, (int)x0, (int)(y0 + 1.0f));
  const Texel c11 = texel(images, img_h, img_w, id, dh, dw, (int)(x0 + 1.0f), (int)(y0 + 1.0f));
  const float ofx = 1.0f - fx;
  const float ofy = 1.0f - fy;
  return Texel{(c00.r * ofx + c01.r * fx) * ofy + (c10.r * ofx + c11.r * fx) * fy,
               (c00.g * ofx + c01.g * fx) * ofy + (c10.g * ofx + c11.g * fx) * fy,
               (c00.b * ofx + c01.b * fx) * ofy + (c10.b * ofx + c11.b * fx) * fy};
}

}  // namespace rt
