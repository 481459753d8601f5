// The edge terms' path traces: every given ray's whole path, on the card, in
// one launch.
//
// Replaces no TPU kernel: the JAX package traces its edge rays with
// `intersect_pallas` a bounce and shades them in XLA, and the port's eager
// path (diff/boundary.py:trace_edge_rays over integrator/wavefront.py:trace)
// did the same with kernel 1 a bounce and about a hundred small PyTorch
// operations for the shading, the counter hash and the roulette, and a
// boolean compaction (a host sync) at every bounce: six calls a train step
// with both edge terms on, each up to 50 bounces deep, held the card idle
// 93% of the step while the host launched them.
//
// Each lane's path is a pure function of its ray and its sample id, so one
// thread traces it to its end with no compaction, no sync and no
// allocation:
// * lane L traces ray L mod K of the (K, 3) origins and directions as
//   sample L under `seed` (the eager path's lanes: `origin.repeat(spp, 1)`),
//   drawing its shading uniforms at ctr_rng shading_ctr(bounce, j) and its
//   roulette coin at rr_ctr(bounce, max_depth), so an in/out pair traced
//   with one seed shares its random numbers;
// * the closest hit over the dense sphere and quad tables
//   (csrc/closest_hit.cuh), each sphere winner's t by the stable quadratic
//   (sphere_winner_t), as kernel 1 takes it on this path with `radius`;
// * the shading of kernel 2's epilogue (csrc/persistent_kernel.cu): the
//   background or sky gradient on a miss, emission, the materials, solid
//   and checker textures and, in the textured instantiations, the
//   procedural marble and images through a deterministic filter
//   (csrc/textures.cuh); the depth budget `max_depth`; russian roulette
//   from depth rr_start by the eager rule (integrator/wavefront.py:
//   roulette): q = clip(max of throughput x attenuation, rr_lo, rr_hi), the
//   throughput divided by q (kernel 2 multiplies by 1 / q, which rounds
//   otherwise);
// * the lane's radiance written to its row of the (K x spp, 3) output; a
//   lane whose ray is False in `live` writes zeros and traces nothing.
// The epilogue is written out here rather than shared with kernel 2
// through a header, so that kernels 2 and 3 keep their machine code.
//
// What bounds it on an H100: its closest hits, as kernel 2's: ~21 FP32
// operations a sphere and 40 a quad per lane-bounce, each its own
// instruction with contraction off (--fmad=false, ops/build.py), from
// broadcast table reads. A warp runs until its lanes' longest path ends,
// and roulette leaves long tails (depth 50 against a mean of about two
// bounces).
//
// Design: one thread a lane, persistent over a strided queue of lanes
// (thread g of a grid of G threads traces lanes g, g + G, g + 2G, ...): a
// thread whose path ends, by a miss, a light, an absorbed scatter, the
// roulette or the depth budget, starts its next lane at once, so one deep
// path holds its own thread and not its warp's other lanes. The grid is a
// share of what stays resident on the card (the occupancy API's grid over
// `grid_divisor`, capped at the lanes), so each thread traces a few lanes
// and its warp's lanes run out of work together. No lane's output depends
// on the thread that traced it. `segments_total`, when given, receives the
// lane-bounces traced (one atomicAdd a thread): the `edge_path_segments`
// counter.
//
// Plain twin (and spec): integrator/wavefront.py:trace with the same
// arguments (stable_spheres, russian_roulette, the counter-hash uniforms
// keyed by lane), which equals it bit for bit on the live lanes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "camera.cuh"
#include "closest_hit.cuh"
#include "ctr_rng.cuh"
#include "textures.cuh"

namespace {

using rt::TWO_PI;
constexpr float NEAR_ZERO = 1e-8f;

// Material types (geometry/scene.py).
constexpr int LAMBERTIAN = 0;
constexpr int METAL = 1;
constexpr int DIELECTRIC = 2;
constexpr int DIFFUSE_LIGHT = 3;

// Texture instantiations, as kernel 2's: solid and checker only; images
// too; and the procedural Perlin marble, from each block's shared tables.
constexpr int TEXTURES_PLAIN = 0;
constexpr int TEXTURES_IMAGE = 1;
constexpr int TEXTURES_NOISE = 2;

// Texture inputs: the (P, 12) texture table as three float4 a row, the
// (I, img_h, img_w, 3) float32 texels, their (I, 2) int32 true dims, and a
// deterministic image filter.
struct TexArgs {
  const float4* rows;
  const float* images;
  const int* dims;
  int img_h, img_w, filter;
};

template <int kTex>
__global__ void edge_path_kernel(
    const float4* __restrict__ sph, const float* __restrict__ radius, int ns,
    const float4* __restrict__ quad, int nq, const float4* __restrict__ res,
    const float* __restrict__ origin, const float* __restrict__ direction,
    const bool* __restrict__ live, int k, int n, const float* __restrict__ background,
    uint32_t seed, int max_depth, int rr_start, float rr_lo, float rr_hi, int sky_gradient,
    float* __restrict__ radiance, unsigned long long* __restrict__ segments_total,
    TexArgs tex) {
  // The noise instantiation's Perlin tables, filled by the whole block
  // before any of its threads leaves.
  const rt::PerlinTables* perlin = nullptr;
  if constexpr (kTex == TEXTURES_NOISE) {
    __shared__ rt::PerlinTables perlin_tables;
    rt::fill_perlin_tables(perlin_tables);
    __syncthreads();
    perlin = &perlin_tables;
  }
  const int stride = gridDim.x * blockDim.x;
  const float bg_r = __ldg(background + 0);
  const float bg_g = __ldg(background + 1);
  const float bg_b = __ldg(background + 2);
  unsigned long long segs = 0;

  for (int lane = blockIdx.x * blockDim.x + threadIdx.x; lane < n; lane += stride) {
    const int ray = lane % k;
    float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f;
    if (live == nullptr || live[ray]) {
      float ox = origin[3 * ray], oy = origin[3 * ray + 1], oz = origin[3 * ray + 2];
      float dx = direction[3 * ray], dy = direction[3 * ray + 1], dz = direction[3 * ray + 2];
      float tpx = 1.0f, tpy = 1.0f, tpz = 1.0f;
      const uint32_t key = rt::sample_key(seed, (uint32_t)lane);

      for (int bounce = 0; bounce < max_depth; ++bounce) {
        ++segs;
        // ---- closest hit (scaled-t compare space), the stable sphere t ----
        const rt::RayTerms r = rt::ray_terms(ox, oy, oz, dx, dy, dz);
        float t_s = INFINITY;
        int prim = -1;
        rt::sphere_candidates(sph, ns, r, t_s, prim);
        rt::quad_candidates(quad, nq, ns, r, t_s, prim);
        if (prim >= 0 && prim < ns) {
          t_s = rt::sphere_winner_t(__ldg(sph + prim), __ldg(radius + prim), r, t_s);
        }

        if (!(t_s < INFINITY)) {
          // ---- miss -> background / sky; the path ends ----
          float bgr = bg_r, bgg = bg_g, bgb = bg_b;
          if (sky_gradient) {
            const float inv_dl0 = 1.0f / sqrtf(r.a);
            const float sa = 0.5f * (dy * inv_dl0 + 1.0f);
            bgr = (1.0f - sa) + sa * 0.5f;
            bgg = (1.0f - sa) + sa * 0.7f;
            bgb = 1.0f;
          }
          rdx = rdx + tpx * bgr;
          rdy = rdy + tpy * bgg;
          rdz = rdz + tpz * bgb;
          break;
        }

        // ---- winner row, read directly by index ----
        const float t = t_s * (1.0f / r.a);  // back from scaled-t space
        const float4 m0 = __ldg(res + 4 * prim);
        const float4 m1 = __ldg(res + 4 * prim + 1);
        const float4 m2 = __ldg(res + 4 * prim + 2);
        const float its = __ldg(res + 4 * prim + 3).x;
        const int mtype = (int)m1.x;
        const float prm = m1.y;

        // ---- hit epilogue: point, outward normal, front face ----
        const float ptx = ox + t * dx;
        const float pty = oy + t * dy;
        const float ptz = oz + t * dz;
        const bool is_quad = prim >= ns;
        float onx = m0.x, ony = m0.y, onz = m0.z;
        if (!is_quad) {  // normalize((p - c) * r): the sign of r flips hollow glass
          const float sx = (ptx - m0.x) * m0.w;
          const float sy = (pty - m0.y) * m0.w;
          const float sz = (ptz - m0.z) * m0.w;
          const float s_len = sqrtf(sx * sx + sy * sy + sz * sz + 1e-20f);
          onx = sx / s_len;
          ony = sy / s_len;
          onz = sz / s_len;
        }
        const float d_dot_n = dx * onx + dy * ony + dz * onz;
        const bool front = d_dot_n < 0.0f;
        const float fsign = front ? 1.0f : -1.0f;
        const float nx = onx * fsign;
        const float ny = ony * fsign;
        const float nz = onz * fsign;

        // ---- texture: solid, or 3D checker parity ----
        float texr = m1.z, texg = m1.w, texb = m2.x;
        if (its > 0.0f) {
          const int cpar = (int)floorf(ptx * its) + (int)floorf(pty * its) +
                           (int)floorf(ptz * its);
          if (cpar & 1) {
            texr = m2.y;
            texg = m2.z;
            texb = m2.w;
          }
        }
        if (kTex != TEXTURES_PLAIN) {  // ---- noise or image texture (csrc/textures.cuh) ----
          const float4 t0 = __ldg(tex.rows + 3 * prim);  // [type scale image 0]
          const int ttype = (int)t0.x;
          if (kTex == TEXTURES_NOISE && ttype == rt::TEX_NOISE) {
            texr = texg = texb = rt::marble(*perlin, ptx, pty, ptz, t0.y);
          } else if (ttype == rt::TEX_IMAGE) {
            float u, v;
            if (is_quad) {  // quad_uv from the row's alpha and beta basis
              const float4 t1 = __ldg(tex.rows + 3 * prim + 1);
              const float4 t2 = __ldg(tex.rows + 3 * prim + 2);
              u = (ptx * t1.x + pty * t1.y + ptz * t1.z) - t1.w;
              v = (ptx * t2.x + pty * t2.y + ptz * t2.z) - t2.w;
            } else {
              rt::sphere_uv(onx, ony, onz, u, v);
            }
            const rt::Texel c = rt::image_texel(tex.images, tex.dims, tex.img_h, tex.img_w,
                                                (int)t0.z, u, v, tex.filter, key, bounce,
                                                max_depth);
            texr = c.r;
            texg = c.g;
            texb = c.b;
          }
        }

        if (mtype == DIFFUSE_LIGHT) {
          // ---- emission; lights never scatter ----
          rdx = rdx + tpx * texr;
          rdy = rdy + tpy * texg;
          rdz = rdz + tpz * texb;
          break;
        }

        // ---- scatter ----
        const float u0 = rt::key_uniform(key, rt::shading_ctr(bounce, 0));
        const float u1 = rt::key_uniform(key, rt::shading_ctr(bounce, 1));
        const float sz = 1.0f - 2.0f * u0;
        const float sphi = TWO_PI * u1;
        const float sr = sqrtf(fmaxf(0.0f, 1.0f - sz * sz));
        const float ssx = sr * cosf(sphi);
        const float ssy = sr * sinf(sphi);
        const float ssz = sz;

        const float inv_dl = 1.0f / sqrtf(r.a);
        const float udx = dx * inv_dl;
        const float udy = dy * inv_dl;
        const float udz = dz * inv_dl;

        float sdx, sdy, sdz;
        float attr = texr, attg = texg, attb = texb;
        if (mtype == LAMBERTIAN) {
          sdx = nx + ssx;
          sdy = ny + ssy;
          sdz = nz + ssz;
          if (fabsf(sdx) < NEAR_ZERO && fabsf(sdy) < NEAR_ZERO && fabsf(sdz) < NEAR_ZERO) {
            sdx = nx;
            sdy = ny;
            sdz = nz;
          }
        } else {
          const float ud_n = udx * nx + udy * ny + udz * nz;
          const float refx = udx - 2.0f * ud_n * nx;
          const float refy = udy - 2.0f * ud_n * ny;
          const float refz = udz - 2.0f * ud_n * nz;
          if (mtype == METAL) {
            sdx = refx + prm * ssx;
            sdy = refy + prm * ssy;
            sdz = refz + prm * ssz;
            if (!((sdx * nx + sdy * ny + sdz * nz) > 0.0f)) break;  // absorbed
          } else {  // DIELECTRIC
            const float eta = front ? 1.0f / prm : prm;
            const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
            const float sin_t = sqrtf(fminf(fmaxf(1.0f - cos_t * cos_t, 1e-12f), 1.0f));
            const bool cannot = sin_t * eta > 1.0f;
            float r0 = (1.0f - eta) / (1.0f + eta);
            r0 = r0 * r0;
            const float om = 1.0f - cos_t;
            const float om2 = om * om;
            const float reflect_p = r0 + (1.0f - r0) * om2 * om2 * om;
            const float coin = rt::key_uniform(key, rt::shading_ctr(bounce, 2));
            if (cannot || reflect_p > coin) {
              sdx = refx;
              sdy = refy;
              sdz = refz;
            } else {
              const float perpx = eta * (udx + cos_t * nx);
              const float perpy = eta * (udy + cos_t * ny);
              const float perpz = eta * (udz + cos_t * nz);
              const float plen = perpx * perpx + perpy * perpy + perpz * perpz;
              const float par = -sqrtf(fmaxf(fabsf(1.0f - plen), 1e-12f));
              sdx = perpx + par * nx;
              sdy = perpy + par * ny;
              sdz = perpz + par * nz;
            }
            attr = attg = attb = 1.0f;
          }
        }

        // ---- throughput, then russian roulette from depth rr_start ----
        tpx = tpx * attr;
        tpy = tpy * attg;
        tpz = tpz * attb;
        if (bounce + 1 >= rr_start) {
          const float q = fminf(fmaxf(fmaxf(tpx, fmaxf(tpy, tpz)), rr_lo), rr_hi);
          const float rru = rt::key_uniform(key, rt::rr_ctr(bounce, max_depth));
          if (!(rru < q)) break;
          tpx = tpx / q;
          tpy = tpy / q;
          tpz = tpz / q;
        }
        ox = ptx;
        oy = pty;
        oz = ptz;
        dx = sdx;
        dy = sdy;
        dz = sdz;
      }
    }
    radiance[3 * (size_t)lane] = rdx;
    radiance[3 * (size_t)lane + 1] = rdy;
    radiance[3 * (size_t)lane + 2] = rdz;
  }
  if (segments_total != nullptr && segs > 0) atomicAdd(segments_total, segs);
}

}  // namespace

// The edge path kernel: radiance (n, 3) float32 of lanes [0, n), lane L
// tracing ray L mod k of origin and direction (k, 3) float32; `live` (k
// bools, or null: every ray live); `background` (3,) float32 on the card;
// `radius` the ns spheres' radii. Textures as kernel 2's (a null table
// selects the plain instantiation, `noise` the marble's), with a
// deterministic filter. `segments_total` (one 64-bit word the caller
// zeroes, or null) gets the lane-bounces traced. The grid is the resident
// one (the occupancy API's blocks per SM times the SMs) over grid_divisor,
// capped at n threads. Returns the first CUDA error of the device queries
// or the launch (0 = launched).
extern "C" int rt_edge_path(
    const void* sph, const void* radius, int ns, const void* quad, int nq, const void* res,
    const void* origin, const void* direction, const void* live, int k, int n,
    const void* background, int seed, int max_depth, int rr_start, float rr_lo, float rr_hi,
    int sky_gradient, void* radiance, void* segments_total, const void* tex_rows,
    const void* images, const void* dims, int img_h, int img_w, int filter, int noise,
    int grid_divisor, int threads, void* stream) {
  const TexArgs tex{(const float4*)tex_rows, (const float*)images, (const int*)dims, img_h,
                    img_w, filter};
  auto kernel = !tex_rows ? edge_path_kernel<TEXTURES_PLAIN>
                : noise   ? edge_path_kernel<TEXTURES_NOISE>
                          : edge_path_kernel<TEXTURES_IMAGE>;
  int device = 0, sms = 0, per_sm = 0, err = 0;
  if ((err = (int)cudaGetDevice(&device))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) {
    return err;
  }
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0))) {
    return err;
  }
  const long long resident = (long long)per_sm * sms * threads;
  const long long grid = resident / grid_divisor > threads ? resident / grid_divisor : threads;
  const int grid_threads = (int)(grid < n ? grid : n);
  const int blocks = (grid_threads + threads - 1) / threads;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)sph, (const float*)radius, ns, (const float4*)quad, nq,
      (const float4*)res, (const float*)origin, (const float*)direction, (const bool*)live, k,
      n, (const float*)background, (uint32_t)seed, max_depth, rr_start, rr_lo, rr_hi,
      sky_gradient, (float*)radiance, (unsigned long long*)segments_total, tex);
  return (int)cudaGetLastError();
}
