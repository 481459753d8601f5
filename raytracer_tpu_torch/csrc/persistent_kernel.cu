// Kernel 2: the whole regenerative wavefront render in one launch.
//
// Replaces raytracer_tpu/ops/persistent_kernel.py:render_persistent_pallas
// (_persistent_kernel): per lane, strided regeneration and the thin-lens
// camera ray, closest hit (dense, or cluster-culled: kCull below), winner
// resolve, hit epilogue, texture, miss/sky, emission, Lambertian / metal /
// dielectric scatter, depth budget, russian roulette, and retirement into
// the (3, K, N) per-(slot, lane) log.
//
// Textures are a compile-time parameter (kTex). The plain instantiation
// shades solid and checker textures from the (P, 16) row table only; in
// the others a winner whose texture-table row (materials/packed.py:
// texture_tables) is noise or image is shaded by csrc/textures.cuh: the
// 7-octave procedural Perlin marble, or the image at the sphere's or
// quad's UV through the nearest, 4-tap or stochastic single-tap filter
// (`filter`, uniform over a launch). Scenes without noise or image
// textures launch the plain instantiation, which holds no texture code;
// scenes with images and no noise the image one, which holds no Perlin
// tables.
//
// What bounds it on an H100: the closest-hit loop, ~20 FP32 operations per
// primitive per path segment (488 rows on rand_spheres), each its own
// instruction with contraction off (--fmad=false, ops/build.py), so the
// instruction issue rate sets its floor; SIMT divergence costs little (a
// warp runs until its longest lane queue drains: warp occupancy 0.947). On
// noise scenes (two to four spheres: a cheap closest hit) the marble
// bounds it: ~1,100 operations per noise hit from the block's shared
// Perlin tables (csrc/textures.cuh), evaluated by a warp whenever any of
// its lanes hits noise.
//
// Design: one thread per wavefront lane, each running its lane's whole
// strided sample queue in a loop, one path segment an iteration, until it
// owes no sample and has no path in flight; the noise instantiations first
// fill the block's shared Perlin tables and sync the block, before any
// thread leaves. This replaces the TPU tile's while_loop and its max
// reduces. All path state lives in registers; nothing touches device memory
// per bounce except the broadcast table reads (csrc/closest_hit.cuh), the
// winner's material row, read directly by index from the (P, 16) table
// (replacing the TPU's lane-gather chunk-band scan), and one coalesced store
// per retired sample at log[c, k, lane]: lanes are contiguous, and every
// (slot, lane) cell is written once, so the fold is deterministic with no
// framebuffer atomics. Random numbers are the ctr_rng counter hash keyed by
// the global sample id lane + k*N (csrc/ctr_rng.cuh), so the plain twin
// consumes identical uniforms. A per-lane safety bound of
// num_slots*(max_depth+2)+8 iterations mirrors the TPU kernel's. The
// sphere loop (csrc/closest_hit.cuh) takes the discriminants of a group of
// four rows and branches past their roots when all four miss, so a miss
// costs its ~17 operations and a quarter of a branch, and never reaches
// the square root's slow path.
//
// Culling is a compile-time parameter too (kCull, render mode only, with
// either kTex). It replaces the TPU kernel's cluster-culled sphere and quad
// loops (persistent_kernel.py:457-545, 571-602) for scenes that
// geometry/bvh.py:cluster_scene permuted into cluster order, by the
// two-level walk of csrc/cluster_walk.cuh under its per-lane policy. The
// TPU tile voted with jnp.any and skipped a loop under lax.cond; here each
// lane branches on its own test. A warp runs a loop while any of its lanes
// is in it, which costs what the tile vote cost and never changes a
// result; there is no warp vote, since lanes leave the kernel at different
// times (the early return, the `rem <= 0` break) and a __any_sync over
// exited lanes is undefined. The result equals the dense search in the
// visit order, ties included; the driver sorts fine rows front to back
// inside each super (render/driver.py:cluster_for_render), so that order
// is not the table's. The kernel keeps no count of the clusters it enters
// (the TPU kernel's clusters_entered): the twin counts them
// (ClusterVisit.hit_work), so a render pays for no counters.
//
// What bounds the culled instantiation on an H100: per segment, every
// super slab test (23 FP32 operations), the fine slab tests of the supers
// it enters, and 21 operations per sphere (40 per quad) of the fine
// clusters it enters. Bounce rays are incoherent, so a warp pays for the
// union of its lanes' clusters: the twin counts both the per-lane and the
// warp-union work (ClusterVisit.hit_work). A primitive far wider than the
// supers (a ground sphere or quad) has a fine row and a super of its own
// (geometry/bvh.py:isolate_oversized), so a bounce ray that leaves it
// does not walk the rest of a cluster stretched over the whole scene.
//
// Plain twin (and spec): raytracer_tpu_torch/integrator/wavefront.py:
// regen_plain. Shading math follows persistent_kernel.py:860-989 line by line;
// the sphere normal is normalized as in materials.py:resolve_and_shade.
//
// Kernel 3, the tape mode (kTape = true), replaces
// raytracer_tpu/ops/persistent_kernel.py:render_persistent_tape
// (_persistent_kernel_tape), the forward of the bucketed gradient: each of
// the N samples traced once to its end (sample s at pixel s mod
// width*height, keyed by s), no russian roulette (rr_start = max_depth), its
// radiance in the (3, 1, N) log at cell s, and the winner of every bounce
// in tape[b * N + s] (-1 for a miss; the wrapper fills the tape with -1 in
// one pass, so the kernel stores only the bounces a path reaches). What
// bounds it is the closest hit of its ~2.9 segments a sample; with one
// sample per thread a warp ran until the deepest of its 32 paths ended
// (depth 50), so three quarters of its issue slots idled (warp occupancy
// 0.241). So samples come from a queue: a thread whose path retires takes
// the next sample id from a global counter (take_sample: one atomicAdd per
// converged group of threads). The grid is a share of what stays resident
// on the card (the occupancy API's grid divided by
// ops/persistent_kernel.py:TAPE_GRID_DIVISOR, capped at N threads), so each
// thread traces tens of samples and its warp's lanes run out of samples
// together (a resident grid's ~5 samples a thread left a 50-segment path
// running alone at the end of most warps). A sample's
// outputs depend on its id alone, never on the thread that traced it, so
// they equal the twin's bit for bit. A safety bound of max_depth + 2
// iterations per sample mirrors the TPU kernel's. `thread_segs`, when
// given, receives each thread's segments (the measured warp occupancy).
// The TPU kernel's tile drained at its deepest lane of 8K and was split into
// a depth-capped launch plus an XLA continuation; one launch runs every
// sample to its end here. Plain twin (and spec):
// integrator/wavefront.py:trace_tape_plain. The render instantiation
// (kTape = false) compiles without any tape code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "camera.cuh"
#include "closest_hit.cuh"
#include "cluster_walk.cuh"
#include "ctr_rng.cuh"
#include "textures.cuh"

namespace {

namespace cg = cooperative_groups;
using rt::CAM_BG;
using rt::CAM_DEFOCUS;
using rt::TWO_PI;
constexpr float NEAR_ZERO = 1e-8f;

// Material types (geometry/scene.py).
constexpr int LAMBERTIAN = 0;
constexpr int METAL = 1;
constexpr int DIELECTRIC = 2;
constexpr int DIFFUSE_LIGHT = 3;

// Material row (materials/packed.py, 16 floats = 4 float4):
//   [g0 g1 g2 g3] [mtype prm c0x c0y] [c0z c1x c1y c1z] [its 0 0 0]
// g = sphere center | quad unit normal; g3 = signed radius | 0;
// prm = metal fuzz | ior; its = 1/checker scale (0 = solid).

// Texture inputs of the image and noise instantiations: the (P, 12)
// texture table as three float4 a row, the (I, img_h, img_w, 3) float32
// texels, their (I, 2) int32 true dims, and the image filter.
struct TexArgs {
  const float4* rows;
  const float* images;
  const int* dims;
  int img_h, img_w, filter;
};

// Kernel 3's sample queue: the next sample id for each calling thread,
// one atomicAdd on `next` per group of converged threads (ids past the
// last sample mean the queue is empty).
static __device__ __forceinline__ int take_sample(int* next) {
  const cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(next, (int)g.size());
  return g.shfl(base, 0) + (int)g.thread_rank();
}

// The texture instantiations (kTex): solid and checker textures only;
// image textures too; and the Perlin marble, whose tables each block fills
// into its shared memory. A scene without noise never pays for the tables
// (their shared memory, their fill, the registers of the marble's loads).
constexpr int TEXTURES_PLAIN = 0;
constexpr int TEXTURES_IMAGE = 1;
constexpr int TEXTURES_NOISE = 2;

template <bool kTape, int kTex, bool kCull>
__global__ void persistent_kernel(
    const float4* __restrict__ sph, int ns, const float4* __restrict__ quad, int nq,
    const float4* __restrict__ res, const float* __restrict__ cam, uint32_t seed,
    const int* __restrict__ rem0, const int* __restrict__ px0,
    const int* __restrict__ py0, int n, float* __restrict__ log,
    int* __restrict__ segs_out, int width, int height, int jump_px, int jump_py,
    int num_slots, int max_depth, int rr_start, float rr_lo, float rr_hi,
    int sky_gradient, int max_iters, int* __restrict__ tape, int* __restrict__ next_sample,
    int* __restrict__ thread_segs, TexArgs tex, rt::CullArgs cull) {
  // The noise instantiations' Perlin tables, filled by the whole block
  // before any of its threads leaves (the return below, kTape's queue break).
  const rt::PerlinTables* perlin = nullptr;
  if constexpr (kTex == TEXTURES_NOISE) {
    __shared__ rt::PerlinTables perlin_tables;
    rt::fill_perlin_tables(perlin_tables);
    __syncthreads();
    perlin = &perlin_tables;
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kTape && lane >= n) return;

  int rem = 0, px = 0, py = 0;
  if (!kTape) {
    rem = rem0[lane];
    px = px0[lane];
    py = py0[lane];
  }
  int sample = 0;     // kTape: the sample in flight
  int thread_segs_total = 0;  // kTape: segments of every sample this thread traced
  int sk = -1;
  int depth = 0;
  bool active = false;
  uint32_t key = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 1.0f, dz = 0.0f;
  float tpx = 1.0f, tpy = 1.0f, tpz = 1.0f;
  float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f;
  int segs = 0;  // the lane's segments (kTape: the sample's)
  const size_t ch_stride = (size_t)num_slots * (size_t)n;
  const bool use_disk = __ldg(cam + CAM_DEFOCUS) > 0.0f;

  for (int it = 0; kTape || it < max_iters; ++it) {
    // ---- regeneration: the next sample's pixel + camera ray ----
    if (!active) {
      if (kTape) {  // from the queue: sample s at pixel s mod (width*height)
        sample = take_sample(next_sample);
        if (sample >= n) break;
        const int pix = sample % (width * height);
        px = pix % width;
        py = pix / width;
        key = rt::sample_key(seed, (uint32_t)sample);
        segs = 0;
      } else {  // strided: the lane's next slot, the pixel advanced by the jump
        if (rem <= 0) break;
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
        key = rt::sample_key(seed, (uint32_t)lane + (uint32_t)sk * (uint32_t)n);
      }
      rt::camera_ray(cam, px, py, key, use_disk, ox, oy, oz, dx, dy, dz);
      tpx = tpy = tpz = 1.0f;
      rdx = rdy = rdz = 0.0f;
      depth = 0;
      active = true;
    }
    ++segs;
    ++thread_segs_total;

    // ---- closest hit (scaled-t compare space) ----
    const rt::RayTerms r = rt::ray_terms(ox, oy, oz, dx, dy, dz);
    float t_s = INFINITY;
    int prim = -1;
    if (kCull) {
      rt::clustered_candidates(cull, sph, ns, quad, nq, r, t_s, prim);
    } else {
      rt::sphere_candidates(sph, ns, r, t_s, prim);
      rt::quad_candidates(quad, nq, ns, r, t_s, prim);
    }
    if (kTape) tape[(size_t)depth * (size_t)n + (size_t)sample] = t_s < INFINITY ? prim : -1;

    bool survives = false;
    if (!(t_s < INFINITY)) {
      // ---- miss -> background / sky ----
      float bgr, bgg, bgb;
      if (sky_gradient) {
        const float inv_dl0 = 1.0f / sqrtf(r.a);
        const float sa = 0.5f * (dy * inv_dl0 + 1.0f);
        bgr = (1.0f - sa) + sa * 0.5f;
        bgg = (1.0f - sa) + sa * 0.7f;
        bgb = 1.0f;
      } else {
        bgr = __ldg(cam + CAM_BG + 0);
        bgg = __ldg(cam + CAM_BG + 1);
        bgb = __ldg(cam + CAM_BG + 2);
      }
      rdx = rdx + tpx * bgr;
      rdy = rdy + tpy * bgg;
      rdz = rdz + tpz * bgb;
    } else {
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
                                              (int)t0.z, u, v, tex.filter, key, depth,
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
      } else {
        // ---- scatter ----
        const float u0 = rt::key_uniform(key, rt::shading_ctr(depth, 0));
        const float u1 = rt::key_uniform(key, rt::shading_ctr(depth, 1));
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
        bool scattered = true;
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
            scattered = (sdx * nx + sdy * ny + sdz * nz) > 0.0f;
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
            const float coin = rt::key_uniform(key, rt::shading_ctr(depth, 2));
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

        // ---- depth budget + russian roulette ----
        const int bounce = depth;
        depth += 1;
        survives = scattered && depth < max_depth;
        if (survives) {
          tpx = tpx * attr;
          tpy = tpy * attg;
          tpz = tpz * attb;
          if (depth >= rr_start) {
            const float q = fminf(fmaxf(fmaxf(tpx, fmaxf(tpy, tpz)), rr_lo), rr_hi);
            const float rru = rt::key_uniform(key, rt::rr_ctr(bounce, max_depth));
            survives = rru < q;
            if (survives) {
              const float inv_q = 1.0f / q;
              tpx = tpx * inv_q;
              tpy = tpy * inv_q;
              tpz = tpz * inv_q;
            }
          }
        }
        if (survives) {
          ox = ptx;
          oy = pty;
          oz = ptz;
          dx = sdx;
          dy = sdy;
          dz = sdz;
        }
      }
    }

    // ---- retire a finished path into its (slot, lane) cell (kTape: its
    // sample's cell; a sample past its safety bound retires as it stands) ----
    if (!survives || (kTape && segs >= max_iters)) {
      const size_t cell = kTape ? (size_t)sample : (size_t)sk * (size_t)n + (size_t)lane;
      log[cell] = rdx;
      log[ch_stride + cell] = rdy;
      log[2 * ch_stride + cell] = rdz;
      if (kTape) segs_out[sample] = segs;
      active = false;
    }
  }
  if (!kTape) {
    segs_out[lane] = segs;
  } else if (thread_segs != nullptr) {
    thread_segs[lane] = thread_segs_total;
  }
}

}  // namespace

// Texture arguments of an entry point.
static TexArgs tex_args(const void* tex_rows, const void* images, const void* dims,
                        int img_h, int img_w, int filter) {
  return TexArgs{(const float4*)tex_rows, (const float*)images, (const int*)dims, img_h,
                 img_w, filter};
}

// The texture instantiation of a launch: a null texture table selects the
// plain one; `noise` (the scene has noise textures) the marble's.
static int textures_of(const void* tex_rows, int noise) {
  return !tex_rows ? TEXTURES_PLAIN : (noise ? TEXTURES_NOISE : TEXTURES_IMAGE);
}

// Kernel 2. A null cluster table selects the dense (kCull = false)
// instantiations. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int rt_render_persistent(
    const void* sph, int ns, const void* quad, int nq, const void* res, const void* cam,
    int seed, const void* rem0, const void* px0, const void* py0, int n, void* log,
    void* segs, int width, int height, int jump_px, int jump_py, int num_slots,
    int max_depth, int rr_start, float rr_lo, float rr_hi, int sky_gradient,
    int max_iters, const void* tex_rows, const void* images, const void* dims, int img_h,
    int img_w, int filter, int noise, const void* clusters, int s_super, int s_fine,
    int q_super, int q_fine, int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  const TexArgs tex = tex_args(tex_rows, images, dims, img_h, img_w, filter);
  const rt::CullArgs cull{(const float4*)clusters, s_super, s_fine, q_super, q_fine};
  const int textures = textures_of(tex_rows, noise);
  auto kernel =
      textures == TEXTURES_NOISE
          ? (clusters ? persistent_kernel<false, TEXTURES_NOISE, true>
                      : persistent_kernel<false, TEXTURES_NOISE, false>)
      : textures == TEXTURES_IMAGE
          ? (clusters ? persistent_kernel<false, TEXTURES_IMAGE, true>
                      : persistent_kernel<false, TEXTURES_IMAGE, false>)
          : (clusters ? persistent_kernel<false, TEXTURES_PLAIN, true>
                      : persistent_kernel<false, TEXTURES_PLAIN, false>);
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)sph, ns, (const float4*)quad, nq, (const float4*)res,
      (const float*)cam, (uint32_t)seed, (const int*)rem0, (const int*)px0,
      (const int*)py0, n, (float*)log, (int*)segs, width, height, jump_px, jump_py,
      num_slots, max_depth, rr_start, rr_lo, rr_hi, sky_gradient, max_iters, nullptr, nullptr,
      nullptr, tex, cull);
  return (int)cudaGetLastError();
}

// Kernel 3: radiance (3, n) float32, tape (max_depth, n) int32 (the caller
// fills it with -1), segs (n,). The grid is the resident one (the
// occupancy API's blocks per SM times the SMs) divided by grid_divisor,
// capped at n threads; its threads take samples from the queue counter
// `next_sample` (one int32 the caller zeroes). `thread_segs` (null, or one
// int32 per launched thread: at most n rounded up to a block) gets each
// thread's segments. The wrapper passes only deterministic image filters.
// Returns the first CUDA error of the device queries or the launch (0 =
// launched).
extern "C" int rt_render_persistent_tape(
    const void* sph, int ns, const void* quad, int nq, const void* res, const void* cam,
    int seed, int n, void* radiance, void* tape, void* segs, int width, int height,
    int max_depth, int sky_gradient, const void* tex_rows, const void* images,
    const void* dims, int img_h, int img_w, int filter, int noise, void* next_sample,
    void* thread_segs, int grid_divisor, int threads, void* stream) {
  const TexArgs tex = tex_args(tex_rows, images, dims, img_h, img_w, filter);
  const int textures = textures_of(tex_rows, noise);
  auto kernel = textures == TEXTURES_NOISE   ? persistent_kernel<true, TEXTURES_NOISE, false>
                : textures == TEXTURES_IMAGE ? persistent_kernel<true, TEXTURES_IMAGE, false>
                                             : persistent_kernel<true, TEXTURES_PLAIN, false>;
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
      (const float4*)sph, ns, (const float4*)quad, nq, (const float4*)res,
      (const float*)cam, (uint32_t)seed, nullptr, nullptr, nullptr, n,
      (float*)radiance, (int*)segs, width, height, 0, 0, /*num_slots=*/1, max_depth,
      /*rr_start=*/max_depth, 0.05f, 0.95f, sky_gradient, /*max_iters=*/max_depth + 2,
      (int*)tape, (int*)next_sample, (int*)thread_segs, tex, rt::CullArgs{nullptr, 0, 0, 0, 0});
  return (int)cudaGetLastError();
}
