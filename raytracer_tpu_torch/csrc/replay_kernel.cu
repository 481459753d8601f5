// The tape replay of the bucketed gradient step and its adjoint: each lane's
// whole path, forward and then in reverse, one thread a lane.
//
// Replaces no TPU kernel: the JAX package leaves the replay to XLA (its
// `make_tape_intersect_fn` inside `trace`, differentiated by jax.grad). The
// eager port ran it as about 330 PyTorch operations a bounce forward and
// 410 in autograd's backward, 50 bounces, with a boolean compaction (a host
// sync) at every bounce both ways: a train step held the card idle nine
// tenths of the time while the host launched them.
//
// Every decision of a lane's path is fixed before the replay starts: the
// winner of each bounce from the tape, the uniforms from the counter hash
// keyed by the sample id (csrc/ctr_rng.cuh), the depth bound from the tape
// (diff/bucketed.py:lane_depths). So one thread replays its lane to its end
// with no compaction and no sync:
// * `replay_forward`: the winner's t by geometry/intersect.py:winner_t_diff's
//   formulas, the shading by materials/materials.py:resolve_and_shade's
//   arithmetic in the same order (sphere normal normalize((p - c) * r), the
//   hollow-glass sign riding on r; Lambertian with its near-zero guard,
//   metal reflection plus fuzz, dielectric refraction; checker and solid
//   colours), the miss's background or sky. It writes the lane's radiance,
//   its segments, and each lane-bounce's state (origin, direction,
//   throughput: 9 floats; zero rows past its last segment) into a scratch
//   whose rows the caller lays out by an exclusive prefix sum of the lanes'
//   depth bounds.
// * `replay_adjoint`: the lane's bounces in reverse, each recomputed from
//   its stored state, carrying the adjoints of the throughput, the origin
//   and the direction from a bounce to the one before. It writes, for each
//   lane-bounce, one cotangent row of 16 floats laid out as the primitive
//   table's row (materials/packed.py): columns 0-3 the table's centre or
//   quad normal and signed radius (through the shading), 5 its fuzz or ior,
//   6-8 and 9-11 its two colours; the table's unused columns 12-15 carry
//   the intersection table's cotangent (the centre or quad normal, the
//   radius or quad offset, through t). Rows past a lane's last segment, and
//   miss bounces, are zero rows of index 0. Per lane: the cotangents of its
//   first ray's origin and direction and of the flat background.
// The caller sums the rows into the tables by csrc/gather_kernel.cu's fixed
// order (no float atomics), so a step's gradient is bit-identical from run
// to run.
//
// Each branch follows the eager code's autograd exactly where the eager code
// computed every branch for every lane and selected (torch.where): only the
// lane's own branch is differentiated here, which is what autograd's where
// gives, and no other branch's non-finite partial is ever formed. The
// dielectric's likelihood-ratio factor p / p.detach() has the forward value
// 1 and the gradient d log p (materials.py:_dielectric_lr).
//
// What bounds it on an H100: a few hundred FP32 operations a lane-bounce
// forward and about twice that in the adjoint, each its own instruction
// with contraction off (--fmad=false, ops/build.py), over ~1.8 M
// lane-bounces a train step: ~1 GFLOP, a few hundredths of a millisecond at
// 67 TFLOP/s; and the scratch and the rows, ~36 and 64 bytes a lane-bounce
// written once and read once. A warp runs until its deepest lane ends, so
// the issue rate is paid for the union of its lanes' bounces.
//
// Plain twin (and spec): raytracer_tpu_torch/ops/replay_kernel.py:
// replay_forward_plain and replay_adjoint_plain, which equal it bit for bit
// on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ctr_rng.cuh"

namespace {

constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float NEAR_ZERO = 1e-8f;
constexpr float T_MIN = 1e-3f;             // ops/intersect_kernel.py:T_MIN
constexpr float QUAD_DENOM_EPS = 1e-8f;    // ops/intersect_kernel.py:QUAD_DENOM_EPS
constexpr float LR_P_LO = 1e-4f;           // materials.py:_dielectric_lr's clamp
constexpr float LR_P_HI = 0.9999f;
constexpr int STATE_COLS = 9;
constexpr int ROW_COLS = 16;
constexpr int LANE_COLS = 9;

constexpr int LAMBERTIAN = 0;
constexpr int METAL = 1;
constexpr int DIFFUSE_LIGHT = 3;

struct V3 {
  float x, y, z;
};

static __device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// Every forward quantity of one bounce that its adjoint reads.
struct Bounce {
  bool hit;       // the tape's winner, and a finite t
  int prim;
  bool quad;
  float t;
  // winner t, sphere: oc = o - c, a = d.d, hb = d.oc, cq = oc.oc - r r
  V3 oc;
  float r, a_t, hb, cq, disc, sq, inv_a, num;
  bool disc_ok, first;
  // winner t, quad: n, dn = d.n, safe, tq = (dq - o.n) / safe
  V3 gq;
  float safe, tq;
  bool denom_ok;
  // shading
  V3 pt, g, s, su, n;
  float g3, s_len, sgn;
  bool front, use_c1;
  V3 tex;
  int mtype;
  float prm;
  V3 ss;
  float a, sqa, inv;
  V3 ud;
  float ud_n, k;
  // dielectric
  float eta, negudn, cos_t, q, d1, r0, om, om2, A, P1, P2, rp, pb, sqm, par, one_m_plen;
  bool cannot, use_reflect;
  V3 w, perp;
  // outcome
  V3 dir, att;
  bool scattered;
};

// The forward of one bounce from ray (o, d), the tape's winner `prim` (-1:
// a miss) and the bounce's three uniforms. Quantities of branches the lane
// does not take are left unset.
static __device__ __forceinline__ Bounce forward_bounce(
    const float4* __restrict__ table, const float4* __restrict__ geom, int ns, int prim,
    V3 o, V3 d, float u0, float u1, float u2) {
  Bounce f;
  f.prim = prim;
  f.hit = prim >= 0;
  f.quad = prim >= ns;
  f.t = INFINITY;
  if (f.hit) {
    const float4 gr = __ldg(geom + prim);
    if (!f.quad) {
      f.oc = V3{o.x - gr.x, o.y - gr.y, o.z - gr.z};
      f.r = gr.w;
      f.a_t = dot3(d, d);
      f.hb = dot3(d, f.oc);
      f.cq = dot3(f.oc, f.oc) - f.r * f.r;
      f.disc = f.hb * f.hb - f.a_t * f.cq;
      f.disc_ok = f.disc > 0.0f;
      f.sq = f.disc_ok ? sqrtf(f.disc) : 0.0f;
      f.inv_a = 1.0f / f.a_t;
      const float t0 = (-f.hb - f.sq) * f.inv_a;
      const float t1 = (-f.hb + f.sq) * f.inv_a;
      f.first = t0 > T_MIN;
      f.num = f.first ? -f.hb - f.sq : -f.hb + f.sq;
      f.t = f.first ? t0 : t1;
    } else {
      f.gq = V3{gr.x, gr.y, gr.z};
      const float dn = dot3(d, f.gq);
      f.denom_ok = fabsf(dn) >= QUAD_DENOM_EPS;
      f.safe = f.denom_ok ? dn : 1.0f;
      f.tq = (gr.w - dot3(o, f.gq)) / f.safe;
      f.t = f.tq;
    }
    f.hit = isfinite(f.t);
  }
  if (!f.hit) return f;

  const float4 m0 = __ldg(table + 4 * prim);
  const float4 m1 = __ldg(table + 4 * prim + 1);
  const float4 m2 = __ldg(table + 4 * prim + 2);
  const float its = __ldg(table + 4 * prim + 3).x;
  f.g = V3{m0.x, m0.y, m0.z};
  f.g3 = m0.w;
  f.mtype = (int)m1.x;
  f.prm = m1.y;
  const float t = f.t;
  f.pt = V3{o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
  V3 out = f.g;
  if (!f.quad) {
    f.s = V3{(f.pt.x - f.g.x) * f.g3, (f.pt.y - f.g.y) * f.g3, (f.pt.z - f.g.z) * f.g3};
    f.s_len = sqrtf(f.s.x * f.s.x + f.s.y * f.s.y + f.s.z * f.s.z + 1e-20f);
    f.su = V3{f.s.x / f.s_len, f.s.y / f.s_len, f.s.z / f.s_len};
    out = f.su;
  }
  f.front = dot3(d, out) < 0.0f;
  f.sgn = f.front ? 1.0f : -1.0f;
  f.n = V3{out.x * f.sgn, out.y * f.sgn, out.z * f.sgn};

  const int cpar = (int)floorf(f.pt.x * its) + (int)floorf(f.pt.y * its) +
                   (int)floorf(f.pt.z * its);
  f.use_c1 = its > 0.0f && (cpar & 1);
  f.tex = f.use_c1 ? V3{m2.y, m2.z, m2.w} : V3{m1.z, m1.w, m2.x};
  if (f.mtype == DIFFUSE_LIGHT) {
    f.scattered = false;
    return f;
  }

  const float sz = 1.0f - 2.0f * u0;
  const float sphi = TWO_PI_F * u1;
  const float sr = sqrtf(fmaxf(1.0f - sz * sz, 0.0f));
  f.ss = V3{sr * cosf(sphi), sr * sinf(sphi), sz};
  f.a = dot3(d, d);
  f.sqa = sqrtf(f.a);
  f.inv = 1.0f / f.sqa;
  f.ud = V3{d.x * f.inv, d.y * f.inv, d.z * f.inv};
  f.scattered = true;
  if (f.mtype == LAMBERTIAN) {
    f.dir = V3{f.n.x + f.ss.x, f.n.y + f.ss.y, f.n.z + f.ss.z};
    if (fabsf(f.dir.x) < NEAR_ZERO && fabsf(f.dir.y) < NEAR_ZERO && fabsf(f.dir.z) < NEAR_ZERO) {
      f.dir = f.n;
    }
    f.att = f.tex;
    return f;
  }
  f.ud_n = dot3(f.ud, f.n);
  f.k = 2.0f * f.ud_n;
  const V3 refl{f.ud.x - f.k * f.n.x, f.ud.y - f.k * f.n.y, f.ud.z - f.k * f.n.z};
  if (f.mtype == METAL) {
    f.dir = V3{refl.x + f.prm * f.ss.x, refl.y + f.prm * f.ss.y, refl.z + f.prm * f.ss.z};
    f.scattered = dot3(f.dir, f.n) > 0.0f;
    f.att = f.tex;
    return f;
  }
  // a dielectric (type 2; any other type scatters as one, as the eager
  // selection does)
  f.eta = f.front ? 1.0f / f.prm : f.prm;
  f.negudn = -f.ud_n;
  f.cos_t = fminf(f.negudn, 1.0f);
  const float sin_t = sqrtf(fminf(fmaxf(1.0f - f.cos_t * f.cos_t, 1e-12f), 1.0f));
  f.cannot = sin_t * f.eta > 1.0f;
  f.d1 = 1.0f + f.eta;
  f.q = (1.0f - f.eta) / f.d1;
  f.r0 = f.q * f.q;
  f.om = 1.0f - f.cos_t;
  f.om2 = f.om * f.om;
  f.A = 1.0f - f.r0;
  f.P1 = f.A * f.om2;
  f.P2 = f.P1 * f.om2;
  f.rp = f.r0 + f.P2 * f.om;
  f.use_reflect = f.cannot || f.rp > u2;
  const float p = fminf(fmaxf(f.rp, LR_P_LO), LR_P_HI);
  f.pb = f.use_reflect ? p : 1.0f - p;
  if (f.use_reflect) {
    f.dir = refl;
  } else {
    f.w = V3{f.ud.x + f.cos_t * f.n.x, f.ud.y + f.cos_t * f.n.y, f.ud.z + f.cos_t * f.n.z};
    f.perp = V3{f.eta * f.w.x, f.eta * f.w.y, f.eta * f.w.z};
    const float plen = dot3(f.perp, f.perp);
    f.one_m_plen = 1.0f - plen;
    f.sqm = sqrtf(fmaxf(fabsf(f.one_m_plen), 1e-12f));
    f.par = -f.sqm;
    f.dir = V3{f.perp.x + f.par * f.n.x, f.perp.y + f.par * f.n.y, f.perp.z + f.par * f.n.z};
  }
  f.att = V3{1.0f, 1.0f, 1.0f};
  return f;
}

struct Sky {
  float a, sqa, inv, sa;
};

// sky_color(d) (integrator/wavefront.py:sky_color): white to (0.5, 0.7, 1)
// on the unit direction's y.
static __device__ __forceinline__ Sky sky_of(V3 d) {
  Sky s;
  s.a = dot3(d, d);
  s.sqa = sqrtf(s.a);
  s.inv = 1.0f / s.sqa;
  s.sa = 0.5f * (d.y * s.inv + 1.0f);
  return s;
}

static __device__ __forceinline__ V3 background_of(V3 d, const float* __restrict__ bg,
                                                   int sky_gradient) {
  if (sky_gradient) {
    const Sky s = sky_of(d);
    return V3{(1.0f - s.sa) + s.sa * 0.5f, (1.0f - s.sa) + s.sa * 0.7f, 1.0f};
  }
  return V3{__ldg(bg), __ldg(bg + 1), __ldg(bg + 2)};
}

__global__ void replay_forward(
    const float4* __restrict__ table, const float4* __restrict__ geom, int ns,
    const int* __restrict__ tape, long long total, const long long* __restrict__ lanes,
    const long long* __restrict__ offs, const int* __restrict__ depth, int n_lanes,
    const float* __restrict__ o0, const float* __restrict__ d0, const float* __restrict__ bg,
    uint32_t seed, int max_depth, int sky_gradient, float* __restrict__ radiance,
    float* __restrict__ state, int* __restrict__ segs_out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n_lanes) return;
  const long long sample = lanes[l];
  const uint32_t key = rt::sample_key(seed, (uint32_t)sample);
  V3 o{o0[3 * l], o0[3 * l + 1], o0[3 * l + 2]};
  V3 d{d0[3 * l], d0[3 * l + 1], d0[3 * l + 2]};
  V3 tp{1.0f, 1.0f, 1.0f};
  V3 rad{0.0f, 0.0f, 0.0f};
  float* st = state + offs[l] * STATE_COLS;
  int segs = 0;
  // The depth bound holds every segment the replay can reach (a bounce
  // past the tape's last hit misses); it also bounds the lane's scratch.
  const int bounces = min(max_depth, depth[l]);
  for (int b = 0; b < bounces; ++b) {
    st[0] = o.x; st[1] = o.y; st[2] = o.z;
    st[3] = d.x; st[4] = d.y; st[5] = d.z;
    st[6] = tp.x; st[7] = tp.y; st[8] = tp.z;
    st += STATE_COLS;
    segs = b + 1;
    const int prim = tape[(long long)b * total + sample];
    const Bounce f = forward_bounce(
        table, geom, ns, prim, o, d, rt::key_uniform(key, rt::shading_ctr(b, 0)),
        rt::key_uniform(key, rt::shading_ctr(b, 1)), rt::key_uniform(key, rt::shading_ctr(b, 2)));
    if (!f.hit) {
      const V3 c = background_of(d, bg, sky_gradient);
      rad = V3{rad.x + tp.x * c.x, rad.y + tp.y * c.y, rad.z + tp.z * c.z};
      break;
    }
    if (f.mtype == DIFFUSE_LIGHT) {
      rad = V3{rad.x + tp.x * f.tex.x, rad.y + tp.y * f.tex.y, rad.z + tp.z * f.tex.z};
      break;
    }
    if (!f.scattered) break;
    tp = V3{tp.x * f.att.x, tp.y * f.att.y, tp.z * f.att.z};
    o = f.pt;
    d = f.dir;
  }
  for (int b = segs; b < depth[l]; ++b) {  // slots the lane never reached
#pragma unroll
    for (int c = 0; c < STATE_COLS; ++c) st[c] = 0.0f;
    st += STATE_COLS;
  }
  radiance[3 * l] = rad.x;
  radiance[3 * l + 1] = rad.y;
  radiance[3 * l + 2] = rad.z;
  segs_out[l] = segs;
}

// The adjoint of bounces [0, segs) of each lane, in reverse. `grad` is the
// (n_lanes, 3) cotangent of the radiance; `rows` (sum of depth, 16) and
// `idx` receive every slot [offs, offs + depth) of the lane; `lane_out`
// (n_lanes, 9): the cotangents of o0, d0 and the flat background.
__global__ void replay_adjoint(
    const float4* __restrict__ table, const float4* __restrict__ geom, int ns,
    const int* __restrict__ tape, long long total, const long long* __restrict__ lanes,
    const long long* __restrict__ offs, const int* __restrict__ depth,
    const int* __restrict__ segs_in, int n_lanes, const float* __restrict__ state,
    const float* __restrict__ grad, const float* __restrict__ bg, uint32_t seed,
    int sky_gradient, float* __restrict__ rows, int* __restrict__ idx,
    float* __restrict__ lane_out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n_lanes) return;
  const long long sample = lanes[l];
  const uint32_t key = rt::sample_key(seed, (uint32_t)sample);
  const V3 gc{grad[3 * l], grad[3 * l + 1], grad[3 * l + 2]};
  const long long off = offs[l];
  const int segs = segs_in[l];
  for (int b = segs; b < depth[l]; ++b) {  // slots the lane never reached
    float4* r4 = reinterpret_cast<float4*>(rows + (off + b) * ROW_COLS);
    const float4 z{0.0f, 0.0f, 0.0f, 0.0f};
    r4[0] = z; r4[1] = z; r4[2] = z; r4[3] = z;
    idx[off + b] = 0;
  }
  // Adjoints of the state after the bounce being visited (zero past the last).
  V3 Gtp{0.0f, 0.0f, 0.0f}, Go{0.0f, 0.0f, 0.0f}, Gd{0.0f, 0.0f, 0.0f};
  V3 Gbg{0.0f, 0.0f, 0.0f};
  for (int b = segs - 1; b >= 0; --b) {
    const float* st = state + (off + b) * STATE_COLS;
    const V3 o{st[0], st[1], st[2]};
    const V3 d{st[3], st[4], st[5]};
    const V3 tp{st[6], st[7], st[8]};
    const bool cont = b + 1 < segs;
    const int prim = tape[(long long)b * total + sample];
    const Bounce f = forward_bounce(
        table, geom, ns, prim, o, d, rt::key_uniform(key, rt::shading_ctr(b, 0)),
        rt::key_uniform(key, rt::shading_ctr(b, 1)), rt::key_uniform(key, rt::shading_ctr(b, 2)));
    float row[ROW_COLS];
#pragma unroll
    for (int c = 0; c < ROW_COLS; ++c) row[c] = 0.0f;
    V3 nGtp, nGo{0.0f, 0.0f, 0.0f}, nGd{0.0f, 0.0f, 0.0f};
    if (!f.hit) {
      // ---- miss: the background (a miss is a path's last segment) ----
      if (sky_gradient) {
        const Sky s = sky_of(d);
        const V3 c{(1.0f - s.sa) + s.sa * 0.5f, (1.0f - s.sa) + s.sa * 0.7f, 1.0f};
        const float cr = gc.x * tp.x;
        const float cg = gc.y * tp.y;
        const float Gsa = (cr * 0.5f - cr) + (cg * 0.7f - cg);
        const float Gy = 0.5f * Gsa;
        nGd.y = nGd.y + Gy * s.inv;
        const float Ginv = Gy * d.y;
        const float Gsqa = -(Ginv * (s.inv * s.inv));
        const float Ga = Gsqa / (2.0f * s.sqa);
        nGd = V3{nGd.x + 2.0f * (Ga * d.x), nGd.y + 2.0f * (Ga * d.y),
                 nGd.z + 2.0f * (Ga * d.z)};
        nGtp = V3{gc.x * c.x, gc.y * c.y, gc.z * c.z};
      } else {
        Gbg = V3{Gbg.x + gc.x * tp.x, Gbg.y + gc.y * tp.y, Gbg.z + gc.z * tp.z};
        nGtp = V3{gc.x * __ldg(bg), gc.y * __ldg(bg + 1), gc.z * __ldg(bg + 2)};
      }
    } else {
      const bool light = f.mtype == DIFFUSE_LIGHT;
      const bool lamb = f.mtype == LAMBERTIAN;
      const bool metal = f.mtype == METAL;
      V3 Gtex{0.0f, 0.0f, 0.0f}, Gn{0.0f, 0.0f, 0.0f}, Gpt{0.0f, 0.0f, 0.0f};
      V3 Gud{0.0f, 0.0f, 0.0f}, Grefl{0.0f, 0.0f, 0.0f};
      float Gprm = 0.0f;
      bool refl_on = false;
      nGtp = V3{0.0f, 0.0f, 0.0f};
      if (light) {
        nGtp = V3{gc.x * f.tex.x, gc.y * f.tex.y, gc.z * f.tex.z};
        Gtex = V3{gc.x * tp.x, gc.y * tp.y, gc.z * tp.z};
      } else if (cont) {
        nGtp = V3{Gtp.x * f.att.x, Gtp.y * f.att.y, Gtp.z * f.att.z};
        const V3 Gatt{Gtp.x * tp.x, Gtp.y * tp.y, Gtp.z * tp.z};
        Gpt = Go;
        const V3 Gdir = Gd;
        if (lamb) {
          Gn = V3{Gn.x + Gdir.x, Gn.y + Gdir.y, Gn.z + Gdir.z};
          Gtex = Gatt;
        } else if (metal) {
          Grefl = Gdir;
          refl_on = true;
          Gprm = Gprm + dot3(Gdir, f.ss);
          Gtex = Gatt;
        } else {  // dielectric
          float Geta = 0.0f, Gcos = 0.0f;
          if (f.use_reflect) {
            Grefl = Gdir;
            refl_on = true;
          } else {
            const float Gpar = dot3(Gdir, f.n);
            Gn = V3{Gn.x + f.par * Gdir.x, Gn.y + f.par * Gdir.y, Gn.z + f.par * Gdir.z};
            const float Gm = -Gpar / (2.0f * f.sqm);
            const float Gabs = fabsf(f.one_m_plen) >= 1e-12f ? Gm : 0.0f;
            const float sgn = f.one_m_plen > 0.0f ? 1.0f : (f.one_m_plen < 0.0f ? -1.0f : 0.0f);
            const float Gplen = -(Gabs * sgn);
            const V3 Gperp{Gdir.x + 2.0f * (Gplen * f.perp.x), Gdir.y + 2.0f * (Gplen * f.perp.y),
                           Gdir.z + 2.0f * (Gplen * f.perp.z)};
            Geta = Geta + dot3(Gperp, f.w);
            const V3 Gw{f.eta * Gperp.x, f.eta * Gperp.y, f.eta * Gperp.z};
            Gud = V3{Gud.x + Gw.x, Gud.y + Gw.y, Gud.z + Gw.z};
            Gcos = Gcos + dot3(Gw, f.n);
            Gn = V3{Gn.x + f.cos_t * Gw.x, Gn.y + f.cos_t * Gw.y, Gn.z + f.cos_t * Gw.z};
          }
          if (!f.cannot) {  // the likelihood ratio p / p.detach()
            const float Glr = Gatt.x + Gatt.y + Gatt.z;
            const float Gpb = Glr / f.pb;
            const float Gp = f.use_reflect ? Gpb : -Gpb;
            const float Grp = (f.rp >= LR_P_LO && f.rp <= LR_P_HI) ? Gp : 0.0f;
            float Gr0 = Grp;
            const float GP2 = Grp * f.om;
            float Gom = Grp * f.P2;
            const float GP1 = GP2 * f.om2;
            float Gom2 = GP2 * f.P1;
            const float GA = GP1 * f.om2;
            Gom2 = Gom2 + GP1 * f.A;
            Gr0 = Gr0 - GA;
            Gom = Gom + 2.0f * (Gom2 * f.om);
            Gcos = Gcos - Gom;
            const float Gq = 2.0f * (Gr0 * f.q);
            const float Gn1 = Gq / f.d1;
            const float Gd1 = -(Gq * (f.q / f.d1));
            Geta = (Geta - Gn1) + Gd1;
          }
          if (f.negudn <= 1.0f) {  // cos_t = min(-(ud.n), 1)
            Gud = V3{Gud.x - Gcos * f.n.x, Gud.y - Gcos * f.n.y, Gud.z - Gcos * f.n.z};
            Gn = V3{Gn.x - Gcos * f.ud.x, Gn.y - Gcos * f.ud.y, Gn.z - Gcos * f.ud.z};
          }
          Gprm = Gprm + (f.front ? -(Geta * (f.eta * f.eta)) : Geta);
        }
        if (refl_on) {  // refl = ud - (2 ud.n) n
          Gud = V3{Gud.x + Grefl.x, Gud.y + Grefl.y, Gud.z + Grefl.z};
          const float Gk = -dot3(Grefl, f.n);
          Gn = V3{Gn.x - Grefl.x * f.k, Gn.y - Grefl.y * f.k, Gn.z - Grefl.z * f.k};
          const float Gudn = 2.0f * Gk;
          Gud = V3{Gud.x + Gudn * f.n.x, Gud.y + Gudn * f.n.y, Gud.z + Gudn * f.n.z};
          Gn = V3{Gn.x + Gudn * f.ud.x, Gn.y + Gudn * f.ud.y, Gn.z + Gudn * f.ud.z};
        }
      }
      if (!light) {  // ud = d / sqrt(d.d)
        nGd = V3{nGd.x + Gud.x * f.inv, nGd.y + Gud.y * f.inv, nGd.z + Gud.z * f.inv};
        const float Ginv = dot3(Gud, d);
        const float Gsqa = -(Ginv * (f.inv * f.inv));
        const float Ga = Gsqa / (2.0f * f.sqa);
        nGd = V3{nGd.x + 2.0f * (Ga * d.x), nGd.y + 2.0f * (Ga * d.y), nGd.z + 2.0f * (Ga * d.z)};
      }
      // normal = outward * sign
      const V3 Gout{Gn.x * f.sgn, Gn.y * f.sgn, Gn.z * f.sgn};
      if (f.quad) {
        row[0] = row[0] + Gout.x;
        row[1] = row[1] + Gout.y;
        row[2] = row[2] + Gout.z;
      } else {  // outward = s / |s|, s = (p - c) r
        V3 Gs{Gout.x / f.s_len, Gout.y / f.s_len, Gout.z / f.s_len};
        const float Gslen = -(Gout.x * (f.su.x / f.s_len) + Gout.y * (f.su.y / f.s_len) +
                              Gout.z * (f.su.z / f.s_len));
        const float Gss = Gslen / (2.0f * f.s_len);
        Gs = V3{Gs.x + 2.0f * (Gss * f.s.x), Gs.y + 2.0f * (Gss * f.s.y),
                Gs.z + 2.0f * (Gss * f.s.z)};
        const V3 pmg{f.pt.x - f.g.x, f.pt.y - f.g.y, f.pt.z - f.g.z};
        const V3 Gpg{Gs.x * f.g3, Gs.y * f.g3, Gs.z * f.g3};
        row[3] = row[3] + dot3(Gs, pmg);
        Gpt = V3{Gpt.x + Gpg.x, Gpt.y + Gpg.y, Gpt.z + Gpg.z};
        row[0] = row[0] - Gpg.x;
        row[1] = row[1] - Gpg.y;
        row[2] = row[2] - Gpg.z;
      }
      row[5] = row[5] + Gprm;
      const int c0 = f.use_c1 ? 9 : 6;
      row[c0] = row[c0] + Gtex.x;
      row[c0 + 1] = row[c0 + 1] + Gtex.y;
      row[c0 + 2] = row[c0 + 2] + Gtex.z;
      // pt = o + t d
      nGo = V3{nGo.x + Gpt.x, nGo.y + Gpt.y, nGo.z + Gpt.z};
      const float Gt = dot3(Gpt, d);
      nGd = V3{nGd.x + f.t * Gpt.x, nGd.y + f.t * Gpt.y, nGd.z + f.t * Gpt.z};
      if (!f.quad) {  // the sphere's t (winner_t_diff)
        const float Gsq = f.first ? -(Gt * f.inv_a) : Gt * f.inv_a;
        float Ghb = -(Gt * f.inv_a);
        const float Ginva = Gt * f.num;
        float Ga2 = -(Ginva * (f.inv_a * f.inv_a));
        const float Gdisc = f.disc_ok ? Gsq / (2.0f * f.sq) : 0.0f;
        Ghb = Ghb + 2.0f * (Gdisc * f.hb);
        Ga2 = Ga2 - Gdisc * f.cq;
        const float Gcq = -(Gdisc * f.a_t);
        V3 Goc{2.0f * (Gcq * f.oc.x), 2.0f * (Gcq * f.oc.y), 2.0f * (Gcq * f.oc.z)};
        const float Gr = -(2.0f * (Gcq * f.r));
        nGd = V3{nGd.x + Ghb * f.oc.x, nGd.y + Ghb * f.oc.y, nGd.z + Ghb * f.oc.z};
        Goc = V3{Goc.x + Ghb * d.x, Goc.y + Ghb * d.y, Goc.z + Ghb * d.z};
        nGd = V3{nGd.x + 2.0f * (Ga2 * d.x), nGd.y + 2.0f * (Ga2 * d.y),
                 nGd.z + 2.0f * (Ga2 * d.z)};
        nGo = V3{nGo.x + Goc.x, nGo.y + Goc.y, nGo.z + Goc.z};
        row[12] = row[12] - Goc.x;
        row[13] = row[13] - Goc.y;
        row[14] = row[14] - Goc.z;
        row[15] = row[15] + Gr;
      } else {  // the quad's t
        const float Gnum = Gt / f.safe;
        const float Gsafe = -(Gt * (f.tq / f.safe));
        V3 Gnq{0.0f, 0.0f, 0.0f};
        if (f.denom_ok) {
          nGd = V3{nGd.x + Gsafe * f.gq.x, nGd.y + Gsafe * f.gq.y, nGd.z + Gsafe * f.gq.z};
          Gnq = V3{Gnq.x + Gsafe * d.x, Gnq.y + Gsafe * d.y, Gnq.z + Gsafe * d.z};
        }
        row[15] = row[15] + Gnum;
        nGo = V3{nGo.x - Gnum * f.gq.x, nGo.y - Gnum * f.gq.y, nGo.z - Gnum * f.gq.z};
        Gnq = V3{Gnq.x - Gnum * o.x, Gnq.y - Gnum * o.y, Gnq.z - Gnum * o.z};
        row[12] = row[12] + Gnq.x;
        row[13] = row[13] + Gnq.y;
        row[14] = row[14] + Gnq.z;
      }
    }
    float4* r4 = reinterpret_cast<float4*>(rows + (off + b) * ROW_COLS);
    r4[0] = make_float4(row[0], row[1], row[2], row[3]);
    r4[1] = make_float4(row[4], row[5], row[6], row[7]);
    r4[2] = make_float4(row[8], row[9], row[10], row[11]);
    r4[3] = make_float4(row[12], row[13], row[14], row[15]);
    idx[off + b] = f.hit ? prim : 0;
    Gtp = nGtp;
    Go = nGo;
    Gd = nGd;
  }
  float* lo = lane_out + (long long)l * LANE_COLS;
  lo[0] = Go.x; lo[1] = Go.y; lo[2] = Go.z;
  lo[3] = Gd.x; lo[4] = Gd.y; lo[5] = Gd.z;
  lo[6] = Gbg.x; lo[7] = Gbg.y; lo[8] = Gbg.z;
}

}  // namespace

// The forward: radiance (n_lanes, 3), state (sum of depth, 9), segs
// (n_lanes,) int32. Returns cudaGetLastError() after the launch.
extern "C" int rt_replay_forward(const void* table, const void* geom, int ns, const void* tape,
                                 int total, const void* lanes, const void* offs,
                                 const void* depth, int n_lanes, const void* o0, const void* d0,
                                 const void* bg, int seed, int max_depth, int sky_gradient,
                                 void* radiance, void* state, void* segs, int threads,
                                 void* stream) {
  const int blocks = (n_lanes + threads - 1) / threads;
  replay_forward<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)table, (const float4*)geom, ns, (const int*)tape, total,
      (const long long*)lanes, (const long long*)offs, (const int*)depth, n_lanes,
      (const float*)o0, (const float*)d0, (const float*)bg, (uint32_t)seed, max_depth,
      sky_gradient, (float*)radiance, (float*)state, (int*)segs);
  return (int)cudaGetLastError();
}

// The adjoint: rows (sum of depth, 16), idx (sum of depth,) int32, lane_out
// (n_lanes, 9). Returns cudaGetLastError() after the launch.
extern "C" int rt_replay_adjoint(const void* table, const void* geom, int ns, const void* tape,
                                 int total, const void* lanes, const void* offs,
                                 const void* depth, const void* segs, int n_lanes,
                                 const void* state, const void* grad, const void* bg, int seed,
                                 int sky_gradient, void* rows, void* idx, void* lane_out,
                                 int threads, void* stream) {
  const int blocks = (n_lanes + threads - 1) / threads;
  replay_adjoint<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)table, (const float4*)geom, ns, (const int*)tape, total,
      (const long long*)lanes, (const long long*)offs, (const int*)depth, (const int*)segs,
      n_lanes, (const float*)state, (const float*)grad, (const float*)bg, (uint32_t)seed,
      sky_gradient, (float*)rows, (int*)idx, (float*)lane_out);
  return (int)cudaGetLastError();
}
