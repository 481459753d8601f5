"""Time kernels 1, 2 (dense) and 3 at their paths' shapes, by CUDA events,
for variants of the build and launch settings taken in turns.

    python -m raytracer_tpu_torch.utils.time_kernels [--rounds 2] [--reps 3] \\
        [--variant NAME:KEY=VALUE,...]...

Cells (each through its public wrapper, so a parent checkout runs it too):

* `k2_rand_spheres`: kernel 2 dense at rand_spheres 400x225@500spp depth 50
  on the render's 2^18 lanes, seed 0 (the CLI render's kernel call);
* `k2_cornell` (quads only) and `k2_quads_1536` (quad_field cut to 1,534
  tiles, its ground quad and its dummy sphere: 1,536 primitives, the most
  a dense render serves), both 400 wide, 16 spp, depth 50 and 8, on 2^18
  lanes; `k2_perlin`, `k2_simple_light` and `k2_earth` (nearest) (textured,
  400x225@100spp depth 50), and
  `k2_culled_large`, `k2_culled_50k` and `k2_culled_quad_field`
  (rand_spheres_large, its 50,001-sphere variant and quad_field clustered
  as the render clusters them, 400x225@64spp depth 8: the culled
  instantiation), the renders' kernel calls;
* `k3_train`: kernel 3 at rand_spheres 400x225@8spp depth 50, 720,000
  lanes, seed 1234 (the bucketed training step's forward), with its warp
  occupancy (segments / the sum over warps of the busiest thread's
  segments x 32); `k3_earth` (the 4-tap) and `k3_perlin` likewise, all
  three timed behind a spin kernel;
* `k1_train`: kernel 1 on that step's 720,000 bounce-0 camera rays (seed
  101), timed behind a spin kernel;
* `k1_scan`: kernel 1 at every launch of one "scan" training step on
  rand_spheres 400x225@8spp depth 50 (seed 101, texture colors halved),
  each at its own rays, summed (the step's 50 launches, recorded as the
  step makes them);
* `k1_large` and `k4_large`: render_loop's large-scene path on rand_spheres_large
  at 400x225@64spp depth 8, seed 0, its launches recorded as the render
  makes them: every bounce launch of kernel 1 (dense in a checkout whose
  large-scene path walks no cluster table, else its clustered entry),
  summed, and kernel 4's first launch (the first pass's 360,000 camera
  rays), each on that checkout's own tables.

A variant sets `threads` (kernel 2 and 3's block size), `k1_threads`
(kernel 1's), where the checkout has them `clustered_threads` (the
clustered walk's: kernel 1's clustered entry and kernel 4) and `split_target`
(ops/intersect_kernel.py:SPLIT_TARGET_BLOCKS, the split launches' blocks
an SM), `tape_grid` (ops/persistent_kernel.py:TAPE_GRID_DIVISOR,
where the checkout has it), the culled cells' clustering where the
checkout's render/driver.py has these settings (`sph` and `quad`:
CLUSTER_GRAIN's leaf/fan of each kind, e.g. `sph=32/16`; `oversize`:
CLUSTER_OVERSIZE, `inf` for JAX's tables) and `patch`: names from PATCHES
joined by '+', source edits applied to a copy of csrc/ that builds into a
library of its own (e.g. `--variant g8:patch=group8` or `--variant
grid1:tape_grid=1`). PATCHES holds the loop variants measured against this
source and not kept; each edit must find its anchor, or the script fails.
Without --variant the checkout's own settings run as "default". Rounds run
the variants in turns (forwards, then backwards). Every variant's outputs
must equal the first variant's bit for bit, or the script fails; a culled
cell under other clustering settings than the first variant's (whose
permuted tables may break a tie in t the other way) is compared and the
result printed (`<cell>_equal`). Prints one JSON line per (round,
variant) and a summary line of medians.
"""

from __future__ import annotations

import argparse
import inspect
import json
import shutil
import statistics
import subprocess

# Source edits of the variants measured and not kept: {name: [(file, old,
# new)]}, against csrc/closest_hit.cuh's grouped sphere loop and
# csrc/persistent_kernel.cu.
_SKIP = "    if (!any_real) continue;  // every row of the group missed: no root\n"
_LAUNCH = "kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>("
_STAGE_HELPER = """// Dynamic shared memory of a staged launch (none when culled).
static size_t stage_bytes(const void* kernel, int ns, int nq, bool culled) {
  const size_t bytes = culled ? 0 : sizeof(float4) * ((size_t)ns + 3 * (size_t)nq);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return bytes;
}

"""
# The early-out quad loop (measured and not kept: PERF.md, section 6):
# rows in groups of four, each row's plane terms first, and its division,
# t compare and in-quad loads only where its plane faces the ray.
_QUAD_LOOP = """static __device__ __forceinline__ void quad_candidates_range(
    const float4* __restrict__ quad, int begin, int end, int prim_offset, const RayTerms& r,
    float& t_best, int& p_best) {
  for (int qi = begin; qi < end; ++qi) {
    const float4 q0 = __ldg(quad + 3 * qi);
    const float4 q1 = __ldg(quad + 3 * qi + 1);
    const float4 q2 = __ldg(quad + 3 * qi + 2);
    const float d_n = r.dx * q0.x + r.dy * q0.y + r.dz * q0.z;
    const float o_n = r.ox * q0.x + r.oy * q0.y + r.oz * q0.z;
    const bool denom_ok = fabsf(d_n) >= QUAD_DENOM_EPS;
    const float t = (q0.w - o_n) / (denom_ok ? d_n : 1.0f);
    // av = (q1.x, q1.y, q1.z), bv = (q1.w, q2.x, q2.y)
    const float alpha = (r.ox * q1.x + r.oy * q1.y + r.oz * q1.z) +
                        t * (r.dx * q1.x + r.dy * q1.y + r.dz * q1.z) - q2.z;
    const float beta = (r.ox * q1.w + r.oy * q2.x + r.oz * q2.y) +
                       t * (r.dx * q1.w + r.dy * q2.x + r.dz * q2.y) - q2.w;
    const bool ok = denom_ok && (t > T_MIN) && (alpha >= 0.0f) && (alpha <= 1.0f) &&
                    (beta >= 0.0f) && (beta <= 1.0f);
    const float t_cand = ok ? t * r.a : INFINITY;
    if (t_cand < t_best) {
      t_best = t_cand;
      p_best = prim_offset + qi;
    }
  }
}

"""
_QUAD_EARLY_OUT = """// Quad rows per group of quad_candidates_range.
constexpr int QUAD_GROUP = 4;

// The plane terms of one quad row: num = n.Q - o.n and d.n, the numerator
// and denominator of its t. Whether the row can give a candidate past
// T_MIN: |d.n| >= QUAD_DENOM_EPS, and num and d.n nonzero and of one sign
// (the sign of an IEEE quotient is the XOR of its operands' signs, so any
// other row has t <= 0 or NaN, which `t > T_MIN` rejects). NaN fails every
// compare.
static __device__ __forceinline__ bool quad_plane(const float4 q0, const RayTerms& r,
                                                  float& num, float& d_n) {
  d_n = r.dx * q0.x + r.dy * q0.y + r.dz * q0.z;
  const float o_n = r.ox * q0.x + r.oy * q0.y + r.oz * q0.z;
  num = q0.w - o_n;
  return fabsf(d_n) >= QUAD_DENOM_EPS && ((num > 0.0f) ? (d_n > 0.0f) : (num < 0.0f && d_n < 0.0f));
}

// The rest of one quad row's test once its plane faces the ray: t, then,
// only while t * a can win the strict `<` against t_best, the in-quad
// coordinates (the row's other two float4) and the compare.
static __device__ __forceinline__ void quad_finish(const float4* __restrict__ quad, int qi,
                                                   float num, float d_n, int prim_offset,
                                                   const RayTerms& r, float& t_best,
                                                   int& p_best) {
  const float t = num / d_n;
  const float t_cand = t * r.a;
  if (!(t > T_MIN) || !(t_cand < t_best)) return;
  const float4 q1 = __ldg(quad + 3 * qi + 1);
  const float4 q2 = __ldg(quad + 3 * qi + 2);
  // av = (q1.x, q1.y, q1.z), bv = (q1.w, q2.x, q2.y)
  const float alpha = (r.ox * q1.x + r.oy * q1.y + r.oz * q1.z) +
                      t * (r.dx * q1.x + r.dy * q1.y + r.dz * q1.z) - q2.z;
  const float beta = (r.ox * q1.w + r.oy * q2.x + r.oz * q2.y) +
                     t * (r.dx * q1.w + r.dy * q2.x + r.dz * q2.y) - q2.w;
  if ((alpha >= 0.0f) && (alpha <= 1.0f) && (beta >= 0.0f) && (beta <= 1.0f)) {
    t_best = t_cand;
    p_best = prim_offset + qi;
  }
}

static __device__ __forceinline__ void quad_candidates_range(
    const float4* __restrict__ quad, int begin, int end, int prim_offset, const RayTerms& r,
    float& t_best, int& p_best) {
  int qi = begin;
  for (; qi + QUAD_GROUP <= end; qi += QUAD_GROUP) {
    float num[QUAD_GROUP], d_n[QUAD_GROUP];
    bool faces[QUAD_GROUP];
    bool any_faces = false;
#pragma unroll
    for (int k = 0; k < QUAD_GROUP; ++k) {
      faces[k] = quad_plane(__ldg(quad + 3 * (qi + k)), r, num[k], d_n[k]);
      any_faces |= faces[k];
    }
    if (!any_faces) continue;  // no row of the group faces the ray: no division
#pragma unroll
    for (int k = 0; k < QUAD_GROUP; ++k) {
      if (faces[k]) quad_finish(quad, qi + k, num[k], d_n[k], prim_offset, r, t_best, p_best);
    }
  }
  for (; qi < end; ++qi) {
    float num, d_n;
    if (quad_plane(__ldg(quad + 3 * qi), r, num, d_n)) {
      quad_finish(quad, qi, num, d_n, prim_offset, r, t_best, p_best);
    }
  }
}

"""
_TEX = "textures.cuh"
_PERM_TABLE = """  const uint32_t w = tab.pair[kAxis][i];
  p0 = w & 255u;
  p1 = w >> 8;
"""
_PERM_HASH = """  p0 = perm_u8<kAxis>(i);
  p1 = perm_u8<kAxis>((i + 1u) & 255u);
"""
_GRAD_HASH = """  const float4 g = make_float4(grad_component<0>(h), grad_component<1>(h),
                               grad_component<2>(h), 0.0f);
"""
PATCHES = {
    # The marble's Perlin tables (csrc/textures.cuh): `hash` recomputes
    # every permutation and gradient as the parent kernel did (the tables
    # are filled and not read), `permhash` the permutations only.
    "permhash": [(_TEX, _PERM_TABLE, _PERM_HASH)],
    "hash": [(_TEX, _PERM_TABLE, _PERM_HASH),
             (_TEX, "  const float4 g = tab.grad[h];\n", _GRAD_HASH)],
    # Kernel 4 walking per lane instead of under the warp vote.
    "perlane": [("culled_kernel.cu", "clustered_candidates<rt::WALK_WARP_VOTE>",
                 "clustered_candidates<rt::WALK_PER_LANE>")],
    # At most 64 registers a thread (eight blocks of 128 threads an SM).
    "regs64": [("persistent_kernel.cu", "__global__ void persistent_kernel(",
                "__global__ void __launch_bounds__(128, 8) persistent_kernel(")],
    "quadearly": [("closest_hit.cuh", _QUAD_LOOP, _QUAD_EARLY_OUT)],
    # Every row's root, misses masked (no group branch).
    "select": [("closest_hit.cuh", _SKIP, "")],
    # The parent's loop: every row's root, NaN for misses.
    "nomask": [("closest_hit.cuh", _SKIP, ""),
               ("closest_hit.cuh", "sqrtf(real ? disc : 1.0f)", "sqrtf(disc)"),
               ("closest_hit.cuh", "return real ? t_cand : INFINITY;", "return t_cand;")],
    **{f"group{k}": [("closest_hit.cuh", "constexpr int SPHERE_GROUP = 4;",
                      f"constexpr int SPHERE_GROUP = {k};")] for k in (1, 2, 8)},
    # Kernels 2 and 3 dense with the sphere and quad tables copied into each
    # block's shared memory (plain loads, LDS there; every other kernel's
    # loads lose __ldg too). Kernel 3's grid is still sized without it.
    "stage": [
        ("closest_hit.cuh", "__ldg(sph + i + k)", "sph[i + k]"),
        ("closest_hit.cuh", "__ldg(sph + i)", "sph[i]"),
        ("closest_hit.cuh", "__ldg(quad + 3 * qi)", "quad[3 * qi]"),
        ("closest_hit.cuh", "__ldg(quad + 3 * qi + 1)", "quad[3 * qi + 1]"),
        ("closest_hit.cuh", "__ldg(quad + 3 * qi + 2)", "quad[3 * qi + 2]"),
        ("persistent_kernel.cu", "  const int lane = blockIdx.x * blockDim.x + threadIdx.x;\n",
         """  extern __shared__ float4 staged[];
  if (!kCull) {
    for (int i = threadIdx.x; i < ns + 3 * nq; i += blockDim.x) {
      staged[i] = i < ns ? __ldg(sph + i) : __ldg(quad + (i - ns));
    }
    __syncthreads();
    sph = staged;
    quad = staged + ns;
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
"""),
        ("persistent_kernel.cu", 'extern "C" int rt_render_persistent(\n',
         _STAGE_HELPER + 'extern "C" int rt_render_persistent(\n'),
        ("persistent_kernel.cu", "persistent_kernel<false, TEXTURES_PLAIN, false>);\n  " + _LAUNCH,
         "persistent_kernel<false, TEXTURES_PLAIN, false>);\n  " + _LAUNCH.replace(
             "0,", "stage_bytes((const void*)kernel, ns, nq, clusters != nullptr),")),
        ("persistent_kernel.cu", "/ threads;\n  " + _LAUNCH, "/ threads;\n  " + _LAUNCH.replace(
            "0,", "stage_bytes((const void*)kernel, ns, nq, false),")),
    ],
}


def _time(fn, reps: int, spin: bool = False) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:  # a kernel shorter than its wrapper's host time: queue behind a spin
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _persistent_cell(name, spp, max_depth, seed=0, lanes=1 << 18, clustered=False, **scene_kw):
    """Kernel 2 on `name` (clustered as the render clusters it: the culled
    instantiation)."""
    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.geometry.intersect import quad_derived
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.materials.packed import texture_tables
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.scenes.registry import get_scene

    from raytracer_tpu_torch.render.driver import cluster_for_render

    scene, cam, st = get_scene(name, spp=spp, max_depth=max_depth, **scene_kw)
    clusters = None
    if clustered:
        scene, cs = cluster_for_render(scene, cam)
        clusters = pk.pack_cluster_table(cs, "cuda")
    sc = scene.to("cuda")
    w, h = st.width, st.height
    n, num_slots, jump = wf.strided_schedule(w * h, spp, lanes)
    args = (*pk.pack_persistent_tables(sc),
            pk.pack_camera_scalars_bg(camera_frame(cam, w, h), cam.background).cuda(), seed,
            *wf.schedule_arrays(n, w * h, spp, w, device="cuda"))
    cfg = dict(width=w, height=h, jump_px=jump % w, jump_py=jump // w, num_slots=num_slots,
               max_depth=max_depth, rr_start=5, rr_lo=0.05, rr_hi=0.75,
               sky_gradient=st.sky_gradient, textures=texture_tables(sc, quad_derived(sc)),
               clusters=clusters)
    return (lambda: pk.render_persistent(*args, **cfg)), dict(
        ns=sc.num_spheres, nq=sc.num_quads, size=[w, h], spp=spp, max_depth=max_depth,
        lanes=n)


def _cluster_settings():
    """The checkout's render/driver.py clustering settings (None where it
    has none)."""
    from raytracer_tpu_torch.render import driver

    grain = getattr(driver, "CLUSTER_GRAIN", None)
    return (tuple(map(tuple, grain.values())) if grain else None,
            getattr(driver, "CLUSTER_OVERSIZE", None))


def _culled_cell(name, **scene_kw):
    """Kernel 2 culled on `name` at 400x225@64spp depth 8, clustered as the
    render clusters it under the clustering settings current at its call:
    each settings' kernel call is built at its first call (untimed) and
    kept."""
    calls = {}

    def call():
        key = _cluster_settings()
        if key not in calls:
            calls[key] = _persistent_cell(name, 64, 8, clustered=True, **scene_kw)[0]
        return calls[key]()

    return call


def _tape_cell(name, **scene_kw):
    """Kernel 3 at the training shape (400x225, 8 spp, depth 50, seed 1234;
    image scenes through the 4-tap); timed behind a spin kernel, as short
    kernels must be. Its call takes `thread_segments`, passed on where the
    checkout's wrapper has it (only the measuring call asks)."""
    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.geometry.intersect import quad_derived
    from raytracer_tpu_torch.materials.packed import texture_tables
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.scenes.registry import get_scene

    scene, cam, st = get_scene(name, width=400, spp=8, max_depth=50, **scene_kw)
    sc = scene.to("cuda")
    w, h = st.width, st.height
    tables = pk.pack_persistent_tables(sc)
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, w, h), cam.background).cuda()
    n = w * h * 8
    kw = dict(width=w, height=h, max_depth=50, sky_gradient=st.sky_gradient,
              textures=texture_tables(sc, quad_derived(sc), stochastic=False))
    queue = "thread_segments" in inspect.signature(pk.render_persistent_tape).parameters

    def call(thread_segments=False):
        extra = dict(thread_segments=True) if thread_segments and queue else {}
        return pk.render_persistent_tape(*tables, cam_s, 1234, n, **kw, **extra)

    return (call, 5, True,
            dict(ns=sc.num_spheres, nq=sc.num_quads, lanes=n, size=[w, h], spp=8, max_depth=50))


def _recorded(run, targets):
    """Run `run()` with each (module, attribute) of `targets` replaced by a
    recorder that passes the call on and keeps the real function and its
    arguments (tensors cloned); returns [(fn, args)] in call order."""
    import torch

    calls = []
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def recorder(fn):
        def call(*args):
            calls.append((fn, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                    for a in args)))
            return fn(*args)
        return call

    try:
        for mod, name, fn in saved:
            setattr(mod, name, recorder(fn))
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls


def _replay(calls):
    """A cell call that makes every recorded call again; returns their
    outputs, flattened."""
    return lambda: tuple(x for fn, args in calls for x in fn(*args))


def _path_cells() -> dict:
    """The k1_scan, k1_large and k4_large cells (see the module docstring)."""
    import dataclasses

    import torch

    from raytracer_tpu_torch.diff.grad import make_inverse_renderer, render_linear_diff
    from raytracer_tpu_torch.ops import culled_kernel as ck
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.render.driver import render_loop
    from raytracer_tpu_torch.scenes.registry import get_scene

    out = {}
    scene, cam, st = get_scene("rand_spheres", width=400, spp=8, max_depth=50)
    kw = dict(width=st.width, height=st.height, samples_per_pass=8, max_depth=50)
    with torch.no_grad():
        target = render_linear_diff(scene.to("cuda"), cam, 7, **kw)
    start = dataclasses.replace(scene, tex_c0=scene.tex_c0 * 0.5)
    _, _, step = make_inverse_renderer(start, cam, target, backend="scan",
                                       learning_rate=1e-2, device="cuda", **kw)
    calls = _recorded(lambda: step(101), [(ik, "intersect")])
    out["k1_scan"] = (_replay(calls), 10, True, dict(
        launches=len(calls), rays=sum(a[2].shape[0] for _, a in calls)))

    scene, cam, st = get_scene("rand_spheres_large", spp=64)
    sc = scene.to("cuda")
    clustered = hasattr(ik, "intersect_clustered")
    k1 = "intersect_clustered" if clustered else "intersect"
    calls = _recorded(lambda: render_loop(sc, cam, st, path="large_scene", seed=0),
                      [(ik, k1), (ck, "intersect_culled")])
    bounces = [c for c in calls if c[0] is not ck.intersect_culled]
    first_camera = [c for c in calls if c[0] is ck.intersect_culled][:1]
    out["k1_large"] = (_replay(bounces), 3, True, dict(
        entry=k1, launches=len(bounces), rays=sum(a[-1].shape[0] for _, a in bounces)))
    out["k4_large"] = (_replay(first_camera), 20, True,
                       dict(rays=first_camera[0][1][-1].shape[0]))
    return out


def cells():
    """{cell: (call, reps, spin, info)}; each call returns its outputs."""
    import torch

    from raytracer_tpu_torch.core.camera import camera_frame, camera_rays
    from raytracer_tpu_torch.geometry.intersect import scene_tables
    from raytracer_tpu_torch.ops import ctr_rng
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.scenes.registry import get_scene

    out = {}
    k2, info = _persistent_cell("rand_spheres", 500, 50)
    out["k2_rand_spheres"] = (k2, 3, False, info)
    k2, info = _persistent_cell("cornell", 16, 50, width=400)
    out["k2_cornell"] = (k2, 3, False, info)
    k2, info = _persistent_cell("quad_field", 16, 8, n_spheres=1534)
    out["k2_quads_1536"] = (k2, 3, False, info)
    for name in ("perlin", "simple_light", "earth"):
        k2, info = _persistent_cell(name, 100, 50)
        out[f"k2_{name}"] = (k2, 3, False, info)
    for cell, name, kw in (("k2_culled_large", "rand_spheres_large", {}),
                           ("k2_culled_50k", "rand_spheres_large", {"n_spheres": 50000}),
                           ("k2_culled_quad_field", "quad_field", {})):
        out[cell] = (_culled_cell(name, **kw), 3, False,
                     dict(scene=name, **kw, size=[400, 225], spp=64, max_depth=8))

    for cell, name, kw in (("k3_train", "rand_spheres", {}),
                           ("k3_earth", "earth", {"bilinear": True}), ("k3_perlin", "perlin", {})):
        out[cell] = _tape_cell(name, **kw)
    scene, cam, st = get_scene("rand_spheres", width=400, spp=8, max_depth=50)
    sc = scene.to("cuda")
    w, h = st.width, st.height
    frame = camera_frame(cam, w, h)
    n = w * h * 8
    sid = torch.arange(n, device="cuda")
    pix = sid % (w * h)
    o, d = camera_rays(frame.to("cuda"), pix % w, pix // w, ctr_rng.camera_uniforms(101, sid))
    o, d = o.contiguous(), d.contiguous()
    sph, quad = scene_tables(sc)
    out["k1_train"] = ((lambda: ik.intersect(sph, quad, o, d)), 20, True,
                       dict(rays=n, ns=sc.num_spheres, nq=sc.num_quads))
    out.update(_path_cells())
    return out


def _apply(variant: dict, defaults: dict):
    """Set a variant's launch settings and select its library; `defaults`
    holds the checkout's own settings."""
    from raytracer_tpu_torch.ops import build
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import persistent_kernel as pk

    pk.THREADS = int(variant.get("threads", defaults["threads"]))
    ik.THREADS = int(variant.get("k1_threads", defaults["k1_threads"]))
    for key, mod, name in (("clustered_threads", ik, "CLUSTERED_THREADS"),
                           ("split_target", ik, "SPLIT_TARGET_BLOCKS")):
        if hasattr(mod, name):
            setattr(mod, name, int(variant.get(key, defaults[key])))
        elif key in variant:
            raise SystemExit(f"time_kernels: this checkout has no {name} for {key}")
    if hasattr(pk, "TAPE_GRID_DIVISOR"):
        pk.TAPE_GRID_DIVISOR = int(variant.get("tape_grid", defaults["tape_grid"]))
    from raytracer_tpu_torch.render import driver

    if hasattr(driver, "CLUSTER_GRAIN"):
        driver.CLUSTER_GRAIN = {kind: tuple(int(x) for x in variant[kind].split("/"))
                                if kind in variant else defaults["grain"][kind]
                                for kind in ("sph", "quad")}
        driver.CLUSTER_OVERSIZE = float(variant.get("oversize", defaults["oversize"]))
    elif any(k in variant for k in ("sph", "quad", "oversize")):
        raise SystemExit("time_kernels: this checkout's render driver has no clustering settings")
    build.CSRC_DIR = defaults["csrc"]
    patches = [p for p in variant.get("patch", "").split("+") if p]
    if patches:
        csrc = build.BUILD_DIR / "variants" / "+".join(patches)
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(defaults["csrc"], csrc)
        for name in patches:
            for fname, old, new in PATCHES[name]:
                f = csrc / fname
                text = f.read_text()
                if old not in text:
                    raise SystemExit(f"time_kernels: patch {name} finds no anchor in {fname}")
                f.write_text(text.replace(old, new))
        build.CSRC_DIR = csrc
    build.load_kernels.cache_clear()
    build.load_kernels()


def _parse_variant(text: str) -> tuple[str, dict]:
    name, _, rest = text.partition(":")
    return name, dict(kv.split("=", 1) for kv in rest.split(",") if kv)


def _outputs_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None) -> dict:
    import torch

    from raytracer_tpu_torch.ops import build
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.utils.metrics import warp_slots

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=0, help="override each cell's repetitions")
    ap.add_argument("--cells", default="", help="comma-separated cells (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    from raytracer_tpu_torch.render import driver

    defaults = dict(threads=pk.THREADS, k1_threads=ik.THREADS,
                    clustered_threads=getattr(ik, "CLUSTERED_THREADS", None),
                    split_target=getattr(ik, "SPLIT_TARGET_BLOCKS", None),
                    tape_grid=getattr(pk, "TAPE_GRID_DIVISOR", 1), csrc=build.CSRC_DIR,
                    grain=dict(getattr(driver, "CLUSTER_GRAIN", {})),
                    oversize=getattr(driver, "CLUSTER_OVERSIZE", None))
    variants = dict(_parse_variant(v) for v in args.variant) or {"default": {}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for v in variants.values():  # build every library before any timing
        _apply(v, defaults)
    table = cells()
    if args.cells:
        table = {k: table[k] for k in args.cells.split(",")}
    first: dict = {}
    first_settings = None
    times: dict = {name: {cell: [] for cell in table} for name in variants}
    extra: dict = {name: {} for name in variants}
    order = list(variants)
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            _apply(variants[name], defaults)
            settings = _cluster_settings()
            first_settings = first_settings or settings
            line = dict(round=r, variant=name, settings=variants[name])
            for cell, (fn, reps, spin, _) in table.items():
                if cell.startswith("k3"):  # per-thread segments, else one sample a thread
                    out = fn(thread_segments=True)
                    threads = out[3] if len(out) == 4 else out[2]
                    extra[name][f"{cell}_warp_occupancy"] = int(out[2].sum()) / warp_slots(threads)
                    extra[name][f"{cell}_threads"] = int((threads > 0).sum())
                    out = out[:3]
                else:
                    out = fn()
                torch.cuda.synchronize()
                if cell not in first:
                    first[cell] = out
                elif cell.startswith("k2_culled") and settings != first_settings:
                    line[f"{cell}_equal"] = _outputs_equal(out, first[cell])
                elif not _outputs_equal(out, first[cell]):
                    raise SystemExit(f"time_kernels: {cell} under {name} differs from "
                                     f"{order[0]}'s outputs")
                del out
                ms = _time(fn, args.reps or reps, spin)
                times[name][cell].append(ms)
                line[cell] = ms
            line.update(extra[name])
            print(json.dumps(line), flush=True)
    summary = dict(
        nvidia_smi=smi, torch=torch.__version__, cells={c: t[3] for c, t in table.items()},
        median_ms={name: {c: statistics.median(v) for c, v in cs.items()}
                   for name, cs in times.items()},
        extra=extra, outputs_equal_across_variants=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
