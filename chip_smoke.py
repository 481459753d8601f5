#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each against
its plain PyTorch twin on the card, checks renders against the JAX package's
golden statistics, then drives each path once with the kernels' launch
counters reset just before and read just after:

* the render path (phase 5): the CLI render of rand_spheres at 400x225,
  500 spp, depth 50, through the persistent render kernel (kernel 2);
* the training path (phase 7): five Adam steps of the inverse renderer's
  tape-forward ("bucketed") backend at 400x225, 8 spp, depth 50, through
  the tape kernel (kernel 3), then one step of its "scan" backend, whose
  closest hit is kernel 1; phase 7t: five such steps on earth (4-tap
  bilinear) and one on perlin (at depth 8), through kernel 3's textured
  instantiation;
* the wavefront-step path (phase 10): perlin with rng-filled Perlin
  tables at 400x225, 100 spp, depth 50 through render_image, kernel 5 and
  the PyTorch shading epilogue;
* the persistent path on large scenes (phase 10): the CLI renders of
  rand_spheres_large (10,001 spheres) and quad_field (8,001 quads) and the
  render_image render of rand_spheres_large with 50,001 spheres, at
  400x225, 64 spp, depth 8, each clustered on the host and rendered in one
  launch of kernel 2's culled instantiation;
* the large-scene path (phase 10): `_render_large_scene` on
  rand_spheres_large at the same shape, clustered as the persistent path
  clusters it, camera rays through the cluster-culled kernel 4, bounces
  through kernel 1's clustered entry (and no dense kernel 1), its mean
  against the persistent render's;
* the textured render path (phase 10): the CLI renders of perlin, earth,
  earth --bilinear, earth --bilinear --bilinear-exact and simple_light at
  400x225, 100 spp, depth 50, each one launch of kernel 2's textured
  instantiation, timed by CUDA events;
* the checkpointed render path (phase 11): render/checkpoint.py's
  render_with_checkpoints on rand_spheres at 400x225, 500 spp, depth 50 in
  chunks of 100 spp, stopped after two chunks and resumed (kernel 2, one
  launch a chunk: 2 + 3, and 5 uninterrupted; resumed = uninterrupted bit
  for bit), its wall and render_image's at that chunking in turns, and
  the CLI with --checkpoint (its PNG byte-equal to phase 5's);
* the training path with the silhouette edge term (phase 12): five
  bucketed Adam steps of make_inverse_renderer(boundary=True) at phase 7's
  shape, kernel 3 the forward and kernel 1 every bounce of the edge
  traces (each of the first step's kernel-1 calls held against its twin
  and timed at its own rays), then one scan step with the edge term; the
  edge gradient on the card against the CPU's at a small shape, and
  diff/opt_checkpoint.py's run_optimization stopped and resumed on the
  card;
* the profiled CLI (phase 13): --profile and --memory-profile on the
  main path, the trace naming kernel 2 among its CUDA kernels;
* the full-gradient step (phase 14, the JAX package's `grad_full`,
  bench.py:333-352): make_inverse_renderer(boundary=True,
  shadow_edges=True) on rand_spheres at 400x225, 8 spp, depth 50, training
  sph_center, sph_radius and tex_c0, three bucketed Adam steps after one
  warm-up step: kernel 3 the forward, kernel 1 the shadow term's receiver
  search and every bounce of both terms' edge traces (each of the first
  counted step's kernel-1 calls held against its twin and timed at its
  own rays, split by term);
* the other edge estimators and the trainable camera (phase 15): the
  mirror (its visibility probe a kernel-1 launch), refracted and
  exhaustive shadow gradients on their test scenes on the card against
  the CPU, and one bucketed step with trainable_camera=("look_from",
  "fov_radians");
* the distributed paths (phase 16): the CLI with --shard on the render
  path's shape at one NCCL rank (kernel 2 once, its PNG byte-equal to
  phase 5's, its wall beside the plain CLI's in turns), the sharded
  bucketed step at phase 7's shape (kernel 3 once; loss and gradients
  bit-equal to the unsharded step's), render_large_scene_sharded (kernels
  4 and 1 clustered) and render_image_sharded on rng-table perlin (kernel
  5) at one rank bit-equal to the unsharded renders, and two gloo ranks
  as two processes on the one card (`--gloo-rank`): their sharded render
  bit-equal to the in-process sum of the ranks' partials, and
  parallel/dryrun.py:dryrun_multichip(2, "cuda");
* the measurement and self-check entry points (phase 17), each in a
  process of its own as a user runs it: `python -m raytracer_tpu_torch.bench
  --repeats 1` over every row (its last line must say "ok": true: every
  row ran, finite, each render at least its camera rays in segments, each
  row's kernels launched: kernel 2 on every render, kernel 3 on the
  bucketed steps, kernel 1 on the scan steps and the edge traces), and
  `python -m raytracer_tpu_torch.scripts.check_persistent` at its default
  spp (exit 0: the sample counter, eight scenes and the 10K clustered
  render agree statistically with their independent renders);
* large images (phase 18): the retirement-log fold of kernel 2's own logs
  at the book render's 1200x800@125 and the headline's shape bit-equal to
  the padded fold it replaced (`padded_fold`), both timed in turns, and
  render_image's peak at 1200x800; rand_spheres at 3840x2160@64 through
  render_image (its chunks, wall, segments and peak within the chunk
  budget) and the CLI (a 3840x2160 PNG); the miss-only scene at 3840x2160
  on the persistent and the wavefront-step paths, every pixel exactly its
  samples' background sum; rng-table perlin at 3840x2160 through
  render_image on the wavefront-step path (kernel 5);
* the bucketed step on scenes kernel 3 does not shade (phase 19): perlin
  with rng-filled Perlin tables at phase 7t's shape, its tape recorded by
  integrator/wavefront.py:trace_tape_scene (kernel 1 a bounce, PyTorch
  shading; kernel 3 never), in turns with the procedural-table step
  (kernel 3), after the same step on the card against the CPU at 64x36,
  its forward with kernel 1 against the forward with kernel 1's twin, a
  trainable-camera step and the sharded step at one NCCL rank;
* the table gather's backward (phase 20, csrc/gather_kernel.cu): at the
  train path's read shapes against its twin and bit-identical over two
  runs, timed beside its byte bound, the twin's index_add_ and PyTorch's
  index_put_(accumulate=True); every call of one bucketed step at phase 7's
  shape, on the eager replay, held and timed at its own shape; that step in
  turns with the same step whose table reads are plain advanced indexing;
* the replay kernels (phase 21, csrc/replay_kernel.cu) at the train path's
  shape on one step's own tape and lanes: the forward and the adjoint
  against their twins bit for bit, the adjoint bit-identical over two
  launches, each timed beside its bound with the reduction, the twins and
  the eager replay; the kernel path's reduced gradients against the eager
  replay's autograd; two steps from one state and seed bit-identical, with
  their launches; the step in turns on the eager replay and the kernels.

The noise instantiations of kernels 2 and 3 (perlin, simple_light) read
the marble's Perlin tables from the block's shared memory
(csrc/textures.cuh); the image ones (earth) hold no tables; every
instantiation traces one segment a loop iteration.

Phase 2 also holds kernel 1 bit for bit on rays built for every branch of
the quad test (tests/adversarial_quads.py), and its split path (launches
too small to fill the card, ops/intersect_kernel.py:split_rows) at 1 to
28,000 rays on a table whose repeated rows tie across slices. Phase 3 also holds kernel 2's
textured instantiation against its twin bit for bit (perlin, earth
nearest, stochastic and 4-tap, simple_light) at 96x54, 8 spp, depth 10 and
at phase 10's own kernel calls (400x225, 100 spp, depth 50, the CLI's seed
and lanes), where the twin also counts the call's marbles and image
lookups per lane and per warp (the textured rows' bounds and SIMT
efficiency), phase 3c holds kernel 2's culled instantiation against its
twin bit for bit (log and segments) on rand_spheres_large, quad_field and
the JAX package's two-level and image-quad culling scenes at 96x54, 8 spp,
depth 8, and at phase 10's three large renders' own kernel calls (400x225,
depth 8, the render's 2^18 lanes, seed 0 and clustered tables): whole at 4
spp, and the 64-spp call on every sample the 4-spp schedule holds,
printing each call's bounds per lane and per warp
(utils/bounds.py:culled_bounds), phase 4 checks renders of every golden
scene the card can reproduce (and earth with a 512x1024 texture), all
through kernel 2, phase 6 holds the tape kernel against its twin at the
training path's shape (rand_spheres, and textured: earth with the 4-tap
and perlin) and prints its warp occupancy under the sample queue, phase 7a
the whole gradient step on the card against the step on the CPU, phase 7
kernel 1 against its twin on the scan step's own rays and times it at
each of the step's launches at its own ray count (as phase 10 does for
`_render_large_scene`'s bounce launches), phase 8 kernel 5
against its twin at perlin's path shape (and the wavefront-step path
against kernel 2 on rand_spheres and on perlin with its textures), and
phase 9 kernel 4 against its twin and kernel 1 on rand_spheres_large's
camera rays, with its per-lane and warp-union bounds on its two-level
table and on the TPU kernel's flat one; phase 10 holds every clustered
kernel-1 launch of `_render_large_scene` against its twin bit for bit and
times each at its own rays. Every phase prints one line; any failure raises and exits
non-zero.
The second-to-last line is the per-kernel JSON record, the last line
`{"ok": true, "device": {...}}`.

Needs one CUDA device; exits non-zero without one, or without the package
next to this file. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()
sys.path.insert(0, str(REPO))
from raytracer_tpu_torch.utils.bounds import (  # noqa: E402
    WARP,
    bound,
    clustered_hit_bytes,
    culled_bounds,
    culled_bytes,
    hit_ops,
)

GOLDEN_CFG = dict(width=96, spp=24, max_depth=10)
GOLDEN_SEED = 12345
# Scenes whose golden statistics a different RNG stream can reproduce at
# test_golden.py's tolerances. cornell's pinned 24-spp draw is ~3 sigma from
# its own estimator's mean (JAX itself fails it at seeds 2 and 4), so
# cornell is held by phase 3 here and by the CPU statistical test instead.
# simple_light's probe (3h/4, 3w/4) is emitter firefly noise (JAX's own
# renders read 0-0.62 there at seeds 0-3 against the pinned 0.023): its
# means and std are held here, its probes on the CPU against JAX renders.
GOLDEN_SCENES = ("rand_spheres", "quads", "one_weekend_final", "perlin", "earth")
# The slice's textured renders through kernel 2 (held against its twin in
# phase 3t, driven through the CLI in phase 10): (label, scene, the
# builder overrides and stochastic bilinear tap that the CLI arguments
# give render_image, the CLI arguments).
TEXTURED_CASES = (
    ("perlin", "perlin", {}, False, ["--scene", "perlin"]),
    ("earth", "earth", {}, False, ["--scene", "earth"]),
    ("earth_bilinear", "earth", {"bilinear": True}, True, ["--scene", "earth", "--bilinear"]),
    ("earth_bilinear_exact", "earth", {"bilinear": True}, False,
     ["--scene", "earth", "--bilinear", "--bilinear-exact"]),
    ("simple_light", "simple_light", {"spp": 100}, False,
     ["--scene", "simple_light", "--spp", "100"]),
)
GOLDEN_NO_PROBES = ("simple_light",)
# Phase 3c's culled cases: (label, scene, cluster_scene arguments or None
# for render_image's own clustering (render/driver.py:cluster_for_render)).
# The last two are the JAX package's culling scenes (tests/cluster_scenes.py),
# their rows sorted front to back as the driver sorts them.
CULLED_CASES = (
    ("rand_spheres_large", "rand_spheres_large", None),
    ("quad_field", "quad_field", None),
    ("grid_two_level", "grid_two_level", dict(max_leaf=4, super_fan=4, min_fine_for_super=8)),
    ("image_quad_field", "image_quad_field", dict(max_leaf=4, super_fan=2, min_fine_for_super=2)),
)
CULLED_SHAPE = dict(width=96, spp=8, max_depth=8)
# Samples per pixel of phase 3c's twin at the large renders' own shape:
# 360,000 samples fill the render's 2^18 lanes and a second slot on 97,856
# of them, and the twin's dense search over 10,001-50,001 primitives stays
# within seconds.
HELD_SPP = 4
# Phase 10's large renders through the persistent path: (label, scene,
# builder overrides, CLI arguments or None for render_image; the CLI has no
# sphere-count flag).
LARGE_CASES = (
    ("rand_spheres_large", "rand_spheres_large", {},
     ["--scene", "rand_spheres_large", "--spp", "64"]),
    ("rand_spheres_large_50k", "rand_spheres_large", {"n_spheres": 50000}, None),
    ("quad_field", "quad_field", {}, ["--scene", "quad_field", "--spp", "64"]),
)
OUT_DIR = REPO / "chiprun_out"
# Phase 2's split launches: ray counts from one to about a compacted scan
# bounce's, and the rand_spheres rows repeated at the table's end.
SPLIT_RAYS = (1, 31, 32, 33, 1000, 28000)
SPLIT_REPEATED_ROWS = 100
# The training path's shape: the JAX package's gradient reference point
# (bench.py:_measure_grad_depth50).
TRAIN_CFG = dict(width=400, spp=8, max_depth=50)
TRAIN_SEEDS = (101, 102, 103, 104, 105)
# Phase 7t's perlin step runs at this depth: its eager replay of the marble
# costs ~0.1 s of host launches a bounce whatever the lanes left, and at
# depth 50 took 18-19 s of the script for paths of 2.3 segments on
# average (0.6% longer than 8). Phase 6 holds kernel 3 on perlin at 50.
PERLIN_STEP_DEPTH = 8
# Phase 11: the checkpointed render's chunking (rand_spheres at the main
# path's shape, 500 spp in chunks of 100) and the chunks the interrupted
# run takes before it stops.
CHECKPOINT_CHUNK = 100
CHECKPOINT_FIRST_CHUNKS = 2
# Phase 12: bucketed steps with the boundary term (phase 7's shape and
# start), and the small shapes of its card-vs-CPU checks.
BOUNDARY_STEPS = 5
EDGE_CHECK_SIZE = (24, 20)
# Phase 14: the full-gradient step's trainables and its counted steps (one
# warm-up step before them).
GRAD_FULL_TRAINABLE = ("sph_center", "sph_radius", "tex_c0")
GRAD_FULL_STEPS = 3

# Phase 16: the gloo ranks' shape (two processes on the one card), and the
# rounds of plain, --shard, --shard, plain CLI renders timed in turns.
GLOO_SHAPE = dict(width=96, spp=8, max_depth=10)
SHARD_ROUNDS = 2
# Bytes of the main path's framebuffer all-reduce: 400x225 pixels x 3 float32.
FRAMEBUFFER_SHAPE = (400 * 225, 3)

# Phase 17: the time limits of the bench (every row, one timed run each)
# and of the estimator self-check, each a process of its own.
BENCH_TIMEOUT_S = 420
CHECK_TIMEOUT_S = 300
# Phase 18d: the wavefront-step path at 3840x2160, kept short (its epilogue
# is PyTorch over 2^21 lanes an iteration).
LARGE_STEP_SPP = 2
LARGE_STEP_DEPTH = 8
# Phase 19: the bucketed step on perlin at phase 7t's shape (400x225@8spp,
# depth PERLIN_STEP_DEPTH), its Perlin tables rng-filled (tape forward
# trace_tape_scene, kernel 1 a bounce) or procedural (kernel 3), timed in
# this order: each label a scene and its own optimizer.
RNG_STEP_TURNS = ("rng", "procedural", "procedural", "rng")
# Phase 20: the table gather's backward at the train cell's read shapes
# (its 489 primitive rows; 16, 3 and 1 columns: the primitive
# table, the centres, the radii) over the first bounce's 720,000 positions,
# GATHER_HOT_SHARE of them on row 0 as a miss or a ground hit puts them;
# then every call of one bucketed step at phase 7's shape, and that step
# with the reads plain in turns.
GATHER_ROWS = 489
GATHER_POSITIONS = 720_000
GATHER_HOT_SHARE = 0.6
GATHER_REPS = 20
GATHER_STEP_TURNS = ("plain", "gather", "gather", "plain")
# Phase 21: the replay kernels at the train cell's shape (phase 7's), timed
# over this many launches each, and the train step in turns on the eager
# replay and on the kernels. The reduced gradients against the eager
# replay's autograd on the card: the colour leaves by the gap of norms,
# every leaf by its median row (the benchmark's grad_row_gap). The two are
# float32 evaluations of one function in different orders (the eager
# replay's three-term sums are CUDA reductions), and the r = 1000 ground's
# expanded-form sphere test cancels about five digits, so the rays that
# leave the ground differ in their last digits and a few near-tangent hits
# part: the first readings were 5.1e-4 and 2.3e-3 (colours) and at most
# 0.030 (mat_fuzz's median row), the parent's own grad_row_gap against the
# float64 reference reads 0.02-0.03, and the sphere normal's derivative cut
# reads 0.33-0.38 there (PERF.md section 2).
REPLAY_REPS = 20
REPLAY_STEP_TURNS = ("eager", "kernel", "kernel", "eager")
REPLAY_COLOUR_LEAVES = ("mat_albedo", "tex_c0")
REPLAY_COLOUR_GAP = 1e-2
REPLAY_ROW_GAP = 0.1
# FP32 operations a lane-bounce of the forward and of the adjoint (which
# recomputes the forward), counted from csrc/replay_kernel.cu's source for
# a Lambertian sphere hit (a dielectric adds about 60 to each): the
# operations side of the kernels' bounds.
REPLAY_FORWARD_OPS = 150
REPLAY_ADJOINT_OPS = 450

# Least time bounds: utils/bounds.py (NVIDIA's published H100 SXM peaks at
# 700 W, and the FP32 operations of csrc/closest_hit.cuh's candidates).


def fail(msg: str):
    raise AssertionError(msg)


def time_cuda(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of `fn` over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_device(fn, reps: int, warm: int = 3) -> float:
    """Mean device milliseconds of `fn` over `reps` runs, by CUDA events
    with the runs queued behind a spin kernel (~25 ms), so the host's
    per-call wrapper overhead cannot leave the device idle between them
    (time_cuda's back-to-back runs measure that overhead for kernels
    shorter than it)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def golden_stats(img):
    """tests/test_golden.py's statistics of a linear (H, W, 3) image."""
    h, w, _ = img.shape
    probes = [(h // 4, w // 4), (h // 2, w // 2), (3 * h // 4, 3 * w // 4), (h // 2, w // 8)]
    return {
        "mean": [float(m) for m in img.mean((0, 1))],
        "std": float(img.std()),
        "probes": [[float(c) for c in img[y, x]] for y, x in probes],
    }


def check_golden(name, img, golden, probes=True):
    import numpy as np

    got, want = golden_stats(img), golden[name]
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0.02, atol=0.004)
    np.testing.assert_allclose(got["std"], want["std"], rtol=0.05, atol=0.01)
    if probes:
        np.testing.assert_allclose(got["probes"], want["probes"], rtol=0.5, atol=0.12)
    return got


def random_rays(n, lo, hi, seed):
    """n rays from uniform origins in the box [lo, hi] towards uniform
    targets in it (most of them hit something)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(tgt - o)


def cuda_textures(scene, stochastic=False):
    """The scene's texture tables on the card (None without noise or image
    textures), its image filter picked as render_image picks it."""
    from raytracer_tpu_torch.geometry.intersect import quad_derived
    from raytracer_tpu_torch.materials.packed import texture_tables

    sc = scene.to("cuda")
    return texture_tables(sc, quad_derived(sc), stochastic=stochastic)


def clustered(scene, cam, cluster_kw):
    """(permuted scene, ClusterSet): render_image's own clustering for
    None, else cluster_scene(**cluster_kw) with the rows sorted front to
    back as the driver sorts them."""
    from raytracer_tpu_torch.geometry.bvh import cluster_scene
    from raytracer_tpu_torch.render.driver import cluster_for_render, order_clusters

    if cluster_kw is None:
        return cluster_for_render(scene, cam)
    scene, cs = cluster_scene(scene, **cluster_kw)
    return scene, order_clusters(cs, cam.look_from.numpy())


def persistent_pair(scene, cam, settings, wavefront, seed, stochastic=False, clusters=None,
                    work=False, tex_work=False):
    """Kernel 2 and its plain twin on the same CUDA tables (with the
    scene's texture tables), schedule and seed: (kernel, plain, fold) —
    zero-argument calls each returning (log, segments), and the fold of a
    log into per-pixel mean radiance. With `clusters` (a ClusterSet of the
    already permuted `scene`) both run the culled closest hit, and with
    `work` the twin also returns its per-lane work counts (slab, sphere
    and quad tests of per-lane culling); with `tex_work` its texture
    evaluations (integrator/wavefront.py:TextureWork), last."""
    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops import persistent_kernel as pk

    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n_pix = w * h
    frame = camera_frame(cam, w, h)
    cam_s = pk.pack_camera_scalars_bg(frame, cam.background).cuda()
    sph, quad, res = pk.pack_persistent_tables(scene.to("cuda"))
    n, num_slots, jump = wf.strided_schedule(n_pix, spp, wavefront)
    rem0, px0, py0 = wf.schedule_arrays(n, n_pix, spp, w, device="cuda")
    cfg = dict(width=w, height=h, jump_px=jump % w, jump_py=jump // w,
               num_slots=num_slots, max_depth=settings.max_depth, rr_start=5,
               rr_lo=0.05, rr_hi=0.75, sky_gradient=settings.sky_gradient,
               textures=cuda_textures(scene, stochastic))
    if clusters is not None:
        cfg["clusters"] = pk.pack_cluster_table(clusters, "cuda")
    args = (sph, quad, res, cam_s, seed, rem0, px0, py0)

    def kernel():
        return pk.render_persistent(*args, **cfg)

    def plain():
        return wf.regen_plain(*args, **cfg, return_work=work, return_texture_work=tex_work,
                              max_iters=pk.max_iters_for(num_slots, settings.max_depth))

    def fold(log):
        return wf._fold_log(log, num_slots, n, n_pix, jump) / spp

    return kernel, plain, fold


def texture_counts(work):
    """The record's fields of a TextureWork (integrator/wavefront.py): the
    call's marbles and image lookups, their warp-union counts and SIMT
    efficiency under kernel 2's loop (one segment an iteration) and under
    the retrace loop measured and not kept (PERF.md, section 6), and the
    closest hits a warp runs under each."""
    eff, eff_re = ([None if math.isnan(x) else x for x in work.simt_efficiency(schedule)]
                   for schedule in ("one_segment", "retrace"))
    return dict(marble_hits=int(work.per_lane[0].sum()), image_lookups=int(work.per_lane[1].sum()),
                warp_union=work.one_segment.tolist(), warp_union_retrace=work.retrace.tolist(),
                marble_simt_efficiency=eff[0], marble_simt_efficiency_retrace=eff_re[0],
                image_simt_efficiency=eff[1], image_simt_efficiency_retrace=eff_re[1],
                warp_trips=int(work.warp_trips[0]), warp_trips_retrace=int(work.warp_trips[1]))


def timed(fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def tape_pair(name, seed, **scene_kw):
    """Kernel 3 and its plain twin on the same CUDA tables (with the
    scene's texture tables, 4-tap for bilinear scenes): (kernel, plain,
    n samples, settings, scene); kernel(thread_segments=True) also returns
    each launched thread's segments."""
    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.scenes.registry import get_scene

    scene, cam, st = get_scene(name, **scene_kw)
    tables = pk.pack_persistent_tables(scene.to("cuda"))
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, st.width, st.height),
                                      cam.background).cuda()
    n = st.width * st.height * st.samples_per_pixel
    cfg = dict(width=st.width, height=st.height, max_depth=st.max_depth,
               sky_gradient=st.sky_gradient, textures=cuda_textures(scene))

    def kernel(thread_segments=False):
        return pk.render_persistent_tape(*tables, cam_s, seed, n, **cfg,
                                         thread_segments=thread_segments)

    def plain():
        return wf.trace_tape_plain(*tables, cam_s, seed, n, **cfg)

    return kernel, plain, n, st, scene


def check_tape(label, kernel_out, plain_out):
    """Kernel 3 against its twin: every tape entry and every sample's
    radiance and segments bit-equal. With the kernel's per-thread segments
    (its fourth output) the warp occupancy of the queue's threads, and
    beside it what one sample per thread would give (the schedule before the
    queue)."""
    import torch

    from raytracer_tpu_torch.utils.metrics import warp_slots

    (rad_k, tape_k, segs_k, *per_thread), (rad_p, tape_p, segs_p) = kernel_out, plain_out
    tape_eq = float((tape_k == tape_p).float().mean())
    lane_eq = float(((rad_k == rad_p).all(dim=0) & (segs_k == segs_p)).float().mean())
    if tape_eq < 1.0 or lane_eq < 1.0:
        fail(f"kernel 3 {label}: tape equal on {tape_eq:.6f}, samples on {lane_eq:.6f} (< 1)")
    if not bool(torch.isfinite(rad_k).all()):
        fail(f"kernel 3 {label}: non-finite radiance")
    segments = int(segs_k.sum())
    out = dict(tape_equal=tape_eq, lanes_equal=lane_eq,
               max_abs=float((rad_k - rad_p).abs().max()), segments=segments,
               one_sample_per_thread_occupancy=segments / warp_slots(segs_k),
               deepest=int(segs_k.max()), lanes=int(tape_k.shape[1]),
               hit_frac_b0=float((tape_k[0] >= 0).float().mean()))
    if per_thread:
        threads = per_thread[0]
        if int(threads.sum()) != segments:
            fail(f"kernel 3 {label}: per-thread segments sum to {int(threads.sum())}, "
                 f"not {segments}")
        out.update(warp_occupancy=segments / warp_slots(threads),
                   threads=int((threads > 0).sum()), launched_threads=int(threads.shape[0]))
    return out


def mixed_scene(noise_sphere=False):
    """tests/test_ktape.py's scene (all four materials, a quad, a checker,
    thin lens; its largest sphere r = 100) and its camera at 64x36; with
    `noise_sphere` also tests/test_torch_rng_tape.py's noise-textured
    sphere, its Perlin tables drawn from the builder's rng (a scene kernel
    3 does not shade)."""
    from raytracer_tpu_torch.core.camera import make_camera
    from raytracer_tpu_torch.geometry.scene import SceneBuilder

    b = SceneBuilder(0)
    ground = b.lambertian(b.checker(0.6, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.add_sphere((0, -100.5, -1), 100, ground)
    b.add_sphere((0, 0, -1), 0.5, b.dielectric(1.5))
    b.add_sphere((-1.1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.add_sphere((1.1, 0.8, -1), 0.3, b.diffuse_light((4, 4, 4)))
    b.add_quad((-2, -0.4, -2.5), (4, 0, 0), (0, 2, 0), b.lambertian((0.4, 0.5, 0.8)))
    if noise_sphere:
        b.add_sphere((0.75, -0.2, -0.3), 0.28, b.lambertian(b.noise(4.0)))
    cam, _ = make_camera(16 / 9, 64, look_from=(0, 0.5, 2), look_at=(0, 0, -1), fov_degrees=60,
                         background=(0.7, 0.8, 1.0), defocus_angle_degrees=2.0)
    return b.build(procedural_perlin=not noise_sphere), cam


# Limits of the step on CUDA against the step on the CPU, per leaf: (rtol,
# atol as a fraction of the CPU gradient's largest entry, None for 1e-4).
# Loss, albedo and texture colors at rtol 1e-4; sphere centers and radii
# at the bound JAX holds between its own forward variants
# (tests/test_ktape.py:165-176); the metal fuzz at the same rtol, since
# it moves scatter directions and its gradient flows through the replayed
# hit points as theirs does.
STEP_LIMITS = {"sph_center": (6e-3, None), "sph_radius": (6e-3, None),
               "mat_fuzz": (6e-3, 1e-3), "mat_albedo": (1e-4, 1e-4), "tex_c0": (1e-4, 1e-4)}


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms, which fix the order of autograd's
    scatter sums on the card (with the cuBLAS workspace they need)."""
    import os

    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def forward_twin(scene):
    """The bucketed step's tape forward on `scene` with its kernel swapped
    for the kernel's plain twin: kernel 3's wrapper as diff/bucketed.py
    calls it, or, on a scene kernel 3 does not shade, kernel 1's as
    integrator/wavefront.py:trace calls it."""
    from raytracer_tpu_torch.diff import bucketed
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops.intersect_kernel import intersect_plain
    from raytracer_tpu_torch.ops.persistent_kernel import unsupported_reason

    module, name, twin = ((wf, "intersect", intersect_plain) if unsupported_reason(scene)
                          else (bucketed, "render_persistent_tape", wf.trace_tape_plain))
    kernel = getattr(module, name)
    setattr(module, name, twin)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def step_devices(scene, cam, seed, w=64, h=36, k=2, depth=8):
    """The tape-forward step (diff/bucketed.py) on the same inputs: on CUDA
    with its forward's kernel (kernel 3, or kernel 1 on a scene kernel 3
    does not shade; "cuda"), on CUDA with that kernel's twin
    (`forward_twin`, "cuda_twin"), on the CPU (the twin in CPU arithmetic,
    "cpu"), and on the CPU with every sphere center one float32 step up
    ("cpu_ulp"). Returns ({way: (loss, grads)}, fraction of tape entries
    the CUDA and CPU forwards share)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.diff import bucketed
    from raytracer_tpu_torch.diff.grad import split_scene

    target = torch.from_numpy(
        np.random.default_rng(3).uniform(0, 1, (h, w, 3)).astype(np.float32))
    runs, tapes = {}, {}
    for dev in ("cuda", "cpu"):
        params, rebuild = split_scene(scene.to(dev))
        step = bucketed.make_bucketed_grad_fn(rebuild, cam, target.to(dev), width=w, height=h,
                                              samples_per_pass=k, max_depth=depth)
        runs[dev] = step(params, seed)
        tapes[dev] = bucketed.tape_forward(params, rebuild, None, cam, seed, w * h * k, width=w,
                                           height=h, max_depth=depth, sky_gradient=False,
                                           device=torch.device(dev))[1].cpu()
        if dev == "cuda":
            with forward_twin(scene):
                runs["cuda_twin"] = step(params, seed)
        else:
            c = params["sph_center"].detach()
            up = torch.nextafter(c, torch.full_like(c, math.inf)).requires_grad_(True)
            runs["cpu_ulp"] = step({**params, "sph_center": up}, seed)
    return runs, float((tapes["cuda"] == tapes["cpu"]).float().mean())


def hold_step(label, runs, tape_eq, held, bad):
    """Phase 7a's readings of step_devices' runs on one scene. The step with
    the forward's kernel against the same step with its twin on CUDA: loss
    equal, every gradient within rtol 1e-5 (autograd sums gathered rows
    with atomics, in no fixed order). The CUDA step against the CPU step:
    loss within rtol 1e-5, and with `held` every gradient within
    STEP_LIMITS. Failures are appended to `bad`."""
    import torch

    (loss_k, g_k), (loss_t, g_t), (loss_c, g_c) = runs["cuda"], runs["cuda_twin"], runs["cpu"]
    if float(loss_k) != float(loss_t):
        bad.append(f"{label}: loss with the kernel {float(loss_k)} vs its twin {float(loss_t)}")
    for name in g_k:
        if not torch.allclose(g_k[name], g_t[name], rtol=1e-5, atol=1e-9):
            bad.append(f"{label}: {name} gradient with the kernel vs its twin beyond rtol 1e-5")
    rel, ulp = {}, {}
    for name, gc in g_c.items():
        gk, top = g_k[name].cpu(), float(gc.abs().max())
        rel[name] = float((gk - gc).abs().max()) / max(top, 1e-30)
        ulp[name] = float((runs["cpu_ulp"][1][name] - gc).abs().max()) / max(top, 1e-30)
        rtol, atol = STEP_LIMITS[name]
        atol = 1e-4 if atol is None else atol * top
        if held and not torch.allclose(gk, gc, rtol=rtol, atol=atol):
            bad.append(f"{label}: {name} gradient CUDA vs CPU beyond rtol {rtol}, atol {atol:.3g}")
    loss_rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
    if held and loss_rel > 1e-5:
        bad.append(f"{label}: loss CUDA {float(loss_k)} vs CPU {float(loss_c)}")
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    if not finite:
        bad.append(f"{label}: non-finite gradients")
    return dict(held_cuda_vs_cpu=held, loss_kernel=float(loss_k), loss_twin=float(loss_t),
                loss_cpu=float(loss_c), loss_rel_cuda_cpu=loss_rel, tape_equal_cuda_cpu=tape_eq,
                cuda_vs_cpu_rel_to_max=rel, cpu_one_ulp_rel_to_max=ulp, grads_finite=finite)


def step_check(seed=21):
    """Phase 7a: the tape-forward step at 64x36, 2 spp, depth 8, held by
    hold_step on both scenes; CUDA against the CPU held on the mixed scene
    (tests/test_ktape.py's, largest sphere r = 100). On rand_spheres the
    CUDA and CPU gradients are reported, not held: its r = 1000 ground
    sphere makes the reference's expanded-form winner t cancel in float32
    (ROADMAP Queue 3). Two witnesses are printed for each scene: the share
    of tape entries the CUDA kernel and the CPU twin agree on (so the two
    steps replay the same paths), and how far the CPU step's own gradients
    move when every sphere center moves one float32 step
    ("cpu_one_ulp_rel_to_max"), the scale of float32 rounding noise in each
    gradient, beside the CUDA-vs-CPU gap ("cuda_vs_cpu_rel_to_max")."""
    from raytracer_tpu_torch.scenes.registry import get_scene

    scene_r, cam_r, _ = get_scene("rand_spheres", width=64, spp=2, max_depth=8)
    out, bad = {}, []
    for label, (scene, cam) in (("mixed", mixed_scene()), ("rand_spheres", (scene_r, cam_r))):
        out[label] = hold_step(label, *step_devices(scene, cam, seed), label == "mixed", bad)
    if bad:
        fail(f"phase 7a: {bad}; readings {json.dumps(out)}")
    return out


def check_hit(label, sph, quad, o, d):
    """Kernel 1 against its twin on one ray batch: prim and t bit-equal on
    every ray; then both timed."""
    import torch

    from raytracer_tpu_torch.ops import intersect_kernel as ik

    t_k, p_k = ik.intersect(sph, quad, o, d)
    t_p, p_p = ik.intersect_plain(sph, quad, o, d)
    torch.cuda.synchronize()
    same = p_k == p_p
    frac = float(same.float().mean())
    fin = same & torch.isfinite(t_p)
    rel = ((t_k[fin] - t_p[fin]).abs() / t_p[fin].abs().clamp(min=1e-30))
    max_rel = float(rel.max()) if rel.numel() else 0.0
    n_off = int((rel > 1e-5).sum())
    max_abs = float((t_k[fin] - t_p[fin]).abs().max()) if rel.numel() else 0.0
    hit_frac = float((p_p >= 0).float().mean())
    t_equal = float(((t_k == t_p) | (t_k.isnan() & t_p.isnan())).float().mean())
    if frac < 1.0 or t_equal < 1.0:
        fail(f"{label}: prim equal on {frac:.6f}, t on {t_equal:.6f} of rays (max rel "
             f"{max_rel:.3g}, {n_off} rays past 1e-5)")
    ms = time_cuda(lambda: ik.intersect(sph, quad, o, d), reps=20, warm=3)
    plain_ms = time_cuda(lambda: ik.intersect_plain(sph, quad, o, d), reps=3)
    return dict(prim_agree=frac, t_bit_equal=t_equal, t_max_rel=max_rel, t_max_abs=max_abs,
                hit_frac=hit_frac,
                ms=ms, plain_ms=plain_ms, rays=int(o.shape[0]), ns=int(sph.shape[0]),
                nq=int(quad.shape[0]))


class HitRecorder:
    """Stands in for ops.intersect_kernel.intersect (and for the name
    integrator.wavefront imports it under, trace's default hit) while a
    path runs and passes every call on to it: keeps each call's ray count
    and inputs
    (`calls`; a call's sphere and quad tables are one copy shared with the
    call before it when they are equal), and marks the first call and the
    first later call whose ray count leaves the kernel's last block partial
    (`kept`)."""

    def __init__(self, ik):
        self.ik, self.real = ik, ik.intersect
        self.counts, self.calls, self.kept = [], [], []
        self.tables = (None, None)

    def _table(self, k, x):
        """Table k (0 spheres, 1 quads) of a call: the last copy kept when
        it holds the same values, else a new copy."""
        import torch

        last = self.tables[k]
        if last is None or last.shape != x.shape or not torch.equal(last, x):
            last = x.detach().clone()
            self.tables = (last, self.tables[1]) if k == 0 else (self.tables[0], last)
        return last

    def __enter__(self):
        from raytracer_tpu_torch.integrator import wavefront

        self.ik.intersect = wavefront.intersect = self
        return self

    def __exit__(self, *exc):
        from raytracer_tpu_torch.integrator import wavefront

        self.ik.intersect = wavefront.intersect = self.real

    def __call__(self, sph, quad, o, d):
        i, n = len(self.counts), o.shape[0]
        self.counts.append(n)
        self.calls.append((self._table(0, sph), self._table(1, quad), o.detach().clone(),
                           d.detach().clone()))
        if i == 0 or (len(self.kept) == 1 and n % self.ik.THREADS):
            self.kept.append(i)
        return self.real(sph, quad, o, d)

    def timed_sum(self, plain=True, lo=0, hi=None):
        """Kernel 1 timed at every recorded call's own inputs (calls lo to
        hi, all by default; device time behind a spin kernel), with its
        bound and, with `plain`, its twin's time: {launches, rays, ms,
        plain_ms, bound_ms, bound_by} summed over the calls ("operations"
        when the operations bound most of them)."""
        ms = plain_ms = bound_ms = 0.0
        by = {"operations": 0, "bytes": 0}
        calls = self.calls[lo:hi]
        for sph, quad, o, d in calls:
            ms += time_device(lambda: self.ik.intersect(sph, quad, o, d), reps=10, warm=2)
            if plain:
                plain_ms += time_cuda(lambda: self.ik.intersect_plain(sph, quad, o, d), reps=1)
            b = bound(hit_ops(o.shape[0], sph.shape[0], quad.shape[0]), o.shape[0] * (24 + 8))
            bound_ms += b[0]
            by[b[1]] += 1
        return dict(launches=len(calls), rays=sum(self.counts[lo:hi]), ms=ms,
                    plain_ms=plain_ms if plain else None, bound_ms=bound_ms,
                    bound_by=max(by, key=by.get))


class ClusteredRecorder:
    """Stands in for ops.intersect_kernel.intersect_clustered while a path
    runs and passes every call on to it: keeps each call's tables (the
    path's own, shared by its calls) and a copy of its rays."""

    def __init__(self, ik):
        self.ik, self.real = ik, ik.intersect_clustered
        self.calls = []

    def __enter__(self):
        self.ik.intersect_clustered = self
        return self

    def __exit__(self, *exc):
        self.ik.intersect_clustered = self.real

    def __call__(self, clusters, sph, quad, o, d):
        self.calls.append((clusters, sph, quad, o.detach().clone(), d.detach().clone()))
        return self.real(clusters, sph, quad, o, d)

    def held_and_timed(self):
        """Every recorded launch held against its twin (ClusterVisit.
        hit_work's t and prim) bit for bit and timed at its own rays
        (device time behind a spin kernel), with the twin's time, and the
        work the twin counts there per lane and per warp: {launches, rays,
        ms, plain_ms, bound_ms (per lane), bound_by, warp_bound_ms,
        simt_efficiency, dense_bound_ms, work, warp_union, max_abs} summed
        over the launches."""
        import torch

        from raytracer_tpu_torch.ops.cluster_visit import ClusterVisit

        ms = plain_ms = max_abs = 0.0
        work = [0] * 6
        warp_work = [0] * 7
        rays = dense_ops = nbytes = 0
        visit = None
        for clusters, sph, quad, o, d in self.calls:
            if visit is None or visit[0] is not clusters:
                visit = (clusters, ClusterVisit.build(clusters, sph, quad))
            n = o.shape[0]
            t_k, p_k = self.real(clusters, sph, quad, o, d)
            t_p, p_p, w, ww = visit[1].hit_work(o, d, torch.arange(n, device=o.device) // WARP)
            torch.cuda.synchronize()
            if not (torch.equal(t_k, t_p) and torch.equal(p_k, p_p)):
                fail(f"kernel 1 clustered, a {n}-ray launch: t equal on "
                     f"{float((t_k == t_p).float().mean())}, prim on "
                     f"{float((p_k == p_p).float().mean())} of rays against its twin")
            max_abs = max(max_abs, max_float_diff(t_k, t_p))
            ms += time_device(lambda: self.real(clusters, sph, quad, o, d), reps=10, warm=2)
            plain_ms += time_cuda(lambda: visit[1].hit(o, d), reps=1)
            work = [a + int(b) for a, b in zip(work, w.sum(1).tolist())]
            warp_work = [a + int(b) for a, b in zip(warp_work, ww.tolist())]
            rays += n
            dense_ops += hit_ops(n, sph.shape[0], quad.shape[0])
            nbytes += clustered_hit_bytes(n, sum(clusters.counts), sph.shape[0], quad.shape[0])
        b = culled_bounds(rays, work, warp_work, nbytes)
        return dict(launches=len(self.calls), rays=rays, ms=ms, plain_ms=plain_ms,
                    bound_ms=b["per_lane"][0], bound_by=b["per_lane"][1],
                    warp_bound_ms=b["warp_union"][0], simt_efficiency=b["simt_efficiency"],
                    dense_bound_ms=bound(dense_ops, rays * 32)[0],
                    work=work, warp_union=warp_work, max_abs=max_abs)


def check_pair(label, kernel_out, plain_out, fold, exact=False):
    """Kernel 2's render against its twin's: >= 99% of pixels within rtol
    1e-3, image mean within 1e-3 relative, segments within 0.1%; with
    `exact`, every (slot, lane) cell and every lane's segments bit-equal.
    The share of bit-equal cells is reported either way."""
    import torch

    (log_k, segs_k), (log_p, segs_p) = kernel_out, plain_out
    cells_equal = float((log_k == log_p).float().mean())
    if exact and not (cells_equal == 1.0 and torch.equal(segs_k, segs_p)):
        fail(f"kernel 2 {label}: {cells_equal:.6f} of log cells bit-equal, segments equal "
             f"{torch.equal(segs_k, segs_p)}")
    fb_k, fb_p = fold(log_k), fold(log_p)
    close = torch.isclose(fb_k, fb_p, rtol=1e-3, atol=1e-6).all(dim=1)
    frac = float(close.float().mean())
    mean_k, mean_p = float(fb_k.mean()), float(fb_p.mean())
    mean_rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-30)
    sk, sp = int(segs_k.sum()), int(segs_p.sum())
    seg_rel = abs(sk - sp) / sp
    if frac < 0.99:
        fail(f"kernel 2 {label}: {frac:.4f} of pixels within rtol 1e-3 (< 0.99)")
    if mean_rel > 1e-3:
        fail(f"kernel 2 {label}: image mean rel err {mean_rel:.3g} > 1e-3")
    if seg_rel > 1e-3:
        fail(f"kernel 2 {label}: segments {sk} vs {sp}")
    return dict(pixels_close=frac, mean_rel=mean_rel, max_abs=float((fb_k - fb_p).abs().max()),
                segments=sk, plain_segments=sp, cells_bit_equal=cells_equal)


# Bytes kernel 5 moves per lane: origin, direction, active, remaining, px,
# py, sample_k and depth read (45); t, prim, origin, direction, grant,
# remaining, px, py, sample_k and four uniforms written (65).
STEP_LANE_BYTES = 110


def max_float_diff(a, b):
    """Largest |a - b| over the entries finite in both (0 if none)."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def step_state(name, seed, **scene_kw):
    """The wavefront-step path's inputs for `name` on CUDA, at the lanes
    render_image gives it: (tables (sph, quad, res, textures), camera
    scalars, schedule, loop config, settings, scene)."""
    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.geometry.intersect import quad_derived
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.materials.packed import texture_tables
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.render.driver import STEP_WAVEFRONT_MAX, STEP_WAVEFRONT_MIN
    from raytracer_tpu_torch.scenes.registry import get_scene

    wavefront = scene_kw.pop("wavefront", None)
    scene, cam, st = get_scene(name, **scene_kw)
    scene = scene.to("cuda")
    w, h, spp = st.width, st.height, st.samples_per_pixel
    wavefront = wavefront or max(STEP_WAVEFRONT_MIN, min(w * h, STEP_WAVEFRONT_MAX))
    sph, quad, res = pk.pack_persistent_tables(scene)
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, w, h), cam.background).cuda()
    n, num_slots, jump = wf.strided_schedule(w * h, spp, wavefront)
    sched = wf.schedule_arrays(n, w * h, spp, w, device="cuda")
    cfg = dict(width=w, height=h, jump_px=jump % w, jump_py=jump // w, num_slots=num_slots,
               max_depth=st.max_depth, rr_start=5, rr_lo=0.05, rr_hi=0.95,
               sky_gradient=st.sky_gradient, max_iters=pk.max_iters_for(num_slots, st.max_depth))
    tables = (sph, quad, res, texture_tables(scene, quad_derived(scene)))
    return tables, cam_s, sched, cfg, (n, num_slots, jump), st, scene


class StepRecorder:
    """Stands in for kernel 5's wrapper inside the wavefront-step loop
    (integrator.wavefront.wavefront_step) and passes every call on to it;
    at the calls in `check_at` it also runs the twin on the same inputs,
    fails unless every output is bit-equal, and times the kernel."""

    def __init__(self, wf, wk, check_at):
        self.wf, self.wk, self.real = wf, wk, wf.wavefront_step
        self.check_at, self.calls, self.rec = check_at, 0, {}

    def __enter__(self):
        self.wf.wavefront_step = self
        return self

    def __exit__(self, *exc):
        self.wf.wavefront_step = self.real

    def __call__(self, *args, **kw):
        import torch

        i = self.calls
        self.calls += 1
        out = self.real(*args, **kw)
        if i in self.check_at:
            plain, plain_ms = timed(lambda: self.wk.wavefront_step_plain(*args, **kw))
            bad = [f for f, a, b in zip(out._fields, out, plain) if not torch.equal(a, b)]
            if bad:
                fail(f"kernel 5 iteration {i}: {bad} differ from the twin")
            self.rec[f"iteration_{i}"] = dict(
                equal=True, granted=int(out.grant.sum()), live=int((args[6] | out.grant).sum()),
                lanes=int(out.t.shape[0]), plain_ms=plain_ms,
                max_abs=max(max_float_diff(a.float(), b.float()) for a, b in zip(out, plain)),
                ms=time_device(lambda: self.real(*args, **kw), reps=20),
                host_bound_ms=time_cuda(lambda: self.real(*args, **kw), reps=20, warm=3))
        return out


def step_kernel_check(seed=5, check_at=(0, 5)):
    """Phase 8a: kernel 5 against its twin at perlin's path shape (400x225,
    100 spp, 2^19 lanes) on the wavefront-step loop's own state: its first
    iteration (every lane granted) and its sixth (lanes partly granted, the
    rest in flight). Every output must be bit-equal."""
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops import wavefront_kernel as wk

    (sph, quad, res, tex), cam_s, sched, cfg, _, st, _ = step_state("perlin", seed)
    with StepRecorder(wf, wk, check_at) as rec:
        wf.wavefront_step_loop(sph, quad, res, tex, cam_s, seed, *sched,
                               **{**cfg, "max_iters": max(check_at) + 1})
    if sorted(rec.rec) != [f"iteration_{i}" for i in sorted(check_at)]:
        fail(f"kernel 5 check ran at {sorted(rec.rec)}")
    return dict(rec.rec, ns=int(sph.shape[0]), nq=int(quad.shape[0]),
                size=[st.width, st.height], spp=st.samples_per_pixel)


def step_vs_persistent(name, seed=11):
    """Phase 8b: the wavefront-step path (kernel 5 + the PyTorch epilogue)
    against kernel 2 on `name` at phase 3's shape (96x54, 8 spp, depth 10,
    8192 lanes), both with russian roulette capped at 0.75, the same seed,
    schedule and texture tables: one estimator. Held at phase 3's limits
    (check_pair): torch's elementwise sin/cos and the kernel's may round
    differently, and a flipped scatter changes a path; the share of
    pixels that are bit-equal is reported."""
    import torch

    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops import persistent_kernel as pk

    (sph, quad, res, tex), cam_s, sched, cfg, (n, num_slots, jump), st, _ = step_state(
        name, seed, width=96, spp=8, max_depth=10, wavefront=8192)
    cfg["rr_hi"] = 0.75
    n_pix = st.width * st.height
    (log_s, segs_s, iters), step_ms = timed(
        lambda: wf.wavefront_step_loop(sph, quad, res, tex, cam_s, seed, *sched, **cfg))
    pcfg = {k: v for k, v in cfg.items() if k != "max_iters"}
    (log_k, segs_k), k2_ms = timed(
        lambda: pk.render_persistent(sph, quad, res, cam_s, seed, *sched, **pcfg, textures=tex))

    def fold(log):
        return wf._fold_log(log, num_slots, n, n_pix, jump) / st.samples_per_pixel

    rec = check_pair("wavefront-step path vs kernel 2", (log_s, segs_s), (log_k, segs_k), fold)
    rec.update(pixels_bit_equal=float((fold(log_s) == fold(log_k)).all(dim=1).float().mean()),
               iterations=iters, step_path_ms=step_ms, kernel2_ms=k2_ms, lanes=n,
               size=[st.width, st.height], spp=st.samples_per_pixel, max_depth=st.max_depth)
    return rec


def culled_check():
    """Phase 9: kernel 4 on the large-scene path's own first-pass camera
    rays of rand_spheres_large at the CLI's shape (400x225, 64 spp in
    passes of 4, 10,001 spheres) and its two-level cluster table
    (render/driver.py:cluster_for_render): t and prim bit-equal to its twin
    (ClusterVisit.hit), and t bit-equal to dense kernel 1 on every ray
    (prim but for exact ties, counted). The twin's per-lane and warp-union
    work on these rays, on this table and on the TPU kernel's flat one
    (utils/cull_work.py:camera_work), gives the bounds."""
    import torch

    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.geometry.intersect import scene_tables
    from raytracer_tpu_torch.ops import culled_kernel as ck
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.ops.cluster_visit import ClusterVisit
    from raytracer_tpu_torch.render.driver import (
        chunk_seed,
        cluster_for_render,
        pass_camera_rays,
        samples_per_pass_for,
    )
    from raytracer_tpu_torch.scenes.registry import get_scene
    from raytracer_tpu_torch.utils.cull_work import camera_work

    scene, cam, st = get_scene("rand_spheres_large", spp=64)
    (sc, cs), cluster_s = timed_host(lambda: cluster_for_render(scene, cam))
    sc = sc.to("cuda")
    table = pk.pack_cluster_table(cs, "cuda")
    sph, quad = scene_tables(sc)
    w, h = st.width, st.height
    k = samples_per_pass_for(st.samples_per_pixel, w * h)
    o, d = pass_camera_rays(camera_frame(cam, w, h).to("cuda"), chunk_seed(0, 0), width=w,
                            height=h, k=k)
    t_k, p_k = ck.intersect_culled(table, sph, quad, o, d)
    visit = ClusterVisit.build(table, sph, quad)
    (t_p, p_p), plain_ms = timed(lambda: visit.hit(o, d))
    t_1, p_1 = ik.intersect(sph, quad, o, d)
    torch.cuda.synchronize()
    rec = {}
    for label, t_o, p_o, exact in (("twin", t_p, p_p, True), ("kernel_1", t_1, p_1, False)):
        t_eq = float((t_k == t_o).float().mean())
        ties = int(((p_k != p_o) & (t_k == t_o)).sum())
        if t_eq < 1.0 or int((p_k != p_o).sum()) != ties or (exact and ties):
            fail(f"kernel 4 vs {label}: t equal on {t_eq}, prim differs off ties or (twin) "
                 f"on {ties} ties")
        rec[f"vs_{label}"] = dict(t_equal=t_eq, prim_ties=ties,
                                  max_abs=max_float_diff(t_k, t_o))
    ms = time_device(lambda: ck.intersect_culled(table, sph, quad, o, d), reps=20)
    k1_ms = time_device(lambda: ik.intersect(sph, quad, o, d), reps=5)
    work, work_s = timed_host(lambda: camera_work(scene, cam, st, device="cuda"))
    rays = int(o.shape[0])
    rec.update(ms=ms, plain_ms=plain_ms, kernel1_ms=k1_ms, rays=rays,
               cluster_rows=list(table.counts), ns=sc.num_spheres, nq=sc.num_quads,
               host_cluster_s=cluster_s, hit_frac=float((p_k >= 0).float().mean()),
               dense_bound_ms=bound(hit_ops(rays, sc.num_spheres, sc.num_quads), rays * 32)[0],
               work=work, work_s=work_s)
    return rec


def timed_host(fn):
    """(fn(), host seconds of that one call)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def cpu_reference(name, width=48, **kw):
    """`name`'s clamped linear image mean from a small CPU render (width
    wide, 4 spp, its depth) through the path render_path gives it, with the
    kernels' plain twins: the image mean of another resolution estimates
    the same integral over the viewport."""
    from raytracer_tpu_torch.render.driver import render_image
    from raytracer_tpu_torch.scenes.registry import get_scene

    scene, cam, st = get_scene(name, width=width, spp=4, **kw)
    img = render_image(scene, cam, st, device="cpu", seed=3)
    return img.clamp(0.0, 1.0).mean((0, 1)).numpy()


def culled_scene(name):
    """Phase 3c's scene at CULLED_SHAPE: a registered one, or one of the
    JAX package's culling scenes (tests/cluster_scenes.py)."""
    from raytracer_tpu_torch.core.camera import make_camera
    from raytracer_tpu_torch.geometry.scene import SceneBuilder
    from raytracer_tpu_torch.scenes.registry import SCENES, get_scene

    if name in SCENES:
        return get_scene(name, **CULLED_SHAPE)
    sys.path.insert(0, str(REPO / "tests"))
    from cluster_scenes import SCENES as CLUSTER_SCENES

    scene, cam_kw = CLUSTER_SCENES[name](SceneBuilder(0))
    cam, st = make_camera(1.0, CULLED_SHAPE["width"], **dict(
        cam_kw, samples_per_pixel=CULLED_SHAPE["spp"], max_depth=CULLED_SHAPE["max_depth"]))
    return scene, cam, st


def persistent_culled_check():
    """Phase 3c: kernel 2's culled instantiation against its twin on each
    CULLED_CASES scene (permuted, its cluster table) at CULLED_SHAPE with
    8192 lanes: every log cell and every lane's segments bit-equal."""
    out = {}
    for label, name, cluster_kw in CULLED_CASES:
        scene, cam, st = culled_scene(name)
        scene_cl, cs = clustered(scene, cam, cluster_kw)
        kernel, plain, fold = persistent_pair(scene_cl, cam, st, 8192, seed=11, clusters=cs)
        kernel_out, ms = timed(kernel)
        plain_out, plain_ms = timed(plain)
        rec = check_pair(f"culled {label}", kernel_out, plain_out, fold, exact=True)
        out[label] = dict(rec, ms=ms, plain_ms=plain_ms, size=[st.width, st.height],
                          spp=st.samples_per_pixel, max_depth=st.max_depth, lanes=8192,
                          ns=scene_cl.num_spheres, nq=scene_cl.num_quads,
                          cluster_rows=[len(x) for x in cs[:4]], builder=cs.builder)
        del kernel_out, plain_out
    return out


def held_culled(label, name, kw):
    """Phase 3c at a phase-10 large render's own kernel call: the scene at
    400x225, depth 8, with the render's DEFAULT_WAVEFRONT lanes, seed 0
    and cluster_for_render's permuted tables.

    At HELD_SPP the kernel against its twin, log and segments bit-equal;
    the twin's work counts give the bounds (per lane and per warp,
    utils/bounds.py:culled_bounds), and the dense instantiation on the
    same permuted tables is timed beside the culled one (it must be
    slower: the witness that the kernel skips clusters).
    Then the render's own 64-spp call: a sample's path depends on its
    sample id alone, so its log must equal the twin's on every (slot,
    lane) cell the HELD_SPP schedule holds; its segments are what phase
    10's render must trace."""
    import torch

    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.render.driver import DEFAULT_WAVEFRONT, cluster_for_render
    from raytracer_tpu_torch.scenes.registry import get_scene
    from raytracer_tpu_torch.utils.metrics import warp_slots

    scene, cam, st = get_scene(name, spp=HELD_SPP, **kw)
    scene_cl, cs = cluster_for_render(scene, cam)
    kernel, plain, fold = persistent_pair(scene_cl, cam, st, DEFAULT_WAVEFRONT, seed=0,
                                          clusters=cs, work=True)
    kernel_out = kernel()
    (log_p, segs_p, work, warp_work), plain_ms = timed(plain)
    rec = check_pair(f"culled {label} at the render's call", kernel_out, (log_p, segs_p), fold,
                     exact=True)
    del kernel_out
    ms = time_cuda(kernel, reps=3)
    dense, _, _ = persistent_pair(scene_cl, cam, st, DEFAULT_WAVEFRONT, seed=0)
    dense_ms = time_cuda(dense, reps=3)
    if not ms < dense_ms:
        fail(f"kernel 2 culled {label}: {ms:.3f} ms, not faster than the dense loops' "
             f"{dense_ms:.3f} ms on the same tables")
    w, h = st.width, st.height
    n, num_slots, _ = wf.strided_schedule(w * h, HELD_SPP, DEFAULT_WAVEFRONT)
    rem0 = wf.schedule_arrays(n, w * h, HELD_SPP, w, device="cuda")[0]
    kernel64, _, _ = persistent_pair(scene_cl, cam, st._replace(samples_per_pixel=64),
                                     DEFAULT_WAVEFRONT, seed=0, clusters=cs)
    log64, segs64 = kernel64()
    held = torch.arange(num_slots, device="cuda")[:, None] < rem0.long()[None, :]
    prefix = torch.where(held, log64[:, :num_slots], 0.0)
    if not torch.equal(prefix, log_p):
        fail(f"kernel 2 culled {label} at 64 spp: {float((prefix == log_p).float().mean()):.6f} "
             f"of the {HELD_SPP}-spp twin's log cells bit-equal")
    segments = int(segs_p.sum())
    w_sum = work.long().sum(1).tolist()
    rows = [len(x) for x in cs[:4]]
    b = culled_bounds(segments, w_sum, warp_work.tolist(), culled_bytes(
        log_p.numel() * 4, n, rows, scene_cl.num_spheres, scene_cl.num_quads))
    return dict(rec, ms=ms, plain_ms=plain_ms, dense_ms=dense_ms, size=[w, h], spp=HELD_SPP,
                max_depth=st.max_depth, lanes=n, slots=num_slots,
                warp_occupancy=segments / warp_slots(segs_p), log_bytes=log_p.numel() * 4,
                slab_tests=w_sum[0], sphere_tests=w_sum[1], quad_tests=w_sum[2],
                sphere_roots=w_sum[3], quad_divisions=w_sum[4], quad_in_quad=w_sum[5],
                warp_union_tests=warp_work.tolist(), bound_ms=b["per_lane"][0],
                bound_by=b["per_lane"][1], warp_bound_ms=b["warp_union"][0],
                simt_efficiency=b["simt_efficiency"],
                ns=scene_cl.num_spheres, nq=scene_cl.num_quads,
                cluster_rows=rows, render_call=dict(
                    spp=64, slots=int(log64.shape[1]), segments=int(segs64.sum()),
                    prefix_cells_equal=True, ms=time_cuda(kernel64, reps=3)))


def png_linear_mean(path):
    import numpy as np
    from PIL import Image

    png = np.asarray(Image.open(path).convert("RGB"))
    return png.shape, ((png.astype(np.float64) / 255.0) ** 2).mean((0, 1))


# Operations of one marble in csrc/textures.cuh, counted from the source
# as the closest hit's are (a table load counts one): 149 per Perlin octave
# from the shared tables (3 floors, 3 fractions, 3 conversions and masks,
# 3 permutation-pair loads and their 6 extracts, 3 smoothsteps of 4, 8
# corners of 11 (2 hash XORs, one gradient load, a 3-term dot product of
# 8), 7 lerps of 4), 6 a turbulence step, 7 octaves, and 32 for the
# scaling and sin (libdevice sinf as 24). The parent's hash recomputed
# the tables: 552 an octave (6 lattice hashes of 9 and their 3 wraps
# instead of the pair loads, and corners of 55, each with 3 gradient
# components of 15), 3,938 a marble. An image lookup: sphere UV (acosf
# and atan2f as ~25 each, clamps, offsets) and the clamped texel index,
# ~80; the 4-tap filter ~150.
MARBLE_OPS_HASH = 3938
MARBLE_OPS = 1117
IMAGE_OPS = {"nearest": 80, "stochastic": 90, "bilinear": 150}


class PersistentTimer:
    """Stands in for ops.persistent_kernel.render_persistent while a path
    runs and passes every call on to it, timing each call on the device by
    CUDA events around it (the kernel and its log's zero fill)."""

    def __init__(self, pk):
        self.pk, self.real, self.events = pk, pk.render_persistent, []

    def __enter__(self):
        self.pk.render_persistent = self
        return self

    def __exit__(self, *exc):
        self.pk.render_persistent = self.real

    def __call__(self, *args, **kw):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.real(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def emitter_scene():
    """tests/test_torch_boundary.py's deterministic edge scene: a
    diffuse_light sphere and quad against a flat background, its camera at
    EDGE_CHECK_SIZE. At max_depth 1 every edge sample's inside radiance is
    the emission and its outside the background, whatever the random
    numbers."""
    from raytracer_tpu_torch.core.camera import make_camera
    from raytracer_tpu_torch.geometry.scene import SceneBuilder

    w, h = EDGE_CHECK_SIZE
    b = SceneBuilder(0)
    b.add_sphere((-0.6, 0.1, -3.0), 0.7, b.diffuse_light((3.0, 2.0, 1.0)))
    b.add_quad((0.3, -0.8, -3.2), (1.0, 0.1, -0.2), (0.1, 1.1, 0.0),
               b.diffuse_light((0.5, 1.5, 2.5)))
    cam, _ = make_camera(w / h, w, fov_degrees=55, look_from=(0, 0, 0), look_at=(0, 0, -3),
                         background=(0.2, 0.3, 0.4))
    return b.build(), cam


def lambertian_edge_scene():
    """tests/test_boundary_grad.py's silhouette scene: a lambertian sphere
    under the gradient sky, its camera at EDGE_CHECK_SIZE."""
    from raytracer_tpu_torch.core.camera import make_camera
    from raytracer_tpu_torch.geometry.scene import SceneBuilder

    w, h = EDGE_CHECK_SIZE
    b = SceneBuilder(0)
    b.add_sphere((0.3, -0.1, -3.0), 1.0, b.lambertian((0.6, 0.3, 0.2)))
    b.add_quad((-1.6, -0.9, -4.0), (0.9, 0.0, 0.0), (0.0, 0.9, 0.0),
               b.lambertian((0.2, 0.6, 0.3)))
    cam, _ = make_camera(w / h, w, fov_degrees=55, look_from=(0, 0, 0), look_at=(0.1, 0, -3))
    return b.build(), cam


def edge_devices(scene, cam, *, max_depth, sky_gradient, seed=31):
    """The boundary term's gradient (diff/boundary.py) of sum(ct * image)
    in every geometry leaf, for one seeded cotangent image, on CUDA (kernel
    1 in the edge traces) and on the CPU (its twin): {device: {leaf:
    gradient on the CPU}}."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.diff.boundary import EdgeSamplingConfig, make_boundary_image_fn
    from raytracer_tpu_torch.diff.grad import split_scene

    w, h = EDGE_CHECK_SIZE
    ct = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (h, w, 3)).astype(np.float32))
    cfg = EdgeSamplingConfig(samples_per_sphere=128, samples_per_quad_edge=32, spp_edge=4)
    out = {}
    for dev in ("cuda", "cpu"):
        params, rebuild = split_scene(scene.to(dev), ("sph_center", "sph_radius", "quad_q",
                                                      "quad_u", "quad_v"))
        fn = make_boundary_image_fn(rebuild, width=w, height=h, max_depth=max_depth,
                                    sky_gradient=sky_gradient, config=cfg)
        grads = torch.autograd.grad((fn(params, cam, seed) * ct.to(dev)).sum(),
                                    list(params.values()))
        out[dev] = {k: g.cpu() for k, g in zip(params, grads)}
    return out


def hold_edge_gradients():
    """Phase 12's card-vs-CPU check of the edge gradient at
    EDGE_CHECK_SIZE, with the same seeds: on the emitter scene (max_depth
    1, deterministic radiances) every leaf within rtol 1e-4 (atol 1e-6 of
    its largest entry); on the lambertian scene (max_depth 3, the gradient
    sky) within phase 7a's STEP_LIMITS for the geometry. Returns the
    readings (largest difference over the largest entry, per leaf)."""
    import torch

    out, bad = {}, []
    for label, (scene, cam), kw in (("emitter", emitter_scene(), dict(max_depth=1,
                                                                      sky_gradient=False)),
                                    ("lambertian", lambertian_edge_scene(),
                                     dict(max_depth=3, sky_gradient=True))):
        g = edge_devices(scene, cam, **kw)
        rel = {}
        for name, gc in g["cpu"].items():
            gk, top = g["cuda"][name], float(gc.abs().max())
            rel[name] = float((gk - gc).abs().max()) / max(top, 1e-30)
            if label == "emitter":
                rtol, atol = 1e-4, 1e-6 * top
            else:
                rtol, atol = STEP_LIMITS["sph_center"][0], 1e-4
            if top <= 0 or not torch.allclose(gk, gc, rtol=rtol, atol=atol):
                bad.append(f"{label}: {name} edge gradient CUDA vs CPU beyond rtol {rtol}, "
                           f"atol {atol:.3g} (largest entry {top:.4g})")
        out[label] = rel
    if bad:
        fail(f"phase 12 edge gradients: {bad}; readings {json.dumps(out)}")
    return out


def optimization_resume_check():
    """Phase 12's run_optimization (diff/opt_checkpoint.py) on the card:
    four scan steps of tests/test_torch_checkpoint.py's small problem,
    stopped after two and resumed, against an uninterrupted run. Two
    uninterrupted runs measure first how far the card's steps differ run
    to run (autograd's backward scatters with atomics); the resumed run
    may differ from an uninterrupted one by no more than four times that,
    or than 1e-6 of the largest param where the runs agree bit for bit
    (float32 rounding). Returns the readings."""
    import tempfile

    import torch

    from raytracer_tpu_torch.core.camera import make_camera
    from raytracer_tpu_torch.diff.grad import make_inverse_renderer, render_linear_diff
    from raytracer_tpu_torch.diff.opt_checkpoint import opt_fingerprint, run_optimization
    from raytracer_tpu_torch.geometry.scene import SceneBuilder

    b = SceneBuilder(0)
    b.add_sphere((0, 0, -3), 1.0, b.lambertian((0.6, 0.3, 0.2)))
    b.add_sphere((0, -101, -3), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.build()
    cam, _ = make_camera(1.0, 12, look_from=(0, 0, 1), look_at=(0, 0, -3))
    kw = dict(width=12, height=12, samples_per_pass=2, max_depth=3, sky_gradient=True)
    with torch.no_grad():
        target = render_linear_diff(scene.to("cuda"), cam, 42, **kw)
    fp = opt_fingerprint(scene, cam, target, kw, 7)

    def run(**ck):
        params, opt, step = make_inverse_renderer(scene, cam, target, trainable=(
            "tex_c0", "sph_center"), learning_rate=5e-2, device="cuda", **kw)
        run_optimization(step, params, opt, n_steps=4, seed=7, fingerprint=fp, **ck)
        return {k: p.detach().cpu() for k, p in params.items()}, opt

    def diff(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    full_a, _ = run()
    full_b, _ = run()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/opt.npz"
        run(checkpoint_path=path, save_every=1, max_steps_this_run=2)
        resumed, opt = run(checkpoint_path=path, save_every=1)
    steps = [int(s["step"]) for s in opt.state_dict()["state"].values()]
    run_to_run, resume = diff(full_a, full_b), diff(resumed, full_a)
    scale = max(float(v.abs().max()) for v in full_a.values())
    limit = 4 * run_to_run if run_to_run > 0 else 1e-6 * scale
    if steps != [4] * len(steps) or not resume <= limit:
        fail(f"run_optimization resumed on the card: Adam steps {steps}, params off the "
             f"uninterrupted run's by {resume:.3g} (limit {limit:.3g}; two uninterrupted runs "
             f"differ by {run_to_run:.3g})")
    return dict(run_to_run_max_abs=run_to_run, resumed_max_abs=resume, limit=limit,
                adam_steps=steps)


def hold_hits(hits):
    """Every kernel-1 call that `hits` (a HitRecorder) recorded against its
    twin on the same inputs, t and prim bit for bit: {calls, rays, max_abs}."""
    import torch

    from raytracer_tpu_torch.ops import intersect_kernel as ik

    max_abs = 0.0
    for i, (sph, quad, o, d) in enumerate(hits.calls):
        t_k, p_k = hits.real(sph, quad, o, d)
        t_p, p_p = ik.intersect_plain(sph, quad, o, d)
        torch.cuda.synchronize()
        if not (torch.equal(p_k, p_p) and bool(((t_k == t_p) | (t_k.isnan() & t_p.isnan())).all())):
            fail(f"kernel 1 on the edge traces, call {i} ({o.shape[0]} rays): t equal on "
                 f"{float((t_k == t_p).float().mean())}, prim on "
                 f"{float((p_k == p_p).float().mean())} of rays against its twin")
        max_abs = max(max_abs, max_float_diff(t_k, t_p))
    return dict(calls=len(hits.calls), rays=sum(hits.counts), max_abs=max_abs)


def checkpoint_phase(cli, smi):
    """Phase 11: render/checkpoint.py on the main path's scene and shape
    (rand_spheres 400x225, 500 spp, depth 50), through kernel 2.

    Two uninterrupted checkpointed renders in chunks of CHECKPOINT_CHUNK
    must be bit-equal (the fold is deterministic). Then a render that
    saves after each chunk and stops after CHECKPOINT_FIRST_CHUNKS chunks,
    its resumption to the end, and an uninterrupted render: the resumed
    image bit-equal to the uninterrupted one, kernel 2's launches
    2 + 3 and 5. render_image at as many chunks (a chunk budget that gives
    it five, each of the largest size that fits: 101 spp, the last 96) and
    the checkpointed render without and with saves are timed in turns,
    three of each, and the saver thread's seconds a save are read. Last,
    the CLI with --checkpoint on a fresh path at the default chunk: its
    PNG byte-equal to phase 5's plain CLI PNG."""
    import shutil

    import torch

    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.render import checkpoint as ckpt
    from raytracer_tpu_torch.render.driver import (
        DEFAULT_WAVEFRONT,
        chunk_bytes,
        render_image,
        spp_chunk_for,
    )
    from raytracer_tpu_torch.scenes.registry import get_scene

    scene, cam, st = get_scene("rand_spheres")
    if (st.width, st.height, st.samples_per_pixel, st.max_depth) != (400, 225, 500, 50):
        fail(f"phase 11: rand_spheres renders at {st}")
    n_pix = st.width * st.height
    kw = dict(seed=0, spp_per_chunk=CHECKPOINT_CHUNK, device="cuda")
    out_dir = OUT_DIR / "checkpoint"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir()

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def launched(fn):
        pk.LAUNCHES = 0
        out, wall = synced(fn)
        return out, wall, pk.LAUNCHES

    first = ckpt.render_with_checkpoints(scene, cam, st, **kw)
    again = ckpt.render_with_checkpoints(scene, cam, st, **kw)
    if not torch.equal(first, again):
        fail("phase 11: two uninterrupted renders at the same chunking differ on "
             f"{int((first != again).sum())} values")
    saves = []
    real_save = ckpt.save_checkpoint

    def timed_save(path, c):
        t0 = time.perf_counter()
        real_save(path, c)
        saves.append(time.perf_counter() - t0)

    path = str(out_dir / "render.npz")
    ckpt.save_checkpoint = timed_save
    try:
        _, wall_first, n_first = launched(lambda: ckpt.render_with_checkpoints(
            scene, cam, st, checkpoint_path=path, max_chunks=CHECKPOINT_FIRST_CHUNKS, **kw))
        stopped = ckpt.load_checkpoint(path)
        resumed, wall_resumed, n_resumed = launched(lambda: ckpt.render_with_checkpoints(
            scene, cam, st, checkpoint_path=path, **kw))
        full, wall_full, n_full = launched(lambda: ckpt.render_with_checkpoints(
            scene, cam, st, **kw))
        chunks = -(-st.samples_per_pixel // CHECKPOINT_CHUNK)
        if (stopped.done_spp, stopped.chunk_idx) != (
                CHECKPOINT_FIRST_CHUNKS * CHECKPOINT_CHUNK, CHECKPOINT_FIRST_CHUNKS):
            fail(f"phase 11: the stopped render saved {stopped.done_spp} spp, chunk "
                 f"{stopped.chunk_idx}")
        if (n_first, n_resumed, n_full) != (CHECKPOINT_FIRST_CHUNKS,
                                            chunks - CHECKPOINT_FIRST_CHUNKS, chunks):
            fail(f"phase 11: kernel 2 launched {n_first} + {n_resumed} and {n_full} times")
        if not torch.equal(resumed, full):
            fail(f"phase 11: the resumed image differs from the uninterrupted one on "
                 f"{int((resumed != full).sum())} values")
        if not torch.equal(resumed, first):
            fail("phase 11: the resumed image differs from the first uninterrupted render")
        # Walls in turns: render_image at a chunk budget that gives it as
        # many chunks (its own chunk size: the largest that fits), the
        # checkpointed render without a path (the chunk loop alone) and
        # with one (a host copy and a save after every chunk).
        budget = chunk_bytes(n_pix, CHECKPOINT_CHUNK, DEFAULT_WAVEFRONT)
        ri_chunk = spp_chunk_for(n_pix, st.samples_per_pixel, DEFAULT_WAVEFRONT, budget)
        if -(-st.samples_per_pixel // ri_chunk) != chunks:
            fail(f"phase 11: the chunk budget gives render_image chunks of {ri_chunk} spp")
        walls = {"render_image": [], "chunks_no_saves": [], "checkpointed": []}
        saves.clear()
        for rep in range(3):
            order = list(walls) if rep % 2 == 0 else list(walls)[::-1]
            for label in order:
                pk.LAUNCHES = 0
                if label == "render_image":
                    img, wall = synced(lambda: render_image(scene, cam, st, device="cuda", seed=0,
                                                            log_budget_bytes=budget))
                elif label == "chunks_no_saves":
                    img, wall = synced(lambda: ckpt.render_with_checkpoints(scene, cam, st, **kw))
                else:
                    p = str(out_dir / f"turn{rep}.npz")
                    img, wall = synced(lambda: ckpt.render_with_checkpoints(
                        scene, cam, st, checkpoint_path=p, **kw))
                if pk.LAUNCHES != chunks or not bool(torch.isfinite(img).all()):
                    fail(f"phase 11: {label} launched kernel 2 {pk.LAUNCHES} times")
                if label != "render_image" and not torch.equal(img, full):
                    fail(f"phase 11: {label} differs from the uninterrupted render")
                walls[label].append(wall)
        saver_s = list(saves)
    finally:
        ckpt.save_checkpoint = real_save
    # The CLI at its default chunk (render_image's: one chunk at this shape).
    png = OUT_DIR / "rand_spheres_checkpoint.png"
    _, wall_cli, n_cli = launched(lambda: cli.main(
        ["--scene", "rand_spheres", "--out", str(png), "--checkpoint",
         str(out_dir / "cli.npz")]))
    if png.read_bytes() != (OUT_DIR / "rand_spheres.png").read_bytes():
        fail("phase 11: the --checkpoint CLI PNG differs from phase 5's plain CLI PNG")
    return dict(launches=dict(stopped=n_first, resumed=n_resumed, uninterrupted=n_full,
                              cli=n_cli),
                wall_s=dict(stopped=wall_first, resumed=wall_resumed,
                            uninterrupted_no_saves=wall_full, cli_checkpoint=wall_cli),
                walls_in_turns=walls, render_image_chunk=ri_chunk, saver_s_per_save=saver_s,
                resumed_equals_uninterrupted=True, cli_png_equal=True)


def boundary_phase(train_kw, smi):
    """Phase 12: make_inverse_renderer(boundary=True) at phase 7's shape and
    start (rand_spheres 400x225, 8 spp, depth 50, the default trainables,
    texture colors halved), through kernel 3 (the bucketed forward) and
    kernel 1 (every bounce of every edge trace).

    BOUNDARY_STEPS bucketed Adam steps, each printed with its wall split
    (tape forward, loss/cotangent, replay forward, backward, edges,
    optimizer); kernel 3's launches (one a step) and kernel 1's (the edge
    traces only) counted. Every kernel-1 call of the first step is
    recorded and held against its twin bit for bit, then timed at its own
    rays (device time, summed, with its bound). Then one scan step with the
    boundary term (kernel 1 in the render and in the edge traces), the
    edge gradient on the card against the CPU's (hold_edge_gradients), and
    run_optimization stopped and resumed on the card
    (optimization_resume_check)."""
    import torch

    from raytracer_tpu_torch.diff.grad import boundary_config, make_inverse_renderer, \
        render_linear_diff
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.scenes.registry import get_scene

    scene, cam, st = get_scene("rand_spheres", **TRAIN_CFG)
    with torch.no_grad():
        target = render_linear_diff(scene.to("cuda"), cam, 7, width=st.width, height=st.height,
                                    samples_per_pass=st.samples_per_pixel,
                                    max_depth=st.max_depth)
    start = dataclasses.replace(scene, tex_c0=scene.tex_c0 * 0.5)
    cfg = boundary_config(scene)
    params, _, step = make_inverse_renderer(start, cam, target, backend="bucketed",
                                            boundary=True, **train_kw)
    steps = []
    ik.LAUNCHES = 0
    pk.LAUNCHES_TAPE = 0
    torch.cuda.synchronize()
    for i, seed in enumerate(TRAIN_SEEDS[:BOUNDARY_STEPS]):
        recorder = HitRecorder(ik) if i == 0 else contextlib.nullcontext()
        timings = {}
        with recorder:
            t0 = time.perf_counter()
            loss = float(step(seed, timings))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if i == 0:
            hits = recorder
        if not (math.isfinite(loss) and all(bool(torch.isfinite(p.grad).all())
                                            for p in params.values())):
            fail(f"boundary step {seed}: loss {loss} or its gradients not finite")
        steps.append(dict(loss=loss, wall_s=wall, **timings))
        s_ = steps[-1]
        print(f"phase 12 bucketed step {i} with the boundary term: loss {loss:.6g}, wall "
              f"{wall:.4f} s = tape forward {s_['tape_forward']:.4f} + loss/cotangent "
              f"{s_['loss_cotangent']:.4f} + replay forward {s_['replay_forward']:.4f} + backward "
              f"{s_['backward']:.4f} + edges {s_['edges']:.4f} + optimizer "
              f"{s_['optimizer']:.4f} s (edges {s_['edges'] / wall:.1%}); {smi}", flush=True)
    launches = dict(closest_hit=ik.LAUNCHES, persistent_tape=pk.LAUNCHES_TAPE)
    if launches["persistent_tape"] != BOUNDARY_STEPS or launches["closest_hit"] <= 0:
        fail(f"phase 12: launches {launches} in {BOUNDARY_STEPS} boundary steps")
    edge_rays = 3 * (scene.num_spheres * cfg.samples_per_sphere) * cfg.spp_edge
    if hits.counts[0] != scene.num_spheres * cfg.samples_per_sphere * cfg.spp_edge:
        fail(f"phase 12: the first edge trace's camera rays {hits.counts[0]}, expected "
             f"{scene.num_spheres} spheres x {cfg.samples_per_sphere} x {cfg.spp_edge}")
    held = hold_hits(hits)
    k1_edges = dict(hits.timed_sum(), held=held, rays_per_launch=hits.counts,
                    launches_in_all_steps=launches["closest_hit"],
                    camera_rays_per_trace=hits.counts[0], edge_paths_per_step=edge_rays)
    del hits.calls
    # One scan step with the boundary term.
    params_s, _, step_s = make_inverse_renderer(start, cam, target, backend="scan",
                                                boundary=True, **train_kw)
    ik.LAUNCHES = 0
    torch.cuda.synchronize()
    scan_t = {}
    t0 = time.perf_counter()
    scan_loss = float(step_s(TRAIN_SEEDS[0], scan_t))
    torch.cuda.synchronize()
    scan_t["wall_s"] = time.perf_counter() - t0
    scan_launches = ik.LAUNCHES
    if not (math.isfinite(scan_loss) and scan_launches > TRAIN_CFG["max_depth"]
            and all(bool(torch.isfinite(p.grad).all()) for p in params_s.values())):
        fail(f"phase 12 scan step: loss {scan_loss}, closest-hit launches {scan_launches}")
    edge_check = hold_edge_gradients()
    resume = optimization_resume_check()
    rec = dict(steps=steps, launches=launches, closest_hit_edges=k1_edges,
               edge_config=cfg._asdict(), scan_step=dict(scan_t, loss=scan_loss,
                                                        closest_hit_launches=scan_launches),
               edge_cuda_vs_cpu_rel_to_max=edge_check, run_optimization=resume)
    print(f"phase 12 boundary term: {BOUNDARY_STEPS} bucketed steps, launches "
          f"{json.dumps(launches)}; kernel 1 in the first step's edge traces: "
          f"{k1_edges['launches']} launches, {k1_edges['rays']} rays, {k1_edges['ms']:.3f} ms "
          f"summed by CUDA events (bound {k1_edges['bound_ms']:.3f} ms, twin "
          f"{k1_edges['plain_ms']:.1f} ms), every call bit-equal to its twin; rays per launch "
          f"{hits.counts}; scan step {json.dumps(rec['scan_step'])}; edge gradient CUDA vs "
          f"CPU {json.dumps(edge_check)}; run_optimization resumed on the card "
          f"{json.dumps(resume)}; {smi}", flush=True)
    return rec


@contextlib.contextmanager
def mark_calls(module, name, hits, marks):
    """While it is open, each call of module.name (a function the module
    imported) appends to `marks` the number of kernel-1 calls that `hits`
    (a HitRecorder) had recorded before it."""
    real = getattr(module, name)

    def marked(*args, **kwargs):
        marks.append(len(hits.counts))
        return real(*args, **kwargs)

    setattr(module, name, marked)
    try:
        yield
    finally:
        setattr(module, name, real)


def grad_full_phase(train_kw, smi):
    """Phase 14: the JAX package's `grad_full` step on the card:
    make_inverse_renderer(boundary=True, shadow_edges=True, backend=
    "bucketed") on rand_spheres at 400x225, 8 spp, depth 50, training
    GRAD_FULL_TRAINABLE from phase 7's start (texture colors halved, the
    target rendered from the true scene), at the production edge budgets
    (boundary_config, shadow_config).

    One warm-up step, then GRAD_FULL_STEPS counted steps, each printed with
    its wall split (tape forward, loss/cotangent, replay forward, backward,
    edges/boundary, edges/shadow, optimizer); kernel 3's launches (one a
    step) and kernel 1's counted. Every kernel-1 call of the first counted
    step is recorded and held against its twin bit for bit, then timed at
    its own rays and split by term: the boundary term's traces, the shadow
    term's receiver search (one ray a pixel) and its traces. The loss and
    every gradient must be finite."""
    import torch

    from raytracer_tpu_torch.diff import shadow_edge
    from raytracer_tpu_torch.diff.grad import boundary_config, make_inverse_renderer, \
        render_linear_diff, shadow_config
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.scenes.registry import get_scene

    scene, cam, st = get_scene("rand_spheres", **TRAIN_CFG)
    with torch.no_grad():
        target = render_linear_diff(scene.to(train_kw["device"]), cam, 7, width=st.width,
                                    height=st.height,
                                    samples_per_pass=st.samples_per_pixel,
                                    max_depth=st.max_depth)
    start = dataclasses.replace(scene, tex_c0=scene.tex_c0 * 0.5)
    bcfg, scfg = boundary_config(scene), shadow_config(scene, st.width, st.height)
    params, _, step = make_inverse_renderer(start, cam, target, trainable=GRAD_FULL_TRAINABLE,
                                            backend="bucketed", boundary=True,
                                            shadow_edges=True, **train_kw)
    t0 = time.perf_counter()
    step(TRAIN_SEEDS[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    steps, marks = [], []
    ik.LAUNCHES = 0
    pk.LAUNCHES_TAPE = 0
    torch.cuda.synchronize()
    for i, seed in enumerate(TRAIN_SEEDS[1:1 + GRAD_FULL_STEPS]):
        recorder = HitRecorder(ik) if i == 0 else contextlib.nullcontext()
        timings = {}
        with recorder, (mark_calls(shadow_edge, "intersect_scene", recorder, marks) if i == 0
                        else contextlib.nullcontext()):
            t0 = time.perf_counter()
            loss = float(step(seed, timings))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if i == 0:
            hits = recorder
        if not (math.isfinite(loss) and all(bool(torch.isfinite(p.grad).all())
                                            for p in params.values())):
            fail(f"phase 14 grad_full step {seed}: loss {loss} or its gradients not finite")
        steps.append(dict(loss=loss, wall_s=wall, **timings))
        s_ = steps[-1]
        print(f"phase 14 grad_full step {i}: loss {loss:.6g}, wall {wall:.4f} s = tape forward "
              f"{s_['tape_forward']:.4f} + loss/cotangent {s_['loss_cotangent']:.4f} + replay "
              f"forward {s_['replay_forward']:.4f} + backward {s_['backward']:.4f} + "
              f"edges/boundary {s_['edges/boundary']:.4f} + edges/shadow "
              f"{s_['edges/shadow']:.4f} + optimizer {s_['optimizer']:.4f} s (edges "
              f"{s_['edges'] / wall:.1%}); {smi}", flush=True)
    launches = dict(closest_hit=ik.LAUNCHES, persistent_tape=pk.LAUNCHES_TAPE)
    if launches["persistent_tape"] != GRAD_FULL_STEPS or launches["closest_hit"] <= 0:
        fail(f"phase 14: launches {launches} in {GRAD_FULL_STEPS} grad_full steps")
    n_pix = st.width * st.height
    shadow_rays = scfg.receivers * scfg.sources_per_receiver * scfg.samples_per_sphere \
        * scfg.spp_edge
    split = marks[0] if len(marks) == 1 else -1
    if not (0 < split < len(hits.counts) - 1 and hits.counts[split] == n_pix
            and hits.counts[split + 1] == shadow_rays
            and hits.counts[0] == scene.num_spheres * bcfg.samples_per_sphere * bcfg.spp_edge):
        fail(f"phase 14: kernel-1 calls {hits.counts}, shadow term from call {marks}; expected "
             f"{n_pix} receiver rays, then {shadow_rays} first-bounce shadow rays")
    held = hold_hits(hits)
    k1 = {"boundary": hits.timed_sum(hi=split),
          "shadow_receivers": hits.timed_sum(lo=split, hi=split + 1),
          "shadow_traces": hits.timed_sum(lo=split + 1)}
    k1["all"] = {key: sum(v[key] for v in k1.values()) for key in ("launches", "rays", "ms",
                                                                  "plain_ms", "bound_ms")}
    rec = dict(steps=steps, warm_up_s=warm_s, launches=launches, closest_hit=k1, held=held,
               rays_per_launch=hits.counts, shadow_from_call=split,
               boundary_config=bcfg._asdict(), shadow_config=scfg._asdict(),
               trainable=GRAD_FULL_TRAINABLE)
    del hits.calls
    print(f"phase 14 grad_full: {GRAD_FULL_STEPS} bucketed steps after a {warm_s:.3f} s warm-up, "
          f"launches {json.dumps(launches)}; kernel 1 in the first counted step, every call "
          f"bit-equal to its twin ({json.dumps(held)}), by CUDA events at each call's own rays: "
          f"{json.dumps(k1)}; rays per launch {hits.counts}; {smi}", flush=True)
    return rec


def edge_term_devices(make_fn, scene, cam, leaves, cam_leaves, size, seed, ct_seed):
    """An edge term's gradient of sum(ct * image) for one seeded cotangent
    image in `leaves` and the camera tensors `cam_leaves`, on the card and
    on the CPU: ([gradients on the card], [on the CPU], all moved to the
    CPU), and the kernel-1 calls of the card's run (a HitRecorder)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.diff.grad import split_scene
    from raytracer_tpu_torch.ops import intersect_kernel as ik

    w, h = size
    ct = torch.from_numpy(np.random.default_rng(ct_seed).uniform(-1, 1, (h, w, 3))
                          .astype(np.float32))
    out = []
    for i, dev in enumerate(("cuda", "cpu")):
        params, rebuild = split_scene(scene.to(dev), leaves)
        camera = dataclasses.replace(cam, **{f: getattr(cam, f).detach().clone()
                                             .requires_grad_(True) for f in cam_leaves})
        fn = make_fn(rebuild)
        recorder = HitRecorder(ik) if i == 0 else contextlib.nullcontext()
        with recorder:
            grads = torch.autograd.grad(
                (fn(params, camera, seed) * ct.to(dev)).sum(),
                [params[k] for k in leaves] + [getattr(camera, f) for f in cam_leaves])
        if i == 0:
            hits = recorder
        out.append([g.cpu() for g in grads])
    return out, hits


def other_edges_phase(train_kw, smi):
    """Phase 15: the mirror, refracted and shadow gradients on the card
    against the CPU on their test scenes (tests/test_torch_*_edge.py), each
    leaf within rtol 1e-4 (mirror, exhaustive shadow: deterministic edge
    radiances) or 1e-3 (refracted: the Newton roots round apart by ~1e-5
    px, and its glass paths are random), atol 1e-6 of the leaf's largest
    entry; the mirror term's visibility probe must be a kernel-1 launch on
    the card (its first recorded call, one ray a (mirror, sphere, sample)).
    Then one bucketed step with trainable_camera=("look_from",
    "fov_radians") and the boundary term at phase 7's shape: finite,
    non-zero camera gradients. Returns the readings."""
    import torch

    from raytracer_tpu_torch.core.camera import make_camera
    from raytracer_tpu_torch.diff.grad import make_inverse_renderer, render_linear_diff
    from raytracer_tpu_torch.diff.mirror_edge import MirrorEdgeConfig, make_mirror_boundary_fn
    from raytracer_tpu_torch.diff.refracted_edge import RefractedEdgeConfig, \
        make_refracted_boundary_fn
    from raytracer_tpu_torch.diff.shadow_edge import make_shadow_boundary_fn
    from raytracer_tpu_torch.geometry.scene import SceneBuilder
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.scenes.registry import get_scene

    b = SceneBuilder(0)
    b.add_quad((-2.0, -2.0, -3.0), (4, 0, 0), (0, 4, 0), b.metal((0.9, 0.9, 0.9), fuzz=0.0))
    b.add_sphere((0.6, 0.3, 1.6), 1.0, b.lambertian((0.05, 0.05, 0.05)))
    mirror = b.build()
    mcam, _ = make_camera(1.0, 32, fov_degrees=60, look_from=(0, 0, 0), look_at=(0, 0, -3),
                          background=(1.0, 1.0, 1.0))
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -2.0), 0.8, b.dielectric(1.5))
    b.add_quad((-0.5, -0.5, -4.0), (1.0, 0, 0), (0, 1.0, 0), b.lambertian((0.05, 0.05, 0.05)))
    glass = b.build()
    gcam, _ = make_camera(1.0, 48, fov_degrees=40, look_from=(0, 0, 1), look_at=(0, 0, -2),
                          background=(1.0, 1.0, 1.0))
    b = SceneBuilder(0)
    white = b.lambertian((0.73, 0.73, 0.73))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), white)
    b.add_quad((-1, 3, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((15, 15, 15)))
    b.add_quad((-0.6, 1.5, -0.6), (1.2, 0, 0), (0, 0, 1.2), white)
    b.add_sphere((1.2, 1.5, 0.6), 0.4, white)
    shadow = b.build()
    scam, _ = make_camera(1.0, 24, fov_degrees=38, look_from=(3.5, 1.0, 0.0),
                          look_at=(0.0, 0.0, 0.0), background=(0, 0, 0))
    cases = (
        ("mirror", lambda r: make_mirror_boundary_fn(
            r, width=32, height=32, max_depth=2,
            config=MirrorEdgeConfig(samples_per_contour=64, spp_edge=2)),
         mirror, mcam, ("sph_center", "sph_radius"), ("look_from", "look_at", "fov_radians"),
         (32, 32), 1e-4),
        ("refracted", lambda r: make_refracted_boundary_fn(
            r, width=48, height=48, max_depth=6,
            config=RefractedEdgeConfig(samples_per_quad_edge=16, spp_edge=4)),
         glass, gcam, ("quad_q", "quad_u", "quad_v"), (), (48, 48), 1e-3),
        ("shadow", lambda r: make_shadow_boundary_fn(r, width=24, height=24, max_depth=2),
         shadow, scam, ("quad_q", "quad_u", "quad_v", "sph_center", "sph_radius"), (),
         (24, 24), 1e-4),
    )
    out, bad = {}, []
    for label, make_fn, scene, cam, leaves, cam_leaves, size, rtol in cases:
        ik.LAUNCHES = 0
        (g_card, g_cpu), hits = edge_term_devices(make_fn, scene, cam, leaves, cam_leaves, size,
                                                  31, 1)
        rel = {}
        for name, gk, gc in zip(leaves + cam_leaves, g_card, g_cpu):
            top = float(gc.abs().max())
            rel[name] = float((gk - gc).abs().max()) / max(top, 1e-30)
            if top <= 0 or not torch.allclose(gk, gc, rtol=rtol, atol=1e-6 * top):
                bad.append(f"{label}: {name} CUDA vs CPU beyond rtol {rtol} (largest entry "
                           f"{top:.4g}, off by {rel[name]:.3g} of it)")
        out[label] = dict(rel_to_max=rel, closest_hit_launches=ik.LAUNCHES,
                          closest_hit_calls=len(hits.counts), rays=sum(hits.counts))
        if label == "mirror":
            probe = 1 * 1 * 64
            out[label]["probe_rays"] = hits.counts[0]
            if hits.counts[0] != probe or ik.LAUNCHES != len(hits.counts):
                bad.append(f"mirror: kernel-1 calls {hits.counts}, launches {ik.LAUNCHES}; the "
                           f"probe of {probe} rays must be a launch on the card")
        del hits.calls
    # One bucketed step with a trainable camera (and the boundary term, whose
    # projections give the camera silhouette gradients too).
    scene, cam, st = get_scene("rand_spheres", **TRAIN_CFG)
    with torch.no_grad():
        target = render_linear_diff(scene.to(train_kw["device"]), cam, 7, width=st.width,
                                    height=st.height,
                                    samples_per_pass=st.samples_per_pixel, max_depth=st.max_depth)
    start = dataclasses.replace(scene, tex_c0=scene.tex_c0 * 0.5)
    params, _, step = make_inverse_renderer(start, cam, target, backend="bucketed",
                                            boundary=True,
                                            trainable_camera=("look_from", "fov_radians"),
                                            **train_kw)
    timings = {}
    t0 = time.perf_counter()
    loss = float(step(TRAIN_SEEDS[0], timings))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cam_grads = {k: p.grad.tolist() for k, p in params["camera"].items()}
    finite = all(bool(torch.isfinite(p.grad).all()) for p in params["camera"].values())
    if not (math.isfinite(loss) and finite and any(
            float(p.grad.abs().max()) > 0 for p in params["camera"].values())):
        bad.append(f"camera step: loss {loss}, camera gradients {cam_grads}")
    out["camera_step"] = dict(loss=loss, wall_s=wall, camera_grads=cam_grads, **timings)
    if bad:
        fail(f"phase 15: {bad}; readings {json.dumps(out)}")
    print(f"phase 15 the mirror, refracted and shadow terms CUDA vs CPU and a trainable-camera "
          f"step: {json.dumps(out)}; {smi}", flush=True)
    return out


def profile_phase(cli):
    """Phase 13: the CLI with --profile and --memory-profile on the main
    path, run in its own directory under OUT_DIR with the allocator's peak
    reset before it: the trace under out/trace names kernel 2's symbol
    among its CUDA kernel events, the memory report's peak is above 0 and
    below the card's total, and the CLI's report carries peak_hbm_mb."""
    import os
    import shutil

    import torch

    run_dir = OUT_DIR / "profile"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(run_dir)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        report = cli.main(["--scene", "rand_spheres", "--out", "rs.png", "--profile",
                           "--memory-profile", "memory.json"])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    traces = sorted((run_dir / "out" / "trace").glob("*.json"))
    if len(traces) != 1:
        fail(f"phase 13: traces {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    k2_events = [e for e in events if e.get("cat") == "kernel" and "persistent_kernel" in e["name"]]
    memory = json.loads((run_dir / "memory.json").read_text())
    total_mb = torch.cuda.get_device_properties(0).total_memory / 2**20
    if not k2_events:
        fail(f"phase 13: no persistent_kernel among the trace's CUDA kernels {kernels}")
    if not 0 < memory["peak_hbm_mb"] < total_mb or "peak_hbm_mb" not in report:
        fail(f"phase 13: memory report peak {memory.get('peak_hbm_mb')} MiB, card "
             f"{total_mb:.0f} MiB; CLI report keys {sorted(report)}")
    return dict(trace=str(traces[0].relative_to(REPO)), trace_mb=traces[0].stat().st_size / 2**20,
                kernel_names=len(kernels), persistent_kernel_events=len(k2_events),
                persistent_kernel_us=sum(e.get("dur", 0) for e in k2_events),
                memory=dict({k: memory[k] for k in ("peak_hbm_mb", "hbm_in_use_mb",
                                                    "hbm_limit_mb", "live_buffers_mb",
                                                    "total_mb", "num_blocks")},
                            largest_block_mb=memory["blocks"][0]["mb"] if memory["blocks"]
                            else 0.0),
                report_memory={k: report[k] for k in ("peak_hbm_mb", "hbm_in_use_mb",
                                                      "hbm_limit_mb", "live_buffers_mb")},
                wall_s=wall, render_wall_s=report["wall_s"])


def gloo_rank(rank: int, coordinator: str, out_dir: Path) -> None:
    """Phase 16's gloo rank `rank` of two, both on the one card (NCCL
    refuses two ranks on one GPU; gloo's collectives take CUDA tensors).
    It imports, loads the kernels and makes its CUDA context, says so
    (out_dir/gloo_ready<rank>), waits for out_dir/gloo_go (the parent's
    timed work is over), then runs
    render_image_sharded on rand_spheres at GLOO_SHAPE, kernel 2's launches
    counted around it, and dryrun_multichip(2, "cuda"), which raises on
    any failed check. Writes out_dir/gloo_rank<rank>.json and, on rank 0,
    the image (gloo_render.pt)."""
    import torch

    from raytracer_tpu_torch.ops import build
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
    from raytracer_tpu_torch.parallel.mesh import close_group, init_group, make_mesh
    from raytracer_tpu_torch.parallel.shard import render_image_sharded
    from raytracer_tpu_torch.scenes.registry import get_scene

    build.load_kernels()
    torch.zeros(1, device="cuda")
    (out_dir / f"gloo_ready{rank}").touch()
    deadline = time.perf_counter() + 300
    while not (out_dir / "gloo_go").exists():
        if time.perf_counter() > deadline:
            raise TimeoutError("phase 16: the parent never released the gloo ranks")
        time.sleep(0.05)
    t0 = time.perf_counter()
    init_group("cuda", backend="gloo", coordinator=coordinator, process_id=rank,
               num_processes=2)
    try:
        start_s = time.perf_counter() - t0
        mesh = make_mesh(2, device="cuda")
        scene, cam, st = get_scene("rand_spheres", **GLOO_SHAPE)
        pk.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_image_sharded(scene, cam, st, mesh, seed=0)
        torch.cuda.synchronize()
        rec = dict(render_wall_s=time.perf_counter() - t0, render_launches=pk.LAUNCHES,
                   group_start_s=start_s, mesh=list(mesh.shape), backend=mesh.backend)
        t0 = time.perf_counter()
        rec["dryrun"] = dryrun_multichip(2, "cuda")
        rec["dryrun_s"] = time.perf_counter() - t0
        if rank == 0:
            torch.save(img.cpu(), out_dir / "gloo_render.pt")
        (out_dir / f"gloo_rank{rank}.json").write_text(json.dumps(rec))
    finally:
        close_group()


def distribution_phase(cli, smi, counted, check_launches, main_png: Path) -> dict:
    """Phase 16: the distributed paths.

    Two gloo ranks start first, as two processes on the one card
    (`gloo_rank`), and import while this process runs the untimed checks;
    they wait until the timed work below is over.

    NCCL at one rank, full width: render_large_scene_sharded on
    rand_spheres_large 400x225@64spp d8 against _render_large_scene
    (bit-equal, the same kernel-4 and clustered kernel-1 launches);
    render_image_sharded on rng-table perlin against render_image
    (bit-equal, the same kernel-5 launches); the sharded bucketed step at
    phase 7's shape against make_bucketed_grad_fn's at the same seed (loss
    and gradients bit-equal under torch's deterministic algorithms, which
    fix autograd's scatter order; one kernel-3 launch); then, timed, the
    two steps' walls in turns, the all-reduce of the 1.08 MB framebuffer
    by CUDA events, and the CLI with --shard on rand_spheres
    400x225@500spp d50 (its PNG byte-equal to phase 5's, one kernel-2
    launch) beside the plain CLI in SHARD_ROUNDS rounds of plain, shard,
    shard, plain, with its group start-up.

    Then the gloo ranks run: the sharded render bit-equal to the sum of
    its two ranks' partials computed here, and dryrun_multichip(2,
    "cuda")."""
    import dataclasses as dc
    import socket

    import torch
    import torch.distributed as dist

    from raytracer_tpu_torch.diff.bucketed import make_bucketed_grad_fn
    from raytracer_tpu_torch.diff.grad import render_linear_diff, split_scene
    from raytracer_tpu_torch.parallel.mesh import close_group, init_group, make_mesh
    from raytracer_tpu_torch.parallel.shard import (
        regen_partial,
        render_image_sharded,
        render_large_scene_sharded,
    )
    from raytracer_tpu_torch.parallel.train import make_sharded_bucketed_grad_fn
    from raytracer_tpu_torch.render import driver
    from raytracer_tpu_torch.scenes.registry import get_scene

    rec = {}
    go = OUT_DIR / "gloo_go"
    ready = [OUT_DIR / f"gloo_ready{r}" for r in range(2)]
    for stale in (go, *ready, OUT_DIR / "gloo_render.pt", *OUT_DIR.glob("gloo_rank*.json")):
        stale.unlink(missing_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--gloo-rank",
                               str(r), coord, str(OUT_DIR)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        t0 = time.perf_counter()
        init_group("cuda")
        try:
            mesh = make_mesh()
            # The process's first NCCL group: the communicator's creation.
            rec["first_group_s"] = time.perf_counter() - t0
            # The large-scene path at one rank.
            scene, cam, st = get_scene("rand_spheres_large", spp=64)
            scene = scene.to("cuda")
            imgs, large = {}, {}
            for mode, fn in (
                    ("plain", lambda: driver._render_large_scene(scene, cam, st, seed=0)),
                    ("shard", lambda: render_large_scene_sharded(scene, cam, st, mesh, seed=0))):
                imgs[mode], counts = counted(fn)
                large[mode] = dict(launches=counts)
                check_launches(f"the {mode} large-scene render", counts,
                               ("culled", "closest_hit_clustered"))
            if large["plain"]["launches"] != large["shard"]["launches"] or not torch.equal(
                    imgs["plain"], imgs["shard"]):
                fail(f"phase 16: large-scene sharded vs unsharded: {json.dumps(large)}")
            rec["large_scene"] = large

            # The wavefront-step path (kernel 5) at one rank.
            scene, cam, st = get_scene("perlin", procedural_perlin=False)
            step_rec = {}
            for mode, fn in (
                    ("plain", lambda: driver.render_image(scene, cam, st, seed=0)),
                    ("shard", lambda: render_image_sharded(scene, cam, st, mesh, seed=0))):
                imgs[mode], counts = counted(fn)
                step_rec[mode] = dict(launches=counts)
                check_launches(f"the {mode} wavefront-step render", counts, ("wavefront_step",))
            if step_rec["plain"]["launches"] != step_rec["shard"]["launches"] or not torch.equal(
                    imgs["plain"], imgs["shard"]):
                fail(f"phase 16: wavefront-step sharded vs unsharded: {json.dumps(step_rec)}")
            rec["wavefront_step"] = step_rec

            # The sharded bucketed step at one rank against the unsharded one.
            scene, cam, st = get_scene("rand_spheres", **TRAIN_CFG)
            with torch.no_grad():
                target = render_linear_diff(scene.to("cuda"), cam, 7, width=st.width,
                                            height=st.height,
                                            samples_per_pass=st.samples_per_pixel,
                                            max_depth=st.max_depth)
            start = dc.replace(scene, tex_c0=scene.tex_c0 * 0.5).to("cuda")
            params, rebuild = split_scene(start)
            kw = dict(width=st.width, height=st.height, samples_per_pass=st.samples_per_pixel,
                      max_depth=st.max_depth)
            steps = {"plain": make_bucketed_grad_fn(rebuild, cam, target, **kw),
                     "shard": make_sharded_bucketed_grad_fn(rebuild, cam, target, mesh, **kw)}
            seed = TRAIN_SEEDS[0]
            with deterministic():
                (loss_s, g_s), counts = counted(lambda: steps["shard"](params, seed))
                loss_p, g_p = steps["plain"](params, seed)
            check_launches("the sharded bucketed step", counts, ("persistent_tape", "table_gather",
                                                                  "replay_path", "replay_adjoint"))
            unequal = [k for k in g_p if not torch.equal(g_p[k], g_s[k])]
            if counts["persistent_tape"] != 1 or float(loss_s) != float(loss_p) or unequal:
                fail(f"phase 16: sharded step launches {counts}, loss {float(loss_s)} vs "
                     f"{float(loss_p)}, gradients unequal {unequal}")

            # Timed from here, once the gloo ranks have started and wait.
            deadline = time.perf_counter() + 300
            while not all(r.exists() for r in ready):
                if time.perf_counter() > deadline or any(p.poll() is not None for p in procs):
                    fail("phase 16: the gloo ranks did not start: exit codes "
                         f"{[p.poll() for p in procs]}, output of the ended ones "
                         f"{[p.communicate()[0].decode()[-3000:] for p in procs if p.poll() is not None]}")
                time.sleep(0.05)
            step_walls = {"plain": [], "shard": []}
            for mode in ("plain", "shard", "shard", "plain"):
                timings = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[mode](params, seed, timings)
                torch.cuda.synchronize()  # on the gradients, not the loss alone
                step_walls[mode].append(dict(wall_s=time.perf_counter() - t0, **timings))
            rec["sharded_step"] = dict(launches=counts, loss=float(loss_s), bit_equal=True,
                                       walls_in_turns=step_walls)
            # The main path's one collective: the framebuffer's all-reduce.
            fb = torch.rand(FRAMEBUFFER_SHAPE, device="cuda")
            want = fb.clone()
            dist.all_reduce(fb)
            if not torch.equal(fb, want):
                fail("phase 16: a one-rank all-reduce changed the framebuffer")
            rec["all_reduce_ms"] = time_cuda(lambda: dist.all_reduce(fb), reps=100, warm=5)
            rec["all_reduce_bytes"] = fb.numel() * 4
        finally:
            close_group()

        # The CLI with --shard in turns with the plain CLI.
        walls, starts = {"plain": [], "shard": []}, []
        want_png = main_png.read_bytes()
        for mode in ("plain", "shard", "shard", "plain") * SHARD_ROUNDS:
            png = OUT_DIR / f"shard_{mode}.png"
            argv = ["--scene", "rand_spheres", "--out", str(png)] + (
                ["--shard"] if mode == "shard" else [])
            rep, counts = counted(lambda: cli.main(argv))
            check_launches(f"the {mode} CLI", counts, ("persistent_render",))
            if counts["persistent_render"] != 1 or png.read_bytes() != want_png:
                fail(f"phase 16: the {mode} CLI launched kernel 2 "
                     f"{counts['persistent_render']} times; PNG equal to phase 5's: "
                     f"{png.read_bytes() == want_png}")
            walls[mode].append(rep["wall_s"])
            if mode == "shard":
                if rep["mesh"] != [1, 1] or rep["backend"] != "nccl":
                    fail(f"phase 16: --shard ran on {rep['mesh']} under {rep['backend']}")
                starts.append(rep["group_start_s"])
                rec["shard_cli"] = dict(report=rep, launches=counts)
        rec["shard_cli"].update(walls_in_turns=walls, group_start_s=starts)
        if dist.is_initialized():
            fail("phase 16: the --shard CLI left its process group running")

        # gloo at two ranks, two processes on the one card.
        t0 = time.perf_counter()
        go.touch()
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
        gloo_s = time.perf_counter() - t0
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode != 0 for p in procs):
        fail(f"phase 16: a gloo rank failed: {outs}")
    ranks = [json.loads((OUT_DIR / f"gloo_rank{r}.json").read_text()) for r in range(2)]
    scene, cam, st = get_scene("rand_spheres", **GLOO_SHAPE)
    renderer = driver.chunk_renderer(scene, cam, st, torch.device("cuda"))
    chunk = driver.default_spp_chunk(scene, st, ranks=2)
    acc, done, c = torch.zeros(st.width * st.height, 3, device="cuda"), 0, 0
    while done < st.samples_per_pixel:
        step = min(chunk, st.samples_per_pixel - done)
        seed = driver.chunk_seed(0, c)
        acc = acc + (regen_partial(renderer, step, seed, 0, 2)[0]
                     + regen_partial(renderer, step, seed, 1, 2)[0])
        done, c = done + step, c + 1
    want = (acc / float(st.samples_per_pixel)).reshape(st.height, st.width, 3).cpu()
    got = torch.load(OUT_DIR / "gloo_render.pt")
    if not torch.equal(got, want) or any(r["render_launches"] < 1 for r in ranks):
        fail(f"phase 16: the gloo render vs the in-process sum of its ranks: max abs "
             f"{float((got - want).abs().max())}; ranks {json.dumps(ranks)}")
    rec["gloo_world2"] = dict(ranks=ranks, released_s=gloo_s, bit_equal=True)
    print(f"phase 16 distribution: --shard CLI (NCCL, one rank) walls {json.dumps(walls)} s, "
          f"group start {[round(x, 4) for x in starts]} s (the process's first NCCL group "
          f"{rec['first_group_s']:.4f} s), PNG byte-equal to phase 5's; "
          f"all-reduce of {rec['all_reduce_bytes']} B {rec['all_reduce_ms']:.4f} ms; sharded "
          f"bucketed step bit-equal to make_bucketed_grad_fn's, walls "
          f"{json.dumps({k: [round(w['wall_s'], 4) for w in v] for k, v in step_walls.items()})}"
          f" s; large scene and wavefront step bit-equal, launches {json.dumps(large['shard'])}, "
          f"{json.dumps(step_rec['shard'])}; gloo two ranks on one card: render bit-equal to "
          f"the in-process sum, rank 0 {json.dumps(ranks[0])}, {gloo_s:.2f} s after their "
          f"release; {smi}", flush=True)
    return rec


def run_entry_point(args: list, timeout: int, log: Path):
    """(exit code, the last line parsed as JSON, seconds) of `python -m
    args` run from the checkout's root; its standard output goes to `log`."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    log.write_text(proc.stdout + proc.stderr)
    try:
        last = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"phase 17: {' '.join(args)} exited {proc.returncode} without a JSON last line; "
             f"errors {proc.stderr[-3000:]}")
    return proc.returncode, last, seconds


def entry_points_phase(smi) -> dict:
    """Phase 17: the bench over every row with one timed run each, then the
    estimator self-check at its default spp (see the module docstring);
    their output goes to OUT_DIR's bench.log and check_persistent.log."""
    rc, bench, bench_s = run_entry_point(
        ["raytracer_tpu_torch.bench", "--repeats", "1"], BENCH_TIMEOUT_S, OUT_DIR / "bench.log")
    detail = bench.get("detail", {})
    errors = {k: v["error"] for k, v in detail.items() if isinstance(v, dict) and "error" in v}
    if rc != 0 or bench.get("ok") is not True or errors:
        fail(f"phase 17: the bench exited {rc}, ok {bench.get('ok')}, faults "
             f"{bench.get('faults')}")
    rows = {name: {k: v for k, v in row.items()
                   if k.endswith(("wall_s", "mrays_per_s")) and k != "cold_wall_s"}
            for name, row in detail.items() if isinstance(row, dict) and "row_s" in row}
    print(f"phase 17 bench (--repeats 1): headline {bench['value']:.2f} {bench['unit']} "
          f"traced, wall {detail['wall_s']:.4f} s, vs_baseline {bench['vs_baseline']:.1f}; rows "
          f"(walls and rates) {json.dumps(rows)}; "
          f"card {json.dumps(bench['device'])}; {bench_s:.1f} s; {smi}", flush=True)
    rc, check, check_s = run_entry_point(["raytracer_tpu_torch.scripts.check_persistent"],
                                         CHECK_TIMEOUT_S, OUT_DIR / "check_persistent.log")
    if rc != 0 or check.get("ok") is not True:
        fail(f"phase 17: check_persistent exited {rc}: {json.dumps(check)}")
    print(f"phase 17 check_persistent (spp {check['spp']}): "
          f"{json.dumps({k: v['ok'] for k, v in check['scenes'].items()})}; {check_s:.1f} s",
          flush=True)
    return dict(bench_s=bench_s, headline=bench["value"], rows=rows, check_s=check_s,
                check={k: {f: v[f] for f in ("ok", "mean_fast", "mean_independent", "std")
                           if f in v} for k, v in check["scenes"].items()})


def padded_fold(log, num_slots, n, n_pixels, jump):
    """The retirement-log fold as it was before it took the log in place:
    the whole log padded to whole chunks of n_pixels lanes, chunk-summed
    into a (3, K, n_pixels) copy, each slot rolled into the framebuffer.
    Phase 18's reference: integrator/wavefront.py:_fold_log must equal it
    bit for bit."""
    import torch

    chunks = -(-n // n_pixels)
    log = torch.nn.functional.pad(log, (0, chunks * n_pixels - n))
    per_slot = log.reshape(3, num_slots, chunks, n_pixels).sum(dim=2)
    fb = torch.zeros(n_pixels, 3, dtype=log.dtype, device=log.device)
    for k in range(num_slots):
        fb = fb + torch.roll(per_slot[:, k, :].T, (k * jump) % n_pixels, dims=0)
    return fb


def peak_above(fn):
    """(fn(), seconds by the host clock ended by a device sync, the
    allocator's peak during fn above what was allocated before it, in
    MiB)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, (torch.cuda.max_memory_allocated() - base) / 2**20


def miss_only(width, spp):
    """tests/test_torch_integrator.py's miss-only scene at `width` x
    width*9/16: no geometry, so every sample is the background (0.2, 0.4,
    0.6), at depth 8. Returns (scene, camera, settings)."""
    from raytracer_tpu_torch.core.camera import make_camera
    from raytracer_tpu_torch.geometry.scene import SceneBuilder

    b = SceneBuilder(0)
    b.lambertian((0.5, 0.5, 0.5))
    cam, st = make_camera(16 / 9, width, samples_per_pixel=spp, max_depth=8,
                          background=(0.2, 0.4, 0.6), look_from=(0, 0, 2), look_at=(0, 0, 0))
    return b.build(), cam, st


def exact_miss_sums(fb, background, spp):
    """Whether every pixel of the (P, 3) sums `fb` is the background added
    spp times in float32, as the fold adds a pixel's slots one by one."""
    import torch

    want = torch.zeros(3, dtype=torch.float32, device=fb.device)
    for _ in range(spp):
        want = want + background.to(fb.device)
    return bool((fb == want).all())


def rng_tape_phase(smi, counted, check_launches) -> dict:
    """Phase 19: the bucketed step on scenes kernel 3 does not shade (noise
    from rng-filled Perlin tables), its tape recorded by
    integrator/wavefront.py:trace_tape_scene, kernel 1 a bounce.

    At 64x36, 2 spp, depth 8 (seed 21), under torch's deterministic
    algorithms: step_devices on the mixed scene with an rng-table noise
    sphere (largest sphere r = 100; CUDA against the CPU held at
    STEP_LIMITS, as phase 7a holds the mixed scene) and on rng-table perlin
    (the kernel-1 step against its twin's held; CUDA against the CPU
    reported with phase 7a's witnesses, not held: its r = 1000 ground
    sphere's winner t cancels in float32, as on rand_spheres); one step
    with trainable_camera=("look_from", "fov_radians"); the sharded step at
    one NCCL rank against the unsharded one, loss and gradients bit-equal.

    At phase 7t's perlin shape: the tape forward with kernel 1 against the
    same forward with kernel 1's twin on CUDA (tape and radiance
    bit-equal), kernel 1's calls there timed at their own rays; then the
    bucketed Adam steps of RNG_STEP_TURNS, each counted: the rng-table
    steps launch kernel 1 and never kernel 3, the procedural ones kernel 3
    once."""
    import dataclasses as dc

    import numpy as np
    import torch

    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.diff.bucketed import make_bucketed_grad_fn
    from raytracer_tpu_torch.diff.grad import (
        make_inverse_renderer,
        render_linear_diff,
        split_scene,
    )
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.parallel.mesh import close_group, init_group, make_mesh
    from raytracer_tpu_torch.parallel.train import make_sharded_bucketed_grad_fn
    from raytracer_tpu_torch.scenes.registry import get_scene

    rec, bad = {}, []
    w, h, k, depth = 64, 36, 2, 8
    perlin_small, cam_small, _ = get_scene("perlin", width=w, spp=k, max_depth=depth,
                                           procedural_perlin=False)
    for label, (scene, cam), held in (("mixed_noise_rng", mixed_scene(noise_sphere=True), True),
                                      ("perlin_rng", (perlin_small, cam_small), False)):
        if pk.unsupported_reason(scene) is None:
            fail(f"phase 19: {label} is a scene kernel 3 shades")
        with deterministic():
            (runs, tape_eq), counts = counted(
                lambda: step_devices(scene, cam, 21, w, h, k, depth))
        if counts["persistent_tape"] or counts["closest_hit"] <= 0:
            fail(f"phase 19 {label}: launches {counts}")
        rec[label] = hold_step(f"phase 19 {label}", runs, tape_eq, held, bad)
    target = torch.from_numpy(
        np.random.default_rng(3).uniform(0, 1, (h, w, 3)).astype(np.float32)).cuda()
    params, _, step = make_inverse_renderer(
        perlin_small, cam_small, target, width=w, height=h, samples_per_pass=k, max_depth=depth,
        backend="bucketed", trainable_camera=("look_from", "fov_radians"), device="cuda")
    loss, counts = counted(lambda: float(step(21)))
    cam_grads = {n: params["camera"][n].grad for n in ("look_from", "fov_radians")}
    if not (math.isfinite(loss) and all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                                        for g in cam_grads.values())):
        bad.append(f"phase 19 camera step: loss {loss}, camera gradients {cam_grads}")
    check_launches("phase 19 camera step", counts, ("closest_hit", "table_gather"))
    rec["camera_step"] = dict(loss=loss, launches=counts,
                              camera_grad_max={n: float(g.abs().max())
                                               for n, g in cam_grads.items()})
    params, rebuild = split_scene(perlin_small.to("cuda"))
    kw = dict(width=w, height=h, samples_per_pass=k, max_depth=depth)
    init_group("cuda")
    try:
        sharded = make_sharded_bucketed_grad_fn(rebuild, cam_small, target, make_mesh(), **kw)
        with deterministic():
            (loss_s, g_s), counts = counted(lambda: sharded(params, 21))
            loss_p, g_p = make_bucketed_grad_fn(rebuild, cam_small, target, **kw)(params, 21)
    finally:
        close_group()
    check_launches("phase 19 sharded step", counts, ("closest_hit", "table_gather"))
    unequal = [n for n in g_p if not torch.equal(g_s[n], g_p[n])]
    if float(loss_s) != float(loss_p) or unequal:
        bad.append(f"phase 19 sharded step: loss {float(loss_s)} vs {float(loss_p)}, gradients "
                   f"unequal {unequal}")
    rec["sharded_step"] = dict(loss=float(loss_s), launches=counts)
    if bad:
        fail(f"phase 19: {bad}; readings {json.dumps(rec)}")

    # The tape forward at phase 7t's perlin shape: step 0's own call. The
    # steps start from the small sphere 5% too large (phase 7t scales the
    # r = 1000 ground too, which then holds the camera inside it).
    scenes = {}
    for label in ("rng", "procedural"):
        scene, cam, st = get_scene("perlin", **{**TRAIN_CFG, "max_depth": PERLIN_STEP_DEPTH},
                                   procedural_perlin=label == "procedural")
        grown = scene.sph_radius * torch.where(scene.sph_radius < 100.0, 1.05, 1.0)
        scenes[label] = (dc.replace(scene, sph_radius=grown), cam, st, scene)
    start, cam, st, _ = scenes["rng"]
    n = st.width * st.height * st.samples_per_pixel
    fwd_kw = dict(width=st.width, height=st.height, max_depth=st.max_depth, sky_gradient=False)
    frame, sc = camera_frame(cam, st.width, st.height), start.to("cuda")
    with HitRecorder(ik) as hits:
        (rad_k, tape_k), fwd_ms = timed(lambda: wf.trace_tape_scene(
            sc, frame, cam.background, TRAIN_SEEDS[0], n, **fwd_kw))
    with forward_twin(start):
        (rad_p, tape_p), fwd_plain_ms = timed(lambda: wf.trace_tape_scene(
            sc, frame, cam.background, TRAIN_SEEDS[0], n, **fwd_kw))
    if not (torch.equal(tape_k, tape_p) and torch.equal(rad_k, rad_p)
            and bool(torch.isfinite(rad_k).all())):
        fail(f"phase 19: the tape forward with kernel 1 vs its twin: tape equal on "
             f"{float((tape_k == tape_p).float().mean())}, radiance max abs "
             f"{float((rad_k - rad_p).abs().max())}")
    k1 = hits.timed_sum()
    rec["tape_forward"] = dict(
        lanes=n, ms=fwd_ms, plain_ms=fwd_plain_ms, hits=int((tape_k >= 0).sum()),
        rays_per_bounce=hits.counts, closest_hit=k1)
    del hits.calls, rad_k, rad_p, tape_k, tape_p

    # The steps, in turns, each counted.
    steppers = {}
    for label, (start, cam, st, scene) in scenes.items():
        with torch.no_grad():
            target = render_linear_diff(scene.to("cuda"), cam, 7, width=st.width,
                                        height=st.height, samples_per_pass=st.samples_per_pixel,
                                        max_depth=st.max_depth)
        steppers[label] = make_inverse_renderer(
            start, cam, target, backend="bucketed", width=st.width, height=st.height,
            samples_per_pass=st.samples_per_pixel, max_depth=st.max_depth, learning_rate=1e-2,
            device="cuda")
    steps = {label: [] for label in steppers}
    for label, seed in zip(RNG_STEP_TURNS, TRAIN_SEEDS):
        params, _, step = steppers[label]
        timings = {}
        t0 = time.perf_counter()
        loss, counts = counted(lambda: float(step(seed, timings)))
        wall = time.perf_counter() - t0
        check_launches(f"phase 19 {label} step", counts,
                       ("closest_hit" if label == "rng" else "persistent_tape", "table_gather"))
        if label == "procedural" and counts["persistent_tape"] != 1:
            fail(f"phase 19: the procedural step launched kernel 3 {counts['persistent_tape']} "
                 "times")
        if not (math.isfinite(loss) and float(params["sph_radius"].grad.abs().max()) > 0
                and all(bool(torch.isfinite(p.grad).all()) for p in params.values())):
            fail(f"phase 19 {label} step {seed}: loss {loss}, gradients not finite or no "
                 "radius gradient")
        steps[label].append(dict(loss=loss, wall_s=wall, launches=counts, **timings))
    rec["steps"] = steps
    for label, rows in steps.items():
        for i, s_ in enumerate(rows):
            print(f"phase 19 {label}-table perlin step {i} at 400x225@8spp depth "
                  f"{PERLIN_STEP_DEPTH}: loss {s_['loss']:.6g}, wall {s_['wall_s']:.4f} s = tape "
                  f"forward {s_['tape_forward']:.4f} + loss/cotangent "
                  f"{s_['loss_cotangent']:.4f} + replay forward {s_['replay_forward']:.4f} + "
                  f"backward {s_['backward']:.4f} + optimizer {s_['optimizer']:.4f} s; launches "
                  f"{json.dumps(s_['launches'])}; {smi}", flush=True)
    small = {x: rec[x] for x in ("mixed_noise_rng", "perlin_rng", "camera_step", "sharded_step")}
    print(f"phase 19 rng-table tape forward at 400x225@8spp depth {PERLIN_STEP_DEPTH} "
          f"({n} lanes): {fwd_ms:.3f} ms with kernel 1, {fwd_plain_ms:.3f} ms with its twin, "
          f"bit-equal; kernel 1 {json.dumps(k1)}, rays a bounce {hits.counts}; at 64x36@2 "
          f"depth 8: {json.dumps(small)}; {smi}", flush=True)
    return rec


def large_image_phase(cli, smi) -> dict:
    """Phase 18: large images on the card, the retirement-log fold at the
    sizes where it outgrew the card.

    a. one_weekend_final at the bench row's 1200x800@125 (fewer lanes than
       pixels) and the headline's rand_spheres 400x225@500 (more): one
       kernel-2 call each, its log folded by `_fold_log` and by
       `padded_fold`, torch.equal; each fold's wall and peak in turns,
       padded / new / new / padded; then render_image at 1200x800@125,
       its peak above what was allocated before it.
    b. rand_spheres at 3840x2160@64, depth 50, 2^18 lanes, through
       render_image: chunks (kernel-2 launches), wall, segments, peak;
       finite, segments >= camera rays, the peak within LOG_BUDGET_BYTES,
       two more framebuffers (the sum and the previous chunk's), the fold's
       scratch, the tables and the lanes' schedule and segments. The CLI
       at that size: its PNG 3840x2160.
    c. the miss-only scene at 3840x2160, 3 spp, 2^18 lanes (the wavefront
       32x smaller than the image) through render_wavefront_regen: every
       pixel exactly the background added 3 times, segments = P * spp.
    d. the wavefront-step path at 3840x2160: the miss-only scene through
       render_wavefront_step at its 2^21 lanes, exact as in (c); then
       phase 10's rng-table perlin at 2 spp, depth 8, through render_image:
       finite, segments >= camera rays, its wall and peak."""
    import numpy as np
    import torch
    from PIL import Image

    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.ops import wavefront_kernel as wk
    from raytracer_tpu_torch.render import driver
    from raytracer_tpu_torch.scenes.registry import get_scene
    from raytracer_tpu_torch.utils.metrics import RenderMetrics

    rec = {}
    # (a) the fold against the padded fold on kernel 2's own logs.
    folds = {}
    for label, name, kw in (("one_weekend_1200x800", "one_weekend_final", dict(spp=125)),
                            ("headline", "rand_spheres", {})):
        scene, cam, st = get_scene(name, **kw)
        kernel, _, _ = persistent_pair(scene, cam, st, driver.DEFAULT_WAVEFRONT, seed=0)
        log, _ = kernel()
        n_pix = st.width * st.height
        n, num_slots, jump = wf.strided_schedule(n_pix, st.samples_per_pixel,
                                                 driver.DEFAULT_WAVEFRONT)
        args = (log, num_slots, n, n_pix, jump)
        turns = {"padded": [], "fold": []}
        peaks = {}
        for which in ("padded", "fold", "fold", "padded"):
            fn = padded_fold if which == "padded" else wf._fold_log
            out, wall, peak = peak_above(lambda: fn(*args))
            turns[which].append(wall)
            peaks[which] = peak
            if which == "padded":
                ref = out
            else:
                got = out
            del out
        if not torch.equal(got, ref):
            fail(f"phase 18a {label}: the fold differs from the padded fold on "
                 f"{int((got != ref).sum())} values")
        folds[label] = dict(size=[st.width, st.height], spp=st.samples_per_pixel, lanes=n,
                            slots=num_slots, log_mb=log.numel() * 4 / 2**20,
                            bit_equal=True, padded_s=turns["padded"], fold_s=turns["fold"],
                            padded_peak_mb=peaks["padded"], fold_peak_mb=peaks["fold"])
        del log, got, ref
        print(f"phase 18a fold of kernel 2's log, {name} {st.width}x{st.height}@"
              f"{st.samples_per_pixel} ({n} lanes, {n_pix} pixels, {num_slots} slots): "
              f"bit-equal to the padded fold; walls in turns padded / fold / fold / padded "
              f"{turns['padded'][0]:.4f} / {turns['fold'][0]:.4f} / {turns['fold'][1]:.4f} / "
              f"{turns['padded'][1]:.4f} s; peak above the log padded "
              f"{peaks['padded']:.1f} MiB, fold {peaks['fold']:.1f} MiB; {smi}", flush=True)
    scene, cam, st = get_scene("one_weekend_final", spp=125)
    pk.LAUNCHES = 0
    img, wall, peak = peak_above(lambda: driver.render_image(scene, cam, st, device="cuda",
                                                             seed=0))
    max_mb = torch.cuda.max_memory_allocated() / 2**20
    if pk.LAUNCHES != 1 or not bool(torch.isfinite(img).all()):
        fail(f"phase 18a: render_image at 1200x800@125 launched kernel 2 {pk.LAUNCHES} times")
    del img
    rec["fold"] = dict(folds, render_image_1200x800=dict(wall_s=wall, peak_mb=peak,
                                                         max_memory_allocated_mb=max_mb,
                                                         launches=1))
    print(f"phase 18a render_image one_weekend_final 1200x800@125: wall {wall:.4f} s, peak "
          f"{peak:.1f} MiB above what was allocated before (max_memory_allocated {max_mb:.1f} "
          f"MiB; 11,497 on the bench row with the padded fold); {smi}", flush=True)

    # (b) 3840x2160@64 on the persistent path, through render_image and the CLI.
    scene, cam, st = get_scene("rand_spheres", width=3840, spp=64)
    n_pix = st.width * st.height
    if (st.width, st.height, st.max_depth) != (3840, 2160, 50):
        fail(f"phase 18b: rand_spheres at width 3840 renders at {st}")
    chunk = driver.default_spp_chunk(scene, st)
    n, num_slots, _ = wf.strided_schedule(n_pix, chunk, driver.DEFAULT_WAVEFRONT)
    chunks = -(-st.samples_per_pixel // chunk)
    metrics = RenderMetrics(total_spp=st.samples_per_pixel, pixels=n_pix)
    pk.LAUNCHES = 0
    img, wall, peak = peak_above(lambda: driver.render_image(scene, cam, st, device="cuda",
                                                             seed=0, metrics=metrics))
    tables = sum(t.numel() * t.element_size()
                 for t in pk.pack_persistent_tables(scene.to("cuda")))
    bound = (driver.LOG_BUDGET_BYTES + 2 * 12 * n_pix + wf.fold_scratch_bytes(num_slots, n, n_pix)
             + tables + 16 * n * chunks) / 2**20
    segs, cam_rays = metrics.traced_segments, n_pix * st.samples_per_pixel
    finite = bool(torch.isfinite(img).all())
    del img
    if not (finite and pk.LAUNCHES == chunks and segs >= cam_rays and peak <= bound):
        fail(f"phase 18b: finite {finite}, launches {pk.LAUNCHES} for {chunks} chunks, segments "
             f"{segs} for {cam_rays} camera rays, peak {peak:.1f} MiB against {bound:.1f}")
    out_png = OUT_DIR / "rand_spheres_3840x2160.png"
    pk.LAUNCHES = 0
    rep = cli.main(["--scene", "rand_spheres", "--width", "3840", "--spp", "64",
                    "--out", str(out_png)])
    with Image.open(out_png) as im:
        png_size = im.size
    if png_size != (3840, 2160) or pk.LAUNCHES != chunks or rep["traced_segments"] != segs:
        fail(f"phase 18b: the CLI wrote a {png_size} PNG with {pk.LAUNCHES} kernel-2 launches, "
             f"{rep['traced_segments']} segments (render_image {segs})")
    rec["persistent_3840x2160"] = dict(
        spp_chunk=chunk, chunks=chunks, launches=chunks, wall_s=wall, segments=segs,
        camera_rays=cam_rays, traced_mrays_per_s=segs / wall / 1e6, peak_mb=peak,
        peak_bound_mb=bound, retirement_log_mb=metrics.retirement_log_mb,
        cli=dict(wall_s=rep["wall_s"], peak_hbm_mb=rep.get("peak_hbm_mb"), png=list(png_size)))
    print(f"phase 18b rand_spheres 3840x2160@64 depth 50 via render_image, "
          f"{driver.DEFAULT_WAVEFRONT} lanes: {chunks} chunks of {chunk} spp (log "
          f"{metrics.retirement_log_mb:.1f} MiB), wall {wall:.4f} s, {segs} segments "
          f"({segs / wall / 1e6:.1f} Mrays/s traced), peak {peak:.1f} MiB (bound {bound:.1f}); the "
          f"CLI {rep['wall_s']:.4f} s, PNG {png_size[0]}x{png_size[1]}; {smi}", flush=True)

    # (c), (d): exact accounting at 3840x2160 on both regenerative paths.
    scene, cam, st = miss_only(3840, 3)
    n_pix, spp = st.width * st.height, st.samples_per_pixel
    sc = scene.to("cuda")
    tables = pk.pack_persistent_tables(sc)
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, st.width, st.height),
                                      cam.background).cuda()
    kw = dict(width=st.width, height=st.height, spp=spp, max_depth=st.max_depth)
    exact = {}
    for label, lanes in (("persistent", driver.DEFAULT_WAVEFRONT),
                         ("wavefront_step", driver.path_wavefront("wavefront_step", n_pix))):
        pk.LAUNCHES = wk.LAUNCHES = 0
        if label == "persistent":
            (fb, segs), wall, peak = peak_above(lambda: wf.render_wavefront_regen(
                *tables, cam_s, 3, wavefront_size=lanes, **kw))
            launched = pk.LAUNCHES
        else:
            (fb, segs, _), wall, peak = peak_above(lambda: wf.render_wavefront_step(
                *tables, None, cam_s, 3, wavefront_size=lanes, **kw))
            launched = wk.LAUNCHES
        ok = exact_miss_sums(fb, cam.background, spp)
        total = int(segs.sum())
        del fb
        if not (ok and total == n_pix * spp and launched > 0):
            fail(f"phase 18{'c' if label == 'persistent' else 'd'} miss-only 3840x2160@{spp} "
                 f"on the {label} path, {lanes} lanes: exact {ok}, segments {total} for "
                 f"{n_pix * spp} samples, launches {launched}")
        exact[label] = dict(lanes=lanes, exact=ok, segments=total, launches=launched,
                            wall_s=wall, peak_mb=peak)
        print(f"phase 18{'c' if label == 'persistent' else 'd'} miss-only 3840x2160@{spp} on "
              f"the {label} path, {lanes} lanes ({n_pix / lanes:.1f} pixels a lane): every "
              f"pixel exactly {spp} x background, {total} segments = P * spp, {launched} "
              f"launches, wall {wall:.4f} s, peak {peak:.1f} MiB; {smi}", flush=True)
    rec["exact_3840x2160"] = exact
    scene, cam, st = get_scene("perlin", procedural_perlin=False, width=3840,
                               spp=LARGE_STEP_SPP, max_depth=LARGE_STEP_DEPTH)
    n_pix = st.width * st.height
    metrics = RenderMetrics(total_spp=st.samples_per_pixel, pixels=n_pix)
    wk.LAUNCHES = 0
    img, wall, peak = peak_above(lambda: driver.render_image(scene, cam, st, device="cuda",
                                                             seed=0, metrics=metrics))
    finite = bool(torch.isfinite(img).all())
    mean = img.clamp(0.0, 1.0).mean((0, 1)).cpu().numpy()
    del img
    segs, cam_rays = metrics.traced_segments, n_pix * st.samples_per_pixel
    if not (driver.render_path(scene) == "wavefront_step" and finite and segs >= cam_rays
            and wk.LAUNCHES > 0):
        fail(f"phase 18d: rng-table perlin 3840x2160: path {driver.render_path(scene)}, finite "
             f"{finite}, segments {segs} for {cam_rays} camera rays, launches {wk.LAUNCHES}")
    rec["wavefront_step_3840x2160"] = dict(
        spp=st.samples_per_pixel, max_depth=st.max_depth, wall_s=wall, peak_mb=peak,
        segments=segs, launches=wk.LAUNCHES, iterations=metrics.snapshot().get("iterations"),
        linear_mean=np.asarray(mean).round(4).tolist())
    print(f"phase 18d rng-table perlin 3840x2160@{st.samples_per_pixel} depth {st.max_depth} via "
          f"render_image ({driver.path_wavefront('wavefront_step', n_pix)} lanes): wall "
          f"{wall:.4f} s, {segs} segments, {wk.LAUNCHES} kernel-5 launches, peak {peak:.1f} MiB, "
          f"linear mean {np.asarray(mean).round(4).tolist()}; {smi}", flush=True)
    return rec


class GatherRecorder:
    """Stands in for ops.gather_kernel.gather_backward while a path runs and
    passes every call on to it, keeping each call's cotangent, rows and
    row count (`calls`)."""

    def __init__(self, gk):
        self.gk, self.real, self.calls = gk, gk.gather_backward, []

    def __enter__(self):
        self.gk.gather_backward = self
        return self

    def __exit__(self, *exc):
        self.gk.gather_backward = self.real

    def __call__(self, grad, idx, rows):
        self.calls.append((grad.detach().clone(), idx.clone(), rows))
        return self.real(grad, idx, rows)


def gather_check(label, grad, idx, rows) -> dict:
    """The gather backward on the card against its twin's float64 sums on the
    host, within the float32 rounding of the kernel's own order
    (ops/gather_kernel.py:rounding_bound), and bit-identical over two
    runs."""
    import torch

    from raytracer_tpu_torch.ops import gather_kernel as gk

    got = gk.gather_backward(grad, idx, rows)
    again = gk.gather_backward(grad, idx, rows)
    torch.cuda.synchronize()
    want = gk.gather_backward_plain(grad.double().cpu(), idx.cpu(), rows)
    n, cols = grad.shape
    plan = gk.launch_plan(rows, cols, n, torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    err = (got.double().cpu() - want).abs()
    tol = gk.rounding_bound(grad, idx, rows, plan)
    if not (torch.equal(got, again) and bool((err <= tol).all())):
        fail(f"{label}: gather backward vs its twin: bit-identical runs "
             f"{torch.equal(got, again)}, worst error over its bound "
             f"{float((err - tol).max())}")
    return dict(max_abs_err=float(err.max()), worst_err_over_bound=float(
        (err / tol.clamp_min(1e-300)).max()), plan=plan._asdict())


def gather_phase(smi) -> dict:
    """Phase 20: the table gather's backward kernel (csrc/gather_kernel.cu).

    At the train cell's read shapes (GATHER_ROWS rows of 16, 3 and 1
    columns, GATHER_POSITIONS positions, GATHER_HOT_SHARE on row 0, int64
    rows): the kernel against its twin (`gather_check`), then its device
    time beside its byte bound (the cotangent read once), the twin's
    index_add_ on the card's tensors (atomics, not deterministic) and
    PyTorch's index_put_(accumulate=True), autograd's backward of
    table[idx] that the port no longer calls. Then one bucketed step at
    phase 7's shape on the eager replay (`eager_replay`: the reads this
    kernel serves there; phase 21 holds the replay kernels, whose rows it
    sums too) with every gather backward recorded, each call held against
    its twin and the calls timed at their own shapes, summed; and that
    step with its reads plain (TableGather.apply replaced by advanced
    indexing) in turns with the gather step, their gradients side by
    side."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.diff.bucketed import make_bucketed_grad_fn
    from raytracer_tpu_torch.diff.grad import render_linear_diff, split_scene
    from raytracer_tpu_torch.ops import gather_kernel as gk
    from raytracer_tpu_torch.scenes.registry import get_scene

    def library(grad, idx, rows):
        return torch.zeros(rows, grad.shape[1], device="cuda").index_put_(
            (idx,), grad, accumulate=True)

    rec = {"shapes": {}}
    rng = np.random.default_rng(20)
    idx_np = rng.integers(0, GATHER_ROWS, GATHER_POSITIONS)
    idx_np[rng.uniform(size=GATHER_POSITIONS) < GATHER_HOT_SHARE] = 0
    idx = torch.from_numpy(idx_np).cuda()
    for cols in (16, 3, 1):
        grad = torch.from_numpy(rng.standard_normal((GATHER_POSITIONS, cols))
                                .astype(np.float32)).cuda()
        r = gather_check(f"phase 20 ({GATHER_ROWS}, {cols})", grad, idx, GATHER_ROWS)
        r.update(
            ms=time_device(lambda: gk.gather_backward(grad, idx, GATHER_ROWS), GATHER_REPS),
            plain_ms=time_device(lambda: gk.gather_backward_plain(grad, idx, GATHER_ROWS),
                                 GATHER_REPS),
            library_ms=time_device(lambda: library(grad, idx, GATHER_ROWS), GATHER_REPS),
            bound_ms=bound(0, grad.numel() * 4)[0])
        rec["shapes"][f"{GATHER_ROWS}x{cols}"] = r
    del grad, idx

    scene, cam, st = get_scene("rand_spheres", **TRAIN_CFG)
    with torch.no_grad():
        target = render_linear_diff(scene.to("cuda"), cam, 7, width=st.width, height=st.height,
                                    samples_per_pass=st.samples_per_pixel,
                                    max_depth=st.max_depth)
    start = dataclasses.replace(scene, tex_c0=scene.tex_c0 * 0.5).to("cuda")
    params, rebuild = split_scene(start)
    step = make_bucketed_grad_fn(rebuild, cam, target, width=st.width, height=st.height,
                                 samples_per_pass=st.samples_per_pixel, max_depth=st.max_depth)
    with eager_replay():
        step(params, TRAIN_SEEDS[0])  # warm
        gk.LAUNCHES = 0
        torch.cuda.synchronize()
        with GatherRecorder(gk) as calls:
            step(params, TRAIN_SEEDS[0])
    torch.cuda.synchronize()
    launches = gk.LAUNCHES
    step_rec = dict(launches=launches, calls=len(calls.calls),
                    rows=sum(int(i.shape[0]) for _, i, _ in calls.calls),
                    by_cols={}, ms=0.0, library_ms=0.0, bound_ms=0.0, worst_err_over_bound=0.0)
    for k, (grad, idx_c, rows) in enumerate(calls.calls):
        c = step_rec["by_cols"].setdefault(str(grad.shape[1]), dict(calls=0, rows=0))
        c["calls"] += 1
        c["rows"] += int(grad.shape[0])
        held = gather_check(f"phase 20 step call {k}", grad, idx_c, rows)
        step_rec["worst_err_over_bound"] = max(step_rec["worst_err_over_bound"],
                                               held["worst_err_over_bound"])
        step_rec["ms"] += time_device(lambda: gk.gather_backward(grad, idx_c, rows), 5)
        step_rec["library_ms"] += time_device(lambda: library(grad, idx_c, rows), 3)
        step_rec["bound_ms"] += bound(0, grad.numel() * 4)[0]
    del calls
    rec["step"] = step_rec

    real_apply = gk.TableGather.apply
    turns, grads = [], {}
    with eager_replay():
        try:
            for mode in GATHER_STEP_TURNS:
                gk.TableGather.apply = real_apply if mode == "gather" else (lambda t, i: t[i])
                timings = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, g = step(params, TRAIN_SEEDS[1], timings)
                torch.cuda.synchronize()
                turns.append(dict(mode=mode, wall_s=time.perf_counter() - t0, loss=float(loss),
                                  **timings))
                grads.setdefault(mode, g)
        finally:
            gk.TableGather.apply = real_apply
    rec["step_turns"] = turns
    rec["gradient_gap"] = {
        k: float((grads["gather"][k] - grads["plain"][k]).norm()
                 / grads["plain"][k].norm().clamp_min(1e-30)) for k in grads["plain"]}
    print(f"phase 20 table gather backward at ({GATHER_ROWS}, 16 / 3 / 1) x {GATHER_POSITIONS} "
          f"positions, {GATHER_HOT_SHARE:.0%} on row 0: {json.dumps(rec['shapes'])}; one "
          f"bucketed step at 400x225@8spp depth 50: {json.dumps(step_rec)}; the step in turns "
          f"with plain reads: {json.dumps(turns)}, gradient gap (norm of the difference over "
          f"the plain step's norm) {json.dumps(rec['gradient_gap'])}; {smi}", flush=True)
    return rec


@contextlib.contextmanager
def eager_replay(on: bool = True):
    """The bucketed step's replay on the eager path (`trace` with autograd)
    whatever the scene, while `on`: diff/bucketed.py:takes_replay_kernel
    answers no."""
    from raytracer_tpu_torch.diff import bucketed as bk

    real = bk.takes_replay_kernel
    if on:
        bk.takes_replay_kernel = lambda scene, device: False
    try:
        yield
    finally:
        bk.takes_replay_kernel = real


def median_row_gap(a, b):
    """The median over rows with a nonzero reference norm of |row norm -
    row norm| / reference row norm (`b` the reference), as the benchmark's
    grad_row_gap reads one leaf."""
    import torch

    ra = a.reshape(a.shape[0], -1).norm(dim=1)
    rb = b.reshape(b.shape[0], -1).norm(dim=1)
    on = rb > 0
    if not bool(on.any()):
        return 0.0
    return float(((ra[on] - rb[on]).abs() / rb[on]).median())


def replay_phase(smi, counted, check_launches) -> dict:
    """Phase 21: the replay kernels (csrc/replay_kernel.cu) at the train
    cell's shape, rand_spheres 400x225@8spp depth 50, on one step's own
    tape, lanes and cotangent.

    The forward kernel against its twin (radiance, scratch state,
    segments) and the adjoint against its twin (every lane-bounce's
    cotangent row and index, the per-lane cotangents), bit for bit; the
    adjoint twice, bit-identical. Each kernel's device time (CUDA events
    behind a spin kernel) beside its bound, the reduction's, the twins'
    and the eager replay's (forward and autograd's backward, synced host
    clock). The reduction of the adjoint's rows against their float64 sums
    within its rounding bound, and the reduced gradients of the kernel
    path against the eager replay's autograd on the same inputs
    (REPLAY_COLOUR_GAP, REPLAY_ROW_GAP). Two train steps from the same
    state and seed, bit-identical, with their launches; then the step in
    turns on the eager replay and on the kernels (`timings` phases)."""
    import torch

    from raytracer_tpu_torch.core.camera import camera_frame, camera_rays
    from raytracer_tpu_torch.diff import bucketed as bk
    from raytracer_tpu_torch.diff.grad import render_linear_diff, split_scene
    from raytracer_tpu_torch.geometry.intersect import quad_derived
    from raytracer_tpu_torch.materials.packed import primitive_table
    from raytracer_tpu_torch.ops import ctr_rng
    from raytracer_tpu_torch.ops import gather_kernel as gk
    from raytracer_tpu_torch.ops import replay_kernel as rk
    from raytracer_tpu_torch.scenes.registry import get_scene

    rec = {}
    scene, cam, st = get_scene("rand_spheres", **TRAIN_CFG)
    w, h, k, depth_max = st.width, st.height, st.samples_per_pixel, st.max_depth
    with torch.no_grad():
        target = render_linear_diff(scene.to("cuda"), cam, 7, width=w, height=h,
                                    samples_per_pass=k, max_depth=depth_max)
    start = dataclasses.replace(scene, tex_c0=scene.tex_c0 * 0.5).to("cuda")
    params, rebuild = split_scene(start)
    seed = TRAIN_SEEDS[0]
    rad, tape = bk.tape_forward(params, rebuild, None, cam, seed, k * w * h, width=w, height=h,
                                max_depth=depth_max, sky_gradient=False, device="cuda")
    _, ct_lane, lane_depth, _ = bk.finish(rad, tape, target, samples_per_pass=k)
    lanes = bk.replay_lanes(lane_depth, False, None)
    depth = lane_depth[lanes]
    offs, rows = rk.scratch_layout(depth)
    qd = quad_derived(start)
    table, geom = primitive_table(start, qd), rk.geom_table(start, qd)
    pix = lanes % (w * h)
    o0, d0 = camera_rays(camera_frame(cam, w, h).to("cuda"), pix % w, pix // w,
                         ctr_rng.camera_uniforms(seed, lanes))
    bg = cam.background.cuda()
    grad = ct_lane[lanes].contiguous()
    args = (table, geom, start.num_spheres, tape, lanes, offs, depth)

    def twins():
        f = rk.replay_forward_plain(*args, rows, o0, d0, bg, seed, False)
        return f, rk.replay_adjoint_plain(*args, f, grad, bg, seed, False)

    fwd = rk.replay_forward(*args, rows, o0, d0, bg, seed, False)
    (fwd_p, adj_p), plain_ms = timed(twins)
    adj = rk.replay_adjoint(*args, fwd, grad, bg, seed, False)
    again = rk.replay_adjoint(*args, fwd, grad, bg, seed, False)
    torch.cuda.synchronize()
    unequal, max_abs = {}, {}
    for label, a, b in (("forward", fwd, fwd_p), ("adjoint", adj, adj_p)):
        for name, x, y in zip(a._fields, a, b):
            gap = (x.double() - y.double()).abs().nan_to_num(0)
            max_abs[f"{label}.{name}"] = float(gap.max()) if gap.numel() else 0.0
            if not torch.equal(x, y):
                unequal[f"{label}.{name}"] = dict(
                    equal_share=float((x == y).float().mean()),
                    max_abs=max_abs[f"{label}.{name}"])
    repeat = all(torch.equal(x, y) for x, y in zip(adj, again))
    segs = int(fwd.segments.sum())
    rec["shape"] = dict(lanes=int(lanes.shape[0]), scratch_rows=rows, segments=segs,
                        deepest=int(fwd.segments.max()), table_rows=int(table.shape[0]))
    rec["twin_max_abs"] = max_abs
    if unequal or not repeat:
        fail(f"phase 21: the replay kernels vs their twins: unequal {json.dumps(unequal)}, "
             f"adjoint bit-identical over two launches {repeat}; {json.dumps(rec['shape'])}")

    # The reduction against the same rows summed in float64 on the host,
    # within the float32 rounding of its fixed order.
    g_table, g_geom = rk.reduce_rows(adj, table.shape[0])
    got = g_table.clone()
    got[:, rk.GEOM_COLS] = g_geom
    plan = gk.launch_plan(table.shape[0], rk.ROW_COLS, rows,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    want = gk.gather_backward_plain(adj.rows.double().cpu(), adj.index.long().cpu(),
                                    table.shape[0])
    tol = gk.rounding_bound(adj.rows, adj.index.long(), table.shape[0], plan)
    err = (got.double().cpu() - want).abs()
    if not bool((err <= tol).all()):
        fail(f"phase 21: the rows' reduction off their float64 sums by "
             f"{float((err - tol).max())} over its rounding bound")
    rec["reduction"] = dict(max_abs_err=float(err.max()), worst_err_over_bound=float(
        (err / tol.clamp_min(1e-300)).max()), plan=plan._asdict())

    n = lanes.shape[0]
    fwd_bytes = segs * (4 + 4 * rk.STATE_COLS) + n * (24 + 8 + 8 + 4 + 12 + 4)
    adj_bytes = segs * (4 + 4 * rk.STATE_COLS) + rows * (4 * rk.ROW_COLS + 4) + n * (
        12 + 8 + 8 + 4 + 4 + 4 * rk.LANE_COLS)
    red_bytes = rows * (4 * rk.ROW_COLS + 4) + table.numel() * 4
    times = dict(
        forward_ms=time_device(lambda: rk.replay_forward(*args, rows, o0, d0, bg, seed, False),
                               REPLAY_REPS),
        adjoint_ms=time_device(lambda: rk.replay_adjoint(*args, fwd, grad, bg, seed, False),
                               REPLAY_REPS),
        reduce_ms=time_device(lambda: rk.reduce_rows(adj, table.shape[0]), REPLAY_REPS))
    bounds = dict(forward=bound(segs * REPLAY_FORWARD_OPS, fwd_bytes),
                  adjoint=bound(segs * REPLAY_ADJOINT_OPS, adj_bytes),
                  reduce=bound(rows * rk.ROW_COLS, red_bytes))
    rec["kernels"] = dict(**times, bound_ms={k_: v[0] for k_, v in bounds.items()},
                          bound_by={k_: v[1] for k_, v in bounds.items()},
                          plain_ms=plain_ms)

    # The reduced gradients and the eager replay on the same inputs.
    grads, walls = {}, {}
    for mode in ("kernel", "eager", "kernel", "eager"):
        with eager_replay(mode == "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = bk.replay_grads(params, rebuild, None, cam, seed, tape, ct_lane, lanes,
                                lane_depth, width=w, height=h, max_depth=depth_max,
                                sky_gradient=False)
            torch.cuda.synchronize()
        walls.setdefault(mode, []).append((time.perf_counter() - t0) * 1e3)
        grads.setdefault(mode, g)
    rec["kernels"]["replay_grads_ms"] = walls["kernel"]
    rec["kernels"]["eager_replay_ms"] = walls["eager"]
    gaps = {key: dict(norm_gap=float((grads["kernel"][key] - grads["eager"][key]).norm()
                                     / grads["eager"][key].norm().clamp_min(1e-30)),
                      row_gap=median_row_gap(grads["kernel"][key], grads["eager"][key]))
            for key in grads["eager"]}
    rec["gradient_gaps"] = gaps
    bad = [key for key, v in gaps.items()
           if v["row_gap"] > REPLAY_ROW_GAP
           or (key in REPLAY_COLOUR_LEAVES and v["norm_gap"] > REPLAY_COLOUR_GAP)
           or not bool(torch.isfinite(grads["kernel"][key]).all())]
    if bad:
        fail(f"phase 21: the kernel path's gradients off the eager replay's in {bad}: "
             f"{json.dumps(gaps)}")

    # Two steps from the same state and seed, counted; then the step in turns.
    step = bk.make_bucketed_grad_fn(rebuild, cam, target, width=w, height=h, samples_per_pass=k,
                                    max_depth=depth_max)
    (loss_a, g_a), counts = counted(lambda: step(params, TRAIN_SEEDS[1]))
    loss_b, g_b = step(params, TRAIN_SEEDS[1])
    check_launches("phase 21 step", counts,
                   ("persistent_tape", "table_gather", "replay_path", "replay_adjoint"))
    if not (counts["replay_path"] == counts["replay_adjoint"] == counts["table_gather"] == 1
            and float(loss_a) == float(loss_b)
            and all(torch.equal(g_a[key], g_b[key]) for key in g_a)):
        fail(f"phase 21: two steps from one state and seed: launches {counts}, loss "
             f"{float(loss_a)} / {float(loss_b)}, gradients equal "
             f"{[torch.equal(g_a[key], g_b[key]) for key in g_a]}")
    rec["step_launches"] = counts
    turns = []
    for mode in REPLAY_STEP_TURNS:
        timings = {}
        with eager_replay(mode == "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = step(params, TRAIN_SEEDS[2], timings)
            torch.cuda.synchronize()
        turns.append(dict(mode=mode, wall_s=time.perf_counter() - t0, loss=float(loss),
                          **timings))
    rec["step_turns"] = turns
    print(f"phase 21 replay kernels at rand_spheres 400x225@8spp depth 50: "
          f"{json.dumps(rec['shape'])}, forward and adjoint bit-equal to their twins, the "
          f"adjoint bit-identical over two launches; {json.dumps(rec['kernels'])}; gradient "
          f"gaps to the eager replay {json.dumps(gaps)}; two steps bit-identical, launches "
          f"{json.dumps(counts)}; the step in turns {json.dumps(turns)}; {smi}", flush=True)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA device",
              file=sys.stderr)
        return 1
    import numpy as np

    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.geometry.intersect import scene_tables
    from raytracer_tpu_torch.ops import build
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.render.driver import DEFAULT_WAVEFRONT, render_image, render_path
    from raytracer_tpu_torch.scenes.registry import get_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    record = {}
    # Each phase's start on the host clock; the record gets their seconds.
    phase_start = {}

    # ---- phase 1: device, kernel build ----
    phase_start["1"] = time.perf_counter()
    t0 = time.perf_counter()
    build.load_kernels()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in build.build_log().splitlines() if "registers" in ln]
    from raytracer_tpu_torch import native

    t0 = time.perf_counter()
    if not native.available():
        fail(f"the C++ BVH builder did not build: {native.build_error()}")
    native_s = time.perf_counter() - t0
    print(f"phase 1 device: {kind} x{count}; {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; kernel build {build_s:.3f} s; BVH builder native, "
          f"built in {native_s:.3f} s; ptxas: {regs}", flush=True)

    # ---- phase 2: kernel 1 vs its plain twin, 1M random rays ----
    phase_start["2"] = time.perf_counter()
    k1 = {}
    for name, lo, hi in (("rand_spheres", (-12, 0.05, -12), (12, 6, 12)),
                         ("cornell", (1, 1, 1), (554, 554, 554))):
        scene, _, _ = get_scene(name)
        sph, quad = scene_tables(scene.to("cuda"))
        o, d = (x.cuda() for x in random_rays(1 << 20, lo, hi, seed=7))
        k1[name] = check_hit(f"kernel 1 {name}", sph, quad, o, d)
    # The quad test on rays built for its every branch (origins on a plane,
    # |d.n| at QUAD_DENOM_EPS, t at T_MIN, back faces, in-quad coordinates
    # 0 and 1, NaN directions, ties; tests/adversarial_quads.py).
    sys.path.insert(0, str(REPO / "tests"))
    from adversarial_quads import adversarial_quad_rays

    table, o, d = (torch.from_numpy(x).cuda() for x in adversarial_quad_rays())
    dummy_sph = ik.pack_sphere_table(torch.zeros(1, 3), torch.zeros(1)).cuda()
    k1["adversarial_quads"] = check_hit("kernel 1 adversarial quads", dummy_sph, table, o, d)
    record["intersect"] = k1
    print(f"phase 2 kernel 1 vs plain, 2^20 rays, and {k1['adversarial_quads']['rays']} "
          f"adversarial quad rays: {json.dumps(k1)}", flush=True)
    # The split path: launches too small to fill the card, on rand_spheres'
    # table with its first rows repeated at its end (exact ties that fall
    # in different slices).
    sph, quad = scene_tables(get_scene("rand_spheres")[0].to("cuda"))
    sph = torch.cat([sph, sph[:SPLIT_REPEATED_ROWS]]).contiguous()
    k1_split = {}
    for n in SPLIT_RAYS:
        rows = ik.split_rows(n, sph.shape[0], ik.sm_count(0))
        if rows <= 0:
            fail(f"kernel 1: a {n}-ray launch over {sph.shape[0]} rows does not split")
        o, d = (x.cuda() for x in random_rays(n, (-12, 0.05, -12), (12, 6, 12), seed=n))
        k1_split[str(n)] = dict(check_hit(f"kernel 1 split, {n} rays", sph, quad, o, d),
                                slice_rows=rows, slices=-(-sph.shape[0] // rows))
    record["intersect_split"] = k1_split
    print(f"phase 2 kernel 1 split vs plain, {sph.shape[0]} sphere rows (the last "
          f"{SPLIT_REPEATED_ROWS} repeated): {json.dumps(k1_split)}", flush=True)

    # ---- phase 3: kernel 2 vs its plain twin, same seed and schedule ----
    phase_start["3"] = time.perf_counter()
    # Small scenes with several samples per lane, then the main path's own
    # kernel call: rand_spheres 400x225@500spp depth 50, its lanes, seed 0.
    k2 = {}
    for name in ("rand_spheres", "cornell"):
        scene, cam, settings = get_scene(name, width=96, spp=8, max_depth=10)
        kernel, plain, fold = persistent_pair(scene, cam, settings, 8192, seed=11)
        k2[name] = check_pair(name, kernel(), plain(), fold)
        k2[name]["size"] = [settings.width, settings.height]
    # The textured instantiation, every texture kind and image filter, at
    # the same shape and then at phase 10's CLI render shape, seed and
    # lanes (400x225, 100 spp, depth 50, seed 0): the very kernel call that
    # phase 10 makes. Log and segments bit-equal to the twin's. There the
    # twin also counts the marbles and image lookups per lane and per warp
    # under both loop schedules (texture_counts), the work of the bounds.
    k2_tex, k2_tex_cli = {}, {}
    for label, name, kw, stochastic, _ in TEXTURED_CASES:
        for out, shape, lanes, seed in ((k2_tex, dict(width=96, spp=8, max_depth=10), 8192, 11),
                                        (k2_tex_cli, {}, DEFAULT_WAVEFRONT, 0)):
            scene, cam, settings = get_scene(name, **{**kw, **shape})
            counts = out is k2_tex_cli
            kernel, plain, fold = persistent_pair(scene, cam, settings, lanes, seed=seed,
                                                  stochastic=stochastic, tex_work=counts)
            kernel_out, ms = timed(kernel)
            plain_out, plain_ms = timed(plain)
            out[label] = dict(check_pair(label, kernel_out, plain_out[:2], fold, exact=True),
                              ms=ms, plain_ms=plain_ms, size=[settings.width, settings.height],
                              spp=settings.samples_per_pixel, max_depth=settings.max_depth,
                              lanes=lanes)
            if counts:
                out[label].update(texture_counts(plain_out[2]))
            del kernel_out, plain_out
    print(f"phase 3t kernel 2 (textured) vs plain, 96x54@8spp depth 10 with 8192 lanes: "
          f"{json.dumps(k2_tex)}; at the CLI renders' 400x225@100spp depth 50 with "
          f"{DEFAULT_WAVEFRONT} lanes: {json.dumps(k2_tex_cli)}", flush=True)
    scene, cam, settings = get_scene("rand_spheres")
    kernel, plain, fold = persistent_pair(scene, cam, settings, DEFAULT_WAVEFRONT, seed=0)
    kernel_out = kernel()
    kernel_out_shape = tuple(kernel_out[0].shape[1:])  # (slots, lanes)
    plain_out, k2_plain_ms = timed(plain)
    main_shape = check_pair("main shape", kernel_out, plain_out, fold, exact=True)
    del kernel_out, plain_out
    k2_ms = time_cuda(kernel, reps=3)
    k2["main_shape"] = dict(main_shape, ms=k2_ms, plain_ms=k2_plain_ms,
                            size=[settings.width, settings.height], lanes=DEFAULT_WAVEFRONT,
                            ns=scene.num_spheres, nq=scene.num_quads,
                            log_bytes=3 * kernel_out_shape[0] * kernel_out_shape[1] * 4)
    print("phase 3 kernel 2 vs plain, 8 spp depth 10 with 8192 lanes, and 400x225@500spp "
          f"depth 50 with {DEFAULT_WAVEFRONT} lanes: {json.dumps(k2)}", flush=True)
    k2_cull = persistent_culled_check()
    k2_held = {label: held_culled(label, name, kw) for label, name, kw, _ in LARGE_CASES}
    record["persistent"] = dict(k2, textured=k2_tex, textured_cli_shape=k2_tex_cli,
                                culled=k2_cull, culled_render_shape=k2_held)
    print(f"phase 3c kernel 2 (culled) vs plain, log and segments, at {CULLED_SHAPE} with 8192 "
          f"lanes: {json.dumps(k2_cull)}; at the large renders' 400x225 depth 8 with "
          f"{DEFAULT_WAVEFRONT} lanes, {HELD_SPP} spp whole and the 64-spp call on the "
          f"{HELD_SPP}-spp samples: {json.dumps(k2_held)}; {smi}", flush=True)
    for label, h in k2_held.items():
        print(f"phase 3c {label} at {HELD_SPP} spp: kernel {h['ms']:.4f} ms, bound per lane "
              f"{h['bound_ms']:.4f} ms, warp-union {h['warp_bound_ms']:.4f} ms, warp-union SIMT "
              f"efficiency {h['simt_efficiency']:.4f}; 64 spp {h['render_call']['ms']:.3f} ms",
              flush=True)

    # ---- phase 4: render_image on CUDA against the golden statistics ----
    phase_start["4"] = time.perf_counter()
    golden = json.loads((REPO / "tests" / "golden_stats.json").read_text())
    g4, clamped_means = {}, {}
    for name in GOLDEN_SCENES + GOLDEN_NO_PROBES:
        scene, cam, settings = get_scene(name, **GOLDEN_CFG)
        before = pk.LAUNCHES
        img = render_image(scene, cam, settings, device="cuda", seed=GOLDEN_SEED)
        if pk.LAUNCHES == before:
            fail(f"golden {name}: rendered without kernel 2")
        img = img.cpu().numpy()
        if not np.isfinite(img).all():
            fail(f"golden {name}: non-finite pixels")
        got = check_golden(name, img, golden, probes=name not in GOLDEN_NO_PROBES)
        g4[name] = [round(m, 5) for m in got["mean"]]
        # The reference of phase 10's PNG means: PNGs clamp to [0, 1].
        clamped_means[name] = img.clip(0.0, 1.0).mean((0, 1))
    # earth with the real earthmap's 512x1024 texels, at its CLI shape
    # (bench.py's earth_hires_tex): finite, its mean near the golden's.
    scene, cam, settings = get_scene("earth", spp=100, tex_height=512, tex_width=1024)
    img, hires_ms = timed(lambda: render_image(scene, cam, settings, device="cuda", seed=1))
    hires_mean = img.mean((0, 1)).cpu().numpy()
    if not (np.isfinite(img.cpu().numpy()).all()
            and np.allclose(hires_mean, golden["earth"]["mean"], rtol=0.05)):
        fail(f"earth 512x1024 texels: mean {hires_mean} vs golden {golden['earth']['mean']}")
    g4["earth_hires_tex"] = dict(mean=hires_mean.round(5).tolist(), ms=hires_ms,
                                 size=[settings.width, settings.height], spp=100)
    print(f"phase 4 golden stats at {GOLDEN_CFG} seed {GOLDEN_SEED} ({GOLDEN_NO_PROBES} without "
          f"probes), and earth 512x1024 texels at 400x225@100spp: {json.dumps(g4)}", flush=True)

    # ---- phase 5: the main path, counted ----
    phase_start["5"] = time.perf_counter()
    out_png = OUT_DIR / "rand_spheres.png"
    ik.LAUNCHES = 0
    pk.LAUNCHES = 0
    torch.cuda.synchronize()
    report = cli.main(["--scene", "rand_spheres", "--out", str(out_png)])
    torch.cuda.synchronize()
    launches = {"closest_hit": ik.LAUNCHES, "persistent_render": pk.LAUNCHES}
    if launches["persistent_render"] <= 0:
        fail(f"main path launched persistent_render {launches['persistent_render']} times")
    if list(report["size"]) != [400, 225] or report["spp"] != 500 or report["max_depth"] != 50:
        fail(f"main path ran {report}")
    # Same scene, seed and schedule as phase 3's main-shape call: the same
    # deterministic kernel run.
    if report["traced_segments"] != main_shape["segments"]:
        fail(f"main path traced {report['traced_segments']} segments, "
             f"phase 3's kernel call {main_shape['segments']}")
    from PIL import Image

    png = np.asarray(Image.open(out_png).convert("RGB"))
    if png.shape != (225, 400, 3):
        fail(f"main path image shape {png.shape}")
    lin_mean = ((png.astype(np.float64) / 255.0) ** 2).mean((0, 1))
    want = np.asarray(golden["rand_spheres"]["mean"])
    if not np.allclose(lin_mean, want, rtol=0.05):
        fail(f"main path image mean {lin_mean} vs golden {want} (rtol 0.05)")
    print(f"phase 5 main path: {json.dumps(report)}; launches {json.dumps(launches)}; "
          f"linear mean {lin_mean.round(4).tolist()}", flush=True)

    # ---- phase 6: kernel 3 vs its plain twin ----
    phase_start["6"] = time.perf_counter()
    # A small cornell shape (quads, the emitter), then the training path's
    # own shape: rand_spheres 400x225, 8 spp, depth 50, one lane per sample.
    k3 = {}
    kernel, plain, _, _, _ = tape_pair("cornell", 7, width=64, spp=2, max_depth=12)
    k3["cornell"] = check_tape("cornell", kernel(thread_segments=True), plain())
    kernel, plain, n3, st3, scene3 = tape_pair("rand_spheres", 1234, **TRAIN_CFG)
    kernel_out = kernel(thread_segments=True)
    plain_out, k3_plain_ms = timed(plain)
    k3["train_shape"] = check_tape("train shape", kernel_out, plain_out)
    del kernel_out, plain_out
    k3_ms = time_cuda(kernel, reps=5)
    k3["train_shape"].update(ms=k3_ms, plain_ms=k3_plain_ms, size=[st3.width, st3.height],
                             spp=st3.samples_per_pixel, max_depth=st3.max_depth)
    # The textured instantiation at the training shape: earth with the
    # 4-tap filter, perlin's marble. Every hit is textured in both scenes,
    # so the tape's hit entries count the lookups and marbles.
    k3_tex = {}
    for label, name, kw in (("earth_bilinear", "earth", {"bilinear": True}),
                            ("perlin", "perlin", {})):
        kernel, plain, n_t, st_t, scene_t = tape_pair(name, 1234, **TRAIN_CFG, **kw)
        kernel_out = kernel(thread_segments=True)
        plain_out, plain_ms = timed(plain)
        k3_tex[label] = check_tape(label, kernel_out, plain_out)
        k3_tex[label].update(ms=time_cuda(kernel, reps=5), plain_ms=plain_ms,
                          textured_hits=int((kernel_out[1] >= 0).sum()),
                          ns=scene_t.num_spheres, nq=scene_t.num_quads)
        del kernel_out, plain_out
    record["tape"] = dict(k3, textured=k3_tex)
    print(f"phase 6 kernel 3 vs plain, cornell 64x64@2spp depth 12 and rand_spheres "
          f"400x225@8spp depth 50 ({n3} samples): warp occupancy under the sample queue "
          f"{k3['train_shape']['warp_occupancy']:.4f} ({k3['train_shape']['threads']} threads; "
          f"one sample per thread would give "
          f"{k3['train_shape']['one_sample_per_thread_occupancy']:.4f}), {k3_ms:.3f} ms; "
          f"{json.dumps(k3)}; textured, earth (4-tap) and perlin at 400x225@8spp depth 50: "
          f"{json.dumps(k3_tex)}; {smi}", flush=True)

    # ---- phase 7: the training path, counted ----
    phase_start["7"] = time.perf_counter()
    from raytracer_tpu_torch.diff.grad import make_inverse_renderer, render_linear_diff

    step_7a = step_check()
    print(f"phase 7a tape-forward step at 64x36@2spp depth 8, kernel 3 vs its twin on CUDA "
          f"and CUDA vs CPU (held on the mixed scene, reported on rand_spheres): "
          f"{json.dumps(step_7a)}", flush=True)
    scene, cam, st = get_scene("rand_spheres", **TRAIN_CFG)
    train_kw = dict(width=st.width, height=st.height, samples_per_pass=st.samples_per_pixel,
                    max_depth=st.max_depth, learning_rate=1e-2, device="cuda")
    with torch.no_grad():
        target = render_linear_diff(scene.to("cuda"), cam, 7, width=st.width, height=st.height,
                                    samples_per_pass=st.samples_per_pixel,
                                    max_depth=st.max_depth)
    start = dataclasses.replace(scene, tex_c0=scene.tex_c0 * 0.5)
    params, _, step = make_inverse_renderer(start, cam, target, backend="bucketed", **train_kw)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    ik.LAUNCHES = 0
    pk.LAUNCHES = 0
    pk.LAUNCHES_TAPE = 0
    torch.cuda.synchronize()
    for seed in TRAIN_SEEDS:
        timings = {}
        t0 = time.perf_counter()
        loss = float(step(seed, timings))  # the step's phases end in device syncs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grads_ok = all(bool(torch.isfinite(p.grad).all()) for p in params.values())
        if not (math.isfinite(loss) and grads_ok):
            fail(f"training step {seed}: loss {loss}, finite grads {grads_ok}")
        steps.append(dict(loss=loss, wall_s=wall, **{k: v for k, v in timings.items()}))
    launches_train = {"closest_hit": ik.LAUNCHES, "persistent_render": pk.LAUNCHES,
                      "persistent_tape": pk.LAUNCHES_TAPE}
    if launches_train["persistent_tape"] != len(TRAIN_SEEDS):
        fail(f"training path launched the tape kernel {launches_train['persistent_tape']} "
             f"times in {len(TRAIN_SEEDS)} steps")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for i, s_ in enumerate(steps):
        print(f"phase 7 step {i}: loss {s_['loss']:.6g}, wall {s_['wall_s']:.4f} s = tape forward "
              f"{s_['tape_forward']:.4f} + loss/cotangent {s_['loss_cotangent']:.4f} + replay "
              f"forward {s_['replay_forward']:.4f} + backward {s_['backward']:.4f} + optimizer "
              f"{s_['optimizer']:.4f} s; {smi}", flush=True)
    params_s, _, step_s = make_inverse_renderer(start, cam, target, backend="scan", **train_kw)
    ik.LAUNCHES = 0
    torch.cuda.synchronize()
    scan_t = {}
    with HitRecorder(ik) as hits:
        t0 = time.perf_counter()
        scan_loss = float(step_s(TRAIN_SEEDS[0], scan_t))
        torch.cuda.synchronize()
        scan_t["wall_s"] = time.perf_counter() - t0
    launches_scan = ik.LAUNCHES
    if launches_scan <= 0:
        fail("the scan backend's step launched no closest-hit kernel")
    if not (math.isfinite(scan_loss)
            and all(bool(torch.isfinite(p.grad).all()) for p in params_s.values())):
        fail(f"scan step: loss {scan_loss} or its gradients not finite")
    # Same estimator and uniforms; the scan's winner t is recomputed in
    # expanded form, so a rare path may round onto another winner.
    if abs(scan_loss - steps[0]["loss"]) > 1e-2 * abs(steps[0]["loss"]):
        fail(f"scan loss {scan_loss} vs bucketed {steps[0]['loss']} from the same start and seed")
    # Kernel 1 against its twin on the scan step's own inputs, phase 2's
    # limits: bounce 0's camera rays, and a later bounce's compacted rays.
    if len(hits.kept) < 2:
        fail(f"scan step: no bounce after the first left a partial block ({hits.counts})")
    k1_path = {}
    for i in hits.kept:
        k1_path[f"bounce_{i}"] = check_hit(f"kernel 1 on the scan step's bounce {i}",
                                           *hits.calls[i])
    # Every launch of the step at its own (compacted) ray count.
    k1_scan = hits.timed_sum()
    del hits.calls
    train = dict(steps=steps, launches=launches_train, peak_gb=peak_gb, scan_loss=scan_loss,
                 scan_timings=scan_t, scan_closest_hit_launches=launches_scan,
                 scan_rays_per_bounce=hits.counts, closest_hit_on_path=k1_path,
                 closest_hit_scan_step=k1_scan)
    record["train"] = train
    print(f"phase 7 training path: 5 bucketed steps at 400x225@8spp depth 50, launches "
          f"{json.dumps(launches_train)}, peak {peak_gb:.2f} GiB; scan step {json.dumps(scan_t)}, "
          f"loss {scan_loss:.6g} (bucketed {steps[0]['loss']:.6g}), closest-hit launches "
          f"{launches_scan}; kernel 1 vs plain on the step's own rays {json.dumps(k1_path)}; "
          f"kernel 1 at each launch's own rays, summed {json.dumps(k1_scan)}", flush=True)

    # ---- phase 7t: the training path on textured scenes, counted ----
    phase_start["7t"] = time.perf_counter()
    # Five bucketed steps on earth (4-tap bilinear) from a sphere 5% too
    # large, then one on perlin at depth PERLIN_STEP_DEPTH; the tape
    # kernel's textured instantiation is each step's forward.
    train_t = {}
    for label, name, kw, n_steps in (
            ("earth_bilinear", "earth", {"bilinear": True}, 5),
            ("perlin", "perlin", {"max_depth": PERLIN_STEP_DEPTH}, 1)):
        scene, cam, st = get_scene(name, **{**TRAIN_CFG, **kw})
        with torch.no_grad():
            target = render_linear_diff(scene.to("cuda"), cam, 7, width=st.width,
                                        height=st.height, samples_per_pass=st.samples_per_pixel,
                                        max_depth=st.max_depth)
        start = dataclasses.replace(scene, sph_radius=scene.sph_radius * 1.05)
        params, _, step = make_inverse_renderer(start, cam, target, backend="bucketed",
                                                **{**train_kw, "max_depth": st.max_depth})
        pk.LAUNCHES_TAPE = 0
        torch.cuda.synchronize()
        steps_t = []
        for seed in TRAIN_SEEDS[:n_steps]:
            timings = {}
            t0 = time.perf_counter()
            loss = float(step(seed, timings))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not (math.isfinite(loss)
                    and all(bool(torch.isfinite(p.grad).all()) for p in params.values())):
                fail(f"{label} training step {seed}: loss {loss} or its gradients not finite")
            steps_t.append(dict(loss=loss, wall_s=wall, **timings))
        if pk.LAUNCHES_TAPE != n_steps:
            fail(f"{label}: the tape kernel launched {pk.LAUNCHES_TAPE} times in {n_steps} steps")
        if float(params["sph_radius"].grad.abs().max()) <= 0:
            fail(f"{label}: no radius gradient")
        train_t[label] = dict(steps=steps_t, tape_launches=pk.LAUNCHES_TAPE)
    record["train_textured"] = train_t
    for label, rec_t in train_t.items():
        for i, s_ in enumerate(rec_t["steps"]):
            print(f"phase 7t {label} step {i}: loss {s_['loss']:.6g}, wall {s_['wall_s']:.4f} s = "
                  f"tape forward {s_['tape_forward']:.4f} + loss/cotangent "
                  f"{s_['loss_cotangent']:.4f} + replay forward {s_['replay_forward']:.4f} + "
                  f"backward {s_['backward']:.4f} + optimizer {s_['optimizer']:.4f} s; "
                  f"tape launches {rec_t['tape_launches']}", flush=True)

    # ---- phase 8: kernel 5 vs its twin; the wavefront-step path vs kernel 2 ----
    phase_start["8"] = time.perf_counter()
    from raytracer_tpu_torch.ops import culled_kernel as ck
    from raytracer_tpu_torch.ops import gather_kernel as gk
    from raytracer_tpu_torch.ops import replay_kernel as rk
    from raytracer_tpu_torch.ops import wavefront_kernel as wk

    k5 = step_kernel_check()
    k5["vs_kernel_2"] = step_vs_persistent("rand_spheres")
    k5["vs_kernel_2_perlin"] = step_vs_persistent("perlin")
    record["wavefront_step"] = k5
    print(f"phase 8 kernel 5 vs plain at perlin's path shape (first and sixth iteration), "
          f"and the wavefront-step path vs kernel 2 on rand_spheres and on perlin (textured) "
          f"96x54@8spp depth 10 (rr_hi 0.75): {json.dumps(k5)}", flush=True)

    # ---- phase 9: kernel 4 vs its twin and kernel 1 ----
    phase_start["9"] = time.perf_counter()
    k4 = culled_check()
    record["culled"] = k4
    print(f"phase 9 kernel 4 vs plain and kernel 1 on rand_spheres_large's first-pass camera "
          f"rays, two-level table: {json.dumps(k4)}", flush=True)

    # ---- phase 10: the wavefront-step, culled, large-scene and textured paths, counted ----
    phase_start["10"] = time.perf_counter()
    from raytracer_tpu_torch.utils.metrics import RenderMetrics

    counters = (("closest_hit", ik, "LAUNCHES"), ("closest_hit_clustered", ik, "LAUNCHES_CLUSTERED"),
                ("persistent_render", pk, "LAUNCHES"),
                ("persistent_tape", pk, "LAUNCHES_TAPE"), ("culled", ck, "LAUNCHES"),
                ("wavefront_step", wk, "LAUNCHES"), ("table_gather", gk, "LAUNCHES"),
                ("replay_path", rk, "LAUNCHES"), ("replay_adjoint", rk, "LAUNCHES_ADJOINT"))

    def counted(fn):
        """(fn(), launches of every kernel during it), the counts zeroed
        just before and read just after."""
        for _, mod, attr in counters:
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        return out, {name: getattr(mod, attr) for name, mod, attr in counters}

    def check_launches(label, counts, want):
        if any(counts[k] <= 0 for k in want) or any(
                v for k, v in counts.items() if k not in want):
            fail(f"{label}: launches {counts}, expected only {want}")

    paths = {}
    # The wavefront-step path: perlin with rng-filled Perlin tables, which
    # kernel 2 does not serve (the JAX driver too renders it off its
    # persistent kernel), through render_image at its CLI shape.
    scene, cam, st = get_scene("perlin", procedural_perlin=False)
    metrics = RenderMetrics(total_spp=st.samples_per_pixel, pixels=st.width * st.height)
    t0 = time.perf_counter()
    img, counts = counted(lambda: render_image(scene, cam, st, device="cuda", seed=0,
                                               metrics=metrics))
    wall = time.perf_counter() - t0
    check_launches("rng-table perlin", counts, ("wavefront_step",))
    lin_mean = img.clamp(0.0, 1.0).mean((0, 1)).cpu().numpy()
    if render_path(scene) != "wavefront_step" or not np.allclose(
            lin_mean, clamped_means["perlin"], rtol=0.05):
        fail(f"rng-table perlin: path {render_path(scene)}, mean {lin_mean} vs "
             f"{clamped_means['perlin']}")
    paths["wavefront_step"] = dict(report=dict(metrics.snapshot(), wall_s=wall,
                                               path=render_path(scene)),
                                   launches=counts, linear_mean=lin_mean.round(4).tolist())
    print(f"phase 10 wavefront_step path, rng-table perlin 400x225@100spp depth 50 via "
          f"render_image: {json.dumps(paths['wavefront_step'])}", flush=True)

    # The persistent path on large scenes: each render clustered on the
    # host and rendered in one launch of kernel 2's culled instantiation;
    # its mean against a small CPU render through the twins, its segments
    # those of its own kernel call, which phase 3c held against the twin.
    large = {}
    for label, name, kw, argv in LARGE_CASES:
        ref = cpu_reference(name, width=32 if kw else 48, **kw)
        scene, cam, st = get_scene(name, spp=64, **kw)
        with PersistentTimer(pk) as timer:
            if argv:
                out_png = OUT_DIR / f"{label}.png"
                rep, counts = counted(lambda: cli.main(argv + ["--out", str(out_png)]))
                shape, lin_mean = png_linear_mean(out_png)
            else:
                metrics = RenderMetrics(total_spp=st.samples_per_pixel,
                                        pixels=st.width * st.height)
                t0 = time.perf_counter()
                img, counts = counted(lambda: render_image(scene, cam, st, device="cuda",
                                                           seed=0, metrics=metrics))
                rep = dict(metrics.snapshot(), wall_s=time.perf_counter() - t0,
                           path=render_path(scene), size=[st.width, st.height],
                           spp=st.samples_per_pixel, max_depth=st.max_depth)
                shape = tuple(img.shape)
                lin_mean = img.clamp(0.0, 1.0).mean((0, 1)).cpu().numpy()
        kernel_ms = timer.ms()
        check_launches(label, counts, ("persistent_render",))
        held = k2_held[label]["render_call"]
        if (rep["path"] != "persistent" or counts["persistent_render"] != 1
                or shape != (225, 400, 3) or rep["traced_segments"] != held["segments"]
                or rep.get("bvh_builder") != "native"
                or not np.allclose(lin_mean, ref, rtol=0.05)):
            fail(f"{label}: {rep}; launches {counts}; image {shape}, linear mean {lin_mean} vs "
                 f"the CPU twins' {ref}; phase 3c's 64-spp kernel call traced "
                 f"{held['segments']} segments")
        large[label] = dict(report=rep, launches=counts, kernel_ms=kernel_ms,
                            linear_mean=np.asarray(lin_mean).round(4).tolist(),
                            reference_mean=np.asarray(ref).round(4).tolist())
        print(f"phase 10 persistent path (culled), {label} 400x225@64spp depth 8 via "
              f"{'the CLI' if argv else 'render_image'}: {json.dumps(rep)}; launches "
              f"{json.dumps(counts)}; kernel 2 {kernel_ms:.3f} ms by CUDA events; linear mean "
              f"{np.asarray(lin_mean).round(4).tolist()} vs "
              f"{np.asarray(ref).round(4).tolist()}; {smi}", flush=True)
    paths["persistent_culled"] = large

    # The large-scene path (kernel 4, kernel 1 clustered), which render_path
    # keeps for scenes kernel 2 does not serve, on rand_spheres_large at the
    # same shape and seed: an A/B against the persistent render's mean.
    # Its first render clusters the scene cold; the second finds the
    # clustering cached.
    from raytracer_tpu_torch.render.driver import _render_large_scene

    scene, cam, st = get_scene("rand_spheres_large", spp=64)
    scene = scene.to("cuda")
    reports = []
    for cached in (False, True):
        metrics = RenderMetrics(total_spp=st.samples_per_pixel, pixels=st.width * st.height)
        recorder = ClusteredRecorder(ik) if cached else contextlib.nullcontext()
        t0 = time.perf_counter()
        with recorder:
            img, counts = counted(lambda: _render_large_scene(scene, cam, st, seed=0,
                                                              metrics=metrics))
        reports.append(dict(metrics.snapshot(), wall_s=time.perf_counter() - t0))
        check_launches("large-scene path", counts, ("culled", "closest_hit_clustered"))
    large_hits = recorder
    # Kernel 1's clustered bounce launches: each against its twin, and timed
    # at its own ray count.
    k1_large = large_hits.held_and_timed()
    del large_hits.calls
    lin_mean = img.clamp(0.0, 1.0).mean((0, 1)).cpu().numpy()
    want = np.asarray(large["rand_spheres_large"]["linear_mean"])
    if not np.allclose(lin_mean, want, rtol=0.05):
        fail(f"large-scene path: mean {lin_mean} vs the persistent render's {want}")
    paths["large_scene"] = dict(report=reports[1], report_cold=reports[0], launches=counts,
                                linear_mean=lin_mean.round(4).tolist(),
                                persistent_mean=want.tolist(), closest_hit_clustered=k1_large)
    print(f"phase 10 large_scene path, _render_large_scene on rand_spheres_large 400x225@64spp "
          f"depth 8: {json.dumps(paths['large_scene'])}", flush=True)

    # The slice's CLI renders at 400x225, 100 spp, depth 50, each through
    # kernel 2's textured instantiation in one launch: the kernel call that
    # phase 3t held bit-equal to its twin (the same segments), the PNG's
    # mean against phase 4's clamped mean of the same scene.
    textured = {}
    for label, ref, _, _, argv in TEXTURED_CASES:
        out_png = OUT_DIR / f"{label}.png"
        with PersistentTimer(pk) as timer:
            rep, counts = counted(lambda: cli.main(argv + ["--out", str(out_png)]))
        check_launches(label, counts, ("persistent_render",))
        shape, lin_mean = png_linear_mean(out_png)
        if (rep["path"] != "persistent" or [rep["size"], rep["spp"], rep["max_depth"]] != [
                [400, 225], 100, 50] or shape != (225, 400, 3)
                or rep["traced_segments"] != k2_tex_cli[label]["segments"]
                or not np.allclose(lin_mean, clamped_means[ref], rtol=0.05)):
            fail(f"{label}: {rep}; image {shape}, linear mean {lin_mean} vs "
                 f"{clamped_means[ref]}; phase 3t's kernel call traced "
                 f"{k2_tex_cli[label]['segments']} segments")
        textured[label] = dict(report=rep, launches=counts, kernel_ms=timer.ms(),
                               linear_mean=lin_mean.round(4).tolist(),
                               reference_mean=clamped_means[ref].round(4).tolist())
        print(f"phase 10 persistent path (textured), {' '.join(argv)}: {json.dumps(rep)}; "
              f"launches {json.dumps(counts)}; kernel 2 {textured[label]['kernel_ms']:.3f} ms by "
              f"CUDA events; linear mean {lin_mean.round(4).tolist()} vs "
              f"{clamped_means[ref].round(4).tolist()}", flush=True)
    paths["textured"] = textured
    record["paths"] = paths

    # ---- phase 11: checkpoint and resume on the main path, counted ----
    phase_start["11"] = time.perf_counter()
    ckpt_rec = checkpoint_phase(cli, smi)
    record["checkpoint"] = ckpt_rec
    print(f"phase 11 checkpoint and resume, rand_spheres 400x225@500spp depth 50 in chunks of "
          f"{CHECKPOINT_CHUNK}: {json.dumps(ckpt_rec)}; {smi}", flush=True)

    # ---- phase 12: the boundary term on the training path, counted ----
    phase_start["12"] = time.perf_counter()
    bnd = boundary_phase(train_kw, smi)
    record["boundary"] = bnd

    # ---- phase 13: the CLI's profiling flags ----
    phase_start["13"] = time.perf_counter()
    prof = profile_phase(cli)
    record["profile"] = prof
    print(f"phase 13 the CLI with --profile --memory-profile, rand_spheres 400x225@500spp "
          f"depth 50: {json.dumps(prof)}; {smi}", flush=True)

    # ---- phase 14: the full-gradient step (grad_full), counted ----
    phase_start["14"] = time.perf_counter()
    full = grad_full_phase(train_kw, smi)
    record["grad_full"] = full

    # ---- phase 15: the mirror, refracted and shadow terms; the camera ----
    phase_start["15"] = time.perf_counter()
    record["other_edges"] = other_edges_phase(train_kw, smi)

    # ---- phase 16: the distributed paths (NCCL at one rank, gloo at two) ----
    phase_start["16"] = time.perf_counter()
    dist_rec = distribution_phase(cli, smi, counted, check_launches,
                                  OUT_DIR / "rand_spheres.png")
    record["distribution"] = dist_rec
    gloo0 = dist_rec["gloo_world2"]["ranks"][0]

    # ---- phase 17: the bench and the estimator self-check ----
    phase_start["17"] = time.perf_counter()
    record["entry_points"] = entry_points_phase(smi)

    # ---- phase 18: large images, the retirement-log fold ----
    phase_start["18"] = time.perf_counter()
    large_img = large_image_phase(cli, smi)
    record["large_images"] = large_img

    # ---- phase 19: the bucketed step on rng-table scenes, counted ----
    phase_start["19"] = time.perf_counter()
    rng_rec = rng_tape_phase(smi, counted, check_launches)
    record["rng_table_step"] = rng_rec

    # ---- phase 20: the table gather's backward ----
    phase_start["20"] = time.perf_counter()
    gather_rec = gather_phase(smi)
    record["table_gather"] = gather_rec

    # ---- phase 21: the replay kernels ----
    phase_start["21"] = time.perf_counter()
    replay_rec = replay_phase(smi, counted, check_launches)
    record["replay"] = replay_rec

    k1r, k2m, k3t = k1_path["bounce_0"], k2["main_shape"], k3["train_shape"]
    b2 = bound(hit_ops(k2m["segments"], k2m["ns"], k2m["nq"]),
               k2m["log_bytes"] + 16 * DEFAULT_WAVEFRONT)
    b3 = bound(hit_ops(k3t["segments"], scene3.num_spheres, scene3.num_quads),
               n3 * (12 + 4 * st3.max_depth + 4))
    # Kernel 4 with perfect per-lane culling on its two-level table (the
    # twin's counts on phase 9's rays; warp-union and the flat table's
    # beside it).
    k4w = k4["work"]
    k5s = k5["iteration_0"]
    b5 = bound(hit_ops(k5s["live"], k5["ns"], k5["nq"]), k5s["lanes"] * STEP_LANE_BYTES)
    # Kernel 2 textured, at each CLI render: the closest hit of every
    # segment, and the marbles and image lookups that the twin counted on
    # the same call (phase 3t); each bound at the kept marble's operations
    # (MARBLE_OPS) and at the parent's hash (MARBLE_OPS_HASH).
    k2_textured = {}
    for label, t in textured.items():
        rep_t, held_t = t["report"], k2_tex_cli[label]
        sc = get_scene(label.split("_bilinear")[0])[0]
        per_lookup = IMAGE_OPS[{"earth": "nearest", "earth_bilinear": "stochastic"}.get(
            label, "bilinear")]
        nbytes = (rep_t["retirement_log_mb"] * 2**20 + 16 * rep_t["wavefront_lanes"]
                  + sc.images.numel() * 4)
        b, b_hash = (bound(hit_ops(rep_t["traced_segments"], sc.num_spheres, sc.num_quads)
                           + held_t["marble_hits"] * ops + held_t["image_lookups"] * per_lookup,
                           nbytes) for ops in (MARBLE_OPS, MARBLE_OPS_HASH))
        k2_textured[label] = dict(launches=t["launches"]["persistent_render"],
                                  ms=t["kernel_ms"], plain_ms=held_t["plain_ms"],
                                  wall_s=rep_t["wall_s"],
                                  segments=rep_t["traced_segments"],
                                  warp_occupancy=rep_t["warp_occupancy"], bound_ms=b[0],
                                  bound_by=b[1], bound_ms_hash_marble=b_hash[0],
                                  **{k: held_t[k] for k in (
                                      "marble_hits", "image_lookups", "marble_simt_efficiency",
                                      "marble_simt_efficiency_retrace", "image_simt_efficiency",
                                      "image_simt_efficiency_retrace", "warp_trips",
                                      "warp_trips_retrace")},
                                  bound_counts=(
                                      f"closest hit + {MARBLE_OPS} ops x marbles + {per_lookup} "
                                      "ops x image lookups, counted by the twin on this call"))
    # Kernel 3 textured: the tape's hit entries count the textured hits
    # (every primitive of both scenes is textured). Its threads take samples
    # from a queue in an order the run does not record, so no warp-union
    # count is made.
    k3_textured = {}
    for label, t in k3_tex.items():
        marbles = t["textured_hits"] if label == "perlin" else 0
        lookups = t["textured_hits"] - marbles
        b, b_hash = (bound(hit_ops(t["segments"], t["ns"], t["nq"]) + marbles * ops
                           + lookups * IMAGE_OPS["bilinear"],
                           t["lanes"] * (12 + 4 * TRAIN_CFG["max_depth"] + 4))
                     for ops in (MARBLE_OPS, MARBLE_OPS_HASH))
        k3_textured[label] = dict(
            {k: t[k] for k in ("ms", "plain_ms", "tape_equal", "lanes_equal", "segments",
                               "warp_occupancy", "textured_hits")},
            marble_hits=marbles, image_lookups=lookups, marble_simt_efficiency=None,
            bound_ms=b[0], bound_by=b[1], bound_ms_hash_marble=b_hash[0],
            launches_in_training=train_t.get(label, {}).get("tape_launches"))
    # Kernel 2 culled, at each large render: ms, twin ms and bounds at
    # phase 3c's call of the render's shape at HELD_SPP (per lane and per
    # warp, from the twin's work counts there), the dense loops' ms on the
    # same call, and the render's own launches, kernel ms by CUDA events
    # and wall.
    k2_culled = {}
    for label, t in large.items():
        h = k2_held[label]
        k2_culled[label] = dict(
            shape=f"400x225@{h['spp']}spp depth 8, {h['lanes']} lanes, {h['ns']} spheres, "
                  f"{h['nq']} quads, cluster rows {h['cluster_rows']}",
            ms=h["ms"], plain_ms=h["plain_ms"], dense_ms=h["dense_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], warp_bound_ms=h["warp_bound_ms"],
            simt_efficiency=h["simt_efficiency"], segments=h["segments"],
            warp_occupancy=h["warp_occupancy"],
            slab_tests=h["slab_tests"], sphere_tests=h["sphere_tests"],
            quad_tests=h["quad_tests"], launches=t["launches"]["persistent_render"],
            render_shape="400x225@64spp depth 8", render_ms=t["kernel_ms"],
            render_call_ms=h["render_call"]["ms"], render_segments=t["report"]["traced_segments"],
            render_warp_occupancy=t["report"]["warp_occupancy"], wall_s=t["report"]["wall_s"],
            cluster_s=t["report"]["cluster_s"], bvh_builder=t["report"]["bvh_builder"])
    kernels = [
        {
            "name": "closest_hit",
            "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/intersect_kernel.cu",
            "replaces": "raytracer_tpu/ops/intersect_kernel.py:115",
            "launches": launches_scan,
            "on_main_path": True,
            "path": "training, scan backend (one step, phase 7)",
            "max_abs_err": max(v["t_max_abs"] for v in (*k1.values(), *k1_path.values(),
                                                         *k1_split.values())),
            "ms": k1_scan["ms"],
            "plain_ms": k1_scan["plain_ms"],
            "bound_ms": k1_scan["bound_ms"],
            "bound_by": k1_scan["bound_by"],
            "library_ms": None,
            "shape": f"the scan step's {k1_scan['launches']} launches at their own ray counts "
                     f"({k1_scan['rays']} rays in all, {k1r['rays']} camera rays at bounce 0) x "
                     f"rand_spheres ({k1r['ns']} spheres, {k1r['nq']} quad); ms, plain_ms and "
                     "bound_ms summed over the launches",
            "bounce_0": {k: k1r[k] for k in ("rays", "ms", "plain_ms")},
            "split": {n: {k: v[k] for k in ("ms", "plain_ms", "slice_rows", "slices")}
                      for n, v in k1_split.items()},
            "edge_term": {k: bnd["closest_hit_edges"][k] for k in (
                "launches", "rays", "ms", "plain_ms", "bound_ms", "bound_by",
                "launches_in_all_steps", "camera_rays_per_trace")},
            "edge_term_path": f"training, bucketed backend with boundary=True: the edge traces "
                              f"of one step (phase 12), {BOUNDARY_STEPS} steps",
            "grad_full": dict(full["closest_hit"], launches_in_all_steps=full["launches"][
                "closest_hit"]),
            "grad_full_path": f"training, grad_full (boundary and shadow_edges, phase 14): the "
                              f"first of {GRAD_FULL_STEPS} counted steps, by term",
            "launches_rng_table_step": [s_["launches"]["closest_hit"]
                                        for s_ in rng_rec["steps"]["rng"]],
            "rng_table_tape_forward": rng_rec["tape_forward"]["closest_hit"],
            "rng_table_path": f"training, bucketed backend on rng-table perlin 400x225@8spp "
                              f"depth {PERLIN_STEP_DEPTH}: the tape forward "
                              f"(integrator/wavefront.py:trace_tape_scene) of each step "
                              f"(phase 19); rng_table_tape_forward summed over step 0's calls",
        },
        {
            "name": "closest_hit_clustered",
            "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/intersect_kernel.cu",
            "replaces": "raytracer_tpu/ops/intersect_kernel.py:115",
            "launches": paths["large_scene"]["launches"]["closest_hit_clustered"],
            "on_main_path": True,
            "path": "render, large-scene path: _render_large_scene's bounce rays on "
                    "rand_spheres_large (phase 10)",
            "max_abs_err": k1_large["max_abs"],
            "ms": k1_large["ms"],
            "plain_ms": k1_large["plain_ms"],
            "bound_ms": k1_large["bound_ms"],
            "bound_by": k1_large["bound_by"],
            "library_ms": None,
            "shape": f"the render's {k1_large['launches']} bounce launches at their own ray "
                     f"counts ({k1_large['rays']} rays in all) x rand_spheres_large clustered "
                     "(two-level table, per-lane walk); ms, plain_ms and bounds summed over the "
                     "launches, bound_ms with perfect per-lane culling",
            "warp_bound_ms": k1_large["warp_bound_ms"],
            "dense_bound_ms": k1_large["dense_bound_ms"],
            "simt_efficiency": k1_large["simt_efficiency"],
        },
        {
            "name": "persistent_render",
            "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/persistent_kernel.cu",
            "replaces": "raytracer_tpu/ops/persistent_kernel.py:1214",
            "launches": launches["persistent_render"],
            "on_main_path": True,
            "path": "render, the CLI (phase 5); culled: the CLI on rand_spheres_large and "
                    "quad_field, render_image on its 50,001-sphere variant (phase 10); "
                    "textured: the CLI on perlin, earth (nearest, "
                    "stochastic, 4-tap) and simple_light (phase 10)",
            "max_abs_err": max(v["max_abs"] for v in (*k2.values(), *k2_tex.values(),
                                                      *k2_tex_cli.values(), *k2_cull.values(),
                                                      *k2_held.values())),
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": b2[0],
            "bound_by": b2[1],
            "library_ms": None,
            "shape": f"rand_spheres 400x225@500spp depth 50, {DEFAULT_WAVEFRONT} lanes",
            "textured": k2_textured,
            "culled": k2_culled,
            "checkpointed": {k: ckpt_rec[k] for k in ("launches", "walls_in_turns",
                                                       "saver_s_per_save")},
            "launches_3840x2160": large_img["persistent_3840x2160"]["launches"],
        },
        {
            "name": "persistent_tape",
            "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/persistent_kernel.cu",
            "replaces": "raytracer_tpu/ops/persistent_kernel.py:1403",
            "launches": launches_train["persistent_tape"],
            "on_main_path": True,
            "path": "training, bucketed backend (five steps, phase 7); textured: five steps on "
                    "earth (4-tap), one on perlin at depth 8 (phase 7t)",
            "max_abs_err": max(v["max_abs"] for v in (*k3.values(), *k3_tex.values())),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": b3[0],
            "bound_by": b3[1],
            "library_ms": None,
            "shape": f"rand_spheres 400x225@8spp depth 50, {n3} samples from the queue",
            "warp_occupancy": k3t["warp_occupancy"],
            "textured": k3_textured,
            "launches_in_boundary_steps": bnd["launches"]["persistent_tape"],
            "launches_in_grad_full_steps": full["launches"]["persistent_tape"],
            "launches_in_rng_table_steps": [s_["launches"]["persistent_tape"]
                                            for s_ in rng_rec["steps"]["rng"]],
        },
        {
            "name": "culled_closest_hit",
            "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/culled_kernel.cu",
            "replaces": "raytracer_tpu/ops/culled_kernel.py:255",
            "launches": paths["large_scene"]["launches"]["culled"],
            "on_main_path": True,
            "path": "render, large-scene path: _render_large_scene on rand_spheres_large "
                    "(phase 10, the A/B against the persistent path)",
            "max_abs_err": max(v["max_abs"] for k_, v in k4.items() if k_.startswith("vs_")),
            "ms": k4["ms"],
            "plain_ms": k4["plain_ms"],
            "bound_ms": k4w["two_level"]["bound_ms"],
            "bound_by": k4w["two_level"]["bound_by"],
            "library_ms": None,
            "shape": f"{k4['rays']} first-pass camera rays x rand_spheres_large ({k4['ns']} "
                     f"spheres, {k4['nq']} quad) on its two-level table (rows "
                     f"{k4['cluster_rows']}), warp vote; bound_ms with perfect per-lane culling",
            "warp_bound_ms": k4w["two_level"]["warp_bound_ms"],
            "flat_table_bound_ms": k4w["flat"]["bound_ms"],
            "flat_table_warp_bound_ms": k4w["flat"]["warp_bound_ms"],
            "dense_bound_ms": k4["dense_bound_ms"],
        },
        {
            "name": "wavefront_step",
            "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/wavefront_kernel.cu",
            "replaces": "raytracer_tpu/ops/wavefront_kernel.py:197",
            "launches": paths["wavefront_step"]["launches"]["wavefront_step"],
            "on_main_path": True,
            "path": "render, wavefront-step path: perlin with rng-filled Perlin tables through "
                    "render_image (phase 10)",
            "max_abs_err": max(v["max_abs"] for k_, v in k5.items() if k_.startswith("iteration")),
            "ms": k5s["ms"],
            "plain_ms": k5s["plain_ms"],
            "bound_ms": b5[0],
            "bound_by": b5[1],
            "library_ms": None,
            "shape": f"perlin 400x225@100spp first iteration, {k5s['lanes']} lanes "
                     f"({k5['ns']} spheres, {k5['nq']} quad)",
            "launches_3840x2160": large_img["wavefront_step_3840x2160"]["launches"],
        },
        {
            "name": "table_gather",
            "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/gather_kernel.cu",
            "replaces": None,
            "launches": replay_rec["step_launches"]["table_gather"],
            "on_main_path": True,
            "path": "training, bucketed backend: the sum of the replay kernels' lane-bounce "
                    "rows into the tables (ops/replay_kernel.py:reduce_rows) in one step at "
                    "400x225@8spp depth 50 (phase 21)",
            "max_abs_err": max(replay_rec["reduction"]["max_abs_err"],
                               *(v["max_abs_err"] for v in gather_rec["shapes"].values())),
            "ms": replay_rec["kernels"]["reduce_ms"],
            "plain_ms": None,
            "bound_ms": replay_rec["kernels"]["bound_ms"]["reduce"],
            "bound_by": replay_rec["kernels"]["bound_by"]["reduce"],
            "library_ms": None,
            "shape": f"{replay_rec['shape']['scratch_rows']} rows of {rk.ROW_COLS} columns "
                     f"into the {replay_rec['shape']['table_rows']}-row table",
            "cell_shapes": gather_rec["shapes"],
            "eager_path": {
                "path": "textured scenes' eager replay: the backward of its table reads in "
                        "one step at 400x225@8spp depth 50 on rand_spheres run eagerly "
                        "(phase 20)",
                "launches": gather_rec["step"]["launches"],
                "ms": gather_rec["step"]["ms"],
                "bound_ms": gather_rec["step"]["bound_ms"],
                "library_ms": gather_rec["step"]["library_ms"],
                "shape": f"the step's {gather_rec['step']['calls']} backward calls at their "
                         f"own positions ({gather_rec['step']['rows']} in all); ms, bound_ms "
                         "and library_ms (index_put_ with accumulate, autograd's backward of "
                         "table[idx]) summed over the calls",
            },
        },
        {
            "name": "replay_path",
            "route": "cuda",
            "source": "raytracer_tpu_torch/csrc/replay_kernel.cu",
            "replaces": None,
            "launches": replay_rec["step_launches"]["replay_path"],
            "adjoint_launches": replay_rec["step_launches"]["replay_adjoint"],
            "on_main_path": True,
            "path": "training, bucketed backend: the replay's forward and adjoint in one step "
                    "at 400x225@8spp depth 50 (phase 21)",
            "max_abs_err": max(replay_rec["twin_max_abs"].values()),
            "ms": replay_rec["kernels"]["forward_ms"] + replay_rec["kernels"]["adjoint_ms"],
            "plain_ms": replay_rec["kernels"]["plain_ms"],
            "bound_ms": (replay_rec["kernels"]["bound_ms"]["forward"]
                         + replay_rec["kernels"]["bound_ms"]["adjoint"]),
            "bound_by": replay_rec["kernels"]["bound_by"]["adjoint"],
            "library_ms": None,
            "eager_replay_ms": replay_rec["kernels"]["eager_replay_ms"],
            "shape": f"rand_spheres 400x225@8spp depth 50, one step's "
                     f"{replay_rec['shape']['lanes']} replayed lanes, "
                     f"{replay_rec['shape']['segments']} lane-bounces; ms and bound_ms the "
                     "forward's and the adjoint's summed, the reduction beside them",
            "split": replay_rec["kernels"],
        },
    ]
    # The sharded paths' launches (phase 16), each counted around its own run.
    dl, gd = dist_rec["large_scene"]["shard"]["launches"], gloo0["dryrun"]
    sharded = {
        "closest_hit": dict(dryrun_scan_step_gloo_rank0=gd["scan_closest_hit_launches"]),
        "closest_hit_clustered": dict(large_scene_nccl_one_rank=dl["closest_hit_clustered"]),
        "persistent_render": dict(
            shard_cli_nccl_one_rank=dist_rec["shard_cli"]["launches"]["persistent_render"],
            gloo_render_per_rank=[r["render_launches"] for r in dist_rec["gloo_world2"]["ranks"]],
            dryrun_regen_gloo_rank0=gd["regen_launches"],
            dryrun_culled_gloo_rank0=gd["culled_launches"]),
        "persistent_tape": dict(
            sharded_step_nccl_one_rank=dist_rec["sharded_step"]["launches"]["persistent_tape"],
            dryrun_gloo_rank0=gd["tape_launches"]),
        "culled_closest_hit": dict(large_scene_nccl_one_rank=dl["culled"]),
        "wavefront_step": dict(wavefront_step_nccl_one_rank=dist_rec["wavefront_step"]["shard"][
            "launches"]["wavefront_step"]),
        "table_gather": dict(
            sharded_step_nccl_one_rank=dist_rec["sharded_step"]["launches"]["table_gather"]),
        "replay_path": dict(
            sharded_step_nccl_one_rank=dist_rec["sharded_step"]["launches"]["replay_path"]),
    }
    for entry in kernels:
        entry["sharded_launches"] = sharded[entry["name"]]
    names = list(phase_start)
    phase_s = {n: (phase_start[names[i + 1]] if i + 1 < len(names) else time.perf_counter())
               - phase_start[n] for i, n in enumerate(names)}
    (OUT_DIR / "chip_smoke_record.json").write_text(json.dumps(
        {"device": kind, "nvidia_smi": smi, "record": record, "golden_means": g4,
         "main_path": report, "step_check": step_7a, "kernels": kernels,
         "command_s": time.perf_counter() - T_START, "phase_s": phase_s}, indent=1))
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s; seconds a phase (to the next "
          f"phase's start, the last to the record) "
          f"{json.dumps({n: round(v, 1) for n, v in phase_s.items()})}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank(int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
