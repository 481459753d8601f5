"""Render driver (port of raytracer_tpu/render/driver.py:render_image,
render_scene, the large-scene pass loop and the host clustering of large
scenes).

`render_path` routes each scene as the JAX driver does
(raytracer_tpu/render/driver.py:477-506, 536-634):

* "persistent": every scene the persistent kernel serves, every texture
  kind and every size included. One kernel-2 launch per spp chunk renders
  every sample of the chunk (ops/persistent_kernel.py); the retirement log
  then folds into the framebuffer (integrator/wavefront.py:_fold_log).
  Scenes of more than CLUSTERED_SCENE_PRIMS primitives are first permuted
  into BVH-cluster order (`cluster_for_render`: JAX's cut at the H100's
  CLUSTER_GRAIN, with each oversized primitive such as a ground sphere or
  quad in a cluster of its own; the clustering is cached per geometry,
  the permutation applied on every render), and kernel 2 culls clusters
  inside its loop.
* "large_scene": scenes it does not serve (noise from rng-filled Perlin
  tables) with more than LARGE_SCENE_PRIMS primitives: the scene clustered
  as for the persistent path (`cluster_for_render`), then passes of k
  samples per pixel, camera rays through the cluster-culled kernel 4 and
  bounces through kernel 1's clustered entry, both walking that cluster
  table (`_render_large_scene`).
* "wavefront_step": the other scenes it does not serve: the regenerative
  loop with kernel 5 as each iteration's front half and the shading
  epilogue in PyTorch (integrator/wavefront.py:render_wavefront_step),
  images filtered by the deterministic 4-tap where the scene asks for
  bilinear filtering.

The TPU's VMEM slot model (regen_max_slots), its gather-band wavefront
heuristic (pick_wavefront) and its tile rounding do not apply: the
wavefront size is chosen to fill the GPU, and the spp budget is chunked
only when what a chunk holds on the device (`chunk_bytes`: its (3, K, N)
float32 log, its framebuffer and the fold's scratch) would pass
`log_budget_bytes`. JAX's RT_CLUSTER_LEAF / RT_CLUSTER_FAN probing overrides
are not ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.core.camera import Camera, RenderSettings, camera_frame, camera_rays
from raytracer_tpu_torch.geometry.bvh import (
    OVERSIZE_FACTOR,
    ClusterSet,
    cluster_order,
    isolate_oversized,
    permute_scene,
)
from raytracer_tpu_torch.geometry.intersect import quad_derived, scene_tables
from raytracer_tpu_torch.geometry.scene import Scene
from raytracer_tpu_torch.integrator.wavefront import (
    fold_scratch_bytes,
    render_wavefront_regen,
    render_wavefront_step,
    strided_schedule,
    trace,
)
from raytracer_tpu_torch.materials.packed import texture_tables
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops import culled_kernel as ck
from raytracer_tpu_torch.ops import intersect_kernel as ik
from raytracer_tpu_torch.ops.persistent_kernel import (
    CLUSTERED_SCENE_PRIMS,
    pack_camera_scalars_bg,
    pack_cluster_table,
    pack_persistent_tables,
    unsupported_reason,
)
from raytracer_tpu_torch.render.postprocess import to_u8
from raytracer_tpu_torch.utils import trace as tr
from raytracer_tpu_torch.utils.metrics import warp_slots

# Wavefront lanes. At the persistent kernel's 62 registers per thread an
# H100 SM holds 1024 threads, so 2^18 lanes are about two resident waves on
# 132 SMs. At the main path's shape 2^17 measured 4% slower and 2^19 3.5%
# faster (PERF.md, PR 1 findings).
DEFAULT_WAVEFRONT = 1 << 18
# Device-memory budget of one chunk: its retirement log, framebuffer and
# fold scratch (`chunk_bytes`). rand_spheres at 400x225@500spp needs a
# 3 * 172 slots * 2^18 lanes * 4 B = 541 MB log, a 1 MB framebuffer and
# 66 MB of fold scratch: one chunk. At 3840x2160 a chunk is 20 spp.
LOG_BUDGET_BYTES = 2 << 30
# Scenes the persistent kernel does not serve take the large-scene path
# above this many primitives (raytracer_tpu/render/driver.py:41).
LARGE_SCENE_PRIMS = 4096
# Wavefront of the wavefront-step path: at least one image, within
# [2^19, 2^21] lanes (the JAX driver's non-persistent sizing, driver.py:550).
STEP_WAVEFRONT_MIN = 1 << 19
STEP_WAVEFRONT_MAX = 1 << 21
# Rays per pass of the large-scene path (the JAX driver's
# DEFAULT_TARGET_RAYS_PER_PASS).
TARGET_RAYS_PER_PASS = 1 << 19
# Cluster granularity of large scenes on the persistent path, per kind:
# fine clusters of <= leaf primitives, supers of <= leaf * fan. These are
# the H100's, swept on the card with kernel 2's per-lane culled walk
# (PERF.md, section 6), not the JAX driver's 64 / 16, which were swept on
# its TPU, where the whole 8x128 tile voted on one cluster. Spheres keep
# 64 / 16: 32 / 16 ran rand_spheres_large 11% faster but its 50,001-sphere
# variant 8% slower (a finer cut means more supers, all tested by every
# segment). Quads take 16 / 16: quad_field 42% faster.
CLUSTER_GRAIN = {"sph": (64, 16), "quad": (16, 16)}
# Oversized primitives (geometry/bvh.py:isolate_oversized) get clusters of
# their own past this multiple of their kind's median super extent; inf
# keeps JAX's tables.
CLUSTER_OVERSIZE = OVERSIZE_FACTOR


def log_bytes(n_pixels: int, spp: int, wavefront: int) -> int:
    """Bytes of the (3, K, N) float32 retirement log of a chunk of `spp`."""
    n, num_slots, _ = strided_schedule(n_pixels, spp, wavefront)
    return 3 * num_slots * n * 4


def chunk_bytes(n_pixels: int, spp: int, wavefront: int) -> int:
    """Device bytes a chunk of `spp` samples per pixel holds: its
    retirement log, its (n_pixels, 3) framebuffer and the fold's scratch
    (integrator/wavefront.py:fold_scratch_bytes)."""
    n, num_slots, _ = strided_schedule(n_pixels, spp, wavefront)
    return (log_bytes(n_pixels, spp, wavefront) + 12 * n_pixels
            + fold_scratch_bytes(num_slots, n, n_pixels))


def spp_chunk_for(n_pixels: int, spp: int, wavefront: int, budget: int) -> int:
    """Largest samples-per-pixel chunk whose device memory (`chunk_bytes`)
    fits `budget`; 1 when none does."""
    chunk = min(spp, max(1, budget // (12 * n_pixels)))
    while chunk > 1 and chunk_bytes(n_pixels, chunk, wavefront) > budget:
        chunk -= 1
    return chunk


def samples_per_pass_for(spp: int, num_pixels: int,
                         target_rays: int = TARGET_RAYS_PER_PASS) -> int:
    """Largest k <= target_rays / num_pixels that divides spp, so passes * k
    == spp exactly."""
    ideal = max(1, min(spp, target_rays // max(1, num_pixels)))
    return next(k for k in range(ideal, 0, -1) if spp % k == 0)


def render_path(scene: Scene) -> str:
    """The path `render_image` takes for `scene`: "persistent",
    "large_scene" or "wavefront_step" (see the module docstring)."""
    if unsupported_reason(scene) is None:
        return "persistent"
    if scene.num_prims > LARGE_SCENE_PRIMS:
        return "large_scene"
    return "wavefront_step"


# The geometry tensors geometry.bvh.cluster_order reads: the clustering
# depends on these alone.
CLUSTER_GEOMETRY = ("sph_center", "sph_radius", "quad_q", "quad_u", "quad_v")
# Host clustering results (ClusterOrder: the permutation and the
# ClusterSet), keyed by the identity of the scene's geometry tensors. Bounded.
_CLUSTER_CACHE: dict[tuple, tuple] = {}


def _cluster_order_cached(scene: Scene):
    """geometry.bvh.cluster_order(scene) at CLUSTER_GRAIN with its oversized
    primitives isolated (geometry.bvh.isolate_oversized at
    CLUSTER_OVERSIZE), from the cache when the same geometry tensors, at
    the same version, were clustered before at the same settings.

    An entry holds the tensors it was built from (so their ids cannot be
    reused) and their version counters, which every in-place update bumps
    (torch.optim's steps on make_inverse_renderer's leaves included), so a
    moved sphere is clustered anew. Only the permutation is cached:
    cluster_for_render applies it to the scene it is given, so a
    dataclasses.replace that keeps the geometry but changes materials,
    textures or material ids renders its own values. The JAX driver
    (raytracer_tpu/render/driver.py:373-384) caches the permuted scene by
    the sphere-center array alone, which renders a replaced scene's old
    radii and materials; the port fixes this rather than match it."""
    tensors = tuple(getattr(scene, f) for f in CLUSTER_GEOMETRY)
    settings = (tuple(CLUSTER_GRAIN["sph"]), tuple(CLUSTER_GRAIN["quad"]), CLUSTER_OVERSIZE)
    key = tuple(id(t) for t in tensors) + settings
    versions = tuple(t._version for t in tensors)
    hit = _CLUSTER_CACHE.get(key)
    if hit is None or hit[1] != versions or any(a is not b for a, b in zip(hit[0], tensors)):
        (leaf, fan), quad_grain = CLUSTER_GRAIN["sph"], CLUSTER_GRAIN["quad"]
        order = cluster_order(scene, max_leaf=leaf, super_fan=fan, quad_grain=quad_grain)
        hit = (tensors, versions, isolate_oversized(scene, order, CLUSTER_OVERSIZE))
        _CLUSTER_CACHE.pop(key, None)
        if len(_CLUSTER_CACHE) >= 8:
            _CLUSTER_CACHE.pop(next(iter(_CLUSTER_CACHE)))
        _CLUSTER_CACHE[key] = hit
    return hit[2]


def _order_front_to_back(fine: np.ndarray, sup: np.ndarray, eye: np.ndarray):
    """Sort one kind's cluster rows by distance from the eye. With a super
    level the supers are sorted and each super's block of fine rows is
    sorted in place (a super's [start, count] indexes fine ROWS, so its
    rows stay contiguous); the supers' starts are rebuilt for the new
    layout."""

    def dist(rows):
        c = (rows[:, 0:3] + rows[:, 3:6]) * 0.5
        return ((c - eye) ** 2).sum(axis=1)

    if fine.shape[0] == 0:
        return fine, sup
    if sup.shape[0] == 0:
        return fine[np.argsort(dist(fine))], sup
    new_fine, new_sup = [], []
    pos = 0
    for si in np.argsort(dist(sup)):
        s, c = int(sup[si, 6]), int(sup[si, 7])
        block = fine[s : s + c]
        new_fine.append(block[np.argsort(dist(block))])
        row = sup[si].copy()
        row[6] = float(pos)
        new_sup.append(row)
        pos += c
    return np.concatenate(new_fine), np.stack(new_sup)


def order_clusters(cs: ClusterSet, eye) -> ClusterSet:
    """`cs` with each kind's rows sorted front to back from `eye`."""
    s_fine, s_sup = _order_front_to_back(cs.sph, cs.sph_super, eye)
    q_fine, q_sup = _order_front_to_back(cs.quad, cs.quad_super, eye)
    return cs._replace(sph=s_fine, sph_super=s_sup, quad=q_fine, quad_super=q_sup)


def cluster_for_render(scene: Scene, cam: Camera):
    """Cluster-order a large scene for kernel 2's culled instantiations (and
    the large-scene path's kernels 1 and 4) and sort its cluster rows front
    to back from the eye: camera rays (most segments) find their
    nearest hit early, and the shrinking best hit culls the clusters behind
    it (the ordered traversal of bvh.go:225-232). Fine rows may move freely
    within their super: their start/count index the permuted primitive
    tables, not the row position. The clustering is cached per geometry
    (`_cluster_order_cached`); the permutation is applied to `scene` on
    every call. Returns (permuted scene, geometry.bvh.ClusterSet)."""
    order = _cluster_order_cached(scene)
    return permute_scene(scene, order), order_clusters(order.clusters,
                                                       cam.look_from.cpu().numpy())


def _clustered(scene: Scene, cam: Camera, dev, metrics=None):
    """(`cluster_for_render`'s permuted scene, its ClusterTable on `dev`);
    `metrics` records the host clustering seconds, the BVH builder and the
    table's section lengths."""
    t0 = time.perf_counter()
    scene, cs = cluster_for_render(scene, cam)
    clusters = pack_cluster_table(cs, dev)
    if metrics is not None:
        metrics.cluster_s += time.perf_counter() - t0
        metrics.bvh_builder = cs.builder
        metrics.cluster_rows = list(clusters.counts)
    return scene, clusters


def chunk_seed(seed: int, idx: int) -> int:
    """Seed of spp chunk or pass `idx`: each restarts sample ids at 0, so
    each gets its own counter-RNG stream."""
    return seed if idx == 0 else int(ctr_rng.hash_i32(seed, idx, 0))


def resolve_device(device) -> torch.device:
    """The render device; a CUDA request without a card raises (no
    fallback hides the device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is false")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def path_wavefront(path: str, n_pixels: int, wavefront: int = DEFAULT_WAVEFRONT) -> int:
    """Lanes of a render on `path`: `wavefront` on the persistent path; at
    least one image within [STEP_WAVEFRONT_MIN, STEP_WAVEFRONT_MAX] on the
    wavefront-step path (the large-scene path sizes passes instead)."""
    if path == "wavefront_step":
        return max(STEP_WAVEFRONT_MIN, min(n_pixels, STEP_WAVEFRONT_MAX))
    return wavefront


def default_spp_chunk(scene: Scene, settings: RenderSettings, *,
                      wavefront: int = DEFAULT_WAVEFRONT,
                      log_budget_bytes: int = LOG_BUDGET_BYTES, ranks: int = 1) -> int:
    """Samples per pixel of `render_image`'s chunks on `scene`'s path: the
    large-scene path's passes (samples_per_pass_for, its ray target scaled
    by `ranks`), else the largest chunk whose device memory (log,
    framebuffer, fold scratch) fits `log_budget_bytes`, that budget holding
    each of `ranks` ranks' share of the chunk (spp_chunk_for; a sharded
    render splits every chunk over its ranks, parallel/shard.py)."""
    n_pix = settings.width * settings.height
    spp = settings.samples_per_pixel
    path = render_path(scene)
    if path == "large_scene":
        return samples_per_pass_for(spp, n_pix, TARGET_RAYS_PER_PASS * ranks)
    share = spp_chunk_for(n_pix, -(-spp // ranks), path_wavefront(path, n_pix, wavefront),
                          log_budget_bytes)
    return min(spp, share * ranks)


class ChunkRenderer(NamedTuple):
    """The tables of a render on the persistent or wavefront-step path,
    packed once on the render device (`chunk_renderer`); `render` renders
    one chunk of them."""

    path: str
    tables: tuple  # sphere, quad and primitive tables (pack_persistent_tables)
    textures: object  # materials.packed.texture_tables
    cam_scalars: torch.Tensor
    clusters: object  # ops.persistent_kernel.ClusterTable, or None
    width: int
    height: int
    wavefront: int  # lanes (path_wavefront)
    max_depth: int
    sky_gradient: bool

    def render(self, spp: int, seed: int):
        """(framebuffer (n_pixels, 3) radiance sums, segments per lane (N,)
        int32, iterations) of `spp` samples per pixel under `seed`: one
        kernel-2 launch on the persistent path (iterations 0), the kernel-5
        loop on the wavefront-step path."""
        kw = dict(width=self.width, height=self.height, spp=spp, wavefront_size=self.wavefront,
                  max_depth=self.max_depth, sky_gradient=self.sky_gradient)
        if self.path == "persistent":
            fb, segs = render_wavefront_regen(*self.tables, self.cam_scalars, seed,
                                              textures=self.textures, clusters=self.clusters,
                                              **kw)
            return fb, segs, 0
        return render_wavefront_step(*self.tables, self.textures, self.cam_scalars, seed, **kw)


def chunk_renderer(scene: Scene, cam: Camera, settings: RenderSettings, dev, *,
                   wavefront: int = DEFAULT_WAVEFRONT, metrics=None,
                   bilinear_stochastic: bool | None = None, clusters=None) -> ChunkRenderer:
    """Pack `scene` for `render_chunks`' chunks on `dev` (persistent or
    wavefront-step path): persistent scenes of more than
    CLUSTERED_SCENE_PRIMS primitives are clustered first
    (`cluster_for_render`; `metrics` records it). `clusters`, a
    geometry.bvh.ClusterSet of a scene already in its cluster order (as
    geometry.bvh.cluster_scene returns them), gives kernel 2 that table
    instead, at any size."""
    path = render_path(scene)
    if path == "large_scene":
        raise ValueError("the large-scene path renders in passes (_large_scene_chunks)")
    w, h = settings.width, settings.height
    cam_scalars = pack_camera_scalars_bg(camera_frame(cam, w, h), cam.background).to(dev)
    if clusters is not None:
        if path != "persistent":
            raise ValueError(f"a cluster table needs the persistent path, not {path}")
        clusters = pack_cluster_table(clusters, dev)
    elif path == "persistent" and scene.num_prims > CLUSTERED_SCENE_PRIMS:
        scene, clusters = _clustered(scene, cam, dev, metrics)
    scene = scene.to(dev)
    textures = texture_tables(scene, quad_derived(scene),
                              stochastic=path == "persistent" and bilinear_stochastic is not False)
    return ChunkRenderer(path, pack_persistent_tables(scene), textures, cam_scalars, clusters,
                         w, h, path_wavefront(path, w * h, wavefront), settings.max_depth,
                         settings.sky_gradient)


def render_chunks(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    *,
    device="cuda",
    seed: int = 0,
    spp_per_chunk: int | None = None,
    start_chunk: int = 0,
    wavefront: int = DEFAULT_WAVEFRONT,
    log_budget_bytes: int = LOG_BUDGET_BYTES,
    progress: bool = False,
    metrics=None,
    bilinear_stochastic: bool | None = None,
):
    """The chunk loop of `render_image` as a generator: renders chunks
    `start_chunk`, `start_chunk` + 1, ... of `spp_per_chunk` samples per
    pixel (default: `default_spp_chunk`; the last chunk takes what is
    left) and yields (chunk index, samples per pixel done after it, the
    chunk's (n_pixels, 3) radiance sum on `device`). Chunk c renders
    samples [c * spp_per_chunk, ...) under seed `chunk_seed(seed, c)`, so
    any run of chunks reproduces the same chunks of an uninterrupted
    render (render/checkpoint.py resumes from one). On the large-scene
    path a chunk is a pass. Arguments as `render_image`'s; `metrics` gets
    the traced-segment totals once the generator is exhausted."""
    path = render_path(scene)
    dev = resolve_device(device)
    if spp_per_chunk is None:
        spp_per_chunk = default_spp_chunk(scene, settings, wavefront=wavefront,
                                          log_budget_bytes=log_budget_bytes)
    if path == "large_scene":
        yield from _large_scene_chunks(scene.to(dev), cam, settings, seed=seed, k=spp_per_chunk,
                                       start_chunk=start_chunk, progress=progress,
                                       metrics=metrics)
        return
    spp = settings.samples_per_pixel
    with tr.span("render/pack"):
        renderer = chunk_renderer(scene, cam, settings, dev, wavefront=wavefront,
                                  metrics=metrics, bilinear_stochastic=bilinear_stochastic)
    chunk = spp_per_chunk
    if metrics is not None:
        n, num_slots, _ = strided_schedule(settings.width * settings.height, chunk,
                                           renderer.wavefront)
        metrics.wavefront_lanes = n
        metrics.retirement_log_mb = 3 * num_slots * n * 4 / 2**20
    seg_parts = []
    iters = 0
    chunk_idx = start_chunk
    done = min(spp, chunk_idx * chunk)
    while done < spp:
        step = min(chunk, spp - done)
        with tr.span("render/chunk"):
            fb, segs, it = renderer.render(step, chunk_seed(seed, chunk_idx))
        iters += it
        seg_parts.append(segs)
        done += step
        if metrics is not None:
            metrics.update(done)
        if progress:
            print(f"spp {done}/{spp}", flush=True)
        yield chunk_idx, done, fb
        chunk_idx += 1
    if metrics is not None:
        if path == "persistent":
            metrics.update(done, segments=sum(int(s.sum()) for s in seg_parts),
                           warp_slots=sum(warp_slots(s) for s in seg_parts))
        else:
            metrics.update(done, segments=sum(int(s.sum()) for s in seg_parts), iterations=iters)


def render_image(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    *,
    device="cuda",
    seed: int = 0,
    wavefront: int = DEFAULT_WAVEFRONT,
    log_budget_bytes: int = LOG_BUDGET_BYTES,
    regenerative: bool = True,
    progress: bool = False,
    metrics=None,
    bilinear_stochastic: bool | None = None,
) -> torch.Tensor:
    """Render the full image; returns linear mean radiance (H, W, 3) float32
    on `device`. CUDA runs the kernels; CPU runs their plain twins. The
    scene takes `render_path(scene)`; `wavefront` sizes the persistent
    path's lanes only. The spp budget runs in `render_chunks`' chunks.

    regenerative=False renders in passes of k samples per pixel instead
    (`render_pass`, k from samples_per_pass_for at TARGET_RAYS_PER_PASS
    rays, pass p under chunk_seed(seed, p)): every lane traces one path to
    its end through `trace`, with no russian roulette, whatever the
    scene's path (the JAX driver's non-regenerative loop, driver.py:636-654).

    bilinear_stochastic (scenes with `bilinear_textures`, as in the JAX
    driver): None (default) filters images by the unbiased stochastic
    single tap on the persistent path; False forces the deterministic
    4-tap; True asks for the stochastic tap, which only the persistent path
    has. Other paths filter by the 4-tap.

    Russian roulette starts at depth 5 and caps the survival probability at
    0.75 on the persistent path and 0.95 on the wavefront-step path (the
    JAX driver's settings, driver.py:602); the large-scene path has none.
    It is unbiased.

    Persistent-path scenes of more than CLUSTERED_SCENE_PRIMS primitives
    are clustered on the host first (`cluster_for_render`) and kernel 2
    culls clusters.

    metrics: optional utils.metrics.RenderMetrics, updated per chunk (or
    pass) and with traced-segment totals after the last (one device sync);
    a clustered render also records its host clustering seconds, the BVH
    builder and the cluster table's section lengths.

    The render is a root span `render_image` of utils/trace.py, with
    `render/pack`, a `render/chunk` a chunk (`render/kernel` and
    `render/fold` inside it) and `render/mean`."""
    with tr.span("render_image"):
        dev = resolve_device(device)
        w, h, spp = settings.width, settings.height, settings.samples_per_pixel
        if not regenerative:
            k = samples_per_pass_for(spp, w * h)
            scene = scene.to(dev)
            acc = torch.zeros(h, w, 3, dtype=torch.float32, device=dev)
            for p in range(spp // k):
                acc += render_pass(scene, cam, chunk_seed(seed, p), width=w, height=h,
                                   samples_per_pass=k, max_depth=settings.max_depth,
                                   sky_gradient=settings.sky_gradient)
                if metrics is not None:
                    metrics.update((p + 1) * k)
                if progress:
                    print(f"pass {p + 1}/{spp // k} ({(p + 1) * k}/{spp} spp)", flush=True)
            return acc / float(spp)
        acc = torch.zeros(w * h, 3, dtype=torch.float32, device=dev)
        for _, _, fb in render_chunks(scene, cam, settings, device=dev, seed=seed,
                                      wavefront=wavefront, log_budget_bytes=log_budget_bytes,
                                      progress=progress, metrics=metrics,
                                      bilinear_stochastic=bilinear_stochastic):
            acc += fb
        with tr.span("render/mean"):
            return (acc / float(spp)).reshape(h, w, 3)


def sample_camera_rays(frame, seed: int, sample_ids, *, width: int, height: int):
    """Camera rays of the global sample ids `sample_ids` (L,) int64: sample
    id L is at pixel L mod (width*height), its uniforms the counter RNG's
    under `seed`; (origin, direction) (L, 3) on the frame's device,
    contiguous."""
    pix = sample_ids % (width * height)
    o, d = camera_rays(frame, pix % width, pix // width,
                       ctr_rng.camera_uniforms(seed, sample_ids))
    return o.contiguous(), d.contiguous()


def pass_camera_rays(frame, seed: int, *, width: int, height: int, k: int):
    """The camera rays of a pass of k samples per pixel: lane L is sample
    id L at pixel L mod (width*height), its uniforms the counter RNG's
    under the pass's seed; (origin, direction) (k * width * height, 3) on
    the frame's device, contiguous."""
    sid = torch.arange(k * width * height, device=frame.center.device)
    return sample_camera_rays(frame, seed, sid, width=width, height=height)


def trace_samples(scene: Scene, cam: Camera, frame, seed: int, sample_ids, *, width: int,
                  height: int, max_depth: int, sky_gradient: bool, intersect_fn=None,
                  return_segments: bool = False):
    """`trace` of the global sample ids `sample_ids` of a pass seeded `seed`:
    a `range` (a contiguous block) or an (L,) int64 tensor. Camera rays
    from `sample_camera_rays`, bounce uniforms the counter RNG's at each
    lane's sample id (a range offsets the lanes, a tensor is gathered), no
    russian roulette. The closest hit is trace's default (kernel 1 dense on
    CUDA) unless `intersect_fn` is given. Returns radiance (L, 3) and, with
    `return_segments`, segments (L,) int32. Lanes depend on their sample
    ids alone, so any split of a pass's ids over ranks traces the same
    per-lane values (parallel/shard.py)."""
    dev = scene.sph_center.device
    if isinstance(sample_ids, range):
        start = sample_ids.start
        sid = torch.arange(start, sample_ids.stop, device=dev)

        def uniforms(bounce, lanes):
            return ctr_rng.bounce_uniforms(seed, lanes + start if start else lanes, bounce)
    else:
        sid = sample_ids

        def uniforms(bounce, lanes):
            return ctr_rng.bounce_uniforms(seed, sid[lanes], bounce)
    o, d = sample_camera_rays(frame, seed, sid, width=width, height=height)
    return trace(scene, o, d, cam.background.to(dev), uniforms, max_depth=max_depth,
                 sky_gradient=sky_gradient, return_segments=return_segments,
                 intersect_fn=intersect_fn)


def render_pass(scene: Scene, cam: Camera, seed: int, *, width: int, height: int,
                samples_per_pass: int, max_depth: int, sky_gradient: bool) -> torch.Tensor:
    """One pass (port of raytracer_tpu/render/driver.py:render_pass): every
    pixel's radiance sum over `samples_per_pass` samples, (height, width,
    3) on the scene's device. Lane L is sample id L at pixel L mod
    (width*height) (`trace_samples`)."""
    n = width * height
    dev = scene.sph_center.device
    frame = camera_frame(cam, width, height).to(dev)
    rad = trace_samples(scene, cam, frame, seed, range(samples_per_pass * n), width=width,
                        height=height, max_depth=max_depth, sky_gradient=sky_gradient)
    return rad.reshape(samples_per_pass, n, 3).sum(0).reshape(height, width, 3)


def large_scene_hit(tables):
    """`trace`'s intersect_fn on a large-scene path's (ClusterTable, sphere
    table, quad table): camera rays (bounce 0, coherent, in pixel order)
    through the cluster-culled kernel 4, bounces through kernel 1's
    clustered entry."""
    clusters, sph, quad = tables

    def hit_fn(scene, o, d, bounce, lanes):
        hit = ck.intersect_culled if bounce == 0 else ik.intersect_clustered
        return hit(clusters, sph, quad, o.contiguous(), d.contiguous())

    return hit_fn


def _large_scene_pass(scene: Scene, tables, cam: Camera, frame, seed: int, *, width: int,
                      height: int, k: int, max_depth: int, sky_gradient: bool):
    """One pass of the large-scene path over a cluster-ordered scene and its
    (ClusterTable, sphere table, quad table): k samples per pixel in one
    batch, lane L sample id L at pixel L mod (width*height), its camera and
    bounce uniforms the counter RNG's under this pass's seed, the hits
    `large_scene_hit`'s; no russian roulette (the JAX package's `trace`).
    Returns ((n_pixels, 3) radiance sum, segments (k * n_pixels,) int32)."""
    n = width * height
    rad, segs = trace_samples(scene, cam, frame, seed, range(k * n), width=width, height=height,
                              max_depth=max_depth, sky_gradient=sky_gradient,
                              intersect_fn=large_scene_hit(tables), return_segments=True)
    return rad.reshape(k, n, 3).sum(0), segs


def large_scene_tables(scene: Scene, cam: Camera, dev, metrics=None):
    """(the cluster-ordered scene, its (ClusterTable, sphere table, quad
    table)) of the large-scene path on `dev` (`_clustered`)."""
    scene, clusters = _clustered(scene, cam, dev, metrics)
    return scene, (clusters, *scene_tables(scene))


def _large_scene_chunks(scene: Scene, cam: Camera, settings: RenderSettings, *, seed: int,
                        k: int | None = None, start_chunk: int = 0, progress: bool = False,
                        metrics=None):
    """The large-scene path's passes as `render_chunks` yields them: the
    scene clustered on the host once (`cluster_for_render`: the clustering
    cached per geometry, the permutation applied to `scene`), then passes
    `start_chunk`, ... of k samples per pixel (default samples_per_pass_for;
    the last pass takes what is left) over the permuted scene, so prim ids
    and shading are that scene's. Yields (pass index, samples per pixel
    done after it, the pass's (n_pixels, 3) radiance sum); `metrics` also
    records the host clustering seconds, the BVH builder and the cluster
    table's section lengths."""
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n = w * h
    dev = scene.sph_center.device
    scene, tables = large_scene_tables(scene, cam, dev, metrics)
    frame = camera_frame(cam, w, h).to(dev)
    if k is None:
        k = samples_per_pass_for(spp, n, TARGET_RAYS_PER_PASS)
    passes = -(-spp // k)
    seg_parts = []
    done = min(spp, start_chunk * k)
    if metrics is not None:
        metrics.wavefront_lanes = k * n
    for p in range(start_chunk, passes):
        step = min(k, spp - done)
        with tr.span("render/chunk"):
            fb, segs = _large_scene_pass(
                scene, tables, cam, frame, chunk_seed(seed, p), width=w, height=h, k=step,
                max_depth=settings.max_depth, sky_gradient=settings.sky_gradient,
            )
        seg_parts.append(segs)
        done += step
        if metrics is not None:
            metrics.update(done)
        if progress:
            print(f"pass {p + 1}/{passes} ({done}/{spp} spp)", flush=True)
        yield p, done, fb
    if metrics is not None:
        # A pass runs one bounce iteration per segment of its deepest lane.
        metrics.update(done, segments=sum(int(s.sum()) for s in seg_parts),
                       iterations=sum(int(s.max()) for s in seg_parts), passes=len(seg_parts))


def _render_large_scene(scene: Scene, cam: Camera, settings: RenderSettings, *, seed: int,
                        progress: bool = False, metrics=None):
    """The large-scene path (port of raytracer_tpu/render/driver.py:290-344)
    over `_large_scene_chunks`' passes. Returns the linear mean radiance
    (H, W, 3) on the scene's device."""
    w, h = settings.width, settings.height
    acc = torch.zeros(w * h, 3, dtype=torch.float32, device=scene.sph_center.device)
    for _, _, fb in _large_scene_chunks(scene, cam, settings, seed=seed, progress=progress,
                                        metrics=metrics):
        acc += fb
    return (acc / float(settings.samples_per_pixel)).reshape(h, w, 3)


def render_scene(scene: Scene, cam: Camera, settings: RenderSettings, **kw) -> np.ndarray:
    """Render and postprocess to uint8 (H, W, 3) on the host."""
    return to_u8(render_image(scene, cam, settings, **kw)).cpu().numpy()
