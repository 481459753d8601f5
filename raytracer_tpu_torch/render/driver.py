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
  table (`large_scene_block`).
* "wavefront_step": the other scenes it does not serve: the regenerative
  loop with kernel 5 as each iteration's front half and the shading
  epilogue in PyTorch (integrator/wavefront.py:render_wavefront_step),
  images filtered by the deterministic 4-tap where the scene asks for
  bilinear filtering.

Every path runs in one loop, `render_loop`: chunks (or passes) of the spp
budget, each a position's partial joined by a `Ranks`. One device is
position 0 of 1 and joins nothing; parallel/shard.py's MeshRanks joins the
positions of a mesh with torch.distributed, which this module never calls.

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

from raytracer_tpu_torch.core.camera import (
    CAMERA_FIELDS,
    Camera,
    RenderSettings,
    camera_frame,
    camera_rays,
)
from raytracer_tpu_torch.geometry.bvh import (
    OVERSIZE_FACTOR,
    ClusterSet,
    cluster_order,
    isolate_oversized,
    permute_scene,
)
from raytracer_tpu_torch.geometry.intersect import quad_derived, scene_tables
from raytracer_tpu_torch.geometry.scene import FLAG_FIELDS, TENSOR_FIELDS, Scene
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


def samples_per_pass_for(spp: int, num_pixels: int, target_rays: int = TARGET_RAYS_PER_PASS,
                         samples_axis: int = 1) -> int:
    """Largest k that divides spp, so passes * k == spp exactly, with k a
    multiple of `samples_axis` (the mesh's samples axis, over which a
    pass's slots split evenly) and k * num_pixels <= target_rays where it
    can be. A valid k exists iff spp is a multiple of samples_axis;
    otherwise ValueError."""
    if spp % samples_axis != 0:
        raise ValueError(
            f"spp={spp} must be a multiple of the sample-axis size ({samples_axis}) for the "
            "pass-based sharded render; use regenerative=True (the default), which splits "
            "any spp exactly")
    ideal = max(samples_axis, min(spp, target_rays // max(1, num_pixels)))
    return next(k for k in range(ideal, 0, -1) if spp % k == 0 and k % samples_axis == 0)


def render_path(scene: Scene) -> str:
    """The path `render_image` takes for `scene`: "persistent",
    "large_scene" or "wavefront_step" (see the module docstring)."""
    if unsupported_reason(scene) is None:
        return "persistent"
    if scene.num_prims > LARGE_SCENE_PRIMS:
        return "large_scene"
    return "wavefront_step"


# Entries each of this module's caches holds at most; the oldest goes first.
CACHE_ENTRIES = 8


def _cached(cache: dict | None, tensors: tuple, settings: tuple, build):
    """(value, hit): the value `cache` holds for `tensors`, at their
    current versions, and `settings`, or else build()'s, stored (with no
    cache, build()'s alone). An entry is keyed by the tensors' identities
    and `settings` and holds the tensors (so their ids cannot be reused)
    and their version counters, which every in-place update bumps
    (torch.optim's steps on make_inverse_renderer's leaves included)."""
    if cache is None:
        return build(), False
    key = tuple(id(t) for t in tensors) + settings
    versions = tuple(t._version for t in tensors)
    hit = cache.get(key)
    if hit is not None and hit[1] == versions and all(a is b for a, b in zip(hit[0], tensors)):
        return hit[2], True
    value = build()
    cache.pop(key, None)
    if len(cache) >= CACHE_ENTRIES:
        cache.pop(next(iter(cache)))
    cache[key] = (tensors, versions, value)
    return value, False


# The geometry tensors geometry.bvh.cluster_order reads: the clustering
# depends on these alone.
CLUSTER_GEOMETRY = ("sph_center", "sph_radius", "quad_q", "quad_u", "quad_v")
# Host clustering results (ClusterOrder: the permutation and the
# ClusterSet), keyed by the identity of the scene's geometry tensors.
_CLUSTER_CACHE: dict[tuple, tuple] = {}


def _cluster_order_cached(scene: Scene):
    """geometry.bvh.cluster_order(scene) at CLUSTER_GRAIN with its oversized
    primitives isolated (geometry.bvh.isolate_oversized at
    CLUSTER_OVERSIZE), from the cache when the same geometry tensors, at
    the same version, were clustered before at the same settings
    (`_cached`), so a moved sphere is clustered anew. Only the permutation
    is cached: cluster_for_render applies it to the scene it is given, so a
    dataclasses.replace that keeps the geometry but changes materials,
    textures or material ids renders its own values. The JAX driver
    (raytracer_tpu/render/driver.py:373-384) caches the permuted scene by
    the sphere-center array alone, which renders a replaced scene's old
    radii and materials; the port fixes this rather than match it."""
    (leaf, fan), quad_grain = CLUSTER_GRAIN["sph"], CLUSTER_GRAIN["quad"]

    def build():
        order = cluster_order(scene, max_leaf=leaf, super_fan=fan, quad_grain=quad_grain)
        return isolate_oversized(scene, order, CLUSTER_OVERSIZE)

    tensors = tuple(getattr(scene, f) for f in CLUSTER_GEOMETRY)
    return _cached(_CLUSTER_CACHE, tensors, ((leaf, fan), tuple(quad_grain), CLUSTER_OVERSIZE),
                   build)[0]


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


def _record_clusters(metrics, builder: str, clusters, seconds: float) -> None:
    """`metrics` (if any) records the host clustering seconds, the BVH
    builder and the cluster table's section lengths."""
    if metrics is not None:
        metrics.cluster_s += seconds
        metrics.bvh_builder = builder
        metrics.cluster_rows = list(clusters.counts)


def _clustered(scene: Scene, cam: Camera, dev, metrics=None):
    """(`cluster_for_render`'s permuted scene, its ClusterTable on `dev`,
    the BVH builder); `metrics` records the clustering (`_record_clusters`)."""
    t0 = time.perf_counter()
    scene, cs = cluster_for_render(scene, cam)
    clusters = pack_cluster_table(cs, dev)
    _record_clusters(metrics, cs.builder, clusters, time.perf_counter() - t0)
    return scene, clusters, cs.builder


def chunk_seed(seed: int, idx: int) -> int:
    """Seed of spp chunk or pass `idx`: each restarts sample ids at 0, so
    each gets its own counter-RNG stream."""
    return seed if idx == 0 else int(ctr_rng.hash_i32(seed, idx, 0))


# Counter of the rank-seed stream: rank_seed hashes (seed, position, this);
# chunk_seed hashes (seed, chunk, 0), so the two streams never share an input.
RANK_SEED_CTR = 1


def rank_seed(seed: int, position: int) -> int:
    """Seed of mesh position `position` in a chunk seeded `seed`: position 0
    keeps the seed (so one device renders what position 0 of 1 renders),
    the others hash (seed, position)."""
    return seed if position == 0 else int(ctr_rng.hash_i32(seed, position, RANK_SEED_CTR))


def rank_share(total: int, position: int, size: int) -> int:
    """Position's share of `total` samples split over `size` positions as
    evenly as integers allow (the shares sum to total)."""
    return total // size + (1 if position < total % size else 0)


def lane_block(n: int, position: int, size: int) -> tuple[int, int]:
    """[start, stop) of position's contiguous block of a flat axis of n
    lanes split over `size` positions (the last blocks may be short or
    empty)."""
    per = -(-n // size)
    start = min(n, position * per)
    return start, min(n, start + per)


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
    render splits every chunk over its ranks, `regen_partial`)."""
    n_pix = settings.width * settings.height
    spp = settings.samples_per_pixel
    path = render_path(scene)
    if path == "large_scene":
        return samples_per_pass_for(spp, n_pix, TARGET_RAYS_PER_PASS * ranks)
    share = spp_chunk_for(n_pix, -(-spp // ranks), path_wavefront(path, n_pix, wavefront),
                          log_budget_bytes)
    return min(spp, share * ranks)


# chunk_renderer's results, and the scene tables inside them, kept on their
# render device between renders (`chunk_renderer`).
_RENDERER_CACHE: dict[tuple, tuple] = {}
_TABLE_CACHE: dict[tuple, tuple] = {}


def clear_pack_cache() -> None:
    """Forget every ChunkRenderer and scene table `chunk_renderer` keeps."""
    _RENDERER_CACHE.clear()
    _TABLE_CACHE.clear()


class ChunkRenderer(NamedTuple):
    """The tables of a render on the persistent or wavefront-step path,
    packed on the render device by `chunk_renderer`, which keeps them for
    the next render of the same scene, camera and settings; `render`
    renders one chunk of them. A render only reads them: kernels 2 and 5
    take the tables, `cam_scalars` and the textures as const pointers, and
    their plain twins write nothing into them."""

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
    """Pack `scene` for `render_loop`'s chunks on `dev` (persistent or
    wavefront-step path): persistent scenes of more than
    CLUSTERED_SCENE_PRIMS primitives are clustered first
    (`cluster_for_render`; `metrics` records it). `clusters`, a
    geometry.bvh.ClusterSet of a scene already in its cluster order (as
    geometry.bvh.cluster_scene returns them), gives kernel 2 that table
    instead, at any size.

    The result is cached, its tables left on `dev`: the next call returns
    it when nothing it was packed from changed. Its key is the identity
    and version (`_cached`) of each of the scene's TENSOR_FIELDS and the
    camera's CAMERA_FIELDS, the scene's FLAG_FIELDS, the settings' width,
    height, max_depth and sky_gradient, `dev`, `wavefront` and
    `bilinear_stochastic`. The sphere, quad, primitive and texture tables
    are cached apart, keyed on the scene's part alone, so a moved camera
    repacks only the camera scalars; a clustered scene's, whose clusters
    are ordered from the eye, key on the camera too, and on CLUSTER_GRAIN
    and CLUSTER_OVERSIZE. A tensor edited in place or replaced packs
    anew; each cache holds at most CACHE_ENTRIES entries, dropping the
    oldest first. Packed without the cache: a scene or camera with a
    tensor that requires grad (the tables would carry its graph), and an
    explicit `clusters`. A clustered render from the cache records in
    `metrics` the builder and the cluster table's section lengths, and no
    clustering seconds.

    Counters (utils/trace.py; `render_loop` calls this inside its
    `render/pack` span): `pack_hits` when the whole result came from the
    cache, else `pack_misses`, once a call."""
    path = render_path(scene)
    if path == "large_scene":
        raise ValueError("the large-scene path renders in passes (render_loop)")
    if clusters is not None and path != "persistent":
        raise ValueError(f"a cluster table needs the persistent path, not {path}")
    w, h = settings.width, settings.height
    stochastic = path == "persistent" and bilinear_stochastic is not False
    clustered = (clusters is None and path == "persistent"
                 and scene.num_prims > CLUSTERED_SCENE_PRIMS)
    scene_t = tuple(getattr(scene, f) for f in TENSOR_FIELDS)
    cam_t = tuple(getattr(cam, f) for f in CAMERA_FIELDS)
    cached = clusters is None and not any(t.requires_grad for t in scene_t + cam_t)
    table_key = (tuple(getattr(scene, f) for f in FLAG_FIELDS), dev, stochastic)
    if clustered:
        table_key += (tuple(CLUSTER_GRAIN["sph"]), tuple(CLUSTER_GRAIN["quad"]),
                      CLUSTER_OVERSIZE)

    def pack_tables():
        packed, table, builder = scene, None, None
        if clusters is not None:
            table = pack_cluster_table(clusters, dev)
        elif clustered:
            packed, table, builder = _clustered(scene, cam, dev, metrics)
        packed = packed.to(dev)
        textures = texture_tables(packed, quad_derived(packed), stochastic=stochastic)
        return pack_persistent_tables(packed), textures, table, builder

    def pack():
        (tables, textures, table, builder), _ = _cached(
            _TABLE_CACHE if cached else None, scene_t + cam_t if clustered else scene_t,
            table_key, pack_tables)
        cam_scalars = pack_camera_scalars_bg(camera_frame(cam, w, h), cam.background).to(dev)
        return ChunkRenderer(path, tables, textures, cam_scalars, table, w, h,
                             path_wavefront(path, w * h, wavefront), settings.max_depth,
                             settings.sky_gradient), builder

    (renderer, builder), hit = _cached(
        _RENDERER_CACHE if cached else None, scene_t + cam_t,
        table_key + (w, h, settings.max_depth, settings.sky_gradient, wavefront,
                     bilinear_stochastic), pack)
    if builder is not None:
        # A fresh clustering recorded its seconds in _clustered; tables from
        # the cache record the same builder and rows, and no seconds.
        _record_clusters(metrics, builder, renderer.clusters, 0.0)
    tr.count("pack_hits" if hit else "pack_misses")
    return renderer


def regen_partial(renderer: ChunkRenderer, spp: int, seed: int, position: int, size: int):
    """Mesh position `position`'s partial of a regenerative chunk of `spp`
    samples per pixel seeded `seed` over `size` positions: its
    `rank_share` under `rank_seed(seed, position)`, as (framebuffer
    (n_pixels, 3) radiance sums, segments per lane (N,) int32,
    iterations). Position 0 of 1 renders the whole chunk; a position whose
    share is 0 contributes zeros."""
    share = rank_share(spp, position, size)
    if share == 0:
        dev = renderer.cam_scalars.device
        return (torch.zeros(renderer.width * renderer.height, 3, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev), 0)
    return renderer.render(share, rank_seed(seed, position))


class Ranks:
    """The positions `render_loop` splits a render over and how their
    partials join. This base is one device: position 0 of a (1, 1) mesh,
    whose partial of a chunk or pass is the whole of it, so every join is
    the partial itself and nothing calls torch.distributed.
    parallel/shard.py:MeshRanks joins the positions of a mesh."""

    position, size, shape = 0, 1, (1, 1)
    root = True  # loads and saves checkpoints, prints progress
    what = "chunking"  # what a refused checkpoint's configuration differs in

    def check_same(self, label: str, *tensors) -> None:
        """Raise unless every position holds the same bytes in `tensors`."""

    def count_segments(self, segs) -> None:
        """Count this position's segments of a chunk, inside its span."""

    def join_chunk(self, fb):
        """A regenerative chunk's (n_pixels, 3) sums from this position's."""
        return fb

    def join_pass(self, blk, n: int):
        """A pass's (n, 3) sums from this position's `pass_block`."""
        return blk

    def join_lanes(self, rad, per: int, total: int):
        """A large-scene pass's (total, 3) lanes from this position's
        `large_scene_block` (`per` lanes a position)."""
        return rad

    def reduce(self, t, op: str = "sum"):
        """`t` summed (op "max": maxed) over the positions, in place."""
        return t

    def broadcast(self, t):
        """Position 0's `t` on every position, in place."""
        return t


ONE_DEVICE = Ranks()


def render_loop(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    ranks: Ranks = ONE_DEVICE,
    *,
    path: str | None = None,
    device="cuda",
    seed: int = 0,
    wavefront: int = DEFAULT_WAVEFRONT,
    log_budget_bytes: int = LOG_BUDGET_BYTES,
    spp_per_chunk: int | None = None,
    progress: bool = False,
    metrics=None,
    bilinear_stochastic: bool | None = None,
    checkpoint: tuple[str, str] | None = None,
    max_chunks: int | None = None,
) -> torch.Tensor:
    """The render's one outer loop, on one device and at each position of a
    mesh alike: chunks c = 0, 1, ... of `spp_per_chunk` samples per pixel
    (the last takes what is left) under chunk_seed(seed, c), each one this
    position's partial, joined over the positions by `ranks` and added to
    the sums. Position 0 of 1 renders every chunk whole, so a mesh of one
    renders ONE_DEVICE's image bit for bit. Returns the linear mean radiance (H, W, 3) on `device` over the
    samples done. `path` (default render_path(scene)) picks the partial:

    * "persistent", "wavefront_step": `regen_partial` on `chunk_renderer`'s
      tables in chunks of default_spp_chunk, joined by `ranks.join_chunk`;
    * "large_scene", on any scene: passes of samples_per_pass_for at
      TARGET_RAYS_PER_PASS rays a position over the scene in cluster
      order, lane blocks (`large_scene_block`) joined by `ranks.join_lanes`,
      their k layers summed in the unsharded order;
    * "passes", the non-regenerative loop: passes of samples_per_pass_for,
      a multiple of the samples axis, tiles and slots (`pass_block`)
      joined by `ranks.join_pass`.

    checkpoint: (file, fingerprint): resume from the file when it is there
    (render/checkpoint.py:resume) and, on `ranks.root`, save after every
    chunk on a BackgroundSaver thread. `max_chunks` stops after that many.

    metrics: updated per chunk and, when the budget is done, with the
    traced segments over the positions (and warp slots and iterations; on
    the large-scene path each pass's deepest lane's iterations and the
    passes) in one sync; the occupancy basis is one position's lanes.

    Spans: `render/pack` (`chunk_renderer`'s counters), a `render/chunk` a
    chunk (this position's partial), those `ranks` opens around its joins,
    and `render/mean`."""
    dev = resolve_device(device)
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n, path, pos, size = w * h, path or render_path(scene), ranks.position, ranks.size
    regenerative = path not in ("passes", "large_scene")
    trace_kw = dict(width=w, height=h, max_depth=settings.max_depth,
                    sky_gradient=settings.sky_gradient)
    chunk = spp_per_chunk or (
        samples_per_pass_for(spp, n, samples_axis=ranks.shape[1]) if path == "passes"
        else samples_per_pass_for(spp, n, TARGET_RAYS_PER_PASS * size) if path == "large_scene"
        else default_spp_chunk(scene, settings, wavefront=wavefront,
                               log_budget_bytes=log_budget_bytes, ranks=size))
    with tr.span("render/pack"):
        if path == "passes":
            scene = scene.to(dev)
        elif path == "large_scene":
            # The scene in cluster order (prim ids and shading are its), and
            # its cluster, sphere and quad tables.
            scene, clusters, _ = _clustered(scene.to(dev), cam, dev, metrics)
            tables = (clusters, *scene_tables(scene))
            ranks.check_same("the cluster table", tables[0].rows, tables[1], tables[2])
            frame = camera_frame(cam, w, h).to(dev)
        else:
            renderer = chunk_renderer(scene, cam, settings, dev, wavefront=wavefront,
                                      metrics=metrics, bilinear_stochastic=bilinear_stochastic)
            if renderer.clusters is not None:
                ranks.check_same("the cluster table", renderer.clusters.rows,
                                 *renderer.tables[:2])
    # With metrics: this position's segments, warp slots and iterations, and
    # each large-scene pass's deepest lane.
    stats, deepest = None, []
    if metrics is not None and path == "large_scene":
        metrics.wavefront_lanes = -(-(chunk * n) // size)
    elif metrics is not None and regenerative:
        lanes, num_slots, _ = strided_schedule(n, -(-chunk // size), renderer.wavefront)
        metrics.wavefront_lanes = lanes
        metrics.retirement_log_mb = 3 * num_slots * lanes * 4 / 2**20
    if metrics is not None and path != "passes":
        stats = torch.zeros(3, dtype=torch.int64, device=dev)

    def chunk_sum(idx: int, step: int) -> torch.Tensor:
        """Chunk `idx`'s (n, 3) radiance sums over `step` samples per pixel
        on every position."""
        c_seed = chunk_seed(seed, idx)
        if path == "passes":
            with tr.span("render/chunk"):
                blk = pass_block(scene, cam, c_seed, shape=ranks.shape, position=pos,
                                 samples_per_pass=step, **trace_kw)
            return ranks.join_pass(blk, n)
        if path == "large_scene":
            with tr.span("render/chunk"):
                rad, segs = large_scene_block(scene, tables, cam, frame, c_seed, position=pos,
                                              size=size, k=step, **trace_kw)
            if stats is not None:
                stats[0] += segs.sum()
                deepest.append(segs.max() if segs.numel() else segs.new_zeros(()))
            lanes = ranks.join_lanes(rad, -(-(step * n) // size), step * n)
            return lanes.reshape(step, n, 3).sum(0)
        with tr.span("render/chunk"):
            fb, segs, it = regen_partial(renderer, step, c_seed, pos, size)
            ranks.count_segments(segs)
        fb = ranks.join_chunk(fb)
        if stats is not None and segs.numel():
            stats[0] += segs.sum()
            if renderer.path == "persistent":
                stats[1] += warp_slots(segs)
            stats[2] += it
        return fb

    acc = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    done, idx, chunks_run, saver = 0, 0, 0, None
    if checkpoint is not None:
        # render/checkpoint.py imports this module: imported at first use.
        from raytracer_tpu_torch.render import checkpoint as ckpt

        done, idx = ckpt.resume(*checkpoint, acc, ranks)
        if done and progress and ranks.root:
            print(f"resumed at {done}/{spp} spp", flush=True)
        if ranks.root:
            saver = ckpt.BackgroundSaver(checkpoint[0])
    try:
        while done < spp and (max_chunks is None or chunks_run < max_chunks):
            step = min(chunk, spp - done)
            acc += chunk_sum(idx, step)
            done, idx, chunks_run = done + step, idx + 1, chunks_run + 1
            if saver is not None:
                host = acc.reshape(h, w, 3).to("cpu", copy=True).numpy()
                saver.submit(ckpt.RenderCheckpoint(acc=host, done_spp=done, seed=seed,
                                                   chunk_idx=idx, config_hash=checkpoint[1]))
            if metrics is not None:
                metrics.update(done)
            if progress and ranks.root:
                print(f"spp {done}/{spp}" if regenerative
                      else f"pass {idx}/{-(-spp // chunk)} ({done}/{spp} spp)", flush=True)
    finally:
        if saver is not None:
            saver.wait()
    if saver is not None:
        saver.raise_errors()
    if stats is not None and done >= spp:
        segments, slots, iters = ranks.reduce(stats).tolist()
        if deepest:
            # A pass runs one bounce iteration per segment of its deepest lane.
            iters = int(ranks.reduce(torch.stack(deepest), "max").sum())
        metrics.update(done, segments=segments, warp_slots=slots, iterations=iters,
                       passes=0 if regenerative else chunks_run)
    with tr.span("render/mean"):
        return (acc / float(max(done, 1))).reshape(h, w, 3)


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
    scene takes `render_path(scene)` through `render_loop` on one device;
    `wavefront` sizes the persistent path's lanes only. regenerative=False
    renders in passes instead: every lane traces one path to its end
    through `trace`, with no russian roulette, whatever the scene's path
    (the JAX driver's non-regenerative loop, driver.py:636-654).

    bilinear_stochastic (scenes with `bilinear_textures`, as in the JAX
    driver): None (default) filters images by the unbiased stochastic
    single tap on the persistent path; False forces the deterministic
    4-tap; True asks for the stochastic tap, which only the persistent path
    has. Other paths filter by the 4-tap.

    Russian roulette starts at depth 5 and caps the survival probability at
    0.75 on the persistent path and 0.95 on the wavefront-step path (the
    JAX driver's settings, driver.py:602); the large-scene path has none.
    It is unbiased.

    metrics: optional utils.metrics.RenderMetrics (`render_loop`'s); a
    clustered render also records its host clustering seconds (none when
    its tables come from the cache), the BVH builder and the cluster
    table's section lengths.

    The persistent and wavefront-step paths keep the scene's packed tables
    on `device` for the next render (`chunk_renderer`): a render of the
    same Scene and Camera objects, their tensors not edited in place, at
    the same settings copies nothing to the device before its chunks. An
    edited or new tensor, another camera or other settings pack anew;
    tensors that require grad are never cached.

    The render is a root span `render_image` of utils/trace.py, with
    `render/pack` (its counter `pack_hits` or `pack_misses`), a
    `render/chunk` a chunk (`render/kernel` and `render/fold` inside it)
    and `render/mean`."""
    with tr.span("render_image"):
        return render_loop(scene, cam, settings, path=None if regenerative else "passes",
                           device=device, seed=seed, wavefront=wavefront,
                           log_budget_bytes=log_budget_bytes, progress=progress,
                           metrics=metrics, bilinear_stochastic=bilinear_stochastic)


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
    ids alone, so any split of a pass's ids over positions traces the same
    per-lane values (`pass_block`, `large_scene_block`)."""
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


def pass_block(scene: Scene, cam: Camera, seed: int, *, shape: tuple[int, int], position: int,
               width: int, height: int, samples_per_pass: int, max_depth: int,
               sky_gradient: bool, intersect_fn=None):
    """Position `position`'s part of one pass on a mesh of `shape` (tiles,
    samples): its tile's pixels [p0, p1) (`lane_block`, pixel order) and
    its sample slots [si * k / S, (si + 1) * k / S); lane (slot, pixel) is
    global sample slot * n + pixel (`trace_samples`, its closest hit
    `intersect_fn` or trace's default). Position 0 of (1, 1) is the whole
    pass (the port of raytracer_tpu/render/driver.py:render_pass). Returns
    the tile's (p1 - p0, 3) radiance sums over those slots."""
    tiles, samples = shape
    ti, si = divmod(position, samples)
    n = width * height
    k_loc = samples_per_pass // samples
    dev = scene.sph_center.device
    p0, p1 = lane_block(n, ti, tiles)
    if p1 - p0 == n:  # the whole image: its slots are one run of sample ids
        sid = range(si * k_loc * n, (si + 1) * k_loc * n)
    else:
        slots = torch.arange(si * k_loc, (si + 1) * k_loc, device=dev)
        sid = (slots[:, None] * n + torch.arange(p0, p1, device=dev)[None, :]).reshape(-1)
    if len(sid) == 0:
        return torch.zeros(p1 - p0, 3, device=dev)
    frame = camera_frame(cam, width, height).to(dev)
    rad = trace_samples(scene, cam, frame, seed, sid, width=width, height=height,
                        max_depth=max_depth, sky_gradient=sky_gradient,
                        intersect_fn=intersect_fn)
    return rad.reshape(k_loc, p1 - p0, 3).sum(0)


def large_scene_block(scene: Scene, tables, cam: Camera, frame, seed: int, *, position: int,
                      size: int, width: int, height: int, k: int, max_depth: int,
                      sky_gradient: bool):
    """Position's contiguous block [start, stop) of a large-scene pass's
    k * n camera rays (`lane_block`; position 0 of 1: the whole pass), lane
    L sample id L at pixel L mod n under the pass's seed, no russian
    roulette (the JAX package's `trace`), over the cluster-ordered scene
    and its (ClusterTable, sphere table, quad table): camera rays (bounce
    0, coherent, in pixel order) through the cluster-culled kernel 4,
    bounces through kernel 1's clustered entry. Returns (radiance
    (stop - start, 3), segments (stop - start,) int32)."""
    clusters, sph, quad = tables
    start, stop = lane_block(k * width * height, position, size)
    if stop == start:
        return (torch.zeros(0, 3, device=sph.device),
                torch.zeros(0, dtype=torch.int32, device=sph.device))

    def hit_fn(scene, o, d, bounce, lanes):
        hit = ck.intersect_culled if bounce == 0 else ik.intersect_clustered
        return hit(clusters, sph, quad, o.contiguous(), d.contiguous())

    return trace_samples(scene, cam, frame, seed, range(start, stop), width=width, height=height,
                         max_depth=max_depth, sky_gradient=sky_gradient, intersect_fn=hit_fn,
                         return_segments=True)


def render_scene(scene: Scene, cam: Camera, settings: RenderSettings, **kw) -> np.ndarray:
    """Render and postprocess to uint8 (H, W, 3) on the host."""
    return to_u8(render_image(scene, cam, settings, **kw)).cpu().numpy()
