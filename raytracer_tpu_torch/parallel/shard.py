"""Sharded rendering over a (tiles, samples) mesh of ranks (port of
raytracer_tpu/parallel/shard.py).

Every rank traces its own share of the work with the single-device kernels
and rays never migrate; the collectives are torch.distributed's, outside
the kernels: an all-reduce (SUM) of the per-pixel radiance sums, an
all-gather where ranks hold disjoint blocks, and a SUM or MAX of the
statistics. Under gloo the tensors may live on CUDA: gloo's collectives
take CUDA tensors.

* `render_regen_sharded`: the regenerative paths (kernel 2, dense or
  culled, on the persistent path; kernel 5 on the wavefront-step path).
  A chunk of spp samples per pixel splits over all D ranks as
  spp // D + (position < spp % D); each rank renders its share with the
  chunk's own kernel call under `rank_seed(chunk seed, position)`, so at
  D = 1 the sharded render is `render_image` bit for bit, and any rank's
  partial can be computed alone, with no process group (`regen_partial`).
* `render_pass_sharded`: one pass of the non-regenerative loop, pixels
  split over tiles and sample slots over samples, each lane keyed by its
  global sample id (render/driver.py:trace_samples); the samples axis
  reduces over its group and the tiles are gathered in pixel order.
* `render_large_scene_sharded`: the large-scene path; each rank traces one
  contiguous, pixel-ordered block of a pass's k * n camera rays, keyed by
  global sample id (kernel 4 for camera rays, kernel 1's clustered entry
  for bounces); no collective inside a pass, the blocks gathered at its
  end and summed in the unsharded order, so the image is
  `_render_large_scene`'s bit for bit at any world size (on a device whose
  per-lane arithmetic does not depend on the lane's place in the batch).
* `render_image_sharded` routes a scene as render_image does, with
  metrics, progress on rank 0, and checkpoints (rank 0 saves; on resume
  rank 0 loads and broadcasts the saved state).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.camera import Camera, RenderSettings, camera_frame
from raytracer_tpu_torch.geometry.scene import Scene
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.parallel.mesh import Mesh, lane_block
from raytracer_tpu_torch.render.driver import (
    DEFAULT_WAVEFRONT,
    LOG_BUDGET_BYTES,
    TARGET_RAYS_PER_PASS,
    ChunkRenderer,
    chunk_renderer,
    chunk_seed,
    default_spp_chunk,
    large_scene_hit,
    large_scene_tables,
    render_path,
    samples_per_pass_for,
    trace_samples,
)
from raytracer_tpu_torch.integrator.wavefront import strided_schedule
from raytracer_tpu_torch.utils import trace as tr
from raytracer_tpu_torch.utils.metrics import warp_slots

# Counter of the rank-seed stream: rank_seed hashes (seed, position, this);
# chunk_seed hashes (seed, chunk, 0), so the two streams never share an input.
RANK_SEED_CTR = 1


def rank_seed(seed: int, position: int) -> int:
    """Seed of mesh position `position` in a chunk seeded `seed`: position 0
    keeps the seed (so one rank renders what render_image renders), the
    others hash (seed, position)."""
    return seed if position == 0 else int(ctr_rng.hash_i32(seed, position, RANK_SEED_CTR))


def rank_share(total: int, position: int, size: int) -> int:
    """Position's share of `total` samples split over `size` positions as
    evenly as integers allow (the shares sum to total)."""
    return total // size + (1 if position < total % size else 0)


def is_root() -> bool:
    return dist.get_rank() == 0


def _by_position(mesh: Mesh, blocks, members) -> list:
    """`blocks` of an all_gather over the group of `members` (group rank
    order, which is ascending global rank) in mesh-position order."""
    order = sorted(members)
    return [blocks[order.index(r)] for r in sorted(members, key=mesh.ranks.index)]


def _gather_blocks(mesh: Mesh, block, per: int, total: int, group=None, members=None):
    """Every rank's `block` (L, 3) of a flat axis split by `lane_block`
    into blocks of `per` lanes, gathered over `group` (default the whole
    mesh) and concatenated in position order: (total, 3)."""
    members = list(mesh.ranks) if members is None else members
    padded = torch.nn.functional.pad(block, (0, 0, 0, per - block.shape[0]))
    out = [torch.empty_like(padded) for _ in members]
    dist.all_gather(out, padded.contiguous(), group=group)
    return torch.cat(_by_position(mesh, out, members))[:total]


def _check_same(mesh: Mesh, label: str, *tensors) -> None:
    """Raise unless every rank holds the same bytes in `tensors` (the
    clustering each rank computes on its own must agree)."""
    if mesh.size == 1:
        return
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    mine = torch.tensor([int.from_bytes(h.digest()[:7], "little")], dtype=torch.int64,
                        device=mesh.device)
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine)
    if any(int(e) != int(mine) for e in every):
        raise RuntimeError(f"ranks disagree on {label}")


class RegenStats(NamedTuple):
    """Statistics of a sharded regenerative chunk, over every rank."""

    segments: int  # traced segments
    rank_segments_max: int  # the most segments one rank traced (load balance)


def regen_partial(renderer: ChunkRenderer, spp: int, seed: int, position: int, size: int):
    """Mesh position `position`'s partial of a regenerative chunk of `spp`
    samples per pixel seeded `seed` over `size` positions: (framebuffer
    (n_pixels, 3) radiance sums, segments per lane (N,) int32,
    iterations). A position whose share is 0 contributes zeros."""
    share = rank_share(spp, position, size)
    if share == 0:
        dev = renderer.cam_scalars.device
        return (torch.zeros(renderer.width * renderer.height, 3, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev), 0)
    return renderer.render(share, rank_seed(seed, position))


def regen_renderer(scene, cam, settings, mesh, **kw) -> ChunkRenderer:
    """render/driver.py:chunk_renderer on the mesh's device; a clustered
    scene's table is checked equal on every rank."""
    renderer = chunk_renderer(scene, cam, settings, mesh.device, **kw)
    if renderer.clusters is not None:
        _check_same(mesh, "the cluster table", renderer.clusters.rows, *renderer.tables[:2])
    return renderer


def render_regen_sharded(scene: Scene, cam: Camera, seed: int, mesh: Mesh, *, width: int,
                         height: int, spp: int, max_depth: int, sky_gradient: bool = False,
                         wavefront: int = DEFAULT_WAVEFRONT, clusters=None):
    """One sharded regenerative chunk: every rank renders its share of
    `spp` samples per pixel (`regen_partial`) on the scene's path, and the
    per-pixel sums reduce over the mesh with one all-reduce. `clusters`
    (a geometry.bvh.ClusterSet of a scene already in cluster order) runs
    kernel 2's culled instantiation on that table. Returns (the (height,
    width, 3) framebuffer of radiance sums over spp samples, RegenStats)."""
    settings = RenderSettings(width, height, spp, max_depth, sky_gradient)
    renderer = regen_renderer(scene, cam, settings, mesh, wavefront=wavefront,
                              clusters=clusters)
    fb, segs, _ = regen_partial(renderer, spp, seed, mesh.position, mesh.size)
    dist.all_reduce(fb)
    mine = segs.sum().to(torch.int64).reshape(1)
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine)
    every = torch.cat(every)
    return fb.reshape(height, width, 3), RegenStats(int(every.sum()), int(every.max()))


def sharded_samples_per_pass(spp: int, num_pixels: int, mesh: Mesh,
                             target_rays: int = TARGET_RAYS_PER_PASS) -> int:
    """Largest k dividing spp with k a multiple of the samples axis and
    k * num_pixels <= target_rays where it can be. A valid k exists iff spp
    is a multiple of the samples axis; otherwise ValueError."""
    n_samp = mesh.shape[1]
    if spp % n_samp != 0:
        raise ValueError(
            f"spp={spp} must be a multiple of the sample-axis size ({n_samp}) for the "
            "pass-based sharded render; use regenerative=True (the default), which splits "
            "any spp exactly")
    ideal = max(n_samp, min(spp, target_rays // max(1, num_pixels)))
    return next((k for k in range(ideal, 0, -1) if spp % k == 0 and k % n_samp == 0), n_samp)


def pass_block(scene: Scene, cam: Camera, seed: int, *, shape: tuple[int, int], position: int,
               width: int, height: int, samples_per_pass: int, max_depth: int,
               sky_gradient: bool, intersect_fn=None):
    """Position `position`'s part of one pass on a mesh of `shape`: its
    tile's pixels [p0, p1) (contiguous, pixel order) and its samples slots
    [si * k / S, (si + 1) * k / S); lane (slot, pixel) is global sample
    slot * n + pixel (`trace_samples`, its closest hit `intersect_fn` or
    trace's default). Returns the tile's (p1 - p0, 3) radiance sums over
    those slots."""
    tiles, samples = shape
    ti, si = divmod(position, samples)
    n = width * height
    k_loc = samples_per_pass // samples
    dev = scene.sph_center.device
    p0, p1 = lane_block(n, ti, tiles)
    slots = torch.arange(si * k_loc, (si + 1) * k_loc, device=dev)
    sid = (slots[:, None] * n + torch.arange(p0, p1, device=dev)[None, :]).reshape(-1)
    if sid.numel() == 0:
        return torch.zeros(p1 - p0, 3, device=dev)
    frame = camera_frame(cam, width, height).to(dev)
    rad = trace_samples(scene, cam, frame, seed, sid, width=width, height=height,
                        max_depth=max_depth, sky_gradient=sky_gradient,
                        intersect_fn=intersect_fn)
    return rad.reshape(k_loc, p1 - p0, 3).sum(0)


def render_pass_sharded(scene: Scene, cam: Camera, seed: int, *, mesh: Mesh, width: int,
                        height: int, samples_per_pass: int, max_depth: int,
                        sky_gradient: bool) -> torch.Tensor:
    """One sharded pass: every pixel's radiance sum over samples_per_pass
    samples, (height, width, 3) on every rank. Each rank traces
    `pass_block`; the sums reduce over the samples axis and the tiles are
    gathered in pixel order. samples_per_pass must be a multiple of the
    samples axis (`sharded_samples_per_pass`)."""
    if samples_per_pass % mesh.shape[1] != 0:
        raise ValueError(f"samples_per_pass={samples_per_pass} not divisible by the "
                         f"samples axis ({mesh.shape[1]})")
    n = width * height
    blk = pass_block(scene, cam, seed, shape=mesh.shape, position=mesh.position, width=width,
                     height=height, samples_per_pass=samples_per_pass, max_depth=max_depth,
                     sky_gradient=sky_gradient)
    if mesh.sample_group is not None:
        dist.all_reduce(blk, group=mesh.sample_group)
    if mesh.tile_group is not None:
        members = list(mesh.ranks[mesh.sample_index::mesh.shape[1]])
        blk = _gather_blocks(mesh, blk, -(-n // mesh.shape[0]), n, mesh.tile_group, members)
    return blk.reshape(height, width, 3)


def large_scene_block(scene: Scene, tables, cam: Camera, frame, seed: int, *, position: int,
                      size: int, width: int, height: int, k: int, max_depth: int,
                      sky_gradient: bool):
    """Position's contiguous block [start, stop) of a large-scene pass's k *
    n camera rays (`lane_block`), traced by global sample id with the
    path's hits over the cluster-ordered scene and its tables
    (render/driver.py:large_scene_tables). Returns (radiance (stop -
    start, 3), segments (stop - start,) int32)."""
    dev = tables[1].device
    start, stop = lane_block(k * width * height, position, size)
    if stop == start:
        return (torch.zeros(0, 3, device=dev), torch.zeros(0, dtype=torch.int32, device=dev))
    return trace_samples(scene, cam, frame, seed, range(start, stop), width=width, height=height,
                         max_depth=max_depth, sky_gradient=sky_gradient,
                         intersect_fn=large_scene_hit(tables), return_segments=True)


def render_large_scene_sharded(scene: Scene, cam: Camera, settings: RenderSettings, mesh: Mesh,
                               *, seed: int = 0, progress: bool = False,
                               metrics=None) -> torch.Tensor:
    """The large-scene path sharded (port of JAX's
    render_large_scene_sharded): every rank clusters the scene as the
    single-device path does (deterministic; the ranks' tables are checked
    equal), then per pass of k samples per pixel (samples_per_pass_for at
    TARGET_RAYS_PER_PASS rays a rank) traces its block (`large_scene_block`);
    the blocks are gathered at the pass's end and their k layers summed as
    `_render_large_scene` sums them. Returns the linear mean radiance (H,
    W, 3) on every rank."""
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n = w * h
    dev = mesh.device
    scene, tables = large_scene_tables(scene.to(dev), cam, dev, metrics)
    _check_same(mesh, "the cluster table", tables[0].rows, tables[1], tables[2])
    frame = camera_frame(cam, w, h).to(dev)
    k = samples_per_pass_for(spp, n, TARGET_RAYS_PER_PASS * mesh.size)
    passes = -(-spp // k)
    if metrics is not None:
        metrics.wavefront_lanes = -(-(k * n) // mesh.size)
    acc = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    stats = torch.zeros(passes, 2, dtype=torch.int64, device=dev)  # segments, deepest lane
    done = 0
    for p in range(passes):
        step = min(k, spp - done)
        rad, segs = large_scene_block(scene, tables, cam, frame, chunk_seed(seed, p),
                                      position=mesh.position, size=mesh.size, width=w,
                                      height=h, k=step, max_depth=settings.max_depth,
                                      sky_gradient=settings.sky_gradient)
        lanes = _gather_blocks(mesh, rad, -(-(step * n) // mesh.size), step * n)
        acc += lanes.reshape(step, n, 3).sum(0)
        if segs.numel():
            stats[p, 0], stats[p, 1] = segs.sum(), segs.max()
        done += step
        if metrics is not None:
            metrics.update(done)
        if progress and is_root():
            print(f"pass {p + 1}/{passes} ({done}/{spp} spp)", flush=True)
    if metrics is not None:
        seg_total, deepest = stats[:, 0].sum().reshape(1), stats[:, 1].clone()
        dist.all_reduce(seg_total)
        dist.all_reduce(deepest, op=dist.ReduceOp.MAX)
        metrics.update(done, segments=int(seg_total), iterations=int(deepest.sum()),
                       passes=passes)
    return (acc / float(spp)).reshape(h, w, 3)


def _fingerprint(scene, cam, settings, chunk, seed, mesh, renderer, bilinear_stochastic):
    from raytracer_tpu_torch.render.checkpoint import config_fingerprint

    return config_fingerprint(
        scene, cam, settings, chunk, seed,
        extra=("sharded", mesh.axis_names, mesh.shape, renderer.wavefront, renderer.path,
               bilinear_stochastic, mesh.device.type),
    )


def _resume(checkpoint_path: str, fingerprint: str, acc, mesh: Mesh):
    """(done, chunk index) of the checkpoint at `checkpoint_path`, (0, 0)
    without one; rank 0 reads it and broadcasts its state and sums into
    `acc` (in place). A checkpoint of another configuration raises
    ValueError on every rank."""
    from raytracer_tpu_torch.render.checkpoint import load_checkpoint

    state = torch.zeros(3, dtype=torch.int64, device=mesh.device)  # found (1) / refused (2)
    if is_root():
        ck = load_checkpoint(checkpoint_path)
        if ck is not None and ck.config_hash != fingerprint:
            state[0] = 2
        elif ck is not None:
            state[:] = torch.tensor([1, ck.done_spp, ck.chunk_idx])
            acc.copy_(torch.from_numpy(np.ascontiguousarray(ck.acc, np.float32)).reshape(
                acc.shape))
    dist.broadcast(state, src=0)
    if int(state[0]) == 2:
        raise ValueError(
            f"checkpoint {checkpoint_path} was written under a different "
            "scene/camera/settings/mesh configuration; refusing to resume (delete it to "
            "restart)")
    if int(state[0]) == 1:
        dist.broadcast(acc, src=0)
    return int(state[1]), int(state[2])


@tr.spanned("render_image_sharded")
def render_image_sharded(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    mesh: Mesh,
    *,
    seed: int = 0,
    regenerative: bool = True,
    wavefront: int = DEFAULT_WAVEFRONT,
    log_budget_bytes: int = LOG_BUDGET_BYTES,
    progress: bool = False,
    metrics=None,
    checkpoint_path: str | None = None,
    max_chunks: int | None = None,
    bilinear_stochastic: bool | None = None,
) -> torch.Tensor:
    """Full sharded render on `mesh.device`; returns the linear mean
    radiance (H, W, 3) on every rank.

    The scene takes render_image's route: the persistent and wavefront-step
    paths run the regenerative chunk loop, each chunk split over the ranks
    (`regen_partial`) and all-reduced; chunk c is seeded chunk_seed(seed,
    c) as in render_image, and a chunk's size is the largest whose every
    rank's share fits `log_budget_bytes` (default_spp_chunk). The
    large-scene path runs `render_large_scene_sharded`; regenerative=False
    the pass loop of `render_pass_sharded` (passes of
    `sharded_samples_per_pass`, pass p seeded chunk_seed(seed, p)). At one
    rank each is render_image's (or _render_large_scene's) image bit for bit.

    metrics: traced segments (and warp slots, iterations) summed over the
    ranks once at the end; the occupancy basis is one rank's lanes.
    progress: printed by rank 0.

    checkpoint_path: the regenerative loop saves after every chunk (rank
    0, on a BackgroundSaver thread) and resumes from the file when it is
    there, bit-identical to an uninterrupted render on the same mesh
    shape; the fingerprint adds the mesh's axes and shape, the lanes, the
    path, the image filter and the device type, and a checkpoint of
    another configuration is refused on every rank. `max_chunks` stops
    after that many chunks. The large-scene path and the pass loop do not
    checkpoint and refuse a checkpoint path.

    The render is a root span `render_image_sharded` of utils/trace.py. On
    the regenerative loop it holds `render/pack` (the rank's tables), a
    `render/chunk` a chunk (the rank's partial, with `render/kernel` and
    `render/fold`; counter `rank_segments`, the segments this rank
    traced), a `render/all_reduce` a chunk (counter `all_reduce_bytes`,
    the framebuffer's bytes) and `render/mean`."""
    from raytracer_tpu_torch.render.checkpoint import BackgroundSaver, RenderCheckpoint

    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    dev = mesh.device
    path = render_path(scene)
    if not regenerative or path == "large_scene":
        if checkpoint_path:
            raise ValueError(
                "checkpointing requires the regenerative sharded path; the "
                f"{'large-scene path' if regenerative else 'pass loop'} does not checkpoint")
        if regenerative:
            return render_large_scene_sharded(scene, cam, settings, mesh, seed=seed,
                                              progress=progress, metrics=metrics)
        k = sharded_samples_per_pass(spp, w * h, mesh)
        scene = scene.to(dev)
        acc = torch.zeros(h, w, 3, dtype=torch.float32, device=dev)
        for p in range(spp // k):
            acc += render_pass_sharded(scene, cam, chunk_seed(seed, p), mesh=mesh, width=w,
                                       height=h, samples_per_pass=k,
                                       max_depth=settings.max_depth,
                                       sky_gradient=settings.sky_gradient)
            if metrics is not None:
                metrics.update((p + 1) * k)
            if progress and is_root():
                print(f"pass {p + 1}/{spp // k} ({(p + 1) * k}/{spp} spp)", flush=True)
        return acc / float(spp)

    with tr.span("render/pack"):
        renderer = regen_renderer(scene, cam, settings, mesh, wavefront=wavefront,
                                  metrics=metrics, bilinear_stochastic=bilinear_stochastic)
    chunk = default_spp_chunk(scene, settings, wavefront=wavefront,
                              log_budget_bytes=log_budget_bytes, ranks=mesh.size)
    if metrics is not None:
        n, num_slots, _ = strided_schedule(w * h, -(-chunk // mesh.size), renderer.wavefront)
        metrics.wavefront_lanes = n
        metrics.retirement_log_mb = 3 * num_slots * n * 4 / 2**20
    acc = torch.zeros(w * h, 3, dtype=torch.float32, device=dev)
    done, chunk_idx = 0, 0
    saver, fingerprint = None, ""
    if checkpoint_path:
        fingerprint = _fingerprint(scene, cam, settings, chunk, seed, mesh, renderer,
                                   bilinear_stochastic)
        done, chunk_idx = _resume(checkpoint_path, fingerprint, acc, mesh)
        if done and progress and is_root():
            print(f"resumed at {done}/{spp} spp", flush=True)
        if is_root():
            saver = BackgroundSaver(checkpoint_path)
    # Per rank: segments, warp slots, iterations; summed over ranks at the end.
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    chunks_run = 0
    try:
        while done < spp and (max_chunks is None or chunks_run < max_chunks):
            step = min(chunk, spp - done)
            with tr.span("render/chunk"):
                fb, segs, it = regen_partial(renderer, step, chunk_seed(seed, chunk_idx),
                                             mesh.position, mesh.size)
                if tr.enabled():
                    tr.count("rank_segments", segs.sum())
            with tr.span("render/all_reduce"):
                tr.count("all_reduce_bytes", fb.numel() * fb.element_size())
                dist.all_reduce(fb)
            acc = acc + fb
            if metrics is not None and segs.numel():
                stats[0] += segs.sum()
                if renderer.path == "persistent":
                    stats[1] += warp_slots(segs)
                stats[2] += it
            done += step
            chunk_idx += 1
            chunks_run += 1
            if saver is not None:
                host = acc.reshape(h, w, 3).to("cpu", copy=True).numpy()
                saver.submit(RenderCheckpoint(acc=host, done_spp=done, seed=seed,
                                              chunk_idx=chunk_idx, config_hash=fingerprint))
            if metrics is not None:
                metrics.update(done)
            if progress and is_root():
                print(f"spp {done}/{spp}", flush=True)
    finally:
        if saver is not None:
            saver.wait()
    if saver is not None:
        saver.raise_errors()
    if metrics is not None:
        dist.all_reduce(stats)
        metrics.update(done, segments=int(stats[0]), warp_slots=int(stats[1]),
                       iterations=int(stats[2]))
    with tr.span("render/mean"):
        return (acc / float(max(done, 1))).reshape(h, w, 3)
