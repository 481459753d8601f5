"""Sharded rendering over a (tiles, samples) mesh of ranks (port of
raytracer_tpu/parallel/shard.py).

Every rank traces its own share of the work with the single-device kernels
and rays never migrate; the collectives are torch.distributed's, outside
the kernels: an all-reduce (SUM) of the per-pixel radiance sums, an
all-gather where ranks hold disjoint blocks, and a SUM or MAX of the
statistics. Under gloo the tensors may live on CUDA: gloo's collectives
take CUDA tensors.

The loop is the single device's, render/driver.py:render_loop, at this
rank's mesh position; `MeshRanks` joins the positions' partials: a
regenerative chunk's share of the samples (spp // D + (position < spp %
D) under `rank_seed(chunk seed, position)`) by an all-reduce; a pass's
tile and sample slots by an all-reduce over the samples axis and a gather
of the tiles in pixel order; a large-scene pass's contiguous block of
lanes by a gather at the pass's end, its k layers summed in the unsharded
order, so that path is one device's image bit for bit at any world size
(on a device whose per-lane arithmetic does not depend on the lane's place
in the batch). At one rank every path is render_image's image bit for bit.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.camera import Camera, RenderSettings
from raytracer_tpu_torch.geometry.scene import Scene
from raytracer_tpu_torch.parallel.mesh import Mesh
from raytracer_tpu_torch.render.checkpoint import config_fingerprint
from raytracer_tpu_torch.render.driver import (
    DEFAULT_WAVEFRONT,
    LOG_BUDGET_BYTES,
    Ranks,
    chunk_renderer,
    default_spp_chunk,
    path_wavefront,
    rank_seed,  # noqa: F401 (the rank seed of a position, importable from here)
    rank_share,  # noqa: F401 (a position's share of a chunk, importable from here)
    regen_partial,
    render_loop,
    render_path,
)
from raytracer_tpu_torch.utils import trace as tr


def _gather_blocks(mesh: Mesh, block, per: int, total: int, group=None, members=None):
    """Every rank's `block` (L, 3) of a flat axis split by `lane_block`
    into blocks of `per` lanes, gathered over `group` (default the whole
    mesh; its `members`) and concatenated in position order: (total, 3).
    all_gather returns them in group rank order, ascending global rank."""
    members = list(mesh.ranks) if members is None else members
    padded = torch.nn.functional.pad(block, (0, 0, 0, per - block.shape[0]))
    out = [torch.empty_like(padded) for _ in members]
    dist.all_gather(out, padded.contiguous(), group=group)
    order = sorted(members)
    return torch.cat([out[order.index(r)] for r in sorted(members, key=mesh.ranks.index)])[:total]


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


class MeshRanks(Ranks):
    """This rank's position on `mesh` in render/driver.py:render_loop, and
    the collectives that join the positions' partials. Rank 0 is the root.

    A chunk's join is a span `render/all_reduce` (counter
    `all_reduce_bytes`, the framebuffer's bytes); with the recorder on, a
    chunk's span counts `rank_segments`, the segments this rank traced."""

    what = "mesh"

    def __init__(self, mesh: Mesh):
        self.mesh, self.root = mesh, dist.get_rank() == 0
        self.position, self.size, self.shape = mesh.position, mesh.size, mesh.shape

    def check_same(self, label, *tensors):
        _check_same(self.mesh, label, *tensors)

    def count_segments(self, segs):
        if tr.enabled():
            tr.count("rank_segments", segs.sum())

    def join_chunk(self, fb):
        with tr.span("render/all_reduce"):
            tr.count("all_reduce_bytes", fb.numel() * fb.element_size())
            dist.all_reduce(fb)
        return fb

    def join_pass(self, blk, n):
        mesh = self.mesh
        if mesh.sample_group is not None:
            dist.all_reduce(blk, group=mesh.sample_group)
        if mesh.tile_group is not None:
            members = list(mesh.ranks[mesh.sample_index::mesh.shape[1]])
            blk = _gather_blocks(mesh, blk, -(-n // mesh.shape[0]), n, mesh.tile_group, members)
        return blk

    def join_lanes(self, rad, per, total):
        return _gather_blocks(self.mesh, rad, per, total)

    def reduce(self, t, op="sum"):
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
        return t

    def broadcast(self, t):
        dist.broadcast(t, src=0)
        return t


class RegenStats(NamedTuple):
    """Statistics of a sharded regenerative chunk, over every rank."""

    segments: int  # traced segments
    rank_segments_max: int  # the most segments one rank traced (load balance)


def render_regen_sharded(scene: Scene, cam: Camera, seed: int, mesh: Mesh, *, width: int,
                         height: int, spp: int, max_depth: int, sky_gradient: bool = False,
                         wavefront: int = DEFAULT_WAVEFRONT, clusters=None):
    """One sharded regenerative chunk: every rank renders its share of
    `spp` samples per pixel (driver.regen_partial) on the scene's path, and
    the per-pixel sums reduce over the mesh with one all-reduce. `clusters`
    (a geometry.bvh.ClusterSet of a scene already in cluster order) runs
    kernel 2's culled instantiation on that table, checked equal on every
    rank. Returns (the (height, width, 3) framebuffer of radiance sums over
    spp samples, RegenStats)."""
    settings = RenderSettings(width, height, spp, max_depth, sky_gradient)
    renderer = chunk_renderer(scene, cam, settings, mesh.device, wavefront=wavefront,
                              clusters=clusters)
    if renderer.clusters is not None:
        _check_same(mesh, "the cluster table", renderer.clusters.rows, *renderer.tables[:2])
    fb, segs, _ = regen_partial(renderer, spp, seed, mesh.position, mesh.size)
    dist.all_reduce(fb)
    mine = segs.sum().to(torch.int64).reshape(1)
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine)
    every = torch.cat(every)
    return fb.reshape(height, width, 3), RegenStats(int(every.sum()), int(every.max()))


def render_large_scene_sharded(scene: Scene, cam: Camera, settings: RenderSettings, mesh: Mesh,
                               *, seed: int = 0, progress: bool = False,
                               metrics=None) -> torch.Tensor:
    """The large-scene path sharded (port of JAX's
    render_large_scene_sharded), on any scene: every rank clusters the
    scene as the single-device path does (deterministic; the ranks' tables
    are checked equal), then per pass of k samples per pixel
    (samples_per_pass_for at TARGET_RAYS_PER_PASS rays a rank) traces its
    lane block; the blocks are gathered at the pass's end and their k
    layers summed as one device sums them (driver.render_loop). Returns
    the linear mean radiance (H, W, 3) on every rank."""
    return render_loop(scene, cam, settings, MeshRanks(mesh), path="large_scene",
                       device=mesh.device, seed=seed, progress=progress, metrics=metrics)


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
    """Full sharded render on `mesh.device` through driver.render_loop at
    this rank's position, routed as render_image routes; returns the
    linear mean radiance (H, W, 3) on every rank. A chunk's size is the
    largest whose every rank's share fits `log_budget_bytes`
    (default_spp_chunk); regenerative=False runs the pass loop, in passes
    of a multiple of the samples axis. metrics: summed over the ranks once
    at the end. progress: printed by rank 0.

    checkpoint_path: the regenerative loop saves after every chunk (rank
    0) and resumes from the file when it is there (rank 0 loads and
    broadcasts it), bit-identical to an uninterrupted render on the same
    mesh shape; the fingerprint adds the mesh's axes and shape, the lanes,
    the path, the image filter and the device type. `max_chunks` stops
    after that many chunks. The large-scene path and the pass loop refuse
    a checkpoint path.

    The render is a root span `render_image_sharded` of utils/trace.py. On
    the regenerative loop it holds `render/pack` (the rank's tables), a
    `render/chunk` a chunk (the rank's partial, with `render/kernel` and
    `render/fold`; counter `rank_segments`), a `render/all_reduce` a chunk
    (counter `all_reduce_bytes`) and `render/mean`."""
    path = render_path(scene) if regenerative else "passes"
    checkpoint = None
    if checkpoint_path:
        if path in ("passes", "large_scene"):
            raise ValueError(
                "checkpointing requires the regenerative sharded path; the "
                f"{'large-scene path' if regenerative else 'pass loop'} does not checkpoint")
        chunk = default_spp_chunk(scene, settings, wavefront=wavefront,
                                  log_budget_bytes=log_budget_bytes, ranks=mesh.size)
        lanes = path_wavefront(path, settings.width * settings.height, wavefront)
        checkpoint = (checkpoint_path, config_fingerprint(
            scene, cam, settings, chunk, seed,
            extra=("sharded", mesh.axis_names, mesh.shape, lanes, path, bilinear_stochastic,
                   mesh.device.type),
        ))
    return render_loop(scene, cam, settings, MeshRanks(mesh), path=path, device=mesh.device,
                       seed=seed, wavefront=wavefront, log_budget_bytes=log_budget_bytes,
                       progress=progress, metrics=metrics,
                       bilinear_stochastic=bilinear_stochastic, checkpoint=checkpoint,
                       max_chunks=max_chunks)
