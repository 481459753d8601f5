"""Sharded gradient steps over a mesh of ranks (the port's counterpart of the
sharded training steps in the JAX package's `__graft_entry__.py`).

Both steps follow one pattern: every rank renders its share of the step's
samples with autograd or a tape, the per-pixel radiance sums are
all-reduced without autograd, every rank computes the loss and the image
cotangent from the same global image, backpropagates its own partial
against that cotangent, and the parameter gradients are all-reduced (SUM).
Every rank then holds the same gradients, so an optimizer stepping on each
rank keeps the parameters equal. The partial of any mesh position can be
computed alone (`partial`/`forward` and `grads`/`backward` on the step), so
a test sums the positions in one process.

* `make_sharded_scan_grad_fn`: the differentiable `trace` (closest hits by
  kernel 1 on CUDA, geometry.intersect.intersect_scene_kernel_diff) over
  the position's tile and sample slots of one pass, each lane keyed by its
  global sample id (parallel/shard.py:pass_block).
* `make_sharded_bucketed_grad_fn`: the tape-forward step
  (diff/bucketed.py): each rank runs the tape forward (kernel 3, or
  trace_tape_scene on scenes kernel 3 does not shade) on its share of
  samples_per_pass under `rank_seed(seed, position)` and replays its own
  tape, so at one rank it is make_bucketed_grad_fn's step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.diff.bucketed import (
    flat_leaves,
    image_loss,
    lane_cotangent,
    lane_depths,
    nest_like,
    replay_grads,
    replay_lanes,
    tape_forward,
)
from raytracer_tpu_torch.geometry.intersect import intersect_scene_kernel_diff
from raytracer_tpu_torch.parallel.mesh import Mesh, lane_block
from raytracer_tpu_torch.parallel.shard import pass_block, rank_seed, rank_share
from raytracer_tpu_torch.utils import trace as tr


def all_reduce_grads(grads: dict) -> dict:
    """`grads` (nested like the params) summed over the ranks: one
    all-reduce of their concatenation."""
    leaves = [g for _, g in flat_leaves(grads)]
    flat = torch.cat([g.reshape(-1) for g in leaves])
    dist.all_reduce(flat)
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return nest_like(grads, out)


def _grads(params: dict, value) -> dict:
    leaves = [t for _, t in flat_leaves(params)]
    return nest_like(params, torch.autograd.grad(value, leaves, allow_unused=True)
                     if value.requires_grad else [None] * len(leaves))


def make_sharded_scan_grad_fn(rebuild, cam: Camera, target, mesh: Mesh, *, width: int,
                              height: int, samples_per_pass: int, max_depth: int,
                              sky_gradient: bool = False):
    """`step(params, seed) -> (loss, grads)`: the MSE of one differentiable
    render of samples_per_pass samples per pixel (a multiple of the samples
    axis) against `target`, sharded as `render_pass_sharded` shards a pass,
    and its gradients summed over the ranks. `step.partial(params, seed,
    position)` is a position's (n_pixels, 3) radiance sums (zero outside
    its tile) with autograd, `step.grads(params, partial, ct_img)` its
    gradient share against the image cotangent."""
    n = width * height
    k = samples_per_pass
    tiles, samples = mesh.shape
    if k % samples != 0:
        raise ValueError(f"samples_per_pass={k} not divisible by the samples axis ({samples})")

    def partial(params, seed: int, position: int):
        blk = pass_block(rebuild(params), cam, seed, shape=mesh.shape, position=position,
                         width=width, height=height, samples_per_pass=k, max_depth=max_depth,
                         sky_gradient=sky_gradient, intersect_fn=intersect_scene_kernel_diff)
        p0, p1 = lane_block(n, position // samples, tiles)
        return torch.nn.functional.pad(blk, (0, 0, p0, n - p1))

    def grads(params, part, ct_img):
        return _grads(params, (part * (ct_img.reshape(n, 3) / float(k))).sum())

    def step(params, seed: int):
        part = partial(params, seed, mesh.position)
        img_sum = part.detach().clone()
        dist.all_reduce(img_sum)
        loss, ct_img = image_loss(img_sum, target, k)
        return loss, all_reduce_grads(grads(params, part, ct_img))

    step.partial, step.grads = partial, grads
    return step


class RankTape(NamedTuple):
    """A position's tape forward: its samples per pixel, its seed, per-lane
    radiance (samples * n, 3), tape (max_depth, samples * n) and per-pixel
    radiance sums (n, 3); radiance and tape are None with no samples."""

    samples: int
    seed: int
    radiance: torch.Tensor | None
    tape: torch.Tensor | None
    img_sum: torch.Tensor


def make_sharded_bucketed_grad_fn(rebuild, cam: Camera, target, mesh: Mesh, *, width: int,
                                  height: int, samples_per_pass: int, max_depth: int,
                                  sky_gradient: bool = False):
    """`step(params, seed, timings=None) -> (loss, grads)`: the tape-forward
    step of diff/bucketed.py sharded over the mesh. Position p runs the
    tape forward on rank_share(samples_per_pass, p, D) samples per pixel
    under rank_seed(seed, p) (`step.forward(params, seed, p)` -> RankTape),
    the image sums are all-reduced, and each rank replays its own tape
    against the global image cotangent (`step.backward(params, rank_tape,
    ct_img)`) before the gradients are all-reduced. With one rank this is
    make_bucketed_grad_fn's step bit for bit. Its phases are that step's
    spans (the replay's lane set-up inside "replay_forward") plus
    "image_all_reduce" and "grad_all_reduce" (utils/trace.py), whose
    seconds `timings` gets."""
    dev = target.device
    n = width * height
    k = samples_per_pass
    shape_kw = dict(width=width, height=height, max_depth=max_depth, sky_gradient=sky_gradient)

    def forward(params, seed: int, position: int) -> RankTape:
        share, s = rank_share(k, position, mesh.size), rank_seed(seed, position)
        if share == 0:
            return RankTape(0, s, None, None, torch.zeros(n, 3, device=dev))
        rad, tape = tape_forward(params, rebuild, None, cam, s, share * n, device=dev,
                                 **shape_kw)
        return RankTape(share, s, rad, tape, rad.reshape(share, n, 3).sum(0))

    def backward(params, rt: RankTape, ct_img, timings=None):
        if rt.samples == 0:
            return nest_like(params, [None] * len(flat_leaves(params)))
        with tr.phase("replay_forward", timings, dev), torch.no_grad():
            ct_lane = lane_cotangent(ct_img, rt.samples, k)
            lane_depth = lane_depths(rt.tape)
            lanes = replay_lanes(lane_depth, sky_gradient, None)
        return replay_grads(params, rebuild, None, cam, rt.seed, rt.tape, ct_lane, lanes,
                            lane_depth, timings=timings, **shape_kw)

    def step(params, seed: int, timings=None):
        with tr.phase("tape_forward", timings, dev):
            rt = forward(params, seed, mesh.position)
        with tr.phase("image_all_reduce", timings, dev):
            img_sum = rt.img_sum.clone()
            dist.all_reduce(img_sum)
        with tr.phase("loss_cotangent", timings, dev), torch.no_grad():
            loss, ct_img = image_loss(img_sum, target, k)
        grads = backward(params, rt, ct_img, timings)
        with tr.phase("grad_all_reduce", timings, dev):
            grads = all_reduce_grads(grads)
        return loss, grads

    step.forward, step.backward = forward, backward
    return step
