"""Tape-forward gradient step (port of raytracer_tpu/diff/bucketed.py,
`make_bucketed_grad_fn(forward="kernel")`, interior gradients).

One step:

1. **Tape forward**, no autograd: one launch of the tape kernel (kernel 3,
   ops/persistent_kernel.py:render_persistent_tape) traces every
   (sample, pixel) lane to its end and records its per-bounce winners.
   Lane L is sample id L, pixel L mod (width*height). Noise and image
   textures are shaded in the kernel; bilinear scenes take the
   deterministic 4-tap filter there and in the replay, as in JAX
   (raytracer_tpu/diff/bucketed.py:601-612).
2. **Finish**: the image, the MSE loss, the per-lane cotangent of the loss
   from the forward image, and each lane's depth min(last hit + 2,
   max_depth) from the tape.
3. **Replay**: the differentiable `trace` of those lanes with the tape
   intersector (diff/tape.py) and the same counter-RNG uniforms, whose
   radiance dotted with the cotangents has the loss gradient as its
   gradient. Lanes of depth 1 missed everything at once: their radiance is
   the flat background, which no scene parameter touches, so they are
   skipped (unless the sky gradient makes the background depend on the ray).

What the JAX package needed and this port does not: the two-phase forward
(`fwd_cap`), because a TPU tile of 8K lanes drains at its deepest lane
while a warp drains at its deepest of 32, so one launch to max_depth is the
design here; and the depth ladder with its padded bucket sizes
(`default_depth_ladder`, `_PadMemo`), which served XLA's static shapes and
compile cache. The eager replay instead works at each bounce on the lanes
still alive, so its work follows the real lane-bounces with no padding;
the gradient is the same sum.

With `edge_image_fns` (diff/boundary.py's zero-valued edge images), the
step adds their gradients as VJPs against the forward's image cotangent
(`compose_edges`, JAX `_compose_edges`).
"""

from __future__ import annotations

import time

import torch

from raytracer_tpu_torch.core.camera import Camera, camera_frame, camera_rays
from raytracer_tpu_torch.diff.tape import make_tape_intersect_fn
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.integrator.wavefront import trace
from raytracer_tpu_torch.materials.packed import texture_tables
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops.persistent_kernel import (
    pack_camera_scalars_bg,
    pack_persistent_tables,
    render_persistent_tape,
    unsupported_reason,
)


# Counter of the edge terms' seed stream (the JAX package folds its step key
# with 6070 for them).
EDGE_SEED_STREAM = 6070


def edge_seed(seed: int, i: int) -> int:
    """Seed of edge term i in a step seeded `seed`: the scan and bucketed
    backends give edge term i the same seed, and none of them shares the
    interior render's."""
    return int(ctr_rng.hash_i32(seed, EDGE_SEED_STREAM, i + 1))


def compose_edges(edge_image_fns, params: dict, cam: Camera, seed: int, ct_img):
    """Gradients, keyed like `params`, of sum over i of sum(fn_i(params,
    cam, edge_seed(seed, i)) * ct_img): for zero-valued edge images
    fn(params, cam, seed) -> (H, W, 3), exactly their first-order share of
    a loss whose image cotangent is `ct_img` (the scan backend adds the
    same images to its render before the loss; the two agree because the
    images are zero)."""
    total = sum((fn(params, cam, edge_seed(seed, i)) * ct_img).sum()
                for i, fn in enumerate(edge_image_fns))
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    return {name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(params.items(), grads)}


class PhaseClock:
    """Wall seconds of named phases, each ended by a device sync, summed
    into `timings` (a dict) when one is given; a no-op otherwise."""

    def __init__(self, timings, device):
        self.timings = timings
        self.device = device
        self.t = time.perf_counter() if timings is not None else 0.0

    def lap(self, name: str):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + (now - self.t)
        self.t = now


def finish(radiance, tape, target, *, samples_per_pass: int):
    """From per-lane radiance (total, 3) and the tape (max_depth, total):
    (loss, per-lane cotangent (total, 3), lane depth (total,), image
    cotangent (H, W, 3)). Lane L belongs to pixel L mod n; each of the k
    samples of a pixel carries 1/k of its cotangent."""
    k = samples_per_pass
    h, w, _ = target.shape
    n = h * w
    img = radiance.reshape(k, n, 3).mean(0).reshape(h, w, 3)
    loss = torch.mean((img - target) ** 2)
    ct_img = 2.0 * (img - target) / float(img.numel())
    ct_lane = ct_img.reshape(n, 3).repeat(k, 1) / float(k)
    max_depth = tape.shape[0]
    rows = torch.arange(max_depth, dtype=torch.int32, device=tape.device)[:, None]
    last_hit = torch.where(tape >= 0, rows, -1).max(dim=0).values
    lane_depth = torch.clamp(last_hit + 2, max=max_depth)
    return loss, ct_lane, lane_depth, ct_img


def replay_loss(params, rebuild, cam: Camera, seed: int, tape, ct_lane, lanes, *,
                width: int, height: int, max_depth: int, sky_gradient: bool):
    """sum(radiance * ct_lane) over the sample ids `lanes`, the radiance
    replayed with autograd from `tape` and the counter-RNG uniforms: its
    gradient in `params` is those lanes' share of the loss gradient."""
    dev = tape.device
    n = width * height
    pix = lanes % n
    frame = camera_frame(cam, width, height).to(dev)
    o, d = camera_rays(frame, pix % width, pix // width, ctr_rng.camera_uniforms(seed, lanes))
    scene = rebuild(params)
    rad = trace(
        scene, o, d, cam.background.to(dev),
        lambda bounce, idx: ctr_rng.bounce_uniforms(seed, lanes[idx], bounce),
        max_depth=max_depth, sky_gradient=sky_gradient,
        intersect_fn=make_tape_intersect_fn(tape[:, lanes]),
    )
    return (rad * ct_lane[lanes]).sum()


def make_bucketed_grad_fn(
    rebuild,
    cam: Camera,
    target,
    *,
    width: int,
    height: int,
    samples_per_pass: int,
    max_depth: int,
    sky_gradient: bool = False,
    edge_image_fns=(),
):
    """Build `step(params, seed, timings=None) -> (loss, grads)`: the loss of
    one tape-forward render against `target` (H, W, 3) and its gradient in
    every tensor of `params` (as from diff.grad.split_scene; `rebuild(params)
    -> Scene`). Runs on target's device: CUDA launches the tape kernel, CPU
    takes its twin. `seed` is an int; the JAX package derives it from its key
    as `jax.random.randint(key, (), 0, 2**31 - 1)`.

    `edge_image_fns`: zero-valued edge images fn(params, cam, seed) (diff/
    boundary.py) whose gradients `compose_edges` adds after the interior
    step, against the forward's image cotangent.

    With a `timings` dict the step syncs the device at each phase's end and
    adds the phase's wall seconds under "tape_forward", "loss_cotangent",
    "replay_forward", "backward" and, with edge terms, "edges"."""
    dev = target.device
    k = samples_per_pass
    total = k * width * height

    def step(params, seed: int, timings=None):
        clock = PhaseClock(timings, dev)
        with torch.no_grad():
            scene = rebuild({name: p.detach() for name, p in params.items()})
            reason = unsupported_reason(scene)
            if reason is not None:
                raise NotImplementedError(reason)
            sph, quad, res = pack_persistent_tables(scene)
            cam_s = pack_camera_scalars_bg(
                camera_frame(cam, width, height), cam.background
            ).to(dev)
            rad3, tape, _ = render_persistent_tape(
                sph, quad, res, cam_s, seed, total, width=width, height=height,
                max_depth=max_depth, sky_gradient=sky_gradient,
                textures=texture_tables(scene, quad_derived(scene)),
            )
            clock.lap("tape_forward")
            loss, ct_lane, lane_depth, ct_img = finish(rad3.T, tape, target, samples_per_pass=k)
            lanes = torch.arange(total, device=dev)
            if not sky_gradient:
                lanes = lanes[lane_depth > 1]
            clock.lap("loss_cotangent")
        leaves = list(params.values())
        replay = replay_loss(
            params, rebuild, cam, seed, tape, ct_lane, lanes,
            width=width, height=height, max_depth=max_depth, sky_gradient=sky_gradient,
        )
        clock.lap("replay_forward")
        grads = (
            torch.autograd.grad(replay, leaves, allow_unused=True)
            if replay.requires_grad else [None] * len(leaves)
        )
        grads = {
            name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(params.items(), grads)
        }
        clock.lap("backward")
        if edge_image_fns:
            with torch.profiler.record_function("edges"):
                edge = compose_edges(edge_image_fns, params, cam, seed, ct_img)
            grads = {name: g + edge[name] for name, g in grads.items()}
            clock.lap("edges")
        return loss, grads

    return step
