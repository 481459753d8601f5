"""Tape-forward gradient step (port of raytracer_tpu/diff/bucketed.py,
`make_bucketed_grad_fn`, interior gradients).

One step:

1. **Tape forward**, no autograd: every (sample, pixel) lane is traced to
   its end and its per-bounce winners recorded. Lane L is sample id L,
   pixel L mod (width*height). The scene decides the forward
   (`tape_forward`), as JAX's step picks `forward="kernel"` or `"xla"`:
   - every scene ops/persistent_kernel.py:unsupported_reason accepts:
     one launch of the tape kernel (kernel 3, render_persistent_tape),
     noise and image textures shaded in the kernel; bilinear scenes take
     the deterministic 4-tap filter there and in the replay, as in JAX
     (raytracer_tpu/diff/bucketed.py:601-612);
   - the rest (noise from rng-filled Perlin tables):
     integrator/wavefront.py:trace_tape_scene, `trace(return_tape=True)`
     with kernel 1 a bounce and PyTorch shading, the counterpart of JAX's
     XLA tape forward (raytracer_tpu/diff/tape.py:trace_tape).
2. **Finish**: the image, the MSE loss, the per-lane cotangent of the loss
   from the forward image, and each lane's depth min(last hit + 2,
   max_depth) from the tape.
3. **Replay**: those lanes retraced from the tape's winners with the same
   counter-RNG uniforms, whose radiance dotted with the cotangents has the
   loss gradient as its gradient (`replay_loss`). The input decides how
   (`takes_replay_kernel`): on CUDA tensors of a scene without noise or
   image textures, the replay kernels (ops/replay_kernel.py:ReplayPath:
   one thread replays a lane's whole path, another sweeps its adjoint
   back, their rows summed into the tables in a fixed order); otherwise
   the eager replay, the differentiable `trace` with the tape intersector
   (diff/tape.py), differentiated by autograd. Lanes of depth 1 missed
   everything at once: their radiance is the flat background, which no
   scene parameter touches, so they are skipped (unless the sky gradient
   makes the background depend on the ray).

What the JAX package needed and this port does not: the two-phase forward
(`fwd_cap`), because a TPU tile of 8K lanes drains at its deepest lane
while a warp drains at its deepest of 32, so one launch to max_depth is the
design here; and the depth ladder with its padded bucket sizes
(`default_depth_ladder`, `_PadMemo`), which served XLA's static shapes and
compile cache. The replay kernels run each lane to its own depth, and the
eager replay works at each bounce on the lanes still alive, so the work
follows the real lane-bounces with no padding; the gradient is the same
sum.

With `edge_image_fns` (the zero-valued edge images of diff/boundary.py,
shadow_edge.py, mirror_edge.py and refracted_edge.py), the step adds their
gradients as VJPs against the forward's image cotangent (`compose_edges`,
JAX `_compose_edges`).

With `rebuild_camera` (from `split_camera`) the camera is trainable: its
leaves live under params[CAMERA_PARAM_KEY], the tape forward packs the
camera from their values, and the replay and the edge terms rebuild it
from them, so their gradients flow through camera_rays and the edge
estimators' projections.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.core.camera import Camera, camera_frame, camera_rays
from raytracer_tpu_torch.diff.tape import make_tape_intersect_fn
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.integrator.wavefront import trace, trace_tape_scene
from raytracer_tpu_torch.materials.packed import primitive_table, texture_tables
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops.persistent_kernel import (
    pack_camera_scalars_bg,
    pack_persistent_tables,
    render_persistent_tape,
    unsupported_reason,
)
from raytracer_tpu_torch.ops.replay_kernel import geom_table, replay_kernel_reason, replay_path
from raytracer_tpu_torch.utils import trace as tr


# Counter of the edge terms' seed stream (the JAX package folds its step key
# with 6070 for them).
EDGE_SEED_STREAM = 6070


# Reserved key of the camera leaves when the camera is trainable.
CAMERA_PARAM_KEY = "camera"


def split_camera(cam: Camera, trainable=("look_from", "look_at")):
    """(camera params, rebuild_camera): fresh leaves that require grad for
    the camera fields `trainable`, and rebuild_camera(cparams) -> the
    camera with those fields replaced; the camera analog of
    diff.grad.split_scene."""
    cparams = {name: getattr(cam, name).detach().clone().requires_grad_(True)
               for name in trainable}

    def rebuild_camera(cp):
        return dataclasses.replace(cam, **cp)

    return cparams, rebuild_camera


def _scene_and_camera(params: dict, rebuild, rebuild_camera, cam_default: Camera):
    """(Scene, Camera) from a params dict that may carry camera leaves
    under CAMERA_PARAM_KEY."""
    if rebuild_camera is None:
        return rebuild(params), cam_default
    sp = {k: v for k, v in params.items() if k != CAMERA_PARAM_KEY}
    return rebuild(sp), rebuild_camera(params[CAMERA_PARAM_KEY])


def _skip_depth1(sky_gradient: bool, rebuild_camera) -> bool:
    """Lanes of depth 1 missed at once: their radiance is the flat
    background, which no scene parameter touches, so their replay is a
    zero gradient, unless the background depends on the ray (the sky
    gradient) or the camera and its background are trainable."""
    return not sky_gradient and rebuild_camera is None


def flat_leaves(params: dict) -> list:
    """(key path, tensor) of every leaf of `params`, the camera leaves
    under params[CAMERA_PARAM_KEY] after the scene's."""
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out.extend(((k, c), t) for c, t in v.items())
        else:
            out.append(((k,), v))
    return out


def nest_like(params: dict, values) -> dict:
    """`values` (one per leaf, flat_leaves' order; None for zeros) in the
    nesting of `params`."""
    out = {}
    for (path, t), g in zip(flat_leaves(params), values):
        g = torch.zeros_like(t) if g is None else g
        if len(path) == 1:
            out[path[0]] = g
        else:
            out.setdefault(path[0], {})[path[1]] = g
    return out


def edge_name(fn) -> str:
    """The name an edge image is timed under: `edges/<name>` for an image
    function named `<name>_image` (diff/boundary.py:edge_image_fn)."""
    return fn.__name__.removesuffix("_image")


def edge_seed(seed: int, i: int) -> int:
    """Seed of edge term i in a step seeded `seed`: the scan and bucketed
    backends give edge term i the same seed, and none of them shares the
    interior render's."""
    return int(ctr_rng.hash_i32(seed, EDGE_SEED_STREAM, i + 1))


def compose_edges(edge_image_fns, params: dict, cam: Camera, seed: int, ct_img,
                  rebuild_camera=None, timings=None):
    """Gradients, nested like `params`, of sum over i of sum(fn_i(params,
    cam, edge_seed(seed, i)) * ct_img): for zero-valued edge images
    fn(params, cam, seed) -> (H, W, 3), exactly their first-order share of
    a loss whose image cotangent is `ct_img` (the scan backend adds the
    same images to its render before the loss; the two agree because the
    images are zero). With `rebuild_camera` the camera is rebuilt from
    params[CAMERA_PARAM_KEY]. Each term is a phase `edges/<name>` of
    utils/trace.py: with a `timings` dict its synced wall seconds go under
    that name and under "edges"."""
    leaves = [t for _, t in flat_leaves(params)]
    if rebuild_camera is None:
        sp, cam_p = params, cam
    else:
        sp = {k: v for k, v in params.items() if k != CAMERA_PARAM_KEY}
        cam_p = rebuild_camera(params[CAMERA_PARAM_KEY])
    total = [None] * len(leaves)
    for i, fn in enumerate(edge_image_fns):
        with tr.phase(f"edges/{edge_name(fn)}", timings, ct_img.device, also=("edges",)):
            grads = torch.autograd.grad((fn(sp, cam_p, edge_seed(seed, i)) * ct_img).sum(),
                                        leaves, allow_unused=True)
            total = [a if g is None else (g if a is None else a + g)
                     for a, g in zip(total, grads)]
    return nest_like(params, total)


def image_loss(img_sum, target, samples_per_pass: int):
    """(loss, image cotangent (H, W, 3)) of the MSE between the image
    img_sum / samples_per_pass (img_sum the (n_pixels, 3) radiance sums)
    and `target` (H, W, 3)."""
    img = (img_sum / float(samples_per_pass)).reshape(target.shape)
    loss = torch.mean((img - target) ** 2)
    return loss, 2.0 * (img - target) / float(img.numel())


def lane_cotangent(ct_img, lane_samples: int, samples_per_pass: int):
    """Per-lane cotangent (lane_samples * n_pixels, 3) of lanes whose lane
    L belongs to pixel L mod n_pixels: each of a pixel's samples_per_pass
    samples carries 1/samples_per_pass of its cotangent."""
    n = ct_img.shape[0] * ct_img.shape[1]
    return ct_img.reshape(n, 3).repeat(lane_samples, 1) / float(samples_per_pass)


def lane_depths(tape):
    """Each lane's replay depth min(last hit + 2, max_depth) from the tape
    (max_depth, total)."""
    max_depth = tape.shape[0]
    rows = torch.arange(max_depth, dtype=torch.int32, device=tape.device)[:, None]
    last_hit = torch.where(tape >= 0, rows, -1).max(dim=0).values
    return torch.clamp(last_hit + 2, max=max_depth)


def finish(radiance, tape, target, *, samples_per_pass: int):
    """From per-lane radiance (total, 3) and the tape (max_depth, total):
    (loss, per-lane cotangent (total, 3), lane depth (total,), image
    cotangent (H, W, 3)). Lane L belongs to pixel L mod n; each of the k
    samples of a pixel carries 1/k of its cotangent."""
    k = samples_per_pass
    n = target.shape[0] * target.shape[1]
    loss, ct_img = image_loss(radiance.reshape(k, n, 3).sum(0), target, k)
    return loss, lane_cotangent(ct_img, k, k), lane_depths(tape), ct_img


def tape_forward(params: dict, rebuild, rebuild_camera, cam: Camera, seed: int, total: int, *,
                 width: int, height: int, max_depth: int, sky_gradient: bool, device):
    """The tape forward, no autograd, over `total` lanes of the scene and
    camera built from `params`' values, seeded `seed`: one launch of the
    tape kernel (its twin on the CPU), or, for a scene it does not shade
    (`unsupported_reason`), integrator.wavefront.trace_tape_scene (kernel 1
    a bounce on the card). The scene alone decides, before any launch.
    Returns (radiance (total, 3), tape (max_depth, total) int32)."""
    with torch.no_grad():
        detached = nest_like(params, [t.detach() for _, t in flat_leaves(params)])
        scene, cam_p = _scene_and_camera(detached, rebuild, rebuild_camera, cam)
        frame = camera_frame(cam_p, width, height)
        if unsupported_reason(scene) is not None:
            return trace_tape_scene(scene, frame, cam_p.background, seed, total, width=width,
                                    height=height, max_depth=max_depth,
                                    sky_gradient=sky_gradient)
        sph, quad, res = pack_persistent_tables(scene)
        cam_s = pack_camera_scalars_bg(frame, cam_p.background).to(device)
        rad3, tape, _ = render_persistent_tape(
            sph, quad, res, cam_s, seed, total, width=width, height=height,
            max_depth=max_depth, sky_gradient=sky_gradient,
            textures=texture_tables(scene, quad_derived(scene)),
        )
    return rad3.T, tape


def replay_lanes(lane_depth, sky_gradient: bool, rebuild_camera):
    """The lanes (sample ids) the replay traces: all of them, less those of
    depth 1 where `_skip_depth1` holds."""
    lanes = torch.arange(lane_depth.shape[0], device=lane_depth.device)
    return lanes[lane_depth > 1] if _skip_depth1(sky_gradient, rebuild_camera) else lanes


def replay_grads(params: dict, rebuild, rebuild_camera, cam: Camera, seed: int, tape, ct_lane,
                 lanes, lane_depth, *, width: int, height: int, max_depth: int,
                 sky_gradient: bool, timings=None):
    """Gradients, nested like `params`, of `replay_loss` over `lanes` (each
    sample's depth `lane_depth`, as `lane_depths` gives it): the
    replay's forward and backward are the phases "replay_forward" (with
    the replay's counters: `replays_kernel` and `replay_kernel_segments`,
    or `replays_eager` with the eager replay's `bounces` and `lanes`) and
    "backward" of utils/trace.py, timed into `timings` when given."""
    leaves = [t for _, t in flat_leaves(params)]
    with tr.phase("replay_forward", timings, tape.device):
        scene, cam_p = _scene_and_camera(params, rebuild, rebuild_camera, cam)
        replay = replay_loss(
            scene, cam_p, seed, tape, ct_lane, lanes, lane_depth,
            width=width, height=height, max_depth=max_depth, sky_gradient=sky_gradient,
        )
    with tr.phase("backward", timings, tape.device):
        return nest_like(params, torch.autograd.grad(replay, leaves, allow_unused=True)
                         if replay.requires_grad else [None] * len(leaves))


def takes_replay_kernel(scene, device) -> bool:
    """Whether `replay_loss` replays on the replay kernels: tensors on a
    CUDA device and a scene `replay_kernel_reason` accepts."""
    return torch.device(device).type == "cuda" and replay_kernel_reason(scene) is None


def replay_loss(scene, cam: Camera, seed: int, tape, ct_lane, lanes, lane_depth, *,
                width: int, height: int, max_depth: int, sky_gradient: bool):
    """sum(radiance * ct_lane) over the sample ids `lanes`, the radiance
    replayed to each sample's `lane_depth` (`lane_depths` of the tape)
    from `tape` and the counter-RNG uniforms in `scene` and `cam`
    (built from the parameters): its gradient in them is those lanes'
    share of the loss gradient. The input decides how: CUDA tensors of a
    scene `replay_kernel_reason` accepts take the replay kernels
    (ops/replay_kernel.py:ReplayPath, its adjoint by hand); other scenes
    and CPU tensors the eager replay, `trace` with the tape's intersect
    hook, differentiated by autograd. Each replay counts `replays_kernel`
    or `replays_eager` (utils/trace.py), and the kernel's
    `replay_kernel_segments`, its traced lane-bounces."""
    dev = tape.device
    n = width * height
    pix = lanes % n
    frame = camera_frame(cam, width, height).to(dev)
    o, d = camera_rays(frame, pix % width, pix // width, ctr_rng.camera_uniforms(seed, lanes))
    background = cam.background.to(dev)
    if takes_replay_kernel(scene, dev):
        tr.count("replays_kernel")
        qd = quad_derived(scene)
        rad, segs = replay_path(primitive_table(scene, qd), geom_table(scene, qd), o, d,
                                background, tape, lanes, lane_depth[lanes], seed=seed,
                                ns=scene.num_spheres, sky_gradient=sky_gradient)
        if tr.enabled():
            tr.count("replay_kernel_segments", segs.sum())
    else:
        tr.count("replays_eager")
        rad = trace(
            scene, o, d, background,
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
    rebuild_camera=None,
):
    """Build `step(params, seed, timings=None) -> (loss, grads)`: the loss of
    one tape-forward render against `target` (H, W, 3) and its gradient in
    every tensor of `params` (as from diff.grad.split_scene; `rebuild(params)
    -> Scene`), nested like `params`. Runs on target's device: CUDA launches
    the forward's kernel (`tape_forward`), CPU takes its twin. `seed` is an
    int; the JAX package derives it from its key as
    `jax.random.randint(key, (), 0, 2**31 - 1)`.

    `edge_image_fns`: zero-valued edge images fn(params, cam, seed) (diff/
    boundary.py, shadow_edge.py, mirror_edge.py, refracted_edge.py) whose
    gradients `compose_edges` adds after the interior step, against the
    forward's image cotangent. `rebuild_camera` (split_camera) makes the
    camera trainable: `params` then carries its leaves under
    CAMERA_PARAM_KEY.

    The step's phases are spans of utils/trace.py: "tape_forward",
    "loss_cotangent", "replay_forward", "backward" and, with edge terms,
    "edges" around an "edges/<name>" for each. With a `timings` dict the
    step syncs the device at each phase's end and adds the phase's wall
    seconds under its name, "edges" taking the sum of its terms."""
    dev = target.device
    k = samples_per_pass
    total = k * width * height
    shape_kw = dict(width=width, height=height, max_depth=max_depth, sky_gradient=sky_gradient,
                    device=dev)

    def step(params, seed: int, timings=None):
        with tr.phase("tape_forward", timings, dev):
            rad, tape = tape_forward(params, rebuild, rebuild_camera, cam, seed, total,
                                     **shape_kw)
        with tr.phase("loss_cotangent", timings, dev), torch.no_grad():
            loss, ct_lane, lane_depth, ct_img = finish(rad, tape, target, samples_per_pass=k)
            lanes = replay_lanes(lane_depth, sky_gradient, rebuild_camera)
        grads = replay_grads(params, rebuild, rebuild_camera, cam, seed, tape, ct_lane, lanes,
                             lane_depth, width=width, height=height, max_depth=max_depth,
                             sky_gradient=sky_gradient, timings=timings)
        if edge_image_fns:
            with tr.span("edges"):
                edge = compose_edges(edge_image_fns, params, cam, seed, ct_img,
                                     rebuild_camera=rebuild_camera, timings=timings)
            grads = nest_like(params, [g + e for (_, g), (_, e) in
                                       zip(flat_leaves(grads), flat_leaves(edge))])
        return loss, grads

    return step
