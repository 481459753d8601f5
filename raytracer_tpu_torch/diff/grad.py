"""Differentiable rendering and inverse rendering (port of
raytracer_tpu/diff/grad.py, interior gradients).

Pixel gradients in scene parameters (sphere centers and radii, albedos,
fuzz, ior, texture colors) flow through the whole path by:

* reparameterized sampling: samples are smooth in their uniforms, and the
  uniforms (the counter RNG, ops/ctr_rng.py) do not depend on parameters;
* straight-through discrete events: the closest hit's winner, the
  dielectric coin and metal absorption keep their sampled outcome, and the
  gradient flows through the selected branch; the coin also carries the
  likelihood-ratio factor (materials.materials._dielectric_lr).

Two backends compute the same estimator:

* "scan": `render_linear_diff`, the differentiable `trace` of every lane,
  each bounce's winner found by the closest-hit kernel on detached rays
  (geometry.intersect.intersect_scene_kernel_diff);
* "bucketed": diff/bucketed.py, whose forward is the tape kernel and whose
  gradient replays the tape.

`boundary=True` adds the silhouette term that interior autodiff cannot see
(diff/boundary.py: primary-visibility edge sampling of sphere contours and
quad edges): the scan backend adds its zero-valued image to the render
before the loss, the bucketed backend composes it by VJP against the
forward's image cotangent (diff/bucketed.py:compose_edges).

Not ported yet (ROADMAP Queue 1 #10): the other visibility-boundary
estimators (`shadow_edges`, `mirror_edges`, `refracted_edges`) and the
trainable camera.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from raytracer_tpu_torch.core.camera import Camera, camera_frame, camera_rays
from raytracer_tpu_torch.diff.boundary import EdgeSamplingConfig, make_boundary_image_fn
from raytracer_tpu_torch.diff.bucketed import PhaseClock, edge_seed, make_bucketed_grad_fn
from raytracer_tpu_torch.geometry.intersect import intersect_scene_kernel_diff
from raytracer_tpu_torch.geometry.scene import Scene
from raytracer_tpu_torch.integrator.wavefront import trace
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.render.driver import resolve_device

# Scene leaves commonly optimized in inverse rendering.
DEFAULT_TRAINABLE = ("sph_center", "sph_radius", "mat_albedo", "mat_fuzz", "tex_c0")

_EDGE_ITEM = "ROADMAP Queue 1 #10, edge estimators"


def split_scene(scene: Scene, trainable=DEFAULT_TRAINABLE):
    """(params, rebuild): `params` maps each trainable field to a fresh leaf
    tensor that requires grad; `rebuild(params)` is the scene with those
    fields replaced (dataclasses.replace), differentiable in them."""
    params = {
        name: getattr(scene, name).detach().clone().requires_grad_(True) for name in trainable
    }

    def rebuild(p):
        return dataclasses.replace(scene, **p)

    return params, rebuild


def params_from_arrays(arrays: dict, device="cpu") -> dict:
    """Leaf tensors (float32, requiring grad) from numpy-convertible arrays
    keyed by field name, for instance the JAX package's split_scene params
    as `np.asarray`: the counterpart of geometry.scene.scene_from_arrays."""
    return {
        name: torch.tensor(np.asarray(a, np.float32), device=device).requires_grad_(True)
        for name, a in arrays.items()
    }


def render_linear_diff(
    scene: Scene,
    cam: Camera,
    seed: int,
    *,
    width: int,
    height: int,
    samples_per_pass: int,
    max_depth: int,
    sky_gradient: bool = False,
):
    """Differentiable render: per-pixel mean linear radiance (H, W, 3) of
    samples_per_pass samples per pixel on the scene's device. Lane L is
    sample id L at pixel L mod (width*height), its uniforms the counter
    RNG's, so the image is the tape kernel's estimator for the same seed.
    Each bounce's winner comes from the closest-hit kernel (its twin on
    CPU tensors); its t, and all shading, carry gradients."""
    dev = scene.sph_center.device
    n = width * height
    total = samples_per_pass * n
    sid = torch.arange(total, device=dev)
    pix = sid % n
    frame = camera_frame(cam, width, height).to(dev)
    o, d = camera_rays(frame, pix % width, pix // width, ctr_rng.camera_uniforms(seed, sid))
    radiance = trace(
        scene, o, d, cam.background.to(dev),
        lambda bounce, lanes: ctr_rng.bounce_uniforms(seed, lanes, bounce),
        max_depth=max_depth, sky_gradient=sky_gradient,
        intersect_fn=intersect_scene_kernel_diff,
    )
    return radiance.reshape(samples_per_pass, n, 3).mean(0).reshape(height, width, 3)


def render_loss(
    params: dict,
    rebuild,
    cam: Camera,
    seed: int,
    target,
    *,
    width: int,
    height: int,
    samples_per_pass: int,
    max_depth: int,
    sky_gradient: bool = False,
    edge_image_fns=(),
):
    """MSE between a fresh render (render_linear_diff) and `target`. Each
    of `edge_image_fns` (zero-valued edge images fn(params, cam, seed),
    diff/boundary.py) is added to the render before the loss, under seed
    diff.bucketed.edge_seed(seed, i), so the geometry gradients include
    its boundary term."""
    img = render_linear_diff(
        rebuild(params), cam, seed, width=width, height=height,
        samples_per_pass=samples_per_pass, max_depth=max_depth, sky_gradient=sky_gradient,
    )
    for i, fn in enumerate(edge_image_fns):
        img = img + fn(params, cam, edge_seed(seed, i))
    return torch.mean((img - target) ** 2)


def make_scan_grad_fn(rebuild, cam: Camera, target, edge_image_fns=(), **render_kw):
    """`step(params, seed, timings=None) -> (loss, grads)` of the scan
    backend; `timings` gets "forward" and "backward" seconds (see
    diff.bucketed.make_bucketed_grad_fn), the edge terms' work inside
    "backward"."""

    def step(params, seed: int, timings=None):
        clock = PhaseClock(timings, target.device)
        loss = render_loss(params, rebuild, cam, seed, target, edge_image_fns=edge_image_fns,
                           **render_kw)
        clock.lap("forward")
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {
            name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(params.items(), grads)
        }
        clock.lap("backward")
        return loss.detach(), grads

    return step


def boundary_config(scene: Scene) -> EdgeSamplingConfig:
    """The edge budget of make_inverse_renderer(boundary=True): the default
    up to 64 primitives; past that 64 samples a sphere contour, 32 a quad
    edge and 4 paths a point (the JAX package's budget, diff/grad.py:
    209-214). The estimator stays unbiased; its noise adds to the
    stochastic gradient's."""
    if scene.num_spheres + scene.num_quads > 64:
        return EdgeSamplingConfig(samples_per_sphere=64, samples_per_quad_edge=32, spp_edge=4)
    return EdgeSamplingConfig()


def make_inverse_renderer(
    scene: Scene,
    cam: Camera,
    target,
    *,
    trainable=DEFAULT_TRAINABLE,
    width: int,
    height: int,
    samples_per_pass: int = 4,
    max_depth: int = 8,
    sky_gradient: bool = False,
    learning_rate: float = 1e-2,
    boundary: bool = False,
    shadow_edges: bool = False,
    mirror_edges: bool = False,
    refracted_edges: bool = False,
    trainable_camera: tuple = (),
    backend: str = "scan",
    device="cuda",
):
    """Build (params, optimizer, step) for gradient-descent scene recovery.

    `params` are the trainable leaves on `device` (split_scene), `optimizer`
    is torch.optim.Adam at optax.adam's defaults (betas 0.9/0.999, eps 1e-8)
    over them, and `step(seed, timings=None) -> loss` computes the loss and
    gradients of one render (backend "scan" or "bucketed") and updates the
    params in place. With a `timings` dict each phase's wall seconds are
    added to it (see the backends), the update under "optimizer".
    `boundary=True` adds the edge-sampled silhouette gradients of
    diff/boundary.py (needed when the trainables move geometry whose
    silhouettes are in view), at a reduced budget on scenes of more than
    64 primitives (`boundary_config`).
    The default device is CUDA, which raises without a card."""
    for flag, name in (
        (shadow_edges, "shadow_edges"), (mirror_edges, "mirror_edges"),
        (refracted_edges, "refracted_edges"),
    ):
        if flag:
            raise NotImplementedError(f"{name} is not ported yet ({_EDGE_ITEM})")
    if trainable_camera:
        raise NotImplementedError(
            "trainable_camera is not ported yet (ROADMAP Queue 1 #10, split_camera)"
        )
    dev = resolve_device(device)
    scene = scene.to(dev)
    target = torch.as_tensor(target, dtype=torch.float32).to(dev)
    params, rebuild = split_scene(scene, trainable)
    optimizer = torch.optim.Adam(
        list(params.values()), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
    )
    render_kw = dict(
        width=width, height=height, samples_per_pass=samples_per_pass,
        max_depth=max_depth, sky_gradient=sky_gradient,
    )
    edge_fns = ()
    if boundary:
        edge_fns = (make_boundary_image_fn(
            rebuild, width=width, height=height, max_depth=max_depth, sky_gradient=sky_gradient,
            config=boundary_config(scene),
        ),)
    if backend == "bucketed":
        grad_fn = make_bucketed_grad_fn(rebuild, cam, target, edge_image_fns=edge_fns,
                                        **render_kw)
    elif backend == "scan":
        grad_fn = make_scan_grad_fn(rebuild, cam, target, edge_image_fns=edge_fns, **render_kw)
    else:
        raise ValueError(f"unknown backend {backend!r}; use 'scan' or 'bucketed'")

    def step(seed: int, timings=None):
        loss, grads = grad_fn(params, seed, timings)
        t0 = time.perf_counter()
        for name, p in params.items():
            p.grad = grads[name]
        optimizer.step()
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings["optimizer"] = timings.get("optimizer", 0.0) + time.perf_counter() - t0
        return loss

    return params, optimizer, step
