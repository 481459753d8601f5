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
* "bucketed": diff/bucketed.py, whose forward records each path's winners
  (the tape kernel on every scene it shades; on scenes with rng-filled
  Perlin tables `trace(return_tape=True)`, kernel 1 a bounce) and whose
  gradient replays the tape.

Visibility boundaries, which interior autodiff cannot see, are opt-in edge
terms, each a zero-valued image whose backward injects its gradient:

* `boundary=True`: primary silhouettes (diff/boundary.py: sphere contours
  and quad edges seen from the camera);
* `shadow_edges=True`: first-bounce shadow edges cast by quads and
  spheres onto diffuse receivers, and area-light rims seen from them
  (diff/shadow_edge.py);
* `mirror_edges=True`: sphere silhouettes seen in flat metal mirrors
  (diff/mirror_edge.py);
* `refracted_edges=True`: quad blockers seen through dielectric spheres
  (diff/refracted_edge.py, a specular-manifold Newton solve).

The scan backend adds their images to the render before the loss, the
bucketed backend composes them by VJP against the forward's image
cotangent (diff/bucketed.py:compose_edges). As in the JAX package, other
discontinuities (deeper-bounce shadow edges, multi-mirror and mirror-glass
paths, sphere blockers behind glass, TIR-cone crossings, caustic folds
beyond the two Newton inits) are not sampled: their terms are zero, with
no warning. `trainable_camera` (bucketed backend) trains camera fields
under params["camera"] (diff/bucketed.py:split_camera).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.core.camera import Camera, camera_frame
from raytracer_tpu_torch.diff.boundary import EdgeSamplingConfig, make_boundary_image_fn
from raytracer_tpu_torch.diff.bucketed import (
    CAMERA_PARAM_KEY,
    edge_seed,
    flat_leaves,
    make_bucketed_grad_fn,
    split_camera,
)
from raytracer_tpu_torch.diff.mirror_edge import make_mirror_boundary_fn
from raytracer_tpu_torch.diff.refracted_edge import make_refracted_boundary_fn
from raytracer_tpu_torch.diff.shadow_edge import ShadowEdgeConfig, make_shadow_boundary_fn
from raytracer_tpu_torch.geometry.intersect import intersect_scene_kernel_diff
from raytracer_tpu_torch.geometry.scene import Scene
from raytracer_tpu_torch.integrator.wavefront import tape_lane_rays, tape_uniforms, trace
from raytracer_tpu_torch.render.driver import resolve_device
from raytracer_tpu_torch.utils import trace as tr

# Scene leaves commonly optimized in inverse rendering.
DEFAULT_TRAINABLE = ("sph_center", "sph_radius", "mat_albedo", "mat_fuzz", "tex_c0")


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
    as `np.asarray`: the counterpart of geometry.scene.scene_from_arrays.
    A dict under CAMERA_PARAM_KEY (the JAX package's split_camera params)
    becomes the camera leaves, on the CPU like every camera tensor."""
    return {
        name: (params_from_arrays(a) if name == CAMERA_PARAM_KEY else
               torch.tensor(np.asarray(a, np.float32), device=device).requires_grad_(True))
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
    o, d = tape_lane_rays(camera_frame(cam, width, height).to(dev), seed, samples_per_pass * n,
                          width=width, height=height)
    radiance = trace(
        scene, o, d, cam.background.to(dev), tape_uniforms(seed),
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
    backend: phases "forward" and "backward" of utils/trace.py, whose
    seconds `timings` gets (see diff.bucketed.make_bucketed_grad_fn), the
    edge terms' work inside "backward"."""

    def step(params, seed: int, timings=None):
        with tr.phase("forward", timings, target.device):
            loss = render_loss(params, rebuild, cam, seed, target,
                               edge_image_fns=edge_image_fns, **render_kw)
        with tr.phase("backward", timings, target.device):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {
                name: torch.zeros_like(p) if g is None else g
                for (name, p), g in zip(params.items(), grads)
            }
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


def shadow_config(scene: Scene, width: int, height: int) -> ShadowEdgeConfig:
    """The shadow-edge budget of make_inverse_renderer(shadow_edges=True):
    the exhaustive default (every pixel a receiver, every source) up to
    2^14 pixels and 64 primitives; past either, 1024 receivers drawn by
    the loss cotangent, 4 sources each by projected solid angle, 16
    samples a sphere contour and 8 a quad edge (the JAX package's budget,
    diff/grad.py:223-249)."""
    if width * height > (1 << 14) or scene.num_spheres + scene.num_quads > 64:
        return ShadowEdgeConfig(receivers=1024, sources_per_receiver=4,
                                samples_per_sphere=16, samples_per_quad_edge=8)
    return ShadowEdgeConfig()


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

    In utils/trace.py's spans, the build is `build` (with the first
    optimizer's construction, `build/optimizer`, inside it) and each
    call of `step` a root span `step` around the backend's phases and the
    phase `optimizer`.

    The edge terms (boundary, shadow_edges, mirror_edges, refracted_edges;
    see the module docstring) are built in that order, term i seeded by
    diff.bucketed.edge_seed(seed, i) on both backends. `boundary` runs at
    a reduced budget on scenes of more than 64 primitives
    (`boundary_config`), `shadow_edges` importance-subsampled past 2^14
    pixels or 64 primitives (`shadow_config`). `trainable_camera` (camera
    field names, e.g. ("look_from", "fov_radians")) puts those leaves
    under params["camera"] (diff/bucketed.py:split_camera); it needs the
    bucketed backend.
    The default device is CUDA, which raises without a card."""
    if backend not in ("scan", "bucketed"):
        raise ValueError(f"unknown backend {backend!r}; use 'scan' or 'bucketed'")
    if trainable_camera and backend != "bucketed":
        raise ValueError("trainable_camera requires backend='bucketed'")
    with tr.span("build"):
        dev = resolve_device(device)
        scene = scene.to(dev)
        target = torch.as_tensor(target, dtype=torch.float32).to(dev)
        params, rebuild = split_scene(scene, trainable)
        rebuild_camera = None
        if trainable_camera:
            params[CAMERA_PARAM_KEY], rebuild_camera = split_camera(cam, trainable_camera)
        leaves = [t for _, t in flat_leaves(params)]
        with tr.span("build/optimizer"):
            optimizer = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        render_kw = dict(
            width=width, height=height, samples_per_pass=samples_per_pass,
            max_depth=max_depth, sky_gradient=sky_gradient,
        )
        edge_kw = dict(width=width, height=height, max_depth=max_depth,
                       sky_gradient=sky_gradient)
        edge_fns = []
        if boundary:
            edge_fns.append(make_boundary_image_fn(rebuild, config=boundary_config(scene),
                                                   **edge_kw))
        if shadow_edges:
            edge_fns.append(make_shadow_boundary_fn(
                rebuild, config=shadow_config(scene, width, height), **edge_kw))
        if mirror_edges:
            edge_fns.append(make_mirror_boundary_fn(rebuild, **edge_kw))
        if refracted_edges:
            edge_fns.append(make_refracted_boundary_fn(rebuild, **edge_kw))
        if backend == "bucketed":
            grad_fn = make_bucketed_grad_fn(rebuild, cam, target, edge_image_fns=tuple(edge_fns),
                                            rebuild_camera=rebuild_camera, **render_kw)
        else:
            grad_fn = make_scan_grad_fn(rebuild, cam, target, edge_image_fns=tuple(edge_fns),
                                        **render_kw)

    def step(seed: int, timings=None):
        with tr.span("step"):
            loss, grads = grad_fn(params, seed, timings)
            with tr.phase("optimizer", timings, dev):
                for (_, p), (_, g) in zip(flat_leaves(params), flat_leaves(grads)):
                    p.grad = g
                optimizer.step()
            return loss

    return params, optimizer, step
