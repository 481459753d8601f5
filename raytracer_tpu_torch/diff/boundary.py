"""Silhouette-aware geometry gradients by primary-visibility edge sampling
(port of raytracer_tpu/diff/boundary.py).

A path-traced pixel is only piecewise smooth in the geometry: moving a
sphere moves its projected silhouette, and the radiance jump across that
curve contributes a boundary term that interior autodiff (diff/grad.py)
cannot see. This module samples it in the style of Li et al. 2018
("Differentiable Monte Carlo Ray Tracing through Edge Sampling") on the
analytic primitives:

* **Spheres**: the visible contour from a pinhole eye is a circle in 3D,
  smooth in (center, radius): for center c at distance d from the eye and
  radius r it lies in the plane (p - c).z = -r^2/d (z = (c - eye)/d) with
  radius r sqrt(d^2 - r^2)/d.
* **Quads**: the four straight edges of the parallelogram, linear in
  (Q, u, v).

For each silhouette sample x(phi; theta) in continuous pixel coordinates,
the pixel integral (unit box filter, matching camera_rays' jitter) obeys

    dI/dtheta = interior + sum over samples (L_in - L_out) (dx/dtheta . n) |dx/dphi| dphi

where n is the image-space edge normal pointing out of the primitive's
projected region, and L_in / L_out are path-traced radiances a hair inside
and outside the edge, traced with common random numbers (the same seed and
lane ids) so that an occluded edge cancels. The term is a
`torch.autograd.Function` whose forward is an image of exact zeros and
whose backward injects the edge-sampled cotangent into the geometry leaves
and the camera tensors that require grad, so it composes with any loss.

The edge traces (`trace_edge_rays`) are pure forward evaluations: on CUDA
tensors one launch of the edge path kernel a call (ops/edge_path_kernel.py),
on CPU tensors its plain twin `trace`, each sphere winner's t by the stable
quadratic (the silhouette's grazing hits would land inside small spheres
by the folded test), with russian roulette so that one deep path does not
hold a whole batch of edge rays at the depth budget.

Scope, as in the JAX package: primary visibility only (shadow edges and
silhouettes seen in mirrors or through glass are other terms), pinhole
cameras.

Inside the bucketed step's `edges/boundary` phase (utils/trace.py) the term
opens `edges/boundary/sample` (contour and edge points, their projection,
orientation and validity), `edges/boundary/trace` (the in/out traces) and
`edges/boundary/splat` (the weights against the cotangent and the VJP of
the edge points into the leaves), and counts `edge_points` (valid samples,
a device sum read at `collect()`) and `edge_rays` (the rays traced, from
shapes), and `trace_edge_rays` its own counters: none syncs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from raytracer_tpu_torch.core import vecmath as vm
from raytracer_tpu_torch.core.camera import CAMERA_FIELDS, Camera, CameraFrame, camera_frame
from raytracer_tpu_torch.integrator.wavefront import trace
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops.edge_path_kernel import edge_path_scene, takes_edge_path_kernel
from raytracer_tpu_torch.utils import trace as tr


class EdgeSamplingConfig(NamedTuple):
    """Edge-sampling budget."""

    samples_per_sphere: int = 256  # phi samples around each contour circle
    samples_per_quad_edge: int = 64  # per straight edge (x4 edges)
    spp_edge: int = 8  # radiance samples per edge point per side
    eps_px: float = 0.15  # in/out offset from the edge, pixel units


def project_to_pixels(frame: CameraFrame, p):
    """World point(s) (..., 3) -> continuous pixel coordinates (s, t), and
    the mask of points on the camera side of the viewport plane.

    The inverse of camera_rays' pixel mapping: the ray through image
    coordinate (s, t) points at pixel00 + s du + t dv; pixel (i, j) spans
    s in [i - 1/2, i + 1/2)."""
    rel = p - frame.center
    q0 = frame.pixel00 - frame.center
    n = vm.cross(frame.pixel_du, frame.pixel_dv)
    denom = rel @ n
    lam = (q0 @ n) / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    r = lam[..., None] * rel - q0
    s = (r @ frame.pixel_du) / (frame.pixel_du @ frame.pixel_du)
    t = (r @ frame.pixel_dv) / (frame.pixel_dv @ frame.pixel_dv)
    return s, t, lam > 0.0


def _perp_basis(zh):
    """Orthonormal (e1, e2) perpendicular to zh (..., 3), the helper axis
    picked without a branch."""
    axes = torch.eye(3, dtype=zh.dtype, device=zh.device)  # made on the device: no copy
    y, x = axes[1].expand_as(zh), axes[0].expand_as(zh)
    up = torch.where(zh[..., 1:2].abs() < 0.9, y, x)
    e1 = vm.cross(zh, up)
    e1 = e1 / torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
    e2 = vm.cross(zh, e1)
    return e1, e2


def sphere_contour_points(center, radius, eye, phi):
    """Visible-contour circle points of spheres from a pinhole eye.

    center (S, 3), radius (S,), phi (M,) -> (p (S, M, 3), valid (S,)):
    valid where the eye is strictly outside the sphere (else there is no
    silhouette). Smooth in (center, radius) wherever valid."""
    r = radius.abs()  # a negative radius is the hollow-glass inner shell: same surface
    z = center - eye
    d = torch.linalg.vector_norm(z, dim=-1)
    # A relative margin: a camera 0.5 above a radius-1000 ground sphere
    # has d/r ~ 1.0005, and its horizon is a good silhouette.
    margin = r * (1.0 + 1e-4) + 1e-6
    valid = d > margin
    d_safe = torch.maximum(d, margin)
    zh = z / d_safe[..., None]
    a = r * r / d_safe
    rho = r * torch.sqrt(torch.clamp(d_safe * d_safe - r * r, min=1e-12)) / d_safe
    e1, e2 = _perp_basis(zh)
    circ = (torch.cos(phi)[None, :, None] * e1[:, None, :]
            + torch.sin(phi)[None, :, None] * e2[:, None, :])
    p = center[:, None, :] - a[:, None, None] * zh[:, None, :] + rho[:, None, None] * circ
    return p, valid


def quad_edge_points(q, u, v, tau):
    """Boundary points of parallelogram quads.

    q, u, v (Q, 3), tau (Me,) in [0, 1) -> (p (Q, 4 Me, 3), dp/dtau (Q,
    4 Me, 3)). Edges q + tau u, q + u + tau v, q + u + v - tau u,
    q + v - tau v (counter-clockwise in (u, v)); linear in the parameters."""
    t = tau[None, :, None]
    e0 = q[:, None, :] + t * u[:, None, :]
    e1 = (q + u)[:, None, :] + t * v[:, None, :]
    e2 = (q + u + v)[:, None, :] - t * u[:, None, :]
    e3 = (q + v)[:, None, :] - t * v[:, None, :]
    p = torch.cat([e0, e1, e2, e3], dim=1)
    dp = torch.cat([u[:, None, :].expand_as(e0), v[:, None, :].expand_as(e1),
                    (-u)[:, None, :].expand_as(e2), (-v)[:, None, :].expand_as(e3)], dim=1)
    return p, dp


def trace_edge_rays(scene, origin, direction, seed: int, *, background, max_depth: int,
                    sky_gradient: bool, spp_edge: int, live=None):
    """Mean path-traced radiance (K, 3) of spp_edge paths from each of the
    rays (origin (K, 3), direction (K, 3)). Lane L of the batch (ray L mod
    K) is sample id L under `seed`, so two calls with the same seed share
    every lane's uniforms and coins (common random numbers for an in/out
    pair). Pure forward, each sphere winner's t by the stable quadratic
    (the rays start a hair from a silhouette, where the folded sphere test
    puts a grazing hit inside a small sphere and the path re-hits it),
    russian roulette from depth 5 with its survival capped at 0.75. Rays
    False in `live` (K,) (invalid edge points) have no use: their radiance
    is garbage.

    The input decides how: CUDA tensors of a scene the edge path kernel
    shades take one launch of it (ops/edge_path_kernel.py: every lane's
    whole path, the rays False in `live` traced not at all); CPU tensors
    and other scenes its plain twin, the eager `trace` (kernel 1 a bounce
    on the card), where those rays end after their first bounce. Counts
    the batch's rays as `edge_rays`, the call as `edge_traces_kernel` or
    `edge_traces_eager`, and the kernel's traced lane-bounces as
    `edge_path_segments` (a device sum read at `collect()`)."""
    tr.count("edge_rays", origin.shape[0] * spp_edge)
    if takes_edge_path_kernel(scene, origin.device):
        tr.count("edge_traces_kernel")
        rad, segs = edge_path_scene(scene, origin, direction, background, seed,
                                    spp_edge=spp_edge, max_depth=max_depth,
                                    sky_gradient=sky_gradient, live=live,
                                    count_segments=tr.enabled())
        if segs is not None:
            tr.count("edge_path_segments", segs)
    else:
        tr.count("edge_traces_eager")
        rad = trace(
            scene, origin.repeat(spp_edge, 1), direction.repeat(spp_edge, 1), background,
            lambda bounce, lanes: ctr_rng.bounce_uniforms(seed, lanes, bounce),
            max_depth=max_depth, sky_gradient=sky_gradient,
            russian_roulette=True, rr_max_q=0.75,
            rr_uniform=lambda bounce, lanes: ctr_rng.rr_uniforms(seed, lanes, bounce, max_depth),
            stable_spheres=True, live=None if live is None else live.repeat(spp_edge),
        )
    return rad.reshape(spp_edge, origin.shape[0], 3).mean(dim=0)


def _trace_edge_radiance(scene, frame: CameraFrame, x_px, seed: int, *, background,
                         max_depth: int, sky_gradient: bool, spp_edge: int, live=None):
    """trace_edge_rays of the camera rays through continuous pixel
    coordinates x_px (K, 2)."""
    target = frame.pixel00 + x_px[:, 0:1] * frame.pixel_du + x_px[:, 1:2] * frame.pixel_dv
    origin = frame.center.expand_as(target)
    return trace_edge_rays(scene, origin, target - origin, seed, background=background,
                           max_depth=max_depth, sky_gradient=sky_gradient, spp_edge=spp_edge,
                           live=live)


def _proj2(frame):
    def proj(pp):
        s, t, _ = project_to_pixels(frame, pp)
        return torch.stack([s, t], dim=-1)

    return proj


def make_boundary_image_fn(
    rebuild,
    *,
    width: int,
    height: int,
    max_depth: int,
    sky_gradient: bool = False,
    config: EdgeSamplingConfig = EdgeSamplingConfig(),
):
    """Build boundary_image(params, cam, seed) -> (H, W, 3).

    Forward: exact zeros on the scene's device (the boundary term has no
    value; it is pure gradient). Backward: the edge-sampled silhouette
    gradient of the geometry leaves present in `params` (sph_center,
    sph_radius, quad_q/u/v) and of every camera tensor that requires grad
    (moving the camera moves the projected silhouettes: look_from, look_at,
    fov_radians get their boundary terms through the same x(theta).n
    sum); every other input gets zero. `seed` (an int) seeds the edge
    traces. Add its output to the interior render (diff/grad.py:
    render_linear_diff) before the loss."""
    cfg = config

    def edge_cotangent(params: dict, cam: Camera, cam_names, seed: int, ct):
        """(gradients of `params`' tensors, of the camera tensors `cam_names`)
        of sum(ct * the boundary image)."""
        with torch.no_grad():
            with tr.span("edges/boundary/sample"):
                scene = rebuild({k: v.detach() for k, v in params.items()})
                dev = scene.sph_center.device
                frame = camera_frame(cam, width, height).to(dev)
                eye = frame.center
                proj2 = _proj2(frame)
                # Each piece: (x_fn(params, cam) -> (K, 2), x (K, 2), tangent
                # (K, 2), image-space outward direction (K, 2), valid (K,),
                # line measure of a sample).
                pieces = []
                if "sph_center" in params or "sph_radius" in params:
                    m = cfg.samples_per_sphere
                    phi = (torch.arange(m, dtype=torch.float32, device=dev) + 0.5) \
                        * (2.0 * math.pi / m)

                    def sphere_x(p, camera):
                        c = p.get("sph_center", scene.sph_center)
                        r = p.get("sph_radius", scene.sph_radius)
                        fr = camera_frame(camera, width, height).to(dev)
                        pts, _ = sphere_contour_points(c, r, fr.center, phi)
                        return _proj2(fr)(pts).reshape(-1, 2)

                    c_sg, r_sg = scene.sph_center, scene.sph_radius
                    pts, valid_s = sphere_contour_points(c_sg, r_sg, eye, phi)
                    # dp/dphi of the circle's parameterization.
                    dphi = torch.stack([-torch.sin(phi), torch.cos(phi)], dim=-1)
                    zh = c_sg - eye
                    d = torch.linalg.vector_norm(zh, dim=-1, keepdim=True)
                    zh = zh / torch.clamp(d, min=1e-6)
                    e1, e2 = _perp_basis(zh)
                    r_abs = r_sg.abs()
                    rho = r_abs * torch.sqrt(torch.clamp(d[:, 0] ** 2 - r_abs ** 2, min=1e-12)) \
                        / torch.clamp(d[:, 0], min=1e-6)
                    dpts = rho[:, None, None] * (dphi[None, :, 0:1] * e1[:, None, :]
                                                 + dphi[None, :, 1:2] * e2[:, None, :])
                    x_sg, tangent = torch.func.jvp(proj2, (pts,), (dpts,))
                    front = project_to_pixels(frame, pts)[2]
                    # Outward orientation from 3D: the surface normal (p - c)/|p - c|
                    # points out of the sphere, and its pushforward out of the
                    # projected region (a projected-center anchor fails when the
                    # center lies behind the eye plane, as a ground sphere's does).
                    n3d = pts - c_sg[:, None, :]
                    n3d = n3d / torch.clamp(torch.linalg.vector_norm(n3d, dim=-1, keepdim=True),
                                            min=1e-12)
                    _, out2d = torch.func.jvp(proj2, (pts,), (n3d,))
                    valid = (valid_s[:, None] & front).reshape(-1)
                    pieces.append((sphere_x, x_sg.reshape(-1, 2), tangent.reshape(-1, 2),
                                   out2d.reshape(-1, 2), valid, 2.0 * math.pi / m))

                if any(k in params for k in ("quad_q", "quad_u", "quad_v")) and scene.num_quads:
                    me = cfg.samples_per_quad_edge
                    tau = (torch.arange(me, dtype=torch.float32, device=dev) + 0.5) / me

                    def quad_x(p, camera):
                        q = p.get("quad_q", scene.quad_q)
                        u = p.get("quad_u", scene.quad_u)
                        v = p.get("quad_v", scene.quad_v)
                        fr = camera_frame(camera, width, height).to(dev)
                        pts, _ = quad_edge_points(q, u, v, tau)
                        return _proj2(fr)(pts).reshape(-1, 2)

                    u_sg, v_sg = scene.quad_u, scene.quad_v
                    pts, dpts = quad_edge_points(scene.quad_q, u_sg, v_sg, tau)
                    x_sg, tangent = torch.func.jvp(proj2, (pts,), (dpts,))
                    front = project_to_pixels(frame, pts)[2]
                    # In-plane outward directions per edge (the interior lies
                    # toward +v, -u, -v, +u); their pushforward orients the
                    # image normal without an anchor.
                    nq = u_sg.shape[0]
                    out3d = torch.cat([(-v_sg)[:, None, :].expand(nq, me, 3),
                                       u_sg[:, None, :].expand(nq, me, 3),
                                       v_sg[:, None, :].expand(nq, me, 3),
                                       (-u_sg)[:, None, :].expand(nq, me, 3)], dim=1)
                    _, out2d = torch.func.jvp(proj2, (pts,), (out3d,))
                    pieces.append((quad_x, x_sg.reshape(-1, 2), tangent.reshape(-1, 2),
                                   out2d.reshape(-1, 2), front.reshape(-1), 1.0 / me))

                background = cam.background.detach().to(dev)
                edges = []
                for x_fn, x_sg, tangent, out2d, valid, dl in pieces:
                    tan_norm = torch.linalg.vector_norm(tangent, dim=-1)
                    that = tangent / torch.clamp(tan_norm, min=1e-12)[:, None]
                    # The edge's image normal, oriented along the projected
                    # outward direction (away from the primitive's region).
                    n_hat = torch.stack([that[:, 1], -that[:, 0]], dim=-1)
                    out_dot = (n_hat * out2d).sum(dim=-1)
                    n_hat = torch.where((out_dot < 0.0)[:, None], -n_hat, n_hat)
                    in_img = ((x_sg[:, 0] > -0.5) & (x_sg[:, 0] < width - 0.5)
                              & (x_sg[:, 1] > -0.5) & (x_sg[:, 1] < height - 0.5))
                    # Edge-on views: the outward pushforward vanishes and the
                    # orientation (and the contribution) is undefined.
                    ok = (valid & in_img & torch.isfinite(x_sg).all(dim=-1)
                          & (out_dot.abs() > 1e-9))
                    if tr.enabled():
                        tr.count("edge_points", ok.sum())
                    edges.append((x_fn, x_sg, tan_norm, n_hat, ok, dl))

            terms = []
            for x_fn, x_sg, tan_norm, n_hat, ok, dl in edges:
                # Radiance a hair inside and outside the edge, common random
                # numbers. Inside a curved silhouette the hit normal turns like
                # sqrt(eps), L_in(eps) = L_in(0) + c sqrt(eps): extrapolate to
                # the edge with a second trace at 4 eps, L(0) ~ 2 L(eps) - L(4 eps).
                def radiance(x_px):
                    return _trace_edge_radiance(
                        scene, frame, x_px, seed, background=background, max_depth=max_depth,
                        sky_gradient=sky_gradient, spp_edge=cfg.spp_edge, live=ok)

                with tr.span("edges/boundary/trace"):
                    l_in = 2.0 * radiance(x_sg - cfg.eps_px * n_hat) \
                        - radiance(x_sg - 4.0 * cfg.eps_px * n_hat)
                    l_out = radiance(x_sg + cfg.eps_px * n_hat)

                with tr.span("edges/boundary/splat"):
                    ix = torch.clamp(torch.round(x_sg[:, 0]).to(torch.int64), 0, width - 1)
                    iy = torch.clamp(torch.round(x_sg[:, 1]).to(torch.int64), 0, height - 1)
                    ct_px = ct[iy, ix, :]
                    w = (ct_px * (l_in - l_out)).sum(dim=-1) * tan_norm * dl \
                        * ok.to(torch.float32)
                    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
                terms.append((x_fn, w, n_hat))

        with tr.span("edges/boundary/splat"):
            if not terms:
                return edge_leaf_grads(params, cam, cam_names, None)
            return edge_leaf_grads(
                params, cam, cam_names,
                lambda leaves, camera: sum((w * (x_fn(leaves, camera) * n_hat).sum(dim=-1)).sum()
                                           for x_fn, w, n_hat in terms))

    return edge_image_fn(rebuild, width, height, edge_cotangent, "boundary")


def edge_image_fn(rebuild, width: int, height: int, cotangent, name: str):
    """The zero-valued edge image of an edge estimator: image(params, cam,
    seed) -> (H, W, 3) zeros on the scene's device, whose backward against
    a cotangent image `ct` gives `cotangent(params, cam, cam_names, seed,
    ct)`: the gradients of the tensors of `params` in order, then of the
    camera tensors `cam_names` (those that require grad). The function is
    named `<name>_image`; the bucketed step times it as `edges/<name>`."""

    class EdgeImage(torch.autograd.Function):
        @staticmethod
        def forward(ctx, seed, names, cam_names, cam, device, *tensors):
            ctx.seed, ctx.names, ctx.cam_names, ctx.cam = seed, names, cam_names, cam
            ctx.save_for_backward(*tensors)
            return torch.zeros(height, width, 3, dtype=torch.float32, device=device)

        @staticmethod
        def backward(ctx, ct):
            tensors = ctx.saved_tensors
            n = len(ctx.names)
            params = dict(zip(ctx.names, tensors[:n]))
            cam = dataclasses.replace(ctx.cam, **dict(zip(ctx.cam_names, tensors[n:])))
            grads = cotangent(params, cam, ctx.cam_names, ctx.seed, ct)
            return (None, None, None, None, None, *grads)

    def image(params: dict, cam: Camera, seed: int):
        names = tuple(params)
        cam_names = tuple(f for f in CAMERA_FIELDS if getattr(cam, f).requires_grad)
        device = rebuild({k: v.detach() for k, v in params.items()}).sph_center.device
        return EdgeImage.apply(int(seed), names, cam_names, cam, device,
                               *(params[k] for k in names),
                               *(getattr(cam, f) for f in cam_names))

    image.__name__ = image.__qualname__ = f"{name}_image"
    return image


def edge_leaf_grads(params: dict, cam: Camera, cam_names, scalar_fn):
    """Gradients of scalar_fn(leaves, camera) in fresh leaves made from
    `params`' tensors and the camera tensors `cam_names` (in that order),
    zeros where it does not reach one; scalar_fn None gives zeros."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    cam_leaves = {f: getattr(cam, f).detach().requires_grad_(True) for f in cam_names}
    inputs = list(leaves.values()) + list(cam_leaves.values())
    if scalar_fn is None or not inputs:
        return [torch.zeros_like(t) for t in inputs]
    with torch.enable_grad():
        total = scalar_fn(leaves, dataclasses.replace(cam, **cam_leaves))
        grads = torch.autograd.grad(total, inputs, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]
