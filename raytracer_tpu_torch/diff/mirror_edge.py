"""Mirror-reflected silhouette gradients: one specular bounce of edge
sampling (port of raytracer_tpu/diff/mirror_edge.py).

diff/boundary.py samples primary silhouettes; a blocker seen only in a flat
metal mirror (fuzz 0) still draws a sharp discontinuity curve in the image,
its reflected silhouette, that neither interior autodiff nor the primary
and shadow edge terms see. Any discontinuity curve in image space adds the
same Reynolds-transport term

    dI/dtheta = ... + (L_in - L_out) (dx/dtheta . n_hat) |dx/dphi| dphi

however many bounces drew it, and for a flat mirror the curve is closed
form: the reflected view is a pinhole view from the mirrored eye E' =
reflect(eye, mirror plane), so the blocker's reflected silhouette is its
visible contour from E' (boundary.sphere_contour_points), and a contour
point X lands on screen at project(reflect(X, plane)). The reflection is
affine, so positions, velocities and outward directions push forward
through it exactly (torch.func.jvp). One-sided radiance is the full path
trace through pixels a hair inside and outside the curve, with common
random numbers (boundary._trace_edge_radiance).

A screen point counts only where its primary ray really sees that mirror:
a visibility probe through the closest-hit kernel (kernel 1 on CUDA
tensors, its twin on CPU tensors) must find the mirror quad first.

Scope, as in the JAX package: flat mirrors (metal quads with fuzz 0),
sphere blockers, one specular bounce; the mirror's own geometry is not
differentiated here. Pairs are dense (every quad x every sphere, the
non-mirrors masked), meant for scenes of tens of primitives. The camera
tensors that require grad get their share through the projection.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracer_tpu_torch.core import vecmath as vm
from raytracer_tpu_torch.core.camera import Camera, camera_frame
from raytracer_tpu_torch.diff.boundary import (
    _perp_basis,
    _proj2,
    _trace_edge_radiance,
    edge_image_fn,
    edge_leaf_grads,
    project_to_pixels,
    sphere_contour_points,
)
from raytracer_tpu_torch.geometry.intersect import scene_tables
from raytracer_tpu_torch.geometry.scene import METAL
from raytracer_tpu_torch.ops import intersect_kernel as ik


class MirrorEdgeConfig(NamedTuple):
    samples_per_contour: int = 128  # phi samples per (mirror, sphere) pair
    spp_edge: int = 8
    eps_px: float = 0.15


def _mirror_planes(scene):
    """(point (Q, 3), unit normal (Q, 3), is_flat_mirror (Q,)) of every quad."""
    n = vm.cross(scene.quad_u, scene.quad_v)
    n_hat = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    mat = scene.quad_mat.long()
    is_mirror = (scene.mat_type[mat] == METAL) & (scene.mat_fuzz[mat] == 0.0)
    return scene.quad_q, n_hat, is_mirror


def _reflect_point(p, q0, n_hat):
    """Reflect point(s) p (..., 3) about the plane through q0 with unit
    normal n_hat (both broadcasting against p)."""
    d = ((p - q0) * n_hat).sum(dim=-1, keepdim=True)
    return p - 2.0 * d * n_hat


def _reflect_dir(v, n_hat):
    return v - 2.0 * (v * n_hat).sum(dim=-1, keepdim=True) * n_hat


def _mirrored_contours(c, r, eyes, phi):
    """Contour points (Q, S, M, 3) and validity (Q, S) of the spheres (c
    (S, 3), r (S,)) seen from each mirrored eye of `eyes` (Q, 3)."""
    nq, ns = eyes.shape[0], c.shape[0]
    pts, valid = sphere_contour_points(c.repeat(nq, 1), r.repeat(nq),
                                       eyes.repeat_interleave(ns, dim=0), phi)
    return pts.reshape(nq, ns, -1, 3), valid.reshape(nq, ns)


def make_mirror_boundary_fn(
    rebuild,
    *,
    width: int,
    height: int,
    max_depth: int,
    sky_gradient: bool = False,
    config: MirrorEdgeConfig = MirrorEdgeConfig(),
):
    """Build mirror_image(params, cam, seed) -> (H, W, 3): zero forward,
    mirror-silhouette blocker gradients (sph_center, sph_radius, and the
    camera tensors that require grad) backward. Composes additively with
    the render and the other edge images (and with the bucketed backend
    through edge_image_fns)."""
    cfg = config

    def edge_cotangent(params: dict, cam: Camera, cam_names, seed: int, ct):
        with torch.no_grad():
            scene = rebuild({k: v.detach() for k, v in params.items()})
            if scene.num_quads == 0 or scene.num_spheres == 0 or not (
                    "sph_center" in params or "sph_radius" in params):
                return edge_leaf_grads(params, cam, cam_names, None)
            dev = scene.sph_center.device
            frame = camera_frame(cam, width, height).to(dev)
            eye = frame.center
            m = cfg.samples_per_contour
            phi = (torch.arange(m, dtype=torch.float32, device=dev) + 0.5) * (2.0 * math.pi / m)
            q0, n_m, is_mirror = _mirror_planes(scene)
            nq, ns = q0.shape[0], scene.num_spheres

            # ---- positions, tangents, outward directions, validity ----
            c_sg, r_sg = scene.sph_center, scene.sph_radius
            eprime = _reflect_point(eye, q0, n_m)  # (Q, 3)
            pts, valid_cs = _mirrored_contours(c_sg, r_sg, eprime, phi)
            # dX/dphi of each contour circle, per mirrored eye.
            z = c_sg[None, :, :] - eprime[:, None, :]
            dz = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
            e1, e2 = _perp_basis(z / torch.clamp(dz, min=1e-6))
            r_abs = r_sg.abs()
            rho = r_abs * torch.sqrt(torch.clamp(dz[..., 0] ** 2 - r_abs ** 2, min=1e-12)) \
                / torch.clamp(dz[..., 0], min=1e-6)
            dphi = torch.stack([-torch.sin(phi), torch.cos(phi)], dim=-1)  # (M, 2)
            dpts = rho[..., None, None] * (dphi[:, 0:1] * e1[:, :, None, :]
                                           + dphi[:, 1:2] * e2[:, :, None, :])  # (Q, S, M, 3)
            n3d = pts - c_sg[None, :, None, :]
            n3d = n3d / torch.clamp(torch.linalg.vector_norm(n3d, dim=-1, keepdim=True), min=1e-12)
            # Push everything through the (affine) reflection, then project.
            nb, qb = n_m[:, None, None, :], q0[:, None, None, :]
            refl = _reflect_point(pts, qb, nb)
            proj2 = _proj2(frame)
            x_sg, tangent = torch.func.jvp(proj2, (refl,), (_reflect_dir(dpts, nb),))
            _, out2d = torch.func.jvp(proj2, (refl,), (_reflect_dir(n3d, nb),))
            front = project_to_pixels(frame, refl)[2]

            # The blocker must be on the eye's side of the mirror plane (a
            # sphere behind it is seen directly, not in reflection).
            side_e = ((eye - q0) * n_m).sum(dim=-1)  # (Q,)
            side_c = ((c_sg[None, :, :] - q0[:, None, :]) * n_m[:, None, :]).sum(dim=-1)
            same_side = side_e[:, None] * side_c > 0.0
            valid = (is_mirror[:, None, None] & valid_cs[:, :, None] & same_side[:, :, None]
                     & front).reshape(-1)
            x_sg, tangent, out2d = x_sg.reshape(-1, 2), tangent.reshape(-1, 2), out2d.reshape(-1, 2)

            # The screen point must see this mirror: its primary ray's winner
            # (kernel 1 on CUDA tensors) is this quad, prim id S + quad index.
            target = frame.pixel00 + x_sg[:, 0:1] * frame.pixel_du + x_sg[:, 1:2] * frame.pixel_dv
            o_pr = eye.expand_as(target).contiguous()
            _, prim_pr = ik.intersect(*scene_tables(scene), o_pr, (target - o_pr).contiguous())
            want = ns + torch.arange(nq, dtype=torch.int32, device=dev).repeat_interleave(ns * m)
            valid = valid & (prim_pr == want)

            # ---- the Reynolds weight (boundary.py's scaffolding) ----
            tan_norm = torch.linalg.vector_norm(tangent, dim=-1)
            that = tangent / torch.clamp(tan_norm, min=1e-12)[:, None]
            n_hat2 = torch.stack([that[:, 1], -that[:, 0]], dim=-1)
            out_dot = (n_hat2 * out2d).sum(dim=-1)
            n_hat2 = torch.where((out_dot < 0.0)[:, None], -n_hat2, n_hat2)
            in_img = ((x_sg[:, 0] > -0.5) & (x_sg[:, 0] < width - 0.5)
                      & (x_sg[:, 1] > -0.5) & (x_sg[:, 1] < height - 0.5))
            ok = valid & in_img & torch.isfinite(x_sg).all(dim=-1) & (out_dot.abs() > 1e-9)

            background = cam.background.detach().to(dev)

            def radiance(x_px):
                return _trace_edge_radiance(scene, frame, x_px, seed, background=background,
                                            max_depth=max_depth, sky_gradient=sky_gradient,
                                            spp_edge=cfg.spp_edge)

            # sqrt-epsilon extrapolation for the curved inside, as boundary.py.
            l_in = 2.0 * radiance(x_sg - cfg.eps_px * n_hat2) \
                - radiance(x_sg - 4.0 * cfg.eps_px * n_hat2)
            l_out = radiance(x_sg + cfg.eps_px * n_hat2)
            ix = torch.clamp(torch.round(x_sg[:, 0]).to(torch.int64), 0, width - 1)
            iy = torch.clamp(torch.round(x_sg[:, 1]).to(torch.int64), 0, height - 1)
            w = ((ct[iy, ix, :] * (l_in - l_out)).sum(dim=-1) * tan_norm * (2.0 * math.pi / m)
                 * ok.to(torch.float32))
            w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))

        def screen_points(p, camera):
            """Blocker params (and camera) -> reflected contour screen
            positions (Q*S*M, 2), differentiable."""
            fr = camera_frame(camera, width, height).to(dev)
            pts_p, _ = _mirrored_contours(p.get("sph_center", scene.sph_center),
                                          p.get("sph_radius", scene.sph_radius),
                                          _reflect_point(fr.center, q0, n_m), phi)
            return _proj2(fr)(_reflect_point(pts_p, qb, nb)).reshape(-1, 2)

        return edge_leaf_grads(params, cam, cam_names,
                               lambda leaves, camera: (w * (screen_points(leaves, camera)
                                                            * n_hat2).sum(dim=-1)).sum())

    return edge_image_fn(rebuild, width, height, edge_cotangent, "mirror")
