"""Refracted-silhouette gradients through glass spheres: specular-manifold
edge sampling (port of raytracer_tpu/diff/refracted_edge.py).

A blocker seen through a dielectric sphere contributes its gradient through
the edges of its refracted image, a discontinuity curve in screen space
that interior autodiff and the primary, shadow and mirror edge terms all
miss. For a sphere the two-interface chain is closed form per screen point,

    P(s) = plane-hit(refract_out(travel(refract_in(camera_ray(s))))),

so the curve is found by a specular-manifold Newton solve (the walk of
Jakob & Marschner 2012, for one glass sphere): for each sample Y(tau) on a
blocker quad edge, solve F(s) = plane_coords(P(s)) - plane_coords(Y) = 0
for the screen position s (2 equations, 2 unknowns, the 2x2 Jacobian from
two forward-mode tangents; damped fixed-iteration Newton, batched over
every (glass, quad, sample) lane and two inits; lanes that miss, reflect
totally or do not converge are masked).

After the solve the implicit-function theorem gives every velocity from
the same Jacobian J = dF/ds: s_lin(theta) = s* + J^{-1} (y2(theta) -
sg(y2)) equals s* at the current parameters and carries the first-order
ds/dtheta, so boundary.py's Reynolds pull-back applies unchanged. The
one-sided radiances are full camera paths through pixels a hair inside
and outside the curve (common random numbers): every branch but
refract-refract is the same on both sides and cancels.

Scope, as in the JAX package: one dielectric sphere (entry and exit), quad
blockers on the far side of the glass, roots only as far as the two Newton
inits reach (direct projection and the image inverted through the center);
TIR curves and glass in glass are out. The JAX package's differentiable
scalar does not use the camera (its `scalar(p, camera)`), so every camera
tensor gets zero here too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.core.camera import Camera, camera_frame
from raytracer_tpu_torch.diff.boundary import (
    _trace_edge_radiance,
    edge_image_fn,
    edge_leaf_grads,
    project_to_pixels,
    quad_edge_points,
)
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.geometry.scene import DIELECTRIC


class RefractedEdgeConfig(NamedTuple):
    samples_per_quad_edge: int = 32  # per straight edge (x4 edges)
    spp_edge: int = 8
    eps_px: float = 0.15
    newton_iters: int = 16
    newton_tol: float = 1e-3  # |F| in blocker-plane units
    damping: float = 0.7


def _glass_spheres(scene):
    """(center (S, 3), radius (S,), ior (S,), is_glass (S,)): dielectric
    spheres of positive radius (a hollow shell's inner sphere would make a
    chain of four interfaces)."""
    mat = scene.sph_mat.long()
    is_glass = (scene.mat_type[mat] == DIELECTRIC) & (scene.sph_radius > 0.0)
    return scene.sph_center, scene.sph_radius, scene.mat_ior[mat], is_glass


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _refract_unit(d, n, eta):
    """Snell refraction of unit d (K, 3) about unit n (d.n < 0), ratio eta
    (K,): (direction, total internal reflection)."""
    cos_i = -_dot(d, n)
    sin2_t = eta ** 2 * torch.clamp(1.0 - cos_i ** 2, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    return eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * n, sin2_t > 1.0


def _chain_to_plane(s, frame, c, r, ior, plane):
    """Screen points s (K, 2) -> in-plane (alpha, beta) (K, 2) of the
    refract-refract chain's hit on each lane's blocker plane, and a
    validity flag (K,). c (K, 3), r, ior (K,) are the lanes' glass spheres;
    `plane` = (normal (K, 3), d (K,), av (K, 3), bv (K, 3), q_av, q_bv (K,))
    their quads' geometry.intersect.QuadDerived rows, so alpha = P.av -
    Q.av and beta = P.bv - Q.bv as the quads' own coordinates."""
    n_p, d_p, av, bv, qav, qbv = plane
    target = frame.pixel00 + s[:, 0:1] * frame.pixel_du + s[:, 1:2] * frame.pixel_dv
    o = frame.center
    d = target - o
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)

    # Entry: the nearest sphere root.
    oc = o - c
    b = _dot(d, oc)
    disc = b * b - (_dot(oc, oc) - r * r)
    t1 = -b - torch.sqrt(torch.clamp(disc, min=1e-12))
    p1 = o + t1[:, None] * d
    d1, tir1 = _refract_unit(d, (p1 - c) / r[:, None], 1.0 / ior)
    ok = (disc > 0.0) & (t1 > 1e-4) & ~tir1

    # Exit: the far root of the internal chord.
    oc2 = p1 - c
    b2 = _dot(d1, oc2)
    disc2 = b2 * b2 - (_dot(oc2, oc2) - r * r)
    t2 = -b2 + torch.sqrt(torch.clamp(disc2, min=1e-12))
    p2 = p1 + t2[:, None] * d1
    d2, tir2 = _refract_unit(d1, (c - p2) / r[:, None], ior)  # inward normal at the exit
    ok = ok & ~tir2

    # The blocker plane's hit.
    denom = _dot(d2, n_p)
    t3 = (d_p - _dot(p2, n_p)) / torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9),
                                             denom)
    ok = ok & (t3 > 1e-4)
    hp = p2 + t3[:, None] * d2
    return torch.stack([_dot(hp, av) - qav, _dot(hp, bv) - qbv], dim=-1), ok


def _inverse_2x2(j, floor: float):
    """Inverses (K, 2, 2) of j (K, 2, 2), a determinant under `floor` in
    magnitude replaced by +floor; and the mask of those determinants."""
    det = j[:, 0, 0] * j[:, 1, 1] - j[:, 0, 1] * j[:, 1, 0]
    small = det.abs() < floor
    adj = torch.stack([torch.stack([j[:, 1, 1], -j[:, 0, 1]], dim=-1),
                       torch.stack([-j[:, 1, 0], j[:, 0, 0]], dim=-1)], dim=1)
    return adj / torch.where(small, torch.full_like(det, floor), det)[:, None, None], small


def _value_and_jacobian(fn, s):
    """(fn(s), dF/ds (K, 2, 2)) of a lane-wise map fn: (K, 2) -> (K, 2),
    column i of the Jacobian the forward-mode tangent along unit vector i
    of every lane's s."""
    eye = torch.eye(2, dtype=s.dtype, device=s.device)
    (value, col0), (_, col1) = (torch.func.jvp(fn, (s,), (eye[i].expand_as(s),))
                                for i in range(2))
    return value, torch.stack([col0, col1], dim=-1)


def manifold_solve(frame, c, r, ior, plane, y3, y2, cfg: RefractedEdgeConfig):
    """The refract-refract screen roots of blocker-plane points: per lane
    (glass sphere c (K, 3), r, ior (K,); its quad's `plane` rows as in
    _chain_to_plane; the edge point y3 (K, 3) and its plane coordinates y2
    (K, 2)), Newton from the direct projection of y3 and from its image
    inverted through the sphere's center. Returns (roots (K, 2, 2) in
    pixels, J^{-1} (K, 2, 2, 2) at each root, converged (K, 2)); a root
    found twice (within 0.5 px) counts once."""

    def f(s):
        return _chain_to_plane(s, frame, c, r, ior, plane)[0] - y2

    def newton(s):
        for _ in range(cfg.newton_iters):
            fs, jac = _value_and_jacobian(f, s)
            inv, _ = _inverse_2x2(jac, 1e-12)
            # Damped, clipped steps: the chain is wildly nonlinear near the rim.
            step = torch.clamp(torch.einsum("kab,kb->ka", inv, fs), -8.0, 8.0)
            s = s - cfg.damping * step
        p2d, ok = _chain_to_plane(s, frame, c, r, ior, plane)
        return s, ok & (torch.linalg.vector_norm(p2d - y2, dim=-1) < cfg.newton_tol)

    def init(p):
        sx, sy, _ = project_to_pixels(frame, p)
        return torch.stack([sx, sy], dim=-1)

    s1, conv1 = newton(init(y3))
    s2, conv2 = newton(init(2.0 * c - y3))
    conv2 = conv2 & ~(conv1 & (torch.linalg.vector_norm(s1 - s2, dim=-1) < 0.5))
    roots, invs, convs = [], [], []
    for s, conv in ((s1, conv1), (s2, conv2)):
        # The implicit-function velocities ds/dy2 = J^{-1} at the root.
        inv, bad = _inverse_2x2(_value_and_jacobian(f, s)[1], 1e-10)
        roots.append(s)
        invs.append(inv)
        convs.append(conv & ~bad)
    return torch.stack(roots, dim=1), torch.stack(invs, dim=1), torch.stack(convs, dim=1)


def make_refracted_boundary_fn(
    rebuild,
    *,
    width: int,
    height: int,
    max_depth: int,
    sky_gradient: bool = False,
    config: RefractedEdgeConfig = RefractedEdgeConfig(),
):
    """Build refracted_image(params, cam, seed) -> (H, W, 3): zero forward,
    refracted-silhouette gradients of quad blockers (quad_q, quad_u,
    quad_v) seen through dielectric spheres backward; every camera tensor
    gets zero, as in the JAX package. Composes additively like the other
    edge terms (and with the bucketed backend through edge_image_fns)."""
    cfg = config

    def edge_cotangent(params: dict, cam: Camera, cam_names, seed: int, ct):
        with torch.no_grad():
            scene = rebuild({k: v.detach() for k, v in params.items()})
            if scene.num_quads == 0 or scene.num_spheres == 0 or not any(
                    k in params for k in ("quad_q", "quad_u", "quad_v")):
                return edge_leaf_grads(params, cam, cam_names, None)
            dev = scene.sph_center.device
            frame = camera_frame(cam, width, height).to(dev)
            c_all, r_all, ior_all, glass = _glass_spheres(scene)
            ns, nq = scene.num_spheres, scene.num_quads
            me = cfg.samples_per_quad_edge
            m4 = 4 * me
            tau = (torch.arange(me, dtype=torch.float32, device=dev) + 0.5) / me
            qd = quad_derived(scene)
            u_sg, v_sg = scene.quad_u, scene.quad_v
            pts, dpts = quad_edge_points(scene.quad_q, u_sg, v_sg, tau)  # (Q, M4, 3)
            # Out-of-region directions per edge (the interior lies toward +v,
            # -u, -v, +u).
            out3d = torch.cat([(-v_sg)[:, None, :].expand(nq, me, 3),
                               u_sg[:, None, :].expand(nq, me, 3),
                               v_sg[:, None, :].expand(nq, me, 3),
                               (-u_sg)[:, None, :].expand(nq, me, 3)], dim=1)

            def plane_2d(x, av, bv):
                """In-plane components (Q, M4, 2) of vectors x (Q, M4, 3)."""
                return torch.stack([torch.einsum("qmk,qk->qm", x, av),
                                    torch.einsum("qmk,qk->qm", x, bv)], dim=-1)

            # Lanes (glass, quad, sample), glass-major as in the JAX package.
            gi = torch.arange(ns, device=dev).repeat_interleave(nq * m4)
            qi = torch.arange(nq, device=dev).repeat_interleave(m4).repeat(ns)
            mi = torch.arange(m4, device=dev).repeat(ns * nq)
            y3 = pts[qi, mi]
            y2 = (plane_2d(pts, qd.av, qd.bv) - torch.stack([qd.q_av, qd.q_bv], dim=-1)[:, None, :])
            plane = (qd.normal[qi], qd.d[qi], qd.av[qi], qd.bv[qi], qd.q_av[qi], qd.q_bv[qi])
            roots, j_invs, convs = manifold_solve(frame, c_all[gi], r_all[gi], ior_all[gi], plane,
                                                  y3, y2[qi, mi], cfg)

            def rep(a):
                """(Q, M4, ...) -> (K, ...): broadcast over glass, then roots."""
                return a[qi, mi].repeat_interleave(2, dim=0)

            # Flatten (glass, quad, sample, root) -> K.
            x_sg = roots.reshape(-1, 2)
            j_inv = j_invs.reshape(-1, 2, 2)
            valid = convs.reshape(-1) & glass[gi].repeat_interleave(2)
            # Screen tangent and outward direction through ds/dy2 = J^{-1}.
            tangent = torch.einsum("kab,kb->ka", j_inv, rep(plane_2d(dpts, qd.av, qd.bv)))
            out2d = torch.einsum("kab,kb->ka", j_inv, rep(plane_2d(out3d, qd.av, qd.bv)))

            tan_norm = torch.linalg.vector_norm(tangent, dim=-1)
            that = tangent / torch.clamp(tan_norm, min=1e-12)[:, None]
            n_hat2 = torch.stack([that[:, 1], -that[:, 0]], dim=-1)
            out_dot = (n_hat2 * out2d).sum(dim=-1)
            n_hat2 = torch.where((out_dot < 0.0)[:, None], -n_hat2, n_hat2)
            in_img = ((x_sg[:, 0] > -0.5) & (x_sg[:, 0] < width - 0.5)
                      & (x_sg[:, 1] > -0.5) & (x_sg[:, 1] < height - 0.5))
            ok = (valid & in_img & torch.isfinite(x_sg).all(dim=-1)
                  & torch.isfinite(tangent).all(dim=-1) & (out_dot.abs() > 1e-9)
                  & (tan_norm < 1e4))

            background = cam.background.detach().to(dev)

            def radiance(x_px):
                return _trace_edge_radiance(scene, frame, x_px, seed, background=background,
                                            max_depth=max_depth, sky_gradient=sky_gradient,
                                            spp_edge=cfg.spp_edge)

            l_in = 2.0 * radiance(x_sg - cfg.eps_px * n_hat2) \
                - radiance(x_sg - 4.0 * cfg.eps_px * n_hat2)
            l_out = radiance(x_sg + cfg.eps_px * n_hat2)
            ix = torch.clamp(torch.round(x_sg[:, 0]).to(torch.int64), 0, width - 1)
            iy = torch.clamp(torch.round(x_sg[:, 1]).to(torch.int64), 0, height - 1)
            # d tau = 1/me; the tangent carries |ds/dtau|.
            w = ((ct[iy, ix, :] * (l_in - l_out)).sum(dim=-1) * tan_norm * (1.0 / me)
                 * ok.to(torch.float32))
            w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
            y2_sg = rep(y2)

        def scalar(p, _camera):
            """sum w (s(theta) . n_hat), s(theta) = s* + J^{-1} (y2(theta) -
            sg(y2)): only the edge points' plane coordinates move (the
            plane's basis is held, a second-order bias in the
            displacement)."""
            pts_t, _ = quad_edge_points(p.get("quad_q", scene.quad_q),
                                        p.get("quad_u", scene.quad_u),
                                        p.get("quad_v", scene.quad_v), tau)
            y2_t = rep(plane_2d(pts_t, qd.av, qd.bv)
                       - torch.stack([qd.q_av, qd.q_bv], dim=-1)[:, None, :])
            s_theta = x_sg + torch.einsum("kab,kb->ka", j_inv, y2_t - y2_sg)
            return (w * (s_theta * n_hat2).sum(dim=-1)).sum()

        grads = edge_leaf_grads(params, cam, (), scalar)
        return grads + [torch.zeros_like(getattr(cam, f)) for f in cam_names]

    return edge_image_fn(rebuild, width, height, edge_cotangent, "refracted")
