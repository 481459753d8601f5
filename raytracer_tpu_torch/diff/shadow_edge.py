"""Secondary-discontinuity (shadow-edge) gradients by path-space edge
sampling from receiver points (port of raytracer_tpu/diff/shadow_edge.py).

diff/boundary.py handles primary visibility: silhouettes as seen from the
camera. This module adds the next order: silhouettes as seen from the
first-bounce receiver point. When an occluder (or an area light's own rim)
sweeps its projected edge across the hemisphere of scatter directions above
a diffuse receiver, the one-bounce radiance integrand jumps, and interior
autodiff misses the moving-boundary term (tests/test_boundary_grad.py:
finite differences -0.124 against 0.000 on a blocker-position axis).

The expected one-bounce contribution at a receiver y with normal n_y and
Lambertian albedo rho is E = rho * INT L(omega) p(omega) d omega with the
cosine density p = cos/pi. An occluder projects a region on the direction
sphere; L jumps across its boundary curve omega(phi; theta), and Reynolds
transport gives

    dE/dtheta |_boundary = rho * SUM_samples (L_in - L_out)(omega) p(omega)
                           (d omega/d theta . n_hat) ||d omega/d phi|| d phi

with n_hat the outward (unoccluded-side) unit normal of the curve in the
tangent plane at omega. The radiances are traced a hair to each side of the
edge with common random numbers, the weights carry no gradient, and the
parameter velocity enters through the scalar sum sg(w) (omega(theta) .
sg(n_hat)), omega(z(theta), y) = (z - y) / |z - y|.

Edge sources per receiver: every quad's four edges (shadow blockers and the
area light's rim) and every sphere's visible contour from y
(boundary.sphere_contour_points with the eye at y). With `receivers` and
`sources_per_receiver` set, receivers are drawn in proportion to the loss
cotangent and sources in proportion to their projected solid angle, each
reweighted by 1/(count x probability). The draws come from the counter RNG
(ops/ctr_rng.py) by inverse CDF, so the CPU and the card draw the same
receivers and sources for the same seed.

The receivers' hits, like the edge traces (diff/boundary.py:
trace_edge_rays), take a sphere winner's t by the stable quadratic, so a
receiver on a small sphere lies on it and its paths do not re-hit it.

Scope, as in the JAX package: first-bounce Lambertian receivers; receiver
motion is frozen (gradients flow to the edge-casting geometry, not through
y). Every other leaf, and the camera, gets zero.

Inside the bucketed step's `edges/shadow` phase (utils/trace.py) the term
opens `edges/shadow/sample` (receivers, their subsampling, the sources and
the edge points' directions and orientation), `edges/shadow/trace` (the
in/out traces) and `edges/shadow/splat` (the weights against the cotangent
and the VJP into the leaves), and counts `edge_points` (valid samples, a
device sum read at `collect()`) and `edge_rays` (diff/boundary.py:
trace_edge_rays, from shapes): neither syncs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracer_tpu_torch.core import vecmath as vm
from raytracer_tpu_torch.core.camera import Camera, camera_frame, camera_rays
from raytracer_tpu_torch.diff.boundary import (
    _perp_basis,
    edge_image_fn,
    edge_leaf_grads,
    quad_edge_points,
    sphere_contour_points,
    trace_edge_rays,
)
from raytracer_tpu_torch.geometry.intersect import intersect_scene, quad_derived
from raytracer_tpu_torch.geometry.scene import LAMBERTIAN
from raytracer_tpu_torch.materials import packed as pk
from raytracer_tpu_torch.materials.textures import eval_texture_extra, eval_texture_rows
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.utils import trace as tr

# Counters of the subsampling draws under the edge seed (the edge traces
# draw at counters >= ctr_rng.CAM_DRAWS, the receivers' camera jitter at
# 0..CAM_DRAWS-1; these stay clear of both).
RECEIVER_DRAW = -1
QUAD_SOURCE_DRAW = -2
SPHERE_SOURCE_DRAW = -3


class ShadowEdgeConfig(NamedTuple):
    """Shadow-edge sampling budget. Trace cost scales as R x (4 Kq
    samples_per_quad_edge + Ks samples_per_sphere) x 3 traces x spp_edge,
    R the receivers (every pixel when 0) and Kq / Ks the sources a
    receiver (every quad / sphere when 0)."""

    samples_per_quad_edge: int = 8  # per straight edge (x4 edges)
    samples_per_sphere: int = 32  # phi samples around each contour circle
    spp_edge: int = 2  # radiance samples per edge point per side
    eps_dir: float = 2e-3  # in/out angular offset from the edge (radians)
    receivers: int = 0  # 0 = every pixel; else importance-sampled count
    sources_per_receiver: int = 0  # 0 = every source of each kind


def sample_categorical(p, u):
    """Indices drawn by inverse CDF: p (..., n) probabilities along the
    last axis, u (..., k) uniforms in [0, 1) -> (..., k) int64 in [0, n).
    An index of probability 0 is never drawn."""
    cdf = torch.cumsum(p.to(torch.float64), dim=-1)
    idx = torch.searchsorted(cdf, u.to(torch.float64) * cdf[..., -1:], right=True)
    return torch.clamp(idx, max=p.shape[-1] - 1)


def _receiver_albedo(scene, hit):
    """Texture color at each receiver hit (N, 3), from the shading rows
    the integrator reads (materials/packed.py)."""
    qd = quad_derived(scene)
    prim = hit.prim_id.long()
    row = pk.primitive_table(scene, qd)[prim]
    rho = eval_texture_rows(row[:, pk.COL_ITS], row[:, pk.COL_C0], row[:, pk.COL_C1], hit.point)
    textures = pk.texture_tables(scene, qd)
    if textures is not None:
        s = (hit.point - row[:, pk.COL_G]) * row[:, pk.COL_G3][:, None]
        s_unit = s / torch.sqrt((s * s).sum(dim=-1) + 1e-20)[:, None]
        rho = eval_texture_extra(textures, textures.rows[prim], prim >= scene.num_spheres,
                                 s_unit, hit.point, rho)
    return rho


def shadow_edge_gradients(params: dict, rebuild, cam: Camera, seed: int, ct, *, width: int,
                          height: int, max_depth: int, sky_gradient: bool = False,
                          config: ShadowEdgeConfig = ShadowEdgeConfig(), cam_uniforms=None):
    """Gradients (one per tensor of `params`, in order) of sum(ct * the
    shadow image) for a cotangent image ct (H, W, 3). `cam_uniforms` (H*W,
    4) replaces the receivers' camera jitter (ctr_rng.camera_uniforms of
    the seed) when given."""
    cfg = config
    with torch.no_grad():
        with tr.span("edges/shadow/sample"):
            scene = rebuild({k: v.detach() for k, v in params.items()})
            dev = scene.sph_center.device
            frame = camera_frame(cam, width, height).to(dev)
            background = cam.background.detach().to(dev)

            # ---- receivers: one jittered camera ray a pixel ----
            n_pix = width * height
            pix = torch.arange(n_pix, device=dev)
            if cam_uniforms is None:
                cam_uniforms = ctr_rng.camera_uniforms(seed, pix)
            o, d = camera_rays(frame, pix % width, pix // width, cam_uniforms.to(dev))
            hit = intersect_scene(scene, o, d, stable_spheres=True)
            recv_ok = hit.hit & (scene.mat_type[hit.mat_id.long()] == LAMBERTIAN)
            y, n_y = hit.point, hit.normal
            rho = _receiver_albedo(scene, hit)
            ct_px = ct.reshape(n_pix, 3)

            # ---- receiver subsampling: R receivers in proportion to |ct| ----
            n_recv = n_pix
            if cfg.receivers and cfg.receivers < n_pix:
                n_recv = cfg.receivers
                s_imp = ct_px.abs().sum(dim=-1) * recv_ok + 1e-30
                p_r = s_imp / s_imp.sum()
                u = ctr_rng.uniform(seed, torch.arange(n_recv, device=dev), RECEIVER_DRAW)
                idx_r = sample_categorical(p_r, u)
                y, n_y, rho, recv_ok = y[idx_r], n_y[idx_r], rho[idx_r], recv_ok[idx_r]
                ct_px = ct_px[idx_r] / (float(n_recv) * p_r[idx_r])[:, None]

            def select(imp, k_src, draw):
                """Per receiver, k_src sources in proportion to imp (P, n) and
                their weights 1/(k_src p); every source with weight 1 when
                k_src is 0 or covers them all."""
                n = imp.shape[1]
                if not k_src or n <= k_src:
                    sel = torch.arange(n, device=dev).expand(n_recv, n)
                    return sel, torch.ones(n_recv, n, device=dev)
                p_src = imp / imp.sum(dim=-1, keepdim=True)
                lanes = torch.arange(n_recv * k_src, device=dev).reshape(n_recv, k_src)
                sel = sample_categorical(p_src, ctr_rng.uniform(seed, lanes, draw))
                return sel, 1.0 / (float(k_src) * torch.gather(p_src, 1, sel))

        pieces = []  # (omega_fn(params) -> (P*M, 3), w (P*M,), n_hat (P*M, 3))

        def finish(z_sg, dz_sg, out3d, valid_edge, dl, omega_fn):
            """Weights of one edge family: z_sg (P, M, 3) edge points, dz_sg
            their curve velocity, out3d (P, M, 3) a direction out of the
            occluded region at z, valid_edge (P, M), dl (P, M) the line
            measure of a sample."""
            with tr.span("edges/shadow/sample"):
                rel = z_sg - y[:, None, :]
                dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
                omega = rel / torch.clamp(dist, min=1e-9)
                # d omega / d phi: the curve velocity pushed through
                # normalize(z - y), y fixed.
                dom = (dz_sg - (dz_sg * omega).sum(dim=-1, keepdim=True) * omega) \
                    / torch.clamp(dist, min=1e-9)
                tan_norm = torch.linalg.vector_norm(dom, dim=-1)
                that = dom / torch.clamp(tan_norm, min=1e-12)[..., None]
                n_hat = vm.cross(that, omega)
                n_hat = n_hat / torch.clamp(
                    torch.linalg.vector_norm(n_hat, dim=-1, keepdim=True), min=1e-12)
                # Orient outward: along the tangent-plane projection of out3d.
                out_t = out3d - (out3d * omega).sum(dim=-1, keepdim=True) * omega
                sgn = (n_hat * out_t).sum(dim=-1)
                n_hat = torch.where((sgn < 0.0)[..., None], -n_hat, n_hat)

                p_dir = torch.clamp((omega * n_y[:, None, :]).sum(dim=-1), min=0.0) \
                    * (1.0 / math.pi)
                ok = (valid_edge & recv_ok[:, None] & (p_dir > 0.0) & (tan_norm > 1e-9)
                      & (sgn.abs() > 1e-9) & torch.isfinite(omega).all(dim=-1))
                if tr.enabled():
                    tr.count("edge_points", ok.sum())

                p, m = omega.shape[0], omega.shape[1]
                om_f, nh_f = omega.reshape(p * m, 3), n_hat.reshape(p * m, 3)
                origin = y[:, None, :].expand(p, m, 3).reshape(p * m, 3)

            # Radiance just inside and outside the edge from the receiver
            # (trace's t_min lifts the origin off the surface), common random
            # numbers; inside a curved silhouette L varies like sqrt(eps):
            # L(0) ~ 2 L(e) - L(4e).
            def radiance(direction):
                return trace_edge_rays(scene, origin, direction, seed, background=background,
                                       max_depth=max_depth - 1, sky_gradient=sky_gradient,
                                       spp_edge=cfg.spp_edge, live=ok.reshape(p * m))

            e = cfg.eps_dir
            with tr.span("edges/shadow/trace"):
                l_in = 2.0 * radiance(om_f - e * nh_f) - radiance(om_f - 4.0 * e * nh_f)
                l_out = radiance(om_f + e * nh_f)
            with tr.span("edges/shadow/splat"):
                jump = (l_in - l_out).reshape(p, m, 3)
                w = ((ct_px[:, None, :] * rho[:, None, :] * jump).sum(dim=-1) * p_dir * tan_norm
                     * dl * ok.to(torch.float32))
                w = torch.where(torch.isfinite(w), w, torch.zeros_like(w)).reshape(p * m)
            pieces.append((omega_fn, w, nh_f))

        def unit_rel(z):
            """normalize(z - y) of edge points z (P, M, 3), flattened."""
            rel = z - y[:, None, :]
            n = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
            return (rel / torch.clamp(n, min=1e-9)).reshape(-1, 3)

        # ---- quad edges (blockers and area-light rims) ----
        if any(k in params for k in ("quad_q", "quad_u", "quad_v")) and scene.num_quads:
            with tr.span("edges/shadow/sample"):
                me = cfg.samples_per_quad_edge
                tau = (torch.arange(me, dtype=torch.float32, device=dev) + 0.5) / me
                q_sg, u_sg, v_sg = scene.quad_q, scene.quad_u, scene.quad_v
                pts, dpts = quad_edge_points(q_sg, u_sg, v_sg, tau)  # (Q, 4 me, 3)
                nq, m4 = pts.shape[0], pts.shape[1]
                # Out-of-region hints per edge (the interior lies toward +v, -u,
                # -v, +u; boundary.py's table).
                out3d = torch.cat([(-v_sg)[:, None, :].expand(nq, me, 3),
                                   u_sg[:, None, :].expand(nq, me, 3),
                                   v_sg[:, None, :].expand(nq, me, 3),
                                   (-u_sg)[:, None, :].expand(nq, me, 3)], dim=1)
                area = torch.linalg.vector_norm(vm.cross(u_sg, v_sg), dim=-1)
                qc = q_sg + 0.5 * (u_sg + v_sg)
                d2 = ((qc[None, :, :] - y[:, None, :]) ** 2).sum(dim=-1)
                sel_q, w_src = select(area[None, :] / torch.clamp(d2, min=1e-6) + 1e-20,
                                      cfg.sources_per_receiver, QUAD_SOURCE_DRAW)
                k = sel_q.shape[1]
                dl = (w_src / me)[:, :, None].expand(n_recv, k, m4).reshape(n_recv, k * m4)
                # Degenerate (dummy) quads have zero edge velocity: masked by
                # finish's tan_norm guard.
                valid = torch.ones(n_recv, k * m4, dtype=torch.bool, device=dev)

                def quad_omega(p, sel_q=sel_q, k=k):
                    z, _ = quad_edge_points(p.get("quad_q", scene.quad_q),
                                            p.get("quad_u", scene.quad_u),
                                            p.get("quad_v", scene.quad_v), tau)
                    return unit_rel(z[sel_q].reshape(n_recv, k * m4, 3))

            finish(pts[sel_q].reshape(n_recv, k * m4, 3), dpts[sel_q].reshape(n_recv, k * m4, 3),
                   out3d[sel_q].reshape(n_recv, k * m4, 3), valid, dl, quad_omega)

        # ---- sphere contours seen from each receiver ----
        if ("sph_center" in params or "sph_radius" in params) and scene.num_spheres:
            with tr.span("edges/shadow/sample"):
                mp = cfg.samples_per_sphere
                phi = (torch.arange(mp, dtype=torch.float32, device=dev) + 0.5) \
                    * (2.0 * math.pi / mp)
                c_sg, r_sg = scene.sph_center, scene.sph_radius
                r_abs = r_sg.abs()
                dd = torch.linalg.vector_norm(c_sg[None, :, :] - y[:, None, :], dim=-1)  # (P, S)
                # sphere_contour_points' validity: the receiver strictly outside.
                valid_s = dd > r_abs * (1.0 + 1e-4) + 1e-6
                sel_s, w_src = select((r_abs / torch.clamp(dd, min=1e-6)) ** 2 * valid_s + 1e-20,
                                      cfg.sources_per_receiver, SPHERE_SOURCE_DRAW)
                k = sel_s.shape[1]
                eye = y[:, None, :].expand(n_recv, k, 3).reshape(-1, 3)

                def contours(c, r):
                    """Contour points (P, k mp, 3) of the selected spheres from
                    their receivers."""
                    z, _ = sphere_contour_points(c[sel_s].reshape(-1, 3), r[sel_s].reshape(-1),
                                                 eye, phi)
                    return z.reshape(n_recv, k * mp, 3)

                pts = contours(c_sg, r_sg)
                # d pts / d phi of the circle's parameterization, per receiver eye.
                zc = c_sg[sel_s] - y[:, None, :]
                dsel = torch.linalg.vector_norm(zc, dim=-1)
                e1, e2 = _perp_basis(zc / torch.clamp(dsel, min=1e-6)[..., None])
                ra = r_abs[sel_s]
                rho_c = ra * torch.sqrt(torch.clamp(dsel * dsel - ra * ra, min=1e-12)) \
                    / torch.clamp(dsel, min=1e-6)
                dphi = torch.stack([-torch.sin(phi), torch.cos(phi)], dim=-1)  # (mp, 2)
                dpts = rho_c[..., None, None] * (dphi[None, None, :, 0:1] * e1[:, :, None, :]
                                                 + dphi[None, None, :, 1:2] * e2[:, :, None, :])
                # Outward hint: the sphere's surface normal at the contour point
                # (dummy spheres, radius 0, are invalid).
                n3d = pts.reshape(n_recv, k, mp, 3) - c_sg[sel_s][:, :, None, :]
                valid = torch.gather(valid_s, 1, sel_s)[:, :, None].expand(n_recv, k, mp)
                dl = (w_src * (2.0 * math.pi / mp))[:, :, None].expand(n_recv, k, mp)

                def sphere_omega(p):
                    return unit_rel(contours(p.get("sph_center", scene.sph_center),
                                             p.get("sph_radius", scene.sph_radius)))

            finish(pts, dpts.reshape(n_recv, k * mp, 3), n3d.reshape(n_recv, k * mp, 3),
                   valid.reshape(n_recv, k * mp), dl.reshape(n_recv, k * mp), sphere_omega)

    with tr.span("edges/shadow/splat"):
        if not pieces:
            return edge_leaf_grads(params, cam, (), None)
        return edge_leaf_grads(
            params, cam, (),
            lambda leaves, _: sum((w * (fn(leaves) * n_sg).sum(dim=-1)).sum()
                                  for fn, w, n_sg in pieces))


def make_shadow_boundary_fn(
    rebuild,
    *,
    width: int,
    height: int,
    max_depth: int,
    sky_gradient: bool = False,
    config: ShadowEdgeConfig = ShadowEdgeConfig(),
):
    """Build shadow_image(params, cam, seed) -> (H, W, 3).

    Forward: exact zeros (a pure-gradient term, like boundary.py).
    Backward: the shadow-edge cotangents of the geometry leaves present in
    `params` (sph_center, sph_radius, quad_q/u/v); every other leaf and the
    camera get zeros. Add it to the interior render (diff/grad.py:
    render_linear_diff) and the boundary image before the loss."""

    def cotangent(params, cam, cam_names, seed, ct):
        grads = shadow_edge_gradients(params, rebuild, cam, seed, ct, width=width,
                                      height=height, max_depth=max_depth,
                                      sky_gradient=sky_gradient, config=config)
        return grads + [torch.zeros_like(getattr(cam, f)) for f in cam_names]

    return edge_image_fn(rebuild, width, height, cotangent, "shadow")
