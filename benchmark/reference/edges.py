"""The visibility terms of the inverse-rendering gradient in plain PyTorch,
in float64 (the receivers' search excepted, below): the boundary terms of
Li, Aittala, Durand and Lehtinen,
"Differentiable Monte Carlo Ray Tracing through Edge Sampling" (SIGGRAPH
Asia 2018), that interior autodiff (train.py) cannot see, for the sphere
leaves `sph_center` and `sph_radius`.

A pixel is only piecewise smooth in the geometry: moving a sphere moves the
curves across which the integrand jumps, and Reynolds transport adds, for
each curve x(phi; theta),

    dI/dtheta |_edge = sum over samples (L_in - L_out) (dx/dtheta . n) |dx/dphi| dphi

with n the curve's unit normal pointing out of the primitive's region and
L_in, L_out the radiance just inside and outside it. Two curves are sampled:

* **primary silhouettes**: each sphere's visible contour from the lens
  centre, a circle in the plane (p - c).z = -r^2 / d (z the unit vector
  from the eye to the centre c, d the distance, r the radius) of radius
  r sqrt(d^2 - r^2) / d, at phi = (k + 0.5) 2 pi / m, k < m; projected to
  continuous pixel coordinates (pixel (i, j) centred on (i, j)); n is the
  image normal of the projected circle, oriented by the pushforward of the
  surface normal (p - c) / |p - c|; each sample's weight is splatted
  against the cotangent of the pixel it rounds to;
* **first-bounce shadow edges**: from receivers y, the first hits of one
  jittered camera ray a pixel on a Lambertian surface, each sphere's
  contour seen from y, a curve omega(phi) = (p(phi) - y) / |p - y| on the
  sphere of directions, weighted by the receiver's albedo and the cosine
  density cos / pi of the direction; n lies in the tangent plane of
  omega, oriented by the surface normal at p. With a budget, receivers
  are drawn in proportion to |cotangent| and the sources of each in
  proportion to their projected solid angle (r / |c - y|)^2, each by the
  inverse of its cumulative distribution over the counter hash (rng.py)
  at counters 2^32 - 1 (receivers) and 2^32 - 3 (sources), and reweighted
  by 1 / (count x probability).

L_in is 2 L(eps) - L(4 eps) and L_out L(eps), eps along -n and +n: a
boundary step of eps_px pixels, a shadow one of eps_dir radians. Each L is
the mean of `spp_edge` paths traced from the given rays (`trace_rays`:
reference/tracer.py's closest hit and shading, russian roulette from
depth 5 with survival clip(max throughput, 0.05, 0.75)), sample j of point
k of a family of K points being sample id j K + k under the term's seed,
so that the in and out traces share their random numbers. Term i of a step
seeded s is seeded by the counter hash of (s, 6070, i + 1): the boundary
term 0, the shadow term 1. A contour circle's frame takes the helper axis
y, or x where the unit vector to the centre has |y| >= 0.9.

Departures from an exact boundary integral, as the renderer has them:

* the silhouette is the pinhole contour from the lens centre, while the
  camera is a 0.6 degree thin lens;
* L(0) is extrapolated as 2 L(eps) - L(4 eps) (inside a curved silhouette
  the hit normal turns like sqrt(eps)), not traced at the edge;
* shadow edges beyond the first bounce, and edges seen in mirrors or
  through glass, are left out; the receiver is held fixed (its own motion
  carries no edge term);
* samples whose curve runs edge-on (|outward . n| <= 1e-9), leaves the
  image, or lies behind the eye are dropped.

Quads, their edges and the rims of quad lights, are not exercised by the
benchmark's cells: a trainable quad leaf raises NotImplementedError.

Precision: everything is computed in the scene's dtype (float64 for the
benchmark's check; bfloat16 for its control): the curves, their
projection and orientation, the traced radiance, the receivers' points,
the weights and their VJP. One part is float32: the search that picks
each pixel's first hit for the shadow term's receiver draw (`receivers`).
That draw inverts a cumulative distribution over every pixel's
hit-or-miss, so one grazing pixel whose winner differs between float32
and float64 moves a fifth of the later draws by a pixel; the program
searches in float32, and the draw is the estimator's, not the geometry's.
Each receiver's point is then its winner's textbook root in the scene's
dtype.

`follow_edges` extends train.follow: each step's gradient is the
interior's, in the scene's precision (the train cell's float32), plus
both edge terms' at the step's own image cotangent.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import rng, tracer
from benchmark.reference import train
from benchmark.scenes import LAMBERTIAN, image_size

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EDGE_STREAM = 6070
RECEIVER_DRAW = -1
SPHERE_SOURCE_DRAW = -3
ROULETTE = (5, 0.05, 0.75)
QUAD_LEAVES = ("quad_q", "quad_u", "quad_v")
FAULTS = ("no_boundary", "no_shadow", "seed_shift", "no_extrapolation", "half_eps",
          "half_receivers", "half_batch")


class Boundary(NamedTuple):
    samples_per_sphere: int = 256
    spp_edge: int = 8
    eps_px: float = 0.15


class Shadow(NamedTuple):
    samples_per_sphere: int = 32
    spp_edge: int = 2
    eps_dir: float = 2e-3
    receivers: int = 0  # 0: every pixel
    sources: int = 0  # 0: every sphere


def budgets(n_primitives: int, width: int, height: int) -> tuple:
    """(Boundary, Shadow) budgets of a scene: every sample up to 64
    primitives; past that 64 points a contour and 4 paths a point for the
    boundary, and for the shadow (also past 2^14 pixels) 1024 receivers, 4
    sources each and 16 points a contour."""
    boundary = Boundary(64, 4) if n_primitives > 64 else Boundary()
    shadow = (Shadow(16, receivers=1024, sources=4)
              if n_primitives > 64 or width * height > (1 << 14) else Shadow())
    return boundary, shadow


def edge_seed(seed: int, i: int) -> int:
    """The seed of edge term i in a step seeded `seed`."""
    return int(rng.hash_word(seed, torch.tensor(EDGE_STREAM), i + 1))


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(x, floor=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=floor)


def trace_rays(tb: tracer.Tables, o, d, seed: int, ids, *, max_depth: int, background,
               sky_gradient: bool):
    """Radiance (N, 3) of one path from each ray (o, d), ray k sample id
    ids[k] under `seed`: tracer.trace's estimator from given rays, with
    russian roulette (ROULETTE)."""
    dtype, dev = o.dtype, o.device
    rad = torch.zeros(o.shape[0], 3, dtype=dtype, device=dev)
    tp = torch.ones_like(rad)
    lanes = torch.arange(o.shape[0], device=dev)
    j3 = torch.arange(rng.SHADING_DRAWS, device=dev)
    start, lo, hi = ROULETTE
    for bounce in range(max_depth):
        if lanes.numel() == 0:
            break
        sid = ids[lanes]
        t, prim = tracer.closest_hit(tb, o, d)
        hit = prim >= 0
        t = torch.where(hit, t, torch.zeros_like(t))
        u = rng.uniform(seed, sid[:, None], rng.shading_ctr(bounce, j3)).to(dtype)
        point, new_d, att, scatters, emitted = tracer.shade(tb, t, torch.clamp(prim, min=0),
                                                            o, d, u)
        bg = tracer.sky(d) if sky_gradient else background.to(dtype).expand_as(d)
        rad = rad.index_add(0, lanes, torch.where(hit[:, None], tp * emitted, tp * bg))
        alive = hit & scatters & (bounce + 1 < max_depth)
        tp_next = torch.where(alive[:, None], tp * att, tp)
        if bounce + 1 >= start:
            q = torch.clamp(tp_next.max(dim=1).values, min=lo, max=hi)
            coin = rng.uniform(seed, sid, rng.roulette_ctr(bounce, max_depth)).to(dtype)
            alive = alive & (coin < q)
            tp_next = torch.where(alive[:, None], tp_next / q[:, None], tp_next)
        lanes, o, d, tp = lanes[alive], point[alive], new_d[alive], tp_next[alive]
    return rad


def edge_radiance(tb, o, d, seed: int, keep, n_points: int, spp: int, **kw):
    """Mean radiance (len(keep), 3) of `spp` paths from each ray (o, d) of
    the points `keep` (indices into a family of n_points): path j of point
    k is sample id j * n_points + k."""
    ids = (torch.arange(spp, device=o.device)[:, None] * n_points + keep[None, :]).reshape(-1)
    rad = trace_rays(tb, o.repeat(spp, 1), d.repeat(spp, 1), seed, ids, **kw)
    return rad.reshape(spp, keep.shape[0], 3).mean(0)


def contour(c, r, eye, phi):
    """Contour circle points (..., M, 3) of spheres (c (..., 3), r (...))
    seen from `eye` (..., 3) at angles phi (M,), their velocity dp/dphi,
    and where the eye lies outside the sphere (...)."""
    r = r.abs()
    z = c - eye
    d = torch.linalg.vector_norm(z, dim=-1)
    margin = r * (1.0 + 1e-4) + 1e-6
    valid = d > margin
    d = torch.maximum(d, margin)
    zh = z / d[..., None]
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=zh.dtype, device=zh.device).expand_as(zh)
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=zh.dtype, device=zh.device).expand_as(zh)
    helper = torch.where(zh[..., 1:2].abs() < 0.9, y_axis, x_axis)
    e1 = _unit(torch.linalg.cross(zh, helper, dim=-1))
    e2 = torch.linalg.cross(zh, e1, dim=-1)
    a = r * r / d
    rho = r * torch.sqrt(torch.clamp(d * d - r * r, min=1e-12)) / d
    cos, sin = torch.cos(phi)[:, None], torch.sin(phi)[:, None]
    e1, e2 = e1[..., None, :], e2[..., None, :]
    p = (c - a[..., None] * zh)[..., None, :] + rho[..., None, None] * (cos * e1 + sin * e2)
    return p, rho[..., None, None] * (cos * e2 - sin * e1), valid


def pixel_coords(fr: tracer.Frame, p):
    """Continuous pixel coordinates (..., 2) of world points p (..., 3) seen
    from the lens centre, and whether each lies in front of the eye."""
    rel, q0 = p - fr.center, fr.pixel00 - fr.center
    n = torch.linalg.cross(fr.du, fr.dv, dim=-1)
    den = _dot(rel, n)
    lam = _dot(q0, n) / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    onto = lam[..., None] * rel - q0
    return torch.stack([_dot(onto, fr.du) / _dot(fr.du, fr.du),
                        _dot(onto, fr.dv) / _dot(fr.dv, fr.dv)], -1), lam > 0.0


def _leaf_grads(sc, leaves, total_fn):
    """Gradients in `leaves` (names) of total_fn(centre, radius), zeros for
    every leaf but the spheres' and for a total_fn of None."""
    c = sc.sph_center.detach().clone().requires_grad_(True)
    r = sc.sph_radius.detach().clone().requires_grad_(True)
    got = {}
    if total_fn is not None:
        got = dict(zip(("sph_center", "sph_radius"), torch.autograd.grad(total_fn(c, r), [c, r])))
    return {k: got[k] if k in got else torch.zeros_like(getattr(sc, k)) for k in leaves}


def boundary_grads(sc: tracer.RefScene, leaves, camera: dict, seed: int, cts, *,
                   max_depth: int, budget: Boundary, fault=None) -> list:
    """The primary-silhouette term's gradient in `leaves` of sum(ct * image),
    one for each image cotangent ct (H, W, 3) of `cts`, under the term's
    seed `seed`: its paths, which no cotangent moves, traced once."""
    width, height = image_size(camera)
    dtype, dev = sc.sph_center.dtype, sc.sph_center.device
    fr = tracer.camera_frame(camera, width).to(dev, dtype)
    tb = tracer.tables(sc)
    m = budget.samples_per_sphere
    phi = (torch.arange(m, device=dev, dtype=dtype) + 0.5) * (2.0 * math.pi / m)
    eps = budget.eps_px * (0.5 if fault == "half_eps" else 1.0)

    def project(p):
        return pixel_coords(fr, p)[0]

    with torch.no_grad():
        p, dp, valid = contour(sc.sph_center, sc.sph_radius, fr.center, phi)
        x, tangent = torch.func.jvp(project, (p,), (dp,))
        _, out2d = torch.func.jvp(project, (p,), (_unit(p - sc.sph_center[:, None, :]),))
        front = pixel_coords(fr, p)[1]
        x, tangent, out2d = x.reshape(-1, 2), tangent.reshape(-1, 2), out2d.reshape(-1, 2)
        length = torch.linalg.vector_norm(tangent, dim=-1)
        that = tangent / torch.clamp(length, min=1e-12)[:, None]
        n = torch.stack([that[:, 1], -that[:, 0]], -1)
        out_dot = _dot(n, out2d)
        n = torch.where((out_dot < 0.0)[:, None], -n, n)
        inside = ((x[:, 0] > -0.5) & (x[:, 0] < width - 0.5)
                  & (x[:, 1] > -0.5) & (x[:, 1] < height - 0.5))
        ok = ((valid[:, None] & front).reshape(-1) & inside & torch.isfinite(x).all(-1)
              & (out_dot.abs() > 1e-9))
        keep = torch.nonzero(ok).squeeze(1)
        if keep.numel() == 0:
            return [_leaf_grads(sc, leaves, None) for _ in cts]
        xk, nk = x[keep], n[keep]
        bg = torch.tensor(camera["background"], dtype=dtype, device=dev)
        kw = dict(max_depth=max_depth, background=bg,
                  sky_gradient=camera.get("sky_gradient", False))

        def radiance(xp):
            target = fr.pixel00 + xp[:, 0:1] * fr.du + xp[:, 1:2] * fr.dv
            eye = fr.center.expand_as(target)
            return edge_radiance(tb, eye, target - eye, seed, keep, x.shape[0], budget.spp_edge,
                                 **kw)

        l_in = radiance(xk - eps * nk)
        if fault != "no_extrapolation":
            l_in = 2.0 * l_in - radiance(xk - 4.0 * eps * nk)
        l_out = radiance(xk + eps * nk)
        ix = torch.clamp(torch.round(xk[:, 0]).long(), 0, width - 1)
        iy = torch.clamp(torch.round(xk[:, 1]).long(), 0, height - 1)
        ws = []
        for ct in cts:
            w = (_dot(ct.to(dev, dtype)[iy, ix], l_in - l_out) * length[keep]
                 * (2.0 * math.pi / m))
            ws.append(torch.where(torch.isfinite(w), w, torch.zeros_like(w)))

    def total(w):
        def fn(c, r):
            pts, _, _ = contour(c, r, fr.center, phi)
            return (w * _dot(project(pts).reshape(-1, 2)[keep], nk)).sum()

        return fn

    return [_leaf_grads(sc, leaves, total(w)) for w in ws]


def _draw(p, u):
    """Indices (..., k) drawn by inverse CDF from probabilities p (..., n)
    at uniforms u (..., k); an index of probability 0 is never drawn."""
    cdf = torch.cumsum(p.double(), -1)
    idx = torch.searchsorted(cdf, u.double() * cdf[..., -1:], right=True)
    return torch.clamp(idx, max=p.shape[-1] - 1)


def receivers(sc: tracer.RefScene, camera: dict, seed: int):
    """(hit point (P, 3), primitive (P,), -1 on a miss, direction (P, 3))
    of one jittered camera ray a pixel under `seed`: each pixel's winner by
    the search in float32 (the module docstring says why), its point by the
    winner's textbook root in the scene's dtype."""
    width, height = image_size(camera)
    n_pix, dtype, dev = width * height, sc.sph_center.dtype, sc.sph_center.device
    pix = torch.arange(n_pix, device=dev)
    fr32 = tracer.camera_frame(camera, width).to(dev, torch.float32)
    o32, d32 = tracer.camera_rays(fr32, seed, pix, width, n_pix, torch.float32)
    _, prim = tracer.closest_hit(tracer.tables(cast(sc, torch.float32)), o32, d32)
    fr = tracer.camera_frame(camera, width).to(dev, dtype)
    o, d = tracer.camera_rays(fr, seed, pix, width, n_pix, dtype)
    t = tracer.winner_t(tracer.tables(sc), sc, o, d, torch.clamp(prim, min=0))
    return o + torch.where(prim >= 0, t, torch.zeros_like(t))[:, None] * d, prim, d


def shadow_grads(sc: tracer.RefScene, leaves, camera: dict, seed: int, ct, *, max_depth: int,
                 budget: Shadow, fault=None) -> dict:
    """The first-bounce shadow-edge term's gradient in `leaves` of sum(ct *
    image) for an image cotangent ct (H, W, 3), under the term's seed."""
    width, height = image_size(camera)
    n_pix = width * height
    dtype, dev = sc.sph_center.dtype, sc.sph_center.device
    ct = ct.to(dev, dtype).reshape(n_pix, 3)
    tb = tracer.tables(sc)
    with torch.no_grad():
        y, prim, d = receivers(sc, camera, seed)
        hit = prim >= 0
        pw = torch.clamp(prim, min=0)
        s = (y - tb.g[pw]) * tb.g3[pw][:, None]
        outward = torch.where((pw >= tb.ns)[:, None], tb.g[pw],
                              s / torch.sqrt(_dot(s, s) + 1e-20)[:, None])
        n_y = torch.where((_dot(d, outward) < 0.0)[:, None], outward, -outward)
        its = tb.its[pw]
        odd = (torch.floor(y * its[:, None]).long().sum(-1) & 1) != 0
        albedo = torch.where(((its > 0.0) & odd)[:, None], tb.c1[pw], tb.c0[pw])
        ok_y = hit & (tb.kind[pw] == tracer.KINDS[LAMBERTIAN])

        n_recv = n_pix
        if budget.receivers and budget.receivers < n_pix:
            n_recv = budget.receivers
            importance = ct.abs().sum(-1) * ok_y + 1e-30
            p_r = importance / importance.sum()
            pick = _draw(p_r, rng.uniform(seed, torch.arange(n_recv, device=dev), RECEIVER_DRAW))
            y, n_y, albedo, ok_y = y[pick], n_y[pick], albedo[pick], ok_y[pick]
            ct = ct[pick] / (n_recv * p_r[pick])[:, None]

        c, r = sc.sph_center, sc.sph_radius.abs()
        dist = torch.linalg.vector_norm(c[None] - y[:, None], dim=-1)
        outside = dist > r * (1.0 + 1e-4) + 1e-6
        k = budget.sources
        if not k or c.shape[0] <= k:
            sel = torch.arange(c.shape[0], device=dev).expand(n_recv, -1)
            w_src = torch.ones(sel.shape, dtype=dtype, device=dev)
        else:
            imp = (r / torch.clamp(dist, min=1e-6)) ** 2 * outside + 1e-20
            p_src = imp / imp.sum(-1, keepdim=True)
            lanes = torch.arange(n_recv * k, device=dev).reshape(n_recv, k)
            sel = _draw(p_src, rng.uniform(seed, lanes, SPHERE_SOURCE_DRAW))
            w_src = 1.0 / (k * torch.gather(p_src, 1, sel))
        k = sel.shape[1]
        m = budget.samples_per_sphere
        phi = (torch.arange(m, device=dev, dtype=dtype) + 0.5) * (2.0 * math.pi / m)
        z, dz, _ = contour(c[sel], sc.sph_radius[sel], y[:, None, :], phi)  # (R, k, m, 3)
        hint = z - c[sel][:, :, None, :]
        valid = torch.gather(outside, 1, sel)[:, :, None].expand(n_recv, k, m)
        dl = (w_src * (2.0 * math.pi / m))[:, :, None].expand(n_recv, k, m)
        z, dz, hint = (v.reshape(n_recv, k * m, 3) for v in (z, dz, hint))
        valid, dl = valid.reshape(n_recv, k * m), dl.reshape(n_recv, k * m)

        rel = z - y[:, None, :]
        dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
        omega = rel / torch.clamp(dist, min=1e-9)
        dom = (dz - _dot(dz, omega)[..., None] * omega) / torch.clamp(dist, min=1e-9)
        length = torch.linalg.vector_norm(dom, dim=-1)
        n = _unit(torch.linalg.cross(dom / torch.clamp(length, min=1e-12)[..., None], omega,
                                     dim=-1))
        side = _dot(n, hint - _dot(hint, omega)[..., None] * omega)
        n = torch.where((side < 0.0)[..., None], -n, n)
        density = torch.clamp(_dot(omega, n_y[:, None, :]), min=0.0) / math.pi
        ok = (valid & ok_y[:, None] & (density > 0.0) & (length > 1e-9) & (side.abs() > 1e-9)
              & torch.isfinite(omega).all(-1))
        keep = torch.nonzero(ok.reshape(-1)).squeeze(1)
        if keep.numel() == 0:
            return _leaf_grads(sc, leaves, None)
        n_points = ok.numel()
        om, nk = omega.reshape(-1, 3)[keep], n.reshape(-1, 3)[keep]
        origin = y[:, None, :].expand(n_recv, k * m, 3).reshape(-1, 3)[keep]
        bg = torch.tensor(camera["background"], dtype=dtype, device=dev)
        kw = dict(max_depth=max_depth - 1, background=bg,
                  sky_gradient=camera.get("sky_gradient", False))

        def radiance(direction):
            return edge_radiance(tb, origin, direction, seed, keep, n_points,
                                 budget.spp_edge, **kw)

        e = budget.eps_dir
        l_in = radiance(om - e * nk)
        if fault != "no_extrapolation":
            l_in = 2.0 * l_in - radiance(om - 4.0 * e * nk)
        jump = l_in - radiance(om + e * nk)
        recv = keep // (k * m)
        w = (_dot(ct[recv] * albedo[recv], jump) * density.reshape(-1)[keep]
             * length.reshape(-1)[keep] * dl.reshape(-1)[keep])
        w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))

    def total(c_, r_):
        zz, _, _ = contour(c_[sel], r_[sel], y[:, None, :], phi)
        rr = zz.reshape(n_recv, k * m, 3) - y[:, None, :]
        om_t = (rr / torch.clamp(torch.linalg.vector_norm(rr, dim=-1, keepdim=True),
                                 min=1e-9)).reshape(-1, 3)[keep]
        return (w * _dot(om_t, nk)).sum()

    return _leaf_grads(sc, leaves, total)


def edge_terms(sc: tracer.RefScene, leaves, camera: dict, seed: int, cts, *, max_depth: int,
               budget=None, fault=None) -> list:
    """For each image cotangent of `cts`, {"boundary": {leaf: gradient},
    "shadow": {...}} of a step seeded `seed`, at the scene's budgets
    (`budgets`) unless `budget` = (Boundary, Shadow) is given. `fault` plants one of
    FAULTS: a term dropped, the terms seeded one term on, L_in without
    the extrapolation, the boundary step halved, or the shadow term from
    the first half of its receivers, the mean over them ("half_receivers",
    and follow_edges' "half_batch")."""
    if sc.quad_q.shape[0] and set(leaves) & set(QUAD_LEAVES):
        raise NotImplementedError("quad edges and quad-light rims are not in the reference")
    width, height = image_size(camera)
    b, s = budget or budgets(sc.sph_center.shape[0] + sc.quad_q.shape[0], width, height)
    if fault in ("half_receivers", "half_batch"):
        s = s._replace(receivers=min(s.receivers or width * height, width * height) // 2)
    shift = 1 if fault == "seed_shift" else 0
    kw = dict(max_depth=max_depth, fault=fault)
    zeros = {k: torch.zeros_like(getattr(sc, k)) for k in leaves}
    boundary = [zeros] * len(cts) if fault == "no_boundary" else boundary_grads(
        sc, leaves, camera, edge_seed(seed, 0 + shift), cts, budget=b, **kw)
    return [{"boundary": bd, "shadow": zeros if fault == "no_shadow" else shadow_grads(
        sc, leaves, camera, edge_seed(seed, 1 + shift), ct, budget=s, **kw)}
        for bd, ct in zip(boundary, cts)]


def cast(sc: tracer.RefScene, dtype) -> tracer.RefScene:
    """`sc` with its floats in `dtype`."""
    return sc.replace(**{k: v.to(dtype) for k, v in sc.__dict__.items()
                         if v.is_floating_point()})


def follow_edges(sc: tracer.RefScene, camera: dict, target, seeds, *, spp: int, max_depth: int,
                 lr: float, trainable=tracer.TRAINABLE, states=None, cts=None, budget=None,
                 fault=None, edge_dtype=torch.float64) -> dict:
    """train.follow with each step's gradient the interior's
    (train.loss_and_grad, in the scene's dtype) plus both edge terms'
    (`edge_terms`, in `edge_dtype`) at the step's own image cotangent 2
    (image - target) / image.numel(). Returns follow's dict with, per step,
    that cotangent (`cts`) and the edge terms (`terms`): taken again at
    cts[i] (the cotangent of the run being judged) where `cts` is given, so
    that a term can be held against the program's alone. `fault`
    "half_batch" takes the interior's image and gradient from the first
    half of the samples (the edge terms from half the receivers, as
    "half_receivers"); the others are edge_terms'."""
    dtype = sc.sph_center.dtype
    target = target.to(sc.sph_center.device, dtype)
    zero = {k: torch.zeros_like(getattr(sc, k)) for k in trainable}
    state = {"params": {k: getattr(sc, k).detach().clone() for k in trainable},
             "exp_avg": zero, "exp_avg_sq": zero}
    out = {"losses": [], "grads": [], "changes": [], "start": state["params"], "states": [],
           "cts": [], "terms": []}
    spp_in = spp // 2 if fault == "half_batch" else spp
    for i, seed in enumerate(seeds):
        if i and states is not None:
            state = {part: {k: v.detach().to(sc.sph_center.device, dtype)
                            for k, v in states[i - 1][part].items()} for part in state}
        leaves = {k: v.clone().requires_grad_(True) for k, v in state["params"].items()}
        loss, grads = train.loss_and_grad(sc, leaves, camera, target, seed, spp=spp_in,
                                          max_depth=max_depth)
        scene = cast(sc.replace(**state["params"]), edge_dtype)
        img = train.image(sc.replace(**state["params"]), camera, seed, spp=spp_in,
                          max_depth=max_depth)
        ct = 2.0 * (img - target) / float(img.numel())
        kw = dict(max_depth=max_depth, budget=budget, fault=fault)
        terms = edge_terms(scene, trainable, camera, seed, [ct] + ([] if cts is None else [cts[i]]),
                           **kw)
        grads = {k: g + (terms[0]["boundary"][k] + terms[0]["shadow"][k]).to(dtype)
                 for k, g in grads.items()}
        out["losses"].append(loss)
        out["grads"].append({k: g.detach().clone() for k, g in grads.items()})
        out["cts"].append(ct)
        out["terms"].append(terms[-1])
        new = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}}
        with torch.no_grad():
            for k, p in state["params"].items():
                new["params"][k], new["exp_avg"][k], new["exp_avg_sq"][k] = train.adam(
                    p, grads[k], state["exp_avg"][k], state["exp_avg_sq"][k], i + 1, lr)
        out["changes"].append({k: new["params"][k] - p for k, p in state["params"].items()})
        out["states"].append(new)
        state = new
    return out
