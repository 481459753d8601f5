"""A plain PyTorch path tracer of the book scenes: the yardstick that
decides whether the program's images and gradients are correct.

It reads the benchmark's own scene description (benchmark/scenes.py) and
camera entry, works out every table and the camera frame itself, and
traces each sample by its sample id, so any set of samples can be traced
alone: sample `s` of an image of `n` pixels lies on pixel s mod n, and its
random numbers are the counter hash of (seed, s) (rng.py).

The estimator, as the renderer defines it:

* camera: pixel jitter in [-0.5, 0.5)^2, a thin lens from a uniform point
  of the disk (radius sqrt(u), angle 2 pi u'); the direction unnormalised;
* closest hit over every sphere and quad in the scaled space t * |d|^2,
  t > 1e-3, the first minimal candidate winning; a sphere by the expanded
  quadratic (|c|^2 - r^2 folded per sphere), a quad by its plane and the
  in-quad coordinates;
* shading: lambertian (normal + a uniform point of the unit sphere, the
  normal where that is near zero), metal (mirror + fuzz * the same point,
  absorbed below the surface), dielectric (Schlick's reflectance against a
  coin, total internal reflection), diffuse light (emission, no scatter);
  solid and 3D checker textures; a sphere's normal from (p - c) * r, so a
  negative radius turns it inside out;
* radiance: background on a miss (flat or the sky lerp), emission on a
  hit, a throughput product, at most `max_depth` segments; with russian
  roulette, from depth `start` a path survives with q = clip(max
  throughput, lo, hi) and its throughput is multiplied by 1/q.

Every float is computed in `dtype`, so the same code in bfloat16 is the
benchmark's control. Gradients are those of a tape replay: a forward
records each bounce's winner, and a second trace follows those winners
with autograd through the scene's leaves, each winner's t by the textbook
quadratic; a dielectric's coin contributes its likelihood ratio
P(branch) / P(branch) held fixed, whose value is 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from benchmark.reference import rng
from benchmark.scenes import CHECKER, DIELECTRIC, LAMBERTIAN, LIGHT, METAL

KINDS = {LAMBERTIAN: 0, METAL: 1, DIELECTRIC: 2, LIGHT: 3}
T_MIN = 1e-3
QUAD_EPS = 1e-8
NEAR_ZERO = 1e-8
INF = float("inf")
# Candidates (rays x primitives) held at once by the closest-hit search.
CANDIDATE_BLOCK = 1 << 25
# Samples traced at once.
SAMPLE_BLOCK = 1 << 20
TRAINABLE = ("sph_center", "sph_radius", "mat_albedo", "mat_fuzz", "tex_c0")


@dataclass
class RefScene:
    """Scene leaves as tensors on one device, floats in one dtype."""

    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    quad_q: torch.Tensor
    quad_u: torch.Tensor
    quad_v: torch.Tensor
    quad_mat: torch.Tensor
    mat_kind: torch.Tensor
    mat_albedo: torch.Tensor
    mat_fuzz: torch.Tensor
    mat_ior: torch.Tensor
    mat_tex: torch.Tensor
    tex_checker: torch.Tensor
    tex_c0: torch.Tensor
    tex_c1: torch.Tensor
    tex_scale: torch.Tensor

    def replace(self, **fields) -> "RefScene":
        return RefScene(**{**self.__dict__, **fields})


def scene_from_description(desc, device, dtype=torch.float32) -> RefScene:
    def fl(rows, width=None):
        t = torch.tensor(rows, dtype=torch.float32, device=device)
        return (t.reshape(-1, width) if width else t.reshape(-1)).to(dtype)

    def ix(rows):
        return torch.tensor(rows, dtype=torch.int64, device=device).reshape(-1)

    s, q, m, x = desc.spheres, desc.quads, desc.materials, desc.textures
    return RefScene(
        sph_center=fl([r[0] for r in s], 3), sph_radius=fl([r[1] for r in s]),
        sph_mat=ix([r[2] for r in s]),
        quad_q=fl([r[0] for r in q], 3), quad_u=fl([r[1] for r in q], 3),
        quad_v=fl([r[2] for r in q], 3), quad_mat=ix([r[3] for r in q]),
        mat_kind=ix([KINDS[r[0]] for r in m]), mat_albedo=fl([r[1] for r in m], 3),
        mat_fuzz=fl([r[2] for r in m]), mat_ior=fl([r[3] for r in m]),
        mat_tex=ix([r[4] for r in m]),
        tex_checker=torch.tensor([r[0] == CHECKER for r in x], device=device),
        tex_c0=fl([r[1] for r in x], 3), tex_c1=fl([r[2] for r in x], 3),
        tex_scale=fl([r[3] for r in x]),
    )


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


@dataclass
class Tables:
    """What the renderer derives from a scene: closest-hit tables and one
    shading row per primitive (spheres, then quads)."""

    sph: torch.Tensor  # (S, 4) centre, |c|^2 - r^2
    quad: torch.Tensor  # (Q, 12) normal, n.Q, alpha basis, beta basis, Q.av, Q.bv
    g: torch.Tensor  # (P, 3) sphere centre | quad unit normal
    g3: torch.Tensor  # (P,) sphere radius | 0
    kind: torch.Tensor  # (P,) material kind
    prm: torch.Tensor  # (P,) metal fuzz | ior
    c0: torch.Tensor  # (P, 3) metal albedo | texture colour | checker even
    c1: torch.Tensor  # (P, 3) checker odd
    its: torch.Tensor  # (P,) 1 / checker scale, 0 for a solid colour
    ns: int


def tables(sc: RefScene) -> Tables:
    """Tables of `sc`, differentiable in its float leaves."""
    c, r = sc.sph_center, sc.sph_radius
    c2r2 = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]) - r * r
    n_raw = _cross(sc.quad_u, sc.quad_v)
    nn = (n_raw * n_raw).sum(-1)
    nn = torch.where(nn > 0, nn, torch.ones_like(nn))
    w = n_raw / nn[:, None]
    normal = n_raw / torch.sqrt(nn)[:, None]
    av, bv = _cross(sc.quad_v, w), _cross(w, sc.quad_u)
    quad = torch.cat([normal, (normal * sc.quad_q).sum(-1)[:, None], av, bv,
                      (sc.quad_q * av).sum(-1)[:, None], (sc.quad_q * bv).sum(-1)[:, None]], 1)
    mat = torch.cat([sc.sph_mat, sc.quad_mat])
    kind, tex = sc.mat_kind[mat], sc.mat_tex[mat]
    metal = kind == KINDS[METAL]
    scale = sc.tex_scale[tex]
    checker = sc.tex_checker[tex] & ~metal
    safe = torch.where(scale != 0.0, scale, torch.ones_like(scale))
    return Tables(
        sph=torch.cat([c, c2r2[:, None]], 1), quad=quad,
        g=torch.cat([c, normal]), g3=torch.cat([r, torch.zeros_like(nn)]), kind=kind,
        prm=torch.where(metal, sc.mat_fuzz[mat], sc.mat_ior[mat]),
        c0=torch.where(metal[:, None], sc.mat_albedo[mat], sc.tex_c0[tex]),
        c1=sc.tex_c1[tex], its=torch.where(checker, 1.0 / safe, torch.zeros_like(scale)),
        ns=c.shape[0],
    )


@torch.no_grad()
def closest_hit(tb: Tables, o, d):
    """(t (N,), +inf on a miss; prim (N,) int64, -1 on a miss), no autograd."""
    n, p = o.shape[0], tb.sph.shape[0] + tb.quad.shape[0]
    t_out = torch.empty(n, dtype=o.dtype, device=o.device)
    p_out = torch.empty(n, dtype=torch.int64, device=o.device)
    step = max(1, CANDIDATE_BLOCK // max(p, 1))
    for s in range(0, n, step):
        ob, db = o[s:s + step], d[s:s + step]
        ox, oy, oz = (ob[:, k:k + 1] for k in range(3))
        dx, dy, dz = (db[:, k:k + 1] for k in range(3))
        a = dx * dx + dy * dy + dz * dz
        tmin = T_MIN * a
        cands = []
        if tb.sph.shape[0]:
            cx, cy, cz, c2r2 = tb.sph.unbind(1)
            half_b = (dx * ox + dy * oy + dz * oz) - (dx * cx + dy * cy + dz * cz)
            cc = (ox * ox + oy * oy + oz * oz) - 2.0 * (ox * cx + oy * cy + oz * cz) + c2r2
            sq = torch.sqrt(half_b * half_b - a * cc)
            t0, t1 = -half_b - sq, -half_b + sq
            cands.append(torch.where(t0 > tmin, t0, torch.where(t1 > tmin, t1, INF)))
        if tb.quad.shape[0]:
            nx, ny, nz, dpl, avx, avy, avz, bvx, bvy, bvz, qav, qbv = tb.quad.unbind(1)
            d_n = dx * nx + dy * ny + dz * nz
            ok = d_n.abs() >= QUAD_EPS
            t = (dpl - (ox * nx + oy * ny + oz * nz)) / torch.where(ok, d_n, 1.0)
            al = (ox * avx + oy * avy + oz * avz) + t * (dx * avx + dy * avy + dz * avz) - qav
            be = (ox * bvx + oy * bvy + oz * bvz) + t * (dx * bvx + dy * bvy + dz * bvz) - qbv
            ok = ok & (t > T_MIN) & (al >= 0.0) & (al <= 1.0) & (be >= 0.0) & (be <= 1.0)
            cands.append(torch.where(ok, t * a, INF))
        best, idx = torch.cat(cands, 1).min(dim=1)
        t_out[s:s + step] = best * (1.0 / a[:, 0])
        p_out[s:s + step] = torch.where(best < INF, idx, -1)
    return t_out, p_out


def winner_t(tb: Tables, sc: RefScene, o, d, prim):
    """The textbook t of each ray's winner `prim` (>= 0), differentiable."""
    ns = tb.ns
    is_quad = prim >= ns
    si = torch.clamp(prim, max=max(ns - 1, 0))
    oc = o - sc.sph_center[si] if ns else o
    a = _dot(d, d)
    r = sc.sph_radius[si] if ns else torch.zeros_like(a)
    half_b = _dot(d, oc)
    disc = half_b * half_b - a * (_dot(oc, oc) - r * r)
    ok = disc > 0.0
    sq = torch.where(ok, torch.sqrt(torch.where(ok, disc, torch.ones_like(disc))), 0.0)
    t0, t1 = (-half_b - sq) / a, (-half_b + sq) / a
    t_s = torch.where(t0 > T_MIN, t0, t1)
    if not tb.quad.shape[0]:
        return t_s
    row = tb.quad[torch.clamp(prim - ns, min=0)]
    d_n = _dot(d, row[:, 0:3])
    t_q = (row[:, 3] - _dot(o, row[:, 0:3])) / torch.where(d_n.abs() >= QUAD_EPS, d_n, 1.0)
    return torch.where(is_quad, t_q, t_s)


def shade(tb: Tables, t, prim, o, d, u):
    """(point, scattered direction, attenuation, scatters, emission) of hit
    lanes from their winners and shading uniforms u (N, 3)."""
    point = o + t[:, None] * d
    is_quad = prim >= tb.ns
    s = (point - tb.g[prim]) * tb.g3[prim][:, None]
    s_unit = s / torch.sqrt(_dot(s, s) + 1e-20)[:, None]
    outward = torch.where(is_quad[:, None], tb.g[prim], s_unit)
    front = _dot(d, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)

    its = tb.its[prim]
    cell = torch.floor(point * its[:, None]).to(torch.int32)
    odd = ((cell[:, 0] + cell[:, 1] + cell[:, 2]) & 1) != 0
    color = torch.where(((its > 0.0) & odd)[:, None], tb.c1[prim], tb.c0[prim])
    kind = tb.kind[prim]
    emitted = torch.where((kind == KINDS[LIGHT])[:, None], color, torch.zeros_like(color))

    z = 1.0 - 2.0 * u[:, 0]
    phi = (2.0 * math.pi) * u[:, 1]
    rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    ball = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], 1)
    ud = d * (1.0 / torch.sqrt(_dot(d, d)))[:, None]

    lamb = normal + ball
    lamb = torch.where((lamb.abs() < NEAR_ZERO).all(1)[:, None], normal, lamb)
    cos_in = _dot(ud, normal)
    refl = ud - (2.0 * cos_in)[:, None] * normal
    prm = tb.prm[prim]
    metal = refl + prm[:, None] * ball
    metal_ok = _dot(metal, normal) > 0.0

    diel = kind == KINDS[DIELECTRIC]
    ior = torch.where(diel, prm, torch.ones_like(prm))
    eta = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(-cos_in, max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12, max=1.0))
    cannot = sin_t * eta > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    om = 1.0 - cos_t
    reflect_p = r0 + (1.0 - r0) * (om * om) * (om * om) * om
    use_reflect = cannot | (reflect_p > u[:, 2])
    perp = eta[:, None] * (ud + cos_t[:, None] * normal)
    par = -torch.sqrt(torch.clamp((1.0 - _dot(perp, perp)).abs(), min=1e-12))
    refr = perp + par[:, None] * normal
    pc = torch.clamp(reflect_p, 1e-4, 1.0 - 1e-4)
    p_branch = torch.where(use_reflect, pc, 1.0 - pc)
    ratio = torch.where(cannot, 1.0, p_branch / p_branch.detach())[:, None].expand_as(color)

    is_lamb, is_metal = kind == KINDS[LAMBERTIAN], kind == KINDS[METAL]
    direction = torch.where(is_lamb[:, None], lamb, torch.where(
        is_metal[:, None], metal, torch.where(use_reflect[:, None], refl, refr)))
    attenuation = torch.where((is_lamb | is_metal)[:, None], color,
                              torch.where(diel[:, None], ratio, torch.zeros_like(color)))
    scatters = (is_metal & metal_ok) | is_lamb | diel
    return point, direction, attenuation, scatters, emitted


def sky(d):
    """White to (0.5, 0.7, 1) on the unit direction's y."""
    sa = 0.5 * (d[:, 1] * (1.0 / torch.sqrt(_dot(d, d))) + 1.0)
    return torch.stack([(1.0 - sa) + sa * 0.5, (1.0 - sa) + sa * 0.7, torch.ones_like(sa)], 1)


@dataclass
class Frame:
    center: torch.Tensor
    pixel00: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    disk_u: torch.Tensor
    disk_v: torch.Tensor
    lens: bool

    def to(self, device, dtype) -> "Frame":
        kw = {k: v.to(device=device, dtype=dtype) for k, v in self.__dict__.items()
              if isinstance(v, torch.Tensor)}
        return Frame(**kw, lens=self.lens)


def camera_frame(camera: dict, width: int) -> Frame:
    """The thin-lens frame of a camera entry, in float32 on the host."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    unit = lambda x: x / torch.sqrt((x * x).sum(-1))  # noqa: E731
    look_from, look_at = f(camera["look_from"]), f(camera["look_at"])
    w = unit(look_from - look_at)
    u = unit(_cross(f(camera["vup"]), w))
    v = _cross(w, u)
    focus = f(camera["focus_dist"])
    view_h = 2.0 * torch.tan(f(math.radians(camera["fov_degrees"])) / 2.0) * focus
    float_h = torch.clamp(float(width) / f(camera["aspect"]), min=1.0)
    view_u = u * (view_h * (float(width) / float_h))
    view_v = -v * view_h
    du, dv = view_u / float(width), view_v / float_h
    upper_left = look_from - focus * w - 0.5 * view_u - 0.5 * view_v
    angle = f(math.radians(camera["defocus_angle_degrees"]))
    radius = focus * torch.tan(angle / 2.0)
    return Frame(center=look_from, pixel00=upper_left + 0.5 * (du + dv), du=du, dv=dv,
                 disk_u=u * radius, disk_v=v * radius, lens=float(angle) > 0.0)


def camera_rays(fr: Frame, seed: int, samples, width: int, n_pixels: int, dtype):
    """(origin, direction) of each sample id's camera ray."""
    pix = samples % n_pixels
    u = rng.uniform(seed, samples[:, None],
                    torch.arange(rng.CAMERA_DRAWS, device=samples.device)).to(dtype)
    px, py = (pix % width).to(dtype), (pix // width).to(dtype)
    target = (fr.pixel00 + (px + (u[:, 0] - 0.5))[:, None] * fr.du
              + (py + (u[:, 1] - 0.5))[:, None] * fr.dv)
    r, phi = torch.sqrt(u[:, 2]), (2.0 * math.pi) * u[:, 3]
    lens = fr.center + (r * torch.cos(phi))[:, None] * fr.disk_u + (r * torch.sin(phi))[
        :, None] * fr.disk_v
    origin = lens if fr.lens else fr.center.expand_as(lens)
    return origin, target - origin


def trace(sc: RefScene, fr: Frame, seed: int, samples, *, width: int, n_pixels: int,
          max_depth: int, background, sky_gradient: bool, roulette=None, tape=None,
          record: bool = False):
    """Radiance (N, 3), segments (N,) and, with `record`, the winners'
    tape (max_depth, N), -1 for a miss or a finished path, of the given
    sample ids. `roulette` = (start, lo, hi) or None; `background` a (3,)
    tensor. With a `tape`, each bounce's winners are the tape's, their t
    the textbook quadratic's, differentiable in the scene's leaves: the
    replay of a recorded forward."""
    dtype, dev = sc.sph_center.dtype, samples.device
    tb = tables(sc)
    o, d = camera_rays(fr, seed, samples, width, n_pixels, dtype)
    n = samples.shape[0]
    rad = torch.zeros(n, 3, dtype=dtype, device=dev)
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    tp = torch.ones(n, 3, dtype=dtype, device=dev)
    lanes = torch.arange(n, device=dev)
    out_tape = torch.full((max_depth, n), -1, dtype=torch.int64, device=dev) if record else None
    j3 = torch.arange(rng.SHADING_DRAWS, device=dev)
    for bounce in range(max_depth):
        if lanes.numel() == 0:
            break
        segs[lanes] += 1
        sid = samples[lanes]
        if tape is None:
            t, prim = closest_hit(tb, o, d)
            pw = torch.clamp(prim, min=0)
        else:
            prim = tape[bounce, lanes]
            pw = torch.clamp(prim, min=0)
            t = winner_t(tb, sc, o, d, pw)
        hit = prim >= 0
        if record:
            out_tape[bounce, lanes] = prim
        t = torch.where(hit, t, torch.zeros_like(t))
        u = rng.uniform(seed, sid[:, None], rng.shading_ctr(bounce, j3)).to(dtype)
        point, new_d, att, scatters, emitted = shade(tb, t, pw, o, d, u)
        bg = sky(d) if sky_gradient else background.to(dtype).expand_as(d)
        rad = rad.index_add(0, lanes, torch.where(hit[:, None], tp * emitted, tp * bg))
        alive = hit & scatters & (bounce + 1 < max_depth)
        tp_next = torch.where(alive[:, None], tp * att, tp)
        if roulette is not None and bounce + 1 >= roulette[0]:
            q = torch.clamp(tp_next.max(dim=1).values, min=roulette[1], max=roulette[2])
            coin = rng.uniform(seed, sid, rng.roulette_ctr(bounce, max_depth)).to(dtype)
            alive = alive & (coin < q)
            tp_next = torch.where(alive[:, None], tp_next * (1.0 / q)[:, None], tp_next)
        lanes, o, d, tp = lanes[alive], point[alive], new_d[alive], tp_next[alive]
    return (rad, segs, out_tape) if record else (rad, segs)


def render_pixels(desc, camera: dict, seed: int, pixels, *, spp: int, max_depth: int,
                  roulette, device, dtype=torch.float32):
    """(mean radiance (P, 3) float32, segments) of `pixels` (P,) of an
    image rendered at `spp` under `seed`: pixel p's samples are the ids
    p + j * n_pixels, j < spp, all in one stream of sample ids."""
    from benchmark.scenes import image_size

    width, height = image_size(camera)
    n_pix = width * height
    sc = scene_from_description(desc, device, dtype)
    fr = camera_frame(camera, width).to(device, dtype)
    bg = torch.tensor(camera["background"], dtype=torch.float32, device=device)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    out = torch.zeros(pixels.shape[0], 3, dtype=torch.float32, device=device)
    segments = 0
    per_block = max(1, SAMPLE_BLOCK // spp)
    for s in range(0, pixels.shape[0], per_block):
        pb = pixels[s:s + per_block]
        ids = (pb[:, None] + torch.arange(spp, device=device)[None, :] * n_pix).reshape(-1)
        rad, segs = trace(sc, fr, seed, ids, width=width, n_pixels=n_pix, max_depth=max_depth,
                          background=bg, sky_gradient=camera.get("sky_gradient", False),
                          roulette=roulette)
        out[s:s + per_block] = rad.float().reshape(-1, spp, 3).sum(1) / float(spp)
        segments += int(segs.sum())
    return out, segments
