"""Texture evaluation: solid, 3D checker, Perlin marble and image textures
with nearest-neighbour, 4-tap bilinear or stochastic single-tap bilinear
filtering (port of raytracer_tpu/materials/textures.py, and of the
stochastic tap of raytracer_tpu/ops/persistent_kernel.py:732-765).

Solid and checker colors come from the (P, 16) row table
(`eval_texture_rows`, the persistent kernel's rule). Noise and image
textures read a second per-primitive table (materials/packed.py:
texture_tables) and are evaluated only for scenes that have them
(`eval_texture_extra`), so solid/checker lanes keep their bits.

The procedural Perlin hash is uint32 arithmetic; torch has no uint32
multiply, so the words live in int64 tensors masked to 32 bits, as in
ops/ctr_rng.py. `perm_u8` and `grad_component` are the torch twins of
materials/perlin_hash.py (whose NumPy copy builds the tables).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.geometry.intersect import quad_uv, sphere_uv
from raytracer_tpu_torch.geometry.scene import TEX_IMAGE, TEX_NOISE
from raytracer_tpu_torch.materials import packed as pk
from raytracer_tpu_torch.materials import perlin_hash as ph

TURBULENCE_OCTAVES = 7


def eval_texture_rows(its, c0, c1, point):
    """Per-lane color from packed row fields: `its` (N,) = 1/checker scale
    (0 = solid), c0/c1 (N, 3), hit points (N, 3). Checker parity is the sum
    of floor(point * its) over the three axes; odd selects c1."""
    ipt = torch.floor(point * its[:, None]).to(torch.int32)
    odd = ((ipt[:, 0] + ipt[:, 1] + ipt[:, 2]) & 1) != 0
    use_c1 = (its > 0.0) & odd
    return torch.where(use_c1[:, None], c1, c0)


def perm_u8(axis: int, x):
    """Torch twin of perlin_hash.perm_u8: x int64 in [0, 256) -> [0, 256)."""
    h = (x * ph._AXIS_MUL1[axis] + ph._AXIS_ADD[axis]) & 255
    h = h ^ (h >> 4)
    h = (h * ph._AXIS_MUL2[axis]) & 255
    return h ^ (h >> 4)


def _mix32(u):
    from raytracer_tpu_torch.ops.ctr_rng import MASK32, _mul32  # ctr_rng imports materials

    u = (u ^ 61) ^ (u >> 16)
    u = (u * 9) & MASK32
    u = u ^ (u >> 4)
    u = _mul32(u, 0x27D4EB2D)
    return u ^ (u >> 15)


def grad_component(k: int, h):
    """Torch twin of perlin_hash.grad_component: component k of gradient
    vector h (int64 in [0, 256)) as float32 in [-1, 1)."""
    mask = 0xFFFFFFFF
    u = _mix32(((h + (((k + 1) * 0x9E3779B9) & mask)) & mask) ^ ph._GRAD_SEED[k])
    return (u & 0xFFFFFF).to(torch.float32) * (2.0**-23) - 1.0


def _smoothstep(t):
    return t * t * (3.0 - 2.0 * t)


def c_lerp(t, a, b):
    return a * (1.0 - t) + b * t


def perlin_noise(p, perlin=None):
    """Gradient noise at points p (N, 3) (materials.go:222-249). `perlin`
    is None for the procedural hash tables (scene.perlin_procedural), else
    the scene's (vec (256, 3), px, py, pz) tables, gathered."""
    pf = torch.floor(p)
    t = p - pf
    i0 = pf.to(torch.int32).to(torch.int64) & 255
    i1 = (i0 + 1) & 255
    if perlin is None:
        pxs = (perm_u8(0, i0[:, 0]), perm_u8(0, i1[:, 0]))
        pys = (perm_u8(1, i0[:, 1]), perm_u8(1, i1[:, 1]))
        pzs = (perm_u8(2, i0[:, 2]), perm_u8(2, i1[:, 2]))

        def gradient(h):
            return tuple(grad_component(k, h) for k in range(3))

    else:
        vec, tpx, tpy, tpz = perlin
        pxs = (tpx[i0[:, 0]], tpx[i1[:, 0]])
        pys = (tpy[i0[:, 1]], tpy[i1[:, 1]])
        pzs = (tpz[i0[:, 2]], tpz[i1[:, 2]])

        def gradient(h):
            g = vec[h.long()]
            return g[:, 0], g[:, 1], g[:, 2]

    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    fx, fy, fz = _smoothstep(tx), _smoothstep(ty), _smoothstep(tz)

    def corner(ix, iy, iz):
        gx, gy, gz = gradient(pxs[ix] ^ pys[iy] ^ pzs[iz])
        return gx * (tx - ix) + gy * (ty - iy) + gz * (tz - iz)

    c00 = c_lerp(fx, corner(0, 0, 0), corner(1, 0, 0))
    c10 = c_lerp(fx, corner(0, 1, 0), corner(1, 1, 0))
    c01 = c_lerp(fx, corner(0, 0, 1), corner(1, 0, 1))
    c11 = c_lerp(fx, corner(0, 1, 1), corner(1, 1, 1))
    return c_lerp(fz, c_lerp(fy, c00, c10), c_lerp(fy, c01, c11))


def perlin_turbulence(p, perlin=None, depth: int = TURBULENCE_OCTAVES):
    """|sum of `depth` halving octaves| (materials.go:251-262)."""
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    for _ in range(depth):
        total = total + weight * perlin_noise(p, perlin)
        weight *= 0.5
        p = p * 2.0
    return torch.abs(total)


def marble(point, scale, perlin=None):
    """Marble value 0.5 * (1 + sin(sp_z + 10 * turb(sp))) with sp = point *
    scale (materials.go:285-288); (N,)."""
    sp = point * scale[:, None]
    return 0.5 * (1.0 + torch.sin(sp[:, 2] + 10.0 * perlin_turbulence(sp, perlin)))


def image_lookup(images, image_dims, img_id, u, v):
    """Nearest-neighbour texel (materials.go:176-193): clamp u, flip v,
    truncate to texel indices, clamp the indices into the image's true
    (H, W). img_id (N,) int64; returns (N, 3)."""
    dims = image_dims[img_id]
    h = dims[:, 0].to(torch.float32)
    w = dims[:, 1].to(torch.float32)
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    return _texel(images, dims, img_id, (uu * w).to(torch.int32), (vv * h).to(torch.int32))


def _bilinear_coords(image_dims, img_id, u, v):
    """(x, y, dims): continuous texel coordinates (u*w - 0.5, v*h - 0.5)
    after clamping u and flipping v, and the images' true (H, W)."""
    dims = image_dims[img_id]
    h = dims[:, 0].to(torch.float32)
    w = dims[:, 1].to(torch.float32)
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    return uu * w - 0.5, vv * h - 0.5, dims


def _texel(images, dims, img_id, xi, yi):
    """Texels at integer coordinates clamped into each image's true dims."""
    zero = torch.zeros_like(dims[:, 0])
    i = torch.minimum(torch.maximum(xi, zero), dims[:, 1] - 1)
    j = torch.minimum(torch.maximum(yi, zero), dims[:, 0] - 1)
    return images[img_id, j.long(), i.long()]


def image_lookup_bilinear(images, image_dims, img_id, u, v):
    """4-tap bilinear lookup (raytracer_tpu/materials/textures.py:
    _image_lookup_bilinear): taps around (u*w - 0.5, v*h - 0.5), each
    clamped into the true dims, blended along x, then y; (N, 3)."""
    x, y, dims = _bilinear_coords(image_dims, img_id, u, v)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def at(xf, yf):
        return _texel(images, dims, img_id, xf.to(torch.int32), yf.to(torch.int32))

    top = at(x0, y0) * (1.0 - fx) + at(x0 + 1.0, y0) * fx
    bot = at(x0, y0 + 1.0) * (1.0 - fx) + at(x0 + 1.0, y0 + 1.0) * fx
    return top * (1.0 - fy) + bot * fy


def image_tap_stochastic(images, image_dims, img_id, u, v, tap_uniforms):
    """One of the 4 bilinear taps, drawn with its bilinear weight: the +1
    column when tap_uniforms[:, 0] < fx, the +1 row when tap_uniforms[:, 1]
    < fy (raytracer_tpu/ops/persistent_kernel.py:748-765, whose uniforms
    came from the TPU's hardware PRNG; here they are the counter RNG's
    ops/ctr_rng.py:tap_ctr draws). Its mean is image_lookup_bilinear."""
    x, y, dims = _bilinear_coords(image_dims, img_id, u, v)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi = x0.to(torch.int32) + (tap_uniforms[:, 0] < x - x0).to(torch.int32)
    yi = y0.to(torch.int32) + (tap_uniforms[:, 1] < y - y0).to(torch.int32)
    return _texel(images, dims, img_id, xi, yi)


def eval_texture_extra(textures, trow, is_quad, s_unit, point, color, tap_uniforms=None):
    """Noise and image colors over `color` (the solid/checker result) for
    lanes whose texture is of those kinds. `textures` is a
    materials.packed.TextureTables (its `image_filter` picks the filter),
    `trow` the winners' (N, TEX_COLS) rows, `s_unit` the sphere lanes'
    outward unit normal (N, 3), `tap_uniforms` (N, 2) the stochastic tap's
    draws (needed by FILTER_STOCHASTIC only)."""
    ttype = trow[:, pk.TCOL_TYPE].to(torch.int32)
    if textures.has_image:
        su, sv = sphere_uv(s_unit)
        qu, qv = quad_uv(point, trow[:, pk.TCOL_AV], trow[:, pk.TCOL_QAV],
                         trow[:, pk.TCOL_BV], trow[:, pk.TCOL_QBV])
        u = torch.where(is_quad, qu, su)
        v = torch.where(is_quad, qv, sv)
        img_id = trow[:, pk.TCOL_IMAGE].to(torch.int64)
        args = (textures.images, textures.image_dims, img_id, u, v)
        if textures.image_filter == pk.FILTER_NEAREST:
            img = image_lookup(*args)
        elif textures.image_filter == pk.FILTER_BILINEAR:
            img = image_lookup_bilinear(*args)
        elif tap_uniforms is None:
            raise ValueError("the stochastic bilinear filter needs its tap uniforms")
        else:
            img = image_tap_stochastic(*args, tap_uniforms)
        color = torch.where((ttype == TEX_IMAGE)[:, None], img, color)
    if textures.has_noise:
        val = marble(point, trow[:, pk.TCOL_SCALE], textures.perlin)
        color = torch.where((ttype == TEX_NOISE)[:, None], val[:, None].expand_as(color), color)
    return color
