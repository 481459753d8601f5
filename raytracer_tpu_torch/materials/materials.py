"""Material shading from the winning (t, prim): emission + scatter.

Port of raytracer_tpu/materials/materials.py:resolve_and_shade with the
persistent kernel's arithmetic (ops/persistent_kernel.py:640-962, and
csrc/persistent_kernel.cu, which equals this function): the unit ray
direction is d / sqrt(|d|^2). Solid and checker textures come from the row
table; noise and image textures from the texture table when one is given.
The sphere normal is normalize((p - c) * r), the hollow-glass sign
riding on r, as in the JAX package's resolve_and_shade; the TPU kernel skips
that normalization, and its normal's length is then off by the hit point's
radial float32 error (~5e-4 on rand_spheres' r = 0.2 spheres).

Random decisions take explicit uniforms (N, UNIFORMS_PER_BOUNCE):
[unit-sphere u0, u1, dielectric reflect-vs-refract coin].

Every branch is evaluated for every lane and the lane's own is selected, so
each branch takes inputs that are safe on the lanes it does not own: the
metal fuzz shares the ior column (a fuzz-0 mirror would make the dielectric
branch's 1/ior infinite, and autograd would multiply that branch's zero
cotangent by an infinite partial, writing NaN into scene gradients). The
forward values of every selected lane are those of the kernel, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.core.sampling import unit_sphere_from_uniform
from raytracer_tpu_torch.geometry.scene import DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN, METAL
from raytracer_tpu_torch.materials import packed as pk
from raytracer_tpu_torch.materials.textures import eval_texture_extra, eval_texture_rows
from raytracer_tpu_torch.ops.gather_kernel import gather_rows

# U[0,1) uniforms consumed per lane per bounce: 2 for the unit-sphere sample
# (Lambertian direction / metal fuzz), 1 for the dielectric coin.
UNIFORMS_PER_BOUNCE = 3

NEAR_ZERO = 1e-8


class BounceResult(NamedTuple):
    """Everything the wavefront loop needs from one bounce."""

    hit: torch.Tensor  # (N,) bool
    point: torch.Tensor  # (N, 3)
    direction: torch.Tensor  # (N, 3) scattered direction
    attenuation: torch.Tensor  # (N, 3)
    scattered: torch.Tensor  # (N,) bool
    emitted: torch.Tensor  # (N, 3)


def _sel(mask, a, b):
    return torch.where(mask[:, None], a, b)


def _dielectric_lr(reflect_prob, use_reflect, cannot_refract):
    """Likelihood-ratio factor of the reflect/refract coin, (N, 1):
    P(branch) / detached P(branch), exactly 1 in the forward pass, whose
    gradient carries d log P / d ior (straight-through alone misses it).
    Total internal reflection is certain, so its factor is the constant 1."""
    p = torch.clamp(reflect_prob, 1e-4, 1.0 - 1e-4)
    p_branch = torch.where(use_reflect, p, 1.0 - p)
    return torch.where(cannot_refract, 1.0, p_branch / p_branch.detach())[:, None]


def resolve_and_shade(
    table, num_spheres: int, t, prim, origin, ray_dir, uniforms, textures=None,
    tap_uniforms=None,
) -> BounceResult:
    """Hit epilogue + shading from the winner (t (N,), +inf on a miss; prim
    (N,) int). `table` is materials.packed.primitive_table(scene, qd) and
    `num_spheres` its sphere row count (quad rows follow); `textures` is
    materials.packed.texture_tables(scene, qd), None for scenes without
    noise or image textures; `tap_uniforms` (N, 2) the stochastic bilinear
    tap's draws when its filter is FILTER_STOCHASTIC. Miss lanes return
    finite garbage that callers mask with `hit`. The winners' rows of
    `table` are read by ops/gather_kernel.py:gather_rows."""
    hit = torch.isfinite(t)
    t = torch.where(hit, t, torch.zeros_like(t))
    prim = torch.where(hit, prim, torch.zeros_like(prim)).long()
    row = gather_rows(table, prim)  # (N, N_COLS): the one indexed read
    g = row[:, pk.COL_G]
    g3 = row[:, pk.COL_G3]
    mtype = row[:, pk.COL_MTYPE].to(torch.int32)
    prm = row[:, pk.COL_PRM]

    point = origin + t[:, None] * ray_dir
    is_quad = prim >= num_spheres
    s = (point - g) * g3[:, None]
    s_len = torch.sqrt(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1] + s[:, 2] * s[:, 2] + 1e-20)
    s_unit = s / s_len[:, None]
    outward = _sel(is_quad, g, s_unit)
    d = ray_dir
    d_dot_n = d[:, 0] * outward[:, 0] + d[:, 1] * outward[:, 1] + d[:, 2] * outward[:, 2]
    front = d_dot_n < 0.0
    normal = outward * torch.where(front, 1.0, -1.0)[:, None]
    nx, ny, nz = normal.unbind(1)

    tex = eval_texture_rows(row[:, pk.COL_ITS], row[:, pk.COL_C0], row[:, pk.COL_C1], point)
    if textures is not None:
        tex = eval_texture_extra(textures, textures.rows[prim], is_quad, s_unit, point, tex,
                                 tap_uniforms)
    is_light = mtype == DIFFUSE_LIGHT
    emitted = _sel(is_light, tex, torch.zeros_like(tex))

    ss = unit_sphere_from_uniform(uniforms[:, 0:2])

    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    ud = d * (1.0 / torch.sqrt(a))[:, None]
    udx, udy, udz = ud.unbind(1)

    # Lambertian + near-zero guard.
    lamb = normal + ss
    lamb = _sel((lamb.abs() < NEAR_ZERO).all(1), normal, lamb)

    is_lamb = mtype == LAMBERTIAN
    is_metal = mtype == METAL
    is_diel = mtype == DIELECTRIC

    # Metal.
    ud_n = udx * nx + udy * ny + udz * nz
    refl = ud - (2.0 * ud_n)[:, None] * normal
    metal = refl + prm[:, None] * ss
    metal_ok = (metal[:, 0] * nx + metal[:, 1] * ny + metal[:, 2] * nz) > 0.0

    # Dielectric (ior 1 on the lanes of other materials: see the docstring).
    ior = torch.where(is_diel, prm, torch.ones_like(prm))
    eta = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12, max=1.0))
    cannot = sin_t * eta > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    om = 1.0 - cos_t
    om2 = om * om
    reflect_p = r0 + (1.0 - r0) * om2 * om2 * om
    use_reflect = cannot | (reflect_p > uniforms[:, 2])
    perp = eta[:, None] * (ud + cos_t[:, None] * normal)
    plen = perp[:, 0] * perp[:, 0] + perp[:, 1] * perp[:, 1] + perp[:, 2] * perp[:, 2]
    par = -torch.sqrt(torch.clamp((1.0 - plen).abs(), min=1e-12))
    refr = perp + par[:, None] * normal
    diel = _sel(use_reflect, refl, refr)
    diel_lr = _dielectric_lr(reflect_p, use_reflect, cannot).expand_as(tex)

    direction = _sel(is_lamb, lamb, _sel(is_metal, metal, diel))
    attenuation = _sel(is_lamb | is_metal, tex, _sel(is_diel, diel_lr, torch.zeros_like(tex)))
    scattered = (is_metal & metal_ok) | is_lamb | is_diel
    return BounceResult(
        hit=hit,
        point=point,
        direction=direction,
        attenuation=attenuation,
        scattered=scattered,
        emitted=emitted,
    )
