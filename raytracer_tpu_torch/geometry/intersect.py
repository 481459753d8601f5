"""Ray-scene intersection (port of raytracer_tpu/geometry/intersect.py).

`closest_hit_t_prim` is the plain closest-hit search the CUDA kernel of
ops/intersect_kernel.py implements (scaled-t compare space, strict t > 1e-3,
spheres before quads); `intersect_scene` adds the hit epilogue and routes the
search through that kernel's wrapper, so CUDA tensors run the kernel.

`intersect_scene_kernel_diff` is the differentiable closest hit: the kernel
finds the winner on detached rays and tables (no gradient ever reaches it),
and `winner_t_diff` recomputes the winner's t with autograd from the scene
tensors. The winner itself is held constant, which is correct almost
everywhere; visibility-boundary terms are the edge estimators' job.

`sphere_uv` and `quad_uv` are the surface coordinates image textures read.
`LargeSceneTables` holds the JAX large-scene path's tables (the dense
tables and the TPU kernel 4's flat cluster table), which the tests hold
against JAX; the port's large-scene path
(render/driver.py:large_scene_block) walks the render's own cluster
table instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracer_tpu_torch.core import vecmath as vm
from raytracer_tpu_torch.geometry.scene import Scene
from raytracer_tpu_torch.ops import culled_kernel as ck
from raytracer_tpu_torch.ops import intersect_kernel as ik
from raytracer_tpu_torch.ops.gather_kernel import gather_rows

DEFAULT_T_MIN = ik.T_MIN
# The reference adds 5*pi/12 to the sphere's phi "to make the earth texture
# line up" (hittables.go:124-125); kept for parity.
SPHERE_UV_PHI_OFFSET = 5.0 * math.pi / 12.0


class HitRecord(NamedTuple):
    """Structure-of-arrays hit buffer."""

    t: torch.Tensor  # (N,) f32, +inf on a miss
    hit: torch.Tensor  # (N,) bool
    point: torch.Tensor  # (N, 3)
    normal: torch.Tensor  # (N, 3) — flipped to face the ray
    front_face: torch.Tensor  # (N,) bool
    mat_id: torch.Tensor  # (N,) int32
    prim_id: torch.Tensor  # (N,) int32 — spheres then quads (0 on a miss)


class QuadDerived(NamedTuple):
    """Per-quad derived quantities."""

    normal: torch.Tensor  # (Q, 3) unit plane normal
    d: torch.Tensor  # (Q,) plane offset n.Q
    av: torch.Tensor  # (Q, 3) alpha = p.av basis vector (= v x w)
    bv: torch.Tensor  # (Q, 3) beta = p.bv basis vector (= w x u)
    q_av: torch.Tensor  # (Q,) Q.av
    q_bv: torch.Tensor  # (Q,) Q.bv


def quad_derived(scene: Scene) -> QuadDerived:
    """n = u x v, unit normal, D = n.Q, w = n/(n.n), av = v x w, bv = w x u.
    Degenerate (dummy) quads get a zero normal."""
    n_raw = vm.cross(scene.quad_u, scene.quad_v)
    nn = vm.length_sq(n_raw)
    safe_nn = torch.where(nn > 0, nn, torch.ones_like(nn))
    w = n_raw / safe_nn[:, None]
    normal = n_raw / torch.sqrt(safe_nn)[:, None]
    av = vm.cross(scene.quad_v, w)
    bv = vm.cross(w, scene.quad_u)
    return QuadDerived(
        normal=normal,
        d=vm.dot(normal, scene.quad_q),
        av=av,
        bv=bv,
        q_av=vm.dot(scene.quad_q, av),
        q_bv=vm.dot(scene.quad_q, bv),
    )


def scene_tables(scene: Scene):
    """(sphere (S, 4), quad (Q, 12)) closest-hit tables."""
    return (
        ik.pack_sphere_table(scene.sph_center, scene.sph_radius),
        ik.pack_quad_table(quad_derived(scene)),
    )


def closest_hit_t_prim(scene: Scene, origin, direction):
    """Plain closest-hit search: (t (N,) f32 with +inf on a miss, prim (N,)
    int32 with -1 on a miss)."""
    sph, quad = scene_tables(scene)
    return ik.intersect_plain(sph, quad, origin, direction)


def sphere_uv(unit_normal):
    """Spherical (u, v) of an outward unit normal (N, 3), with the
    reference's phi offset (hittables.go:122-126)."""
    ny = torch.clamp(unit_normal[:, 1], -1.0, 1.0)
    theta = torch.acos(-ny)
    phi = torch.atan2(-unit_normal[:, 2], unit_normal[:, 0]) + math.pi
    return (phi + SPHERE_UV_PHI_OFFSET) / (2.0 * math.pi), theta / math.pi


def quad_uv(point, av, q_av, bv, q_bv):
    """Quad (u, v) = (p.av - Q.av, p.bv - Q.bv) of hit points (N, 3), from
    the winners' basis rows (hittables.go:183-186)."""
    u = (point[:, 0] * av[:, 0] + point[:, 1] * av[:, 1] + point[:, 2] * av[:, 2]) - q_av
    v = (point[:, 0] * bv[:, 0] + point[:, 1] * bv[:, 1] + point[:, 2] * bv[:, 2]) - q_bv
    return u, v


def winner_t_diff(scene: Scene, qd: QuadDerived, origin, direction, prim, t_nd, t_min=DEFAULT_T_MIN):
    """Differentiable t of each lane's winning primitive `prim` (N,) (port of
    the JAX package's `_winner_t_diff`): the expanded-form sphere and quad
    formulas at the winner's row only. Lanes whose `t_nd` is +inf (misses)
    keep it; every branch takes finite inputs on the lanes it does not own
    (double where), so no infinite partial meets a zero cotangent. The
    winners' rows are read by ops/gather_kernel.py:gather_rows."""
    ns = scene.num_spheres
    hit = torch.isfinite(t_nd)
    primc = torch.where(hit, prim, torch.zeros_like(prim)).long()
    is_quad = primc >= ns
    sidx = torch.clamp(primc, max=ns - 1)
    qidx = torch.clamp(primc - ns, min=0, max=scene.num_quads - 1)

    c = gather_rows(scene.sph_center, sidx)
    r = gather_rows(scene.sph_radius, sidx)
    oc = origin - c
    a = vm.length_sq(direction)
    half_b = vm.dot(direction, oc)
    cq = vm.length_sq(oc) - r * r
    disc = half_b * half_b - a * cq
    disc_ok = disc > 0.0
    sq = torch.sqrt(torch.where(disc_ok, disc, torch.ones_like(disc)))
    sq = torch.where(disc_ok, sq, torch.zeros_like(sq))
    inv_a = 1.0 / a
    t0 = (-half_b - sq) * inv_a
    t1 = (-half_b + sq) * inv_a
    t_s = torch.where(t0 > t_min, t0, t1)

    n = gather_rows(qd.normal, qidx)
    d_n = vm.dot(direction, n)
    denom_ok = d_n.abs() >= ik.QUAD_DENOM_EPS
    safe_dn = torch.where(denom_ok, d_n, torch.ones_like(d_n))
    t_q = (gather_rows(qd.d, qidx) - vm.dot(origin, n)) / safe_dn

    t = torch.where(is_quad, t_q, t_s)
    return torch.where(hit, t, t_nd)


def intersect_scene_kernel_diff(scene: Scene, origin, direction, bounce=None, lanes=None):
    """Differentiable closest hit: (t (N,) with autograd, +inf on a miss;
    prim (N,) int32, -1 on a miss). The closest-hit kernel (its twin on CPU
    tensors) searches on detached inputs; `winner_t_diff` recomputes t.
    `bounce` and `lanes` are unused: the signature is the integrator's
    intersect hook (integrator/wavefront.py:trace)."""
    with torch.no_grad():
        sph, quad = scene_tables(scene)
        t_nd, prim = ik.intersect(
            sph, quad, origin.detach().contiguous(), direction.detach().contiguous()
        )
    return winner_t_diff(scene, quad_derived(scene), origin, direction, prim, t_nd), prim


def intersect_scene(scene: Scene, origin, direction, stable_spheres: bool = False) -> HitRecord:
    """Closest hit with its epilogue, through the kernel wrapper (CUDA
    tensors launch the closest-hit kernel; CPU tensors take its twin); with
    `stable_spheres` a sphere winner's t is the stable quadratic's
    (ops/intersect_kernel.py:refine_sphere_winners)."""
    sph, quad = scene_tables(scene)
    radius = scene.sph_radius.detach().contiguous() if stable_spheres else None
    t, prim = ik.intersect(sph, quad, origin.contiguous(), direction.contiguous(), radius)
    ns = scene.num_spheres
    hit = torch.isfinite(t)
    prim = torch.where(hit, prim, torch.zeros_like(prim))
    point = origin + torch.where(hit, t, torch.zeros_like(t))[:, None] * direction
    is_quad = prim >= ns
    sidx = torch.clamp(prim, max=ns - 1).long()
    qidx = torch.clamp(prim - ns, min=0, max=scene.num_quads - 1).long()
    s_out = vm.normalize(
        (point - scene.sph_center[sidx]) * scene.sph_radius[sidx][:, None], eps=1e-20
    )
    outward = torch.where(is_quad[:, None], quad_derived(scene).normal[qidx], s_out)
    front = vm.dot(direction, outward) < 0.0
    return HitRecord(
        t=t,
        hit=hit,
        point=point,
        normal=torch.where(front[:, None], outward, -outward),
        front_face=front,
        mat_id=torch.where(is_quad, scene.quad_mat[qidx], scene.sph_mat[sidx]),
        prim_id=prim,
    )


class LargeSceneTables(NamedTuple):
    """Device tables of the JAX large-scene path's searches: the dense
    closest-hit tables and ops/culled_kernel.py:build_clusters' flat
    cluster tables."""

    sph_table: torch.Tensor  # (S, 4) dense
    quad_table: torch.Tensor  # (Q, 12)
    clusters: torch.Tensor  # (G, 8)
    cluster_order: torch.Tensor  # (8, G) int32
    sph_clustered: torch.Tensor  # (S', 4) cluster-ordered
    orig_ids: torch.Tensor  # (S',) int32
    num_spheres: int


def build_large_scene_tables(scene: Scene, max_leaf: int = 128) -> LargeSceneTables:
    """Host BVH clustering (NumPy) plus the dense tables, on the scene's
    device."""
    dev = scene.sph_center.device
    sph, quad = scene_tables(scene)
    cl, order, sph_cl, orig = ck.build_clusters(scene, max_leaf=max_leaf)
    return LargeSceneTables(sph, quad, cl.to(dev), order.to(dev), sph_cl.to(dev),
                            orig.to(dev), scene.num_spheres)
