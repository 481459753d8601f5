"""Kernel 1: closest hit of a flat ray batch over all spheres, then all quads.

Port of raytracer_tpu/ops/intersect_kernel.py (`intersect_pallas`). The CUDA
kernel is `csrc/intersect_kernel.cu` (one thread per ray, math from
`csrc/closest_hit.cuh`); `intersect_plain` below is its plain PyTorch twin
and its spec: the same scaled-t compare space (t' = t*|d|^2), the same strict
open interval t > 1e-3, NaN-rejected infeasible spheres, and the first
minimal candidate winning ties (the kernel's sequential strict `<`).

`intersect` runs the dense search: in one pass, or, for a launch too small
to fill the card, with the table split into slices whose winners fold
into one (t bits, prim) word per ray (`split_rows`; `intersect_split_plain`
is the plain model of that combine). `intersect_clustered` runs the
two-level cluster walk over a cluster-ordered scene (the large-scene
path's bounce rays); its twin is ops/cluster_visit.py:ClusterVisit.hit.

Given the spheres' radii (`radius`), the dense search recomputes each
sphere winner's t by the stable quadratic (`refine_sphere_winners`): the
folded |c|^2 - r^2 keeps two or three digits of r^2 for a small sphere far
from the origin, and a grazing hit then lands up to ~5e-4 inside it. The
winner is the same either way.

Tables: spheres (S, 4) [cx, cy, cz, |c|^2 - r^2] with 1e30 for dummy rows;
quads (Q, 12) [n, n.Q, av, bv, Q.av, Q.bv] with a zero normal for dummy rows.
Results: t (N,) float32 (+inf on a miss), prim (N,) int32 (-1 on a miss;
quads are numbered after spheres).
"""

from __future__ import annotations

import functools

import torch

INF = float("inf")
T_MIN = 1e-3
QUAD_DENOM_EPS = 1e-8
# Sign-preserving stand-in for a zero direction component in a cluster slab
# test: (bmin - o) * (1/0) is 0 * inf = NaN for an origin on the box plane,
# and a NaN compare would cull a box the ray hits.
SLAB_TINY = 1e-30
# Rays per block of the plain twin's dense (rays, prims) candidate matrices.
PLAIN_CHUNK = 16384
# Threads per block of the dense kernel, and of the clustered walk (kernel
# 1's clustered entry and kernel 4).
THREADS = 256
CLUSTERED_THREADS = 128
# The dense kernel splits its table when a launch has fewer blocks than
# this many a streaming multiprocessor, into enough slices for about
# SPLIT_TARGET_BLOCKS blocks an SM (eight blocks of 256 threads fill one),
# each of at least SPLIT_MIN_ROWS sphere rows.
SPLIT_BELOW_BLOCKS = 2
SPLIT_TARGET_BLOCKS = 8
SPLIT_MIN_ROWS = 32
# Sphere rows per group of csrc/closest_hit.cuh's loop: slices start on a
# group.
SPHERE_GROUP = 4

# CUDA launches of the dense and the clustered kernel (plain-twin calls do
# not count; a split launch counts once).
LAUNCHES = 0
LAUNCHES_CLUSTERED = 0


def pack_sphere_table(sph_center, sph_radius) -> torch.Tensor:
    """(S, 4): cx, cy, cz, |c|^2 - r^2; dummy rows (radius == 0) get +1e30."""
    c = sph_center
    c2r2 = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]) - sph_radius * sph_radius
    c2r2 = torch.where(sph_radius == 0.0, torch.full_like(c2r2, 1e30), c2r2)
    return torch.cat([sph_center, c2r2[:, None]], dim=1).contiguous()


def pack_quad_table(qd) -> torch.Tensor:
    """(Q, 12) from geometry.intersect.QuadDerived (dummy rows have n = 0)."""
    return torch.cat(
        [qd.normal, qd.d[:, None], qd.av, qd.bv, qd.q_av[:, None], qd.q_bv[:, None]],
        dim=1,
    ).contiguous()


def _ray_terms(origin, direction):
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    a = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o_sq = ox * ox + oy * oy + oz * oz
    return (ox, oy, oz), (dx, dy, dz), a, d_dot_o, o_sq


def closest_hit_scaled(sph_table, quad_table, origin, direction):
    """Winning scaled t' = t*|d|^2 (+inf on a miss) and prim (-1 on a miss)
    for a block of rays: dense (rays, prims) candidates, then one min."""
    cands, a = candidates_scaled(sph_table, quad_table, origin, direction)
    t_best, idx = cands.min(dim=1)
    prim = torch.where(t_best < INF, idx, torch.full_like(idx, -1)).to(torch.int32)
    return t_best, prim, a


def candidates_scaled(sph_table, quad_table, origin, direction, terms: bool = False):
    """((rays, spheres + quads) scaled-t candidates, +inf where a primitive
    is missed; |d|^2 per ray) and, with `terms`, the intermediate terms
    (rays, spheres) disc and (rays, quads) d.n, n.Q - o.n and t (None for a
    kind without rows)."""
    (ox, oy, oz), (dx, dy, dz), a, d_dot_o, o_sq = _ray_terms(origin, direction)
    tmin_a = (T_MIN * a)[:, None]
    col = lambda v: v[:, None]  # noqa: E731 — per-ray column
    cands = []
    disc = d_n = num = t = None
    if sph_table.shape[0]:
        cx, cy, cz, c2r2 = sph_table.unbind(1)
        d_dot_c = col(dx) * cx + col(dy) * cy + col(dz) * cz
        o_dot_c = col(ox) * cx + col(oy) * cy + col(oz) * cz
        half_b = col(d_dot_o) - d_dot_c
        c = col(o_sq) - 2.0 * o_dot_c + c2r2
        disc = half_b * half_b - col(a) * c
        sq = torch.sqrt(disc)  # NaN (disc < 0) -> rejected by the compares
        nhb = -half_b
        t0s = nhb - sq
        t1s = nhb + sq
        inf = torch.full_like(t0s, INF)
        cands.append(torch.where(t0s > tmin_a, t0s, torch.where(t1s > tmin_a, t1s, inf)))
    if quad_table.shape[0]:
        q = quad_table.unbind(1)
        nx, ny, nz, dplane = q[0:4]
        d_n = col(dx) * nx + col(dy) * ny + col(dz) * nz
        o_n = col(ox) * nx + col(oy) * ny + col(oz) * nz
        denom_ok = d_n.abs() >= QUAD_DENOM_EPS
        num = dplane - o_n
        t = num / torch.where(denom_ok, d_n, torch.ones_like(d_n))
        avx, avy, avz, bvx, bvy, bvz, qav, qbv = q[4:12]
        alpha = (
            (col(ox) * avx + col(oy) * avy + col(oz) * avz)
            + t * (col(dx) * avx + col(dy) * avy + col(dz) * avz)
            - qav
        )
        beta = (
            (col(ox) * bvx + col(oy) * bvy + col(oz) * bvz)
            + t * (col(dx) * bvx + col(dy) * bvy + col(dz) * bvz)
            - qbv
        )
        ok = (
            denom_ok
            & (t > T_MIN)
            & (alpha >= 0.0)
            & (alpha <= 1.0)
            & (beta >= 0.0)
            & (beta <= 1.0)
        )
        cands.append(torch.where(ok, t * col(a), torch.full_like(t, INF)))
    if terms:
        return torch.cat(cands, dim=1), a, (disc, d_n, num, t)
    return torch.cat(cands, dim=1), a


def slab_inv(direction):
    """1 / direction with components below SLAB_TINY in magnitude nudged to
    +-SLAB_TINY (csrc/closest_hit.cuh:slab_inv), elementwise."""
    tiny = torch.where(direction < 0, -SLAB_TINY, SLAB_TINY)
    return 1.0 / torch.where(direction.abs() < SLAB_TINY, tiny, direction)


def refine_sphere_winners(sph_table, radius, origin, direction, t_s, prim, a):
    """Scaled t (N,) of the winners (t_s, prim) with each sphere winner's
    recomputed from its centre and radius by the stable quadratic: oc = o -
    c, and the discriminant |d|^2 (r^2 - |l|^2) from the perpendicular l =
    oc - (d.oc / |d|^2) d, for a sphere with 4 r^2 < |o|^2 + |c|^2 (the fold
    rounds at about |o|^2 + |c|^2, the stable form at about r (|oc| + r)).
    Other winners, and one whose stable roots are both <= T_MIN, keep t_s.
    Twin of csrc/closest_hit.cuh:sphere_winner_t, operation for
    operation."""
    if sph_table.shape[0] == 0:
        return t_s
    is_sphere = (prim >= 0) & (prim < sph_table.shape[0])
    row = torch.where(is_sphere, prim, torch.zeros_like(prim)).long()
    c, r = sph_table[row], radius[row]
    (ox, oy, oz), (dx, dy, dz), _, _, o_sq = _ray_terms(origin, direction)
    ocx, ocy, ocz = ox - c[:, 0], oy - c[:, 1], oz - c[:, 2]
    hb = dx * ocx + dy * ocy + dz * ocz
    k = hb / a
    lx, ly, lz = ocx - k * dx, ocy - k * dy, ocz - k * dz
    h2 = r * r - (lx * lx + ly * ly + lz * lz)
    sq = torch.sqrt(a * torch.clamp(h2, min=0.0))
    nhb = -hb
    t0s, t1s = nhb - sq, nhb + sq
    tmin_a = T_MIN * a
    t_new = torch.where(t0s > tmin_a, t0s, torch.where(t1s > tmin_a, t1s, t_s))
    c_sq = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
    small = 4.0 * r * r < o_sq + c_sq
    return torch.where(is_sphere & small, t_new, t_s)


def intersect_plain(sph_table, quad_table, origin, direction, radius=None):
    """Plain PyTorch twin of the kernel: (t (N,), prim (N,) int32); with
    `radius` (S,) the sphere winners' t by `refine_sphere_winners`."""
    n = origin.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    prim = torch.empty(n, dtype=torch.int32, device=origin.device)
    for s in range(0, n, PLAIN_CHUNK):
        e = min(n, s + PLAIN_CHUNK)
        t_s, p, a = closest_hit_scaled(sph_table, quad_table, origin[s:e], direction[s:e])
        if radius is not None:
            t_s = refine_sphere_winners(sph_table, radius, origin[s:e], direction[s:e], t_s, p,
                                        a)
        t[s:e] = t_s * (1.0 / a)  # back from scaled-t space (INF stays INF)
        prim[s:e] = p
    return t, prim


def split_rows(n: int, ns: int, sms: int, threads: int = THREADS) -> int:
    """Sphere rows per slice of a dense launch of n rays over ns sphere rows
    on a card of `sms` streaming multiprocessors: 0 (one pass) when its
    blocks fill the card or the table is too short to split, else a
    multiple of SPHERE_GROUP that cuts the table into enough slices for
    SPLIT_TARGET_BLOCKS blocks an SM."""
    blocks = -(-n // threads)
    if n == 0 or blocks >= SPLIT_BELOW_BLOCKS * sms or ns < 2 * SPLIT_MIN_ROWS:
        return 0
    slices = min(-(-SPLIT_TARGET_BLOCKS * sms // blocks), ns // SPLIT_MIN_ROWS)
    rows = -(-ns // slices)
    return -(-rows // SPHERE_GROUP) * SPHERE_GROUP


def intersect_split_plain(sph_table, quad_table, origin, direction, slice_rows: int):
    """Plain model of the split kernel's combine: each slice's first minimal
    candidate (sphere rows [k * slice_rows, (k + 1) * slice_rows), the quads
    in the last slice) as the word (bits of its scaled t << 32) | prim, the
    minimum word over the slices (none for a slice without a finite
    candidate), and the word turned back into (t, prim). Equals
    intersect_plain bit for bit."""
    ns = sph_table.shape[0]
    slices = max(1, -(-ns // slice_rows))
    miss = torch.iinfo(torch.int64).max
    a = _ray_terms(origin, direction)[2]
    best = torch.full((origin.shape[0],), miss, dtype=torch.int64, device=origin.device)
    for k in range(slices):
        b, e = k * slice_rows, min(ns, (k + 1) * slice_rows)
        quads = quad_table if k == slices - 1 else quad_table[:0]
        t_s, p, _ = closest_hit_scaled(sph_table[b:e], quads, origin, direction)
        prim = torch.where(p < e - b, p.long() + b, p.long() - (e - b) + ns)
        bits = t_s.view(torch.int32).long()
        word = torch.where(t_s < INF, (bits << 32) | prim, miss)
        best = torch.minimum(best, word)
    hit = best != miss
    t_s = torch.where(hit, (best >> 32).to(torch.int32).view(torch.float32), INF)
    prim = torch.where(hit, best & 0xFFFFFFFF, -1).to(torch.int32)
    return t_s * (1.0 / a), prim


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_tensor(name, x, dtype, shape, device):
    """Raise unless `x` has the dtype, shape (None = any extent), device and
    contiguity a kernel needs."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(x.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_float4_rows(**tables):
    """Raise unless each table starts on a 16-byte boundary: kernels read
    their rows as float4."""
    for name, x in tables.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: rows are read as float4 and need 16-byte alignment")


def intersect(sph_table, quad_table, origin, direction, radius=None):
    """Closest hit for a flat ray batch: (t (N,) f32, prim (N,) i32); with
    the spheres' radii `radius` (S,) each sphere winner's t is the stable
    quadratic's (`refine_sphere_winners`).

    CPU tensors take `intersect_plain`; CUDA tensors launch the CUDA kernel
    (or raise), split (`split_rows`) when its blocks cannot fill the card,
    its scratch words allocated here."""
    global LAUNCHES
    dev = origin.device
    check_tensor("sph_table", sph_table, torch.float32, (None, 4), dev)
    check_tensor("quad_table", quad_table, torch.float32, (None, 12), dev)
    check_tensor("origin", origin, torch.float32, (None, 3), dev)
    n = origin.shape[0]
    check_tensor("direction", direction, torch.float32, (n, 3), dev)
    if radius is not None:
        check_tensor("radius", radius, torch.float32, (sph_table.shape[0],), dev)
    if dev.type == "cpu":
        return intersect_plain(sph_table, quad_table, origin, direction, radius)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_float4_rows(sph_table=sph_table, quad_table=quad_table)
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    lib = load_kernels()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t, prim
    rows = split_rows(n, sph_table.shape[0], sm_count(dev.index or 0))
    words = torch.empty(n if rows else 0, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_intersect(
        sph_table.data_ptr(), None if radius is None else radius.data_ptr(),
        sph_table.shape[0], quad_table.data_ptr(), quad_table.shape[0],
        origin.data_ptr(), direction.data_ptr(), n, t.data_ptr(), prim.data_ptr(),
        rows, words.data_ptr() if rows else None, THREADS, stream,
    )
    check_launch("rt_intersect", err)
    LAUNCHES += 1
    return t, prim


def clustered_closest_hit(entry: str, clusters, sph_table, quad_table, origin, direction):
    """Closest hit of a ray batch over a cluster-ordered scene: (t (N,) f32,
    prim (N,) i32, the scene's table rows, whether a kernel was launched).
    `clusters` is the scene's ops/persistent_kernel.py:ClusterTable,
    `sph_table` and `quad_table` its tables (geometry/intersect.py:
    scene_tables of the permuted scene).

    CPU tensors take the twin, ops/cluster_visit.py:ClusterVisit.hit; CUDA
    tensors launch the library's clustered walk `entry` (or raise)."""
    from raytracer_tpu_torch.ops.cluster_visit import ClusterVisit, check_clustered_inputs

    dev = origin.device
    check_clustered_inputs(clusters, sph_table, quad_table, origin, direction)
    if dev.type == "cpu":
        return (*ClusterVisit.build(clusters, sph_table, quad_table).hit(origin, direction),
                False)
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    lib = load_kernels()
    n = origin.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t, prim, False
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(
        clusters.rows.data_ptr(), *clusters.counts, sph_table.data_ptr(), sph_table.shape[0],
        quad_table.data_ptr(), quad_table.shape[0], origin.data_ptr(), direction.data_ptr(), n,
        t.data_ptr(), prim.data_ptr(), CLUSTERED_THREADS, stream,
    )
    check_launch(entry, err)
    return t, prim, True


def intersect_clustered(clusters, sph_table, quad_table, origin, direction):
    """Closest hit of a ray batch over a cluster-ordered scene by the
    per-lane cluster walk (the large-scene path's bounce rays): (t, prim),
    as clustered_closest_hit."""
    global LAUNCHES_CLUSTERED
    t, prim, launched = clustered_closest_hit("rt_intersect_clustered", clusters, sph_table,
                                              quad_table, origin, direction)
    LAUNCHES_CLUSTERED += launched
    return t, prim
