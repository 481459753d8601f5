"""Host-side BVH builder to flat arrays, and the two-level cluster cut of it
(port of raytracer_tpu/geometry/bvh.py: primitive_bounds, FlatBVH,
build_bvh, ClusterSet, cluster_scene; the port splits cluster_scene into
`cluster_order` and `permute_scene`).

A deterministic top-down longest-axis median split (the reference's random
axis, bvh.go:147, only picks *a* valid tree), laid out in DFS preorder with
a stackless skip link per node: a hit on a node's box advances to the next
node, a miss jumps to `skip[i]`. Leaves reference a contiguous range of the
primitive permutation `prim_order`.

`build_bvh` prefers the C++ builder (native/, compiled from
cpp/raytpu_native.cc at first use, byte-identical output) as the JAX
package does, and falls back to the NumPy builder here when no C++ compiler
is available; `build_bvh_reporting` also says which one ran. The arrays stay
NumPy: the build is host work, and ops/culled_kernel.py:build_clusters and
`cluster_scene` read them on the host.

`cluster_order` cuts the tree into fine clusters and super-clusters for
kernel 2's in-kernel culling (ops/persistent_kernel.py:pack_cluster_table),
`isolate_oversized` gives each primitive far wider than its kind's
supers (a ground sphere or ground quad) a fine row and a super of its own
(a port-side step; JAX has none), and `permute_scene` puts a scene's
primitives in that order.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch


class FlatBVH(NamedTuple):
    """Array-encoded BVH (host arrays)."""

    box_min: np.ndarray  # (M, 3) float32 node AABB min
    box_max: np.ndarray  # (M, 3) float32 node AABB max
    skip: np.ndarray  # (M,) int32: node to jump to when this box misses
    leaf_start: np.ndarray  # (M,) int32: first index into prim_order, -1 internal
    leaf_count: np.ndarray  # (M,) int32: number of leaf primitives
    prim_order: np.ndarray  # (P,) int32: permutation of global primitive ids


def primitive_bounds(scene) -> tuple[np.ndarray, np.ndarray]:
    """Host AABBs of all primitives (spheres then quads): sphere center +-
    |r| (hittables.go:86-92), quad corners with degenerate axes padded by
    1e-4 (hittables.go:161, bvh.go:63-82). Dummy primitives get inverted
    boxes that never hit."""
    c = scene.sph_center.cpu().numpy().astype(np.float64)
    radius = scene.sph_radius.cpu().numpy()
    r = np.abs(radius.astype(np.float64))[:, None]
    smin = c - r
    smax = c + r
    dummy_s = radius == 0.0
    smin[dummy_s] = np.inf
    smax[dummy_s] = -np.inf

    q = scene.quad_q.cpu().numpy().astype(np.float64)
    u = scene.quad_u.cpu().numpy().astype(np.float64)
    v = scene.quad_v.cpu().numpy().astype(np.float64)
    corners = np.stack([q, q + u, q + v, q + u + v], axis=0)
    qmin = corners.min(axis=0)
    qmax = corners.max(axis=0)
    eps = 1e-4
    thin = (qmax - qmin) < eps
    qmin = np.where(thin, qmin - eps, qmin)
    qmax = np.where(thin, qmax + eps, qmax)
    dummy_q = np.linalg.norm(np.cross(u, v), axis=-1) == 0.0
    qmin[dummy_q] = np.inf
    qmax[dummy_q] = -np.inf

    return (
        np.concatenate([smin, qmin]).astype(np.float32),
        np.concatenate([smax, qmax]).astype(np.float32),
    )


def build_bvh_reporting(scene, leaf_size: int = 4,
                        use_native: bool = True) -> tuple[FlatBVH, str]:
    """(build_bvh's tree, the builder that made it: "native" or "numpy")."""
    bmin, bmax = primitive_bounds(scene)
    if use_native:
        from raytracer_tpu_torch import native

        out = native.build_bvh_native(bmin, bmax, leaf_size)
        if out is not None:
            return FlatBVH(*out), "native"
    return _build_bvh_numpy(bmin, bmax, leaf_size), "numpy"


def build_bvh(scene, leaf_size: int = 4, use_native: bool = True) -> FlatBVH:
    """Top-down longest-axis median-split build over the scene's valid
    primitives (host): the C++ builder when it is available (and
    `use_native`), else NumPy; both give the same arrays."""
    return build_bvh_reporting(scene, leaf_size, use_native)[0]


def _build_bvh_numpy(bmin, bmax, leaf_size: int) -> FlatBVH:
    valid = np.isfinite(bmin[:, 0])
    prims = np.flatnonzero(valid)
    if prims.size == 0:
        prims = np.array([0], np.int64)

    nodes_min, nodes_max, skips, lstart, lcount = [], [], [], [], []
    order: list[int] = []

    def emit(ids) -> int:
        """DFS-preorder emit; returns the node index."""
        idx = len(nodes_min)
        nodes_min.append(bmin[ids].min(axis=0))
        nodes_max.append(bmax[ids].max(axis=0))
        skips.append(-1)  # patched after the subtree is emitted
        if len(ids) <= leaf_size:
            lstart.append(len(order))
            lcount.append(len(ids))
            order.extend(int(i) for i in ids)
        else:
            lstart.append(-1)
            lcount.append(0)
            c = (bmin[ids] + bmax[ids]) * 0.5
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = len(ids) // 2
            part = ids[np.argsort(c[:, axis], kind="stable")]
            emit(part[:mid])
            emit(part[mid:])
        skips[idx] = len(nodes_min)  # next node after this subtree
        return idx

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(prims)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        box_min=np.array(nodes_min, np.float32),
        box_max=np.array(nodes_max, np.float32),
        skip=np.array(skips, np.int32),
        leaf_start=np.array(lstart, np.int32),
        leaf_count=np.array(lcount, np.int32),
        prim_order=np.array(order, np.int32),
    )


class ClusterSet(NamedTuple):
    """Two-level cluster tables for kernel 2's in-kernel culling, host
    float32 arrays with rows [min xyz, max xyz, start, count]:

    * `sph` (Gs, 8): fine sphere clusters; start/count index the permuted
      sphere table.
    * `sph_super` (Ss, 8): the coarse level over the fine rows; start/count
      index `sph` ROWS. (0, 8) when the table is too small to gain from it:
      the kernel then walks the fine rows directly.
    * `quad` / `quad_super`: the same two levels for quads (start/count of
      `quad` index the permuted quad table). (0, 8) for both turns quad
      culling off (the dense quad loop).
    * `builder`: the BVH builder the cut was made from ("native", "numpy").

    Start and count are exact in float32 below 2^24."""

    sph: np.ndarray
    sph_super: np.ndarray
    quad: np.ndarray
    quad_super: np.ndarray
    builder: str = "numpy"


def _empty_rows() -> np.ndarray:
    return np.zeros((0, 8), np.float32)


def _cut_walk(skip, leaf_start, leaf_count, order, counts, limit, lo=0, hi=None):
    """Preorder walk over [lo, hi): the shallowest subtree roots whose kind
    count is <= limit (or that are leaves). `counts` is the per-node kind
    count; nodes without a primitive of the kind are skipped whole."""
    cuts = []
    i = lo
    end = len(skip) if hi is None else hi
    while i < end:
        if counts[i] == 0:
            i = skip[i]
        elif counts[i] <= limit or leaf_start[i] >= 0:
            cuts.append(i)
            i = skip[i]
        else:
            i += 1
    return cuts


def _cluster_kind(bvh: FlatBVH, bmin, bmax, keep, max_leaf: int, super_fan: int,
                  min_fine_for_super: int):
    """Fine and super cluster rows of one primitive kind.

    `keep` is a boolean mask over global primitive ids selecting the kind.
    Returns (perm: list of the kind's global ids in cluster order, fine
    (G, 8) rows, super (S, 8) rows); supers are empty when G <
    min_fine_for_super (one slab level already covers a small table).

    The JAX package's walk, with the per-node counts and subtree members
    read off the preorder layout: a subtree's leaves are the leaves in
    [node, skip[node]), and preorder emits them as one contiguous run of
    `prim_order`."""
    skip = np.asarray(bvh.skip, np.int64)
    leaf_start = np.asarray(bvh.leaf_start, np.int64)
    leaf_count = np.asarray(bvh.leaf_count, np.int64)
    order = np.asarray(bvh.prim_order, np.int64)
    m = len(skip)
    is_leaf = leaf_start >= 0

    kept = keep[order].astype(np.int64)
    kept_before = np.concatenate([[0], np.cumsum(kept)])  # kind count of order[:k]
    # Order offset where each node's subtree starts: its first leaf at or
    # after it in preorder. A subtree ends where the node after it starts.
    first_leaf = np.full(m + 1, len(order), np.int64)
    first_leaf[:m][is_leaf] = leaf_start[is_leaf]
    first_leaf = np.minimum.accumulate(first_leaf[::-1])[::-1]
    sub_lo = first_leaf[:m]
    sub_hi = first_leaf[skip]
    counts = kept_before[sub_hi] - kept_before[sub_lo]

    # The cut: fine subtree roots, and each super's span of them.
    fine_nodes: list[int] = []
    spans: list[tuple[int, int]] = []
    for cnode in _cut_walk(skip, leaf_start, leaf_count, order, counts, max_leaf * super_fan):
        lo = len(fine_nodes)
        fine_nodes += [f for f in _cut_walk(skip, leaf_start, leaf_count, order, counts,
                                            max_leaf, lo=cnode, hi=skip[cnode]) if counts[f]]
        if len(fine_nodes) > lo:
            spans.append((lo, len(fine_nodes)))
    if not fine_nodes:
        return [], _empty_rows(), _empty_rows()
    # Each fine root's subtree is one run of `order`; its kind's primitives,
    # in order, make the row.
    f = np.asarray(fine_nodes, np.int64)
    lens = sub_hi[f] - sub_lo[f]
    run_start = np.repeat(sub_lo[f] - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    ids = order[run_start + np.arange(int(lens.sum()))]
    perm = ids[keep[ids]]
    count = counts[f]
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    fine = np.concatenate([np.minimum.reduceat(bmin[perm], start, axis=0),
                           np.maximum.reduceat(bmax[perm], start, axis=0),
                           start[:, None], count[:, None]], axis=1).astype(np.float32)
    if len(fine_nodes) < min_fine_for_super:
        return perm.tolist(), fine, _empty_rows()
    s_lo = np.asarray([lo for lo, _ in spans], np.int64)
    s_n = np.asarray([hi - lo for lo, hi in spans], np.int64)
    sup = np.concatenate([np.minimum.reduceat(fine[:, 0:3], s_lo, axis=0),
                          np.maximum.reduceat(fine[:, 3:6], s_lo, axis=0),
                          s_lo[:, None], s_n[:, None]], axis=1).astype(np.float32)
    return perm.tolist(), fine, sup


class ClusterOrder(NamedTuple):
    """The host clustering of a scene's geometry (`cluster_order`): the
    primitive permutation and the cluster rows over the permuted tables.

    * `sph` (S',) int64 CPU tensor: the sphere rows in cluster order (dummy
      spheres dropped, but one kept when no real sphere exists).
    * `quad` (Q',) int64 CPU tensor of quad rows in cluster order, or None
      when the scene has no real quad (the quad table stays as it is).
    * `clusters`: the ClusterSet."""

    sph: torch.Tensor
    quad: torch.Tensor | None
    clusters: ClusterSet


def cluster_order(scene, max_leaf: int = 128, super_fan: int = 16,
                  min_fine_for_super: int = 24, use_native: bool = True,
                  quad_grain: tuple[int, int] | None = None) -> ClusterOrder:
    """Cluster-order the scene's primitives along BVH subtree cuts (host)
    for kernel 2's in-kernel culling; `permute_scene` applies the result.

    Cuts the BVH (leaf 8) at the shallowest subtrees holding <= max_leaf
    primitives of a kind and lays each subtree's primitives out
    contiguously, so one (start, count) range and one AABB describe a
    spatial cluster (the subtree skip of bvh.go:220-249). A second level of
    super-clusters of <= max_leaf * super_fan primitives, cut from the same
    tree so each super's fine rows are contiguous, lets one coarse slab
    miss skip up to super_fan fine slab tests; below min_fine_for_super
    fine clusters that level is dropped. Spheres and quads get their own
    tables (the kernel intersects them in separate loops); `quad_grain`
    (max_leaf, super_fan) cuts the quads at their own granularity (None:
    the spheres').

    It reads the geometry alone (sph_center, sph_radius, quad_q, quad_u,
    quad_v; `primitive_bounds`). Dummy primitives are dropped since they
    never hit. A scene without a real sphere keeps one dummy sphere row (so
    the tables keep their shapes) in one fine cluster; one without a real
    quad keeps its quad table and gets no quad clusters."""
    ns = scene.num_spheres
    bvh, builder = build_bvh_reporting(scene, leaf_size=8, use_native=use_native)
    bmin, bmax = primitive_bounds(scene)
    ids = np.arange(bmin.shape[0])

    s_perm, s_fine, s_super = _cluster_kind(bvh, bmin, bmax, ids < ns, max_leaf, super_fan,
                                            min_fine_for_super)
    q_leaf, q_fan = quad_grain or (max_leaf, super_fan)
    q_perm, q_fine, q_super = _cluster_kind(bvh, bmin, bmax, ids >= ns, q_leaf, q_fan,
                                            min_fine_for_super)
    if not s_perm:  # no real sphere: one dummy so the shapes stay valid
        s_perm = [0]
        s_fine = np.array([[0, 0, 0, 0, 0, 0, 0.0, 1.0]], np.float32)
        s_super = _empty_rows()
    q = None
    if q_perm:
        q = torch.as_tensor(q_perm, dtype=torch.int64) - ns
    else:
        q_fine, q_super = _empty_rows(), _empty_rows()
    return ClusterOrder(torch.as_tensor(s_perm, dtype=torch.int64), q, ClusterSet(
        sph=s_fine, sph_super=s_super, quad=q_fine, quad_super=q_super, builder=builder))


# A primitive is oversized when its box's largest extent passes this
# multiple of the median largest extent of its kind's supers: one so wide
# stretches its fine row and its super over the scene, so nearly every
# bounce ray starts inside both and tests all of that row's primitives
# (rand_spheres_large's r = 1000 ground, 2000 wide, against supers of
# 25-45).
OVERSIZE_FACTOR = 4.0


def _split_kind(perm: np.ndarray, fine: np.ndarray, sup: np.ndarray, pmin: np.ndarray,
                pmax: np.ndarray, factor: float):
    """One kind's rows with its oversized primitives moved out (see
    `isolate_oversized`). `perm` is the kind's cluster order, `pmin` /
    `pmax` its primitives' boxes in that order. Returns (perm, fine, sup)."""
    if sup.shape[0] == 0:
        return perm, fine, sup
    extent = np.sort((sup[:, 3:6] - sup[:, 0:3]).max(axis=1))
    big = (pmax - pmin).max(axis=1) > factor * extent[len(extent) // 2]  # the (upper) median
    if not big.any():
        return perm, fine, sup
    big_before = np.concatenate([[0], np.cumsum(big)])  # oversized among perm[:k]
    start, count = fine[:, 6].astype(np.int64), fine[:, 7].astype(np.int64)
    lost = big_before[start + count] - big_before[start]
    left = count - lost > 0
    rows = fine[left].copy()
    rows[:, 6] = (start - big_before[start])[left]
    rows[:, 7] = (count - lost)[left]
    kept_pos = np.flatnonzero(~big)
    for r in np.flatnonzero(lost[left] > 0):  # re-box the rows that lost one
        ids = kept_pos[int(rows[r, 6]) : int(rows[r, 6] + rows[r, 7])]
        rows[r, 0:3], rows[r, 3:6] = pmin[ids].min(axis=0), pmax[ids].max(axis=0)
    # Supers over the fine rows left: a super's rows stay contiguous.
    left_before = np.concatenate([[0], np.cumsum(left)])
    s_start, s_count = sup[:, 6].astype(np.int64), sup[:, 7].astype(np.int64)
    s_left = left_before[s_start + s_count] - left_before[s_start]
    keep_sup = s_left > 0
    supers = sup[keep_sup].copy()
    supers[:, 6] = left_before[s_start][keep_sup]
    supers[:, 7] = s_left[keep_sup]
    lost_before = np.concatenate([[0], np.cumsum(lost > 0)])
    touched = (lost_before[s_start + s_count] - lost_before[s_start])[keep_sup] > 0
    for j in np.flatnonzero(touched):
        block = rows[int(supers[j, 6]) : int(supers[j, 6] + supers[j, 7])]
        supers[j, 0:3], supers[j, 3:6] = block[:, 0:3].min(axis=0), block[:, 3:6].max(axis=0)
    # Each oversized primitive: a fine row and a super of its own, appended.
    pos = np.flatnonzero(big)
    boxes = np.concatenate([pmin[pos], pmax[pos]], axis=1)
    n_left = len(kept_pos)
    own_fine = np.concatenate([boxes, (n_left + np.arange(len(pos)))[:, None],
                               np.ones((len(pos), 1))], axis=1)
    own_sup = np.concatenate([boxes, (len(rows) + np.arange(len(pos)))[:, None],
                              np.ones((len(pos), 1))], axis=1)
    return (np.concatenate([perm[~big], perm[big]]),
            np.concatenate([rows, own_fine]).astype(np.float32),
            np.concatenate([supers, own_sup]).astype(np.float32))


def isolate_oversized(scene, order: ClusterOrder,
                      factor: float = OVERSIZE_FACTOR) -> ClusterOrder:
    """`order` with each oversized primitive (OVERSIZE_FACTOR) in a fine row
    of count 1 under a super of its own, appended to its kind's rows; the
    primitive moves to the end of its kind's permuted table, and the fine
    row and super it left are re-boxed over what remains (a row left empty
    is dropped). A kind without a super level walks its few fine rows
    directly and is left as it is. Kernel 2's walk and its twin follow
    whatever table they are given, so they stay equal; render/driver.py:
    order_clusters then sorts the new rows front to back like the others."""
    bmin, bmax = primitive_bounds(scene)
    cs = order.clusters
    sph, s_fine, s_sup = _split_kind(order.sph.numpy(), cs.sph, cs.sph_super,
                                     bmin[order.sph.numpy()], bmax[order.sph.numpy()], factor)
    quad, q_fine, q_sup = order.quad, cs.quad, cs.quad_super
    if quad is not None:
        gid = quad.numpy() + scene.num_spheres
        q_np, q_fine, q_sup = _split_kind(quad.numpy(), cs.quad, cs.quad_super, bmin[gid],
                                          bmax[gid], factor)
        quad = torch.from_numpy(q_np)
    return ClusterOrder(torch.from_numpy(sph), quad, cs._replace(
        sph=s_fine, sph_super=s_sup, quad=q_fine, quad_super=q_sup))


def permute_scene(scene, order: ClusterOrder):
    """`scene` with its per-primitive fields (geometry and material ids) in
    `order`'s cluster order. Materials and textures are shared tables keyed
    by sph_mat / quad_mat, so they stay as the scene has them."""
    dev = scene.sph_center.device
    p = order.sph.to(dev)
    repl = dict(sph_center=scene.sph_center[p], sph_radius=scene.sph_radius[p],
                sph_mat=scene.sph_mat[p])
    if order.quad is not None:
        q = order.quad.to(dev)
        repl.update(quad_q=scene.quad_q[q], quad_u=scene.quad_u[q], quad_v=scene.quad_v[q],
                    quad_mat=scene.quad_mat[q])
    return dataclasses.replace(scene, **repl)


def cluster_scene(scene, max_leaf: int = 128, super_fan: int = 16,
                  min_fine_for_super: int = 24, use_native: bool = True):
    """(the scene permuted into cluster order, its ClusterSet):
    `cluster_order` applied by `permute_scene`."""
    order = cluster_order(scene, max_leaf, super_fan, min_fine_for_super, use_native)
    return permute_scene(scene, order), order.clusters


def _slab_test(box_min, box_max, o, inv_d, t_min: float, t_max):
    """Branchless slab test of each ray against its box (reference Aabb.Hit
    / InBoundary, bvh.go:52-102, strict `rT.min < rT.max`); NaN reads as a
    miss."""
    t0 = (box_min - o) * inv_d
    t1 = (box_max - o) * inv_d
    tn = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=t_min)
    tf = torch.minimum(t_max, torch.maximum(t0, t1).amin(dim=-1))
    return tn < tf


def _prim_t(scene, qd, p, o, d, t_min: float):
    """Candidate t of global primitive ids `p` (spheres, then quads) for
    rays (o, d), +inf where they miss (hittables.go:96-116, 167-194; strict
    disc > 0 as the dense search, so exactly tangent rays miss)."""

    def dot(a, b):
        return (a * b).sum(dim=-1)

    ns, nq = scene.num_spheres, scene.num_quads
    si = torch.clamp(p, max=ns - 1)
    oc = o - scene.sph_center[si]
    r = scene.sph_radius[si]
    a = dot(d, d)
    half_b = dot(d, oc)
    disc = half_b * half_b - a * (dot(oc, oc) - r * r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    feas = (disc > 0.0) & (r != 0.0)
    inf = torch.full_like(a, float("inf"))
    ts0 = (-half_b - sq) / a
    ts1 = (-half_b + sq) / a
    t = torch.minimum(torch.where(feas & (ts0 > t_min), ts0, inf),
                      torch.where(feas & (ts1 > t_min), ts1, inf))
    if nq == 0:
        return t
    qi = torch.clamp(p - ns, 0, nq - 1)
    nrm = qd.normal[qi]
    dn = dot(d, nrm)
    ok = dn.abs() >= 1e-8
    tq = (qd.d[qi] - dot(o, nrm)) / torch.where(ok, dn, torch.ones_like(dn))
    pt = o + tq[:, None] * d
    alpha = dot(pt, qd.av[qi]) - qd.q_av[qi]
    beta = dot(pt, qd.bv[qi]) - qd.q_bv[qi]
    okq = (ok & (tq > t_min) & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1))
    return torch.where(p >= ns, torch.where(okq, tq, inf), t)


def bvh_closest_hit(scene, bvh: FlatBVH, origin, direction, t_min: float = 1e-3):
    """Closest hit by the stackless skip-link traversal of `bvh` (port of
    raytracer_tpu/geometry/bvh.py:bvh_closest_hit): every ray walks the
    preorder nodes, a box hit advancing to the next node and a miss jumping
    to the node's skip link, and tests the primitives of each leaf whose
    box it hits, in leaf order (the first of equal t wins). Plain torch
    on the rays' device, lock-step over the rays still walking; the
    cross-check of the dense closest hit, on no render path. Returns (t
    (N,) float32 with +inf on a miss, prim (N,) int32 with -1 on a miss),
    the dense search's semantics."""
    from raytracer_tpu_torch.geometry.intersect import quad_derived

    dev = origin.device
    n = origin.shape[0]
    as_t = lambda x, dtype: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
    box_min, box_max = as_t(bvh.box_min, torch.float32), as_t(bvh.box_max, torch.float32)
    skip, leaf_start = as_t(bvh.skip, torch.int64), as_t(bvh.leaf_start, torch.int64)
    leaf_count, order = as_t(bvh.leaf_count, torch.int64), as_t(bvh.prim_order, torch.int64)
    num_nodes = box_min.shape[0]
    max_leaf = int(leaf_count.max()) if num_nodes else 0
    qd = quad_derived(scene)
    # A sign-preserving nudge of zero direction components: 1/0 = inf, and
    # (box - o) * inf with o on the slab's plane is NaN, which reads as a
    # miss; the nudge keeps the test conservative.
    tiny = 1e-30
    d = direction
    inv_d = 1.0 / torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d)
    t_best = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    p_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev) if num_nodes else torch.zeros(0, dtype=torch.int64)
    while live.numel():
        nd = node[live]
        hit_box = _slab_test(box_min[nd], box_max[nd], origin[live], inv_d[live], t_min,
                             t_best[live])
        leaf = live[hit_box & (leaf_start[nd] >= 0)]
        start, cnt = leaf_start[node[leaf]], leaf_count[node[leaf]]
        for j in range(max_leaf):
            m = j < cnt
            rays = leaf[m]
            p = order[start[m] + j]
            tc = _prim_t(scene, qd, p, origin[rays], direction[rays], t_min)
            better = tc < t_best[rays]
            t_best[rays] = torch.where(better, tc, t_best[rays])
            p_best[rays] = torch.where(better, p, p_best[rays])
        node[live] = torch.where(hit_box, nd + 1, skip[nd])
        live = live[node[live] < num_nodes]
    return t_best, p_best.to(torch.int32)
