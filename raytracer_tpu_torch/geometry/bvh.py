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
and `permute_scene` puts a scene's primitives in that order.
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

    def subtree_prims(node):
        ids = order[sub_lo[node] : sub_hi[node]]
        return ids[keep[ids]].tolist()

    def row(ids, start, count):
        return np.concatenate([bmin[ids].min(axis=0), bmax[ids].max(axis=0),
                               [float(start), float(count)]])

    perm: list[int] = []
    fine_rows: list[np.ndarray] = []
    super_rows: list[np.ndarray] = []
    for cnode in _cut_walk(skip, leaf_start, leaf_count, order, counts, max_leaf * super_fan):
        fine_lo = len(fine_rows)
        for fnode in _cut_walk(skip, leaf_start, leaf_count, order, counts, max_leaf,
                               lo=cnode, hi=skip[cnode]):
            ids = subtree_prims(fnode)
            if not ids:
                continue
            fine_rows.append(row(ids, len(perm), len(ids)))
            perm.extend(ids)
        if len(fine_rows) > fine_lo:
            sub = np.stack(fine_rows[fine_lo:])
            super_rows.append(np.concatenate(
                [sub[:, 0:3].min(axis=0), sub[:, 3:6].max(axis=0),
                 [float(fine_lo), float(len(fine_rows) - fine_lo)]]))
    fine = np.stack(fine_rows).astype(np.float32) if fine_rows else _empty_rows()
    if len(fine_rows) < min_fine_for_super:
        sup = _empty_rows()
    else:
        sup = np.stack(super_rows).astype(np.float32)
    return perm, fine, sup


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
                  min_fine_for_super: int = 24, use_native: bool = True) -> ClusterOrder:
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
    tables (the kernel intersects them in separate loops).

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
    q_perm, q_fine, q_super = _cluster_kind(bvh, bmin, bmax, ids >= ns, max_leaf, super_fan,
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
