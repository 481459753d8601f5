"""Host-side BVH builder to flat arrays (port of raytracer_tpu/geometry/bvh.py:
primitive_bounds, FlatBVH, build_bvh).

A deterministic top-down longest-axis median split (the reference's random
axis, bvh.go:147, only picks *a* valid tree), laid out in DFS preorder with
a stackless skip link per node: a hit on a node's box advances to the next
node, a miss jumps to `skip[i]`. Leaves reference a contiguous range of the
primitive permutation `prim_order`.

This is the NumPy builder only. The JAX package prefers a byte-identical C++
builder (cpp/raytpu_native.cc) through ctypes; that binding is not ported
yet (ROADMAP Queue 1 #12). The arrays stay NumPy: the build is host work,
and ops/culled_kernel.py:build_clusters reads them on the host.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np


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


def build_bvh(scene, leaf_size: int = 4) -> FlatBVH:
    """Top-down longest-axis median-split build over the scene's valid
    primitives (host, NumPy)."""
    bmin, bmax = primitive_bounds(scene)
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
