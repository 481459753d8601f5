"""Kernel 4: cluster-culled closest hit for coherent camera rays in large
scenes.

Port of raytracer_tpu/ops/culled_kernel.py (`intersect_pallas_culled`,
`build_clusters`). The TPU kernel walks a flat table: the BVH cut on the
host into clusters of at most `max_leaf` spheres, laid out
cluster-contiguous, each with its AABB, ordered front to back for each of
the eight direction octants. `build_clusters` and `intersect_culled_plain`
(the same search without culling, in that order) keep that table and
search here as the TPU kernel's spec, held against JAX by the tests.

On the H100 the CUDA kernel (`csrc/culled_kernel.cu`, one thread per ray)
walks the render's own two-level cluster table instead
(render/driver.py:cluster_for_render: 64-sphere fine rows under supers of
16, sorted front to back from the eye, from which every camera ray
starts), with csrc/cluster_walk.cuh's warp vote: a warp enters a row when
any of its rays can hit it. `intersect_culled` takes that ClusterTable and
the permuted scene's tables; its twin is ops/cluster_visit.py:
ClusterVisit.hit, which equals the dense search in t on every ray.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.geometry.bvh import build_bvh, primitive_bounds
from raytracer_tpu_torch.ops.intersect_kernel import (
    INF,
    PLAIN_CHUNK,
    T_MIN,
    closest_hit_scaled,
    clustered_closest_hit,
    slab_inv,
)

# Lanes of a warp (the TPU kernel's tile took its first ray's octant).
WARP = 32

# CUDA launches of the kernel (plain-twin calls do not count).
LAUNCHES = 0


def build_clusters(scene, bvh=None, max_leaf: int = 128):
    """Host clustering from the BVH: cut the tree at the shallowest subtrees
    holding <= max_leaf primitives. Returns CPU tensors (clusters (G, 8)
    float32 [min xyz, max xyz, start, count], order (8, G) int32 front to
    back per octant, sph_cl (S', 4) float32 cluster-ordered sphere rows,
    orig_ids (S',) int32 global sphere ids)."""
    if bvh is None:
        bvh = build_bvh(scene, leaf_size=8)
    skip, leaf_start, leaf_count = bvh.skip, bvh.leaf_start, bvh.leaf_count
    order = bvh.prim_order
    ns = scene.num_spheres

    # Subtree primitive counts via the preorder/skip structure.
    m = len(skip)
    counts = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):
        if leaf_start[i] >= 0:
            counts[i] = leaf_count[i]
        else:
            left = i + 1
            right = skip[left]
            counts[i] = counts[left] + (counts[right] if right < m else 0)

    clusters = []
    i = 0
    while i < m:
        if counts[i] <= max_leaf or leaf_start[i] >= 0:
            clusters.append(i)
            i = skip[i]
        else:
            i += 1

    def subtree_prims(node):
        out = []
        for j in range(node, skip[node]):
            if leaf_start[j] >= 0:
                s, c = leaf_start[j], leaf_count[j]
                out.extend(order[s : s + c])
        return out

    centers = scene.sph_center.cpu().numpy()
    radii = scene.sph_radius.cpu().numpy()
    c2r2 = (centers * centers).sum(-1) - radii * radii
    c2r2 = np.where(radii == 0.0, 1e30, c2r2)

    cl_rows, sph_rows, orig_ids = [], [], []
    bmin, bmax = primitive_bounds(scene)
    for node in clusters:
        prims = [p for p in subtree_prims(node) if p < ns]  # spheres only
        if not prims:
            continue
        start = len(sph_rows)
        for p in prims:
            sph_rows.append([centers[p, 0], centers[p, 1], centers[p, 2], c2r2[p]])
            orig_ids.append(p)
        pmin = bmin[prims].min(axis=0)
        pmax = bmax[prims].max(axis=0)
        cl_rows.append([pmin[0], pmin[1], pmin[2], pmax[0], pmax[1], pmax[2],
                        float(start), float(len(prims))])
    if not sph_rows:  # no real sphere
        sph_rows = [[0, 0, 0, 1e30]]
        orig_ids = [0]
        cl_rows = [[0, 0, 0, 0, 0, 0, 0.0, 1.0]]
    cl = np.array(cl_rows, np.float32)
    centers_g = (cl[:, 0:3] + cl[:, 3:6]) * 0.5
    orders = []
    for oct_id in range(8):
        sign = np.array([1.0 if oct_id & 1 else -1.0,
                         1.0 if oct_id & 2 else -1.0,
                         1.0 if oct_id & 4 else -1.0])
        orders.append(np.argsort(centers_g @ sign, kind="stable"))
    return (
        torch.from_numpy(cl),
        torch.from_numpy(np.array(orders, np.int32)),
        torch.from_numpy(np.array(sph_rows, np.float32)),
        torch.from_numpy(np.array(orig_ids, np.int32)),
    )


def warp_octants(direction):
    """(N,) octant of each ray's warp: the direction signs of the warp's
    first ray (the TPU kernel took the tile's first ray)."""
    first = (torch.arange(direction.shape[0], device=direction.device) // WARP) * WARP
    d0 = direction[first]
    return (d0[:, 0] > 0).long() + 2 * (d0[:, 1] > 0).long() + 4 * (d0[:, 2] > 0).long()


def _slab_enters(box, origin, inv_d, t_best, inv_a):
    """(rays,) bool: the ray enters the AABB `box` (8,) between T_MIN and
    its current best hit (the kernel's slab test)."""
    lo = hi = None
    for k in range(3):
        t0 = (box[k] - origin[:, k]) * inv_d[:, k]
        t1 = (box[3 + k] - origin[:, k]) * inv_d[:, k]
        tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
        lo = tn if lo is None else torch.maximum(lo, tn)
        hi = tf if hi is None else torch.minimum(hi, tf)
    lo = torch.clamp(lo, min=T_MIN)
    hi = torch.minimum(hi, t_best * inv_a)
    return lo < hi


def intersect_culled_plain(clusters, order, sph_cl, orig_ids, quad_table, ns_total: int,
                           origin, direction, *, return_work: bool = False):
    """The TPU kernel's search (its spec; the CUDA kernel walks the
    two-level table instead): for each ray every cluster in its warp's
    octant order (no culling), first minimal scaled-t candidate winning,
    then the quads. Returns (t (N,) float32, prim (N,) int32 global ids:
    spheres 0..ns_total-1, quads after); with `return_work` also (N,)
    int64 sphere tests a perfect per-ray cull would make (the spheres of
    every cluster the ray's own slab test enters)."""
    n = origin.shape[0]
    dev = origin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    work = torch.zeros(n, dtype=torch.int64, device=dev)
    octs = warp_octants(direction)
    cl = clusters.cpu()
    orig = orig_ids.long()
    inv_d = slab_inv(direction)
    for oct_id in torch.unique(octs).tolist():
        rays = torch.nonzero(octs == oct_id).squeeze(1)
        for s in range(0, rays.numel(), PLAIN_CHUNK):
            r = rays[s : s + PLAIN_CHUNK]
            o, d = origin[r], direction[r]
            t_best = torch.full((r.numel(),), INF, dtype=torch.float32, device=dev)
            p_best = torch.full((r.numel(),), -1, dtype=torch.int64, device=dev)
            inv_a = None
            for c in order[oct_id].tolist():
                start, count = int(cl[c, 6]), int(cl[c, 7])
                if return_work:
                    if inv_a is None:
                        inv_a = 1.0 / (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
                    box = clusters[c].to(dev)
                    work[r] += count * _slab_enters(box, o, inv_d[r], t_best, inv_a)
                t_c, p_c, _ = closest_hit_scaled(
                    sph_cl[start : start + count], quad_table[:0], o, d)
                better = t_c < t_best
                t_best = torch.where(better, t_c, t_best)
                p_best = torch.where(better, orig[start + p_c.long()], p_best)
            t_q, p_q, a = closest_hit_scaled(sph_cl[:0], quad_table, o, d)
            better = t_q < t_best
            t_best = torch.where(better, t_q, t_best)
            p_best = torch.where(better, ns_total + p_q.long(), p_best)
            t[r] = t_best * (1.0 / a)
            prim[r] = p_best.to(torch.int32)
    return (t, prim, work) if return_work else (t, prim)


def intersect_culled(clusters, sph_table, quad_table, origin, direction):
    """Cluster-culled closest hit of a coherent ray batch (camera rays in
    pixel order) by the warp-vote cluster walk: (t, prim), as
    ops/intersect_kernel.py:clustered_closest_hit (the twin on CPU tensors,
    the CUDA kernel or an error on CUDA tensors)."""
    global LAUNCHES
    t, prim, launched = clustered_closest_hit("rt_intersect_culled", clusters, sph_table,
                                              quad_table, origin, direction)
    LAUNCHES += launched
    return t, prim
