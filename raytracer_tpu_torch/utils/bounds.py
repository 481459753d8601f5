"""Least-time bounds of the port's kernels on an H100: the larger of the
operations a call needs over the card's FP32 rate and the bytes it must
move over its memory rate (chip_smoke.py's per-kernel record,
utils/cull_work.py).

Operations are the FP32 arithmetic of csrc/closest_hit.cuh and the cluster
walk of csrc/cluster_walk.cuh, counted from the source (compares and
selects not counted, a multiply-add as two operations: contraction is off).
Where a loop skips work on the data, the culled bounds count what the
call's data needs, from the twin's counts (ops/cluster_visit.py:
ClusterVisit.hit_work).
"""

from __future__ import annotations

# NVIDIA's published H100 SXM peaks at 700 W: FP32 outside the tensor cores,
# and HBM bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# One whole closest-hit candidate, and the per-ray terms. Shading adds about
# 1% per segment at rand_spheres' 490 rows and is not counted.
SPHERE_OPS = 21
QUAD_OPS = 40
RAY_OPS = 15
# The parts of a candidate: a sphere's discriminant (every row tested) and
# its root and compare chain (rows whose discriminant is >= 0); a quad's
# plane terms d.n, o.n and num (every row), its division and t * a (rows
# whose plane faces the ray), and its in-quad coordinates (rows whose t can
# still win).
SPHERE_DISC_OPS = 17
SPHERE_ROOT_OPS = SPHERE_OPS - SPHERE_DISC_OPS
QUAD_PLANE_OPS = 11
QUAD_DIV_OPS = 2
QUAD_INQUAD_OPS = 26
# One cluster slab test (six subtracts, six multiplies, ten min/max, the
# running-best rescale), and a segment's three slab reciprocals.
SLAB_OPS = 23
SLAB_INV_OPS = 3
# Lanes of a warp: one issue of a warp's instruction.
WARP = 32


def hit_ops(segments, ns, nq):
    """Closest-hit FP32 operations of `segments` rays over ns spheres and nq
    quads, every candidate whole."""
    return float(segments) * (ns * SPHERE_OPS + nq * QUAD_OPS + RAY_OPS)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _walk_ops(steps, counts):
    """Operations of `steps` ray segments and a ClusterVisit work vector
    (slab, sphere, quad tests, roots, divisions, in-quad tests)."""
    slab, sph, quad, roots, divs, in_quad = (float(c) for c in counts[:6])
    return (float(steps) * (RAY_OPS + SLAB_INV_OPS) + slab * SLAB_OPS + sph * SPHERE_DISC_OPS
            + roots * SPHERE_ROOT_OPS + quad * QUAD_PLANE_OPS + divs * QUAD_DIV_OPS
            + in_quad * QUAD_INQUAD_OPS)


def culled_bytes(log_bytes, lanes, cluster_rows, ns, nq):
    """Bytes a culled kernel-2 call must move: its log, the schedule and
    segments (16 a lane), the cluster rows, and the primitive and material
    tables."""
    return (log_bytes + 16 * lanes + 32 * sum(cluster_rows) + (16 + 64) * ns
            + (48 + 64) * nq)


def clustered_hit_bytes(rays, cluster_rows, ns, nq):
    """Bytes a clustered closest-hit call (kernel 1's clustered entry,
    kernel 4) must move: each ray's origin and direction read and its t and
    prim written (32), the cluster rows, and the sphere and quad tables."""
    return 32 * rays + 32 * cluster_rows + 16 * ns + 48 * nq


def culled_bounds(segments, work, warp_work, nbytes):
    """A culled walk's bounds from its twin's counts on the same call
    (kernel 2: regen_plain(return_work=True); kernels 1 and 4:
    ClusterVisit.hit_work, with `segments` their rays): `work` the six
    per-lane totals, `warp_work` the six warp-union totals and the warp
    steps:

    * "per_lane": (bound_ms, bound_by) of perfect per-lane culling, every
      lane paying only its own tests;
    * "warp_union": the same where each warp pays, for all its 32 lanes,
      the union of its lanes' tests (a warp runs a loop while any lane is
      in it, per lane or under csrc/cluster_walk.cuh's warp vote);
    * "simt_efficiency": per-lane operations over warp-union operations."""
    lane_ops = _walk_ops(segments, work)
    warp_ops = WARP * _walk_ops(warp_work[6], warp_work)
    return dict(per_lane=bound(lane_ops, nbytes), warp_union=bound(warp_ops, nbytes),
                simt_efficiency=lane_ops / warp_ops, lane_ops=lane_ops, warp_ops=warp_ops)
