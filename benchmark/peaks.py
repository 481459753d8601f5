"""Published peaks of one NVIDIA H100 SXM at 700 W, and the FP32 work of
the renderer's closest hit, frozen for the roofline metrics.

Peaks (NVIDIA's data sheet, dense): 67 TFLOP/s FP32 outside the tensor
cores, 3.35 TB/s HBM3. A closest-hit candidate costs, counted from the
kernel's source with a multiply-add as two operations: a sphere 21 (17
for its discriminant, 4 for a root and compare), a quad 40 (its plane
terms, the division and the in-quad coordinates), and 15 a ray for its
own terms. Shading is not counted: about
1% a segment beside rand_spheres' 488 spheres, a larger share beside
cornell's 18 quads, so the roofline shares read low by that much.
"""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SPHERE_OPS = 21
QUAD_OPS = 40
RAY_OPS = 15
# Bytes of a table row: a sphere (float4), a quad (3 float4), a shading
# row (4 float4); and of one retired sample's radiance (3 float32).
SPHERE_BYTES, QUAD_BYTES, SHADING_BYTES, SAMPLE_BYTES = 16, 48, 64, 12


def hit_ops(segments: float, ns: int, nq: int) -> float:
    """FP32 operations of `segments` closest hits over ns spheres, nq quads."""
    return float(segments) * (ns * SPHERE_OPS + nq * QUAD_OPS + RAY_OPS)


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of operations over the FP32 peak and bytes over HBM's."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)
