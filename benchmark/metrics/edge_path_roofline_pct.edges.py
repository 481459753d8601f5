"""The edge path kernel's share of its roofline in the edge terms, in %: the
least time the card could take for the closest hits the kernel
(raytracer_tpu_torch/csrc/edge_path_kernel.cu) traced a step over its
device time a step. Its lane-bounces are the `edge_path_segments` counter
of diff/boundary.py:trace_edge_rays in each `edges/<name>/trace` span of
the span stretch; each a closest hit over the scene's spheres and quads
(benchmark/peaks.py; shading not counted, so the share reads low), its ray
read and its winner written once, the tables read once. None where the
kernel did not run (a program that traces the edges otherwise). The card's
power limit is on the run's `card` line."""

from benchmark import peaks
from benchmark.spans import summary

KERNEL = "edge_path_kernel"
RAY_BYTES = 32  # origin and direction in, t and primitive out


def read(rec):
    device_s, s, x = rec.per_item_s(KERNEL), summary(rec), rec.extra
    traces = [v for k, v in (s or {}).get("by_name", {}).items()
              if k.startswith("edges/") and k.endswith("/trace")]
    segs = sum(v.get("edge_path_segments", 0) for v in traces)
    if device_s is None or not segs:
        return None
    segs /= s["items"]
    ns, nq = x["spheres"], x["quads"]
    nbytes = segs * RAY_BYTES + ns * peaks.SPHERE_BYTES + nq * peaks.QUAD_BYTES
    return 100.0 * peaks.least_seconds(peaks.hit_ops(segs, ns, nq), nbytes) / device_s
