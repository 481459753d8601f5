"""Kernel 1's share of its roofline in the edge terms, in %: the least time
the card could take for the closest hits kernel 1 ran a step over its
device time a step. Every kernel-1 launch of this cell lies inside the
edge terms (the tape forward is kernel 3, the replay its own kernels), so
its device time is that of its operations in the device stretch. Its rays
are those the edge traces' bounces took (the `lanes` counter of
integrator/wavefront.py:_trace_loop in each `edges/<name>/trace` span of
the span stretch) and the shadow term's receivers, one camera ray a pixel;
each a closest hit over the scene's spheres and quads (benchmark/peaks.py;
shading not counted, so the share reads low), its ray read and its winner
written once. The card's power limit is on the run's `card` line."""

from benchmark import peaks
from benchmark.spans import summary

KERNEL1 = "intersect_kernel"
RAY_BYTES = 32  # origin and direction in, t and primitive out


def read(rec):
    k1, s, x = rec.per_item_s(KERNEL1), summary(rec), rec.extra
    traces = [v for k, v in (s or {}).get("by_name", {}).items()
              if k.startswith("edges/") and k.endswith("/trace")]
    if k1 is None or not traces:
        return None
    lanes = sum(v.get("lanes", 0) for v in traces)
    rays = lanes / s["items"] + x["receiver_rays"]
    ns, nq = x["spheres"], x["quads"]
    nbytes = rays * RAY_BYTES + ns * peaks.SPHERE_BYTES + nq * peaks.QUAD_BYTES
    return 100.0 * peaks.least_seconds(peaks.hit_ops(rays, ns, nq), nbytes) / k1
