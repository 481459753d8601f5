"""Rank 0's kernel 2 against its roofline, in %: the least time the card
could take for rank 0's share of an image's work over kernel 2's device
time per image on rank 0. The work is rank 0's camera samples (its share
of every chunk) times the configuration's segments_per_sample, each
segment a closest hit over every sphere and quad (benchmark/peaks.py;
shading not counted, so the share reads low), and the bytes those
samples' radiance written and the tables read once: what
kernel2_roofline_pct.render reads of a whole image."""

from benchmark import peaks
from benchmark.profiling import KERNEL2


def read(rec):
    k2, x = rec.per_item_s(KERNEL2), rec.extra
    if k2 is None or x.get("work", {}).get("segments_per_sample") is None:
        return None
    ns, nq = x["spheres"], x["quads"]
    ops = peaks.hit_ops(x["samples"] * x["work"]["segments_per_sample"], ns, nq)
    nbytes = (x["samples"] * peaks.SAMPLE_BYTES + ns * peaks.SPHERE_BYTES
              + nq * peaks.QUAD_BYTES + (ns + nq) * peaks.SHADING_BYTES)
    return 100.0 * peaks.least_seconds(ops, nbytes) / k2
