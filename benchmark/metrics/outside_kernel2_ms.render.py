"""Milliseconds of an image outside kernel 2: the host clock around each
image of the device stretch (render_image's packing, chunk loop, fold and
mean, then to_u8 and the copy to the host) less kernel 2's device time,
averaged over its images."""

from benchmark.profiling import KERNEL2


def read(rec):
    k2 = rec.per_item_s(KERNEL2)
    return None if k2 is None else (sum(rec.spans_s) / rec.items - k2) * 1e3
