"""Kernel 2's warp occupancy: the program's RenderMetrics count of traced
segments over the warp slots their 32-lane warps ran, averaged over the
two images rendered with it after the profiled stretches."""


def read(rec):
    occ = rec.extra.get("occupancy", [])
    return sum(occ) / len(occ) if occ else None
