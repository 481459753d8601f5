"""The fastest rank's wait at the framebuffer's all-reduce, in ms: per
image of the span stretch, the largest less the smallest over the ranks of
that rank's `render/all_reduce` stream time (each rank's spans brought to
rank 0 by utils/trace.py:gather; jobs/render_sharded.py), averaged over the
images. None where the ranks' spans, the span or its stream time (none on
the CPU) are missing."""


def read(rec):
    ranks = (rec.extra.get("spans") or {}).get("ranks") or []
    per_rank = [[t["render/all_reduce"].get("device_ms") for t in items if "render/all_reduce" in t]
                for items in ranks]
    if (not per_rank or not per_rank[0] or len({len(r) for r in per_rank}) != 1
            or any(ms is None for r in per_rank for ms in r)):
        return None
    waits = [max(ms) - min(ms) for ms in zip(*per_rank)]
    return sum(waits) / len(waits)
