"""Stream milliseconds an image spends in rank 0's `render/all_reduce`
spans (parallel/shard.py:render_image_sharded: the framebuffer's
all-reduce over the ranks, one a chunk), between each span's two CUDA
events: the transfer and rank 0's wait for the slowest rank, summed over
the image's chunks and averaged over the span stretch's images
(jobs/render_sharded.py)."""

from benchmark.spans import per_item


def read(rec):
    return per_item(rec, "render/all_reduce", "device_ms")
