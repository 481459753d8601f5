"""Host-device synchronisations an image makes on rank 0 inside the
program's root spans `render_image_sharded` and `to_u8` (utils/trace.py's
sync counter: PyTorch's CUDA sync debug mode), averaged over the span
stretch's images (jobs/render_sharded.py); None on the CPU."""

from benchmark.spans import syncs_per_item


def read(rec):
    return syncs_per_item(rec, ("render_image_sharded", "to_u8"))
