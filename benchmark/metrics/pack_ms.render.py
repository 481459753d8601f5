"""Host milliseconds an image spends in the program's `render/pack` span
(utils/trace.py: render/driver.py:chunk_renderer packing the scene's
tables, the camera scalars and the textures), averaged over the span
stretch's images (benchmark/spans.py)."""

from benchmark.spans import per_item


def read(rec):
    return per_item(rec, "render/pack", "host_ms")
