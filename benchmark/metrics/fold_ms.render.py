"""Stream milliseconds an image spends between the two CUDA events of the
program's `render/fold` span (utils/trace.py: integrator/wavefront.py:
_fold_log folding the retirement log into the framebuffer), averaged over
the span stretch's images (benchmark/spans.py)."""

from benchmark.spans import per_item


def read(rec):
    return per_item(rec, "render/fold", "device_ms")
