"""Device operations an image launches inside the program's `render/fold`
span: each device operation of the span stretch's profile put down,
through the host operation that launched it, to the innermost program
span (benchmark/spans.py), counted over the stretch's images."""

from benchmark.spans import device_per_item


def read(rec):
    return device_per_item(rec, "device_ops", "render/fold")
