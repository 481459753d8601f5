"""Device operations a step launches inside the edge terms: those of the
span stretch's profile put down, through the host operation that launched
them, to `edges` or a span under it (benchmark/spans.py), per step. The
terms' spans under `edges/<name>` open where autograd runs the terms'
backward, on its device thread, and their operations land under them by
time like any other."""

from benchmark.spans import summary


def read(rec):
    s = summary(rec)
    if not s or "device_ops" not in s or "edges" not in s["by_name"]:
        return None
    return sum(v for k, v in s["device_ops"].items()
               if k == "edges" or k.startswith("edges/")) / s["items"]
