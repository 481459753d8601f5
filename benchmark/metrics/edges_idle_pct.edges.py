"""The device's idle share, in %, while the step's edge terms run: the idle
gaps of the span stretch's profile put down to `edges` or a span under it
(`edges/<name>`, `edges/<name>/sample`, `/trace`, `/splat`; benchmark/
spans.py: each gap to the innermost span open at its midpoint), over the
host time of the `edges` spans, the window in which one of them is the
innermost span open."""

from benchmark.spans import summary


def read(rec):
    s = summary(rec)
    if not s or "idle_ms" not in s or "edges" not in s["by_name"]:
        return None
    idle = sum(v for k, v in s["idle_ms"].items() if k == "edges" or k.startswith("edges/"))
    return 100.0 * idle / s["by_name"]["edges"]["host_ms"]
