"""Seconds of the set-up's `build` span: the program's
diff/grad.py:make_inverse_renderer building the train step (utils/trace.py),
recorded from the job's start to its first timed step in the span
stretch's process (benchmark/spans.py)."""

from benchmark.spans import summary


def read(rec):
    setup = (summary(rec) or {}).get("setup") or {}
    return setup.get("build")
