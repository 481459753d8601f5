"""Seconds a step spends in its `edges/boundary` phase (the primary
silhouettes, diff/boundary.py), by the program's phase clock
(utils/trace.py:phase, which syncs the card at the phase's end), averaged
over the traced steps."""


def read(rec):
    t = [x["edges/boundary"] for x in rec.extra.get("timings", []) if "edges/boundary" in x]
    return sum(t) / len(t) if t else None
