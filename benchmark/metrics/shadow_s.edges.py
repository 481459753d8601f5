"""Seconds a step spends in its `edges/shadow` phase (the first-bounce
shadow edges, diff/shadow_edge.py), by the program's phase clock
(utils/trace.py:phase, which syncs the card at the phase's end), averaged
over the traced steps."""


def read(rec):
    t = [x["edges/shadow"] for x in rec.extra.get("timings", []) if "edges/shadow" in x]
    return sum(t) / len(t) if t else None
