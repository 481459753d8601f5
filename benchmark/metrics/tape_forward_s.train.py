"""Seconds a step spends in its `tape_forward` phase, by the program's phase
clock (diff/bucketed.py:PhaseClock, which syncs the card at each phase's
end), averaged over the traced steps."""


def read(rec):
    t = [x["tape_forward"] for x in rec.extra.get("timings", []) if "tape_forward" in x]
    return sum(t) / len(t) if t else None
