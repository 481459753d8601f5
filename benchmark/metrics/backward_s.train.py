"""Seconds a step spends in its `backward` phase, by the program's phase
clock (diff/bucketed.py:PhaseClock, which syncs the card at each phase's
end), averaged over the traced steps."""


def read(rec):
    t = [x["backward"] for x in rec.extra.get("timings", []) if "backward" in x]
    return sum(t) / len(t) if t else None
