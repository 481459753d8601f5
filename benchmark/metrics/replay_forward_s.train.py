"""Seconds a step spends in its `replay_forward` phase, by the program's phase
clock (diff/bucketed.py:PhaseClock, which syncs the card at each phase's
end), averaged over the traced steps."""


def read(rec):
    t = [x["replay_forward"] for x in rec.extra.get("timings", []) if "replay_forward" in x]
    return sum(t) / len(t) if t else None
