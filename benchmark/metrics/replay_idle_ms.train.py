"""Device idle milliseconds a train step spends while the program's
`replay_forward` phase (diff/bucketed.py:replay_grads) is the innermost
program span open: the idle gaps between device operations of the span
stretch's profile, each put down to the innermost span at its midpoint
(benchmark/spans.py), averaged over the stretch's steps."""

from benchmark.spans import device_per_item


def read(rec):
    return device_per_item(rec, "idle_ms", "replay_forward")
