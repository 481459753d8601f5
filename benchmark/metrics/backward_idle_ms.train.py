"""Device idle milliseconds a train step spends while the program's
`backward` phase (autograd's backward through the replay,
diff/bucketed.py:replay_grads) is the innermost program span open: the
idle gaps of the span stretch's profile put down as for
replay_idle_ms.train (benchmark/spans.py), averaged over its steps."""

from benchmark.spans import device_per_item


def read(rec):
    return device_per_item(rec, "idle_ms", "backward")
