"""Host-device synchronisations a train step makes inside the program's
root span `step` (utils/trace.py's sync counter: PyTorch's CUDA sync debug
mode; a backward's count toward it), averaged over the span stretch's
steps (benchmark/spans.py); None on the CPU."""

from benchmark.spans import syncs_per_item


def read(rec):
    return syncs_per_item(rec, ("step",))
