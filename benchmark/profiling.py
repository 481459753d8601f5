"""What a traced run measures, reduced to what the per-layer metrics read.

A traced run has three stretches of whole items (images or steps), one
after another, so that each measures with the least disturbance:

* the device stretch, under torch.profiler with the CUDA activity alone
  (no host operations recorded, so the host runs at its own pace): the
  device operations (kernels, copies, fills) as intervals, and each
  item's host-clock seconds. The device is busy for the union of its
  operations' intervals, and the stretch's window runs from the first
  operation's start to the last one's end;
* the label stretch, under the profiler with the host activity too: the
  idle gaps between device operations, each summed under the innermost
  host operation that spans it (`python` where none does), for the
  result's breakdown;
* a job's own stretch for the program's counters and phase clock (jobs/).

Times from the profiler are its microseconds.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

SPAN = "bench.item"
TOP = 10
# Kernel 2, the render kernel (csrc/persistent_kernel.cu's
# persistent_kernel<false, ...>), as the trace names it.
KERNEL2 = "persistent_kernel<false"
# Host events scanned back from a gap for the innermost one around it.
LABEL_SCAN = 256
# A device operation's name in the breakdown: without these prefixes, cut
# to this length.
NAME_PREFIXES = ("void ", "at::native::", "(anonymous namespace)::")
NAME_CHARS = 120


def short(name: str) -> str:
    for prefix in NAME_PREFIXES:
        name = name.replace(prefix, "")
    return name[:NAME_CHARS]


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


@dataclass
class TraceRecord:
    """The device stretch's operations and item times, the label
    stretch's idle gaps, and the job's counters (`extra`)."""

    device_ops: list = field(default_factory=list)  # (name, start, end)
    spans_s: list = field(default_factory=list)  # host seconds of each item
    idle_gaps: list = field(default_factory=list)  # [[host operation, seconds], ...]
    extra: dict = field(default_factory=dict)

    @property
    def items(self) -> int:
        return len(self.spans_s)

    @property
    def window_s(self) -> float:
        if not self.device_ops:
            return 0.0
        return (max(e for _, _, e in self.device_ops)
                - min(s for _, s, _ in self.device_ops)) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged([(s, e) for _, s, e in self.device_ops])) / 1e6

    def per_item_s(self, name_part: str):
        """Device seconds per item of the operations whose name holds
        `name_part`, or None where there are none."""
        total = sum(e - s for n, s, e in self.device_ops if name_part in n) / 1e6
        return total / self.items if total > 0 and self.items else None

    def idle_pct(self):
        """100 * (1 - busy / window), or None where nothing ran."""
        if self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        by_name: dict = {}
        for n, s, e in self.device_ops:
            by_name[short(n)] = by_name.get(short(n), 0.0) + (e - s) / 1e6
        return {"device_ops": top(by_name), "idle_gaps": self.idle_gaps}


def device_stretch(run_item, n: int, cuda: bool) -> TraceRecord:
    """Run `run_item()` n times under the profiler's CUDA activity (none on
    the CPU); the record of its device operations and item times."""
    from torch.profiler import ProfilerActivity, profile

    rec = TraceRecord()

    def items():
        for _ in range(n):
            t0 = time.perf_counter()
            run_item()
            rec.spans_s.append(time.perf_counter() - t0)

    if not cuda:
        items()
        return rec
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        items()
    rec.device_ops = device_ops(prof)
    return rec


def device_ops(prof) -> list:
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type != DeviceType.CPU and not getattr(e, "is_user_annotation", False)
            and e.name != SPAN]


def label_stretch(run_item, n: int, cuda: bool) -> list:
    """Run `run_item()` n times under the profiler's host and CUDA
    activities; the idle gaps of the items' spans, summed by the innermost
    host operation around each ([] on the CPU)."""
    if not cuda:
        return []
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function(SPAN):
                run_item()
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    host = sorted(((e.name, e.time_range.start, e.time_range.end) for e in cpu
                   if e.name != SPAN), key=lambda x: x[1])
    spans = merged([(e.time_range.start, e.time_range.end) for e in cpu if e.name == SPAN])
    busy = merged([(s, e) for _, s, e in device_ops(prof)])
    starts = [s for _, s, _ in host]
    by_label: dict = {}
    for lo, hi in spans:
        inside = [(max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi]
        edges = [lo] + [x for iv in inside for x in iv] + [hi]
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid, label, best = 0.5 * (s + e), "python", float("inf")
            i = bisect.bisect_right(starts, mid)
            for name, hs, he in host[max(0, i - LABEL_SCAN):i]:
                if he >= mid and he - hs < best:
                    label, best = name, he - hs
            by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e6
    return top(by_label)
