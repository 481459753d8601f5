"""The span stretch of a traced run: the program's own spans and counters
(raytracer_tpu_torch/utils/trace.py), and the device's work and idle time
put down to them.

The jobs (jobs/) know nothing of the recorder. So the first metric of a
traced run that asks for the stretch (`summary`) runs the cell once more,
with the run's own workload and seed, in a process of its own
(`python3 -m benchmark.spans`): there the job runs as it is, with the
recorder on from its start to its first timed item (the set-up's spans,
`setup`), and when the job starts its device stretch (profiling.py) the
items of that stretch run instead, first with the recorder off under the
profiler's CUDA activity alone, as the job's device stretch runs them
(their operations are not read: that takes the event tree, half a minute
for three train steps), then with the recorder on under torch.profiler
with the host and CUDA activities, and the job stops. The first of the
two also keeps the span stretch from being the process's first profiling
session: in a first session on an H100 the profiler put 0.3-0.8% of the
render cells' device operations under the wrong host operation. A
process of its own keeps the set-up's spans whole (a second set-up in
the traced run's process would find its imports and kernels loaded), and
keeps the traced run's own stretches as they were.

The recorder's spans land on the profiler's timeline as record_function
ranges of their names, so on the card

* each device operation is put down, through the host operation that
  launched it (the profiler's correlation ids, read from its raw
  results), to the innermost program span open when that host operation
  started;
* each idle gap between device operations inside an item is put down to
  the innermost program span open at its midpoint (`outside` where none
  is), as profiling.py's label stretch puts it down to host operations.

The summary, `record.extra["spans"]`, sums over the stretch's items (the
metrics divide by `items`): per span name its count, host, self and device
milliseconds, launches, host syncs and counters (`by_name`); the device
operations, their device milliseconds and the idle milliseconds per span
(`device_ops`, `device_ms`, `idle_ms`); the stretch's idle time read
apart from the gaps, as the items' length less the summed durations of
the device operations that start inside them (`idle_ms_measured`: it
equals the sum of `idle_ms` where the operations neither overlap nor
outlast their item, and each gap got its label); each item's host seconds
(`item_s`), and those of the same items run with the recorder off just
before (`off_item_s`: the cost of tracing on); the set-up's
spans (`setup`); and where the second process's host seconds went
(`seconds`).

The traced runs of a parent commit run these benchmark files over a
program that may have no recorder. There `summary` is None and no second
process runs: the new metrics read None. A recorder that fails to import
raises.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

from benchmark import harness, profiling
from benchmark.profiling import SPAN, merged

OUTSIDE = "outside"
# Seconds the second process may take: a train cell's takes about 55 on the
# card (its set-up, the job's synced steps and the two stretches).
TIMEOUT_S = 900


def has_recorder() -> bool:
    """Whether the program has the span recorder (utils/trace.py); see the
    module docstring."""
    return importlib.util.find_spec("raytracer_tpu_torch.utils.trace") is not None


def by_name(spans: list) -> dict:
    """Totals per span name of the recorder's spans: n, host_ms, self_ms,
    device_ms (where the card timed it), launches, syncs and each counter."""
    out: dict = {}
    for s in spans:
        t = out.setdefault(s["name"], {"n": 0, "host_ms": 0.0, "self_ms": 0.0, "launches": 0,
                                       "syncs": 0})
        t["n"] += 1
        t["host_ms"] += s["host_ms"]
        t["self_ms"] += s["self_ms"]
        t["launches"] += s["launches"]
        t["syncs"] += s["syncs"]
        if s["device_ms"] is not None:
            t["device_ms"] = t.get("device_ms", 0.0) + s["device_ms"]
        for k, v in s["counts"].items():
            t[k] = t.get(k, 0) + v
    return out


def setup_seconds(spans: list) -> dict:
    """Host seconds per span name of the set-up's spans."""
    return {k: v["host_ms"] / 1e3 for k, v in by_name(spans).items()}


def innermost(intervals: list):
    """(starts, labels) of the elementary pieces of the timeline cut by the
    (start, end, name) intervals, each piece labelled with the shortest
    interval that covers it (OUTSIDE where none does), for `label_at`."""
    cuts = sorted({x for s, e, _ in intervals for x in (s, e)})
    starts, labels = [], []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        best, label = float("inf"), OUTSIDE
        for s, e, name in intervals:
            if s <= mid < e and e - s < best:
                best, label = e - s, name
        starts.append(a)
        labels.append(label)
    if cuts:
        starts.append(cuts[-1])
        labels.append(OUTSIDE)
    return starts, labels


def label_at(pieces, t) -> str:
    starts, labels = pieces
    i = bisect.bisect_right(starts, t) - 1
    return labels[i] if i >= 0 else OUTSIDE


class Event(NamedTuple):
    """One event of a profile, from the profiler's raw results: times in
    ns; `corr` its correlation id; `link` that of the host operation a
    device event or a runtime call belongs to (0 for host operations)."""

    name: str
    cpu: bool
    start: int
    end: int
    corr: int
    link: int
    annotation: bool


def events_of(prof) -> list:
    """The profile's events, read from the profiler's raw results rather
    than `prof.events()`, whose event tree takes about a minute to build
    for the profile of three train steps."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        note = getattr(e, "is_user_annotation", None)
        out.append(Event(e.name(), e.device_type() == DeviceType.CPU, e.start_ns(),
                         e.start_ns() + e.duration_ns(), e.correlation_id(),
                         e.linked_correlation_id(), bool(note()) if note else False))
    return out


def attribute(events: list, names: set) -> dict:
    """Device operations, their device ms and idle gaps put down to the
    innermost program span `names` (see the module docstring), and the
    measured idle time, from the events of items each inside a `SPAN`
    range. A device operation belongs to the host operation whose
    correlation id it links (the first, where two share one); those
    linked to none (the ctypes launches of the program's own kernels
    among them) are `unlinked`."""
    cpu = [e for e in events if e.cpu]
    pieces = innermost([(e.start, e.end, e.name) for e in cpu if e.name in names])
    items = merged([(e.start, e.end) for e in cpu if e.name == SPAN])
    host: dict = {}
    for e in cpu:
        if not e.link and e.corr not in host:
            host[e.corr] = e
    device = [e for e in events if not e.cpu and not e.annotation and e.name != SPAN
              and e.name not in names]
    ops_n: dict = {}
    ops_ms: dict = {}
    for e in device:
        h = host.get(e.link) if e.link else None
        label = "unlinked" if h is None else label_at(pieces, h.start)
        ops_n[label] = ops_n.get(label, 0) + 1
        ops_ms[label] = ops_ms.get(label, 0.0) + (e.end - e.start) / 1e6
    busy = merged([(e.start, e.end) for e in device])
    idle: dict = {}
    for lo, hi in items:
        inside = [(max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi]
        edges = [lo] + [x for iv in inside for x in iv] + [hi]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                label = label_at(pieces, 0.5 * (s + e))
                idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    return {"device_ops": ops_n, "device_ms": ops_ms, "idle_ms": idle,
            "idle_ms_measured": measured_idle_ms(items, device)}


def measured_idle_ms(items: list, device: list) -> float:
    """The items' length less the summed durations of the device operations
    that start inside an item, in ms: the idle time read without the gaps
    that `attribute` labels."""
    starts = [lo for lo, _ in items]
    busy = 0
    for e in device:
        i = bisect.bisect_right(starts, e.start) - 1
        if i >= 0 and e.start < items[i][1]:
            busy += e.end - e.start
    return (sum(hi - lo for lo, hi in items) - busy) / 1e6


def stretch(run_item, n: int, cuda: bool) -> dict:
    """Run `run_item()` n times with the program's recorder on, under the
    profiler's host and CUDA activities on the card (no profiler on the
    CPU); the stretch's part of the summary (module docstring), with the
    host seconds of its items, of stopping the profiler and of the
    attribution (`seconds`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from raytracer_tpu_torch.utils import trace

    spans, item_s = [], []

    def items():
        for _ in range(n):
            t0 = time.perf_counter()
            with record_function(SPAN):
                run_item()
            item_s.append(time.perf_counter() - t0)
            spans.extend(trace.collect())

    trace.collect()
    trace.enable()
    t0 = time.perf_counter()
    try:
        if cuda:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                items()
                t1 = time.perf_counter()
        else:
            items()
            t1 = time.perf_counter()
    finally:
        trace.disable()
    t2 = time.perf_counter()
    out = {"cuda": cuda, "items": n, "item_s": item_s, "by_name": by_name(spans)}
    if cuda:
        out.update(attribute(events_of(prof), set(out["by_name"])))
    out["seconds"] = {"items": t1 - t0, "profiler_stop": t2 - t1,
                      "attribute": time.perf_counter() - t2}
    return out


class Stop(Exception):
    """Ends the job once its span stretch has run; carries the summary."""

    def __init__(self, summary: dict):
        super().__init__("span stretch done")
        self.summary = summary


class SetupEnds(harness.Context):
    """The job's context: when the job sets `setup_s` at its first timed
    item, the recorder goes off and the set-up's spans are kept
    (`setup_spans`)."""

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name == "setup_s" and not math.isnan(value):
            from raytracer_tpu_torch.utils import trace

            trace.disable()
            super().__setattr__("setup_spans", setup_seconds(trace.collect()))


def run_job(workload: str, seed: int, device: str) -> dict:
    """Run the cell's job with the recorder on through its set-up; in place
    of its device stretch, its items with the recorder off, then with it on
    (`stretch`); the summary (module docstring)."""
    import torch

    from raytracer_tpu_torch.utils import trace

    if device == "cuda":
        torch.cuda.init()
    cell = harness.Cell.load(workload, cpu=device == "cpu")
    ctx = SetupEnds(cell=cell, seed=seed, seconds=0.0, trace=True, device=device,
                    start=time.perf_counter())
    job = importlib.import_module(f"benchmark.jobs.{cell.workload['job']}")
    device_stretch = profiling.device_stretch

    def then_spans(run_item, n, cuda):
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) if cuda else contextlib.nullcontext():
            off = device_stretch(run_item, n, False)  # its operations are not read
        t1 = time.perf_counter()
        out = stretch(run_item, n, cuda)
        out["seconds"].update(setup=ctx.setup_s, off_stretch=t1 - t0)
        raise Stop({**out, "setup": ctx.setup_spans, "off_item_s": off.spans_s})

    profiling.device_stretch = then_spans
    trace.enable()
    try:
        job.run(ctx)
    except Stop as done:
        return done.summary
    finally:
        trace.disable()
        profiling.device_stretch = device_stretch
    raise RuntimeError(f"job {cell.workload['job']} ran no device stretch")


def summary(rec):
    """The span stretch's summary of this traced run (module docstring),
    run once and kept in `rec.extra["spans"]`, with a `spans {...}` line on
    standard error. None where the program has no recorder, on the CPU, and
    outside a run of benchmark.run (whose workload and seed it takes)."""
    if "spans" in rec.extra:
        return rec.extra["spans"]
    main = sys.modules.get("__main__")
    if getattr(getattr(main, "__spec__", None), "name", None) != "benchmark.run":
        return None
    args = main.parse(sys.argv[1:])
    if args.device != "cuda" or not args.trace or not has_recorder():
        return None
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.spans", "--workload", args.workload,
         "--seed", str(args.seed), "--device", args.device],
        cwd=harness.REPO, capture_output=True, text=True, timeout=TIMEOUT_S, check=False)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the span stretch failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    rec.extra["spans"] = json.loads(lines[-1])
    print("spans " + json.dumps(rec.extra["spans"]), file=sys.stderr)
    return rec.extra["spans"]


def per_item(rec, name: str, key: str):
    """`key` of the span `name` (`by_name`) over the stretch's items; None
    where the record has no stretch or the span no such number."""
    s = summary(rec)
    t = s["by_name"].get(name) if s else None
    return None if t is None or t.get(key) is None else t[key] / s["items"]


def syncs_per_item(rec, names: tuple):
    """Host syncs inside the spans `names` over the stretch's items; None
    without a card (the CPU has no syncs to count) or without the spans."""
    s = summary(rec)
    if not s or not s["cuda"] or not any(n in s["by_name"] for n in names):
        return None
    return sum(s["by_name"][n]["syncs"] for n in names if n in s["by_name"]) / s["items"]


def device_per_item(rec, key: str, name: str):
    """The device trace's `key` (`device_ops`, `device_ms` or `idle_ms`) put
    down to the span `name`, over the stretch's items; None without a card
    or where the span never ran."""
    s = summary(rec)
    if not s or key not in s or name not in s["by_name"]:
        return None
    return s[key].get(name, 0) / s["items"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a cell's span stretch; print its summary.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run_job(args.workload, args.seed, args.device)
    out["seconds"]["run_job"] = time.perf_counter() - t0
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
