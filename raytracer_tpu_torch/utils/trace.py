"""Spans and counters inside the port, on the profiler's clock.

The recorder is off by default. `enable()` turns it on, `disable()` off,
and `collect()` returns the spans finished since the last `collect()` and
forgets them. The program opens spans at its layer boundaries:

    with trace.span("render/fold"):
        fb = _fold_log(...)

Off, `span(name)` returns one shared no-op context: the cost is a flag
read, with no allocation, no record_function and no CUDA event. On, a span
records

* its name, its id, its parent's id (a stack per thread) and its item: the
  id of the outermost span open around it. The entry points open the
  roots (`render_image` per image, `to_u8`, `step` per train step), so
  every span of one image or step shares that identifier;
* host start and end (`time.perf_counter_ns`);
* a pair of CUDA timing events recorded on the current stream at entry
  and exit, never waited on inside the span: `collect()` resolves them
  after one device sync (none on a machine without a card);
* the deltas over the span of the port's kernel launches
  (utils/launches.py's counters), of host syncs (below) and of the
  counters that `count(key, n)` adds to every open span of the thread
  (`n` an int, or a one-element tensor that `collect()` reads after its
  device sync, so counting a device value syncs nothing inside the span);
* a `torch.profiler.record_function(name)` over its extent, so that under
  any profiler the span lands on the profiler's own timeline beside the
  device activity, and an idle gap or a kernel can be put down to the
  innermost program span open at that moment.

Host syncs are counted by PyTorch's CUDA sync debug mode: while the
recorder is on, `torch.cuda.set_sync_debug_mode("warn")` makes every
synchronising call (`item`, `nonzero`, boolean-mask indexing, copies to
the host, synchronous copies from it) warn, and a filter that sees every
such warning and prints none counts it. `disable()` restores the previous
mode, warning filters and `warnings.showwarning`. An explicit
`torch.cuda.synchronize()` does not warn and is not counted. Autograd
replays the warnings of its device threads on the calling thread when a
backward ends, so the syncs of a backward count toward the span around
it (the train step's `backward`).

Across ranks, `gather(spans)` brings each rank's collected spans to rank 0
over the default process group (a collective, run outside timed work), so
that one rank can compare the ranks' spans item by item.

`phase(name, timings, device)` is a span that, given a `timings` dict,
ends with a device sync and adds its wall seconds to `timings[name]`
(and to each of `also`): the synced phase times of the train steps'
`timings` argument, whether or not the recorder is on. Without `timings`
nothing syncs.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import re
import threading
import time
import warnings

import torch
import torch.distributed as dist

# The text of the warning PyTorch's sync debug mode gives at every sync.
SYNC_WARNING = "called a synchronizing CUDA operation"

_NULL = contextlib.nullcontext()


class _Recorder:
    """The process's recorder: the switch, the open spans of each thread,
    the finished spans and the host-sync count."""

    def __init__(self):
        self.on = False
        self.local = threading.local()
        self.finished: list = []
        self.ids = itertools.count(1)
        self.syncs = 0
        self.cuda = False
        self.launches = None
        self.mode = None  # the sync debug mode to restore
        self.warnings = None  # the warnings.catch_warnings() that restores the filters
        self.passthrough = None  # the warnings.showwarning found on enable()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def launch_count(self) -> int:
        return sum(self.launches.read().values())

    def show(self, message, category, filename, lineno, file=None, line=None):
        """warnings.showwarning while on: count the sync warnings, pass the
        rest to the hook that was there before."""
        if SYNC_WARNING in str(message):
            self.syncs += 1
            return
        self.passthrough(message, category, filename, lineno, file, line)


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "id", "parent", "item", "t0", "t1", "ev0", "ev1", "launches",
                 "syncs", "counts", "pending", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        stack = rec.stack()
        self.id = next(rec.ids)
        self.parent = stack[-1].id if stack else None
        self.item = stack[0].item if stack else self.id
        self.counts = {}
        self.pending = []  # (key, one-element tensor) read by collect()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.launches = rec.launch_count()
        self.syncs = rec.syncs
        self.ev0 = self.ev1 = None
        if rec.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = _REC
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        stack = rec.stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.launches = rec.launch_count() - self.launches
        self.syncs = rec.syncs - self.syncs
        self.rf.__exit__(*exc)
        self.rf = None
        rec.finished.append(self)
        return False


class _Phase:
    """A span that adds its wall seconds, ended by a device sync, to a
    timings dict under its name and `also`."""

    def __init__(self, name: str, timings: dict, device, also: tuple):
        self.keys = (name, *also)
        self.timings = timings
        self.device = torch.device(device) if device is not None else None
        self.span = span(name)

    def __enter__(self):
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self.t0
        for key in self.keys:
            self.timings[key] = self.timings.get(key, 0.0) + dt
        return self.span.__exit__(*exc)


def span(name: str):
    """A context manager timing `name` when the recorder is on; the shared
    no-op context when it is off."""
    if not _REC.on:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorator: the function runs inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def phase(name: str, timings: dict | None = None, device=None, also: tuple = ()):
    """`span(name)`; with a `timings` dict, also a synced phase clock: at
    its end the phase syncs `device` (when it is a CUDA device) and adds
    its wall seconds under `name` and each key of `also`."""
    if timings is None:
        return span(name)
    return _Phase(name, timings, device, also)


def enabled() -> bool:
    """Whether the recorder is on: work done only to feed a counter is
    skipped when it is off."""
    return _REC.on


def count(key: str, n=1) -> None:
    """Add `n` to counter `key` of every span open on this thread (no-op
    when the recorder is off). `n` is an int, or a one-element tensor
    whose value `collect()` reads after its device sync."""
    if not _REC.on:
        return
    for s in _REC.stack():
        if isinstance(n, torch.Tensor):
            s.pending.append((key, n))
        else:
            s.counts[key] = s.counts.get(key, 0) + n


def enable() -> None:
    """Turn the recorder on (and PyTorch's sync debug mode to "warn" on a
    machine with a card); a no-op when it is on."""
    rec = _REC
    if rec.on:
        return
    from raytracer_tpu_torch.utils import launches

    rec.launches = launches
    rec.cuda = torch.cuda.is_available()
    rec.mode = torch.cuda.get_sync_debug_mode() if rec.cuda else None
    rec.warnings = warnings.catch_warnings()
    rec.warnings.__enter__()
    rec.passthrough = warnings.showwarning
    warnings.filterwarnings("always", message=".*" + re.escape(SYNC_WARNING))
    warnings.showwarning = rec.show
    if rec.cuda:
        torch.cuda.set_sync_debug_mode("warn")
    rec.on = True


def disable() -> None:
    """Turn the recorder off and restore the sync debug mode, the warning
    filters and `warnings.showwarning` it found; a no-op when it is off.
    Finished spans stay until `collect()`."""
    rec = _REC
    if not rec.on:
        return
    rec.on = False
    if rec.mode is not None:
        torch.cuda.set_sync_debug_mode(rec.mode)
    rec.warnings.__exit__(None, None, None)
    rec.warnings = rec.passthrough = None


def collect() -> list[dict]:
    """The spans finished since the last call, in the order they ended, as
    dicts, and forget them. Host times are ms; `self_ms` is the span's host
    time less its child spans'; `device_ms` the stream time between its two
    events (None without a card); `launches`, `syncs` and `counts` cover
    its children too. Syncs the device once to resolve the events."""
    rec = _REC
    done, rec.finished = rec.finished, []
    if any(s.ev0 is not None for s in done):
        torch.cuda.synchronize()
    for s in done:
        for key, n in s.pending:
            s.counts[key] = s.counts.get(key, 0) + int(n)
        s.pending = []
    child_ns: dict = {}
    for s in done:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + (s.t1 - s.t0)
    out = []
    for s in done:
        host_ns = s.t1 - s.t0
        out.append({
            "name": s.name, "id": s.id, "parent": s.parent, "item": s.item,
            "start_ns": s.t0, "end_ns": s.t1, "host_ms": host_ns / 1e6,
            "self_ms": (host_ns - child_ns.get(s.id, 0)) / 1e6,
            "device_ms": s.ev0.elapsed_time(s.ev1) if s.ev0 is not None else None,
            "launches": s.launches, "syncs": s.syncs, "counts": dict(s.counts),
        })
    return out


def gather(spans: list, dst: int = 0):
    """Every rank's collected `spans` on rank `dst`, in rank order (None on
    the other ranks); a collective over the default process group, which
    every rank calls. Without a group, [spans]."""
    if not dist.is_initialized():
        return [spans]
    out = [None] * dist.get_world_size() if dist.get_rank() == dst else None
    dist.gather_object(spans, out, dst=dst)
    return out
