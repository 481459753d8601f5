"""Sharded render job: one image split over the cell's ranks, one rank a
card, one client in a closed loop.

Rank 0 is this process, the one benchmark.run started; ranks 1 .. R - 1
are its children (`python3 -m benchmark.jobs.render_sharded --rank r
...`), started when the job starts. They meet at a coordinator on
localhost, and each takes its card by the program's own rule
(parallel/mesh.py:init_group). Each image is the program's
render_image_sharded of the cell's scene on the mesh of every rank (the
regenerative split: every chunk's samples spread over the ranks, one
all-reduce a chunk, every rank ends with the image), then on rank 0
to_u8 and the copy of the 8-bit image to the host, as the CLI has it
before it writes the file; the image ends there. At the start of each
image rank 0 broadcasts one command to the others: render, with the
image's seed (drawn from the run's seed) and whether to keep the image
for the check or record spans; or stop. The next image starts when the
last is on rank 0's host.

Every rank computes on the host with one thread unless OMP_NUM_THREADS
says otherwise, as torchrun starts the workers of a host (four processes
of PyTorch's default thread pool on one host's cores contend for them).

Set-up counts the children's start, the process group, the scene and two
warm images. End to end: `msamples_per_s`, the camera samples of every
image of the window (all ranks' together) over the window, and
`image_p95_s`, the 95th percentile of rank 0's image times.

A traced run renders the workload's `trace.items` images under rank 0's
device profiler and `trace.label_items` under its host one (profiling.py),
then as many as `trace.items` again with the program's span recorder on
every rank, rank 0's under the profiler's host and CUDA activities. After
the last image each rank's spans reach rank 0 (utils/trace.py:gather),
outside every timed stretch. `record.extra["spans"]` is the span
stretch's summary that benchmark/spans.py's readers read, with each
rank's totals per item (`ranks`: an image's root `render_image_sharded`,
and on rank 0 its `to_u8`), printed as the `spans {...}` line of standard
error. Device metrics are rank 0's; the
memory peak is the largest rank's.

`correct`: two images, one drawn from the seed among the first
`check.among_first` and the window's last, are compared on rank 0 with
the reference (reference/sharded.py: the same split of the samples over
the ranks) on `check.pixels` pixels drawn from the seed, every sample of
each (`pixel_gap`), and every pixel's 8-bit value with the tonemap of
rank 0's linear image worked out in float64 (`u8_off`); the images every
rank ended with are compared by hash (`rank_image_mismatch`: images that
differ from rank 0's); `rank_devices` counts the distinct cards the ranks
rendered on (the CPU counts as one); `chunk_count_off` is how far the
program's number of chunks an image (render/driver.py:default_spp_chunk)
lies from the reference's own chunk plan.

No child outlives the run: a watcher thread ends this process with code
1 when a child ends before it is told to stop, and rank 0 kills what is
left when it leaves, on an error too; a child dies with rank 0 (Linux's
parent-death signal).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

from benchmark import profiling, spans
from benchmark.harness import (
    REPO,
    Cell,
    Check,
    Result,
    int_seeds,
    port_camera,
    port_scene,
    seed_stream,
)

WARM_IMAGES = 2
STOP, RENDER = 0, 1
# Command words: op, image seed, keep as the drawn image, keep as the last
# image, record spans.
WORDS = 5
# Seconds between the watcher's looks at the children; that the set-up (the
# children's start, the group, the kernel library's build on a checkout's
# first run, the warm images: 20-60 s) may take before the watcher ends the
# run; that rank 0 waits for the children to end once they are told to stop.
POLL_S = 0.5
SETUP_S = 300
JOIN_S = 120
PR_SET_PDEATHSIG = 1


class Exactly(Check):
    """A number that must equal its limit."""

    @property
    def ok(self) -> bool:
        return self.value == self.limit


class Children:
    """Rank 0's child processes, started at once and watched: `on_failure`
    (default: leave this process with code 1) runs, after the others are
    killed, when one ends before `stopping()`, or when `ready()` has not
    come `setup_s` seconds after the start (a group that never forms)."""

    def __init__(self, argvs: list, on_failure=None, setup_s: float = SETUP_S):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.setdefault("OMP_NUM_THREADS", "1")
        self.on_failure = on_failure or (lambda: os._exit(1))
        self.stop = threading.Event()
        self.is_ready = threading.Event()
        self.deadline = time.monotonic() + setup_s
        self.procs = []
        try:
            for argv in argvs:
                self.procs.append(subprocess.Popen(argv, cwd=REPO, env=env,
                                                   stdout=subprocess.DEVNULL))
        except BaseException:
            self.kill()
            raise
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    @property
    def pids(self) -> list:
        return [p.pid for p in self.procs]

    def _watch(self) -> None:
        while not self.stop.wait(POLL_S):
            ended = [p for p in self.procs if p.poll() is not None]
            late = not self.is_ready.is_set() and time.monotonic() > self.deadline
            if (ended or late) and not self.stop.is_set():
                print(f"rank process {ended[0].pid} ended with code {ended[0].returncode} "
                      "before the run ended" if ended else "the ranks' set-up took too long",
                      file=sys.stderr, flush=True)
                self.kill()
                self.on_failure()
                return

    def ready(self) -> None:
        """The set-up is done: from here on only a child's end fails."""
        self.is_ready.set()

    def stopping(self) -> None:
        """From here on a child's end is expected."""
        self.stop.set()

    def join(self, timeout: float = JOIN_S) -> list:
        """Wait up to `timeout` s for every child, kill the rest; their
        exit codes."""
        self.stopping()
        deadline = time.monotonic() + timeout
        for p in self.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        self.kill()
        return [p.returncode for p in self.procs]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_id(dev) -> str:
    """What tells one card from another: its UUID; "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(dev)
    return str(getattr(props, "uuid", f"{props.name}:{dev.index}"))


def digest(img) -> str:
    return hashlib.sha256(img.contiguous().cpu().numpy().tobytes()).hexdigest()


class Rank:
    """One rank's part: the process group, its card, the scene, and the
    program's sharded render of one image."""

    def __init__(self, cell: Cell, device: str, rank: int, world: int, coordinator: str):
        from raytracer_tpu_torch.parallel.mesh import init_group, make_mesh

        self.cell, self.rank, self.world = cell, rank, world
        self.dev = init_group(device, coordinator=coordinator, process_id=rank,
                              num_processes=world)
        self.mesh = make_mesh()
        self.cards = [None] * world
        dist.all_gather_object(self.cards, card_id(self.dev))
        if self.dev.type == "cuda" and len(set(self.cards)) < world:
            raise RuntimeError(f"the {world} ranks share cards: {self.cards}")
        self.desc = cell.description()
        self.scene = port_scene(self.desc)
        self.cam, self.settings = port_camera(cell.camera, cell.spp, cell.max_depth)

    def image(self, seed: int):
        from raytracer_tpu_torch.parallel.shard import render_image_sharded

        return render_image_sharded(self.scene, self.cam, self.settings, self.mesh, seed=seed)

    def command(self, op=STOP, seed=0, drawn=False, last=False, record=False) -> None:
        dist.broadcast(torch.tensor([op, seed, int(drawn), int(last), int(record)],
                                    dtype=torch.int64, device=self.dev), src=0)

    def next_command(self) -> list:
        cmd = torch.empty(WORDS, dtype=torch.int64, device=self.dev)
        dist.broadcast(cmd, src=0)
        return cmd.tolist()

    def report(self, kept: dict, span_log: list):
        """Collective after the stop: on rank 0 every rank's report (digests
        of its kept images, memory peak) and spans, in rank order; None
        elsewhere."""
        from raytracer_tpu_torch.utils import trace

        peak = int(torch.cuda.max_memory_allocated(self.dev)) if self.dev.type == "cuda" else 0
        mine = {"digests": {k: digest(v) for k, v in kept.items()}, "memory_peak": peak}
        reports = [None] * self.world if self.rank == 0 else None
        dist.gather_object(mine, reports, dst=0)
        gathered = trace.gather(span_log) if hasattr(trace, "gather") else None
        return reports, gathered

    def close(self) -> None:
        from raytracer_tpu_torch.parallel.mesh import close_group

        close_group()


def child_main(argv=None) -> int:
    """A rank other than 0: follow rank 0's commands until it says stop."""
    ap = argparse.ArgumentParser(description="One rank of the sharded render job.")
    for name in ("--workload", "--device", "--coordinator"):
        ap.add_argument(name, required=True)
    for name in ("--rank", "--world", "--parent"):
        ap.add_argument(name, type=int, required=True)
    args = ap.parse_args(argv)
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong, ctypes.c_ulong,
                           ctypes.c_ulong]
    libc.prctl.restype = ctypes.c_int
    libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    if os.getppid() != args.parent:  # rank 0 ended before the signal was set
        return 1
    from raytracer_tpu_torch.utils import trace

    r = Rank(Cell.load(args.workload, cpu=args.device == "cpu"), args.device, args.rank,
             args.world, args.coordinator)
    kept, span_log = {}, []
    try:
        while True:
            op, seed, drawn, last, record = r.next_command()
            if op == STOP:
                break
            if record:
                trace.enable()
            else:
                trace.disable()
            img = r.image(seed)
            if record:
                span_log.extend(trace.collect())
            kept.update({"last": img} if last else {})
            kept.update({"drawn": img} if drawn else {})
        trace.disable()
        r.report(kept, span_log)
    finally:
        r.close()
    return 0


def item_totals(log: list) -> list:
    """Per item (the spans under one root, in the order they ran), the
    totals by span name (benchmark/spans.py:by_name) of a rank's spans."""
    items: dict = {}
    for s in log:
        items.setdefault(s["item"], []).append(s)
    return [spans.by_name(v) for v in items.values()]


def span_stretch(item, n: int, cuda: bool):
    """`item()` n times with the program's recorder on, under the
    profiler's host and CUDA activities on the card; (the summary of
    benchmark/spans.py:stretch, the spans)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from raytracer_tpu_torch.utils import trace

    log, item_s = [], []
    trace.collect()
    trace.enable()
    try:
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if cuda
              else contextlib.nullcontext()) as prof:
            for _ in range(n):
                t0 = time.perf_counter()
                with record_function(profiling.SPAN):
                    item()
                item_s.append(time.perf_counter() - t0)
                log.extend(trace.collect())
    finally:
        trace.disable()
    out = {"cuda": cuda, "items": n, "item_s": item_s, "by_name": spans.by_name(log)}
    if cuda:
        out.update(spans.attribute(spans.events_of(prof), set(out["by_name"])))
    return out, log


def run(ctx) -> Result:
    from raytracer_tpu_torch.render.postprocess import to_u8
    from raytracer_tpu_torch.utils import launches

    cell = ctx.cell
    world = cell.workload["traffic"]["ranks"]
    if "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)
    width, height = cell.size
    spp = cell.spp
    t = time.perf_counter()
    coordinator = f"localhost:{free_port()}"
    children = Children([
        [sys.executable, "-m", "benchmark.jobs.render_sharded", "--workload", cell.name,
         "--device", ctx.device, "--coordinator", coordinator, "--rank", str(r),
         "--world", str(world), "--parent", str(os.getpid())] for r in range(1, world)])
    print(f"ranks {[os.getpid(), *children.pids]}", file=sys.stderr, flush=True)
    r = None
    try:
        r = Rank(cell, ctx.device, 0, world, coordinator)
        t = ctx.part("group_s", t)

        def image(seed: int, drawn=False, last=False, record=False):
            r.command(RENDER, seed, drawn, last, record)
            img = r.image(seed)
            return img, to_u8(img).cpu()

        for i, seed in enumerate(int_seeds(ctx.seed, 9, WARM_IMAGES)):
            image(seed)
            ctx.sync()
            t = ctx.part(f"warm_image{i}_s", t)

        seeds = seed_stream(ctx.seed, 0)
        check_at = int(seed_stream(ctx.seed, 1).integers(0, cell.check["among_first"]))
        kept, times, record, span_log = {}, [], None, []
        children.ready()
        t_start = time.perf_counter()
        ctx.setup_s = t_start - ctx.start
        if ctx.trace:
            cuda = ctx.device == "cuda"

            def item():
                seed = int(seeds.integers(0, 2**31 - 1))
                drawn = len(times) == check_at
                img, u8 = image(seed, drawn=drawn, last=True)
                kept.update({"last": (seed, img, u8)} | ({"drawn": (seed, img, u8)}
                                                         if drawn else {}))
                times.append(seed)

            def plain_item(record=False):
                image(int(seeds.integers(0, 2**31 - 1)), record=record)

            launches.reset()
            record = profiling.device_stretch(item, cell.trace_items, cuda)
            record.extra["launches"] = launches.read()
            label_items = cell.workload["trace"]["label_items"]
            record.idle_gaps = profiling.label_stretch(plain_item, label_items, cuda)
            summary, span_log = span_stretch(lambda: plain_item(record=True), cell.trace_items,
                                             cuda)
            n_done = 2 * cell.trace_items + (label_items if cuda else 0)
        else:
            n_done, t0 = 0, t_start
            while n_done == 0 or t0 - t_start < ctx.seconds:
                seed = int(seeds.integers(0, 2**31 - 1))
                drawn = n_done == check_at
                img, u8 = image(seed, drawn=drawn, last=True)
                t1 = time.perf_counter()
                times.append(t1 - t0)
                kept.update({"last": (seed, img, u8)} | ({"drawn": (seed, img, u8)}
                                                         if drawn else {}))
                n_done, t0 = n_done + 1, t1
        window = time.perf_counter() - t_start
        ctx.close_window()
        children.stopping()
        r.command(STOP)
        reports, gathered = r.report({k: v[1] for k, v in kept.items()}, span_log)
    except BaseException:
        children.kill()  # first, so that no collective waits on them
        raise
    finally:
        if r is not None:
            r.close()
        codes = children.join()
    if any(codes):
        raise RuntimeError(f"rank processes ended with codes {codes}")
    ctx.memory_peak = max([ctx.memory_peak] + [x["memory_peak"] for x in reports])

    result = Result(attempted=n_done, failed=0, record=record)
    if record is not None:
        from raytracer_tpu_torch.parallel.shard import rank_share
        from raytracer_tpu_torch.render.driver import default_spp_chunk

        chunk = default_spp_chunk(r.scene, r.settings, ranks=world)
        own = sum(rank_share(min(chunk, spp - done), 0, world) for done in range(0, spp, chunk))
        if gathered is not None:
            summary["ranks"] = [item_totals(log) for log in gathered]
        print("spans " + json.dumps(summary), file=sys.stderr)
        record.extra.update({"spans": summary, "samples": width * height * own,
                             "spheres": len(r.desc.spheres), "quads": len(r.desc.quads),
                             "work": cell.config["work"]})
    else:
        result.end_to_end = {
            "setup_s": ctx.setup_s,
            "msamples_per_s": n_done * width * height * spp / window / 1e6,
            "image_p95_s": statistics.quantiles(times, n=100, method="inclusive")[94]
            if len(times) > 1 else times[0],
        }
    result.checks, result.look = check(ctx, r, kept, reports)
    return result


def check(ctx, r: Rank, kept: dict, reports: list):
    """The checks of the module docstring, and what is printed beside
    them."""
    from benchmark.reference import compare, sharded
    from raytracer_tpu_torch.render.driver import default_spp_chunk

    cell = ctx.cell
    width, height = cell.size
    n_pix = width * height
    roulette = cell.config["render"]["roulette"]
    gaps, mismatches, plan = [], [], []
    images = {id(v[1]): (name, v) for name, v in kept.items()}.values()
    for k, (_, (seed, img, u8)) in enumerate(images):
        pick = seed_stream(ctx.seed, 2 + k).choice(n_pix, min(cell.check["pixels"], n_pix),
                                                    replace=False)
        ref, _, plan = sharded.render_pixels(
            r.desc, cell.camera, seed, pick, spp=cell.spp, max_depth=cell.max_depth,
            roulette=(roulette["start"], roulette["lo"], roulette["hi"]), ranks=r.world,
            device=ctx.device)
        prog = img.reshape(-1, 3)[torch.as_tensor(pick, device=img.device)]
        gaps.append(compare.pixel_gap(prog, ref))
        mismatches.append(compare.u8_off(u8, img))
    mine = reports[0]["digests"]
    differ = sum(x["digests"].get(name) != mine[name] for x in reports[1:] for name in mine)
    chunk = default_spp_chunk(r.scene, r.settings, ranks=r.world)
    limits = cell.check["limits"]
    checks = [Check("pixel_gap", max(gaps), limits["pixel_gap"]),
              Check("u8_off", max(mismatches), limits["u8_off"]),
              Check("rank_image_mismatch", differ, limits["rank_image_mismatch"]),
              Exactly("rank_devices", len(set(r.cards)), limits["rank_devices"]),
              Check("chunk_count_off", abs(-(-cell.spp // chunk) - len(plan)),
                    limits["chunk_count_off"])]
    look = {"pixel_gaps": gaps, "chunk_plan": plan, "cards": r.cards,
            "rank_memory_peak_mb": [x["memory_peak"] / 2**20 for x in reports]}
    return checks, look


if __name__ == "__main__":
    sys.exit(child_main())
