"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<cell>.json`; its job, `benchmark/jobs/
<job>.py`, sets up, measures for `--seconds` and checks its outputs with
the reference. With `--trace 0` the result carries the cell's end-to-end
metrics of BENCHMARK.json; with `--trace 1` its per-layer metrics, each
read by `benchmark/metrics/<metric>.py` from the traced stretch. The last
line of standard output is the result; standard error ends with each
number compared beside its limit.

Without a CUDA device, or with fewer than the cell's chips, the run exits
with code 2 and prints no result. `--device cpu` runs the cell at the
small shapes of its workload file's `cpu` entry, on the program's CPU
path, for the tests: its numbers are the CPU's and carry no device metric.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")
# Sources a CPU run does not report: it has no device trace, and its spans
# time the CPU.
CPU_SILENT = ("device_trace", "program_span")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metric_reader(name: str):
    """The `read(record)` function of benchmark/metrics/<name>.py."""
    path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (those that list no cells, or list it),
    or with `trace` its per-layer ones (each lists its cells)."""
    if trace:
        return [m for m in spec["per_layer"] if cell in m["workloads"]]
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    t = time.perf_counter()
    import torch

    from benchmark import harness

    setup_parts = {"import_torch_s": time.perf_counter() - t}
    spec = harness.benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"needs {entry['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        t = time.perf_counter()
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        setup_parts["cuda_context_s"] = time.perf_counter() - t
    setup_parts["library"] = "cached" if any(
        harness.REPO.glob("raytracer_tpu_torch/build/libraytracer_kernels_*.so")) else "built"

    cell = harness.Cell.load(args.workload, cpu=args.device == "cpu")
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=args.device, start=START,
                          setup_parts=setup_parts)
    job = importlib.import_module(f"benchmark.jobs.{cell.workload['job']}")
    result = job.run(ctx)

    metrics = {}
    for m in cell_metrics(spec, args.workload, bool(args.trace)):
        value = (metric_reader(m["name"])(result.record) if args.trace
                 else result.end_to_end.get(m["name"]))
        if args.device == "cpu" and m["source"] in CPU_SILENT:
            continue
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not args.trace:
            print(f"{m['name']}: not produced by job {cell.workload['job']}", file=sys.stderr)
            return 3

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
              "count": entry["chips"] if args.device == "cuda" else 0,
              "memory_peak_bytes": ctx.memory_peak}
    out = {"correct": all(c.ok for c in result.checks), "attempted": result.attempted,
           "failed": result.failed, "metrics": metrics, "device": device}
    rec = result.record
    if rec is not None:
        if args.device == "cuda":
            device.update(busy_s=rec.busy_s, window_s=rec.window_s)
            out["breakdown"] = rec.breakdown()
        print("launches " + json.dumps(rec.extra.get("launches", {})), file=sys.stderr)
    if args.device == "cuda":
        print(f"card {harness.card()}", file=sys.stderr)
        print(f"peak_hbm_mb {ctx.memory_peak / 2**20:.3f}", file=sys.stderr)
    print("setup " + json.dumps({"setup_s": ctx.setup_s,
                                 **ctx.setup_parts}), file=sys.stderr)
    if result.look:
        print("look " + json.dumps(result.look), file=sys.stderr)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in result.checks}
    for c in result.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
