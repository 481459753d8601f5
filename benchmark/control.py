"""Readings that the limits of `correct` are set from, and the work
constants of a configuration, on the card at a cell's own size:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--program-faults reversed,betas] \\
        [--count-segments 3] [--out <file.json>]

* the program: for each of `--seeds`, one run of the cell's job with a
  window of one item (set-up, the timed path, the check), and its
  numbers;
* the control: for each of `--control-seeds`, the reference computed in
  bfloat16 put in the program's place, compared with the reference in
  float32 at the same samples, the same numbers;
* a train cell's planted fault: half of each step's samples left out,
  the mean taken over the rest (reference/train.py), the same numbers; a
  step that leaves its state unchanged reads 1 by construction;
* `--program-faults reversed,betas`: the program's own runs, as for
  `--seeds` but on `--control-seeds`, with a fault planted in it:
  `reversed` moves the leaves back by each step's update, `betas` runs
  its Adam at betas (0.8, 0.99);
* `--count-segments k`: a render cell's segments per camera sample,
  counted by the float32 reference over every pixel of k images.

The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import torch

from benchmark import harness
from benchmark.reference import compare, tracer
from benchmark.reference import train as reference


def program_readings(cell_name: str, seeds, device: str = "cuda") -> list:
    out = []
    for seed in seeds:
        cell = harness.Cell.load(cell_name, cpu=device == "cpu")
        ctx = harness.Context(cell=cell, seed=seed, seconds=1e-3, trace=False, device=device,
                              start=time.perf_counter())
        job = __import__(f"benchmark.jobs.{cell.workload['job']}", fromlist=["run"])
        result = job.run(ctx)
        out.append({"seed": seed, **{c.name: c.value for c in result.checks},
                    **({"look": result.look} if result.look else {})})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


@contextlib.contextmanager
def program_fault(name: str):
    """The program with a fault planted in its optimizer (see the module's
    docstring), for `program_readings`."""
    from raytracer_tpu_torch.diff import grad

    make, adam = grad.make_inverse_renderer, torch.optim.Adam

    def reversed_step(*a, **kw):
        params, optimizer, step = make(*a, **kw)

        def back(seed, timings=None):
            saved = {k: v.detach().clone() for k, v in params.items()}
            loss = step(seed, timings)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(2.0 * saved[k] - v)
            return loss

        return params, optimizer, back

    if name == "reversed":
        grad.make_inverse_renderer = reversed_step
    elif name == "betas":
        torch.optim.Adam = lambda leaves, lr, betas, eps: adam(leaves, lr=lr, betas=(0.8, 0.99),
                                                               eps=eps)
    else:
        raise ValueError(f"unknown program fault {name!r}")
    try:
        yield
    finally:
        grad.make_inverse_renderer, torch.optim.Adam = make, adam


def render_control(cell: harness.Cell, seeds, device: str = "cuda") -> list:
    """pixel_gap of the bfloat16 reference against the float32 one, at the
    pixels and image seed the cell's check would draw, over the pixels the
    bfloat16 trace left finite (the others counted apart)."""
    desc, (w, h) = cell.description(), cell.size
    r = cell.config["render"]["roulette"]
    out = []
    for seed in seeds:
        image_seed = int(harness.seed_stream(seed, 0).integers(0, 2**31 - 1))
        pick = harness.seed_stream(seed, 2).choice(w * h, min(cell.check["pixels"], w * h),
                                                   replace=False)
        kw = dict(spp=cell.spp, max_depth=cell.max_depth, roulette=(r["start"], r["lo"], r["hi"]),
                  device=device)
        ref, _ = tracer.render_pixels(desc, cell.camera, image_seed, pick, **kw)
        low, _ = tracer.render_pixels(desc, cell.camera, image_seed, pick, dtype=torch.bfloat16,
                                      **kw)
        finite = torch.isfinite(low).all(1)
        out.append({"seed": seed, "pixel_gap": compare.pixel_gap(low[finite], ref[finite]),
                    "nonfinite_pixels": int((~finite).sum())})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


def train_readings(cell: harness.Cell, seeds, device: str = "cuda", **fault) -> list:
    """A train cell's numbers of the reference in bfloat16 (no `fault`) or
    of a planted fault (`drop_half=True`), against the float32 reference."""
    from benchmark.jobs.train import perturbed

    traffic, desc = cell.workload["traffic"], cell.description()
    kw = dict(spp=cell.spp, max_depth=cell.max_depth, lr=traffic["lr"],
              trainable=tuple(traffic["trainable"]))
    out = []
    for seed in seeds:
        sc = tracer.scene_from_description(desc, device)
        target = reference.image(perturbed(sc, seed, traffic["perturb"]), cell.camera,
                                 harness.int_seeds(seed, 5, 1)[0], spp=cell.spp,
                                 max_depth=cell.max_depth)
        steps = harness.int_seeds(seed, 4, traffic["first_steps"])
        if fault:
            other = reference.follow(sc, cell.camera, target, steps, **kw, **fault)
        else:
            low = tracer.scene_from_description(desc, device, torch.bfloat16)
            other = reference.follow(low, cell.camera, target, steps, **kw)
        ref = reference.follow(sc, cell.camera, target, steps, **kw, states=other["states"])
        out.append({"seed": seed, **compare.train_numbers(other, ref, cell.check, traffic["lr"]),
                    "look": compare.train_look(other, ref)})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


def count_segments(cell: harness.Cell, k: int, device: str = "cuda") -> dict:
    """Segments per camera sample of the float32 reference over every
    pixel of `k` images (seeds 0 .. k-1)."""
    desc, (w, h) = cell.description(), cell.size
    r = cell.config["render"]["roulette"]
    counts = []
    for seed in range(k):
        _, segs = tracer.render_pixels(desc, cell.camera, seed, torch.arange(w * h),
                                       spp=cell.spp, max_depth=cell.max_depth,
                                       roulette=(r["start"], r["lo"], r["hi"]), device=device)
        counts.append(segs / (w * h * cell.spp))
    return {"per_seed": counts, "mean": statistics.fmean(counts),
            "spread": (max(counts) - min(counts)) / statistics.fmean(counts),
            "shape": [w, h, cell.spp, cell.max_depth], "seeds": list(range(k))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--program-faults", default="")
    ap.add_argument("--count-segments", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    cell = harness.Cell.load(args.workload)
    report = {"workload": args.workload, "card": harness.card()}
    if seeds:
        report["program"] = program_readings(args.workload, seeds)
    if control_seeds and cell.workload["job"] == "train":
        report["control"] = train_readings(cell, control_seeds)
        report["fault_drop_half"] = train_readings(cell, control_seeds, drop_half=True)
    elif control_seeds:
        report["control"] = render_control(cell, control_seeds)
    for name in filter(None, args.program_faults.split(",")):
        with program_fault(name):
            report[f"program_fault_{name}"] = program_readings(args.workload, control_seeds)
    if args.count_segments:
        report["segments_per_sample"] = count_segments(cell, args.count_segments)
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
