"""Readings that the limits of the edge cell's `correct` are set from, on
the card at the cell's own size:

    python3 -m benchmark.control_edges --workload rand_spheres.train_edges \\
        --seeds 101,102,103 [--variants bf16,no_boundary,...] [--out <file.json>]

For each seed and variant, the reference with the variant in the program's
place (reference/edges.py:follow_edges from the cell's scene, target and
first seeds, as jobs/train_edges.py makes them), compared with the sound
reference at that run's states and cotangents by the cell's numbers
(jobs/train_edges.py:numbers). The variants: `bf16`, the reference computed
in bfloat16 (the control); and the planted faults of reference/edges.py:
FAULTS, a term dropped (`no_boundary`, `no_shadow`), the terms seeded one
term on (`seed_shift`), L_in without the extrapolation
(`no_extrapolation`), the boundary step halved (`half_eps`), the shadow
term from half its receivers (`half_receivers`), and half the batch: the
interior from half of each step's samples and the shadow term from half
its receivers (`half_batch`).

The sound program's own readings are control.py's: `python3 -m
benchmark.control --workload rand_spheres.train_edges --seeds ...`. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import harness
from benchmark.reference import edges, tracer
from benchmark.reference import train as reference

VARIANTS = ("bf16",) + edges.FAULTS


def readings(cell: harness.Cell, seeds, variant: str, device: str = "cuda") -> list:
    """The cell's numbers of `variant` in the program's place, one a seed."""
    from benchmark.jobs.train import perturbed
    from benchmark.jobs.train_edges import look, numbers

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
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
        if variant == "bf16":
            other = edges.follow_edges(edges.cast(sc, torch.bfloat16), cell.camera, target, steps,
                                       edge_dtype=torch.bfloat16, **kw)
        else:
            other = edges.follow_edges(sc, cell.camera, target, steps, fault=variant, **kw)
        ref = edges.follow_edges(sc, cell.camera, target, steps, states=other["states"],
                                 cts=other["cts"], **kw)
        out.append({"seed": seed, "variant": variant, **numbers(other, ref, traffic["lr"]),
                    "look": look(other, ref)})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="rand_spheres.train_edges")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.Cell.load(args.workload, cpu=args.device == "cpu")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    report = {"workload": args.workload, "card": harness.card() if args.device == "cuda"
              else "cpu"}
    for variant in filter(None, args.variants.split(",")):
        report[variant] = readings(cell, seeds, variant, args.device)
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
