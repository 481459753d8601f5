"""Time repeated CLI renders in one process, after a build and a warm render.

    python -m raytracer_tpu_torch.utils.time_cli [--reps 5] --scene rand_spheres [CLI args]

Every argument it does not know passes to `raytracer_tpu_torch.cli`. The
kernels are built and one render is run first, so the timed renders measure
the render alone; each prints the CLI's JSON report on its own line. To
compare two checkouts on one card, run it from each checkout's root in
turns (parent, change, change, parent) with `PYTHONPATH=.`.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> list[dict]:
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.ops import build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args, cli_argv = ap.parse_known_args(argv)
    build.load_kernels()
    cli.main(cli_argv)
    return [cli.main(cli_argv) for _ in range(args.reps)]


if __name__ == "__main__":
    main()
