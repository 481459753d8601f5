"""Time every render and training path's wall in one process, warm, for an
A/B of two checkouts in turns.

    python -m raytracer_tpu_torch.utils.time_paths [--reps 5] [--paths a,b,...]

Paths (each through the entry point a user calls; the kernels built and
each path run once before its timed runs):

* `culled_large`, `culled_quad_field`: the CLI on rand_spheres_large and
  quad_field at --spp 64 (kernel 2's culled instantiation);
* `textured_perlin`, `textured_earth`, `textured_simple_light`: the CLI on
  perlin, earth and simple_light at --spp 100 (kernel 2 textured);
* `wavefront_step`: `render_image` on perlin with rng-filled Perlin tables
  (kernel 5 and the PyTorch epilogue), ended by a device sync;
* `bucketed_step`, `scan_step`: one `make_inverse_renderer` Adam step of
  each backend on rand_spheres at 400x225, 8 spp, depth 50 from texture
  colors halved (chip_smoke.py phase 7's shape), ended by a device sync.

The CLI's own report gives the CLI walls; the others are host seconds
around the call. Prints one JSON line per path (every timed wall) and a
summary line of medians. To compare checkouts on one card, run it from
each checkout's root in turns (parent, change, change, parent) with
`PYTHONPATH=.`; the rand_spheres CLI has its own script, utils/time_cli.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

CLI_PATHS = {
    "culled_large": ["--scene", "rand_spheres_large", "--spp", "64"],
    "culled_quad_field": ["--scene", "quad_field", "--spp", "64"],
    "textured_perlin": ["--scene", "perlin"],
    "textured_earth": ["--scene", "earth"],
    "textured_simple_light": ["--scene", "simple_light", "--spp", "100"],
}
TRAIN = dict(width=400, spp=8, max_depth=50)


def _synced(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def path_runners(out_dir: Path) -> dict:
    """{path: zero-argument call returning that run's wall seconds}."""
    import torch

    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.diff.grad import make_inverse_renderer, render_linear_diff
    from raytracer_tpu_torch.render.driver import render_image
    from raytracer_tpu_torch.scenes.registry import get_scene

    runners = {name: (lambda argv=argv, name=name: cli.main(
        argv + ["--out", str(out_dir / f"{name}.png")])["wall_s"])
        for name, argv in CLI_PATHS.items()}
    scene, cam, st = get_scene("perlin", procedural_perlin=False)
    runners["wavefront_step"] = lambda: _synced(
        lambda: render_image(scene, cam, st, device="cuda", seed=0))

    t_scene, t_cam, t_st = get_scene("rand_spheres", **TRAIN)
    with torch.no_grad():
        target = render_linear_diff(t_scene.to("cuda"), t_cam, 7, width=t_st.width,
                                    height=t_st.height, samples_per_pass=t_st.samples_per_pixel,
                                    max_depth=t_st.max_depth)
    start = dataclasses.replace(t_scene, tex_c0=t_scene.tex_c0 * 0.5)
    for backend in ("bucketed", "scan"):
        _, _, step = make_inverse_renderer(
            start, t_cam, target, backend=backend, width=t_st.width, height=t_st.height,
            samples_per_pass=t_st.samples_per_pixel, max_depth=t_st.max_depth,
            learning_rate=1e-2, device="cuda")
        seeds = iter(range(101, 10**6))
        runners[f"{backend}_step"] = lambda step=step, seeds=seeds: _synced(
            lambda: step(next(seeds)))
    return runners


def main(argv=None) -> dict:
    import torch

    from raytracer_tpu_torch.ops import build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--paths", default="", help="comma-separated paths (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_paths: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    build.load_kernels()
    medians = {}
    with tempfile.TemporaryDirectory() as d:
        runners = path_runners(Path(d))
        for name in (args.paths.split(",") if args.paths else runners):
            run = runners[name]
            run()  # warm: first launches, caches
            walls = [run() for _ in range(args.reps)]
            medians[name] = statistics.median(walls)
            print(json.dumps({"path": name, "wall_s": walls}), flush=True)
    summary = dict(nvidia_smi=smi, median_wall_s=medians)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
