"""Command-line driver: render a registered scene to PPM/PNG on the GPU.

Port of raytracer_tpu/cli.py. The device defaults to CUDA and a missing card
is an error; `--device cpu` runs the kernels' plain PyTorch twins. Scene
tables are not size-bucketed (bucketing only shared jit executables in the
JAX package). `--profile` writes a torch.profiler Chrome trace under
out/trace, `--memory-profile PATH` a JSON report of the card's allocator,
and `--checkpoint PATH` renders through render/checkpoint.py, resuming
from PATH when it is there.

Usage:
    python -m raytracer_tpu_torch.cli --scene rand_spheres --out out/rs.png
"""

from __future__ import annotations

import argparse
import inspect
import json
import time

import torch

from raytracer_tpu_torch.imgio.image import write_png, write_ppm
from raytracer_tpu_torch.render.checkpoint import render_with_checkpoints
from raytracer_tpu_torch.render.driver import render_path, render_scene, resolve_device
from raytracer_tpu_torch.render.postprocess import to_u8
from raytracer_tpu_torch.scenes.registry import SCENES, get_scene
from raytracer_tpu_torch.utils.metrics import (
    RenderMetrics,
    device_memory_stats,
    profiler_trace,
    save_memory_profile,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="rand_spheres", choices=sorted(SCENES))
    ap.add_argument("--out", default="out/img.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler trace of the render (CPU and CUDA activity) to out/trace")
    ap.add_argument(
        "--memory-profile", default=None, metavar="PATH",
        help="write a JSON report of the device memory after the render: the CUDA "
        "allocator's live blocks, largest first, and its totals",
    )
    ap.add_argument(
        "--checkpoint", default=None, metavar="PATH",
        help="checkpoint file: saved after every spp chunk, resumed from when present "
        "(fail-stop and rerun)",
    )
    ap.add_argument(
        "--bilinear", action="store_true",
        help="bilinear image filtering (scenes with image textures; the reference is "
        "nearest-neighbour, materials.go:184-192). The persistent path filters "
        "stochastically: one tap drawn with its bilinear weight, unbiased",
    )
    ap.add_argument(
        "--bilinear-exact", action="store_true",
        help="with --bilinear: the deterministic 4-tap filter instead of the stochastic tap",
    )
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    overrides = {}
    if args.bilinear:
        if "bilinear" not in inspect.signature(SCENES[args.scene]).parameters:
            ap.error(f"--bilinear is not supported by scene {args.scene!r}")
        overrides["bilinear"] = True
    if args.width is not None:
        overrides["width"] = args.width
    if args.spp is not None:
        overrides["spp"] = args.spp
    if args.max_depth is not None:
        overrides["max_depth"] = args.max_depth
    scene, cam, settings = get_scene(args.scene, args.seed, **overrides)

    metrics = RenderMetrics(
        total_spp=settings.samples_per_pixel, pixels=settings.width * settings.height
    )
    render_kw = dict(device=dev, seed=args.seed, progress=True, metrics=metrics,
                     bilinear_stochastic=False if args.bilinear_exact else None)
    t0 = time.perf_counter()
    with profiler_trace("out/trace" if args.profile else None):
        if args.checkpoint:
            linear = render_with_checkpoints(scene, cam, settings,
                                             checkpoint_path=args.checkpoint, **render_kw)
            img = to_u8(linear).cpu().numpy()
        else:
            img = render_scene(scene, cam, settings, **render_kw)
    dt = time.perf_counter() - t0

    if args.out.endswith(".ppm"):
        write_ppm(args.out, img)
    else:
        write_png(args.out, img)

    if args.memory_profile and not save_memory_profile(args.memory_profile, dev):
        print("memory profile unavailable on this backend", flush=True)

    camera_rays = settings.width * settings.height * settings.samples_per_pixel
    report = {
        "scene": args.scene,
        "size": [settings.width, settings.height],
        "spp": settings.samples_per_pixel,
        "max_depth": settings.max_depth,
        "path": render_path(scene),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "wall_s": dt,
        "camera_mrays_per_s": camera_rays / dt / 1e6,
        "out": args.out,
    }
    snap = metrics.snapshot()
    for k in ("traced_segments", "warp_occupancy", "iterations", "lane_occupancy", "passes",
              "wavefront_lanes", "retirement_log_mb", "cluster_s", "bvh_builder",
              "cluster_rows"):
        if k in snap:
            report[k] = snap[k]
    # Both rates over the render's wall time (image encoding excluded).
    report["traced_mrays_per_s"] = metrics.traced_segments / dt / 1e6
    report.update(device_memory_stats(dev))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
