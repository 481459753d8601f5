"""Command-line driver: render a registered scene to PPM/PNG on the GPU.

Port of raytracer_tpu/cli.py. The device defaults to CUDA and a missing card
is an error; `--device cpu` runs the kernels' plain PyTorch twins. Scene
tables are not size-bucketed (bucketing only shared jit executables in the
JAX package). `--profile` writes a torch.profiler Chrome trace under
out/trace, `--memory-profile PATH` a JSON report of the card's allocator,
and `--checkpoint PATH` renders through render/checkpoint.py, resuming
from PATH when it is there.

`--shard` renders through parallel/shard.py:render_image_sharded over a
(tiles, samples) mesh of every rank of a process group (`--sample-parallel`
ranks to a tile). Under `torchrun` the group comes from the environment,
one rank a device (NCCL on CUDA, gloo on the CPU); run alone it is a group
of one rank on `--device`. The group starts before the render's clock and
is reported as `group_start_s`; rank 0 writes the image and prints the
report, which adds the mesh shape and the backend.

Usage:
    python -m raytracer_tpu_torch.cli --scene rand_spheres --out out/rs.png
    torchrun --nproc-per-node 8 -m raytracer_tpu_torch.cli --shard --scene rand_spheres
"""

from __future__ import annotations

import argparse
import inspect
import json
import time

import torch
import torch.distributed as dist

from raytracer_tpu_torch.imgio.image import write_png, write_ppm
from raytracer_tpu_torch.parallel.mesh import close_group, init_group, make_mesh
from raytracer_tpu_torch.parallel.shard import render_image_sharded
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
        "--shard", action="store_true",
        help="render over every rank of a process group: torchrun's, or one rank run alone",
    )
    ap.add_argument(
        "--sample-parallel", type=int, default=1,
        help="with --shard: ranks cooperating on the same pixels (must divide the ranks)",
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
    if args.sample_parallel != 1 and not args.shard:
        ap.error("--sample-parallel requires --shard")

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
    render_kw = dict(seed=args.seed, progress=True, metrics=metrics,
                     bilinear_stochastic=False if args.bilinear_exact else None)
    started_group = args.shard and not dist.is_initialized()
    group_s, mesh = 0.0, None
    try:
        if args.shard:
            t0 = time.perf_counter()
            if started_group:
                dev = init_group(dev)
            mesh = make_mesh(sample_parallel=args.sample_parallel, device=dev)
            group_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with profiler_trace("out/trace" if args.profile else None):
            if args.shard:
                linear = render_image_sharded(scene, cam, settings, mesh,
                                              checkpoint_path=args.checkpoint, **render_kw)
                img = to_u8(linear).cpu().numpy()
            elif args.checkpoint:
                linear = render_with_checkpoints(scene, cam, settings, device=dev,
                                                 checkpoint_path=args.checkpoint, **render_kw)
                img = to_u8(linear).cpu().numpy()
            else:
                img = render_scene(scene, cam, settings, device=dev, **render_kw)
        dt = time.perf_counter() - t0
        root = not args.shard or dist.get_rank() == 0
    finally:
        if started_group:
            close_group()
    if not root:
        return {}

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
    if mesh is not None:
        report.update(mesh=list(mesh.shape), backend=mesh.backend, group_start_s=group_s)
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
