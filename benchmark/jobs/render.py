"""Render job: one client in a closed loop. Each image is the program's
`render_image` of the cell's scene at its size and samples per pixel,
under a seed of its own drawn from the run's seed, then `to_u8` and the
copy of the 8-bit image to the host, as the program's CLI has it before
it writes the file. The next image starts when the last is on the host.

End to end: `msamples_per_s`, the camera samples of every image of the
window over the window's length, and `image_p95_s`, the 95th percentile
of the images' times. A traced run renders the workload's `trace.items`
images under the device profiler and `trace.label_items` under the host
one (profiling.py), then two more with the program's RenderMetrics for
the warp occupancy.

`correct`: two images, one drawn from the seed among the first
`check.among_first` and the window's last, are compared with the
reference (reference/tracer.py) on `check.pixels` pixels drawn from the
seed, every sample of each (`pixel_gap`), and every pixel's 8-bit value
with the tonemap of the program's linear image worked out in float64
(`u8_off`: pixels more than one level off).
"""

from __future__ import annotations

import statistics
import time

from benchmark import profiling
from benchmark.harness import Check, Result, int_seeds, port_camera, port_scene, seed_stream

WARM_IMAGES = 2
OCCUPANCY_IMAGES = 2


def run(ctx) -> Result:
    from raytracer_tpu_torch.render.driver import render_image
    from raytracer_tpu_torch.render.postprocess import to_u8
    from raytracer_tpu_torch.utils import launches
    from raytracer_tpu_torch.utils.metrics import RenderMetrics

    cell = ctx.cell
    width, height = cell.size
    spp, max_depth = cell.spp, cell.max_depth
    t = time.perf_counter()
    desc = cell.description()
    scene = port_scene(desc)
    cam, settings = port_camera(cell.camera, spp, max_depth)
    t = ctx.part("scene_build_s", t)

    def image(seed: int, metrics=None):
        img = render_image(scene, cam, settings, device=ctx.device, seed=seed, metrics=metrics)
        return img, to_u8(img).cpu()

    for i, seed in enumerate(int_seeds(ctx.seed, 9, WARM_IMAGES)):
        image(seed)
        ctx.sync()
        t = ctx.part(f"warm_image{i}_s", t)

    seeds = seed_stream(ctx.seed, 0)
    check_at = int(seed_stream(ctx.seed, 1).integers(0, cell.check["among_first"]))
    kept, times, record = {}, [], None
    t_start = time.perf_counter()
    ctx.setup_s = t_start - ctx.start
    if ctx.trace:
        cuda = ctx.device == "cuda"

        def item():
            seed = int(seeds.integers(0, 2**31 - 1))
            img, u8 = image(seed)
            kept.update({"last": (seed, img, u8)} | ({"drawn": (seed, img, u8)}
                                                     if len(times) == check_at else {}))
            times.append(seed)

        launches.reset()
        record = profiling.device_stretch(item, cell.trace_items, cuda)
        record.extra["launches"] = launches.read()
        record.idle_gaps = profiling.label_stretch(
            lambda: image(int(seeds.integers(0, 2**31 - 1))), cell.workload["trace"]["label_items"],
            cuda)
        occupancy = []
        for seed in int_seeds(ctx.seed, 8, OCCUPANCY_IMAGES):
            m = RenderMetrics(total_spp=spp, pixels=width * height)
            image(seed, metrics=m)
            if m.warp_slots:
                occupancy.append(m.traced_segments / m.warp_slots)
        record.extra.update({"occupancy": occupancy, "samples": width * height * spp,
                             "spheres": len(desc.spheres), "quads": len(desc.quads),
                             "work": cell.config["work"]})
        n_done = cell.trace_items + cell.workload["trace"]["label_items"] + OCCUPANCY_IMAGES
    else:
        n_done, t0 = 0, t_start
        while n_done == 0 or t0 - t_start < ctx.seconds:
            seed = int(seeds.integers(0, 2**31 - 1))
            img, u8 = image(seed)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            kept.update({"last": (seed, img, u8)} | ({"drawn": (seed, img, u8)}
                                                     if n_done == check_at else {}))
            n_done, t0 = n_done + 1, t1
    window = time.perf_counter() - t_start
    ctx.close_window()
    del scene

    result = Result(attempted=n_done, failed=0, record=record)
    if not ctx.trace:
        result.end_to_end = {
            "setup_s": ctx.setup_s,
            "msamples_per_s": n_done * width * height * spp / window / 1e6,
            "image_p95_s": statistics.quantiles(times, n=100, method="inclusive")[94]
            if len(times) > 1 else times[0],
        }
    result.checks = check(ctx, desc, kept)
    return result


def check(ctx, desc, kept) -> list:
    """Compare the kept images with the reference (see the module
    docstring); the worst image's numbers."""
    import torch

    from benchmark.reference import compare, tracer

    cell = ctx.cell
    width, height = cell.size
    n_pix = width * height
    roulette = cell.config["render"]["roulette"]
    images = {id(v[1]): v for v in kept.values()}.values()
    gaps, mismatches = [], []
    for k, (seed, img, u8) in enumerate(images):
        pick = seed_stream(ctx.seed, 2 + k).choice(n_pix, min(cell.check["pixels"], n_pix),
                                                    replace=False)
        ref, _ = tracer.render_pixels(
            desc, cell.camera, seed, pick, spp=cell.spp, max_depth=cell.max_depth,
            roulette=(roulette["start"], roulette["lo"], roulette["hi"]), device=ctx.device)
        prog = img.reshape(-1, 3)[torch.as_tensor(pick, device=img.device)]
        gaps.append(compare.pixel_gap(prog, ref))
        mismatches.append(compare.u8_off(u8, img))
    limits = cell.check["limits"]
    return [Check("pixel_gap", max(gaps), limits["pixel_gap"]),
            Check("u8_off", max(mismatches), limits["u8_off"])]
