"""Profile one inverse-rendering gradient step on a CUDA device.

    python -m raytracer_tpu_torch.utils.profile_grad [--backend bucketed|scan]
        [--boundary] [--grad-full] [--out out/grad_trace.json]

The training shape of chip_smoke.py phase 7: rand_spheres at 400x225,
8 spp, depth 50, its texture colors halved, the target rendered from the
true scene. Two warm steps,
then one step under torch.profiler (CPU and CUDA activity). Prints one JSON
line: the step's wall seconds and phase split, the device's busy time (the
union of its kernels' intervals) and idle share of the profiled window, and
the device time of the top kernels and of the top autograd operators; writes
the Chrome trace to --out. With `--boundary` the step adds the silhouette
edge term (make_inverse_renderer(boundary=True)); `--grad-full` profiles
the JAX package's `grad_full` step instead (bench.py:333-352: boundary and
shadow_edges, training sph_center, sph_radius and tex_c0). On the bucketed
backend the line then also reads the edge terms' window (the `edges`
span of utils/trace.py) and each term's own (`edges/boundary`, `edges/shadow`):
its seconds, the device's busy time and idle share in it, its CUDA kernel
launches and the closest-hit kernel's share. Needs a CUDA device: it fails
without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

# The training path's shape (chip_smoke.py phase 7) and the rows listed.
WIDTH, SPP, MAX_DEPTH = 400, 8, 50
TOP = 15

def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.diff.grad import make_inverse_renderer, render_linear_diff
    from raytracer_tpu_torch.scenes.registry import get_scene
    from raytracer_tpu_torch.utils import trace

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="bucketed", choices=("bucketed", "scan"))
    ap.add_argument("--boundary", action="store_true", help="add the silhouette edge term")
    ap.add_argument("--grad-full", action="store_true",
                    help="the silhouette and shadow edge terms, training sph_center, "
                         "sph_radius and tex_c0")
    ap.add_argument("--out", default="out/grad_trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_grad needs a CUDA device")

    scene, cam, st = get_scene("rand_spheres", width=WIDTH, spp=SPP, max_depth=MAX_DEPTH)
    kw = dict(width=st.width, height=st.height, samples_per_pass=st.samples_per_pixel,
              max_depth=st.max_depth)
    with torch.no_grad():
        target = render_linear_diff(scene.to("cuda"), cam, 7, **kw)
    start = dataclasses.replace(scene, tex_c0=scene.tex_c0 * 0.5)
    full = dict(boundary=True, shadow_edges=True,
                trainable=("sph_center", "sph_radius", "tex_c0")) if args.grad_full else {}
    _, _, step = make_inverse_renderer(start, cam, target, backend=args.backend,
                                       **{"boundary": args.boundary, **full}, device="cuda", **kw)
    for seed in (1, 2):
        step(seed)
    torch.cuda.synchronize()
    timings = {}
    trace.enable()  # the step's spans, `edges` and `edges/<name>` among them
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(3, timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace.disable()
    trace.collect()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    prof.export_chrome_trace(args.out)

    # Device events, without the device-side ranges of record_function
    # (user annotations such as `edges/shadow`), which span their window.
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("edges")]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    ops = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CPU]
    dev_attr = "self_device_time_total" if hasattr(ops[0], "self_device_time_total") else (
        "self_cuda_time_total")
    top_ops = sorted(((a.key, getattr(a, dev_attr) / 1e3, a.count) for a in ops),
                     key=lambda t: -t[1])[:TOP]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    edges = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not (
                e.name == "edges" or e.name.startswith("edges/")):
            continue
        lo, hi = e.time_range.start, e.time_range.end
        inside = [k for k in kernels if lo <= k.time_range.start < hi]
        busy_e = busy_us([(k.time_range.start, k.time_range.end) for k in inside]) / 1e6
        hit = [k for k in inside if "intersect_kernel" in k.name]
        launches_host = [k for k in prof.events() if k.name.startswith(("cudaLaunch", "cuLaunch"))
                         and lo <= k.time_range.start < hi]
        key = e.name.replace("/", "_")
        edges.update({f"{key}_window_s": (hi - lo) / 1e6, f"{key}_device_busy_s": busy_e,
                      f"{key}_device_idle_share": 1.0 - busy_e / ((hi - lo) / 1e6),
                      f"{key}_kernel_launches": len(inside),
                      f"{key}_cuda_launch_calls": len(launches_host),
                      f"{key}_closest_hit_launches": len(hit),
                      f"{key}_closest_hit_ms": sum(k.time_range.elapsed_us() for k in hit) / 1e3})
    report = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "backend": args.backend,
        "boundary": args.boundary, "grad_full": args.grad_full, **edges,
        "shape": [st.width, st.height, st.samples_per_pixel, st.max_depth],
        "wall_s": wall, "phases_s": timings, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall, "kernel_launches": len(kernels),
        "top_kernels_ms": top_kernels,
        "top_ops_self_device_ms_count": top_ops,
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
