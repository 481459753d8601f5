"""Profile one render of a registered scene on a CUDA device.

    python -m raytracer_tpu_torch.utils.profile_render [--scene perlin]
        [--spp N] [--large-scene] [--out out/render_trace.json]

The scene at its CLI defaults (width, spp, depth; --spp overrides), through
the path render/driver.py:render_path gives it, or with --large-scene
through the large-scene path (render/driver.py:render_loop). One warm render, then one
under torch.profiler (CPU and CUDA activity). Prints one JSON line: the
render's wall seconds, the device's busy time (the union of its kernels'
intervals) and idle share, the kernel launches, the device time of the
port's own kernels and of everything else (PyTorch's operators), the host
syncs (`aten::nonzero` and `aten::item`, each waits for the device), and
the top kernels and operators (by device time, and by host time); with
--out also the Chrome trace. Needs a
CUDA device: it fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

from raytracer_tpu_torch.utils.profile_grad import busy_us

# Device functions of the port's hand-written kernels (csrc/).
OWN_KERNELS = ("wavefront_step_kernel", "culled_kernel", "intersect_kernel", "persistent_kernel")
SYNC_OPS = ("aten::nonzero", "aten::item")
ROWS = 8  # top kernels and operators listed
NAME_CHARS = 100  # kernel names are cut to this length


def short(name: str) -> str:
    """A kernel's name without its namespaces, cut to NAME_CHARS."""
    for prefix in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(prefix, "")
    return name[:NAME_CHARS]


def main(argv=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.render.driver import render_image, render_loop, render_path
    from raytracer_tpu_torch.scenes.registry import SCENES, get_scene

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="perlin", choices=sorted(SCENES))
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--large-scene", action="store_true",
                    help="render through the large-scene path (kernels 4 and 1)")
    ap.add_argument("--out", default=None, help="Chrome trace path (none by default)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_render needs a CUDA device")

    scene, cam, st = get_scene(args.scene, **({} if args.spp is None else {"spp": args.spp}))
    if args.large_scene:
        scene = scene.to("cuda")

    def render(seed):
        if args.large_scene:
            return render_loop(scene, cam, st, path="large_scene", seed=seed)
        return render_image(scene, cam, st, device="cuda", seed=seed)

    render(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        prof.export_chrome_trace(args.out)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6
    by_kernel: dict = {}
    for e in kernels:
        name = short(e.name)
        by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    own_ms = {k: sum(v for name, v in by_kernel.items() if k in name) for k in OWN_KERNELS}
    own_launches = {k: sum(1 for e in kernels if k in e.name) for k in OWN_KERNELS}
    ops = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CPU]
    dev_attr = "self_device_time_total" if hasattr(ops[0], "self_device_time_total") else (
        "self_cuda_time_total")
    top_ops = sorted(((a.key, getattr(a, dev_attr) / 1e3, a.count) for a in ops),
                     key=lambda t: -t[1])[:ROWS]
    top_host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count) for a in ops),
                      key=lambda t: -t[1])[:ROWS]
    syncs = {a.key: a.count for a in ops if a.key in SYNC_OPS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    total_ms = sum(by_kernel.values())
    report = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "scene": args.scene,
        "path": "large_scene" if args.large_scene else render_path(scene),
        "shape": [st.width, st.height, st.samples_per_pixel, st.max_depth],
        "wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "kernel_launches": len(kernels), "kernel_ms_total": total_ms,
        "own_kernel_ms": own_ms, "own_kernel_launches": own_launches,
        "other_kernel_ms": total_ms - sum(own_ms.values()), "host_syncs": syncs,
        "top_kernels_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:ROWS],
        "top_ops_self_device_ms_count": top_ops,
        "top_ops_self_host_ms_count": top_host,
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
