"""Time every render and training path's wall in one process, warm, for an
A/B of two checkouts in turns.

    python -m raytracer_tpu_torch.utils.time_paths [--reps 5] [--paths a,b,...] \
        [--rounds 1] [--variant NAME:KEY=VALUE,...]...

Paths (each through the entry point a user calls; the kernels built and
each path run once before its timed runs):

* `culled_large`, `culled_quad_field`: the CLI on rand_spheres_large and
  quad_field at --spp 64 (kernel 2's culled instantiation; every CLI call
  builds its scene anew, so its wall holds a cold host clustering);
* `culled_50k`: `render_image` on rand_spheres_large with 50,000 spheres
  at 400x225@64spp depth 8, each run on a scene built anew before it (a
  cold host clustering inside the wall), ended by a device sync;
  `culled_50k_cached` the same on one scene, so every run after the
  first finds its clustering cached;
* `textured_perlin`, `textured_earth`, `textured_simple_light`: the CLI on
  perlin, earth and simple_light at --spp 100 (kernel 2 textured);
* `wavefront_step`: `render_image` on perlin with rng-filled Perlin tables
  (kernel 5 and the PyTorch epilogue), ended by a device sync;
* `large_scene`: render_loop's large-scene path on rand_spheres_large at
  400x225@64spp depth 8 (kernels 4 and 1), each run on a scene built
  anew and moved to the card before it (its host clustering cold inside
  the wall), ended by a device sync; `large_scene_cached` the same on one
  scene on the card, so every run after the first finds its clustering
  cached;
* `bucketed_step`, `scan_step`: one `make_inverse_renderer` Adam step of
  each backend on rand_spheres at 400x225, 8 spp, depth 50 from texture
  colors halved (chip_smoke.py phase 7's shape), ended by a device sync;
  `boundary_step` the bucketed step with `boundary=True` (phase 12),
  `grad_full_step` with `boundary=True, shadow_edges=True`, training
  sph_center, sph_radius and tex_c0 (phase 14, the JAX package's
  `grad_full`). Each step is built at its path's first (warm) run, so a
  checkout without an option fails only on the path that needs it.

The CLI's own report gives the CLI walls; the others are host seconds
around the call. The culled paths also report each run's host clustering
seconds (`cluster_s`). A variant sets the clustering of the culled paths where
the checkout's render/driver.py has these settings (`sph`, `quad`:
CLUSTER_GRAIN's leaf/fan of each kind, e.g. `sph=32/16`; `oversize`:
CLUSTER_OVERSIZE); rounds run the variants in turns (forwards, then
backwards). Prints one JSON line per (round, variant, path) with every
timed wall and a summary line of medians over the rounds. To compare
checkouts on one card, run it from each checkout's root in turns (parent,
change, change, parent) with `PYTHONPATH=.`; the rand_spheres CLI has its
own script, utils/time_cli.py.
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
    """{path: zero-argument call returning that run's {"wall_s": seconds},
    with "cluster_s" on the culled paths}."""
    import torch

    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.diff.grad import make_inverse_renderer, render_linear_diff
    from raytracer_tpu_torch.render.driver import render_image, render_loop
    from raytracer_tpu_torch.scenes.registry import get_scene
    from raytracer_tpu_torch.utils.metrics import RenderMetrics

    def cli_run(name, argv):
        rep = cli.main(argv + ["--out", str(out_dir / f"{name}.png")])
        return {k: rep[k] for k in ("wall_s", "cluster_s") if k in rep}

    runners = {name: (lambda argv=argv, name=name: cli_run(name, argv))
               for name, argv in CLI_PATHS.items()}

    def render_50k(scene=None):
        if scene is None:  # new tensors: a cold host clustering
            scene = get_scene("rand_spheres_large", spp=64, n_spheres=50000)[0]
        st = big[2]
        m = RenderMetrics(total_spp=st.samples_per_pixel, pixels=st.width * st.height)
        wall = _synced(lambda: render_image(scene, big[1], st, device="cuda", seed=0, metrics=m))
        return dict(wall_s=wall, cluster_s=m.cluster_s)

    big = get_scene("rand_spheres_large", spp=64, n_spheres=50000)
    runners["culled_50k"] = render_50k
    runners["culled_50k_cached"] = lambda: render_50k(big[0])
    def render_large(scene=None):
        if scene is None:  # new tensors: a cold host clustering
            scene = get_scene("rand_spheres_large", spp=64)[0].to("cuda")
        return dict(wall_s=_synced(lambda: render_loop(scene, large[1], large[2],
                                                        path="large_scene", seed=0)))

    large = get_scene("rand_spheres_large", spp=64)
    large_sc = large[0].to("cuda")
    runners["large_scene"] = render_large
    runners["large_scene_cached"] = lambda: render_large(large_sc)
    scene, cam, st = get_scene("perlin", procedural_perlin=False)
    runners["wavefront_step"] = lambda: dict(wall_s=_synced(
        lambda: render_image(scene, cam, st, device="cuda", seed=0)))

    t_scene, t_cam, t_st = get_scene("rand_spheres", **TRAIN)
    with torch.no_grad():
        target = render_linear_diff(t_scene.to("cuda"), t_cam, 7, width=t_st.width,
                                    height=t_st.height, samples_per_pass=t_st.samples_per_pixel,
                                    max_depth=t_st.max_depth)
    start = dataclasses.replace(t_scene, tex_c0=t_scene.tex_c0 * 0.5)

    def step_runner(**options):
        built, seeds = [], iter(range(101, 10**6))

        def run():
            if not built:
                built.append(make_inverse_renderer(
                    start, t_cam, target, width=t_st.width, height=t_st.height,
                    samples_per_pass=t_st.samples_per_pixel, max_depth=t_st.max_depth,
                    learning_rate=1e-2, device="cuda", **options)[2])
            return dict(wall_s=_synced(lambda: built[0](next(seeds))))

        return run

    runners["bucketed_step"] = step_runner(backend="bucketed")
    runners["scan_step"] = step_runner(backend="scan")
    runners["boundary_step"] = step_runner(backend="bucketed", boundary=True)
    runners["grad_full_step"] = step_runner(
        backend="bucketed", boundary=True, shadow_edges=True,
        trainable=("sph_center", "sph_radius", "tex_c0"))
    return runners


def _set_clustering(variant: dict, defaults: dict):
    """Set the render driver's clustering settings of a variant (its own where it
    names them, else the checkout's)."""
    from raytracer_tpu_torch.render import driver

    if not hasattr(driver, "CLUSTER_GRAIN"):
        if any(k in variant for k in ("sph", "quad", "oversize")):
            raise SystemExit("time_paths: this checkout's render driver has no clustering settings")
        return
    driver.CLUSTER_GRAIN = {kind: tuple(int(x) for x in variant[kind].split("/"))
                            if kind in variant else defaults["grain"][kind]
                            for kind in ("sph", "quad")}
    driver.CLUSTER_OVERSIZE = float(variant.get("oversize", defaults["oversize"]))


def main(argv=None) -> dict:
    import torch

    from raytracer_tpu_torch.ops import build
    from raytracer_tpu_torch.render import driver

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--paths", default="", help="comma-separated paths (default: all)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_paths: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    defaults = dict(grain=dict(getattr(driver, "CLUSTER_GRAIN", {})),
                    oversize=getattr(driver, "CLUSTER_OVERSIZE", None))
    variants = {}
    for text in args.variant:
        name, _, rest = text.partition(":")
        variants[name] = dict(kv.split("=", 1) for kv in rest.split(",") if kv)
    variants = variants or {"default": {}}
    build.load_kernels()
    walls: dict = {v: {} for v in variants}
    clustering: dict = {v: {} for v in variants}
    with tempfile.TemporaryDirectory() as d:
        runners = path_runners(Path(d))
        names = args.paths.split(",") if args.paths else list(runners)
        order = list(variants)
        for r in range(args.rounds):
            for v in order if r % 2 == 0 else order[::-1]:
                _set_clustering(variants[v], defaults)
                for name in names:
                    run = runners[name]
                    run()  # warm: first launches, caches
                    got = [run() for _ in range(args.reps)]
                    line = {"round": r, "variant": v, "settings": variants[v], "path": name}
                    for key, acc in (("wall_s", walls), ("cluster_s", clustering)):
                        if key in got[0]:
                            line[key] = [g[key] for g in got]
                            acc[v].setdefault(name, []).extend(line[key])
                    print(json.dumps(line), flush=True)

    def medians(acc):
        out = {v: {name: statistics.median(w) for name, w in ws.items()} for v, ws in acc.items()}
        return out if len(variants) > 1 else next(iter(out.values()))

    summary = dict(nvidia_smi=smi, median_wall_s=medians(walls),
                   median_cluster_s=medians(clustering))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
