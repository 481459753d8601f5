"""Count the work of kernel 2's culled closest hit on a large render's own
call, and give its bounds per lane and per warp.

    python -m raytracer_tpu_torch.utils.cull_work --scene rand_spheres_large --spp 64
    python -m raytracer_tpu_torch.utils.cull_work --scene rand_spheres_large \\
        --n-spheres 50000 --spp 64 [--jax-tables]

Runs the culled instantiation's plain twin (integrator/wavefront.py:
regen_plain with return_work) on the render's call: the scene clustered by
render/driver.py:cluster_for_render, 400x225 (or --width), the render's
lanes, seed 0. Prints one JSON line: segments, the six per-lane work totals
and the six warp-union totals with the warp steps (ClusterVisit.hit_work),
both bounds and the warp-union SIMT efficiency (utils/bounds.py:
culled_bounds), and the twin's seconds. Runs on the card unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def count(scene, cam, st, *, device="cuda", wavefront=None, seed=0) -> dict:
    """The twin's work counts and bounds on `scene`'s render call."""
    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.geometry.intersect import quad_derived
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.materials.packed import texture_tables
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.render.driver import DEFAULT_WAVEFRONT, cluster_for_render
    from raytracer_tpu_torch.utils.bounds import culled_bounds, culled_bytes

    t0 = time.perf_counter()
    scene_cl, cs = cluster_for_render(scene, cam)
    sc = scene_cl.to(device)
    w, h, spp = st.width, st.height, st.samples_per_pixel
    n, num_slots, jump = wf.strided_schedule(w * h, spp, wavefront or DEFAULT_WAVEFRONT)
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, w, h), cam.background).to(device)
    _, segs, work, warp_work = wf.regen_plain(
        *pk.pack_persistent_tables(sc), cam_s, seed,
        *wf.schedule_arrays(n, w * h, spp, w, device=device), width=w, height=h,
        jump_px=jump % w, jump_py=jump // w, num_slots=num_slots, max_depth=st.max_depth,
        rr_start=5, rr_lo=0.05, rr_hi=0.75, sky_gradient=st.sky_gradient,
        max_iters=pk.max_iters_for(num_slots, st.max_depth),
        textures=texture_tables(sc, quad_derived(sc)), clusters=pk.pack_cluster_table(cs, device),
        return_work=True)
    segments = int(segs.sum())
    totals = work.long().sum(1).tolist()
    rows = [len(x) for x in cs[:4]]
    b = culled_bounds(segments, totals, warp_work.tolist(), culled_bytes(
        3 * num_slots * n * 4, n, rows, sc.num_spheres, sc.num_quads))
    return dict(segments=segments, lanes=n, cluster_rows=rows,
                work=dict(zip(("slab", "sphere", "quad", "sphere_roots", "quad_divisions",
                               "quad_in_quad"), totals)),
                warp_union=dict(zip(("slab", "sphere", "quad", "sphere_roots", "quad_divisions",
                                     "quad_in_quad", "warp_steps"), warp_work.tolist())),
                bound_ms=b["per_lane"][0], bound_by=b["per_lane"][1],
                warp_bound_ms=b["warp_union"][0], warp_bound_by=b["warp_union"][1],
                simt_efficiency=b["simt_efficiency"], seconds=time.perf_counter() - t0)


def main(argv=None) -> dict:
    from raytracer_tpu_torch.scenes.registry import get_scene

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="rand_spheres_large")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--n-spheres", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jax-tables", action="store_true",
                    help="cluster at the JAX driver's granularity (64 / 16 for both kinds), "
                         "with no oversized primitive isolated")
    args = ap.parse_args(argv)
    if args.jax_tables:
        from raytracer_tpu_torch.render import driver

        driver.CLUSTER_GRAIN = {"sph": (64, 16), "quad": (64, 16)}
        driver.CLUSTER_OVERSIZE = float("inf")
    kw = {k: v for k, v in (("width", args.width), ("n_spheres", args.n_spheres)) if v}
    scene, cam, st = get_scene(args.scene, spp=args.spp, **kw)
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = dict(scene=args.scene, size=[st.width, st.height], spp=args.spp,
               max_depth=st.max_depth, **kw, jax_tables=args.jax_tables, nvidia_smi=smi,
               **count(scene, cam, st, device=args.device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
