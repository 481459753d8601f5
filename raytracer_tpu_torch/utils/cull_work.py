"""Count the work of kernel 2's culled closest hit on a large render's own
call, and give its bounds per lane and per warp; with --camera, kernel 4's
on the large-scene path's first-pass camera rays.

    python -m raytracer_tpu_torch.utils.cull_work --scene rand_spheres_large --spp 64
    python -m raytracer_tpu_torch.utils.cull_work --scene rand_spheres_large \\
        --n-spheres 50000 --spp 64 [--jax-tables]
    python -m raytracer_tpu_torch.utils.cull_work --camera [--samples K]

Runs the culled instantiation's plain twin (integrator/wavefront.py:
regen_plain with return_work) on the render's call: the scene clustered by
render/driver.py:cluster_for_render, 400x225 (or --width), the render's
lanes, seed 0. Prints one JSON line: segments, the six per-lane work totals
and the six warp-union totals with the warp steps (ClusterVisit.hit_work),
both bounds and the warp-union SIMT efficiency (utils/bounds.py:
culled_bounds), and the twin's seconds. Runs on the card unless `--device
cpu` is given.

With --camera (`camera_work`) it counts, on the camera rays of
the large-scene path's first pass (render/driver.py:pass_camera_rays, seed
0; --samples K keeps the first K samples per pixel of the pass), the work
of kernel 4's walk on the render's two-level table (ClusterVisit.hit_work
on cluster_for_render's tables) and on the TPU kernel's flat table
(ops/culled_kernel.py:build_clusters, each warp in the octant order of its
first ray, as the parent CUDA kernel walked it: a two-level walk without
supers), both with the padded slab test of csrc/cluster_walk.cuh.
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


def camera_work(scene, cam, st, *, device="cuda", samples=None, seed=0) -> dict:
    """Kernel 4's per-lane and warp-union work and bounds on the
    large-scene path's first-pass camera rays (or its first `samples`
    samples per pixel), on the two-level table ("two_level") and on the
    TPU kernel's flat table ("flat")."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.geometry.intersect import build_large_scene_tables, scene_tables
    from raytracer_tpu_torch.ops import culled_kernel as ck
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.ops.cluster_visit import ClusterVisit
    from raytracer_tpu_torch.render.driver import (
        TARGET_RAYS_PER_PASS,
        chunk_seed,
        cluster_for_render,
        pass_camera_rays,
        samples_per_pass_for,
    )
    from raytracer_tpu_torch.utils.bounds import WARP, clustered_hit_bytes, culled_bounds

    t0 = time.perf_counter()
    w, h = st.width, st.height
    k = samples or samples_per_pass_for(st.samples_per_pixel, w * h, TARGET_RAYS_PER_PASS)
    o, d = pass_camera_rays(camera_frame(cam, w, h).to(device), chunk_seed(seed, 0), width=w,
                            height=h, k=k)
    rays = o.shape[0]
    warp = torch.arange(rays, device=device) // WARP

    def summary(work, warp_work, rows, nbytes):
        b = culled_bounds(rays, work, warp_work, nbytes)
        return dict(cluster_rows=rows,
                    work=dict(zip(("slab", "sphere", "quad", "sphere_roots", "quad_divisions",
                                   "quad_in_quad"), work)),
                    warp_union=dict(zip(("slab", "sphere", "quad", "sphere_roots",
                                         "quad_divisions", "quad_in_quad", "warp_steps"),
                                        warp_work)),
                    bound_ms=b["per_lane"][0], bound_by=b["per_lane"][1],
                    warp_bound_ms=b["warp_union"][0], warp_bound_by=b["warp_union"][1],
                    simt_efficiency=b["simt_efficiency"], lane_ops_per_ray=b["lane_ops"] / rays,
                    warp_ops_per_ray=b["warp_ops"] / rays)

    scene_cl, cs = cluster_for_render(scene, cam)
    sc = scene_cl.to(device)
    table = pk.pack_cluster_table(cs, device)
    sph, quad = scene_tables(sc)
    _, _, work, warp_work = ClusterVisit.build(table, sph, quad).hit_work(o, d, warp)
    out = dict(rays=rays, samples=k, two_level=summary(
        work.sum(1).tolist(), warp_work.tolist(), list(table.counts),
        clustered_hit_bytes(rays, sum(table.counts), sc.num_spheres, sc.num_quads)))

    flat = build_large_scene_tables(scene.to(device))
    rows = flat.clusters.cpu().numpy()
    octs = ck.warp_octants(d)
    lane_f = np.zeros(6, np.int64)
    warp_f = np.zeros(7, np.int64)
    for oct_id in torch.unique(octs).tolist():
        sel = torch.nonzero(octs == oct_id).squeeze(1)
        walk = rows[flat.cluster_order[oct_id].long().cpu().numpy()]
        ct = pk.ClusterTable(torch.from_numpy(np.ascontiguousarray(walk)).to(device), 0,
                             walk.shape[0], 0, 0)
        _, _, wk, wwk = ClusterVisit.build(ct, flat.sph_clustered, flat.quad_table).hit_work(
            o[sel], d[sel], warp[sel])
        lane_f += wk.sum(1).cpu().numpy()
        warp_f += wwk.cpu().numpy()
    g = rows.shape[0]
    # The flat table's bytes add its (8, G) octant orders and the sphere ids.
    n_cl = flat.sph_clustered.shape[0]
    out["flat"] = summary(lane_f.tolist(), warp_f.tolist(), [g], clustered_hit_bytes(
        rays, g, n_cl, flat.quad_table.shape[0]) + 32 * g + 4 * n_cl)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> dict:
    from raytracer_tpu_torch.scenes.registry import get_scene

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="rand_spheres_large")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--n-spheres", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--camera", action="store_true",
                    help="kernel 4's work on the large-scene path's first-pass camera rays, "
                         "on the two-level and on the flat table")
    ap.add_argument("--samples", type=int, default=None,
                    help="with --camera: the first SAMPLES samples per pixel of the pass")
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
    counted = (camera_work(scene, cam, st, device=args.device, samples=args.samples)
               if args.camera else count(scene, cam, st, device=args.device))
    out = dict(scene=args.scene, size=[st.width, st.height], spp=args.spp,
               max_depth=st.max_depth, **kw, jax_tables=args.jax_tables, nvidia_smi=smi,
               **counted)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
