"""Count the rays on which kernel 2's cluster cull would part from the
dense search, for several paddings of its slab test.

    python -m raytracer_tpu_torch.utils.cull_divergence --scene rand_spheres_large --spp 64
    python -m raytracer_tpu_torch.utils.cull_divergence --scene rand_spheres_large \\
        --n-spheres 50000 --spp 16

Runs the culled instantiation's plain twin (integrator/wavefront.py:
regen_plain) on the render's own call: the scene clustered by
render/driver.py:cluster_for_render, the render's lanes, seed 0. At every
closest hit it also takes, for each pad, the winner among the rows whose
padded slab tests (supers and fine rows) enter, with the dense running
best, and counts the rays whose winner (t or primitive) differs from the
dense one. A count above zero at kernel 2's pad
(ops/persistent_kernel.py:CLUSTER_SLAB_PAD) means the kernel cannot equal
its twin bit for bit there. Prints one JSON line. Runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

DEFAULT_PADS = (0.0, 1e-3, 2e-3, 4e-3, 8e-3)


def divergent_rays(visit, o, d, pads) -> dict:
    """{pad: rays of (o, d) whose culled winner differs from the dense one}
    for a ClusterVisit `visit` (one block of rays)."""
    from raytracer_tpu_torch.ops.cluster_visit import _slab_enters
    from raytracer_tpu_torch.ops.intersect_kernel import INF, candidates_scaled, slab_inv

    cands, a = candidates_scaled(visit.sph_rows, visit.quad_rows, o, d)
    t_best, i = cands.min(dim=1)
    before = torch.cat([torch.full_like(cands[:, :1], INF),
                        torch.cummin(cands, dim=1).values[:, :-1]], dim=1)
    inv = slab_inv(d)
    out = {}
    for pad in pads:
        keep = torch.ones_like(cands, dtype=torch.bool)
        for kind in visit.kinds:
            if kind.dense:
                continue
            enter = _slab_enters(kind.fine_box, o, inv, a,
                                 before[:, kind.col0 + kind.fine_col], pad)
            if kind.super_box is not None:
                enter &= _slab_enters(kind.super_box, o, inv, a,
                                      before[:, kind.col0 + kind.super_col], pad)[:, kind.fine_super]
            cols = torch.repeat_interleave(enter, kind.fine_count, dim=1)
            keep[:, kind.col0 : kind.col0 + cols.shape[1]] = cols
        t_c, i_c = torch.where(keep, cands, torch.full_like(cands, INF)).min(dim=1)
        out[pad] = int(((t_c != t_best) | ((i_c != i) & (t_best < INF))).sum())
    return out


def count(scene, cam, st, *, device="cuda", pads=DEFAULT_PADS, wavefront=None, seed=0) -> dict:
    """Run the clustered twin on `scene`'s render call; returns segments,
    seconds and {pad: divergent rays}."""
    from raytracer_tpu_torch.core.camera import camera_frame
    from raytracer_tpu_torch.geometry.intersect import quad_derived
    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.materials.packed import texture_tables
    from raytracer_tpu_torch.ops import cluster_visit as cv
    from raytracer_tpu_torch.ops import persistent_kernel as pk
    from raytracer_tpu_torch.render.driver import DEFAULT_WAVEFRONT, cluster_for_render

    scene_cl, cs = cluster_for_render(scene, cam)
    sc = scene_cl.to(device)
    w, h, spp = st.width, st.height, st.samples_per_pixel
    n, num_slots, jump = wf.strided_schedule(w * h, spp, wavefront or DEFAULT_WAVEFRONT)
    sched = wf.schedule_arrays(n, w * h, spp, w, device=device)
    cam_s = pk.pack_camera_scalars_bg(camera_frame(cam, w, h), cam.background).to(device)
    totals = {pad: 0 for pad in pads}
    real_hit = cv.ClusterVisit.hit

    def hit(visit, o, d):
        step = max(1, cv.WORK_CELLS // max(1, visit.sph_rows.shape[0] + visit.quad_rows.shape[0]))
        for s in range(0, o.shape[0], step):
            for pad, k in divergent_rays(visit, o[s : s + step], d[s : s + step], pads).items():
                totals[pad] += k
        return real_hit(visit, o, d)

    cv.ClusterVisit.hit = hit
    t0 = time.perf_counter()
    try:
        _, segs = wf.regen_plain(
            *pk.pack_persistent_tables(sc), cam_s, seed, *sched, width=w, height=h,
            jump_px=jump % w, jump_py=jump // w, num_slots=num_slots, max_depth=st.max_depth,
            rr_start=5, rr_lo=0.05, rr_hi=0.75, sky_gradient=st.sky_gradient,
            max_iters=pk.max_iters_for(num_slots, st.max_depth),
            textures=texture_tables(sc, quad_derived(sc)),
            clusters=pk.pack_cluster_table(cs, device))
        segments = int(segs.sum())
    finally:
        cv.ClusterVisit.hit = real_hit
    return dict(segments=segments, seconds=time.perf_counter() - t0, kernel_pad=pk.CLUSTER_SLAB_PAD,
                divergent_rays_by_pad={str(p): k for p, k in totals.items()})


def main(argv=None) -> dict:
    from raytracer_tpu_torch.scenes.registry import get_scene

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="rand_spheres_large")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--n-spheres", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pads", type=float, nargs="+", default=list(DEFAULT_PADS))
    args = ap.parse_args(argv)
    kw = {k: v for k, v in (("width", args.width), ("n_spheres", args.n_spheres)) if v}
    scene, cam, st = get_scene(args.scene, spp=args.spp, **kw)
    out = dict(scene=args.scene, size=[st.width, st.height], spp=args.spp,
               max_depth=st.max_depth, **kw, **count(scene, cam, st, device=args.device,
                                                     pads=tuple(args.pads)))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
