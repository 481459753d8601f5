"""One sharded training and rendering round over an initialised process group
(the port's counterpart of `__graft_entry__.py:dryrun_multichip`).

    python -m torch.distributed.run --nproc-per-node 2 -m raytracer_tpu_torch.parallel.dryrun --device cpu

`dryrun_multichip(world, device)` runs, on every rank of a group of `world`
ranks, at tiny shapes:

1. the sharded differentiable step (parallel/train.py:
   make_sharded_scan_grad_fn) and one torch.optim.Adam update on every
   rank: the gradients equal on every rank and within rtol 1e-5 of the sum
   of every position's partial gradients computed in this process; the
   parameters equal on every rank after the update, and moved;
2. the sharded bucketed step (make_sharded_bucketed_grad_fn, kernel 3),
   held the same way;
3. the sharded regenerative render (render_regen_sharded) with an spp
   (5) that the world size need not divide: every sample traced, the
   framebuffer the in-process sum of the positions' partials bit for bit
   at two ranks or fewer (rtol 1e-6 past that: the all-reduce's sum order
   is its own);
4. the same render on a 41-primitive scene cut into a two-level cluster
   table (geometry.bvh.cluster_scene at max_leaf 4, super_fan 2), through
   kernel 2's culled instantiation.

Any failure raises. Rank 0 prints one summary line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.camera import RenderSettings, make_camera
from raytracer_tpu_torch.diff.bucketed import flat_leaves, image_loss
from raytracer_tpu_torch.diff.grad import split_scene
from raytracer_tpu_torch.geometry.bvh import cluster_scene
from raytracer_tpu_torch.geometry.scene import SceneBuilder
from raytracer_tpu_torch.ops import intersect_kernel as ik
from raytracer_tpu_torch.ops import persistent_kernel as pk
from raytracer_tpu_torch.parallel.mesh import close_group, init_group, make_mesh
from raytracer_tpu_torch.parallel.shard import render_regen_sharded
from raytracer_tpu_torch.parallel.train import (
    make_sharded_bucketed_grad_fn,
    make_sharded_scan_grad_fn,
)
from raytracer_tpu_torch.render.driver import chunk_renderer, regen_partial
from raytracer_tpu_torch.scenes.registry import get_scene

GRAD_RTOL = 1e-5


def _flat(tree: dict) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for _, t in flat_leaves(tree)])


def _same_on_every_rank(label: str, t: torch.Tensor) -> None:
    every = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(every, t.contiguous())
    if not all(torch.equal(e, t) for e in every):
        raise RuntimeError(f"dryrun: {label} differ across ranks")


def _hold(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise unless `got` is within GRAD_RTOL of `want` (relative to the
    largest entry of `want`); returns the relative distance."""
    rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if not torch.isfinite(got).all() or rel > GRAD_RTOL:
        raise RuntimeError(f"dryrun: {label} {rel:.3g} from the in-process sum (rtol {GRAD_RTOL})")
    return rel


def _summed(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _cluster_scene():
    """The JAX dryrun's culling scene: 40 lambertian spheres and a ground
    quad, 8x8 at 2 spp and depth 2."""
    b = SceneBuilder(0)
    lam = b.lambertian((0.6, 0.5, 0.4))
    rng = np.random.default_rng(3)
    for _ in range(40):
        b.add_sphere(rng.uniform(-6, 6, 3), rng.uniform(0.3, 0.9), lam)
    b.add_quad((-8, -7, -8), (16, 0, 0), (0, 0, 16), lam)
    cam, _ = make_camera(1.0, 8, samples_per_pixel=2, max_depth=2, background=(0.4, 0.5, 0.6),
                         look_from=(0, 0, 14), look_at=(0, 0, 0), fov_degrees=50)
    return b.build(), cam


def dryrun_multichip(world: int, device="cuda") -> dict:
    """Run the four checks of the module docstring on every rank of the
    initialised group (of `world` ranks) on `device` ("cuda" or "cpu");
    returns rank-local readings (launch counts of the sharded calls,
    losses, relative gaps to the in-process sums)."""
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise RuntimeError(f"dryrun_multichip({world}) needs an initialised group of {world} ranks")
    dev = torch.device(device)
    mesh = make_mesh(world, sample_parallel=2 if world % 2 == 0 else 1, device=dev)
    exact = world <= 2
    width, height, depth = 16, 9, 3
    n = width * height
    k = 2 * mesh.shape[1]
    scene, cam, _ = get_scene("rand_spheres", width=width, spp=k, max_depth=depth)
    params, rebuild = split_scene(scene.to(dev))
    target = torch.zeros(height, width, 3, device=dev)
    shape_kw = dict(width=width, height=height, samples_per_pass=k, max_depth=depth)
    out = {"mesh": list(mesh.shape), "backend": mesh.backend, "device": dev.type}

    # 1. The sharded differentiable step and one Adam update on every rank.
    step = make_sharded_scan_grad_fn(rebuild, cam, target, mesh, **shape_kw)
    before = ik.LAUNCHES
    loss, grads = step(params, 0)
    out["scan_closest_hit_launches"] = ik.LAUNCHES - before
    parts = [step.partial(params, 0, p) for p in range(world)]
    img_sum = _summed([p.detach() for p in parts])
    _, ct_img = image_loss(img_sum, target, k)
    ref = _summed([_flat(step.grads(params, p, ct_img)) for p in parts])
    out["scan_grad_rel"] = _hold("scan-step gradients", _flat(grads), ref)
    _same_on_every_rank("scan-step gradients", _flat(grads))
    leaves = [t for _, t in flat_leaves(params)]
    start = _flat(params).clone()
    opt = torch.optim.Adam(leaves, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for (_, p), (_, g) in zip(flat_leaves(params), flat_leaves(grads)):
        p.grad = g
    opt.step()
    _same_on_every_rank("parameters after the Adam step", _flat(params))
    if not (torch.isfinite(loss) and bool((_flat(params) != start).any())):
        raise RuntimeError(f"dryrun: scan step loss {float(loss)}, parameters moved "
                           f"{bool((_flat(params) != start).any())}")
    out["loss"] = float(loss)

    # 2. The sharded bucketed step.
    bstep = make_sharded_bucketed_grad_fn(rebuild, cam, target, mesh, **shape_kw)
    before = pk.LAUNCHES_TAPE
    bloss, bgrads = bstep(params, 5)
    out["tape_launches"] = pk.LAUNCHES_TAPE - before
    tapes = [bstep.forward(params, 5, p) for p in range(world)]
    bloss_ref, ct_img = image_loss(_summed([t.img_sum for t in tapes]), target, k)
    ref = _summed([_flat(bstep.backward(params, t, ct_img)) for t in tapes])
    out["bucketed_grad_rel"] = _hold("bucketed-step gradients", _flat(bgrads), ref)
    _same_on_every_rank("bucketed-step gradients", _flat(bgrads))
    if not torch.isfinite(bloss) or (exact and float(bloss) != float(bloss_ref)):
        raise RuntimeError(f"dryrun: bucketed loss {float(bloss)} vs in-process {float(bloss_ref)}")
    out["bucketed_loss"] = float(bloss)

    # 3. The sharded regenerative render, spp 5 over `world` ranks.
    scene = scene.to(dev)
    settings = RenderSettings(width, height, 5, depth)
    kw = dict(width=width, height=height, spp=5, max_depth=depth, wavefront=1024)
    before = pk.LAUNCHES
    fb, stats = render_regen_sharded(scene, cam, 1, mesh, **kw)
    out["regen_launches"] = pk.LAUNCHES - before
    renderer = chunk_renderer(scene, cam, settings, dev, wavefront=1024)
    want = _summed([regen_partial(renderer, 5, 1, p, world)[0] for p in range(world)])
    _check_image("regen render", fb.reshape(-1, 3), want, exact)
    if stats.segments < n * 5:
        raise RuntimeError(f"dryrun: regen render traced {stats.segments} segments, < {n * 5}")
    out["regen_segments"] = stats.segments

    # 4. The same render on a small two-level cluster table (kernel 2 culled).
    big, big_cam = _cluster_scene()
    big_cl, cs = cluster_scene(big, max_leaf=4, super_fan=2, min_fine_for_super=2)
    if cs.sph_super.shape[0] <= 1 or cs.quad.shape[0] < 1:
        raise RuntimeError(f"dryrun: cluster table lost a level: {cs.sph_super.shape[0]} "
                           f"supers, {cs.quad.shape[0]} quad rows")
    before = pk.LAUNCHES
    fb2, stats2 = render_regen_sharded(big_cl.to(dev), big_cam, 3, mesh, width=8, height=8,
                                       spp=2, max_depth=2, wavefront=1024, clusters=cs)
    out["culled_launches"] = pk.LAUNCHES - before
    if not (torch.isfinite(fb2).all() and float(fb2.mean()) > 0 and stats2.segments >= 128):
        raise RuntimeError(f"dryrun: clustered render mean {float(fb2.mean())}, "
                           f"segments {stats2.segments}")
    out["culled_segments"] = stats2.segments
    out["cluster_rows"] = [int(cs.sph_super.shape[0]), int(cs.sph.shape[0]),
                           int(cs.quad_super.shape[0]), int(cs.quad.shape[0])]
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: world {world}, {json.dumps(out)}", flush=True)
    return out


def _check_image(label, got, want, exact: bool) -> None:
    ok = torch.equal(got, want) if exact else torch.allclose(got, want, rtol=1e-6, atol=0.0)
    if not ok or not torch.isfinite(got).all():
        raise RuntimeError(f"dryrun: {label} differs from the in-process sum of its ranks")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)
    init_group(args.device)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
               else torch.device("cpu"))
        dryrun_multichip(dist.get_world_size(), dev)
    finally:
        close_group()


if __name__ == "__main__":
    main()
