"""Inverse-rendering demo (port of scripts/inverse_render_demo.py).

Stage 1: recover the sphere albedos from a target image by gradient descent
through the differentiable renderer (scan backend).
Stage 2: recover a laterally displaced sphere center at 224x126 through
make_inverse_renderer(backend="bucketed", boundary=True,
shadow_edges=True), the tape-kernel forward composed with the silhouette
and shadow edge terms; a finite-difference check of the composed gradient
at the wrong start goes into history.json.
Stage 3: recover an out-of-frame blocker's position from the shadow it
casts alone: interior and primary-boundary gradients are zero on this axis,
so only the shadow-edge term (diff/shadow_edge.py) moves the optimizer.
Stage 4: recover the width of a dark quad hidden behind a glass sphere,
seen only through it: only the refracted-edge term
(diff/refracted_edge.py) carries this axis.

    python -m raytracer_tpu_torch.scripts.inverse_render_demo [--device cpu]
        [--checkpoint] [--out out/inverse]

Writes target.png, init.png, recovered.png, geometry_recovered.png,
shadow_target.png, shadow_recovered.png, glass_target.png,
glass_recovered.png and history.json under --out. Runs on the card
unless --device cpu; each stage is a function of its sizes and step
counts (the defaults are the JAX demo's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from raytracer_tpu_torch.core.camera import make_camera
from raytracer_tpu_torch.diff.boundary import make_boundary_image_fn
from raytracer_tpu_torch.diff.bucketed import make_bucketed_grad_fn
from raytracer_tpu_torch.diff.grad import (
    make_inverse_renderer,
    render_linear_diff,
    render_loss,
    split_scene,
)
from raytracer_tpu_torch.diff.opt_checkpoint import opt_fingerprint, run_optimization
from raytracer_tpu_torch.diff.refracted_edge import (
    RefractedEdgeConfig,
    make_refracted_boundary_fn,
)
from raytracer_tpu_torch.diff.shadow_edge import ShadowEdgeConfig, make_shadow_boundary_fn
from raytracer_tpu_torch.geometry.scene import SceneBuilder
from raytracer_tpu_torch.imgio.image import write_png
from raytracer_tpu_torch.render.driver import resolve_device
from raytracer_tpu_torch.render.postprocess import to_u8

TRUE_ALBEDO0, TRUE_ALBEDO1 = (0.70, 0.15, 0.10), (0.10, 0.25, 0.75)
CENTER1 = (1.1, -0.1, -3.2)
TARGET_BX, START_BX = 0.35, -0.25  # stage 3: the blocker's x
TRUE_UX, START_UX = 1.0, 0.55  # stage 4: the hidden quad's width


def render(scene, cam, seed: int, **kw):
    with torch.no_grad():
        return render_linear_diff(scene, cam, seed, **kw)


def save_png(path: str, img) -> None:
    write_png(path, to_u8(img).cpu().numpy())


def mean_render(scene, cam, seeds, **kw):
    return torch.stack([render(scene, cam, s, **kw) for s in seeds]).mean(0)


def build_scene(albedo0, albedo1, center1):
    b = SceneBuilder(0)
    b.add_sphere((-1.1, 0.0, -3.0), 1.0, b.lambertian(tuple(albedo0)))
    b.add_sphere(tuple(center1), 0.8, b.lambertian(tuple(albedo1)))
    b.add_sphere((0.0, -101.0, -3.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    return b.build()


def stage_albedo(out_dir: str, device, *, size: int = 96, spp: int = 8, max_depth: int = 5,
                 steps: int = 300, checkpoint: bool = False) -> dict:
    """Stage 1: the two spheres' albedos from a grey start."""
    cam, _ = make_camera(1.0, size, fov_degrees=55, look_from=(0, 0.3, 1), look_at=(0, 0, -3))
    kw = dict(width=size, height=size, samples_per_pass=spp, max_depth=max_depth,
              sky_gradient=True)
    target = render(build_scene(TRUE_ALBEDO0, TRUE_ALBEDO1, CENTER1).to(device), cam, 99, **kw)
    save_png(f"{out_dir}/target.png", target)
    scene0 = build_scene((0.4, 0.4, 0.4), (0.4, 0.4, 0.4), CENTER1)
    save_png(f"{out_dir}/init.png", render(scene0.to(device), cam, 1, **kw))
    params, opt, step = make_inverse_renderer(scene0, cam, target, trainable=("tex_c0",),
                                              learning_rate=3e-2, device=device, **kw)
    history = []

    def log_step(i, loss, every=20):
        if i % every == 0 or i == steps - 1:
            history.append({"step": i, "loss": loss})
            print(f"step {i:4d}  loss {loss:.6f}", flush=True)

    t0 = time.perf_counter()
    run_optimization(step, params, opt, n_steps=steps, seed=7,
                     fingerprint=opt_fingerprint(scene0, cam, target, ("tex_c0", 3e-2, kw), 7),
                     checkpoint_path=f"{out_dir}/opt_stage1.npz" if checkpoint else None,
                     save_every=25, on_step=log_step)
    wall = time.perf_counter() - t0
    final = dataclasses.replace(scene0.to(device), tex_c0=params["tex_c0"].detach())
    save_png(f"{out_dir}/recovered.png", render(final, cam, 2, **kw))
    tex = params["tex_c0"].detach().cpu()
    return {"wall_s": round(wall, 1), "loss_history": history,
            "recovered_albedo0": [round(float(x), 3) for x in tex[0]],
            "true_albedo0": list(TRUE_ALBEDO0),
            "recovered_albedo1": [round(float(x), 3) for x in tex[1]],
            "true_albedo1": list(TRUE_ALBEDO1)}


def stage_geometry(out_dir: str, device, *, width: int = 224, height: int = 126, spp: int = 8,
                   max_depth: int = 5, steps: int = 150, fd_seeds: int = 4,
                   checkpoint: bool = False) -> dict:
    """Stage 2: a displaced sphere center through the bucketed backend
    with the boundary and shadow edge terms, with an FD check of the
    composed gradient at the wrong start."""
    cam, _ = make_camera(width / height, width, fov_degrees=55, look_from=(0, 0.3, 1),
                         look_at=(0, 0, -3))
    kw = dict(width=width, height=height, samples_per_pass=spp, max_depth=max_depth,
              sky_gradient=True)
    true_scene = build_scene(TRUE_ALBEDO0, TRUE_ALBEDO1, CENTER1).to(device)
    target = render(true_scene, cam, 98, **kw)
    center = true_scene.sph_center.clone()
    center[1] += torch.tensor([0.45, -0.3, 0.0], device=center.device)
    wrong = dataclasses.replace(true_scene, sph_center=center)

    # FD (common random numbers) on the displaced sphere's x at the wrong
    # start against the composed bucketed gradient there.
    def loss_at(dx, seed):
        c = center.clone()
        c[1, 0] += dx
        img = render(dataclasses.replace(wrong, sph_center=c), cam, seed, **kw)
        return float(torch.mean((img - target) ** 2))

    h = 0.05
    fd = float(np.mean([(loss_at(h, 550 + i) - loss_at(-h, 550 + i)) / (2 * h)
                        for i in range(fd_seeds)])) if fd_seeds else None
    params2, rebuild2 = split_scene(wrong, ("sph_center",))
    edge_kw = dict(width=width, height=height, max_depth=max_depth, sky_gradient=True)
    gfn = make_bucketed_grad_fn(rebuild2, cam, target, edge_image_fns=(
        make_boundary_image_fn(rebuild2, **edge_kw), make_shadow_boundary_fn(rebuild2, **edge_kw)),
        **kw)
    ad = float(np.mean([float(gfn(params2, 600 + i)[1]["sph_center"][1, 0])
                        for i in range(fd_seeds)])) if fd_seeds else None
    print(f"geometry FD check (composed bucketed): fd {fd}  ad {ad}", flush=True)

    params, opt, step = make_inverse_renderer(wrong, cam, target, trainable=("sph_center",),
                                              learning_rate=2e-2, boundary=True,
                                              shadow_edges=True, backend="bucketed",
                                              device=device, **kw)
    history = []

    def log_step(i, loss):
        if i % 25 == 0 or i == steps - 1:
            history.append({"step": i, "loss": loss})
            print(f"geo step {i:4d}  loss {loss:.6f}", flush=True)

    t0 = time.perf_counter()
    run_optimization(step, params, opt, n_steps=steps, seed=13,
                     fingerprint=opt_fingerprint(wrong, cam, target, (
                         "sph_center", 2e-2, "boundary+shadow bucketed", kw), 13),
                     checkpoint_path=f"{out_dir}/opt_stage2.npz" if checkpoint else None,
                     save_every=25, on_step=log_step)
    wall = time.perf_counter() - t0
    got = params["sph_center"].detach()
    save_png(f"{out_dir}/geometry_recovered.png",
             render(dataclasses.replace(wrong, sph_center=got), cam, 3, **kw))
    return {"wall_s": round(wall, 1), "size": [width, height],
            "backend": "bucketed+boundary+shadow_edges", "fd_grad_cx": fd, "ad_grad_cx": ad,
            "loss_history": history,
            "recovered_center1": [round(float(x), 3) for x in got[1].cpu()],
            "true_center1": list(CENTER1),
            "init_center1": [round(float(x), 3) for x in center[1].cpu()]}


def shadow_scene(bx: float, decoys: int = 14):
    """Ground, an overhead area light, the blocker quad at x = bx and fixed
    decoy blockers (known geometry)."""
    b = SceneBuilder(0)
    white = b.lambertian((0.73, 0.73, 0.73))
    light = b.diffuse_light((15, 15, 15))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), white)
    b.add_quad((-1, 3, -1), (2, 0, 0), (0, 0, 2), light)
    b.add_quad((bx - 0.6, 1.5, -0.6), (1.2, 0, 0), (0, 0, 1.2), white)
    rng = np.random.default_rng(4)
    for _ in range(decoys):
        x, z = rng.uniform(-3.5, 3.5, 2)
        yq = float(rng.uniform(0.7, 2.4))
        b.add_quad((float(x) - 0.25, yq, float(z) - 0.25), (0.5, 0, 0), (0, 0, 0.5), white)
    return b.build()


def _masked_adam_run(params, rebuild, cam, target, edge_fn, key, index, *, lr, decay_steps,
                     decay_rate, steps, seed0, kw, log, every):
    """Adam on params[key][index] alone (the other entries are known) with
    an exponentially decaying step size (optax.exponential_decay's curve),
    the loss the render plus `edge_fn`'s image against `target`. Returns
    the trained value after each step."""
    leaf = params[key]
    mask = torch.zeros_like(leaf)
    mask[index] = 1.0
    opt = torch.optim.Adam([leaf], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: decay_rate ** (i / decay_steps))
    hist = []
    for i in range(steps):
        loss = render_loss(params, rebuild, cam, seed0 + i, target, edge_image_fns=(edge_fn,),
                           **kw)
        (g,) = torch.autograd.grad(loss, [leaf])
        leaf.grad = g * mask
        opt.step()
        sched.step()
        hist.append(float(leaf.detach()[index]))
        if i % every == 0 or i == steps - 1:
            log(i, float(loss.detach()), hist[-1])
    return hist


def stage_shadow(out_dir: str, device, *, size: int = 96, spp: int = 32, steps: int = 80,
                 fd_seeds: int = 4, target_seeds: int = 8, decoys: int = 14) -> dict:
    """Stage 3: the out-of-frame blocker's x from its shadow, 1024
    cotangent-sampled receivers and 4 sources each."""
    cam, _ = make_camera(1.0, size, fov_degrees=38, look_from=(3.5, 1.0, 0.0),
                         look_at=(0.0, 0.0, 0.0), background=(0, 0, 0))
    kw = dict(width=size, height=size, samples_per_pass=spp, max_depth=3, sky_gradient=False)
    target = mean_render(shadow_scene(TARGET_BX, decoys).to(device), cam,
                         range(100, 100 + target_seeds), **kw)
    save_png(f"{out_dir}/shadow_target.png", target)
    params, rebuild = split_scene(shadow_scene(START_BX, decoys).to(device), ("quad_q",))
    shadow_fn = make_shadow_boundary_fn(rebuild, width=size, height=size, max_depth=3,
                                        config=ShadowEdgeConfig(samples_per_quad_edge=8,
                                                                spp_edge=2, receivers=1024,
                                                                sources_per_receiver=4))

    # FD check on the blocker's x (CRN pairs): interior autodiff alone
    # reads ~0 here; the shadow-edge gradient must land near FD.
    def loss_at(bx, seed):
        img = render(shadow_scene(bx, decoys).to(device), cam, seed, **kw)
        return float(torch.mean((img - target) ** 2))

    def ad_at(seed):
        loss = render_loss(params, rebuild, cam, seed, target, edge_image_fns=(shadow_fn,), **kw)
        return float(torch.autograd.grad(loss, [params["quad_q"]])[0][2, 0])

    h = 0.05
    fd = float(np.mean([(loss_at(START_BX + h, 770 + i) - loss_at(START_BX - h, 770 + i))
                        / (2 * h) for i in range(fd_seeds)])) if fd_seeds else None
    ad = float(np.mean([ad_at(500 + i) for i in range(fd_seeds)])) if fd_seeds else None
    print(f"shadow FD check: fd {fd}  ad {ad}", flush=True)

    t0 = time.perf_counter()
    hist = _masked_adam_run(
        params, rebuild, cam, target, shadow_fn, "quad_q", (2, 0), lr=0.08, decay_steps=30,
        decay_rate=0.35, steps=steps, seed0=1000, kw=kw, every=16,
        log=lambda i, loss, q: print(f"shadow step {i:3d}  loss {loss:.5f}  bx {q + 0.6:+.3f}",
                                     flush=True))
    wall = time.perf_counter() - t0
    bx = [round(q + 0.6, 4) for q in hist]
    save_png(f"{out_dir}/shadow_recovered.png", render(rebuild(params), cam, 3, **kw))
    return {"wall_s": round(wall, 1), "size": [size, size], "n_prims": 3 + decoys,
            "recovered_bx": round(float(np.mean(bx[-6:])), 3), "true_bx": TARGET_BX,
            "init_bx": START_BX, "bx_history": bx, "fd_grad_bx": fd, "ad_grad_bx": ad}


def glass_scene(ux: float):
    """A glass sphere in front of a dark quad of width ux, which it hides."""
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -2.0), 0.8, b.dielectric(1.5))
    b.add_quad((-0.5, -0.5, -4.0), (float(ux), 0, 0), (0, 1.0, 0),
               b.lambertian((0.05, 0.05, 0.05)))
    return b.build()


def stage_glass(out_dir: str, device, *, size: int = 48, spp: int = 32, steps: int = 50,
                target_seeds: int = 4) -> dict:
    """Stage 4: the hidden quad's width through the glass."""
    cam, _ = make_camera(1.0, size, fov_degrees=40, look_from=(0, 0, 1), look_at=(0, 0, -2),
                         background=(1.0, 1.0, 1.0))
    kw = dict(width=size, height=size, samples_per_pass=spp, max_depth=6)
    target = mean_render(glass_scene(TRUE_UX).to(device), cam, range(300, 300 + target_seeds),
                         **kw)
    save_png(f"{out_dir}/glass_target.png", target)
    params, rebuild = split_scene(glass_scene(START_UX).to(device), ("quad_u",))
    refr_fn = make_refracted_boundary_fn(rebuild, width=size, height=size, max_depth=6,
                                         config=RefractedEdgeConfig(samples_per_quad_edge=32,
                                                                    spp_edge=8))
    t0 = time.perf_counter()
    hist = _masked_adam_run(
        params, rebuild, cam, target, refr_fn, "quad_u", (0, 0), lr=0.05, decay_steps=20,
        decay_rate=0.5, steps=steps, seed0=2000, kw=kw, every=10,
        log=lambda i, loss, u: print(f"glass step {i:3d}  loss {loss:.5f}  ux {u:+.3f}",
                                     flush=True))
    wall = time.perf_counter() - t0
    save_png(f"{out_dir}/glass_recovered.png", render(rebuild(params), cam, 5, **kw))
    return {"wall_s": round(wall, 1), "size": [size, size],
            "recovered_ux": round(float(np.mean(hist[-6:])), 3), "true_ux": TRUE_UX,
            "init_ux": START_UX, "ux_history": [round(u, 4) for u in hist[::5]]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="out/inverse")
    ap.add_argument("--checkpoint", action="store_true",
                    help="resumable stages 1-2 (diff/opt_checkpoint.py): rerun to continue")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    result = stage_albedo(args.out, device, checkpoint=args.checkpoint)
    result["geometry"] = stage_geometry(args.out, device, checkpoint=args.checkpoint)
    result["shadow"] = stage_shadow(args.out, device)
    result["glass"] = stage_glass(args.out, device)
    if device.type == "cuda":
        result["device"] = torch.cuda.get_device_name(device)
    with open(f"{args.out}/history.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
