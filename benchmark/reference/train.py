"""The inverse-rendering step in plain autograd: the image of a scene as
the mean of its samples, the mean squared error against a target, its
gradient in the trainable leaves by a tape replay (tracer.py), and Adam at
betas (0.9, 0.999), eps 1e-8.

An image of `spp` samples per pixel under `seed` takes sample ids 0 ..
spp * n_pixels - 1 (sample s on pixel s mod n_pixels), with no russian
roulette: each path ends on a miss, a light, an absorption or its
`max_depth`-th segment. The loss is the forward's; the gradient is that of
sum(replayed radiance * the loss's cotangent of each sample), the
cotangent taken at the forward's image.
"""

from __future__ import annotations

import torch

from benchmark.reference import tracer
from benchmark.scenes import image_size


def _trace(sc: tracer.RefScene, camera: dict, seed: int, spp: int, max_depth: int, **kw):
    width, height = image_size(camera)
    n = width * height
    dev, dtype = sc.sph_center.device, sc.sph_center.dtype
    return tracer.trace(
        sc, tracer.camera_frame(camera, width).to(dev, dtype), seed,
        torch.arange(spp * n, device=dev), width=width, n_pixels=n, max_depth=max_depth,
        background=torch.tensor(camera["background"], dtype=torch.float32, device=dev),
        sky_gradient=camera.get("sky_gradient", False), **kw)


def mean_image(rad, camera: dict, spp: int):
    width, height = image_size(camera)
    return (rad.reshape(spp, width * height, 3).sum(0) / float(spp)).reshape(height, width, 3)


@torch.no_grad()
def image(sc: tracer.RefScene, camera: dict, seed: int, *, spp: int, max_depth: int):
    """(H, W, 3) mean radiance of `spp` samples a pixel."""
    return mean_image(_trace(sc, camera, seed, spp, max_depth)[0], camera, spp)


def loss_and_grad(sc: tracer.RefScene, leaves: dict, camera: dict, target, seed: int, *,
                  spp: int, max_depth: int):
    """(loss, {leaf: gradient}) of one step from the scene `sc` with
    `leaves` in place."""
    scene = sc.replace(**leaves)
    with torch.no_grad():
        rad, _, tape = _trace(scene, camera, seed, spp, max_depth, record=True)
        img = mean_image(rad, camera, spp)
        loss = torch.mean((img - target) ** 2)
        ct = (2.0 * (img - target) / float(img.numel())).reshape(-1, 3).repeat(spp, 1) / float(spp)
    replay, _ = _trace(scene, camera, seed, spp, max_depth, tape=tape)
    grads = torch.autograd.grad((replay * ct).sum(), list(leaves.values()), allow_unused=True)
    return float(loss), {k: torch.zeros_like(v) if g is None else g
                         for (k, v), g in zip(leaves.items(), grads)}


BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def adam(p, g, m, v, step: int, lr: float):
    """(p, m, v) after Adam's `step`-th update (betas 0.9, 0.999, eps 1e-8,
    bias-corrected) from moments m, v under the gradient g."""
    m = BETA1 * m + (1.0 - BETA1) * g
    v = BETA2 * v + (1.0 - BETA2) * g * g
    m_hat = m / (1.0 - BETA1 ** step)
    v_hat = v / (1.0 - BETA2 ** step)
    return p - lr * m_hat / (torch.sqrt(v_hat) + EPS), m, v


def follow(sc: tracer.RefScene, camera: dict, target, seeds, *, spp: int, max_depth: int,
           lr: float, trainable=tracer.TRAINABLE, drop_half: bool = False,
           states=None) -> dict:
    """Adam steps on the leaves of `sc`, one per seed. The first starts from
    `sc`'s leaves with zero moments; step k + 1 starts from `states[k - 1]`
    where given (the state that the run being judged reached after step k:
    its leaves, "exp_avg" and "exp_avg_sq", each a {leaf: tensor}), else
    from this run's own state.
    Returns each step's loss, gradient and change of the leaves from the
    state it started from, the leaves it started from, and the state after
    each step.
    `drop_half` leaves out the second half of the samples and takes the
    mean over the rest (a planted fault)."""
    dtype = sc.sph_center.dtype
    target = target.to(dtype)
    zero = {k: torch.zeros_like(getattr(sc, k)) for k in trainable}
    state = {"params": {k: getattr(sc, k).detach().clone() for k in trainable},
             "exp_avg": zero, "exp_avg_sq": zero}
    out = {"losses": [], "grads": [], "changes": [], "start": state["params"], "states": []}
    for i, seed in enumerate(seeds):
        if i and states is not None:
            state = {part: {k: v.detach().to(sc.sph_center.device, dtype)
                            for k, v in states[i - 1][part].items()} for part in state}
        leaves = {k: v.clone().requires_grad_(True) for k, v in state["params"].items()}
        loss, grads = loss_and_grad(sc, leaves, camera, target, seed,
                                    spp=spp // 2 if drop_half else spp, max_depth=max_depth)
        out["losses"].append(loss)
        out["grads"].append({k: g.detach().clone() for k, g in grads.items()})
        new = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}}
        with torch.no_grad():
            for k, p in state["params"].items():
                new["params"][k], new["exp_avg"][k], new["exp_avg_sq"][k] = adam(
                    p, grads[k], state["exp_avg"][k], state["exp_avg_sq"][k], i + 1, lr)
        out["changes"].append({k: new["params"][k] - p for k, p in state["params"].items()})
        out["states"].append(new)
        state = new
    return out
