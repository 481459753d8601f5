"""The reference against the program at tiny sizes on the CPU, where the
program runs its kernels' plain twins: the same samples give the same
pixels, and the same step the same loss and gradients."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import compare, rng, tracer
from benchmark.reference import train as reference


@pytest.mark.parametrize("cell", ["rand_spheres.render", "cornell.render"])
def test_pixels_agree(cell):
    from raytracer_tpu_torch.render.driver import render_image

    c = harness.Cell.load(cell, cpu=True)
    desc, (w, h) = c.description(), c.size
    cam, settings = harness.port_camera(c.camera, c.spp, c.max_depth)
    img = render_image(harness.port_scene(desc), cam, settings, device="cpu", seed=2**31 + 7)
    r = c.config["render"]["roulette"]
    ref, segs = tracer.render_pixels(desc, c.camera, 2**31 + 7, torch.arange(w * h), spp=c.spp,
                                     max_depth=c.max_depth,
                                     roulette=(r["start"], r["lo"], r["hi"]), device="cpu")
    assert compare.pixel_gap(img.reshape(-1, 3), ref) < 1e-6
    assert segs >= w * h * c.spp


def test_step_agrees():
    from raytracer_tpu_torch.diff.bucketed import make_bucketed_grad_fn
    from raytracer_tpu_torch.diff.grad import split_scene

    c = harness.Cell.load("rand_spheres.train", cpu=True)
    desc, (w, h) = c.description(), c.size
    sc = tracer.scene_from_description(desc, "cpu")
    target = torch.rand(h, w, 3, generator=torch.Generator().manual_seed(3))
    params, rebuild = split_scene(harness.port_scene(desc))
    cam, _ = harness.port_camera(c.camera, c.spp, c.max_depth)
    step = make_bucketed_grad_fn(rebuild, cam, target, width=w, height=h, samples_per_pass=c.spp,
                                 max_depth=c.max_depth)
    loss_p, grads_p = step(params, 11)
    leaves = {k: getattr(sc, k).clone().requires_grad_(True) for k in tracer.TRAINABLE}
    loss_r, grads_r = reference.loss_and_grad(sc, leaves, c.camera, target, 11, spp=c.spp,
                                              max_depth=c.max_depth)
    assert float(loss_p) == pytest.approx(loss_r, rel=1e-6)
    for k in tracer.TRAINABLE:
        torch.testing.assert_close(grads_p[k], grads_r[k], rtol=1e-4, atol=1e-6)


def test_uniforms_are_the_programs():
    from raytracer_tpu_torch.ops import ctr_rng

    ids = torch.arange(0, 1 << 20, 997, dtype=torch.int64)
    for seed in (0, 123456789, 2**31 + 5):
        for ctr in (0, 3, 4 + 3 * 49 + 2, 4 + 3 * 50 + 49):
            assert torch.equal(rng.uniform(seed, ids, ctr), ctr_rng.uniform(seed, ids, ctr))


def test_scene_is_the_books_draw():
    """The description of rand_spheres is the scene the program's registry
    draws from seed 0, field for field."""
    from raytracer_tpu_torch.scenes.builders import rand_spheres

    ours = harness.port_scene(harness.Cell.load("rand_spheres.render").description())
    book, _, _ = rand_spheres(0)
    for f in ("sph_center", "sph_radius", "mat_type", "mat_albedo", "mat_fuzz", "mat_ior",
              "tex_c0"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), getattr(book, f).numpy())
