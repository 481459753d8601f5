"""The port's mirror-reflected silhouette term (diff/mirror_edge.py)
against the JAX package's: its gradient, camera tensors included, on
tests/test_mirror_edge.py's scene at a depth where the edge radiances do
not depend on the random numbers, equal to JAX make_mirror_boundary_fn's
for the same cotangent image; its masks (tests/test_mirror_edge.py:130,
:160); and its visibility probe through the closest-hit kernel's wrapper."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.diff import mirror_edge as jm
from raytracer_tpu.diff.grad import split_scene as jax_split_scene
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.diff import grad as pgrad
from raytracer_tpu_torch.diff import mirror_edge as pm
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.ops import intersect_kernel as ik

torch.set_num_threads(1)

W = H = 32
CAM = dict(fov_degrees=60, look_from=(0, 0, 0), look_at=(0, 0, -3), background=(1.0, 1.0, 1.0))
CAMERA = ("look_from", "look_at", "fov_radians")
LEAVES = ("sph_center", "sph_radius")
CFG = dict(samples_per_contour=64, spp_edge=2)


def mirror_scene(builder_cls, mirror="flat", sphere=((0.6, 0.3, 1.6), 1.0)):
    """tests/test_mirror_edge.py's scene: a metal quad facing the camera
    (fuzz 0: a flat mirror; or fuzzy metal or lambertian) and a dark sphere
    behind the camera, seen only in the mirror."""
    b = builder_cls(0)
    mat = {"flat": lambda: b.metal((0.9, 0.9, 0.9), fuzz=0.0),
           "fuzzy": lambda: b.metal((0.9, 0.9, 0.9), fuzz=0.3),
           "lambert": lambda: b.lambertian((0.9, 0.9, 0.9))}[mirror]()
    b.add_quad((-2.0, -2.0, -3.0), (4, 0, 0), (0, 4, 0), mat)
    b.add_sphere(sphere[0], sphere[1], b.lambertian((0.05, 0.05, 0.05)))
    return b.build()


def test_mirror_gradient_matches_jax():
    """The deterministic case: at max_depth 2 an edge path is the camera
    ray, the fuzz-0 reflection and its end (the white background, or the
    dark sphere's zero emission), whatever the random numbers. The sphere's
    center and radius gradients and the camera's look_from, look_at and
    fov_radians gradients equal JAX's for the same cotangent image, rtol
    1e-4 (atol 1e-6 of the largest entry)."""
    ct = np.random.default_rng(2).uniform(-1, 1, (H, W, 3)).astype(np.float32)
    jparams, jrebuild = jax_split_scene(mirror_scene(jscene.SceneBuilder), LEAVES)
    jc, _ = jcam.make_camera(1.0, W, **CAM)
    jfn = jm.make_mirror_boundary_fn(jrebuild, width=W, height=H, max_depth=2,
                                     config=jm.MirrorEdgeConfig(**CFG))
    jg, jg_cam = jax.jit(jax.grad(lambda p, c: jnp.sum(jfn(p, c, jax.random.PRNGKey(0)) * ct),
                                  argnums=(0, 1)))(jparams, jc)

    params, rebuild = pgrad.split_scene(mirror_scene(pscene.SceneBuilder), LEAVES)
    cam, _ = pcam.make_camera(1.0, W, **CAM)
    for f in CAMERA:
        getattr(cam, f).requires_grad_(True)
    fn = pm.make_mirror_boundary_fn(rebuild, width=W, height=H, max_depth=2,
                                    config=pm.MirrorEdgeConfig(**CFG))
    img = fn(params, cam, 5)
    assert fn.__name__ == "mirror_image" and torch.equal(img.detach(), torch.zeros(H, W, 3))
    inputs = [params[k] for k in LEAVES] + [getattr(cam, f) for f in CAMERA]
    grads = torch.autograd.grad((img * torch.from_numpy(ct)).sum(), inputs)
    wants = [np.asarray(jg[k]) for k in LEAVES] + [np.asarray(getattr(jg_cam, f)) for f in CAMERA]
    for name, got, want in zip(LEAVES + CAMERA, grads, wants):
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)


def sphere_center_grad(scene):
    params, rebuild = pgrad.split_scene(scene, ("sph_center",))
    cam, _ = pcam.make_camera(1.0, W, **CAM)
    fn = pm.make_mirror_boundary_fn(rebuild, width=W, height=H, max_depth=4,
                                    config=pm.MirrorEdgeConfig(samples_per_contour=32, spp_edge=2))
    img = fn(params, cam, 0)
    (g,) = torch.autograd.grad((img ** 2).mean() + img.sum(), [params["sph_center"]])
    return g


@pytest.mark.parametrize("mirror", ["fuzzy", "lambert"])
def test_mirror_edge_masks_non_mirrors(mirror):
    """Fuzzy metal and lambertian quads are not mirrors: exactly zero."""
    g = sphere_center_grad(mirror_scene(pscene.SceneBuilder, mirror, ((0.5, 0.3, 1.5), 0.5)))
    assert torch.equal(g, torch.zeros_like(g))


def test_mirror_edge_behind_mirror_masked():
    """A sphere behind the mirror plane (seen directly, through no mirror)
    gets no mirror-edge contribution; the same sphere in front of it does."""
    behind = sphere_center_grad(mirror_scene(pscene.SceneBuilder, "flat", ((0.0, 0.0, -5.0), 0.5)))
    assert torch.equal(behind, torch.zeros_like(behind))
    front = sphere_center_grad(mirror_scene(pscene.SceneBuilder, "flat", ((0.6, 0.3, 1.6), 1.0)))
    assert float(front.abs().max()) > 0


def test_visibility_probe_runs_the_closest_hit_wrapper(monkeypatch):
    """The probe that a screen point sees its mirror goes through kernel
    1's wrapper (ops/intersect_kernel.py:intersect, which launches the
    kernel on CUDA tensors), not the plain search: with the wrapper's
    answer replaced by misses, every point is masked and the gradient is
    zero."""
    real = ik.intersect
    calls = []

    def spy(sph, quad, o, d):
        calls.append(o.shape[0])
        t, prim = real(sph, quad, o, d)
        if len(calls) == 1:  # the probe comes before the edge traces
            prim = torch.full_like(prim, -1)
        return t, prim

    monkeypatch.setattr(ik, "intersect", spy)
    g = sphere_center_grad(mirror_scene(pscene.SceneBuilder))
    assert calls[0] == 1 * 1 * 32  # one probe ray per (mirror, sphere, sample)
    assert torch.equal(g, torch.zeros_like(g))
