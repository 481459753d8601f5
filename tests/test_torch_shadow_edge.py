"""The port's shadow-edge term (diff/shadow_edge.py) against the JAX
package's: its gradient on tests/test_boundary_grad.py's shadow scenes
where the edge radiances do not depend on the random numbers, equal to JAX
make_shadow_boundary_fn's VJP for the same cotangent image and camera
jitter; finite-difference parity on the port alone on the axis interior
autodiff misses (tests/test_boundary_grad.py:352-371); and its importance
subsampling (tests/test_shadow_inverse.py:112-140)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.diff import shadow_edge as js
from raytracer_tpu.diff.grad import split_scene as jax_split_scene
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.diff import boundary as pb
from raytracer_tpu_torch.diff import grad as pgrad
from raytracer_tpu_torch.diff import shadow_edge as ps
from raytracer_tpu_torch.geometry import scene as pscene

torch.set_num_threads(1)

W = H = 24
CAM = dict(fov_degrees=38, look_from=(3.5, 1.0, 0.0), look_at=(0.0, 0.0, 0.0),
           background=(0, 0, 0))
BLOCKER_ROW = 2


def shadow_scene(builder_cls, blocker="quad", bx=0.0):
    """tests/test_boundary_grad.py's _shadow_scene: ground, an overhead
    area light and a blocker (quad or sphere) that the camera never sees."""
    b = builder_cls(0)
    white = b.lambertian((0.73, 0.73, 0.73))
    light = b.diffuse_light((15, 15, 15))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), white)
    b.add_quad((-1, 3, -1), (2, 0, 0), (0, 0, 2), light)
    if blocker == "quad":
        b.add_quad((bx - 0.6, 1.5, -0.6), (1.2, 0, 0), (0, 0, 1.2), white)
    else:
        b.add_sphere((bx, 1.5, 0.0), 0.6, white)
    return b.build()


@pytest.mark.parametrize("blocker,leaves", [
    ("quad", ("quad_q", "quad_u", "quad_v")),
    ("sphere", ("sph_center", "sph_radius")),
])
def test_shadow_gradient_matches_jax(blocker, leaves):
    """The deterministic case: at max_depth 2 with a black background each
    edge trace ends at its first hit (the light's emission, else black), so
    L_in - L_out does not depend on the random numbers. With the exhaustive
    default config and JAX's own camera jitter (the first of its key's four
    splits) fed to the port, every geometry gradient equals JAX's for the
    same cotangent image, rtol 1e-4 (atol 1e-6 of the largest entry)."""
    ct = np.random.default_rng(1).uniform(-1, 1, (H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jparams, jrebuild = jax_split_scene(shadow_scene(jscene.SceneBuilder, blocker), leaves)
    jc, _ = jcam.make_camera(1.0, W, **CAM)
    jfn = js.make_shadow_boundary_fn(jrebuild, width=W, height=H, max_depth=2)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jfn(p, jc, key) * ct)))(jparams)
    uni = np.array(jax.random.uniform(jax.random.split(key, 4)[0], (W * H, 4), jnp.float32))

    params, rebuild = pgrad.split_scene(shadow_scene(pscene.SceneBuilder, blocker), leaves)
    cam, _ = pcam.make_camera(1.0, W, **CAM)
    grads = ps.shadow_edge_gradients(params, rebuild, cam, 5, torch.from_numpy(ct), width=W,
                                     height=H, max_depth=2, cam_uniforms=torch.from_numpy(uni))
    for name, got in zip(leaves, grads):
        want = np.asarray(jg[name])
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)


def test_shadow_image_is_zero_and_gives_the_camera_zero():
    """The image is exact zeros on the scene's device; its backward gives
    the blocker a gradient and every camera tensor that requires grad a
    zero one (JAX returns a zero camera cotangent)."""
    params, rebuild = pgrad.split_scene(shadow_scene(pscene.SceneBuilder), ("quad_q", "mat_albedo"))
    cam, _ = pcam.make_camera(1.0, 12, **CAM)
    cam.look_from.requires_grad_(True)
    fn = ps.make_shadow_boundary_fn(rebuild, width=12, height=12, max_depth=2,
                                    config=ps.ShadowEdgeConfig(samples_per_quad_edge=2, spp_edge=1))
    assert fn.__name__ == "shadow_image"
    img = fn(params, cam, 4)
    assert torch.equal(img.detach(), torch.zeros(12, 12, 3))
    gq, ga, gc = torch.autograd.grad(img.sum(), [params["quad_q"], params["mat_albedo"],
                                                 cam.look_from])
    assert float(gq[BLOCKER_ROW].abs().max()) > 0
    assert float(ga.abs().max()) == 0.0 and float(gc.abs().max()) == 0.0


# tests/test_boundary_grad.py's finite-difference setting.
NKEYS = 10
KW = dict(width=W, height=H, samples_per_pass=48, max_depth=3, sky_gradient=False)


def test_shadow_edge_closes_blocker_bias():
    """The port's analog of test_shadow_edge_estimator_closes_blocker_bias:
    on the blocker quad's x, which the camera never sees, interior +
    boundary AD misses most of FD (> 70%), and with the shadow term it is
    within 20% of FD. FD and AD average the linear loss mean(img * wfix)
    over the same NKEYS seeds; FD steps 0.05 (the penumbra is ~1 wide)."""
    params, rebuild = pgrad.split_scene(shadow_scene(pscene.SceneBuilder), ("quad_q",))
    cam, _ = pcam.make_camera(1.0, W, **CAM)
    wfix = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(np.float32))
    edge_kw = dict(width=W, height=H, max_depth=KW["max_depth"], sky_gradient=False)
    boundary_fn = pb.make_boundary_image_fn(
        rebuild, config=pb.EdgeSamplingConfig(samples_per_sphere=512, samples_per_quad_edge=128,
                                              spp_edge=16, eps_px=0.08), **edge_kw)
    shadow_fn = ps.make_shadow_boundary_fn(
        rebuild, config=ps.ShadowEdgeConfig(samples_per_quad_edge=8, spp_edge=2), **edge_kw)
    leaf = params["quad_q"]

    def loss_avg(q):
        with torch.no_grad():
            return float(np.mean([float((pgrad.render_linear_diff(
                rebuild({"quad_q": q}), cam, 7000 + i, **KW) * wfix).mean())
                for i in range(NKEYS)]))

    e = torch.zeros_like(leaf)
    e[BLOCKER_ROW, 0] = 0.05
    fd = (loss_avg(leaf.detach() + e) - loss_avg(leaf.detach() - e)) / 0.1
    ad_int = ad_full = 0.0
    for i in range(NKEYS):
        img = pgrad.render_linear_diff(rebuild(params), cam, 7000 + i, **KW)
        interior = (img * wfix).mean()
        full = ((img + boundary_fn(params, cam, 9000 + i) + shadow_fn(params, cam, 9500 + i))
                * wfix).mean()
        ad_int += float(torch.autograd.grad(interior, [leaf], retain_graph=True)[0][
            BLOCKER_ROW, 0]) / NKEYS
        ad_full += float(torch.autograd.grad(full, [leaf])[0][BLOCKER_ROW, 0]) / NKEYS
    assert abs(fd) > 5e-4, (fd, ad_full, ad_int)
    assert abs(ad_int - fd) > 0.7 * abs(fd), (fd, ad_full, ad_int)
    assert abs(ad_full - fd) < 0.2 * abs(fd), (fd, ad_full, ad_int)


def shadow_grad_bx(config, seed):
    """The blocker x's gradient of sum(shadow image) (a ones cotangent) on
    tests/test_shadow_inverse.py's start, max_depth 3."""
    params, rebuild = pgrad.split_scene(shadow_scene(pscene.SceneBuilder, bx=-0.25), ("quad_q",))
    cam, _ = pcam.make_camera(1.0, W, **CAM)
    fn = ps.make_shadow_boundary_fn(rebuild, width=W, height=H, max_depth=3, config=config)
    (g,) = torch.autograd.grad(fn(params, cam, seed).sum(), [params["quad_q"]])
    return float(g[BLOCKER_ROW, 0])


BASE = ps.ShadowEdgeConfig(samples_per_quad_edge=4, spp_edge=1)


def test_subsampling_knobs_are_identity_when_exhaustive():
    """receivers >= the pixels and sources_per_receiver >= the sources
    take the exhaustive path: equal gradients bit for bit."""
    wide = BASE._replace(receivers=W * H, sources_per_receiver=16)
    assert shadow_grad_bx(BASE, 3) == shadow_grad_bx(wide, 3)


def test_subsampling_unbiased():
    """Receivers drawn by the cotangent and one source a receiver by its
    solid angle (the counter RNG's draws, by inverse CDF) estimate the
    exhaustive gradient: over 12 seeds their mean matches the mean of 4
    exhaustive seeds in sign and within 4 standard errors of the
    difference (tests/test_shadow_inverse.py holds JAX's within 35%)."""
    sub = BASE._replace(receivers=96, sources_per_receiver=1)
    full = np.array([shadow_grad_bx(BASE, 50 + i) for i in range(4)])
    subs = np.array([shadow_grad_bx(sub, 50 + i) for i in range(12)])
    assert full.mean() != 0.0 and len(set(subs.tolist())) > 1
    assert np.sign(subs.mean()) == np.sign(full.mean())
    sigma = np.sqrt(subs.var(ddof=1) / len(subs) + full.var(ddof=1) / len(full))
    assert abs(subs.mean() - full.mean()) < 4.0 * sigma, (subs.mean(), full.mean(), sigma)


def test_sample_categorical_draws_by_inverse_cdf():
    """Draws follow their probabilities (within 5 standard errors over
    40,000 counter-RNG uniforms), never an index of probability 0, row by
    row for a batch of distributions."""
    from raytracer_tpu_torch.ops import ctr_rng

    p = torch.tensor([[0.1, 0.0, 0.6, 0.3], [0.0, 0.5, 0.0, 0.5]])
    n = 40_000
    u = ctr_rng.uniform(11, torch.arange(2 * n).reshape(2, n), ps.RECEIVER_DRAW)
    idx = ps.sample_categorical(p, u)
    assert idx.shape == (2, n) and idx.dtype == torch.int64
    for row in range(2):
        freq = torch.bincount(idx[row], minlength=4).double() / n
        assert float(freq[p[row] == 0].sum()) == 0.0
        se = torch.sqrt(p[row].double() * (1 - p[row].double()) / n)
        assert bool(((freq - p[row].double()).abs() <= 5 * se + 1e-12).all()), freq
