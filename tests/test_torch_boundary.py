"""The port's silhouette edge term (diff/boundary.py) against the JAX
package's: its geometry helpers array for array, its gradient on a scene
where the edge radiances are deterministic (emitters against a flat
background, one bounce) equal to JAX make_boundary_image_fn's for the same
cotangent image, finite-difference parity of interior + boundary gradients
on the port alone (tests/test_boundary_grad.py's scenes and tolerances),
and make_inverse_renderer(boundary=True) on both backends."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.diff import boundary as jb
from raytracer_tpu.diff.grad import split_scene as jax_split_scene
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.diff import boundary as pb
from raytracer_tpu_torch.diff import grad as pgrad
from raytracer_tpu_torch.geometry import scene as pscene

torch.set_num_threads(1)

GEOMETRY = ("sph_center", "sph_radius", "quad_q", "quad_u", "quad_v")
CAMERA = ("look_from", "look_at", "fov_radians")


def test_helpers_match_jax():
    """project_to_pixels, _perp_basis, sphere_contour_points and
    quad_edge_points on seeded inputs, rtol 1e-5."""
    rng = np.random.default_rng(21)
    cam_kw = dict(fov_degrees=55, look_from=(0.2, 0.3, 0.1), look_at=(0.1, -0.1, -3))
    jframe = jcam.camera_frame(jcam.make_camera(1.3, 26, **cam_kw)[0], 26, 20)
    pframe = pcam.camera_frame(pcam.make_camera(1.3, 26, **cam_kw)[0], 26, 20)
    pts = rng.uniform(-3, 3, (5, 7, 3)).astype(np.float32)
    pts[..., 2] -= 4.0
    for a, b in zip(jb.project_to_pixels(jframe, jnp.asarray(pts)),
                    pb.project_to_pixels(pframe, torch.from_numpy(pts))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    zh = rng.normal(size=(40, 3)).astype(np.float32)
    zh /= np.linalg.norm(zh, axis=-1, keepdims=True)
    zh[:3] = [[0, 1, 0], [0, -1, 0], [0.1, 0.95, 0.3]]
    for a, b in zip(jb._perp_basis(jnp.asarray(zh)), pb._perp_basis(torch.from_numpy(zh))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    center = rng.uniform(-2, 2, (6, 3)).astype(np.float32)
    center[:, 2] -= 5.0
    radius = rng.uniform(0.2, 1.5, 6).astype(np.float32)
    radius[1] = -radius[1]  # the hollow-glass inner shell
    center[2] = (0.1, 0.2, 0.3)  # the eye inside: no silhouette
    radius[2] = 2.0
    eye = np.array([0.1, 0.2, 0.4], np.float32)
    phi = ((np.arange(16) + 0.5) * (2 * np.pi / 16)).astype(np.float32)
    jp, jv = jb.sphere_contour_points(jnp.asarray(center), jnp.asarray(radius), jnp.asarray(eye),
                                      jnp.asarray(phi))
    pp, pv = pb.sphere_contour_points(torch.from_numpy(center), torch.from_numpy(radius),
                                      torch.from_numpy(eye), torch.from_numpy(phi))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert not bool(pv[2])
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    q, u, v = (rng.uniform(-2, 2, (4, 3)).astype(np.float32) for _ in range(3))
    tau = ((np.arange(8) + 0.5) / 8).astype(np.float32)
    for a, b in zip(jb.quad_edge_points(*(jnp.asarray(x) for x in (q, u, v, tau))),
                    pb.quad_edge_points(*(torch.from_numpy(x) for x in (q, u, v, tau)))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


EMITTER_W, EMITTER_H = 24, 20
EMITTER_CAM = dict(fov_degrees=55, look_from=(0, 0, 0), look_at=(0, 0, -3),
                   background=(0.2, 0.3, 0.4))
EMITTER_CFG = dict(samples_per_sphere=64, samples_per_quad_edge=16, spp_edge=2)


def emitter_scene(builder_cls):
    """A diffuse_light sphere and a diffuse_light quad apart in the image,
    against a flat background: at max_depth 1 every edge sample's inside
    radiance is the emission and its outside the background, whatever the
    random numbers."""
    b = builder_cls(0)
    b.add_sphere((-0.6, 0.1, -3.0), 0.7, b.diffuse_light((3.0, 2.0, 1.0)))
    b.add_quad((0.3, -0.8, -3.2), (1.0, 0.1, -0.2), (0.1, 1.1, 0.0),
               b.diffuse_light((0.5, 1.5, 2.5)))
    return b.build()


def test_emitter_scene_gradient_matches_jax():
    """The deterministic case: the port's boundary gradient in every
    geometry leaf and in look_from, look_at and fov_radians equals JAX
    make_boundary_image_fn's for the same cotangent image, rtol 1e-4 (atol
    1e-6 of the largest entry); the forward is exact zeros."""
    w, h = EMITTER_W, EMITTER_H
    ct = np.random.default_rng(1).uniform(-1, 1, (h, w, 3)).astype(np.float32)
    jparams, jrebuild = jax_split_scene(emitter_scene(jscene.SceneBuilder), GEOMETRY)
    jcamera, _ = jcam.make_camera(w / h, w, **EMITTER_CAM)
    jfn = jb.make_boundary_image_fn(jrebuild, width=w, height=h, max_depth=1,
                                    config=jb.EdgeSamplingConfig(**EMITTER_CFG))
    jg, jg_cam = jax.jit(jax.grad(lambda p, c: jnp.sum(jfn(p, c, jax.random.PRNGKey(0)) * ct),
                                  argnums=(0, 1)))(jparams, jcamera)

    params, rebuild = pgrad.split_scene(emitter_scene(pscene.SceneBuilder), GEOMETRY)
    cam, _ = pcam.make_camera(w / h, w, **EMITTER_CAM)
    for f in CAMERA:
        getattr(cam, f).requires_grad_(True)
    fn = pb.make_boundary_image_fn(rebuild, width=w, height=h, max_depth=1,
                                   config=pb.EdgeSamplingConfig(**EMITTER_CFG))
    img = fn(params, cam, 5)
    assert img.shape == (h, w, 3) and img.requires_grad
    assert torch.equal(img.detach(), torch.zeros(h, w, 3))
    inputs = [params[k] for k in GEOMETRY] + [getattr(cam, f) for f in CAMERA]
    grads = torch.autograd.grad((img * torch.from_numpy(ct)).sum(), inputs)
    wants = [np.asarray(jg[k]) for k in GEOMETRY] + [np.asarray(getattr(jg_cam, f))
                                                     for f in CAMERA]
    for name, got, want in zip(GEOMETRY + CAMERA, grads, wants):
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)


# tests/test_boundary_grad.py's finite-difference setting.
W = H = 24
NKEYS = 10
KW = dict(width=W, height=H, samples_per_pass=48, max_depth=3, sky_gradient=True)
CFG = pb.EdgeSamplingConfig(samples_per_sphere=512, samples_per_quad_edge=128, spp_edge=16,
                            eps_px=0.08)


def _wfix():
    return torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(np.float32))


def _fd_vs_ad(scene, cam, trainable, coords, *, fd_eps=5e-3):
    """name, index -> (fd, ad_full, ad_interior) of the linear loss
    mean(img * wfix): FD averages the loss over NKEYS seeds shared by both
    sides; AD averages the per-seed gradient over the same seeds, with the
    boundary term (edge seeds 9000 + i) and without."""
    params, rebuild = pgrad.split_scene(scene, trainable)
    wfix = _wfix()
    boundary_fn = pb.make_boundary_image_fn(rebuild, width=W, height=H,
                                            max_depth=KW["max_depth"],
                                            sky_gradient=KW["sky_gradient"], config=CFG)

    def loss_avg(p):
        with torch.no_grad():
            return float(np.mean([float((pgrad.render_linear_diff(
                rebuild(p), cam, 7000 + i, **KW) * wfix).mean()) for i in range(NKEYS)]))

    leaves = list(params.values())
    g_full = [torch.zeros_like(p) for p in leaves]
    g_int = [torch.zeros_like(p) for p in leaves]
    for i in range(NKEYS):
        img = pgrad.render_linear_diff(rebuild(params), cam, 7000 + i, **KW)
        interior = (img * wfix).mean()
        full = ((img + boundary_fn(params, cam, 9000 + i)) * wfix).mean()
        for acc, loss in ((g_int, interior), (g_full, full)):
            for a, g in zip(acc, torch.autograd.grad(loss, leaves, retain_graph=True,
                                                     allow_unused=True)):
                if g is not None:
                    a += g / NKEYS
    names = list(params)
    out = {}
    for name, idx in coords:
        base = params[name].detach()
        e = torch.zeros(base.numel())
        e[idx] = fd_eps
        e = e.reshape(base.shape)
        fd = (loss_avg({**params, name: base + e})
              - loss_avg({**params, name: base - e})) / (2 * fd_eps)
        j = names.index(name)
        out[(name, idx)] = (fd, float(g_full[j].reshape(-1)[idx]),
                            float(g_int[j].reshape(-1)[idx]))
    return out


def test_sphere_silhouette_fd_parity():
    """One lambertian sphere with its whole silhouette in view: FD matches
    interior + boundary AD; interior-only AD misses the boundary flux on
    the radius (> 50% of it)."""
    b = pscene.SceneBuilder(0)
    b.add_sphere((0.3, -0.1, -3.0), 1.0, b.lambertian((0.6, 0.3, 0.2)))
    cam, _ = pcam.make_camera(1.0, W, fov_degrees=55, look_from=(0, 0, 0), look_at=(0.1, 0, -3))
    res = _fd_vs_ad(b.build(), cam, ("sph_center", "sph_radius"),
                    [("sph_center", 0), ("sph_center", 1), ("sph_center", 2),
                     ("sph_radius", 0)])
    fds = np.array([v[0] for v in res.values()])
    fulls = np.array([v[1] for v in res.values()])
    np.testing.assert_allclose(fulls, fds, rtol=0.15, atol=0.08 * np.abs(fds).max())
    r_fd, r_full, r_int = res[("sph_radius", 0)]
    assert abs(r_int - r_fd) > 0.5 * abs(r_fd)
    assert abs(r_full - r_fd) < 0.15 * abs(r_fd)


def test_quad_edge_fd_parity():
    """A tilted lambertian quad against the sky: FD matches AD with the
    four edges' boundary term on the corner and edge coordinates with a
    strong signal."""
    b = pscene.SceneBuilder(0)
    b.add_quad((-1.0, -0.8, -3.0), (1.8, 0.0, -0.4), (0.2, 1.6, 0.0),
               b.lambertian((0.7, 0.4, 0.3)))
    cam, _ = pcam.make_camera(1.0, W, fov_degrees=55, look_from=(0, 0, 0), look_at=(0, 0, -3))
    res = _fd_vs_ad(b.build(), cam, ("quad_q", "quad_u"),
                    [("quad_q", 0), ("quad_q", 2), ("quad_u", 0), ("quad_u", 2)])
    fds = np.array([v[0] for v in res.values()])
    fulls = np.array([v[1] for v in res.values()])
    np.testing.assert_allclose(fulls, fds, rtol=0.2, atol=0.05 * np.abs(fds).max())


def test_occluded_silhouette_cancels():
    """A silhouette hidden behind a nearer sphere: its inside and outside
    radiances are equal (common random numbers), so its boundary gradient
    vanishes (< 2% of the occluder's)."""
    b = pscene.SceneBuilder(0)
    b.add_sphere((0.0, 0.0, -6.0), 1.0, b.lambertian((0.6, 0.3, 0.2)))  # hidden
    b.add_sphere((0.0, 0.0, -2.5), 1.2, b.lambertian((0.5, 0.5, 0.5)))  # occluder
    cam, _ = pcam.make_camera(1.0, W, fov_degrees=45, look_from=(0, 0, 0), look_at=(0, 0, -3))
    params, rebuild = pgrad.split_scene(b.build(), ("sph_center",))
    boundary_fn = pb.make_boundary_image_fn(rebuild, width=W, height=H, max_depth=3,
                                            sky_gradient=True, config=CFG)
    img = pgrad.render_linear_diff(rebuild(params), cam, 1, **KW)
    loss = ((img + boundary_fn(params, cam, 2)) * _wfix()).mean()
    (g,) = torch.autograd.grad(loss, [params["sph_center"]])
    hidden, front = g[0].numpy(), g[1].numpy()
    assert np.abs(front).max() > 0
    assert np.abs(hidden).max() < 0.02 * np.abs(front).max()


def test_inverse_renderer_boundary_on_both_backends():
    """make_inverse_renderer(boundary=True), one step a backend on the CPU:
    the loss equals the step's without the boundary term (its image is
    zero), the edge term moves the geometry gradients, and the two
    backends' edge gradients (with minus without) agree for the same
    seed. The bucketed step times the edge work under "edges"."""
    b = pscene.SceneBuilder(0)
    b.add_sphere((0.3, -0.1, -3.0), 1.0, b.lambertian((0.6, 0.3, 0.2)))
    b.add_sphere((0, -101, -3), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_quad((-1.5, -0.8, -4.0), (0.8, 0.0, 0.0), (0.0, 0.9, 0.0),
               b.lambertian((0.2, 0.6, 0.3)))
    scene = b.build()
    cam, _ = pcam.make_camera(1.0, 24, fov_degrees=55, look_from=(0, 0, 0),
                              look_at=(0.1, 0, -3), background=(0.7, 0.8, 1.0))
    kw = dict(width=24, height=24, samples_per_pass=2, max_depth=3)
    target = pgrad.render_linear_diff(scene, cam, 42, **kw).detach()
    radius = scene.sph_radius.clone()
    radius[0] *= 1.05
    start = pscene.Scene(**{**scene.__dict__, "sph_radius": radius})
    trainable = ("sph_center", "sph_radius", "quad_q", "tex_c0")
    run = {}
    for backend in ("scan", "bucketed"):
        for boundary in (False, True):
            params, _, step = pgrad.make_inverse_renderer(
                start, cam, target, trainable=trainable, backend=backend, device="cpu",
                boundary=boundary, **kw)
            timings = {}
            loss = float(step(7, timings))
            run[backend, boundary] = (loss, {k: p.grad.clone() for k, p in params.items()},
                                      timings)
        assert run[backend, True][0] == run[backend, False][0], backend
    assert "edges" in run["bucketed", True][2] and "edges" not in run["bucketed", False][2]
    edge = {backend: {k: run[backend, True][1][k] - run[backend, False][1][k] for k in trainable}
            for backend in ("scan", "bucketed")}
    for k in ("sph_center", "sph_radius", "quad_q"):
        assert float(edge["scan"][k].abs().max()) > 0, k
        top = float(run["scan", True][1][k].abs().max())
        torch.testing.assert_close(edge["bucketed"][k], edge["scan"][k], rtol=1e-4,
                                   atol=1e-5 * top, msg=k)
    assert float(edge["scan"]["tex_c0"].abs().max()) == 0.0
