"""The port's refracted-silhouette term (diff/refracted_edge.py) against
the JAX package's: the specular-manifold solve array for array on
tests/test_glass_gap.py's scene (roots, J^{-1}, convergence) against the
JAX package's chain and Newton iteration (raytracer_tpu/diff/
refracted_edge.py:217-290); the whole estimator equal to JAX
make_refracted_boundary_fn's with the edge radiances fixed to one smooth
function in both packages; finite-difference parity of the port's
gradient on the axis interior autodiff misses (tests/test_refracted_edge.py:
25); zero without glass (:72), and a zero camera cotangent, as in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.diff import boundary as jb
from raytracer_tpu.diff import refracted_edge as jre
from raytracer_tpu.diff.grad import split_scene as jax_split_scene
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu.geometry.intersect import quad_derived as jax_quad_derived
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.diff import grad as pgrad
from raytracer_tpu_torch.diff import refracted_edge as pre
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.geometry.intersect import quad_derived

torch.set_num_threads(1)

W = H = 48
CAM = dict(fov_degrees=40, look_from=(0, 0, 1), look_at=(0, 0, -2), background=(1.0, 1.0, 1.0))


def glass_scene(builder_cls, material="glass", ux=1.0):
    """tests/test_glass_gap.py's scene: a dark quad fully hidden behind a
    glass sphere (or a lambertian one)."""
    b = builder_cls(0)
    mat = b.dielectric(1.5) if material == "glass" else b.lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -2.0), 0.8, mat)
    b.add_quad((-0.5, -0.5, -4.0), (ux, 0, 0), (0, 1.0, 0), b.lambertian((0.05, 0.05, 0.05)))
    return b.build()


def jax_solve(scene, frame, y3s, cfg):
    """The JAX package's per-sample solve (refracted_edge.py:217-290, its
    `solve_one` for glass sphere 0 and quad 0) over the points y3s."""
    qd = jax_quad_derived(scene)
    plane = jnp.concatenate([scene.quad_q, qd.normal, qd.d[:, None]], axis=1)[0]
    c, r, ior = scene.sph_center[0], scene.sph_radius[0], scene.mat_ior[scene.sph_mat[0]]
    sg = jax.lax.stop_gradient

    def inv2(j, floor):
        det = j[0, 0] * j[1, 1] - j[0, 1] * j[1, 0]
        return (jnp.array([[j[1, 1], -j[0, 1]], [-j[1, 0], j[0, 0]]])
                / jnp.where(jnp.abs(det) < floor, floor, det), jnp.abs(det) < floor)

    def one(y3):
        y2 = jnp.stack([jnp.sum(y3 * qd.av[0]) - qd.q_av[0], jnp.sum(y3 * qd.bv[0]) - qd.q_bv[0]])

        def f(s):
            p2d, ok = jre._chain_to_plane(s, frame, c, r, ior, plane, qd.av[0], qd.bv[0],
                                          qd.q_av[0], qd.q_bv[0])
            return p2d - y2, ok

        def newton(s0):
            def body(_, s):
                inv, _ = inv2(jax.jacfwd(lambda ss: f(ss)[0])(s), 1e-12)
                return s - cfg.damping * jnp.clip(inv @ f(s)[0], -8.0, 8.0)

            s = jax.lax.fori_loop(0, cfg.newton_iters, body, s0)
            fs, ok = f(s)
            return s, ok & (jnp.linalg.norm(fs) < cfg.newton_tol)

        sa, ta, _ = jb.project_to_pixels(frame, y3)
        sb, tb, _ = jb.project_to_pixels(frame, 2.0 * c - y3)
        s1, c1 = newton(jnp.stack([sa, ta]))
        s2, c2 = newton(jnp.stack([sb, tb]))
        c2 = c2 & ~(c1 & (jnp.linalg.norm(s1 - s2) < 0.5))
        out = []
        for s, conv in ((s1, c1), (s2, c2)):
            inv, bad = inv2(jax.jacfwd(lambda ss: f(ss)[0])(sg(s)), 1e-10)
            out.append((s, inv, conv & ~bad))
        return tuple(jnp.stack(x) for x in zip(*out))

    return jax.jit(jax.vmap(one))(y3s)


def test_manifold_solve_matches_jax():
    """One glass sphere, one quad, samples_per_quad_edge 2 (8 edge points,
    two inits each): the port's batched Newton gives JAX's convergence mask
    exactly, its roots within 1e-3 px and J^{-1} within 1e-4 of its largest
    entry (float32 Newton, the two packages' roundings apart)."""
    cfg = pre.RefractedEdgeConfig(samples_per_quad_edge=2)
    js = glass_scene(jscene.SceneBuilder)
    jframe = jcam.camera_frame(jcam.make_camera(1.0, W, **CAM)[0], W, H)
    tau = (np.arange(2, dtype=np.float32) + 0.5) / 2
    pts = np.array(jb.quad_edge_points(js.quad_q, js.quad_u, js.quad_v, jnp.asarray(tau))[0][0])
    j_roots, j_inv, j_conv = (np.asarray(x) for x in jax_solve(js, jframe, jnp.asarray(pts), cfg))

    scene = glass_scene(pscene.SceneBuilder)
    frame = pcam.camera_frame(pcam.make_camera(1.0, W, **CAM)[0], W, H)
    qd = quad_derived(scene)
    y3 = torch.from_numpy(pts)
    k = y3.shape[0]
    y2 = torch.stack([(y3 * qd.av[0]).sum(-1) - qd.q_av[0], (y3 * qd.bv[0]).sum(-1) - qd.q_bv[0]],
                     dim=-1)
    lane = torch.zeros(k, dtype=torch.int64)
    plane = tuple(x[lane] for x in (qd.normal, qd.d, qd.av, qd.bv, qd.q_av, qd.q_bv))
    c, r, ior, glass = pre._glass_spheres(scene)
    assert bool(glass[0])
    with torch.no_grad():
        roots, inv, conv = pre.manifold_solve(frame, c[lane], r[lane], ior[lane], plane, y3, y2,
                                              cfg)
    assert j_conv[:, 0].all()  # the direct init converges on every point here
    np.testing.assert_array_equal(conv.numpy(), j_conv)
    np.testing.assert_allclose(roots.numpy(), j_roots, rtol=0, atol=1e-3)
    np.testing.assert_allclose(inv.numpy(), j_inv, rtol=0, atol=1e-4 * np.abs(j_inv).max())


def smooth_radiance_jax(scene, frame, x_px, key, **kw):
    x, y = x_px[:, 0], x_px[:, 1]
    return jnp.stack([jnp.sin(0.37 * x + 0.11 * y), jnp.cos(0.23 * y), jnp.sin(0.05 * (x - y))],
                     axis=-1)


def smooth_radiance_torch(scene, frame, x_px, seed, **kw):
    x, y = x_px[:, 0], x_px[:, 1]
    return torch.stack([torch.sin(0.37 * x + 0.11 * y), torch.cos(0.23 * y),
                        torch.sin(0.05 * (x - y))], dim=-1)


def test_refracted_gradient_matches_jax_with_fixed_radiance(monkeypatch):
    """With the edge traces replaced in both packages by one smooth
    function of the pixel position, the estimator is deterministic: the
    quad gradients equal JAX's for the same cotangent image (roots, weights
    and the implicit-function pull-back together), rtol 1e-3 (atol 1e-5 of
    the largest entry: the roots agree to 1e-3 px), and the camera's
    cotangent is zero in both."""
    leaves = ("quad_q", "quad_u", "quad_v")
    cfg = dict(samples_per_quad_edge=8, spp_edge=1)
    ct = np.random.default_rng(3).uniform(-1, 1, (H, W, 3)).astype(np.float32)
    monkeypatch.setattr(jre, "_trace_edge_radiance", smooth_radiance_jax)
    monkeypatch.setattr(pre, "_trace_edge_radiance", smooth_radiance_torch)
    jparams, jrebuild = jax_split_scene(glass_scene(jscene.SceneBuilder), leaves)
    jc, _ = jcam.make_camera(1.0, W, **CAM)
    jfn = jre.make_refracted_boundary_fn(jrebuild, width=W, height=H, max_depth=6,
                                         config=jre.RefractedEdgeConfig(**cfg))
    jg, jg_cam = jax.jit(jax.grad(lambda p, c: jnp.sum(jfn(p, c, jax.random.PRNGKey(0)) * ct),
                                  argnums=(0, 1)))(jparams, jc)
    params, rebuild = pgrad.split_scene(glass_scene(pscene.SceneBuilder), leaves)
    cam, _ = pcam.make_camera(1.0, W, **CAM)
    cam.look_from.requires_grad_(True)
    fn = pre.make_refracted_boundary_fn(rebuild, width=W, height=H, max_depth=6,
                                        config=pre.RefractedEdgeConfig(**cfg))
    assert fn.__name__ == "refracted_image"
    img = fn(params, cam, 1)
    grads = torch.autograd.grad((img * torch.from_numpy(ct)).sum(),
                                [params[k] for k in leaves] + [cam.look_from])
    for name, got in zip(leaves, grads):
        want = np.asarray(jg[name])
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
    assert float(grads[-1].abs().max()) == 0.0
    assert float(np.abs(np.asarray(jg_cam.look_from)).max()) == 0.0


KW = dict(width=W, height=H, samples_per_pass=32, max_depth=6)


def test_refracted_edge_recovers_fd():
    """tests/test_refracted_edge.py's check on the port: on the hidden
    quad's width (quad_u.x), FD of mean(img^2) over 4 seeds (h 0.04,
    common random numbers) is strongly negative, and interior AD plus the
    refracted term over 3 seeds matches its sign and lies within 0.7-1.4x
    its size; along the plane (quad_q.x) the term stays under 15% of it."""
    params, rebuild = pgrad.split_scene(glass_scene(pscene.SceneBuilder), ("quad_q", "quad_u"))
    cam, _ = pcam.make_camera(1.0, W, **CAM)

    def loss(p, seed):
        return torch.mean(pgrad.render_linear_diff(rebuild(p), cam, seed, **KW) ** 2)

    fds = []
    for seed in range(4):
        f = []
        for dx in (-0.04, 0.04):
            u = params["quad_u"].detach().clone()
            u[0, 0] += dx
            with torch.no_grad():
                f.append(float(loss({**params, "quad_u": u}, seed)))
        fds.append((f[1] - f[0]) / 0.08)
    fd = float(np.mean(fds))
    assert fd < -0.03, (fd, fds)
    rfn = pre.make_refracted_boundary_fn(
        rebuild, width=W, height=H, max_depth=KW["max_depth"],
        config=pre.RefractedEdgeConfig(samples_per_quad_edge=64, spp_edge=16))
    ad_u, ad_q = [], []
    for seed in range(3):
        img = pgrad.render_linear_diff(rebuild(params), cam, 100 + seed, **KW)
        img = img + rfn(params, cam, 200 + seed)
        gq, gu = torch.autograd.grad(torch.mean(img ** 2), [params["quad_q"], params["quad_u"]])
        ad_u.append(float(gu[0, 0]))
        ad_q.append(float(gq[0, 0]))
    ad = float(np.mean(ad_u))
    assert np.sign(ad) == np.sign(fd), (ad, fd)
    assert 0.7 * abs(fd) < abs(ad) < 1.4 * abs(fd), (ad, fd)
    assert abs(float(np.mean(ad_q))) < 0.15 * abs(fd), (ad_q, fd)


def test_refracted_edge_no_glass_is_zero():
    """Without a dielectric sphere every root is masked: exactly zero."""
    params, rebuild = pgrad.split_scene(glass_scene(pscene.SceneBuilder, "lambert"), ("quad_u",))
    cam, _ = pcam.make_camera(1.0, W, **CAM)
    fn = pre.make_refracted_boundary_fn(rebuild, width=W, height=H, max_depth=4,
                                        config=pre.RefractedEdgeConfig(samples_per_quad_edge=8,
                                                                       spp_edge=2))
    (g,) = torch.autograd.grad(fn(params, cam, 0).sum(), [params["quad_u"]])
    assert torch.equal(g, torch.zeros_like(g))
