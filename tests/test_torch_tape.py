"""The port's tape forward and replay against the JAX package: `trace`'s
winner tape and radiance against JAX `trace(return_tape=True)` with the same
counter-RNG uniforms, the tape kernel's plain twin against `trace`,
`winner_t_diff` and the dielectric likelihood-ratio factor against their
JAX originals (values and gradients), finite gradients over a fuzz-0
mirror, and kernel 2's twin unchanged."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.geometry import intersect as jintersect
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu.integrator import wavefront as jwf
from raytracer_tpu.materials import materials as jmat
from raytracer_tpu.ops import ctr_rng as jrng
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.diff.bucketed import make_bucketed_grad_fn
from raytracer_tpu_torch.diff.grad import split_scene
from raytracer_tpu_torch.geometry import intersect as pintersect
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.integrator import wavefront as pwf
from raytracer_tpu_torch.materials import materials as pmat
from raytracer_tpu_torch.ops import ctr_rng as prng
from raytracer_tpu_torch.ops import persistent_kernel as ppk
from raytracer_tpu_torch.scenes.registry import get_scene
from test_torch_integrator import CAM_KW, mixed_scene, plain_regen

torch.set_num_threads(1)

SEED = 12345
W, H, SPP, DEPTH = 64, 36, 2, 8


@pytest.fixture(scope="module")
def traced():
    """JAX and port `trace(return_tape=True)` of the mixed scene, 64x36,
    2 spp, depth 8, from the same counter-RNG camera rays and uniforms."""
    jc, _ = jcam.make_camera(16 / 9, W, **CAM_KW)
    n = W * H
    sid = np.arange(SPP * n)
    pix = sid % n
    o, d = jcam.camera_rays(jcam.camera_frame(jc, W, H), jnp.asarray(pix % W),
                            jnp.asarray(pix // W), jrng.camera_uniforms(SEED, jnp.asarray(sid)))
    useq = jrng.bounce_uniform_seq(SEED, jnp.asarray(sid), DEPTH)
    rad_j, tape_j = jwf.trace(mixed_scene(jscene.SceneBuilder), o, d, jax.random.PRNGKey(0),
                              jc.background, max_depth=DEPTH, uniform_seq=useq, return_tape=True)
    pc, _ = pcam.make_camera(16 / 9, W, **CAM_KW)
    pseq = torch.tensor(np.asarray(useq))
    rad_p, tape_p = pwf.trace(
        mixed_scene(pscene.SceneBuilder), torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
        pc.background, lambda b, lanes: pseq[b][lanes], max_depth=DEPTH, return_tape=True,
    )
    return np.asarray(rad_j), np.asarray(tape_j), rad_p.numpy(), tape_p.numpy()


def test_trace_tape_matches_jax(traced):
    """Tape equal on >= 99.9% of entries (measured: all 36,864). Radiance
    within 1e-5 on >= 99.9% of the lanes whose tapes agree (measured: all
    but 1 of 4,608; that lane's metal absorb test, a dot product within
    rounding of 0, went the other way, which the tape cannot show: it reads
    -1 after an absorption and after a scatter into the sky alike)."""
    rad_j, tape_j, rad_p, tape_p = traced
    assert tape_p.dtype == np.int32 and tape_p.shape == (DEPTH, SPP * W * H)
    assert (tape_p == tape_j).mean() >= 0.999
    agree = (tape_p == tape_j).all(axis=0)
    close = np.isclose(rad_p[agree], rad_j[agree], rtol=1e-5, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.999, close.mean()
    # The scene exercises every winner kind: spheres, the quad (id 4), misses.
    assert {0, 1, 2, 3, 4, -1} <= set(np.unique(tape_p).tolist())


def test_tape_twin_is_trace_with_counter_uniforms():
    """render_persistent_tape on CPU tables (the kernel's twin) equals the
    port's trace(return_tape=True) fed ctr_rng.camera_uniforms and
    bounce_uniform_seq, bit for bit, and counts no kernel launch."""
    scene = mixed_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 32, **CAM_KW)
    w, h, depth, n = 32, 18, 6, 32 * 18 * 2
    sph, quad, res = ppk.pack_persistent_tables(scene)
    cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, w, h), cam.background)
    before = ppk.LAUNCHES_TAPE
    rad, tape, segs = ppk.render_persistent_tape(sph, quad, res, cam_s, SEED, n, width=w,
                                                 height=h, max_depth=depth)
    assert ppk.LAUNCHES_TAPE == before
    assert rad.shape == (3, n) and tape.shape == (depth, n) and segs.dtype == torch.int32
    sid = torch.arange(n)
    pix = sid % (w * h)
    o, d = pcam.camera_rays(pcam.camera_frame(cam, w, h), pix % w, pix // w,
                            prng.camera_uniforms(SEED, sid))
    useq = prng.bounce_uniform_seq(SEED, sid, depth)
    rad_t, tape_t = pwf.trace(scene, o, d, cam.background, lambda b, lanes: useq[b][lanes],
                              max_depth=depth, return_tape=True)
    torch.testing.assert_close(rad.T, rad_t, rtol=0, atol=0)
    assert torch.equal(tape, tape_t)
    # One segment per bounce traced: a lane's tape reads -1 from its end on.
    hit_rows = (tape >= 0).sum(dim=0)
    assert bool((segs >= hit_rows).all()) and bool((segs <= depth).all())
    assert int(segs.min()) >= 1


def _rays_at_scene(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((-2.5, -0.3, -0.5), (2.5, 1.5, 2.5), (n, 3)).astype(np.float32)
    tgt = rng.uniform((-2.0, -0.6, -2.5), (2.0, 1.2, -0.5), (n, 3)).astype(np.float32)
    return o, (tgt - o).astype(np.float32)


def test_winner_t_diff_matches_jax():
    """Values and VJPs (sphere centers and radii, quad corners and edges,
    ray origins and directions) of the port's winner_t_diff against JAX
    `_winner_t_diff`, rtol 1e-5, over winners of every kind and misses."""
    o_np, d_np = _rays_at_scene(4096, 3)
    jsc = mixed_scene(jscene.SceneBuilder)
    psc = mixed_scene(pscene.SceneBuilder)
    t_nd, prim = pintersect.closest_hit_t_prim(psc, torch.tensor(o_np), torch.tensor(d_np))
    assert (prim.numpy() == 4).any() and (prim.numpy() == -1).any()
    ct = np.random.default_rng(4).normal(size=4096).astype(np.float32)
    hit = np.isfinite(t_nd.numpy())
    fields = ("sph_center", "sph_radius", "quad_q", "quad_u", "quad_v")

    def jfn(leaves, o, d):
        sc = jsc.replace(**leaves)
        t = jintersect._winner_t_diff(sc, jintersect.quad_derived(sc), o, d,
                                      jnp.asarray(prim.numpy()), jnp.asarray(t_nd.numpy()), 1e-3)
        return jnp.sum(jnp.where(hit, t, 0.0) * ct), t

    jleaves = {k: getattr(jsc, k) for k in fields}
    (_, t_j), g_j = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jleaves, jnp.asarray(o_np), jnp.asarray(d_np))

    pleaves = {k: getattr(psc, k).clone().requires_grad_(True) for k in fields}
    o = torch.tensor(o_np, requires_grad=True)
    d = torch.tensor(d_np, requires_grad=True)
    sc = pscene.Scene(**{**psc.__dict__, **pleaves})
    t_p = pintersect.winner_t_diff(sc, pintersect.quad_derived(sc), o, d, prim, t_nd)
    (torch.where(torch.from_numpy(hit), t_p, 0.0) * torch.from_numpy(ct)).sum().backward()

    np.testing.assert_allclose(t_p.detach().numpy(), np.asarray(t_j), rtol=1e-5)
    for k in fields:
        np.testing.assert_allclose(pleaves[k].grad.numpy(), np.asarray(g_j[0][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(g_j[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(g_j[2]), rtol=1e-5, atol=1e-6)


def test_dielectric_lr_is_one_and_carries_the_ior_gradient():
    """Forward exactly 1 on every lane (reflect, refract and total internal
    reflection); d/d ior of its weighted sum equals JAX `_dielectric_lr`'s."""
    rng = np.random.default_rng(5)
    cos_np = rng.uniform(0.0, 1.0, 512).astype(np.float32)
    front_np = rng.random(512) < 0.5
    coin_np = rng.random(512).astype(np.float32)
    w_np = rng.normal(size=512).astype(np.float32)
    sin_np = np.sqrt(1.0 - cos_np * cos_np)

    def jloss(ior):
        eta = jnp.where(front_np, 1.0 / ior, ior)
        cannot = sin_np * eta > 1.0
        r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
        p = r0 + (1.0 - r0) * (1.0 - cos_np) ** 5
        return jnp.sum(jmat._dielectric_lr(p, cannot | (p > coin_np), cannot)[:, 0] * w_np)

    g_j = jax.grad(jloss)(jnp.float32(1.5))
    ior = torch.tensor(1.5, requires_grad=True)
    cos, sin = torch.from_numpy(cos_np), torch.from_numpy(sin_np)
    eta = torch.where(torch.from_numpy(front_np), 1.0 / ior, ior)
    cannot = sin * eta > 1.0
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    p = r0 + (1.0 - r0) * (1.0 - cos) ** 5
    use = cannot | (p > torch.from_numpy(coin_np))
    lr = pmat._dielectric_lr(p, use, cannot)
    assert lr.shape == (512, 1) and bool((lr == 1.0).all())
    assert bool(cannot.any()) and bool((use & ~cannot).any()) and bool((~use).any())
    (lr[:, 0] * torch.from_numpy(w_np)).sum().backward()
    np.testing.assert_allclose(float(ior.grad), float(g_j), rtol=1e-5)


def test_fuzz0_mirror_replay_gives_finite_gradients():
    """Regression for the masked-branch NaN: a fuzz-0 metal sphere (as
    rand_spheres' hero mirror) once made the dielectric branch's 1/ior
    infinite on its lanes, and autograd wrote NaN into every gradient."""
    b = pscene.SceneBuilder(0)
    b.add_sphere((0, -100.5, -1), 100, b.lambertian((0.5, 0.6, 0.4)))
    b.add_sphere((-0.6, 0, -1), 0.5, b.metal((0.8, 0.8, 0.8), 0.0))
    b.add_sphere((0.6, 0, -1), 0.5, b.dielectric(1.5))
    scene = b.build()
    cam, _ = pcam.make_camera(16 / 9, 32, look_from=(0, 0.3, 1.5), look_at=(0, 0, -1),
                              fov_degrees=60, background=(0.7, 0.8, 1.0))
    params, rebuild = split_scene(scene, ("sph_center", "sph_radius", "mat_albedo",
                                          "mat_fuzz", "mat_ior", "tex_c0"))
    target = torch.zeros(18, 32, 3)
    step = make_bucketed_grad_fn(rebuild, cam, target, width=32, height=18,
                                 samples_per_pass=2, max_depth=5)
    loss, grads = step(params, 7)
    assert np.isfinite(float(loss))
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
    assert float(grads["mat_fuzz"][1].abs()) > 0  # the mirror's fuzz is live
    assert float(grads["mat_ior"][2].abs()) > 0  # the glass's ior, via the LR factor


# sha256 of regen_plain's log and segments below, as the tree before the
# tape port computed them (the persistent kernel's twin must not move).
REGEN_SHA256 = "6874227b9ad8105cb408a6ffd62d2750b4f6596cdd4c7d006661c3850583d69e"


def test_regen_plain_unchanged_bit_for_bit():
    """Kernel 2's twin gives the bytes it gave before the gradient-safe
    shading (mixed scene with russian roulette and 3 spp; rand_spheres,
    whose hero mirror has fuzz 0)."""
    h = hashlib.sha256()
    cam, st = pcam.make_camera(16 / 9, 48, **CAM_KW)
    log, segs, _ = plain_regen(mixed_scene(pscene.SceneBuilder), cam, 48, st.height, 3, 1000, 6,
                               rr_start=2)
    h.update(log.numpy().tobytes())
    h.update(segs.numpy().tobytes())
    sc, cam, st = get_scene("rand_spheres", width=40, spp=2, max_depth=8)
    log, segs, _ = plain_regen(sc, cam, 40, st.height, 2, 1500, 8, rr_start=3)
    h.update(log.numpy().tobytes())
    h.update(segs.numpy().tobytes())
    assert h.hexdigest() == REGEN_SHA256
