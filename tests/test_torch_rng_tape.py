"""The bucketed gradient step on scenes the tape kernel does not shade (noise
from rng-filled Perlin tables), whose tape forward is
integrator/wavefront.py:trace_tape_scene: against `jax.value_and_grad` of
the same image loss through JAX `raytracer_tpu/diff/tape.py:trace_tape`
fed the same counter draws, against the port's scan backend, with a
trainable camera, sharded at one rank, and the recorder against kernel 3's
twin on a scene kernel 3 serves. The scene is tests/test_ktape.py's mixed
scene with a noise-textured sphere added (no r = 1000 sphere, whose
expanded-form winner t cancels in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.diff.grad import split_scene as jax_split_scene
from raytracer_tpu.diff.tape import trace_tape as jax_trace_tape
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu.ops import ctr_rng as jrng
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.diff import bucketed as pbucketed
from raytracer_tpu_torch.diff import grad as pgrad
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.integrator import wavefront as pwf
from raytracer_tpu_torch.materials.packed import texture_tables
from raytracer_tpu_torch.ops import persistent_kernel as ppk
from raytracer_tpu_torch.parallel import mesh as pmesh
from raytracer_tpu_torch.parallel.train import make_sharded_bucketed_grad_fn
from test_torch_integrator import CAM_KW, mixed_scene

torch.set_num_threads(1)

# tests/test_torch_grad.py's gradient size.
W, H, SPP, DEPTH = 32, 18, 2, 6
SEED = 424242
# The leaves held against JAX, and their limits (rtol, atol):
# test_bucketed_step_matches_jax_kernel_forward's.
HELD = {"sph_center": (6e-3, 1e-4), "sph_radius": (6e-3, 1e-4), "mat_albedo": (1e-4, 1e-8),
        "tex_c0": (1e-4, 1e-8)}
CAMERA_LEAVES = ("look_from", "fov_radians")


def noise_scene(builder_cls, procedural_perlin=False):
    return mixed_scene(builder_cls, noise_sphere=True, procedural_perlin=procedural_perlin)


def target_image():
    return np.random.default_rng(1).uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)


def port_setup(trainable=tuple(HELD)):
    """(params, rebuild, camera, target) of the rng-table scene on the CPU."""
    scene = noise_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    params, rebuild = pgrad.split_scene(scene, trainable)
    return params, rebuild, cam, torch.from_numpy(target_image())


def bucketed_step(rebuild, cam, target):
    return pbucketed.make_bucketed_grad_fn(rebuild, cam, target, width=W, height=H,
                                           samples_per_pass=SPP, max_depth=DEPTH)


@pytest.fixture(scope="module")
def jax_reference():
    """`jax.value_and_grad` of the MSE of JAX trace_tape's image (the XLA
    tape forward and its replay), fed ctr_rng's camera and bounce draws
    for SEED: (loss, grads as numpy)."""
    scene = noise_scene(jscene.SceneBuilder)
    cam, _ = jcam.make_camera(16 / 9, 64, **CAM_KW)
    params, rebuild = jax_split_scene(scene, tuple(HELD))
    n = W * H
    sid = jnp.arange(SPP * n, dtype=jnp.int32)
    pix = sid % n
    o, d = jcam.camera_rays(jcam.camera_frame(cam, W, H), pix % W, pix // W,
                            jrng.camera_uniforms(SEED, sid))
    useq = jrng.bounce_uniform_seq(SEED, sid, DEPTH)
    target = jnp.asarray(target_image())

    def loss_fn(p):
        rad = jax_trace_tape(rebuild(p), o, d, useq, cam.background, max_depth=DEPTH)
        img = rad.reshape(SPP, n, 3).mean(0).reshape(H, W, 3)
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_perlin_tables_equal_across_packages():
    """Both builders draw the same rng-filled Perlin tables from seed 0, so
    both packages shade the same noise; the port refuses the scene to
    kernel 3 and accepts the procedural one."""
    js, ps = noise_scene(jscene.SceneBuilder), noise_scene(pscene.SceneBuilder)
    for name in ("perlin_vec", "perlin_px", "perlin_py", "perlin_pz"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert ps.has_noise and not ps.perlin_procedural
    assert ppk.unsupported_reason(ps) is not None
    assert ppk.unsupported_reason(noise_scene(pscene.SceneBuilder, True)) is None


def test_bucketed_step_matches_jax_trace_tape(jax_reference):
    """(a) The port's bucketed step (tape by trace_tape_scene, then the
    replay) against JAX trace_tape's value_and_grad at the same int seed:
    loss rtol 1e-5; centers and radii rtol 6e-3 / atol 1e-4; albedo and
    texture colors rtol 1e-4 (test_bucketed_step_matches_jax_kernel_
    forward's limits). Every held leaf's JAX gradient is non-zero."""
    loss_j, grads_j = jax_reference
    params, rebuild, cam, target = port_setup()
    timings = {}
    loss, grads = bucketed_step(rebuild, cam, target)(params, SEED, timings)
    assert set(timings) == {"tape_forward", "loss_cotangent", "replay_forward", "backward"}
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    for name, (rtol, atol) in HELD.items():
        assert np.abs(grads_j[name]).max() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), grads_j[name], rtol=rtol, atol=atol,
                                   err_msg=name)


def test_scan_backend_equals_bucketed_on_rng_tables():
    """(b) The scan backend (the closest hit searched at every bounce) and
    the bucketed step consume the same counter uniforms and trace the same
    paths: loss within rtol 1e-6, and the scan backend's VJP against the
    step's own image cotangent equals the step's gradients within rtol 1e-5
    (the rule of test_torch_grad.py::test_scan_backend_equals_bucketed;
    measured: bit for bit). The two steps' own gradients differ by the VJP
    of their images' difference: the step's loss reads the tape forward's
    image, whose hit points come from the closest hit's t, the scan's the
    replayed one's, from the expanded-form t, and the marble's steep
    turbulence turns that rounding into up to 1e-4 in a pixel (on this
    scene with procedural tables, through kernel 3's twin, as well)."""
    params, rebuild, cam, target = port_setup(pgrad.DEFAULT_TRAINABLE)
    kw = dict(width=W, height=H, samples_per_pass=SPP, max_depth=DEPTH)
    loss_b, grads_b = pbucketed.make_bucketed_grad_fn(rebuild, cam, target, **kw)(params, SEED)
    loss_s, _ = pgrad.make_scan_grad_fn(rebuild, cam, target, **kw)(params, SEED)
    np.testing.assert_allclose(float(loss_s), float(loss_b), rtol=1e-6)
    with torch.no_grad():
        rad, tape = pbucketed.tape_forward(params, rebuild, None, cam, SEED, SPP * W * H,
                                           width=W, height=H, max_depth=DEPTH,
                                           sky_gradient=False, device=target.device)
        loss_f, _, _, ct_img = pbucketed.finish(rad, tape, target, samples_per_pass=SPP)
    assert float(loss_f) == float(loss_b)
    img = pgrad.render_linear_diff(rebuild(params), cam, SEED, **kw)
    vjp = torch.autograd.grad(img, list(params.values()), grad_outputs=ct_img)
    for name, g in zip(params, vjp):
        torch.testing.assert_close(g, grads_b[name], rtol=1e-5, atol=1e-9, msg=name)
    assert float(grads_b["sph_center"][4].abs().max()) > 0  # the noise sphere's


def test_inverse_renderer_trains_the_camera_on_rng_tables():
    """(c) make_inverse_renderer(backend="bucketed") with the camera's
    look_from and fov_radians trainable steps on the rng-table scene on the
    CPU: finite loss, finite non-zero camera gradients, moved leaves."""
    scene = noise_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    params, _, step = pgrad.make_inverse_renderer(
        scene, cam, target_image(), width=W, height=H, samples_per_pass=SPP, max_depth=DEPTH,
        backend="bucketed", trainable_camera=CAMERA_LEAVES, device="cpu")
    before = {k: v.detach().clone() for k, v in params["camera"].items()}
    for seed in (3, 4):
        assert np.isfinite(float(step(seed)))
    for name in CAMERA_LEAVES:
        g = params["camera"][name].grad
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, name
        assert not torch.equal(params["camera"][name].detach(), before[name]), name


def test_recorder_equals_kernel3_twin_on_procedural_tables():
    """(d) On the procedural-table scene, which kernel 3 serves,
    trace_tape_scene's tape and radiance equal render_persistent_tape's
    twin bit for bit: the routing cannot change a scene kernel 3 serves."""
    scene = noise_scene(pscene.SceneBuilder, procedural_perlin=True)
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    frame, n = pcam.camera_frame(cam, W, H), SPP * W * H
    cfg = dict(width=W, height=H, max_depth=DEPTH, sky_gradient=False)
    rad3, tape_k, _ = ppk.render_persistent_tape(
        *ppk.pack_persistent_tables(scene), ppk.pack_camera_scalars_bg(frame, cam.background),
        SEED, n, textures=texture_tables(scene, quad_derived(scene)), **cfg)
    rad, tape = pwf.trace_tape_scene(scene, frame, cam.background, SEED, n, **cfg)
    assert tape.dtype == torch.int32 and tape.shape == (DEPTH, n)
    assert torch.equal(tape, tape_k)
    assert torch.equal(rad, rad3.T)
    # The noise sphere (id 4) is hit, and so are the quad (id 5) and the sky.
    assert {4, 5, -1} <= set(torch.unique(tape).tolist())


def test_tape_forward_routes_on_the_scene(monkeypatch):
    """tape_forward picks its forward from the scene before any launch:
    kernel 3's wrapper on the procedural scene, trace_tape_scene on the
    rng-table one, and a failing kernel 3 still raises (no fallback)."""
    calls = []
    kernel3, recorder = pbucketed.render_persistent_tape, pbucketed.trace_tape_scene
    monkeypatch.setattr(pbucketed, "render_persistent_tape",
                        lambda *a, **k: calls.append("kernel3") or kernel3(*a, **k))
    monkeypatch.setattr(pbucketed, "trace_tape_scene",
                        lambda *a, **k: calls.append("recorder") or recorder(*a, **k))
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    target = torch.from_numpy(target_image())
    for procedural in (True, False):
        params, rebuild = pgrad.split_scene(noise_scene(pscene.SceneBuilder, procedural))
        bucketed_step(rebuild, cam, target)(params, SEED)
    assert calls == ["kernel3", "recorder"]

    def refuse(*a, **k):
        raise RuntimeError("kernel 3 failed to launch")

    monkeypatch.setattr(pbucketed, "render_persistent_tape", refuse)
    params, rebuild = pgrad.split_scene(noise_scene(pscene.SceneBuilder, True))
    with pytest.raises(RuntimeError, match="kernel 3 failed"):
        bucketed_step(rebuild, cam, target)(params, SEED)


def test_sharded_step_at_one_rank_is_the_unsharded_step():
    """(e) make_sharded_bucketed_grad_fn at one in-process gloo rank equals
    make_bucketed_grad_fn's step bit for bit on the rng-table scene (its
    forward is the same tape_forward)."""
    params, rebuild, cam, target = port_setup()
    loss, grads = bucketed_step(rebuild, cam, target)(params, SEED)
    pmesh.init_group("cpu")
    try:
        step = make_sharded_bucketed_grad_fn(rebuild, cam, target, pmesh.make_mesh(), width=W,
                                             height=H, samples_per_pass=SPP, max_depth=DEPTH)
        loss_s, grads_s = step(params, SEED)
    finally:
        pmesh.close_group()
    assert float(loss_s) == float(loss)
    for name in grads:
        assert torch.equal(grads_s[name], grads[name]), name
