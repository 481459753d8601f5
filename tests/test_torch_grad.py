"""The port's gradient step against the JAX package: the tape-forward step
(diff/bucketed.py) against JAX `make_bucketed_grad_fn(forward="kernel")` run
in Pallas interpret mode with the same int seed, with and without a
trainable camera, the compacting replay against one full-depth replay, the
scan backend against the tape-forward step, torch Adam against optax.adam,
split_scene / rebuild / params_from_arrays (camera leaves included), and
make_inverse_renderer with every edge term on both backends."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.diff.bucketed import make_bucketed_grad_fn as jax_make_bucketed_grad_fn
from raytracer_tpu.diff.bucketed import split_camera as jax_split_camera
from raytracer_tpu.diff.grad import split_scene as jax_split_scene
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.diff import bucketed as pbucketed
from raytracer_tpu_torch.diff import grad as pgrad
from raytracer_tpu_torch.diff.tape import make_tape_intersect_fn
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.materials.materials import resolve_and_shade
from raytracer_tpu_torch.ops import ctr_rng as prng
from raytracer_tpu_torch.ops import persistent_kernel as ppk
from test_torch_integrator import CAM_KW, mixed_scene

torch.set_num_threads(1)

# tests/test_ktape.py's gradient size.
W, H, SPP, DEPTH = 32, 18, 2, 6
GEOMETRY = ("sph_center", "sph_radius")
CAMERA_LEAVES = ("look_from", "fov_radians", "background")


def target_image():
    return np.random.default_rng(0).uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_step():
    """JAX kernel-forward bucketed step (interpret mode) on the mixed scene:
    (params as numpy, loss, grads as numpy, the int seed it derived)."""
    scene = mixed_scene(jscene.SceneBuilder)
    cam, _ = jcam.make_camera(16 / 9, 64, **CAM_KW)
    params, rebuild = jax_split_scene(scene)
    key = jax.random.PRNGKey(5)
    with pltpu.force_tpu_interpret_mode():
        step = jax_make_bucketed_grad_fn(
            rebuild, cam, jnp.asarray(target_image()), width=W, height=H,
            samples_per_pass=SPP, max_depth=DEPTH, quant=256, forward="kernel",
            scene_probe=scene, tape_rows=8,
        )
        loss, grads = step(params, key)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1, jnp.int32))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(params), float(loss), as_np(grads), seed


def port_setup(params_np):
    scene = mixed_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    _, rebuild = pgrad.split_scene(scene)
    return pgrad.params_from_arrays(params_np), rebuild, cam, torch.from_numpy(target_image())


def test_bucketed_step_matches_jax_kernel_forward(jax_step):
    """Loss within rtol 1e-5. Albedo and texture-color gradients within
    rtol 1e-4. Sphere centers and radii within rtol 6e-3 / atol 1e-4: the
    bound JAX holds between its own forward variants
    (tests/test_ktape.py:165-176). The metal fuzz within rtol 1e-3 and an
    atol of 1e-3 of its largest entry: it moves scatter directions, so its
    gradient flows through the replayed hit points as the geometry's does,
    and one 5-bounce metal-glass-glass-light path's derivative rounds
    apart in the two packages' float associations (see PERF.md, PR 2, for
    the readings this limit was set from and one that must fail it)."""
    params_np, loss_j, grads_j, seed = jax_step
    params, rebuild, cam, target = port_setup(params_np)
    step = pbucketed.make_bucketed_grad_fn(rebuild, cam, target, width=W, height=H,
                                           samples_per_pass=SPP, max_depth=DEPTH)
    timings = {}
    loss, grads = step(params, seed, timings)
    assert set(timings) == {"tape_forward", "loss_cotangent", "replay_forward", "backward"}
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert set(grads) == set(grads_j) == set(pgrad.DEFAULT_TRAINABLE)
    for name, g in grads.items():
        assert g.shape == grads_j[name].shape, name
        assert np.abs(grads_j[name]).max() > 0, name
        if name in GEOMETRY:
            np.testing.assert_allclose(g.numpy(), grads_j[name], rtol=6e-3, atol=1e-4, err_msg=name)
        elif name == "mat_fuzz":
            np.testing.assert_allclose(g.numpy(), grads_j[name], rtol=1e-3,
                                       atol=1e-3 * np.abs(grads_j[name]).max(), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), grads_j[name], rtol=1e-4, atol=1e-8, err_msg=name)


@pytest.fixture(scope="module")
def jax_camera_step():
    """JAX kernel-forward bucketed step (interpret mode) on the mixed scene
    with the camera's look_from, fov_radians and background trainable
    under params["camera"]: (params as numpy, nested, loss, grads as
    numpy, nested, the int seed)."""
    scene = mixed_scene(jscene.SceneBuilder)
    cam, _ = jcam.make_camera(16 / 9, 64, **CAM_KW)
    params, rebuild = jax_split_scene(scene, GEOMETRY)
    cam_params, rebuild_camera = jax_split_camera(cam, CAMERA_LEAVES)
    params = {**params, "camera": cam_params}
    key = jax.random.PRNGKey(8)
    with pltpu.force_tpu_interpret_mode():
        step = jax_make_bucketed_grad_fn(
            rebuild, cam, jnp.asarray(target_image()), width=W, height=H,
            samples_per_pass=SPP, max_depth=DEPTH, quant=256, forward="kernel",
            scene_probe=scene, tape_rows=8, rebuild_camera=rebuild_camera,
        )
        loss, grads = step(params, key)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1, jnp.int32))
    as_np = jax.tree_util.Partial(jax.tree_util.tree_map, np.asarray)
    return as_np(params), float(loss), as_np(grads), seed


def test_bucketed_camera_grads_match_jax(jax_camera_step):
    """params_from_arrays carries JAX's split_scene + split_camera params
    across (camera leaves under "camera", on the CPU, requiring grad), and
    the port's bucketed step with split_camera's rebuild gives JAX's loss
    (rtol 1e-5), its geometry gradients at test_bucketed_step_matches_jax_
    kernel_forward's bound (rtol 6e-3, atol 1e-4), and its camera
    gradients at that bound relative to each leaf's largest entry (rtol
    6e-3, atol 1e-4 of it; tests/test_unified_grad.py:92 holds JAX's own
    backends within rtol 6e-3)."""
    params_np, loss_j, grads_j, seed = jax_camera_step
    params = pgrad.params_from_arrays(params_np)
    assert set(params["camera"]) == set(CAMERA_LEAVES)
    for name, t in params["camera"].items():
        assert t.is_leaf and t.requires_grad and t.device.type == "cpu", name
        assert torch.equal(t.detach(), torch.from_numpy(params_np["camera"][name])), name
    scene = mixed_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    _, rebuild = pgrad.split_scene(scene, GEOMETRY)
    _, rebuild_camera = pbucketed.split_camera(cam, CAMERA_LEAVES)
    step = pbucketed.make_bucketed_grad_fn(rebuild, cam, torch.from_numpy(target_image()),
                                           width=W, height=H, samples_per_pass=SPP,
                                           max_depth=DEPTH, rebuild_camera=rebuild_camera)
    loss, grads = step(params, seed)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    for name in GEOMETRY:
        np.testing.assert_allclose(grads[name].numpy(), grads_j[name], rtol=6e-3, atol=1e-4,
                                   err_msg=name)
    for name in CAMERA_LEAVES:
        want = grads_j["camera"][name]
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(grads["camera"][name].numpy(), want, rtol=6e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f"camera.{name}")


def test_bucketed_camera_grads_match_full_depth_replay(jax_camera_step):
    """The port of tests/test_unified_grad.py:35: camera leaves under
    params["camera"] get, through the bucketed replay (depth-1 lanes kept,
    since the background is trainable), the gradients of one full-depth
    replay of every lane that rebuilds the camera from the same leaves,
    rtol 1e-5. The mixed scene's glass makes the interior camera
    gradients non-zero."""
    params_np, _, _, seed = jax_camera_step
    params = pgrad.params_from_arrays(params_np)
    scene = mixed_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    _, rebuild = pgrad.split_scene(scene, GEOMETRY)
    _, rebuild_camera = pbucketed.split_camera(cam, CAMERA_LEAVES)
    target = torch.from_numpy(target_image())
    _, grads = pbucketed.make_bucketed_grad_fn(
        rebuild, cam, target, width=W, height=H, samples_per_pass=SPP, max_depth=DEPTH,
        rebuild_camera=rebuild_camera)(params, seed)
    scene_p = {k: params[k] for k in GEOMETRY}
    with torch.no_grad():
        cam_p = rebuild_camera({k: v.detach() for k, v in params["camera"].items()})
        sph, quad, res = ppk.pack_persistent_tables(rebuild(scene_p))
        cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam_p, W, H), cam_p.background)
        rad3, tape, _ = ppk.render_persistent_tape(sph, quad, res, cam_s, seed, SPP * W * H,
                                                   width=W, height=H, max_depth=DEPTH)
        _, ct_lane, lane_depth, _ = pbucketed.finish(rad3.T, tape, target, samples_per_pass=SPP)
    assert int((lane_depth == 1).sum()) > 0
    ref = full_depth_replay(scene_p, rebuild, rebuild_camera(params["camera"]), seed, tape,
                            ct_lane)
    leaves = [params[k] for k in GEOMETRY] + [params["camera"][k] for k in CAMERA_LEAVES]
    ref_grads = torch.autograd.grad(ref, leaves)
    got = [grads[k] for k in GEOMETRY] + [grads["camera"][k] for k in CAMERA_LEAVES]
    for name, g, r in zip(GEOMETRY + CAMERA_LEAVES, got, ref_grads):
        assert float(r.abs().max()) > 0, name
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-9, msg=name)


def full_depth_replay(params, rebuild, cam, seed, tape, ct_lane):
    """Every lane, every bounce to max_depth, alive masks instead of
    compaction, depth-1 lanes included: sum(radiance * ct_lane)."""
    scene = rebuild(params)
    total = tape.shape[1]
    sid = torch.arange(total)
    pix = sid % (W * H)
    o, d = pcam.camera_rays(pcam.camera_frame(cam, W, H), pix % W, pix // W,
                            prng.camera_uniforms(seed, sid))
    _, _, res = ppk.pack_persistent_tables(scene)
    hit_fn = make_tape_intersect_fn(tape)
    tp, rad = torch.ones(total, 3), torch.zeros(total, 3)
    alive = torch.ones(total, dtype=torch.bool)
    bg = cam.background.expand(total, 3)
    for bounce in range(tape.shape[0]):
        t, prim = hit_fn(scene, o, d, bounce, sid)
        s = resolve_and_shade(res, scene.num_spheres, t, prim, o, d,
                              prng.bounce_uniforms(seed, sid, bounce))
        rad = rad + torch.where((alive & ~s.hit)[:, None], tp * bg, 0.0)
        rad = rad + torch.where((alive & s.hit)[:, None], tp * s.emitted, 0.0)
        alive = alive & s.hit & s.scattered
        tp = torch.where(alive[:, None], tp * s.attenuation, tp)
        o = torch.where(alive[:, None], s.point, o)
        d = torch.where(alive[:, None], s.direction, d)
    return (rad * ct_lane).sum()


def test_compacting_replay_equals_full_depth_replay(jax_step):
    """The step's replay (depth-1 lanes skipped, alive lanes compacted at
    each bounce) gives the gradient of one masked full-depth replay of
    every lane against the same cotangents, rtol 1e-5."""
    params_np, _, _, seed = jax_step
    params, rebuild, cam, target = port_setup(params_np)
    loss, grads = pbucketed.make_bucketed_grad_fn(
        rebuild, cam, target, width=W, height=H, samples_per_pass=SPP, max_depth=DEPTH,
    )(params, seed)
    with torch.no_grad():
        scene = rebuild({k: v.detach() for k, v in params.items()})
        sph, quad, res = ppk.pack_persistent_tables(scene)
        cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, W, H), cam.background)
        rad3, tape, _ = ppk.render_persistent_tape(sph, quad, res, cam_s, seed, SPP * W * H,
                                                   width=W, height=H, max_depth=DEPTH)
        loss_f, ct_lane, lane_depth, _ = pbucketed.finish(rad3.T, tape, target,
                                                          samples_per_pass=SPP)
    assert float(loss_f) == float(loss)
    assert int((lane_depth == 1).sum()) > 0  # the skip is exercised
    ref = full_depth_replay(params, rebuild, cam, seed, tape, ct_lane)
    ref_grads = torch.autograd.grad(ref, list(params.values()))
    for (name, g), r in zip(grads.items(), ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-9, msg=name)


def test_scan_backend_equals_bucketed(jax_step):
    """render_linear_diff (the closest hit searched at every bounce) and the
    tape-forward step consume the same counter uniforms, so they trace the
    same paths: equal loss, gradients within rtol 1e-5."""
    params_np, _, _, seed = jax_step
    params, rebuild, cam, target = port_setup(params_np)
    kw = dict(width=W, height=H, samples_per_pass=SPP, max_depth=DEPTH)
    loss_b, grads_b = pbucketed.make_bucketed_grad_fn(rebuild, cam, target, **kw)(params, seed)
    timings = {}
    loss_s, grads_s = pgrad.make_scan_grad_fn(rebuild, cam, target, **kw)(params, seed, timings)
    assert set(timings) == {"forward", "backward"}
    np.testing.assert_allclose(float(loss_s), float(loss_b), rtol=1e-6)
    img = pgrad.render_linear_diff(rebuild(params), cam, seed, **kw)
    assert img.shape == (H, W, 3) and img.requires_grad
    for name in grads_b:
        torch.testing.assert_close(grads_s[name], grads_b[name], rtol=1e-5, atol=1e-9, msg=name)


def test_adam_matches_optax():
    """Three torch.optim.Adam updates at optax.adam's defaults equal
    optax.adam's, given equal gradients (rtol 1e-6)."""
    rng = np.random.default_rng(9)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in (("a", (5, 3)), ("b", (7,)))}
    gs = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
          for _ in range(3)]
    opt = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = pgrad.params_from_arrays(p0)
    topt = torch.optim.Adam(list(tp.values()), lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for g in gs:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_split_scene_rebuild_roundtrip():
    """split_scene gives fresh leaves that require grad; rebuild of them is
    the scene again, differentiable; params_from_arrays of the JAX
    package's split_scene params gives the same leaves."""
    scene = mixed_scene(pscene.SceneBuilder)
    params, rebuild = pgrad.split_scene(scene)
    assert set(params) == set(pgrad.DEFAULT_TRAINABLE)
    for name, p in params.items():
        assert p.is_leaf and p.requires_grad and p is not getattr(scene, name)
    again = rebuild(params)
    for name in pscene.TENSOR_FIELDS:
        assert torch.equal(getattr(again, name), getattr(scene, name)), name
    assert again.has_checker == scene.has_checker
    moved = rebuild({**params, "sph_radius": params["sph_radius"] * 2.0})
    assert torch.equal(moved.sph_radius, scene.sph_radius * 2.0)
    assert torch.equal(moved.sph_center, scene.sph_center)
    moved.sph_radius.sum().backward()
    assert torch.equal(params["sph_radius"].grad, torch.full_like(scene.sph_radius, 2.0))
    jparams, _ = jax_split_scene(mixed_scene(jscene.SceneBuilder))
    from_jax = pgrad.params_from_arrays({k: np.asarray(v) for k, v in jparams.items()})
    for name, p in from_jax.items():
        assert p.requires_grad and p.dtype == torch.float32
        assert torch.equal(p.detach(), params[name].detach()), name


def test_inverse_renderer_steps_on_cpu():
    """make_inverse_renderer on the CPU: each backend takes Adam steps on
    the texture colors that lower the loss from a half-bright start toward
    the target rendered from the true scene; every edge term and the
    trainable camera build on both backends (the camera on the bucketed
    one only: scan raises ValueError) and take one step with finite
    gradients; an unknown backend raises ValueError."""
    scene = mixed_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    kw = dict(width=W, height=H, samples_per_pass=SPP, max_depth=DEPTH)
    target = pgrad.render_linear_diff(scene, cam, 3, **kw).detach()
    start = pscene.Scene(**{**scene.__dict__, "tex_c0": scene.tex_c0 * 0.5})
    for backend in ("bucketed", "scan"):
        params, opt, step = pgrad.make_inverse_renderer(
            start, cam, target, trainable=("tex_c0",), backend=backend, device="cpu", **kw)
        assert isinstance(opt, torch.optim.Adam)
        before = params["tex_c0"].detach().clone()
        timings = {}
        losses = [float(step(seed, timings)) for seed in (3, 3, 3, 3, 3)]
        assert "optimizer" in timings and all(np.isfinite(losses))
        assert losses[-1] < losses[0], (backend, losses)
        assert not torch.equal(params["tex_c0"].detach(), before)
    small = dict(kw, width=12, height=8, max_depth=3)
    edges = dict(boundary=True, shadow_edges=True, mirror_edges=True, refracted_edges=True)
    for backend in ("bucketed", "scan"):
        camera = ("look_from",) if backend == "bucketed" else ()
        params, opt, step = pgrad.make_inverse_renderer(
            start, cam, target[:8, :12], trainable=("sph_center", "quad_q"), backend=backend,
            device="cpu", trainable_camera=camera, **edges, **small)
        timings = {}
        assert np.isfinite(float(step(5, timings)))
        grads = [p.grad for p in (params["sph_center"], params["quad_q"])]
        if camera:
            grads.append(params["camera"]["look_from"].grad)
            assert any(t is params["camera"]["look_from"] for t in opt.param_groups[0]["params"])
        assert all(bool(torch.isfinite(g).all()) for g in grads), backend
        if backend == "bucketed":
            names = ("boundary", "shadow", "mirror", "refracted")
            assert {f"edges/{n}" for n in names} <= set(timings)
            assert timings["edges"] == pytest.approx(sum(timings[f"edges/{n}"] for n in names))
    with pytest.raises(ValueError, match="trainable_camera"):
        pgrad.make_inverse_renderer(scene, cam, target, device="cpu", backend="scan",
                                    trainable_camera=("look_from",), **kw)
    with pytest.raises(ValueError, match="backend"):
        pgrad.make_inverse_renderer(scene, cam, target, device="cpu", backend="xla", **kw)


def test_bucketed_shadow_edges_compose():
    """The port of tests/test_unified_grad.py:141: boundary and shadow_edges
    together through the bucketed backend give finite, non-zero blocker
    gradients, and the shadow term moves them (the step without it
    differs); the loss is the step's without the edge terms."""
    b = pscene.SceneBuilder(0)
    b.add_quad((-4, 0, -8), (8, 0, 0), (0, 0, 8), b.lambertian((0.7, 0.7, 0.7)))
    b.add_sphere((0.0, 1.2, -4.0), 0.5, b.lambertian((0.4, 0.4, 0.8)))
    b.add_sphere((0.0, 4.0, -4.0), 1.0, b.diffuse_light((12, 12, 12)))
    scene = b.build()
    cam, _ = pcam.make_camera(1.0, 24, fov_degrees=60, look_from=(0, 2.5, 2), look_at=(0, 0.5, -4))
    kw = dict(width=24, height=24, samples_per_pass=2, max_depth=3, backend="bucketed",
              device="cpu", trainable=("sph_center",))
    run = {}
    for shadow in (False, True):
        params, _, step = pgrad.make_inverse_renderer(scene, cam, torch.zeros(24, 24, 3),
                                                      boundary=True, shadow_edges=shadow, **kw)
        loss = float(step(0))
        run[shadow] = (loss, params["sph_center"].grad.clone())
    loss, g = run[True]
    assert np.isfinite(loss) and loss == run[False][0]
    assert bool(torch.isfinite(g).all()) and float(g[0].abs().max()) > 0
    assert not torch.equal(g, run[False][1])


def test_inverse_renderer_defaults_to_cuda():
    """No fallback hides the device: without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = mixed_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 64, **CAM_KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        pgrad.make_inverse_renderer(scene, cam, torch.zeros(H, W, 3), width=W, height=H)


def test_profile_grad_busy_union_and_needs_cuda():
    """The profiler script's device-busy time is the union of kernel
    intervals (overlaps and nesting counted once); without a card it
    raises rather than profiling the CPU."""
    from raytracer_tpu_torch.utils import profile_grad

    assert profile_grad.busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert profile_grad.busy_us([]) == 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_grad.main([])
