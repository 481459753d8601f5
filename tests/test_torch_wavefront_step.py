"""Kernel 5's plain twin (ops/wavefront_kernel.py:wavefront_step_plain)
against the JAX package's wavefront_step_pallas run in interpret mode, and
the wavefront-step path (integrator/wavefront.py:wavefront_step_loop)
against kernel 2's twin regen_plain, bit for bit, with the same russian
roulette settings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.core.camera import camera_frame as jframe
from raytracer_tpu.core.camera import camera_rays as jrays
from raytracer_tpu.core.camera import make_camera as jmake_camera
from raytracer_tpu.geometry.intersect import quad_derived
from raytracer_tpu.geometry.scene import SceneBuilder
from raytracer_tpu.ops import intersect_kernel as jik
from raytracer_tpu.ops.wavefront_kernel import pack_camera_scalars, wavefront_step_pallas
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.integrator import wavefront as pwf
from raytracer_tpu_torch.materials.packed import texture_tables
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops import intersect_kernel as pik
from raytracer_tpu_torch.ops import persistent_kernel as ppk
from raytracer_tpu_torch.ops import wavefront_kernel as pwk
from raytracer_tpu_torch.scenes.registry import get_scene

torch.set_num_threads(1)

W = H = 32
N = 8 * 128  # one interpret-mode tile of rows=8


def small_scene(builder_cls):
    """tests/test_pallas_kernel.py's scene: 20 spheres and 6 quads."""
    rng = np.random.default_rng(1234)
    b = builder_cls(0)
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(20):
        b.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.3, 1.5), m)
    for _ in range(6):
        b.add_quad(rng.uniform(-5, 5, 3), rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3), m)
    return b.build()


def jax_step(state, seed=7):
    """wavefront_step_pallas in interpret mode (its PRNG reads zeros)."""
    jsc = small_scene(SceneBuilder)
    cam, _ = jmake_camera(1.0, W, fov_degrees=60, look_from=(0, 0, 8), look_at=(0, 0, 0))
    frame = jframe(cam, W, H)
    args = [jik.pack_sphere_table(jsc.sph_center, jsc.sph_radius),
            jik.pack_quad_table(quad_derived(jsc)), pack_camera_scalars(frame), jnp.int32(seed)]
    args += [jnp.asarray(state[k]) for k in ("origin", "direction", "active", "remaining", "px",
                                             "py", "sample_k")]
    with pltpu.force_tpu_interpret_mode():
        out = wavefront_step_pallas(*args, width=W, height=H, jump_px=state["jump_px"],
                                    jump_py=state["jump_py"], rows=8)
        out = {k: np.asarray(v) for k, v in out.items()}
    return out, jsc, frame


def port_step(state, seed=7):
    psc = small_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(1.0, W, fov_degrees=60, look_from=(0, 0, 8), look_at=(0, 0, 0))
    sph, quad, _ = ppk.pack_persistent_tables(psc)
    cs = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, W, H), cam.background)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items() if not k.startswith("jump")}
    return pwk.wavefront_step(
        sph, quad, cs, seed, t["origin"], t["direction"], t["active"], t["remaining"], t["px"],
        t["py"], t["sample_k"], t["depth"], width=W, height=H, jump_px=state["jump_px"],
        jump_py=state["jump_py"], max_depth=8,
    )


def start_state():
    lane = np.arange(N, dtype=np.int32)
    return dict(origin=np.zeros((N, 3), np.float32), direction=np.ones((N, 3), np.float32),
                active=np.zeros(N, bool), remaining=np.ones(N, np.int32),
                px=lane % W, py=(lane // W) % H, sample_k=np.full(N, -1, np.int32),
                depth=np.zeros(N, np.int32), jump_px=0, jump_py=0)


def mid_state():
    """Partly active lanes, some owing samples, strided pixels advancing
    (with carries and wraps), slots already taken."""
    rng = np.random.default_rng(3)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = (rng.uniform(-4, 4, (N, 3)).astype(np.float32) - o).astype(np.float32)
    return dict(origin=o, direction=d, active=rng.random(N) < 0.5,
                remaining=rng.integers(0, 3, N).astype(np.int32),
                px=rng.integers(0, W, N).astype(np.int32), py=rng.integers(0, H, N).astype(np.int32),
                sample_k=rng.integers(-1, 4, N).astype(np.int32),
                depth=rng.integers(0, 6, N).astype(np.int32), jump_px=27, jump_py=5)


@pytest.mark.parametrize("which", ["start", "mid"])
def test_step_twin_matches_jax_interpret(which):
    """grant, remaining, px, py and sample_k equal the JAX kernel's; rays of
    lanes not granted pass through unchanged; the camera origin is the
    camera center (no defocus)."""
    state = start_state() if which == "start" else mid_state()
    ref, _, frame = jax_step(state)
    got = port_step(state)
    for f in ("grant", "remaining", "px", "py", "sample_k"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f], err_msg=f)
    grant = ref["grant"]
    assert grant.any() and (which == "start") == grant.all()
    keep = ~grant
    np.testing.assert_array_equal(got.origin.numpy()[keep], state["origin"][keep])
    np.testing.assert_array_equal(got.direction.numpy()[keep], state["direction"][keep])
    np.testing.assert_allclose(got.origin.numpy()[grant],
                               np.tile(np.asarray(frame.center), (int(grant.sum()), 1)), atol=1e-6)
    live = state["active"] | grant
    assert np.isinf(got.t.numpy()[~live]).all() and (got.prim.numpy()[~live] == -1).all()


@pytest.mark.parametrize("which", ["start", "mid"])
def test_step_twin_hit_on_the_jax_steps_rays(which):
    """The twin's closest hit on the JAX step's own rays (its zero-uniform
    camera rays, or the passed-through rays) against the JAX step's t and
    prim, with tests/test_pallas_kernel.py's tolerance (rtol 2e-4, atol
    1e-4; the JAX kernel and the dense search differ that much)."""
    state = start_state() if which == "start" else mid_state()
    ref, _, _ = jax_step(state)
    psc = small_scene(pscene.SceneBuilder)
    sph, quad, _ = ppk.pack_persistent_tables(psc)
    t, prim = pik.intersect_plain(sph, quad, torch.tensor(ref["origin"]),
                                  torch.tensor(ref["direction"]))
    t, prim = t.numpy(), prim.numpy()
    both = np.isfinite(t) & np.isfinite(ref["t"])
    assert (np.isfinite(t) == np.isfinite(ref["t"])).mean() > 0.995 and both.sum() > 100
    np.testing.assert_allclose(t[both], ref["t"][both], rtol=2e-4, atol=1e-4)
    assert (prim[both] == ref["prim"][both]).mean() > 0.999


def test_step_twin_camera_matches_jax_camera_rays():
    """The granted lanes' rays equal JAX camera_rays at the uniforms the
    twin drew (counters 0-3 of sample id lane + sample_k*N), within 1e-6;
    the four draws follow the counter layout."""
    state = mid_state()
    got = port_step(state, seed=11)
    g = got.grant.numpy()
    lanes = np.flatnonzero(g)
    sid = torch.from_numpy(lanes + got.sample_k.numpy()[g].astype(np.int64) * N)
    uni = ctr_rng.camera_uniforms(11, sid).numpy()
    cam, _ = jmake_camera(1.0, W, fov_degrees=60, look_from=(0, 0, 8), look_at=(0, 0, 0))
    o, d = jrays(jframe(cam, W, H), jnp.asarray(got.px.numpy()[g]), jnp.asarray(got.py.numpy()[g]),
                 jnp.asarray(uni))
    np.testing.assert_allclose(got.origin.numpy()[g], np.asarray(o), atol=1e-6)
    np.testing.assert_allclose(got.direction.numpy()[g], np.asarray(d), atol=1e-6)
    depth = np.where(g, 0, state["depth"]).astype(np.int64)
    sid_all = torch.from_numpy(np.arange(N) + got.sample_k.numpy().astype(np.int64) * N)
    want_rr = ctr_rng.uniform(11, sid_all, ctr_rng.rr_ctr(torch.from_numpy(depth), 8))
    np.testing.assert_array_equal(got.uniforms[:, 3].numpy(), want_rr.numpy())


def step_inputs(name, width, spp, wavefront, max_depth):
    scene, cam, st = get_scene(name, width=width, spp=spp, max_depth=max_depth)
    w, h = st.width, st.height
    n_pix = w * h
    sph, quad, res = ppk.pack_persistent_tables(scene)
    cs = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, w, h), cam.background)
    n, num_slots, jump = pwf.strided_schedule(n_pix, spp, wavefront)
    rem0, px0, py0 = pwf.schedule_arrays(n, n_pix, spp, w)
    cfg = dict(width=w, height=h, jump_px=jump % w, jump_py=jump // w, num_slots=num_slots,
               max_depth=max_depth, rr_start=5, rr_lo=0.05, rr_hi=0.75,
               sky_gradient=st.sky_gradient, max_iters=ppk.max_iters_for(num_slots, max_depth))
    return scene, (sph, quad, res), cs, (rem0, px0, py0), cfg


@pytest.mark.parametrize("name,wavefront", [("rand_spheres", 2592), ("rand_spheres", 1000),
                                            ("cornell", 700), ("perlin", 1000),
                                            ("earth", 1000)])
def test_step_path_equals_regen_plain_bit_for_bit(name, wavefront):
    """At 48 wide, 2 spp, depth 8, rr_hi 0.75 (the persistent path's
    setting), one sample per lane and several: the wavefront-step loop's
    log and segments equal regen_plain's exactly (same estimator, same
    counters), with the texture tables of the noise and image scenes."""
    scene, (sph, quad, res), cs, sched, cfg = step_inputs(name, 48, 2, wavefront, 8)
    tex = texture_tables(scene, pwf.quad_derived(scene))
    assert (tex is None) == (name not in ("perlin", "earth"))
    before = pwk.LAUNCHES
    log_s, segs_s, iters = pwf.wavefront_step_loop(sph, quad, res, tex, cs, 7, *sched, **cfg)
    log_r, segs_r = pwf.regen_plain(sph, quad, res, cs, 7, *sched, **cfg, textures=tex)
    assert pwk.LAUNCHES == before  # CPU tensors take the twin
    assert torch.equal(log_s, log_r) and torch.equal(segs_s, segs_r)
    assert iters >= int(segs_s.max()) and float(log_s.sum()) > 0


def test_step_path_textures_on_perlin():
    """perlin through the step loop with its texture table: finite, every
    sample retired once (segments >= samples), and the marble sphere's
    pixels neither black nor the flat base color of the untextured row."""
    scene, (sph, quad, res), cs, sched, cfg = step_inputs("perlin", 32, 2, 4096, 6)
    cfg["rr_hi"] = 0.95
    tex = texture_tables(scene, pwf.quad_derived(scene))
    log, segs, iters = pwf.wavefront_step_loop(sph, quad, res, tex, cs, 3, *sched, **cfg)
    plain, _, _ = pwf.wavefront_step_loop(sph, quad, res, None, cs, 3, *sched, **cfg)
    assert bool(torch.isfinite(log).all()) and int(segs.sum()) >= 32 * 18 * 2
    assert float(log.mean()) > 0.05 and not torch.equal(log, plain)
