"""The port's integrator against the JAX package: the plain twin of the
persistent kernel (integrator/wavefront.py:regen_plain) per lane against JAX
`trace` fed the same counter-RNG uniforms (the tape layout
tests/test_ktape.py pins to the Pallas kernel), the retirement-log fold, the
strided schedule, and the exact-accounting invariants of
tests/test_persistent_kernel.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu.integrator import wavefront as jwf
from raytracer_tpu.ops import ctr_rng as jrng
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.integrator import wavefront as pwf
from raytracer_tpu_torch.ops import ctr_rng as prng
from raytracer_tpu_torch.ops import persistent_kernel as ppk

torch.set_num_threads(1)

SEED = 12345


def mixed_scene(builder_cls, *, noise_sphere=False, procedural_perlin=True):
    """tests/test_ktape.py's scene: all four materials, a quad, a checker;
    with `noise_sphere` also a lambertian sphere with a noise texture, its
    Perlin tables procedural or, with procedural_perlin=False, drawn from
    the builder's rng (seed 0)."""
    b = builder_cls(0)
    ground = b.lambertian(b.checker(0.6, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.add_sphere((0, -100.5, -1), 100, ground)
    b.add_sphere((0, 0, -1), 0.5, b.dielectric(1.5))
    b.add_sphere((-1.1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.add_sphere((1.1, 0.8, -1), 0.3, b.diffuse_light((4, 4, 4)))
    b.add_quad((-2, -0.4, -2.5), (4, 0, 0), (0, 2, 0), b.lambertian((0.4, 0.5, 0.8)))
    if noise_sphere:
        b.add_sphere((0.75, -0.2, -0.3), 0.28, b.lambertian(b.noise(4.0)))
    return b.build(procedural_perlin=procedural_perlin)


CAM_KW = dict(look_from=(0, 0.5, 2), look_at=(0, 0, -1), fov_degrees=60,
              background=(0.7, 0.8, 1.0), defocus_angle_degrees=2.0)


def plain_regen(scene, cam, width, height, spp, wavefront, max_depth, rr_start, seed=SEED):
    """(log (3, K, N), segments, (n, num_slots, jump)) from the plain twin."""
    n_pix = width * height
    n, num_slots, jump = pwf.strided_schedule(n_pix, spp, wavefront)
    rem0, px0, py0 = pwf.schedule_arrays(n, n_pix, spp, width)
    sph, quad, res = ppk.pack_persistent_tables(scene)
    cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, width, height), cam.background)
    log, segs = ppk.render_persistent(
        sph, quad, res, cam_s, seed, rem0, px0, py0, width=width, height=height,
        jump_px=jump % width, jump_py=jump // width, num_slots=num_slots,
        max_depth=max_depth, rr_start=rr_start,
    )
    return log, segs, (n, num_slots, jump)


def jax_trace_samples(jscene_, jcamera, width, height, sids, max_depth, seed=SEED):
    """JAX trace of global sample ids `sids` (pixel = sid mod n_pixels) with
    the counter-RNG camera and bounce uniforms."""
    n_pix = width * height
    sids = jnp.asarray(sids, jnp.int32)
    pix = sids % n_pix
    o, d = jcam.camera_rays(jcam.camera_frame(jcamera, width, height), pix % width,
                            pix // width, jrng.camera_uniforms(seed, sids))
    useq = jrng.bounce_uniform_seq(seed, sids, max_depth)
    rad = jwf.trace(jscene_, o, d, jax.random.PRNGKey(0), jcamera.background,
                    max_depth=max_depth, uniform_seq=useq)
    return np.asarray(rad)


def assert_radiance_close(got, want):
    """allclose rtol 1e-4 / atol 1e-5 on >= 99.5% of lanes (libm sin/cos
    ulps may flip a rare branch), mean radiance within 1e-4 relative."""
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-4)


def test_plain_twin_matches_jax_trace_one_sample_per_lane():
    """64x36, depth 8, one sample per lane, russian roulette off."""
    width, height, max_depth = 64, 36, 8
    jcamera, _ = jcam.make_camera(16 / 9, width, **CAM_KW)
    pcamera, _ = pcam.make_camera(16 / 9, width, **CAM_KW)
    n_pix = width * height
    log, segs, (n, num_slots, _) = plain_regen(
        mixed_scene(pscene.SceneBuilder), pcamera, width, height, 1, n_pix, max_depth,
        rr_start=max_depth,
    )
    assert (n, num_slots) == (n_pix, 1)
    got = log[:, 0, :].T.numpy()
    want = jax_trace_samples(mixed_scene(jscene.SceneBuilder), jcamera, width, height,
                             np.arange(n_pix), max_depth)
    assert_radiance_close(got, want)
    assert int(segs.min()) >= 1 and int(segs.max()) <= max_depth
    assert (want > 0).any(axis=1).mean() > 0.5


def test_plain_twin_slots_are_the_strided_samples():
    """With several samples per lane (K > 1), cell (k, L) holds global
    sample L + k*N at pixel (L + k*N) mod n_pixels: the port's own `trace`
    of that sample reproduces it exactly, and JAX `trace` within the
    tolerance above."""
    width, spp, max_depth, wavefront = 24, 3, 6, 250
    jcamera, _ = jcam.make_camera(16 / 9, width, **CAM_KW)
    pcamera, settings = pcam.make_camera(16 / 9, width, **CAM_KW)
    height = settings.height
    pscene_ = mixed_scene(pscene.SceneBuilder)
    log, _, (n, num_slots, jump) = plain_regen(
        pscene_, pcamera, width, height, spp, wavefront, max_depth, rr_start=max_depth
    )
    n_pix = width * height
    assert num_slots == -(-n_pix * spp // n) > 1 and jump == n % n_pix
    k, lane = np.meshgrid(np.arange(num_slots), np.arange(n), indexing="ij")
    sid = (lane + k * n).ravel()
    valid = sid < n_pix * spp
    got = log.reshape(3, -1).T.numpy()[valid]
    sid = sid[valid]

    pix = torch.from_numpy(sid % n_pix)
    frame = pcam.camera_frame(pcamera, width, height)
    o, d = pcam.camera_rays(frame, pix % width, pix // width,
                            prng.camera_uniforms(SEED, torch.from_numpy(sid)))
    useq = prng.bounce_uniform_seq(SEED, torch.from_numpy(sid), max_depth)
    own = pwf.trace(pscene_, o, d, pcamera.background, lambda b, lanes: useq[b][lanes],
                    max_depth=max_depth)
    np.testing.assert_array_equal(got, own.numpy())
    want = jax_trace_samples(mixed_scene(jscene.SceneBuilder), jcamera, width, height,
                             sid, max_depth)
    assert_radiance_close(got, want)


def test_port_trace_matches_jax_trace_sky_gradient():
    """The port's trace with injected uniforms against JAX trace, on
    rand_spheres' geometry with the gradient sky, camera rays only (deeper,
    its many small spheres turn float32 hit-point differences into
    different paths: 0.3% of lanes at depth 2, 1.3% at depth 6; the mixed
    scene above holds the bounces)."""
    from raytracer_tpu.scenes.registry import get_scene as jax_get_scene
    from raytracer_tpu_torch.scenes.registry import get_scene

    depth = 1
    jsc, jc, js = jax_get_scene("one_weekend_final", width=32)
    psc, pc, _ = get_scene("one_weekend_final", width=32)
    n = js.width * js.height
    sid = np.arange(n)
    o, d = jcam.camera_rays(jcam.camera_frame(jc, js.width, js.height), jnp.asarray(sid % 32),
                            jnp.asarray(sid // 32), jrng.camera_uniforms(SEED, jnp.asarray(sid)))
    useq = jrng.bounce_uniform_seq(SEED, jnp.asarray(sid), depth)
    want = np.asarray(jwf.trace(jsc, o, d, jax.random.PRNGKey(0), jc.background,
                                max_depth=depth, uniform_seq=useq, sky_gradient=True))
    pseq = torch.tensor(np.asarray(useq))
    got = pwf.trace(psc, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)), pc.background,
                    lambda b, lanes: pseq[b][lanes], max_depth=depth, sky_gradient=True)
    assert_radiance_close(got.numpy(), want)


@pytest.mark.parametrize("n,n_pix,spp", [(1000, 1500, 4), (4096, 1024, 6), (777, 100, 9),
                                         (300, 2000, 3), (500, 997, 4), (2000, 997, 5)])
def test_fold_log_matches_jax(n, n_pix, spp):
    """Random log; wavefront smaller than (once with several wraps), a
    multiple of, and coprime to the pixel count, and a prime pixel count
    below and above the wavefront."""
    num_slots = -(-n_pix * spp // n)
    jump = pwf.regen_jump(n, n_pix)
    log = np.random.default_rng(n).uniform(0, 2, (3, num_slots, n)).astype(np.float32)
    want = np.asarray(jwf._fold_log(jnp.asarray(log), num_slots, n, n_pix, jump, 0, 0, False))
    got = pwf._fold_log(torch.from_numpy(log), num_slots, n, n_pix, jump)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def padded_fold(log, num_slots, n, n_pixels, jump):
    """The fold as it was before it took its log in place: the whole log
    padded to whole chunks of n_pixels lanes, chunk-summed into a (3, K,
    n_pixels) copy, each slot rolled into the framebuffer (the reference
    the fold must equal bit for bit)."""
    chunks = -(-n // n_pixels)
    log = torch.nn.functional.pad(log, (0, chunks * n_pixels - n))
    per_slot = log.reshape(3, num_slots, chunks, n_pixels).sum(dim=2)
    fb = torch.zeros(n_pixels, 3, dtype=log.dtype, device=log.device)
    for k in range(num_slots):
        fb = fb + torch.roll(per_slot[:, k, :].T, (k * jump) % n_pixels, dims=0)
    return fb


# (n, n_pixels, spp, slots a fold group or None for the default scratch):
# fewer lanes than pixels, 2 and 3 chunks, equal, a prime pixel count
# below and above the lanes, one lane and one pixel, the headline's ratio
# (2^18 lanes over 90,000 pixels), and groups of 4 slots, the last short.
FOLD_SHAPES = [(1000, 1500, 4, None), (1500, 1000, 6, None), (2600, 1000, 7, None),
               (1024, 1024, 5, None), (500, 997, 9, None), (2000, 997, 5, None),
               (1, 1, 3, None), (2621, 900, 50, None), (2621, 900, 50, 4)]


@pytest.mark.parametrize("n,n_pix,spp,group", FOLD_SHAPES)
def test_fold_log_matches_padded_fold(n, n_pix, spp, group, monkeypatch):
    """The fold equals the padded whole-log fold bit for bit, on a random
    log of the schedule's shape."""
    num_slots = -(-n_pix * spp // n)
    jump = pwf.regen_jump(n, n_pix)
    if group is not None:
        chunks = -(-n // n_pix)
        monkeypatch.setattr(pwf, "FOLD_SCRATCH_BYTES", 12 * n_pix * (chunks + 1) * group)
        assert pwf._fold_group(num_slots, n, n_pix) == group and num_slots % group
    log = torch.from_numpy(
        np.random.default_rng(n + n_pix).uniform(0, 2, (3, num_slots, n)).astype(np.float32))
    got = pwf._fold_log(log, num_slots, n, n_pix, jump)
    assert torch.equal(got, padded_fold(log, num_slots, n, n_pix, jump))


@pytest.mark.parametrize("n,n_pix,spp,scratch", [(1000, 5003, 50, None),
                                                 (2600, 1000, 40, 12 * 1000 * 4 * 5)])
def test_fold_log_scratch_is_bounded(n, n_pix, spp, scratch, monkeypatch):
    """Every tensor the fold creates, views included, has at most max(3P,
    the group scratch's) elements: with fewer lanes than pixels and K*P >=
    10^6 no more than the framebuffer; with more lanes, a 5-slot group of
    its 16 slots. Either is below the whole padded log. The
    fold_scratch_bytes it reports is that group's and one rolled slot's."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    if scratch is not None:
        monkeypatch.setattr(pwf, "FOLD_SCRATCH_BYTES", scratch)
    num_slots = -(-n_pix * spp // n)
    assert n > n_pix or num_slots * n_pix >= 10**6

    class Sizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numels = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.numels += [t.numel() for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            return out

    log = torch.ones(3, num_slots, n)
    with Sizes() as sizes:
        pwf._fold_log(log, num_slots, n, n_pix, pwf.regen_jump(n, n_pix))
    bound = max(3 * n_pix, pwf.FOLD_SCRATCH_BYTES // 4 if n > n_pix else 0)
    padded_log = 3 * num_slots * -(-n // n_pix) * n_pix
    assert sizes.numels and max(sizes.numels) <= bound < padded_log
    want = 0 if n <= n_pix else pwf.FOLD_SCRATCH_BYTES + 12 * n_pix  # a group, a rolled slot
    assert pwf.fold_scratch_bytes(num_slots, n, n_pix) == want


def log_only_spp_chunk_for(n_pixels, spp, wavefront, budget):
    """The chunk rule before the budget counted the framebuffer and the
    fold: the largest chunk whose retirement log alone fits."""
    from raytracer_tpu_torch.render.driver import log_bytes

    chunk = min(spp, max(1, budget // (12 * n_pixels)))
    while chunk > 1 and log_bytes(n_pixels, chunk, wavefront) > budget:
        chunk -= 1
    return chunk


def test_chunk_budget_counts_the_fold():
    """At 3840x2160@64, the book render's 1200x800@125 and the headline,
    the chunk that spp_chunk_for picks holds its log, framebuffer and the
    fold's scratch (at most FOLD_SCRATCH_BYTES) within LOG_BUDGET_BYTES, and
    is the largest that does. 3840x2160 takes 20 spp a chunk (at 21 the
    log alone fits, the framebuffer does not). Every render row of the
    bench keeps the chunk of the log-only rule."""
    from raytracer_tpu_torch import bench
    from raytracer_tpu_torch.render import driver
    from raytracer_tpu_torch.scenes.registry import get_scene

    wavefront, budget = driver.DEFAULT_WAVEFRONT, driver.LOG_BUDGET_BYTES

    def held(n_pix, spp):
        n, num_slots, _ = pwf.strided_schedule(n_pix, spp, wavefront)
        scratch = pwf.FOLD_SCRATCH_BYTES + n_pix * 3 * 4 if n > n_pix else 0
        return 3 * num_slots * n * 4 + n_pix * 3 * 4 + scratch

    for (w, h, spp) in ((3840, 2160, 64), (1200, 800, 125), (400, 225, 500)):
        chunk = driver.spp_chunk_for(w * h, spp, wavefront, budget)
        assert held(w * h, chunk) <= budget
        assert chunk == spp or held(w * h, chunk + 1) > budget
    assert driver.spp_chunk_for(3840 * 2160, 64, wavefront, budget) == 20
    assert log_only_spp_chunk_for(3840 * 2160, 64, wavefront, budget) == 21
    rows = [fn.keywords for fn in bench.ROWS.values()
            if isinstance(fn, functools.partial) and fn.func is bench.render_row]
    shapes = {(400, 225, 500)}  # the headline
    for kw in rows:
        _, _, st = get_scene(kw["scene"], spp=kw["spp"],
                             **({"width": kw["width"]} if "width" in kw else {}))
        shapes.add((st.width, st.height, st.samples_per_pixel))
    assert len(rows) == 12 and (1200, 800, 125) in shapes and (600, 600, 200) in shapes
    for (w, h, spp) in shapes:
        assert (driver.spp_chunk_for(w * h, spp, wavefront, budget)
                == log_only_spp_chunk_for(w * h, spp, wavefront, budget)), (w, h, spp)


@pytest.mark.parametrize("n_pix", [1, 97, 1024, 4096, 50000])
def test_schedule_matches_jax(n_pix):
    for n in (1, 64, 1000, 1024, 8192, 16384):
        assert pwf.regen_jump(n, n_pix) == jwf.regen_jump(n, n_pix)
    spp, width = 5, max(1, n_pix // 7)
    n = 16384  # a Pallas tile multiple: JAX's strided_schedule rounds to tiles
    jn, jslots, jjump = jwf.strided_schedule(n_pix, spp, n)
    pn, pslots, pjump = pwf.strided_schedule(n_pix, spp, jn)
    assert (pn, pslots, pjump) == (min(jn, n_pix * spp), -(-n_pix * spp // pn),
                                   pwf.regen_jump(pn, n_pix))
    for got, want in zip(pwf.schedule_arrays(jn, n_pix, spp, width),
                         jwf.schedule_arrays(jn, n_pix, spp, width)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wavefront", [32, 100, 256, 1024, 4096])
def test_miss_only_exact_accounting(wavefront):
    """No geometry: every sample is the background, retired exactly once
    (tests/test_persistent_kernel.py:51), for several wavefront sizes, the
    first 8x smaller than the image."""
    b = pscene.SceneBuilder(0)
    b.lambertian((0.5, 0.5, 0.5))
    scene = b.build()
    cam, st = pcam.make_camera(1.0, 16, max_depth=8, background=(0.2, 0.4, 0.6),
                               look_from=(0, 0, 2), look_at=(0, 0, 0))
    spp = 5
    n_pix = st.width * st.height
    sph, quad, res = ppk.pack_persistent_tables(scene)
    cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, 16, 16), cam.background)
    fb, segs = pwf.render_wavefront_regen(sph, quad, res, cam_s, 3, width=16, height=16,
                                          spp=spp, wavefront_size=wavefront, max_depth=8)
    assert int(segs.sum()) == n_pix * spp
    expect = np.tile(np.array([0.2, 0.4, 0.6], np.float32) * spp, (n_pix, 1))
    np.testing.assert_allclose(fb.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_emitter_exact():
    """A huge emissive sphere around the camera: every ray emits and ends."""
    b = pscene.SceneBuilder(0)
    b.add_sphere((0, 0, 0), 100.0, b.diffuse_light((3.0, 2.0, 1.0)))
    scene = b.build()
    cam, _ = pcam.make_camera(1.0, 8, max_depth=8, background=(9, 9, 9),
                              look_from=(0, 0, 0), look_at=(0, 0, -1))
    sph, quad, res = ppk.pack_persistent_tables(scene)
    cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, 8, 8), cam.background)
    fb, segs = pwf.render_wavefront_regen(sph, quad, res, cam_s, 1, width=8, height=8, spp=3,
                                          wavefront_size=50, max_depth=8)
    assert int(segs.sum()) == 64 * 3
    np.testing.assert_allclose(fb.numpy(), np.tile([9.0, 6.0, 3.0], (64, 1)), rtol=1e-6)


def test_russian_roulette_unbiased():
    """RR on (start 1, cap 0.75) vs off, in a closed diffuse box lit by an
    emitter: the image means agree statistically (the RR estimator is
    unbiased; only its variance grows)."""
    b = pscene.SceneBuilder(0)
    b.add_sphere((0, 0, 0), 10.0, b.lambertian((0.7, 0.7, 0.7)))
    b.add_sphere((0, 3, -4), 2.0, b.diffuse_light((2.0, 2.0, 2.0)))
    scene = b.build()
    cam, _ = pcam.make_camera(1.0, 16, max_depth=8, look_from=(0, 0, 5), look_at=(0, 0, 0))
    means = {}
    for rr_start in (1, 8):
        log, segs, _ = plain_regen(scene, cam, 16, 16, 64, 4096, 8, rr_start=rr_start)
        per_sample = log.sum(dim=0).reshape(-1).numpy()
        means[rr_start] = (per_sample.mean(), per_sample.std() / np.sqrt(per_sample.size), int(segs.sum()))
    (m_rr, se_rr, segs_rr), (m_off, se_off, segs_off) = means[1], means[8]
    assert abs(m_rr - m_off) < 5 * np.hypot(se_rr, se_off), means
    assert segs_rr < segs_off  # roulette did terminate paths early


def test_scene_support_gates():
    """The persistent kernel serves every texture kind (noise, images,
    bilinear filtering) at any size, and refuses one kind of scene, as
    JAX's scene_supports_persistent does: noise from rng-filled Perlin
    tables (`procedural_perlin=False`), which `render_path` sends down the
    wavefront-step path, or past LARGE_SCENE_PRIMS the large-scene path.
    Large scenes (rand_spheres_large, quad_field, 2,000 solid spheres) take
    the persistent path and render clustered. Bilinear scenes render."""
    from raytracer_tpu_torch.geometry.scene import SceneBuilder
    from raytracer_tpu_torch.render.driver import LARGE_SCENE_PRIMS, render_image, render_path
    from raytracer_tpu_torch.scenes.registry import get_scene
    from raytracer_tpu_torch.utils.metrics import RenderMetrics

    for name, kw in (("rand_spheres_large", {}), ("quad_field", {}),
                     ("rand_spheres_large", {"n_spheres": 2000})):
        scene, cam, st = get_scene(name, width=8, spp=1, max_depth=2, **kw)
        assert scene.num_prims > ppk.CLUSTERED_SCENE_PRIMS
        assert ppk.scene_supports_persistent(scene) and ppk.unsupported_reason(scene) is None
        assert render_path(scene) == "persistent"
        metrics = RenderMetrics(total_spp=1, pixels=st.width * st.height)
        img = render_image(scene, cam, st, device="cpu", metrics=metrics)
        assert bool(torch.isfinite(img).all()) and sum(metrics.cluster_rows) > 1
    rng_perlin = get_scene("perlin", width=8, procedural_perlin=False)[0]
    assert "rng-filled Perlin" in ppk.unsupported_reason(rng_perlin)
    assert render_path(rng_perlin) == "wavefront_step"
    b = SceneBuilder(0)
    marble = b.lambertian(b.noise(4.0))
    for i in range(LARGE_SCENE_PRIMS + 1):
        b.add_sphere((i % 64, 0.2, i // 64), 0.3, marble)
    big_rng_perlin = b.build(procedural_perlin=False)
    assert "rng-filled Perlin" in ppk.unsupported_reason(big_rng_perlin)
    assert render_path(big_rng_perlin) == "large_scene"
    for name in ("rand_spheres", "one_weekend_final", "quads", "cornell", "perlin",
                 "simple_light", "earth"):
        scene = get_scene(name, width=8)[0]
        assert ppk.scene_supports_persistent(scene) and render_path(scene) == "persistent"
    scene, cam, st = get_scene("earth", width=8, spp=1, bilinear=True)
    assert render_path(scene) == "persistent"
    img = render_image(scene, cam, st, device="cpu")
    assert img.shape == (st.height, 8, 3) and bool(torch.isfinite(img).all())


def _trace_inputs(scene_cam, width, spp, seed):
    """Camera rays of `spp` samples per pixel (sample id L at pixel L mod
    n_pixels) and the counter-RNG shading uniforms of those ids."""
    cam = scene_cam
    height = width
    n = width * height
    sid = torch.arange(spp * n)
    pix = sid % n
    o, d = pcam.camera_rays(pcam.camera_frame(cam, width, height), pix % width, pix // width,
                            prng.camera_uniforms(seed, sid))
    return o, d, lambda bounce, lanes: prng.bounce_uniforms(seed, lanes, bounce)


def test_trace_without_roulette_is_unchanged():
    """`trace` with russian_roulette off is the estimator it was before the
    option: bit-equal to the tape kernel's twin (trace_tape_plain, pinned to
    JAX by test_torch_tape.py) on the same samples, and to `trace` with
    roulette on but never reaching its start depth."""
    scene = mixed_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(16 / 9, 32, **CAM_KW)
    width, height, depth, seed = 32, 18, 6, 77
    n = width * height
    sid = torch.arange(n)
    o, d = pcam.camera_rays(pcam.camera_frame(cam, width, height), sid % width, sid // width,
                            prng.camera_uniforms(seed, sid))
    uni = lambda bounce, lanes: prng.bounce_uniforms(seed, lanes, bounce)  # noqa: E731
    off, segs = pwf.trace(scene, o, d, cam.background, uni, max_depth=depth,
                          return_segments=True)
    sph, quad, res = ppk.pack_persistent_tables(scene)
    cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, width, height), cam.background)
    rad3, _, segs3 = pwf.trace_tape_plain(sph, quad, res, cam_s, seed, n, width=width,
                                          height=height, max_depth=depth, sky_gradient=False)
    assert torch.equal(off, rad3.T) and torch.equal(segs, segs3)
    never = pwf.trace(scene, o, d, cam.background, uni, max_depth=depth, russian_roulette=True,
                      rr_start_depth=depth + 1,
                      rr_uniform=lambda b, lanes: prng.rr_uniforms(seed, lanes, b, depth))
    assert torch.equal(off, never)
    with pytest.raises(ValueError, match="rr_uniform"):
        pwf.trace(scene, o, d, cam.background, uni, max_depth=depth, russian_roulette=True)


def test_roulette_step_matches_jax_formula():
    """The roulette step on given throughputs, alive masks, depths and coins
    equals the JAX package's rule (raytracer_tpu/integrator/wavefront.py:
    477-483) evaluated in jnp, bit for bit."""
    rng = np.random.default_rng(3)
    n = 4096
    tp = rng.uniform(0.0, 1.2, (n, 3)).astype(np.float32)
    tp[:64] = 0.0  # q clamps at the floor
    alive = rng.uniform(size=n) < 0.8
    depth = rng.integers(0, 9, n).astype(np.int32)
    coin = rng.uniform(size=n).astype(np.float32)
    for start, hi in ((5, 0.95), (1, 0.75)):
        q = jnp.clip(jnp.max(tp, axis=-1), 0.05, hi)
        rr_on = alive & (depth >= start)
        want_alive = alive & (~rr_on | (coin < q))
        want_tp = jnp.where((rr_on & want_alive)[:, None], tp / q[:, None], tp)
        got_alive, got_tp = pwf.roulette(torch.from_numpy(tp), torch.from_numpy(alive),
                                         torch.from_numpy(depth), torch.from_numpy(coin),
                                         start=start, lo=0.05, hi=hi)
        np.testing.assert_array_equal(got_alive.numpy(), np.asarray(want_alive))
        np.testing.assert_array_equal(got_tp.numpy(), np.asarray(want_tp))


def test_trace_live_ends_lanes_after_their_first_bounce():
    """Lanes False in `live` take one bounce (one segment) and the others
    trace bit for bit as without the mask, with and without roulette and the
    stable sphere hits."""
    scene = mixed_scene(pscene.SceneBuilder)
    cam, _ = pcam.make_camera(1.0, 16, **CAM_KW)
    o, d, uni = _trace_inputs(cam, 16, 2, 5)
    live = torch.arange(o.shape[0]) % 3 != 0
    for kw in ({}, dict(russian_roulette=True, rr_start_depth=2, rr_max_q=0.75,
                        rr_uniform=lambda b, lanes: prng.rr_uniforms(5, lanes, b, 6),
                        stable_spheres=True)):
        full, segs = pwf.trace(scene, o, d, cam.background, uni, max_depth=6,
                               return_segments=True, **kw)
        part, segs_live = pwf.trace(scene, o, d, cam.background, uni, max_depth=6,
                                    return_segments=True, live=live, **kw)
        assert torch.equal(part[live], full[live]) and torch.equal(segs_live[live], segs[live])
        assert bool((segs_live[~live] == 1).all()) and bool((segs[~live] > 1).any())


def test_trace_roulette_unbiased_against_jax():
    """In a closed diffuse box lit by an emitter (every path long), the
    port's trace with russian roulette from depth 2 has the image mean of
    its trace without it and of JAX's trace(russian_roulette=True), each
    within 4 sigma, and traces fewer segments."""
    def box(builder_cls):
        b = builder_cls(0)
        b.add_sphere((0, 0, 0), 10.0, b.lambertian((0.7, 0.7, 0.7)))
        b.add_sphere((0, 3, -4), 2.0, b.diffuse_light((2.0, 2.0, 2.0)))
        return b.build()

    width, spp, depth, seed = 16, 16, 8, 9
    cam_kw = dict(look_from=(0, 0, 5), look_at=(0, 0, 0))
    cam, _ = pcam.make_camera(1.0, width, **cam_kw)
    o, d, uni = _trace_inputs(cam, width, spp, seed)
    scene = box(pscene.SceneBuilder)
    stats = {}
    for label, kw in (("off", {}), ("rr", dict(
            russian_roulette=True, rr_start_depth=2, rr_max_q=0.75,
            rr_uniform=lambda b, lanes: prng.rr_uniforms(seed, lanes, b, depth)))):
        rad, segs = pwf.trace(scene, o, d, cam.background, uni, max_depth=depth,
                              return_segments=True, **kw)
        per = rad.sum(dim=1).double().numpy()
        stats[label] = (per.mean(), per.std() / np.sqrt(per.size), int(segs.sum()))
    jcamera, _ = jcam.make_camera(1.0, width, **cam_kw)
    rad = jwf.trace(box(jscene.SceneBuilder), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                    jax.random.PRNGKey(seed), jcamera.background, max_depth=depth,
                    russian_roulette=True, rr_start_depth=2, rr_max_q=0.75)
    per = np.asarray(rad).sum(axis=1).astype(np.float64)
    stats["jax_rr"] = (per.mean(), per.std() / np.sqrt(per.size), 0)
    m_rr, se_rr, segs_rr = stats["rr"]
    for other in ("off", "jax_rr"):
        m, se, _ = stats[other]
        assert abs(m_rr - m) < 4 * np.hypot(se_rr, se), stats
    assert segs_rr < stats["off"][2], stats
