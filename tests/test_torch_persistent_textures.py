"""Noise and image textures in kernels 2 and 3, through their plain twins,
against the JAX package (the mirror of tests/test_persistent_kernel.py's
textured-emitter tests):

* huge textured emitters around the camera, rendered by render_persistent
  on CPU tables (kernel 2's twin), against JAX's perlin_turbulence and
  eval_texture at the hit points of the port's own camera rays (JAX
  intersect_scene): noise; images on a sphere and a quad, nearest, 4-tap
  and the stochastic tap that ops/ctr_rng.py:tap_ctr's uniforms select;
* the stochastic tap's mean against the 4-tap value, and
  image_lookup_bilinear against JAX's _image_lookup_bilinear;
* the tape twin (trace_tape_plain) on tiny earth and perlin against JAX's
  render_persistent_tape in Pallas interpret mode;
* the bucketed gradient step on a tiny bilinear earth against JAX
  make_bucketed_grad_fn(forward="kernel") in interpret mode;
* the twin's counts of marbles and image lookups per lane and per warp
  (regen_plain's TextureWork) against a brute-force count.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.core import camera as jcam
from raytracer_tpu.diff.bucketed import make_bucketed_grad_fn as jax_make_bucketed_grad_fn
from raytracer_tpu.diff.grad import split_scene as jax_split_scene
from raytracer_tpu.geometry import intersect as jint
from raytracer_tpu.geometry import scene as jscene
from raytracer_tpu.materials import textures as jtex
from raytracer_tpu.ops import persistent_kernel as jpk
from raytracer_tpu.scenes.registry import get_scene as jax_get_scene
from raytracer_tpu_torch.core import camera as pcam
from raytracer_tpu_torch.diff import bucketed as pbucketed
from raytracer_tpu_torch.diff import grad as pgrad
from raytracer_tpu_torch.geometry import scene as pscene
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.integrator import wavefront as pwf
from raytracer_tpu_torch.materials import packed as ppacked
from raytracer_tpu_torch.materials import textures as ptex
from raytracer_tpu_torch.ops import ctr_rng as prng
from raytracer_tpu_torch.ops import persistent_kernel as ppk
from raytracer_tpu_torch.scenes.registry import get_scene

torch.set_num_threads(1)

W = 16  # emitter images are W x W
SEED = 3
DEPTH = 4


def emitter_scene(builder_cls, kind):
    """tests/test_persistent_kernel.py's emitters: a noise sphere, an
    image sphere, or an image sphere with an image quad in front of the
    camera (both UV paths)."""
    rng = np.random.default_rng(9)
    img = rng.uniform(0.0, 1.0, (16, 48, 3)).astype(np.float32)
    img2 = rng.uniform(0.0, 1.0, (11, 13, 3)).astype(np.float32)
    b = builder_cls(0)
    if kind == "noise":
        b.add_sphere((0, 0, 0), 100.0, b.diffuse_light(b.noise(0.7)))
        return b, {}
    b.add_sphere((0, 0, 0), 100.0, b.diffuse_light(b.image(img)))
    b.add_quad((-0.8, -0.8, -2.0), (1.6, 0, 0), (0, 1.6, 0), b.diffuse_light(b.image(img2)))
    return b, {1: 1}  # prim 1 (the quad) reads texture 1


def emitter_render(kind, image_filter):
    """(port framebuffer (W*W, 3), JAX scene, JAX hit record of the port's
    camera rays, sample ids) for one sample per pixel."""
    bilinear = image_filter != ppacked.FILTER_NEAREST
    pb, _ = emitter_scene(pscene.SceneBuilder, kind)
    psc = pb.build(bilinear_textures=bilinear)
    jb, _ = emitter_scene(jscene.SceneBuilder, kind)
    jsc = jb.build(bilinear_textures=bilinear)
    cam_kw = dict(samples_per_pixel=1, max_depth=DEPTH, background=(9, 9, 9),
                  look_from=(0, 0, 0), look_at=(0.1, -0.1, -1))
    cam, _ = pcam.make_camera(1.0, W, **cam_kw)
    frame = pcam.camera_frame(cam, W, W)
    sph, quad, res = ppk.pack_persistent_tables(psc)
    cam_s = ppk.pack_camera_scalars_bg(frame, cam.background)
    textures = ppacked.texture_tables(psc, quad_derived(psc),
                                      stochastic=image_filter == ppacked.FILTER_STOCHASTIC)
    assert textures.image_filter == image_filter
    fb, segs = pwf.render_wavefront_regen(sph, quad, res, cam_s, SEED, width=W, height=W, spp=1,
                                          wavefront_size=W * W, max_depth=DEPTH,
                                          textures=textures)
    assert int(segs.sum()) == W * W  # every camera ray hits the emitter and ends
    sid = torch.arange(W * W)
    o, d = pcam.camera_rays(frame, sid % W, sid // W, prng.camera_uniforms(SEED, sid))
    hit = jint.intersect_scene(jsc, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    assert bool(np.asarray(hit.hit).all())
    return fb.numpy(), jsc, hit, sid


def test_noise_emitter_matches_jax_marble():
    """Radiance = the marble at the hit point (JAX's rtol 2e-4, atol 2e-5)."""
    fb, jsc, hit, _ = emitter_render("noise", ppacked.FILTER_NEAREST)
    sp = hit.point * 0.7
    val = np.asarray(0.5 * (1.0 + jnp.sin(sp[:, 2] + 10.0 * jtex.perlin_turbulence(jsc, sp, 7))))
    np.testing.assert_allclose(fb, np.tile(val[:, None], (1, 3)), rtol=2e-4, atol=2e-5)


def jax_texture_ids(hit, quad_tex):
    prim = np.asarray(hit.prim_id)
    tex = np.zeros_like(prim)
    for p, t in quad_tex.items():
        tex[prim == p] = t
    return jnp.asarray(tex, jnp.int32), prim


@pytest.mark.parametrize("image_filter", [ppacked.FILTER_NEAREST, ppacked.FILTER_BILINEAR])
def test_image_emitter_matches_jax_eval_texture(image_filter):
    """Radiance = JAX eval_texture at the hit's UV on the sphere and the
    quad, nearest or 4-tap bilinear (JAX's rtol and atol 2e-5)."""
    fb, jsc, hit, _ = emitter_render("image", image_filter)
    _, quad_tex = emitter_scene(jscene.SceneBuilder, "image")
    tex, prim = jax_texture_ids(hit, quad_tex)
    assert 0.1 < (prim == 1).mean() < 0.9  # both UV paths
    want = np.asarray(jtex.eval_texture(jsc, tex, hit.u, hit.v, hit.point,
                                        bilinear=image_filter == ppacked.FILTER_BILINEAR))
    np.testing.assert_allclose(fb, want, rtol=2e-5, atol=2e-5)


def test_stochastic_emitter_takes_the_tap_its_uniforms_select():
    """The stochastic filter's radiance is the texel at (floor(x) +
    [u_x < fx], floor(y) + [u_y < fy]), clamped, with x, y from JAX's hit
    UV and u_x, u_y the counter RNG's tap_ctr draws of bounce 0 (JAX's
    rtol and atol 2e-5); it differs from the 4-tap image."""
    fb, jsc, hit, sid = emitter_render("image", ppacked.FILTER_STOCHASTIC)
    _, quad_tex = emitter_scene(jscene.SceneBuilder, "image")
    tex, prim = jax_texture_ids(hit, quad_tex)
    img_id = np.where(prim == 1, 1, 0)
    dims = np.asarray(jsc.image_dims)[img_id]
    x = np.clip(np.asarray(hit.u), 0.0, 1.0) * dims[:, 1] - 0.5
    y = (1.0 - np.clip(np.asarray(hit.v), 0.0, 1.0)) * dims[:, 0] - 0.5
    ux, uy = (prng.uniform(SEED, sid, prng.tap_ctr(0, DEPTH, j)).numpy() for j in (0, 1))
    iu = np.clip(np.floor(x).astype(int) + (ux < x - np.floor(x)), 0, dims[:, 1] - 1)
    iv = np.clip(np.floor(y).astype(int) + (uy < y - np.floor(y)), 0, dims[:, 0] - 1)
    want = np.asarray(jsc.images)[img_id, iv, iu]
    np.testing.assert_allclose(fb, want, rtol=2e-5, atol=2e-5)
    four_tap = np.asarray(jtex.eval_texture(jsc, tex, hit.u, hit.v, hit.point, bilinear=True))
    assert np.abs(fb - four_tap).max() > 0.05


def lookup_inputs(n=4096, seed=5):
    """The earth texture's scene tables, and UVs over [-0.1, 1.1] with the
    corners and edges included."""
    jsc = jax_get_scene("earth", width=16, tex_height=16, tex_width=32)[0]
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    u[:8], v[:8] = [0, 1, 1, 0, 0.5, 0.5, 0, 1], [0, 0, 1, 1, 0, 1, 0.5, 0.5]
    return jsc, u, v


def test_image_lookup_bilinear_matches_jax():
    """image_lookup_bilinear against JAX _image_lookup_bilinear on random
    and edge UVs (the same float operations in the same order: 1e-6)."""
    jsc, u, v = lookup_inputs()
    zero = np.zeros(u.shape[0], np.int32)
    ref = jtex._image_lookup_bilinear(jsc, jnp.asarray(zero), jnp.asarray(u), jnp.asarray(v))
    got = ptex.image_lookup_bilinear(torch.tensor(np.asarray(jsc.images)),
                                     torch.tensor(np.asarray(jsc.image_dims)),
                                     torch.from_numpy(zero).long(), torch.from_numpy(u),
                                     torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_stochastic_tap_mean_is_the_four_tap_value():
    """At 64 fixed UVs, the mean of 4,096 stochastic taps (uniforms from
    tap_ctr over 4,096 sample ids) lies within 4 sigma of the 4-tap value
    in every channel, and the taps land on at least two texels somewhere."""
    jsc, u, v = lookup_inputs(64, seed=6)
    images = torch.tensor(np.asarray(jsc.images))
    dims = torch.tensor(np.asarray(jsc.image_dims))
    k = 4096
    sid = torch.arange(k)
    tap = torch.stack([prng.uniform(11, sid, prng.tap_ctr(2, 8, j)) for j in (0, 1)], dim=1)
    uu = torch.from_numpy(u).repeat_interleave(k)
    vv = torch.from_numpy(v).repeat_interleave(k)
    ids = torch.zeros(64 * k, dtype=torch.int64)
    taps = ptex.image_tap_stochastic(images, dims, ids, uu, vv, tap.repeat(64, 1)).reshape(64, k, 3)
    four = ptex.image_lookup_bilinear(images, dims, ids[:64], torch.from_numpy(u),
                                      torch.from_numpy(v))
    sigma = taps.std(dim=1) / np.sqrt(k)
    assert bool(((taps.mean(dim=1) - four).abs() <= 4 * sigma + 1e-6).all())
    assert float(taps.std(dim=1).max()) > 0.05


def tape_case(name):
    """(port scene, JAX scene, camera kw) of the tiny tape scenes; earth
    with a 16x32 texture keeps JAX's polynomial acos/atan2 (ops/invtrig.py,
    2e-6) well inside a texel."""
    kw = dict(width=16, spp=1, max_depth=6)
    if name == "perlin":
        return get_scene("perlin", **kw), jax_get_scene("perlin", **kw)
    bilinear = name == "earth_bilinear"
    kw.update(tex_height=16, tex_width=32, bilinear=bilinear)
    return get_scene("earth", **kw), jax_get_scene("earth", **kw)


def jax_xla_tape_radiance(jsc, jc, w, h, k, depth):
    """(3, k*w*h) radiance of JAX's XLA `trace` fed the tape kernel's
    counter-RNG camera rays and uniforms."""
    from raytracer_tpu.integrator import wavefront as jwf
    from raytracer_tpu.ops import ctr_rng as jrng

    sid = jnp.arange(k * w * h)
    pix = sid % (w * h)
    o, d = jcam.camera_rays(jcam.camera_frame(jc, w, h), pix % w, pix // w,
                            jrng.camera_uniforms(SEED, sid))
    rad = jwf.trace(jsc, o, d, jax.random.PRNGKey(0), jc.background, max_depth=depth,
                    uniform_seq=jrng.bounce_uniform_seq(SEED, sid, depth))
    return np.asarray(rad).T


@pytest.mark.parametrize("name", ["earth", "earth_bilinear", "perlin"])
def test_tape_twin_matches_jax_tape_kernel(name):
    """trace_tape_plain with the scene's texture tables against JAX's
    render_persistent_tape in interpret mode, 16x9, 2 samples a pixel,
    depth 6: tape equal on every entry. Earth's radiance within
    tests/test_torch_tape.py::test_trace_tape_matches_jax's rtol and atol
    1e-5 on every lane (JAX's kernel decodes 8-bit texels as k * (1/255),
    the port reads k/255 itself). perlin's 7-octave marble at scale 4
    turns the last bits of a hit point into ~1e-3 of radiance: JAX's own
    XLA `trace` on the same lanes and uniforms is 7.7e-4 from JAX's kernel
    and agrees with it at 1e-5 on 77% of the lanes only (the port's twin on
    68%, measured). So perlin's radiance is held no farther from JAX's
    kernel than twice the distance of JAX's XLA path from it."""
    (psc, pcam_, pst), (jsc, jcam_, _) = tape_case(name)
    w, h, depth, k = pst.width, pst.height, pst.max_depth, 2
    total = w * h * k
    rows = 8
    n_phys = -(-total // (rows * 128)) * rows * 128
    sid = np.arange(n_phys, dtype=np.int32)
    pix = sid % (w * h)
    has_image = bool(jsc.has_image)
    with pltpu.force_tpu_interpret_mode():
        rad_j, tape_j, _, _ = jpk.render_persistent_tape(
            *jpk.pack_persistent_tables(jsc, jint.quad_derived(jsc)),
            jpk.pack_camera_scalars_bg(jcam.camera_frame(jcam_, w, h), jcam_.background),
            SEED, jnp.asarray((sid < total).astype(np.int32)), jnp.asarray(pix % w),
            jnp.asarray(pix // w), jnp.asarray(sid),
            jpk.pack_image_table(jsc) if has_image else None,
            width=w, height=h, rows=rows, max_depth=depth, has_noise=bool(jsc.has_noise),
            has_image=has_image, img_h=int(jsc.images.shape[1]), img_w=int(jsc.images.shape[2]),
            bilinear=bool(jsc.bilinear_textures),
        )
    rad_j, tape_j = np.asarray(rad_j)[:, :total], np.asarray(tape_j)[:, :total]
    sph, quad, res = ppk.pack_persistent_tables(psc)
    cam_s = ppk.pack_camera_scalars_bg(pcam.camera_frame(pcam_, w, h), pcam_.background)
    textures = ppacked.texture_tables(psc, quad_derived(psc))
    assert textures.image_filter == (ppacked.FILTER_BILINEAR if name == "earth_bilinear"
                                     else ppacked.FILTER_NEAREST)
    rad_p, tape_p, _ = ppk.render_persistent_tape(sph, quad, res, cam_s, SEED, total, width=w,
                                                  height=h, max_depth=depth, textures=textures)
    np.testing.assert_array_equal(tape_p.numpy(), tape_j)
    if name == "perlin":
        spread = np.abs(jax_xla_tape_radiance(jsc, jcam_, w, h, k, depth) - rad_j).max()
        assert 0 < spread < 1e-2
        np.testing.assert_allclose(rad_p.numpy(), rad_j, rtol=0, atol=2 * spread)
    else:
        np.testing.assert_allclose(rad_p.numpy(), rad_j, rtol=1e-5, atol=1e-5)
    assert (tape_j[0] >= 0).mean() > 0.2 and float(rad_p.max()) > 0


def test_bucketed_step_on_bilinear_earth_matches_jax():
    """The tape-forward step on a tiny bilinear earth (16x9, 2 spp, depth
    4) against JAX make_bucketed_grad_fn(forward="kernel") in interpret
    mode with the same int seed: loss within rtol 1e-5; the sphere's
    center and radius gradients, which reach the loss through the hit
    point's bilinear UV weights and the scatter directions, within
    tests/test_torch_grad.py's geometry bound (rtol 6e-3, atol 1e-4 of
    their largest entry); every other leaf's gradient zero on both sides
    (earth has no metal and no solid texture)."""
    kw = dict(width=16, spp=2, max_depth=4, tex_height=16, tex_width=32, bilinear=True)
    jsc, jc, jst = jax_get_scene("earth", **kw)
    psc, pc, pst = get_scene("earth", **kw)
    w, h, k, depth = pst.width, pst.height, 2, pst.max_depth
    target = np.random.default_rng(0).uniform(0, 1, (h, w, 3)).astype(np.float32)
    params, rebuild = jax_split_scene(jsc)
    key = jax.random.PRNGKey(5)
    with pltpu.force_tpu_interpret_mode():
        step = jax_make_bucketed_grad_fn(rebuild, jc, jnp.asarray(target), width=w, height=h,
                                         samples_per_pass=k, max_depth=depth, quant=256,
                                         forward="kernel", scene_probe=jsc, tape_rows=8)
        loss_j, grads_j = step(params, key)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1, jnp.int32))
    _, prebuild = pgrad.split_scene(psc)
    pparams = pgrad.params_from_arrays({n: np.asarray(v) for n, v in params.items()})
    loss, grads = pbucketed.make_bucketed_grad_fn(prebuild, pc, torch.from_numpy(target),
                                                  width=w, height=h, samples_per_pass=k,
                                                  max_depth=depth)(pparams, seed)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for name, g in grads.items():
        gj = np.asarray(grads_j[name])
        if name in ("sph_center", "sph_radius"):
            top = np.abs(gj).max()
            assert top > 0, name
            np.testing.assert_allclose(g.numpy(), gj, rtol=6e-3, atol=1e-4 * top, err_msg=name)
        else:
            assert not gj.any() and not bool(g.any()), name


def test_textured_scene_support():
    """The persistent kernel's twin takes noise and image scenes; the
    kernel-side check refuses gathered (rng-filled) Perlin tables."""
    for name in ("perlin", "earth", "simple_light"):
        assert ppk.unsupported_reason(get_scene(name, width=8)[0]) is None
    b = pscene.SceneBuilder(0)
    b.add_sphere((0, 0, -1), 0.5, b.lambertian(b.noise(2.0)))
    sc = b.build(procedural_perlin=False)
    assert "rng-filled" in ppk.unsupported_reason(sc)
    assert ppacked.texture_tables(sc, quad_derived(sc)).perlin is not None


def brute_force_texture_work(steps, kinds, n):
    """Per-lane segment sequences from each regen_plain iteration's (lanes,
    t, prim), then the TextureWork counts straight from their definitions:
    per warp of 32 lanes, a (warp, iteration) pair evaluates a kind when
    any lane does; under one segment an iteration, iteration j is a lane's
    j-th segment; under retrace, its j-th hit, and its j-th iteration runs
    the segments from its (j-1)-th hit to its j-th (or to its end)."""
    seqs = [[] for _ in range(n)]
    for lanes, t, prim in steps:
        for lane, tl, pl in zip(lanes.tolist(), t.tolist(), prim.tolist()):
            seqs[lane].append(kinds[pl] if math.isfinite(tl) else "miss")
    per_lane = [[sum(k == kind for k in seq) for seq in seqs] for kind in ("marble", "image")]
    one_seg, retrace = [set(), set()], [set(), set()]
    trips_one = trips_retrace = 0
    for w in range(-(-n // 32)):
        warp_seqs = seqs[32 * w: 32 * w + 32]
        trips_one += max(len(seq) for seq in warp_seqs)
        runs = {}  # retrace iteration -> most segments a lane traced in it
        for seq in warp_seqs:
            hits = run = 0
            for j, kind in enumerate(seq):
                run += 1
                if kind == "miss":
                    continue
                for k, name in enumerate(("marble", "image")):
                    if kind == name:
                        one_seg[k].add((w, j))
                        retrace[k].add((w, hits))
                runs[hits] = max(runs.get(hits, 0), run)
                hits, run = hits + 1, 0
            if run:
                runs[hits] = max(runs.get(hits, 0), run)
        trips_retrace += sum(runs.values())
    return per_lane, [len(x) for x in one_seg], [len(x) for x in retrace], [trips_one,
                                                                             trips_retrace]


@pytest.mark.parametrize("name", ["perlin", "simple_light", "earth"])
def test_texture_work_counts_match_brute_force(name, monkeypatch):
    """regen_plain's TextureWork (the marbles and image lookups per lane,
    their warp unions under both loop schedules, the closest hits a warp
    runs) against a brute-force count over the same tiny render's per-lane
    segment sequences; counting changes neither the log nor the
    segments."""
    scene, cam, st = get_scene(name, width=24, spp=4, max_depth=10)
    w, h = st.width, st.height
    n, slots, jump = pwf.strided_schedule(w * h, 4, 256)
    args = (*ppk.pack_persistent_tables(scene),
            ppk.pack_camera_scalars_bg(pcam.camera_frame(cam, w, h), cam.background), 5,
            *pwf.schedule_arrays(n, w * h, 4, w))
    textures = ppacked.texture_tables(scene, quad_derived(scene))
    cfg = dict(width=w, height=h, jump_px=jump % w, jump_py=jump // w, num_slots=slots,
               max_depth=10, rr_start=5, rr_lo=0.05, rr_hi=0.75, sky_gradient=st.sky_gradient,
               max_iters=ppk.max_iters_for(slots, 10), textures=textures)
    steps, real = [], pwf._bounce_and_retire

    def recording(res, ns, tex, bg, a, sk_a, t, prim, *rest, **kw):
        steps.append((a.clone(), t.clone(), prim.clone()))
        return real(res, ns, tex, bg, a, sk_a, t, prim, *rest, **kw)

    monkeypatch.setattr(pwf, "_bounce_and_retire", recording)
    log, segs, work = pwf.regen_plain(*args, **cfg, return_texture_work=True)
    monkeypatch.setattr(pwf, "_bounce_and_retire", real)
    log0, segs0 = pwf.regen_plain(*args, **cfg)
    assert torch.equal(log, log0) and torch.equal(segs, segs0)

    ttype = textures.rows[:, ppacked.TCOL_TYPE].long().tolist()
    kinds = ["marble" if k == pscene.TEX_NOISE else "image" if k == pscene.TEX_IMAGE else "other"
             for k in ttype]
    per_lane, one_seg, retrace, trips = brute_force_texture_work(steps, kinds, n)
    assert work.per_lane.tolist() == per_lane
    assert work.one_segment.tolist() == one_seg
    assert work.retrace.tolist() == retrace
    assert work.warp_trips.tolist() == trips
    k = 1 if name == "earth" else 0
    assert sum(per_lane[k]) > 0 and retrace[k] < one_seg[k] and trips[1] >= trips[0]
    assert work.simt_efficiency("retrace")[k] == sum(per_lane[k]) / (32 * retrace[k])
