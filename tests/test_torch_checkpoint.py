"""The port's checkpoint and resume (render/checkpoint.py, diff/opt_checkpoint.py)
against tests/test_checkpoint.py's cases and against the JAX package's file
layout: a resumed render is bit-identical to an uninterrupted one on the
persistent and wavefront-step paths, an uninterrupted checkpointed render is
render_image's bit for bit, a changed configuration, static flag or version
refuses, an optimizer run resumes bit for bit on the CPU, and a checkpoint
file crosses between the packages both ways."""

import numpy as np
import pytest
import torch

from raytracer_tpu.render import checkpoint as jckpt
from raytracer_tpu_torch.core.camera import make_camera
from raytracer_tpu_torch.diff.grad import make_inverse_renderer, render_linear_diff
from raytracer_tpu_torch.diff.opt_checkpoint import (
    OptCheckpoint,
    load_opt_checkpoint,
    opt_fingerprint,
    optimizer_state_like,
    run_optimization,
    save_opt_checkpoint,
)
from raytracer_tpu_torch.geometry.scene import SceneBuilder
from raytracer_tpu_torch.parallel import mesh as pmesh
from raytracer_tpu_torch.parallel import shard
from raytracer_tpu_torch.render import checkpoint as pckpt
from raytracer_tpu_torch.render.driver import (
    chunk_bytes,
    path_wavefront,
    render_image,
    render_path,
)
from raytracer_tpu_torch.scenes.registry import get_scene

torch.set_num_threads(1)


def _setup():
    """tests/test_checkpoint.py's scene: a lambertian sphere on a fuzzy metal
    ground, 40x22, 8 spp, depth 5."""
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -3), 1.0, b.lambertian((0.6, 0.3, 0.2)))
    b.add_sphere((0, -101, -3), 100.0, b.metal((0.8, 0.8, 0.8), 0.2))
    cam, settings = make_camera(16 / 9, 40, samples_per_pixel=8, max_depth=5,
                                background=(0.7, 0.8, 1.0))
    return b.build(), cam, settings


def _path_scene(path):
    if path == "persistent":
        return _setup()
    scene, cam, st = get_scene("perlin", width=24, spp=8, max_depth=4, procedural_perlin=False)
    assert render_path(scene) == "wavefront_step"
    return scene, cam, st


@pytest.mark.parametrize("path", ["persistent", "wavefront_step"])
def test_resume_is_bit_identical(tmp_path, path):
    scene, cam, settings = _path_scene(path)
    assert render_path(scene) == path
    ckpt = str(tmp_path / "render.ckpt.npz")
    kw = dict(seed=3, spp_per_chunk=2, device="cpu")
    full = pckpt.render_with_checkpoints(scene, cam, settings, **kw)
    # Interrupted after 2 chunks (4 of 8 spp), then resumed.
    partial = pckpt.render_with_checkpoints(scene, cam, settings, checkpoint_path=ckpt,
                                            max_chunks=2, **kw)
    ck = pckpt.load_checkpoint(ckpt)
    assert ck is not None and (ck.done_spp, ck.chunk_idx) == (4, 2)
    assert ck.acc.shape == (settings.height, settings.width, 3) and ck.acc.dtype == np.float32
    assert torch.isfinite(partial).all()
    resumed = pckpt.render_with_checkpoints(scene, cam, settings, checkpoint_path=ckpt, **kw)
    assert torch.equal(resumed, full)
    assert pckpt.load_checkpoint(ckpt).done_spp == 8


@pytest.mark.parametrize("path", ["persistent", "wavefront_step"])
def test_uninterrupted_equals_render_image(path):
    """At the default chunk (render_image's), and at a chunking render_image
    takes under a small log budget, the checkpointed render is
    render_image's bit for bit."""
    scene, cam, settings = _path_scene(path)
    kw = dict(seed=5, device="cpu")
    assert torch.equal(pckpt.render_with_checkpoints(scene, cam, settings, **kw),
                       render_image(scene, cam, settings, **kw))
    n_pix = settings.width * settings.height
    budget = chunk_bytes(n_pix, 3, path_wavefront(path, n_pix))  # 3 spp a chunk
    assert torch.equal(
        pckpt.render_with_checkpoints(scene, cam, settings, log_budget_bytes=budget, **kw),
        render_image(scene, cam, settings, log_budget_bytes=budget, **kw))


def test_mismatched_config_refuses(tmp_path):
    scene, cam, settings = _setup()
    ckpt = str(tmp_path / "render.ckpt.npz")
    kw = dict(spp_per_chunk=2, checkpoint_path=ckpt, device="cpu")
    pckpt.render_with_checkpoints(scene, cam, settings, seed=1, max_chunks=1, **kw)
    with pytest.raises(ValueError, match="different scene/camera"):
        pckpt.render_with_checkpoints(scene, cam, settings, seed=2, **kw)
    # Another chunk size changes the chunks' seeds and samples: refused too.
    with pytest.raises(ValueError, match="different scene/camera"):
        pckpt.render_with_checkpoints(scene, cam, settings, seed=1, checkpoint_path=ckpt,
                                      spp_per_chunk=4, device="cpu")
    moved = SceneBuilder(0)
    moved.add_sphere((0, 0.01, -3), 1.0, moved.lambertian((0.6, 0.3, 0.2)))
    moved.add_sphere((0, -101, -3), 100.0, moved.metal((0.8, 0.8, 0.8), 0.2))
    with pytest.raises(ValueError, match="different scene/camera"):
        pckpt.render_with_checkpoints(moved.build(), cam, settings, seed=1, **kw)


def test_static_scene_flag_change_refuses(tmp_path):
    b = SceneBuilder(0)
    img = (np.arange(12, dtype=np.float32).reshape(2, 2, 3) % 3) / 3.0
    b.add_sphere((0, 0, -3), 1.0, b.lambertian(b.image(img)))
    cam, settings = make_camera(16 / 9, 40, samples_per_pixel=4, max_depth=3,
                                background=(0.7, 0.8, 1.0))
    ckpt = str(tmp_path / "r.npz")
    kw = dict(seed=0, spp_per_chunk=2, checkpoint_path=ckpt, device="cpu")
    pckpt.render_with_checkpoints(b.build(bilinear_textures=False), cam, settings,
                                  max_chunks=1, **kw)
    with pytest.raises(ValueError, match="refusing to resume"):
        pckpt.render_with_checkpoints(b.build(bilinear_textures=True), cam, settings, **kw)


# The config_hash that checkpoints of `_setup()` at seed 3 on the CPU carry:
# one device at 2 spp a chunk (render_with_checkpoints) and a mesh of one
# rank at its default chunk (render_image_sharded). A change to either
# fingerprint leaves every checkpoint on disk unable to resume.
PINNED_FINGERPRINTS = {
    "single": "1e4a413ee26cbc9bbfa7c55979f6c92120d7879727b35932434a3b76d595a4ad",
    "sharded": "cdaf923e957a29e80550c36638e3c0c5ac602edccaf6b639ed94ad5cabb6dc3c",
}


@pytest.mark.parametrize("entry", sorted(PINNED_FINGERPRINTS))
def test_fingerprints_are_pinned(tmp_path, entry):
    scene, cam, settings = _setup()
    ckpt = str(tmp_path / "r.npz")
    if entry == "single":
        pckpt.render_with_checkpoints(scene, cam, settings, seed=3, spp_per_chunk=2,
                                      device="cpu", checkpoint_path=ckpt, max_chunks=1)
    else:
        pmesh.init_group("cpu")
        try:
            shard.render_image_sharded(scene, cam, settings, pmesh.make_mesh(), seed=3,
                                       checkpoint_path=ckpt, max_chunks=1)
        finally:
            pmesh.close_group()
    assert pckpt.load_checkpoint(ckpt).config_hash == PINNED_FINGERPRINTS[entry]


def test_version_mismatch_raises(tmp_path):
    scene, cam, settings = _setup()
    ckpt = str(tmp_path / "r.npz")
    pckpt.render_with_checkpoints(scene, cam, settings, seed=0, spp_per_chunk=2,
                                  checkpoint_path=ckpt, max_chunks=1, device="cpu")
    with np.load(ckpt) as z:
        data = dict(z)
    data["version"] = np.array(data["version"]) + 1
    np.savez(ckpt, **data)
    with pytest.raises(ValueError, match="version"):
        pckpt.load_checkpoint(ckpt)


def test_checkpoint_file_crosses_packages(tmp_path):
    """A file the JAX package's save_checkpoint writes loads in the port's
    load_checkpoint with every field equal, and the other way round."""
    rng = np.random.default_rng(11)
    fields = dict(acc=rng.uniform(0, 5, (6, 9, 3)).astype(np.float32), done_spp=12, seed=7,
                  chunk_idx=3, config_hash="abc123")
    for save, load, name in ((jckpt.save_checkpoint, pckpt.load_checkpoint, "j2p"),
                             (pckpt.save_checkpoint, jckpt.load_checkpoint, "p2j")):
        path = str(tmp_path / f"{name}.npz")
        cls = jckpt.RenderCheckpoint if save is jckpt.save_checkpoint else pckpt.RenderCheckpoint
        save(path, cls(**fields))
        got = load(path)
        assert got is not None, name
        np.testing.assert_array_equal(np.asarray(got.acc), fields["acc"])
        assert np.asarray(got.acc).dtype == np.float32
        for k in ("done_spp", "seed", "chunk_idx", "config_hash"):
            assert getattr(got, k) == fields[k], (name, k)
    assert pckpt.CHECKPOINT_VERSION == jckpt.CHECKPOINT_VERSION


def _opt_setup():
    b = SceneBuilder(0)
    b.add_sphere((0, 0, -3), 1.0, b.lambertian((0.6, 0.3, 0.2)))
    b.add_sphere((0, -101, -3), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.build()
    cam, _ = make_camera(1.0, 12, look_from=(0, 0, 1), look_at=(0, 0, -3))
    kw = dict(width=12, height=12, samples_per_pass=2, max_depth=3, sky_gradient=True)
    target = render_linear_diff(scene, cam, 42, **kw).detach()
    return scene, cam, kw, target


def test_optimizer_checkpoint_resume_bit_identical(tmp_path):
    """An optimization stopped after 5 of 12 steps and resumed: params,
    optimizer state and the overlapping losses equal the uninterrupted
    run's bit for bit (CPU)."""
    scene, cam, kw, target = _opt_setup()

    def fresh():
        return make_inverse_renderer(scene, cam, target, trainable=("tex_c0",),
                                     learning_rate=5e-2, device="cpu", **kw)

    fp = opt_fingerprint(scene, cam, target, ("tex_c0", 5e-2, kw), 7)
    n_steps = 12
    p0, opt, step = fresh()
    p_full, opt_full, step_full, losses_full = run_optimization(
        step, p0, opt, n_steps=n_steps, seed=7, fingerprint=fp)
    assert step_full == n_steps and len(losses_full) == n_steps

    ckpt = str(tmp_path / "opt.ckpt.npz")
    p0, opt, step = fresh()
    _, _, stopped, _ = run_optimization(step, p0, opt, n_steps=n_steps, seed=7, fingerprint=fp,
                                        checkpoint_path=ckpt, save_every=2,
                                        max_steps_this_run=5)
    assert stopped == 5
    p1, opt1, _ = fresh()
    ck = load_opt_checkpoint(ckpt, params_like=p1, opt_state_like=optimizer_state_like(opt1),
                             config_hash=fp)
    assert ck is not None and ck.step == 5

    p1, opt1, step1 = fresh()
    p_res, opt_res, step_res, losses_res = run_optimization(
        step1, p1, opt1, n_steps=n_steps, seed=7, fingerprint=fp, checkpoint_path=ckpt,
        save_every=2)
    assert step_res == n_steps and len(losses_res) == n_steps - 5
    for name in p_full:
        assert torch.equal(p_full[name].detach(), p_res[name].detach()), name
    s_full, s_res = opt_full.state_dict()["state"], opt_res.state_dict()["state"]
    assert s_full.keys() == s_res.keys()
    for pid in s_full:
        for key in s_full[pid]:
            assert torch.equal(s_full[pid][key], s_res[pid][key]), (pid, key)
    assert losses_full[5:] == losses_res


def test_optimizer_checkpoint_refusals(tmp_path):
    """Version, fingerprint, leaf-count and shape mismatches refuse; the
    happy path round-trips bit for bit."""
    params = {"x": torch.ones(3, requires_grad=True)}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    params["x"].grad = torch.full((3,), 0.5)
    opt.step()
    path = str(tmp_path / "o.npz")
    save_opt_checkpoint(path, OptCheckpoint(params, opt.state_dict(), 4, 1, "fp-a"))
    like = optimizer_state_like(opt)
    with pytest.raises(ValueError, match="different"):
        load_opt_checkpoint(path, params_like=params, opt_state_like=like, config_hash="fp-b")
    wide = {"x": torch.ones(4, requires_grad=True)}
    with pytest.raises(ValueError, match="refusing"):
        load_opt_checkpoint(path, params_like=wide,
                            opt_state_like=optimizer_state_like(torch.optim.Adam(
                                list(wide.values()), lr=1e-2)),
                            config_hash="fp-a")
    two = {"x": torch.ones(3, requires_grad=True), "y": torch.ones(2, requires_grad=True)}
    with pytest.raises(ValueError, match="leaf counts"):
        load_opt_checkpoint(path, params_like=two,
                            opt_state_like=optimizer_state_like(torch.optim.Adam(
                                list(two.values()), lr=1e-2)),
                            config_hash="fp-a")
    ck = load_opt_checkpoint(path, params_like=params, opt_state_like=like, config_hash="fp-a")
    assert ck.step == 4 and ck.seed == 1
    assert torch.equal(ck.params["x"], params["x"].detach())
    for key, value in opt.state_dict()["state"][0].items():
        assert torch.equal(ck.opt_state["state"][0][key], value), key
    with np.load(path) as z:
        data = dict(z)
    data["version"] = np.int64(99)
    np.savez(path[:-4], **data)
    with pytest.raises(ValueError, match="version"):
        load_opt_checkpoint(path, params_like=params, opt_state_like=like, config_hash="fp-a")
