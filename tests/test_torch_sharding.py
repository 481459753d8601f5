"""The port's sharded rendering and training (parallel/) against
tests/test_sharding.py's cases and against the JAX package's sharded renders.

Groups of more than one rank run as gloo processes on the CPU (`run_ranks`:
each a subprocess, so no process group outlives a test); the JAX side runs
on the 8-virtual-device CPU mesh of tests/conftest.py. At one rank every
path is render_image's image bit for bit; at two ranks a render is the
in-process sum of its ranks' partials bit for bit; at four the sums are
held at rtol 1e-6 (the all-reduce's sum order is its own). Against JAX the
images agree statistically, within JAX's own test limits."""

import contextlib
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.core.camera import make_camera as jax_make_camera
from raytracer_tpu.geometry.scene import SceneBuilder as JaxSceneBuilder
from raytracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytracer_tpu.parallel.shard import render_image_sharded as jax_render_image_sharded
from raytracer_tpu.render.driver import render_image as jax_render_image
from raytracer_tpu_torch.core.camera import make_camera
from raytracer_tpu_torch.geometry.scene import SceneBuilder
from raytracer_tpu_torch.parallel import mesh as pmesh
from raytracer_tpu_torch.parallel import shard
from raytracer_tpu_torch.render import driver
from raytracer_tpu_torch.scenes.registry import get_scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240


def tiny(builder=SceneBuilder, camera=make_camera, spp=8):
    """tests/test_sharding.py:_tiny, in either package."""
    b = builder(0)
    b.add_sphere((0, 0, -3), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0, -101, -3), 100.0, b.metal((0.8, 0.8, 0.8), 0.1))
    b.add_quad((-0.5, 1.5, -3), (1, 0, 0), (0, 0, -1), b.diffuse_light((3, 3, 3)))
    cam, settings = camera(16 / 9, 40, samples_per_pixel=spp, max_depth=5,
                           background=(0.7, 0.8, 1.0))
    return b.build(), cam, settings


def miss_only():
    """tests/test_sharding.py's miss-only scene: nothing to hit, background
    (0.2, 0.4, 0.6), 16x16."""
    b = SceneBuilder(0)
    b.lambertian((0.5, 0.5, 0.5))
    cam, _ = make_camera(1.0, 16, samples_per_pixel=13, max_depth=6, background=(0.2, 0.4, 0.6),
                         look_from=(0, 0, 2), look_at=(0, 0, 0))
    return b.build(), cam


def step_scene():
    """A wavefront-step path scene (rng-filled Perlin tables)."""
    return get_scene("perlin", width=24, spp=4, max_depth=4, procedural_perlin=False)


# The code each rank runs: `python -c WORKER job rank world coordinator outdir`.
# It writes outdir/<job>_<rank>.json and, on rank 0, the images as .npy.
WORKER = r'''
import json, sys, numpy as np, torch
sys.path.insert(0, sys.argv[6])
torch.set_num_threads(1)
from test_torch_sharding import tiny, miss_only, step_scene
from raytracer_tpu_torch.parallel.mesh import close_group, init_group, make_mesh
from raytracer_tpu_torch.parallel import shard
from raytracer_tpu_torch.utils.metrics import RenderMetrics
job, rank, world, coord, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
init_group("cpu", coordinator=coord, process_id=rank, num_processes=world)
res, imgs = {}, {}
def image(name, t):
    imgs[name] = t.numpy()
try:
    if job == "four":
        mesh = make_mesh(4, sample_parallel=2)
        res["mesh"] = dict(shape=list(mesh.shape), position=mesh.position, ranks=list(mesh.ranks),
                           tile=mesh.tile_index, sample=mesh.sample_index)
        for args in ((4, 3), (8, 1), (2, 1)):
            try:
                make_mesh(*args)
                res[str(args)] = "no error"
            except ValueError as e:
                res[str(args)] = str(e)
        scene, cam = miss_only()
        fb, st = shard.render_regen_sharded(scene, cam, 0, mesh, width=16, height=16, spp=13,
                                            max_depth=6, wavefront=1024)
        image("miss_only", fb)
        res["miss_only"] = st._asdict()
        scene, cam, st = tiny(spp=32)
        image("regen", shard.render_image_sharded(scene, cam, st, mesh, seed=0))
        scene, cam, st = tiny()
        image("passes", shard.render_image_sharded(scene, cam, st, mesh, seed=0, regenerative=False))
        image("large", shard.render_large_scene_sharded(scene, cam, st, mesh, seed=0))
        _, stats = shard.render_regen_sharded(scene, cam, 3, mesh, width=st.width, height=st.height,
                                              spp=64, max_depth=st.max_depth, wavefront=1 << 12)
        res["balance"] = stats._asdict()
        m = RenderMetrics(total_spp=st.samples_per_pixel, pixels=st.width * st.height)
        shard.render_image_sharded(scene, cam, st, mesh, seed=0, progress=True, metrics=m)
        res["metrics"] = dict(m.snapshot(), done_spp=m.done_spp)
    elif job == "two":
        mesh = make_mesh(2)
        scene, cam, st = tiny()
        image("regen", shard.render_image_sharded(scene, cam, st, mesh, seed=0))
        image("regen_again", shard.render_image_sharded(scene, cam, st, mesh, seed=0))
        image("large", shard.render_large_scene_sharded(scene, cam, st, mesh, seed=0))
        s_scene, s_cam, s_st = step_scene()
        image("step", shard.render_image_sharded(s_scene, s_cam, s_st, mesh, seed=2))
        # Chunks of 2 spp (one a rank): the log budget of one sample a lane.
        kw = dict(seed=3, log_budget_bytes=3 * st.width * st.height * 4)
        image("full", shard.render_image_sharded(scene, cam, st, mesh, **kw))
        ck = out + "/shard.npz"
        image("stopped", shard.render_image_sharded(scene, cam, st, mesh, checkpoint_path=ck,
                                                    max_chunks=1, **kw))
        image("resumed", shard.render_image_sharded(scene, cam, st, mesh, checkpoint_path=ck, **kw))
        try:
            shard.render_image_sharded(scene, cam, st._replace(samples_per_pixel=16), mesh,
                                       checkpoint_path=ck, **kw)
            res["mismatch"] = "resumed"
        except ValueError as e:
            res["mismatch"] = str(e)
        from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
        res["dryrun"] = dryrun_multichip(2, "cpu")
finally:
    close_group()
json.dump(res, open(f"{out}/{job}_{rank}.json", "w"))
if rank == 0:
    np.savez(f"{out}/{job}.npz", **imgs)
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job: str, world: int, out) -> tuple[list, dict, list]:
    """Run WORKER's `job` as `world` gloo ranks; (each rank's json, rank 0's
    images, each rank's output)."""
    coord = f"localhost:{free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, job, str(r), str(world), coord, str(out),
         os.path.join(REPO, "tests")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    res = [json.load(open(out / f"{job}_{r}.json")) for r in range(world)]
    with np.load(out / f"{job}.npz") as z:
        imgs = {k: z[k] for k in z.files}
    return res, imgs, outs


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_ranks("four", 4, tmp_path_factory.mktemp("four"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_ranks("two", 2, tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def jax_images():
    """JAX's renders of _tiny on the 8-device CPU mesh: the sharded regen at
    32 spp (sample_parallel 4), the sharded pass loop at 8 spp (2) and the
    single-device pass loop at 8 spp."""
    assert len(jax.devices()) == 8
    scene, cam, st = tiny(JaxSceneBuilder, jax_make_camera)
    return dict(
        regen=np.asarray(jax_render_image_sharded(
            scene, cam, st._replace(samples_per_pixel=32), jax_make_mesh(8, sample_parallel=4),
            seed=0)),
        passes=np.asarray(jax_render_image_sharded(
            scene, cam, st, jax_make_mesh(8, sample_parallel=2), seed=0, regenerative=False)),
        single_passes=np.asarray(jax_render_image(scene, cam, st, seed=0, regenerative=False)),
    )


@contextlib.contextmanager
def world_of_one():
    pmesh.init_group("cpu")
    try:
        yield pmesh.make_mesh()
    finally:
        pmesh.close_group()


def in_process_regen(scene, cam, settings, size, seed, **kw):
    """render_image_sharded's regenerative loop with every position's
    partial computed here and summed in position order (at two ranks what
    gloo's all-reduce sums)."""
    renderer = driver.chunk_renderer(scene, cam, settings, torch.device("cpu"))
    chunk = driver.default_spp_chunk(scene, settings, ranks=size, **kw)
    spp, done, c = settings.samples_per_pixel, 0, 0
    acc = torch.zeros(settings.width * settings.height, 3)
    while done < spp:
        step = min(chunk, spp - done)
        parts = [driver.regen_partial(renderer, step, driver.chunk_seed(seed, c), p, size)[0]
                 for p in range(size)]
        fb = parts[0]
        for p in parts[1:]:
            fb = fb + p
        acc = acc + fb
        done, c = done + step, c + 1
    return (acc / float(spp)).reshape(settings.height, settings.width, 3).numpy()


def large_scene(scene, cam, settings, seed):
    """The large-scene path on one CPU device, on any scene."""
    return driver.render_loop(scene, cam, settings, path="large_scene", device="cpu", seed=seed)


def hold_statistically(img, ref, mean_abs=0.08, rtol=0.05):
    """JAX's limits for two renders of one estimator at 8-32 spp."""
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert np.abs(img - ref).mean() < mean_abs
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=rtol)


def test_make_mesh_shapes_order_and_errors(four):
    res, _, _ = four
    meshes = [r["mesh"] for r in res]
    assert all(m["shape"] == [2, 2] for m in meshes)
    assert sorted(m["position"] for m in meshes) == [0, 1, 2, 3]
    # One process a node, ranks in order: position = rank.
    assert all(m["ranks"] == [0, 1, 2, 3] and m["position"] == r for r, m in enumerate(meshes))
    assert [(m["tile"], m["sample"]) for m in meshes] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert "not divisible by sample_parallel=3" in res[0]["(4, 3)"]
    assert "only 4 available" in res[0]["(8, 1)"]
    assert "spans every rank" in res[0]["(2, 1)"]


def test_make_mesh_needs_a_group_and_world_of_one():
    with pytest.raises(RuntimeError, match="initialised process group"):
        pmesh.make_mesh()
    with world_of_one() as mesh:
        assert mesh.shape == (1, 1) and mesh.position == 0 and mesh.backend == "gloo"
        assert mesh.axis_names == (pmesh.TILE_AXIS, pmesh.SAMPLE_AXIS)
        with pytest.raises(ValueError, match="only 1 available"):
            pmesh.make_mesh(2)
        with pytest.raises(ValueError, match="not divisible"):
            pmesh.make_mesh(1, sample_parallel=2)
    assert not torch.distributed.is_initialized()


def test_lane_blocks_rank_shares_and_seeds():
    blocks = [driver.lane_block(10, p, 4) for p in range(4)]
    assert blocks == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert driver.lane_block(2, 3, 4) == (2, 2)
    shares = [shard.rank_share(13, p, 8) for p in range(8)]
    assert sum(shares) == 13 and shares == [2] * 5 + [1] * 3
    assert shard.rank_seed(77, 0) == 77
    seeds = {shard.rank_seed(77, p) for p in range(8)} | {driver.chunk_seed(77, c) for c in (1, 2)}
    assert len(seeds) == 10


def fake_mesh(shape):
    return pmesh.Mesh(shape=shape, position=0, ranks=tuple(range(shape[0] * shape[1])),
                      device=torch.device("cpu"), backend="gloo")


def test_sharded_samples_per_pass():
    k = driver.samples_per_pass_for(16, 1000, 1 << 20, fake_mesh((2, 4)).shape[1])
    assert k % 4 == 0 and 16 % k == 0
    assert driver.samples_per_pass_for(16, 1000, 1 << 20, fake_mesh((1, 1)).shape[1]) == \
        driver.samples_per_pass_for(16, 1000, 1 << 20)


def test_sharded_samples_per_pass_uneven_spp_raises():
    with pytest.raises(ValueError, match="multiple of the sample-axis"):
        driver.samples_per_pass_for(10, 1000, 1 << 20, fake_mesh((2, 4)).shape[1])


def test_miss_only_exact_accounting_uneven_spp(four):
    """13 spp over 4 ranks (shares 4, 3, 3, 3): every sample retires the
    background once, so the framebuffer is exactly 13 * background."""
    res, imgs, _ = four
    n_pix = 16 * 16
    assert res[0]["miss_only"]["segments"] == n_pix * 13
    expect = np.tile(np.array([0.2, 0.4, 0.6], np.float32) * 13, (n_pix, 1))
    np.testing.assert_allclose(imgs["miss_only"].reshape(n_pix, 3), expect, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("path", ["persistent", "wavefront_step", "large_scene", "passes"])
def test_world_of_one_is_render_image_bit_for_bit(path, monkeypatch):
    # Past LARGE_SCENE_PRIMS a scene kernel 2 does not serve takes the
    # large-scene path.
    scene, cam, st = step_scene() if path in ("wavefront_step", "large_scene") else tiny()
    if path == "large_scene":
        monkeypatch.setattr(driver, "LARGE_SCENE_PRIMS", 1)
    regenerative = path != "passes"
    assert path == "passes" or driver.render_path(scene) == path
    with world_of_one() as mesh:
        img = shard.render_image_sharded(scene, cam, st, mesh, seed=4, regenerative=regenerative)
    ref = driver.render_image(scene, cam, st, device="cpu", seed=4, regenerative=regenerative)
    assert img.shape == ref.shape and torch.equal(img, ref)


@pytest.mark.parametrize("path", ["persistent", "wavefront_step", "large_scene", "passes"])
def test_one_device_calls_no_collective(path, monkeypatch, tmp_path):
    """A render on one device, checkpointed or not, makes no
    torch.distributed call: with its collectives made to raise, every path
    renders the image it renders without them."""
    from raytracer_tpu_torch.render import checkpoint as pckpt

    scene, cam, st = step_scene() if path in ("wavefront_step", "large_scene") else tiny()
    if path == "large_scene":
        monkeypatch.setattr(driver, "LARGE_SCENE_PRIMS", 1)
    regenerative = path != "passes"
    ref = driver.render_image(scene, cam, st, device="cpu", seed=4, regenerative=regenerative)

    def refuse(*args, **kwargs):
        raise AssertionError("a one-device render called torch.distributed")

    for name in ("all_reduce", "all_gather", "broadcast", "barrier", "new_group",
                 "get_rank", "get_world_size", "init_process_group"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    img = driver.render_image(scene, cam, st, device="cpu", seed=4, regenerative=regenerative)
    assert torch.equal(img, ref)
    if regenerative:
        ckpt = str(tmp_path / "one.npz")
        kw = dict(device="cpu", seed=4, spp_per_chunk=1, checkpoint_path=ckpt)
        pckpt.render_with_checkpoints(scene, cam, st, max_chunks=1, **kw)
        resumed = pckpt.render_with_checkpoints(scene, cam, st, **kw)
        assert pckpt.load_checkpoint(ckpt).done_spp == st.samples_per_pixel
        assert torch.isfinite(resumed).all()


@pytest.mark.parametrize("name", ["regen", "step"])
def test_two_ranks_are_the_sum_of_their_partials(two, name):
    _, imgs, _ = two
    scene, cam, st = tiny() if name == "regen" else step_scene()
    want = in_process_regen(scene, cam, st, 2, 0 if name == "regen" else 2)
    np.testing.assert_array_equal(imgs[name], want)


def test_large_scene_passes_follow_the_ray_target(monkeypatch):
    """The sharded large-scene path takes one device's passes
    (samples_per_pass_for at TARGET_RAYS_PER_PASS rays a rank), whatever
    path the scene would take in render_image."""
    scene, cam, st = tiny(spp=6)
    monkeypatch.setattr(driver, "TARGET_RAYS_PER_PASS", 2 * st.width * st.height)
    with world_of_one() as mesh:
        img = shard.render_large_scene_sharded(scene, cam, st, mesh, seed=1)
    ref = large_scene(scene, cam, st, seed=1)
    assert torch.equal(img, ref)


def test_two_rank_large_scene_is_the_unsharded_render(two):
    """Lanes keyed by global sample id and the k layers summed in the
    unsharded order: the sharded large-scene path is one device's image
    bit for bit."""
    _, imgs, _ = two
    scene, cam, st = tiny()
    ref = large_scene(scene, cam, st, seed=0)
    np.testing.assert_array_equal(imgs["large"], ref.numpy())


def test_four_ranks_against_in_process_and_unsharded(four):
    _, imgs, _ = four
    scene, cam, st = tiny(spp=32)
    np.testing.assert_allclose(imgs["regen"], in_process_regen(scene, cam, st, 4, 0),
                               rtol=1e-6, atol=1e-7)
    scene, cam, st = tiny()
    ref = driver.render_image(scene, cam, st, device="cpu", seed=0, regenerative=False)
    np.testing.assert_allclose(imgs["passes"], ref.numpy(), rtol=1e-6, atol=1e-7)
    ref = large_scene(scene, cam, st, seed=0)
    np.testing.assert_array_equal(imgs["large"], ref.numpy())


@pytest.mark.parametrize("name", ["regen", "passes", "large"])
def test_sharded_statistically_matches_jax(four, jax_images, name):
    _, imgs, _ = four
    scene, cam, st = tiny(spp=32 if name == "regen" else 8)
    ours = driver.render_image(scene, cam, st, device="cpu", seed=0).numpy()
    if name == "large":
        # tests/test_sharding.py:test_sharded_large_scene_fallback's limits.
        np.testing.assert_allclose(imgs[name].mean((0, 1)),
                                   jax_images["single_passes"].mean((0, 1)), rtol=0.06, atol=0.02)
        hold_statistically(imgs[name], ours)
        return
    hold_statistically(imgs[name], jax_images[name])
    hold_statistically(imgs[name], ours)


def test_pass_loop_matches_jax_render_image(jax_images):
    scene, cam, st = tiny()
    img = driver.render_image(scene, cam, st, device="cpu", seed=0, regenerative=False).numpy()
    hold_statistically(img, jax_images["single_passes"])


def test_sharded_render_deterministic(two):
    _, imgs, _ = two
    np.testing.assert_array_equal(imgs["regen"], imgs["regen_again"])


def test_load_balance_proxy(four):
    """Per-rank segments are the scaling-efficiency proxy: with the spp
    budget split evenly the busiest rank traces under 2x the mean."""
    res, _, _ = four
    b = res[0]["balance"]
    assert all(r["balance"] == b for r in res)
    assert b["rank_segments_max"] < 2.0 * b["segments"] / 4


def test_sharded_metrics_and_progress(four):
    res, _, outs = four
    for r in res:
        m = r["metrics"]
        assert m["done_spp"] == 8 and m["traced_segments"] > 0 and m["warp_occupancy"] > 0
        assert "traced_mrays_per_s" in m
    # Every rank holds the totals over all ranks.
    assert len({r["metrics"]["traced_segments"] for r in res}) == 1
    assert "spp 8/8" in outs[0] and "spp 8/8" not in outs[1]


def test_sharded_checkpoint_resume_bit_identical_and_refused(two):
    res, imgs, _ = two
    np.testing.assert_array_equal(imgs["resumed"], imgs["full"])
    assert np.isfinite(imgs["stopped"]).all() and not np.array_equal(imgs["stopped"],
                                                                       imgs["full"])
    assert all("refusing to resume" in r["mismatch"] for r in res)


def test_checkpoint_refused_off_the_regenerative_loop(tmp_path, monkeypatch):
    scene, cam, st = tiny()
    with world_of_one() as mesh:
        with pytest.raises(ValueError, match="pass loop does not checkpoint"):
            shard.render_image_sharded(scene, cam, st, mesh, regenerative=False,
                                       checkpoint_path=str(tmp_path / "a.npz"))
        monkeypatch.setattr(driver, "LARGE_SCENE_PRIMS", 1)
        scene, cam, st = step_scene()
        with pytest.raises(ValueError, match="large-scene path does not checkpoint"):
            shard.render_image_sharded(scene, cam, st, mesh, checkpoint_path=str(tmp_path / "a.npz"))


def test_dryrun_multichip_two_ranks(two):
    """dryrun_multichip(2, "cpu") passed on both ranks (it raises on any
    failed check): gradients equal on both ranks and within rtol 1e-5 of
    the in-process sum of the two ranks' partial gradients."""
    res, _, _ = two
    for r in res:
        d = r["dryrun"]
        assert d["mesh"] == [1, 2] and d["backend"] == "gloo"
        assert d["scan_grad_rel"] <= 1e-5 and d["bucketed_grad_rel"] <= 1e-5
        assert d["regen_segments"] >= 16 * 9 * 5
        assert d["cluster_rows"][0] > 1 and d["cluster_rows"][3] >= 1
    assert res[0]["dryrun"]["loss"] == res[1]["dryrun"]["loss"]


def test_dryrun_multichip_world_of_one():
    from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip

    with world_of_one():
        out = dryrun_multichip(1, "cpu")
        with pytest.raises(RuntimeError, match="group of 2 ranks"):
            dryrun_multichip(2, "cpu")
    assert out["scan_grad_rel"] == 0.0 and out["bucketed_grad_rel"] == 0.0
