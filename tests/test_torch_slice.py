"""The port's main path end to end on the CPU (plain twins of the kernels):
render_image against the JAX package's golden statistics and renders, the
CLI writing a P3 file, image output byte-identical to the JAX package's, and
the port importing no jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu.imgio import image as jimage
from raytracer_tpu.render.driver import render_image as jax_render_image
from raytracer_tpu.render.postprocess import to_u8 as jax_to_u8
from raytracer_tpu.scenes.registry import get_scene as jax_get_scene
from raytracer_tpu_torch.imgio import image as pimage
from raytracer_tpu_torch.render.driver import (
    chunk_bytes,
    render_image,
    render_scene,
    spp_chunk_for,
)
from raytracer_tpu_torch.render.postprocess import to_u8
from raytracer_tpu_torch.scenes.registry import get_scene
from raytracer_tpu_torch.utils.metrics import RenderMetrics, warp_slots

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((REPO / "tests" / "golden_stats.json").read_text())
CFG = dict(width=96, spp=24, max_depth=10)  # tests/test_golden.py
SEED = 12345


def stats(img):
    """tests/test_golden.py's statistics."""
    h, w, _ = img.shape
    probes = [(h // 4, w // 4), (h // 2, w // 2), (3 * h // 4, 3 * w // 4), (h // 2, w // 8)]
    return {
        "mean": [float(m) for m in img.mean((0, 1))],
        "std": float(img.std()),
        "probes": [[float(c) for c in img[y, x]] for y, x in probes],
    }


def assert_golden_tolerances(got, want):
    """tests/test_golden.py's tolerances."""
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0.02, atol=0.004)
    np.testing.assert_allclose(got["std"], want["std"], rtol=0.05, atol=0.01)
    np.testing.assert_allclose(got["probes"], want["probes"], rtol=0.5, atol=0.12)


@pytest.mark.parametrize("name", ["rand_spheres", "quads"])
def test_render_image_matches_golden(name):
    scene, cam, settings = get_scene(name, **CFG)
    metrics = RenderMetrics(total_spp=settings.samples_per_pixel,
                            pixels=settings.width * settings.height)
    img = render_image(scene, cam, settings, device="cpu", seed=SEED, metrics=metrics)
    assert img.shape == (settings.height, settings.width, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
    assert_golden_tolerances(stats(img.numpy()), GOLDEN[name])
    snap = metrics.snapshot()
    assert snap["spp"] == "24/24" and snap["traced_segments"] >= settings.width * settings.height * 24
    assert 0.0 < snap["warp_occupancy"] <= 1.0


def test_cornell_matches_jax_renders():
    """cornell's golden entry is one 24-spp draw ~3 sigma above its
    estimator's mean (the JAX package itself misses it at seeds 2 and 4:
    probe (72, 72) is a firefly pixel), so the port is held against the JAX
    package's own renders instead: the mean of four seeds of each, with
    test_golden.py's tolerances, each probe read as the mean of the 5x5
    pixels around it (a single pixel of this scene stays firefly noise
    at 96 spp)."""
    def mean_of(render, seeds):
        img = np.mean([render(s) for s in seeds], axis=0)
        pad = np.pad(img, ((2, 2), (2, 2), (0, 0)), mode="edge")
        box = sum(pad[dy : dy + img.shape[0], dx : dx + img.shape[1]]
                  for dy in range(5) for dx in range(5)) / 25.0
        return img, box

    jsc, jcam, jst = jax_get_scene("cornell", **CFG)
    psc, pcam, pst = get_scene("cornell", **CFG)
    want, want_box = mean_of(lambda s: np.asarray(jax_render_image(jsc, jcam, jst, seed=s)), range(4))
    got, got_box = mean_of(lambda s: render_image(psc, pcam, pst, device="cpu", seed=s).numpy(), range(4))
    g, w = stats(got), stats(want)
    g["probes"], w["probes"] = stats(got_box)["probes"], stats(want_box)["probes"]
    assert_golden_tolerances(g, w)
    # ... and its channel means sit within the golden tolerance of the pin.
    np.testing.assert_allclose(stats(got)["mean"], GOLDEN["cornell"]["mean"], rtol=0.02, atol=0.004)


def test_spp_chunking_covers_budget():
    """A budget below one chunk's device memory (log, framebuffer, fold
    scratch) splits the spp budget; every sample is still rendered exactly
    once (miss-only scene: each pixel's mean is the background)."""
    from raytracer_tpu_torch.core.camera import make_camera
    from raytracer_tpu_torch.geometry.scene import SceneBuilder

    b = SceneBuilder(0)
    b.lambertian((0.5, 0.5, 0.5))
    cam, st = make_camera(1.0, 12, samples_per_pixel=10, max_depth=4, background=(0.25, 0.5, 1.0))
    budget = chunk_bytes(144, 3, 400) - 1  # just below a 3-spp chunk with 400 lanes
    assert spp_chunk_for(144, 10, 400, budget) == 2
    metrics = RenderMetrics(total_spp=10, pixels=144)
    img = render_image(b.build(), cam, st, device="cpu", wavefront=400, log_budget_bytes=budget,
                       metrics=metrics)
    np.testing.assert_allclose(img.reshape(-1, 3).numpy(), np.tile([0.25, 0.5, 1.0], (144, 1)),
                               rtol=1e-6)
    assert metrics.traced_segments == 144 * 10


def test_to_u8_matches_jax():
    x = np.random.default_rng(0).uniform(-0.5, 2.0, (64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_u8(torch.from_numpy(x)).numpy(), np.asarray(jax_to_u8(x)))


def test_image_io_matches_jax(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (7, 11, 3)).astype(np.uint8)
    pimage.write_ppm(str(tmp_path / "p.ppm"), img)
    jimage.write_ppm(str(tmp_path / "j.ppm"), img)
    assert (tmp_path / "p.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    np.testing.assert_array_equal(pimage.read_ppm(str(tmp_path / "p.ppm")), img)
    pimage.write_png(str(tmp_path / "p.png"), img)
    jimage.write_png(str(tmp_path / "j.png"), img)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "j.png")), img)
    Image.fromarray(img).save(tmp_path / "t.jpg")
    np.testing.assert_array_equal(
        pimage.load_jpeg(str(tmp_path / "t.jpg")), jimage.load_jpeg(str(tmp_path / "t.jpg"))
    )
    np.testing.assert_array_equal(
        pimage.synthetic_earth_texture(32, 64), jimage.synthetic_earth_texture(32, 64)
    )


def test_cli_writes_p3(tmp_path):
    out = tmp_path / "x.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.cli", "--device", "cpu", "--scene", "cornell",
         "--width", "32", "--spp", "4", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["size"] == [32, 32] and report["spp"] == 4 and report["device"] == "cpu"
    text = out.read_text()
    assert text.startswith("P3\n32 32\n255\n")
    img = pimage.read_ppm(str(out))
    assert img.shape == (32, 32, 3) and img.max() > 0
    assert len(text.splitlines()) == 3 + 32 * 32


def test_cli_defaults_to_cuda():
    """No fallback hides the device: without a card the default --device
    cuda raises instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from raytracer_tpu_torch import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--scene", "cornell", "--width", "8", "--spp", "1"])


def test_render_scene_u8():
    scene, cam, settings = get_scene("quads", width=16, spp=2, max_depth=3)
    img = render_scene(scene, cam, settings, device="cpu")
    assert img.dtype == np.uint8 and img.shape == (settings.height, 16, 3)


def test_warp_slots():
    segs = torch.tensor([1, 2, 3] + [0] * 29 + [5])  # 33 lanes: two warps
    assert warp_slots(segs) == (3 + 5) * 32


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import raytracer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'raytracer_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) > 20, names\n"
        "assert {'raytracer_tpu_torch.diff.grad', 'raytracer_tpu_torch.diff.bucketed',\n"
        "        'raytracer_tpu_torch.diff.tape', 'raytracer_tpu_torch.diff.boundary',\n"
        "        'raytracer_tpu_torch.diff.opt_checkpoint', 'raytracer_tpu_torch.diff.shadow_edge',\n"
        "        'raytracer_tpu_torch.diff.mirror_edge', 'raytracer_tpu_torch.diff.refracted_edge',\n"
        "        'raytracer_tpu_torch.scripts.inverse_render_demo',\n"
        "        'raytracer_tpu_torch.render.checkpoint', 'raytracer_tpu_torch.parallel.mesh',\n"
        "        'raytracer_tpu_torch.parallel.shard', 'raytracer_tpu_torch.parallel.train',\n"
        "        'raytracer_tpu_torch.parallel.dryrun',\n"
        "        'raytracer_tpu_torch.scripts.run_multihost'} <= set(names), names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m.startswith('raytracer_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
