"""The port's estimator self-check (raytracer_tpu_torch/scripts/
check_persistent.py) on the CPU twins: exact sample accounting with fewer
wavefront lanes than pixels, in the port and in the JAX package; the
statistical rule against the JAX check's own expression; a scene check and
the clustered check at small sizes; and the JSON line and exit code."""

import json
import re
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.core.camera import make_camera as jax_make_camera
from raytracer_tpu.geometry.scene import SceneBuilder as JaxSceneBuilder
from raytracer_tpu.render.driver import render_regen
from raytracer_tpu_torch.scripts import check_persistent as cp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
COUNTER = dict(width=40, spp=16, wavefront=1024)  # 1024 lanes < 1600 pixels


def test_sample_counter_is_exact_in_both_packages():
    got = cp.check_sample_counter("cpu", **COUNTER)
    assert got["wavefront"] < got["pixels"] == 1600
    assert got == dict(got, ok=True, bad_pixels=0, minmax=[1.0, 1.0])
    # The JAX package's XLA path at the same shape (as its own tests run it
    # on the CPU: use_pallas=False), its check's settings otherwise.
    w = COUNTER["width"]
    cam, _ = jax_make_camera(1.0, w, samples_per_pixel=COUNTER["spp"], background=(1, 1, 1))
    img = render_regen(JaxSceneBuilder(0).build(), cam, jax.random.PRNGKey(0),
                       spp=COUNTER["spp"], height=w, width=w,
                       wavefront_size=COUNTER["wavefront"], max_depth=8, sky_gradient=False,
                       use_pallas=False, rr_max_q=0.75)
    assert (np.asarray(img)[..., 0] == 1.0).all()


def jax_verdict(a, b) -> bool:
    """The JAX check's rule, executed from scripts/check_persistent_tpu.py's
    own text (its scene loop's mean and std comparison)."""
    src = (REPO / "scripts" / "check_persistent_tpu.py").read_text()
    block = re.findall(r"\n( +mean_a, mean_b = a\.mean.*?\n +\)\n)", src, re.S)[-1]
    env = {"np": np, "a": a, "b": b}
    exec(textwrap.dedent(block), env)
    return env["ok"]


@pytest.mark.parametrize("case", ["agreeing", "biased_mean", "wider_spread", "dark_offset"])
def test_agree_gives_the_jax_verdict(case):
    rng = np.random.default_rng(7)
    b = rng.gamma(2.0, 0.2, size=(112, 200, 3)).astype(np.float32)
    a = rng.gamma(2.0, 0.2, size=(112, 200, 3)).astype(np.float32)  # an independent draw
    if case == "biased_mean":
        a = a * 1.05
    elif case == "wider_spread":
        a = (a - a.mean()) * 1.3 + a.mean()
    elif case == "dark_offset":  # under atol on a dark image
        a, b = a * 0.01 + 0.003, b * 0.01
    got = cp.agree(a, b)
    assert got["ok"] == jax_verdict(a, b)
    assert got["ok"] == (case in ("agreeing", "dark_offset"))


def test_cornell_check_passes_on_the_cpu_twins():
    # At 8 spp the two renders' cornell means lie 15% apart (its emitter
    # makes the image noisy), beyond the rule's 2%; at 1024 spp 0.9%. Both
    # paths are unbiased, so only the sample count matters.
    got = cp.check_scene("cornell", "cpu", spp=1024, width=32)
    assert got["ok"], got
    assert got["path"] == "persistent" and got["finite"]


def test_clustered_check_passes_on_the_cpu_twins():
    # 2,001 spheres: past CLUSTERED_SCENE_PRIMS, so the fast path clusters.
    got = cp.check_large_scene_clustered("cpu", spp=16, width=32, n_spheres=2000)
    assert got["ok"], got


def test_scene_list_is_the_jax_checks_but_its_tpu_fallback():
    src = (REPO / "scripts" / "check_persistent_tpu.py").read_text()
    jax_labels = set(re.findall(r'\(\s*"(\w+)",\s*"\w+",\s*dict\(', src))
    assert jax_labels - {label for label, *_ in cp.SCENES} == {"earth_megakernel"}
    assert len(cp.SCENES) == 8 and cp.FAST_SEED != cp.INDEPENDENT_SEED


@pytest.mark.parametrize("counter_ok", [True, False])
def test_main_prints_one_json_line_and_its_exit_code(monkeypatch, capsys, counter_ok):
    # The scene checks are held above; here they are stubs, the counter real.
    monkeypatch.setattr(cp, "SCENES", cp.SCENES[:2])
    monkeypatch.setattr(cp, "check_scene", lambda label, dev, spp: {"ok": True, "spp": spp})
    monkeypatch.setattr(cp, "check_large_scene_clustered", lambda dev: {"ok": True})
    counter = cp.check_sample_counter
    monkeypatch.setattr(cp, "check_sample_counter",
                        lambda dev: dict(counter(dev, **COUNTER), ok=counter_ok))
    rc = cp.main(["8", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"ok", "spp", "device", "scenes"}
    assert out["spp"] == 8 and out["device"] == {"name": "cpu", "power_limit_w": None}
    assert set(out["scenes"]) == {"sample_counter_small_wavefront",
                                  "large_10k_clustered_vs_dense", "rand_spheres", "perlin"}
    assert out["scenes"]["perlin"] == {"ok": True, "spp": 8}
    assert out["scenes"]["sample_counter_small_wavefront"]["bad_pixels"] == 0
    assert out["ok"] is counter_ok and rc == (0 if counter_ok else 1)
