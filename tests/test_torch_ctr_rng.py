"""The port's counter RNG: bit-equal to the JAX package's ops/ctr_rng.py over
random int32 seeds, lanes and counters (negative ones included), consistent
with the CUDA header's constants, and Monte-Carlo grade (moments,
decorrelation, 1D and 2D stratification)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import ctr_rng as jrng
from raytracer_tpu_torch.materials.materials import UNIFORMS_PER_BOUNCE
from raytracer_tpu_torch.ops import ctr_rng as prng

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)


def _random_i32(rng, n):
    return rng.integers(I32.min, I32.max, n, dtype=np.int64, endpoint=True).astype(np.int32)


@pytest.mark.parametrize("seed_kind", ["random", "edge"])
def test_hash_and_uniform_bit_equal_to_jax(seed_kind):
    rng = np.random.default_rng(17)
    n = 20000
    if seed_kind == "random":
        seed, lane, ctr = (_random_i32(rng, n) for _ in range(3))
    else:  # extremes and small values, all combinations
        vals = np.array([0, 1, -1, 2, I32.max, I32.min, I32.min + 1, 4, 7, 153], np.int32)
        seed, lane, ctr = (g.ravel() for g in np.meshgrid(vals, vals, vals))
    jh = np.asarray(jrng.hash_i32(jnp.asarray(seed), jnp.asarray(lane), jnp.asarray(ctr)))
    ph = prng.hash_i32(torch.from_numpy(seed), torch.from_numpy(lane), torch.from_numpy(ctr))
    assert ph.dtype == torch.int32
    np.testing.assert_array_equal(ph.numpy(), jh)
    ju = np.asarray(jrng.uniform(jnp.asarray(seed), jnp.asarray(lane), jnp.asarray(ctr)))
    pu = prng.uniform(torch.from_numpy(seed), torch.from_numpy(lane), torch.from_numpy(ctr))
    assert pu.dtype == torch.float32
    np.testing.assert_array_equal(pu.numpy(), ju)


@pytest.mark.parametrize("seed", [0, 12345, -7, I32.max])
def test_camera_and_bounce_streams_bit_equal_to_jax(seed):
    lanes = np.arange(0, 3000, 3, dtype=np.int32)
    np.testing.assert_array_equal(
        prng.camera_uniforms(seed, torch.from_numpy(lanes)).numpy(),
        np.asarray(jrng.camera_uniforms(jnp.int32(seed), jnp.asarray(lanes))),
    )
    np.testing.assert_array_equal(
        prng.bounce_uniform_seq(seed, torch.from_numpy(lanes), 9).numpy(),
        np.asarray(jrng.bounce_uniform_seq(jnp.int32(seed), jnp.asarray(lanes), 9)),
    )


def test_draw_layout_is_derived_and_disjoint():
    assert prng.CAM_DRAWS == jrng.CAM_DRAWS
    assert UNIFORMS_PER_BOUNCE == 3
    max_depth = 50
    cam = set(range(prng.CAM_DRAWS))
    shade = {prng.shading_ctr(b, j) for b in range(max_depth) for j in range(UNIFORMS_PER_BOUNCE)}
    rr = {prng.rr_ctr(b, max_depth) for b in range(max_depth)}
    tap = {prng.tap_ctr(b, max_depth, j) for b in range(max_depth) for j in range(2)}
    assert len(shade) == max_depth * UNIFORMS_PER_BOUNCE and len(rr) == max_depth
    assert len(tap) == 2 * max_depth
    assert not (cam & shade) and not (cam & rr) and not (shade & rr)
    assert not (tap & (cam | shade | rr))
    assert min(shade) == prng.CAM_DRAWS  # the tape layout test_ktape pins
    # The tap draws follow the coins, so every earlier counter keeps its place.
    assert min(tap) == max(rr) + 1 == prng.CAM_DRAWS + (UNIFORMS_PER_BOUNCE + 1) * max_depth


def test_cuda_header_constants_match_python():
    src = (Path(prng.__file__).parent.parent / "csrc" / "ctr_rng.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["CAM_DRAWS"]) == prng.CAM_DRAWS
    assert int(consts["UNIFORMS_PER_BOUNCE"]) == UNIFORMS_PER_BOUNCE
    for c in (prng._M1, prng._M2, prng._PHI, prng._SEED_XOR):
        assert f"0x{c:08X}u" in src
    # Each counter function's body derives from the two constants as the
    # Python functions do.
    assert "CAM_DRAWS + UNIFORMS_PER_BOUNCE * bounce + j" in src
    assert "CAM_DRAWS + UNIFORMS_PER_BOUNCE * max_depth + bounce" in src
    assert "CAM_DRAWS + (UNIFORMS_PER_BOUNCE + 1) * max_depth + 2 * bounce + j" in src


def test_moments_and_decorrelation():
    lanes = torch.arange(8192)
    u = prng.bounce_uniform_seq(7, lanes, 16).numpy()  # (16, 8192, 3)
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(), 0.5, atol=3e-3)
    np.testing.assert_allclose(u.var(), 1.0 / 12.0, rtol=1e-2)
    # Third and fourth central moments of U[0,1): 0 and 1/80.
    c = u - 0.5
    np.testing.assert_allclose((c**3).mean(), 0.0, atol=1e-3)
    np.testing.assert_allclose((c**4).mean(), 1.0 / 80.0, rtol=2e-2)
    flat = u.reshape(16, -1)
    c_lane = np.corrcoef(u[:, :-1, :].ravel(), u[:, 1:, :].ravel())[0, 1]
    c_ctr = np.corrcoef(flat[:-1].ravel(), flat[1:].ravel())[0, 1]
    c_seed = np.corrcoef(u.ravel(), prng.bounce_uniform_seq(8, lanes, 16).numpy().ravel())[0, 1]
    assert max(abs(c_lane), abs(c_ctr), abs(c_seed)) < 0.01


def test_stratification():
    """Chi-square over 64 equal bins of one stream, and over an 8x8 grid of
    consecutive-counter pairs (the 2D samples a bounce consumes), against
    the 0.1% critical value for 63 degrees of freedom (103.4)."""
    lanes = torch.arange(1 << 16)
    u = prng.uniform(3, lanes[:, None], torch.arange(2)[None, :]).numpy()  # (L, 2)
    expected = u.shape[0] / 64
    h1, _ = np.histogram(u[:, 0], bins=64, range=(0.0, 1.0))
    h2, _, _ = np.histogram2d(u[:, 0], u[:, 1], bins=8, range=((0, 1), (0, 1)))
    for h in (h1, h2.ravel()):
        chi2 = float(((h - expected) ** 2 / expected).sum())
        assert chi2 < 103.4, chi2
