"""Counter-based RNG, bit-identical to raytracer_tpu/ops/ctr_rng.py and to
`csrc/ctr_rng.cuh`.

Every uniform is a pure function u = uniform(seed, lane, ctr): two rounds of
the murmur3 finalizer over (seed ^ c) + lane*phi, then state ^ ctr*m1, and
the low 23 bits scaled by 2^-23. JAX computes it in wrapping int32; here the
words live in int64 tensors masked to 32 bits (`& 0xFFFFFFFF`), every right
shift is therefore logical, and each 32x32-bit multiply is split into 16-bit
halves so no intermediate leaves the exact int64 range. The CUDA kernels use
uint32_t. `hash_i32` returns the word as the signed int32 JAX returns.

Draw-index layout (the contract between kernels and their plain twins):

    ctr 0..CAM_DRAWS-1            camera uniforms (jitter x, jitter y,
                                  disk radius-u, disk phi-u)
    CAM_DRAWS + UPB*bounce + j    shading uniform j of bounce `bounce`
                                  (UPB = UNIFORMS_PER_BOUNCE)
    CAM_DRAWS + UPB*max_depth + bounce
                                  russian-roulette coin of bounce `bounce`
                                  (outside the shading range)
    CAM_DRAWS + (UPB+1)*max_depth + 2*bounce + j
                                  stochastic bilinear tap uniform j (0: x,
                                  1: y) of bounce `bounce` (after the coins)

`lane` is the global sample id, not the physical lane, so any subset of
samples can regenerate its own stream.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.materials.materials import UNIFORMS_PER_BOUNCE

CAM_DRAWS = 4  # camera_rays consumes (N, 4) uniforms

MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_PHI = 0x9E3779B9
_SEED_XOR = 0x3C6EF372


def shading_ctr(bounce, j):
    """Counter of shading uniform j at bounce `bounce`."""
    return CAM_DRAWS + UNIFORMS_PER_BOUNCE * bounce + j


def rr_ctr(bounce, max_depth: int):
    """Counter of the russian-roulette coin at bounce `bounce`."""
    return CAM_DRAWS + UNIFORMS_PER_BOUNCE * max_depth + bounce


def tap_ctr(bounce, max_depth: int, j):
    """Counter of the stochastic bilinear tap's uniform j (0 picks the
    column, 1 the row) at bounce `bounce`."""
    return CAM_DRAWS + (UNIFORMS_PER_BOUNCE + 1) * max_depth + 2 * bounce + j


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK32


def _mul32(x, m: int):
    """(x * m) mod 2^32 for x in [0, 2^32) and a constant m, exact in int64."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x):
    """murmur3 finalizer on uint32 words held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def hash_u32(seed, lane, ctr):
    """Mixed 32-bit word (int64 tensor in [0, 2^32)) for draw `ctr` of
    stream (seed, lane). Arguments broadcast; negative ints wrap."""
    seed, lane, ctr = _u32(seed), _u32(lane), _u32(ctr)
    x = fmix32(((seed ^ _SEED_XOR) + _mul32(lane, _PHI)) & MASK32)
    return fmix32(x ^ _mul32(ctr, _M1))


def hash_i32(seed, lane, ctr):
    """The hash as signed int32, bit-equal to the JAX package's."""
    x = hash_u32(seed, lane, ctr)
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def uniform(seed, lane, ctr):
    """U[0,1) float32 with a 23-bit mantissa."""
    bits = hash_u32(seed, lane, ctr)
    return (bits & 0x7FFFFF).to(torch.float32) * (1.0 / 8388608.0)


def camera_uniforms(seed, lane_ids):
    """(L, CAM_DRAWS) camera-ray uniforms for the given sample ids."""
    j = torch.arange(CAM_DRAWS, dtype=torch.int64, device=lane_ids.device)[None, :]
    return uniform(seed, lane_ids.to(torch.int64)[:, None], j)


def bounce_uniforms(seed, lane_ids, bounce: int):
    """(L, UNIFORMS_PER_BOUNCE) shading uniforms of one bounce: row `bounce`
    of bounce_uniform_seq, drawn for the given sample ids only."""
    j = torch.arange(UNIFORMS_PER_BOUNCE, dtype=torch.int64, device=lane_ids.device)[None, :]
    return uniform(seed, lane_ids.to(torch.int64)[:, None], shading_ctr(bounce, j))


def rr_uniforms(seed, lane_ids, bounce: int, max_depth: int):
    """(L,) russian-roulette coins of one bounce for the given sample ids,
    at the counter the persistent kernel draws them at (rr_ctr)."""
    return uniform(seed, lane_ids.to(torch.int64), rr_ctr(bounce, max_depth))


def bounce_uniform_seq(seed, lane_ids, max_depth: int):
    """(max_depth, L, UNIFORMS_PER_BOUNCE) shading uniforms, the
    `uniform_seq` layout of integrator.wavefront.trace."""
    return torch.stack([bounce_uniforms(seed, lane_ids, b) for b in range(max_depth)])
