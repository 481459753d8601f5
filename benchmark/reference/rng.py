"""Counter-hash uniforms keyed by sample id: the estimator's stream of
random numbers, frozen here as the renderer defines it.

u = uniform(seed, sample, ctr): two rounds of the murmur3 finalizer over
(seed ^ 0x3C6EF372) + sample * 0x9E3779B9, then state ^ ctr * 0x85EBCA6B,
and the low 23 bits scaled by 2^-23. Words are uint32 held in int64
tensors; each 32-bit product is split into 16-bit halves so nothing leaves
int64's exact range.

Counters of one sample: 0-3 the camera (pixel jitter x, y; lens radius,
angle), 4 + 3 * bounce + j the shading uniforms j = 0, 1, 2 of a bounce,
4 + 3 * max_depth + bounce its russian-roulette coin.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
M1, M2, PHI, SEED_XOR = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0x3C6EF372
CAMERA_DRAWS = 4
SHADING_DRAWS = 3


def _mul(x, m: int):
    """(x * m) mod 2^32 for uint32 words x and a constant m."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & MASK


def _fmix(x):
    x = x ^ (x >> 16)
    x = _mul(x, M1)
    x = x ^ (x >> 13)
    x = _mul(x, M2)
    return x ^ (x >> 16)


def hash_word(seed: int, sample, ctr):
    """uint32 word (int64 tensor) of draw `ctr` of sample `sample`."""
    sample = torch.as_tensor(sample, dtype=torch.int64) & MASK
    ctr = torch.as_tensor(ctr, dtype=torch.int64, device=sample.device) & MASK
    x = _fmix(((int(seed) & MASK) ^ SEED_XOR) + _mul(sample, PHI) & MASK)
    return _fmix(x ^ _mul(ctr, M1))


def uniform(seed: int, sample, ctr):
    """U[0, 1) float32 with 23 random bits; arguments broadcast."""
    return (hash_word(seed, sample, ctr) & 0x7FFFFF).to(torch.float32) * (1.0 / 8388608.0)


def shading_ctr(bounce: int, j):
    return CAMERA_DRAWS + SHADING_DRAWS * bounce + j


def roulette_ctr(bounce: int, max_depth: int):
    return CAMERA_DRAWS + SHADING_DRAWS * max_depth + bounce
