"""The sharded render's split of the samples, added to the reference
tracer (tracer.py): the chunk plan, each rank's share of each chunk and
each rank's seed, worked out here with the reference's own hash (rng.py).

The split, as the renderer's sharded regenerative loop defines it over
R ranks:

* the chunk plan: the image's spp run in chunks of `chunk` samples per
  pixel, the last taking what is left. `chunk` is R times the largest
  share whose device memory fits the log budget on one rank (at most
  ceil(spp / R)), capped at spp: a rank's chunk of k samples holds its
  (3, K, N) float32 retirement log (N = min(lanes, k * pixels) lanes, K =
  ceil(k * pixels / N) slots), its (pixels, 3) float32 framebuffer and,
  with more lanes than pixels, the fold's scratch;
* chunk c is seeded hash(seed, c, 0) as a signed 32-bit word (chunk 0
  keeps the seed);
* rank r's share of a chunk of k samples is k // R + (r < k % R), traced
  under hash(chunk seed, r, 1) as a signed word (rank 0 keeps the chunk
  seed), as sample ids p + j * pixels, j < share, of pixel p.

The pixel is the sum over ranks and chunks of their samples' radiance,
divided by spp. Everything is float32 with TF32 off, or `dtype`.
"""

from __future__ import annotations

import torch

from benchmark.reference import rng, tracer
from benchmark.scenes import image_size

# The renderer's persistent path: its lanes, the device memory a chunk may
# hold, and the fold's scratch budget.
LANES = 1 << 18
LOG_BUDGET_BYTES = 2 << 30
FOLD_SCRATCH_BYTES = 64 << 20
CHUNK_CTR, RANK_CTR = 0, 1


def signed_hash(seed: int, lane: int, ctr: int) -> int:
    """rng.hash_word of (seed, lane, ctr) as a signed 32-bit integer."""
    w = int(rng.hash_word(seed, torch.tensor(lane), ctr))
    return w - (1 << 32) if w >= 1 << 31 else w


def chunk_seed(seed: int, c: int) -> int:
    return seed if c == 0 else signed_hash(seed, c, CHUNK_CTR)


def rank_seed(seed: int, r: int) -> int:
    return seed if r == 0 else signed_hash(seed, r, RANK_CTR)


def rank_share(k: int, r: int, ranks: int) -> int:
    return k // ranks + (1 if r < k % ranks else 0)


def chunk_bytes(n_pixels: int, k: int, lanes: int = LANES) -> int:
    """Device bytes one rank's chunk of k samples per pixel holds (module
    docstring)."""
    total = n_pixels * k
    n = max(1, min(lanes, total))
    slots = -(-total // n)
    scratch = 0
    if n > n_pixels:
        per = -(-n // n_pixels) + 1
        group = max(1, min(slots, FOLD_SCRATCH_BYTES // (12 * n_pixels * per)))
        scratch = 12 * n_pixels * (per * group + 1)
    return 12 * slots * n + 12 * n_pixels + scratch


def chunk_plan(n_pixels: int, spp: int, ranks: int, budget: int = LOG_BUDGET_BYTES,
               lanes: int = LANES) -> list[int]:
    """Samples per pixel of each chunk, in order (module docstring)."""
    share = min(-(-spp // ranks), max(1, budget // (12 * n_pixels)))
    while share > 1 and chunk_bytes(n_pixels, share, lanes) > budget:
        share -= 1
    chunk = min(spp, share * ranks)
    return [min(chunk, spp - done) for done in range(0, spp, chunk)]


def render_pixels(desc, camera: dict, seed: int, pixels, *, spp: int, max_depth: int,
                  roulette, ranks: int, device, dtype=torch.float32,
                  budget: int = LOG_BUDGET_BYTES):
    """(mean radiance (P, 3) float32, segments, chunk plan) of `pixels` (P,)
    of an image rendered at `spp` under `seed`, its samples split over
    `ranks` ranks as the module docstring sets out; every sample traced
    by its (rank seed, sample id)."""
    width, height = image_size(camera)
    n_pix = width * height
    plan = chunk_plan(n_pix, spp, ranks, budget)
    sc = tracer.scene_from_description(desc, device, dtype)
    fr = tracer.camera_frame(camera, width).to(device, dtype)
    bg = torch.tensor(camera["background"], dtype=torch.float32, device=device)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    out = torch.zeros(pixels.shape[0], 3, dtype=torch.float32, device=device)
    segments = 0
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for c, k in enumerate(plan):
            for r in range(ranks):
                share = rank_share(k, r, ranks)
                if share == 0:
                    continue
                s = rank_seed(chunk_seed(seed, c), r)
                per_block = max(1, tracer.SAMPLE_BLOCK // share)
                for b in range(0, pixels.shape[0], per_block):
                    pb = pixels[b:b + per_block]
                    ids = (pb[:, None] + torch.arange(share, device=device)[None, :] * n_pix)
                    rad, segs = tracer.trace(
                        sc, fr, s, ids.reshape(-1), width=width, n_pixels=n_pix,
                        max_depth=max_depth, background=bg,
                        sky_gradient=camera.get("sky_gradient", False), roulette=roulette)
                    out[b:b + per_block] += rad.float().reshape(-1, share, 3).sum(1)
                    segments += int(segs.sum())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out / float(spp), segments, plan
