"""Checkpoint and resume of long renders (port of
raytracer_tpu/render/checkpoint.py).

The accumulated per-pixel radiance sums and the chunk counter are the whole
state of a render: chunk c always renders under `driver.chunk_seed(seed,
c)`, so a render resumed from a checkpoint is bit-identical to one that was
never stopped at the same chunking. Failure handling is fail-stop and
resume: rerun with the same checkpoint path and the render continues after
the last chunk saved.

Files keep the JAX package's npz layout (keys `version`, `acc` as (H, W, 3)
float32 radiance sums, `done_spp`, `seed`, `chunk_idx`, `config_hash`), so
either package loads the other's file; the fingerprints differ, so neither
resumes the other's render.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.core.camera import Camera, RenderSettings
from raytracer_tpu_torch.geometry.scene import Scene
from raytracer_tpu_torch.render.driver import (
    DEFAULT_WAVEFRONT,
    LOG_BUDGET_BYTES,
    default_spp_chunk,
    render_loop,
    render_path,
    resolve_device,
)

CHECKPOINT_VERSION = 2


def _hash_value(h, value) -> None:
    if isinstance(value, torch.Tensor):
        arr = value.detach().cpu().contiguous().numpy()
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    else:
        h.update(repr(value).encode())


def config_fingerprint(scene: Scene, cam: Camera, settings: RenderSettings, spp_per_chunk: int,
                       seed: int, extra: tuple = ()) -> str:
    """Hash of everything that determines the accumulated image: every field
    of the scene and the camera in field order (tensors by dtype, shape and
    bytes; the static flags, such as `bilinear_textures` and
    `perlin_procedural`, by repr), the render settings, the chunk size, the
    seed and `extra` (what else picks the samples' streams or arithmetic:
    the path, the lanes, the image filter, the device type). Resuming
    under another configuration would blend inconsistent sums, so
    `render_with_checkpoints` refuses on a mismatch."""
    h = hashlib.sha256()
    for obj in (scene, cam):
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _hash_value(h, getattr(obj, f.name))
    h.update(repr(tuple(settings)).encode())
    h.update(str(int(spp_per_chunk)).encode())
    h.update(str(int(seed)).encode())
    h.update(repr(extra).encode())
    return h.hexdigest()


class RenderCheckpoint(NamedTuple):
    acc: np.ndarray  # (H, W, 3) float32 radiance sums over completed samples
    done_spp: int
    seed: int
    chunk_idx: int = 0  # next chunk to run
    config_hash: str = ""  # config_fingerprint at save time


def save_checkpoint(path: str, ckpt: RenderCheckpoint) -> None:
    """Write `ckpt` atomically: to `path`.tmp.npz, then renamed over `path`,
    so a kill mid-save leaves the previous checkpoint whole."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    np.savez(
        tmp,
        version=CHECKPOINT_VERSION,
        acc=np.asarray(ckpt.acc, np.float32),
        done_spp=ckpt.done_spp,
        seed=ckpt.seed,
        chunk_idx=ckpt.chunk_idx,
        config_hash=np.array(ckpt.config_hash),
    )
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str) -> RenderCheckpoint | None:
    """The checkpoint at `path`, or None when there is none. A file of
    another version raises: restarting from 0 spp would overwrite it."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["version"]) != CHECKPOINT_VERSION:
            raise ValueError(
                f"checkpoint {path} has version {int(z['version'])}, this "
                f"build writes {CHECKPOINT_VERSION}; finish it with the old "
                "build or delete it to restart"
            )
        return RenderCheckpoint(
            acc=z["acc"],
            done_spp=int(z["done_spp"]),
            seed=int(z["seed"]),
            chunk_idx=int(z["chunk_idx"]),
            config_hash=str(z["config_hash"]),
        )


class BackgroundSaver:
    """One worker thread writing checkpoints off the render loop. A newer
    checkpoint supersedes a queued older one (cancelled if not started), so
    at most one save runs and one waits. `wait` drains the queue; after a
    render loop that succeeded, `raise_errors` surfaces any save error.
    The caller hands it host copies (RenderCheckpoint.acc is a numpy
    array): the worker makes no CUDA call and reads nothing the loop
    changes."""

    def __init__(self, path: str):
        self._path = path
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._futures: list = []

    def submit(self, ckpt: RenderCheckpoint) -> None:
        if self._futures and self._futures[-1].cancel():
            self._futures.pop()
        self._futures.append(self._pool.submit(save_checkpoint, self._path, ckpt))

    def wait(self) -> None:
        """Drain the queue (call from `finally`: never raises, so an error
        of the render in flight is not masked by a save error)."""
        self._pool.shutdown(wait=True)

    def raise_errors(self) -> None:
        """Raise the first save error (call after the render loop)."""
        for f in self._futures:
            if not f.cancelled():
                f.result()


def resume(path: str, fingerprint: str, acc: torch.Tensor, ranks) -> tuple[int, int]:
    """(samples per pixel done, next chunk) of the checkpoint at `path`,
    (0, 0) without one. `ranks.root` (driver.Ranks) reads the file into
    `acc` (in place) and `ranks` broadcasts its state and sums. A
    checkpoint of another configuration raises ValueError on every
    position."""
    state = torch.zeros(3, dtype=torch.int64, device=acc.device)  # found (1) / refused (2)
    if ranks.root:
        ck = load_checkpoint(path)
        if ck is not None and ck.config_hash != fingerprint:
            state[0] = 2
        elif ck is not None:
            state[:] = torch.tensor([1, ck.done_spp, ck.chunk_idx])
            acc.copy_(torch.from_numpy(np.ascontiguousarray(ck.acc, np.float32)).reshape(
                acc.shape))
    found, done, chunk_idx = ranks.broadcast(state).tolist()
    if found == 2:
        raise ValueError(
            f"checkpoint {path} was written under a different scene/camera/settings/"
            f"{ranks.what} configuration; refusing to resume (delete it to restart)")
    if found:
        ranks.broadcast(acc)
    return done, chunk_idx


def render_with_checkpoints(
    scene: Scene,
    cam: Camera,
    settings: RenderSettings,
    *,
    seed: int = 0,
    checkpoint_path: str | None = None,
    spp_per_chunk: int | None = None,
    max_chunks: int | None = None,
    progress: bool = False,
    device="cuda",
    wavefront: int = DEFAULT_WAVEFRONT,
    log_budget_bytes: int = LOG_BUDGET_BYTES,
    bilinear_stochastic: bool | None = None,
    metrics=None,
) -> torch.Tensor:
    """Render through `driver.render_loop` on one device, saving a
    checkpoint after each chunk; returns the linear mean radiance (H, W, 3)
    on `device` (partial when `max_chunks` stopped it early).

    The default chunk is `render_image`'s (driver.default_spp_chunk), so an
    uninterrupted render equals `render_image`'s bit for bit; `wavefront`
    (the persistent path's lanes, the port's counterpart of the JAX
    function's `target_rays_per_pass`), `log_budget_bytes`,
    `bilinear_stochastic`, `device` and `metrics` are render_image's. With
    `checkpoint_path` the render resumes from the file when it is there
    (refusing one written under another configuration) and saves after
    every chunk on a BackgroundSaver thread, which gets a host copy of the
    sums made after the chunk."""
    dev = resolve_device(device)
    if spp_per_chunk is None:
        spp_per_chunk = default_spp_chunk(scene, settings, wavefront=wavefront,
                                          log_budget_bytes=log_budget_bytes)
    checkpoint = None
    if checkpoint_path:
        checkpoint = (checkpoint_path, config_fingerprint(
            scene, cam, settings, spp_per_chunk, seed,
            extra=(render_path(scene), wavefront, bilinear_stochastic, dev.type),
        ))
    return render_loop(scene, cam, settings, device=dev, seed=seed, wavefront=wavefront,
                       log_budget_bytes=log_budget_bytes, spp_per_chunk=spp_per_chunk,
                       progress=progress, metrics=metrics,
                       bilinear_stochastic=bilinear_stochastic, checkpoint=checkpoint,
                       max_chunks=max_chunks)
