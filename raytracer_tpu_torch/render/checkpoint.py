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
    render_chunks,
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
    """Render through `driver.render_chunks`, saving a checkpoint after each
    chunk; returns the linear mean radiance (H, W, 3) on `device` (partial
    when `max_chunks` stopped it early).

    The default chunk is `render_image`'s (driver.default_spp_chunk), so an
    uninterrupted render equals `render_image`'s bit for bit; `wavefront`
    (the persistent path's lanes, the port's counterpart of the JAX
    function's `target_rays_per_pass`), `log_budget_bytes`,
    `bilinear_stochastic`, `device` and `metrics` are render_image's. With
    `checkpoint_path` the render resumes from the file when it is there
    (refusing one written under another configuration) and saves after
    every chunk on a BackgroundSaver thread; the device-to-host copy of the
    sums is made here, after the chunk, so the saver reads a snapshot."""
    dev = resolve_device(device)
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    if spp_per_chunk is None:
        spp_per_chunk = default_spp_chunk(scene, settings, wavefront=wavefront,
                                          log_budget_bytes=log_budget_bytes)
    fingerprint = config_fingerprint(
        scene, cam, settings, spp_per_chunk, seed,
        extra=(render_path(scene), wavefront, bilinear_stochastic, dev.type),
    )
    done, chunk_idx = 0, 0
    acc = torch.zeros(w * h, 3, dtype=torch.float32, device=dev)
    if checkpoint_path:
        ck = load_checkpoint(checkpoint_path)
        if ck is not None:
            if ck.config_hash != fingerprint:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written under a "
                    "different scene/camera/settings/chunking configuration; "
                    "refusing to resume (delete it to restart)"
                )
            done, chunk_idx = ck.done_spp, ck.chunk_idx
            acc = torch.from_numpy(np.ascontiguousarray(ck.acc, np.float32)).reshape(
                w * h, 3).to(dev)
            if progress:
                print(f"resumed at {done}/{spp} spp", flush=True)

    saver = BackgroundSaver(checkpoint_path) if checkpoint_path else None
    chunks = render_chunks(
        scene, cam, settings, device=dev, seed=seed, spp_per_chunk=spp_per_chunk,
        start_chunk=chunk_idx, wavefront=wavefront, log_budget_bytes=log_budget_bytes,
        progress=progress, metrics=metrics, bilinear_stochastic=bilinear_stochastic,
    )
    chunks_run = 0
    try:
        while done < spp and (max_chunks is None or chunks_run < max_chunks):
            idx, done, fb = next(chunks)
            # A new tensor each chunk: nothing of a saved state is changed
            # in place.
            acc = acc + fb
            chunk_idx = idx + 1
            chunks_run += 1
            if saver is not None:
                host = acc.reshape(h, w, 3).to("cpu", copy=True).numpy()
                saver.submit(RenderCheckpoint(acc=host, done_spp=done, seed=seed,
                                              chunk_idx=chunk_idx, config_hash=fingerprint))
        if done >= spp:
            # Run the generator to its end: the metrics' totals come after
            # the last chunk.
            next(chunks, None)
    finally:
        chunks.close()
        if saver is not None:
            saver.wait()
    if saver is not None:
        saver.raise_errors()
    return (acc / float(max(done, 1))).reshape(h, w, 3)
