"""Optimizer-state checkpoint and resume for inverse-rendering runs (port of
raytracer_tpu/diff/opt_checkpoint.py).

Gradient-descent scene recovery gets the same fail-stop and resume that
render/checkpoint.py gives renders:

* the checkpoint holds the trainable params, the optimizer's state
  (`torch.optim.Adam.state_dict()`: each param's `step`, `exp_avg` and
  `exp_avg_sq`), the next step and the seed;
* step i of a run seeded `seed` renders under `driver.chunk_seed(seed, i)`
  (the counterpart of JAX's fold_in(PRNGKey(seed), i)), so a resumed run
  repeats the uninterrupted trajectory; on the CPU bit for bit;
* a fingerprint of the configuration refuses a resume under another
  scene, target or optimizer, and a file of another version, leaf count,
  shape or dtype is refused too;
* saves are atomic (tmp file, then os.replace).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.render.driver import chunk_seed

OPT_CHECKPOINT_VERSION = 1


def _update(h, x) -> None:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    if isinstance(x, (np.ndarray, np.generic)):
        h.update(f"array {x.dtype} {x.shape}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, dict):
        h.update(f"dict {len(x)}".encode())
        for k, v in x.items():
            h.update(repr(k).encode())
            _update(h, v)
    elif isinstance(x, (list, tuple)):
        h.update(f"{type(x).__name__} {len(x)}".encode())
        for v in x:
            _update(h, v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        h.update(type(x).__name__.encode())
        for f in dataclasses.fields(x):
            h.update(f.name.encode())
            _update(h, getattr(x, f.name))
    else:
        h.update(repr(x).encode())


def opt_fingerprint(*parts) -> str:
    """Hash of the values that determine an optimization's trajectory (the
    initial scene or params, the camera, the target, the loss settings, the
    optimizer's hyperparameters, the seed). Tensors and arrays hash by
    dtype, shape and bytes; dicts (in their order), lists, tuples and
    dataclasses by structure and items; other values by repr."""
    h = hashlib.sha256()
    for part in parts:
        _update(h, part)
    return h.hexdigest()


class OptCheckpoint(NamedTuple):
    params: dict  # name -> tensor
    opt_state: dict  # an optimizer state_dict
    step: int  # next step to run
    seed: int
    config_hash: str


def optimizer_state_like(optimizer: torch.optim.Optimizer) -> dict:
    """`optimizer.state_dict()` with the state each param will hold once it
    has taken a step, for params that have not: the template
    `load_opt_checkpoint` holds a file against. Adam only (the optimizer
    of diff.grad.make_inverse_renderer): `step` a float32 scalar,
    `exp_avg` and `exp_avg_sq` (and `max_exp_avg_sq` with amsgrad) zeros
    like the param."""
    if not isinstance(optimizer, torch.optim.Adam):
        raise TypeError(f"optimizer_state_like knows Adam's state, not {type(optimizer)}")
    sd = optimizer.state_dict()
    pid = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            if pid not in sd["state"]:
                state = {"step": torch.zeros((), dtype=torch.float32),
                         "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
                if group["amsgrad"]:
                    state["max_exp_avg_sq"] = torch.zeros_like(p)
                sd["state"][pid] = state
            pid += 1
    return sd


def _state_leaves(state_dict: dict) -> list:
    """(param index, key, tensor) of a state_dict's state, in index and
    then key order."""
    state = state_dict["state"]
    return [(pid, key, state[pid][key]) for pid in sorted(state) for key in sorted(state[pid])]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_opt_checkpoint(path: str, ckpt: OptCheckpoint) -> None:
    """Write `ckpt` atomically (tmp file, then os.replace)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    p_leaves = list(ckpt.params.values())
    s_leaves = [t for _, _, t in _state_leaves(ckpt.opt_state)]
    payload = {f"p{i}": _host(x) for i, x in enumerate(p_leaves)}
    payload.update({f"s{i}": _host(x) for i, x in enumerate(s_leaves)})
    tmp = path + ".tmp"
    np.savez(
        tmp,
        version=OPT_CHECKPOINT_VERSION,
        step=ckpt.step,
        seed=ckpt.seed,
        config_hash=np.array(ckpt.config_hash),
        n_params=len(p_leaves),
        n_state=len(s_leaves),
        **payload,
    )
    os.replace(tmp + ".npz", path)


def load_opt_checkpoint(path: str, *, params_like: dict, opt_state_like: dict,
                        config_hash: str) -> OptCheckpoint | None:
    """Load and validate; None when the file does not exist.

    `params_like` (the caller's fresh params) and `opt_state_like`
    (`optimizer_state_like(optimizer)`) give the structure: the version,
    the config hash, the leaf counts and every leaf's shape and dtype must
    match, or the load refuses. Returns CPU tensors: params by name, and a
    state_dict of `opt_state_like`'s structure for
    `optimizer.load_state_dict`."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["version"]) != OPT_CHECKPOINT_VERSION:
            raise ValueError(
                f"optimizer checkpoint {path} has version {int(z['version'])},"
                f" this build writes {OPT_CHECKPOINT_VERSION}; finish it with"
                " the old build or delete it to restart"
            )
        if str(z["config_hash"]) != config_hash:
            raise ValueError(
                f"optimizer checkpoint {path} was written under a different "
                "scene/target/optimizer configuration; refusing to resume "
                "(delete it to restart)"
            )
        p_like = list(params_like.items())
        s_like = _state_leaves(opt_state_like)
        if int(z["n_params"]) != len(p_like) or int(z["n_state"]) != len(s_like):
            raise ValueError(
                f"optimizer checkpoint {path} leaf counts do not match the "
                "current params/optimizer structure; refusing to resume"
            )

        def restore(key, like):
            arr = z[key]
            want = _host(like)
            if arr.shape != want.shape or arr.dtype != want.dtype:
                raise ValueError(
                    f"optimizer checkpoint {path} leaf {key} is {arr.dtype}{arr.shape}, "
                    f"expected {want.dtype}{want.shape}; refusing to resume"
                )
            return torch.from_numpy(arr.copy())

        params = {name: restore(f"p{i}", like) for i, (name, like) in enumerate(p_like)}
        state: dict[int, dict[str, Any]] = {}
        for i, (pid, key, like) in enumerate(s_like):
            state.setdefault(pid, {})[key] = restore(f"s{i}", like)
        opt_state = {"state": state, "param_groups": opt_state_like["param_groups"]}
        return OptCheckpoint(params=params, opt_state=opt_state, step=int(z["step"]),
                             seed=int(z["seed"]), config_hash=str(z["config_hash"]))


def run_optimization(
    step_fn,
    params: dict,
    optimizer: torch.optim.Optimizer,
    *,
    n_steps: int,
    seed: int,
    fingerprint: str = "",
    checkpoint_path: str | None = None,
    save_every: int = 10,
    max_steps_this_run: int | None = None,
    on_step=None,
):
    """Deterministic checkpointed optimization loop over
    diff.grad.make_inverse_renderer's contract: `step_fn(seed_i) -> loss`
    updates `params` (the leaves `optimizer` steps) in place. Step i runs
    under seed `chunk_seed(seed, i)`, so the trajectory depends only on the
    initial state and `seed`.

    Returns (params, optimizer, next step, losses of this run). With
    `checkpoint_path`, the run resumes from the file when it is there
    (refusing on a mismatch), loading the params in place and the
    optimizer's state, and saves every `save_every` steps, at the end, and
    where `max_steps_this_run` stops it early. `on_step(i, loss)` is called
    after each step."""
    start = 0
    if checkpoint_path:
        ck = load_opt_checkpoint(checkpoint_path, params_like=params,
                                 opt_state_like=optimizer_state_like(optimizer),
                                 config_hash=fingerprint)
        if ck is not None:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(ck.params[name])
            optimizer.load_state_dict(ck.opt_state)
            start = ck.step

    def save(step):
        save_opt_checkpoint(checkpoint_path, OptCheckpoint(
            params=params, opt_state=optimizer.state_dict(), step=step, seed=seed,
            config_hash=fingerprint))

    losses = []
    step = start
    while step < n_steps:
        if max_steps_this_run is not None and len(losses) >= max_steps_this_run:
            break
        losses.append(float(step_fn(chunk_seed(seed, step))))
        step += 1
        if on_step is not None:
            on_step(step - 1, losses[-1])
        if checkpoint_path and (step % save_every == 0 or step == n_steps):
            save(step)
    if checkpoint_path and losses and step % save_every != 0 and step != n_steps:
        save(step)
    return params, optimizer, step, losses
