"""Kernel 5: the front half of one iteration of the wavefront-step path.

Port of raytracer_tpu/ops/wavefront_kernel.py (`wavefront_step_pallas`).
Per lane: regeneration (an idle lane that owes samples advances its strided
pixel and starts its next sample), the thin-lens camera ray, the closest
hit, and the lane's random draws for the shading epilogue that follows in
PyTorch (integrator/wavefront.py:wavefront_step_loop). The CUDA kernel is
`csrc/wavefront_kernel.cu`; `wavefront_step_plain` below is its plain twin
and its spec.

The TPU kernel drew its uniforms from the core's hardware PRNG. Here every
draw is the ctr_rng counter hash keyed by the sample id lane + sample_k*N
(ops/ctr_rng.py): camera draws at counters 0-3, the three shading uniforms
at shading_ctr(depth, j), the russian-roulette coin at rr_ctr(depth,
max_depth), with depth 0 for a lane granted a new sample. The path then
realises exactly the estimator of kernel 2 (regen_plain).

Lanes with no path in flight after regeneration skip the closest hit and
report a miss (t = +inf, prim = -1); the TPU kernel searched for them too,
but the epilogue never reads those outputs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raytracer_tpu_torch.core.camera import camera_rays
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops.intersect_kernel import (
    INF,
    check_float4_rows,
    check_tensor,
    intersect_plain,
)
from raytracer_tpu_torch.ops.persistent_kernel import N_CAM, frame_from_scalars

# Threads per block of the CUDA kernel.
THREADS = 256

# CUDA launches of the kernel (plain-twin calls do not count).
LAUNCHES = 0


class StepOut(NamedTuple):
    """One step's per-lane outputs (N lanes)."""

    t: torch.Tensor  # (N,) float32, +inf on a miss or an idle lane
    prim: torch.Tensor  # (N,) int32, -1 on a miss or an idle lane
    origin: torch.Tensor  # (N, 3) float32: the camera ray on granted lanes
    direction: torch.Tensor  # (N, 3) float32
    grant: torch.Tensor  # (N,) bool: the lane started a new sample
    remaining: torch.Tensor  # (N,) int32 samples still owed
    px: torch.Tensor  # (N,) int32 pixel column
    py: torch.Tensor  # (N,) int32 pixel row
    sample_k: torch.Tensor  # (N,) int32 slot of the lane's current sample
    uniforms: torch.Tensor  # (N, 4) float32: three shading uniforms, the RR coin


def advance_pixels(px, py, first, *, width: int, height: int, jump_px: int, jump_py: int):
    """Pixels of the next strided sample of lanes starting one: a lane's
    first sample keeps its initial pixel (`first`), later ones advance by
    the constant jump with carry and wrap (no division)."""
    pxa = px + jump_px
    pya = py + jump_py
    carry = pxa >= width
    pxa = torch.where(carry, pxa - width, pxa)
    pya = torch.where(carry, pya + 1, pya)
    pya = torch.where(pya >= height, pya - height, pya)
    return torch.where(first, px, pxa), torch.where(first, py, pya)


def wavefront_step_plain(
    sph_table, quad_table, cam_scalars, seed: int, origin, direction, active,
    remaining, px, py, sample_k, depth, *, width: int, height: int, jump_px: int,
    jump_py: int, max_depth: int,
) -> StepOut:
    """Plain twin of kernel 5 (see the module docstring). `depth` (N,) is
    each lane's bounce count, read for lanes not granted a new sample."""
    dev = origin.device
    n = origin.shape[0]
    grant = ~active & (remaining > 0)
    o, d = origin.clone(), direction.clone()
    rem, px, py, sk = remaining.clone(), px.clone(), py.clone(), sample_k.clone()
    g = torch.nonzero(grant).squeeze(1)
    if g.numel():
        px[g], py[g] = advance_pixels(px[g], py[g], sk[g] < 0, width=width, height=height,
                                      jump_px=jump_px, jump_py=jump_py)
        sk[g] += 1
        rem[g] -= 1
        sid = g + sk[g].to(torch.int64) * n
        o[g], d[g] = camera_rays(
            frame_from_scalars(cam_scalars), px[g], py[g], ctr_rng.camera_uniforms(seed, sid)
        )
    t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(active | grant).squeeze(1)
    if live.numel():
        t[live], prim[live] = intersect_plain(sph_table, quad_table, o[live], d[live])
    bounce = torch.where(grant, 0, depth).to(torch.int64)
    sid = torch.arange(n, dtype=torch.int64, device=dev) + sk.to(torch.int64) * n
    j3 = torch.arange(ctr_rng.UNIFORMS_PER_BOUNCE, dtype=torch.int64, device=dev)
    uniforms = torch.cat(
        [
            ctr_rng.uniform(seed, sid[:, None], ctr_rng.shading_ctr(bounce[:, None], j3)),
            ctr_rng.uniform(seed, sid, ctr_rng.rr_ctr(bounce, max_depth))[:, None],
        ],
        dim=1,
    )
    return StepOut(t, prim, o, d, grant, rem, px, py, sk, uniforms)


def wavefront_step(
    sph_table, quad_table, cam_scalars, seed: int, origin, direction, active,
    remaining, px, py, sample_k, depth, *, width: int, height: int, jump_px: int,
    jump_py: int, max_depth: int,
) -> StepOut:
    """One step for every lane: regeneration, camera ray, closest hit and
    draws. Tables from ops/persistent_kernel.py:pack_persistent_tables and
    pack_camera_scalars_bg; `active` (N,) bool; remaining, px, py,
    sample_k, depth (N,) int32 (sample_k -1 before a lane's first sample,
    px/py its first pixel then).

    CPU tensors take `wavefront_step_plain`; CUDA tensors launch the CUDA
    kernel (or raise)."""
    global LAUNCHES
    dev = origin.device
    n = origin.shape[0]
    check_tensor("sph_table", sph_table, torch.float32, (None, 4), dev)
    check_tensor("quad_table", quad_table, torch.float32, (None, 12), dev)
    check_tensor("cam_scalars", cam_scalars, torch.float32, (N_CAM,), dev)
    check_tensor("origin", origin, torch.float32, (n, 3), dev)
    check_tensor("direction", direction, torch.float32, (n, 3), dev)
    check_tensor("active", active, torch.bool, (n,), dev)
    ints = (("remaining", remaining), ("px", px), ("py", py), ("sample_k", sample_k),
            ("depth", depth))
    for name, x in ints:
        check_tensor(name, x, torch.int32, (n,), dev)
    cfg = dict(width=width, height=height, jump_px=jump_px, jump_py=jump_py, max_depth=max_depth)
    args = (sph_table, quad_table, cam_scalars, seed, origin, direction, active,
            remaining, px, py, sample_k, depth)
    if dev.type == "cpu":
        return wavefront_step_plain(*args, **cfg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_float4_rows(sph_table=sph_table, quad_table=quad_table)
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    lib = load_kernels()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = StepOut(
        t=torch.empty(n, **f32), prim=torch.empty(n, **i32),
        origin=torch.empty(n, 3, **f32), direction=torch.empty(n, 3, **f32),
        grant=torch.empty(n, dtype=torch.bool, device=dev), remaining=torch.empty(n, **i32),
        px=torch.empty(n, **i32), py=torch.empty(n, **i32), sample_k=torch.empty(n, **i32),
        uniforms=torch.empty(n, 4, **f32),
    )
    if n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_wavefront_step(
        sph_table.data_ptr(), sph_table.shape[0], quad_table.data_ptr(), quad_table.shape[0],
        cam_scalars.data_ptr(), ctypes.c_int(int(seed) & 0xFFFFFFFF).value,
        origin.data_ptr(), direction.data_ptr(), active.data_ptr(),
        *(x.data_ptr() for _, x in ints), n, width, height, jump_px, jump_py, max_depth,
        *(x.data_ptr() for x in out), THREADS, stream,
    )
    check_launch("rt_wavefront_step", err)
    LAUNCHES += 1
    return out
