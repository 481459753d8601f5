"""Kernels 2 and 3: the whole regenerative wavefront render in one launch,
and its gradient-forward (tape) mode.

Kernel 2 ports raytracer_tpu/ops/persistent_kernel.py
(`render_persistent_pallas`) whole: all four texture kinds (solid,
checker, procedural Perlin marble, images filtered nearest, 4-tap bilinear
or by one stochastic bilinear tap), with dense primitive loops or, given a
cluster table (`pack_cluster_table`, from geometry/bvh.py:cluster_scene),
the two-level cluster-culled loops of large scenes. The CUDA kernel is
`csrc/persistent_kernel.cu` (one thread per wavefront lane, each running
its lane's strided sample queue to the end; noise and images in
`csrc/textures.cuh`, compiled in only for scenes that have them, the
marble's shared-memory Perlin tables only for scenes with noise, and the
culled loops only for calls with a cluster table); its plain PyTorch twin
and spec is integrator/wavefront.py:regen_plain, which takes the same
packed tables.

Kernel 3 ports `render_persistent_tape`: the same CUDA kernel, instantiated
with a tape, traces every sample once without russian roulette and records
each bounce's winner (the forward of the bucketed gradient on every
scene `unsupported_reason` accepts, diff/bucketed.py), with deterministic
image filters only, as in JAX; its threads take samples from a queue. Its
twin is integrator/wavefront.py:trace_tape_plain.

Every random draw is the ctr_rng counter hash keyed by the global sample id
(ops/ctr_rng.py), so kernel and twin consume identical uniforms; the TPU
kernel's hardware PRNG has no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.core.camera import CameraFrame
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.materials.packed import (
    FILTER_STOCHASTIC,
    N_COLS,
    TEX_COLS,
    primitive_table,
)
from raytracer_tpu_torch.ops.intersect_kernel import (
    check_float4_rows,
    check_tensor,
    pack_quad_table,
    pack_sphere_table,
)

# Camera/config scalar layout, (N_CAM,) float32.
CAM_PIXEL00 = 0  # 3
CAM_DU = 3  # 3
CAM_DV = 6  # 3
CAM_CENTER = 9  # 3
CAM_DISK_U = 12  # 3
CAM_DISK_V = 15  # 3
CAM_DEFOCUS = 18  # > 0 -> thin-lens sampling
CAM_BG = 19  # 3 — flat background color
N_CAM = 22

# Above this primitive count the render driver clusters the scene and
# kernel 2 culls (raytracer_tpu/render/driver.py CLUSTERED_SCENE_PRIMS).
CLUSTERED_SCENE_PRIMS = 1536

# Padding (in t) of a cluster's slab interval on each side in kernel 2's
# culled walk (csrc/cluster_walk.cuh:SLAB_PAD). A bounce ray starts on
# a surface, and the expanded-form sphere test can re-hit that surface
# just past T_MIN at a point outside the sphere's own box; the TPU
# kernel's unpadded test culls such a candidate where the dense search
# keeps it. Padding only enters more clusters.
CLUSTER_SLAB_PAD = 4e-3

# Threads per block of the CUDA kernel.
THREADS = 128
# Kernel 3 launches the resident grid divided by this: its threads take
# samples from a queue, and each thread's share of samples must be large
# against the deepest path (50 segments against a mean of ~3) for its
# warps' lanes to finish together. On an H100 at rand_spheres' training
# shape a quarter of the resident grid ran 22% faster than all of it
# (PERF.md, section 6).
TAPE_GRID_DIVISOR = 4

# CUDA launches of kernel 2 and of kernel 3 (plain-twin calls do not count).
LAUNCHES = 0
LAUNCHES_TAPE = 0


def unsupported_reason(scene) -> str | None:
    """Why the persistent kernel (CUDA or its plain twin) cannot render
    `scene`; None if it can, at any size. The render driver sends such
    scenes down its other paths (render/driver.py:render_path), and the
    bucketed gradient records their tape with integrator/wavefront.py:
    trace_tape_scene instead of kernel 3 (diff/bucketed.py:tape_forward),
    as JAX's bucketed step takes its XLA forward. The one gate is JAX's
    scene_supports_persistent's (raytracer_tpu/ops/persistent_kernel.py:
    1189-1190); its image-size gates (:1191-1201) guarded the TPU's VMEM
    budget and its f32 dims encoding, which the port does not have."""
    if scene.has_noise and not scene.perlin_procedural:
        return ("noise from rng-filled Perlin tables (procedural_perlin=False) is shaded off "
                "the persistent kernel, as the JAX package's scene_supports_persistent does")
    return None


def scene_supports_persistent(scene) -> bool:
    return unsupported_reason(scene) is None


def pack_persistent_tables(scene):
    """(sph (S, 4), quad (Q, 12), res (P, 16)) float32 tables on the scene's
    device."""
    qd = quad_derived(scene)
    return (
        pack_sphere_table(scene.sph_center, scene.sph_radius),
        pack_quad_table(qd),
        primitive_table(scene, qd),
    )


def _texture_launch_args(textures, p: int, dev):
    """The texture arguments of a kernel entry point, after checking the
    tables of a scene of `p` primitives: null pointers select the plain
    instantiation, the last argument (`has_noise`) the one that fills the
    Perlin tables for the marble (csrc/persistent_kernel.cu:
    TEXTURES_NOISE)."""
    if textures is None:
        return (None, None, None, 0, 0, 0, 0)
    check_tensor("textures.rows", textures.rows, torch.float32, (p, TEX_COLS), dev)
    images = textures.images
    check_tensor("textures.images", images, torch.float32, (None, None, None, 3), dev)
    check_tensor("textures.image_dims", textures.image_dims, torch.int32,
                 (images.shape[0], 2), dev)
    if textures.has_noise and textures.perlin is not None:
        raise ValueError("the kernel shades the procedural Perlin tables only")
    check_float4_rows(texture_rows=textures.rows)
    return (textures.rows.data_ptr(), images.data_ptr(), textures.image_dims.data_ptr(),
            images.shape[1], images.shape[2], textures.image_filter, int(textures.has_noise))


class ClusterTable(NamedTuple):
    """Kernel 2's cluster table: `rows` (R, 8) float32 on the render device,
    the sections [sphere supers | sphere fine | quad supers | quad fine] of
    a geometry.bvh.ClusterSet in that order (JAX's layout,
    raytracer_tpu/ops/persistent_kernel.py:1279-1302), each row two float4
    [min.x min.y min.z max.x] [max.y max.z start count], and the four
    section lengths. A super's start indexes its kind's fine rows, a fine
    row's start the (permuted) primitive table. No sphere rows: the dense
    sphere loop; no quad rows: the dense quad loop."""

    rows: torch.Tensor
    n_sph_super: int
    n_sph: int
    n_quad_super: int
    n_quad: int

    @property
    def counts(self) -> tuple[int, int, int, int]:
        return self.n_sph_super, self.n_sph, self.n_quad_super, self.n_quad


def pack_cluster_table(clusters, device="cpu") -> ClusterTable:
    """ClusterTable of a geometry.bvh.ClusterSet (its rows stay float32
    bit for bit). An empty set packs one zero row, so the kernel always
    gets a valid pointer."""
    parts = [np.asarray(x, np.float32).reshape(-1, 8)
             for x in (clusters.sph_super, clusters.sph, clusters.quad_super, clusters.quad)]
    rows = np.concatenate(parts) if sum(len(x) for x in parts) else np.zeros((1, 8), np.float32)
    return ClusterTable(torch.from_numpy(np.ascontiguousarray(rows)).to(device),
                        *(len(x) for x in parts))


def check_cluster_table(clusters: ClusterTable, dev) -> None:
    check_tensor("clusters.rows", clusters.rows, torch.float32, (None, 8), dev)
    if min(clusters.counts) < 0 or sum(clusters.counts) > clusters.rows.shape[0]:
        raise ValueError(f"cluster counts {clusters.counts} do not fit "
                         f"{clusters.rows.shape[0]} rows")


def pack_camera_scalars_bg(frame, background) -> torch.Tensor:
    """(N_CAM,) float32 camera + background scalars (CPU)."""
    return torch.cat(
        [
            frame.pixel00,
            frame.pixel_du,
            frame.pixel_dv,
            frame.center,
            frame.defocus_disk_u,
            frame.defocus_disk_v,
            frame.defocus_angle_radians.reshape(1),
            torch.as_tensor(background, dtype=torch.float32).reshape(3),
        ]
    ).to(torch.float32)


def frame_from_scalars(cam) -> CameraFrame:
    """The camera frame held in a (N_CAM,) scalar vector."""
    return CameraFrame(
        center=cam[CAM_CENTER : CAM_CENTER + 3],
        pixel00=cam[CAM_PIXEL00 : CAM_PIXEL00 + 3],
        pixel_du=cam[CAM_DU : CAM_DU + 3],
        pixel_dv=cam[CAM_DV : CAM_DV + 3],
        defocus_disk_u=cam[CAM_DISK_U : CAM_DISK_U + 3],
        defocus_disk_v=cam[CAM_DISK_V : CAM_DISK_V + 3],
        defocus_angle_radians=cam[CAM_DEFOCUS],
    )


def max_iters_for(num_slots: int, max_depth: int) -> int:
    """Per-lane iteration safety bound (the TPU kernel's, per tile)."""
    return num_slots * (max_depth + 2) + 8


def render_persistent(
    sph_table,
    quad_table,
    res_table,
    cam_scalars,
    seed: int,
    rem0,
    px0,
    py0,
    *,
    width: int,
    height: int,
    jump_px: int,
    jump_py: int,
    num_slots: int,
    max_depth: int = 50,
    rr_start: int = 5,
    rr_lo: float = 0.05,
    rr_hi: float = 0.75,
    sky_gradient: bool = False,
    textures=None,
    clusters: ClusterTable | None = None,
):
    """Render every lane's strided sample queue.

    Tables from pack_persistent_tables and pack_camera_scalars_bg; rem0,
    px0, py0 (N,) int32 per-lane schedule (samples owed, first pixel) from
    integrator.wavefront.schedule_arrays; `textures` from
    materials.packed.texture_tables (None for scenes without noise or
    image textures), whose `image_filter` selects the image filter;
    `clusters` a ClusterTable on the tables' device (None: dense primitive
    loops), the sphere and quad tables then packed from the scene that
    geometry.bvh.cluster_scene permuted. Returns (log (3, num_slots, N)
    float32 retired radiance per (slot, lane), segments (N,) int32 path
    segments traced per lane).

    CPU tensors take integrator.wavefront.regen_plain; CUDA tensors launch
    the CUDA kernel (or raise)."""
    global LAUNCHES
    dev = rem0.device
    n = rem0.shape[0]
    check_tensor("sph_table", sph_table, torch.float32, (None, 4), dev)
    check_tensor("quad_table", quad_table, torch.float32, (None, 12), dev)
    p = sph_table.shape[0] + quad_table.shape[0]
    check_tensor("res_table", res_table, torch.float32, (p, N_COLS), dev)
    check_tensor("cam_scalars", cam_scalars, torch.float32, (N_CAM,), dev)
    for name, x in (("rem0", rem0), ("px0", px0), ("py0", py0)):
        check_tensor(name, x, torch.int32, (n,), dev)
    if clusters is not None:
        check_cluster_table(clusters, dev)
    cfg = dict(
        width=width, height=height, jump_px=jump_px, jump_py=jump_py,
        num_slots=num_slots, max_depth=max_depth, rr_start=rr_start,
        rr_lo=rr_lo, rr_hi=rr_hi, sky_gradient=sky_gradient,
        max_iters=max_iters_for(num_slots, max_depth),
    )
    if dev.type == "cpu":
        from raytracer_tpu_torch.integrator.wavefront import regen_plain

        return regen_plain(
            sph_table, quad_table, res_table, cam_scalars, seed, rem0, px0, py0, **cfg,
            textures=textures, clusters=clusters,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_float4_rows(sph_table=sph_table, quad_table=quad_table, res_table=res_table)
    tex = _texture_launch_args(textures, p, dev)
    cull = (None, 0, 0, 0, 0)
    if clusters is not None:
        check_float4_rows(cluster_rows=clusters.rows)
        cull = (clusters.rows.data_ptr(), *clusters.counts)
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    lib = load_kernels()
    log = torch.zeros(3, num_slots, n, dtype=torch.float32, device=dev)
    segs = torch.zeros(n, dtype=torch.int32, device=dev)
    if n == 0:
        return log, segs
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_render_persistent(
        sph_table.data_ptr(), sph_table.shape[0],
        quad_table.data_ptr(), quad_table.shape[0],
        res_table.data_ptr(), cam_scalars.data_ptr(),
        ctypes.c_int(int(seed) & 0xFFFFFFFF).value,
        rem0.data_ptr(), px0.data_ptr(), py0.data_ptr(), n,
        log.data_ptr(), segs.data_ptr(),
        width, height, jump_px, jump_py, num_slots, max_depth, rr_start,
        rr_lo, rr_hi, int(sky_gradient), cfg["max_iters"], *tex, *cull, THREADS, stream,
    )
    check_launch("rt_render_persistent", err)
    LAUNCHES += 1
    return log, segs


def render_persistent_tape(
    sph_table,
    quad_table,
    res_table,
    cam_scalars,
    seed: int,
    n: int,
    *,
    width: int,
    height: int,
    max_depth: int = 50,
    sky_gradient: bool = False,
    textures=None,
    thread_segments: bool = False,
):
    """Kernel 3: global sample s of the n traced at pixel s mod
    (width*height) to its end (no russian roulette; camera draws at counters
    0-3, shading at ops.ctr_rng.shading_ctr), recording its winner per
    bounce. `textures` as render_persistent's, with a deterministic image
    filter (the replay must reproduce every texel).

    Returns (radiance (3, n) float32, tape (max_depth, n) int32 with -1 for
    a miss or a dead lane, segments (n,) int32). CPU tables take
    integrator.wavefront.trace_tape_plain; CUDA tables launch the CUDA
    kernel (or raise), whose threads take samples from a queue. With
    `thread_segments` (CUDA only, to measure warp occupancy) a fourth
    output holds each launched thread's segments, int32, zero past the
    launched grid."""
    global LAUNCHES_TAPE
    dev = sph_table.device
    check_tensor("sph_table", sph_table, torch.float32, (None, 4), dev)
    check_tensor("quad_table", quad_table, torch.float32, (None, 12), dev)
    p = sph_table.shape[0] + quad_table.shape[0]
    check_tensor("res_table", res_table, torch.float32, (p, N_COLS), dev)
    check_tensor("cam_scalars", cam_scalars, torch.float32, (N_CAM,), dev)
    if max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {max_depth}")
    if textures is not None and textures.image_filter == FILTER_STOCHASTIC:
        raise ValueError("the tape needs a deterministic image filter, not the stochastic tap")
    cfg = dict(width=width, height=height, max_depth=max_depth, sky_gradient=sky_gradient,
               textures=textures)
    if dev.type == "cpu" and thread_segments:
        raise ValueError("thread_segments exist only for the CUDA kernel's threads")
    if dev.type == "cpu":
        from raytracer_tpu_torch.integrator.wavefront import trace_tape_plain

        return trace_tape_plain(sph_table, quad_table, res_table, cam_scalars, seed, n, **cfg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_float4_rows(sph_table=sph_table, quad_table=quad_table, res_table=res_table)
    tex = _texture_launch_args(textures, p, dev)
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    lib = load_kernels()
    radiance = torch.empty(3, n, dtype=torch.float32, device=dev)
    tape = torch.full((max_depth, n), -1, dtype=torch.int32, device=dev)
    segs = torch.empty(n, dtype=torch.int32, device=dev)
    next_sample = torch.zeros(1, dtype=torch.int32, device=dev)
    # The launched grid is at most n threads rounded up to a block.
    per_thread = (torch.zeros(-(-n // THREADS) * THREADS, dtype=torch.int32, device=dev)
                  if thread_segments else None)
    outs = (radiance, tape, segs) + ((per_thread,) if thread_segments else ())
    if n == 0:
        return outs
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_render_persistent_tape(
        sph_table.data_ptr(), sph_table.shape[0],
        quad_table.data_ptr(), quad_table.shape[0],
        res_table.data_ptr(), cam_scalars.data_ptr(),
        ctypes.c_int(int(seed) & 0xFFFFFFFF).value, n,
        radiance.data_ptr(), tape.data_ptr(), segs.data_ptr(),
        width, height, max_depth, int(sky_gradient), *tex, next_sample.data_ptr(),
        per_thread.data_ptr() if thread_segments else None, TAPE_GRID_DIVISOR, THREADS, stream,
    )
    check_launch("rt_render_persistent_tape", err)
    LAUNCHES_TAPE += 1
    return outs
