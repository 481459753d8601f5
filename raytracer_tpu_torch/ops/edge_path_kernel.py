"""The edge terms' path traces in one hand-written CUDA launch a call
(`csrc/edge_path_kernel.cu`).

The edge estimators (diff/boundary.py, diff/shadow_edge.py and, through
boundary._trace_edge_radiance, diff/mirror_edge.py and
diff/refracted_edge.py) get their radiances from
diff/boundary.py:trace_edge_rays: spp_edge paths from each of K rays, lane
L (ray L mod K) the sample id L under the call's seed, with russian
roulette and each sphere winner's t by the stable quadratic. Its eager path,
integrator/wavefront.py:trace, runs kernel 1 a bounce, about a hundred
small PyTorch operations for the shading and a host sync at every bounce's
compaction. `edge_path` traces every lane's whole path in one launch
instead: one thread a lane, persistent over a strided queue of lanes, the
closest hit and kernel 2's shading written out in the kernel, no sync and
no allocation inside it.

`trace` is its plain twin and spec: on the card the kernel's radiance
equals it bit for bit on every live lane (the same counter-hash uniforms,
hit and shading arithmetic with contraction off, ops/build.py). A lane
whose ray is False in `live` traces nothing and reads zeros.

Dispatch (diff/boundary.py:trace_edge_rays, by `takes_edge_path_kernel`):
CUDA tensors of a scene the kernel shades (kernel 2's rule,
ops/persistent_kernel.py:unsupported_reason, which refuses noise from
rng-filled Perlin tables) take the kernel; CPU tensors and other
scenes take the eager `trace`. `edge_path` itself takes CUDA tensors only
and raises on anything it cannot launch.

Launch counter (utils/launches.py): `LAUNCHES` (`edge_path`), one a launch.
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.geometry.scene import FLAG_FIELDS, TENSOR_FIELDS
from raytracer_tpu_torch.materials.packed import (
    FILTER_STOCHASTIC,
    N_COLS,
    primitive_table,
    texture_tables,
)
from raytracer_tpu_torch.ops import persistent_kernel as pk
from raytracer_tpu_torch.ops.intersect_kernel import (
    check_float4_rows,
    check_tensor,
    pack_quad_table,
    pack_sphere_table,
)

# Threads per block.
THREADS = 128
# The launch's grid is the resident grid divided by this, capped at the
# lanes: each thread then traces a few lanes of its strided queue, so a
# deep path holds its own thread and its warp's other threads go on to
# their next lanes.
GRID_DIVISOR = 4

# Russian roulette, trace's rule as the edge traces take it: from depth 5,
# survival q = clip(max throughput, 0.05, 0.75).
RR_START, RR_LO, RR_HI = 5, 0.05, 0.75

# CUDA launches of the kernel.
LAUNCHES = 0

# `scene_tables`' cache: (the scene's tensors, their versions and the
# scene's flags, its tables), or None.
_LAST_TABLES: list = [None]


def takes_edge_path_kernel(scene, device) -> bool:
    """Whether diff/boundary.py:trace_edge_rays traces on the kernel:
    tensors on a CUDA device and a scene kernel 2 shades
    (ops/persistent_kernel.py:unsupported_reason None)."""
    return torch.device(device).type == "cuda" and pk.unsupported_reason(scene) is None


def scene_tables(scene) -> tuple:
    """`edge_path`'s scene arguments (sph_table, quad_table, res_table,
    radius, textures), packed as integrator/wavefront.py:trace packs them
    (texture_tables with its deterministic image filter). The last scene's
    come from a one-entry cache while each of its TENSOR_FIELDS is the same
    tensor at the same version and its FLAG_FIELDS are the same (an edge
    term's traces share one scene; its ~110 packing operations then run
    once a term, not once a trace); a scene with a tensor that requires
    grad is packed without it."""
    tensors = tuple(getattr(scene, f) for f in TENSOR_FIELDS)
    key = (tuple(t._version for t in tensors), tuple(getattr(scene, f) for f in FLAG_FIELDS))
    last = _LAST_TABLES[0]
    if last is not None and last[1] == key and all(a is b for a, b in zip(last[0], tensors)):
        return last[2]
    qd = quad_derived(scene)
    tables = (pack_sphere_table(scene.sph_center, scene.sph_radius), pack_quad_table(qd),
              primitive_table(scene, qd), scene.sph_radius.contiguous(),
              texture_tables(scene, qd))
    if not any(t.requires_grad for t in tensors):
        _LAST_TABLES[0] = (tensors, key, tables)
    return tables


def edge_path_scene(scene, origin, direction, background, seed: int, *, spp_edge: int,
                    max_depth: int, sky_gradient: bool = False, live=None,
                    count_segments: bool = False):
    """`edge_path` of the scene's tables (`scene_tables`)."""
    sph, quad, res, radius, textures = scene_tables(scene)
    return edge_path(sph, quad, res, radius, origin.contiguous(), direction.contiguous(),
                     background.contiguous(), seed, spp_edge=spp_edge, max_depth=max_depth,
                     sky_gradient=sky_gradient, live=live, textures=textures,
                     count_segments=count_segments)


def edge_path(sph_table, quad_table, res_table, radius, origin, direction, background,
              seed: int, *, spp_edge: int, max_depth: int, sky_gradient: bool = False,
              live=None, textures=None, count_segments: bool = False):
    """Radiance (K x spp_edge, 3) float32 of the lanes of K rays (origin,
    direction (K, 3)): lane L traces ray L mod K as sample id L under
    `seed`, as integrator/wavefront.py:trace(russian_roulette=True,
    rr_max_q=RR_HI, stable_spheres=True) traces `origin.repeat(spp_edge,
    1)` with the uniforms ops/ctr_rng.py:bounce_uniforms and rr_uniforms
    key by lane.
    Tables as trace builds them: sph_table (S, 4) and quad_table (Q, 12)
    (ops/intersect_kernel.py), res_table (S + Q, 16)
    (materials/packed.py:primitive_table), the radii `radius` (S,), the
    flat `background` (3,); `textures` materials/packed.py:texture_tables
    (None without noise or image textures) with a deterministic image
    filter. `live` (K,) bool: lanes of rays False there read zeros.

    Returns (radiance, segments): with `count_segments` a (1,) int64 tensor
    that holds, once the launch has run, the lane-bounces it traced (read it
    without syncing inside a timed span: utils/trace.py:count); else None.
    CUDA tensors only: raises on a CPU tensor or an input the kernel does
    not take."""
    global LAUNCHES
    dev = origin.device
    check_tensor("sph_table", sph_table, torch.float32, (None, 4), dev)
    check_tensor("quad_table", quad_table, torch.float32, (None, 12), dev)
    ns, p = sph_table.shape[0], sph_table.shape[0] + quad_table.shape[0]
    check_tensor("res_table", res_table, torch.float32, (p, N_COLS), dev)
    check_tensor("radius", radius, torch.float32, (ns,), dev)
    check_tensor("origin", origin, torch.float32, (None, 3), dev)
    k = origin.shape[0]
    check_tensor("direction", direction, torch.float32, (k, 3), dev)
    check_tensor("background", background, torch.float32, (3,), dev)
    if live is not None:
        check_tensor("live", live, torch.bool, (k,), dev)
    if spp_edge < 1 or max_depth < 1:
        raise ValueError(f"spp_edge and max_depth must be >= 1, got {spp_edge}, {max_depth}")
    n = k * spp_edge
    if n >= 2**31:
        raise ValueError(f"{n} lanes do not fit the kernel's int32 lane ids")
    if textures is not None and textures.image_filter == FILTER_STOCHASTIC:
        raise ValueError("the edge paths need a deterministic image filter, not the "
                         "stochastic tap")
    check_float4_rows(sph_table=sph_table, quad_table=quad_table, res_table=res_table)
    tex = pk._texture_launch_args(textures, p, dev)
    if dev.type != "cuda":
        raise ValueError(f"the edge path kernel runs on CUDA tensors, got {dev}: CPU rays take "
                         "integrator/wavefront.py:trace")
    from raytracer_tpu_torch.ops.build import check_launch, load_kernels

    lib = load_kernels()
    radiance = torch.empty(n, 3, dtype=torch.float32, device=dev)
    segments = torch.zeros(1, dtype=torch.int64, device=dev) if count_segments else None
    if n == 0:
        return radiance, segments
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rt_edge_path(
        sph_table.data_ptr(), radius.data_ptr(), ns, quad_table.data_ptr(),
        quad_table.shape[0], res_table.data_ptr(), origin.data_ptr(), direction.data_ptr(),
        None if live is None else live.data_ptr(), k, n, background.data_ptr(),
        ctypes.c_int(int(seed) & 0xFFFFFFFF).value, max_depth, RR_START, RR_LO, RR_HI,
        int(sky_gradient), radiance.data_ptr(),
        None if segments is None else segments.data_ptr(), *tex, GRID_DIVISOR, THREADS, stream,
    )
    check_launch("rt_edge_path", err)
    LAUNCHES += 1
    return radiance, segments
