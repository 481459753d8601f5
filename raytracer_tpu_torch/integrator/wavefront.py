"""Wavefront path-trace integrator (port of raytracer_tpu/integrator/wavefront.py).

The reference recursion (miss -> background; hit, no scatter -> emitted;
hit, scatter -> emitted + attenuation * recurse) becomes an iterative loop
over a batch of lanes with a throughput product, a radiance sum and an
alive mask.

* `trace`: every lane traces one path to completion (the non-regenerative
  loop), optionally recording the per-bounce winner tape; with a
  differentiable intersect hook it is the gradient path (diff/).
* `trace_tape_plain`: the plain twin and spec of the tape kernel (kernel 3,
  ops/persistent_kernel.py:render_persistent_tape): `trace` of one sample
  per lane from the packed tables, with counter-RNG uniforms.
* `trace_tape_scene`: the same lanes and uniforms traced by `trace` from
  the scene (kernel 1 a bounce on the card), the tape forward of the
  scenes kernel 3 does not shade (diff/bucketed.py:tape_forward).
* `regen_plain`: the regenerative wavefront over a strided per-lane sample
  queue, the plain twin and spec of the persistent CUDA kernel
  (csrc/persistent_kernel.cu) — the regen loop body and its epilogue
  (`_bounce_and_retire`), with every texture kind and image filter, and
  the culled instantiation's closest hit (ops/cluster_visit.py:
  `ClusterVisit`).
* `render_wavefront_regen`: schedule, kernel wrapper, `_fold_log`.
* `wavefront_step_loop`, `render_wavefront_step`: the same regenerative
  loop for scenes the persistent kernel does not serve (noise from
  rng-filled Perlin tables), each iteration's front half in kernel 5
  (ops/wavefront_kernel.py) and the epilogue `_bounce_and_retire` in
  PyTorch.

Every random draw is the ctr_rng counter hash keyed by the global sample id
(ops/ctr_rng.py for the layout).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.core.camera import camera_rays
from raytracer_tpu_torch.geometry.intersect import quad_derived
from raytracer_tpu_torch.materials.materials import resolve_and_shade
from raytracer_tpu_torch.materials.packed import (
    FILTER_STOCHASTIC,
    primitive_table,
    texture_tables,
)
from raytracer_tpu_torch.ops import ctr_rng
from raytracer_tpu_torch.ops import persistent_kernel as pk
from raytracer_tpu_torch.ops.cluster_visit import WORK_ROWS, ClusterVisit
from raytracer_tpu_torch.ops.intersect_kernel import (
    intersect,
    intersect_plain,
    pack_quad_table,
    pack_sphere_table,
)
from raytracer_tpu_torch.ops.wavefront_kernel import advance_pixels, wavefront_step
from raytracer_tpu_torch.utils import trace as tr
from raytracer_tpu_torch.utils.metrics import WARP

# Russian-roulette survival cap of the wavefront-step path: the JAX
# driver's value for its non-persistent paths (driver.py:602); the
# persistent path caps at 0.75.
STEP_RR_HI = 0.95

# Bound of the fold's scratch when the wavefront outnumbers the pixels: a
# chunk then holds its log, its framebuffer and this much more, whatever
# its slots and pixels (render/driver.py counts all three in its budget).
# 64 MiB is 3% of that budget, and at the headline's 90,000 pixels it
# still takes 15 slots a group, so the pad and the sum are not per slot.
FOLD_SCRATCH_BYTES = 64 << 20


def sky_color(direction):
    """Lerp sky: white -> (0.5, 0.7, 1.0) on the unit direction's y (the
    kernel's arithmetic: d_y / sqrt(|d|^2))."""
    d = direction
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    sa = 0.5 * (d[:, 1] * (1.0 / torch.sqrt(a)) + 1.0)
    return torch.stack(
        [(1.0 - sa) + sa * 0.5, (1.0 - sa) + sa * 0.7, torch.ones_like(sa)], dim=1
    )


def _background(direction, background, sky_gradient):
    if sky_gradient:
        return sky_color(direction)
    return background.to(direction.device).expand_as(direction)


def roulette(throughput, alive, depth, coin, *, start: int, lo: float, hi: float):
    """Unbiased russian roulette (the JAX package's rule,
    raytracer_tpu/integrator/wavefront.py:477-483): with q = clip(max over
    channels of the lane's throughput, lo, hi), a lane alive at `depth`
    (bounces taken, counting this one) >= `start` continues only if its
    coin < q, and its throughput is divided by q. Returns (alive,
    throughput)."""
    q = torch.clamp(throughput.max(dim=1).values, min=lo, max=hi)
    on = alive & (depth >= start)
    alive = alive & (~on | (coin < q))
    throughput = torch.where((on & alive)[:, None], throughput / q[:, None], throughput)
    return alive, throughput


def _trace_loop(
    res, num_spheres: int, origin, direction, background, uniforms_at, hit_fn, *,
    max_depth: int, sky_gradient: bool, return_tape: bool, textures=None, rr=None,
    rr_uniform_at=None, live=None,
):
    """Trace every lane's path to its end, working at each bounce on the
    lanes still alive only (compacted, so the work and the autograd graph
    grow with the real lane-bounces, not N x max_depth).

    `uniforms_at(bounce, lanes)` gives the (L, UNIFORMS_PER_BOUNCE) shading
    uniforms of the alive lanes `lanes` (indices into the batch);
    `hit_fn(origin, direction, bounce, lanes)` their winner (t (L,) with
    +inf on a miss, prim (L,)). `rr` = (start, lo, hi) turns on
    `roulette` after each bounce, its coins (L,) from
    `rr_uniform_at(bounce, lanes)`. Lanes False in `live` (N,) bool end
    after their first bounce. Returns (radiance (N, 3), tape (max_depth, N)
    int32 or None, segments (N,) int32)."""
    n = origin.shape[0]
    dev = origin.device
    rad = torch.zeros_like(origin)
    tape = torch.full((max_depth, n), -1, dtype=torch.int32, device=dev) if return_tape else None
    segs = torch.zeros(n, dtype=torch.int32, device=dev)
    lanes = torch.arange(n, device=dev)
    o, d = origin, direction
    tp = torch.ones_like(origin)
    for bounce in range(max_depth):
        if lanes.numel() == 0:
            break
        tr.count("bounces")
        tr.count("lanes", lanes.numel())
        segs[lanes] += 1
        t, prim = hit_fn(o, d, bounce, lanes)
        scat = resolve_and_shade(res, num_spheres, t, prim, o, d, uniforms_at(bounce, lanes),
                                 textures)
        if tape is not None:
            tape[bounce, lanes] = torch.where(scat.hit, prim.to(torch.int32), -1)
        # A miss adds the background, a hit its emission (0 but for lights).
        bg = _background(d, background, sky_gradient)
        contrib = torch.where(scat.hit[:, None], tp * scat.emitted, tp * bg)
        rad = rad.index_put((lanes,), rad[lanes] + contrib)
        alive = scat.hit & scat.scattered
        if live is not None and bounce == 0:
            alive = alive & live
        if rr is not None and bounce + 1 >= rr[0]:
            alive, tp_next = roulette(
                tp * scat.attenuation, alive, bounce + 1, rr_uniform_at(bounce, lanes),
                start=rr[0], lo=rr[1], hi=rr[2])
            tp = tp_next[alive]
        else:
            tp = (tp * scat.attenuation)[alive]
        o = scat.point[alive]
        d = scat.direction[alive]
        lanes = lanes[alive]
    return rad, tape, segs


def trace(
    scene,
    origin,
    direction,
    background,
    uniform_seq,
    *,
    max_depth: int = 50,
    sky_gradient: bool = False,
    return_tape: bool = False,
    return_segments: bool = False,
    intersect_fn=None,
    russian_roulette: bool = False,
    rr_start_depth: int = 5,
    rr_max_q: float = 0.95,
    rr_uniform=None,
    stable_spheres: bool = False,
    live=None,
):
    """Trace one path per lane; returns radiance (N, 3), and with
    `return_tape` also the (max_depth, N) int32 winner tape: row b holds the
    primitive lane L hit at bounce b (quads numbered after spheres), -1 for
    a miss or a lane already dead; with `return_segments` also the (N,)
    int32 path segments per lane (last).

    `uniform_seq(bounce, lanes) -> (L, UNIFORMS_PER_BOUNCE)` gives the
    shading uniforms of the alive lanes `lanes` (indices into this batch)
    at `bounce`; for a precomputed (max_depth, N, UNIFORMS_PER_BOUNCE)
    tensor `seq` (ops.ctr_rng.bounce_uniform_seq) pass
    `lambda b, l: seq[b][l]`. Depth exhaustion contributes black.

    `russian_roulette` (off by default) ends paths early without bias: after
    a bounce, a lane that scattered and has taken >= `rr_start_depth`
    bounces continues with probability q = clip(max throughput, 0.05,
    `rr_max_q`), its throughput divided by q (`roulette` above, the
    rule of JAX's `trace` and of its regenerative epilogue). The coins come
    from the caller like the shading uniforms: `rr_uniform(bounce, lanes)
    -> (L,)`, for instance `lambda b, l: ctr_rng.rr_uniforms(seed, l, b,
    max_depth)`, the counter the persistent kernel draws its coins at.

    `intersect_fn(scene, origin, direction, bounce, lanes) -> (t, prim)`
    replaces the closest hit; `lanes` are the alive lanes' indices into
    this batch (a tape replay looks its winners up by them, diff/tape.py).
    The default is the closest-hit kernel's wrapper on detached tables (its
    twin on CPU tensors), which carries no gradient through t: pass
    geometry.intersect.intersect_scene_kernel_diff for the differentiable
    hit. With `stable_spheres` the default hit takes each sphere winner's t
    by the stable quadratic (the kernel's `radius`, ops/intersect_kernel.py:
    refine_sphere_winners), so a grazing hit lies on its sphere. Shading is
    differentiable in the scene; noise and image textures are shaded from
    materials.packed.texture_tables (bilinear scenes with the deterministic
    4-tap filter, the tape kernel's).

    `live` (N,) bool ends the lanes False there after their first bounce
    (their radiance is then that bounce's alone, for the caller to
    discard): rays a caller has no use for drop out with the first bounce's
    compaction, which reads no more back from the card than the loop does."""
    qd = quad_derived(scene)
    sph, quad = pack_sphere_table(scene.sph_center, scene.sph_radius), pack_quad_table(qd)
    res = primitive_table(scene, qd)
    if russian_roulette and rr_uniform is None:
        raise ValueError("russian_roulette needs the coins: pass rr_uniform(bounce, lanes)")
    if intersect_fn is None:
        sph, quad = sph.detach(), quad.detach()
        radius = scene.sph_radius.detach().contiguous() if stable_spheres else None

        def hit_fn(o, d, bounce, lanes):
            return intersect(sph, quad, o.detach().contiguous(), d.detach().contiguous(), radius)
    else:
        def hit_fn(o, d, bounce, lanes):
            return intersect_fn(scene, o, d, bounce, lanes)

    rad, tape, segs = _trace_loop(
        res, scene.num_spheres, origin, direction, background, uniform_seq, hit_fn,
        max_depth=max_depth, sky_gradient=sky_gradient, return_tape=return_tape,
        textures=texture_tables(scene, qd),
        rr=(rr_start_depth, 0.05, rr_max_q) if russian_roulette else None,
        rr_uniform_at=rr_uniform, live=live,
    )
    out = (rad,) + ((tape,) if return_tape else ()) + ((segs,) if return_segments else ())
    return out if len(out) > 1 else rad


def trace_tape_plain(
    sph_table, quad_table, res_table, cam_scalars, seed: int, n: int, *,
    width: int, height: int, max_depth: int, sky_gradient: bool, textures=None,
):
    """Plain twin of the tape kernel: lane L traces global sample L at pixel
    L mod (width*height), its camera ray and shading drawn from the counter
    RNG, with `trace`'s estimator (no russian roulette; `textures` as
    materials.packed.texture_tables, whose image filter is deterministic).
    Returns (radiance (3, n) float32, tape (max_depth, n) int32, segments
    (n,) int32)."""
    o, d = tape_lane_rays(pk.frame_from_scalars(cam_scalars), seed, n, width=width,
                          height=height)
    rad, tape, segs = _trace_loop(
        res_table, sph_table.shape[0], o, d, cam_scalars[pk.CAM_BG : pk.CAM_BG + 3],
        tape_uniforms(seed),
        lambda o, d, bounce, lanes: intersect_plain(sph_table, quad_table, o, d),
        max_depth=max_depth, sky_gradient=sky_gradient, return_tape=True, textures=textures,
    )
    return rad.T.contiguous(), tape, segs


def tape_lane_rays(frame, seed: int, n: int, *, width: int, height: int):
    """The camera rays (origin, direction), each (n, 3), of a tape
    forward's lanes on the frame's device: lane L is global sample L at
    pixel L mod (width*height), its lens and pixel jitter from
    ctr_rng.camera_uniforms (the layout of kernel 3 and of
    diff.grad.render_linear_diff)."""
    sid = torch.arange(n, dtype=torch.int64, device=frame.center.device)
    pix = sid % (width * height)
    return camera_rays(frame, pix % width, pix // width, ctr_rng.camera_uniforms(seed, sid))


def tape_uniforms(seed: int):
    """`uniform_seq` of a tape forward's lanes: the lanes' own sample ids
    keyed at each bounce (ctr_rng.bounce_uniforms)."""
    return lambda bounce, lanes: ctr_rng.bounce_uniforms(seed, lanes, bounce)


def trace_tape_scene(scene, cam_frame, background, seed: int, n: int, *, width: int,
                     height: int, max_depth: int, sky_gradient: bool):
    """The tape forward of scenes kernel 3 does not shade (noise from
    rng-filled Perlin tables; ops.persistent_kernel.unsupported_reason):
    `trace(return_tape=True)` of tape_lane_rays' lanes with tape_uniforms,
    no russian roulette, on the scene's device. The closest hit is
    `trace`'s default (kernel 1 on CUDA tensors, its twin on CPU tensors),
    the shading materials.packed.texture_tables'. The port's counterpart of
    JAX's XLA tape forward (raytracer_tpu/diff/tape.py:trace_tape); on a
    scene kernel 3 serves it equals trace_tape_plain bit for bit. Returns
    (radiance (n, 3), tape (max_depth, n) int32) in kernel 3's layout:
    quads numbered after spheres, -1 for a miss or a dead lane."""
    dev = scene.sph_center.device
    o, d = tape_lane_rays(cam_frame.to(dev), seed, n, width=width, height=height)
    return trace(scene, o, d, background, tape_uniforms(seed), max_depth=max_depth,
                 sky_gradient=sky_gradient, return_tape=True)


def regen_jump(n: int, n_pixels: int) -> int:
    """Per-regeneration pixel advance of the strided schedule: n mod
    n_pixels, so contiguous global sample ids sweep pixels and every pixel
    gets exactly spp samples; a golden-ratio stride when that is zero (any
    advance is exact then, and a zero advance would bind lanes to pixels)."""
    j = n % n_pixels
    if j == 0 and n_pixels > 1:
        j = max(1, int(0.6180339887 * n_pixels)) % n_pixels or 1
    return j


def strided_schedule(n_pixels: int, spp: int, wavefront_size: int):
    """(n, num_slots, jump): lane L owns sample ids L, L+n, L+2n, ... below
    n_pixels*spp; num_slots is the most samples any lane owns. No tile
    rounding: the kernel masks its ragged edge."""
    total = n_pixels * spp
    n = max(1, min(wavefront_size, total))
    num_slots = -(-total // n)
    return n, num_slots, regen_jump(n, n_pixels)


def schedule_arrays(n: int, n_pixels: int, spp: int, width: int, device="cpu"):
    """Per-lane samples owed and first pixel (column, row), int32 (N,)."""
    total = n_pixels * spp
    lane = torch.arange(n, dtype=torch.int64, device=device)
    remaining = torch.clamp((total - lane + n - 1) // n, min=0)
    pix = lane % n_pixels
    as32 = lambda x: x.to(torch.int32)  # noqa: E731
    return as32(remaining), as32(pix % width), as32(pix // width)


class TextureWork(NamedTuple):
    """Kernel 2's texture evaluations (marbles, image lookups), counted by
    regen_plain(return_texture_work=True): per lane, and per warp of 32
    consecutive lanes under two schedules of its loop. A warp evaluates a
    kind in an iteration when any of its lanes does, so its warp-union
    count is the (warp, iteration) pairs where one lane did. Under
    `one_segment` iteration i traces each lane's i-th segment (the kernel's
    loop); under `retrace` a lane whose segment misses retires and traces
    its next path in the same iteration, so iteration j shades each lane's
    j-th hit (a loop of the dense textured instantiations measured and not
    kept: PERF.md, section 6)."""

    per_lane: torch.Tensor  # (2, N) int32: marbles, image lookups of each lane
    one_segment: torch.Tensor  # (2,) int64 warp-union marbles, image lookups
    retrace: torch.Tensor  # (2,) int64 the same under the retrace schedule
    # (2,) int64 closest hits a warp runs (each iteration as many as its
    # lane tracing the most segments in it), one_segment and retrace.
    warp_trips: torch.Tensor

    def simt_efficiency(self, schedule: str) -> list[float]:
        """Per kind: evaluations over WARP x warp-union evaluations (1 when
        every lane of every evaluating warp evaluates; NaN for none)."""
        union = getattr(self, schedule).double() * WARP
        return (self.per_lane.sum(dim=1).double().cpu() / union.cpu()).tolist()


class _TextureCounter:
    """regen_plain's count of TextureWork, fed each iteration's winners."""

    def __init__(self, textures, n: int, max_iters: int, dev):
        from raytracer_tpu_torch.geometry.scene import TEX_IMAGE, TEX_NOISE
        from raytracer_tpu_torch.materials.packed import TCOL_TYPE

        ttype = textures.rows[:, TCOL_TYPE].to(torch.int64)
        self.kinds = torch.stack([ttype == TEX_NOISE, ttype == TEX_IMAGE])  # (2, P)
        self.per_lane = torch.zeros(2, n, dtype=torch.int64, device=dev)
        self.hits = torch.zeros(n, dtype=torch.int64, device=dev)
        self.one_segment = torch.zeros(2, dtype=torch.int64, device=dev)
        # (kind, warp, hit index) pairs any lane evaluated, for `retrace`.
        self.seen = torch.zeros(2, -(-n // WARP), max_iters, dtype=torch.bool, device=dev)
        # Segments of each lane since its last hit, and per (warp, retrace
        # iteration) the most any lane traced in it.
        self.run = torch.zeros(n, dtype=torch.int64, device=dev)
        self.trips = torch.zeros(-(-n // WARP) * max_iters, dtype=torch.int64, device=dev)
        self.max_iters = max_iters

    def _close_runs(self, lanes):
        key = (lanes // WARP) * self.max_iters + self.hits[lanes]
        self.trips.scatter_reduce_(0, key, self.run[lanes], "amax")
        self.run[lanes] = 0

    def add(self, a, t, prim):
        hit = torch.isfinite(t)
        lanes, p = a[hit], prim[hit].long()
        warp, j = lanes // WARP, self.hits[lanes]
        for k in range(2):
            m = self.kinds[k, p]
            self.per_lane[k].index_add_(0, lanes[m], torch.ones_like(lanes[m]))
            self.one_segment[k] += torch.unique(warp[m]).numel()
            self.seen[k, warp[m], j[m]] = True
        self.run[a] += 1
        self._close_runs(lanes)
        self.hits[lanes] += 1

    def result(self, segs) -> TextureWork:
        self._close_runs(torch.nonzero(self.run).squeeze(1))  # each lane's last misses
        n = segs.shape[0]
        per_warp = torch.nn.functional.pad(segs.long(), (0, -n % WARP)).reshape(-1, WARP)
        trips = torch.stack([per_warp.max(dim=1).values.sum(), self.trips.sum()])
        return TextureWork(self.per_lane.to(torch.int32), self.one_segment,
                           self.seen.sum(dim=(1, 2)), trips)


def regen_plain(
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
    max_depth: int,
    rr_start: int,
    rr_lo: float,
    rr_hi: float,
    sky_gradient: bool,
    max_iters: int,
    textures=None,
    clusters=None,
    return_work: bool = False,
    return_texture_work: bool = False,
):
    """Plain twin of the persistent kernel: the same per-lane semantics
    (strided regeneration, camera ray, closest hit, shade, depth budget,
    russian roulette, retirement into (3, K, N)), run lock-step over the
    lanes that have a path in flight. `textures` is
    materials.packed.texture_tables (None without noise or image textures);
    the stochastic bilinear tap draws its uniforms at ops.ctr_rng.tap_ctr.
    `clusters` (ops.persistent_kernel.ClusterTable) gives the culled
    instantiation's closest hit (ClusterVisit). Returns (log, segments per
    lane) and, with `return_work` (clusters only), (6, N) int32 per-lane
    counts of the cluster slab tests, sphere tests and quad tests that the
    kernel's per-lane culling makes (the TPU kernel's clusters_entered, per
    lane; the work of its bound) and of the roots, divisions and in-quad
    tests among them, and (7,) int64 warp-union counts: those six counts
    over the union of what the lanes of each kernel warp (32 consecutive
    lanes) run in each iteration, and the (warp, iteration) steps with a
    lane in flight (ClusterVisit.hit_work)."""
    if return_work and clusters is None:
        raise ValueError("return_work counts the culled loops: pass clusters")
    dev = rem0.device
    n = rem0.shape[0]
    ns = sph_table.shape[0]
    frame = pk.frame_from_scalars(cam_scalars)
    bg = cam_scalars[pk.CAM_BG : pk.CAM_BG + 3]
    lane_ids = torch.arange(n, dtype=torch.int64, device=dev)
    j3 = torch.arange(ctr_rng.UNIFORMS_PER_BOUNCE, dtype=torch.int64, device=dev)
    stochastic = textures is not None and textures.image_filter == FILTER_STOCHASTIC

    rem = rem0.to(torch.int64)
    px = px0.to(torch.int64)
    py = py0.to(torch.int64)
    sk = torch.full((n,), -1, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    origin = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    direction = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    tp = torch.ones(n, 3, dtype=torch.float32, device=dev)
    rad = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    log = torch.zeros(3, num_slots, n, dtype=torch.float32, device=dev)
    segs = torch.zeros(n, dtype=torch.int32, device=dev)
    work = torch.zeros(WORK_ROWS, n, dtype=torch.int64, device=dev) if return_work else None
    warp_work = torch.zeros(WORK_ROWS + 1, dtype=torch.int64, device=dev) if return_work else None
    visit = None if clusters is None else ClusterVisit.build(clusters, sph_table, quad_table)
    tex_count = _TextureCounter(textures, n, max_iters, dev) if return_texture_work else None

    for _ in range(max_iters):
        # ---- regeneration: idle lanes owing samples start their next one ----
        g = torch.nonzero(~active & (rem > 0)).squeeze(1)
        if g.numel():
            px[g], py[g] = advance_pixels(px[g], py[g], sk[g] < 0, width=width, height=height,
                                          jump_px=jump_px, jump_py=jump_py)
            sk[g] += 1
            rem[g] -= 1
            sid = lane_ids[g] + sk[g] * n
            o_g, d_g = camera_rays(frame, px[g], py[g], ctr_rng.camera_uniforms(seed, sid))
            origin[g] = o_g
            direction[g] = d_g
            tp[g] = 1.0
            rad[g] = 0.0
            depth[g] = 0
            active[g] = True
        a = torch.nonzero(active).squeeze(1)
        if a.numel() == 0:
            break
        segs[a] += 1

        # ---- one bounce ----
        o, d, sk_a = origin[a], direction[a], sk[a]
        sid = lane_ids[a] + sk_a * n
        bounce = depth[a]
        if return_work:
            t, prim, w, ww = visit.hit_work(o, d, warp=a // WARP)
            work[:, a] += w
            warp_work += ww
        elif visit is not None:
            t, prim = visit.hit(o, d)
        else:
            t, prim = intersect_plain(sph_table, quad_table, o, d)
        if tex_count is not None:
            tex_count.add(a, t, prim)
        uni = ctr_rng.uniform(seed, sid[:, None], ctr_rng.shading_ctr(bounce[:, None], j3))
        rru = ctr_rng.uniform(seed, sid, ctr_rng.rr_ctr(bounce, max_depth))
        tap = None
        if stochastic:
            tap = ctr_rng.uniform(seed, sid[:, None],
                                  ctr_rng.tap_ctr(bounce[:, None], max_depth, j3[:2]))
        _bounce_and_retire(
            res_table, ns, textures, bg, a, sk_a, t, prim, uni, rru,
            (origin, direction, tp, rad, depth, active, log), max_depth=max_depth,
            rr_start=rr_start, rr_lo=rr_lo, rr_hi=rr_hi, sky_gradient=sky_gradient, tap=tap,
        )
    out = (log, segs) + ((work.to(torch.int32), warp_work) if return_work else ())
    return out + ((tex_count.result(segs),) if return_texture_work else ())


def _bounce_and_retire(
    res_table, ns, textures, bg, a, sk_a, t, prim, uni, rru, state, *,
    max_depth, rr_start, rr_lo, rr_hi, sky_gradient, tap=None,
):
    """One bounce of the lanes `a` in flight from their winners (t, prim),
    shading uniforms `uni` (L, 3), russian-roulette coins `rru` (L,) and,
    for the stochastic bilinear filter, tap uniforms `tap` (L, 2):
    shade, background or emission, depth budget, russian roulette; then
    the state tensors (origin, direction, throughput, radiance, depth,
    active, log) are updated in place and finished paths retire into
    log[:, slot, lane]. The bounce epilogue of regen_plain and of the
    wavefront-step path (raytracer_tpu/integrator/wavefront.py:
    _regen_bounce_epilogue), so both realise one estimator."""
    origin, direction, tp, rad, depth, active, log = state
    o, d, tp_a, rad_a = origin[a], direction[a], tp[a], rad[a]
    bounce = depth[a]
    scat = resolve_and_shade(res_table, ns, t, prim, o, d, uni, textures, tap)
    miss = ~scat.hit
    rad_a = rad_a + torch.where(miss[:, None], tp_a * _background(d, bg, sky_gradient), 0.0)
    rad_a = rad_a + torch.where(scat.hit[:, None], tp_a * scat.emitted, 0.0)
    depth_a = bounce + 1
    survives = scat.hit & scat.scattered & (depth_a < max_depth)
    tp_a = torch.where(survives[:, None], tp_a * scat.attenuation, tp_a)
    rr_on = survives & (depth_a >= rr_start)
    q = torch.clamp(tp_a.max(dim=1).values, min=rr_lo, max=rr_hi)
    survives = survives & (~rr_on | (rru < q))
    tp_a = torch.where((rr_on & survives)[:, None], tp_a * (1.0 / q)[:, None], tp_a)

    origin[a] = torch.where(survives[:, None], scat.point, o)
    direction[a] = torch.where(survives[:, None], scat.direction, d)
    tp[a] = tp_a
    rad[a] = rad_a
    depth[a] = depth_a.to(depth.dtype)
    active[a] = survives

    # ---- retire finished paths into their (slot, lane) cells ----
    fin = ~survives
    log[:, sk_a[fin].long(), a[fin]] = rad_a[fin].T


def _fold_group(num_slots: int, n: int, n_pixels: int) -> int:
    """Slots `_fold_log` pads and chunk-sums at once when n > n_pixels: as
    many as keep the padded group and its chunk sums within
    FOLD_SCRATCH_BYTES, at least one."""
    chunks = -(-n // n_pixels)
    return max(1, min(num_slots, FOLD_SCRATCH_BYTES // (12 * n_pixels * (chunks + 1))))


def fold_scratch_bytes(num_slots: int, n: int, n_pixels: int) -> int:
    """Device bytes `_fold_log` allocates beside the log and the
    framebuffer: none when n <= n_pixels, else one group's padded slots and
    their chunk sums, and one rolled slot."""
    if n <= n_pixels:
        return 0
    chunks = -(-n // n_pixels)
    return 12 * n_pixels * ((chunks + 1) * _fold_group(num_slots, n, n_pixels) + 1)


def _add_wrapped(fb, src, off: int):
    """fb[(off + i) mod P] += src[:, i] for every column i of the (3, m)
    `src`, m <= P = fb's rows: one run of pixels, or two where it wraps."""
    m = src.shape[1]
    a = min(m, fb.shape[0] - off)
    fb[off : off + a].add_(src[:, :a].T)
    if a < m:
        fb[: m - a].add_(src[:, a:].T)


def _fold_log(log, num_slots: int, n: int, n_pixels: int, jump: int):
    """Fold the (3, K, N) retirement log into the (n_pixels, 3) framebuffer:
    slot k of lane L is pixel (L + k*jump) mod n_pixels. With N <= n_pixels
    each slot's lanes land on one run of pixels (two where it wraps) and
    are added there in place. With more lanes than pixels the lanes are
    first chunk-summed modulo n_pixels, a group of slots at a time
    (`_fold_group`: the group padded to whole chunks), and each slot's sum
    is rolled into place (one roll and one add a slot: most slots wrap).
    Each pixel takes its slots in ascending k, each slot's chunk sum over
    the same axis as a whole-log sum, so the framebuffer is that of
    padding the whole log, summing its chunks and rolling each slot into
    place, bit for bit, in FOLD_SCRATCH_BYTES and one slot of scratch
    (`fold_scratch_bytes`)."""
    fb = torch.zeros(n_pixels, 3, dtype=log.dtype, device=log.device)
    if n <= n_pixels:
        for k in range(num_slots):
            _add_wrapped(fb, log[:, k, :], (k * jump) % n_pixels)
        return fb
    chunks = -(-n // n_pixels)
    group = _fold_group(num_slots, n, n_pixels)
    for k0 in range(0, num_slots, group):
        k1 = min(num_slots, k0 + group)
        padded = torch.nn.functional.pad(log[:, k0:k1, :], (0, chunks * n_pixels - n))
        per_slot = padded.reshape(3, k1 - k0, chunks, n_pixels).sum(dim=2)  # (3, G, P)
        del padded
        for k in range(k0, k1):
            fb.add_(torch.roll(per_slot[:, k - k0, :].T, (k * jump) % n_pixels, dims=0))
        del per_slot  # before the next group's pad, so one group is live at a time
    return fb


def render_wavefront_regen(
    sph_table,
    quad_table,
    res_table,
    cam_scalars,
    seed: int,
    *,
    width: int,
    height: int,
    spp: int,
    wavefront_size: int,
    max_depth: int = 50,
    sky_gradient: bool = False,
    textures=None,
    clusters=None,
):
    """Render spp samples per pixel with path regeneration: a fixed set of
    lanes, each starting its next strided sample as soon as its path ends.
    Tables are on the render device (CUDA runs the kernel, CPU its twin);
    `textures` is materials.packed.texture_tables (None without noise or
    image textures); `clusters` an ops.persistent_kernel.ClusterTable for
    tables packed from a clustered scene (None: dense loops). Russian
    roulette takes render_persistent's defaults. Returns (framebuffer
    (n_pixels, 3) radiance sums, segments (N,) int32)."""
    n_pixels = width * height
    n, num_slots, jump = strided_schedule(n_pixels, spp, wavefront_size)
    with tr.span("render/kernel"):
        rem0, px0, py0 = schedule_arrays(n, n_pixels, spp, width, device=sph_table.device)
        log, segs = pk.render_persistent(
            sph_table, quad_table, res_table, cam_scalars, seed, rem0, px0, py0,
            width=width, height=height, jump_px=jump % width, jump_py=jump // width,
            num_slots=num_slots, max_depth=max_depth, sky_gradient=sky_gradient,
            textures=textures, clusters=clusters,
        )
    with tr.span("render/fold"):
        return _fold_log(log, num_slots, n, n_pixels, jump), segs


def wavefront_step_loop(
    sph_table,
    quad_table,
    res_table,
    textures,
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
    max_depth: int,
    rr_start: int,
    rr_lo: float,
    rr_hi: float,
    sky_gradient: bool,
    max_iters: int,
):
    """The wavefront-step path's loop (port of regen_core's `body_mk` with
    `_regen_bounce_epilogue`, raytracer_tpu/integrator/wavefront.py:708-866):
    per iteration, kernel 5 (ops/wavefront_kernel.py:wavefront_step)
    regenerates idle lanes, traces the camera ray and finds every lane's
    closest hit with its draws; the lanes in flight are then shaded and
    retired in PyTorch (`_bounce_and_retire`, regen_plain's epilogue, with
    the texture table for noise and image textures; its image filter must
    be deterministic: kernel 5 draws no tap uniforms). The loop ends when
    no lane has a path in flight after regeneration: one host sync per
    iteration. Arguments as regen_plain's, plus `textures`
    (materials.packed.texture_tables, or None). Returns (log (3, K, N),
    segments per lane (N,) int32, iterations)."""
    dev = rem0.device
    n = rem0.shape[0]
    ns = sph_table.shape[0]
    bg = cam_scalars[pk.CAM_BG : pk.CAM_BG + 3]
    rem, px, py = rem0, px0, py0
    sk = torch.full((n,), -1, dtype=torch.int32, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    origin = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    direction = torch.ones(n, 3, dtype=torch.float32, device=dev)
    tp = torch.ones(n, 3, dtype=torch.float32, device=dev)
    rad = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    log = torch.zeros(3, num_slots, n, dtype=torch.float32, device=dev)
    segs = torch.zeros(n, dtype=torch.int32, device=dev)
    iters = 0
    for _ in range(max_iters):
        out = wavefront_step(
            sph_table, quad_table, cam_scalars, seed, origin, direction, active, rem, px, py,
            sk, depth, width=width, height=height, jump_px=jump_px, jump_py=jump_py,
            max_depth=max_depth,
        )
        origin, direction = out.origin, out.direction
        rem, px, py, sk = out.remaining, out.px, out.py, out.sample_k
        tp.masked_fill_(out.grant[:, None], 1.0)
        rad.masked_fill_(out.grant[:, None], 0.0)
        depth.masked_fill_(out.grant, 0)
        active = active | out.grant
        a = torch.nonzero(active).squeeze(1)
        if a.numel() == 0:
            break
        iters += 1
        segs[a] += 1
        uni = out.uniforms[a]
        _bounce_and_retire(
            res_table, ns, textures, bg, a, sk[a], out.t[a], out.prim[a], uni[:, :3], uni[:, 3],
            (origin, direction, tp, rad, depth, active, log), max_depth=max_depth,
            rr_start=rr_start, rr_lo=rr_lo, rr_hi=rr_hi, sky_gradient=sky_gradient,
        )
    return log, segs, iters


def render_wavefront_step(
    sph_table,
    quad_table,
    res_table,
    textures,
    cam_scalars,
    seed: int,
    *,
    width: int,
    height: int,
    spp: int,
    wavefront_size: int,
    max_depth: int = 50,
    sky_gradient: bool = False,
):
    """Render spp samples per pixel through the wavefront-step path, for
    scenes the persistent kernel does not serve. Russian roulette starts at
    depth 5 with survival capped at STEP_RR_HI. Returns (framebuffer
    (n_pixels, 3) radiance sums, segments (N,) int32, iterations)."""
    n_pixels = width * height
    n, num_slots, jump = strided_schedule(n_pixels, spp, wavefront_size)
    with tr.span("render/kernel"):
        rem0, px0, py0 = schedule_arrays(n, n_pixels, spp, width, device=sph_table.device)
        log, segs, iters = wavefront_step_loop(
            sph_table, quad_table, res_table, textures, cam_scalars, seed, rem0, px0, py0,
            width=width, height=height, jump_px=jump % width, jump_py=jump // width,
            num_slots=num_slots, max_depth=max_depth, rr_start=5, rr_lo=0.05,
            rr_hi=STEP_RR_HI, sky_gradient=sky_gradient,
            max_iters=pk.max_iters_for(num_slots, max_depth),
        )
    with tr.span("render/fold"):
        return _fold_log(log, num_slots, n, n_pixels, jump), segs, iters
