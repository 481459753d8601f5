"""Structured render metrics (port of raytracer_tpu/utils/metrics.py, without
the jax profiler hooks).

The driver updates `done_spp` per chunk and adds traced-segment counts once
at the end of the render (one device sync). `warp_slots` is the SIMT
occupancy basis of the persistent CUDA kernel: a warp of 32 lanes runs until
its busiest lane drains, so occupancy = segments / (sum over warps of the
busiest lane's segments * 32). The wavefront-step and large-scene paths
count loop `iterations` instead (kernel-5 steps; bounces of every pass),
and the large-scene path its `passes`; their lane occupancy is segments /
(iterations * wavefront_lanes). A render of a clustered scene records the
host seconds its clustering took (`cluster_s`, ~0 when cached), the BVH
builder ("native" or "numpy") and the cluster table's section lengths
[sphere supers, sphere fine, quad supers, quad fine].
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

WARP = 32


@dataclass
class RenderMetrics:
    total_spp: int
    pixels: int
    wavefront_lanes: int = 0  # lanes of the regenerative wavefront
    retirement_log_mb: float = 0.0  # (3, K, N) f32 log per chunk
    start_time: float = field(default_factory=time.perf_counter)
    done_spp: int = 0
    traced_segments: int = 0
    warp_slots: int = 0
    iterations: int = 0
    passes: int = 0
    cluster_s: float = 0.0
    bvh_builder: str = ""
    cluster_rows: list = field(default_factory=list)

    def update(self, spp_done: int, segments: int = 0, warp_slots: int = 0,
               iterations: int = 0, passes: int = 0):
        self.done_spp = spp_done
        self.traced_segments += int(segments)
        self.warp_slots += int(warp_slots)
        self.iterations += int(iterations)
        self.passes += int(passes)

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start_time

    def snapshot(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        out = {
            "spp": f"{self.done_spp}/{self.total_spp}",
            "wall_s": dt,
            "camera_mrays_per_s": self.pixels * self.done_spp / dt / 1e6,
        }
        if self.traced_segments:
            out["traced_segments"] = self.traced_segments
            out["traced_mrays_per_s"] = self.traced_segments / dt / 1e6
        if self.warp_slots:
            out["warp_occupancy"] = self.traced_segments / self.warp_slots
        if self.iterations:
            out["iterations"] = self.iterations
            if self.wavefront_lanes:
                out["lane_occupancy"] = self.traced_segments / (
                    self.iterations * self.wavefront_lanes
                )
        if self.passes:
            out["passes"] = self.passes
        if self.wavefront_lanes:
            out["wavefront_lanes"] = self.wavefront_lanes
        if self.retirement_log_mb:
            out["retirement_log_mb"] = self.retirement_log_mb
        if self.bvh_builder:
            out["cluster_s"] = self.cluster_s
            out["bvh_builder"] = self.bvh_builder
            out["cluster_rows"] = self.cluster_rows
        return out


def warp_slots(segments) -> int:
    """Lane-iterations a SIMT machine spends on per-lane segment counts
    `segments` (N,): each group of 32 consecutive lanes costs 32 times its
    largest count."""
    n = segments.shape[0]
    pad = (-n) % WARP
    s = torch.nn.functional.pad(segments.to(torch.int64), (0, pad))
    return int(s.reshape(-1, WARP).max(dim=1).values.sum()) * WARP
