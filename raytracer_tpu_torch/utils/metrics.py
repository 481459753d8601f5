"""Structured render metrics, device-memory statistics and the profiler
trace (port of raytracer_tpu/utils/metrics.py).

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

`device_memory_stats`, `save_memory_profile` and `profiler_trace` serve the
CLI's report, `--memory-profile` and `--profile`: the CUDA caching
allocator's counters and live blocks stand where the JAX package reads the
runtime's memory statistics and its live arrays. `card_identity` names the
card and its power limit beside a measurement (bench.py,
scripts/check_persistent.py).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
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


def _cuda_device(device):
    """`device` as a torch.device when it is a CUDA device (None: the
    current one, when a card is present), else None."""
    if device is None:
        return torch.device("cuda") if torch.cuda.is_available() else None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def device_memory_stats(device=None) -> dict:
    """Device memory of the render's `device` (default: the current CUDA
    device) in MiB: the peak the allocator reached (`peak_hbm_mb`), what
    it holds now (`hbm_in_use_mb`), the card's total (`hbm_limit_mb`) and
    the bytes of its live blocks (`live_buffers_mb`). {} on the CPU."""
    dev = _cuda_device(device)
    if dev is None:
        return {}
    _, total = torch.cuda.mem_get_info(dev)
    live = torch.cuda.memory_stats(dev).get("active_bytes.all.current", 0)
    return {
        "peak_hbm_mb": torch.cuda.max_memory_allocated(dev) / 2**20,
        "hbm_in_use_mb": torch.cuda.memory_allocated(dev) / 2**20,
        "hbm_limit_mb": total / 2**20,
        "live_buffers_mb": live / 2**20,
    }


def card_identity(device) -> dict:
    """{"name", "power_limit_w", "nvidia_smi"} of the render's `device`:
    torch's name for the card and its power limit in watts, parsed from
    the line `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints for the first card (also returned whole). A card's limit may be
    set below its maximum, and it then runs slower under load. On CUDA a
    missing `nvidia-smi` or an unreadable limit raises; on the CPU the name
    is "cpu" and the limit None."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    limit = smi.rsplit(",", 1)[1].strip()
    if not limit.endswith(" W"):
        raise ValueError(f"unreadable power limit in nvidia-smi's {smi!r}")
    return {"name": torch.cuda.get_device_name(dev), "power_limit_w": float(limit[:-2]),
            "nvidia_smi": smi}


def save_memory_profile(path: str, device=None) -> bool:
    """Write a JSON device-memory report of `device`: the caching
    allocator's live blocks (`torch.cuda.memory_snapshot`), largest first
    (at most 200), their total, the card's name and device_memory_stats.
    Returns False, writing nothing, when `device` is not a CUDA device."""
    dev = _cuda_device(device)
    if dev is None:
        return False
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks = [
        {"mb": b["size"] / 2**20, "segment_type": seg.get("segment_type"),
         "stream": seg.get("stream")}
        for seg in torch.cuda.memory_snapshot()
        if seg["device"] == index
        for b in seg["blocks"]
        if b["state"] == "active_allocated"
    ]
    blocks.sort(key=lambda b: -b["mb"])
    report = {
        "total_mb": sum(b["mb"] for b in blocks),
        "num_blocks": len(blocks),
        "device": torch.cuda.get_device_name(dev),
        "blocks": blocks[:200],
        **device_memory_stats(dev),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return True


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Profile the block with torch.profiler (CPU activity, and CUDA
    activity when a card is present), with utils/trace.py's recorder on so
    that the program's spans (`render_image`, `render/pack`, `render/fold`,
    ...) lie on the trace's timeline, and write its Chrome trace to
    `log_dir`/trace_<pid>_<time>.json on exit; a no-op when `log_dir` is
    None. Open the trace in Perfetto or chrome://tracing."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.utils import trace

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace.enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        trace.disable()
        trace.collect()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
