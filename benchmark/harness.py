"""What every job shares: the cell and its configuration, read by name from
their files; seeds; the scene handed to the program; the run's context and
result; the card's identity.

A cell `<cell>` is `workloads/<cell>.json`: its configuration's name
(`config`), its job (`job`, a module of `jobs/`), its traffic
(`traffic`), its correctness check (`check`: sizes and limits), its traced
stretch (`trace`) and the small shapes of a run on the CPU (`cpu`). A
configuration `<config>` is `configs/<config>.json`: the scene, the camera
and the render settings as published, and the work constants the
per-layer metrics read.
"""

from __future__ import annotations

import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from benchmark.scenes import describe, image_size

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return read_json(REPO / "BENCHMARK.json")


@dataclass
class Cell:
    """A cell's files, with the CPU run's shapes applied when `cpu`."""

    name: str
    workload: dict
    config: dict
    cpu: bool = False

    @classmethod
    def load(cls, name: str, cpu: bool = False) -> "Cell":
        workload = read_json(ROOT / "workloads" / f"{name}.json")
        config = read_json(ROOT / "configs" / f"{workload['config']}.json")
        return cls(name, workload, config, cpu)

    def _small(self, key: str, default):
        return self.workload.get("cpu", {}).get(key, default) if self.cpu else default

    @property
    def camera(self) -> dict:
        return {**self.config["camera"], "width": self._small("width",
                                                               self.config["camera"]["width"])}

    @property
    def size(self) -> tuple[int, int]:
        return image_size(self.camera)

    @property
    def spp(self) -> int:
        return self._small("spp", self.workload["traffic"].get("spp", self.config["render"]["spp"]))

    @property
    def max_depth(self) -> int:
        return self._small("max_depth", self.workload["traffic"].get(
            "max_depth", self.config["render"]["max_depth"]))

    @property
    def check(self) -> dict:
        return {**self.workload["check"], **self.workload.get("cpu", {}).get("check", {})} \
            if self.cpu else self.workload["check"]

    @property
    def trace_items(self) -> int:
        return self._small("trace_items", self.workload["trace"]["items"])

    def description(self):
        return describe(self.config["scene"])


def seed_stream(seed: int, stream: int) -> np.random.Generator:
    """A generator of stream `stream` of the run seed `seed` (any whole
    number, however large)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def int_seeds(seed: int, stream: int, n: int) -> list[int]:
    """`n` seeds below 2^31 drawn from stream `stream` of `seed`."""
    return [int(x) for x in seed_stream(seed, stream).integers(0, 2**31 - 1, n)]


def port_scene(desc):
    """The description given to the program through its SceneBuilder:
    textures, materials, spheres and quads added in the description's
    order, so the program numbers them alike."""
    from raytracer_tpu_torch.geometry.scene import SceneBuilder

    b = SceneBuilder(0)
    for kind, c0, c1, scale in desc.textures:
        b.checker(scale, c0, c1) if kind == "checker" else b.solid_color(*c0)
    for kind, albedo, fuzz, ior, tex in desc.materials:
        if kind == "lambertian":
            b.lambertian(tex)
        elif kind == "light":
            b.diffuse_light(tex)
        elif kind == "metal":
            b.metal(albedo, fuzz)
        else:
            b.dielectric(ior)
    for center, radius, mat in desc.spheres:
        b.add_sphere(center, radius, mat)
    for q, u, v, mat in desc.quads:
        b.add_quad(q, u, v, mat)
    return b.build()


def port_camera(camera: dict, spp: int, max_depth: int):
    """(Camera, RenderSettings) of a camera entry, by the program's
    make_camera."""
    from raytracer_tpu_torch.core.camera import make_camera

    return make_camera(
        camera["aspect"], camera["width"], samples_per_pixel=spp, max_depth=max_depth,
        fov_degrees=camera["fov_degrees"], look_from=tuple(camera["look_from"]),
        look_at=tuple(camera["look_at"]), vup=tuple(camera["vup"]),
        defocus_angle_degrees=camera["defocus_angle_degrees"],
        focus_dist=camera["focus_dist"], background=tuple(camera["background"]),
        sky_gradient=camera.get("sky_gradient", False))


@dataclass
class Context:
    """One run: its cell, seed, window, device and the clock of its
    set-up."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    start: float  # perf_counter at process start
    setup_parts: dict = field(default_factory=dict)
    setup_s: float = float("nan")  # process start to the first timed item
    memory_peak: int = 0  # bytes, read when the window closes

    def close_window(self) -> None:
        """Read the device's memory peak, before anything else runs."""
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def part(self, name: str, t0: float) -> float:
        """Record set-up part `name` as the seconds since `t0`; returns now."""
        now = time.perf_counter()
        self.setup_parts[name] = now - t0
        return now

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()


@dataclass
class Check:
    """One number compared, its limit, and which side of it is sound."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Result:
    """What a job's run hands back to `run.py`."""

    attempted: int
    failed: int
    end_to_end: dict = field(default_factory=dict)  # name -> value
    record: object = None  # profiling.TraceRecord of a traced run
    checks: list = field(default_factory=list)
    look: dict = field(default_factory=dict)  # readings printed beside the checks


def card() -> str:
    """The first card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    return out.splitlines()[0] if out else "unavailable"
