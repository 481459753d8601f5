"""Launch counts of the port's CUDA kernels, under the kernel names of
chip_smoke.py's `kernels` line.

Each kernel's wrapper adds one to its module's counter where it launches
the kernel, and nowhere else: a call that takes the plain twin (a CPU
tensor) counts nothing. `reset` zeroes every counter and `read` returns
them, so a caller brackets the run it counts:

    launches.reset()
    run()
    counts = launches.read()

An edge term's backward runs on autograd's CUDA thread; the counters are
module attributes, so its launches count too.
"""

from __future__ import annotations

from raytracer_tpu_torch.ops import (
    culled_kernel,
    edge_path_kernel,
    gather_kernel,
    intersect_kernel,
    persistent_kernel,
    replay_kernel,
    wavefront_kernel,
)

# (kernel name, module, counter attribute)
COUNTERS = (
    ("closest_hit", intersect_kernel, "LAUNCHES"),
    ("closest_hit_clustered", intersect_kernel, "LAUNCHES_CLUSTERED"),
    ("persistent_render", persistent_kernel, "LAUNCHES"),
    ("persistent_tape", persistent_kernel, "LAUNCHES_TAPE"),
    ("culled_closest_hit", culled_kernel, "LAUNCHES"),
    ("wavefront_step", wavefront_kernel, "LAUNCHES"),
    ("table_gather", gather_kernel, "LAUNCHES"),
    ("replay_path", replay_kernel, "LAUNCHES"),
    ("replay_adjoint", replay_kernel, "LAUNCHES_ADJOINT"),
    ("edge_path", edge_path_kernel, "LAUNCHES"),
)


def reset() -> None:
    """Zero every kernel's launch counter."""
    for _, module, attr in COUNTERS:
        setattr(module, attr, 0)


def read() -> dict:
    """{kernel name: launches since the last `reset`}."""
    return {name: getattr(module, attr) for name, module, attr in COUNTERS}
