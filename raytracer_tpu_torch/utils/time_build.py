"""Time the kernel library's build from the checkout's sources: one nvcc per
source started together, then a link (`ops/build.py:build_library`),
against one nvcc compiling every source in turn with the same flags. Each
build goes into a fresh temporary directory, in turns (serial, parallel,
parallel, serial); prints one JSON line of seconds.

    python -m raytracer_tpu_torch.utils.time_build
"""

from __future__ import annotations

import json
import subprocess
import tempfile
import time
from pathlib import Path


def main() -> dict:
    from raytracer_tpu_torch.ops import build

    sources = [str(s) for s in sorted(build.CSRC_DIR.glob("*.cu"))]
    times = {"serial_s": [], "parallel_s": []}
    for kind in ("serial_s", "parallel_s", "parallel_s", "serial_s"):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            if kind == "serial_s":
                subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                                str(Path(d) / "serial.so"), *sources],
                               check=True, capture_output=True)
            else:
                build.BUILD_DIR = Path(d)
                build.build_library()
            times[kind].append(time.perf_counter() - t0)
    out = dict(times, sources=len(sources))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
