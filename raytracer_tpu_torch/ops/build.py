"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

nvcc compiles each `.cu` file to an object, all of them at once in
parallel processes, and links them into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The build runs at first use, never at import, into `build/` next
to this package's sources; the library's file name carries a hash of the
sources and flags, so an edit rebuilds.

Fast math stays off (the closest hit takes the IEEE, correctly rounded
square root of the twin's torch.sqrt), and so does multiply-add
contraction (`--fmad=false`):
the plain PyTorch twins are the kernels' spec and round every product and
sum separately, and near-tangent or near-origin rays amplify a contracted
rounding difference (with contraction on, the worst of 2^20 random rays
against rand_spheres gave a hit t 7.7% off the twin's on an H100).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from raytracer_tpu_torch.utils import trace as tr

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--fmad=false",
    "-Xptxas", "-v",  # per-kernel registers / spills, kept in build_log()
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # sph, ns, quad, nq, origin, direction, n, t_out, prim_out, slice_rows,
    # words, threads, stream
    "rt_intersect": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _P],
    # clusters, n_sph_super, n_sph, n_quad_super, n_quad, sph, ns, quad, nq,
    # origin, direction, n, t_out, prim_out, threads, stream
    "rt_intersect_clustered": [_P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P],
    # sph, ns, quad, nq, res, cam, seed, rem0, px0, py0, n, log, segs,
    # width, height, jump_px, jump_py, num_slots, max_depth, rr_start,
    # rr_lo, rr_hi, sky_gradient, max_iters, tex_rows, images, image_dims,
    # img_h, img_w, filter, noise, clusters, n_sph_super, n_sph,
    # n_quad_super, n_quad, threads, stream
    "rt_render_persistent": [
        _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
        _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P,
    ],
    # sph, ns, quad, nq, res, cam, seed, n, radiance, tape, segs,
    # width, height, max_depth, sky_gradient, tex_rows, images, image_dims,
    # img_h, img_w, filter, noise, next_sample, thread_segs, grid_divisor,
    # threads, stream
    "rt_render_persistent_tape": [
        _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
        _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P,
    ],
    # sph, ns, quad, nq, cam, seed, origin, direction, active, remaining, px,
    # py, sample_k, depth, n, width, height, jump_px, jump_py, max_depth,
    # t, prim, origin_out, direction_out, grant, remaining_out, px_out,
    # py_out, sample_k_out, uniforms, threads, stream
    "rt_wavefront_step": [
        _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
    ],
    # clusters, n_sph_super, n_sph, n_quad_super, n_quad, sph, ns, quad, nq,
    # origin, direction, n, t_out, prim_out, threads, stream
    "rt_intersect_culled": [_P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P],
    # grad, idx, idx_is_64, n, rows, cols, tile_rows, tiles, blocks, warps,
    # partial, out, sum_threads, stream
    "rt_gather_backward": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    # table, geom, ns, tape, total, lanes, offs, depth, n_lanes, o0, d0, bg,
    # seed, max_depth, sky_gradient, radiance, state, segs, threads, stream
    "rt_replay_forward": [_P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P,
                          _I, _I, _I, _P, _P, _P, _I, _P],
    # table, geom, ns, tape, total, lanes, offs, depth, segs, n_lanes, state,
    # grad, bg, seed, sky_gradient, rows, idx, lane_out, threads, stream
    "rt_replay_adjoint": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P,
                          _P, _P, _I, _I, _P, _P, _P, _I, _P],
}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_files() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in source_files():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libraytracer_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel processes, wait for every one, and
    return their joined output; raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build_library() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objs = [so.with_name(f"{so.stem}.{src.stem}.{tag}.o") for src in sources]
    tmp = so.with_suffix(f".{tag}.so")
    try:
        with tr.span("kernels/nvcc"):
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                            for src, o in zip(sources, objs)])
            log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    return so


def build_log() -> str:
    """nvcc's output for the current sources (ptxas register and spill
    counts), or "" if they have not been built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
@tr.spanned("kernels/load")
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry
    points, in a span `kernels/load` (`kernels/nvcc` inside it when it
    builds)."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel entry point reported a CUDA error (its
    cudaGetLastError() right after the launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
