"""ctypes binding to the C++ BVH builder (port of raytracer_tpu/native/__init__.py,
`build_bvh_native` only).

The source is the repository's `cpp/raytpu_native.cc`, the JAX package's
native runtime. It is compiled with g++ at first use, never at import, into
`build/` next to this package's sources (beside the CUDA kernels,
ops/build.py), under a file name that hashes the source and flags, so an edit
rebuilds; the JAX package's own `cpp/libraytpu.so` is neither read nor
written. The builder is deterministic and byte-identical to the NumPy one in
geometry/bvh.py (longest-centroid-axis median split, stable sort, DFS
preorder with skip links).

`available()` says whether the library built and loaded; `build_error()`
says why not. geometry/bvh.py:build_bvh prefers this builder and reports
which one ran.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "cpp" / "raytpu_native.cc"
BUILD_DIR = PKG_DIR / "build"
# No -march=native: the library is built on whatever host runs it. No
# contraction either: the builder's only float arithmetic is the centroid
# 0.5 * (min + max), which must round as the NumPy builder's does.
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libraytpu_native_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the builder unless a library for this source exists; raise
    if there is no C++ compiler or it fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    return so


@functools.lru_cache(maxsize=None)
def _load():
    """(the loaded library with typed entry points, "") or (None, why not)."""
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError) as e:
        return None, str(e)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.rt_build_bvh.restype = ctypes.c_int32
    lib.rt_build_bvh.argtypes = [
        f32p, f32p, ctypes.c_int32, ctypes.c_int32,
        f32p, f32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def build_error() -> str:
    """Why the library is not available ("" if it is)."""
    return _load()[1]


def build_bvh_native(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int = 4):
    """C++ BVH build over per-primitive AABBs; the array contract of
    geometry/bvh.py:build_bvh. Returns (box_min, box_max, skip, leaf_start,
    leaf_count, prim_order) NumPy arrays, or None if the library is not
    available."""
    lib = _load()[0]
    if lib is None:
        return None
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    n = bmin.shape[0]
    cap = 2 * max(n, 1)
    out_min = np.empty((cap, 3), np.float32)
    out_max = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    lstart = np.empty(cap, np.int32)
    lcount = np.empty(cap, np.int32)
    order = np.empty(max(n, 1), np.int32)
    order_len = ctypes.c_int32(0)
    m = lib.rt_build_bvh(bmin, bmax, n, leaf_size, out_min, out_max, skip, lstart, lcount,
                         order, ctypes.byref(order_len))
    if m < 0:
        raise ValueError(f"rt_build_bvh refused n={n}, leaf_size={leaf_size}")
    k = order_len.value
    return (out_min[:m].copy(), out_max[:m].copy(), skip[:m].copy(), lstart[:m].copy(),
            lcount[:m].copy(), order[:k].copy())
