"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (sm_90a)
into one shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, from the repository's sources only, into
``csrc/build/`` (git-ignored), and is cached by a hash of the sources and
the flags: a second process reuses the library, and any source change
rebuilds it.

Flags: ``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into fused
multiply-adds, so the kernels round exactly as their torch twins do;
``--use_fast_math`` is never used. ``-Xptxas -v`` reports registers and
spills into ``csrc/build/build.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libcoxgraph_tpu_torch.so")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")
SOURCES = ("tsdf_update.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lib = None
last_build_seconds = 0.0


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then PATH, then the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of coxgraph_tpu_torch are built at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the library unless an up-to-date one exists → its path.
    Sets ``last_build_seconds`` (0.0 when the cached library was used)."""
    global last_build_seconds
    digest = _digest()
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                last_build_seconds = 0.0
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    with open(LOG_PATH, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument and result types."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cox_tsdf_update_blocks.argtypes = (
        [P] * 10          # pools, coords, k, slots, mask, depth, color, T
        + [I] * 5         # n_lanes, mb, vps, height, width
        + [F] * 11        # fx fy cx cy min max tau 1/(tau/2) max_w vs bs
        + [I, I, P])      # use_dropoff, use_distance_weight, stream
    lib.cox_tsdf_update_blocks.restype = I
    lib.cox_error_string.argtypes = [I]
    lib.cox_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
