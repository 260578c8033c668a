"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (sm_90a),
one process per source started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.
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
SOURCES = ("tsdf_update.cu", "hamming_match.cu", "tsdf_alloc.cu",
           "esdf_sweep.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-fmad=false",
                              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
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
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    # one nvcc per source, all started together, then one link
    cmds = [[nvcc, *COMPILE_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
            for s, o in zip(SOURCES, objs)]
    tmp = f"{LIB_PATH}.{tag}"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    runs = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        runs.append((c, p.returncode, out, err))
    if all(rc == 0 for _, rc, _, _ in runs):
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.returncode, proc.stdout, proc.stderr))
    last_build_seconds = time.perf_counter() - t0
    with open(LOG_PATH, "w") as f:
        for c, _, out, err in runs:
            f.write(" ".join(c) + "\n" + out + err)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(c, rc, err) for c, rc, _, err in runs if rc != 0]
    if failed:
        c, rc, err = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}) on {c[-1]}:\n{err[-4000:]}")
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
    _lib = declare(ctypes.CDLL(build()))
    return _lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the entry points that ``lib``
    holds (this library, or a build of an edited copy of one source)
    → ``lib``."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entry_points = {
        "cox_tsdf_update_blocks": (
            [P] * 10      # pools, coords, k, slots, mask, depth, color, T
            + [I] * 6     # n_lanes, mb, vps, vec, height, width
            + [F] * 11    # fx fy cx cy min max tau 1/(tau/2) max_w vs bs
            + [I, I, P],  # use_dropoff, use_distance_weight, stream
            I),
        "cox_hamming_topk": (
            [P] * 8       # a, a_valid, b, b_valid, d1, i1, d2, best_a
            + [I] * 7     # n_q, cap, ka, kb, b_batched, big, excl
            + [P],        # stream
            I),
        "cox_tsdf_alloc": (
            [P] * 3       # depth, T, marks
            + [ctypes.c_int64]   # the bytes of marks
            + [P] * 7     # index, coords, num_blocks, k, slots, mask,
                          # touched
            + [I] * 8     # height, width, stride, band, gd, mb, vps, lanes
            + [F] * 10    # band lo hi step, cx cy 1/fx 1/fy min max 1/vs
            + [P],        # stream
            I),
        "cox_esdf_build": (
            [P] * 10      # sdf, weight, index, coords, num_blocks, dist,
                          # observed, tmp, band, nbr
            + [I] * 5     # B, v, gd, n_iters, full
            + [F] * 3     # max_distance, truncation, min weight
            + [P, P],     # the host steps, stream
            I),
        "cox_error_string": ([I], ctypes.c_char_p),
    }
    for name, (argtypes, restype) in entry_points.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib
