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

Every C entry point is an ``EntryPoint`` declared in the wrapper module
that passes its arguments (``ops.cuda_*``): its symbol, its argument
types, and the name its launches are counted under in ``runtime``. A new
kernel touches only its ``.cu`` file, its wrapper, one entry in
``SOURCES`` and its tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

from . import runtime

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libcoxgraph_tpu_torch.so")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")
SOURCES = ("tsdf_update.cu", "hamming_match.cu", "tsdf_alloc.cu",
           "esdf_sweep.cu", "registration_terms.cu")
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
    """Build if needed and load once per process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    return _lib


class EntryPoint:
    """One C entry point: ``symbol``, returning 0 or an error code that
    ``cox_error_string`` names, with ``argtypes`` and then the CUDA stream.
    Declaring one declares its launch count ``name`` in ``runtime``."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name, self.symbol = name, symbol
        self.argtypes = (*argtypes, ctypes.c_void_p)
        runtime.add_launches(name, 0)

    def __call__(self, device, *args, launches: int = 1,
                 lib: Optional[ctypes.CDLL] = None) -> None:
        """Launch on ``device``'s current stream, operands unchecked (the
        wrapper checks them), then add ``launches`` to the count. ``lib``:
        this library unless a build of an edited source is given."""
        lib = load() if lib is None else lib
        fn = getattr(lib, self.symbol)
        if fn.argtypes is None:
            fn.argtypes = self.argtypes
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            text = lib.cox_error_string
            text.argtypes, text.restype = (ctypes.c_int,), ctypes.c_char_p
            raise RuntimeError(f"{self.symbol} launch failed: "
                               + text(err).decode())
        runtime.add_launches(self.name, launches)
