"""Native (C++) host runtime of the port, loaded with ctypes: the compact
wire serializer of TSDF layers (``serializer.cpp``) and the message bus
broker and client (``bus.cpp``). Both are copies of the JAX package's
sources, so the wire format and the bus frames are byte for byte the
same: a robot of either package talks to a server of the other.

The library is host code, not a kernel. It is built with ``g++`` at first
use into ``native/build/`` (git-ignored) as ``libcoxnative_torch.so`` (its
own name, so a process may load it beside the JAX package's
``libcoxnative.so``), and cached by a hash of the sources and the flags,
not by file times: a fresh checkout gives every file a new time. Builds
racing in several processes are safe (pid-tagged temporaries,
``os.replace``). A failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libcoxnative_torch.so")
SOURCES = ("serializer.cpp", "bus.cpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread")
_LOCK = threading.Lock()
_LIB = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the library unless an up-to-date one exists → its path."""
    digest = _digest()
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, *(os.path.join(_DIR, s) for s in SOURCES),
           "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{LIB_PATH}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    stamp_tmp = f"{stamp}.{os.getpid()}.tmp"
    with open(stamp_tmp, "w") as f:
        f.write(digest)
    os.replace(stamp_tmp, stamp)
    return LIB_PATH


def _declare(L: ctypes.CDLL) -> ctypes.CDLL:
    P, U32 = ctypes.c_void_p, ctypes.c_uint32
    L.cox_serialized_bound.restype = ctypes.c_size_t
    L.cox_serialized_bound.argtypes = [U32, U32]
    L.cox_serialize.restype = ctypes.c_size_t
    L.cox_serialize.argtypes = [P, P, P, P, U32, U32, ctypes.c_float,
                                ctypes.c_float, P, ctypes.c_size_t]
    L.cox_peek.restype = ctypes.c_int
    L.cox_peek.argtypes = [P, ctypes.c_size_t, ctypes.POINTER(U32),
                           ctypes.POINTER(U32),
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_float)]
    L.cox_deserialize.restype = ctypes.c_int
    L.cox_deserialize.argtypes = [P, ctypes.c_size_t, P, P, P, P]
    # message bus (bus.cpp)
    L.cox_bus_serve.restype = ctypes.c_int
    L.cox_bus_serve.argtypes = [ctypes.c_uint16]
    L.cox_bus_stop.restype = None
    L.cox_bus_stop.argtypes = [ctypes.c_int]
    L.cox_bus_connect.restype = ctypes.c_int
    L.cox_bus_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
    L.cox_bus_close.restype = None
    L.cox_bus_close.argtypes = [ctypes.c_int]
    for name in ("cox_bus_subscribe", "cox_bus_advertise"):
        fn = getattr(L, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_char_p]
    L.cox_bus_publish.restype = ctypes.c_int
    L.cox_bus_publish.argtypes = [ctypes.c_int, ctypes.c_char_p, P, U32]
    L.cox_bus_reply.restype = ctypes.c_int
    L.cox_bus_reply.argtypes = [ctypes.c_int, ctypes.c_uint64, P, U32]
    L.cox_bus_poll.restype = ctypes.c_int
    L.cox_bus_poll.argtypes = [ctypes.c_int, ctypes.c_int]
    L.cox_bus_request.restype = ctypes.c_long
    L.cox_bus_request.argtypes = [ctypes.c_int, ctypes.c_char_p, P, U32,
                                  ctypes.c_int]
    L.cox_bus_msg_len.restype = U32
    L.cox_bus_msg_len.argtypes = [ctypes.c_int]
    L.cox_bus_msg_reqid.restype = ctypes.c_uint64
    L.cox_bus_msg_reqid.argtypes = [ctypes.c_int]
    L.cox_bus_msg_topic.restype = ctypes.c_int
    L.cox_bus_msg_topic.argtypes = [ctypes.c_int, ctypes.c_char_p, U32]
    L.cox_bus_msg_data.restype = ctypes.c_int
    L.cox_bus_msg_data.argtypes = [ctypes.c_int, P, U32]
    return L


def lib() -> ctypes.CDLL:
    """Load (building if needed) the native library, once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _declare(ctypes.CDLL(build()))
    return _LIB
