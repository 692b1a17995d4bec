"""Build and bind the hand-written CUDA kernels (``csrc/grid_kernels.cu``:
``rate_grid``, ``rate_grid_packed`` and ``m4_grid``).

The source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into the
git-ignored ``filodb_tpu_torch/_build/`` directory; the library file
name carries a hash of the source, so an edited kernel never loads a
stale build.  The library is bound with ``ctypes``: every pointer and
the stream are ``c_void_p``, every scalar a ``c_int``, and each entry
returns ``cudaGetLastError()`` after its launch.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "grid_kernels.cu")
_BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no fused multiply-add contraction: the kernels repeat the
              # plain versions' f32 arithmetic op for op
              "-fmad=false", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_log = ""            # nvcc's output of the last build (registers, spills)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            p = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return p


def _compile() -> str:
    global build_log
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(_BUILD, f"libgrid_kernels-{digest.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True, timeout=600)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The built and bound kernel library (compiled on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_compile())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            # (vals, ts, phase, out; nb, ns, T, K, stride, g, steps0, op,
            #  mode, dense, is_rate; stream)
            lib.rate_grid_launch.argtypes = [ptr] * 4 + [i32] * 11 + [ptr]
            # (plane, meta, out; kind, nb, n, out_ld, col, row0, T, K,
            #  stride, g, op, use_phase, dense, is_rate; stream)
            lib.rate_grid_packed_launch.argtypes = \
                [ptr] * 3 + [i32] * 14 + [ptr]
            # (vals, out; T, S, P, W; stream)
            lib.m4_grid_launch.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
            lib.rate_grid_launch.restype = i32
            lib.rate_grid_packed_launch.restype = i32
            lib.m4_grid_launch.restype = i32
            lib.grid_error_string.restype = ctypes.c_char_p
            lib.grid_error_string.argtypes = [i32]
            _lib = lib
        return _lib


def error_string(rc: int) -> str:
    return "unknown" if _lib is None else _lib.grid_error_string(rc).decode()
