"""Build and bind the hand-written CUDA kernels (``csrc/grid_kernels.cu``:
``rate_grid``'s direct path, ``rate_grid_packed``,
``rate_grid_grouped``'s direct path,
the grouped packed kernel behind ``rate_grid_grouped_packed`` and
``hist_grid_grouped_packed``'s direct path, and ``m4_grid``;
``csrc/hist_staged.cu``: the staged kernel of
``hist_grid_grouped_packed``; ``csrc/grouped_staged.cu``: the staged
kernel of ``rate_grid_grouped_packed``; ``csrc/dense_staged.cu``: the
staged kernel of ``rate_grid_grouped``; ``csrc/series_staged.cu``: the
staged kernel of ``rate_grid``; all on
``csrc/grid_device.cuh``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into an
object, one ``nvcc`` a source, all started together; the objects are
linked into one shared library with a plain C interface, at first use,
in the git-ignored ``filodb_tpu_torch/_build/`` directory.  The library
file name carries a hash of the sources, so an edited kernel never loads
a stale build.  The library is bound with ``ctypes``: every pointer and
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
_CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("grid_kernels.cu", "hist_staged.cu", "grouped_staged.cu",
           "dense_staged.cu", "series_staged.cu")
HEADERS = ("grid_device.cuh",)
_BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC",
              # no fused multiply-add contraction: the kernels repeat the
              # plain versions' f32 arithmetic op for op
              "-fmad=false", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-Xcompiler", "-fPIC")

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


def _run(procs: list, what: str) -> str:
    """Wait for every (source, process) pair; their output, or raise with
    the first failure's."""
    log, failed = [], None
    try:
        for src, proc in procs:
            out, err = proc.communicate(timeout=600)
            log.append(out + err)
            if proc.returncode != 0 and failed is None:
                failed = f"nvcc failed on {src} ({what}):\n{err[-4000:]}"
    finally:
        for _src, proc in procs:          # a timeout leaves none running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError(failed)
    return "".join(log)


def _compile() -> str:
    global build_log
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(name.encode() + f.read())
    so = os.path.join(_BUILD, f"libgrid_kernels-{digest.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tag = f"{digest.hexdigest()[:12]}.{os.getpid()}"
    objs = [os.path.join(_BUILD, f"{os.path.splitext(n)[0]}-{tag}.o")
            for n in SOURCES]
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = nvcc_path()
    try:
        procs = [(n, subprocess.Popen(
                     [nvcc, *NVCC_FLAGS, "-c", "-o", o,
                      os.path.join(_CSRC, n)],
                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                     text=True)) for n, o in zip(SOURCES, objs)]
        build_log = _run(procs, "compile")
        link = subprocess.Popen([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        build_log += _run([("the objects", link)], "link")
        os.replace(tmp, so)
    finally:
        for p in objs + [tmp]:
            if os.path.exists(p):
                os.remove(p)
    return so


def library() -> ctypes.CDLL:
    """The built and bound kernel library (compiled on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_compile())
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # the function arguments: (farg, farg2, rank_lo, rank_hi,
            #  w_lo, w_hi, fill)
            fn_args = [f32, f32, i32, i32, f32, f32, f32]
            # (vals, ts, phase, out; nb, ns, T, K, stride, g, steps0, op,
            #  mode, dense, is_rate; function arguments; stream)
            lib.rate_grid_launch.argtypes = \
                [ptr] * 4 + [i32] * 11 + fn_args + [ptr]
            # (planes, metas: void*[k]; widths, cols, kinds: int[k]; k;
            #  out; out_ld, row0, T, K, stride, g, op, use_phase, dense,
            #  is_rate; function arguments; stream): every class plane of
            #  a pack in one launch
            ptrs = ctypes.POINTER(ptr)
            ints = ctypes.POINTER(i32)
            lib.rate_grid_packed_launch.argtypes = \
                [ptrs, ptrs, ints, ints, ints, i32, ptr] + [i32] * 10 \
                + fn_args + [ptr]
            # (vals, ts, phase, sum, cnt; nb, ns, group_lanes, T, K,
            #  stride, g, steps0, op, mode, dense, is_rate; function
            #  arguments; stream)
            lib.rate_grid_grouped_launch.argtypes = \
                [ptr] * 5 + [i32] * 12 + fn_args + [ptr]
            # (plane, meta, sum, cnt; kind, nb, n, group_lanes, hb, slot0,
            #  row0, T, K, stride, g, op, use_phase, dense, is_rate;
            #  function arguments; stream)
            lib.grouped_packed_launch.argtypes = \
                [ptr] * 4 + [i32] * 15 + fn_args + [ptr]
            # (plane, meta, sum, cnt; kind, nb, n, group_lanes, hb, slot0,
            #  row0, T, K, stride, g, op, use_phase, dense, is_rate, tile,
            #  ring_bytes, chunk, acc_shared; function arguments; stream)
            lib.hist_staged_launch.argtypes = \
                [ptr] * 4 + [i32] * 19 + fn_args + [ptr]
            # (plane, meta, sum, cnt; kind, nb, n, group_lanes, hb, slot0,
            #  row0, T, K, stride, g, op, use_phase, dense, is_rate, tile,
            #  ring_bytes, linear; function arguments; stream)
            lib.grouped_staged_launch.argtypes = \
                [ptr] * 4 + [i32] * 18 + fn_args + [ptr]
            # (vals, ts, phase, sum, cnt; nb, ns, group_lanes, T, K,
            #  stride, g, steps0, op, mode, dense, is_rate, tile,
            #  ring_bytes, linear; function arguments; stream)
            lib.dense_staged_launch.argtypes = \
                [ptr] * 5 + [i32] * 15 + fn_args + [ptr]
            # (vals, ts, phase, out; nb, ns, T, K, stride, g, steps0, op,
            #  mode, dense, is_rate, ring_bytes; function arguments;
            #  stream)
            lib.series_staged_launch.argtypes = \
                [ptr] * 4 + [i32] * 12 + fn_args + [ptr]
            # B1's member axis: (vals, ts, phase, out, row0s, steps0s;
            #  members, nrows, ns, T, K, stride, g, op, mode, dense,
            #  is_rate, ring_bytes; function arguments; stream), and the
            #  direct kernel's (the same less nrows and ring_bytes)
            lib.series_staged_batch_launch.argtypes = \
                [ptr] * 6 + [i32] * 12 + fn_args + [ptr]
            lib.rate_grid_batch_launch.argtypes = \
                [ptr] * 6 + [i32] * 10 + fn_args + [ptr]
            # (vals, out; T, S, P, W; stream)
            lib.m4_grid_launch.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
            for fn in (lib.rate_grid_launch, lib.rate_grid_packed_launch,
                       lib.rate_grid_grouped_launch,
                       lib.grouped_packed_launch, lib.hist_staged_launch,
                       lib.grouped_staged_launch, lib.dense_staged_launch,
                       lib.series_staged_launch,
                       lib.series_staged_batch_launch,
                       lib.rate_grid_batch_launch, lib.m4_grid_launch):
                fn.restype = i32
            lib.grid_error_string.restype = ctypes.c_char_p
            lib.grid_error_string.argtypes = [i32]
            _lib = lib
        return _lib


def error_string(rc: int) -> str:
    return "unknown" if _lib is None else _lib.grid_error_string(rc).decode()
