"""Native (C++) host-codec fast paths, bound via ctypes.

``src/codecs.cpp`` is built with g++ at first use into the git-ignored
``filodb_tpu_torch/_build/`` directory.  :func:`enable` installs the fast
paths into the pure-Python codec modules' ``_native`` hooks; without a
compiler the numpy codecs keep working (host code only — nothing here
touches the GPU).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "codecs.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD, "libcodecs.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    """Compile the shared library if missing/stale.  Returns error or None."""
    try:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return None
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"  # unique per process: no build races
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-fno-exceptions", "-o", tmp, _SRC]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            return proc.stderr.strip() or "g++ failed"
        os.replace(tmp, _SO)
        return None
    except Exception as e:  # compiler missing, read-only fs, ...
        return str(e)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err is not None:
            _build_error = err
            return None
        try:
            lib = _bind(ctypes.CDLL(_SO))
        except OSError as e:  # corrupt/mismatched cached .so
            _build_error = str(e)
            return None
        _lib = lib
        return _lib


def _bind(lib):
    lib.np_max_packed.restype = ctypes.c_size_t
    lib.np_max_packed.argtypes = [ctypes.c_size_t]
    lib.np_pack.restype = ctypes.c_longlong
    lib.np_pack.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.np_unpack.restype = ctypes.c_longlong
    lib.np_unpack.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.c_size_t, ctypes.c_size_t,
                              ctypes.c_void_p]
    lib.np_packed_end.restype = ctypes.c_longlong
    lib.np_packed_end.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_size_t, ctypes.c_size_t]
    lib.dd_decode.restype = ctypes.c_longlong
    lib.dd_decode.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_size_t]
    lib.xor_unpack.restype = ctypes.c_longlong
    lib.xor_unpack.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                               ctypes.c_size_t, ctypes.c_size_t,
                               ctypes.c_void_p]
    for fn in (lib.ll_encode_batch, lib.dbl_encode_batch):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return lib


class _NibbleNative:
    """Adapter matching the ``_native`` hook protocol in nibblepack.py."""

    def __init__(self, lib):
        self._lib = lib

    def nibble_pack(self, values: np.ndarray) -> bytes:
        v = np.ascontiguousarray(values, dtype=np.uint64)
        out = np.empty(self._lib.np_max_packed(len(v)), dtype=np.uint8)
        n = self._lib.np_pack(v.ctypes.data, len(v),
                              out.ctypes.data if len(out) else None)
        return out[:n].tobytes()

    def nibble_unpack(self, buf, count: int, offset: int = 0):
        b = bytes(buf)
        out = np.zeros(max(count, 1), dtype=np.uint64)
        nxt = self._lib.np_unpack(b, len(b), offset, count, out.ctypes.data)
        if nxt < 0:
            raise ValueError("nibble stream truncated")
        return out[:count], int(nxt)

    def nibble_packed_end(self, buf, count: int, offset: int = 0) -> int:
        b = bytes(buf)
        nxt = self._lib.np_packed_end(b, len(b), offset, count)
        if nxt < 0:
            raise ValueError("nibble stream truncated")
        return int(nxt)


class _DeltaDeltaNative:
    """Adapter for deltadelta's ``_native`` hook: fused full-buffer decode."""

    def __init__(self, lib, wire_const: int, wire_delta2: int):
        self._lib = lib
        self._wc = wire_const
        self._wd = wire_delta2

    def dd_decode(self, buf) -> np.ndarray:
        from filodb_tpu_torch.codecs import deltadelta

        b = np.frombuffer(buf, dtype=np.uint8)   # zero-copy over any buffer
        if len(b) < 1 + deltadelta._HDR.size:
            raise ValueError("DELTA2 buffer too short")
        n = deltadelta._HDR.unpack_from(b, 1)[0]
        out = np.empty(max(n, 1), dtype=np.int64)
        got = self._lib.dd_decode(b.ctypes.data, len(b), self._wc, self._wd,
                                  out.ctypes.data, len(out))
        if got < 0:
            raise ValueError("corrupt DELTA2 vector")
        return out[:n]


class _XorNative:
    """Adapter for doublecodec's ``_native`` hook: fused XOR-chain decode
    + batch double encode (the flush hot loop)."""

    def __init__(self, lib):
        self._lib = lib

    def xor_unpack(self, buf, count: int, offset: int) -> np.ndarray:
        b = np.frombuffer(buf, dtype=np.uint8)   # zero-copy over any buffer
        out = np.empty(max(count, 1), dtype=np.float64)
        nxt = self._lib.xor_unpack(b.ctypes.data, len(b), offset, count,
                                   out.ctypes.data)
        if nxt < 0:
            raise ValueError("corrupt XOR double vector")
        return out[:count]

    def dbl_encode_batch(self, arrays) -> list[bytes]:
        return _encode_batch(self._lib.dbl_encode_batch, arrays, np.float64)


class _LLEncodeNative:
    """Adapter for deltadelta's batch-encode hook."""

    def __init__(self, lib):
        self._lib = lib

    def ll_encode_batch(self, arrays) -> list[bytes]:
        return _encode_batch(self._lib.ll_encode_batch, arrays, np.int64)


def _encode_batch(fn, arrays, dtype) -> list[bytes]:
    nvec = len(arrays)
    if nvec == 0:
        return []
    lens = np.array([len(a) for a in arrays], dtype=np.int64)
    starts = np.zeros(nvec + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(a, dtype).ravel() for a in arrays])
        if starts[-1] else np.empty(0, dtype))
    # per-vector worst case: nested headers (<=26B) + the nibblepack
    # bound ((n+7)//8 groups * 66B), closed-form — no per-vector FFI
    cap = int((26 + ((lens + 7) // 8) * 66).sum())
    out = np.empty(max(cap, 1), dtype=np.uint8)
    offs = np.empty(nvec + 1, dtype=np.int64)
    total = fn(flat.ctypes.data if len(flat) else None, starts.ctypes.data,
               nvec, out.ctypes.data, len(out), offs.ctypes.data)
    if total < 0:
        raise ValueError("native batch encode overflow")
    buf = out[:total].tobytes()
    return [buf[offs[i]:offs[i + 1]] for i in range(nvec)]


def enable() -> bool:
    """Install native fast paths into the codec modules.  True on success."""
    lib = _load()
    if lib is None:
        return False
    from filodb_tpu_torch.codecs import deltadelta, doublecodec, nibblepack
    from filodb_tpu_torch.codecs.wire import WireType

    nibblepack._native = _NibbleNative(lib)
    deltadelta._native = _DeltaDeltaNative(lib, int(WireType.CONST_LONG),
                                           int(WireType.DELTA2))
    deltadelta._native_enc = _LLEncodeNative(lib)
    doublecodec._native = _XorNative(lib)
    return True
