"""Native (C++) host-codec fast paths, bound via ctypes.

``src/codecs.cpp`` is built with g++ at first use into the git-ignored
``filodb_tpu_torch/_build/`` directory.  :func:`enable` installs the fast
paths into the pure-Python codec modules' ``_native`` hooks; without a
compiler the numpy codecs keep working (host code only — nothing here
touches the GPU).  :func:`crc32c` and :func:`crc32c_verify` are the
chunk checksums of the integrity layer.
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
    for fn in (lib.ll_decode_batch, lib.dbl_decode_batch):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
    lib.page_decode_column.restype = ctypes.c_longlong
    lib.page_decode_column.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    # c_char_p: bytes pass zero-copy with no numpy wrapper
    lib.crc32c_buf.restype = ctypes.c_uint32
    lib.crc32c_buf.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                               ctypes.c_uint32]
    lib.crc32c_verify_batch.restype = ctypes.c_longlong
    lib.crc32c_verify_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.crc32c_verify_spans.restype = ctypes.c_longlong
    lib.crc32c_verify_spans.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def build_error() -> str | None:
    """The compiler error from the last failed build attempt, if any."""
    _load()
    return _build_error


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


class _BatchDecodeNative:
    """Adapter for chunk.py's batch column decode and the paging shard's
    bulk page-in: one native call per column over many blobs."""

    def __init__(self, lib):
        self._lib = lib

    def _decode(self, fn, blobs, counts, dtype):
        nvec = len(blobs)
        offs = np.zeros(nvec + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        buf = np.frombuffer(b"".join(blobs), dtype=np.uint8) \
            if offs[-1] else np.empty(0, np.uint8)
        out_offs = np.zeros(nvec + 1, dtype=np.int64)
        np.cumsum(counts, out=out_offs[1:])
        out = np.empty(max(int(out_offs[-1]), 1), dtype=dtype)
        got = fn(buf.ctypes.data if len(buf) else None, offs.ctypes.data,
                 nvec, out.ctypes.data, out_offs.ctypes.data)
        if got < 0:
            raise ValueError("corrupt vector in batch decode")
        return [out[out_offs[i]:out_offs[i + 1]] for i in range(nvec)]

    def ll_decode_batch(self, blobs, counts) -> list[np.ndarray]:
        return self._decode(self._lib.ll_decode_batch, blobs, counts,
                            np.int64)

    def dbl_decode_batch(self, blobs, counts) -> list[np.ndarray]:
        return self._decode(self._lib.dbl_decode_batch, blobs, counts,
                            np.float64)

    def _frame_buf(self, blobs):
        nrows = len(blobs)
        offs = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        buf = np.frombuffer(b"".join(blobs), dtype=np.uint8) \
            if offs[-1] else np.empty(0, np.uint8)
        return buf, offs

    def _verify_spans(self, buf, offs, nrows, crcs) -> bool:
        """CRC32C-verify every row span of an already-joined frame
        buffer against its stored checksum (integrity subsystem,
        deferred-verify contract: the store skipped verification
        because this decode pass rides the same join).  crc 0 = legacy
        unchecksummed row, passes.  False on any mismatch — callers
        return their corrupt sentinel and the generic (store-verified)
        path takes over."""
        exp = np.ascontiguousarray(crcs, dtype=np.uint32)
        ok = np.empty(max(nrows, 1), dtype=np.uint8)
        bad = self._lib.crc32c_verify_spans(
            buf.ctypes.data if len(buf) else None, offs.ctypes.data,
            nrows, exp.ctypes.data, ok.ctypes.data)
        return bad == 0

    def page_decode(self, blobs, counts, cols, crcs=None):
        """Decode columns of FRAMED ColumnStore row blobs (pack_vectors
        layout) — the ODP bulk page-in: one C pass per column over the
        whole row set, no per-row unpack.  ``cols``: (column_index,
        is_double) pairs; column 0 is the timestamp vector.  With
        ``crcs``, every row blob is first CRC32C-verified against its
        stored checksum on this call's own join (deferred store
        verification).  Returns one flat array per requested column
        (int64 or float64, rows adjacent in blob order), or None if any
        checksum/framing/vector is corrupt (the caller falls back to
        the per-chunk path, which raises usefully)."""
        nrows = len(blobs)
        buf, offs = self._frame_buf(blobs)
        if crcs is not None and not self._verify_spans(buf, offs, nrows,
                                                       crcs):
            return None
        cnts = np.ascontiguousarray(counts, dtype=np.int64)
        starts = np.zeros(nrows, dtype=np.int64)
        np.cumsum(cnts[:-1], out=starts[1:])
        total = int(cnts.sum())
        outs = []
        for col, dbl in cols:
            out = np.empty(max(total, 1),
                           dtype=np.float64 if dbl else np.int64)
            got = self._lib.page_decode_column(
                buf.ctypes.data if len(buf) else None, offs.ctypes.data,
                nrows, int(col), 1 if dbl else 0, out.ctypes.data,
                starts.ctypes.data, cnts.ctypes.data)
            if got < 0:
                return None
            outs.append(out[:total])
        return outs

    def page_decode_into(self, blobs, counts, specs, out_starts,
                         crcs=None) -> bool:
        """Decode framed row blobs DIRECTLY into caller-allocated
        arrays: row k writes counts[k] values at flat index
        out_starts[k] of each spec's output.  ``specs``: (column_index,
        is_double, out_array) with out_array C-contiguous and of the
        matching dtype — the ODP cold path points these at the padded
        [S, R] query batch so decode IS the batch assembly.  With
        ``crcs``, rows are CRC32C-verified on this call's join BEFORE
        any decode writes (deferred store verification).  False on
        corrupt input (outputs then hold partial garbage; callers must
        discard them and fall back)."""
        nrows = len(blobs)
        buf, offs = self._frame_buf(blobs)
        if crcs is not None and not self._verify_spans(buf, offs, nrows,
                                                       crcs):
            return False
        cnts = np.ascontiguousarray(counts, dtype=np.int64)
        starts = np.ascontiguousarray(out_starts, dtype=np.int64)
        for col, dbl, out in specs:
            # raw-pointer writes: a dtype/layout mismatch would corrupt
            # the heap, so this must raise even under python -O
            want = np.float64 if dbl else np.int64
            if not out.flags.c_contiguous or out.dtype != want:
                raise ValueError(
                    f"page_decode_into output for column {col} must be "
                    f"C-contiguous {want.__name__}")
            got = self._lib.page_decode_column(
                buf.ctypes.data if len(buf) else None, offs.ctypes.data,
                nrows, int(col), 1 if dbl else 0, out.ctypes.data,
                starts.ctypes.data, cnts.ctypes.data)
            if got < 0:
                return False
        return True


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


def crc32c(buf, seed: int = 0) -> "int | None":
    """CRC32C of a buffer via the C kernel, or None when the library is
    unavailable (the integrity layer then uses its bit-identical Python
    version).  Independent of :func:`enable`: checksums must not change
    value because the codec hooks were toggled."""
    lib = _load()
    if lib is None:
        return None
    if not isinstance(buf, bytes):
        buf = bytes(buf)
    return int(lib.crc32c_buf(buf, len(buf), seed & 0xFFFFFFFF))


def crc32c_verify(blobs, expected) -> "tuple[int, np.ndarray] | None":
    """Batch CRC32C verify: one C call over a pointer array of blobs
    against the per-blob expected checksums (``integrity.chunk_crc``'s
    never-zero mapping applied).  Returns (mismatch count, ok bool
    array), or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(blobs)
    ptrs = (ctypes.c_char_p * n)(*blobs)
    lens = np.array(list(map(len, blobs)), dtype=np.int64)
    exp = np.ascontiguousarray(expected, dtype=np.uint32)
    ok = np.empty(max(n, 1), dtype=np.uint8)
    bad = lib.crc32c_verify_batch(ptrs, lens.ctypes.data, n,
                                  exp.ctypes.data, ok.ctypes.data)
    return int(bad), ok[:n].astype(bool)


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
    global _batch_dec
    _batch_dec = _BatchDecodeNative(lib)
    return True


def disable() -> None:
    """Restore the numpy codecs and drop the batch decoder: the paging
    shard then pages in partition by partition."""
    from filodb_tpu_torch.codecs import deltadelta, doublecodec, nibblepack

    nibblepack._native = None
    deltadelta._native = None
    deltadelta._native_enc = None
    doublecodec._native = None
    global _batch_dec
    _batch_dec = None


_batch_dec = None


def batch_decoder():
    """The batch column-decode adapter, or None when :func:`enable` has
    not installed it (no compiler, or :func:`disable`).  Looked up
    lazily: ``enable`` runs during the codecs package import, before
    ``core.chunk`` can be imported."""
    return _batch_dec
