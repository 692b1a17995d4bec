"""Delta-delta (DELTA2) codec for int64 timestamp/counter vectors.

Models the vector as a sloped line ``pred[i] = base + slope*i`` and stores
only the zigzag'd residuals, nibble-packed — the same sloped-line model the
reference uses for timestamps and long counters (reference:
memory/src/main/scala/filodb.memory/format/vectors/DeltaDeltaVector.scala:28,
doc/compression.md "Long/Integer Compression").  Perfectly linear vectors
(regular timestamps, idle counters) collapse to a 21-byte const encoding.

Layout (after the 1-byte WireType header written by the caller):

    u32  n          number of values
    i64  base       value of element 0 in the line model
    i64  slope      per-step increment
    [nibble-packed zigzag residuals]     (DELTA2 only; absent for CONST_LONG)
"""

from __future__ import annotations

import struct

import numpy as np

from filodb_tpu_torch.codecs import nibblepack
from filodb_tpu_torch.codecs.wire import WireType

_HDR = struct.Struct("<Iqq")

_native = None  # set by filodb_tpu_torch.native when the shared lib is importable
_native_enc = None  # batch-encode hook (flush/downsample hot loop)


def encode_batch(arrays) -> list[bytes]:
    """Encode many int64 vectors; ONE native call when available (the
    per-vector Python overhead dominates small downsample chunks)."""
    if _native_enc is not None:
        return _native_enc.ll_encode_batch(arrays)
    return [encode(a) for a in arrays]


def encode(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.int64)
    n = len(v)
    if n == 0:
        return bytes([WireType.CONST_LONG]) + _HDR.pack(0, 0, 0)
    base = int(v[0])
    slope = int(round((int(v[-1]) - base) / (n - 1))) if n > 1 else 0
    # wrap slope into int64: residual arithmetic is modular (2^64) on both
    # encode and decode, so wraparound round-trips exactly even for vectors
    # spanning the full int64 range
    slope = (slope + 2**63) % 2**64 - 2**63
    with np.errstate(over="ignore"):
        pred = np.int64(base) + np.int64(slope) * np.arange(n, dtype=np.int64)
        resid = v - pred
    if not resid.any():
        return bytes([WireType.CONST_LONG]) + _HDR.pack(n, base, slope)
    packed = nibblepack.pack(nibblepack.zigzag_encode(resid))
    return bytes([WireType.DELTA2]) + _HDR.pack(n, base, slope) + packed


def decode(buf: bytes) -> np.ndarray:
    wire = buf[0]
    if wire not in (WireType.CONST_LONG, WireType.DELTA2):
        raise ValueError(f"not a DELTA2 vector: wire type {wire}")
    if _native is not None:
        return _native.dd_decode(buf)
    n, base, slope = _HDR.unpack_from(buf, 1)
    with np.errstate(over="ignore"):
        line = np.int64(base) + np.int64(slope) * np.arange(n, dtype=np.int64)
        if wire == WireType.CONST_LONG:
            return line
        packed, _ = nibblepack.unpack(buf, n, 1 + _HDR.size)
        return line + nibblepack.zigzag_decode(packed)


def num_values(buf: bytes) -> int:
    return _HDR.unpack_from(buf, 1)[0]
