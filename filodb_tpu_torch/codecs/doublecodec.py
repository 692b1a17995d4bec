"""Float64 vector codec.

Strategy mirrors the reference's DoubleVector optimizer (reference:
memory/src/main/scala/filodb.memory/format/vectors/DoubleVector.scala:14):

- all values integral and line-like  -> route through the DELTA2 long codec
  (``DELTA2_DOUBLE``), the common case for counters ingested as doubles;
- constant vectors -> ``CONST_DOUBLE``;
- otherwise -> previous-value XOR predictor, residuals stored as the
  SMALLER of two forms: bit-level Gorilla windows (``GORILLA_DOUBLE``)
  or NibblePack (``XOR_DOUBLE``; doc/compression.md "Floating Point
  Compression") — unless neither saves >=10% over raw, in which case
  ``RAW_DOUBLE`` wins: incompressible (IID-noise) data decodes with one
  memcpy instead of a bit-stream walk (the batch downsampler's read
  side is decode-bound on such data).

``GORILLA_DOUBLE`` keeps Gorilla's information layout — 1 bit for a
repeat, leading-zero count + significant length + significant bits
otherwise (the reference's time-series paper lineage) — but in a
STRUCTURE-OF-ARRAYS stream instead of one sequential bit tape:

    [n u32][nnz u32][zero-bitmap ceil(n/8)]
    [12-bit headers: clz(6) | siglen-1(6), one per nonzero]
    [concatenated significant bits, LSB-first]

Splitting control/header/payload planes makes BOTH encode and decode
fully vectorizable (numpy today, a trivial TPU/pallas port tomorrow) —
the classic Gorilla tape forces bit-serial decode.  On realistic gauge
streams (repeats + slowly-moving mantissas) this lands the same >=2x
the sequential format gets; on adversarial IID noise the NibblePack
fallback wins and is chosen by size.

NaN is used by ingestion as the "no data" sentinel, exactly like the
reference's Prometheus schemas; NaNs survive round-trip bit-exactly
through the XOR paths.
"""

from __future__ import annotations

import struct

import numpy as np

from filodb_tpu_torch.codecs import deltadelta, nibblepack
from filodb_tpu_torch.codecs.wire import WireType

_N = struct.Struct("<I")

_native = None  # set by filodb_tpu_torch.native when the shared lib is importable

_U64_1 = np.uint64(1)


def encode_batch(arrays) -> list[bytes]:
    """Encode many float64 vectors with the full selector; ONE native
    call when available (the flush/downsample hot loop)."""
    if _native is not None and hasattr(_native, "dbl_encode_batch"):
        return _native.dbl_encode_batch(arrays)
    return [encode(np.asarray(a, dtype=np.float64)) for a in arrays]


def encode_batch_2d(arr2d: np.ndarray) -> list[bytes]:
    """Encode every row of a [nvec, n] float64 matrix (the columnar
    downsample write path): the contiguous layout skips the per-vector
    gather of :func:`encode_batch`."""
    if _native is not None and hasattr(_native, "dbl_encode_batch_2d"):
        return _native.dbl_encode_batch_2d(arr2d)
    return [encode(row) for row in np.asarray(arr2d, dtype=np.float64)]


def _bit_length64(x: np.ndarray) -> np.ndarray:
    """Vectorized exact bit length of u64 (0 -> 0): frexp on the 32-bit
    halves (each exact in f64) — one pass instead of a shift cascade."""
    hi = (x >> np.uint64(32)).astype(np.float64)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.float64)
    _, ehi = np.frexp(hi)
    _, elo = np.frexp(lo)
    return np.where(hi > 0, ehi + 32, elo).astype(np.uint64)


def _gorilla_plan(residuals: np.ndarray):
    """Cheap per-value window analysis: (nz, clz, ctz, lens, nbytes).
    The encoded size is closed-form from the windows alone, so the
    encode selector can pick a winner WITHOUT materializing the (much
    more expensive) bitstream of the loser."""
    n = len(residuals)
    nz = residuals != 0
    nnz = int(nz.sum())
    if nnz == 0:
        nbytes = 2 * _N.size + (n + 7) // 8
        return nz, None, None, None, nbytes
    r = residuals[nz]
    bl = _bit_length64(r)
    clz = np.uint64(64) - bl
    ctz = _bit_length64(r & (~r + _U64_1)) - _U64_1  # lowest set bit idx
    lens = bl - ctz                              # significant bits, >= 1
    total = int(lens.astype(np.int64).sum())
    nbytes = (2 * _N.size + (n + 7) // 8 + (nnz * 12 + 7) // 8
              + (total + 7) // 8)
    return nz, clz, ctz, lens, nbytes


def _gorilla_pack(residuals: np.ndarray, plan=None) -> bytes:
    n = len(residuals)
    nz, clz, ctz, lens, _ = plan if plan is not None \
        else _gorilla_plan(residuals)
    bitmap = np.packbits(nz, bitorder="little").tobytes()
    if clz is None:
        return _N.pack(n) + _N.pack(0) + bitmap
    nnz = len(clz)
    sig = residuals[nz] >> ctz
    # 12-bit headers: clz(6) | len-1(6), fixed width -> one packbits
    hdr = (clz << np.uint64(6)) | (lens - _U64_1)
    hdr_bits = ((hdr[:, None] >> np.arange(12, dtype=np.uint64)) &
                _U64_1).astype(np.uint8)
    headers = np.packbits(hdr_bits.ravel(), bitorder="little").tobytes()
    # significant-bit stream, LSB-first within each value
    lens_i = lens.astype(np.int64)
    offs = np.zeros(nnz, np.int64)
    np.cumsum(lens_i[:-1], out=offs[1:] if nnz > 1 else offs[:0])
    total = int(lens_i.sum())
    pos = np.arange(total, dtype=np.int64) - np.repeat(offs, lens_i)
    bits = ((np.repeat(sig, lens_i) >> pos.astype(np.uint64)) &
            _U64_1).astype(np.uint8)
    payload = np.packbits(bits, bitorder="little").tobytes()
    return _N.pack(n) + _N.pack(nnz) + bitmap + headers + payload


def _gorilla_unpack(buf, offset: int) -> np.ndarray:
    (n,) = _N.unpack_from(buf, offset)
    (nnz,) = _N.unpack_from(buf, offset + _N.size)
    o = offset + 2 * _N.size
    bm_bytes = (n + 7) // 8
    nz = np.unpackbits(np.frombuffer(buf, np.uint8, bm_bytes, o),
                       bitorder="little")[:n].astype(bool)
    o += bm_bytes
    residuals = np.zeros(n, np.uint64)
    if nnz:
        hdr_bytes = (nnz * 12 + 7) // 8
        hbits = np.unpackbits(
            np.frombuffer(buf, np.uint8, hdr_bytes, o),
            bitorder="little")[:nnz * 12].astype(np.uint64)
        hdr = (hbits.reshape(nnz, 12)
               << np.arange(12, dtype=np.uint64)).sum(axis=1)
        o += hdr_bytes
        clz = hdr >> np.uint64(6)
        lens = (hdr & np.uint64(63)) + _U64_1
        ctz = np.uint64(64) - clz - lens
        lens_i = lens.astype(np.int64)
        total = int(lens_i.sum())
        sig_bytes = (total + 7) // 8
        sbits = np.unpackbits(
            np.frombuffer(buf, np.uint8, sig_bytes, o),
            bitorder="little")[:total].astype(np.uint64)
        offs = np.zeros(nnz, np.int64)
        np.cumsum(lens_i[:-1], out=offs[1:] if nnz > 1 else offs[:0])
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(offs, lens_i)).astype(np.uint64)
        weighted = sbits << pos
        sig = np.add.reduceat(weighted, offs)
        residuals[nz] = sig << ctz
    bits = np.bitwise_xor.accumulate(residuals)
    return bits.view(np.float64)


def encode(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.float64)
    n = len(v)
    if (n and np.isfinite(v).all() and (np.abs(v) < 2**63).all()
            and not (np.signbit(v) & (v == 0)).any()):  # -0.0 must keep its sign bit
        as_int = v.astype(np.int64)
        if (as_int.astype(np.float64) == v).all():
            inner = deltadelta.encode(as_int)
            return bytes([WireType.DELTA2_DOUBLE]) + inner
    if n and np.all(v[0] == v) and not np.isnan(v[0]):
        return bytes([WireType.CONST_DOUBLE]) + _N.pack(n) + struct.pack("<d", v[0])
    bits = v.view(np.uint64)
    prev = np.concatenate([[np.uint64(0)], bits[:-1]])
    residuals = bits ^ prev
    packed = nibblepack.pack(residuals)
    plan = _gorilla_plan(residuals)
    best = min(plan[-1], len(packed) + _N.size)
    # compression must pay for itself: on incompressible data (IID
    # noise) the bit-packed forms land within a few % of raw while
    # decoding orders of magnitude slower (bit streams vs one memcpy) —
    # take RAW unless the winner saves >=10%.  Integer rule, mirrored
    # exactly by the native encoder (codecs.cpp dbl_encode_one) so the
    # byte-pairing tests hold.
    raw_bytes = _N.size + 8 * n
    if best * 10 > raw_bytes * 9:
        return bytes([WireType.RAW_DOUBLE]) + _N.pack(n) + v.tobytes()
    if plan[-1] <= len(packed) + _N.size:
        return bytes([WireType.GORILLA_DOUBLE]) \
            + _gorilla_pack(residuals, plan)
    return bytes([WireType.XOR_DOUBLE]) + _N.pack(n) + packed


def decode(buf: bytes) -> np.ndarray:
    wire = buf[0]
    if wire == WireType.DELTA2_DOUBLE:
        return deltadelta.decode(buf[1:]).astype(np.float64)
    if wire == WireType.CONST_DOUBLE:
        (n,) = _N.unpack_from(buf, 1)
        (val,) = struct.unpack_from("<d", buf, 1 + _N.size)
        return np.full(n, val, dtype=np.float64)
    if wire == WireType.GORILLA_DOUBLE:
        return _gorilla_unpack(buf, 1)
    if wire == WireType.RAW_DOUBLE:
        (n,) = _N.unpack_from(buf, 1)
        return np.frombuffer(buf, np.float64, n, 1 + _N.size).copy()
    if wire != WireType.XOR_DOUBLE:
        raise ValueError(f"not a double vector: wire type {wire}")
    (n,) = _N.unpack_from(buf, 1)
    if _native is not None:
        return _native.xor_unpack(buf, n, 1 + _N.size)
    residuals, _ = nibblepack.unpack(buf, n, 1 + _N.size)
    # invert the XOR-with-previous chain via cumulative xor
    bits = np.bitwise_xor.accumulate(residuals)
    return bits.view(np.float64)


def num_values(buf: bytes) -> int:
    wire = buf[0]
    if wire == WireType.DELTA2_DOUBLE:
        return deltadelta.num_values(buf[1:])
    return _N.unpack_from(buf, 1)[0]
