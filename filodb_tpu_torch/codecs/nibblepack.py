"""Predictive NibblePack codec.

Implements the public NibblePack storage scheme described in the reference's
compression spec (reference: doc/compression.md:33-76 and
memory/src/main/scala/filodb.memory/format/NibblePack.scala:12): u64 values are
packed 8 at a time; each group stores

    +0  u8  bitmask, bit i set => value i is nonzero
    +1  u8  (only if bitmask != 0)
            bits 0-3: number of trailing zero *nibbles* (0-15)
            bits 4-7: number of stored nibbles - 1   (0-15)
    +2  nibble stream: for each nonzero value in bitmask order, the
        ``numNibbles`` middle nibbles, least-significant nibble first,
        packed two-per-byte (low nibble first).

This is a fresh numpy implementation of that format (plus zigzag helpers for
signed residual streams).  A C++ fast path with identical output lives in
``filodb_tpu_torch/native``; :func:`use_native` toggles it when built.
"""

from __future__ import annotations

import numpy as np

_native = None  # set by filodb_tpu_torch.native when the shared lib is importable


def zigzag_encode(values: np.ndarray) -> np.ndarray:
    """Map signed int64 -> unsigned u64 with small magnitudes near zero."""
    v = values.astype(np.int64, copy=False)
    return ((v.astype(np.uint64) << np.uint64(1)) ^ (v >> np.int64(63)).astype(np.uint64))


def zigzag_decode(values: np.ndarray) -> np.ndarray:
    u = values.astype(np.uint64, copy=False)
    return ((u >> np.uint64(1)).astype(np.int64)) ^ -(u & np.uint64(1)).astype(np.int64)


def _nibble_widths(group: np.ndarray) -> tuple[int, int, int]:
    """Return (bitmask, trailing_zero_nibbles, num_nibbles) for one group of 8."""
    nz = group != 0
    bitmask = int(np.packbits(nz[::-1]).item())  # bit i corresponds to value i
    if bitmask == 0:
        return 0, 0, 0
    vals = group[nz]
    # leading/trailing zero bit counts over nonzero values only (zero values
    # would contribute 64 and never win the min)
    tz_bits = 64
    lz_bits = 64
    for v in vals:
        iv = int(v)
        tz_bits = min(tz_bits, (iv & -iv).bit_length() - 1)
        lz_bits = min(lz_bits, 64 - iv.bit_length())
    trailing_nibbles = tz_bits // 4
    leading_nibbles = lz_bits // 4
    num_nibbles = max(1, 16 - leading_nibbles - trailing_nibbles)
    return bitmask, trailing_nibbles, num_nibbles


def pack(values: np.ndarray) -> bytes:
    """NibblePack an array of u64.  Length is NOT stored; callers record it."""
    if _native is not None:
        return _native.nibble_pack(np.ascontiguousarray(values, dtype=np.uint64))
    v = np.ascontiguousarray(values, dtype=np.uint64)
    n = len(v)
    ngroups = (n + 7) // 8
    padded = np.zeros(ngroups * 8, dtype=np.uint64)
    padded[:n] = v
    out = bytearray()
    for g in range(ngroups):
        group = padded[g * 8:(g + 1) * 8]
        bitmask, trailing, num_nibbles = _nibble_widths(group)
        out.append(bitmask)
        if bitmask == 0:
            continue
        out.append((trailing & 0xF) | ((num_nibbles - 1) << 4))
        # emit nibbles LSB-first for each nonzero value
        nibbles = []
        for v64 in group[group != 0]:
            shifted = int(v64) >> (trailing * 4)
            for k in range(num_nibbles):
                nibbles.append((shifted >> (4 * k)) & 0xF)
        if len(nibbles) % 2:
            nibbles.append(0)
        for lo, hi in zip(nibbles[::2], nibbles[1::2]):
            out.append(lo | (hi << 4))
    return bytes(out)


def unpack(buf: bytes, count: int, offset: int = 0) -> tuple[np.ndarray, int]:
    """Decode ``count`` u64 values starting at ``offset``.

    Returns (values, next_offset).
    """
    if _native is not None:
        return _native.nibble_unpack(buf, count, offset)
    out = np.zeros(((count + 7) // 8) * 8, dtype=np.uint64)
    pos = offset
    mv = memoryview(buf)
    for g in range((count + 7) // 8):
        bitmask = mv[pos]
        pos += 1
        if bitmask == 0:
            continue
        hdr = mv[pos]
        pos += 1
        trailing = hdr & 0xF
        num_nibbles = (hdr >> 4) + 1
        nnz = bin(bitmask).count("1")
        total_nibbles = num_nibbles * nnz
        nbytes = (total_nibbles + 1) // 2
        chunk = mv[pos:pos + nbytes]
        pos += nbytes
        # expand nibble stream
        nibbles = np.empty(nbytes * 2, dtype=np.uint64)
        arr = np.frombuffer(chunk, dtype=np.uint8)
        nibbles[0::2] = arr & 0xF
        nibbles[1::2] = arr >> 4
        vi = 0
        for i in range(8):
            if bitmask & (1 << i):
                val = 0
                base = vi * num_nibbles
                for k in range(num_nibbles):
                    val |= int(nibbles[base + k]) << (4 * k)
                out[g * 8 + i] = np.uint64((val << (trailing * 4)) & 0xFFFFFFFFFFFFFFFF)
                vi += 1
    return out[:count], pos


