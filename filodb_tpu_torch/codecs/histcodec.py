"""Histogram vector codec: 2D-delta NibblePacked sections.

Capability match for the reference's section-based HistogramVector
(reference: memory/src/main/scala/filodb.memory/format/vectors/
HistogramVector.scala:189, Section.scala, doc/compression.md "2D Delta
Compression"): rows are cumulative bucket counts; row 0 of each section is
stored as within-row deltas, subsequent rows as deltas vs the previous row —
both streams zigzag'd and NibblePacked.  Sections bound how many rows a
decoder must replay, standing in for the reference's skippable section
headers.

Layout:
    u8   WireType.HIST_2D_DELTA
    u32  n_rows
    u16  n_buckets
    u16  rows_per_section
    [bucket scheme: HistogramBuckets.serialize()]
    per section:  u32 payload_bytes, then NibblePacked payload
"""

from __future__ import annotations

import struct

import numpy as np

from filodb_tpu_torch.codecs import nibblepack
from filodb_tpu_torch.codecs.wire import WireType
from filodb_tpu_torch.core.histogram import HistogramBuckets

_HDR = struct.Struct("<IHH")
DEFAULT_ROWS_PER_SECTION = 64


def encode(buckets: HistogramBuckets, rows: np.ndarray,
           rows_per_section: int = DEFAULT_ROWS_PER_SECTION) -> bytes:
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n_rows, n_buckets = rows.shape
    out = bytearray([WireType.HIST_2D_DELTA])
    out += _HDR.pack(n_rows, n_buckets, rows_per_section)
    out += buckets.serialize()
    for start in range(0, n_rows, rows_per_section):
        sect = rows[start:start + rows_per_section]
        deltas = np.empty_like(sect)
        # row 0: within-row delta of cumulative buckets (small non-negative)
        deltas[0, 0] = sect[0, 0]
        deltas[0, 1:] = np.diff(sect[0])
        # rows 1..: 2D delta vs previous row
        deltas[1:] = sect[1:] - sect[:-1]
        payload = nibblepack.pack(nibblepack.zigzag_encode(deltas.ravel()))
        out += struct.pack("<I", len(payload))
        out += payload
    return bytes(out)


def decode(buf: bytes) -> tuple[HistogramBuckets, np.ndarray]:
    if buf[0] != WireType.HIST_2D_DELTA:
        raise ValueError(f"not a histogram vector: wire type {buf[0]}")
    n_rows, n_buckets, rps = _HDR.unpack_from(buf, 1)
    buckets, pos = HistogramBuckets.deserialize(buf, 1 + _HDR.size)
    rows = np.empty((n_rows, n_buckets), dtype=np.int64)
    for start in range(0, n_rows, rps):
        count = min(rps, n_rows - start)
        (nbytes,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        packed, _ = nibblepack.unpack(buf, count * n_buckets, pos)
        pos += nbytes
        deltas = nibblepack.zigzag_decode(packed).reshape(count, n_buckets)
        sect = np.empty_like(deltas)
        sect[0] = np.cumsum(deltas[0])
        for r in range(1, count):
            sect[r] = sect[r - 1] + deltas[r]
        rows[start:start + count] = sect
    return buckets, rows


def num_values(buf: bytes) -> int:
    return _HDR.unpack_from(buf, 1)[0]


# --------------------------------------------------------------------------
# Single-sample blob: the ingest wire form of one histogram
# --------------------------------------------------------------------------

def encode_hist_value(buckets: HistogramBuckets, values) -> bytes:
    """One histogram sample as a self-describing blob — the BinaryHistogram
    that rides inside ingest records (reference: memory/format/vectors/
    HistogramVector.scala:34 BinHistogram layout: bucket scheme + packed
    cumulative counts)."""
    vals = np.ascontiguousarray(values, dtype=np.int64)
    out = bytearray([WireType.HIST_BLOB])
    out += struct.pack("<H", len(vals))
    out += buckets.serialize()
    deltas = np.empty_like(vals)
    if len(vals):
        deltas[0] = vals[0]
        deltas[1:] = np.diff(vals)
    out += nibblepack.pack(nibblepack.zigzag_encode(deltas))
    return bytes(out)


def decode_hist_value(buf: bytes) -> tuple[HistogramBuckets, np.ndarray]:
    if buf[0] != WireType.HIST_BLOB:
        raise ValueError(f"not a histogram blob: wire type {buf[0]}")
    (n,) = struct.unpack_from("<H", buf, 1)
    buckets, pos = HistogramBuckets.deserialize(buf, 3)
    deltas, _ = nibblepack.unpack(buf, n, pos)
    return buckets, np.cumsum(nibblepack.zigzag_decode(deltas))
