"""First-class histogram value type and bucket schemes.

Re-creates the capability of the reference's histogram model (reference:
memory/src/main/scala/filodb.memory/format/vectors/Histogram.scala:59-76):
histograms are single values with cumulative (Prometheus-style) buckets, a
bucket *scheme* shared across rows, and a ``quantile`` with Prometheus linear
interpolation.  Unlike the reference (per-value objects), bulk operations here
work on dense ``[rows, buckets]`` matrices so they can be shipped to device.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


class HistogramBuckets:
    """Base for bucket schemes.  Subclasses define top-edge ("le") values."""

    scheme_id: int = 0

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_tops())

    def bucket_tops(self) -> np.ndarray:
        raise NotImplementedError

    def serialize(self) -> bytes:
        raise NotImplementedError

    @staticmethod
    def deserialize(buf: bytes, offset: int = 0) -> tuple["HistogramBuckets", int]:
        scheme = buf[offset]
        if scheme == GeometricBuckets.scheme_id:
            first, mult, n, m1 = struct.unpack_from("<ddHB", buf, offset + 1)
            return GeometricBuckets(first, mult, n, bool(m1)), offset + 1 + 19
        if scheme == CustomBuckets.scheme_id:
            (n,) = struct.unpack_from("<H", buf, offset + 1)
            tops = np.frombuffer(buf, dtype="<f8", count=n, offset=offset + 3)
            return CustomBuckets(tops.copy()), offset + 3 + 8 * n
        raise ValueError(f"unknown bucket scheme {scheme}")

    def __eq__(self, other) -> bool:
        return (type(self) is type(other)
                and np.array_equal(self.bucket_tops(), other.bucket_tops()))

    def __hash__(self) -> int:
        return hash(self.bucket_tops().tobytes())


@dataclasses.dataclass(eq=False)
class GeometricBuckets(HistogramBuckets):
    """Exponential buckets: top_i = first * mult**i  (reference scheme
    ``geometric``; ``geometric_1`` prepends a bucket counting from 1)."""

    first_bucket: float
    multiplier: float
    count: int
    starts_at_one: bool = False  # geometric_1

    scheme_id = 1

    def bucket_tops(self) -> np.ndarray:
        tops = self.first_bucket * self.multiplier ** np.arange(self.count, dtype=np.float64)
        if self.starts_at_one:
            tops = np.concatenate([[1.0], tops])
        return tops

    def serialize(self) -> bytes:
        return bytes([self.scheme_id]) + struct.pack(
            "<ddHB", self.first_bucket, self.multiplier, self.count, int(self.starts_at_one))


@dataclasses.dataclass(eq=False)
class CustomBuckets(HistogramBuckets):
    """Explicit "le" upper bounds, Prometheus style; last is typically +Inf."""

    tops: np.ndarray

    scheme_id = 2

    def __post_init__(self):
        self.tops = np.asarray(self.tops, dtype=np.float64)

    def bucket_tops(self) -> np.ndarray:
        return self.tops

    def serialize(self) -> bytes:
        return bytes([self.scheme_id]) + struct.pack("<H", len(self.tops)) + self.tops.astype("<f8").tobytes()


@dataclasses.dataclass
class Histogram:
    """One histogram observation: cumulative bucket counts under a scheme."""

    buckets: HistogramBuckets
    values: np.ndarray  # cumulative counts, shape [num_buckets]

    def quantile(self, q: float) -> float:
        return float(quantile_bulk(self.buckets.bucket_tops(),
                                   self.values[np.newaxis, :], q)[0])

    def __add__(self, other: "Histogram") -> "Histogram":
        if self.buckets != other.buckets:
            raise ValueError("bucket scheme mismatch")
        return Histogram(self.buckets, self.values + other.values)


def quantile_bulk(tops: np.ndarray, rows: np.ndarray, q: float) -> np.ndarray:
    """Prometheus histogram_quantile over a dense [rows, buckets] matrix.

    Same interpolation contract as the reference (reference:
    memory/.../vectors/Histogram.scala:59-76 and Prometheus's bucketQuantile):
    linear within the located bucket, lower bound 0 for the first bucket, and
    the last finite bucket top when the quantile lands in the +Inf bucket.
    """
    rows = np.asarray(rows, dtype=np.float64)
    if q < 0:
        return np.full(rows.shape[0], -np.inf)
    if q > 1:
        return np.full(rows.shape[0], np.inf)
    B = len(tops)
    if B < 2:
        return np.full(rows.shape[0], np.nan)
    total = rows[:, -1]
    rank = q * total
    # first bucket index whose cumulative count >= rank (exact, no epsilon —
    # reference: Histogram.firstBucketGTE)
    idx = np.sum(rows < rank[:, None], axis=1)
    idx = np.minimum(idx, B - 1)
    count_at = np.take_along_axis(rows, idx[:, None], axis=1)[:, 0]
    count_below = np.where(idx > 0,
                           np.take_along_axis(rows, np.maximum(idx - 1, 0)[:, None], axis=1)[:, 0],
                           0.0)
    top = tops[idx]
    bottom = np.where(idx > 0, tops[np.maximum(idx - 1, 0)], 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        interp = bottom + (top - bottom) * (rank - count_below) / (count_at - count_below)
    # last bucket: cannot interpolate to +Inf -> second-to-last top
    out = np.where(idx == B - 1, tops[B - 2], interp)
    # first bucket with non-positive top: return the top itself
    out = np.where((idx == 0) & (tops[0] <= 0), tops[0], out)
    # all-NaN rows (padded / no-data series slots) must stay NaN
    out = np.where(np.isnan(total), np.nan, out)
    return out


