"""Chunk downsamplers + period markers.

Capability match for the reference's streaming downsample primitives
(reference: core/src/main/scala/filodb.core/downsample/
ChunkDownsampler.scala:1-371 — dMin/dMax/dSum/dCount/dAvg/dAvgAc/dAvgSc/
tTime/dLast/hSum/hLast; DownsamplePeriodMarker.scala:163 — time- and
counter-aware period splitting).  Instead of per-row iterators, each
downsampler is a vectorized reduction over row ranges of a decoded chunk:
periods are computed once per chunk as row boundaries and every
downsampler reduces with numpy over those slices, in f64 on the host.
This is the per-series path; ``griddown.py`` is the batched one.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np

_SPEC_RE = re.compile(r"^([a-zA-Z]+)\((\d+)\)$")


def _ranges_reduce(vals: np.ndarray, bounds: np.ndarray, fn, empty):
    """Reduce ``vals`` over [bounds[i], bounds[i+1]) slices, NaN-aware."""
    out = np.full(len(bounds) - 1, empty, dtype=np.float64)
    for i in range(len(bounds) - 1):
        seg = vals[bounds[i]:bounds[i + 1]]
        seg = seg[~np.isnan(seg)] if seg.dtype.kind == "f" else seg
        if len(seg):
            out[i] = fn(seg)
    return out


@dataclasses.dataclass(frozen=True)
class ChunkDownsampler:
    """One output column of a downsample record."""

    name: str
    col_id: int  # input column index in the raw schema (0 = timestamp)

    def downsample(self, ts: np.ndarray, cols: Sequence, bounds: np.ndarray,
                   period_ends: np.ndarray):
        raise NotImplementedError

    @property
    def is_time(self) -> bool:
        return False


class TTime(ChunkDownsampler):
    """Timestamp column: the period end time (reference: TimeDownsampler)."""

    @property
    def is_time(self) -> bool:
        return True

    def downsample(self, ts, cols, bounds, period_ends):
        return period_ends.astype(np.int64)


class DMin(ChunkDownsampler):
    def downsample(self, ts, cols, bounds, period_ends):
        return _ranges_reduce(cols[self.col_id - 1], bounds, np.min, np.nan)


class DMax(ChunkDownsampler):
    def downsample(self, ts, cols, bounds, period_ends):
        return _ranges_reduce(cols[self.col_id - 1], bounds, np.max, np.nan)


class DSum(ChunkDownsampler):
    def downsample(self, ts, cols, bounds, period_ends):
        return _ranges_reduce(cols[self.col_id - 1], bounds, np.sum, np.nan)


class DCount(ChunkDownsampler):
    def downsample(self, ts, cols, bounds, period_ends):
        return _ranges_reduce(cols[self.col_id - 1], bounds, len, 0.0)


class DAvg(ChunkDownsampler):
    def downsample(self, ts, cols, bounds, period_ends):
        return _ranges_reduce(cols[self.col_id - 1], bounds, np.mean, np.nan)


class DAvgSc(ChunkDownsampler):
    """Average from separate sum and count columns — re-downsampling a
    ds-gauge dataset (reference: AvgScDownsampler)."""

    def __init__(self, name: str, sum_col: int, count_col: int):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "col_id", sum_col)
        object.__setattr__(self, "count_col", count_col)

    def downsample(self, ts, cols, bounds, period_ends):
        s = _ranges_reduce(cols[self.col_id - 1], bounds, np.sum, np.nan)
        c = _ranges_reduce(cols[self.count_col - 1], bounds, np.sum, 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(c > 0, s / c, np.nan)


class DAvgAc(ChunkDownsampler):
    """Average from an avg column weighted by a count column (reference:
    AvgAcDownsampler)."""

    def __init__(self, name: str, avg_col: int, count_col: int):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "col_id", avg_col)
        object.__setattr__(self, "count_col", count_col)

    def downsample(self, ts, cols, bounds, period_ends):
        avg = cols[self.col_id - 1]
        cnt = cols[self.count_col - 1]
        out = np.full(len(bounds) - 1, np.nan)
        for i in range(len(bounds) - 1):
            a = avg[bounds[i]:bounds[i + 1]]
            c = cnt[bounds[i]:bounds[i + 1]]
            ok = ~np.isnan(a)
            if ok.any() and c[ok].sum() > 0:
                out[i] = float((a[ok] * c[ok]).sum() / c[ok].sum())
        return out


class DLast(ChunkDownsampler):
    """Last value in the period — correct for counters since within-period
    increase is recoverable from consecutive lasts (reference:
    LastValueDDownsampler)."""

    def downsample(self, ts, cols, bounds, period_ends):
        vals = cols[self.col_id - 1]
        out = np.full(len(bounds) - 1, np.nan)
        for i in range(len(bounds) - 1):
            seg = vals[bounds[i]:bounds[i + 1]]
            fin = np.flatnonzero(~np.isnan(seg))
            if len(fin):
                out[i] = seg[fin[-1]]
        return out


class HLast(ChunkDownsampler):
    """Last histogram row per period (reference: LastValueHDownsampler).
    Input column decodes to (HistogramBuckets, int64[rows, buckets])."""

    def downsample(self, ts, cols, bounds, period_ends):
        buckets, rows = cols[self.col_id - 1]
        out = np.zeros((len(bounds) - 1, rows.shape[1] if rows.ndim == 2 else 0),
                       dtype=np.float64)
        for i in range(len(bounds) - 1):
            if bounds[i + 1] > bounds[i]:
                out[i] = rows[bounds[i + 1] - 1]
        return buckets, out


class HSum(ChunkDownsampler):
    """Bucket-wise histogram sum per period (reference: SumHDownsampler)."""

    def downsample(self, ts, cols, bounds, period_ends):
        buckets, rows = cols[self.col_id - 1]
        out = np.zeros((len(bounds) - 1, rows.shape[1] if rows.ndim == 2 else 0),
                       dtype=np.float64)
        for i in range(len(bounds) - 1):
            if bounds[i + 1] > bounds[i]:
                out[i] = rows[bounds[i]:bounds[i + 1]].sum(axis=0)
        return buckets, out


_REGISTRY = {
    "tTime": TTime, "dMin": DMin, "dMax": DMax, "dSum": DSum,
    "dCount": DCount, "dAvg": DAvg, "dLast": DLast, "hLast": HLast,
    "hSum": HSum,
}


def parse_downsampler(spec: str) -> ChunkDownsampler:
    """Parse "dMin(1)" / "tTime(0)" specs (reference: DownsamplerName +
    ChunkDownsampler.downsamplers factory).  dAvgSc/dAvgAc take two column
    ids: "dAvgSc(3,4)"."""
    m = re.match(r"^([a-zA-Z]+)\((\d+)(?:,(\d+))?\)$", spec)
    if not m:
        raise ValueError(f"bad downsampler spec: {spec}")
    name, c1, c2 = m.group(1), int(m.group(2)), m.group(3)
    if name == "dAvgSc":
        return DAvgSc(spec, c1, int(c2))
    if name == "dAvgAc":
        return DAvgAc(spec, c1, int(c2))
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown downsampler {name!r} in {spec}")
    return cls(spec, c1)


# ---------------------------------------------------------------------------
# Period markers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PeriodMarker:
    """Splits a chunk's rows into downsample periods.  Returns
    (bounds, period_ends): bounds is a row-index array of length P+1;
    period i covers rows [bounds[i], bounds[i+1]) and is stamped
    period_ends[i]."""

    col_id: int

    def periods(self, ts: np.ndarray, cols: Sequence, resolution_ms: int
                ) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _time_bounds(self, ts: np.ndarray, resolution_ms: int):
        if len(ts) == 0:
            return np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.int64)
        # period p covers (p*res, (p+1)*res]; stamp = period end, like the
        # reference's timestamp normalization
        pids = (ts - 1) // resolution_ms
        uniq, starts = np.unique(pids, return_index=True)
        bounds = np.append(starts, len(ts)).astype(np.int64)
        ends = ((uniq + 1) * resolution_ms).astype(np.int64)
        return bounds, ends


class TimePeriodMarker(PeriodMarker):
    """Fixed time buckets (reference: TimeDownsamplePeriodMarker)."""

    def periods(self, ts, cols, resolution_ms):
        return self._time_bounds(ts, resolution_ms)


class CounterPeriodMarker(PeriodMarker):
    """Time buckets plus extra splits at counter resets so downsampled
    counters preserve rate correction (reference:
    CounterDownsamplePeriodMarker.scala:163: periods additionally split
    where the counter drops)."""

    def periods(self, ts, cols, resolution_ms):
        bounds, ends = self._time_bounds(ts, resolution_ms)
        vals = cols[self.col_id - 1]
        if len(vals) < 2:
            return bounds, ends
        with np.errstate(invalid="ignore"):
            drops = np.flatnonzero(np.diff(vals) < 0) + 1  # row starts a reset
        if len(drops) == 0:
            return bounds, ends
        # insert a split right before each drop row: the truncated period is
        # stamped with its last pre-reset sample ts; periods ending on a
        # time boundary keep that boundary stamp
        drop_set = set(int(d) for d in drops)
        new_bounds = np.union1d(bounds, drops).astype(np.int64)
        new_ends = np.empty(len(new_bounds) - 1, dtype=np.int64)
        for i in range(len(new_bounds) - 1):
            nxt = int(new_bounds[i + 1])
            if nxt in drop_set:
                new_ends[i] = ts[nxt - 1]
            else:
                # original time period containing these rows
                j = np.searchsorted(bounds, new_bounds[i], side="right") - 1
                new_ends[i] = ends[j]
        return new_bounds, new_ends


def parse_period_marker(spec: str) -> PeriodMarker:
    """Parse "time(0)" / "counter(1)" (reference: DownsamplePeriodMarker
    factory)."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(f"bad period marker spec: {spec}")
    name, col = m.group(1), int(m.group(2))
    if name == "time":
        return TimePeriodMarker(col)
    if name == "counter":
        return CounterPeriodMarker(col)
    raise ValueError(f"unknown period marker {name!r}")
