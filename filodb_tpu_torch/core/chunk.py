"""Chunk metadata and encoded chunk sets.

Equivalent of the reference's ChunkSetInfo + BinaryVector chunk payloads
(reference: core/src/main/scala/filodb.core/store/ChunkSetInfo.scala:59,122).
A ``ChunkSet`` is the frozen, compressed form of one partition's write buffer
(what gets flushed to the column store).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from filodb_tpu_torch.codecs import deltadelta, doublecodec, histcodec, strcodec
from filodb_tpu_torch.core.histogram import HistogramBuckets
from filodb_tpu_torch.core.schemas import ColumnType, Schema


def chunk_id(start_time_ms: int, ingestion_seq: int = 0) -> int:
    """Chunk ids are timestamp-based so they sort by time (reference:
    ChunkSetInfo chunkID = timestamp-based, store/ChunkSetInfo.scala)."""
    return (start_time_ms << 12) | (ingestion_seq & 0xFFF)


@dataclasses.dataclass
class ChunkSetInfo:
    chunk_id: int
    num_rows: int
    start_time: int
    end_time: int


@dataclasses.dataclass
class ChunkSet:
    """Compressed columns of one chunk of one partition."""

    info: ChunkSetInfo
    partkey: bytes
    vectors: list[bytes]  # one encoded blob per data column (col 0 = timestamps)
    schema_hash: int = 0  # 16-bit schema id, persisted so readers (ODP,
    #                       batch downsampler) recover the exact schema

    @property
    def nbytes(self) -> int:
        return sum(len(v) for v in self.vectors)


def encode_chunkset(schema: Schema, partkey: bytes, timestamps: np.ndarray,
                    columns: Sequence, ingestion_seq: int = 0) -> ChunkSet:
    """Freeze raw append buffers into the smallest encoding per column —
    the optimize() step of the reference's BinaryAppendableVector
    (reference: memory/format/BinaryVector.scala optimize,
    TimeSeriesPartition.encodeOneChunkset TimeSeriesPartition.scala:203-249).

    ``columns`` are the non-timestamp data columns in schema order; histogram
    columns take ``(HistogramBuckets, int64[rows, buckets])`` tuples.
    """
    return encode_chunksets_batch(
        schema, [(partkey, timestamps, columns, ingestion_seq)])[0]


def encode_chunksets_batch(schema: Schema, items: Sequence[tuple]
                           ) -> list[ChunkSet]:
    """Encode MANY chunksets with two native batch-encode calls total
    (one per numeric family) — the offline downsampler's write side,
    where per-chunkset call overhead dominates small rollup chunks
    (reference: BatchDownsampler.downsampleBatch re-encode loop).

    ``items``: (partkey, timestamps, columns, ingestion_seq) tuples with
    the same column contract as :func:`encode_chunkset`."""
    data_cols = schema.data.columns[1:]
    ll_arrays, dbl_arrays = [], []
    # identical ll arrays (the grid downsampler hands EVERY series the
    # same period-end timestamp object) encode once and share the blob
    ll_index: dict[int, int] = {}

    def ll_slot(arr) -> int:
        i = ll_index.get(id(arr))
        if i is None:
            i = ll_index[id(arr)] = len(ll_arrays)
            ll_arrays.append(arr)
        return i

    plans = []          # per item: list of ("ll"/"dbl"/"done", idx/blob)
    items = [(pk, np.ascontiguousarray(ts, dtype=np.int64), cols, seq)
             for pk, ts, cols, seq in items]
    for partkey, ts, columns, seq in items:
        n = len(ts)
        if len(columns) != len(data_cols):
            raise ValueError(
                f"schema {schema.name} expects {len(data_cols)} data "
                f"columns, got {len(columns)}")
        plan = [("ll", ll_slot(ts))]
        for col, data in zip(data_cols, columns):
            rows = data[1] if col.ctype == ColumnType.HISTOGRAM else data
            if len(rows) != n:
                raise ValueError(f"column {col.name}: {len(rows)} rows "
                                 f"!= {n} timestamps")
            if col.ctype == ColumnType.DOUBLE:
                plan.append(("dbl", len(dbl_arrays)))
                dbl_arrays.append(np.asarray(data, dtype=np.float64))
            elif col.ctype in (ColumnType.LONG, ColumnType.TIMESTAMP,
                               ColumnType.INT):
                plan.append(("ll", ll_slot(np.asarray(data,
                                                      dtype=np.int64))))
            elif col.ctype == ColumnType.HISTOGRAM:
                buckets, hrows = data
                plan.append(("done",
                             histcodec.encode(buckets, np.asarray(hrows))))
            elif col.ctype == ColumnType.STRING:
                plan.append(("done", strcodec.encode_utf8(list(data))))
            else:
                raise ValueError(f"unsupported column type {col.ctype}")
        plans.append(plan)
    ll_blobs = deltadelta.encode_batch(ll_arrays)
    dbl_blobs = doublecodec.encode_batch(dbl_arrays) if dbl_arrays else []
    out = []
    for (partkey, ts, _columns, seq), plan in zip(items, plans):
        vectors = [ll_blobs[p[1]] if p[0] == "ll"
                   else dbl_blobs[p[1]] if p[0] == "dbl" else p[1]
                   for p in plan]
        n = len(ts)
        t0 = int(ts[0]) if n else 0
        info = ChunkSetInfo(chunk_id(t0, seq), n, t0,
                            int(ts[-1]) if n else 0)
        out.append(ChunkSet(info, partkey, vectors,
                            schema_hash=schema.schema_hash))
    return out


def decode_column(blob: bytes, ctype: ColumnType):
    if ctype in (ColumnType.TIMESTAMP, ColumnType.LONG, ColumnType.INT):
        return deltadelta.decode(blob)
    if ctype == ColumnType.DOUBLE:
        return doublecodec.decode(blob)
    if ctype == ColumnType.HISTOGRAM:
        return histcodec.decode(blob)
    if ctype == ColumnType.STRING:
        return strcodec.decode_utf8(blob)
    raise ValueError(f"unsupported column type {ctype}")


def decode_chunkset(schema: Schema, cs: ChunkSet) -> tuple[np.ndarray, list]:
    ts = deltadelta.decode(cs.vectors[0])
    cols = [decode_column(blob, col.ctype)
            for col, blob in zip(schema.data.columns[1:], cs.vectors[1:])]
    return ts, cols


# --------------------------------------------------------------------------
# Padded batches: the general query path's input
# --------------------------------------------------------------------------

TS_PAD = np.iinfo(np.int64).max  # padding timestamp: sorts after everything


@dataclasses.dataclass
class ChunkBatch:
    """Padded dense SoA over a set of series: the unit the window
    functions consume (``ops/windows.py``), staged on the host and
    uploaded whole.

    ``timestamps[s, r]`` is padded with TS_PAD and ``values`` with NaN past
    ``row_counts[s]`` so searchsorted/window functions need no masks beyond
    the value NaN convention.  ``hist`` columns become [S, R, B] matrices.

    Arrays are READ-ONLY by convention: scan paths may hand out views of
    shared decoded caches (partition read_range output), so consumers
    must never mutate a batch in place.
    """

    timestamps: np.ndarray          # [S, R] int64
    values: np.ndarray              # [S, R] float64 (the designated value column)
    row_counts: np.ndarray          # [S] int32
    hist: Optional[np.ndarray] = None       # [S, R, B] float64 when value col is hist
    bucket_tops: Optional[np.ndarray] = None  # [B]

    @property
    def num_series(self) -> int:
        return self.timestamps.shape[0]

    @property
    def max_rows(self) -> int:
        return self.timestamps.shape[1]


def pad_rows(max_rows: int, pad_to: Optional[int]) -> int:
    """The padded row dimension R for a batch whose longest series has
    ``max_rows`` rows: rounded up to ``pad_to``, then geometric buckets
    above it, so the set of batch shapes stays logarithmic in the row
    count."""
    R = max_rows
    if pad_to:
        if R <= pad_to:
            R = pad_to
        else:
            R = pad_to * (1 << int(np.ceil(np.log2(R / pad_to))))
    return max(R, 1)


def build_batch(series_ts: Sequence[np.ndarray], series_vals: Sequence,
                pad_to: Optional[int] = None, hist: bool = False,
                bucket_tops: Optional[np.ndarray] = None,
                pad_series_to: Optional[int] = None) -> ChunkBatch:
    """Stack ragged per-series arrays into a padded [S, R] batch.

    R = max rows rounded up by :func:`pad_rows`; timestamps pad with
    TS_PAD, values with NaN so windowed functions naturally exclude them.
    """
    S = len(series_ts)
    counts = np.array([len(t) for t in series_ts], dtype=np.int32)
    R = pad_rows(int(counts.max()) if S else 0, pad_to)
    S_pad = max(S, pad_series_to) if pad_series_to else max(S, 1)
    ts = np.full((S_pad, R), TS_PAD, dtype=np.int64)
    for i, t in enumerate(series_ts):
        ts[i, :len(t)] = t
    if hist:
        B = len(bucket_tops)
        vals = np.full((S_pad, R, B), np.nan, dtype=np.float64)
        for i, v in enumerate(series_vals):
            vals[i, :len(v)] = v
        return ChunkBatch(ts, np.full((S_pad, R), np.nan),
                          counts_pad(counts, S_pad), hist=vals,
                          bucket_tops=np.asarray(bucket_tops,
                                                 dtype=np.float64))
    vals = np.full((S_pad, R), np.nan, dtype=np.float64)
    for i, v in enumerate(series_vals):
        vals[i, :len(v)] = v
    return ChunkBatch(ts, vals, counts_pad(counts, S_pad))


def counts_pad(counts: np.ndarray, s_pad: int) -> np.ndarray:
    if len(counts) == s_pad:
        return counts
    out = np.zeros(s_pad, dtype=np.int32)
    out[:len(counts)] = counts
    return out
