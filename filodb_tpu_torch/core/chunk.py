"""Chunk metadata and encoded chunk sets.

Equivalent of the reference's ChunkSetInfo + BinaryVector chunk payloads
(reference: core/src/main/scala/filodb.core/store/ChunkSetInfo.scala:59,122).
A ``ChunkSet`` is the frozen, compressed form of one partition's write buffer
(what gets flushed to the column store).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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
