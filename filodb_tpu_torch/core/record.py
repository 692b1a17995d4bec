"""Ingestion record format: the BinaryRecord v2 equivalent.

The reference serializes each sample into an off-heap BinaryRecord inside a
reusable RecordContainer — the unit that flows over Kafka and into shards,
carrying the 16-bit schema hash, the partition-key hash and the shard-key
hash so downstream code never re-parses tags (reference:
core/src/main/scala/filodb.core/binaryrecord2/RecordBuilder.scala:32,
RecordSchema.scala:40, RecordContainer.scala:27, doc/binaryrecord-spec.md).

Here a record is a compact binary struct with the same embedded hashes, and a
``RecordContainer`` is a length-prefixed batch of them.  Hashes use
blake2b-64 (stable across processes/hosts, unlike Python ``hash``); the
shard-key hash covers only the shard-key tags so the shard mapper can
bit-splice it with the partition hash (reference: RecordBuilder.shardKeyHash
/ partitionKeyHash, RecordBuilder.scala:578+).
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.schemas import ColumnType, DatasetOptions, Schema


def stable_hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def stable_hash32(data: bytes) -> int:
    return stable_hash64(data) & 0xFFFFFFFF


def canonical_partkey(tags: Mapping[str, str]) -> bytes:
    """Canonical partition-key bytes: sorted tag pairs.  Serves the role of
    the reference's partKey BinaryRecord (equality + hashing + persistence)."""
    out = bytearray()
    for k in sorted(tags):
        kb, vb = k.encode(), tags[k].encode()
        out += struct.pack("<HH", len(kb), len(vb)) + kb + vb
    return bytes(out)


def parse_partkey(buf: bytes) -> dict[str, str]:
    tags: dict[str, str] = {}
    pos = 0
    while pos < len(buf):
        klen, vlen = struct.unpack_from("<HH", buf, pos)
        pos += 4
        k = buf[pos:pos + klen].decode(); pos += klen
        v = buf[pos:pos + vlen].decode(); pos += vlen
        tags[k] = v
    return tags


def shard_key_hash(tags: Mapping[str, str], options: DatasetOptions) -> int:
    """32-bit hash over shard-key tag values only, with the reference's
    metric-suffix stripping (``_bucket``/``_count``/``_sum`` hash like their
    base metric so they land on the same shards; reference:
    RecordBuilder.trimShardColumn + shardKeyHash)."""
    parts = []
    for col in options.shard_key_columns:
        v = tags.get(col, "")
        for suffix in options.ignore_shard_key_column_suffixes.get(col, ()):
            if v.endswith(suffix):
                v = v[: -len(suffix)]
                break
        parts.append(v)
    return stable_hash32("\x00".join(parts).encode())


def partition_hash(tags: Mapping[str, str], options: Optional[DatasetOptions] = None) -> int:
    """32-bit hash over the full tag set minus ignored tags (reference:
    DatasetOptions.ignoreTagsOnPartitionKeyHash, e.g. ``le``)."""
    ignored = options.ignore_tags_on_partition_key_hash if options else ()
    filtered = {k: v for k, v in tags.items() if k not in ignored}
    return stable_hash32(canonical_partkey(filtered))


@dataclasses.dataclass
class IngestRecord:
    """One decoded sample: schema hash + tags + timestamp + data values.

    ``values`` holds the non-timestamp data columns in schema order; histogram
    columns hold an encoded BinaryHistogram-equivalent blob (bytes).
    """

    schema_hash: int
    tags: dict[str, str]
    timestamp: int
    values: tuple
    shard_hash: int = 0
    part_hash: int = 0

    def partkey(self) -> bytes:
        return canonical_partkey(self.tags)


_REC_DTYPE_CACHE: dict = {}


def record_dtype(schema: Schema, pklen: int) -> "np.dtype":
    """The numpy structured dtype of one wire record for (schema, pklen)
    — cached: dtype construction is a surprising share of small
    per-series batch encodes."""
    key = (schema.schema_hash, pklen)
    dt = _REC_DTYPE_CACHE.get(key)
    if dt is None:
        fields = [("schema", "<u2"), ("shash", "<u4"), ("phash", "<u4"),
                  ("ts", "<i8")]
        for ci, col in enumerate(schema.data.columns[1:]):
            if col.ctype == ColumnType.DOUBLE:
                fields.append((f"c{ci}", "<f8"))
            elif col.ctype == ColumnType.INT:
                fields.append((f"c{ci}", "<i4"))
            else:
                fields.append((f"c{ci}", "<i8"))
        fields.append(("pklen", "<u2"))
        if pklen:
            fields.append(("pk", f"V{pklen}"))
        dt = _REC_DTYPE_CACHE[key] = np.dtype(fields)
    return dt


class RecordBuilder:
    """Builds RecordContainers from samples (reference: RecordBuilder.scala:32).

    Not thread-safe; one builder per producer, like the reference's
    per-thread builders.
    """

    def __init__(self, schema: Schema, options: DatasetOptions | None = None,
                 container_size: int = 1024 * 1024):
        self.schema = schema
        self.options = options or DatasetOptions()
        self.container_size = container_size
        self._containers: list[bytearray] = []
        self._cur: bytearray = bytearray()

    def add(self, timestamp: int, values: Sequence, tags: Mapping[str, str]) -> None:
        # normalize the Prometheus __name__ label to the dataset's metric
        # column (reference: gateway InputRecord conversion writes the
        # metric into DatasetOptions.metricColumn)
        mcol = self.options.metric_column
        if mcol != "__name__" and "__name__" in tags:
            norm = dict(tags)
            norm[mcol] = norm.pop("__name__")
            tags = norm
        shash = shard_key_hash(tags, self.options)
        phash = partition_hash(tags, self.options)
        rec = _encode_record(self.schema, self.options, timestamp, values, tags,
                             shash, phash)
        if len(self._cur) + len(rec) > self.container_size and self._cur:
            self._flush_container()
        self._cur += rec

    def add_series(self, timestamps: Sequence, columns: Sequence[Sequence],
                   tags: Mapping[str, str]) -> int:
        """Vectorized add of one series' samples: hashes and the partkey
        are computed once, and all records are encoded with a numpy
        structured array in one pass.  Producers naturally hold
        per-series batches (reference: RecordBuilder reuse across a
        container, RecordBuilder.scala:32; the gateway's InputRecords
        carry one series each).  Falls back to per-row :meth:`add` for
        histogram/string schemas.  Returns records added."""
        n = len(timestamps)
        if n == 0:
            return 0
        data_cols = self.schema.data.columns[1:]
        if len(columns) != len(data_cols):
            raise ValueError(f"expected {len(data_cols)} columns, "
                             f"got {len(columns)}")
        if any(c.ctype not in (ColumnType.DOUBLE, ColumnType.LONG,
                               ColumnType.TIMESTAMP, ColumnType.INT)
               for c in data_cols):
            for i, t in enumerate(timestamps):
                self.add(int(t), [col[i] for col in columns], tags)
            return n
        mcol = self.options.metric_column
        if mcol != "__name__" and "__name__" in tags:
            norm = dict(tags)
            norm[mcol] = norm.pop("__name__")
            tags = norm
        return self.add_series_hashed(
            timestamps, columns, shard_key_hash(tags, self.options),
            partition_hash(tags, self.options), canonical_partkey(tags))

    def add_series_hashed(self, timestamps: Sequence,
                          columns: Sequence[Sequence], shash: int,
                          phash: int, pk: bytes) -> int:
        """:meth:`add_series` with the per-series hashes/partkey already
        computed — the gateway's columnar ingest memoizes them per
        series across batches, so recomputing them per call would be
        a third of its cost.  Numeric schemas only (the caller already
        normalized tags into ``pk``)."""
        n = len(timestamps)
        if n == 0:
            return 0
        rec = np.zeros(n, dtype=record_dtype(self.schema, len(pk)))
        rec["schema"] = self.schema.schema_hash
        rec["shash"] = shash
        rec["phash"] = phash
        rec["ts"] = np.asarray(timestamps, dtype=np.int64)
        self._fill_value_cols(rec, columns)
        rec["pklen"] = len(pk)
        if pk:
            rec["pk"] = np.frombuffer(pk, dtype=np.uint8).view(f"V{len(pk)}")
        self.append_encoded(rec.tobytes(), rec.dtype.itemsize, n)
        return n

    def _fill_value_cols(self, rec: np.ndarray, columns) -> None:
        for ci, col in enumerate(self.schema.data.columns[1:]):
            arr = np.asarray(columns[ci])
            rec[f"c{ci}"] = arr.astype(np.float64) \
                if col.ctype == ColumnType.DOUBLE else arr.astype(np.int64) \
                if col.ctype != ColumnType.INT else arr.astype(np.int32)

    def append_encoded(self, blob: bytes, rec_size: int, n: int) -> None:
        """Append ``n`` pre-encoded fixed-size wire records (built with
        :func:`record_dtype`) across container boundaries.  This is the
        PUBLIC seam for callers that batch-encode records themselves
        (the gateway's planned ingest) — container framing and size
        policy stay in this class."""
        per = max((self.container_size - len(self._cur)) // rec_size, 0)
        pos = 0
        while pos < n:
            if per == 0:
                if self._cur:
                    self._flush_container()
                per = max(self.container_size // rec_size, 1)
            take = min(per, n - pos)
            self._cur += blob[pos * rec_size:(pos + take) * rec_size]
            pos += take
            per = (self.container_size - len(self._cur)) // rec_size

    def _flush_container(self) -> None:
        self._containers.append(self._cur)
        self._cur = bytearray()

    def containers(self) -> list[bytes]:
        """Drain all full+partial containers as wire bytes."""
        if self._cur:
            self._flush_container()
        out = [struct.pack("<I", len(c)) + bytes(c) for c in self._containers]
        self._containers = []
        return out


def _encode_record(schema: Schema, options: DatasetOptions, timestamp: int,
                   values: Sequence, tags: Mapping[str, str],
                   shash: int, phash: int) -> bytes:
    out = bytearray()
    out += struct.pack("<HIIq", schema.schema_hash, shash, phash, timestamp)
    data_cols = schema.data.columns[1:]
    if len(values) != len(data_cols):
        raise ValueError(f"expected {len(data_cols)} values, got {len(values)}")
    for col, v in zip(data_cols, values):
        if col.ctype == ColumnType.DOUBLE:
            out += struct.pack("<d", float(v))
        elif col.ctype in (ColumnType.LONG, ColumnType.TIMESTAMP):
            out += struct.pack("<q", int(v))
        elif col.ctype == ColumnType.INT:
            out += struct.pack("<i", int(v))
        elif col.ctype == ColumnType.HISTOGRAM:
            blob = v if isinstance(v, (bytes, bytearray)) else bytes(v)
            out += struct.pack("<H", len(blob)) + blob
        elif col.ctype == ColumnType.STRING:
            blob = v.encode() if isinstance(v, str) else bytes(v)
            out += struct.pack("<H", len(blob)) + blob
        else:
            raise ValueError(f"unsupported column type {col.ctype}")
    pk = canonical_partkey(tags)
    out += struct.pack("<H", len(pk)) + pk
    return bytes(out)


def decode_container(buf: bytes, schemas) -> Iterator[IngestRecord]:
    """Iterate records in one container (reference: RecordContainer.iterate)."""
    (total,) = struct.unpack_from("<I", buf, 0)
    pos = 4
    end = 4 + total
    while pos < end:
        schema_hash, shash, phash, ts = struct.unpack_from("<HIIq", buf, pos)
        pos += 18
        schema = schemas.by_hash(schema_hash)
        vals = []
        for col in schema.data.columns[1:]:
            if col.ctype == ColumnType.DOUBLE:
                vals.append(struct.unpack_from("<d", buf, pos)[0]); pos += 8
            elif col.ctype in (ColumnType.LONG, ColumnType.TIMESTAMP):
                vals.append(struct.unpack_from("<q", buf, pos)[0]); pos += 8
            elif col.ctype == ColumnType.INT:
                vals.append(struct.unpack_from("<i", buf, pos)[0]); pos += 4
            elif col.ctype in (ColumnType.HISTOGRAM, ColumnType.STRING):
                (ln,) = struct.unpack_from("<H", buf, pos); pos += 2
                vals.append(bytes(buf[pos:pos + ln])); pos += ln
        (pklen,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        tags = parse_partkey(buf[pos:pos + pklen])
        pos += pklen
        yield IngestRecord(schema_hash, tags, ts, tuple(vals), shash, phash)
