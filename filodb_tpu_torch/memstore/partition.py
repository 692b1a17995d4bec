"""Per-series partition state: write buffers + frozen chunks.

Equivalent of the reference's TimeSeriesPartition (reference:
core/src/main/scala/filodb.core/memstore/TimeSeriesPartition.scala:64):
appends land in pre-allocated write buffers; when full (or at flush
boundaries) ``switch_buffers`` freezes them into a compressed ``ChunkSet``
(the encodeOneChunkset step, :203-249); out-of-order samples are dropped
(:131-134).  Queries read through ``read_range`` which serves decoded dense
arrays — the device-facing form.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np

from filodb_tpu_torch.codecs import histcodec
from filodb_tpu_torch.core.chunk import ChunkSet, decode_chunkset, encode_chunkset
from filodb_tpu_torch.core.histogram import HistogramBuckets
from filodb_tpu_torch.core.schemas import ColumnType, Schema

_EMPTY_I64 = np.empty(0, dtype=np.int64)


class PendingBuffer(NamedTuple):
    """A detached-but-not-yet-encoded write buffer.  ``freeze_raw`` (the
    ingest thread's half of a flush) produces these in O(1); the flush
    executor encodes them into ChunkSets later (reference: prepareFlushGroup
    switchBuffers on the ingest thread, encode in doFlushSteps on the flush
    scheduler — TimeSeriesShard.scala:756-774, 884-974)."""

    ts: np.ndarray
    cols: list
    hist_buckets: Optional[HistogramBuckets]
    seq: int


class TimeSeriesPartition:
    __slots__ = ("part_id", "schema", "partkey", "tags", "group",
                 "chunks", "_decoded", "_buf_ts", "_buf_cols", "_buf_n",
                 "_capacity", "_hist_buckets", "_seq", "_unflushed",
                 "_pending", "_lock", "_encode_lock",
                 "out_of_order_dropped", "on_freeze")

    def __init__(self, part_id: int, schema: Schema, partkey: bytes,
                 tags: dict[str, str], group: int, capacity: int = 400):
        self.part_id = part_id
        self.schema = schema
        self.partkey = partkey
        self.tags = tags
        self.group = group
        self.chunks: list[ChunkSet] = []
        self._decoded: dict[int, tuple] = {}   # chunk_id -> (ts, cols)
        self._capacity = capacity
        # write buffers allocate lazily on first ingest: paged-in /
        # snapshot partitions never ingest, and the ODP cold path
        # constructs thousands of them per query
        self._buf_ts = _EMPTY_I64
        self._buf_cols: Optional[list] = None
        self._buf_n = 0
        self._hist_buckets: Optional[HistogramBuckets] = None
        self._seq = 0
        self._unflushed: list[ChunkSet] = []
        # raw frozen buffers awaiting encode (pipelined flush); guarded by
        # _lock together with chunks/_unflushed so flush-executor encodes
        # never interleave badly with ingest freezes or query reads
        self._pending: list[PendingBuffer] = []
        self._lock = threading.Lock()
        # serializes whole drain_pending runs (ingest thread's buffer-full
        # encode vs a flush-executor encode of the same partition); taken
        # OUTSIDE the buffer lock (enforced by filolint):
        # lock-order: _encode_lock < TimeSeriesPartition._lock
        self._encode_lock = threading.Lock()
        self.out_of_order_dropped = 0
        # shard hook observing chunk freezes (device grid invalidation)
        self.on_freeze = None

    def _new_col_buffer(self, ctype: ColumnType):
        if ctype == ColumnType.DOUBLE:
            return np.empty(self._capacity, dtype=np.float64)
        if ctype in (ColumnType.LONG, ColumnType.TIMESTAMP, ColumnType.INT):
            return np.empty(self._capacity, dtype=np.int64)
        return []  # STRING / HISTOGRAM: python list, frozen at encode time

    def _alloc_buffers_locked(self) -> None:
        self._buf_ts = np.empty(self._capacity, dtype=np.int64)
        self._buf_cols = [self._new_col_buffer(c.ctype)
                          for c in self.schema.data.columns[1:]]

    # -- ingest -------------------------------------------------------------

    def ingest(self, timestamp: int, values: Sequence) -> bool:
        """Append one sample.  Returns False for out-of-order drops.

        All buffer mutation happens under ``_lock`` so an off-thread
        flush (``flush_now``/admin ``flush_all``) freezing this buffer
        concurrently cannot interleave with a half-written row; encoding
        of anything frozen here is deferred until after the lock drops
        (lock order: never hold ``_lock`` while taking ``_encode_lock``).
        """
        if timestamp <= self.latest_timestamp:
            self.out_of_order_dropped += 1
            return False
        # decode histogram blobs first: a bucket-scheme switch mid-stream
        # freezes the current buffer (reference: AddResponse.
        # BucketSchemaMismatch forces a new vector, BinaryVector.scala:231-236)
        decoded = []
        new_buckets = None
        for col, v in zip(self.schema.data.columns[1:], values):
            if col.ctype == ColumnType.HISTOGRAM:
                buckets, counts = histcodec.decode_hist_value(v) \
                    if isinstance(v, (bytes, bytearray)) else v
                new_buckets = buckets
                decoded.append(np.asarray(counts, dtype=np.int64))
            else:
                decoded.append(v)
        froze = False
        with self._lock:
            if self._buf_cols is None:
                self._alloc_buffers_locked()
            if new_buckets is not None:
                if self._hist_buckets is not None and self._buf_n > 0 \
                        and new_buckets != self._hist_buckets:
                    froze = self._freeze_raw_locked() or froze
                self._hist_buckets = new_buckets
            if self._buf_n == self._capacity:
                froze = self._freeze_raw_locked() or froze
            i = self._buf_n
            self._buf_ts[i] = timestamp
            for buf, col, v in zip(self._buf_cols,
                                   self.schema.data.columns[1:], decoded):
                if col.ctype in (ColumnType.HISTOGRAM, ColumnType.STRING):
                    buf.append(v)
                else:
                    buf[i] = v
            self._buf_n = i + 1
        if froze:
            self.drain_pending()
        return True

    def ingest_block(self, ts: np.ndarray, cols: Sequence
                     ) -> tuple[int, int]:
        """Append a block of samples (the C++ columnar decode path).
        Scalar columns are numpy arrays; a histogram column is a
        ``(HistogramBuckets, int64[rows, nb])`` pair covering the whole
        block under ONE scheme (the shard splits mixed runs).
        Vectorized out-of-order drop: a sample survives iff it exceeds
        every timestamp before it in (chunks + block) — identical to
        per-record ``ingest`` because dropped samples never advance the
        high-water mark.  Returns (rows_added, rows_dropped)."""
        n = len(ts)
        if n == 0:
            return 0, 0
        new_buckets = None
        for c in cols:
            if isinstance(c, tuple):
                new_buckets = c[0]
        froze = False
        with self._lock:
            # high-water mark inline (the property would re-take _lock)
            if self._buf_n:
                lt = int(self._buf_ts[self._buf_n - 1])
            elif self._pending:
                lt = int(self._pending[-1].ts[-1])
            elif self.chunks:
                lt = self.chunks[-1].info.end_time
            else:
                lt = -1
            running = np.maximum.accumulate(np.concatenate(([lt], ts)))[:-1]
            keep = ts > running
            kept = int(keep.sum())
            dropped = n - kept
            self.out_of_order_dropped += dropped
            if kept == 0:
                return 0, dropped
            if kept != n:
                ts = ts[keep]
                cols = [(c[0], c[1][keep]) if isinstance(c, tuple)
                        else c[keep] for c in cols]
            # bucket-scheme switch freezes the current buffer, same as
            # the per-record path (reference: BucketSchemaMismatch).
            # This runs AFTER the out-of-order drop: a fully-dropped
            # block must not freeze anything or move the scheme, exactly
            # like per-record ingest() returns before scheme handling.
            if new_buckets is not None:
                if self._hist_buckets is not None and self._buf_n > 0 \
                        and new_buckets != self._hist_buckets:
                    froze = self._freeze_raw_locked() or froze
                self._hist_buckets = new_buckets
            if self._buf_cols is None:
                self._alloc_buffers_locked()
            i = 0
            while i < kept:
                if self._buf_n == self._capacity:
                    froze = self._freeze_raw_locked() or froze
                take = min(self._capacity - self._buf_n, kept - i)
                j = self._buf_n
                self._buf_ts[j:j + take] = ts[i:i + take]
                for buf, arr in zip(self._buf_cols, cols):
                    if isinstance(arr, tuple):
                        # hist buffer is a list of per-row count arrays;
                        # list slice assignment extends it in place.
                        # .copy() bounds retention to the buffered rows —
                        # views would pin the whole container matrix
                        # until this buffer freezes
                        buf[j:j + take] = list(arr[1][i:i + take].copy())
                    else:
                        buf[j:j + take] = arr[i:i + take]
                self._buf_n = j + take
                i += take
        if froze:
            # encode outside _lock (lock order: _encode_lock then _lock)
            self.drain_pending()
        return kept, dropped

    @property
    def latest_timestamp(self) -> int:
        with self._lock:
            if self._buf_n:
                return int(self._buf_ts[self._buf_n - 1])
            if self._pending:
                return int(self._pending[-1].ts[-1])
            if self.chunks:
                return self.chunks[-1].info.end_time
            return -1

    @property
    def earliest_timestamp(self) -> int:
        with self._lock:
            if self.chunks:
                return self.chunks[0].info.start_time
            if self._pending:
                return int(self._pending[0].ts[0])
            if self._buf_n:
                return int(self._buf_ts[0])
            return -1

    def freeze_raw(self) -> bool:
        """Detach the current write buffer as a PendingBuffer in O(1) —
        the ingest-thread half of a pipelined flush (reference:
        prepareFlushGroup/switchBuffers, TimeSeriesShard.scala:756-774).
        Encoding happens later in :meth:`drain_pending` on the flush
        executor.  Returns True if anything froze."""
        with self._lock:
            return self._freeze_raw_locked()

    def _freeze_raw_locked(self) -> bool:
        n = self._buf_n
        if n == 0:
            return False
        cols = [buf[:n] for buf in self._buf_cols]
        self._pending.append(PendingBuffer(self._buf_ts[:n], cols,
                                           self._hist_buckets, self._seq))
        self._seq += 1
        self._buf_n = 0
        self._alloc_buffers_locked()
        return True

    def drain_pending(self) -> list[ChunkSet]:
        """Encode all pending buffers into ChunkSets, in seq order.  Safe
        from the flush executor: encoding runs outside the lock; the
        append-to-chunks + unpend step is atomic under the lock so query
        reads never see a sample twice or not at all."""
        out: list[ChunkSet] = []
        with self._encode_lock:
            out.extend(self._drain_pending_locked())
        return out

    def _drain_pending_locked(self) -> list[ChunkSet]:
        out: list[ChunkSet] = []
        while True:
            with self._lock:
                if not self._pending:
                    break
                pb = self._pending[0]
            cols = []
            for buf, col in zip(pb.cols, self.schema.data.columns[1:]):
                if col.ctype == ColumnType.HISTOGRAM:
                    cols.append((pb.hist_buckets, np.stack(list(buf))))
                elif col.ctype == ColumnType.STRING:
                    cols.append(list(buf))
                else:
                    cols.append(np.asarray(buf))
            cs = encode_chunkset(self.schema, self.partkey, pb.ts, cols,
                                 ingestion_seq=pb.seq)
            with self._lock:
                self.chunks.append(cs)
                self._unflushed.append(cs)
                self._pending.pop(0)
            if self.on_freeze is not None:
                self.on_freeze(cs)
            out.append(cs)
        return out

    def switch_buffers(self) -> Optional[ChunkSet]:
        """Freeze the current write buffer into a compressed ChunkSet
        (reference: switchBuffers + encodeOneChunkset).  Synchronous:
        freeze + encode in one call."""
        had = self.freeze_raw()
        encoded = self.drain_pending()
        return encoded[-1] if had and encoded else None

    def collect_flush_chunks(self) -> list[ChunkSet]:
        """Encode already-frozen pending buffers and drain the unflushed
        list.  Never touches the live write buffer, so it is safe from
        the flush executor while the ingest thread keeps appending."""
        self.drain_pending()
        with self._lock:
            out, self._unflushed = self._unflushed, []
        return out

    def requeue_unflushed(self, chunksets: Sequence[ChunkSet]) -> None:
        """Put collected-but-not-persisted chunksets back at the head of
        the unflushed list (a failed store write must not lose them —
        the next flush retries; writes are idempotent by chunk id)."""
        with self._lock:
            self._unflushed = list(chunksets) + self._unflushed

    # -- read ---------------------------------------------------------------

    def _decoded_chunk(self, cs: ChunkSet) -> tuple:
        got = self._decoded.get(cs.info.chunk_id)
        if got is None:
            got = decode_chunkset(self.schema, cs)
            self._decoded[cs.info.chunk_id] = got
        return got

    def read_range(self, start: int, end: int, column_id: Optional[int] = None):
        """All samples with start <= ts <= end as dense arrays.

        Returns (ts[int64], values) where values is float64 for scalar
        columns or (HistogramBuckets, int64[rows, buckets]) for histograms.
        Replaces per-row VectorDataReader iteration with whole-chunk decode +
        concatenation; the windowing kernels do the range math on device.
        """
        cid = self.schema.data.value_column_id if column_id is None else column_id
        col_idx = cid - 1  # data columns after the timestamp
        ctype = self.schema.data.columns[cid].ctype
        # one locked snapshot of chunks + pending + write-buffer tail:
        # freeze_raw moves the buffer into pending under the same lock, so
        # a concurrent reader sees each sample in exactly one of the three
        with self._lock:
            chunks_snap = list(self.chunks)
            pending_snap = list(self._pending)
            buf_n = self._buf_n
            buf_ts = self._buf_ts
            buf_cols = self._buf_cols
            buf_hist = self._hist_buckets
        ts_parts, val_parts = [], []
        for cs in chunks_snap:
            if cs.info.end_time < start or cs.info.start_time > end:
                continue
            ts, cols = self._decoded_chunk(cs)
            ts_parts.append(ts)
            val_parts.append(cols[col_idx])
        for pb in pending_snap:
            if int(pb.ts[-1]) < start or int(pb.ts[0]) > end:
                continue
            ts_parts.append(np.asarray(pb.ts))
            buf = pb.cols[col_idx]
            if ctype == ColumnType.HISTOGRAM:
                val_parts.append((pb.hist_buckets, np.stack(list(buf))))
            elif ctype == ColumnType.STRING:
                val_parts.append(list(buf))
            else:
                val_parts.append(np.asarray(buf, dtype=np.float64))
        if buf_n:
            t0 = int(buf_ts[0])
            if not (buf_ts[buf_n - 1] < start or t0 > end):
                ts_parts.append(buf_ts[:buf_n].copy())
                buf = buf_cols[col_idx]
                if ctype == ColumnType.HISTOGRAM:
                    val_parts.append((buf_hist, np.stack(buf[:buf_n])))
                elif ctype == ColumnType.STRING:
                    val_parts.append(list(buf[:buf_n]))
                else:
                    val_parts.append(buf[:buf_n].copy())
        if not ts_parts:
            empty_ts = np.empty(0, dtype=np.int64)
            if ctype == ColumnType.HISTOGRAM:
                return empty_ts, (self._hist_buckets, np.empty((0, 0), dtype=np.int64))
            return empty_ts, np.empty(0, dtype=np.float64)
        ts = ts_parts[0] if len(ts_parts) == 1 \
            else np.concatenate(ts_parts)
        if ctype == ColumnType.HISTOGRAM:
            # widest bucket scheme wins; narrower chunks pad their top bucket
            # out (cumulative counts -> edge padding preserves totals)
            buckets = max((p[0] for p in val_parts if p[0] is not None),
                          key=lambda bk: bk.num_buckets, default=None)
            rows = [p[1] for p in val_parts]
            b = buckets.num_buckets if buckets is not None else 0
            rows = [np.pad(r, ((0, 0), (0, b - r.shape[1])), mode="edge")
                    if 0 < r.shape[1] < b else r for r in rows]
            vals = np.concatenate(rows) if rows else np.empty((0, b), dtype=np.int64)
            mask = (ts >= start) & (ts <= end)
            return ts[mask], (buckets, vals[mask])
        if ctype == ColumnType.STRING:
            mask = (ts >= start) & (ts <= end)
            flat = [x for p in val_parts for x in p]
            return ts[mask], [x for x, m in zip(flat, mask) if m]
        vals = (val_parts[0] if len(val_parts) == 1
                else np.concatenate(val_parts)).astype(np.float64,
                                                       copy=False)
        # whole span inside the query range (the ODP cold path / full
        # dashboard scan): skip the mask pass — the returned arrays may
        # then VIEW the decoded-chunk cache, so callers must treat
        # read_range output as read-only (they all copy into batches,
        # grids, or encoders)
        if int(ts[0]) >= start and int(ts[-1]) <= end:
            return ts, vals
        mask = (ts >= start) & (ts <= end)
        return ts[mask], vals[mask]

