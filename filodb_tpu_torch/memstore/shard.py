"""TimeSeriesShard: per-shard ingestion state machine + device-grid scans.

Matches the reference's TimeSeriesShard (reference: core/src/main/scala/
filodb.core/memstore/TimeSeriesShard.scala:222) on the part this package
serves:

- partition registry: partkey -> part_id -> TimeSeriesPartition (:243,316)
- tag index lookups (:255, PartKeyLuceneIndex), ``lookup_partitions``
  (:1441-1488)
- flush groups: hash(partKey) % groups_per_shard with per-group recovery
  watermarks (:155-157, :488-522); the flush pipeline freezes buffers,
  writes chunks and dirty partkeys, then checkpoints (:884-974)
- the device-grid scan surface ``scan_grid`` / ``scan_grid_grouped``,
  served from :class:`~filodb_tpu_torch.memstore.devicestore.DeviceGridCache`
- ``scan_batch``: padded host batches for the general query path (every
  query the grid does not serve)

Single-writer discipline: ``ingest`` must be called from one thread per
shard.  The shard's grid lives on ``device`` (CUDA unless the caller
asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, Optional, Sequence

import numpy as np

from filodb_tpu_torch.core.chunk import ChunkBatch, build_batch
from filodb_tpu_torch.core.filters import ColumnFilter
from filodb_tpu_torch.core.record import (IngestRecord, decode_container,
                                          parse_partkey)
from filodb_tpu_torch.core.schemas import ColumnType, Schemas
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.devicestore import (DeviceGridCache,
                                                   resolve_device)
from filodb_tpu_torch.memstore.index import PartKeyIndex
from filodb_tpu_torch.memstore.partition import TimeSeriesPartition
from filodb_tpu_torch.native import ingestfast
from filodb_tpu_torch.store.columnstore import (ColumnStore, NullColumnStore,
                                                PartKeyRecord)
from filodb_tpu_torch.store.metastore import InMemoryMetaStore, MetaStore


@dataclasses.dataclass
class PartLookupResult:
    """Outcome of an index lookup (reference: PartLookupResult,
    TimeSeriesShard.scala:1441-1488): in-memory part ids plus partkeys
    whose partitions are not in memory."""

    shard: int
    part_ids: np.ndarray
    missing_partkeys: list[bytes]
    first_schema_hash: Optional[int]


@dataclasses.dataclass
class FlushTask:
    """Snapshot handed from the ingest thread to the flush step
    (reference: FlushGroup, TimeSeriesShard.scala:110-160)."""

    group: int
    parts: list
    dirty: set
    offset: int
    ingestion_time: int


@dataclasses.dataclass
class ShardStats:
    """Counter bundle (reference: TimeSeriesShardStats, :37-108)."""

    rows_ingested: int = 0
    rows_skipped: int = 0
    out_of_order_dropped: int = 0
    partitions_created: int = 0
    chunks_flushed: int = 0
    flushes_done: int = 0


class TimeSeriesShard:
    def __init__(self, dataset: str, schemas: Schemas, shard_num: int,
                 config: Optional[StoreConfig] = None,
                 column_store: Optional[ColumnStore] = None,
                 meta_store: Optional[MetaStore] = None,
                 device="cuda"):
        self.dataset = dataset
        self.schemas = schemas
        self.shard_num = shard_num
        self.device = resolve_device(device)
        self.config = config or StoreConfig()
        self.store = column_store or NullColumnStore()
        self.meta = meta_store or InMemoryMetaStore()
        self.index = PartKeyIndex()
        self._lookup_cache: dict = {}
        # bumped whenever a partition leaves the in-memory map: lets the
        # grid cache skip re-validating every requested pid per query
        self.removal_epoch = 0
        self.partitions: dict[int, TimeSeriesPartition] = {}
        self.part_set: dict[bytes, int] = {}
        self._next_part_id = 0
        self.num_groups = self.config.groups_per_shard
        # per-group recovery watermarks: records at offset <= watermark
        # were already persisted and are skipped
        self.group_watermarks = [-1] * self.num_groups
        self._dirty_partkeys: list[set[int]] = [set() for _ in range(self.num_groups)]
        self._dirty_lock = threading.Lock()
        self.latest_offset = -1
        self.stats = ShardStats()
        # device-resident grids, one per (schema, value column)
        self.device_caches: dict = {}
        # bumped whenever new rows or chunks could change query results
        # (the grid caches' tail version)
        self.ingest_epoch = 0

    # ------------------------------------------------------------------ ingest

    def ingest_container(self, container: bytes, offset: int) -> int:
        fast = self._ingest_container_fast(container, offset)
        if fast is not None:
            return fast
        return self.ingest(decode_container(container, self.schemas), offset)

    def _ingest_container_fast(self, container: bytes, offset: int
                               ) -> Optional[int]:
        """Columnar ingest: C++ container decode + per-series batch append
        (native/ingestfast.py).  Returns None when this container can't
        take the fast path (string columns, mixed schemas, no compiler);
        the caller then runs the per-record path.  Semantics match
        :meth:`ingest`."""
        dec = ingestfast.decode(container, self.schemas)
        if dec is None:
            return None
        if dec.num_records == 0:
            self.latest_offset = max(self.latest_offset, offset)
            return 0
        schema = self.schemas.by_hash(dec.schema_hash)
        ts, cols, uniq_idx = dec.ts, dec.cols, dec.uniq_idx
        groups_r = (dec.part_hashes % np.uint32(self.num_groups)).astype(
            np.int64)
        # recovery watermark skip (reference IngestConsumer :488-522)
        if offset <= max(self.group_watermarks):
            keep = offset > np.asarray(self.group_watermarks)[groups_r]
            skipped = int((~keep).sum())
            if skipped:
                self.stats.rows_skipped += skipped
                ts, uniq_idx = ts[keep], uniq_idx[keep]
                cols = [c[keep] for c in cols]
        n_uniq = len(dec.partkeys)
        order = np.argsort(uniq_idx, kind="stable")
        ts_s = ts[order]
        cols_s = [c[order] for c in cols]
        counts = np.bincount(uniq_idx, minlength=n_uniq)
        starts = np.concatenate(([0], np.cumsum(counts)))
        added_total = 0
        maxint = np.iinfo(np.int64).max
        for u in range(n_uniq):
            s0, s1 = int(starts[u]), int(starts[u + 1])
            if s0 == s1:
                continue  # every record of this series was watermark-skipped
            first = int(dec.uniq_first[u])
            part = self._get_or_add_partition_pk(
                dec.partkeys[u], schema, int(dec.part_hashes[first]),
                int(ts_s[s0]))
            added, dropped = self._ingest_series_block(
                part, ts_s[s0:s1], [c[s0:s1] for c in cols_s])
            added_total += added
            self.stats.rows_ingested += added
            self.stats.out_of_order_dropped += dropped
            if self.index.end_time(part.part_id) != maxint:
                self.index.mark_active(part.part_id)
            with self._dirty_lock:
                self._dirty_partkeys[int(groups_r[first])].add(part.part_id)
        self.latest_offset = max(self.latest_offset, offset)
        if added_total:
            self.ingest_epoch += 1
        return added_total

    @staticmethod
    def _ingest_series_block(part, ts: np.ndarray, cols: list
                             ) -> tuple[int, int]:
        """Batch-append one series' rows.  HistColumn entries become
        (bucket scheme, counts matrix) pairs when the run is uniform (one
        scheme, one width); otherwise the run ingests per record so
        bucket-scheme-switch semantics match the slow path exactly."""
        block_cols: list = []
        uniform = True
        for c in cols:
            if not isinstance(c, ingestfast.HistColumn):
                block_cols.append(c)
                continue
            if len(c.schemes) > 1 and \
                    (c.scheme_idx != c.scheme_idx[0]).any():
                uniform = False
                break
            nb0 = int(c.nbuckets[0])
            if (c.nbuckets != nb0).any():
                uniform = False
                break
            block_cols.append((c.schemes[int(c.scheme_idx[0])],
                               c.counts[:, :nb0]))
        if uniform:
            return part.ingest_block(ts, block_cols)
        added = dropped = 0
        for i in range(len(ts)):
            # .copy(): a buffered row view would pin the whole container
            # counts matrix until the buffer freezes
            row = [(c.schemes[int(c.scheme_idx[i])],
                    c.counts[i, :int(c.nbuckets[i])].copy())
                   if isinstance(c, ingestfast.HistColumn) else c[i]
                   for c in cols]
            if part.ingest(int(ts[i]), row):
                added += 1
            else:
                dropped += 1
        return added, dropped

    def ingest(self, records: Iterable[IngestRecord], offset: int) -> int:
        """Ingest a batch of records at a stream offset.  Returns rows
        added.  Group watermark skipping mirrors the reference's
        IngestConsumer (:488-522)."""
        n = 0
        for rec in records:
            group = rec.part_hash % self.num_groups
            if offset <= self.group_watermarks[group]:
                self.stats.rows_skipped += 1
                continue
            part = self._get_or_add_partition_pk(
                rec.partkey(), self.schemas.by_hash(rec.schema_hash),
                rec.part_hash, rec.timestamp, tags=rec.tags)
            if part.ingest(rec.timestamp, rec.values):
                n += 1
                self.stats.rows_ingested += 1
            else:
                self.stats.out_of_order_dropped += 1
            if self.index.end_time(part.part_id) != np.iinfo(np.int64).max:
                self.index.mark_active(part.part_id)
            with self._dirty_lock:
                self._dirty_partkeys[group].add(part.part_id)
        self.latest_offset = max(self.latest_offset, offset)
        if n:
            self.ingest_epoch += 1
        return n

    def _get_or_add_partition_pk(self, pk: bytes, schema, part_hash: int,
                                 timestamp: int, tags: Optional[dict] = None
                                 ) -> TimeSeriesPartition:
        """Partition registry lookup/creation keyed by raw partkey bytes;
        tags are parsed only for new series (reference: partSet lookup,
        TimeSeriesShard.scala:1091)."""
        pid = self.part_set.get(pk)
        if pid is not None:
            return self.partitions[pid]
        if tags is None:
            tags = parse_partkey(pk)
        pid = self._next_part_id
        self._next_part_id += 1
        part = TimeSeriesPartition(pid, schema, pk, tags,
                                   part_hash % self.num_groups,
                                   capacity=self.config.max_chunks_size)
        part.on_freeze = self._on_chunk_freeze
        self.partitions[pid] = part
        self.part_set[pk] = pid
        self.index.add_partkey(pid, pk, tags, timestamp)
        self.stats.partitions_created += 1
        return part

    # ------------------------------------------------------------------ flush

    def prepare_flush_group(self, group: int,
                            ingestion_time: Optional[int] = None
                            ) -> FlushTask:
        """Ingest-thread half of a flush: buffer detaches plus state
        snapshots (reference: prepareFlushGroup, :756-774)."""
        itime = ingestion_time if ingestion_time is not None \
            else int(time.time() * 1000)
        parts = [p for p in self.partitions.values() if p.group == group]
        for part in parts:
            part.freeze_raw()
        with self._dirty_lock:
            dirty = self._dirty_partkeys[group]
            self._dirty_partkeys[group] = set()
        return FlushTask(group=group, parts=parts, dirty=dirty,
                         offset=self.latest_offset, ingestion_time=itime)

    def run_flush_task(self, task: FlushTask) -> int:
        """Encode pending buffers, write chunks and dirty partkeys, then
        checkpoint (doFlushSteps, reference :884-974).  Returns chunksets
        written.  On failure the chunks and dirty partkeys are re-queued
        for a later flush."""
        collected: list[tuple] = []
        try:
            chunksets = []
            for part in task.parts:
                fresh = part.collect_flush_chunks()
                if fresh:
                    collected.append((part, fresh))
                chunksets.extend(fresh)
            if chunksets:
                self.store.write_chunks(self.dataset, self.shard_num,
                                        chunksets, task.ingestion_time)
            if task.dirty:
                recs = [PartKeyRecord(self.index.partkey(pid),
                                      self.index.start_time(pid),
                                      self.index.end_time(pid),
                                      self.shard_num,
                                      self.partitions[pid].schema.schema_hash)
                        for pid in task.dirty if pid in self.partitions]
                self.store.write_part_keys(self.dataset, self.shard_num, recs)
        except BaseException:
            for part, fresh in collected:
                part.requeue_unflushed(fresh)
            with self._dirty_lock:
                self._dirty_partkeys[task.group] |= task.dirty
            raise
        # checkpoint only after chunks+partkeys persisted (reference :949-960)
        self.meta.write_checkpoint(self.dataset, self.shard_num, task.group,
                                   task.offset)
        self.group_watermarks[task.group] = max(
            self.group_watermarks[task.group], task.offset)
        self.stats.chunks_flushed += len(chunksets)
        self.stats.flushes_done += 1
        # proactive device-memory reclaim off the query path
        frac = self.config.device_headroom_frac
        if frac > 0:
            for cache in list(self.device_caches.values()):
                cache.ensure_headroom(frac)
        return len(chunksets)

    def flush_group(self, group: int,
                    ingestion_time: Optional[int] = None) -> int:
        """Synchronous flush of one group (prepare + run inline)."""
        return self.run_flush_task(self.prepare_flush_group(group,
                                                            ingestion_time))

    def flush_all(self, ingestion_time: Optional[int] = None) -> int:
        return sum(self.flush_group(g, ingestion_time)
                   for g in range(self.num_groups))

    # ------------------------------------------------------------------ query

    def lookup_partitions(self, filters: Sequence[ColumnFilter],
                          start_time: int, end_time: int,
                          limit: Optional[int] = None) -> PartLookupResult:
        """Index lookup restricted to ONE schema, the first matched
        (reference: MultiSchemaPartitionsExec.scala:41-85).  Cached on
        (filters, range, index version): the cached result's identity is
        what the grid cache memoizes its lane preparation on."""
        key = (tuple(filters), start_time, end_time, limit,
               self.index.version, len(self.partitions))
        cached = self._lookup_cache.get(key)
        if cached is not None:
            return cached
        ids = self.index.part_ids_from_filters(filters, start_time,
                                               end_time, limit)
        first_schema = None
        in_mem: list[int] = []
        missing: list[bytes] = []
        for i in ids:
            pid = int(i)
            part = self.partitions.get(pid)
            if part is None:
                missing.append(self.index.partkey(pid))
                continue
            if first_schema is None:
                first_schema = part.schema.schema_hash
            if part.schema.schema_hash == first_schema:
                in_mem.append(pid)
        result = PartLookupResult(self.shard_num,
                                  np.asarray(in_mem, dtype=np.int32),
                                  missing, first_schema)
        if len(self._lookup_cache) > 64:
            self._lookup_cache.clear()
        self._lookup_cache[key] = result
        return result

    def grid_partition(self, part_id: int) -> Optional[TimeSeriesPartition]:
        """Resolve a part id for the device grid's block builds and plan
        validation."""
        return self.partitions.get(part_id)

    # --------------------------------------------------- device-resident scan

    def _on_chunk_freeze(self, cs) -> None:
        self.ingest_epoch += 1
        for (shash, _cid), cache in self.device_caches.items():
            if shash == cs.schema_hash or cs.schema_hash == 0:
                cache.note_freeze(cs)

    def device_cache(self, schema_hash: int, column_id: int
                     ) -> DeviceGridCache:
        cache = self.device_caches.get((schema_hash, column_id))
        if cache is None:
            cache = DeviceGridCache(self, schema_hash, column_id,
                                    self.config.device_cache_bytes,
                                    self.config.grid_step_ms)
            self.device_caches[(schema_hash, column_id)] = cache
        return cache

    def _grid_cache_for(self, part_ids: Sequence[int],
                        column_id: Optional[int]):
        """Resolve the value column off the first partition, require a
        DOUBLE column, fetch the cache.  The ORIGINAL ``part_ids`` object
        goes to the cache, which memoizes its lane preparation on that
        object's identity (the lookup cache keeps it alive)."""
        if len(part_ids) == 0:
            return None
        first = self.grid_partition(int(part_ids[0]))
        if first is None:
            return None
        cid = first.schema.data.value_column_id if column_id is None \
            else column_id
        if first.schema.data.columns[cid].ctype != ColumnType.DOUBLE:
            return None
        return self.device_cache(first.schema.schema_hash, cid)

    def scan_grid(self, part_ids: Sequence[int], func, steps0: int,
                  nsteps: int, step_ms: int, window_ms: int,
                  column_id: Optional[int] = None, fargs: tuple = ()):
        """Serve a windowed range function from the device-resident grid.
        Returns ``(tags_list, vals [S, T], None)`` with ``vals`` a tensor
        on the store's device, or None when the fast path cannot serve
        this query ("not served here": the caller scans another way)."""
        cache = self._grid_cache_for(part_ids, column_id)
        if cache is None:
            return None
        served = cache.scan_rate(part_ids, func, steps0, nsteps, step_ms,
                                 window_ms, fargs)
        if served is None:
            return None
        vals, tops = served
        tags_list = []
        for pid in part_ids:
            part = self.grid_partition(int(pid))
            if part is None:
                return None   # evicted mid-query
            tags_list.append(part.tags)
        return tags_list, vals, tops

    def scan_grid_grouped(self, part_ids: Sequence[int], func, steps0: int,
                          nsteps: int, step_ms: int, window_ms: int,
                          group_ids: Sequence[int], num_groups: int,
                          op: str, column_id: Optional[int] = None,
                          fargs: tuple = ()):
        """Fused ``agg by (g)(fn(...))`` from the device grid: only
        ``[G, T]`` partials come out.  Returns the mergeable state dict
        (tensors on the store's device) or None."""
        cache = self._grid_cache_for(part_ids, column_id)
        if cache is None:
            return None
        return cache.scan_rate_grouped(part_ids, func, steps0, nsteps,
                                       step_ms, window_ms, group_ids,
                                       num_groups, op, fargs)

    def scan_batch(self, part_ids: Sequence[int], start_time: int,
                   end_time: int, column_id: Optional[int] = None
                   ) -> tuple[list[dict], Optional[ChunkBatch]]:
        """Materialize partitions into one padded host ChunkBatch + tag
        dicts: the general query path's input, for every query the
        device grid does not serve (reference: scanPartitions /
        RawDataRangeVector iteration :1490, SelectRawPartitionsExec)."""
        tags_list, ts_list, val_list = [], [], []
        hist = None  # locked by the first partition: one value type per batch
        bucket_tops = None
        for pid in part_ids:
            part = self.partitions.get(int(pid))
            if part is None:
                continue
            cid = part.schema.data.value_column_id if column_id is None \
                else column_id
            is_hist = part.schema.data.columns[cid].ctype \
                == ColumnType.HISTOGRAM
            if hist is None:
                hist = is_hist
            elif is_hist != hist:
                continue  # mixed schemas: callers scan one schema at a time
            ts, vals = part.read_range(start_time, end_time, cid)
            tags_list.append(part.tags)
            ts_list.append(ts)
            if is_hist:
                buckets, rows = vals
                if buckets is not None:
                    tops = buckets.bucket_tops()
                    if bucket_tops is None or len(tops) > len(bucket_tops):
                        bucket_tops = tops
                val_list.append(rows.astype(np.float64))
            else:
                val_list.append(vals)
        if not tags_list:
            return [], None
        pad_series = _round_up(len(tags_list), self.config.batch_series_pad)
        if hist:
            if bucket_tops is None:
                bucket_tops = np.empty(0, dtype=np.float64)
            b = len(bucket_tops)
            # narrower bucket schemes edge-pad: their top bucket already
            # holds the total count
            val_list = [v if v.shape[1] == b
                        else np.zeros((0, b)) if v.size == 0
                        else np.pad(v, ((0, 0), (0, b - v.shape[1])),
                                    mode="edge")
                        if v.shape[1] < b else v[:, :b] for v in val_list]
            batch = build_batch(ts_list, val_list,
                                pad_to=self.config.batch_row_pad, hist=True,
                                bucket_tops=bucket_tops,
                                pad_series_to=pad_series)
        else:
            batch = build_batch(ts_list, val_list,
                                pad_to=self.config.batch_row_pad,
                                pad_series_to=pad_series)
        return tags_list, batch

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)


def _round_up(n: int, to: int) -> int:
    return ((n + to - 1) // to) * to if to else n
