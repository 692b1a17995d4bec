"""TimeSeriesShard: per-shard ingestion state machine + device-grid scans.

Matches the reference's TimeSeriesShard (reference: core/src/main/scala/
filodb.core/memstore/TimeSeriesShard.scala:222) on the part this package
serves:

- partition registry: partkey -> part_id -> TimeSeriesPartition (:243,316)
- tag index lookups (:255, PartKeyLuceneIndex), ``lookup_partitions``
  (:1441-1488)
- flush groups: hash(partKey) % groups_per_shard with per-group recovery
  watermarks (:155-157, :488-522); the flush pipeline freezes buffers,
  writes chunks and dirty partkeys, then checkpoints (:884-974), on the
  ingest thread (``flush_all``) or pipelined through a
  :class:`~filodb_tpu_torch.memstore.flush.FlushScheduler` that watches
  ``latest_ingest_ts`` (:804-846)
- eviction by oldest end time, with a bloom filter of evicted keys
  (:1308-1401), and purge of expired partitions (:776-795); the
  cardinality tracker notes every creation and removal, and an optional
  per-tenant series quota rejects new series over its limit
- integrity: partitions report corrupt chunks through
  :meth:`note_corrupt_chunk`; the shard registers itself so the column
  store's read-back detections reach it too
- the device-grid scan surface ``scan_grid`` / ``scan_grid_grouped``,
  served from :class:`~filodb_tpu_torch.memstore.devicestore.DeviceGridCache`
- ``scan_batch``: padded host batches for the general query path (every
  query the grid does not serve)

Single-writer discipline: ``ingest`` must be called from one thread per
shard; flush tasks run on the scheduler's executor threads.  The shard's
grid lives on ``device`` (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import traceback
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch import integrity
from filodb_tpu_torch.core.chunk import ChunkBatch, build_batch
from filodb_tpu_torch.core.filters import ColumnFilter
from filodb_tpu_torch.core.record import (IngestRecord, decode_container,
                                          parse_partkey)
from filodb_tpu_torch.core.schemas import ColumnType, Schemas
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.devicestore import (DeviceGridCache,
                                                   resolve_device)
from filodb_tpu_torch.memstore.index import PartKeyIndex
from filodb_tpu_torch.memstore.cardinality import CardinalityTracker
from filodb_tpu_torch.memstore.partition import (
    TimeSeriesPartition, TracingTimeSeriesPartition, drain_pending_batch)
from filodb_tpu_torch.native import ingestfast
from filodb_tpu_torch.store.columnstore import (ColumnStore, NullColumnStore,
                                                PartKeyRecord)
from filodb_tpu_torch.store.metastore import InMemoryMetaStore, MetaStore
from filodb_tpu_torch.utils.bloom import BloomFilter
from filodb_tpu_torch.utils.devicewatch import FLIGHT
from filodb_tpu_torch.utils.observability import TRACER, flush_metrics
from filodb_tpu_torch.workload.quota import SeriesQuotaExceeded

_FLUSH_METRICS = None


def _flush_m() -> dict:
    """The filodb_flush_* metric objects, resolved once per process."""
    global _FLUSH_METRICS
    if _FLUSH_METRICS is None:
        _FLUSH_METRICS = flush_metrics()
    return _FLUSH_METRICS


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
    """Snapshot handed from the ingest thread to the flush executor
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
    partitions_evicted: int = 0
    partitions_purged: int = 0
    chunks_flushed: int = 0
    flushes_done: int = 0
    # integrity subsystem: decode/checksum corruption detected while
    # serving this shard, and how many of those chunks entered
    # quarantine here
    chunks_corrupt: int = 0
    chunks_quarantined: int = 0
    # new series rejected because their tenant hit its active-series
    # quota, and the rows those rejections dropped
    series_quota_rejected: int = 0
    rows_quota_dropped: int = 0


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
        # bumped whenever a partition leaves the in-memory map or a chunk
        # is quarantined: lets the grid cache skip re-validating every
        # requested pid per query
        self.removal_epoch = 0
        # serializes removal_epoch bumps: corruption reports arrive from
        # query threads as well as the ingest thread; a lost
        # read-modify-write would leave stale grid preps "current"
        self._epoch_lock = threading.Lock()
        self.partitions: dict[int, TimeSeriesPartition] = {}
        self.part_set: dict[bytes, int] = {}
        # part id -> 16-bit schema hash; covers index-only (recovered)
        # entries, which have no partition object yet
        self.part_schema_hash: dict[int, int] = {}
        self._next_part_id = 0
        self.num_groups = self.config.groups_per_shard
        # per-group recovery watermarks: records at offset <= watermark
        # were already persisted and are skipped
        self.group_watermarks = [-1] * self.num_groups
        self._dirty_partkeys: list[set[int]] = [set() for _ in range(self.num_groups)]
        self._dirty_lock = threading.Lock()
        self.latest_offset = -1
        # newest sample timestamp seen: drives time-boundary flush
        # scheduling (reference: createFlushTasks time boundaries :804-846)
        self.latest_ingest_ts = -1
        self.evicted_keys = BloomFilter(
            self.config.evicted_pk_bloom_filter_capacity)
        self.stats = ShardStats()
        # held only for the flush tasks' counter increments
        self._stats_lock = threading.Lock()
        # set when a bookkeeping invariant broke: the shard FAILS further
        # scans rather than serve stale buffers (the reference kills the
        # process on its reclaim meta check)
        self.integrity_failed: Optional[str] = None
        # store-level corruption detections route back here by identity
        integrity.register_shard(self)
        # the FlushScheduler currently driving this shard (set by
        # TimeSeriesMemStore.ingest_stream, or by a caller running one)
        self.flush_scheduler = None
        # active-series quota (workload/quota.py), consulted right before
        # a NEW part id is assigned; None = unlimited
        self.series_quota = None
        # O(1) churn notes at part-id assignment and evict/purge, plus
        # set_fn-sampled active-series gauges off this shard's index
        self.cardinality = CardinalityTracker(dataset, shard_num)
        self.cardinality.attach_index(self.index)
        # flush-time downsampling (reference: ShardDownsampler invoked
        # from doFlushSteps :915-917); set by enable_downsampling()
        self.downsample_publisher = None
        self.downsample_resolutions: tuple[int, ...] = ()
        self._downsamplers: dict[int, object] = {}
        # the live rollup engine's feed (``rollup``): called after each
        # successful flush task with {schema_hash: [(tags, chunkset)]}
        # and the task's ingestion time.  Never fails a flush
        self.rollup_listener = None
        # device-resident grids, one per (schema, value column)
        self.device_caches: dict = {}
        # the co-arrival batcher the grid caches offer their dispatches
        # to (batching.QueryBatcher); None = every query launches alone
        self.query_batcher = None
        # bumped whenever new rows or chunks could change query results
        # (the grid caches' tail version)
        self.ingest_epoch = 0
        # counts chunk FREEZES only (a strict subset of ingest_epoch
        # bumps): the encoded chunk set changes exactly on a freeze or a
        # removal, which is what the result cache's span table keys on
        self.freeze_epoch = 0
        self._span_table: Optional[tuple] = None     # (key, arrays)
        self._mutable_floor: Optional[tuple] = None  # (ingest_epoch, ts)

    def enable_downsampling(self, publisher, resolutions_ms) -> None:
        """Downsample every flushed chunkset at ``resolutions_ms`` into
        ``publisher`` (a ``downsample.DownsamplePublisher``).  The grid
        path's period reduce runs on this shard's device."""
        self.downsample_publisher = publisher
        self.downsample_resolutions = tuple(resolutions_ms)
        self._downsamplers = {}

    def _downsampler_for(self, schema_hash: int):
        ds = self._downsamplers.get(schema_hash)
        if ds is None:
            # imported here: the downsample package's serving store
            # imports the memstore, which imports this module
            from filodb_tpu_torch.downsample.sharddown import \
                ShardDownsampler
            ds = ShardDownsampler(self.dataset, self.shard_num,
                                  self.schemas.by_hash(schema_hash),
                                  self.downsample_publisher,
                                  self.downsample_resolutions,
                                  device=self.device)
            # keyed by schema hash: bounded by the configured schemas
            self._downsamplers[schema_hash] = ds
        return ds

    @staticmethod
    def _by_schema(pairs) -> dict[int, list]:
        """``(partition, fresh chunksets)`` pairs -> {schema_hash:
        [(tags, chunkset)]}, the downsamplers' and the rollup feed's
        shape."""
        by_schema: dict[int, list] = {}
        for part, fresh in pairs:
            by_schema.setdefault(part.schema.schema_hash, []).extend(
                (part.tags, cs) for cs in fresh)
        return by_schema

    def _downsample(self, pairs, by_schema=None) -> None:
        """Hand ``(partition, fresh chunksets)`` pairs to each schema's
        downsampler, once each (the flush task and the eviction)."""
        if by_schema is None:
            by_schema = self._by_schema(pairs)
        for shash, tagged in by_schema.items():
            self._downsampler_for(shash).downsample_chunksets(tagged)

    def close(self) -> None:
        """Release what this shard holds beyond its own objects: a flush
        scheduler still attached is closed without flushing (its
        executor threads and sampled gauges go; what is persisted is
        the caller's choice, made before close), and the cardinality
        gauges are deregistered.  The integrity hook is a weak reference
        and needs no unwinding."""
        self.cardinality.close()
        sched = self.flush_scheduler
        if sched is not None:
            self.flush_scheduler = None
            sched.close(flush_remaining=False)

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
        added_total = dropped_total = 0
        maxint = np.iinfo(np.int64).max
        # per-series scalars as Python ints, once a container
        bounds = starts.tolist()
        firsts = dec.uniq_first.tolist()
        hashes = dec.part_hashes.tolist()
        groups = groups_r.tolist()
        dirty: dict[int, set] = {}
        part_set, partitions = self.part_set, self.partitions
        try:
            for u in range(n_uniq):
                s0, s1 = bounds[u], bounds[u + 1]
                if s0 == s1:
                    continue  # every record of it was watermark-skipped
                first = firsts[u]
                pid = part_set.get(dec.partkeys[u])
                part = partitions.get(pid) if pid is not None else None
                if part is None:
                    try:
                        part = self._get_or_add_partition_pk(
                            dec.partkeys[u], schema, hashes[first],
                            int(ts_s[s0]))
                    except SeriesQuotaExceeded:
                        # an over-quota NEW series: its rows drop, the
                        # rest of the container keeps ingesting
                        self.stats.rows_quota_dropped += s1 - s0
                        self.series_quota.note_dropped_samples(
                            parse_partkey(dec.partkeys[u]), s1 - s0)
                        continue
                added, dropped = self._ingest_series_block(
                    part, ts_s[s0:s1], [c[s0:s1] for c in cols_s])
                added_total += added
                dropped_total += dropped
                if self.index.end_time(part.part_id) != maxint:
                    self.index.mark_active(part.part_id)
                dirty.setdefault(groups[first], set()).add(part.part_id)
        finally:
            # what was appended counts, and is dirty, even if a later
            # series of the container raised
            self.stats.rows_ingested += added_total
            self.stats.out_of_order_dropped += dropped_total
            with self._dirty_lock:
                for g, pids in dirty.items():
                    self._dirty_partkeys[g] |= pids
        if len(ts):
            self.latest_ingest_ts = max(self.latest_ingest_ts,
                                        int(ts.max()))
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
            try:
                part = self._get_or_add_partition_pk(
                    rec.partkey(), self.schemas.by_hash(rec.schema_hash),
                    rec.part_hash, rec.timestamp, tags=rec.tags)
            except SeriesQuotaExceeded:
                self.stats.rows_quota_dropped += 1
                self.series_quota.note_dropped_samples(rec.tags)
                continue
            if part.ingest(rec.timestamp, rec.values):
                n += 1
                self.stats.rows_ingested += 1
            else:
                self.stats.out_of_order_dropped += 1
            if self.index.end_time(part.part_id) != np.iinfo(np.int64).max:
                self.index.mark_active(part.part_id)
            with self._dirty_lock:
                self._dirty_partkeys[group].add(part.part_id)
            if rec.timestamp > self.latest_ingest_ts:
                self.latest_ingest_ts = rec.timestamp
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
            part = self.partitions.get(pid)
            if part is not None:
                return part
            # index-only entry (recovered): materialize the partition
            # under its existing part id, keeping the index lifecycle
            rtags = tags if tags is not None else parse_partkey(pk)
            part = self._partition_cls(rtags)(pid, schema, pk, rtags,
                                       part_hash % self.num_groups,
                                       capacity=self.config.max_chunks_size)
            part.on_freeze = self._on_chunk_freeze
            part.on_corrupt = self.note_corrupt_chunk
            self.partitions[pid] = part
            self.index.mark_active(pid)
            return part
        if tags is None:
            tags = parse_partkey(pk)
        if self.series_quota is not None \
                and not self.series_quota.allow_new_series(
                    tags, shard=self.shard_num):
            self.stats.series_quota_rejected += 1
            tenant = self.series_quota.tenant_of(tags)
            raise SeriesQuotaExceeded(
                tenant, self.series_quota.active(tenant),
                self.series_quota.limit_for(tenant) or 0)
        pid = self._next_part_id
        self._next_part_id += 1
        part = self._partition_cls(tags)(pid, schema, pk, tags,
                                   part_hash % self.num_groups,
                                   capacity=self.config.max_chunks_size)
        part.on_freeze = self._on_chunk_freeze
        part.on_corrupt = self.note_corrupt_chunk
        self.partitions[pid] = part
        self.part_set[pk] = pid
        self.part_schema_hash[pid] = schema.schema_hash
        self.index.add_partkey(pid, pk, tags, timestamp)
        self.stats.partitions_created += 1
        self.cardinality.note_created()
        return part

    def _partition_cls(self, tags: dict[str, str]):
        """TracingTimeSeriesPartition for series matching the
        ``trace_filters`` tag subset (reference:
        TimeSeriesPartition.scala:451); the normal class otherwise."""
        tf = self.config.trace_filters
        if tf and all(tags.get(k) == str(v) for k, v in tf.items()):
            return TracingTimeSeriesPartition
        return TimeSeriesPartition

    # ------------------------------------------------------------------ flush

    def prepare_flush_group(self, group: int,
                            ingestion_time: Optional[int] = None
                            ) -> FlushTask:
        """Ingest-thread half of a pipelined flush: O(partitions-in-group)
        buffer detaches plus state snapshots; no encoding, no IO
        (reference: prepareFlushGroup, :756-774).  The returned task runs
        on a flush executor via :meth:`run_flush_task`; tasks for the
        SAME group must run in submission order (the scheduler chains
        them)."""
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
        """Flush-executor half: encode pending buffers (frozen at prepare
        time — never the live write buffer), write chunks and dirty
        partkeys, then checkpoint (doFlushSteps, reference :884-974).
        Returns chunksets written.  On failure the chunks and dirty
        partkeys are re-queued for a later flush.  One
        ``memstore.flush`` span and the filodb_flush_* metrics a task
        (reference: Kamon spans around flush, :888-891); failures count
        before re-raising."""
        m = _flush_m()
        t0 = time.perf_counter()
        try:
            with TRACER.span("memstore.flush", dataset=self.dataset,
                             shard=self.shard_num, group=task.group):
                n = self._run_flush_task(task)
        except BaseException:
            m["failures"].inc(dataset=self.dataset)
            raise
        finally:
            m["flush_seconds"].observe(time.perf_counter() - t0,
                                       dataset=self.dataset)
        m["chunks"].inc(n, dataset=self.dataset)
        FLIGHT.record("flush", dataset=self.dataset, shard=self.shard_num,
                      group=task.group, chunks=n,
                      seconds=round(time.perf_counter() - t0, 6))
        return n

    def _run_flush_task(self, task: FlushTask) -> int:
        collected: list[tuple] = []
        try:
            chunksets = []
            # every frozen buffer of the task in one batch encode, then
            # each partition's list of chunks not yet persisted
            drain_pending_batch(task.parts)
            for part in task.parts:
                fresh = part.take_unflushed()
                if fresh:
                    collected.append((part, fresh))
                chunksets.extend(fresh)
            if chunksets:
                self.store.write_chunks(self.dataset, self.shard_num,
                                        chunksets, task.ingestion_time)
            ds_pairs: dict[int, list] = {}
            if collected and (self.downsample_publisher is not None
                              or self.rollup_listener is not None):
                ds_pairs = self._by_schema(collected)
            if self.downsample_publisher is not None and collected:
                self._downsample(collected, ds_pairs)
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
        listener = self.rollup_listener
        if listener is not None and ds_pairs:
            # the fresh chunksets go to the rollup engine AFTER they are
            # persisted and checkpointed: its restart catch-up reads the
            # store by ingestion time, so a crash between persist and
            # handoff replays, never loses
            try:
                listener(ds_pairs, task.ingestion_time)
            except Exception:  # noqa: BLE001 — rollup never fails a flush
                traceback.print_exc()
        self.group_watermarks[task.group] = max(
            self.group_watermarks[task.group], task.offset)
        # tasks of different groups finish on different executor threads:
        # a read-modify-write of a counter must not lose an update
        with self._stats_lock:
            self.stats.chunks_flushed += len(chunksets)
            self.stats.flushes_done += 1
        # proactive device-memory reclaim off the query path.  Flush tasks
        # run on executor threads, and torch's current device is per
        # thread: name the store's device for what the reclaim frees
        frac = self.config.device_headroom_frac
        if frac > 0 and self.device_caches:
            with torch.cuda.device(self.device) \
                    if self.device.type == "cuda" else _NO_DEVICE:
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

    # ------------------------------------------------------------- integrity

    def bump_removal_epoch(self) -> None:
        """Atomic removal-epoch increment; see ``_epoch_lock``."""
        with self._epoch_lock:
            self.removal_epoch += 1

    def note_corrupt_chunk(self, err, newly_quarantined: bool) -> None:
        """Partition/store hook: a chunk of this shard failed checksum
        or decode (already quarantined + logged by the integrity
        funnel); keep the per-shard tally."""
        self.stats.chunks_corrupt += 1
        if newly_quarantined:
            self.stats.chunks_quarantined += 1
            # grid preps and plans staged from this chunk must
            # revalidate; the caches drop their blocks on the quarantine
            # epoch, so the device path excludes the chunk exactly like
            # the host path's read_range does
            self.bump_removal_epoch()

    def evict_partitions(self, n: int) -> int:
        """Evict up to n longest-stopped partitions (reference
        :1308-1401).  Their data must already be flushed; the in-memory
        state and the index entry go, and the partkey is recorded in the
        evicted bloom filter.  Returns the victims considered."""
        victims = self.index.part_ids_ordered_by_end_time(n)
        for pid in victims:
            part = self.partitions.pop(pid, None)
            if part is None:
                continue
            self.bump_removal_epoch()
            self.part_set.pop(part.partkey, None)
            self.evicted_keys.add(part.partkey)
            self.index.remove([pid])
            if self.series_quota is not None:
                self.series_quota.note_removed(part.tags)
            self.stats.partitions_evicted += 1
            self.cardinality.note_removed("evict")
        return len(victims)

    def purge_expired(self, retention_ms: int, now_ms: int) -> int:
        """Drop partitions whose data aged out entirely (reference
        :776-795)."""
        cutoff = now_ms - retention_ms
        doomed = [pid for pid, p in self.partitions.items()
                  if p.latest_timestamp < cutoff]
        for pid in doomed:
            part = self.partitions.pop(pid)
            self.bump_removal_epoch()
            self.part_set.pop(part.partkey, None)
            self.index.remove([pid])
            if self.series_quota is not None:
                self.series_quota.note_removed(part.tags)
            self.stats.partitions_purged += 1
            self.cardinality.note_removed("purge")
        return len(doomed)

    def mark_stopped_series(self, now_ms: int, stale_ms: int) -> int:
        """Set the index end time of every series that stopped ingesting:
        latest sample older than ``now_ms - stale_ms``, end time still
        open (reference: updateIndexWithEndTime during flush,
        :1037-1057).  Returns how many it marked."""
        n = 0
        for pid, part in list(self.partitions.items()):
            if part.latest_timestamp < now_ms - stale_ms \
                    and self.index.end_time(pid) == np.iinfo(np.int64).max:
                self.index.update_end_time(pid, part.latest_timestamp)
                n += 1
        return n

    def _check_integrity(self) -> None:
        """Hard tripwire: once bookkeeping is known broken, refuse to
        serve (stale buffers are worse than errors)."""
        if self.integrity_failed is not None:
            raise integrity.IntegrityInvariantError(
                f"shard {self.shard_num} failed integrity: "
                f"{self.integrity_failed}")

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

    def chunk_span_table(self):
        """Flat ``(pid, chunk_id, start_time, end_time)`` int64 arrays
        over every in-memory partition's encoded chunks — the result
        cache's immutability digest source (query/resultcache.py).
        Cached per (freeze_epoch, removal_epoch, index version,
        partition count): the encoded chunk set changes exactly on
        freeze/removal, so live per-row ingest never rebuilds it.  The
        key is taken BEFORE the walk: a freeze landing mid-walk bumps
        the epoch, so the next call rebuilds instead of trusting a
        table that may have missed the chunk."""
        key = (self.freeze_epoch, self.removal_epoch, self.index.version,
               len(self.partitions))
        tbl = self._span_table
        if tbl is not None and tbl[0] == key:
            return tbl[1]
        pid_l: list = []
        cid_l: list = []
        cs_l: list = []
        ce_l: list = []
        for pid, part in list(self.partitions.items()):
            with part._lock:
                for cs in part.chunks:
                    pid_l.append(pid)
                    cid_l.append(cs.info.chunk_id)
                    cs_l.append(cs.info.start_time)
                    ce_l.append(cs.info.end_time)
        arrs = (np.asarray(pid_l, np.int64), np.asarray(cid_l, np.int64),
                np.asarray(cs_l, np.int64), np.asarray(ce_l, np.int64))
        self._span_table = (key, arrs)
        return arrs

    def mutable_floor(self) -> Optional[int]:
        """Earliest mutable (write-buffer / pending-encode) row
        timestamp across ALL partitions, or None when everything is
        encoded — the result cache's closed-segment probe, cached per
        ingest epoch so a burst of queries between ingest batches pays
        one partition walk.  Deliberately filter-independent: an
        unmatched partition's buffer marking a segment open only costs
        a cache miss, never staleness."""
        # capture the epoch BEFORE the walk (chunk_span_table does the
        # same): a row ingested mid-walk bumps the epoch and must force
        # a recompute — caching the walk under the post-bump epoch
        # would hide that row until the NEXT ingest
        epoch = self.ingest_epoch
        mf = self._mutable_floor
        if mf is not None and mf[0] == epoch:
            return mf[1]
        lo: Optional[int] = None
        for part in list(self.partitions.values()):
            mt = part.mutable_floor()
            if mt is not None and (lo is None or mt < lo):
                lo = mt
        self._mutable_floor = (epoch, lo)
        return lo

    def _partition_for_scan(self, part_id: int
                            ) -> Optional[TimeSeriesPartition]:
        """Resolve a part id for ``scan_batch``; the paging shard also
        consults its page cache."""
        return self.partitions.get(part_id)

    def grid_partition(self, part_id: int) -> Optional[TimeSeriesPartition]:
        """Resolve a part id for the device grid's block builds and plan
        validation; the paging shard serves paged partitions too."""
        return self.partitions.get(part_id)

    # --------------------------------------------------- device-resident scan

    def _on_chunk_freeze(self, cs) -> None:
        self.ingest_epoch += 1
        self.freeze_epoch += 1
        for (shash, _cid), cache in self.device_caches.items():
            if shash == cs.schema_hash or cs.schema_hash == 0:
                cache.note_freeze(cs)

    def device_cache(self, schema_hash: int, column_id: int,
                     hist: bool = False) -> DeviceGridCache:
        cache = self.device_caches.get((schema_hash, column_id))
        if cache is None:
            cache = DeviceGridCache(self, schema_hash, column_id,
                                    self.config.device_cache_bytes,
                                    self.config.grid_step_ms, hist=hist)
            self.device_caches[(schema_hash, column_id)] = cache
        return cache

    def _grid_cache_for(self, part_ids: Sequence[int],
                        column_id: Optional[int]):
        """Resolve the value column off the first partition, require a
        DOUBLE or HISTOGRAM column, fetch the cache.  The ORIGINAL
        ``part_ids`` object goes to the cache, which memoizes its lane
        preparation on that object's identity (the lookup cache keeps it
        alive)."""
        if len(part_ids) == 0:
            return None
        first = self.grid_partition(int(part_ids[0]))
        if first is None:
            return None
        cid = first.schema.data.value_column_id if column_id is None \
            else column_id
        ctype = first.schema.data.columns[cid].ctype
        if ctype not in (ColumnType.DOUBLE, ColumnType.HISTOGRAM):
            return None
        return self.device_cache(first.schema.schema_hash, cid,
                                 hist=ctype == ColumnType.HISTOGRAM)

    def scan_grid(self, part_ids: Sequence[int], func, steps0: int,
                  nsteps: int, step_ms: int, window_ms: int,
                  column_id: Optional[int] = None, fargs: tuple = ()):
        """Serve a windowed range function from the device-resident grid.
        Returns ``(tags_list, vals, bucket_tops)``: ``vals`` a tensor on
        the store's device, ``[S, T]`` with ``bucket_tops`` None for a
        scalar column, ``[S, T, hb]`` a bucket with the column's bucket
        tops for a histogram column; or None when the fast path cannot
        serve this query ("not served here": the caller scans another
        way)."""
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
        ``[G, T]`` partials come out (``[G, T, hb]`` bucket sums and
        ``bucket_tops`` for a histogram column).  Returns the mergeable
        state dict (tensors on the store's device) or None."""
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
        self._check_integrity()
        tags_list, ts_list, val_list = [], [], []
        hist = None  # locked by the first partition: one value type per batch
        bucket_tops = None
        for pid in part_ids:
            part = self._partition_for_scan(int(pid))
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


_NO_DEVICE = contextlib.nullcontext()


def _round_up(n: int, to: int) -> int:
    return ((n + to - 1) // to) * to if to else n
