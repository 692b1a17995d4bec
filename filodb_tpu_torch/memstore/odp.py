"""On-demand paging: serve queries for series whose chunks live only on disk.

Capability match for the reference's OnDemandPagingShard +
DemandPagedChunkStore (reference: core/src/main/scala/filodb.core/
memstore/OnDemandPagingShard.scala, DemandPagedChunkStore.scala:34): on
query, partitions found in the tag index but absent from memory (evicted,
or index-bootstrapped after restart) have their raw chunks read back from
the ColumnStore and re-materialized.  Paged partitions are read-only and
live in a bytes-bounded LRU cache — the stand-in for time-bucketed block
memory with reclaim-on-demand.  A paged partition always holds its FULL
persisted history (cache granularity is the partition), so repeated
queries at different ranges see consistent data.

Also enforces the per-query scanned-data cap over chunks overlapping the
query range (``StoreConfig.max_data_per_shard_query``; reference
capDataScannedPerShardCheck).

Host code: the page-in reads sqlite and decodes on the CPU (the native
batch decoder, ``native/src/codecs.cpp``); the device sees paged
partitions only through the grid cache's block builds, like any other
partition.  A batch decoder that failed to build is an error here, not a
slower path: only a deliberately disabled one (``native.disable()``)
pages in partition by partition.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import struct
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from filodb_tpu_torch import integrity, native
from filodb_tpu_torch.core.chunk import (ChunkBatch, ChunkSet, ChunkSetInfo,
                                         counts_pad, fill_batch_pads,
                                         pad_rows)
from filodb_tpu_torch.core.filters import ColumnFilter
from filodb_tpu_torch.core.record import parse_partkey
from filodb_tpu_torch.core.schemas import ColumnType
from filodb_tpu_torch.integrity import IntegrityInvariantError
from filodb_tpu_torch.memstore.partition import (TimeSeriesPartition,
                                                 make_flush_chunks)
from filodb_tpu_torch.memstore.shard import (PartLookupResult,
                                             TimeSeriesShard, _round_up)
from filodb_tpu_torch.store.columnstore import (PartKeyRecord,
                                                ScanBytesExceeded)
from filodb_tpu_torch.store.persistence import unpack_vectors
from filodb_tpu_torch.utils.devicewatch import FLIGHT, LEDGER
from filodb_tpu_torch.utils.observability import (TRACER, integrity_metrics,
                                                  odp_metrics)

_MAX_TIME = 2**62

_LOG = logging.getLogger("filodb.odp")
# numbers the page caches' LEDGER pools: two stores may open the same
# (dataset, shard), and each pool must stay its own
_POOL_SEQ = itertools.count()
_EMPTY_I64 = np.empty(0, dtype=np.int64)
_U16 = struct.Struct("<H")

_NUMERIC = (ColumnType.TIMESTAMP, ColumnType.LONG, ColumnType.INT,
            ColumnType.DOUBLE)


class QueryLimitExceeded(Exception):
    """A query would scan more bytes than max_data_per_shard_query allows."""


def _active_ctx():
    """The ExecContext of the scan on THIS thread (None off the query
    path, e.g. the deferred publish thread).  Lazy import: exec.py
    imports the memstore package at module load."""
    from filodb_tpu_torch.query.exec import active_exec_ctx
    return active_exec_ctx()


def _batch_decoder():
    """The native batch decoder; None only when it was disabled on
    purpose.  A decoder that failed to build raises: the bulk page-in is
    the path, and the per-partition one must not stand in for it
    unnoticed."""
    nb = native.batch_decoder()
    if nb is None:
        err = native.build_error()
        if err is not None:
            raise RuntimeError(f"the native batch decoder did not build: "
                               f"{err}")
    return nb


_ODP_METRICS = None


def _odp_m() -> dict:
    """The filodb_odp_* metric objects, resolved ONCE — page-ins must
    not serialize on the registry lock for pure lookups."""
    global _ODP_METRICS
    if _ODP_METRICS is None:
        _ODP_METRICS = odp_metrics()
    return _ODP_METRICS


@contextlib.contextmanager
def _pagein_timed(shard, kind: str):
    """Span + filodb_odp_* latency + per-query decode-stage attribution
    around a page-in (reference: Kamon spans around ODP,
    OnDemandPagingShard.scala)."""
    t0 = time.perf_counter()
    try:
        with TRACER.span("odp.pagein", dataset=shard.dataset,
                         shard=shard.shard_num, kind=kind):
            yield
    finally:
        dt = time.perf_counter() - t0
        _odp_m()["pagein_seconds"].observe(dt, dataset=shard.dataset)
        ctx = _active_ctx()
        if ctx is not None:
            ctx.note_timing("decode", dt)


class _LazyVectors:
    """Sequence of encoded vector spans, unpacked from the framed row
    blob on first access.  Bulk-paged partitions rarely touch the
    encoded bytes — queries serve from the pre-filled decoded cache —
    so the per-row unpack is deferred until something (a per-chunk
    decode) actually asks."""

    __slots__ = ("_blob", "_vecs")

    def __init__(self, blob: bytes):
        self._blob = blob
        self._vecs = None

    def _force(self) -> list:
        if self._vecs is None:
            self._vecs = unpack_vectors(self._blob)
        return self._vecs

    def __getitem__(self, i):
        return self._force()[i]

    def __len__(self) -> int:
        return len(self._force())

    def __iter__(self):
        return iter(self._force())


@dataclasses.dataclass
class PagedChunkSet(ChunkSet):
    """ChunkSet over a raw framed ColumnStore row blob: ``vectors``
    unpack lazily and ``nbytes`` is precomputed — the bulk page-in
    builds thousands per query and only the decoded cache is hot."""

    raw_nbytes: int = 0

    @property
    def nbytes(self) -> int:
        return self.raw_nbytes


class _PagedPartitions:
    """Bytes-bounded LRU of read-only re-materialized partitions (int keys)
    and backfill chunk lists for live partitions (``("bf", pid)`` keys).

    All methods take an internal lock: ODP shards are queried concurrently
    from HTTP handler threads, so the OrderedDict reorder + byte accounting
    must not interleave."""

    def __init__(self, max_bytes: int, on_evict=None):
        self.max_bytes = max_bytes
        self._entries: OrderedDict = OrderedDict()   # key -> (value, nbytes)
        self._bytes = 0
        self._lock = threading.Lock()
        # invalidation generations: pop() stamps the key with a bumped
        # gen under the lock, and a deferred put_many carrying gen_guard
        # drops exactly the items whose key was popped SINCE the guard
        # was captured — so an evict's pop and a late publish's insert
        # are safe in EITHER order (pop-then-insert would otherwise
        # resurrect a stale partition missing chunks flushed at
        # eviction), while unrelated evictions don't cancel a
        # cold-dashboard publish wholesale.  _pop_floor bounds the stamp
        # map: below it, guarded puts drop everything (rare overflow)
        self.gen = 0
        self._pop_gen: dict = {}
        self._pop_floor = 0
        # called AFTER put releases the lock when LRU pressure dropped an
        # entry (deadlock-safe; implementations must not assume mutual
        # exclusion with concurrent put/get) — the ODP shard bumps its
        # removal epoch so grid plan memos referencing the evicted
        # partition revalidate
        self._on_evict = on_evict

    def get(self, key):
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            self._entries.move_to_end(key)
            return ent[0]

    def put(self, key, value, nbytes: int) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            evicted = False
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_ev, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                evicted = True
        if evicted and self._on_evict is not None:
            self._on_evict()

    def snapshot(self) -> dict:
        """One-lock read view {key: value} — the bulk scan classifies
        thousands of ids without a lock round-trip (and LRU reorder)
        per id; recency is restored afterwards via :meth:`touch_many`."""
        with self._lock:
            return {k: v[0] for k, v in self._entries.items()}

    def touch_many(self, keys: Sequence) -> None:
        """Refresh LRU recency for keys served by a bulk scan (one lock
        for the whole batch)."""
        with self._lock:
            move = self._entries.move_to_end
            for k in keys:
                if k in self._entries:
                    move(k)

    def put_many(self, items: Sequence[tuple],
                 gen_guard: Optional[int] = None) -> None:
        """Batch put of (key, value, nbytes): ONE lock acquisition for a
        bulk page-in (thousands of partitions per cold dashboard).  With
        ``gen_guard``, items whose key was pop()ed since the guard was
        captured are dropped (deferred publishes must not resurrect
        explicitly-invalidated partitions; the rest of the batch still
        lands)."""
        with self._lock:
            if gen_guard is not None:
                if gen_guard < self._pop_floor:
                    return          # stamp map overflowed: conservative
                pg = self._pop_gen
                if pg:
                    items = [it for it in items
                             if pg.get(it[0], 0) <= gen_guard]
            for key, value, nbytes in items:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._bytes -= old[1]
                self._entries[key] = (value, nbytes)
                self._bytes += nbytes
            evicted = False
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_ev, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                evicted = True
        if evicted and self._on_evict is not None:
            self._on_evict()

    def pop(self, key) -> None:
        with self._lock:
            self.gen += 1
            self._pop_gen[key] = self.gen   # cancels in-flight publish
            if len(self._pop_gen) > 65536:  # bound the stamp map
                self._pop_floor = self.gen
                self._pop_gen.clear()
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            if self._bytes < 0:   # O(1) reclaim-bookkeeping tripwire
                raise IntegrityInvariantError(
                    f"paged LRU byte accounting went negative "
                    f"({self._bytes}) popping {key!r}")

    def current_gen(self) -> int:
        """The invalidation generation read UNDER the lock: guard
        capture for a deferred publish must not race a concurrent
        pop()'s bump."""
        with self._lock:
            return self.gen

    def check_invariants(self) -> None:
        """Hard reclaim-bookkeeping check: tracked bytes must equal the
        sum over live entries.  Raises IntegrityInvariantError on drift
        — callers fail the shard rather than serve stale buffers (the
        reference's reclaim meta-size check kills the process,
        TimeSeriesShard.scala:279-301)."""
        with self._lock:
            actual = sum(nb for _v, nb in self._entries.values())
            if actual != self._bytes or self._bytes < 0:
                raise IntegrityInvariantError(
                    f"paged LRU byte accounting drift: tracked="
                    f"{self._bytes} actual={actual} "
                    f"entries={len(self._entries)}")

    def __len__(self) -> int:
        """Number of cached whole partitions (backfill entries excluded)."""
        with self._lock:
            return sum(1 for k in self._entries if isinstance(k, int))


class OnDemandPagingShard(TimeSeriesShard):
    """TimeSeriesShard that pages missing partitions from the ColumnStore."""

    def __init__(self, *args, page_cache_bytes: Optional[int] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if page_cache_bytes is None:
            page_cache_bytes = self.config.page_cache_bytes
        self.paged = _PagedPartitions(page_cache_bytes,
                                      on_evict=self._on_page_evict)
        # the page cache is a budgeted resident arena like the device
        # grids: a sampled ledger pool shows who holds it
        self._ledger_owner = (f"odp:{self.dataset}/{self.shard_num}"
                              f"#{next(_POOL_SEQ)}")
        paged = self.paged
        LEDGER.register_pool(self._ledger_owner,
                             lambda: paged._bytes,
                             lambda: paged.max_bytes)
        # serializes page-in / backfill store reads across query threads so
        # concurrent misses for the same partition don't duplicate work
        # (outermost in the paging hierarchy):
        # lock-order: _odp_lock < _PagedPartitions._lock
        self._odp_lock = threading.Lock()
        # partitions pinned by an in-flight scan on THIS thread: strong
        # references so mid-query LRU eviction cannot drop them from results
        self._pinned = threading.local()
        # in-flight deferred page-cache publishes (fused cold scans hand
        # the query its batch first and materialize skeletons for the
        # cache on this side thread — reference:
        # DemandPagedChunkStore.scala:34 pages into block memory via
        # futures too); queries that MISS the cache join these first so
        # a publish-in-progress never causes a redundant re-page.  Each
        # entry is (thread, frozenset of pids the publish will land) so
        # per-pid misses join ONLY publishes that could contain them.
        self._mat_tasks: list[tuple[threading.Thread, frozenset]] = []
        self.stats.partitions_paged = 0
        self.stats.chunks_paged = 0
        self.stats.page_publish_errors = 0
        # bulk page-decode calls that hit a corrupt-input sentinel and
        # fell back to the per-chunk path (which diagnoses + quarantines)
        self.stats.page_decode_corrupt = 0

    def close(self) -> None:
        """The page-cache pool registration is a set_fn gauge holding
        this shard's paged-LRU alive: deregister it on teardown."""
        LEDGER.deregister_pool(self._ledger_owner)
        super().close()

    def _join_materialize(self, part_id: Optional[int] = None) -> None:
        # peek-join-remove (NOT pop-then-join): a task must stay visible
        # to concurrent threads until its publish has actually landed,
        # or a third thread could classify a miss mid-publish and
        # duplicate the whole store read.  With ``part_id``, only joins
        # publishes whose pid set could contain it: a cache-miss
        # reader must not block behind an unrelated cold dashboard's
        # thousand-partition page-in; the argless form
        # (bulk classification under _odp_lock) still joins everything.
        while True:
            tasks = [e for e in self._mat_tasks
                     if part_id is None or part_id in e[1]]
            if not tasks:
                return
            entry = tasks[-1]
            entry[0].join()
            try:
                self._mat_tasks.remove(entry)
            except ValueError:
                pass       # another joiner removed it after its join

    def _paged_or_join(self, part_id: int) -> Optional[TimeSeriesPartition]:
        """Page-cache read that joins an in-flight deferred publish on a
        miss (shared by every per-pid resolution path).  Joins ONLY
        publishes tracking this pid, so an unrelated publish-in-progress
        never serializes this reader behind it."""
        part = self.paged.get(part_id)
        if part is None and self._mat_tasks:
            self._join_materialize(part_id)
            part = self.paged.get(part_id)
        return part

    def _note_paged(self, nparts: int, nchunks: int) -> None:
        """Page-in accounting in ONE place: shard stats, the
        filodb_odp_* counters, and the active query's pages-in/chunks
        resource counters (absent on the deferred publish thread)."""
        m = _odp_m()
        if nparts:
            self.stats.partitions_paged += nparts
            m["partitions"].inc(nparts, dataset=self.dataset)
        if nchunks:
            self.stats.chunks_paged += nchunks
            m["chunks"].inc(nchunks, dataset=self.dataset)
        ctx = _active_ctx()
        if ctx is not None:
            ctx.note_counts(chunks=nchunks, pages=nparts)
        if nparts or nchunks:
            FLIGHT.record("odp.pagein", dataset=self.dataset,
                          shard=self.shard_num, partitions=nparts,
                          chunks=nchunks)

    def _on_page_evict(self) -> None:
        # called after the page-cache lock is released; concurrent evictions
        # from multiple query threads must not lose an increment (a lost
        # bump would leave a grid prep stamped "current" despite an
        # eviction it never observed)
        self.bump_removal_epoch()
        LEDGER.note_eviction(self._ledger_owner, "budget_overflow")

    # ------------------------------------------------------------ resolution

    def _partition_for_scan(self, part_id: int
                            ) -> Optional[TimeSeriesPartition]:
        pinned = getattr(self._pinned, "parts", None)
        if pinned is not None:
            part = pinned.get(part_id)
            if part is not None:
                return part
        part = self.partitions.get(part_id)
        if part is None:
            part = self._paged_or_join(part_id)
        return part

    def grid_partition(self, part_id: int) -> Optional[TimeSeriesPartition]:
        """PAGED partitions serve the device grid too: once a dashboard
        pages history in, its chunks register as grid blocks and repeat
        hits serve at device speed (reference:
        DemandPagedChunkStore.scala:34 pages into block memory).  Paged
        partitions hold their FULL persisted history, so the grid's
        disk-floor proof passes naturally; page-cache eviction bumps the
        shard's removal epoch, invalidating grid plans that referenced
        the evicted partition."""
        part = self.partitions.get(part_id)
        if part is None:
            part = self._paged_or_join(part_id)
        return part

    def _resolve_partitions(self, part_ids: Sequence[int], start_time: int,
                            end_time: int) -> dict[int, TimeSeriesPartition]:
        """Resolve every id, paging absent partitions (full history) and
        backfilling older on-disk chunks of recovery-tail residents.  The
        scanned-bytes cap is enforced BEFORE any vector leaves the store
        (reference: capDataScannedPerShardCheck runs before paging)."""
        resident: dict[int, TimeSeriesPartition] = {}
        missing: list[int] = []
        for pid in part_ids:
            pid = int(pid)
            part = self.partitions.get(pid)
            if part is not None:
                resident[pid] = part
                continue
            part = self.paged.get(pid)
            if part is None:
                missing.append(pid)
            else:
                resident[pid] = part
        self._cap_data_scanned(resident.values(), missing, start_time,
                               end_time)
        for pid, part in list(resident.items()):
            if pid in self.partitions:
                # live partition: may hold only its post-recovery tail
                resident[pid] = self._with_backfill(part)
        if missing:
            self._page_in(missing, resident)
        return resident

    def _with_backfill(self, part: TimeSeriesPartition) -> TimeSeriesPartition:
        """A live partition re-materialized during recovery holds only rows
        replayed after the checkpoint; its older chunks stayed on disk
        (reference: OnDemandPagingShard computes missing chunk time-ranges
        per partition).  Newer-than-resident chunks cannot exist for a live
        partition — it is the single writer of its own tail.

        The live partition is NEVER mutated from the query thread: the
        ingest thread is its single writer.  Instead the older chunks are
        cached in the paged LRU and the scan gets a read-only snapshot
        object whose chunk list is a fresh ``older + live`` copy."""
        earliest = part.earliest_timestamp
        if earliest < 0:
            earliest = _MAX_TIME
        try:
            idx_start = self.index.start_time(part.part_id)
        except KeyError:
            return part
        if idx_start >= earliest:
            return part  # nothing on disk predates memory
        key = ("bf", part.part_id)
        older = self.paged.get(key)
        if older is None:
            with self._odp_lock:
                older = self.paged.get(key)
                if older is None:
                    have = {c.info.chunk_id for c in list(part.chunks)}
                    older = []
                    for _pk, chunksets in self.store.read_raw_partitions(
                            self.dataset, self.shard_num, [part.partkey],
                            idx_start, earliest - 1):
                        older.extend(cs for cs in chunksets
                                     if cs.info.chunk_id not in have)
                    older.sort(key=lambda c: c.info.chunk_id)
                    # cache only while this exact partition object is still
                    # live: a concurrent eviction + re-ingest reuses the pid
                    # and the old list would hide the chunks flushed at
                    # eviction time
                    if self.partitions.get(part.part_id) is part:
                        self.paged.put(key, older,
                                       sum(c.nbytes for c in older))
                    self._note_paged(0, len(older))
        if not older:
            return part
        snap = TimeSeriesPartition.__new__(TimeSeriesPartition)
        for slot in TimeSeriesPartition.__slots__:
            setattr(snap, slot, getattr(part, slot))
        snap.chunks = older + part.chunks   # fresh list; live one untouched
        snap._unflushed = []
        return snap

    def _page_in_bulk(self, part_ids: Sequence[int],
                      byte_cap: Optional[int] = None, fuse=None):
        """Vectorized page-in: ONE sqlite pass for the raw framed rows
        (a full-shard range scan when most of the shard is wanted), one
        native decode call per column for the whole set, partitions
        materialized with their decoded caches pre-filled (reference:
        DemandPagedChunkStore.scala:34 pages raw chunks straight into
        block memory — no per-chunk object dance).

        Returns None when the set needs the per-partition path (native
        off, store without raw rows, mixed/unknown schemas, non-numeric
        columns), else ``(built, tags, batch)``: pid->part, plus a
        ready query batch when ``fuse=(ids, start, end, column_id)``
        applied — the triggering query's padded [S, R] matrices are
        then written DIRECTLY by the native decoder (out_starts), so
        serving the cold query costs no second assembly pass.  The
        returned batch ALIASES the partitions' cached decoded planes —
        callers must treat ChunkBatch arrays as read-only (they already
        must: generic read_range hands out decoded-cache views too).
        ``byte_cap`` streams through to the store read; crossing it
        raises ScanBytesExceeded (caller decides)."""
        nb = _batch_decoder()
        if nb is None:
            return None
        with self._odp_lock:
            # a publish deferred by the PREVIOUS lock holder must land
            # before this query classifies hits/misses, or it would
            # re-read the whole set from the store (publishes don't take
            # _odp_lock, so joining under it cannot deadlock)
            self._join_materialize()
            built: dict[int, TimeSeriesPartition] = {}
            by_pk: dict[bytes, int] = {}
            for pid in part_ids:
                part = self.paged.get(pid)   # raced another query thread
                if part is not None:
                    built[pid] = part
                    continue
                try:
                    by_pk[self.index.partkey(pid)] = pid
                except KeyError:
                    continue  # purged from index since lookup
            if not by_pk:
                return built, None, None
            # pre-read eligibility: create/recover-time schema hashes
            # decide most ineligible shards (hist/string columns, mixed
            # schemas) WITHOUT paying the sqlite read that the generic
            # fallback would then repeat
            hs = {self.part_schema_hash.get(pid) for pid in by_pk.values()}
            if None not in hs and 0 not in hs:
                if len(hs) > 1:
                    return None          # mixed schemas: generic path
                try:
                    sch = self.schemas.by_hash(next(iter(hs)))
                except KeyError:
                    return None
                if any(c.ctype not in _NUMERIC
                       for c in sch.data.columns[1:]):
                    return None          # hist/string: generic path
            # most-of-the-shard page-ins walk the primary key range
            # instead of binding thousands of point lookups
            full = len(by_pk) > 256 \
                and 2 * len(by_pk) >= len(self.part_set)
            # defer_verify: the native decoder CRC-checks every selected
            # row span on the join it builds anyway (crcs= below), so
            # the store skips its own checksum pass — rows the full
            # scan over-returns are never verified OR decoded
            rows = self.store.read_raw_rows(self.dataset, self.shard_num,
                                            None if full else list(by_pk),
                                            0, _MAX_TIME,
                                            byte_cap=byte_cap,
                                            defer_verify=True)
            if rows is None:
                return None          # store has no bulk read
            # group by partkey runs, skipping rows the full scan
            # over-returned; fold schema/time bounds into the same pass
            sel: list[tuple] = []
            groups: list[tuple] = []   # (pid, si, sj, rows_total)
            gmin, gmax = _MAX_TIME, -_MAX_TIME
            h0 = None        # from the first SELECTED row: a full scan
            #                  over-returns rows of other schemas
            uniform = True
            i, n = 0, len(rows)
            while i < n:
                pk = rows[i][0]
                j = i
                while j < n and rows[j][0] == pk:
                    j += 1
                pid = by_pk.get(pk)
                if pid is not None:
                    si = len(sel)
                    c = 0
                    for k in range(i, j):
                        r = rows[k]
                        c += r[2]
                        if r[3] < gmin:
                            gmin = r[3]
                        if r[4] > gmax:
                            gmax = r[4]
                        if r[5] != h0:
                            if h0 is None:
                                h0 = r[5]
                            else:
                                uniform = False
                        sel.append(r)
                    groups.append((pid, si, len(sel), c))
                i = j
            del rows
            if not groups:
                return built, None, None
            if not h0 or not uniform:
                return None          # mixed/legacy schemas: generic path
            try:
                schema = self.schemas.by_hash(h0)
            except KeyError:
                return None
            data_cols = schema.data.columns[1:]
            if any(c.ctype not in _NUMERIC for c in data_cols):
                return None          # hist/string columns: generic path
            row_counts = [r[2] for r in sel]
            blobs = [r[6] for r in sel]
            # stored checksums ride along (deferred store verification:
            # the decode calls below verify these on their own join);
            # honor the global verify switch here too — the store was
            # told to defer, so this is where OFF must actually mean off
            import operator
            crcs = list(map(operator.itemgetter(7), sel)) \
                if len(sel[0]) > 7 and integrity.verify_enabled() else None
            dec_row_bytes = 8 * len(schema.data.columns)
            # ---- fused: decode straight into the query's padded batch
            fcid = None
            if fuse is not None and not built \
                    and fuse[1] <= gmin and gmax <= fuse[2]:
                fcid = schema.data.value_column_id if fuse[3] is None \
                    else fuse[3]
                if not (1 <= fcid < len(schema.data.columns)) \
                        or schema.data.columns[fcid].ctype \
                        != ColumnType.DOUBLE:
                    fcid = None
            if fcid is not None:
                present = {g[0] for g in groups}
                order = [pid for pid in fuse[0] if pid in present]
                if len(order) != len(present):
                    fcid = None      # duplicate ids: generic semantics
            if fcid is not None:
                idx_of = {pid: x for x, pid in enumerate(order)}
                counts = np.zeros(len(order), dtype=np.int64)
                for pid, _si, _sj, c in groups:
                    counts[idx_of[pid]] = c
                S = len(order)
                R = pad_rows(int(counts.max()),
                             self.config.batch_row_pad)
                S_pad = max(S, _round_up(S,
                                         self.config.batch_series_pad))
                out_starts = np.empty(len(sel), dtype=np.int64)
                for pid, si, sj, _c in groups:
                    run = idx_of[pid] * R
                    for k in range(si, sj):
                        out_starts[k] = run
                        run += row_counts[k]
                ts2d = np.empty((S_pad, R), dtype=np.int64)
                val2d = np.empty((S_pad, R), dtype=np.float64)
                extra = [(jj, c.ctype == ColumnType.DOUBLE)
                         for jj, c in enumerate(data_cols, start=1)
                         if jj != fcid]
                eflats = None
                # crcs on the FIRST call only: one verify per row set
                if nb.page_decode_into(blobs, row_counts,
                                       [(0, False, ts2d),
                                        (fcid, True, val2d)], out_starts,
                                       crcs=crcs):
                    eflats = nb.page_decode(blobs, row_counts, extra) \
                        if extra else []
                if eflats is None:
                    # corrupt-input sentinel (checksum or decode): count
                    # it, then the generic path re-reads store-verified
                    # rows, re-decodes per chunk, diagnoses, quarantines
                    self.stats.page_decode_corrupt += 1
                    return None
                self._count_verified(len(sel), crcs)
                cnts = counts_pad(counts.astype(np.int32), S_pad)
                fill_batch_pads(ts2d, val2d, cnts, S)
                epref = np.concatenate(
                    ([0], np.cumsum(row_counts))).tolist() if extra \
                    else None
                ncols = len(schema.data.columns)

                def views(k, x, run, nr):
                    lo, hi = run, run + nr
                    colviews, e = [], 0
                    for jj in range(1, ncols):
                        if jj == fcid:
                            colviews.append(val2d[x, lo:hi])
                        else:
                            colviews.append(
                                eflats[e][epref[k]:epref[k] + nr])
                            e += 1
                    return ts2d[x, lo:hi], colviews

                # the triggering query needs only tags + the decoded
                # batch; skeleton construction + LRU publish (the other
                # ~40% of the cold budget) runs on a side thread.  Stats
                # count NOW so callers see the page-in they just caused.
                tags_of = self.index.tags
                tags_list: list = [None] * len(order)
                for pid, si, _sj, _c in groups:
                    try:
                        tags = tags_of(pid)
                    except KeyError:
                        tags = parse_partkey(sel[si][0])
                    tags_list[idx_of[pid]] = tags
                self._note_paged(len(groups), len(sel))
                # pop()s since this point cancel the publish (gen_guard);
                # read under the cache lock so a concurrent pop cannot
                # slip between the read and the guard capture
                gen0 = self.paged.current_gen()

                def publish():
                    # lock-free: everything touched (page-cache, index
                    # tag reads) locks internally, so joiners holding
                    # _odp_lock cannot deadlock on this thread
                    try:
                        self._materialize_paged(sel, groups, schema,
                                                dec_row_bytes, idx_of,
                                                views, {},
                                                count_stats=False,
                                                gen_guard=gen0,
                                                tags_by_x=tags_list)
                    except Exception:
                        # the triggering query already succeeded; a
                        # failed publish only loses cache warmth — but
                        # must be visible, not silent
                        self.stats.page_publish_errors += 1
                        _LOG.exception("deferred page-cache publish "
                                       "failed (shard %s)",
                                       self.shard_num)

                t = threading.Thread(target=publish, name="odp-publish",
                                     daemon=True)
                t.start()   # started BEFORE it is joinable via the list
                self._mat_tasks.append(
                    (t, frozenset(g[0] for g in groups)))
                return built, tags_list, ChunkBatch(ts2d, val2d, cnts)
            # ---- flat decode: fills decoded caches only
            cols = [(0, False)] + [
                (j, c.ctype == ColumnType.DOUBLE)
                for j, c in enumerate(data_cols, start=1)]
            flats = nb.page_decode(blobs, row_counts, cols, crcs=crcs)
            if flats is None:
                # corrupt-input sentinel (checksum or decode): count +
                # fall back (the generic store-verified per-chunk path
                # diagnoses and quarantines the culprit)
                self.stats.page_decode_corrupt += 1
                return None
            self._count_verified(len(sel), crcs)
            oo = np.concatenate(([0], np.cumsum(row_counts))).tolist()
            ts_flat, val_flats = flats[0], flats[1:]

            def views(k, _x, _run, _nr):
                lo, hi = oo[k], oo[k + 1]
                return ts_flat[lo:hi], [f[lo:hi] for f in val_flats]

            self._materialize_paged(sel, groups, schema, dec_row_bytes,
                                    None, views, built)
            return built, None, None

    def _materialize_paged(self, sel, groups, schema, dec_row_bytes,
                           idx_of, views, built,
                           count_stats: bool = True,
                           gen_guard: Optional[int] = None,
                           tags_by_x: Optional[list] = None) -> None:
        """Shared construction tail of the bulk page-in (ONE copy for
        the fused and flat branches): read-only partition skeletons,
        lazily-framed PagedChunkSets, decoded caches filled from the
        ``views(k, series_index, run, nr)`` callback, LRU publish and
        stats.  Runs either under ``_odp_lock`` (flat branch) or on the
        deferred publish thread WITHOUT it (every structure it touches
        locks internally); strong refs stay in ``built`` (LRU pressure
        here may evict entries from the cache but never from the
        in-flight query)."""
        tags_of = self.index.tags
        items = []
        for pid, si, sj, _c in groups:
            pk = sel[si][0]
            x = idx_of[pid] if idx_of is not None else 0
            if tags_by_x is not None:
                # the fused branch already resolved these for the query
                # response; reuse them so the cached partition and the
                # response can never diverge (and the publish thread
                # skips a second full index pass)
                tags = tags_by_x[x]
            else:
                try:
                    tags = tags_of(pid)
                except KeyError:
                    tags = parse_partkey(pk)
            # write buffers are lazy, so the plain constructor costs
            # only the attribute sets — no skeleton shortcut needed
            part = TimeSeriesPartition(pid, schema, pk, tags,
                                       group=pid % self.num_groups)
            part.on_corrupt = self.note_corrupt_chunk
            chunks, decoded, nbytes = [], {}, 0
            run = 0
            for k in range(si, sj):
                _pk, cidk, nr, st, et, shh, blob = sel[k][:7]
                (nvec,) = _U16.unpack_from(blob, 0)
                raw_nb = len(blob) - 2 - 4 * nvec
                chunks.append(PagedChunkSet(
                    ChunkSetInfo(cidk, nr, st, et), pk,
                    _LazyVectors(blob), schema_hash=shh,
                    raw_nbytes=raw_nb))
                decoded[cidk] = views(k, x, run, nr)
                run += nr
                # account the DECODED bytes too: the views pin shared
                # batch-wide planes, so the LRU budget must reflect
                # decoded residency, not just the compressed blob size
                nbytes += raw_nb + nr * dec_row_bytes
            part.chunks = chunks
            part._decoded = decoded
            items.append((pid, part, nbytes))
            built[pid] = part
        self.paged.put_many(items, gen_guard=gen_guard)
        if count_stats:
            self._note_paged(len(items), len(sel))

    def _page_in(self, part_ids: list[int],
                 resident: dict[int, TimeSeriesPartition]) -> None:
        """Materialize fully-absent partitions from disk with their whole
        persisted history, so the cached object serves any time range."""
        with _pagein_timed(self, "generic"):
            self._page_in_inner(part_ids, resident)

    def _page_in_inner(self, part_ids: list[int],
                       resident: dict[int, TimeSeriesPartition]) -> None:
        got = self._page_in_bulk(part_ids)
        if got is not None:
            resident.update(got[0])
            return
        # generic path (a disabled decoder, or rows the bulk path
        # declines): one partition at a time through read_raw_partitions
        with self._odp_lock:
            # publishes never take _odp_lock: joining under it cannot
            # deadlock, and it keeps a landing publish from being re-paged
            self._join_materialize()
            by_pk = {}
            for pid in part_ids:
                # another query thread may have paged it in while this one
                # waited on the lock
                part = self.paged.get(pid)
                if part is not None:
                    resident[pid] = part
                    continue
                try:
                    by_pk[self.index.partkey(pid)] = pid
                except KeyError:
                    continue  # purged from index since lookup: skip gracefully
            if not by_pk:
                return
            for pk, chunksets in self.store.read_raw_partitions(
                    self.dataset, self.shard_num, list(by_pk), 0, _MAX_TIME):
                pid = by_pk[pk]
                schema = self._schema_for_chunks(chunksets)
                # the index parsed this partkey at recover/create time —
                # reuse its tags dict instead of re-parsing per page-in
                try:
                    tags = self.index.tags(pid)
                except KeyError:
                    tags = parse_partkey(pk)
                part = TimeSeriesPartition(pid, schema, pk, tags,
                                           group=pid % self.num_groups)
                part.on_corrupt = self.note_corrupt_chunk
                part.chunks = sorted(chunksets, key=lambda c: c.info.chunk_id)
                # paged chunks are already persisted: nothing to flush
                part._unflushed = []
                nbytes = 0
                for cs in part.chunks:
                    nbytes += cs.nbytes
                self.paged.put(pid, part, nbytes)
                resident[pid] = part
                self._note_paged(1, len(chunksets))

    def _schema_for_chunks(self, chunksets):
        """The persisted schema hash identifies the exact schema; fall back
        to column-count matching for chunks written before hashes were
        stored."""
        h = chunksets[0].schema_hash
        if h:
            try:
                return self.schemas.by_hash(h)
            except KeyError:
                pass
        ncols = len(chunksets[0].vectors)
        candidates = [s for s in self.schemas.all
                      if len(s.data.columns) == ncols]
        for part in self.partitions.values():
            if part.schema in candidates or not candidates:
                return part.schema
        if candidates:
            return candidates[0]
        return self.schemas.all[0]

    # ------------------------------------------------------------ query path

    def scan_batch(self, part_ids: Sequence[int], start_time: int,
                   end_time: int, column_id: Optional[int] = None):
        got = self._scan_batch_bulk(part_ids, start_time, end_time,
                                    column_id)
        if got is not None:
            return got
        parts = self._resolve_partitions(part_ids, start_time, end_time)
        # pin resolved partitions for the duration of the scan: later
        # page-ins must not LRU-evict earlier ones out of this query
        self._pinned.parts = parts
        try:
            self._predecode_chunks(parts.values(), start_time, end_time)
            return super().scan_batch(part_ids, start_time, end_time,
                                      column_id)
        finally:
            self._pinned.parts = None

    def _scan_batch_bulk(self, part_ids: Sequence[int], start_time: int,
                         end_time: int, column_id: Optional[int]):
        """Fully-vectorized scan for the pure paged/cold case: every
        requested partition is read-only (paged or on disk), one schema,
        numeric value column.  Page-in is bulk (:meth:`_page_in_bulk`), and
        the padded [S, R] batch assembles with whole-array ops instead
        of a per-partition read_range + row-copy loop — the per-series
        Python constants were the whole cold-scan budget.  Returns (tags,
        batch) or None to fall back."""
        if _batch_decoder() is None:
            return None
        self._check_integrity()
        live = self.partitions
        paged = self.paged.snapshot()
        parts: dict[int, TimeSeriesPartition] = {}
        missing: list[int] = []
        ids: list[int] = []
        for p in part_ids:
            pid = int(p)
            ids.append(pid)
            if pid in live:
                return None   # live series mix in: generic path handles
            part = paged.get(pid)
            if part is None:
                missing.append(pid)
            else:
                parts[pid] = part
        # scanned-bytes cap: resident paged chunks are costed in Python
        # (precomputed raw_nbytes); the page-in read streams the rest of
        # the budget instead of paying a LENGTH() metadata pre-pass
        cap = self.config.max_data_per_shard_query
        resident_bytes = sum(
            cs.nbytes for part in parts.values() for cs in part.chunks
            if cs.info.end_time >= start_time
            and cs.info.start_time <= end_time)
        if resident_bytes > cap:
            raise QueryLimitExceeded(
                f"query would scan over {resident_bytes} bytes on shard "
                f"{self.shard_num}, cap is {cap} "
                "(max-data-per-shard-query)")
        if missing:
            # no pre-paged survivors -> missing covers every id, so the
            # page-in may fuse the padded batch assembly into its
            # decode pass and serve the query directly
            fuse = None if parts else (ids, start_time, end_time,
                                       column_id)
            with _pagein_timed(self, "bulk"):
                try:
                    got = self._page_in_bulk(
                        missing, byte_cap=cap - resident_bytes, fuse=fuse)
                except ScanBytesExceeded:
                    # full-history bytes crossed the budget; only chunks
                    # overlapping the range count, so do the precise
                    # metadata check (raises when genuinely over), then
                    # retry uncapped — falling back to the generic path
                    # would read the same multi-MB row set a third time
                    self._cap_data_scanned(parts.values(), missing,
                                           start_time, end_time)
                    got = self._page_in_bulk(missing, fuse=fuse)
            if got is None:
                return None
            built, ftags, fbatch = got
            if ftags is not None:
                return ftags, fbatch
            parts.update(built)
        order = [pid for pid in ids if pid in parts]
        if not order:
            return [], None
        schema = parts[order[0]].schema
        cid = schema.data.value_column_id if column_id is None \
            else column_id
        if cid < 1 or cid >= len(schema.data.columns) \
                or schema.data.columns[cid].ctype not in _NUMERIC:
            return None
        # paged partitions built by the bulk path arrive pre-decoded;
        # ones paged by the generic path may not be — fill in one call
        self._predecode_chunks(parts.values(), start_time, end_time)
        col_idx = cid - 1
        h0 = schema.schema_hash
        ts_parts, val_parts = [], []
        counts = np.zeros(len(order), dtype=np.int64)
        lo_info, hi_info = _MAX_TIME, -_MAX_TIME
        q = integrity.QUARANTINE
        for i, pid in enumerate(order):
            part = parts[pid]
            if part.schema.schema_hash != h0:
                return None
            q_ids = q.chunk_ids(part.partkey) if q else ()
            c = 0
            for cs in part.chunks:
                info = cs.info
                if info.end_time < start_time \
                        or info.start_time > end_time:
                    continue
                if q_ids and info.chunk_id in q_ids:
                    continue   # quarantined: serve partial, never corrupt
                got = part._decoded.get(info.chunk_id)
                if got is None:
                    return None   # mixed schema within partition etc.
                if info.start_time < lo_info:
                    lo_info = info.start_time
                if info.end_time > hi_info:
                    hi_info = info.end_time
                ts_parts.append(got[0])
                val_parts.append(got[1][col_idx])
                c += len(got[0])
            counts[i] = c
        total = int(counts.sum())
        if total == 0:
            flat_ts = _EMPTY_I64
            flat_val = np.empty(0, dtype=np.float64)
        else:
            flat_ts = np.concatenate(ts_parts)
            flat_val = np.concatenate(val_parts).astype(np.float64,
                                                        copy=False)
            # trim to [start, end] globally: timestamps are sorted
            # within each partition, so a flat mask + per-partition
            # prefix-sum recount preserves per-series order (chunk-info
            # bounds decide whether any trim is needed at all)
            if lo_info < start_time or hi_info > end_time:
                offs = np.zeros(len(order) + 1, dtype=np.int64)
                np.cumsum(counts, out=offs[1:])
                mask = (flat_ts >= start_time) & (flat_ts <= end_time)
                cm = np.zeros(total + 1, dtype=np.int64)
                np.cumsum(mask, out=cm[1:])
                counts = cm[offs[1:]] - cm[offs[:-1]]
                flat_ts = flat_ts[mask]
                flat_val = flat_val[mask]
        # padded [S, R] assembly, same geometry as build_batch
        S = len(order)
        R = pad_rows(int(counts.max()) if S else 0,
                     self.config.batch_row_pad)
        S_pad = max(S, _round_up(S, self.config.batch_series_pad))
        cnts = counts_pad(counts.astype(np.int32), S_pad)
        ts2d = np.empty((S_pad, R), dtype=np.int64)
        val2d = np.empty((S_pad, R), dtype=np.float64)
        if fill_batch_pads(ts2d, val2d, cnts, S):
            # uniform row count (the whole-dashboard page-in): one
            # reshaped block copy instead of a mask scatter
            r0 = int(counts[0]) if S else 0
            ts2d[:S, :r0] = flat_ts.reshape(S, r0)
            val2d[:S, :r0] = flat_val.reshape(S, r0)
        elif flat_ts.size:
            rowmask = np.arange(R)[None, :] < cnts[:, None]
            ts2d[rowmask] = flat_ts
            val2d[rowmask] = flat_val
        self.paged.touch_many(order)
        tags = [parts[pid].tags for pid in order]
        return tags, ChunkBatch(ts2d, val2d, cnts)

    @staticmethod
    def _predecode_chunks(parts, start_time: int, end_time: int) -> None:
        """Batch-decode every undecoded chunk the scan will touch with
        ONE native call, filling each partition's decoded-chunk cache so
        read_range becomes pure concatenation (reference:
        DemandPagedChunkStore.scala:34 pages straight into block memory,
        where a per-chunk decode would cost a Python call a chunk).
        Quarantined chunks are excluded; a corrupt chunk discovered here
        is diagnosed per chunk, quarantined, and the rest still decode."""
        from filodb_tpu_torch.core.chunk import decode_partitions_batch
        groups, owners = [], []
        schema = None
        q = integrity.QUARANTINE
        for part in parts:
            if schema is None:
                schema = part.schema
            elif part.schema.schema_hash != schema.schema_hash:
                return                     # mixed schemas: per-chunk path
            decoded = part._decoded
            q_ids = q.chunk_ids(part.partkey) if q else ()
            for cs in part.chunks:
                if cs.info.end_time < start_time \
                        or cs.info.start_time > end_time \
                        or cs.info.chunk_id in decoded:
                    continue
                if q_ids and cs.info.chunk_id in q_ids:
                    continue
                groups.append([cs])
                owners.append((part, cs.info.chunk_id))
        if not groups or schema is None:
            return
        t0 = time.perf_counter()
        try:
            try:
                decoded_all = decode_partitions_batch(schema, groups)
            except (ValueError, IndexError, struct.error):
                # ONE corrupt chunk fails the whole batch decode: redo per
                # chunk so the culprit gets its structured diagnosis +
                # quarantine while every healthy chunk still fills its cache
                for (part, _cid), (cs,) in zip(owners, groups):
                    try:
                        part._decoded_chunk(cs)
                    except integrity.CorruptVectorError as err:
                        part._note_corrupt(err)
                return
            for (part, cid), decoded in zip(owners, decoded_all):
                part._decoded[cid] = decoded
        finally:
            ctx = _active_ctx()
            if ctx is not None:
                ctx.note_timing("decode", time.perf_counter() - t0)

    def _cap_data_scanned(self, resident_parts, missing_ids: Sequence[int],
                          start_time: int, end_time: int) -> None:
        """Only chunks overlapping the query range count against the cap —
        a narrow query over a long-retention series must not be rejected
        for history it will never decode.  Absent partitions are costed
        from store metadata before their vectors are read."""
        total = sum(c.nbytes
                    for p in resident_parts for c in p.chunks
                    if c.info.end_time >= start_time
                    and c.info.start_time <= end_time)
        cap = self.config.max_data_per_shard_query
        if missing_ids and total <= cap:
            pks = []
            for pid in missing_ids:
                try:
                    pks.append(self.index.partkey(pid))
                except KeyError:
                    continue
            if pks:
                total += self.store.scan_bytes(self.dataset, self.shard_num,
                                               pks, start_time, end_time)
        if total > cap:
            raise QueryLimitExceeded(
                f"query would scan {total} bytes on shard {self.shard_num}, "
                f"cap is {cap} (max-data-per-shard-query)")

    def lookup_partitions(self, filters: Sequence[ColumnFilter],
                          start_time: int, end_time: int,
                          limit: Optional[int] = None) -> PartLookupResult:
        """Unlike the in-memory-only base (which reports non-resident ids as
        ``missing_partkeys``), every indexed id is servable here — absent
        partitions page in at scan time."""
        self._check_integrity()
        ids = self.index.part_ids_from_filters(filters, start_time, end_time,
                                               limit)
        first_schema = None
        out: list[int] = []
        hash_of = self.part_schema_hash.get
        parts_get = self.partitions.get
        paged_get = self.paged.get
        for i in ids:
            pid = int(i)
            # create/recover-time hash first: the common all-indexed case
            # then needs no per-id paged-LRU lock round-trip
            h = hash_of(pid)
            if h is None:
                part = parts_get(pid) or paged_get(pid)
                if part is not None:
                    h = part.schema.schema_hash
            if h is not None:
                if first_schema is None:
                    first_schema = h
                if h != first_schema:
                    continue  # one schema per lookup, like the base class
            out.append(pid)
        return PartLookupResult(self.shard_num,
                                np.asarray(out, dtype=np.int32), [],
                                first_schema)

    # -------------------------------------------------------------- eviction

    def evict_partitions(self, n: int) -> int:
        """Unlike the base (in-memory-only) shard, keep index + part-set
        entries so queries can page evicted series back from disk
        (reference: Lucene entries survive eviction; evicted partkeys
        tracked in a bloom filter, TimeSeriesShard.scala:1308-1401)."""
        # stopped-longest-ago first; ghost ids (already evicted, still
        # indexed) must not consume the quota
        stopped = [pid for pid in
                   self.index.part_ids_ordered_by_end_time(
                       n + max(len(self.index_only_ids()), 0))
                   if pid in self.partitions]
        victims = stopped[:n]
        if len(victims) < n:
            # not enough stopped series: fall back to least-recently-written
            # active partitions (they are safely pageable once flushed)
            seen = set(victims)
            active = sorted((p.latest_timestamp, pid)
                            for pid, p in self.partitions.items()
                            if pid not in seen)
            victims += [pid for _, pid in active[:n - len(victims)]]
        evicted = 0
        self._persist_before_eviction(
            [self.partitions[pid] for pid in victims
             if pid in self.partitions], int(time.time() * 1000))
        for pid in victims:
            part = self.partitions.get(pid)
            if part is None:
                continue
            # under _odp_lock so an in-flight backfill compute for this pid
            # finishes (and its live-partition identity check then fails)
            # before the stale entries are dropped
            with self._odp_lock:
                del self.partitions[pid]
                self.bump_removal_epoch()    # invalidates grid prep caches
                self.paged.pop(pid)          # cached copy lacks the tail
                self.paged.pop(("bf", pid))  # list is live-part relative
                LEDGER.note_eviction(self._ledger_owner, "epoch_purge",
                                     n=2)
                # hard reclaim invariant (still under _odp_lock, so no
                # legitimate re-page-in can land): a popped entry that is
                # STILL cached means a publish resurrected stale buffers
                # past the gen guard — fail the shard, don't serve it
                for key in (pid, ("bf", pid)):
                    if self.paged.get(key) is not None:
                        self._fail_integrity(
                            f"evicted entry {key!r} resurrected in the "
                            f"page cache during eviction")
            self.evicted_keys.add(part.partkey)
            self.stats.partitions_evicted += 1
            evicted += 1
        if evicted:
            # full byte-accounting audit once per eviction batch (O(cache
            # entries), off the query path)
            try:
                self.paged.check_invariants()
            except IntegrityInvariantError as e:
                self._fail_integrity(str(e))
        return evicted

    def _persist_before_eviction(self, parts, itime: int) -> None:
        """Eviction must not lose data: every victim's rows not yet
        persisted (its write buffer and its unflushed chunks) are encoded
        in one batch and written, with the victims' part keys, one write
        each, before any victim leaves memory.  The reference writes them
        a partition at a time (odp.py:1253-1261); the rows on disk are
        the same.  A failed write puts the chunks back on their
        partitions' unflushed lists, and no partition is evicted."""
        collected, recs = [], []
        for part, fresh in zip(parts, make_flush_chunks(parts)):
            if fresh:
                collected.append((part, fresh))
                pid = part.part_id
                recs.append(PartKeyRecord(part.partkey,
                                          self.index.start_time(pid),
                                          self.index.end_time(pid),
                                          self.shard_num,
                                          part.schema.schema_hash))
        if not collected:
            return
        try:
            self.store.write_chunks(self.dataset, self.shard_num,
                                    [cs for _p, fresh in collected
                                     for cs in fresh], ingestion_time=itime)
            self.store.write_part_keys(self.dataset, self.shard_num, recs)
        except BaseException:
            for part, fresh in collected:
                part.requeue_unflushed(fresh)
            raise
        # the persisted rows still feed the streaming downsampler, each
        # victim's chunks once, in one call a schema (the reference: one
        # call a partition, odp.py:1262-1265)
        if self.downsample_publisher is not None:
            self._downsample(collected)

    @staticmethod
    def _count_verified(n: int, crcs) -> None:
        """Bulk decode succeeded with deferred checksum verification:
        credit the verified-chunks counter (the store skipped its pass)."""
        if crcs is not None and n:
            integrity_metrics()["chunks_verified"].inc(n)

    def _fail_integrity(self, detail: str) -> None:
        """Record the broken invariant, count it, and fail the shard:
        every subsequent scan raises instead of serving stale buffers."""
        self.integrity_failed = detail
        integrity.note_invariant_failure(self.dataset, self.shard_num,
                                         detail)
        raise IntegrityInvariantError(
            f"shard {self.shard_num} failed integrity: {detail}")

    def index_only_ids(self) -> list[int]:
        """Ids present in the index but not resident in memory."""
        return [pid for pid in self.part_set.values()
                if pid not in self.partitions]
