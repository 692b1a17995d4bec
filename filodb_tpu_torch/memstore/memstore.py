"""TimeSeriesMemStore: dataset -> shards facade.

Matches the reference's TimeSeriesMemStore (reference: core/src/main/scala/
filodb.core/memstore/TimeSeriesMemStore.scala:22): ``setup`` creates
shards, ``ingest`` routes containers to a shard, ``ingest_stream``
interleaves flushes with a stream, ``recover_index`` and
``recover_stream`` rebuild a shard from the column store's part keys and
replay a source from the meta store's checkpoints with per-group
watermark skipping, and lookups delegate to shards.  Every shard's
device grid lives on the store's ``device``: CUDA by default, the CPU
only when the caller says so.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from filodb_tpu_torch.core.filters import ColumnFilter
from filodb_tpu_torch.core.record import parse_partkey
from filodb_tpu_torch.core.schemas import Schemas
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.devicestore import resolve_device
from filodb_tpu_torch.memstore.shard import PartLookupResult, TimeSeriesShard
from filodb_tpu_torch.store.columnstore import ColumnStore, NullColumnStore
from filodb_tpu_torch.store.metastore import InMemoryMetaStore, MetaStore


class ShardNotSetup(Exception):
    pass


class TimeSeriesMemStore:
    def __init__(self, column_store: Optional[ColumnStore] = None,
                 meta_store: Optional[MetaStore] = None, device="cuda"):
        self.device = resolve_device(device)
        self.store = column_store or NullColumnStore()
        self.meta = meta_store or InMemoryMetaStore()
        self._datasets: dict[str, dict[int, TimeSeriesShard]] = {}

    def setup(self, dataset: str, schemas: Schemas, shard_num: int,
              config: Optional[StoreConfig] = None) -> TimeSeriesShard:
        shards = self._datasets.setdefault(dataset, {})
        if shard_num in shards:
            raise ValueError(f"shard {shard_num} already set up for {dataset}")
        cfg = config or StoreConfig()
        if cfg.demand_paging_enabled and not isinstance(self.store,
                                                       NullColumnStore):
            # over a persistent store, absent partitions page back in
            from filodb_tpu_torch.memstore.odp import OnDemandPagingShard
            shard = OnDemandPagingShard(dataset, schemas, shard_num, cfg,
                                        self.store, self.meta,
                                        device=self.device)
        else:
            shard = TimeSeriesShard(dataset, schemas, shard_num, cfg,
                                    self.store, self.meta,
                                    device=self.device)
        shards[shard_num] = shard
        return shard

    def drop_shard(self, dataset: str, shard_num: int) -> bool:
        """Remove one shard's in-memory state entirely (the persisted
        side is the caller's job).  Returns True when a shard was
        dropped."""
        shard = self._datasets.get(dataset, {}).pop(shard_num, None)
        if shard is None:
            return False
        shard.close()
        return True

    def has_shard(self, dataset: str, shard_num: int) -> bool:
        return shard_num in self._datasets.get(dataset, ())

    def get_shard(self, dataset: str, shard_num: int) -> TimeSeriesShard:
        try:
            return self._datasets[dataset][shard_num]
        except KeyError:
            raise ShardNotSetup(f"{dataset} shard {shard_num} not set up")

    def shards(self, dataset: str) -> list[TimeSeriesShard]:
        return list(self._datasets.get(dataset, {}).values())

    def ingest(self, dataset: str, shard_num: int, container: bytes,
               offset: int) -> int:
        return self.get_shard(dataset, shard_num).ingest_container(
            container, offset)

    def ingest_stream(self, dataset: str, shard_num: int,
                      stream: Iterable[tuple[int, bytes]],
                      flush_each: Optional[int] = None,
                      flush_interval_ms: Optional[int] = None,
                      flush_parallelism: int = 2,
                      flush_remaining: bool = True) -> int:
        """Consume an (offset, container) stream, interleaving flushes the
        way ingestStream interleaves createFlushTasks (reference:
        TimeSeriesMemStore.scala:106-129).

        Two flush modes:
        - ``flush_each=N``: synchronous flush every N containers.
        - ``flush_interval_ms``: the reference's production mode — per-group
          time-boundary scheduling with encode+IO pipelined onto a
          dedicated flush executor (memstore/flush.py), so ingestion never
          stalls behind a flush (reference TimeSeriesShard.scala:804-846).
          At the end of the stream the scheduler drains its tasks and,
          with ``flush_remaining`` (the default), flushes what is still
          buffered; without it the buffers stay unflushed, as after a
          crash, and recovery replays them from the checkpoints.
        """
        if flush_each is not None and flush_interval_ms is not None:
            raise ValueError("pass flush_each OR flush_interval_ms, not both")
        shard = self.get_shard(dataset, shard_num)
        total = 0
        if flush_interval_ms is not None:
            from filodb_tpu_torch.memstore.flush import FlushScheduler
            sched = FlushScheduler(shard, flush_interval_ms,
                                   flush_parallelism)
            shard.flush_scheduler = sched
            try:
                for offset, container in stream:
                    total += shard.ingest_container(container, offset)
                    sched.note_ingested()
            finally:
                try:
                    sched.close(flush_remaining=flush_remaining)
                finally:
                    shard.flush_scheduler = None
            return total
        for i, (offset, container) in enumerate(stream):
            total += shard.ingest_container(container, offset)
            if flush_each and (i + 1) % flush_each == 0:
                shard.flush_all()
        return total

    def prepare_recovery(self, dataset: str, shard_num: int
                         ) -> tuple[Optional[int], int]:
        """Set group watermarks from persisted checkpoints and return
        (resume_offset, highest_checkpoint); resume_offset is None when no
        checkpoints exist (reference: IngestionActor.scala:193-217 reads
        checkpoints, TimeSeriesMemStore.recoverStream applies them)."""
        shard = self.get_shard(dataset, shard_num)
        cps = self.meta.read_checkpoints(dataset, shard_num)
        for group, offset in cps.items():
            shard.group_watermarks[group] = max(
                shard.group_watermarks[group], offset)
        if not cps:
            return None, -1
        return min(cps.values()) + 1, max(cps.values())

    def recover_stream(self, dataset: str, shard_num: int,
                       stream: Iterable[tuple[int, bytes]]) -> int:
        """Replay from checkpoints: set group watermarks from the meta
        store, then ingest — below-watermark records skip (reference:
        recoverStream TimeSeriesMemStore.scala:136-173)."""
        shard = self.get_shard(dataset, shard_num)
        self.prepare_recovery(dataset, shard_num)
        total = 0
        for offset, container in stream:
            total += shard.ingest_container(container, offset)
        return total

    def recover_index(self, dataset: str, shard_num: int) -> int:
        """Rebuild the tag index from persisted partkeys (reference:
        IndexBootstrapper.scala:12, TimeSeriesShard.recoverIndex)."""
        shard = self.get_shard(dataset, shard_num)
        n = 0
        for rec in self.store.scan_part_keys(dataset, shard_num):
            if rec.partkey in shard.part_set:
                continue
            pid = shard._next_part_id
            shard._next_part_id += 1
            shard.index.add_partkey(pid, rec.partkey,
                                    parse_partkey(rec.partkey),
                                    rec.start_time, rec.end_time)
            shard.part_schema_hash[pid] = rec.schema_hash
            # register in the part set so resumed ingest reuses this part
            # id instead of creating a duplicate index entry
            shard.part_set[rec.partkey] = pid
            n += 1
        # bootstrap completes the index BEFORE the shard serves (reference:
        # IndexBootstrapper.scala:12 refreshes the Lucene reader after the
        # bulk add): the first lookup must not pay the label backlog
        shard.index.apply_pending()
        return n

    def flush(self, dataset: str, shard_num: Optional[int] = None) -> int:
        if shard_num is not None:
            return self.get_shard(dataset, shard_num).flush_all()
        return sum(s.flush_all() for s in self.shards(dataset))

    def lookup_partitions(self, dataset: str, shard_num: int,
                          filters: Sequence[ColumnFilter], start: int,
                          end: int, limit: Optional[int] = None
                          ) -> PartLookupResult:
        return self.get_shard(dataset, shard_num).lookup_partitions(
            filters, start, end, limit)

    def reset(self) -> None:
        for shards in self._datasets.values():
            for sh in shards.values():
                sh.close()
        self._datasets.clear()
