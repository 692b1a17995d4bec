"""TimeSeriesMemStore: dataset -> shards facade.

Matches the reference's TimeSeriesMemStore (reference: core/src/main/scala/
filodb.core/memstore/TimeSeriesMemStore.scala:22): ``setup`` creates
shards, ``ingest`` routes containers to a shard, and lookups delegate to
shards.  Every shard's device grid lives on the store's ``device``:
CUDA by default, the CPU only when the caller says so.
"""

from __future__ import annotations

from typing import Optional, Sequence

from filodb_tpu_torch.core.filters import ColumnFilter
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
        shard = TimeSeriesShard(dataset, schemas, shard_num,
                                config or StoreConfig(), self.store,
                                self.meta, device=self.device)
        shards[shard_num] = shard
        return shard

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
