"""MetaStore: ingestion checkpoints, written per (dataset, shard,
flush-group) only after chunks+partkeys persist (reference:
core/src/main/scala/filodb.core/store/MetaStore.scala:14,48,67,
InMemoryMetaStore.scala:89)."""

from __future__ import annotations


class MetaStore:
    def write_checkpoint(self, dataset: str, shard: int, group: int,
                         offset: int) -> None:
        raise NotImplementedError

    def read_checkpoints(self, dataset: str, shard: int) -> dict[int, int]:
        raise NotImplementedError


class InMemoryMetaStore(MetaStore):
    def __init__(self) -> None:
        self._cps: dict[tuple, dict[int, int]] = {}

    def write_checkpoint(self, dataset, shard, group, offset) -> None:
        self._cps.setdefault((dataset, shard), {})[group] = offset

    def read_checkpoints(self, dataset, shard) -> dict[int, int]:
        return dict(self._cps.get((dataset, shard), {}))
