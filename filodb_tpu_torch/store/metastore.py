"""MetaStore: dataset metadata + ingestion checkpoints.

Capability match for the reference's MetaStore incl. the checkpoint API
written per (dataset, shard, flush-group) only after chunks+partkeys
persist, and read back as min/max for recovery (reference:
core/src/main/scala/filodb.core/store/MetaStore.scala:14,48,67,
InMemoryMetaStore.scala:89, cassandra/.../CheckpointTable.scala:17).
"""

from __future__ import annotations

from typing import Optional


class MetaStore:
    def initialize(self) -> None:
        pass

    def write_checkpoint(self, dataset: str, shard: int, group: int,
                         offset: int) -> None:
        raise NotImplementedError

    def read_checkpoints(self, dataset: str, shard: int) -> dict[int, int]:
        raise NotImplementedError

    # -- small durable KV: split phase/cursor records and the per-node
    # clone/retire markers that make resharding crash-safe --------------

    def write_kv(self, key: str, value: str) -> None:
        raise NotImplementedError

    def read_kv(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def delete_kv(self, key: str) -> None:
        raise NotImplementedError

    def list_kv(self, prefix: str) -> dict[str, str]:
        raise NotImplementedError

    def delete_checkpoints(self, dataset: str, shard: int) -> None:
        """Drop one shard's checkpoint rows (split abort discards the
        children's cloned recovery state)."""
        raise NotImplementedError

    def read_earliest_checkpoint(self, dataset: str, shard: int) -> int:
        cps = self.read_checkpoints(dataset, shard)
        return min(cps.values()) if cps else -1

    def read_highest_checkpoint(self, dataset: str, shard: int) -> int:
        cps = self.read_checkpoints(dataset, shard)
        return max(cps.values()) if cps else -1

    def shutdown(self) -> None:
        pass


class InMemoryMetaStore(MetaStore):
    def __init__(self) -> None:
        self._checkpoints: dict[tuple, dict[int, int]] = {}
        self._kv: dict[str, str] = {}

    def write_checkpoint(self, dataset, shard, group, offset) -> None:
        self._checkpoints.setdefault((dataset, shard), {})[group] = offset

    def read_checkpoints(self, dataset, shard) -> dict[int, int]:
        return dict(self._checkpoints.get((dataset, shard), {}))

    def delete_checkpoints(self, dataset, shard) -> None:
        self._checkpoints.pop((dataset, shard), None)

    def write_kv(self, key: str, value: str) -> None:
        self._kv[key] = value

    def read_kv(self, key: str) -> Optional[str]:
        return self._kv.get(key)

    def delete_kv(self, key: str) -> None:
        self._kv.pop(key, None)

    def list_kv(self, prefix: str) -> dict[str, str]:
        return {k: v for k, v in self._kv.items() if k.startswith(prefix)}
