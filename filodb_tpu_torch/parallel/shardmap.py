"""ShardMapper: record -> shard bit-splice, spread fan-out, shard status.

The part of the reference's ShardMapper the query planner reads
(reference: coordinator/src/main/scala/filodb.coordinator/ShardMapper.scala:
26-46 — shard = f(shardKeyHash upper bits, partitionHash lower bits,
spread); queryShards returns the 2^spread shards holding one shard key)
plus the per-shard status the planner prunes on (ShardStatus.scala:54-94)
and the routing token the result cache keys validity on.  Replicas,
resharding topologies and node assignment stay with the serving shell.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence


class ShardStatus(enum.Enum):
    UNASSIGNED = "Unassigned"
    ASSIGNED = "Assigned"
    RECOVERY = "Recovery"
    ACTIVE = "Active"
    ERROR = "Error"
    STOPPED = "Stopped"
    DOWN = "Down"

    @property
    def queryable(self) -> bool:
        return self in (ShardStatus.ACTIVE, ShardStatus.RECOVERY)


class ShardMapper:
    def __init__(self, num_shards: int):
        if num_shards <= 0 or num_shards & (num_shards - 1):
            raise ValueError(f"num_shards {num_shards} must be a power of 2")
        self.num_shards = num_shards
        self._status = [ShardStatus.UNASSIGNED] * num_shards

    def shard_hash_mask(self, spread: int) -> int:
        return (self.num_shards - 1) & ~((1 << spread) - 1)

    def ingestion_shard(self, shard_key_hash: int, part_hash: int,
                        spread: int) -> int:
        """Upper bits from the shard-key hash, lower ``spread`` bits from the
        partition hash (reference: ShardMapper.ingestionShard)."""
        return ((shard_key_hash & self.shard_hash_mask(spread))
                | (part_hash & ((1 << spread) - 1)))

    def query_shards(self, shard_key_hash: int, spread: int) -> list[int]:
        """All 2^spread shards that can hold series of one shard key (a
        spread wider than the shard count folds back onto it)."""
        base = shard_key_hash & self.shard_hash_mask(spread)
        return [(base | i) % self.num_shards for i in range(1 << spread)]

    def update_status(self, shard: int, status: ShardStatus) -> None:
        self._status[shard] = status

    def status(self, shard: int) -> ShardStatus:
        return self._status[shard]

    def active_shards(self, shards: Optional[Sequence[int]] = None
                      ) -> list[int]:
        """Shards in a queryable state."""
        rng = range(self.num_shards) if shards is None else shards
        return [s for s in rng
                if 0 <= s < self.num_shards and self._status[s].queryable]

    def routing_token(self) -> int:
        """Cheap hash of the routing state: the shard count and every
        shard's status.  Any status transition (a shard going to
        recovery, down, back to active) changes it, so consumers that
        memoize answers computed under one routing view
        (query/resultcache.py) can key validity on it without
        subscribing to shard events."""
        return hash((self.num_shards,
                     tuple(s.value for s in self._status)))
