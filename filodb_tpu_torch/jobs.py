"""Offline maintenance jobs: chunk repair, cardinality busting, index
migration.

Capability match for the reference's spark-jobs suite (reference:
spark-jobs/src/main/scala/filodb/repair/ChunkCopier.scala:22 —
cross-cluster chunk copy by ingestion-time range; cardbuster/
PerShardCardinalityBuster.scala:20 — delete partkeys matching filters;
index/DSIndexJob.scala:17 — migrate partkey index entries from the raw
dataset to downsample datasets).  Spark's executor parallelism maps to
per-(shard × time-split) work items driven by plain loops or a thread
pool — each item is independent.
"""

from __future__ import annotations

from typing import Optional, Sequence

from filodb_tpu_torch.core.filters import ColumnFilter
from filodb_tpu_torch.core.record import parse_partkey
from filodb_tpu_torch.downsample.dsstore import ds_dataset_name
from filodb_tpu_torch.store.columnstore import ColumnStore


class ChunkCopier:
    """Copies chunks (and partkeys) between column stores for a dataset +
    ingestion-time range — disaster repair between clusters (reference:
    ChunkCopier.run)."""

    def __init__(self, source: ColumnStore, target: ColumnStore,
                 source_dataset: str, target_dataset: Optional[str] = None,
                 batch_size: int = 1000):
        self.source = source
        self.target = target
        self.source_dataset = source_dataset
        self.target_dataset = target_dataset or source_dataset
        self.batch_size = batch_size

    def copy_shard(self, shard: int, ingestion_start: int,
                   ingestion_end: int) -> int:
        """One (shard × time-split) work item; returns chunksets copied.
        Per-chunk ingestion times are preserved so incremental/overlapping
        repair runs and batch-downsample scans on the target see the same
        timeline as the source."""
        copied = 0
        by_itime: dict[int, list] = {}
        copied_pks: set[bytes] = set()

        def flush_groups():
            nonlocal copied
            for itime, group in by_itime.items():
                self.target.write_chunks(self.target_dataset, shard, group,
                                         ingestion_time=itime)
                copied += len(group)
            by_itime.clear()

        pending = 0
        for itime, cs in self.source.chunksets_with_ingestion_time(
                self.source_dataset, shard, ingestion_start, ingestion_end):
            by_itime.setdefault(itime, []).append(cs)
            copied_pks.add(cs.partkey)
            pending += 1
            if pending >= self.batch_size:
                flush_groups()
                pending = 0
        flush_groups()
        # bring the partkey records along so the target can recover its index
        recs = [r for r in self.source.scan_part_keys(self.source_dataset,
                                                      shard)
                if r.partkey in copied_pks]
        if recs:
            self.target.write_part_keys(self.target_dataset, shard, recs)
        return copied

    def run(self, shards: Sequence[int], ingestion_start: int,
            ingestion_end: int) -> dict[int, int]:
        return {s: self.copy_shard(s, ingestion_start, ingestion_end)
                for s in shards}


class PerShardCardinalityBuster:
    """Deletes partkeys (and their chunks) whose tags match the given
    filters — the escape hatch for cardinality explosions (reference:
    PerShardCardinalityBuster.scala:20)."""

    def __init__(self, store: ColumnStore, dataset: str):
        self.store = store
        self.dataset = dataset

    def matching_partkeys(self, shard: int,
                          filters: Sequence[ColumnFilter]) -> list[bytes]:
        out = []
        for rec in self.store.scan_part_keys(self.dataset, shard):
            tags = parse_partkey(rec.partkey)
            if all(f.matches(tags) for f in filters):
                out.append(rec.partkey)
        return out

    def bust_shard(self, shard: int, filters: Sequence[ColumnFilter],
                   dry_run: bool = True) -> int:
        """Returns partkeys matched (deleted unless dry_run — the
        reference defaults to a dry run for the same reason)."""
        pks = self.matching_partkeys(shard, filters)
        if pks and not dry_run:
            self.store.delete_part_keys(self.dataset, shard, pks)
        return len(pks)

    def run(self, shards: Sequence[int], filters: Sequence[ColumnFilter],
            dry_run: bool = True) -> dict[int, int]:
        return {s: self.bust_shard(s, filters, dry_run) for s in shards}


class DSIndexJob:
    """Migrates partkey records from the raw dataset to its downsample
    datasets so downsample indexes can bootstrap (reference:
    DSIndexJob.updateDSPartKeyIndex)."""

    def __init__(self, store: ColumnStore, raw_dataset: str,
                 resolutions_ms: Sequence[int]):
        self.store = store
        self.raw_dataset = raw_dataset
        self.ds_names = [ds_dataset_name(raw_dataset, r)
                         for r in resolutions_ms]

    def migrate_shard(self, shard: int) -> int:
        recs = list(self.store.scan_part_keys(self.raw_dataset, shard))
        if not recs:
            return 0
        for name in self.ds_names:
            self.store.write_part_keys(name, shard, recs)
        return len(recs)

    def run(self, shards: Sequence[int]) -> dict[int, int]:
        return {s: self.migrate_shard(s) for s in shards}
