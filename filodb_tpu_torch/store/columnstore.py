"""ColumnStore: where flushed chunks and part keys persist.

The flush path's sink (reference: core/src/main/scala/filodb.core/store/
ChunkSink.scala:21,116, ColumnStore.scala:59).  This package carries the
abstract sink and its NullColumnStore double; disk and in-memory backends
stay in the reference package until the store slice is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

from filodb_tpu_torch.core.chunk import ChunkSet


@dataclasses.dataclass
class PartKeyRecord:
    partkey: bytes
    start_time: int
    end_time: int
    shard: int
    schema_hash: int = 0  # 16-bit schema id so readers recover exact schemas


class ColumnStore:
    """Sink of persisted chunks.  All times are epoch millis."""

    def write_chunks(self, dataset: str, shard: int,
                     chunksets: Sequence[ChunkSet],
                     ingestion_time: int = 0) -> int:
        raise NotImplementedError

    def write_part_keys(self, dataset: str, shard: int,
                        records: Sequence[PartKeyRecord]) -> int:
        raise NotImplementedError

    def scan_part_keys(self, dataset: str, shard: int) -> Iterator[PartKeyRecord]:
        raise NotImplementedError


class NullColumnStore(ColumnStore):
    """Swallows writes; serves nothing (reference: NullColumnStore,
    ChunkSink.scala:116).  Used by in-memory-only deployments and tests."""

    def __init__(self) -> None:
        self.chunksets_written = 0
        self.partkeys_written = 0

    def write_chunks(self, dataset, shard, chunksets, ingestion_time=0) -> int:
        n = len(chunksets)
        self.chunksets_written += n
        return n

    def write_part_keys(self, dataset, shard, records) -> int:
        self.partkeys_written += len(records)
        return len(records)

    def scan_part_keys(self, dataset, shard):
        return iter(())
