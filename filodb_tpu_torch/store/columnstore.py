"""ChunkSink / ColumnStore: where flushed chunks and part keys persist.

Capability match for the reference's ChunkSink/ColumnStore API plus its
NullColumnStore test double (reference: core/src/main/scala/filodb.core/
store/ChunkSink.scala:21,116, ColumnStore.scala:59) and the Cassandra table
model it persists into — chunks by (partkey, chunk_id), an ingestion-time
index for batch jobs, and partkeys with start/end times per shard
(reference: cassandra/.../TimeSeriesChunksTable.scala:22,
IngestionTimeIndexTable.scala:22, PartitionKeysTable.scala:15).  Concrete
backends: in-memory (tests), local disk (persistence.py).  Host code
only: nothing here touches the device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

from filodb_tpu_torch.core.chunk import ChunkSet


class ScanBytesExceeded(Exception):
    """A capped raw-row read crossed its byte budget (a bulk page-in
    streams the cap inside the chunk read instead of paying a separate
    metadata pre-pass; the caller decides whether the precise
    range-overlap accounting still permits the query)."""


@dataclasses.dataclass
class PartKeyRecord:
    partkey: bytes
    start_time: int
    end_time: int
    shard: int
    schema_hash: int = 0  # 16-bit schema id so readers recover exact schemas


class ColumnStore:
    """Sink + source of persisted chunks.  All times are epoch millis."""

    def initialize(self, dataset: str, num_shards: int) -> None:
        pass

    # -- sink (flush path) --------------------------------------------------

    def write_chunks(self, dataset: str, shard: int,
                     chunksets: Sequence[ChunkSet],
                     ingestion_time: int = 0) -> int:
        raise NotImplementedError

    def write_part_keys(self, dataset: str, shard: int,
                        records: Sequence[PartKeyRecord]) -> int:
        raise NotImplementedError

    def merge_part_keys(self, dataset: str, shard: int,
                        records: Sequence["PartKeyRecord"]) -> int:
        """Upsert partkeys WIDENING the stored lifetime (min start, max
        end) instead of replacing it — the batch downsampler writes one
        ingestion window at a time, and a later window must not narrow a
        partkey's visible range (write_part_keys replaces, which is
        right for the memstore flush path that recomputes full
        lifetimes).  Default: read-modify-write via scan_part_keys."""
        existing = {r.partkey: r for r in self.scan_part_keys(dataset,
                                                              shard)}
        merged = []
        for r in records:
            old = existing.get(r.partkey)
            if old is not None:
                r = PartKeyRecord(r.partkey,
                                  min(old.start_time, r.start_time),
                                  max(old.end_time, r.end_time),
                                  r.shard, r.schema_hash)
            merged.append(r)
        return self.write_part_keys(dataset, shard, merged)

    def deferred_commits(self):
        """Context manager batching the durability point of the write
        calls inside it into ONE commit at exit (the batch downsampler's
        many small per-resolution writes).  Default: no-op — stores
        whose writes are already atomic per call need nothing."""
        import contextlib
        return contextlib.nullcontext()

    # -- source (paging / recovery path) -------------------------------------

    def read_raw_partitions(self, dataset: str, shard: int,
                            partkeys: Sequence[bytes],
                            start_time: int, end_time: int
                            ) -> Iterator[tuple[bytes, list[ChunkSet]]]:
        raise NotImplementedError

    def read_raw_rows(self, dataset: str, shard: int,
                      partkeys: Sequence[bytes], start_time: int,
                      end_time: int,
                      byte_cap: int | None = None,
                      defer_verify: bool = False) -> Optional[list[tuple]]:
        """Raw FRAMED chunk rows for a bulk page-in (see
        persistence.DiskColumnStore.read_raw_rows for the row layout,
        cap and integrity contracts; rows may carry a trailing stored
        crc that callers index positionally or ignore).  None =
        unsupported; callers use the per-partition
        :meth:`read_raw_partitions` path."""
        return None

    def scan_part_keys(self, dataset: str, shard: int) -> Iterator[PartKeyRecord]:
        raise NotImplementedError

    def scan_bytes(self, dataset: str, shard: int, partkeys: Sequence[bytes],
                   start_time: int, end_time: int) -> int:
        """Encoded bytes of chunks overlapping [start_time, end_time] for the
        given partkeys, WITHOUT reading the vectors — lets a paging path
        enforce max-data-per-shard-query before paying the page-in cost
        (reference: capDataScannedPerShardCheck runs before paging)."""
        total = 0
        for _pk, chunks in self.read_raw_partitions(dataset, shard, partkeys,
                                                    start_time, end_time):
            total += sum(cs.nbytes for cs in chunks)
        return total

    def chunksets_by_ingestion_time(self, dataset: str, shard: int,
                                    start: int, end: int) -> Iterator[ChunkSet]:
        """Scan-by-ingestion-time for the batch downsampler (reference:
        getChunksByIngestionTimeRange)."""
        for _itime, cs in self.chunksets_with_ingestion_time(dataset, shard,
                                                             start, end):
            yield cs

    def chunksets_with_ingestion_time(self, dataset: str, shard: int,
                                      start: int, end: int
                                      ) -> Iterator[tuple[int, ChunkSet]]:
        """Like chunksets_by_ingestion_time but yields (ingestion_time,
        chunkset) so copies preserve the timeline (ChunkCopier)."""
        raise NotImplementedError

    def delete_part_keys(self, dataset: str, shard: int,
                         partkeys: Sequence[bytes]) -> int:
        """Delete partkeys and their chunks (reference:
        PerShardCardinalityBuster)."""
        raise NotImplementedError

    def clone_shard(self, dataset: str, src_shard: int, dst_shard: int,
                    keep_pk) -> int:
        """Copy ``src_shard``'s persisted chunks + partkeys whose
        partkey passes ``keep_pk`` into ``dst_shard`` (a shard split's
        catch-up backfill: the child inherits the parent's persisted
        history for its half of the hash space).  IDEMPOTENT — keys are
        upserts on (dataset, shard, partkey[, chunk_id]), so a crashed
        clone simply reruns.  Returns chunk rows copied."""
        recs = [r for r in self.scan_part_keys(dataset, src_shard)
                if keep_pk(r.partkey)]
        if recs:
            self.write_part_keys(dataset, dst_shard, [
                PartKeyRecord(r.partkey, r.start_time, r.end_time,
                              dst_shard, r.schema_hash) for r in recs])
        n = 0
        batch: dict[int, list] = {}
        for itime, cs in self.chunksets_with_ingestion_time(
                dataset, src_shard, 0, (1 << 62)):
            if not keep_pk(cs.partkey):
                continue
            batch.setdefault(itime, []).append(cs)
            n += 1
        for itime, css in batch.items():
            self.write_chunks(dataset, dst_shard, css, itime)
        return n

    def delete_shard(self, dataset: str, shard: int) -> int:
        """Drop EVERY persisted row of one shard (split abort discards
        the children's cloned/backfilled data wholesale)."""
        pks = [r.partkey for r in self.scan_part_keys(dataset, shard)]
        seen = set(pks)
        # chunks can exist for partkeys never flushed into the partkeys
        # table (evicted before their first dirty-key flush) — sweep the
        # chunk side too so an aborted child leaves nothing behind
        for _itime, cs in self.chunksets_with_ingestion_time(
                dataset, shard, 0, (1 << 62)):
            if cs.partkey not in seen:
                seen.add(cs.partkey)
                pks.append(cs.partkey)
        if pks:
            self.delete_part_keys(dataset, shard, pks)
        return len(pks)

    def shutdown(self) -> None:
        pass


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

    def read_raw_partitions(self, dataset, shard, partkeys, start_time, end_time):
        return iter(())

    def scan_part_keys(self, dataset, shard):
        return iter(())

    def chunksets_with_ingestion_time(self, dataset, shard, start, end):
        return iter(())

    def delete_part_keys(self, dataset, shard, partkeys) -> int:
        return 0


class InMemoryColumnStore(ColumnStore):
    """Everything in host dicts; the test/recovery double with real reads."""

    def __init__(self) -> None:
        # (dataset, shard) -> partkey -> list[(ingestion_time, ChunkSet)]
        self._chunks: dict[tuple, dict[bytes, list]] = {}
        # (dataset, shard) -> partkey -> PartKeyRecord
        self._partkeys: dict[tuple, dict[bytes, PartKeyRecord]] = {}

    def write_chunks(self, dataset, shard, chunksets, ingestion_time=0) -> int:
        store = self._chunks.setdefault((dataset, shard), {})
        for cs in chunksets:
            store.setdefault(cs.partkey, []).append((ingestion_time, cs))
        return len(chunksets)

    def write_part_keys(self, dataset, shard, records) -> int:
        store = self._partkeys.setdefault((dataset, shard), {})
        for r in records:
            store[r.partkey] = r
        return len(records)

    def read_raw_partitions(self, dataset, shard, partkeys, start_time, end_time):
        store = self._chunks.get((dataset, shard), {})
        for pk in partkeys:
            rows = [cs for _, cs in store.get(pk, ())
                    if cs.info.end_time >= start_time
                    and cs.info.start_time <= end_time]
            if rows:
                yield pk, sorted(rows, key=lambda c: c.info.chunk_id)

    def scan_part_keys(self, dataset, shard):
        yield from self._partkeys.get((dataset, shard), {}).values()

    def chunksets_with_ingestion_time(self, dataset, shard, start, end):
        for rows in self._chunks.get((dataset, shard), {}).values():
            for itime, cs in rows:
                if start <= itime <= end:
                    yield itime, cs

    def delete_part_keys(self, dataset, shard, partkeys) -> int:
        pk_store = self._partkeys.get((dataset, shard), {})
        ch_store = self._chunks.get((dataset, shard), {})
        n = 0
        for pk in partkeys:
            if pk_store.pop(pk, None) is not None:
                n += 1
            ch_store.pop(pk, None)
        return n
