"""Retention-driven tier migration: local sqlite rows -> bucket objects.

One pass per (dataset, shard): every chunk row wholly older than
``now - retention`` is uploaded (read-back CRC-verified), and ONLY then
deleted locally — a crash between upload and delete leaves the row in
both tiers, which the TieredColumnStore read path dedupes (local wins)
and the next pass re-uploads idempotently (same key, same bytes).
Corrupt local rows are quarantined by the verified scan and stay local:
corruption never gets archived as truth.

The per-shard WATERMARK (the cutoff of the last completed pass) persists
in the meta store's KV under ``coldstore_ageout:{ds}:{shard}``;
``floor_ms(dataset)`` — the min across shards — is the boundary a
resolution router can use as the rolled-local / rolled-cold stitch
point.  The boundary is attribution-only for correctness: both stitch
legs read through the same TieredColumnStore, so a stale watermark can
misattribute a tier but never change results.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

from filodb_tpu_torch.coldstore.store import ColdChunkStore, ColdWriteError
from filodb_tpu_torch.utils.observability import coldstore_metrics

_LOG = logging.getLogger("filodb.coldstore")

KV_PREFIX = "coldstore_ageout:"


class AgeOutManager:
    """Moves aged chunk rows local -> cold and tracks the per-shard
    watermarks a stitch router reads."""

    def __init__(self, local, cold: ColdChunkStore, metastore=None,
                 now_ms_fn=None, delete_batch: int = 512) -> None:
        self.local = local
        self.cold = cold
        self.metastore = metastore
        self._now_ms = now_ms_fn or (lambda: int(time.time() * 1000))
        self.delete_batch = delete_batch
        # (dataset, shard) -> cutoff_ms of the last COMPLETED pass
        self._watermarks: dict = {}
        self._loaded_kv = False

    # ---------------------------------------------------------- watermarks

    def _load_kv(self) -> None:
        if self._loaded_kv or self.metastore is None:
            return
        self._loaded_kv = True
        for key, val in self.metastore.list_kv(KV_PREFIX).items():
            try:
                _pfx, ds, shard = key.rsplit(":", 2)
                self._watermarks[(ds, int(shard))] = int(val)
            except ValueError:
                _LOG.warning("ignoring malformed age-out watermark %s=%s",
                             key, val)

    def _set_watermark(self, dataset: str, shard: int, cutoff: int) -> None:
        self._watermarks[(dataset, shard)] = cutoff
        if self.metastore is not None:
            self.metastore.write_kv(f"{KV_PREFIX}{dataset}:{shard}",
                                    str(cutoff))

    def watermark_ms(self, dataset: str, shard: int) -> int:
        """Cutoff of the last completed pass for one shard; 0 = never."""
        self._load_kv()
        return self._watermarks.get((dataset, shard), 0)

    def floor_ms(self, dataset: str) -> int:
        """The dataset's cold boundary: chunks ending before this are
        archived on EVERY shard that ever completed a pass — the min
        across recorded shard watermarks, 0 when none exist (no cold leg
        yet)."""
        self._load_kv()
        marks = [wm for (ds, _sh), wm in self._watermarks.items()
                 if ds == dataset]
        return min(marks) if marks else 0

    # ---------------------------------------------------------- passes

    def _shards(self, dataset: str,
                shards: Optional[Sequence[int]]) -> list:
        if shards is not None:
            return list(shards)
        return self.local.list_shards(dataset)

    def plan(self, dataset: str, retention_ms: int,
             shards: Optional[Sequence[int]] = None) -> dict:
        """Dry run: what a pass WOULD move, metadata-only (no uploads, no
        deletes, no watermark advance)."""
        cutoff = self._now_ms() - retention_ms
        per_shard = []
        total_rows = total_bytes = 0
        for sh in self._shards(dataset, shards):
            rows, nbytes = self.local.count_chunks_aged(dataset, sh, cutoff)
            per_shard.append({"shard": sh, "chunks": rows, "bytes": nbytes,
                              "watermark_ms": self.watermark_ms(dataset, sh)})
            total_rows += rows
            total_bytes += nbytes
        return {"dataset": dataset, "cutoff_ms": cutoff,
                "retention_ms": retention_ms, "shards": per_shard,
                "total_chunks": total_rows, "total_bytes": total_bytes}

    def run(self, dataset: str, retention_ms: int,
            shards: Optional[Sequence[int]] = None) -> dict:
        """One migration pass.  Returns the summary dict; raises on an
        upload/verify failure (the shard's watermark does not advance,
        nothing local was deleted for the failed row)."""
        m = coldstore_metrics()
        cutoff = self._now_ms() - retention_ms
        per_shard = []
        total_rows = total_bytes = 0
        for sh in self._shards(dataset, shards):
            moved = moved_bytes = 0
            doomed: list = []
            try:
                for (pk, cid, nr, st, et, schema_hash, blob, crc,
                     itime) in self.local.scan_chunk_rows_aged(
                         dataset, sh, cutoff):
                    self.cold.put_chunk_row(
                        dataset, sh, pk, cid, nr, st, et, schema_hash,
                        itime, bytes(blob), crc, verify=True)
                    doomed.append((pk, cid))
                    moved += 1
                    moved_bytes += len(blob)
                    if len(doomed) >= self.delete_batch:
                        self.local.delete_chunk_rows(dataset, sh, doomed)
                        doomed.clear()
            except ColdWriteError:
                # verified rows already uploaded stay correct once
                # deleted; the failed row is still local and the
                # watermark does not advance — the next pass retries
                if doomed:
                    self.local.delete_chunk_rows(dataset, sh, doomed)
                raise
            if doomed:
                self.local.delete_chunk_rows(dataset, sh, doomed)
            self._set_watermark(dataset, sh, cutoff)
            if moved:
                m["aged_chunks"].inc(moved, dataset=dataset)
                m["aged_bytes"].inc(moved_bytes, dataset=dataset)
                _LOG.info("aged out %d chunks (%d bytes) %s/%d -> cold "
                          "(cutoff=%d)", moved, moved_bytes, dataset, sh,
                          cutoff)
            m["watermark"].set(cutoff, dataset=dataset, shard=str(sh))
            per_shard.append({"shard": sh, "chunks": moved,
                              "bytes": moved_bytes, "watermark_ms": cutoff})
            total_rows += moved
            total_bytes += moved_bytes
        return {"dataset": dataset, "cutoff_ms": cutoff,
                "retention_ms": retention_ms, "shards": per_shard,
                "total_chunks": total_rows, "total_bytes": total_bytes}
