"""Quarantine registry: corrupt chunks excluded from serving.

One process-wide registry (``filodb_tpu_torch.integrity.QUARANTINE``)
keyed by ``(partkey bytes, chunk_id)`` — the pair is stable across every
layer that can detect corruption (store read-back, partition decode), so
a chunk quarantined by any of them is excluded by all of them: the
partition read path skips it and the device grid re-stages without it.
Queries overlapping a quarantined chunk count it in
``QueryStats.corrupt_chunks_excluded`` (query/exec.py), never serving
the corrupt values and never silence.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional


class QuarantineRegistry:
    """Thread-safe set of quarantined (partkey, chunk_id) pairs with a
    bounded detail log."""

    def __init__(self, max_details: int = 1024):
        # partkey -> {chunk_id: (start_time, end_time) | None}: the time
        # range lets the query path warn only when a quarantined chunk
        # actually OVERLAPS the scanned window
        self._by_pk: dict[bytes, dict[int, Optional[tuple]]] = {}
        self._details: list[dict] = []
        self._max_details = max_details
        self._dropped_details = 0
        # bumped on every membership change (add OR clear): consumers
        # that keep data staged with quarantine exclusions applied (the
        # device grid cache) key their validity on it — a staged block
        # must never outlive the exclusion set it saw
        self._epoch = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def quarantine(self, partkey: bytes, chunk_id: int, *,
                   reason: str = "", detail: str = "",
                   dataset: Optional[str] = None,
                   shard: Optional[int] = None,
                   start_time: Optional[int] = None,
                   end_time: Optional[int] = None) -> bool:
        """Add one chunk.  Returns True when newly quarantined (callers
        use this for log-once semantics)."""
        partkey = bytes(partkey)
        chunk_id = int(chunk_id)
        span = (start_time, end_time) \
            if start_time is not None and end_time is not None else None
        with self._lock:
            ids = self._by_pk.setdefault(partkey, {})
            if chunk_id in ids:
                return False
            ids[chunk_id] = span
            self._epoch += 1
            if len(self._details) < self._max_details:
                self._details.append({
                    "partkey": partkey.hex(), "chunk_id": chunk_id,
                    "dataset": dataset, "shard": shard, "reason": reason,
                    "start_time": start_time, "end_time": end_time,
                    "detail": detail, "at_ms": int(time.time() * 1000)})
            else:
                self._dropped_details += 1
        # a quarantined chunk is an eviction from the serving set:
        # attribute it on the devicewatch eviction counter + flight ring
        from filodb_tpu_torch.utils.devicewatch import LEDGER
        LEDGER.note_eviction(f"quarantine:{dataset}/{shard}",
                             "integrity_quarantine")
        return True

    def is_quarantined(self, partkey: bytes, chunk_id: int) -> bool:
        with self._lock:
            ids = self._by_pk.get(bytes(partkey))
            return ids is not None and int(chunk_id) in ids

    def chunk_ids(self, partkey: bytes) -> frozenset:
        """Quarantined chunk ids for one partkey (empty when none)."""
        with self._lock:
            ids = self._by_pk.get(bytes(partkey))
            return frozenset(ids) if ids else frozenset()

    def count_for(self, partkey: bytes) -> int:
        with self._lock:
            ids = self._by_pk.get(bytes(partkey))
            return len(ids) if ids else 0

    def count_overlapping(self, partkeys: Iterable[bytes],
                          start_time: int, end_time: int) -> int:
        """Quarantined chunks across a partkey set whose time range
        overlaps [start_time, end_time] — the leaf query plan's
        partial-data check: a corrupt chunk outside the scanned window
        excluded nothing from THIS result, so it must not flag it.
        Chunks quarantined without a known range count conservatively.
        O(1) when nothing is quarantined (the common case)."""
        with self._lock:
            if not self._by_pk:
                return 0
            by_pk = self._by_pk
            n = 0
            for pk in map(bytes, partkeys):
                ids = by_pk.get(pk)
                if not ids:
                    continue
                for span in ids.values():
                    if span is None or (span[1] >= start_time
                                        and span[0] <= end_time):
                        n += 1
            return n

    def total(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._by_pk.values())

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._by_pk)

    def items(self) -> list[dict]:
        """Detail records (bounded at construction; ``dropped`` in
        :meth:`summary` counts overflow)."""
        with self._lock:
            return [dict(d) for d in self._details]

    def summary(self) -> dict:
        with self._lock:
            return {"quarantined_chunks":
                    sum(len(v) for v in self._by_pk.values()),
                    "quarantined_partkeys": len(self._by_pk),
                    "detail_records": len(self._details),
                    "detail_records_dropped": self._dropped_details}

    def epoch(self) -> int:
        """Monotone membership version: changes whenever the exclusion
        set changes in either direction."""
        with self._lock:
            return self._epoch

    def clear(self) -> None:
        """Operator action (and test isolation): forget everything."""
        with self._lock:
            if self._by_pk:
                self._epoch += 1
            self._by_pk.clear()
            self._details.clear()
            self._dropped_details = 0
