"""Ingest watermark ledger: how far behind each shard is.

An operator's first question, "is ingestion keeping up", is answered by
per-shard offsets and per-group recovery watermarks (reference:
TimeSeriesShard group watermarks :155-157, checkpoint reads
IngestionActor.scala:193-217, ShardHealthStats).  The
:class:`WatermarkLedger` samples them into one monotone chain a shard::

    broker_end >= ingested >= flushed (group min) >= checkpoint

exported as ``filodb_ingest_watermark_offset{stage=}`` with lag gauges in
rows and seconds, and joined with the FlushScheduler's queue snapshot
and the ShardMapper's status.  A shard whose row lag is nonzero while
its ingested offset makes no progress for ``stall_window_s`` records an
``ingest.stall`` flight event and ``filodb_ingest_stalls_total`` once an
episode (re-armed on progress), and holds ``filodb_ingest_stalled`` at 1
meanwhile.

One ledger a server, not one a process: several nodes in one process
have colliding (dataset, shard) keys, and the ``node`` label keeps their
rows apart.  :class:`TierWatermarks` keeps peers' rolled-through
watermarks for a cluster's stitch boundary; the port has no peers yet,
so it only holds what it is told.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from filodb_tpu_torch.utils.devicewatch import FLIGHT
from filodb_tpu_torch.utils.observability import (PeriodicThread,
                                                  watermark_metrics)

_STAGES = ("broker_end", "ingested", "flushed", "checkpoint")


class _Watch:
    __slots__ = ("memstore", "mapper", "end_offset_fn")

    def __init__(self, memstore, mapper, end_offset_fn):
        self.memstore = memstore
        self.mapper = mapper
        self.end_offset_fn = end_offset_fn


class WatermarkLedger:
    """Samples every watched dataset's shards into a health tree.

    ``sample()`` is driven by :class:`WatermarkSampler` and by any
    caller that wants live numbers; the stall state advances on every
    call."""

    def __init__(self, stall_window_s: float = 30.0, node: str = ""):
        self.stall_window_s = float(stall_window_s)
        self.node = node
        self._watches: dict[str, _Watch] = {}  # guarded-by: _lock
        # (dataset, shard) -> stall state; advanced under the lock, or
        # two concurrent samples double-count an episode boundary
        self._stall: dict[tuple, dict] = {}  # guarded-by: _lock
        # (dataset, shard) label sets this ledger exported rows for:
        # close() and unwatch() remove them, so a dead server's
        # ``stalled=1`` row does not stay in the registry
        self._emitted: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()

    def watch(self, dataset: str, memstore, mapper=None,
              end_offset_fn: Optional[Callable[[int], int]] = None) -> None:
        """Track a dataset; its shards are enumerated afresh on every
        sample.  ``end_offset_fn(shard)`` returns the broker head of the
        shard's partition; None = no broker stage (in-process sources)."""
        with self._lock:
            self._watches[dataset] = _Watch(memstore, mapper, end_offset_fn)

    def unwatch(self, dataset: str) -> None:
        with self._lock:
            self._watches.pop(dataset, None)
            gone = [k for k in self._emitted if k[0] == dataset]
            for k in gone:
                self._emitted.discard(k)
        for _ds, shard in gone:
            self._remove_rows(dataset, shard)

    def _remove_rows(self, dataset: str, shard: int) -> None:
        m = watermark_metrics()
        labels = {"dataset": dataset, "shard": shard, "node": self.node}
        for stage in _STAGES:
            m["offset"].remove(stage=stage, **labels)
        m["lag_rows"].remove(**labels)
        m["lag_seconds"].remove(**labels)
        m["stalled"].remove(**labels)

    def close(self) -> None:
        """Drop every gauge row this ledger exported."""
        with self._lock:
            emitted, self._emitted = self._emitted, set()
            self._watches.clear()
        for dataset, shard in emitted:
            self._remove_rows(dataset, shard)

    def watching(self) -> list[str]:
        with self._lock:
            return list(self._watches)

    # --------------------------------------------------------------- sample

    @staticmethod
    def _flush_row(sh) -> Optional[dict]:
        sched = getattr(sh, "flush_scheduler", None)
        if sched is None:
            return None
        try:
            return sched.snapshot()
        except Exception:  # noqa: BLE001 — scheduler mid-close
            return None

    @staticmethod
    def _checkpoint(dataset: str, sh) -> Optional[int]:
        try:
            cps = sh.meta.read_checkpoints(dataset, sh.shard_num)
        except Exception:  # noqa: BLE001 — meta store shut down
            return None
        return min(cps.values()) if cps else -1

    def _note_stall(self, dataset: str, shard: int, ingested: int,
                    lag_rows: int, now: float) -> bool:
        """Advance the shard's stall machine; True while it counts as
        stalled.  One counter bump and flight event an episode; progress
        re-arms it."""
        key = (dataset, shard)
        with self._lock:
            st = self._stall.get(key)
            if lag_rows <= 0:
                self._stall.pop(key, None)
                return False
            if st is None or st["offset"] != ingested:
                self._stall[key] = {"offset": ingested, "since": now,
                                    "fired": False}
                return False
            if now - st["since"] < self.stall_window_s:
                return False
            fire = not st["fired"]
            st["fired"] = True
            since = st["since"]
        if fire:
            watermark_metrics()["stalls"].inc(dataset=dataset, shard=shard,
                                              node=self.node)
            FLIGHT.record("ingest.stall", dataset=dataset, shard=shard,
                          node=self.node, lag_rows=lag_rows,
                          stalled_for_s=round(now - since, 3))
        return True

    def _shard_row(self, dataset: str, sh, watch: _Watch,
                   now_mono: float, now_ms: int) -> dict:
        m = watermark_metrics()
        labels = {"dataset": dataset, "shard": sh.shard_num,
                  "node": self.node}
        ingested = sh.latest_offset
        flushed = min(sh.group_watermarks) if sh.group_watermarks else -1
        checkpoint = self._checkpoint(dataset, sh)
        broker_end = None
        if watch.end_offset_fn is not None:
            try:
                broker_end = int(watch.end_offset_fn(sh.shard_num))
            except Exception:  # noqa: BLE001 — broker unreachable
                broker_end = None
        # end_offset is the NEXT offset to be written, latest_offset the
        # last one ingested: the lag is what lies between them
        lag_rows = max(0, broker_end - 1 - ingested) \
            if broker_end is not None else 0
        lag_seconds = 0.0
        if lag_rows > 0 and sh.latest_ingest_ts >= 0:
            lag_seconds = max(0.0, (now_ms - sh.latest_ingest_ts) / 1000.0)
        stalled = self._note_stall(dataset, sh.shard_num, ingested,
                                   lag_rows, now_mono)
        watermarks = {"ingested": ingested, "flushed": flushed,
                      "groups": list(sh.group_watermarks)}
        if broker_end is not None:
            watermarks["broker_end"] = broker_end
        if checkpoint is not None:
            watermarks["checkpoint"] = checkpoint
        for stage in _STAGES:
            if stage in watermarks:
                m["offset"].set(watermarks[stage], stage=stage, **labels)
        with self._lock:
            self._emitted.add((dataset, sh.shard_num))
        m["lag_rows"].set(lag_rows, **labels)
        m["lag_seconds"].set(lag_seconds, **labels)
        # the level alert rules watch: a counter's label set is born at 1,
        # so increase() over it never sees the first episode
        m["stalled"].set(1.0 if stalled else 0.0, **labels)
        row = {"shard": sh.shard_num,
               "watermarks": watermarks,
               "lag": {"rows": lag_rows, "seconds": round(lag_seconds, 3)},
               "stalled": stalled,
               "rows_ingested": sh.stats.rows_ingested,
               "latest_ingest_ts": sh.latest_ingest_ts}
        flush = self._flush_row(sh)
        if flush is not None:
            row["flush"] = flush
        if watch.mapper is not None \
                and sh.shard_num < watch.mapper.num_shards:
            # the port's mapper has no replicas or split topology yet: the
            # shard's own status is its serving status
            st = watch.mapper.status(sh.shard_num)
            row["status"] = st.value
            row["queryable"] = st.queryable
        return row

    def sample(self) -> dict:
        """One pass over every watched dataset: refresh the gauges,
        advance stall detection, return the health tree."""
        with self._lock:
            watches = dict(self._watches)
        now_mono = time.monotonic()
        now_ms = int(time.time() * 1000)
        datasets: dict = {}
        for ds, watch in watches.items():
            rows = [self._shard_row(ds, sh, watch, now_mono, now_ms)
                    for sh in watch.memstore.shards(ds)]
            rows.sort(key=lambda r: r["shard"])
            datasets[ds] = {
                "shards": rows,
                "totals": {
                    "lag_rows": sum(r["lag"]["rows"] for r in rows),
                    "stalled": sum(1 for r in rows if r["stalled"]),
                    "queryable": sum(1 for r in rows
                                     if r.get("queryable", True)),
                },
            }
        return {"node": self.node, "stall_window_s": self.stall_window_s,
                "sampled_at_ms": now_ms, "datasets": datasets}


class TierWatermarks:
    """Cluster-wide rolled-through watermarks of each peer's rollup
    tiers: the stitch boundary of a dataset is the newest stamp every
    shard-owning peer has closed (:meth:`cluster_min`).  One a server,
    like the :class:`WatermarkLedger`."""

    def __init__(self, node: str = ""):
        self.node = node
        # (peer node, dataset) -> {resolution_ms: rolled_through_ms}
        self._peers: dict[tuple, dict] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def note(self, peer: str, dataset: str, tiers: dict) -> None:
        """Fold one peer's ``{resolution_ms: through_ms}``; values only
        advance (a stale poll racing a fresh one must not drag the
        boundary back)."""
        with self._lock:
            row = self._peers.setdefault((peer, dataset), {})
            for res, through in tiers.items():
                res = int(res)
                row[res] = max(row.get(res, -(1 << 62)), int(through))

    def peer_value(self, peer: str, dataset: str,
                   res: int) -> Optional[int]:
        with self._lock:
            row = self._peers.get((peer, dataset))
            return None if row is None else row.get(int(res))

    def forget(self, peer: str) -> None:
        """Drop a departed node's rows: its frozen boundary must not cap
        the cluster's stitch forever."""
        with self._lock:
            for key in [k for k in self._peers if k[0] == peer]:
                del self._peers[key]

    def cluster_min(self, dataset: str, res: int,
                    peers) -> Optional[int]:
        """Min of the given peers' watermarks; None while any peer has
        not reported (the caller keeps its own conservative boundary)."""
        vals = []
        for peer in set(peers):
            v = self.peer_value(peer, dataset, res)
            if v is None:
                return None
            vals.append(v)
        return min(vals) if vals else None

    def snapshot(self) -> dict:
        with self._lock:
            return {f"{peer}/{ds}": {str(r): v for r, v in row.items()}
                    for (peer, ds), row in sorted(self._peers.items())}


class WatermarkSampler(PeriodicThread):
    """Background sampler: ``ledger.sample()`` every ``interval_s``, so
    that lag gauges and stall events exist without anyone asking."""

    def __init__(self, ledger: WatermarkLedger, interval_s: float = 10.0):
        super().__init__(ledger.sample, interval_s, "watermark-sampler")
        self.ledger = ledger
