"""Cardinality tracking: how many series a shard holds, and how fast
they churn.

:class:`CardinalityTracker` rides each shard: churn counters and EWMA
creation/removal rates noted at part-id assignment and at evict/purge,
plus ``set_fn``-sampled active-series and label gauges read off the
part-key index's per-value alive refcounts
(``filodb_index_cardinality_*`` / ``filodb_index_churn_*``; reference:
CardinalityManager reading counts off PartKeyLuceneIndex).
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Optional

_METRICS = None


def _m() -> dict:
    global _METRICS
    if _METRICS is None:
        from filodb_tpu_torch.utils.observability import index_metrics
        _METRICS = index_metrics()
    return _METRICS


class Ewma:
    """Exponentially-decayed event-rate estimator (events/second).

    ``note(n)`` adds n events; ``rate()`` reads the decayed rate.  For a
    steady stream of r events/s the estimate converges to r with a half
    life of ``halflife_s`` — the cheap, lock-tiny churn signal the
    explorer exports (a counter alone cannot alert on "creation rate
    spiked" without server-side rate())."""

    __slots__ = ("_tau", "_rate", "_t", "_lock")

    def __init__(self, halflife_s: float = 60.0):
        self._tau = max(halflife_s, 1e-3) / math.log(2)
        self._rate = 0.0
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def _decay_locked(self, now: float) -> None:
        dt = now - self._t
        if dt > 0:
            self._rate *= math.exp(-dt / self._tau)
            self._t = now

    def note(self, n: float = 1.0, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._decay_locked(now)
            self._rate += n / self._tau

    def rate(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._decay_locked(now)
            return self._rate


class CardinalityTracker:
    """Per-shard churn accounting + cardinality gauges.

    The shard calls :meth:`note_created` right after assigning a NEW
    part id and :meth:`note_removed` on evict/purge; both are O(1)
    (one counter inc + one EWMA note).  Gauges are ``set_fn``-sampled
    at scrape time through a weakref to the index, so a dropped shard
    stops exporting instead of pinning the index alive."""

    def __init__(self, dataset: str, shard_num: int,
                 churn_halflife_s: float = 60.0):
        self.dataset = dataset
        self.shard_num = shard_num
        self.created_total = 0
        self.removed_total = 0
        self.create_ewma = Ewma(churn_halflife_s)
        self.remove_ewma = Ewma(churn_halflife_s)
        self._index_ref = None
        m = _m()
        labels = {"dataset": dataset, "shard": shard_num}
        m["create_rate"].set_fn(self.create_ewma.rate, **labels)
        m["remove_rate"].set_fn(self.remove_ewma.rate, **labels)

    def attach_index(self, index) -> None:
        """Register the set_fn cardinality gauges against this index."""
        self._index_ref = weakref.ref(index)
        ref = self._index_ref
        m = _m()
        labels = {"dataset": self.dataset, "shard": self.shard_num}
        m["active_series"].set_fn(
            lambda: float(idx.active_series_count())
            if (idx := ref()) is not None else 0.0, **labels)
        m["labels"].set_fn(
            lambda: float(len(idx.label_names()))
            if (idx := ref()) is not None else 0.0, **labels)

    def close(self) -> None:
        """Deregister every gauge this tracker owns (the Gauge.remove
        contract: set_fn registrants must remove on teardown or the
        registry exports dead-instance rows and pins the callbacks
        forever).  The shard's ``close`` drives it; a tracker recreated
        under the same (dataset, shard) key replaces these
        registrations, so double-close/re-register is safe."""
        m = _m()
        labels = {"dataset": self.dataset, "shard": self.shard_num}
        for name in ("create_rate", "remove_rate", "active_series",
                     "labels"):
            m[name].remove(**labels)

    def note_created(self, n: int = 1) -> None:
        self.created_total += n
        self.create_ewma.note(n)
        _m()["created"].inc(n, dataset=self.dataset, shard=self.shard_num)

    def note_removed(self, reason: str, n: int = 1) -> None:
        self.removed_total += n
        self.remove_ewma.note(n)
        _m()["removed"].inc(n, dataset=self.dataset, shard=self.shard_num,
                            reason=reason)
