"""Ingest cardinality quotas: cap active series per tenant.

Capability match for the reference's CardinalityManager + QuotaSource
(reference: coordinator/.../CardinalityManager.scala — per-namespace
active-timeseries counts maintained from the part-key index, new series
over quota rejected at ingest).  One :class:`SeriesQuota` is shared by
every shard of a dataset:

- the shard consults it in ``_get_or_add_partition_pk`` right before
  assigning a new part id: an over-quota tenant's NEW series is
  rejected (its rows dropped and counted) while existing series keep
  ingesting;
- counts follow part-key-index lifecycle events (series created, and
  removed on evict and purge) and can be rebuilt from the index's
  per-value alive refcounts (:meth:`SeriesQuota.refresh_from_index`)
  after recovery.

Metrics: ``filodb_quota_active_series{dataset,tenant}``,
``filodb_quota_limit_series``, ``filodb_quota_rejected_series_total``,
``filodb_quota_dropped_samples_total``.
"""

from __future__ import annotations

import threading
from typing import Mapping, Optional


def _metrics():
    from filodb_tpu_torch.utils.observability import workload_metrics
    return workload_metrics()


class SeriesQuotaExceeded(Exception):
    """A new series would push its tenant over quota."""

    def __init__(self, tenant: str, active: int, limit: int):
        super().__init__(
            f"tenant {tenant!r} is at its active-series quota "
            f"({active}/{limit}); new series rejected")
        self.tenant = tenant
        self.active = active
        self.limit = limit


class SeriesQuota:
    """Active-series counting + limits per tenant for ONE dataset.

    The tenant key is the value of ``tenant_label`` (default the
    namespace shard-key column ``_ns_``); series without the label pool
    under ``""``.  ``default_limit=None`` means unlimited unless an
    override names the tenant."""

    def __init__(self, dataset: str = "", tenant_label: str = "_ns_",
                 default_limit: Optional[int] = None,
                 overrides: Optional[Mapping[str, int]] = None):
        self.dataset = dataset
        self.tenant_label = tenant_label
        self.default_limit = default_limit
        self.overrides = {str(k): int(v)
                          for k, v in (overrides or {}).items()}
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        m = _metrics()
        self._m_active = m["quota_active"]
        self._m_limit = m["quota_limit"]
        self._m_rejected = m["quota_rejected"]
        self._m_dropped = m["quota_dropped_samples"]
        for tenant, lim in self.overrides.items():
            self._m_limit.set(lim, dataset=dataset, tenant=tenant)

    # ------------------------------------------------------------------ api

    def tenant_of(self, tags: Mapping[str, str]) -> str:
        return tags.get(self.tenant_label, "")

    def limit_for(self, tenant: str) -> Optional[int]:
        lim = self.overrides.get(tenant, self.default_limit)
        return None if lim is None else int(lim)

    def active(self, tenant: str) -> int:
        with self._lock:
            return self._counts.get(tenant, 0)

    def allow_new_series(self, tags: Mapping[str, str],
                         shard: Optional[int] = None) -> bool:
        """Check-and-count for a series about to be CREATED: increments
        the tenant's active count and returns True when under quota;
        counts the rejection and returns False otherwise."""
        tenant = self.tenant_of(tags)
        lim = self.limit_for(tenant)
        with self._lock:
            n = self._counts.get(tenant, 0)
            if lim is not None and n >= lim:
                reject = True
            else:
                reject = False
                self._counts[tenant] = n + 1
        if reject:
            self._m_rejected.inc(dataset=self.dataset, tenant=tenant)
            return False
        self._m_active.set(n + 1, dataset=self.dataset, tenant=tenant)
        return True

    def over_limit(self, tags: Mapping[str, str]) -> bool:
        """Read-only probe: would a NEW series of this tenant be
        rejected right now?"""
        tenant = self.tenant_of(tags)
        lim = self.limit_for(tenant)
        if lim is None:
            return False
        with self._lock:
            return self._counts.get(tenant, 0) >= lim

    def note_removed(self, tags: Mapping[str, str], n: int = 1) -> None:
        """Series left the index (evicted/purged): free its quota."""
        tenant = self.tenant_of(tags)
        with self._lock:
            left = self._counts.get(tenant, 0) - n
            if left <= 0:
                self._counts.pop(tenant, None)
                left = 0
            else:
                self._counts[tenant] = left
        self._m_active.set(left, dataset=self.dataset, tenant=tenant)

    def note_dropped_samples(self, tags: Mapping[str, str],
                             n: int = 1) -> None:
        self._m_dropped.inc(n, dataset=self.dataset,
                            tenant=self.tenant_of(tags))

    # ------------------------------------------------------------- lifecycle

    def refresh_from_index(self, *indexes) -> None:
        """Rebuild counts from part-key indexes (recovery/bootstrap):
        the per-value alive refcounts of the tenant label ARE the
        active-series counts — O(values), no document walk."""
        merged: dict[str, int] = {}
        for index in indexes:
            vc = index.value_counts(self.tenant_label)
            for value, n in vc.items():
                merged[value] = merged.get(value, 0) + n
            # series lacking the tenant label pool under ""
            untagged = len(index) - sum(vc.values())
            if untagged > 0:
                merged[""] = merged.get("", 0) + untagged
        with self._lock:
            self._counts = merged
        for tenant, n in merged.items():
            self._m_active.set(n, dataset=self.dataset, tenant=tenant)

    def snapshot(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
        return {"tenant_label": self.tenant_label,
                "default_limit": self.default_limit,
                "overrides": dict(self.overrides),
                "active": counts}
