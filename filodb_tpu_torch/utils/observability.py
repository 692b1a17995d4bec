"""Observability: the counters and the tracing spans the query engine
reports into.

Capability match for the reference's Kamon-based instrumentation
(reference: coordinator/.../KamonLogger.scala:146 metric/span log
reporters; Kamon.spanBuilder in ExecPlan.execute ExecPlan.scala:99-126).
This package keeps the part its query, flush and integrity paths call:
counters, gauges and histograms in a process-wide registry
(``downsample_metrics``, ``integrity_metrics``, ``query_metrics``,
``flush_metrics``, ``resultcache_metrics`` and the families below) and
a thread-local span stack with pluggable reporters (:data:`TRACER`).
Everything is stdlib.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import random
import threading
import time
import traceback
from typing import Callable, Optional, Sequence

# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0)


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = collections.defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += amount

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def total(self) -> float:
        """The sum over every label set."""
        with self._lock:
            return sum(self._values.values())


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._fns: dict[tuple, Callable[[], float]] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def set_fn(self, fn: Callable[[], float], **labels) -> None:
        """Lazily-sampled gauge (e.g. a queue depth at read time)."""
        with self._lock:
            self._fns[tuple(sorted(labels.items()))] = fn

    def value(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        if key in self._fns:
            return float(self._fns[key]())
        return self._values.get(key, 0.0)

    def remove(self, **labels) -> None:
        """Drop one label set (both value and set_fn).  Components that
        register bound-method callbacks must call this on shutdown or
        the registry keeps them (and everything they capture) alive."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._fns.pop(key, None)
            self._values.pop(key, None)


class Histogram:
    """Cumulative-bucket histogram (seconds by convention)."""

    def __init__(self, name: str, help_: str = "",
                 buckets: Sequence[float] = _BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        # per-bucket raw counts (one extra slot for > last bucket):
        # observe() does one bisect and one increment
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = collections.defaultdict(float)
        self._totals: dict[tuple, int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def counts(self, **labels) -> list[int]:
        """Raw (non-cumulative) counts of one label set, the overflow
        slot last."""
        with self._lock:
            got = self._counts.get(tuple(sorted(labels.items())))
            return list(got) if got else [0] * (len(self.buckets) + 1)


class MetricsRegistry:
    """Process-wide named metrics (replaces Kamon's metric registry)."""

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = _BUCKETS) -> Histogram:
        return self._get(name, lambda: Histogram(name, help_, buckets),
                         Histogram)

    def _get(self, name, ctor, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = ctor()
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as "
                                f"{type(m).__name__}")
            return m


REGISTRY = MetricsRegistry()


def downsample_metrics() -> dict:
    """Visualization downsampling (``DownsampleMapper``, ops/grid.py
    m4_grid): the point-volume reduction."""
    return {
        "points_in": REGISTRY.counter(
            "filodb_downsample_points_in_total",
            "finite samples entering the downsampler"),
        "points_out": REGISTRY.counter(
            "filodb_downsample_points_out_total",
            "pixel-exact samples kept (<= 4 per pixel bin per series)"),
    }


def integrity_metrics() -> dict:
    """Integrity counters (``filodb_tpu_torch.integrity``): one place
    defines the metric names.  Labels: ``dataset``/``shard`` when the
    detection site knows them."""
    return {
        "checksum_failures": REGISTRY.counter(
            "filodb_integrity_checksum_failures_total",
            "chunk blobs whose stored CRC32C did not match on read-back"),
        "decode_failures": REGISTRY.counter(
            "filodb_integrity_decode_failures_total",
            "chunk vectors whose native/numpy decode hit a -1 sentinel"),
        "chunks_verified": REGISTRY.counter(
            "filodb_integrity_chunks_verified_total",
            "chunk blobs checksum-verified on read-back or page-in"),
        "chunks_quarantined": REGISTRY.gauge(
            "filodb_integrity_quarantined_chunks",
            "chunks currently excluded from serving by the quarantine"),
        "invariant_failures": REGISTRY.counter(
            "filodb_integrity_invariant_failures_total",
            "eviction/reclaim bookkeeping invariant violations"),
        "partial_queries": REGISTRY.counter(
            "filodb_integrity_partial_query_results_total",
            "queries answered with a partial-data warning"),
    }


def query_metrics() -> dict:
    """Query-path metrics: the device grid's bytes read."""
    return {
        "hbm_read_bytes": REGISTRY.counter(
            "filodb_query_hbm_read_bytes_total",
            "device-grid bytes read serving queries, by resident "
            "format (label format=dense|compressed|compressed-hist)"),
    }


def flush_metrics() -> dict:
    """Memstore-flush metrics."""
    return {
        "flush_seconds": REGISTRY.histogram(
            "filodb_flush_seconds",
            "run_flush_task latency (encode + IO + checkpoint)"),
        "chunks": REGISTRY.counter(
            "filodb_flush_chunks_total", "chunksets written by flushes"),
        "failures": REGISTRY.counter(
            "filodb_flush_failures_total",
            "flush tasks that raised (work requeued)"),
        "queue_depth": REGISTRY.gauge(
            "filodb_flush_queue_depth",
            "flush tasks submitted but not yet completed, per shard"),
        "last_age": REGISTRY.gauge(
            "filodb_flush_last_age_seconds",
            "seconds since the most recent completed flush on any group "
            "of the shard (since scheduler start when none completed)"),
    }


def odp_metrics() -> dict:
    """On-demand paging (``memstore/odp.py``)."""
    return {
        "pagein_seconds": REGISTRY.histogram(
            "filodb_odp_pagein_seconds",
            "page-in latency (store read + decode + materialize)"),
        "partitions": REGISTRY.counter(
            "filodb_odp_partitions_paged_total",
            "partitions re-materialized from the column store"),
        "chunks": REGISTRY.counter(
            "filodb_odp_chunks_paged_total",
            "chunks read back from the column store"),
    }


def index_metrics() -> dict:
    """Part-key-index cardinality and series churn
    (``memstore/cardinality.py``)."""
    return {
        "active_series": REGISTRY.gauge(
            "filodb_index_cardinality_active_series",
            "series currently alive in the part-key index, per shard"),
        "labels": REGISTRY.gauge(
            "filodb_index_cardinality_labels",
            "distinct label names carried by alive series, per shard"),
        "created": REGISTRY.counter(
            "filodb_index_churn_created_total",
            "new series assigned a part id, per shard"),
        "removed": REGISTRY.counter(
            "filodb_index_churn_removed_total",
            "series removed from the index, per shard and reason "
            "(evict | purge)"),
        "create_rate": REGISTRY.gauge(
            "filodb_index_churn_create_rate_per_s",
            "exponentially-decayed series-creation rate, per shard"),
        "remove_rate": REGISTRY.gauge(
            "filodb_index_churn_remove_rate_per_s",
            "exponentially-decayed series-removal rate, per shard"),
    }


def workload_metrics() -> dict:
    """Active-series quotas (``workload/quota.py``)."""
    return {
        "quota_active": REGISTRY.gauge(
            "filodb_quota_active_series",
            "active (alive-in-index) series per dataset/tenant"),
        "quota_limit": REGISTRY.gauge(
            "filodb_quota_limit_series",
            "configured active-series limit per dataset/tenant"),
        "quota_rejected": REGISTRY.counter(
            "filodb_quota_rejected_series_total",
            "new series rejected because their tenant is over quota"),
        "quota_dropped_samples": REGISTRY.counter(
            "filodb_quota_dropped_samples_total",
            "samples dropped for over-quota new series"),
    }


def device_metrics() -> dict:
    """Device-resource metrics (``utils/devicewatch.py``): resident bytes
    by owner and format (tracked tensors and sampled pools), their high
    watermarks, eviction attribution, and the kernel ledger's families
    (:class:`~filodb_tpu_torch.utils.devicewatch.KernelTimer`)."""
    return {
        "hbm_bytes": REGISTRY.gauge(
            "filodb_device_hbm_bytes",
            "ledger-tracked device-resident bytes by owner and resident "
            "format (tracked tensors and sampled pools)"),
        "hbm_watermark": REGISTRY.gauge(
            "filodb_device_hbm_high_watermark_bytes",
            "high watermark of ledger-tracked bytes by owner/format"),
        "evictions": REGISTRY.counter(
            "filodb_device_evictions_total",
            "device/pool resident evictions by owner and reason "
            "(budget_overflow | epoch_purge | integrity_quarantine)"),
        "kernel_launches": REGISTRY.counter(
            "filodb_kernel_launches_total",
            "timed-program launches (every launch counts; reconciles "
            "exactly with the kernel ledger's table)"),
        "kernel_seconds": REGISTRY.counter(
            "filodb_kernel_device_seconds",
            "measured device seconds of SAMPLED launches (CUDA events on "
            "the card, wall time around the plain version on the CPU)"),
        "kernel_roofline": REGISTRY.gauge(
            "filodb_kernel_roofline_fraction",
            "achieved device-memory bytes/s per program as a fraction of "
            "the configured roof"),
        "kernel_regressions": REGISTRY.counter(
            "filodb_kernel_regressions_total",
            "kernel-regression episodes: sustained EWMA device time >= "
            "factor x learned baseline"),
        "kernel_regressed": REGISTRY.gauge(
            "filodb_kernel_regressed",
            "1 while the program's EWMA device time counts as regressed "
            "against its learned baseline, else 0"),
    }


def batch_metrics() -> dict:
    """Co-arrival batching metrics (``batching/batcher.py``): realized
    group sizes and the fallback ladder, named in one place."""
    return {
        "groups": REGISTRY.counter(
            "filodb_batch_groups_total",
            "batched device launches serving >= 2 queries, per dataset"),
        "members": REGISTRY.counter(
            "filodb_batch_members_total",
            "queries served from a batched launch, per dataset "
            "(members/groups = realized mean batch size)"),
        "fallbacks": REGISTRY.counter(
            "filodb_batch_fallbacks_total",
            "dispatches demoted to the per-query chain, per dataset "
            "and reason (breaker | deadline | solo-window | "
            "member-expired | timeout | error)"),
        "peak": REGISTRY.gauge(
            "filodb_batch_realized_peak",
            "largest realized batch size since start, per dataset"),
    }


def watermark_metrics() -> dict:
    """Ingest-watermark metrics (``memstore/watermarks.py``): the
    per-shard monotone offset chain broker_end -> ingested -> flushed ->
    checkpoint, its lag in rows and seconds, and stall detection."""
    return {
        "offset": REGISTRY.gauge(
            "filodb_ingest_watermark_offset",
            "per-shard ingest watermark chain by stage "
            "(broker_end | ingested | flushed | checkpoint)"),
        "lag_rows": REGISTRY.gauge(
            "filodb_ingest_lag_rows",
            "records the broker holds that this shard has not ingested"),
        "lag_seconds": REGISTRY.gauge(
            "filodb_ingest_lag_seconds",
            "seconds since the shard's newest ingested sample, while row "
            "lag is nonzero (0 when caught up)"),
        "stalls": REGISTRY.counter(
            "filodb_ingest_stalls_total",
            "stall episodes: a lagging shard whose ingested offset made "
            "no progress for the stall window"),
        "stalled": REGISTRY.gauge(
            "filodb_ingest_stalled",
            "1 while the shard counts as stalled, else 0"),
    }


def rollup_metrics() -> dict:
    """Rollup-subsystem metrics (``rollup/``): tick health, tier
    lag/stall, emission volume, routing — one place defines the names
    so the engine and the router can never drift."""
    return {
        "passes": REGISTRY.counter(
            "filodb_rollup_passes_total",
            "rollup scheduler passes completed, per dataset"),
        "pass_seconds": REGISTRY.histogram(
            "filodb_rollup_pass_seconds",
            "wall time of one rollup pass (consume + reduce + emit)"),
        "samples": REGISTRY.counter(
            "filodb_rollup_samples_written_total",
            "rolled records emitted into the tier datasets, per "
            "dataset and resolution"),
        "lag": REGISTRY.gauge(
            "filodb_rollup_lag_seconds",
            "newest consumed raw sample time minus the tier's newest "
            "emitted period stamp, per dataset/shard/resolution"),
        "errors": REGISTRY.counter(
            "filodb_rollup_tier_errors_total",
            "tier emission passes that raised (retried next tick)"),
        "deferred": REGISTRY.counter(
            "filodb_rollup_deferred_total",
            "rollup passes deferred by admission control (the rollup "
            "class yielded to user traffic)"),
        "stalled": REGISTRY.gauge(
            "filodb_rollup_stalled",
            "1 while a tier makes no progress past the stall window "
            "with work pending, else 0 — the LEVEL the self-monitoring "
            "alert rules watch (a counter's label set is born at 1, "
            "invisible to increase())"),
        "buffered": REGISTRY.gauge(
            "filodb_rollup_buffered_samples",
            "raw samples resident in rollup closure buffers, per "
            "dataset/shard"),
        "routed": REGISTRY.counter(
            "filodb_rollup_queries_routed_total",
            "queries the resolution router served from a rolled tier, "
            "per dataset and resolution (resolution=raw counts "
            "rollup-eligible queries that stayed raw)"),
        "tier_served": REGISTRY.counter(
            "filodb_rollup_tier_legs_total",
            "stitch legs materialized per storage tier "
            "(raw | rolled-local | rolled-cold), per dataset — a "
            "stitched query counts once per tier it actually read"),
    }


def resultcache_metrics() -> dict:
    """Query-frontend result-cache metrics (query/resultcache.py):
    hit/miss traffic, resident bytes, LRU evictions, and epoch/digest
    invalidations — one place defines the names so the cache and its
    readers can never drift."""
    return {
        "hits": REGISTRY.counter(
            "filodb_resultcache_hits_total",
            "queries (or query segments) served from memoized partials, "
            "per dataset and kind (range segment | instant window)"),
        "misses": REGISTRY.counter(
            "filodb_resultcache_misses_total",
            "cacheable segments/windows that had to be computed fresh, "
            "per dataset and kind"),
        "skipped": REGISTRY.counter(
            "filodb_resultcache_skipped_total",
            "queries that bypassed the cache, per dataset and reason "
            "(shape|remote|range|open|instant-*)"),
        "bytes": REGISTRY.gauge(
            "filodb_resultcache_bytes",
            "resident bytes of memoized partials + instant window "
            "state, per dataset (reconciles exactly with a walk of the "
            "live entries)"),
        "evictions": REGISTRY.counter(
            "filodb_resultcache_evictions_total",
            "entries dropped to stay under the byte budget, per "
            "dataset and reason"),
        "invalidations": REGISTRY.counter(
            "filodb_resultcache_invalidations_total",
            "entries discarded / window states reset because their "
            "validity inputs changed, per dataset and reason "
            "(chunks|quarantine|routing|series|regressed)"),
        "bypass": REGISTRY.counter(
            "filodb_result_cache_bypass_total",
            "range/instant queries that bypassed the result cache "
            "entirely, per dataset and reason (remote = plan spans "
            "non-local shards; disabled = cache switched off; "
            "unfingerprintable = shape has no canonical fingerprint)"),
    }


def coldstore_metrics() -> dict:
    """Cold-tier metrics (coldstore/): bucket fetch traffic and its
    failure classes, age-out volume, and the per-shard watermark — one
    place defines the names so the store and the age-out pass can never
    drift."""
    return {
        "fetches": REGISTRY.counter(
            "filodb_coldstore_fetches_total",
            "objects fetched from the cold bucket (cache-miss reads; "
            "prefetched objects count once, at prefetch time)"),
        "fetch_bytes": REGISTRY.counter(
            "filodb_coldstore_fetch_bytes_total",
            "object bytes fetched from the cold bucket"),
        "fetch_corrupt": REGISTRY.counter(
            "filodb_coldstore_fetch_corrupt_total",
            "fetched objects failing their key CRC (truncated or "
            "bit-rotted in the bucket) — quarantined, never served, "
            "per dataset"),
        "fetch_timeouts": REGISTRY.counter(
            "filodb_coldstore_fetch_timeouts_total",
            "fetches refused because the deadline-derived timeout "
            "expired (stalled backend or exhausted query budget)"),
        "fetch_missing": REGISTRY.counter(
            "filodb_coldstore_fetch_missing_total",
            "fetches of objects deleted between listing and get "
            "(served as absent rows, not errors)"),
        "aged_chunks": REGISTRY.counter(
            "filodb_coldstore_aged_chunks_total",
            "chunk rows migrated local -> cold by age-out passes, "
            "per dataset"),
        "aged_bytes": REGISTRY.counter(
            "filodb_coldstore_aged_bytes_total",
            "blob bytes migrated local -> cold, per dataset"),
        "watermark": REGISTRY.gauge(
            "filodb_coldstore_ageout_watermark_ms",
            "cutoff (epoch ms) of the last completed age-out pass, per "
            "dataset/shard — chunks ending before it are archived"),
    }


class PeriodicThread:
    """Daemon loop calling ``fn`` every ``interval_s`` until stopped;
    exceptions print and the loop continues (the shared harness for
    background samplers such as the watermark sampler)."""

    def __init__(self, fn: Callable[[], object], interval_s: float,
                 name: str):
        self.fn = fn
        self.interval_s = float(interval_s)
        self.name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.fn()
                except Exception:  # noqa: BLE001 — keep looping, loudly
                    traceback.print_exc()

        self._thread = threading.Thread(target=loop, name=self.name,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# Tracing spans
# ---------------------------------------------------------------------------


def _new_id() -> str:
    """64-bit random hex span id."""
    return f"{random.getrandbits(64):016x}"


@dataclasses.dataclass
class SpanRecord:
    name: str
    start_s: float
    duration_s: float
    tags: dict
    span_id: str
    parent_id: Optional[str]
    error: Optional[str] = None


class Tracer:
    """Thread-local span stack + pluggable reporters (replaces Kamon span
    propagation via Kamon.runWithSpan).  ``capture()`` / ``attach()``
    move the current span across the thread pool that runs an ExecPlan's
    children, so child spans parent onto the plan's span."""

    def __init__(self) -> None:
        self._local = threading.local()
        self._reporters: list[Callable[[SpanRecord], None]] = []
        self._lock = threading.Lock()

    def add_reporter(self, fn: Callable[[SpanRecord], None]) -> None:
        with self._lock:
            self._reporters.append(fn)

    def remove_reporter(self, fn: Callable[[SpanRecord], None]) -> None:
        with self._lock:
            self._reporters = [r for r in self._reporters if r is not fn]

    def current_span_id(self) -> Optional[str]:
        stack = getattr(self._local, "stack", None)
        if stack:
            return stack[-1]
        return getattr(self._local, "parent_hint", None)

    def capture(self) -> Optional[str]:
        """The current span's id, a token for cross-thread propagation."""
        return self.current_span_id()

    @contextlib.contextmanager
    def attach(self, token: Optional[str]):
        """Install a captured span on this thread: spans opened inside
        parent onto it, on a fresh span stack."""
        old_hint = getattr(self._local, "parent_hint", None)
        old_stack = getattr(self._local, "stack", None)
        self._local.parent_hint = token
        self._local.stack = []
        try:
            yield
        finally:
            self._local.parent_hint = old_hint
            self._local.stack = old_stack

    def span(self, name: str, **tags):
        return _Span(self, name, tags)

    def _report(self, rec: SpanRecord) -> None:
        with self._lock:
            reporters = list(self._reporters)
        for fn in reporters:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — reporters must not break work
                traceback.print_exc()


class _Span:
    """One span.  With no reporter installed when it opens it does
    nothing: no id, no clock, no record."""

    def __init__(self, tracer: Tracer, name: str, tags: dict):
        self.tracer = tracer
        self.name = name
        self.tags = tags
        self.live = False

    def __enter__(self):
        self.live = bool(self.tracer._reporters)
        if not self.live:
            return self
        self.span_id = _new_id()
        self.parent_id = self.tracer.current_span_id()
        local = self.tracer._local
        if getattr(local, "stack", None) is None:
            local.stack = []
        local.stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self.live:
            return False
        dur = time.perf_counter() - self._t0
        try:  # spans must NEVER raise into the instrumented path
            self.tracer._local.stack.pop()
        except (AttributeError, IndexError):
            pass
        self.tracer._report(SpanRecord(
            self.name, time.time() - dur, dur, dict(self.tags),
            self.span_id, self.parent_id,
            error=repr(exc) if exc is not None else None))
        return False


TRACER = Tracer()
