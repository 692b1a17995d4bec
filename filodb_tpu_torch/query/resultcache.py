"""Query-frontend result cache: chunk-aligned partial memoization.

Thousands of browsers refresh the SAME dashboard panels every few
seconds, and every refresh re-runs the full scan -> window -> aggregate
pipeline from scratch.  Chunks are immutable once encoded, so partials
computed over them never change; this module memoizes them in the
serving path (capability match for the reference's query frontend's
results cache).

Two memoization shapes, both behind :class:`ResultCachingPlanner`:

**Range queries** split on chunk-aligned segment boundaries
(``segment_ms``, the dataset's flush interval).  A segment whose input
interval is fully covered by encoded (immutable) chunks is evaluated
once through the normal planner and its final batches memoized, keyed
by ``(plan fingerprint, segment)`` where the fingerprint is the
canonical PromQL rendering + step/phase/lookback.  A hit is honored
only when the segment's chunk-id digest, the integrity quarantine
epoch, and the routing token all still match — so a cache hit can never
serve data a cache miss would refuse.  On a refresh, only the open head
sliver (and any invalidated segment) is recomputed, and the stitch
merge is the same ``StitchRvsMapper`` the rollup-boundary path uses.
The rollup tier boundary needs no token here by construction: the cache
wraps each tier's planner BELOW the resolution router, so when the
boundary moves a step from raw to rolled, the ROUTER changes which
cache is asked — stale raw segments simply stop being requested.

**Instant queries** of the incremental shapes (``fn(sel[w])`` and
``agg by (..)(fn(sel[w]))``) keep a resident
:mod:`~filodb_tpu_torch.query.windowstate` window per fingerprint: each
refresh fetches only ``(fetched_through, now]`` through the normal
planner path and merges with the resident window via the normal
aggregator map / ``AggPartialBatch`` reduce — the open head chunk's
sliver is all that is re-scanned.  A part-id signature over the window
interval resets the state whenever a series appears or vanishes (a new
series materializing with OLD timestamps is exactly the case warm
state cannot see), and the quarantine epoch / routing token reset it
like any other entry.

The memoized batches are the ones the engine returned: their values
stay on the ExecContext's device, and a hit replays them there; only
the API edge reads values back.  Byte accounting is HbmLedger-style:
every entry's bytes (device bytes included) are tracked on
insert/resize/evict and ``reconcile()`` proves the total equals a walk
of the live entries.  Bounded LRU; metrics ``filodb_resultcache_*``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from filodb_tpu_torch.coordinator.planner import QueryPlanner
from filodb_tpu_torch.coordinator.planners import (copy_with_time_range,
                                                   logical_plan_to_promql,
                                                   plan_lookback_ms)
from filodb_tpu_torch.ops.windows import StepRange, value_dtype
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.exec import ExecContext, ExecPlan, LeafExecPlan
from filodb_tpu_torch.query.model import (PeriodicBatch, QueryContext,
                                          ctx_device)
from filodb_tpu_torch.query.windowstate import (AggWindowState, WindowState,
                                                WindowUnsupported,
                                                agg_window_spec, window_spec)

_METRICS = None


def _m() -> dict:
    global _METRICS
    if _METRICS is None:
        from filodb_tpu_torch.utils.observability import resultcache_metrics
        _METRICS = resultcache_metrics()
    return _METRICS


# aggregation operators whose segment-split evaluation is bit-equal to
# the unsplit evaluation: their map partials are zero-insensitive
# moments, so a series absent from one segment (vs present with NaN
# steps) contributes an exact 0.0 either way.  Rank-based reduces
# (topk/quantile/count_values) are excluded.
_CACHE_AGG_OPS = frozenset({"SUM", "COUNT", "MIN", "MAX", "AVG", "GROUP",
                            "STDDEV", "STDVAR"})

# hard ceiling on segments per query: a multi-year range at a 1h
# segment would otherwise balloon the plan walk
_MAX_SEGMENTS = 512


def _cacheable(plan) -> bool:
    """Allowlist walk: only shapes whose split evaluation provably
    matches unsplit evaluation (see _CACHE_AGG_OPS) and whose canonical
    PromQL rendering captures every semantic knob."""
    if isinstance(plan, lp.PeriodicSeries):
        rs = plan.raw_series
        return not plan.offset_ms and not rs.columns and not rs.offset_ms
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        rs = plan.series
        return (not plan.offset_ms and isinstance(rs, lp.RawSeries)
                and not rs.columns and not rs.offset_ms)
    if isinstance(plan, lp.Aggregate):
        return (getattr(plan.operator, "name", "") in _CACHE_AGG_OPS
                and not plan.params and _cacheable(plan.vectors))
    if isinstance(plan, lp.ApplyInstantFunction):
        return (all(not isinstance(a, lp.LogicalPlan)
                    for a in plan.function_args)
                and _cacheable(plan.vectors))
    if isinstance(plan, lp.ScalarVectorBinaryOperation):
        return (isinstance(plan.scalar_arg,
                           (int, float, lp.ScalarFixedDoublePlan,
                            lp.ScalarTimeBasedPlan))
                and _cacheable(plan.vector))
    return False


def plan_fingerprint(plan, step_ms: int, start_ms: int) -> Optional[str]:
    """Cache key half 1: the canonical PromQL rendering (time range is
    not part of the rendering) + step + step-grid phase + lookback.
    ``None`` = not a cacheable shape."""
    if not _cacheable(plan):
        return None
    if len(lp.leaf_raw_series(plan)) != 1:
        return None
    try:
        rendered = logical_plan_to_promql(plan)
    except ValueError:
        return None
    phase = (start_ms % step_ms) if step_ms > 0 else 0
    return (f"{rendered}|step={step_ms}|phase={phase}"
            f"|look={plan_lookback_ms(plan)}")


def _quarantine_epoch() -> int:
    from filodb_tpu_torch.integrity import QUARANTINE
    return QUARANTINE.epoch()


def _input_pad_ms(plan) -> int:
    """How far BELOW a step the plan's leaf scans can reach: lookback
    PLUS window (``copy_with_time_range`` widens the selector by their
    sum).  Deliberately >= plan_lookback_ms (which takes the max) — an
    over-wide immutability probe only costs extra invalidations, never
    staleness."""
    look = max((rs.lookback_ms or 0 for rs in lp.leaf_raw_series(plan)),
               default=0)
    window = 0

    def walk(p):
        nonlocal window
        if dataclasses.is_dataclass(p):
            window = max(window, getattr(p, "window_ms", 0) or 0)
            for f in dataclasses.fields(p):
                v = getattr(p, f.name)
                if isinstance(v, lp.LogicalPlan):
                    walk(v)
    walk(plan)
    return look + window


def _segment_states(memstore, dataset: str, filters, segs,
                    look: int) -> dict:
    """Per-segment ``(chunk-id digest, closed)`` across the dataset's
    local shards, in ONE pass per partition (a per-segment walk would
    multiply the lock traffic by the segment count).

    ``closed`` = no partition has mutable (write-buffer /
    pending-encode) rows at or below the segment's input end, i.e. a
    result computed over it can never change without the digest
    changing too: encoded chunks are immutable, per-partition ingest is
    monotone, and a new series materializing with old timestamps
    appears as a new part id with chunks/buffers that change the
    digest or the closed bit."""
    lo = min(s.lo for s in segs) - look
    hi = max(s.hi for s in segs)
    hashers = {s.k: hashlib.blake2b(digest_size=16) for s in segs}
    closed = {s.k: True for s in segs}
    for sh in memstore.shards(dataset):
        lookup = sh.lookup_partitions(list(filters), lo, hi)
        # the shard's epoch-cached span table (rebuilt only on chunk
        # freeze/removal) restricted to the matched partitions; each
        # segment then digests with one vectorized overlap mask
        pid_a, cid_a, cs_a, ce_a = sh.chunk_span_table()
        if len(pid_a) and len(lookup.part_ids):
            sel = np.isin(pid_a, np.asarray(lookup.part_ids, np.int64))
            pid_a, cid_a = pid_a[sel], cid_a[sel]
            cs_a, ce_a = cs_a[sel], ce_a[sel]
        elif len(pid_a):
            pid_a = pid_a[:0]
        # the shard-wide mutable floor (cached per ingest epoch):
        # filter-independent and so conservative — an unmatched
        # partition's buffer marking a segment open costs a cache
        # miss, never staleness
        mut_min = sh.mutable_floor()
        for s in segs:
            a, b = s.lo - look, s.hi
            h = hashers[s.k]
            h.update(struct.pack("<i", sh.shard_num))
            if len(pid_a):
                m = (ce_a >= a) & (cs_a <= b)
                if m.any():
                    h.update(pid_a[m].tobytes())
                    h.update(cid_a[m].tobytes())
            if mut_min is not None and mut_min <= b:
                closed[s.k] = False
            for pk in lookup.missing_partkeys:
                # paged/evicted series: persisted = immutable;
                # membership changes invalidate every segment
                h.update(pk)
    return {s.k: (hashers[s.k].hexdigest(), closed[s.k]) for s in segs}


def _pid_signature(memstore, dataset: str, filters,
                   t0: int, t1: int) -> bytes:
    """Cheap series-set signature over ``[t0, t1]`` — the instant
    window states reset when it changes (series born or evicted)."""
    h = hashlib.blake2b(digest_size=16)
    for sh in memstore.shards(dataset):
        lookup = sh.lookup_partitions(list(filters), t0, t1)
        h.update(struct.pack("<iq", sh.shard_num, len(lookup.part_ids)))
        h.update(np.asarray(lookup.part_ids, np.int64).tobytes())
        for pk in lookup.missing_partkeys:
            h.update(pk)
    return h.digest()


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SegmentEntry:
    """One memoized closed segment: the final (post-transformer)
    batches of the sub-plan, read-only, their values on the device the
    engine computed them on."""

    batches: list
    nbytes: int
    digest: str
    quarantine_epoch: int
    routing_token: int
    result_samples: int


@dataclasses.dataclass
class HeadEntry:
    """The memoized STABLE PREFIX of a range query's open head segment:
    steps whose inputs all end below the dataset's mutable floor never
    change without the prefix digest changing too, so a warm
    dashboard's refresh replays them and recomputes only the true
    sliver ``(stable_hi, head.hi]`` — the mutable tail — instead of the
    whole head segment."""

    batches: list
    nbytes: int
    digest: str          # over the prefix input range [lo - look, stable_hi]
    stable_hi: int       # last step covered by the memoized prefix
    lo: int              # first step of the head segment's grid
    step: int
    quarantine_epoch: int
    routing_token: int
    result_samples: int


class InstantEntry:
    """One fingerprint's resident instant window state."""

    __slots__ = ("state", "lock", "pid_sig", "quarantine_epoch",
                 "routing_token", "dead", "nbytes")

    def __init__(self, state):
        self.state = state
        self.lock = threading.Lock()
        self.pid_sig: Optional[bytes] = None
        self.quarantine_epoch = -1
        self.routing_token = 0
        self.dead = False          # WindowUnsupported: permanent bypass
        self.nbytes = 512


def _nbytes(x) -> int:
    """Bytes an array or a tensor holds, on whichever device it lives."""
    return 0 if x is None else int(getattr(x, "nbytes", 0))


def _entry_bytes(batches) -> tuple[int, int]:
    """(nbytes, result samples) for a list of stored batches; a batch's
    values count whether they are host or device bytes."""
    nbytes, samples = 256, 0
    for b in batches:
        nbytes += _nbytes(b.values) + 64 * len(b.keys)
        nbytes += _nbytes(b.hist)
        samples += len(b.keys) * b.steps.num_steps
    return nbytes, samples


class ResultCache:
    """Bounded byte-LRU over segment entries + instant window states,
    with exact byte reconciliation (the HbmLedger discipline: totals
    always equal a walk of the live entries)."""

    def __init__(self, dataset: str, max_bytes: int = 64 * 1024 * 1024,
                 enabled: bool = False, doorkeeper: bool = True):
        self.dataset = dataset
        self.enabled = bool(enabled)
        self.max_bytes = int(max_bytes)
        # doorkeeper admission (the TinyLFU idea): only a fingerprint
        # seen BEFORE gets the split/probe/store treatment, so a stream
        # of never-repeating queries pays one set probe instead of
        # digesting and storing segments nothing will ever hit
        self.doorkeeper = bool(doorkeeper)
        self._seen: OrderedDict = OrderedDict()     # guarded-by: _lock
        self._entries: OrderedDict = OrderedDict()  # guarded-by: _lock
        self._bytes = 0                             # guarded-by: _lock
        self._lock = threading.Lock()
        # local counters mirrored into the metric families (admin view)
        self.hits = 0
        self.misses = 0
        self.skips = 0
        self.evictions = 0
        self.invalidations = 0

    # ------------------------------------------------------------- config

    def configure(self, enabled: Optional[bool] = None,
                  max_bytes: Optional[int] = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if max_bytes is not None:
            self.max_bytes = int(max_bytes)
            with self._lock:
                evicted = self._evict_to_budget_locked()
            self._note_evictions(evicted)

    # ------------------------------------------------------------ entries

    def admit(self, fp: str) -> bool:
        """Doorkeeper probe: True when this fingerprint has been seen
        before (worth caching).  A first sighting registers it and
        returns False — the caller serves the uncached path untouched.
        Survives :meth:`clear` on purpose: the operator flushes
        ENTRIES, not the evidence of which panels repeat."""
        if not self.doorkeeper:
            return True
        with self._lock:
            if fp in self._seen:
                self._seen.move_to_end(fp)
                return True
            self._seen[fp] = None
            while len(self._seen) > 4096:
                self._seen.popitem(last=False)
            return False

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def put(self, key, entry) -> None:
        if entry.nbytes > self.max_bytes // 4:
            return               # one giant panel must not flush the rest
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += entry.nbytes
            evicted = self._evict_to_budget_locked()
            total = self._bytes
        self._note_evictions(evicted)
        _m()["bytes"].set(total, dataset=self.dataset)

    def resize(self, key, nbytes: int) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            self._bytes += int(nbytes) - entry.nbytes
            entry.nbytes = int(nbytes)
            evicted = self._evict_to_budget_locked()
            total = self._bytes
        self._note_evictions(evicted)
        _m()["bytes"].set(total, dataset=self.dataset)

    def _evict_to_budget_locked(self) -> int:
        n = 0
        while self._bytes > self.max_bytes and self._entries:
            _k, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes
            n += 1
        return n

    def _note_evictions(self, n: int) -> None:
        if n:
            self.evictions += n
            _m()["evictions"].inc(n, dataset=self.dataset, reason="budget")

    def discard(self, key, reason: str) -> None:
        """Invalidate one entry (stale digest / epoch / routing)."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            total = self._bytes
        if old is not None:
            self.invalidations += 1
            _m()["invalidations"].inc(dataset=self.dataset, reason=reason)
            _m()["bytes"].set(total, dataset=self.dataset)

    def note_invalidation(self, reason: str) -> None:
        """An in-place state reset (instant windows go cold rather than
        being dropped) still counts as an invalidation."""
        self.invalidations += 1
        _m()["invalidations"].inc(dataset=self.dataset, reason=reason)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
        _m()["bytes"].set(0, dataset=self.dataset)

    # ----------------------------------------------------------- counters

    def note_hit(self, kind: str) -> None:
        self.hits += 1
        _m()["hits"].inc(dataset=self.dataset, kind=kind)

    def note_miss(self, kind: str) -> None:
        self.misses += 1
        _m()["misses"].inc(dataset=self.dataset, kind=kind)

    def note_skip(self, reason: str) -> None:
        self.skips += 1
        _m()["skipped"].inc(dataset=self.dataset, reason=reason)

    # -------------------------------------------------------------- views

    def reconcile(self) -> tuple[int, int]:
        """(accounted total, walked total) — equal by construction."""
        with self._lock:
            return self._bytes, sum(e.nbytes
                                    for e in self._entries.values())

    def snapshot(self) -> dict:
        with self._lock:
            entries = len(self._entries)
            nbytes = self._bytes
            segments = [
                {"fingerprint": k[0][:160], "segment": k[1],
                 "samples": e.result_samples}
                for k, e in self._entries.items()
                if isinstance(e, SegmentEntry)]
            heads = [
                {"fingerprint": k[0][:160], "segment": k[1],
                 "stable_hi": e.stable_hi,
                 "samples": e.result_samples}
                for k, e in self._entries.items()
                if isinstance(e, HeadEntry)]
            instants = [
                {"fingerprint": k[0][:160],
                 "series": e.state.resident_series,
                 "samples": e.state.resident_samples,
                 "fetched_through_ms": e.state.fetched_through_ms,
                 "dead": e.dead}
                for k, e in self._entries.items()
                if isinstance(e, InstantEntry)]
        return {"enabled": self.enabled, "max_bytes": self.max_bytes,
                "bytes": nbytes, "entries": entries,
                "hits": self.hits, "misses": self.misses,
                "skips": self.skips, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "segments": segments,
                "head_windows": heads,
                "instant_windows": instants}


# ---------------------------------------------------------------------------
# planner integration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Seg:
    """One segment of a range query's step grid."""

    k: int           # absolute segment index (t // segment_ms)
    lo: int          # first step in this segment
    hi: int          # last step in this segment
    full: bool = False   # covers the segment's complete step set
    key: tuple = ()
    digest: str = ""
    storable: bool = False


class ResultCachingPlanner(QueryPlanner):
    """Wraps one dataset's planner with the result cache.  Sits BELOW
    the rollup resolution router (each tier's planner gets its own
    wrapper), so tier selection and boundary stitching stay upstream
    and the cache only ever sees ranges the router already assigned."""

    def __init__(self, dataset: str, inner: QueryPlanner, memstore,
                 cache: ResultCache, segment_ms: int = 3_600_000,
                 routing_token_fn=None, instant: bool = True):
        self.dataset = dataset
        self.inner = inner
        self.memstore = memstore
        self.cache = cache
        self.segment_ms = max(int(segment_ms), 1000)
        self.routing_token_fn = routing_token_fn
        self.instant = instant

    # ------------------------------------------------------------- helpers

    def _routing_token(self) -> int:
        """Routing validity key (``ShardMapper.routing_token``): a shard
        status transition invalidates every entry computed under the
        old routing view."""
        if self.routing_token_fn is None:
            return 0
        return int(self.routing_token_fn())

    def _plan_local(self, plan, qctx) -> bool:
        fn = getattr(self.inner, "plan_is_local", None)
        return True if fn is None else fn(plan, qctx)

    # --------------------------------------------------------- materialize

    def materialize(self, plan: lp.LogicalPlan,
                    qctx: Optional[QueryContext] = None) -> ExecPlan:
        qctx = qctx or QueryContext()
        cache = self.cache
        if not cache.enabled or not isinstance(plan, lp.PeriodicSeriesPlan):
            # only cache-SHAPED plans count as "disabled" bypasses —
            # metadata/raw plans never were cache traffic and would
            # drown the signal
            if not cache.enabled \
                    and isinstance(plan, lp.PeriodicSeriesPlan):
                _m()["bypass"].inc(dataset=self.dataset,
                                   reason="disabled")
            return self.inner.materialize(plan, qctx)
        try:
            start, step, end = lp.time_range(plan)
        except ValueError:
            return self.inner.materialize(plan, qctx)
        fp = plan_fingerprint(plan, step, start)
        if fp is None:
            cache.note_skip("shape")
            _m()["bypass"].inc(dataset=self.dataset,
                               reason="unfingerprintable")
            return self.inner.materialize(plan, qctx)
        if not self._plan_local(plan, qctx):
            # remote-shard plans bypass the cache (the known federation
            # coherence gap), counted
            cache.note_skip("remote")
            _m()["bypass"].inc(dataset=self.dataset, reason="remote")
            return self.inner.materialize(plan, qctx)
        if not cache.admit(fp):
            cache.note_skip("first-sight")
            return self.inner.materialize(plan, qctx)
        if start == end:
            return self._materialize_instant(plan, qctx, fp, start)
        return self._materialize_range(plan, qctx, fp, start, step, end)

    # -------------------------------------------------------------- range

    def _materialize_range(self, plan, qctx, fp, start, step, end):
        cache = self.cache
        seg_ms = self.segment_ms
        first_k, last_k = start // seg_ms, end // seg_ms
        if last_k - first_k < 1 or last_k - first_k + 1 > _MAX_SEGMENTS:
            cache.note_skip("range")
            return self.inner.materialize(plan, qctx)
        look = _input_pad_ms(plan)
        filters = tuple(lp.leaf_raw_series(plan)[0].filters)
        qepoch = _quarantine_epoch()
        rtok = self._routing_token()
        segs: list[_Seg] = []
        phase = start % step
        for k in range(first_k, last_k + 1):
            lo = start + -(-(max(k * seg_ms, start) - start) // step) * step
            hi = start + ((min((k + 1) * seg_ms - 1, end) - start)
                          // step) * step
            if lo > hi:
                continue         # the step grid skips this segment
            # FULL segments carry the segment's complete absolute-grid
            # step set — only those are cache-eligible.  A partial
            # first/last segment's step subset depends on THIS query's
            # start/end, so a memoized copy would replay steps outside
            # (or short of) the next refresh's range.
            full_lo = k * seg_ms + (phase - k * seg_ms) % step
            full_hi = full_lo + ((k + 1) * seg_ms - 1 - full_lo) \
                // step * step
            segs.append(_Seg(k, lo, hi,
                             full=(lo == full_lo and hi == full_hi)))
        if not segs:
            return self.inner.materialize(plan, qctx)
        # head-segment prefix: the open head segment's steps below the
        # mutable floor are stable — probe/extend a memoized prefix so
        # a warm refresh recomputes only the true sliver.  Both the
        # probe of the resident entry and the digest for the new prefix
        # ride the SAME _segment_states pass as synthetic rows (one
        # partition walk).
        head = segs[-1]
        head_key = (fp, head.k, seg_ms, "head")
        head_entry = self.cache.get(head_key)
        if not isinstance(head_entry, HeadEntry):
            head_entry = None
        mut_min = None
        for sh in self.memstore.shards(self.dataset):
            f = sh.mutable_floor()
            if f is not None:
                mut_min = f if mut_min is None else min(mut_min, f)
        if mut_min is None:
            stable_hi_now: Optional[int] = head.hi
        elif mut_min > head.lo:
            stable_hi_now = head.lo + ((min(head.hi, mut_min - 1)
                                        - head.lo) // step) * step
        else:
            stable_hi_now = None
        probe: list[_Seg] = []
        _PROBE_K, _STORE_K = ("head", "probe"), ("head", "store")
        if head_entry is not None and head.lo <= head_entry.stable_hi \
                <= head.hi:
            probe.append(_Seg(_PROBE_K, head.lo, head_entry.stable_hi))
        if stable_hi_now is not None:
            probe.append(_Seg(_STORE_K, head.lo, stable_hi_now))
        states = _segment_states(self.memstore, self.dataset, filters,
                                 segs + probe, look)
        hits: dict[int, SegmentEntry] = {}
        for seg in segs:
            seg.key = (fp, seg.k, seg_ms)
            digest, closed = states[seg.k]
            seg.digest, seg.storable = digest, closed and seg.full
            if not seg.storable:
                continue
            entry = cache.get(seg.key)
            if entry is None or isinstance(entry, InstantEntry):
                continue
            if entry.digest != digest:
                cache.discard(seg.key, "chunks")
            elif entry.quarantine_epoch != qepoch:
                cache.discard(seg.key, "quarantine")
            elif entry.routing_token != rtok:
                cache.discard(seg.key, "routing")
            else:
                hits[seg.k] = entry
        head_hit: Optional[HeadEntry] = None
        head_store: Optional[tuple] = None
        if not head.storable:
            if head_entry is not None and states.get(_PROBE_K):
                digest, closed = states[_PROBE_K]
                if head_entry.lo != head.lo or head_entry.step != step \
                        or not head.lo <= head_entry.stable_hi <= head.hi:
                    pass             # different grid: plain miss
                elif head_entry.digest != digest or not closed:
                    cache.discard(head_key, "chunks")
                elif head_entry.quarantine_epoch != qepoch:
                    cache.discard(head_key, "quarantine")
                elif head_entry.routing_token != rtok:
                    cache.discard(head_key, "routing")
                else:
                    head_hit = head_entry
            if head_hit is None and stable_hi_now is not None:
                digest, closed = states[_STORE_K]
                if closed:           # the floor did not move mid-pass
                    head_store = (head_key, head, stable_hi_now, digest,
                                  step)
        if not hits and head_hit is None and head_store is None \
                and not any(s.storable for s in segs):
            # nothing cached and nothing cacheable (all-open range):
            # serve the unsplit plan — zero overhead on the miss path
            cache.note_skip("open")
            return self.inner.materialize(plan, qctx)
        # group consecutive non-hit segments into runs: one sub-plan per
        # run (a cold first refresh is exactly ONE child == the unsplit
        # plan), sliced per segment for storage afterwards
        items: list[tuple] = []
        run: list[_Seg] = []

        def flush_run():
            if not run:
                return
            sub = copy_with_time_range(plan, run[0].lo, run[-1].hi)
            items.append(("run", self.inner.materialize(sub, qctx),
                          list(run)))
            run.clear()

        for seg in segs:
            if seg.k in hits:
                flush_run()
                items.append(("hit", hits[seg.k], seg))
            elif seg is head and head_hit is not None:
                # replay the stable prefix; recompute only the sliver
                flush_run()
                items.append(("head", head_hit, seg))
                sliver_lo = head_hit.stable_hi + step
                if sliver_lo <= seg.hi:
                    sub = copy_with_time_range(plan, sliver_lo, seg.hi)
                    items.append(("run", self.inner.materialize(sub,
                                                                qctx),
                                  []))
            else:
                run.append(seg)
        flush_run()
        return CachedRangeExec(self, items, qepoch, rtok, qctx,
                               head_store=head_store)

    # ------------------------------------------------------------ instant

    def _materialize_instant(self, plan, qctx, fp, eval_ms):
        cache = self.cache
        if not self.instant:
            cache.note_skip("instant-off")
            return self.inner.materialize(plan, qctx)
        spec = window_spec(plan)
        aspec = None if spec is not None else agg_window_spec(plan)
        if spec is None and aspec is None:
            cache.note_skip("instant-shape")
            return self.inner.materialize(plan, qctx)
        key = (fp, "instant")
        entry = cache.get(key)
        if entry is not None and not isinstance(entry, InstantEntry):
            entry = None
        if entry is not None and entry.dead:
            cache.note_skip("instant-unsupported")
            return self.inner.materialize(plan, qctx)
        if entry is None:
            state = WindowState(spec) if spec is not None \
                else AggWindowState(aspec)
            entry = InstantEntry(state)
            cache.put(key, entry)
        return InstantWindowExec(self, plan, qctx, key, entry, eval_ms)


# ---------------------------------------------------------------------------
# exec plans
# ---------------------------------------------------------------------------


def _sub_ctx(ctx: ExecContext) -> ExecContext:
    """A fresh context on the same store and knobs: a fresh run's or a
    delta fetch's volumes are counted exactly, then absorbed."""
    return ExecContext(ctx.memstore, ctx.query_context, ctx.parallelism)


def _slice_steps(b: PeriodicBatch, lo: int, hi: int) -> PeriodicBatch:
    """Steps ``[lo, hi]`` of a batch as a batch of their own: the values
    stay on the batch's device, copied out of the run's result."""
    st = b.steps
    i0 = (lo - st.start) // st.step
    i1 = (hi - st.start) // st.step + 1
    vals = b.values_t()[:, i0:i1].clone()
    return PeriodicBatch(list(b.keys), StepRange(lo, hi, st.step), vals)


class CachedRangeExec(ExecPlan):
    """Root of a cached range query: replays hit segments, executes
    miss runs through the normal path, stores the newly-closed
    segments, and stitches — the same merge the rollup boundary uses."""

    def __init__(self, planner: ResultCachingPlanner, items: list,
                 quarantine_epoch: int, routing_token: int,
                 query_context: Optional[QueryContext] = None,
                 head_store: Optional[tuple] = None):
        super().__init__(query_context)
        self._planner = planner
        self._items = items
        self._qepoch = quarantine_epoch
        self._rtok = routing_token
        # (key, head _Seg, stable_hi, digest, step) when the head
        # segment's stable prefix should be memoized off this execution
        self._head_store = head_store

    @property
    def children(self):
        return [it[1] for it in self._items if it[0] == "run"]

    def do_execute(self, ctx: ExecContext) -> list:
        from filodb_tpu_torch.query.transformers import StitchRvsMapper
        cache = self._planner.cache
        if len(self._items) == 1 and self._items[0][0] == "run":
            # all-miss (cold) query: one child covers the whole range —
            # execute it exactly like the uncached path (no stitch) and
            # only slice the closed segments into the cache afterwards
            _kind, child, seg_metas = self._items[0]
            sub_ctx = _sub_ctx(ctx)
            res = child.execute(sub_ctx)
            ctx.absorb_stats_from(sub_ctx)
            for seg in seg_metas:
                if seg.storable:
                    cache.note_miss("range")
            self._store(res, seg_metas)
            ctx.note_resultcache(recomputed=res.stats.samples_scanned)
            return res.batches
        batches: list = []
        cached_samples = recomputed = 0
        for item in self._items:
            if item[0] in ("hit", "head"):
                _kind, entry, _seg = item
                batches.extend(entry.batches)
                cached_samples += entry.result_samples
                cache.note_hit("range" if item[0] == "hit" else "head")
                continue
            _kind, child, seg_metas = item
            res = child.execute(_sub_ctx(ctx))
            ctx.absorb_stats(res.stats)
            recomputed += res.stats.samples_scanned
            for seg in seg_metas:
                if seg.storable:
                    cache.note_miss("range")
            self._store(res, seg_metas)
            batches.extend(res.batches)
        ctx.note_resultcache(cached=cached_samples, recomputed=recomputed)
        return StitchRvsMapper().apply(batches, ctx)

    def _store(self, res, seg_metas) -> None:
        """Memoize each closed segment of a fresh run by slicing the
        run's step axis.  Partial or corrupt-overlapping results are
        never stored — a hit must be indistinguishable from a miss."""
        if res.stats.corrupt_chunks_excluded:
            return
        cache = self._planner.cache
        for b in res.batches:
            if not isinstance(b, PeriodicBatch):
                return           # unexpected shape: don't memoize any of it
            if b.hist is not None:
                # histogram planes don't survive the warm-path stitch
                # (StitchRvsMapper rebuilds value-only batches), so a
                # hit would drop buckets a miss serves — never store
                cache.note_skip("hist")
                return
        for seg in seg_metas:
            if not seg.storable:
                continue
            stored: list = []
            ok = True
            for b in res.batches:
                st = b.steps
                if (seg.lo - st.start) % st.step or seg.lo < st.start \
                        or seg.hi > st.end:
                    ok = False
                    break
                stored.append(_slice_steps(b, seg.lo, seg.hi))
            if not ok:
                continue
            nbytes, samples = _entry_bytes(stored)
            cache.put(seg.key, SegmentEntry(
                stored, nbytes, seg.digest, self._qepoch, self._rtok,
                samples))
        if self._head_store is not None \
                and any(s is self._head_store[1] for s in seg_metas):
            self._store_head(res)

    def _store_head(self, res) -> None:
        """Memoize the head segment's stable prefix off a fresh run
        (same slicing discipline as the closed segments — the guards in
        :meth:`_store` already vetoed partial/hist results)."""
        key, seg, stable_hi, digest, step = self._head_store
        cache = self._planner.cache
        stored: list = []
        for b in res.batches:
            st = b.steps
            if st.step != step or (seg.lo - st.start) % st.step \
                    or seg.lo < st.start or stable_hi > st.end:
                return
            stored.append(_slice_steps(b, seg.lo, stable_hi))
        # an empty ``stored`` (no series matched) is still worth
        # memoizing: the refresh skips the stable steps, and the digest
        # guards late series births
        nbytes, samples = _entry_bytes(stored)
        cache.put(key, HeadEntry(stored, nbytes, digest, stable_hi,
                                 seg.lo, step, self._qepoch, self._rtok,
                                 samples))
        cache.note_miss("head")


class InstantWindowExec(LeafExecPlan):
    """A repeatedly-refreshed instant panel served from a resident
    window: the delta fetch runs through the normal planner path (so
    quarantine exclusion and stats apply) and only the head sliver is
    re-scanned; the window function runs on the query's device.

    Its one step carries the plan's own step length: a one-step RANGE
    plan (the rollup router cuts a stitch leg to one step) lands here
    too, and its batch must stitch with the other legs.  The JAX
    package answers on a 1 s step whatever the plan's, which its router's
    stitch then refuses ("cannot stitch mismatched steps")."""

    def __init__(self, planner: ResultCachingPlanner, plan, qctx,
                 key, entry: InstantEntry, eval_ms: int):
        super().__init__(qctx)
        self._planner = planner
        self._plan = plan
        self._key = key
        self._entry = entry
        self.eval_ms = int(eval_ms)
        self.step_ms = int(lp.time_range(plan)[1])

    def _fallback(self, ctx) -> list:
        child = self._planner.inner.materialize(self._plan,
                                                self.query_context)
        res = child.execute(_sub_ctx(ctx))
        ctx.absorb_stats(res.stats)
        return res.batches

    def _fetch_sharded(self, sub_ctx, filters, start_ms, end_ms) -> list:
        from filodb_tpu_torch.query.windowstate import batches_to_buckets
        plan = lp.RawSeries(lp.IntervalSelector(int(start_ms), int(end_ms)),
                            tuple(filters))
        ep = self._planner.inner.materialize(plan, self.query_context)
        res = ep.execute(sub_ctx)
        return batches_to_buckets(res.batches)

    def do_execute(self, ctx: ExecContext) -> list:
        planner, cache, entry = self._planner, self._planner.cache, \
            self._entry
        state = entry.state
        spec = state.spec.window if isinstance(state, AggWindowState) \
            else state.spec
        eval_ms = self.eval_ms
        device = ctx_device(ctx)
        with entry.lock:
            sig = _pid_signature(ctx.memstore, planner.dataset,
                                 spec.filters, eval_ms - spec.window_ms,
                                 eval_ms)
            qepoch = _quarantine_epoch()
            rtok = planner._routing_token()
            warm = state.fetched_through_ms is not None
            if warm:
                reason = None
                if entry.pid_sig != sig:
                    reason = "series"
                elif entry.quarantine_epoch != qepoch:
                    reason = "quarantine"
                elif entry.routing_token != rtok:
                    reason = "routing"
                elif eval_ms < state.fetched_through_ms:
                    reason = "regressed"
                if reason is not None:
                    state.reset()
                    cache.note_invalidation(reason)
                    warm = False
            entry.pid_sig = sig
            entry.quarantine_epoch = qepoch
            entry.routing_token = rtok
            sub_ctx = _sub_ctx(ctx)

            def fetch(f, s, e):
                return self._fetch_sharded(sub_ctx, f, s, e)
            try:
                if isinstance(state, AggWindowState):
                    limit = ctx.query_context.group_by_cardinality_limit
                    batch = state.tick(eval_ms, fetch, group_limit=limit,
                                       device=device, step_ms=self.step_ms)
                else:
                    def flat(f, s, e):
                        return [r for b in fetch(f, s, e) for r in b]
                    pairs = state.tick(eval_ms, flat, device=device)
                    batch = self._pairs_batch(pairs, eval_ms, self.step_ms,
                                              device)
            except WindowUnsupported:
                entry.dead = True
                cache.note_skip("instant-unsupported")
                ctx.absorb_stats_from(sub_ctx)
                return self._fallback(ctx)
            ctx.absorb_stats_from(sub_ctx)
            fetched = sub_ctx.counter("samples")
            resident = state.resident_samples
            if warm:
                cache.note_hit("instant")
            else:
                cache.note_miss("instant")
            ctx.note_resultcache(cached=max(0, resident - fetched),
                                 recomputed=fetched)
            # resize() computes its delta from entry.nbytes and updates
            # it — pre-mutating the entry here would zero the delta and
            # leave the byte ledger stuck at the insert-time size
            cache.resize(self._key, 512 + 24 * resident)
        return [] if batch is None else [batch]

    @staticmethod
    def _pairs_batch(pairs, eval_ms, step_ms,
                     device) -> Optional[PeriodicBatch]:
        if not pairs:
            return None
        keys = [t for t, _v in pairs]
        vals = torch.tensor([[v] for _t, v in pairs],
                            dtype=value_dtype(device), device=device)
        return PeriodicBatch(keys, StepRange(eval_ms, eval_ms, step_ms),
                             vals)
