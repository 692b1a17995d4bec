"""The live rollup engine: continuous raw -> 1m -> 15m -> 1h tiering.

The offline scaffolding (``jobs.py``, ``downsample/``) builds
``<ds>_ds_<res>`` datasets; this engine runs the SAME downsampler
continuously over freshly-flushed chunks, inside the server, so a
month-long dashboard query need not scan every raw sample.  Its period
reduce is ``downsample/griddown.py``'s, on the memstore's device (the
card by default), with the per-series host path for what the grid
declines:

- **incremental, chunk-aligned** (arXiv:2603.09555): each tick
  consumes ONLY the chunksets the
  flush pipeline produced since the last tick (a flush listener on
  :class:`TimeSeriesShard`; cold restarts catch up from the column
  store by ingestion time, resuming at persisted high-water marks);
- **per-series period closure**: a series' rollup period ``(P-res, P]``
  is emitted only once a flushed sample with ``ts > P`` exists for THAT
  series — per-series ingest is monotone, so a closed period can never
  change.  This is what makes the warm output **bit-equal** to the
  offline ``downsample/`` oracle over closed periods: the emitted
  records are computed by the same marker/downsampler code over the
  same rows, never a partial re-aggregation (two partial records for
  one period would collide on the period stamp and silently drop);
- **low-priority workload class**: given an admission controller whose
  ``enabled`` is set, each tick's consume+reduce runs under a
  ``"rollup"`` permit with a minted deadline, so rollup defers under
  overload and can never starve user queries;
- **durable output**: emitted records publish through the tier
  dataset's publish function (the caller's: an in-process ingest, a
  replicated fanout), so rolled chunks are flushed through the
  integrity-checksummed store and queryable like any dataset.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import numpy as np

from filodb_tpu_torch.codecs import histcodec
from filodb_tpu_torch.core.histogram import concat_hist_parts
from filodb_tpu_torch.core.record import RecordBuilder, parse_partkey
from filodb_tpu_torch.downsample import sharddown
from filodb_tpu_torch.downsample.dsstore import ds_dataset_name
from filodb_tpu_torch.downsample.sharddown import ShardDownsampler
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.store.columnstore import NullColumnStore
from filodb_tpu_torch.utils.observability import (TRACER, PeriodicThread,
                                                  rollup_metrics)
from filodb_tpu_torch.workload import AdmissionRejected
from filodb_tpu_torch.workload import deadline as wdl

# the engine's admission identity: a dedicated class priced below the
# rules engine and a reserved tenant, so rollup work is attributable
ROLLUP_PRIORITY = "rollup"
ROLLUP_TENANT = "_rollup"

_NEG = -(1 << 62)
_QUEUE_CAP = 50_000        # flush batches buffered per shard before loss
# idle-closed series keep their emitted stamps in the restart-seed map
# so a resumed series cannot re-emit a force-closed period; the map is
# soft-capped (drop oldest-inserted half) against unbounded churn
_RESTORED_CAP = 500_000


def _ck_name(dataset: str) -> str:
    """Metastore checkpoint key for rollup high-water marks (namespaced
    so it can never collide with a real dataset's ingest checkpoints)."""
    return f"__rollup__:{dataset}"


def _cat_col(a, b):
    """Concatenate two decoded column parts: plain arrays, or histogram
    ``(buckets, rows)`` tuples (widening-aware)."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        return concat_hist_parts([a, b])
    return np.concatenate([a, b])


def _take_col(c, order, keep):
    """Row-select a (possibly histogram-tuple) concatenated column."""
    if isinstance(c, tuple):
        return c[0], c[1][order][keep]
    return c[order][keep]


def _emit_col(c, mask):
    """Downsampled output column -> per-row record values.  Histogram
    downsamplers (hSum/hLast) emit ``(buckets, rows)``; each masked row
    encodes back to the wire histogram value the tier schema's hist
    column ingests (same encode as the flush path's per-row emit,
    downsample/sharddown.py _emit).  A numeric column stays an array:
    the record builder takes its f64 values as they are."""
    if isinstance(c, tuple):
        buckets, rows = c
        return [histcodec.encode_hist_value(buckets, r)
                for r in np.asarray(rows)[mask]]
    return np.asarray(c)[mask]


class _SeriesState:
    """One raw series' resident tail: rows newer than the oldest tier's
    emitted boundary, plus per-tier emitted stamps."""

    __slots__ = ("partkey", "tags", "schema_hash", "ts", "cols",
                 "emitted", "last_seen_s", "key")

    def __init__(self, partkey: bytes, tags: dict, schema_hash: int,
                 seed_emitted: Optional[dict] = None):
        self.partkey = partkey
        self.tags = tags
        self.schema_hash = schema_hash
        self.ts: Optional[np.ndarray] = None
        self.cols: list = []
        # res -> newest emitted period stamp (restored from the tier
        # dataset's persisted chunks on cold restart)
        self.emitted: dict[int, int] = dict(seed_emitted or {})
        self.last_seen_s = 0.0
        # (shard-key hash, partition hash, partkey) of its tier records,
        # computed at its first emission
        self.key = None

    def append(self, ts: np.ndarray, cols: list) -> None:
        """Append decoded rows.  Per-series ingest is monotone so new
        chunks normally extend the tail; the defensive merge handles
        restart catch-up re-reading a chunk the live listener already
        delivered (exact-duplicate timestamps keep the first copy).
        Histogram columns arrive as ``(buckets, rows)`` tuples and
        merge bucket-scheme-aware (mid-stream widening edge-pads, see
        core.histogram.concat_hist_parts)."""
        if self.ts is None or len(self.ts) == 0:
            self.ts = ts
            self.cols = list(cols)
            return
        if len(ts) == 0:
            return
        if int(ts[0]) > int(self.ts[-1]):
            self.ts = np.concatenate([self.ts, ts])
            self.cols = [_cat_col(a, b)
                         for a, b in zip(self.cols, cols)]
            return
        merged_ts = np.concatenate([self.ts, ts])
        order = np.argsort(merged_ts, kind="stable")
        merged_ts = merged_ts[order]
        keep = np.ones(len(merged_ts), bool)
        keep[1:] = merged_ts[1:] != merged_ts[:-1]
        self.ts = merged_ts[keep]
        self.cols = [_take_col(_cat_col(a, b), order, keep)
                     for a, b in zip(self.cols, cols)]

    def prune(self, resolutions) -> None:
        """Drop rows EVERY configured tier has emitted (ts <= min
        emitted stamp, a tier with no cursor yet counting as minus
        infinity — a tier that failed to publish still needs its
        rows).  Rows in open periods always survive — closure needs
        them."""
        if self.ts is None or len(self.ts) == 0:
            return
        floor = min(self.emitted.get(r, _NEG) for r in resolutions)
        if floor <= _NEG:
            return
        i = int(np.searchsorted(self.ts, floor, side="right"))
        if i > 0:
            self.ts = self.ts[i:]
            self.cols = [(c[0], c[1][i:]) if isinstance(c, tuple)
                         else c[i:] for c in self.cols]

    @property
    def buffered(self) -> int:
        return 0 if self.ts is None else len(self.ts)


class _ShardRollup:
    """Per-raw-shard rollup state (one flush listener feeds it)."""

    def __init__(self, shard_num: int):
        self.shard_num = shard_num
        # flush listener -> tick handoff: [(itime, {schema: [(tags, cs)]})]
        self.queue: list = []
        self.lost = False              # queue overflowed: continuity broken
        self.series: dict[bytes, _SeriesState] = {}
        # restart seeds: partkey -> {res: emitted stamp} from the tier
        # datasets' persisted chunks, consumed as series reappear
        self.restored: dict[bytes, dict] = {}
        self.it_hwm = -1               # newest consumed ingestion time
        # chunks whose rows are not yet emitted by every tier:
        # [itime, end_ts, partkey] — min itime is the restart replay floor
        self.pending: list = []
        self.samplers: dict[int, Optional[ShardDownsampler]] = {}
        self.active = False            # this node currently rolls this shard
        # a tier errored (emission or publish): the next tick must
        # re-attempt emission over EVERY buffered series even with no
        # fresh chunks — the failed rows are already consumed from the
        # queue and live only in the buffers
        self.retry = False


class _DatasetRollup:
    def __init__(self, dataset, memstore, schemas, config, publish_for,
                 column_store, meta_store, owner_fn, admission):
        self.dataset = dataset
        self.memstore = memstore
        self.schemas = schemas
        self.config = config
        self.publish_for = publish_for      # res -> publish(shard, container)
        self.column_store = column_store
        self.meta_store = meta_store
        self.owner_fn = owner_fn            # shard -> bool (primary here?)
        self.admission = admission
        self.lock = threading.Lock()
        self.shards: dict[int, _ShardRollup] = {}
        self.loop: Optional[PeriodicThread] = None
        # telemetry the admin view + router read
        self.samples_written: dict[int, int] = {r: 0 for r
                                                in config.resolutions_ms}
        self.passes = 0
        self.deferred = 0
        self.last_pass_s = 0.0
        self.last_pass_at_s = 0.0
        self.tier_errors: dict[int, str] = {}
        self.tier_last_advance: dict[int, float] = {}
        self.rolled_cache: dict[int, int] = {}   # res -> stitch boundary
        # the two halves a cluster's gossip composes separately: what
        # THIS node's owned shards have closed (the value it gossips),
        # and what the local tier replicas have had delivered (the
        # serve-locally clamp)
        self.owned_cache: dict[int, int] = {}
        self.delivered_cache: dict[int, int] = {}


class RollupEngine:
    """Owns every watched dataset's rollup ladder: scheduling, cursor
    state, emission, telemetry."""

    def __init__(self, node: str = ""):
        self.node = node
        self._m = rollup_metrics()
        self._datasets: dict[str, _DatasetRollup] = {}
        self._started = False
        self._gauge_rows: set = set()   # (metric, labels...) rows to remove

    # ------------------------------------------------------------- lifecycle

    def watch(self, dataset: str, memstore, schemas, config,
              publish_for: dict, column_store=None, meta_store=None,
              owner_fn: Optional[Callable[[int], bool]] = None,
              admission=None) -> None:
        """Register one raw dataset: attach a flush listener to each of
        its local shards and (for owned shards) restore cursors from the
        persisted high-water marks + tier datasets."""
        d = _DatasetRollup(dataset, memstore, schemas, config, publish_for,
                           column_store, meta_store, owner_fn, admission)
        self._datasets[dataset] = d
        for sh in memstore.shards(dataset):
            self.attach_shard(dataset, sh)

    def attach_shard(self, dataset: str, shard) -> None:
        """Wire one raw shard's flush stream into the engine (listener
        payload mirrors the flush path's downsample pairs: chunksets
        grouped by schema, tagged with the flush ingestion time)."""
        d = self._datasets[dataset]
        sr = _ShardRollup(shard.shard_num)
        with d.lock:
            d.shards[shard.shard_num] = sr
        self._install_listener(d, sr, shard)

    def _install_listener(self, d, sr, shard) -> None:
        shard.rollup_listener = \
            lambda pairs, itime, _d=d, _sr=sr: self._on_flush(_d, _sr,
                                                              pairs, itime)

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for d in self._datasets.values():
            # re-attach flush listeners after a previous stop() (which
            # detaches them); existing shard state — cursors, buffers —
            # is reused, and anything flushed while stopped replays
            # from the store on the next owned tick
            for sh in d.memstore.shards(d.dataset):
                sr = d.shards.get(sh.shard_num)
                if sr is None:
                    self.attach_shard(d.dataset, sh)
                elif sh.rollup_listener is None:
                    sr.active = False   # replay the stopped gap
                    self._install_listener(d, sr, sh)
            d.loop = PeriodicThread(
                lambda _d=d: self._tick(_d),
                d.config.tick_interval_s, f"rollup-{d.dataset}")
            d.loop.start()

    def stop(self) -> None:
        self._started = False
        for d in self._datasets.values():
            if d.loop is not None:
                d.loop.stop()
                d.loop = None
            # detach the flush listeners (every registration needs a
            # remove path): a stopped engine must not keep accumulating
            # chunksets into queues no tick will ever drain, nor stay
            # pinned by the listener closures
            for sh in d.memstore.shards(d.dataset):
                sh.rollup_listener = None
            with d.lock:
                for sr in d.shards.values():
                    sr.queue = []
        # Gauge.remove contract: a stopped engine must not keep
        # exporting lag/stall rows (a dead node's stalled=1 would feed
        # the self-monitoring alerts forever)
        for metric, labels in list(self._gauge_rows):
            self._m[metric].remove(**dict(labels))
        self._gauge_rows.clear()

    # ------------------------------------------------------------- ingest

    def _on_flush(self, d: _DatasetRollup, sr: _ShardRollup,
                  pairs_by_schema: dict, itime: int) -> None:
        """Flush-executor hook: enqueue freshly-flushed chunksets for
        the next tick.  Must never block or raise into the flush path."""
        with d.lock:
            if len(sr.queue) >= _QUEUE_CAP:
                # backlog cap: drop the handoff LOUDLY and fall back to
                # the store-replay path — the dropped chunks are
                # already persisted, so flipping the shard inactive
                # makes the next owned tick restore from the
                # ingestion-time floor instead of losing them (an
                # in-memory-only store keeps the loss, flagged)
                if not sr.lost:
                    for res in d.config.resolutions_ms:
                        d.tier_errors[res] = (
                            "flush-queue overflow: backlog dropped, "
                            "replaying from the store")
                sr.lost = True
                sr.active = False
                return
            sr.queue.append((itime, pairs_by_schema))

    # --------------------------------------------------------------- tick

    def run_once(self, dataset: str) -> None:
        """One synchronous pass over a dataset (tests, warm-up)."""
        self._tick(self._datasets[dataset])

    def _tick(self, d: _DatasetRollup) -> None:
        t0 = time.perf_counter()
        now_s = time.time()
        with TRACER.span("rollup.pass", dataset=d.dataset):
            # shards materialized after watch() (failover gain, late
            # resync) pick up their flush listener here
            for sh in d.memstore.shards(d.dataset):
                if sh.shard_num not in d.shards:
                    self.attach_shard(d.dataset, sh)
            with d.lock:
                shard_nums = list(d.shards)
            for s in shard_nums:
                sr = d.shards.get(s)
                if sr is None:
                    continue
                withheld: set = set()   # tiers in trouble this tick
                self._tick_shard(d, sr, now_s, withheld)
                # PER-SHARD stall clocks: one healthy shard must not
                # mask a permanently wedged one — the gauge below
                # reports the WORST shard per tier.  WITHHELD vetoes
                # advanced: a tier where one schema emitted but
                # another failed is still in trouble
                for res in d.config.resolutions_ms:
                    key = (s, res)
                    if res not in withheld:
                        d.tier_last_advance[key] = now_s
                    else:
                        # first withheld tick anchors the stall clock
                        d.tier_last_advance.setdefault(key, now_s)
            self._refresh_rolled_cache(d)
        dur = time.perf_counter() - t0
        d.last_pass_s = dur
        d.last_pass_at_s = now_s
        d.passes += 1
        self._m["passes"].inc(dataset=d.dataset)
        self._m["pass_seconds"].observe(dur, dataset=d.dataset)
        for res in d.config.resolutions_ms:
            stale = any(
                now_s - d.tier_last_advance.get((s, res), now_s)
                > d.config.stall_after_s for s in shard_nums)
            self._set_gauge("stalled", 1.0 if stale else 0.0,
                            dataset=d.dataset, resolution=str(res))

    def _tick_shard(self, d: _DatasetRollup, sr: _ShardRollup, now_s: float,
                    withheld: set) -> None:
        with d.lock:
            batches = sr.queue
            sr.queue = []
        owner = d.owner_fn is None or d.owner_fn(sr.shard_num)
        if not owner:
            # not the rolling replica for this shard: drop the backlog
            # (the owner consumes its own flush stream) and forget any
            # buffered state — a later ownership gain restores from the
            # persisted high-water marks instead of half-stale buffers.
            # The exported lag/buffered rows go too: a frozen lag value
            # from before the failover must not keep an alert latched
            # while the NEW owner is caught up
            if sr.active:
                with d.lock:
                    sr.series.clear()
                    sr.pending.clear()
                    sr.active = False
                self._clear_shard_gauges(d, sr)
            return
        if not sr.active:
            try:
                batches = self._restore_shard(d, sr) + batches
            except Exception as e:  # noqa: BLE001 — store unreadable:
                # requeue the drained flush batches and retry the
                # restore next tick (sr.active stays False)
                with d.lock:
                    sr.queue = batches + sr.queue
                for res in d.config.resolutions_ms:
                    d.tier_errors[res] = repr(e)
                withheld.update(d.config.resolutions_ms)
                return
            sr.active = True
        nchunks = sum(len(css) for _it, by_schema in batches
                      for css in by_schema.values())
        idle = self._idle_states(d, sr, now_s)
        if nchunks == 0 and not idle and not sr.retry:
            self._set_shard_gauges(d, sr)
            return
        permit = contextlib.nullcontext()
        if d.admission is not None and getattr(d.admission, "enabled", False) \
                and nchunks:
            qctx = wdl.mint(QueryContext(
                submit_time_ms=int(now_s * 1000),
                timeout_ms=int(d.config.tick_interval_s * 1000),
                tenant=ROLLUP_TENANT,
                priority=ROLLUP_PRIORITY))
            try:
                permit = d.admission.admit(qctx, float(nchunks))
            except AdmissionRejected:
                # overloaded: rollup yields — requeue and retry next tick
                with d.lock:
                    sr.queue = batches + sr.queue
                d.deferred += 1
                self._m["deferred"].inc(dataset=d.dataset)
                withheld.update(d.config.resolutions_ms)
                return
        with permit:
            try:
                self._consume_and_emit(d, sr, batches, idle, now_s,
                                       withheld)
            except Exception as e:  # noqa: BLE001 — a consume failure
                # (decode, staging) must not LOSE the drained batches:
                # requeue them whole and retry next tick.  Re-consumed
                # rows dedupe at append and re-emission masks on the
                # cursors, so the retry is idempotent; a permanently
                # poisoned chunk wedges THIS shard's rollup loudly
                # (stall gauge -> self-monitoring alert) instead of
                # silently diverging from raw.
                with d.lock:
                    sr.queue = batches + sr.queue
                for res in d.config.resolutions_ms:
                    d.tier_errors[res] = repr(e)
                    self._m["errors"].inc(dataset=d.dataset,
                                          resolution=str(res))
                withheld.update(d.config.resolutions_ms)
                sr.retry = True
        self._set_shard_gauges(d, sr)

    # ------------------------------------------------------ consume + emit

    def _consume_and_emit(self, d, sr, batches, idle, now_s,
                          withheld) -> None:
        touched: dict[int, dict] = {}        # schema -> {id(tags): state}
        per_schema: dict[int, list] = {}
        ledger_add: list = []
        for itime, by_schema in batches:
            sr.it_hwm = max(sr.it_hwm, int(itime))
            for shash, pairs in by_schema.items():
                per_schema.setdefault(shash, []).extend(pairs)
                for _tags, cs in pairs:
                    ledger_add.append([int(itime), int(cs.info.end_time),
                                       cs.partkey])
        for shash, pairs in per_schema.items():
            sampler = self._sampler(d, sr, shash)
            if sampler is None:
                continue
            decoded_new = sharddown.decode_concat_with_keys(sampler.schema,
                                                            pairs)
            with d.lock:
                for pk, tags, ts, cols in decoded_new:
                    st = sr.series.get(pk)
                    if st is None:
                        st = sr.series[pk] = _SeriesState(
                            pk, tags, shash,
                            seed_emitted=sr.restored.pop(pk, None))
                    st.append(np.asarray(ts, dtype=np.int64), cols)
                    st.last_seen_s = now_s
                    touched.setdefault(shash, {})[id(st.tags)] = st
        # a series that RESUMED in this very tick is no longer idle —
        # force-closing it now would emit its open period mid-way and
        # the later rows could never replace the partial record
        fresh = {sid for m in touched.values() for sid in m}
        idle = [st for st in idle if id(st.tags) not in fresh]
        for st in idle:
            # force-close a silent series: emit its open periods too
            touched.setdefault(st.schema_hash, {}).setdefault(
                id(st.tags), st)
        if sr.retry:
            # a previous tier failure left closed-but-unemitted rows in
            # the buffers: re-attempt every buffered series (already-
            # emitted periods mask out, so the pass is idempotent)
            with d.lock:
                for st in sr.series.values():
                    touched.setdefault(st.schema_hash, {}).setdefault(
                        id(st.tags), st)
        failed = False
        emitted: list = []      # (res, n, [containers], cursor updates)
        for shash, stmap in touched.items():
            sampler = self._sampler(d, sr, shash)
            if sampler is None:
                continue
            states = [st for st in stmap.values() if st.buffered]
            if not states:
                continue
            decoded = [(st.tags, st.ts, st.cols) for st in states]
            prepared = sampler.prepare_decoded(decoded)
            by_id = {id(st.tags): st for st in states}
            force_close = {id(st.tags) for st in idle}
            for res in d.config.resolutions_ms:
                try:
                    n, containers, updates = self._emit_tier(
                        sampler, prepared, by_id, force_close, res)
                except Exception as e:  # noqa: BLE001 — one tier's failure
                    # must not block the others (or the next tick)
                    d.tier_errors[res] = repr(e)
                    self._m["errors"].inc(dataset=d.dataset,
                                          resolution=str(res))
                    withheld.add(res)
                    failed = True
                    continue
                if n:
                    emitted.append((res, n, containers, updates))
        # publish OUTSIDE the state lock (the fanout/broker edge may
        # block), and advance the cursors only AFTER the tier's
        # containers left this process: a failed publish retries the
        # whole emission next tick — re-sent duplicates of a partially
        # delivered pass are dropped by the tier partition's equal-
        # timestamp dedupe, while an advanced-but-unsent cursor would
        # lose the rows forever
        all_published = True
        for res, n, containers, updates in emitted:
            publish = d.publish_for.get(res)
            try:
                if publish is not None:
                    for container in containers:
                        publish(sr.shard_num, container)
            except Exception as e:  # noqa: BLE001 — transport failure:
                # leave the cursor, retry next tick
                d.tier_errors[res] = repr(e)
                self._m["errors"].inc(dataset=d.dataset,
                                      resolution=str(res))
                withheld.add(res)
                all_published = False
                failed = True
                continue
            if res not in withheld:
                # only a FULLY healthy tier clears its error: another
                # schema's emission failure for this res in this same
                # tick must stay visible (and keep the stall clock
                # withheld) — a healthy schema must not mask it
                d.tier_errors.pop(res, None)
            with d.lock:
                for st, stamp in updates:
                    st.emitted[res] = stamp
            d.samples_written[res] += n
            self._m["samples"].inc(n, dataset=d.dataset,
                                   resolution=str(res))
        with d.lock:
            if all_published and not failed:
                # idle (force-closed) states drop only once EVERY tier
                # emitted AND delivered — otherwise their rows must
                # survive for the retry.  Their emitted stamps PERSIST
                # in the restart-
                # seed map: if the series resumes inside a force-closed
                # period, a fresh state would otherwise re-emit that
                # period's stamp from the new rows alone and the tier's
                # first-copy dedupe would keep the PARTIAL record
                for st in idle:
                    if st.emitted:
                        sr.restored[st.partkey] = dict(st.emitted)
                    sr.series.pop(st.partkey, None)
                if len(sr.restored) > _RESTORED_CAP:
                    for pk in list(sr.restored)[:_RESTORED_CAP // 2]:
                        sr.restored.pop(pk, None)
            for st in sr.series.values():
                st.prune(d.config.resolutions_ms)
            sr.pending.extend(ledger_add)
            keep = []
            for entry in sr.pending:
                st = sr.series.get(entry[2])
                if st is None:
                    continue
                floor = min(st.emitted.get(r, _NEG)
                            for r in d.config.resolutions_ms)
                if entry[1] > floor:
                    keep.append(entry)
            sr.pending = keep
            floor_itime = min((e[0] for e in sr.pending),
                              default=sr.it_hwm + 1)
            sr.retry = failed
        self._persist(d, sr, floor_itime)

    def _emit_tier(self, sampler, prepared, by_id, force_close,
                   res: int):
        """One (schema, resolution) emission pass: downsample the
        resident buffers with the shared grid/host kernels, keep only
        newly-CLOSED periods per series, build record containers.
        Returns (records, containers, cursor updates) — the caller
        applies the updates only after the containers are delivered.

        The series whose period-end vectors are equal (the grid path's
        series live over the same periods) are emitted together: each
        one's newly closed periods are a run of that vector, and their
        records are encoded in one pass; the records are those the
        per-series loop builds."""
        outs = sampler.downsample_arrays(prepared, res)
        builder = RecordBuilder(sampler.ds_schema)
        updates: list = []
        n = 0
        shared: dict = {}        # pe's bytes -> (pe, [(state, cols)])
        for tags, pe, cols in outs:
            st = by_id.get(id(tags))
            if st is None or st.ts is None or len(st.ts) == 0:
                continue
            if not any(isinstance(c, tuple) for c in cols):
                pe = np.asarray(pe, dtype=np.int64)
                shared.setdefault(pe.tobytes(), (pe, []))[1].append(
                    (st, cols))
                continue
            n += self._emit_series(builder, st, pe, cols, force_close, res,
                                   updates)
        for pe, members in shared.values():
            n += self._emit_shared(builder, pe, members, force_close, res,
                                   updates)
        return n, builder.containers(), updates

    @staticmethod
    def _closed_through(st, force_close, res: int) -> int:
        if id(st.tags) in force_close:
            return 1 << 62              # emit open periods too (idle close)
        # period (P-res, P] closes only once a sample PAST it exists for
        # this series — monotone per-series ingest means the period can
        # then never change
        return ((int(st.ts[-1]) - 1) // res) * res

    def _emit_series(self, builder, st, pe, cols, force_close, res: int,
                     updates: list) -> int:
        """One series' newly closed periods, added to ``builder``."""
        closed = self._closed_through(st, force_close, res)
        pe = np.asarray(pe, dtype=np.int64)
        mask = pe <= closed
        prev = st.emitted.get(res)
        if prev is not None:
            mask &= pe > prev
        if not mask.any():
            return 0
        pe_m = pe[mask]
        builder.add_series(pe_m, [_emit_col(c, mask) for c in cols],
                           st.tags)
        updates.append((st, int(pe_m[-1])))
        return len(pe_m)

    def _emit_shared(self, builder, pe, members, force_close, res: int,
                     updates: list) -> int:
        """The series of one period-end vector: where it is strictly
        ascending, each one's newly closed periods ``prev < pe <=
        closed`` are the run ``[lo, hi)`` of it, and the records of
        every series go to ``builder`` in one encode a partkey length,
        each series' in time order."""
        if len(members) == 1 or (len(pe) > 1 and
                                 not (pe[1:] > pe[:-1]).all()):
            return sum(self._emit_series(builder, st, pe, cols, force_close,
                                         res, updates)
                       for st, cols in members)
        closed = np.fromiter((self._closed_through(st, force_close, res)
                              for st, _c in members), np.int64, len(members))
        prev = np.fromiter((st.emitted.get(res, _NEG) for st, _c in members),
                           np.int64, len(members))
        lo = np.searchsorted(pe, prev, side="right")
        hi = np.maximum(np.searchsorted(pe, closed, side="right"), lo)
        lens = hi - lo
        live = np.flatnonzero(lens)
        if not len(live):
            return 0
        for i in live:
            st = members[i][0]
            if st.key is None:
                st.key = builder.series_key(st.tags)
            updates.append((st, int(pe[hi[i] - 1])))
        pklen = np.fromiter((len(members[i][0].key[2]) for i in live),
                            np.int64, len(live))
        for plen in np.unique(pklen):
            group = live[pklen == plen]
            cnt = lens[group]
            total = int(cnt.sum())
            # record r of series g is row lo[g] + r of the vector
            first = np.repeat(lo[group] - np.cumsum(cnt) + cnt, cnt)
            rows = first + np.arange(total)
            ncols = len(members[group[0]][1])
            vals = [np.concatenate([np.asarray(members[g][1][c])[lo[g]:hi[g]]
                                    for g in group])
                    for c in range(ncols)]
            keys = [members[g][0].key for g in group]
            builder.add_records_hashed(
                pe[rows], vals,
                np.repeat(np.asarray([k[0] for k in keys], np.uint32), cnt),
                np.repeat(np.asarray([k[1] for k in keys], np.uint32), cnt),
                int(plen),
                np.repeat(np.frombuffer(b"".join(k[2] for k in keys),
                                        f"V{int(plen)}"), cnt)
                if plen else None)
        return int(lens.sum())

    def _idle_states(self, d, sr, now_s: float) -> list:
        if d.config.idle_close_s is None:
            return []
        cutoff = now_s - d.config.idle_close_s
        with d.lock:
            return [st for st in sr.series.values()
                    if st.buffered and st.last_seen_s
                    and st.last_seen_s < cutoff]

    def _sampler(self, d, sr, schema_hash: int):
        """ShardDownsampler for one raw schema, memoized; None when the
        schema can't roll (no downsamplers / no downsample schema).  Its
        period reduce runs on the memstore's device.  Histogram schemas
        roll through their hSum/hLast period oracles
        (downsample/chunkdown.py): the grid staging declines them
        (griddown.grid_supported), so they reduce on the per-series
        host path."""
        if schema_hash in sr.samplers:
            return sr.samplers[schema_hash]
        sampler = None
        try:
            schema = d.schemas.by_hash(schema_hash)
        except KeyError:
            schema = None
        if schema is not None:
            s = ShardDownsampler(d.dataset, sr.shard_num, schema, None,
                                 d.config.resolutions_ms,
                                 device=d.memstore.device)
            if s.enabled:
                sampler = s
        sr.samplers[schema_hash] = sampler
        return sampler

    # ------------------------------------------------------------- restart

    def _restore_shard(self, d: _DatasetRollup, sr: _ShardRollup) -> list:
        """Cold restart / ownership gain: seed per-series emitted stamps
        from the tier datasets' persisted chunks (a rolled record's
        stamp IS the cursor) and replay raw chunks from the persisted
        ingestion-time floor.  Returns listener-shaped batches."""
        store = d.column_store
        if store is None or isinstance(store, NullColumnStore):
            return []
        for res in d.config.resolutions_ms:
            name = ds_dataset_name(d.dataset, res)
            try:
                for _it, cs in store.chunksets_with_ingestion_time(
                        name, sr.shard_num, 0, 1 << 62):
                    seeds = sr.restored.setdefault(cs.partkey, {})
                    seeds[res] = max(seeds.get(res, _NEG),
                                     int(cs.info.end_time))
            except Exception:  # noqa: BLE001 — tier dataset not created yet
                continue
        floor = None
        if d.meta_store is not None:
            try:
                cps = d.meta_store.read_checkpoints(_ck_name(d.dataset),
                                                    sr.shard_num)
            except Exception:  # noqa: BLE001 — meta store not ready
                cps = {}
            floor = cps.get(0)
            sr.it_hwm = max(sr.it_hwm, cps.get(1, -1))
        if floor is None:
            return []
        tags_memo: dict[bytes, dict] = {}
        batches: dict[int, dict] = {}
        for itime, cs in store.chunksets_with_ingestion_time(
                d.dataset, sr.shard_num, floor, 1 << 62):
            schema = self._schema_of(d, cs)
            if schema is None:
                continue
            tags = tags_memo.get(cs.partkey)
            if tags is None:
                tags = tags_memo[cs.partkey] = parse_partkey(cs.partkey)
            batches.setdefault(int(itime), {}).setdefault(
                schema.schema_hash, []).append((tags, cs))
        return [(it, batches[it]) for it in sorted(batches)]

    @staticmethod
    def _schema_of(d, cs):
        if cs.schema_hash:
            try:
                return d.schemas.by_hash(cs.schema_hash)
            except KeyError:
                return None
        for s in d.schemas.all:
            if len(s.data.columns) == len(cs.vectors) \
                    and s.downsample is not None:
                return s
        return None

    def _persist(self, d, sr, floor_itime: int) -> None:
        """Write the restart high-water marks: group 0 = the replay
        floor (oldest ingestion time still holding unemitted rows),
        group 1 = the consumed ingestion-time high-water."""
        if d.meta_store is None or d.column_store is None \
                or isinstance(d.column_store, NullColumnStore):
            return
        try:
            d.meta_store.write_checkpoint(_ck_name(d.dataset),
                                          sr.shard_num, 0, int(floor_itime))
            d.meta_store.write_checkpoint(_ck_name(d.dataset),
                                          sr.shard_num, 1, int(sr.it_hwm))
        except Exception:  # noqa: BLE001 — cursor persistence is advisory;
            # the next successful tick rewrites it
            pass

    # ------------------------------------------------------------ telemetry

    def _set_gauge(self, metric: str, value: float, **labels) -> None:
        self._m[metric].set(value, **labels)
        self._gauge_rows.add((metric, tuple(sorted(labels.items()))))

    def _clear_shard_gauges(self, d, sr) -> None:
        """Remove one shard's exported lag/buffered rows (ownership
        loss): frozen values must not outlive the state behind them."""
        rows = [("buffered", {"dataset": d.dataset,
                              "shard": str(sr.shard_num)})]
        for res in d.config.resolutions_ms:
            rows.append(("lag", {"dataset": d.dataset,
                                 "shard": str(sr.shard_num),
                                 "resolution": str(res)}))
        for metric, labels in rows:
            self._m[metric].remove(**labels)
            self._gauge_rows.discard(
                (metric, tuple(sorted(labels.items()))))

    def _set_shard_gauges(self, d, sr) -> None:
        with d.lock:
            states = list(sr.series.values())
        buffered = sum(st.buffered for st in states)
        self._set_gauge("buffered", float(buffered), dataset=d.dataset,
                        shard=str(sr.shard_num))
        data_hwm = max((int(st.ts[-1]) for st in states
                        if st.ts is not None and len(st.ts)), default=None)
        data_floor = min((int(st.ts[0]) for st in states
                          if st.ts is not None and len(st.ts)), default=None)
        for res in d.config.resolutions_ms:
            if data_hwm is None:
                lag = 0.0
            else:
                emitted = max((st.emitted.get(res, _NEG)
                               for st in states), default=_NEG)
                if emitted > _NEG:
                    lag = max(0.0, (data_hwm - emitted) / 1000.0)
                else:
                    # nothing emitted yet: the whole buffer is unrolled
                    lag = max(0.0, (data_hwm - data_floor) / 1000.0)
            self._set_gauge("lag", lag, dataset=d.dataset,
                            shard=str(sr.shard_num), resolution=str(res))

    def _refresh_rolled_cache(self, d) -> None:
        """Per-tier stitch boundary: the newest stamp up to which EVERY
        live series of every owned shard has been rolled — the router
        serves rolled data only below it, raw above (no gaps).

        Shards OTHER nodes roll contribute through the tier dataset's
        local replica instead: the newest rolled stamp actually
        DELIVERED here floors the boundary, so a peer whose rollup
        lags (deferrals, tier errors, a dead fanout lane) pulls the
        stitch down rather than leaving silent holes in its shards'
        rolled range.  (Intra-shard series skew on peer shards still
        needs tier-watermark gossip.)"""
        out: dict[int, int] = {}
        owned_out: dict[int, int] = {}
        delivered_out: dict[int, int] = {}
        with d.lock:
            for res in d.config.resolutions_ms:
                vals: list[int] = []
                for sr in d.shards.values():
                    if not sr.active:
                        continue
                    for st in sr.series.values():
                        e = st.emitted.get(res)
                        if e is None:
                            if st.ts is None or not len(st.ts):
                                continue
                            # nothing closed yet: data before this
                            # series' first sample is not MISSING, so
                            # its floor is the period before it
                            e = ((int(st.ts[0]) - 1) // res) * res
                        vals.append(e)
                local = min(vals) if vals else None
                delivered = [sh.latest_ingest_ts for sh in
                             d.memstore.shards(ds_dataset_name(d.dataset,
                                                               res))
                             if sh.latest_ingest_ts >= 0]
                clamp = min(delivered) if delivered else None
                if local is not None:
                    owned_out[res] = local
                if clamp is not None:
                    delivered_out[res] = clamp
                if local is not None and clamp is not None:
                    out[res] = min(local, clamp)
                elif clamp is not None:
                    # a pure-replica node (owns no primaries) can still
                    # route from the tier data delivered to it
                    out[res] = clamp
                elif local is not None:
                    out[res] = local
            d.rolled_cache = out
            d.owned_cache = owned_out
            d.delivered_cache = delivered_out

    # ---------------------------------------------------------------- views

    def rolled_through(self, dataset: str, res: int) -> int:
        """Newest sample time the tier serves without gaps (very
        negative when nothing is rolled yet)."""
        d = self._datasets.get(dataset)
        if d is None:
            return _NEG
        with d.lock:
            return d.rolled_cache.get(res, _NEG)

    def owned_rolled_through(self, dataset: str, res: int) -> Optional[int]:
        """Closure boundary over the shards THIS node rolls (None when
        it owns none) — the authoritative value this node gossips."""
        d = self._datasets.get(dataset)
        if d is None:
            return None
        with d.lock:
            return d.owned_cache.get(res)

    def delivered_through(self, dataset: str, res: int) -> Optional[int]:
        """Newest rolled stamp delivered to every local tier replica
        (None when this node holds no tier data) — the serve-locally
        clamp the cluster-wide boundary still must respect."""
        d = self._datasets.get(dataset)
        if d is None:
            return None
        with d.lock:
            return d.delivered_cache.get(res)

    def rolled_snapshot(self) -> dict:
        """Per-dataset owned-closure watermarks for the ``/__health``
        gossip payload: only shards this node actually
        rolls — peers compose their own delivered clamps."""
        out: dict = {}
        for ds, d in self._datasets.items():
            with d.lock:
                tiers = {str(r): v for r, v in d.owned_cache.items()}
            if tiers:
                out[ds] = tiers
        return out

    def datasets(self) -> list[str]:
        return list(self._datasets)

    def config_for(self, dataset: str):
        d = self._datasets.get(dataset)
        return d.config if d is not None else None

    def admin_state(self) -> dict:
        """The ``GET /admin/rollup`` payload: cursor positions, lag vs
        the flush watermark, pass timing, rows written, per-tier
        health."""
        out = []
        for ds, d in self._datasets.items():
            with d.lock:
                shards = []
                for sr in sorted(d.shards.values(),
                                 key=lambda s: s.shard_num):
                    states = list(sr.series.values())
                    data_hwm = max((int(st.ts[-1]) for st in states
                                    if st.ts is not None and len(st.ts)),
                                   default=None)
                    tiers = {}
                    for res in d.config.resolutions_ms:
                        em = [st.emitted[res] for st in states
                              if res in st.emitted]
                        tiers[str(res)] = {
                            "emitted_through_ms": max(em) if em else None,
                            "emitted_min_ms": min(em) if em else None,
                            "lag_s": round(
                                (data_hwm - max(em)) / 1000.0, 3)
                            if em and data_hwm is not None else None,
                        }
                    shards.append({
                        "shard": sr.shard_num,
                        "active": sr.active,
                        "queue_depth": len(sr.queue),
                        "ingestion_time_hwm": sr.it_hwm,
                        "buffered_series": len(states),
                        "buffered_samples": sum(st.buffered
                                                for st in states),
                        "data_hwm_ms": data_hwm,
                        "overflow_lost": sr.lost,
                        "tiers": tiers,
                    })
                rolled = {str(r): v for r, v in d.rolled_cache.items()}
                # atomic snapshots: the tick thread inserts/pops keys
                # concurrently and iterating the live dicts could raise
                # mid-request
                errors = dict(d.tier_errors)
                written = dict(d.samples_written)
            out.append({
                "dataset": ds,
                "resolutions_ms": list(d.config.resolutions_ms),
                "tick_interval_s": d.config.tick_interval_s,
                "passes": d.passes,
                "deferred": d.deferred,
                "last_pass_s": round(d.last_pass_s, 6),
                "samples_written": {str(r): n for r, n
                                    in written.items()},
                "tier_errors": {str(r): e for r, e
                                in errors.items()},
                "rolled_through_ms": rolled,
                "shards": shards,
            })
        return {"priority_class": ROLLUP_PRIORITY, "tenant": ROLLUP_TENANT,
                "datasets": out}
