"""Shared incremental window-state core: resident windows, ticked by deltas.

Capability match for the reference's window states, which two consumers
share there (the rule engine's recording rules and the query-frontend
result cache); the port has the result cache (``query/resultcache``):
a repeatedly-refreshed instant dashboard panel keeps its window
resident, so each refresh re-scans only the open head chunk's sliver
instead of the whole window.

Two state shapes:

- :class:`WindowState` — ``fn(selector[w])``: one window value per
  input series.
- :class:`AggWindowState` — ``agg by/without (fn(selector[w]))`` for the
  moment aggregations (sum/count/min/max/avg/group/stddev/stdvar).
  Per-series window values are computed with the very same
  :func:`~filodb_tpu_torch.query.rangefns.apply_range_function` the
  query path's general path dispatches, then aggregated through the
  NORMAL aggregator machinery — per-shard-bucket ``Aggregator.map``
  partials merged with the same ``AggPartialBatch`` reduce
  ``ReduceAggregateExec`` runs — so the float association matches the
  general path's scatter-gather exactly.  Two ordering disciplines make
  that hold:

  * buckets mirror the fetch's per-shard batches in shard order (the
    reduce order of the query path's child list);
  * within a bucket, series keep their FIRST-APPEARANCE slot forever
    (emptied series leave a tombstone rather than being deleted):
    part-ids are assigned in creation order and index lookups return
    them ascending, so first-appearance order IS the leaf-scan batch
    order, and a series that empties and later resumes must not move
    to the back of the association.

The window values are computed on the device the caller names (the
query's ExecContext device); the resident samples are host rows, as
the fetch's raw batches are.  :class:`WindowState` reads back only the
values it emits; :class:`AggWindowState` returns its aggregate on the
device, as every plan of the engine does.

The invariant: warm incremental output is **bit-equal** to a cold full
evaluation.  Late-arriving samples (a NEW series materializing with
timestamps at or below an already-consumed slice boundary) are
invisible to warm state until :meth:`reset`; the result cache detects
the case with a part-id signature and resets (a cache may never
diverge from a cold evaluation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from filodb_tpu_torch.core.chunk import build_batch
from filodb_tpu_torch.ops.windows import StepRange
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.model import to_numpy
from filodb_tpu_torch.query.rangefns import apply_range_function, supported

# row padding for the buffered batches: the same default the shard
# store config uses, so incremental and cold batches have the same row
# padding (values are padding-independent either way)
_ROW_PAD = 64

# tombstone/residency backstop: a state holding more series than this
# (live + tombstoned) resets cold instead of growing without bound
_MAX_SERIES = 200_000


class WindowUnsupported(Exception):
    """The data didn't match the recognized shape at tick time (hist
    planes, bucket-count drift past reset, residency blow-up) — the
    caller falls back to full evaluation."""


@dataclasses.dataclass
class WindowSpec:
    """The recognized incremental shape: ``fn(selector[w])``."""

    filters: tuple
    window_ms: int
    function: object                # RangeFunctionId
    args: tuple = ()


# the aggregations whose map partials are zero-insensitive moments:
# adding an absent/NaN series contributes an exact 0.0 (or -inf/inf for
# min/max), so the incremental association matches the query path's
# bit-for-bit.  topk/quantile/count_values reduce through value
# ordering and are excluded on purpose.
_AGG_OPS = frozenset({"SUM", "COUNT", "MIN", "MAX", "AVG", "GROUP",
                      "STDDEV", "STDVAR"})


@dataclasses.dataclass
class AggWindowSpec:
    """The extended incremental shape: ``agg by (..)(fn(selector[w]))``."""

    window: WindowSpec
    operator: object                # AggregationOperator
    by: tuple = ()
    without: tuple = ()


def window_spec(plan) -> Optional[WindowSpec]:
    """Return the :class:`WindowSpec` when ``plan`` is a bare windowed
    range function the incremental path supports; ``None`` falls back
    to full evaluation (aggregations, joins, offsets, histograms...).

    ``offset`` is excluded on purpose: an offset window reads the past,
    where "newly-arrived samples" no longer describes the delta.
    """
    if not isinstance(plan, lp.PeriodicSeriesWithWindowing):
        return None
    if plan.offset_ms:
        return None
    if not isinstance(plan.series, lp.RawSeries) or plan.series.columns:
        return None
    if not supported(plan.function, hist=False):
        return None
    return WindowSpec(tuple(plan.series.filters), int(plan.window_ms),
                      plan.function, tuple(plan.function_args))


def agg_window_spec(plan) -> Optional[AggWindowSpec]:
    """Recognize ``agg [by|without (...)] (fn(selector[w]))`` — the
    shape recorded dashboards use most (``sum(rate(...))``,
    ``sum by (le)(rate(..._bucket[5m]))``); ``None`` falls back."""
    if not isinstance(plan, lp.Aggregate):
        return None
    if plan.params:
        return None
    if getattr(plan.operator, "name", None) not in _AGG_OPS:
        return None
    inner = window_spec(plan.vectors)
    if inner is None:
        return None
    return AggWindowSpec(inner, plan.operator, tuple(plan.by),
                         tuple(plan.without))


def batches_to_buckets(batches) -> list:
    """Unpack a RawSeries plan's result batches into the per-shard
    bucket shape the window states consume: one inner
    ``[(tags, ts, vals)]`` list per per-shard ``RawBatch``, in the
    scatter-gather child order (the order the query path's reduce
    associates in).  Histogram planes raise :class:`WindowUnsupported`
    — the buffers hold scalar floats."""
    from filodb_tpu_torch.query.model import RawBatch
    buckets: list = []
    for b in batches:
        if not isinstance(b, RawBatch):
            continue
        rows: list = []
        if b.batch is not None:
            if b.batch.hist is not None:
                raise WindowUnsupported("histogram-schema selector")
            ts_all = to_numpy(b.batch.timestamps)
            vals_all = to_numpy(b.batch.values)
            counts = to_numpy(b.batch.row_counts)
            for i, tags in enumerate(b.keys):
                n = int(counts[i])
                rows.append((tags, np.asarray(ts_all[i][:n]),
                             np.asarray(vals_all[i][:n])))
        buckets.append(rows)
    return buckets


class _SeriesBuffer:
    """One input series' resident window: samples grouped into blocks
    keyed on chunk-aligned boundaries (``ts // block_ms``), so eviction
    drops whole immutable blocks instead of scanning sample-by-sample.
    A block holds its rows as the arrays they arrived in (ascending
    timestamps: a series only ever appends past its newest row)."""

    __slots__ = ("tags", "blocks", "last_ts")

    def __init__(self, tags: dict):
        self.tags = tags
        # block idx -> [(ts array, values array)...] in arrival order
        self.blocks: dict[int, list] = {}
        self.last_ts = -(1 << 62)           # newest buffered timestamp

    def append(self, ts: np.ndarray, vals: np.ndarray,
               block_ms: int) -> None:
        n = len(ts)
        if not n:
            return
        first, last = int(ts[0]) // block_ms, int(ts[-1]) // block_ms
        if first == last:                   # the common case: one block
            self.blocks.setdefault(first, []).append((ts, vals))
        else:
            idx = ts // block_ms
            cut = np.flatnonzero(idx[1:] != idx[:-1]) + 1
            for lo, hi in zip([0, *cut.tolist()], [*cut.tolist(), n]):
                self.blocks.setdefault(int(idx[lo]), []).append(
                    (ts[lo:hi], vals[lo:hi]))
        self.last_ts = max(self.last_ts, int(ts[-1]))

    def evict_before(self, cutoff_ms: int, block_ms: int) -> None:
        """Drop blocks wholly below ``cutoff_ms`` (a block containing
        the cutoff stays; compute-time clamping handles its head)."""
        dead = [b for b in self.blocks if (b + 1) * block_ms <= cutoff_ms]
        for b in dead:
            del self.blocks[b]

    def window_rows(self, start_ms: int,
                    end_ms: int) -> tuple[np.ndarray, np.ndarray]:
        """Samples with ``start <= ts <= end`` in timestamp order — the
        same inclusive clamp a leaf scan's ``read_range`` applies."""
        parts = [p for b in sorted(self.blocks) for p in self.blocks[b]]
        if not parts:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float64))
        if len(parts) == 1:
            ts, vals = parts[0]
        else:
            ts = np.concatenate([t for t, _v in parts])
            vals = np.concatenate([v for _t, v in parts])
        if ts[0] >= start_ms and ts[-1] <= end_ms:
            return ts, vals
        lo = np.searchsorted(ts, start_ms, side="left")
        hi = np.searchsorted(ts, end_ms, side="right")
        return ts[lo:hi], vals[lo:hi]

    @property
    def sample_count(self) -> int:
        return sum(len(t) for rows in self.blocks.values() for t, _v in rows)


def _window_values(keys, ts_list, val_list, steps, spec: WindowSpec,
                   device):
    """The window function over the resident rows, on ``device``:
    ``[len(keys), 1]``."""
    batch = build_batch(ts_list, val_list, pad_to=_ROW_PAD)
    return apply_range_function(batch, steps, spec.window_ms,
                                spec.function, spec.args,
                                device=device)[:len(keys)]


class WindowState:
    """Incremental evaluator for one ``fn(selector[w])`` shape.

    ``fetch`` is the consumer's raw-series reader — it issues a
    ``RawSeries`` plan through the normal planner path and returns
    ``[(tags, ts, vals)]`` clamped to the requested interval.
    """

    def __init__(self, spec: WindowSpec, block_ms: Optional[int] = None):
        self.spec = spec
        # chunk-aligned block boundary: the window itself (>= 1s), so a
        # live window spans at most 2 resident blocks + the open one
        self.block_ms = int(block_ms or max(spec.window_ms, 1000))
        self.fetched_through_ms: Optional[int] = None
        self.series: dict[tuple, _SeriesBuffer] = {}
        self.samples_consumed = 0      # lifetime, for telemetry

    # --------------------------------------------------------------- state

    def reset(self) -> None:
        """Forget everything: the next tick re-reads the full window
        (cold).  Called by consumers after any failed evaluation so a
        missed slice cannot leave a silent hole in the window."""
        self.fetched_through_ms = None
        self.series.clear()

    @property
    def resident_series(self) -> int:
        return len(self.series)

    @property
    def resident_samples(self) -> int:
        return sum(b.sample_count for b in self.series.values())

    # ---------------------------------------------------------------- tick

    def tick(self, eval_ms: int,
             fetch: Callable[[tuple, int, int], list],
             device="cuda") -> list[tuple[dict, float]]:
        """Consume newly-arrived samples and produce ``[(tags, value)]``
        for every series with a non-NaN window value at ``eval_ms``; the
        window function runs on ``device``."""
        window_start = eval_ms - self.spec.window_ms
        warm = self.fetched_through_ms is not None \
            and self.fetched_through_ms <= eval_ms
        fetch_from = self.fetched_through_ms if warm else window_start
        new = 0
        for tags, ts, vals in fetch(self.spec.filters, fetch_from, eval_ms):
            key = tuple(sorted(tags.items()))
            buf = self.series.get(key)
            if buf is not None:
                # dedupe against THIS series' newest buffered row, not
                # the global fetch boundary: a sample stamped exactly at
                # the boundary but ingested after the boundary fetch ran
                # would otherwise vanish from warm state (and break the
                # bit-equality invariant vs a cold pass)
                keep = ts > buf.last_ts
            else:
                keep = ts >= (fetch_from if warm else window_start)
            ts, vals = ts[keep], vals[keep]
            if not len(ts):
                continue
            if buf is None:
                buf = self.series[key] = _SeriesBuffer(dict(tags))
            buf.append(ts, vals, self.block_ms)
            new += len(ts)
        self.samples_consumed += new
        self.fetched_through_ms = eval_ms
        # evict aged blocks; a series whose whole window emptied is
        # dropped outright: state for a vanished series must not
        # survive it
        for key in list(self.series):
            buf = self.series[key]
            buf.evict_before(window_start, self.block_ms)
            if not buf.blocks:
                del self.series[key]
        if not self.series:
            return []
        keys, ts_list, val_list = [], [], []
        for buf in self.series.values():
            ts, vals = buf.window_rows(window_start, eval_ms)
            if not len(ts):
                continue
            keys.append(buf.tags)
            ts_list.append(ts)
            val_list.append(vals)
        if not keys:
            return []
        values = _window_values(keys, ts_list, val_list,
                                StepRange(eval_ms, eval_ms, 1000),
                                self.spec, device)
        # the emitted values are what the caller reads: one readback
        host = to_numpy(values[:, 0]).astype(np.float64)
        out = []
        for i, tags in enumerate(keys):
            v = float(host[i])
            if not np.isnan(v):
                out.append((tags, v))
        return out


class _Bucket:
    """One shard's resident series, in first-appearance order with
    tombstones (see the module docstring's ordering discipline)."""

    __slots__ = ("series",)

    def __init__(self):
        self.series: dict[tuple, _SeriesBuffer] = {}


class AggWindowState:
    """Incremental evaluator for ``agg by (..)(fn(selector[w]))``.

    ``fetch`` returns the delta grouped per shard bucket, in the same
    order the query path's scatter-gather children reduce in:
    ``[[(tags, ts, vals), ...], ...]`` — one inner list per per-shard
    ``RawBatch`` of the fetch plan, ascending shard order.
    """

    def __init__(self, spec: AggWindowSpec, block_ms: Optional[int] = None,
                 max_buckets: int = 16):
        self.spec = spec
        self.block_ms = int(block_ms or max(spec.window.window_ms, 1000))
        # >= hierarchical-reduce fan-in shards reduce in sqrt groups on
        # the query path — a different association this flat reduce
        # cannot reproduce, so such fan-outs fall back to full evaluation
        self.max_buckets = max_buckets
        self.fetched_through_ms: Optional[int] = None
        self.buckets: list[_Bucket] = []
        self.samples_consumed = 0

    # --------------------------------------------------------------- state

    def reset(self) -> None:
        self.fetched_through_ms = None
        self.buckets = []

    @property
    def resident_series(self) -> int:
        return sum(1 for b in self.buckets
                   for buf in b.series.values() if buf.blocks)

    @property
    def resident_samples(self) -> int:
        return sum(buf.sample_count for b in self.buckets
                   for buf in b.series.values())

    # ---------------------------------------------------------------- tick

    def _consume(self, eval_ms: int, fetch) -> None:
        window_start = eval_ms - self.spec.window.window_ms
        warm = self.fetched_through_ms is not None \
            and self.fetched_through_ms <= eval_ms
        fetch_from = self.fetched_through_ms if warm else window_start
        fetched = fetch(self.spec.window.filters, fetch_from, eval_ms)
        if len(fetched) > self.max_buckets:
            raise WindowUnsupported(
                f"{len(fetched)} shard buckets >= hierarchical-reduce "
                f"fan-in — query path associates differently")
        if warm and len(fetched) != len(self.buckets):
            # the fan-out changed shape (shard set grew/shrank): the
            # per-bucket association no longer lines up — go cold
            self.reset()
            warm = False
            fetch_from = window_start
            fetched = fetch(self.spec.window.filters, fetch_from, eval_ms)
            if len(fetched) > self.max_buckets:
                raise WindowUnsupported("bucket blow-up on cold refetch")
        if not self.buckets:
            self.buckets = [_Bucket() for _ in fetched]
        new = 0
        for bucket, rows in zip(self.buckets, fetched):
            for tags, ts, vals in rows:
                key = tuple(sorted(tags.items()))
                buf = bucket.series.get(key)
                if buf is not None and buf.blocks:
                    keep = ts > buf.last_ts
                else:
                    keep = ts >= (fetch_from if warm else window_start)
                ts, vals = ts[keep], vals[keep]
                if not len(ts):
                    continue
                if buf is None:
                    buf = bucket.series[key] = _SeriesBuffer(dict(tags))
                buf.append(ts, vals, self.block_ms)
                new += len(ts)
        self.samples_consumed += new
        self.fetched_through_ms = eval_ms
        total = 0
        for bucket in self.buckets:
            for buf in bucket.series.values():
                buf.evict_before(window_start, self.block_ms)
                if not buf.blocks:
                    # tombstone: keep the slot (and its association
                    # order), drop the payload
                    buf.last_ts = -(1 << 62)
            total += len(bucket.series)
        if total > _MAX_SERIES:
            raise WindowUnsupported(
                f"{total} resident series exceeds the state backstop")

    def tick(self, eval_ms: int, fetch, group_limit: int = 100_000,
             device="cuda", step_ms: int = 1000):
        """Consume the delta and produce the aggregated
        :class:`~filodb_tpu_torch.query.model.PeriodicBatch` at
        ``eval_ms`` on ``device`` (None when no series holds data), via
        the normal aggregator map -> AggPartialBatch reduce -> present
        chain.  The batch's one step carries ``step_ms``, the step of the
        plan it answers (a one-step range, such as a router's stitch leg,
        must stitch with its other legs); the length changes no value."""
        from filodb_tpu_torch.query.aggregators import aggregator_for
        from filodb_tpu_torch.query.model import PeriodicBatch
        self._consume(eval_ms, fetch)
        window_start = eval_ms - self.spec.window.window_ms
        steps = StepRange(eval_ms, eval_ms, step_ms)
        agg = aggregator_for(self.spec.operator, device)
        partials = []
        for bucket in self.buckets:
            keys, ts_list, val_list = [], [], []
            for buf in bucket.series.values():
                if not buf.blocks:
                    continue
                ts, vals = buf.window_rows(window_start, eval_ms)
                if not len(ts):
                    continue
                keys.append(buf.tags)
                ts_list.append(ts)
                val_list.append(vals)
            if not keys:
                continue
            values = _window_values(keys, ts_list, val_list, steps,
                                    self.spec.window, device)
            pb = PeriodicBatch(keys, steps, values)
            partials.append(agg.map(pb, self.spec.by, self.spec.without,
                                    (), group_limit))
        if not partials:
            return None
        return agg.present(agg.reduce(partials))
