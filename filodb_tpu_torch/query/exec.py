"""ExecPlan tree: scatter-gather physical plans.

Mirrors the reference's ExecPlan machinery (reference: query/src/main/scala/
filodb/query/exec/ExecPlan.scala:40,278,337): ``execute`` = do_execute then
apply transformers then enforce limits; non-leaf plans dispatch children
via their PlanDispatcher and compose.  Children run in-process.

The data leaf, :class:`MultiSchemaPartitionsExec`, tries the memstore's
device grid first (``shard.scan_grid`` / ``scan_grid_grouped``, the grid
kernels) and otherwise scans a padded batch (``shard.scan_batch``) for the
general path: window functions, aggregators and instant functions in
torch on the memstore's device.  Both leave their results on that device
(:func:`model.ctx_device`); every plan above computes there too.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch import integrity
from filodb_tpu_torch.core.filters import ColumnFilter
from filodb_tpu_torch.ops import instant as instant_ops
from filodb_tpu_torch.ops.windows import StepRange, value_dtype
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.aggregators import (AggPartialBatch,
                                                aggregator_for, grouping_key)
from filodb_tpu_torch.query.logical import (AggregationOperator as Agg,
                                            BinaryOperator, Cardinality,
                                            ScalarFunctionId)
from filodb_tpu_torch.query.model import (PeriodicBatch, QueryContext,
                                          QueryError, QueryResult, QueryStats,
                                          RawBatch, ScalarResult,
                                          concat_periodic, ctx_device,
                                          to_tensor, unify)
from filodb_tpu_torch.query.transformers import (AggregateMapReduce,
                                                 PeriodicSamplesMapper,
                                                 RangeVectorTransformer,
                                                 StitchRvsMapper)
from filodb_tpu_torch.utils.observability import TRACER

# the ExecContext of the scan running on THIS thread: the grid seam
# attributes its device time, and the paging shard its page-ins, to the
# active query through it
_ACTIVE = threading.local()

# aggregate operator -> the grouped op the device grid reduces it with;
# the JAX package derives the same table from its mesh
# (filodb_tpu/parallel/meshgrid.py GRID_MESH_OPS): stddev/stdvar reduce
# the (sum, count, sum of squares) "moments" planes on the device.
GRID_AGG_OPS = {Agg.SUM: "sum", Agg.COUNT: "count", Agg.AVG: "avg",
                Agg.MIN: "min", Agg.MAX: "max", Agg.GROUP: "count",
                Agg.STDDEV: "moments", Agg.STDVAR: "moments"}


def active_exec_ctx() -> Optional["ExecContext"]:
    return getattr(_ACTIVE, "ctx", None)


@dataclasses.dataclass
class ExecContext:
    """What a plan needs to run locally: the data source + query knobs.
    The memstore's device is where the general path computes."""

    memstore: object        # memstore.memstore.TimeSeriesMemStore
    query_context: QueryContext = dataclasses.field(
        default_factory=QueryContext)
    parallelism: int = 8
    # quarantined-chunk exclusions noted by leaf scans anywhere in the
    # plan tree (children run concurrently but share this ctx); the root
    # folds the total into QueryStats for the partial-data warning
    _corrupt_excluded: int = 0
    # per-stage wall time and scan volume, noted by leaves and the
    # DownsampleMapper anywhere in the tree (children share this ctx);
    # the root folds the totals into its QueryResult's stats
    _timings: dict = dataclasses.field(default_factory=dict, repr=False)
    _counters: dict = dataclasses.field(default_factory=dict, repr=False)
    # sampled device seconds a program (utils/devicewatch.KERNEL_TIMER)
    _device_programs: dict = dataclasses.field(default_factory=dict,
                                               repr=False)
    # reentrant: the device ledger's finalizers note a residency delta
    # here, and one may run inside a GC that a counter update set off
    _lock: object = dataclasses.field(default_factory=threading.RLock,
                                      repr=False)

    def note_corrupt_excluded(self, n: int) -> None:
        with self._lock:
            self._corrupt_excluded += n

    def corrupt_excluded(self) -> int:
        return self._corrupt_excluded

    def note_timing(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._timings[stage] = self._timings.get(stage, 0.0) + seconds

    def _add(self, **counts) -> None:
        with self._lock:
            for k, v in counts.items():
                if v:
                    self._counters[k] = self._counters.get(k, 0) + v

    def note_counts(self, samples: int = 0, bytes_: int = 0,
                    chunks: int = 0, pages: int = 0,
                    hbm_dense: int = 0, hbm_compressed: int = 0,
                    hbm_hist: int = 0, hbm_delta: int = 0) -> None:
        """Scan volume; ``chunks``/``pages`` are the chunks and
        partitions the paging shard read back from the column store for
        this query; ``hbm_delta`` is signed: the device ledger credits
        the bytes it committed and debits those freed while this query
        was active."""
        self._add(samples=samples, bytes=bytes_, chunks=chunks,
                  pages=pages, hbm_dense=hbm_dense,
                  hbm_compressed=hbm_compressed, hbm_hist=hbm_hist,
                  hbm_delta=hbm_delta)

    def note_device_program(self, program: str, seconds: float) -> None:
        """Fold a sampled launch's measured device seconds into this
        query's per-program split (``QueryStats.device_programs``)."""
        with self._lock:
            d = self._device_programs
            d[program] = d.get(program, 0.0) + seconds

    def note_downsample(self, points_in: int = 0,
                        points_out: int = 0) -> None:
        """DownsampleMapper accounting: finite points entering the M4
        selection vs pixel-exact points kept."""
        self._add(ds_in=points_in, ds_out=points_out)

    def note_resultcache(self, cached: int = 0, recomputed: int = 0) -> None:
        """Result-cache accounting (query/resultcache.py): result
        samples served from memoized partials vs samples re-scanned on
        the fresh/miss path."""
        self._add(rc_cached=cached, rc_recomputed=recomputed)

    def note_cold(self, chunks: int = 0, bytes_: int = 0) -> None:
        """Cold-tier accounting: chunks/bytes this query pulled from the
        object bucket."""
        self._add(cold_chunks=chunks, cold_bytes=bytes_)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def absorb_stats_from(self, other: "ExecContext") -> None:
        """Fold a nested sub-context's accumulated accounting into this
        one (the result cache runs fresh segments / delta fetches with
        their own ctx so per-segment volumes are exact)."""
        st = QueryStats()
        other.fold_into(st)
        st.corrupt_chunks_excluded = other.corrupt_excluded()
        self.absorb_stats(st)

    def absorb_stats(self, stats: QueryStats) -> None:
        """Fold a child's returned stats into this query's accounting
        (children that share this ctx need no absorb)."""
        self.note_counts(samples=stats.samples_scanned,
                         chunks=stats.chunks_scanned,
                         bytes_=stats.bytes_scanned, pages=stats.pages_in,
                         hbm_dense=stats.hbm_read_bytes.get("dense", 0),
                         hbm_compressed=stats.hbm_read_bytes.get(
                             "compressed", 0),
                         hbm_hist=stats.hbm_read_bytes.get(
                             "compressed-hist", 0),
                         hbm_delta=stats.hbm_resident_delta_bytes)
        self.note_resultcache(cached=stats.resultcache_cached_samples,
                              recomputed=stats.resultcache_recomputed_samples)
        self.note_cold(chunks=stats.cold_chunks_paged,
                       bytes_=stats.cold_bytes_read)
        self.note_downsample(points_in=stats.downsample_points_in,
                             points_out=stats.downsample_points_out)
        if stats.corrupt_chunks_excluded:
            self.note_corrupt_excluded(stats.corrupt_chunks_excluded)
        for k, v in stats.timings.items():
            self.note_timing(k, v)
        for k, v in stats.device_programs.items():
            self.note_device_program(k, v)

    def fold_into(self, stats: QueryStats) -> None:
        """Write the accumulated totals into an outgoing QueryResult's
        stats (overwrite: the ctx holds running totals)."""
        with self._lock:
            c = self._counters
            stats.timings = dict(self._timings)
            stats.samples_scanned = c.get("samples", 0)
            stats.bytes_scanned = c.get("bytes", 0)
            stats.chunks_scanned = c.get("chunks", 0)
            stats.pages_in = c.get("pages", 0)
            stats.downsample_points_in = c.get("ds_in", 0)
            stats.downsample_points_out = c.get("ds_out", 0)
            stats.hbm_read_bytes = {
                k: c[ck] for k, ck in (("dense", "hbm_dense"),
                                       ("compressed", "hbm_compressed"),
                                       ("compressed-hist", "hbm_hist"))
                if c.get(ck)}
            stats.device_programs = dict(self._device_programs)
            stats.hbm_resident_delta_bytes = c.get("hbm_delta", 0)
            stats.resultcache_cached_samples = c.get("rc_cached", 0)
            stats.resultcache_recomputed_samples = c.get("rc_recomputed", 0)
            stats.cold_chunks_paged = c.get("cold_chunks", 0)
            stats.cold_bytes_read = c.get("cold_bytes", 0)


class PlanDispatcher:
    """Moves an ExecPlan to where its data lives (reference:
    PlanDispatcher.scala:20 — InProcessPlanDispatcher)."""

    def dispatch(self, plan: "ExecPlan", ctx: ExecContext) -> QueryResult:
        raise NotImplementedError


class InProcessDispatcher(PlanDispatcher):
    def dispatch(self, plan, ctx):
        with TRACER.span("dispatch.inprocess", plan=type(plan).__name__):
            return plan.execute(ctx)


IN_PROCESS = InProcessDispatcher()


class ExecPlan:
    def __init__(self, query_context: Optional[QueryContext] = None,
                 dispatcher: PlanDispatcher = IN_PROCESS):
        self.query_context = query_context or QueryContext()
        self.dispatcher = dispatcher
        self.transformers: list[RangeVectorTransformer] = []

    def add_transformer(self, t: RangeVectorTransformer) -> "ExecPlan":
        self.transformers.append(t)
        return self

    @property
    def children(self) -> Sequence["ExecPlan"]:
        return ()

    def do_execute(self, ctx: ExecContext) -> list:
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> QueryResult:
        # deadline tripwire: one clock read a plan node, so that a deep
        # scatter-gather stops the moment its end-to-end budget is gone
        # (reference: queryTimeoutMillis checked inside ExecPlan
        # execution); DeadlineExceeded is a QueryError
        qctx = self.query_context
        if qctx.deadline_ms:
            from filodb_tpu_torch.workload import deadline as dl
            dl.check(qctx, where=type(self).__name__)
        # one span per plan node (reference: Kamon.spanBuilder in
        # ExecPlan.execute, ExecPlan.scala:99-126); tags carry the plan
        # type and, for data leaves, dataset/shard
        tags = {"plan": type(self).__name__}
        ds = getattr(self, "dataset", None)
        if ds is not None:
            tags["dataset"] = ds
            tags["shard"] = getattr(self, "shard", "")
        try:
            with TRACER.span("execplan.execute", **tags):
                batches = self.do_execute(ctx)
                for t in self.transformers:
                    batches = t.apply(batches, ctx)
                self._enforce_limits(batches, ctx)
                stats = QueryStats()
                for b in batches:
                    stats.series_scanned += getattr(b, "num_series", 0)
                # quarantined-chunk exclusions accumulate on the shared
                # ctx; the outermost plan returns last, so its result
                # carries the whole tree's total
                stats.corrupt_chunks_excluded = ctx.corrupt_excluded()
                ctx.fold_into(stats)
                return QueryResult(self.query_context.query_id, batches,
                                   stats)
        except QueryError:
            raise
        except Exception as e:  # noqa: BLE001 - plan failure surfaces as QueryError
            raise QueryError(self.query_context.query_id,
                             f"{type(self).__name__}: {e}") from e

    def _enforce_limits(self, batches, ctx):
        total = sum(len(b.keys) * b.steps.num_steps for b in batches
                    if isinstance(b, PeriodicBatch))
        if total > ctx.query_context.sample_limit:
            raise QueryError(
                self.query_context.query_id,
                f"result samples {total} > limit "
                f"{ctx.query_context.sample_limit}")


class LeafExecPlan(ExecPlan):
    pass


class NonLeafExecPlan(ExecPlan):
    def __init__(self, children: Sequence[ExecPlan],
                 query_context: Optional[QueryContext] = None,
                 dispatcher: PlanDispatcher = IN_PROCESS):
        super().__init__(query_context, dispatcher)
        self._children = list(children)

    @property
    def children(self) -> Sequence[ExecPlan]:
        return self._children

    def do_execute(self, ctx: ExecContext) -> list:
        return self.compose(self._dispatch_children(ctx), ctx)

    def _dispatch_children(self, ctx) -> list[QueryResult]:
        """Children run via their own dispatchers, concurrently (reference:
        NonLeafExecPlan.doExecute mapAsync, ExecPlan.scala:370-409).  The
        current span is captured here and re-attached on the pool threads
        so child spans parent onto this plan's span."""
        kids = self._children
        if len(kids) <= 1:
            return [c.dispatcher.dispatch(c, ctx) for c in kids]
        token = TRACER.capture()

        def run(c):
            with TRACER.attach(token):
                return c.dispatcher.dispatch(c, ctx)

        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(len(kids), ctx.parallelism)) as pool:
            futs = [pool.submit(run, c) for c in kids]
            return [f.result() for f in futs]

    def compose(self, results: list[QueryResult], ctx) -> list:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

class MultiSchemaPartitionsExec(LeafExecPlan):
    """Leaf scan: index lookup, then the device grid or a padded batch
    (reference: exec/MultiSchemaPartitionsExec.scala:27 +
    SelectRawPartitionsExec)."""

    def __init__(self, dataset: str, shard: int,
                 filters: Sequence[ColumnFilter], start_ms: int, end_ms: int,
                 column: Optional[str] = None,
                 query_context: Optional[QueryContext] = None,
                 dispatcher: PlanDispatcher = IN_PROCESS):
        super().__init__(query_context, dispatcher)
        self.dataset = dataset
        self.shard = shard
        self.filters = list(filters)
        self.start_ms = start_ms
        self.end_ms = end_ms
        self.column = column

    def do_execute(self, ctx: ExecContext) -> list:
        t0 = time.perf_counter()
        prev = getattr(_ACTIVE, "ctx", None)
        _ACTIVE.ctx = ctx
        try:
            shard = ctx.memstore.get_shard(self.dataset, self.shard)
            lookup = shard.lookup_partitions(self.filters, self.start_ms,
                                             self.end_ms)
            try:
                batches = self._do_scan(shard, lookup)
                self._note_batch_counts(ctx, batches)
                return batches
            finally:
                # AFTER the scan, so corruption detected by this very
                # query already counts toward its own partial-data count
                self._note_quarantined(ctx, shard, lookup.part_ids)
        finally:
            _ACTIVE.ctx = prev
            ctx.note_timing("scan", time.perf_counter() - t0)

    @staticmethod
    def _note_batch_counts(ctx: ExecContext, batches) -> None:
        """Scan-volume accounting from what the leaf actually returned."""
        samples = nbytes = 0
        for b in batches:
            if isinstance(b, PeriodicBatch):
                samples += len(b.keys) * b.steps.num_steps
                nbytes += to_tensor(b.values).nbytes
            elif isinstance(b, RawBatch) and b.batch is not None:
                samples += int(np.asarray(b.batch.row_counts).sum())
                nbytes += b.batch.values.nbytes
            elif isinstance(b, AggPartialBatch):
                nbytes += sum(to_tensor(v).nbytes for v in b.state.values())
        ctx.note_counts(samples=samples, bytes_=nbytes)

    @staticmethod
    def _grid_timed(fn, *args, **kw):
        """Run a device-grid serving call, attributing its wall time to
        the active query's device_compute stage."""
        ctx = active_exec_ctx()
        if ctx is None:
            return fn(*args, **kw)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            ctx.note_timing("device_compute", time.perf_counter() - t0)

    def _do_scan(self, shard, lookup) -> list:
        schema = None
        if lookup.first_schema_hash is not None:
            schema = shard.schemas.by_hash(lookup.first_schema_hash)
        column_id = None
        if self.column is not None and schema is not None:
            column_id = schema.data.column(self.column).id
        elif schema is not None:
            # schema-driven rewrites AFTER discovery, BEFORE scanning
            # (reference: MultiSchemaPartitionsExec.finalizePlan :41-85)
            served = self._try_schema_rewrite(shard, lookup.part_ids, schema)
            if served is not None:
                return served
        served = self._try_device_grid(shard, lookup.part_ids, column_id)
        if served is not None:
            return served
        tags, batch = shard.scan_batch(lookup.part_ids, self.start_ms,
                                       self.end_ms, column_id)
        return [RawBatch(tags, batch)]

    def _note_quarantined(self, ctx: ExecContext, shard, part_ids) -> None:
        """Partial-data tripwire: quarantined chunks among the scanned
        series AND overlapping this query's time range mean the result
        excludes data — now and on every re-query (quarantine persists
        until cleared).  A corrupt chunk outside the window excluded
        nothing from THIS result, so it must not count.  O(1) when the
        quarantine is empty, the common case."""
        if not integrity.QUARANTINE:
            return
        pks = []
        for pid in part_ids:
            try:
                pks.append(shard.index.partkey(int(pid)))
            except KeyError:
                continue
        n = integrity.QUARANTINE.count_overlapping(pks, self.start_ms,
                                                   self.end_ms)
        if n:
            ctx.note_corrupt_excluded(n)

    # -- downsample-gauge & hist-max schema rewrites ------------------------

    def _first_mapper(self):
        if not self.transformers:
            return None
        mapper = self.transformers[0]
        if not isinstance(mapper, PeriodicSamplesMapper) \
                or not mapper.well_formed:
            return None
        return mapper

    def _try_schema_rewrite(self, shard, part_ids, schema):
        """ds-gauge column selection + range-function swap, and hist+max
        column pairing (see :mod:`query.dsrewrite`).  Returns leaf batches
        (already stepped — the mapper passes them through) or None when
        no rewrite applies."""
        from filodb_tpu_torch.query import dsrewrite
        mapper = self._first_mapper()
        if mapper is None or len(part_ids) == 0:
            return None
        if dsrewrite.is_ds_gauge(schema.data):
            return self._execute_ds_gauge(shard, part_ids, schema, mapper)
        if dsrewrite.hist_max_column(schema.data) is not None:
            return self._execute_hist_max(shard, part_ids, schema, mapper)
        return None

    def _scan_stepped(self, shard, part_ids, steps, window_ms, func, cid,
                      fargs=()):
        """One column read + windowed range function, grid-served when
        possible: returns (tags, values, bucket_tops) with values
        [len(tags), T] ([len(tags), T, hb] for hist columns)."""
        from filodb_tpu_torch.query import rangefns
        got = self._grid_timed(shard.scan_grid, part_ids, func, steps.start,
                               steps.num_steps, steps.step, window_ms, cid,
                               fargs=fargs)
        if got is not None:
            return got
        tags, batch = shard.scan_batch(part_ids, self.start_ms, self.end_ms,
                                       cid)
        if batch is None or not tags:
            return None
        vals = rangefns.apply_range_function(
            batch, steps, window_ms, func, fargs,
            device=ctx_device(active_exec_ctx()))
        tops = np.asarray(batch.bucket_tops) if batch.hist is not None \
            else None
        # scan_batch pads the series axis; trim to the real tag rows so
        # paired two-column reads stay row-aligned
        return tags, vals[:len(tags)], tops

    @staticmethod
    def _align_pair(got_a, got_b):
        """Row-align two independently scanned planes by series tags (one
        may be grid-served, the other not; a partition evicted between
        the two scans drops a row from one side only)."""
        tags_a, va, tops_a = got_a
        tags_b, vb, _ = got_b
        va, vb = unify([va, vb], ctx_device(active_exec_ctx()))
        if tags_a == tags_b:
            return tags_a, va, vb, tops_a
        idx_b = {tuple(sorted(t.items())): i for i, t in enumerate(tags_b)}
        keep_a, keep_b, tags = [], [], []
        for i, t in enumerate(tags_a):
            j = idx_b.get(tuple(sorted(t.items())))
            if j is not None:
                keep_a.append(i)
                keep_b.append(j)
                tags.append(t)
        if not tags:
            return None
        return tags, va[keep_a], vb[keep_b], tops_a

    def _execute_ds_gauge(self, shard, part_ids, schema, mapper):
        from filodb_tpu_torch.query import dsrewrite
        from filodb_tpu_torch.query.logical import RangeFunctionId as F
        rw = dsrewrite.ds_gauge_rewrite(mapper.function)
        if rw is None:
            return None        # default avg column is already correct
        cols, func = rw
        steps, report = mapper.step_ranges()
        window = mapper.effective_window_ms
        if func is not None:
            cid = schema.data.column(cols[0]).id
            got = self._scan_stepped(shard, part_ids, steps, window, func,
                                     cid, tuple(mapper.function_args))
            if got is None:
                return []
            tags, vals, _ = got
            return [PeriodicBatch(tags, report, vals)]
        # AvgWithSumAndCountOverTime: sum(period sums) / sum(period counts)
        got_s = self._scan_stepped(shard, part_ids, steps, window,
                                   F.SUM_OVER_TIME,
                                   schema.data.column("sum").id)
        got_c = self._scan_stepped(shard, part_ids, steps, window,
                                   F.SUM_OVER_TIME,
                                   schema.data.column("count").id)
        if got_s is None or got_c is None:
            return []
        pair = self._align_pair(got_s, got_c)
        if pair is None:
            return []
        tags, sums, counts, _ = pair
        vals = torch.where(counts > 0, sums / counts,
                           torch.full_like(sums, float("nan")))
        return [PeriodicBatch(tags, report, vals)]

    def _execute_hist_max(self, shard, part_ids, schema, mapper):
        """Histogram schema with a max column: pair the hist function with
        the max column so histogram_max_quantile sees both planes
        (reference: histMaxRangeFunction — None -> LastSampleHistMax,
        sum_over_time -> SumAndMaxOverTime)."""
        from filodb_tpu_torch.query import dsrewrite
        from filodb_tpu_torch.query.logical import RangeFunctionId as F
        if mapper.function not in (None, F.SUM_OVER_TIME):
            return None        # rate/increase etc: hist column only
        steps, report = mapper.step_ranges()
        window = mapper.effective_window_ms
        max_func = None if mapper.function is None else F.MAX_OVER_TIME
        got_h = self._scan_stepped(shard, part_ids, steps, window,
                                   mapper.function,
                                   schema.data.value_column_id)
        if got_h is None:
            return []
        got_m = self._scan_stepped(shard, part_ids, steps, window, max_func,
                                   dsrewrite.hist_max_column(schema.data))
        if got_m is None:
            return []
        pair = self._align_pair(got_h, got_m)
        if pair is None:
            return []
        tags, hvals, mvals, tops = pair
        return [PeriodicBatch(tags, report, mvals, hist=hvals,
                              bucket_tops=tops)]

    # -- the device grid seams ---------------------------------------------

    def _try_device_grid(self, shard, part_ids, column_id):
        """Serve leaf + PeriodicSamplesMapper straight from the shard's
        device-resident grid (memstore/devicestore.py) when the first
        transformer is an eligible windowed function.  Emits the
        already-stepped PeriodicBatch; the mapper passes it through.
        When an AggregateMapReduce follows the mapper, the aggregation is
        reduced on the device too: only [G, T] partials come back."""
        if not self.transformers or len(part_ids) == 0:
            return None
        mapper = self.transformers[0]
        if not isinstance(mapper, PeriodicSamplesMapper) \
                or not mapper.well_formed:
            return None   # half-specified windowing: general path decides
        # bare instant selector: the staleness lookback is a
        # last-sample-in-window scan the grid serves directly
        window_ms = mapper.effective_window_ms
        steps, report = mapper.step_ranges()
        mapred = self.transformers[1] if len(self.transformers) > 1 else None
        if isinstance(mapred, AggregateMapReduce) and not mapred.params \
                and mapred.operator in GRID_AGG_OPS:
            served = self._try_grid_aggregated(shard, part_ids, column_id,
                                               mapper, mapred, steps, report,
                                               window_ms)
            if served is not None:
                return served
        got = self._grid_timed(shard.scan_grid, part_ids, mapper.function,
                               steps.start, steps.num_steps, steps.step,
                               window_ms, column_id,
                               fargs=tuple(mapper.function_args))
        if got is None:
            return None
        tags, vals, tops = got
        if vals.ndim == 3:      # histogram column: [S, T, hb] bucket planes
            return [PeriodicBatch(tags, report,
                                  torch.full(vals.shape[:2], float("nan"),
                                             dtype=vals.dtype,
                                             device=vals.device),
                                  hist=vals, bucket_tops=tops)]
        return [PeriodicBatch(tags, report, vals)]

    def _try_grid_aggregated(self, shard, part_ids, column_id, mapper,
                             mapred, steps, report, window_ms):
        union: dict[tuple, int] = {}
        if not mapred.by and not mapred.without:
            # global aggregate: one group, skip the per-series key walk
            union[()] = 0
            gids = [0] * len(part_ids)
        else:
            gids = []
            for pid in part_ids:
                part = shard.grid_partition(int(pid))
                if part is None:
                    return None
                key = tuple(sorted(grouping_key(part.tags, mapred.by,
                                                mapred.without).items()))
                gids.append(union.setdefault(key, len(union)))
        state = self._grid_timed(
            shard.scan_grid_grouped, part_ids, mapper.function, steps.start,
            steps.num_steps, steps.step, window_ms, gids,
            max(len(union), 1), GRID_AGG_OPS[mapred.operator], column_id,
            fargs=tuple(mapper.function_args))
        if state is None:
            return None
        # the fused path never materializes per-series batches, so the
        # scanned volume is accounted here
        ctx = active_exec_ctx()
        if ctx is not None:
            ctx.note_counts(samples=len(part_ids) * steps.num_steps)
        tops = state.pop("bucket_tops", None)
        return [AggPartialBatch(mapred.operator, (),
                                [dict(k) for k in union], report, state,
                                bucket_tops=tops)]


# ---------------------------------------------------------------------------
# Scalar leaves
# ---------------------------------------------------------------------------

def _scalar_row(vals, ctx) -> torch.Tensor:
    dev = ctx_device(ctx)
    return torch.as_tensor(vals, dtype=value_dtype(dev), device=dev)


class ScalarFixedDoubleExec(LeafExecPlan):
    def __init__(self, scalar: float, start_ms: int, step_ms: int, end_ms: int,
                 query_context=None, dispatcher: PlanDispatcher = IN_PROCESS):
        super().__init__(query_context, dispatcher)
        self.scalar = scalar
        self.steps = StepRange(start_ms, end_ms, step_ms)

    def do_execute(self, ctx):
        return [ScalarResult(self.steps, _scalar_row(
            np.full(self.steps.num_steps, self.scalar), ctx))]


class TimeScalarGeneratorExec(LeafExecPlan):
    """time(), hour(), minute()... as per-step scalars (reference:
    exec/TimeScalarGeneratorExec.scala:91)."""

    def __init__(self, function: ScalarFunctionId, start_ms: int, step_ms: int,
                 end_ms: int, query_context=None,
                 dispatcher: PlanDispatcher = IN_PROCESS):
        super().__init__(query_context, dispatcher)
        self.function = function
        self.steps = StepRange(start_ms, end_ms, step_ms)

    def do_execute(self, ctx):
        secs = np.asarray(self.steps.timestamps(), dtype=np.float64) / 1000.0
        if self.function == ScalarFunctionId.TIME:
            return [ScalarResult(self.steps, _scalar_row(secs, ctx))]
        fn = instant_ops.INSTANT_FUNCTIONS[self.function.value]
        # the reference feeds these functions the step times in
        # milliseconds while they read seconds, so hour() and its kin
        # come out wrong there; the port keeps its answers until the
        # reference is fixed (ROADMAP.md, Queue C)
        vals = fn(torch.as_tensor(secs[None, :] * 1000.0))[0]
        return [ScalarResult(self.steps, _scalar_row(vals, ctx))]


class EmptyResultExec(LeafExecPlan):
    """A leaf that answers nothing (reference: EmptyResultExec)."""

    def do_execute(self, ctx):
        return []


# ---------------------------------------------------------------------------
# Non-leaves
# ---------------------------------------------------------------------------

class ReduceAggregateExec(NonLeafExecPlan):
    """Cross-shard aggregation reduce (reference: ReduceAggregateExec,
    AggrOverRangeVectors.scala:19-66)."""

    def __init__(self, children, operator: Agg, params: tuple = (),
                 query_context=None, dispatcher: PlanDispatcher = IN_PROCESS):
        super().__init__(children, query_context, dispatcher)
        self.operator = operator
        self.params = params

    def compose(self, results, ctx):
        partials = [b for r in results for b in r.batches
                    if isinstance(b, AggPartialBatch)]
        presented = [b for r in results for b in r.batches
                     if not isinstance(b, AggPartialBatch)]
        if not partials:
            return presented
        return [aggregator_for(self.operator, ctx_device(ctx)).reduce(
            partials)] + presented


class DistConcatExec(NonLeafExecPlan):
    """Concatenate child results (reference: DistConcatExec.scala:12)."""

    def compose(self, results, ctx):
        return [b for r in results for b in r.batches]


class StitchRvsExec(NonLeafExecPlan):
    """Concat + stitch split series (reference: StitchRvsExec.scala:61):
    the children's batches merge onto their union step grid on the
    ExecContext's device."""

    def compose(self, results, ctx):
        batches = [b for r in results for b in r.batches]
        return StitchRvsMapper().apply(batches, ctx)


def _join_key(tags: dict, on: tuple, ignoring: tuple) -> tuple:
    if on:
        return tuple((k, tags.get(k, "")) for k in sorted(on))
    drop = set(ignoring) | {"_metric_", "__name__"}
    return tuple(sorted((k, v) for k, v in tags.items() if k not in drop))


def _sides(results, lhs_count: int, device):
    return [concat_periodic([b for r in rs for b in r.batches
                             if isinstance(b, PeriodicBatch)], device)
            for rs in (results[:lhs_count], results[lhs_count:])]


class BinaryJoinExec(NonLeafExecPlan):
    """Hash join on `on`/`ignoring` labels (reference:
    BinaryJoinExec.scala:37).  lhs children come first in the children
    list; ``lhs_count`` splits them."""

    def __init__(self, children, lhs_count: int, operator: BinaryOperator,
                 cardinality: Cardinality = Cardinality.ONE_TO_ONE,
                 on: tuple = (), ignoring: tuple = (), include: tuple = (),
                 query_context=None, dispatcher: PlanDispatcher = IN_PROCESS,
                 bool_mode: bool = False):
        super().__init__(children, query_context, dispatcher)
        self.lhs_count = lhs_count
        self.operator = operator
        self.cardinality = cardinality
        self.on = tuple(on)
        self.ignoring = tuple(ignoring)
        self.include = tuple(include)
        self.bool_mode = bool_mode

    def compose(self, results, ctx):
        lhs_b, rhs_b = _sides(results, self.lhs_count, ctx_device(ctx))
        if lhs_b is None or rhs_b is None:
            return []
        lv, rv = unify([lhs_b.values_t(), rhs_b.values_t()], ctx_device(ctx))
        # hash side = the "one" side (reference puts smaller on build side)
        rkeys: dict[tuple, int] = {}
        for i, t in enumerate(rhs_b.keys):
            k = _join_key(t, self.on, self.ignoring)
            if k in rkeys and self.cardinality == Cardinality.ONE_TO_ONE:
                raise QueryError(self.query_context.query_id,
                                 "duplicate series on right side of join")
            rkeys.setdefault(k, i)
        out_keys, li, ri = [], [], []
        seen: set[tuple] = set()
        for i, t in enumerate(lhs_b.keys):
            k = _join_key(t, self.on, self.ignoring)
            j = rkeys.get(k)
            if j is None:
                continue
            if self.cardinality == Cardinality.ONE_TO_ONE:
                if k in seen:
                    raise QueryError(self.query_context.query_id,
                                     "duplicate series on left side of join")
                seen.add(k)
            out_keys.append(self._result_key(t, rhs_b.keys[j]))
            li.append(i)
            ri.append(j)
        if not li:
            return [PeriodicBatch([], lhs_b.steps, lv[:0])]
        vals = instant_ops.apply_binary(self.operator.name, lv[li], rv[ri],
                                        self.bool_mode)
        return [PeriodicBatch(out_keys, lhs_b.steps, vals)]

    def _result_key(self, lt: dict, rt: dict) -> dict:
        if self.operator.is_comparison:
            if self.bool_mode:  # bool comparisons drop the metric name
                return {k: v for k, v in lt.items()
                        if k not in ("_metric_", "__name__")}
            return dict(lt)
        if self.on:
            key = {k: lt.get(k, "") for k in self.on if k in lt}
        else:
            drop = set(self.ignoring) | {"_metric_", "__name__"}
            key = {k: v for k, v in lt.items() if k not in drop}
        for k in self.include:
            if k in rt:
                key[k] = rt[k]
        return key


class SetOperatorExec(NonLeafExecPlan):
    """and/or/unless set operators (reference: SetOperatorExec.scala:31)."""

    def __init__(self, children, lhs_count: int, operator: BinaryOperator,
                 on: tuple = (), ignoring: tuple = (),
                 query_context=None, dispatcher: PlanDispatcher = IN_PROCESS):
        super().__init__(children, query_context, dispatcher)
        self.lhs_count = lhs_count
        self.operator = operator
        self.on = tuple(on)
        self.ignoring = tuple(ignoring)

    def compose(self, results, ctx):
        lhs_b, rhs_b = _sides(results, self.lhs_count, ctx_device(ctx))
        op = self.operator
        if lhs_b is None:
            if op == BinaryOperator.LOR and rhs_b is not None:
                return [rhs_b]
            return []
        if rhs_b is None:
            return [] if op == BinaryOperator.LAND else [lhs_b]

        def jk(t):
            return _join_key(t, self.on, self.ignoring)

        rset = {jk(t) for t in rhs_b.keys}
        lv = to_tensor(lhs_b.values_t(), ctx_device(ctx))
        if op in (BinaryOperator.LAND, BinaryOperator.LUNLESS):
            want = op == BinaryOperator.LAND
            idx = [i for i, t in enumerate(lhs_b.keys)
                   if (jk(t) in rset) == want]
            return [PeriodicBatch([lhs_b.keys[i] for i in idx], lhs_b.steps,
                                  lv[idx])]
        # or: all of lhs + rhs series whose join key is not present on lhs
        lset = {jk(t) for t in lhs_b.keys}
        ridx = [i for i, t in enumerate(rhs_b.keys) if jk(t) not in lset]
        lv, rv = unify([lv, rhs_b.values_t()], ctx_device(ctx))
        keys = list(lhs_b.keys) + [rhs_b.keys[i] for i in ridx]
        return [PeriodicBatch(keys, lhs_b.steps, torch.cat([lv, rv[ridx]]))]


class ScalarBinaryOperationExec(LeafExecPlan):
    """Pure scalar arithmetic tree (reference:
    ScalarBinaryOperationExec.scala)."""

    def __init__(self, operator: BinaryOperator, lhs, rhs,
                 start_ms: int, step_ms: int, end_ms: int,
                 query_context=None, dispatcher: PlanDispatcher = IN_PROCESS):
        super().__init__(query_context, dispatcher)
        self.operator = operator
        self.lhs = lhs
        self.rhs = rhs
        self.steps = StepRange(start_ms, end_ms, step_ms)

    def _eval(self, side, ctx) -> torch.Tensor:
        if isinstance(side, (int, float)):
            return _scalar_row(np.full(self.steps.num_steps, float(side)),
                               ctx)
        if isinstance(side, lp.ScalarBinaryOperation):
            # nested scalar expression: evaluate inline
            return instant_ops.apply_binary(
                side.operator.name, self._eval(side.lhs, ctx),
                self._eval(side.rhs, ctx), False)
        if isinstance(side, lp.ScalarFixedDoublePlan):
            return self._eval(float(side.scalar), ctx)
        if isinstance(side, ExecPlan):
            return to_tensor(side.execute(ctx).batches[0].values,
                             ctx_device(ctx))
        raise QueryError("", f"bad scalar operand {side}")

    def do_execute(self, ctx):
        lv, rv = unify([self._eval(self.lhs, ctx), self._eval(self.rhs, ctx)],
                       ctx_device(ctx))
        return [ScalarResult(self.steps, instant_ops.apply_binary(
            self.operator.name, lv, rv, False))]
