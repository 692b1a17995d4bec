"""RangeVectorTransformers: batch -> batch functions applied on top of an
ExecPlan's own result (reference: query/exec/RangeVectorTransformer.scala:56-430,
PeriodicSamplesMapper.scala:27, AggrOverRangeVectors.scala:74-122).

Value math runs in torch on the ExecContext's memstore device
(:func:`model.ctx_device`), where every batch of the query lives.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional

import numpy as np
import torch

from filodb_tpu_torch.ops import histogram_ops, instant as instant_ops
from filodb_tpu_torch.ops.grid import m4_bin_width, m4_grid
from filodb_tpu_torch.ops.windows import StepRange, value_dtype
from filodb_tpu_torch.query import rangefns
from filodb_tpu_torch.query.aggregators import AggPartialBatch, aggregator_for
from filodb_tpu_torch.query.logical import (AggregationOperator,
                                            InstantFunctionId,
                                            MiscellaneousFunctionId,
                                            RangeFunctionId, SortFunctionId)
from filodb_tpu_torch.query.model import (PeriodicBatch, QueryError, RawBatch,
                                          ScalarResult, ctx_device, to_numpy,
                                          to_tensor)
from filodb_tpu_torch.utils.observability import downsample_metrics


class RangeVectorTransformer:
    def apply(self, batches: list, ctx) -> list:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


def effective_window_ms(window_ms, stale_ms: int = 300_000) -> int:
    """The lookback actually scanned: the explicit range-function window,
    or the staleness lookback for bare instant selectors.  The single
    home of this substitution — the general path and the grid fast path
    must agree on it."""
    return window_ms if window_ms else stale_ms


@dataclasses.dataclass
class PeriodicSamplesMapper(RangeVectorTransformer):
    """Raw irregular samples -> regular-step samples, optionally through a
    windowed range function (reference: PeriodicSamplesMapper.scala:27).
    ``offset_ms`` shifts the window into the past while reporting at the
    query grid."""

    start_ms: int
    step_ms: int
    end_ms: int
    window_ms: Optional[int] = None
    function: Optional[RangeFunctionId] = None
    function_args: tuple = ()
    offset_ms: int = 0
    stale_ms: int = 300_000  # staleness lookback for instant selectors

    @property
    def effective_window_ms(self) -> int:
        return effective_window_ms(self.window_ms, self.stale_ms)

    @property
    def well_formed(self) -> bool:
        """False for half-specified windowing (window without function or
        vice versa) — fast paths must decline and let apply() decide."""
        return (self.window_ms is None) == (self.function is None)

    def step_ranges(self) -> tuple[StepRange, StepRange]:
        """(compute steps, report steps): ``offset`` shifts the scanned
        windows into the past while results are reported at the query
        grid."""
        steps = StepRange(self.start_ms - self.offset_ms,
                          self.end_ms - self.offset_ms, self.step_ms)
        report = StepRange(self.start_ms, self.end_ms, self.step_ms)
        return steps, report

    def apply(self, batches, ctx):
        out = []
        steps, report = self.step_ranges()
        window = self.effective_window_ms
        for b in batches:
            if isinstance(b, (PeriodicBatch, AggPartialBatch)):
                # the leaf already stepped (or even aggregated) this batch
                # from the device grid
                out.append(b)
                continue
            if not isinstance(b, RawBatch):
                raise QueryError("", f"PeriodicSamplesMapper over "
                                     f"{type(b).__name__}")
            if b.batch is None or not b.keys:
                continue
            vals = rangefns.apply_range_function(
                b.batch, steps, window, self.function, self.function_args,
                device=ctx_device(ctx))
            if vals.ndim == 3:  # histogram result [S,T,B]
                out.append(PeriodicBatch(
                    b.keys, report, torch.full(vals.shape[:2], float("nan"),
                                               dtype=vals.dtype,
                                               device=vals.device),
                    hist=vals, bucket_tops=np.asarray(b.batch.bucket_tops)))
            else:
                out.append(PeriodicBatch(b.keys, report, vals))
        return out


def _resolve(a, ctx):
    """Scalar argument: float | ScalarResult | ExecPlan producing a scalar
    (the reference's ExecPlanFuncArgs evaluated at run time)."""
    if hasattr(a, "execute") and ctx is not None:  # ExecPlan
        res = a.execute(ctx)
        return res.batches[0] if res.batches else ScalarResult(
            None, torch.tensor([float("nan")]))
    return a


def _scalar_arg(args, i) -> float:
    a = args[i]
    if isinstance(a, ScalarResult):
        return float(to_numpy(a.values).ravel()[0])
    return float(a)


def _eval_arg(a, like: torch.Tensor):
    if isinstance(a, ScalarResult):
        return to_tensor(a.values, like.device).to(like.dtype)
    return float(a)


@dataclasses.dataclass
class InstantVectorFunctionMapper(RangeVectorTransformer):
    function: InstantFunctionId
    args: tuple = ()

    def apply(self, batches, ctx):
        fid = self.function
        # resolve ExecPlan-valued args ONCE, not once per batch (they may be
        # whole scalar subqueries, reference: ExecPlanFuncArgs)
        resolved = [_resolve(a, ctx) for a in self.args]
        dev = ctx_device(ctx)
        out = []
        for b in batches:
            if fid in (InstantFunctionId.HISTOGRAM_QUANTILE,
                       InstantFunctionId.HISTOGRAM_MAX_QUANTILE,
                       InstantFunctionId.HISTOGRAM_BUCKET):
                h = to_tensor(b.hist, dev)
                x = _scalar_arg(resolved, 0)
                if fid == InstantFunctionId.HISTOGRAM_QUANTILE:
                    vals = histogram_ops.hist_quantile(b.bucket_tops, h, x)
                elif fid == InstantFunctionId.HISTOGRAM_MAX_QUANTILE:
                    vals = histogram_ops.hist_max_quantile(
                        b.bucket_tops, h, to_tensor(b.values, h.device), x)
                else:
                    vals = histogram_ops.hist_bucket(b.bucket_tops, h, x)
                out.append(PeriodicBatch(b.keys, b.steps, vals))
            else:
                fn = instant_ops.INSTANT_FUNCTIONS[fid.value]
                v = to_tensor(b.values, dev)
                args = [_eval_arg(a, v) for a in resolved]
                out.append(PeriodicBatch(b.keys, b.steps, fn(v, *args)))
        return out


_MIRROR = {"GTR": "LSS", "LSS": "GTR", "GTE": "LTE", "LTE": "GTE",
           "EQL": "EQL", "NEQ": "NEQ"}


@dataclasses.dataclass
class ScalarOperationMapper(RangeVectorTransformer):
    """vector <op> scalar / scalar <op> vector (reference:
    ScalarOperationMapper, RangeVectorTransformer.scala:193).  ``operator``
    is a BinaryOperator enum *name* ("ADD", "GTR", ...)."""

    operator: str
    scalar: object  # float | ScalarResult | ExecPlan
    scalar_on_lhs: bool = False
    bool_mode: bool = False

    def apply(self, batches, ctx):
        scalar = _resolve(self.scalar, ctx)
        is_cmp = self.operator in _MIRROR
        out = []
        for b in batches:
            v = b.values_t()
            sval = _eval_arg(scalar, v)
            if is_cmp and self.scalar_on_lhs and not self.bool_mode:
                # `s < vec` filters on the VECTOR value: mirror to `vec > s`
                res = instant_ops.apply_binary(_MIRROR[self.operator], v,
                                               sval, False)
            elif self.scalar_on_lhs:
                res = instant_ops.apply_binary(self.operator, sval, v,
                                               self.bool_mode)
            else:
                res = instant_ops.apply_binary(self.operator, v, sval,
                                               self.bool_mode)
            # arithmetic and bool-mode comparisons drop the metric name;
            # filtering comparisons keep the input series identity
            keys = b.keys if is_cmp and not self.bool_mode \
                else _drop_metric(b.keys)
            out.append(PeriodicBatch(keys, b.steps, res, b.hist,
                                     b.bucket_tops))
        return out


def _drop_metric(keys: list[dict]) -> list[dict]:
    return [{k: v for k, v in t.items() if k != "_metric_"} for t in keys]


@dataclasses.dataclass
class AggregateMapReduce(RangeVectorTransformer):
    """Shard-local map+partial-reduce (reference: AggregateMapReduce,
    AggrOverRangeVectors.scala:74-120).  Emits AggPartialBatch for the
    ReduceAggregateExec above."""

    operator: AggregationOperator
    params: tuple = ()
    by: tuple = ()
    without: tuple = ()

    def apply(self, batches, ctx):
        agg = aggregator_for(self.operator, ctx_device(ctx))
        limit = ctx.query_context.group_by_cardinality_limit
        parts = [agg.map(b, self.by, self.without, self.params, limit)
                 for b in batches if isinstance(b, PeriodicBatch) and b.keys]
        # device-grid leaves may emit already-aggregated partials
        # (exec._try_grid_aggregated); merge them rather than re-mapping
        pre = [b for b in batches if isinstance(b, AggPartialBatch)]
        for p in pre:
            if len(p.group_keys) > limit:
                raise QueryError(
                    "", f"group-by cardinality {len(p.group_keys)} "
                        f"exceeds limit {limit}")
        parts = pre + parts
        if not parts:
            return []
        if len(parts) == 1:
            return parts
        return [agg.reduce(parts)]


@dataclasses.dataclass
class AggregatePresenter(RangeVectorTransformer):
    operator: AggregationOperator
    params: tuple = ()

    def apply(self, batches, ctx):
        agg = aggregator_for(self.operator, ctx_device(ctx))
        return [agg.present(b) if isinstance(b, AggPartialBatch) else b
                for b in batches]


@dataclasses.dataclass
class MiscellaneousFunctionMapper(RangeVectorTransformer):
    function: MiscellaneousFunctionId
    args: tuple = ()

    def apply(self, batches, ctx):
        fid = self.function
        out = []
        for b in batches:
            if fid == MiscellaneousFunctionId.LABEL_REPLACE:
                dst, repl, src, regex = self.args[:4]
                rx = re.compile(regex)
                keys = []
                for t in b.keys:
                    t2 = dict(t)
                    m = rx.fullmatch(t.get(src, ""))
                    if m:
                        val = m.expand(_prom_template(repl))
                        if val:
                            t2[dst] = val
                        else:
                            t2.pop(dst, None)
                    keys.append(t2)
                out.append(dataclasses.replace(b, keys=keys))
            elif fid == MiscellaneousFunctionId.LABEL_JOIN:
                dst, sep, *srcs = self.args
                keys = []
                for t in b.keys:
                    t2 = dict(t)
                    val = sep.join(t.get(s, "") for s in srcs)
                    if val:
                        t2[dst] = val
                    else:
                        t2.pop(dst, None)
                    keys.append(t2)
                out.append(dataclasses.replace(b, keys=keys))
            elif fid == MiscellaneousFunctionId.HIST_TO_PROM_VECTORS:
                out.append(_hist_to_prom_series(b))
            else:
                raise QueryError("", f"unsupported misc function {fid}")
        return out


def _prom_template(repl: str) -> str:
    """PromQL $1 -> python regex \\1 template."""
    return re.sub(r"\$(\d+)", r"\\\1", repl)


def _hist_to_prom_series(b: PeriodicBatch) -> PeriodicBatch:
    """Explode histogram series into per-bucket le-labelled series
    (reference: HistToPromSeriesMapper, RangeVectorTransformer.scala:409)."""
    if b.hist is None:
        return b
    h = to_tensor(b.hist)
    S = len(b.keys)  # hist rows beyond the keys are series padding
    _, T, B = h.shape
    tops = np.asarray(b.bucket_tops)
    keys = []
    for s in range(S):
        for j in range(B):
            t2 = dict(b.keys[s])
            t2["le"] = "+Inf" if np.isinf(tops[j]) else _fmt(tops[j])
            keys.append(t2)
    return PeriodicBatch(keys, b.steps, h[:S].permute(0, 2, 1).reshape(
        S * B, T))


def _fmt(v: float) -> str:
    return str(int(v)) if float(v) == int(v) else repr(float(v))


@dataclasses.dataclass
class SortFunctionMapper(RangeVectorTransformer):
    function: SortFunctionId

    def apply(self, batches, ctx):
        out = []
        desc = self.function == SortFunctionId.SORT_DESC
        for b in batches:
            if not isinstance(b, PeriodicBatch) or not b.keys:
                out.append(b)
                continue
            v = b.values_t()
            # sort by the mean of the finite values (reference sorts by
            # average value like Prometheus's instant sort)
            key = torch.nanmean(v, dim=1)
            key = torch.where(torch.isnan(key),
                              float("inf") if desc else float("-inf"), key)
            order = torch.argsort(-key if desc else key, stable=True)
            pos = to_numpy(order).tolist()
            hist = None if b.hist is None \
                else to_tensor(b.hist)[:len(b.keys)][order.to(
                    to_tensor(b.hist).device)]
            out.append(PeriodicBatch([b.keys[i] for i in pos], b.steps,
                                     v[order], hist, b.bucket_tops))
        return out


@dataclasses.dataclass
class AbsentFunctionMapper(RangeVectorTransformer):
    """absent(expr): 1 when no series present (reference:
    AbsentFunctionMapper, RangeVectorTransformer.scala:344)."""

    filters: tuple = ()
    start_ms: int = 0
    step_ms: int = 1
    end_ms: int = 0

    def apply(self, batches, ctx):
        steps = None
        present: Optional[torch.Tensor] = None
        for b in batches:
            if isinstance(b, PeriodicBatch):
                steps = b.steps
                p = torch.isfinite(b.values_t()).any(dim=0)
                present = p if present is None \
                    else (present | p.to(present.device))
        if steps is None:
            dev = ctx_device(ctx)
            steps = StepRange(self.start_ms, self.end_ms,
                              max(self.step_ms, 1))
            present = torch.zeros(steps.num_steps, dtype=torch.bool,
                                  device=dev)
            dtype = value_dtype(dev)
        else:
            dtype = value_dtype(present.device)
        one = torch.ones(present.shape, dtype=dtype, device=present.device)
        vals = torch.where(present, float("nan"), one)[None, :]
        key = {f.column: f.filter.value for f in self.filters
               if type(f.filter).__name__ == "Equals"
               and f.column != "_metric_"}
        return [PeriodicBatch([key], steps, vals)]


@dataclasses.dataclass
class ScalarFunctionMapper(RangeVectorTransformer):
    """scalar(vector): single-series vector -> per-step scalar (NaN when 0
    or >1 series) (reference: ScalarFunctionMapper)."""

    def apply(self, batches, ctx):
        series = [b for b in batches
                  if isinstance(b, PeriodicBatch) and b.keys]
        total = sum(b.num_series for b in series)
        if total == 1:
            b = series[0]
            return [ScalarResult(b.steps, b.values_t()[0])]
        steps = series[0].steps if series else None
        if steps is None:
            for b in batches:
                if hasattr(b, "steps"):
                    steps = b.steps
        n = steps.num_steps if steps else 0
        dev = ctx_device(ctx)
        return [ScalarResult(steps, torch.full((n,), float("nan"),
                                               dtype=value_dtype(dev),
                                               device=dev))]


@dataclasses.dataclass
class VectorFunctionMapper(RangeVectorTransformer):
    """vector(scalar): scalar -> one labelless series."""

    def apply(self, batches, ctx):
        return [PeriodicBatch([{}], b.steps, to_tensor(b.values)[None, :])
                if isinstance(b, ScalarResult) else b for b in batches]


@dataclasses.dataclass
class StitchRvsMapper(RangeVectorTransformer):
    """Merge same-key series split across time (reference:
    StitchRvsExec.scala:13,61): children may cover different sub-ranges
    of one step grid (raw-vs-rolled routing, time splits); their values
    go onto the UNION grid, each placed by its step offset, and a NaN
    slot fills from a later child.  The merge runs on the ExecContext's
    device in the children's promoted dtype; nothing is read back."""

    def apply(self, batches, ctx):
        pbs = [b for b in batches if isinstance(b, PeriodicBatch)]
        if not pbs:
            return []
        step = pbs[0].steps.step
        for b in pbs:
            if b.steps.step != step:
                raise ValueError(
                    f"cannot stitch mismatched steps {b.steps.step} != {step}")
        start = min(b.steps.start for b in pbs)
        end = max(b.steps.end for b in pbs)
        union = StepRange(start, end, step)
        n = union.num_steps
        dev = ctx_device(ctx)
        vals = [to_tensor(b.values_t(), dev) for b in pbs]
        dtype = value_dtype(dev)
        for v in vals:
            dtype = torch.promote_types(dtype, v.dtype)
        rows: dict[tuple, int] = {}
        order: list[tuple] = []
        placed = []
        for b, v in zip(pbs, vals):
            idx = []
            for t in b.keys:
                k = tuple(sorted(t.items()))
                if k not in rows:
                    rows[k] = len(order)
                    order.append(k)
                idx.append(rows[k])
            placed.append(idx)
        merged = torch.full((len(order), n), float("nan"), dtype=dtype,
                            device=dev)
        for b, v, idx in zip(pbs, vals, placed):
            off = (b.steps.start - start) // step
            m = b.steps.num_steps
            v = v.to(dtype)
            if len(set(idx)) != len(idx):
                # a key twice in one child: in order, first value wins
                for i, r in enumerate(idx):
                    seg = merged[r, off:off + m]
                    merged[r, off:off + m] = torch.where(torch.isnan(seg),
                                                         v[i], seg)
                continue
            ix = torch.as_tensor(idx, dtype=torch.int64, device=dev)
            seg = merged[ix, off:off + m]
            merged[ix, off:off + m] = torch.where(torch.isnan(seg), v, seg)
        return [PeriodicBatch([dict(k) for k in order], union, merged)]


@dataclasses.dataclass
class DownsampleMapper(RangeVectorTransformer):
    """?downsample=<pixels>: M4 visualization downsampling as the
    OUTERMOST transformer — per series, per pixel bin, keep only the
    min/max/first/last samples (<= 4 x pixels points), which is
    everything a panel that wide can render (arXiv:2307.05389).

    The kept points stay on the original step grid: non-selected steps
    become NaN and the dense batch shape is unchanged.  The selection
    planes come from :func:`ops.grid.m4_grid`, run on the device of the
    ExecContext's memstore; the per-step selection that follows runs on
    the host, in float32, and the thinned result is a host array (this
    transformer is the last before the API edge).  Its three stages are
    noted on the ExecContext: ``downsample_m4`` (time-major copy, kernel,
    planes read back; it also waits for the work queued before it),
    ``downsample_readback`` (the values) and ``downsample_select``."""

    pixels: int

    def apply(self, batches, ctx):
        out = []
        for b in batches:
            if not isinstance(b, PeriodicBatch) or b.hist is not None \
                    or b.num_series == 0 \
                    or b.steps.num_steps <= self.pixels:
                out.append(b)   # already at panel resolution (or not
                continue        # a plain matrix): nothing to thin
            dev = ctx_device(ctx) if ctx is not None \
                else to_tensor(b.values).device
            t0 = time.perf_counter()
            vals_t = to_tensor(b.values)[:b.num_series].to(
                device=dev, dtype=torch.float32)
            planes = to_numpy(m4_grid(vals_t.T.contiguous(), self.pixels))
            t1 = time.perf_counter()
            vals = to_numpy(vals_t)                        # [S, T]
            t2 = time.perf_counter()
            ns, nsteps = vals.shape
            w = m4_bin_width(nsteps, self.pixels)
            # local bin indices -> global step indices; -1 marks empty
            idx = planes[:, 4:8, :].astype(np.int64)      # [P, 4, S]
            keep = idx >= 0
            idx = idx + (np.arange(self.pixels) * w)[:, None, None]
            sel = np.zeros((ns, nsteps), bool)
            s_ix = np.broadcast_to(np.arange(ns)[None, None, :], idx.shape)
            sel[s_ix[keep], np.minimum(idx[keep], nsteps - 1)] = True
            points_in = int(np.isfinite(vals).sum())
            points_out = int(sel.sum())
            thinned = np.where(sel, vals, np.nan)
            if ctx is not None:
                ctx.note_timing("downsample_m4", t1 - t0)
                ctx.note_timing("downsample_readback", t2 - t1)
                ctx.note_timing("downsample_select",
                                time.perf_counter() - t2)
                ctx.note_downsample(points_in=points_in,
                                    points_out=points_out)
            m = downsample_metrics()
            m["points_in"].inc(points_in)
            m["points_out"].inc(points_out)
            out.append(PeriodicBatch(b.keys, b.steps, thinned))
        return out
