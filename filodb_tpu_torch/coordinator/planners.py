"""Time-range planning: split a query where its data changes home.

Capability match for the reference's planner pieces the rollup router
and the result cache stand on (reference: coordinator/.../queryplanner/):
- LogicalPlanUtils.scala:238 copyWithUpdatedTimeRange;
- LongTimeRangePlanner.scala: route to the raw planner, the downsample
  planner, or both stitched, at the earliest time raw serves;
- LogicalPlanParser.scala convertToQuery: a plan rendered back to
  PromQL, the canonical text the result cache's fingerprint rests on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from filodb_tpu_torch.coordinator.planner import QueryPlanner
from filodb_tpu_torch.core.filters import Equals, EqualsRegex
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.exec import ExecPlan, StitchRvsExec
from filodb_tpu_torch.query.model import QueryContext


def copy_with_time_range(plan: lp.LogicalPlan, start_ms: int,
                         end_ms: int) -> lp.LogicalPlan:
    """Recursively rebuild a periodic plan for a new [start, end]; the raw
    interval selectors are re-derived from lookback/window + offset."""
    if isinstance(plan, lp.RawSeries):
        look = plan.lookback_ms or 0
        off = plan.offset_ms or 0
        return dataclasses.replace(
            plan, range_selector=lp.IntervalSelector(start_ms - look - off,
                                                     end_ms - off))
    if not dataclasses.is_dataclass(plan):
        return plan
    updates = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, lp.RawSeries):
            look = (v.lookback_ms or 0) + getattr(plan, "window_ms", 0)
            off = v.offset_ms or 0
            updates[f.name] = dataclasses.replace(
                v, range_selector=lp.IntervalSelector(start_ms - look - off,
                                                      end_ms - off))
        elif isinstance(v, lp.LogicalPlan):
            updates[f.name] = copy_with_time_range(v, start_ms, end_ms)
    if hasattr(plan, "start_ms"):
        updates["start_ms"] = start_ms
        updates["end_ms"] = end_ms
    return dataclasses.replace(plan, **updates)


def plan_lookback_ms(plan: lp.LogicalPlan) -> int:
    """Largest lookback/window any leaf needs (to snap split boundaries)."""
    look = 0
    for rs in lp.leaf_raw_series(plan):
        look = max(look, rs.lookback_ms or 0)

    def walk(p):
        nonlocal look
        if dataclasses.is_dataclass(p):
            look = max(look, getattr(p, "window_ms", 0) or 0)
            for f in dataclasses.fields(p):
                v = getattr(p, f.name)
                if isinstance(v, lp.LogicalPlan):
                    walk(v)
    walk(plan)
    return look


class LongTimeRangePlanner(QueryPlanner):
    """Routes to the raw planner, the downsample planner, or both
    stitched (reference: LongTimeRangePlanner.scala, the earliestRawTime
    boundary; the split point snaps to a step so the two sub-plans
    interleave cleanly)."""

    def __init__(self, raw_planner: QueryPlanner,
                 downsample_planner: QueryPlanner,
                 earliest_raw_time_fn: Callable[[], int],
                 latest_downsample_time_fn: Optional[Callable[[], int]] = None):
        self.raw = raw_planner
        self.downsample = downsample_planner
        self.earliest_raw_time = earliest_raw_time_fn
        self.latest_downsample_time = latest_downsample_time_fn \
            or earliest_raw_time_fn

    def materialize(self, plan: lp.LogicalPlan,
                    qctx: Optional[QueryContext] = None) -> ExecPlan:
        qctx = qctx or QueryContext()
        if not isinstance(plan, lp.PeriodicSeriesPlan):
            return self.raw.materialize(plan, qctx)
        start, step, end = lp.time_range(plan)
        earliest_raw = self.earliest_raw_time()
        look = plan_lookback_ms(plan)
        if start - look >= earliest_raw:
            return self.raw.materialize(plan, qctx)
        latest_ds = self.latest_downsample_time()
        if end < earliest_raw:
            return self.downsample.materialize(plan, qctx)
        # spans both: the first step whose full lookback raw data serves
        first_raw_step = start
        while first_raw_step - look < earliest_raw and first_raw_step <= end:
            first_raw_step += step
        if first_raw_step > end:
            return self.downsample.materialize(plan, qctx)
        ds_end = min(first_raw_step - step, latest_ds)
        if ds_end < start:
            return self.raw.materialize(
                copy_with_time_range(plan, first_raw_step, end), qctx)
        ds_plan = self.downsample.materialize(
            copy_with_time_range(plan, start, ds_end), qctx)
        raw_plan = self.raw.materialize(
            copy_with_time_range(plan, first_raw_step, end), qctx)
        return StitchRvsExec([ds_plan, raw_plan], qctx)


# ---------------------------------------------------------------------------
# LogicalPlanParser: plan -> PromQL string (reference:
# LogicalPlanParser.scala round-trip)
# ---------------------------------------------------------------------------

_FN_NAME = {
    "RATE": "rate", "INCREASE": "increase", "DELTA": "delta",
    "IRATE": "irate", "IDELTA": "idelta", "DERIV": "deriv",
    "RESETS": "resets", "SUM_OVER_TIME": "sum_over_time",
    "AVG_OVER_TIME": "avg_over_time", "MIN_OVER_TIME": "min_over_time",
    "MAX_OVER_TIME": "max_over_time", "COUNT_OVER_TIME": "count_over_time",
    "STDDEV_OVER_TIME": "stddev_over_time",
    "STDVAR_OVER_TIME": "stdvar_over_time", "CHANGES": "changes",
    "QUANTILE_OVER_TIME": "quantile_over_time",
    "LAST_OVER_TIME": "last_over_time", "HOLT_WINTERS": "holt_winters",
    "PREDICT_LINEAR": "predict_linear", "ZSCORE": "z_score",
    "TIMESTAMP": "timestamp",
}


def _filters_to_promql(filters, metric_column: str = "_metric_") -> str:
    metric = ""
    matchers = []
    for f in filters:
        if f.column == metric_column and isinstance(f.filter, Equals):
            metric = f.filter.value
            continue
        flt = f.filter
        if isinstance(flt, Equals):
            matchers.append(f'{f.column}="{flt.value}"')
        elif isinstance(flt, EqualsRegex):
            matchers.append(f'{f.column}=~"{flt.pattern}"')
        elif type(flt).__name__ == "NotEquals":
            matchers.append(f'{f.column}!="{flt.value}"')
        elif type(flt).__name__ == "NotEqualsRegex":
            matchers.append(f'{f.column}!~"{flt.pattern}"')
    body = ("{" + ",".join(matchers) + "}") if matchers else ""
    return f"{metric}{body}"


def _dur(ms: int) -> str:
    if ms % 60_000 == 0 and ms:
        return f"{ms // 60_000}m"
    if ms % 1000 == 0:
        return f"{ms // 1000}s"
    return f"{ms}ms"  # never silently truncate sub-second durations


def logical_plan_to_promql(plan: lp.LogicalPlan) -> str:
    """Render a LogicalPlan back to PromQL (reference: LogicalPlanParser
    convertToQuery)."""
    if isinstance(plan, lp.PeriodicSeries):
        s = _filters_to_promql(plan.raw_series.filters)
        if plan.offset_ms:
            s += f" offset {_dur(plan.offset_ms)}"
        return s
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        fn = _FN_NAME.get(plan.function.name, plan.function.name.lower())
        inner = _filters_to_promql(plan.series.filters)
        window = f"[{_dur(plan.window_ms)}]"
        offset = f" offset {_dur(plan.offset_ms)}" if plan.offset_ms else ""
        args = "".join(f"{a}, " for a in plan.function_args)
        return f"{fn}({args}{inner}{window}{offset})"
    if isinstance(plan, lp.Aggregate):
        op = plan.operator.name.lower()
        inner = logical_plan_to_promql(plan.vectors)
        params = ", ".join(str(p) for p in plan.params)
        arg = f"{params}, {inner}" if params else inner
        suffix = ""
        if plan.by:
            suffix = f" by ({', '.join(plan.by)})"
        elif plan.without:
            suffix = f" without ({', '.join(plan.without)})"
        return f"{op}({arg}){suffix}"
    if isinstance(plan, lp.BinaryJoin):
        lhs = logical_plan_to_promql(plan.lhs)
        rhs = logical_plan_to_promql(plan.rhs)
        op = _binop_text(plan.operator)
        mods = ""
        if plan.on:
            mods = f" on ({', '.join(plan.on)})"
        elif plan.ignoring:
            mods = f" ignoring ({', '.join(plan.ignoring)})"
        b = " bool" if plan.bool_mode else ""
        return f"({lhs} {op}{b}{mods} {rhs})"
    if isinstance(plan, lp.ScalarVectorBinaryOperation):
        vec = logical_plan_to_promql(plan.vector)
        sc = logical_plan_to_promql(plan.scalar_arg)
        op = _binop_text(plan.operator)
        return f"({sc} {op} {vec})" if plan.scalar_is_lhs \
            else f"({vec} {op} {sc})"
    if isinstance(plan, lp.ApplyInstantFunction):
        fn = plan.function.name.lower()
        inner = logical_plan_to_promql(plan.vectors)
        args = "".join(f", {a}" for a in plan.function_args)
        return f"{fn}({inner}{args})"
    if isinstance(plan, lp.ApplyMiscellaneousFunction):
        fn = plan.function.name.lower()
        inner = logical_plan_to_promql(plan.vectors)
        args = "".join(f', "{a}"' for a in plan.string_args)
        return f"{fn}({inner}{args})"
    if isinstance(plan, lp.ApplySortFunction):
        return (f"{plan.function.name.lower()}"
                f"({logical_plan_to_promql(plan.vectors)})")
    if isinstance(plan, lp.ApplyAbsentFunction):
        return f"absent({logical_plan_to_promql(plan.vectors)})"
    if isinstance(plan, lp.ScalarFixedDoublePlan):
        return repr(plan.scalar)
    if isinstance(plan, lp.ScalarTimeBasedPlan):
        return f"{plan.function.name.lower()}()"
    if isinstance(plan, lp.ScalarVaryingDoublePlan):
        return f"scalar({logical_plan_to_promql(plan.vectors)})"
    if isinstance(plan, lp.VectorPlan):
        return f"vector({logical_plan_to_promql(plan.scalars)})"
    raise ValueError(f"cannot render {type(plan).__name__} to PromQL")


def _binop_text(op) -> str:
    return op.value  # BinaryOperator values ARE the PromQL operator text
