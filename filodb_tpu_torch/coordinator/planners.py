"""Time-range planning: split a query where its data changes home.

Capability match for the reference's planner pieces the rollup router
stands on (reference: coordinator/.../queryplanner/):
- LogicalPlanUtils.scala:238 copyWithUpdatedTimeRange;
- LongTimeRangePlanner.scala: route to the raw planner, the downsample
  planner, or both stitched, at the earliest time raw serves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from filodb_tpu_torch.coordinator.planner import QueryPlanner
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
