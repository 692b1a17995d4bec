"""Resolution-routed query planning: raw vs rolled tiers, stitched.

The serving half of the rollup subsystem: every query against a
rollup-enabled dataset plans through :class:`RollupRouterPlanner`,
which

1. computes the query's **resolution limit** — the coarsest period
   length that still puts >=1 rolled sample in every window the plan
   evaluates (min over step, range-function windows, and instant-
   selector lookbacks);
2. picks the **coarsest tier** within that limit (a month-long
   dashboard query at 1h step reads the 1h tier: thousands of samples
   instead of tens of millions — the tsdownsample decimation argument,
   arXiv:2307.05389).  ``?resolution=raw|auto|<duration>`` overrides;
3. **stitches at the tier boundary**: the rolled tier serves only up
   to the engine's per-tier closure watermark (and raw only down to
   its retention floor); the split/snap/stitch math is the reference's
   ``LongTimeRangePlanner`` (coordinator/planners.py), instantiated
   per query with the live boundary.  The ds-gauge column rewrites
   (query/dsrewrite.py) apply at the tier leaves exactly as on any
   downsampled dataset — ``sum_over_time`` reads the ``sum`` column,
   never a sum of averages;
4. **reports the chosen resolution**: stamped on the QueryContext at
   materialize time (``rollup_resolution_ms``, and ``rollup_tiers``
   for the legs), and counted per tier in
   ``filodb_rollup_queries_routed_total``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from filodb_tpu_torch.coordinator.planner import QueryPlanner
from filodb_tpu_torch.coordinator.planners import (LongTimeRangePlanner,
                                                   plan_lookback_ms)
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.rollup.config import parse_duration_ms
from filodb_tpu_torch.utils.observability import rollup_metrics

_NEG = -(1 << 62)

# instant selectors carry the Prometheus staleness lookback; a rolled
# period longer than it would leave every step empty
_DEFAULT_LOOKBACK_MS = 300_000


def resolution_limit_ms(plan: lp.LogicalPlan, step_ms: int) -> int:
    """Coarsest usable period length for this plan: every evaluation
    window (range-function window or instant lookback) and the step
    itself must hold >= 1 rolled sample."""
    limit = max(int(step_ms), 1)

    def walk(p):
        nonlocal limit
        if isinstance(p, lp.PeriodicSeriesWithWindowing):
            limit = min(limit, int(p.window_ms))
        elif isinstance(p, lp.PeriodicSeries):
            look = p.raw_series.lookback_ms or _DEFAULT_LOOKBACK_MS
            limit = min(limit, int(look))
        if dataclasses.is_dataclass(p):
            for f in dataclasses.fields(p):
                v = getattr(p, f.name)
                if isinstance(v, lp.LogicalPlan):
                    walk(v)
    walk(plan)
    return limit


def parse_resolution_pref(pref: str) -> Optional[object]:
    """``?resolution=`` values: '' / 'auto' -> None (router decides),
    'raw' -> 0, a duration ('1m') -> that many ms."""
    pref = (pref or "").strip().lower()
    if pref in ("", "auto"):
        return None
    if pref == "raw":
        return 0
    return parse_duration_ms(pref)


#: canonical stats/span ordering for stitched tiers, oldest data first
TIER_ORDER = ("rolled-cold", "rolled-local", "raw")


def canonical_tiers(tiers) -> str:
    """'+'-joined tier attribution in canonical (oldest-first) order —
    the legs materialize in planner-internal order, so the raw append
    sequence is not presentation-stable."""
    seen = [t for t in TIER_ORDER if t in tiers]
    seen += [t for t in tiers if t not in seen]
    return "+".join(seen)


class _TierNotePlanner(QueryPlanner):
    """Wraps a leg planner purely for ATTRIBUTION: when the stitch
    math materializes this leg, the tier name lands on
    ``qctx.rollup_tiers`` (what ``QueryStats.tiers`` reports) and the
    per-tier routing counter bumps.  Correctness never depends on it:
    both rolled legs read the same tier dataset."""

    def __init__(self, inner: QueryPlanner, tier: str, dataset: str,
                 routed_counter=None):
        self.inner = inner
        self.tier = tier
        self.dataset = dataset
        self._routed = routed_counter

    def materialize(self, plan, qctx=None):
        if qctx is not None and self.tier not in qctx.rollup_tiers:
            qctx.rollup_tiers.append(self.tier)
            if self._routed is not None:
                self._routed.inc(dataset=self.dataset, tier=self.tier)
        return self.inner.materialize(plan, qctx)


class RollupRouterPlanner(QueryPlanner):
    """Routes one dataset's queries across its resolution ladder."""

    def __init__(self, dataset: str, raw_planner: QueryPlanner,
                 tier_planners: dict[int, QueryPlanner],
                 rolled_through_fn: Callable[[int], int],
                 raw_retention_ms: Optional[int] = None,
                 now_ms_fn: Optional[Callable[[], int]] = None,
                 cold_floor_fn: Optional[Callable[[int], int]] = None):
        self.dataset = dataset
        self.raw = raw_planner
        self.tiers = dict(sorted(tier_planners.items()))
        self.rolled_through = rolled_through_fn
        self.raw_retention_ms = raw_retention_ms
        self.now_ms = now_ms_fn or (lambda: int(time.time() * 1000))
        # cold tier: resolution -> age-out floor of that
        # tier's dataset (epoch ms; 0 = nothing archived yet).  Chunks
        # ending before the floor live in the object bucket; the router
        # adds a rolled-local/rolled-cold stitch at it for attribution
        self.cold_floor = cold_floor_fn
        self._routed = rollup_metrics()["routed"]
        self._tier_served = rollup_metrics()["tier_served"]

    # ------------------------------------------------------------ selection

    def _pick_tier(self, limit_ms: int, start_ms: int,
                   pref: Optional[int]) -> Optional[int]:
        """Coarsest tier that fits the limit and has rolled data the
        query's range can use; None -> raw only."""
        if pref == 0:
            return None
        if pref is not None:
            if pref not in self.tiers:
                # an explicit pin to a duration outside the ladder is a
                # client mistake — silently serving raw would defeat the
                # very reproduction the pin exists for (400 upstream)
                ladder = ", ".join(f"{r // 1000}s" for r in self.tiers)
                raise ValueError(
                    f"resolution {pref}ms is not a configured rollup "
                    f"tier of {self.dataset!r} (ladder: {ladder}, or "
                    f"'raw'/'auto')")
            return pref
        best = None
        for res in self.tiers:
            if res <= limit_ms and self.rolled_through(res) > start_ms:
                best = res
        return best

    def _earliest_raw_ms(self) -> int:
        if self.raw_retention_ms is None:
            return _NEG
        return self.now_ms() - self.raw_retention_ms

    # --------------------------------------------------------- materialize

    def materialize(self, plan: lp.LogicalPlan,
                    qctx: Optional[QueryContext] = None):
        qctx = qctx or QueryContext()
        if not isinstance(plan, lp.PeriodicSeriesPlan):
            return self.raw.materialize(plan, qctx)
        try:
            start, step, end = lp.time_range(plan)
        except ValueError:
            return self.raw.materialize(plan, qctx)
        pref = parse_resolution_pref(qctx.resolution_pref)
        limit = resolution_limit_ms(plan, step)
        # the router IS deciding for this query (even when it decides
        # "raw"): mark the qctx, so a routed raw answer is told apart
        # from an un-tiered dataset's
        qctx.rollup_routed = True
        res = self._pick_tier(limit, start, pref)
        retention_floor = self._earliest_raw_ms()
        if res is None and retention_floor > start and self.tiers:
            # raw can't serve the head of the range: best-effort route
            # the finest tier even past the fidelity limit (partial
            # rolled data beats a silent hole; reference behavior)
            res = next(iter(self.tiers))
        if res is None:
            self._routed.inc(dataset=self.dataset, resolution="raw")
            if "raw" not in qctx.rollup_tiers:
                qctx.rollup_tiers.append("raw")
            return self.raw.materialize(plan, qctx)
        rolled_hwm = self.rolled_through(res)
        if rolled_hwm <= start:
            self._routed.inc(dataset=self.dataset, resolution="raw")
            if "raw" not in qctx.rollup_tiers:
                qctx.rollup_tiers.append("raw")
            return self.raw.materialize(plan, qctx)
        # the boundary raw serving starts at: everything the tier has
        # closed serves rolled, the live tail serves raw.  Unlike the
        # retention case LongTimeRangePlanner was built for, raw DOES
        # hold the data below this profit boundary — so the raw side's
        # "first step whose full lookback is raw-served" rule must be
        # offset by the lookback, or the one step whose window SPANS
        # the boundary would be served by neither side (a gap at every
        # stitch).  Raw retention (when configured) still floors it.
        look = plan_lookback_ms(plan)
        boundary = rolled_hwm + 1 - look
        if _NEG < retention_floor <= rolled_hwm:
            boundary = max(boundary, retention_floor)
        # retention past the rolled watermark is unenforceable without
        # a hole: the tier has nothing there yet, and raw still HOLDS
        # the data (raw-retention is a routing knob, it deletes
        # nothing) — so the raw side serves the gap instead of every
        # fresh step coming back empty
        qctx.rollup_resolution_ms = int(res)
        self._routed.inc(dataset=self.dataset, resolution=str(res))
        # the reference's raw/downsample split+stitch math, instantiated
        # with THIS query's live boundary (snap to step, lookback-aware)
        ltr = LongTimeRangePlanner(
            _TierNotePlanner(self.raw, "raw", self.dataset,
                             self._tier_served),
            self._rolled_leg(res, start, look),
            earliest_raw_time_fn=lambda _b=boundary: _b,
            latest_downsample_time_fn=lambda _h=rolled_hwm: _h)
        return ltr.materialize(plan, qctx)

    def _rolled_leg(self, res: int, start_ms: int, look_ms: int):
        """The rolled side of the stitch — with a THIRD boundary when
        the tier's age-out floor cuts the query range: data ending
        before the floor is guaranteed archived (rolled-cold), newer
        rolled data is still local (rolled-local).  Both legs read the
        SAME tier dataset (the cold tier's store merges the archived
        chunks under it), so the boundary is pure attribution: a stale watermark can
        mislabel a leg but never change bytes.  A year-long panel thus
        plans raw -> rolled-local -> rolled-cold and never touches the
        raw dataset below the profit boundary."""
        tier = self.tiers[res]
        local_leg = _TierNotePlanner(tier, "rolled-local", self.dataset,
                                     self._tier_served)
        cold_wm = self.cold_floor(res) if self.cold_floor is not None else 0
        if cold_wm <= start_ms:
            return local_leg
        cold_leg = _TierNotePlanner(tier, "rolled-cold", self.dataset,
                                    self._tier_served)
        # same gap-avoid offset as the outer stitch: the one step whose
        # lookback window spans the floor is served by the local leg
        cold_boundary = cold_wm + 1 - look_ms
        return LongTimeRangePlanner(
            local_leg, cold_leg,
            earliest_raw_time_fn=lambda _b=cold_boundary: _b,
            latest_downsample_time_fn=lambda _h=cold_wm: _h)
