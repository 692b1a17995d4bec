"""LogicalPlan ADT + plan enums.

Mirrors the reference's LogicalPlan hierarchy and PlanEnums
(reference: query/src/main/scala/filodb/query/LogicalPlan.scala:83-410,
PlanEnums.scala:1-209).  Logical plans are built by the PromQL parser and
materialized into ExecPlans by the planners.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Union

from filodb_tpu_torch.core.filters import ColumnFilter


class AggregationOperator(enum.Enum):
    AVG = "avg"
    COUNT = "count"
    GROUP = "group"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    STDDEV = "stddev"
    STDVAR = "stdvar"
    TOPK = "topk"
    BOTTOMK = "bottomk"
    QUANTILE = "quantile"
    COUNT_VALUES = "count_values"


class RangeFunctionId(enum.Enum):
    AVG_OVER_TIME = "avg_over_time"
    CHANGES = "changes"
    COUNT_OVER_TIME = "count_over_time"
    DELTA = "delta"
    DERIV = "deriv"
    HOLT_WINTERS = "holt_winters"
    IDELTA = "idelta"
    INCREASE = "increase"
    IRATE = "irate"
    LAST_OVER_TIME = "last_over_time"
    MAX_OVER_TIME = "max_over_time"
    MIN_OVER_TIME = "min_over_time"
    PREDICT_LINEAR = "predict_linear"
    QUANTILE_OVER_TIME = "quantile_over_time"
    MAD_OVER_TIME = "mad_over_time"
    RATE = "rate"
    RESETS = "resets"
    STDDEV_OVER_TIME = "stddev_over_time"
    STDVAR_OVER_TIME = "stdvar_over_time"
    SUM_OVER_TIME = "sum_over_time"
    TIMESTAMP = "timestamp"
    Z_SCORE = "z_score"


class InstantFunctionId(enum.Enum):
    ABS = "abs"
    CEIL = "ceil"
    CLAMP_MAX = "clamp_max"
    CLAMP_MIN = "clamp_min"
    EXP = "exp"
    FLOOR = "floor"
    HISTOGRAM_QUANTILE = "histogram_quantile"
    HISTOGRAM_MAX_QUANTILE = "histogram_max_quantile"
    HISTOGRAM_BUCKET = "histogram_bucket"
    LN = "ln"
    LOG10 = "log10"
    LOG2 = "log2"
    ROUND = "round"
    SGN = "sgn"
    SQRT = "sqrt"
    DAYS_IN_MONTH = "days_in_month"
    DAY_OF_MONTH = "day_of_month"
    DAY_OF_WEEK = "day_of_week"
    HOUR = "hour"
    MINUTE = "minute"
    MONTH = "month"
    YEAR = "year"


class BinaryOperator(enum.Enum):
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"
    POW = "^"
    EQL = "=="
    NEQ = "!="
    GTR = ">"
    LSS = "<"
    GTE = ">="
    LTE = "<="
    LAND = "and"
    LOR = "or"
    LUNLESS = "unless"

    @property
    def is_comparison(self) -> bool:
        return self in (BinaryOperator.EQL, BinaryOperator.NEQ,
                        BinaryOperator.GTR, BinaryOperator.LSS,
                        BinaryOperator.GTE, BinaryOperator.LTE)

    @property
    def is_set_op(self) -> bool:
        return self in (BinaryOperator.LAND, BinaryOperator.LOR,
                        BinaryOperator.LUNLESS)


class Cardinality(enum.Enum):
    ONE_TO_ONE = "OneToOne"
    ONE_TO_MANY = "OneToMany"
    MANY_TO_ONE = "ManyToOne"
    MANY_TO_MANY = "ManyToMany"


class MiscellaneousFunctionId(enum.Enum):
    LABEL_REPLACE = "label_replace"
    LABEL_JOIN = "label_join"
    HIST_TO_PROM_VECTORS = "hist_to_prom_vectors"


class SortFunctionId(enum.Enum):
    SORT = "sort"
    SORT_DESC = "sort_desc"


class ScalarFunctionId(enum.Enum):
    SCALAR = "scalar"
    TIME = "time"
    HOUR = "hour"
    MINUTE = "minute"
    MONTH = "month"
    YEAR = "year"
    DAY_OF_MONTH = "day_of_month"
    DAY_OF_WEEK = "day_of_week"
    DAYS_IN_MONTH = "days_in_month"


class VectorFunctionId(enum.Enum):
    VECTOR = "vector"


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------

class LogicalPlan:
    """Base; RawSeriesLikePlan/PeriodicSeriesPlan split as in the reference."""


class RawSeriesLikePlan(LogicalPlan):
    pass


class PeriodicSeriesPlan(LogicalPlan):
    pass


class MetadataQueryPlan(LogicalPlan):
    pass


@dataclasses.dataclass(frozen=True)
class IntervalSelector:
    """[from, to] epoch ms range of raw data to read (reference:
    RangeSelector/IntervalSelector)."""

    from_ms: int
    to_ms: int


@dataclasses.dataclass(frozen=True)
class RawSeries(RawSeriesLikePlan):
    range_selector: IntervalSelector
    filters: tuple[ColumnFilter, ...]
    columns: tuple[str, ...] = ()
    lookback_ms: Optional[int] = None
    offset_ms: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RawChunkMeta(RawSeriesLikePlan):
    range_selector: IntervalSelector
    filters: tuple[ColumnFilter, ...]
    column: str = ""


@dataclasses.dataclass(frozen=True)
class PeriodicSeries(PeriodicSeriesPlan):
    """Raw series resampled at regular steps, no range function — the
    instant-vector selector (reference LogicalPlan.scala PeriodicSeries)."""

    raw_series: RawSeries
    start_ms: int
    step_ms: int
    end_ms: int
    offset_ms: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PeriodicSeriesWithWindowing(PeriodicSeriesPlan):
    series: RawSeries
    start_ms: int
    step_ms: int
    end_ms: int
    window_ms: int
    function: RangeFunctionId
    function_args: tuple = ()
    offset_ms: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Aggregate(PeriodicSeriesPlan):
    operator: AggregationOperator
    vectors: PeriodicSeriesPlan
    params: tuple = ()
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class BinaryJoin(PeriodicSeriesPlan):
    lhs: PeriodicSeriesPlan
    operator: BinaryOperator
    cardinality: Cardinality
    rhs: PeriodicSeriesPlan
    on: tuple[str, ...] = ()
    ignoring: tuple[str, ...] = ()
    include: tuple[str, ...] = ()
    bool_mode: bool = False  # comparison returns 0/1 instead of filtering


@dataclasses.dataclass(frozen=True)
class ScalarVectorBinaryOperation(PeriodicSeriesPlan):
    operator: BinaryOperator
    scalar_arg: "LogicalPlan"  # ScalarPlan subtype
    vector: PeriodicSeriesPlan
    scalar_is_lhs: bool = False
    bool_mode: bool = False


@dataclasses.dataclass(frozen=True)
class ApplyInstantFunction(PeriodicSeriesPlan):
    vectors: PeriodicSeriesPlan
    function: InstantFunctionId
    function_args: tuple = ()


@dataclasses.dataclass(frozen=True)
class ApplyMiscellaneousFunction(PeriodicSeriesPlan):
    vectors: PeriodicSeriesPlan
    function: MiscellaneousFunctionId
    string_args: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ApplySortFunction(PeriodicSeriesPlan):
    vectors: PeriodicSeriesPlan
    function: SortFunctionId


@dataclasses.dataclass(frozen=True)
class ApplyAbsentFunction(PeriodicSeriesPlan):
    vectors: PeriodicSeriesPlan
    filters: tuple[ColumnFilter, ...]
    start_ms: int = 0
    step_ms: int = 0
    end_ms: int = 0


# -- scalar plans -----------------------------------------------------------

class ScalarPlan(PeriodicSeriesPlan):
    pass


@dataclasses.dataclass(frozen=True)
class ScalarTimeBasedPlan(ScalarPlan):
    function: ScalarFunctionId
    start_ms: int
    step_ms: int
    end_ms: int


@dataclasses.dataclass(frozen=True)
class ScalarFixedDoublePlan(ScalarPlan):
    scalar: float
    start_ms: int
    step_ms: int
    end_ms: int


@dataclasses.dataclass(frozen=True)
class ScalarVaryingDoublePlan(ScalarPlan):
    """scalar(vector-expr): per-step scalar from a one-series vector."""

    vectors: PeriodicSeriesPlan
    function: ScalarFunctionId = ScalarFunctionId.SCALAR


@dataclasses.dataclass(frozen=True)
class ScalarBinaryOperation(ScalarPlan):
    operator: BinaryOperator
    lhs: Union[float, "ScalarBinaryOperation", ScalarPlan]
    rhs: Union[float, "ScalarBinaryOperation", ScalarPlan]
    start_ms: int = 0
    step_ms: int = 0
    end_ms: int = 0


@dataclasses.dataclass(frozen=True)
class VectorPlan(PeriodicSeriesPlan):
    """vector(scalar-expr)."""

    scalars: ScalarPlan


# -- metadata plans ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LabelValues(MetadataQueryPlan):
    label_names: tuple[str, ...]
    filters: tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


@dataclasses.dataclass(frozen=True)
class SeriesKeysByFilters(MetadataQueryPlan):
    filters: tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


@dataclasses.dataclass(frozen=True)
class RawChunkMeta(MetadataQueryPlan):
    """Chunk-level metadata for matching series — the debugging /
    capacity-planning query (reference: LogicalPlan.scala RawChunkMeta +
    exec/SelectChunkInfosExec).  Chunks here store all columns together
    (one ChunkSet), so unlike the reference there is no per-column
    variant."""

    filters: tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


# ---------------------------------------------------------------------------
# Tree utilities (reference: LogicalPlanUtils / LogicalPlan object helpers)
# ---------------------------------------------------------------------------

def leaf_raw_series(plan: LogicalPlan) -> list[RawSeries]:
    out: list[RawSeries] = []

    def walk(p):
        if isinstance(p, RawSeries):
            out.append(p)
        elif dataclasses.is_dataclass(p):
            for f in dataclasses.fields(p):
                v = getattr(p, f.name)
                if isinstance(v, LogicalPlan):
                    walk(v)
    walk(plan)
    return out


def raw_series_filters(plan: LogicalPlan) -> list[tuple[ColumnFilter, ...]]:
    return [rs.filters for rs in leaf_raw_series(plan)]


def time_range(plan: LogicalPlan) -> tuple[int, int, int]:
    """(start, step, end) of a periodic plan."""
    for attr in ("start_ms",):
        if hasattr(plan, attr):
            return plan.start_ms, plan.step_ms, plan.end_ms
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, PeriodicSeriesPlan):
            return time_range(v)
    raise ValueError(f"no time range on {type(plan).__name__}")
