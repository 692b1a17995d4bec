"""Schema-driven plan rewrites for downsampled / hist-max schemas.

The reference finalizes the leaf plan AFTER schema discovery: for the
downsample-gauge schema it selects the right aggregate columns and swaps
the range function (reference: query/src/main/scala/filodb/query/exec/
MultiSchemaPartitionsExec.scala:41-85, SelectRawPartitionsExec.scala:40-96,
rangefn/RangeFunction.scala:238-267 downsampleColsFromRangeFunction /
downsampleRangeFunction); for histogram schemas carrying a ``max`` double
column it pairs the hist kernel with a max kernel (histMaxRangeFunction,
RangeFunction.scala:359-365).

Without these rewrites, ``min_over_time``/``max_over_time``/``sum_over_time``/
``count_over_time``/``avg_over_time`` over a downsampled gauge would compute
over the per-period *averages* — wrong results, not just missing speed.
"""

from __future__ import annotations

from typing import Optional

from filodb_tpu_torch.core.schemas import ColumnType, DataSchema
from filodb_tpu_torch.query.logical import RangeFunctionId as F

# ds-gauge aggregate columns, all doubles (reference ds-gauge schema,
# filodb-defaults.conf: min/max/sum/count/avg with value-column avg)
_DS_GAUGE_COLS = frozenset(["min", "max", "sum", "count", "avg"])


def is_ds_gauge(data: DataSchema) -> bool:
    """Downsample-gauge detection by column signature (robust to custom
    schema names, unlike the reference's identity check vs Schemas.dsGauge):
    every aggregate column present as a double, value column = avg."""
    if data.value_column != "avg":
        return False
    doubles = {c.name for c in data.columns if c.ctype == ColumnType.DOUBLE}
    return _DS_GAUGE_COLS <= doubles


def hist_max_column(data: DataSchema) -> Optional[int]:
    """Column id of the ``max`` double column when the schema also has a
    histogram column (reference: SelectRawPartitionsExec.histMaxColumn)."""
    if not any(c.ctype == ColumnType.HISTOGRAM for c in data.columns):
        return None
    for c in data.columns:
        if c.name == "max" and c.ctype == ColumnType.DOUBLE:
            return c.id
    return None


# func -> (columns to read, function to run over them).  Functions absent
# from this table read the default value column (avg) unchanged — the
# reference maps changes/delta/deriv/stddev/quantile/... to Seq("avg")
# with the original function (RangeFunction.scala:238-258).
_DS_GAUGE_REWRITES = {
    F.MIN_OVER_TIME: (("min",), F.MIN_OVER_TIME),
    F.MAX_OVER_TIME: (("max",), F.MAX_OVER_TIME),
    F.SUM_OVER_TIME: (("sum",), F.SUM_OVER_TIME),
    # count over periods = sum of the per-period counts
    F.COUNT_OVER_TIME: (("count",), F.SUM_OVER_TIME),
    # avg = sum(period sums) / sum(period counts): the reference's
    # AvgWithSumAndCountOverTime (AggrOverTimeFunctions.scala:242)
    F.AVG_OVER_TIME: (("sum", "count"), None),
}


def ds_gauge_rewrite(func: Optional[F]):
    """Return (columns, new_func) for a ds-gauge read, or None when the
    default value column (avg) with the original function is already
    correct.  new_func None means the two-column AvgWithSumAndCount path.
    """
    if func is None:
        return None
    return _DS_GAUGE_REWRITES.get(func)
