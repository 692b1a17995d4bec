"""Plan enums the device grid needs.

Mirrors the reference's RangeFunctionId (reference:
query/src/main/scala/filodb/query/PlanEnums.scala); the rest of the
logical-plan ADT arrives with the query slice.
"""

from __future__ import annotations

import enum


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
