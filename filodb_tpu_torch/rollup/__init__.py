"""Tiered-resolution serving: continuous rollup inside the live server
(reference: the offline spark-jobs downsampler and the
DownsampledTimeSeriesStore pair, run continuously).

- :mod:`.config` — the per-dataset rollup ladder (raw -> 1m -> 15m -> 1h
  by default), tick cadence, routing policy.
- :mod:`.engine` — the RollupEngine: per-shard incremental chunk
  consumption (only newly-flushed chunks per tick), per-series period
  closure, tier emission through the tier datasets' publish functions,
  persisted high-water marks.  The period reduce runs on the memstore's
  device.
- :mod:`.planner` — RollupRouterPlanner: picks the coarsest tier whose
  resolution fits the query's step and windows, stitches raw and rolled
  results at the tier boundary (LongTimeRangePlanner, StitchRvsExec),
  and stamps the chosen resolution on the QueryContext.
"""

from filodb_tpu_torch.rollup.config import RollupConfig  # noqa: F401
from filodb_tpu_torch.rollup.engine import (ROLLUP_PRIORITY,  # noqa: F401
                                            ROLLUP_TENANT, RollupEngine)
from filodb_tpu_torch.rollup.planner import RollupRouterPlanner  # noqa: F401
