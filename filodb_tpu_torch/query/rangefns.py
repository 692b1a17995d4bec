"""RangeFunctionId -> batched window function dispatch.

The reference picks a ChunkedRangeFunction per (function, column type)
(reference: query/exec/rangefn/RangeFunction.scala:233-405 factory).  Here
each function maps to one batched function of :mod:`ops.windows` /
:mod:`ops.histogram_ops`, run on the device the caller names over the
whole uploaded ChunkBatch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from filodb_tpu_torch.core.chunk import ChunkBatch
from filodb_tpu_torch.ops import histogram_ops, windows
from filodb_tpu_torch.ops.windows import StepRange
from filodb_tpu_torch.query.logical import RangeFunctionId as F


# prefix-path functions: fn(ts, vals, steps, window) -> [S,T]
def _last_sample_value(ts, vals, steps, window):
    return windows.last_sample(ts, vals, steps, window)[0]


_PREFIX = {
    F.SUM_OVER_TIME: windows.sum_over_time,
    F.COUNT_OVER_TIME: windows.count_over_time,
    F.AVG_OVER_TIME: windows.avg_over_time,
    F.STDDEV_OVER_TIME: windows.stddev_over_time,
    F.STDVAR_OVER_TIME: windows.stdvar_over_time,
    F.CHANGES: windows.changes_over_time,
    F.RESETS: windows.resets_over_time,
    F.RATE: windows.rate,
    F.INCREASE: windows.increase,
    F.DELTA: windows.delta_fn,
    F.IRATE: windows.irate,
    F.IDELTA: windows.idelta,
    F.TIMESTAMP: windows.timestamp_fn,
    F.Z_SCORE: windows.z_score,
    # last_over_time == the instant selector's last-sample scan with an
    # explicit window (reference: LastSampleChunkedFunctionD)
    F.LAST_OVER_TIME: _last_sample_value,
}

# gather-path functions: fn(ts, vals, steps, window, wmax, *args) -> [S,T]
_GATHER = {
    F.MIN_OVER_TIME: windows.min_over_time,
    F.MAX_OVER_TIME: windows.max_over_time,
    F.QUANTILE_OVER_TIME: windows.quantile_over_time,
    F.MAD_OVER_TIME: windows.mad_over_time,
    F.DERIV: windows.deriv,
    F.PREDICT_LINEAR: windows.predict_linear,
    F.HOLT_WINTERS: windows.holt_winters,
}

_HIST = {
    F.RATE: histogram_ops.hist_rate,
    F.INCREASE: histogram_ops.hist_increase,
    F.SUM_OVER_TIME: histogram_ops.hist_sum_over_time,
    None: histogram_ops.hist_last_sample,
}


def supported(func: Optional[F], hist: bool) -> bool:
    """Whether :func:`apply_range_function` serves ``func`` over a
    scalar (``hist=False``) or a histogram batch."""
    if hist:
        return func in _HIST
    return func is None or func in _PREFIX or func in _GATHER


def apply_range_function(batch: ChunkBatch, steps: StepRange,
                         window_ms: int, func: Optional[F],
                         args: tuple = (), device="cuda") -> torch.Tensor:
    """Run one windowed range function over a whole ChunkBatch on
    ``device``: the batch is uploaded once (values in the device's value
    type, :func:`ops.windows.value_dtype`) and the result stays there.

    ``func=None`` is the plain instant-vector selector: last sample within
    the lookback window (reference: PeriodicSamplesMapper with no range
    function uses LastSampleChunkedFunction).  Returns values [S, T], or a
    hist result [S, T, B] when the batch holds histograms.
    """
    dev = torch.device(device)
    dtype = windows.value_dtype(dev)
    step_arr = torch.as_tensor(steps.timestamps(), device=dev)
    ts = torch.as_tensor(batch.timestamps, device=dev)
    window = int(window_ms)
    if batch.hist is not None:
        kern = _HIST.get(func)
        if kern is None:
            raise ValueError(f"range function {func} not supported on "
                             f"histograms")
        hist = torch.as_tensor(batch.hist, dtype=dtype, device=dev)
        return kern(ts, hist, step_arr, window)
    vals = torch.as_tensor(batch.values, dtype=dtype, device=dev)
    if func is None:
        return _last_sample_value(ts, vals, step_arr, window)
    if func in _PREFIX:
        return _PREFIX[func](ts, vals, step_arr, window)
    if func in _GATHER:
        wmax = windows.max_window_rows(ts, step_arr, window)
        wmax = max(int(np.ceil(wmax / 16)) * 16, 16)   # bounded tile widths
        extra = tuple(float(a) for a in args)
        return _GATHER[func](ts, vals, step_arr, window, wmax, *extra)
    raise ValueError(f"unsupported range function {func}")
