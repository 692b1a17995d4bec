"""Windowed range functions over padded batches, on tensors.

Semantics match the reference's PeriodicSamplesMapper windows — for each
output step ``t`` the window is ``(t - window, t]``, start exclusive / end
inclusive (reference: query/exec/PeriodicSamplesMapper.scala:323-344) — and
Prometheus' extrapolation rules for rate/increase/delta (reference:
query/exec/rangefn/RateFunctions.scala:10-80 extrapolatedRate).

Every function computes ALL windows of ALL series at once, on the device
its inputs live on:

- ``window_bounds``: batched ``torch.searchsorted`` -> [S, T] first/last
  row indices.
- prefix-path functions: running sums over the row axis; each window is
  two gathers and a subtract.
- gather-path functions (min/max/quantile/...): bounded per-window row
  tiles [S, T, W] reduced along W.

Inputs: ``ts [S, R]`` int64 epoch ms (padding rows TS_PAD), ``vals [S, R]``
float (NaN = no sample), ``steps [T]`` int64 step ends, ``window`` ms.
Time differences are taken in int64 before they become floats, so epoch
milliseconds never round in float32 on the card; in float64 this is the
same arithmetic bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class StepRange(NamedTuple):
    """Regular output grid: steps at start, start+step, ..., end (inclusive),
    like the reference's RangeParams."""

    start: int  # ms
    end: int    # ms
    step: int   # ms

    @property
    def num_steps(self) -> int:
        return (self.end - self.start) // self.step + 1

    def timestamps(self, dtype=None):
        """Host-side epoch-ms step grid as numpy int64."""
        out = (np.arange(self.num_steps, dtype=np.int64) * self.step
               + np.int64(self.start))
        return out if dtype is None else out.astype(dtype)


def value_dtype(device) -> torch.dtype:
    """The values' type on ``device``: float32 on the card (the kernels'
    type), float64 on the CPU — the device store's rule."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


def _nan(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float("nan"), dtype=like.dtype, device=like.device)


def window_bounds(ts: torch.Tensor, steps: torch.Tensor, window):
    """[S,R] sorted timestamps x [T] step ends -> (first, last) [S,T].

    ``first`` = index of first row with ts > step-window; ``last`` = index
    one past the last row with ts <= step (reference: per-window
    binarySearch/ceilingIndex, LongBinaryVector.scala:152,162)."""
    S = ts.shape[0]
    hi = steps[None, :].expand(S, -1).contiguous()
    lo = hi - window
    first = torch.searchsorted(ts, lo, right=True)
    last = torch.searchsorted(ts, hi, right=True)
    return first, last


def _shift_prev(vals: torch.Tensor) -> torch.Tensor:
    return torch.cat([vals[:, :1], vals[:, :-1]], dim=1)


def counter_correct(vals: torch.Tensor) -> torch.Tensor:
    """Prometheus counter-reset correction along the row axis: wherever a
    value drops below its predecessor, all later values shift up by the
    predecessor (reference: CorrectionMeta threading,
    rangefn/RangeFunction.scala:125-161)."""
    prev = _shift_prev(vals)
    drop = torch.where(vals < prev, prev, torch.zeros_like(vals))
    return vals + torch.cumsum(drop, dim=1)


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """[S,R] -> [S,R+1] running sum with NaN treated as 0."""
    s = torch.cumsum(torch.where(torch.isnan(x), torch.zeros_like(x), x),
                     dim=1)
    return torch.nn.functional.pad(s, (1, 0))


def _at(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [S,R], idx [S,T] in range -> out[s,t] = arr[s, idx[s,t]]."""
    return torch.gather(arr, 1, idx)


def _range_sum(P, first, last):
    return _at(P, last) - _at(P, first)


def _gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-series gather with idx clipped into [0, R-1]."""
    return _at(arr, idx.clamp(0, arr.shape[1] - 1))


def _rows(vals: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(vals.shape[1], dtype=like.dtype,
                        device=vals.device)[None, :].expand_as(vals)


# --------------------------------------------------------------------------
# Prefix-path functions
# --------------------------------------------------------------------------

def sum_count_avg(ts, vals, steps, window):
    """Returns (sum, count, avg) over each window in one pass."""
    first, last = window_bounds(ts, steps, window)
    s = _range_sum(_prefix(vals), first, last)
    n = _range_sum(_prefix(torch.isfinite(vals).to(vals.dtype)), first, last)
    empty = n == 0
    nan = _nan(vals)
    s = torch.where(empty, nan, s)
    avg = torch.where(empty, nan, s / torch.where(empty, 1.0, n))
    return s, torch.where(empty, nan, n), avg


def sum_over_time(ts, vals, steps, window):
    return sum_count_avg(ts, vals, steps, window)[0]


def count_over_time(ts, vals, steps, window):
    return sum_count_avg(ts, vals, steps, window)[1]


def avg_over_time(ts, vals, steps, window):
    return sum_count_avg(ts, vals, steps, window)[2]


def stdvar_stddev(ts, vals, steps, window):
    """Population variance/stddev via sum & sum-of-squares prefixes,
    centered on a per-series grand mean first so the E[x^2]-E[x]^2
    cancellation cannot blow up (reference: VarOverTimeChunkedFunctionD,
    AggrOverTimeFunctions.scala)."""
    first, last = window_bounds(ts, steps, window)
    fin = torch.isfinite(vals)
    nrows = fin.sum(dim=1, keepdim=True).clamp(min=1).to(vals.dtype)
    center = torch.where(fin, vals, torch.zeros_like(vals)).sum(
        dim=1, keepdim=True) / nrows
    x = vals - center
    s1 = _range_sum(_prefix(x), first, last)
    s2 = _range_sum(_prefix(x * x), first, last)
    n = _range_sum(_prefix(fin.to(vals.dtype)), first, last)
    empty = n == 0
    nsafe = torch.where(empty, 1.0, n)
    mean = s1 / nsafe
    var = torch.clamp(s2 / nsafe - mean * mean, min=0.0)
    # one sample has no spread: exactly 0, whatever rounding the two
    # prefix differences carry
    var = torch.where(n == 1, torch.zeros_like(var), var)
    var = torch.where(empty, _nan(vals), var)
    return var, torch.sqrt(var)


def stdvar_over_time(ts, vals, steps, window):
    return stdvar_stddev(ts, vals, steps, window)[0]


def stddev_over_time(ts, vals, steps, window):
    return stdvar_stddev(ts, vals, steps, window)[1]


def _pair_count(flags, ts, vals, steps, window):
    """Count of flagged consecutive-sample pairs fully inside each
    window; NaN where the window holds no finite sample."""
    first, last = window_bounds(ts, steps, window)
    C = _prefix(flags.to(vals.dtype))
    # pair i covers rows (i-1, i); only pairs fully inside the window count
    raw = _at(C, last) - _at(C, torch.minimum(first + 1, last))
    n = _range_sum(_prefix(torch.isfinite(vals).to(vals.dtype)), first, last)
    return torch.where(n == 0, _nan(vals), raw)


def changes_over_time(ts, vals, steps, window):
    """Number of value changes between consecutive samples in the window."""
    prev = _shift_prev(vals)
    chg = (vals != prev) & torch.isfinite(vals) & torch.isfinite(prev)
    return _pair_count(chg, ts, vals, steps, window)


def resets_over_time(ts, vals, steps, window):
    return _pair_count(vals < _shift_prev(vals), ts, vals, steps, window)


def _last_finite(vals, like):
    """Per row, the index of the last finite row at or before it (-1)."""
    rows = _rows(vals, like)
    return torch.cummax(torch.where(torch.isfinite(vals), rows, -1),
                        dim=1).values


def last_sample(ts, vals, steps, window):
    """Last *non-NaN* sample in the window and its timestamp: the raw-series
    instant selector (reference: LastSampleChunkedFunctionD,
    rangefn/RangeFunction.scala:408-542).  Returns (value, ts_ms) [S,T];
    ts_ms is -1 where no sample exists."""
    first, last = window_bounds(ts, steps, window)
    lastfin = _last_finite(vals, first)
    j = _gather_rows(lastfin, torch.clamp(last - 1, min=0))
    valid = (last > 0) & (j >= first) & (j >= 0)
    value = torch.where(valid, _gather_rows(vals, j), _nan(vals))
    tstamp = torch.where(valid, _gather_rows(ts, j), -1)
    return value, tstamp


def timestamp_fn(ts, vals, steps, window):
    """PromQL timestamp(): seconds of the last sample (reference
    rangefn/RangeFunction.scala:544 TimestampChunkedFunction).  Absolute
    epoch seconds in the value type: float32 on the card quantizes them
    to ~128 s, as the reference's general path does on accelerators."""
    _, t = last_sample(ts, vals, steps, window)
    # a multiply by 1e-3, as the reference's compiled division by the
    # constant 1000 rounds (and as torch divides by a scalar on the card)
    return torch.where(t < 0, _nan(vals), t.to(vals.dtype) * 1e-3)


# --------------------------------------------------------------------------
# Rate family
# --------------------------------------------------------------------------

def _extrapolated(delta, n, t1, t2, steps, window, v1, is_counter, is_rate,
                  dtype):
    """Prometheus extrapolatedRate (reference RateFunctions.scala:37-80)."""
    hi = steps[None, :]
    dur_start = (t1 - (hi - window)).to(dtype) / 1000.0
    dur_end = (hi - t2).to(dtype) / 1000.0
    sampled = (t2 - t1).to(dtype) / 1000.0
    avg_dur = sampled / torch.clamp(n.to(dtype) - 1.0, min=1.0)
    one = torch.ones_like(delta)
    if is_counter:
        dur_zero = sampled * v1 / torch.where(delta == 0, one, delta)
        clamp = (delta > 0) & (v1 >= 0) & (dur_zero < dur_start)
        dur_start = torch.where(clamp, dur_zero, dur_start)
    thresh = avg_dur * 1.1
    half = avg_dur / 2.0
    extrap = (sampled + torch.where(dur_start < thresh, dur_start, half)
              + torch.where(dur_end < thresh, dur_end, half))
    scaled = delta * extrap / torch.where(sampled == 0, one, sampled)
    if is_rate:
        scaled = scaled / (torch.tensor(window, dtype=dtype,
                                        device=delta.device) / 1000.0)
    return torch.where((n >= 2) & (sampled > 0), scaled, _nan(delta))


def _finite_bounds(ts, vals, steps, window):
    """Window bounds restricted to *finite* samples: (j1, j2, n_finite)
    [S,T] row indices of the first/last finite sample in each window and
    the finite count.  NaN rows are "no sample" and never act as
    rate/delta boundary samples."""
    first, last = window_bounds(ts, steps, window)
    fin = torch.isfinite(vals)
    R = vals.shape[1]
    rows = _rows(vals, first)
    lastfin = torch.cummax(torch.where(fin, rows, -1), dim=1).values
    nextfin = torch.flip(torch.cummin(torch.flip(
        torch.where(fin, rows, R), [1]), dim=1).values, [1])
    j2 = _gather_rows(lastfin, torch.clamp(last - 1, min=0))
    j1 = _gather_rows(nextfin, torch.clamp(first, max=R - 1))
    n = _range_sum(_prefix(fin.to(vals.dtype)), first, last)
    valid = (last > first) & (j2 >= j1) & (j1 < last) & (j2 >= 0) & (j1 < R)
    zero = torch.zeros_like(j1)
    return (torch.where(valid, j1, zero), torch.where(valid, j2, zero),
            torch.where(valid, n, torch.zeros_like(n)))


def _rate_family(ts, vals, steps, window, is_counter: bool, is_rate: bool):
    v = counter_correct(vals) if is_counter else vals
    j1, j2, n = _finite_bounds(ts, vals, steps, window)
    t1 = _gather_rows(ts, j1)
    t2 = _gather_rows(ts, j2)
    v1 = _gather_rows(v, j1)
    v2 = _gather_rows(v, j2)
    return _extrapolated(v2 - v1, n, t1, t2, steps, window, v1,
                         is_counter, is_rate, vals.dtype)


def rate(ts, vals, steps, window):
    return _rate_family(ts, vals, steps, window, is_counter=True, is_rate=True)


def increase(ts, vals, steps, window):
    return _rate_family(ts, vals, steps, window, is_counter=True,
                        is_rate=False)


def delta_fn(ts, vals, steps, window):
    return _rate_family(ts, vals, steps, window, is_counter=False,
                        is_rate=False)


def _instant_pair(ts, vals, steps, window, correct: bool):
    """Last two *finite* samples in the window (for irate/idelta)."""
    v = counter_correct(vals) if correct else vals
    first, last = window_bounds(ts, steps, window)
    lastfin = _last_finite(vals, first)
    j2 = _gather_rows(lastfin, torch.clamp(last - 1, min=0))
    j1 = _gather_rows(lastfin, torch.clamp(j2 - 1, min=0))
    valid = (last > first) & (j2 >= first) & (j2 > 0) & (j1 >= first) \
        & (j1 >= 0) & (j1 < j2)
    j1c, j2c = torch.clamp(j1, min=0), torch.clamp(j2, min=0)
    t1, t2 = _gather_rows(ts, j1c), _gather_rows(ts, j2c)
    v1, v2 = _gather_rows(v, j1c), _gather_rows(v, j2c)
    dt = (t2 - t1).to(vals.dtype) / 1000.0
    return v1, v2, dt, valid


def irate(ts, vals, steps, window):
    """Instant rate from the last two samples (reference IRateFunction)."""
    v1, v2, dt, valid = _instant_pair(ts, vals, steps, window, correct=True)
    return torch.where(valid & (dt > 0), (v2 - v1) / dt, _nan(vals))


def idelta(ts, vals, steps, window):
    # zero sampledInterval drops the pair, same as irate
    v1, v2, dt, valid = _instant_pair(ts, vals, steps, window, correct=False)
    return torch.where(valid & (dt > 0), v2 - v1, _nan(vals))


# --------------------------------------------------------------------------
# Gather-path functions
# --------------------------------------------------------------------------

def max_window_rows(ts, steps, window) -> int:
    """The exact max rows in any window: the gather path's tile width
    must bound it (gather_windows truncates wider windows)."""
    first, last = window_bounds(ts, steps, window)
    return int((last - first).max()) if first.numel() else 0


def gather_windows(ts, vals, steps, window, wmax: int):
    """Bounded per-window tiles: values [S,T,W] (NaN-masked) and x-offsets
    [S,T,W] in seconds relative to the step end (for regressions).
    ``wmax`` must bound the max rows per window (:func:`max_window_rows`)."""
    first, last = window_bounds(ts, steps, window)
    S, T = first.shape
    R = vals.shape[1]
    idx = first[:, :, None] + torch.arange(wmax, dtype=first.dtype,
                                           device=first.device)
    in_win = idx < last[:, :, None]
    cidx = idx.clamp(0, R - 1)
    vw = torch.gather(vals[:, None, :].expand(S, T, R), 2, cidx)
    vw = torch.where(in_win, vw, _nan(vals))
    tw = torch.gather(ts[:, None, :].expand(S, T, R), 2, cidx)
    xw = (tw - steps[None, :, None]).to(vals.dtype) / 1000.0
    xw = torch.where(in_win, xw, _nan(vals))
    return vw, xw


def _nan_reduce(vw, reduce, identity: float):
    fin = torch.isfinite(vw)
    out = reduce(torch.where(fin, vw, torch.full_like(vw, identity)), -1)
    return torch.where(fin.any(dim=-1), out, _nan(vw))


def min_over_time(ts, vals, steps, window, wmax: int):
    vw, _ = gather_windows(ts, vals, steps, window, wmax)
    return _nan_reduce(vw, torch.amin, float("inf"))


def max_over_time(ts, vals, steps, window, wmax: int):
    vw, _ = gather_windows(ts, vals, steps, window, wmax)
    return _nan_reduce(vw, torch.amax, float("-inf"))


def quantile_over_time(ts, vals, steps, window, wmax: int, q: float):
    vw, _ = gather_windows(ts, vals, steps, window, wmax)
    if q > 1.0 or q < 0.0:
        # Prometheus returns ±Inf for out-of-range phi on windows that
        # have samples (reference QuantileOverTimeFunction); presence =
        # any non-NaN (±Inf samples count)
        live = (~torch.isnan(vw)).any(dim=-1)
        inf = torch.tensor(float("inf") if q > 1.0 else float("-inf"),
                           dtype=vw.dtype, device=vw.device)
        return torch.where(live, inf, _nan(vw))
    return torch.nanquantile(vw, q, dim=-1)


def mad_over_time(ts, vals, steps, window, wmax: int):
    """Median absolute deviation (reference MedianAbsoluteDeviationOverTime)."""
    vw, _ = gather_windows(ts, vals, steps, window, wmax)
    med = torch.nanquantile(vw, 0.5, dim=-1)
    return torch.nanquantile((vw - med[..., None]).abs(), 0.5, dim=-1)


def _linreg(vw, xw):
    """Least-squares (slope, intercept-at-x=0) over the window tile; x is
    seconds relative to the step end (Prometheus linearRegression with
    interceptTime = range end)."""
    fin = torch.isfinite(vw)
    n = fin.sum(dim=-1).to(vw.dtype)
    zero = torch.zeros_like(vw)
    x = torch.where(fin, xw, zero)
    y = torch.where(fin, vw, zero)
    sx, sy = x.sum(-1), y.sum(-1)
    sxx, sxy = (x * x).sum(-1), (x * y).sum(-1)
    nsafe = torch.clamp(n, min=1.0)
    cov = sxy - sx * sy / nsafe
    var = sxx - sx * sx / nsafe
    slope = cov / torch.where(var == 0, torch.ones_like(var), var)
    intercept = sy / nsafe - slope * (sx / nsafe)
    ok = (n >= 2) & (var > 0)
    nan = _nan(vw)
    return torch.where(ok, slope, nan), torch.where(ok, intercept, nan)


def deriv(ts, vals, steps, window, wmax: int):
    vw, xw = gather_windows(ts, vals, steps, window, wmax)
    return _linreg(vw, xw)[0]


def predict_linear(ts, vals, steps, window, wmax: int, duration_s: float):
    vw, xw = gather_windows(ts, vals, steps, window, wmax)
    slope, intercept = _linreg(vw, xw)
    return intercept + slope * duration_s


def z_score(ts, vals, steps, window):
    """(last - mean) / stddev over the window (reference ZScoreChunked).
    sd == 0 or fewer than 2 samples give NaN: prefix-sum rounding would
    otherwise turn an exact 0/0 into finite garbage or ±inf."""
    lastv, _ = last_sample(ts, vals, steps, window)
    _, sd = stdvar_stddev(ts, vals, steps, window)
    _, n, mean = sum_count_avg(ts, vals, steps, window)
    return torch.where((sd == 0) | ~(n >= 2), _nan(vals), (lastv - mean) / sd)


def holt_winters(ts, vals, steps, window, wmax: int, sf: float, tf: float):
    """Double exponential smoothing, Prometheus semantics: level seeded from
    the first sample, trend from the first pair, smoothed forward over the
    window (reference HoltWintersFunction, rangefn/AggrOverTimeFunctions)."""
    vw, _ = gather_windows(ts, vals, steps, window, wmax)   # [S,T,W]
    s = torch.zeros(vw.shape[:2], dtype=vw.dtype, device=vw.device)
    b = torch.zeros_like(s)
    cnt = torch.zeros(vw.shape[:2], dtype=torch.int32, device=vw.device)
    for w in range(vw.shape[2]):
        y = vw[:, :, w]
        valid = torch.isfinite(y)
        b_eff = torch.where(cnt == 1, y - s, b)  # trend seeds from the first pair
        x = sf * y + (1 - sf) * (s + b_eff)
        s_new = torch.where(cnt == 0, y, x)
        b_new = torch.where(cnt == 0, torch.zeros_like(x),
                            tf * (x - s) + (1 - tf) * b_eff)
        s = torch.where(valid, s_new, s)
        b = torch.where(valid, b_new, b)
        cnt = cnt + valid.to(torch.int32)
    return torch.where(cnt >= 2, s, _nan(vw))
