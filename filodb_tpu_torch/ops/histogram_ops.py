"""Histogram functions on tensors: per-bucket rate, quantile, bucket
extraction.

Replaces the reference's histogram range functions and
HistogramQuantileMapper (reference: rangefn/RangeFunction.scala:376-377 hist
rate/increase, exec/HistogramQuantileMapper.scala:22, rangefn/
AggrOverTimeFunctions.scala SumOverTimeChunkedFunctionH).  Histogram batches
are dense ``[S, R, B]`` cumulative-bucket matrices; all bucket math is
vectorized over B.
"""

from __future__ import annotations

import torch

from filodb_tpu_torch.ops import windows as W


def _per_bucket(fn, ts, hist, *args):
    """Run a per-series window function on every bucket plane: hist
    [S,R,B] -> [S,T,B]."""
    return torch.stack([fn(ts, hist[:, :, b].contiguous(), *args)
                        for b in range(hist.shape[2])], dim=2)


def hist_rate(ts, hist, steps, window):
    """Per-bucket Prometheus rate with counter correction (reference
    HistRateFunction)."""
    return _per_bucket(W.rate, ts, hist, steps, window)


def hist_increase(ts, hist, steps, window):
    return _per_bucket(W.increase, ts, hist, steps, window)


def hist_sum_over_time(ts, hist, steps, window):
    return _per_bucket(W.sum_over_time, ts, hist, steps, window)


def hist_last_sample(ts, hist, steps, window):
    """Last histogram in window (instant selector for hist columns)."""
    return _per_bucket(lambda t, v, s, w: W.last_sample(t, v, s, w)[0],
                       ts, hist, steps, window)


def hist_quantile(tops, hist, q):
    """histogram_quantile over dense bucket matrices [..., B].

    Linear inside the located bucket, second-to-last top for the +Inf
    bucket, NaN for empty/NaN rows (reference: memory/.../vectors/
    Histogram.scala:59-76)."""
    tops = torch.as_tensor(tops, dtype=hist.dtype, device=hist.device)
    B = tops.shape[0]
    total = hist[..., -1]
    rank = q * total
    idx = (hist < rank[..., None]).sum(dim=-1).clamp(max=B - 1)
    count_at = torch.gather(hist, -1, idx[..., None])[..., 0]
    below_idx = torch.clamp(idx - 1, min=0)
    zero = torch.zeros_like(total)
    count_below = torch.where(
        idx > 0, torch.gather(hist, -1, below_idx[..., None])[..., 0], zero)
    top = tops[idx]
    bottom = torch.where(idx > 0, tops[below_idx], zero)
    interp = bottom + (top - bottom) * (rank - count_below) \
        / (count_at - count_below)
    out = torch.where(idx == B - 1, tops[B - 2], interp)
    out = torch.where((idx == 0) & (tops[0] <= 0), tops[0], out)
    out = torch.where(torch.isnan(total), torch.full_like(out, float("nan")),
                      out)
    if q < 0:
        return torch.full_like(out, float("-inf"))
    if q > 1:
        return torch.full_like(out, float("inf"))
    return out


def hist_max_quantile(tops, hist, maxes, q):
    """histogram_max_quantile: clamp to the observed max column."""
    base = hist_quantile(tops, hist, q)
    return torch.where(torch.isfinite(maxes) & (base > maxes), maxes, base)


def hist_bucket(tops, hist, le):
    """histogram_bucket: extract one bucket as a plain series (reference
    InstantFunctionId.HistogramBucket)."""
    tops = torch.as_tensor(tops, dtype=hist.dtype, device=hist.device)
    le_t = torch.tensor(le, dtype=hist.dtype, device=hist.device)
    match = torch.isclose(tops, le_t) | (torch.isinf(tops) & torch.isinf(le_t))
    if not bool(match.any()):
        return torch.full(hist.shape[:-1], float("nan"), dtype=hist.dtype,
                          device=hist.device)
    return hist[..., int(match.to(torch.int8).argmax())]
