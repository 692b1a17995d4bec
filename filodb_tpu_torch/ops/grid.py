"""Aligned-grid window kernels: the memory-bound serving fast path.

The device chunk store lays frozen chunks out as a **time-major bucket
grid** ``vals [B, S]``: column *s* is a series (a lane), row *c* a time
bucket of width ``gstep``, and the sample in row ``c`` has ``ts in
(t0 + (c-1)*gstep, t0 + c*gstep]``; missing buckets hold NaN.  When the
query window is ``K * gstep`` and the query steps land on bucket edges,
window ``t`` covers exactly rows ``[t*stride, t*stride + K - 1]`` — no
search, no gather (reference: query/exec/rangefn/RangeFunction.scala
addChunks + the Prometheus extrapolated rate, RateFunctions.scala:37-80).

Each function below has a hand-written CUDA kernel
(``csrc/grid_kernels.cu``; ``csrc/hist_staged.cu`` for
:func:`hist_grid_grouped_packed` and ``csrc/grouped_staged.cu`` for
:func:`rate_grid_grouped_packed`, each with a direct kernel in
``grid_kernels.cu`` for a step that fits no ring) and a plain PyTorch
version beside it (``<name>_ref``):

- :func:`rate_grid` — decoded planes (``vals`` plus, per mode, a ts
  plane or a per-lane phase row) -> ``[T, S]``; :func:`rate_grid_batch`
  is the same kernel over M members' rows of one set of planes in one
  launch -> ``[M, T, S]``;
- :func:`rate_grid_packed` — XOR-class packed planes
  (``codecs/xorgrid.py``) decoded inside the kernel -> ``[T, width]`` in
  packed lane order;
- :func:`rate_grid_grouped`, :func:`rate_grid_grouped_packed` and
  :func:`hist_grid_grouped_packed` — the same window ops fused with a
  per-group (per-bucket) sum and count -> ``(sum, count)`` ``[G, T]``
  (``[G*hb, T]``): the north-star path (``filodb_tpu_torch/
  northstar.py``);
- :func:`m4_grid` — the M4 points of ``?downsample=`` over a time-major
  ``[T, S]`` result.

:func:`hist_quantile_grid_packed` and :func:`event_topk_grid_packed`
compose them with plain torch (the le-interpolation; a filter, a group
reduce and a ranking).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each wrapper counts its kernel launches
in ``<wrapper>.launches``, and is a program of the kernel ledger
(``utils/devicewatch.timed``, named ``grid.<wrapper>``): the ledger
counts every call, plain or launched, and times one call in N.

Layout contract (enforced by the caller / device store):

- ``ts`` int32 milliseconds relative to an epoch the caller also
  subtracts from ``steps0`` (absolute ms overflow int32);
- row 0 of the given planes is the first bucket of the first window;
- counter correction runs from row 0, i.e. from the start of the scanned
  range.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from filodb_tpu_torch.ops import aggregate, histogram_ops, kernels
from filodb_tpu_torch.utils.devicewatch import timed

_IBIG = 2**30


class GridQuery(NamedTuple):
    """Static configuration of one grid query.

    ``op`` selects the fused window function:
      "rate" / "increase" / "delta" — Prometheus extrapolation (rate and
                                       increase with counter correction)
      "sum" / "count" / "avg" / "min" / "max" — the *_over_time family
      "last"  — last_over_time and the instant selector's lookback
      "stddev" / "stdvar" / "zscore" — window moments
      "changes" / "resets" — consecutive-row pair counts (dense only)
      "irate" / "idelta" — the window's last two samples (dense only)
      "deriv" / "predict_linear" — least-squares slope / forecast
      "timestamp" — the last sample's time, seconds before window end
      "quantile" / "mad" — order statistics (dense only, K <= 32)
      "holt_winters" — double exponential smoothing (dense only)

    ``dense`` asserts the dense-lane contract: over the used rows every
    lane is finite in ALL rows or in NONE.  The caller must prove it;
    setting it on data that breaks it gives wrong results, not an error.
    ``stride``: query step = stride * gstep, window t covers rows
    ``[t*stride, t*stride + K - 1]``.  ``farg`` / ``farg2``: the
    function's scalar arguments (predict_linear's horizon in seconds,
    quantile's phi, holt_winters' smoothing and trend factors).
    """

    nsteps: int       # T output steps
    kbuckets: int     # K = window // gstep buckets per window
    gstep_ms: int     # bucket width
    is_rate: bool = True
    op: str = "rate"
    dense: bool = False
    farg: float = 0.0
    farg2: float = 0.0
    stride: int = 1


# ops whose kernels never read the ts plane
TS_FREE_OPS = frozenset(("quantile", "mad", "holt_winters", "zscore",
                         "last", "sum", "count", "avg", "min", "max",
                         "changes", "resets", "stddev", "stdvar"))
# ops with a dense + uniform-phase mode: one phase row replaces ts
PHASE_OPS = frozenset(("rate", "increase", "delta"))
# ops whose dense computation is independent of K
K_FREE_DENSE_OPS = frozenset(("rate", "increase", "last", "count",
                              "irate", "idelta", "delta", "timestamp"))
# ops served only under the proven dense contract
DENSE_ONLY_OPS = frozenset(("changes", "resets", "irate", "idelta",
                            "quantile", "mad", "holt_winters"))

# the ops of every grid kernel (every op of the TPU kernels); the packed
# ones serve those that read no ts plane
SERVED_OPS = TS_FREE_OPS | PHASE_OPS | frozenset(
    ("irate", "idelta", "deriv", "predict_linear", "timestamp"))

MAX_K_BUCKETS = 64       # K cap of the ops that walk every window row
MAX_DENSE_K = 1024       # K cap of the K-free ops under the dense contract
MAX_GRID_SPAN_ROWS = 16_384   # rows staged/assembled per query
SORT_OPS_MAX_K = 32


def _rows_needed(q: GridQuery) -> int:
    return (q.nsteps - 1) * q.stride + q.kbuckets


def max_k_for(op: str, dense: bool) -> int:
    if op in ("quantile", "mad"):
        return SORT_OPS_MAX_K
    return MAX_DENSE_K if dense and op in K_FREE_DENSE_OPS \
        else MAX_K_BUCKETS


def supports_grid(window_ms: int, step_ms: int, gstep_ms: int,
                  nsteps: int = 1, max_k: int = MAX_K_BUCKETS) -> bool:
    """Host-side check: can the aligned fast path serve this query?  The
    query step may be any multiple of the bucket width; ``max_k`` caps
    K = window/gstep (pass ``max_k_for(op, dense)``); total input rows
    are capped by the block-assembly bound."""
    if not (window_ms > 0 and gstep_ms > 0 and step_ms > 0
            and step_ms % gstep_ms == 0 and window_ms % gstep_ms == 0
            and window_ms // gstep_ms <= max_k):
        return False
    stride = step_ms // gstep_ms
    rows = (nsteps - 1) * stride + window_ms // gstep_ms
    return rows <= MAX_GRID_SPAN_ROWS


def phase_eligible(q: GridQuery) -> bool:
    """Can this query use the uniform-phase mode (given a proven phase
    vector)?  K >= 2: the collapsed extrapolation divides by K-1."""
    return q.dense and q.op in PHASE_OPS and q.kbuckets >= 2


def _phase_mode(q: GridQuery, phase) -> bool:
    return phase is not None and phase_eligible(q)


def _mode_for(q: GridQuery, phase) -> str:
    """Input-plane mode: 'free' ops read only values; 'phase' reads
    values + one phase row; 'ts' reads both planes."""
    if q.op in TS_FREE_OPS:
        return "free"
    if _phase_mode(q, phase):
        return "phase"
    return "ts"


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU serving path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _win(x: torch.Tensor, d: int, q: GridQuery) -> torch.Tensor:
    """Row d of every window: input rows d, d+stride, ... -> [T, L]."""
    return x[d:d + (q.nsteps - 1) * q.stride + 1:q.stride]


def _correct(vals: torch.Tensor, dense: bool) -> torch.Tensor:
    """Counter correction: add the running sum of counter drops.  A drop
    is measured against the previous FINITE sample (a missed scrape
    leaves a NaN bucket); before the first finite sample the previous
    value is row 0's, and row 0 has no drop.  Under the dense contract
    the previous sample is the previous row.  NaN compares false, so a
    NaN on either side drops nothing."""
    nb = vals.shape[0]
    if dense:
        prev = vals.roll(1, 0)
    else:
        fin = torch.isfinite(vals)
        row = torch.arange(nb, device=vals.device)[:, None]
        last = torch.where(fin, row, -1).cummax(0).values
        ffill = torch.where(last >= 0, vals.gather(0, last.clamp(min=0)),
                            vals[0:1].expand_as(vals))
        prev = ffill.roll(1, 0)
    prev[0] = vals[0]
    drop = torch.where(vals < prev, prev, torch.zeros_like(vals))
    return vals + drop.cumsum(0)


def _window_stats_dense(ts, vals, vcorr, q: GridQuery):
    """Dense lanes: first/last of window t are rows t*stride and
    t*stride+K-1, and the finite count is K (0 for empty lanes)."""
    K = q.kbuckets
    live = torch.isfinite(_win(vals, 0, q))
    nf = live.to(vcorr.dtype) * K
    return (nf, _win(ts, 0, q), _win(ts, K - 1, q), _win(vcorr, 0, q),
            _win(vcorr, K - 1, q))


def _window_stats(ts, fin, vcorr, q: GridQuery):
    """First/last finite sample (ts and value) and finite count of every
    window, by K select passes."""
    shape = (q.nsteps, vcorr.shape[1])
    dt = vcorr.dtype
    nf = torch.zeros(shape, dtype=dt, device=vcorr.device)
    t2 = torch.full(shape, _IBIG, dtype=ts.dtype, device=ts.device)
    v2 = torch.full(shape, float("nan"), dtype=dt, device=vcorr.device)
    for d in range(q.kbuckets):            # forward: last finite wins
        fd = _win(fin, d, q)
        nf = nf + fd.to(dt)
        t2 = torch.where(fd, _win(ts, d, q), t2)
        v2 = torch.where(fd, _win(vcorr, d, q), v2)
    t1 = torch.full(shape, _IBIG, dtype=ts.dtype, device=ts.device)
    v1 = torch.full(shape, float("nan"), dtype=dt, device=vcorr.device)
    for d in range(q.kbuckets - 1, -1, -1):  # reverse: first finite wins
        fd = _win(fin, d, q)
        t1 = torch.where(fd, _win(ts, d, q), t1)
        v1 = torch.where(fd, _win(vcorr, d, q), v1)
    return nf, t1, t2, v1, v2


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _extrapolate(nf, t1, t2, v1, v2, steps0: int, q: GridQuery):
    """Prometheus extrapolatedRate on [T, L] tiles (reference:
    RateFunctions.scala:37-80): the window geometry from the first and
    last finite samples' timestamps, then :func:`_extrapolate_geometry`."""
    dt = v1.dtype
    window = q.kbuckets * q.gstep_ms
    # divisors are tensors: torch divides by a Python scalar on CUDA as a
    # multiply by its reciprocal, one rounding away from the kernel's
    # IEEE division
    ms_per_s = _scalar(1000.0, v1)
    tcol = torch.arange(q.nsteps, dtype=torch.int32, device=v1.device)
    hi = (tcol * (q.gstep_ms * q.stride) + steps0).to(dt)[:, None]
    lo = hi - _scalar(window, v1)
    t1f = t1.to(dt)
    t2f = t2.to(dt)
    return _extrapolate_geometry(nf, (t1f - lo) / ms_per_s,
                                 (hi - t2f) / ms_per_s,
                                 (t2f - t1f) / ms_per_s, v1, v2, q)


def _extrapolate_geometry(nf, dur_start, dur_end, sampled, v1, v2,
                          q: GridQuery):
    """The extrapolation from a window's geometry in seconds: the gaps
    from the window's start to its first sample and from its last
    sample to its end, and the sampled interval between them."""
    window = q.kbuckets * q.gstep_ms
    ms_per_s = _scalar(1000.0, v1)
    avg_dur = sampled / torch.clamp(nf - 1.0, min=1.0)
    delta = v2 - v1
    one = torch.ones_like(delta)
    if q.op != "delta":    # counter zero-point clamp (rate/increase only)
        dur_zero = sampled * v1 / torch.where(delta == 0, one, delta)
        clamp = (delta > 0) & (v1 >= 0) & (dur_zero < dur_start)
        dur_start = torch.where(clamp, dur_zero, dur_start)
    thresh = avg_dur * 1.1
    half = avg_dur / _scalar(2.0, v1)
    extrap = (sampled + torch.where(dur_start < thresh, dur_start, half)
              + torch.where(dur_end < thresh, dur_end, half))
    scaled = delta * extrap / torch.where(sampled == 0, one, sampled)
    if q.op == "rate" and q.is_rate:
        scaled = scaled / (_scalar(window, v1) / ms_per_s)
    return torch.where((nf >= 2) & (sampled > 0), scaled,
                       torch.full_like(scaled, float("nan")))


def _phase_block(phase_row, vals, q: GridQuery):
    """rate/increase/delta under dense + uniform phase: every live lane
    is scraped at a constant offset ``phase in (0, gstep]`` within its
    bucket, so every window's geometry is a per-lane constant: the first
    sample lies ``phase`` after the window's start, the last ``gstep -
    phase`` before its end, ``(K-1)*gstep`` apart, and the window holds
    K samples.  The kernel collapses the formula to a divide-free form.
    For rate and increase the plain version computes the ts path's own
    formula (:func:`_extrapolate_geometry`) on that geometry, so a
    window answers the same bits on the CPU whichever plan mode serves
    it (the geometry is exact: whole milliseconds, divided once); delta,
    which reads no correction prefix, keeps the kernel's form
    ``delta * K/(K-1)``, bit for bit the kernel's.  Liveness is row
    0's."""
    dt = vals.dtype
    K, g = q.kbuckets, q.gstep_ms
    live_row = torch.isfinite(vals[0:1])
    if q.op == "delta":
        v1 = _win(vals, 0, q)
        out = (_win(vals, K - 1, q) - v1) * _scalar(K / (K - 1), vals)
    else:
        src = _correct(vals, dense=True)
        ms_per_s = _scalar(1000.0, vals)
        ph = phase_row.to(dt)
        nf = torch.full_like(ph, float(K))
        out = _extrapolate_geometry(nf, ph / ms_per_s,
                                    (_scalar(g, vals) - ph) / ms_per_s,
                                    _scalar((K - 1) * g, vals) / ms_per_s,
                                    _win(src, 0, q), _win(src, K - 1, q), q)
    return torch.where(live_row, out, torch.full_like(out, float("nan")))


def _dense_required(q: GridQuery) -> None:
    if not q.dense:
        raise ValueError(f"grid op {q.op} requires the dense contract")


def _nan_tile(vals, q: GridQuery) -> torch.Tensor:
    return torch.full((q.nsteps, vals.shape[1]), float("nan"),
                      dtype=vals.dtype, device=vals.device)


def _instant_pair_block(ts, vals, q: GridQuery):
    """irate/idelta under the dense contract: the window's last two
    samples are its last two rows (reference: IRateFunction).  The
    counter correction between adjacent samples collapses to the pair:
    on a reset the increase is ``v2``."""
    _dense_required(q)
    K = q.kbuckets
    if K < 2:
        return _nan_tile(vals, q)
    v2, v1 = _win(vals, K - 1, q), _win(vals, K - 2, q)
    t2, t1 = _win(ts, K - 1, q), _win(ts, K - 2, q)
    live = torch.isfinite(v2)
    delta = v2 - v1
    if q.op == "irate":
        delta = torch.where(v2 < v1, v2, delta)
    dt_s = (t2 - t1).to(vals.dtype) / _scalar(1000.0, vals)
    ok = live & (dt_s > 0)
    out = delta if q.op == "idelta" else delta / dt_s
    return torch.where(ok, out, _scalar(float("nan"), vals))


def _changes_block(vals, q: GridQuery):
    """changes/resets under the dense contract: the consecutive-row
    pairs inside the window (reference: changes_over_time /
    resets_over_time)."""
    live = torch.isfinite(_win(vals, 0, q))
    c = torch.zeros_like(_win(vals, 0, q))
    prev = _win(vals, 0, q)
    for d in range(1, q.kbuckets):
        cur = _win(vals, d, q)
        hit = (cur != prev) if q.op == "changes" else (cur < prev)
        c = c + hit.to(vals.dtype)
        prev = cur
    return torch.where(live, c, _scalar(float("nan"), vals))


def _window_first(vals, fin, q: GridQuery):
    """Each window's first finite value ``[T, L]`` (NaN where none)."""
    c = _nan_tile(vals, q)
    for d in range(q.kbuckets - 1, -1, -1):  # reverse: first finite wins
        c = torch.where(_win(fin, d, q), _win(vals, d, q), c)
    return c


def _masked_moments(vals, fin, q: GridQuery):
    """Per-window ``(n, c, mean_x, var)`` of the finite values, each
    taken relative to the window's first finite value ``c``.  The
    anchor keeps ``s2/n - mean^2`` from cancelling where a lane sits far
    from 0 (a counter near 1e6 moving by a few a step): the f32 answer
    stays within a few ulps of the variance, where a lane-wide centre
    leaves 1e-4 of it and more."""
    c = _window_first(vals, fin, q)
    zero = torch.zeros_like(c)
    s1, s2, n = zero, zero, zero
    for d in range(q.kbuckets):
        fd = _win(fin, d, q)
        xd = torch.where(fd, _win(vals, d, q) - c, zero)
        s1 = s1 + xd
        s2 = s2 + xd * xd
        n = n + fd.to(vals.dtype)
    nsafe = torch.clamp(n, min=1.0)
    mean_x = s1 / nsafe
    var = torch.clamp(s2 / nsafe - mean_x * mean_x, min=0.0)
    return n, c, mean_x, var


def _zscore_block(vals, q: GridQuery):
    """(last - mean) / stddev over the window (reference ZScoreChunked),
    NaN where n < 2 or the deviation is 0."""
    fin = torch.isfinite(vals)
    n, c, mean_x, var = _masked_moments(vals, fin, q)
    sd = torch.sqrt(var)
    lastv = _nan_tile(vals, q)
    for d in range(q.kbuckets):
        lastv = torch.where(_win(fin, d, q), _win(vals, d, q), lastv)
    out = ((lastv - c) - mean_x) / torch.where(sd == 0, _scalar(1.0, vals),
                                                sd)
    return torch.where((n >= 2) & (sd > 0), out,
                       _scalar(float("nan"), vals))


def _window_end(steps0: int, q: GridQuery, like) -> torch.Tensor:
    """Each window's end, epoch-relative int32 ms ``[T, 1]``."""
    tcol = torch.arange(q.nsteps, dtype=torch.int32, device=like.device)
    return (tcol * (q.gstep_ms * q.stride) + steps0)[:, None]


def _linreg_block(ts, vals, steps0: int, q: GridQuery):
    """Least-squares slope (deriv) or forecast ``farg`` seconds past the
    window end (predict_linear) over each window (reference: Prometheus
    linearRegression, intercept at the window end).  x is seconds
    relative to the window end, shifted by +W/2, and y relative to the
    window's first finite value, so that the f32 sums do not cancel
    (the slope is shift-invariant in both)."""
    dt = vals.dtype
    fin = torch.isfinite(vals)
    c = _window_first(vals, fin, q)
    hi = _window_end(steps0, q, vals).to(dt)
    shift = _scalar(q.kbuckets * q.gstep_ms / 1000.0 / 2.0, vals)
    ms_per_s = _scalar(1000.0, vals)
    zero = _scalar(0.0, vals)
    shape = (q.nsteps, vals.shape[1])
    n, sx, sy, sxx, sxy = (torch.zeros(shape, dtype=dt, device=vals.device)
                           for _ in range(5))
    for d in range(q.kbuckets):
        fd = _win(fin, d, q)
        x = (_win(ts, d, q).to(dt) - hi) / ms_per_s + shift
        x = torch.where(fd, x, zero)
        y = torch.where(fd, _win(vals, d, q) - c, zero)
        n = n + fd.to(dt)
        sx = sx + x
        sy = sy + y
        sxx = sxx + x * x
        sxy = sxy + x * y
    nsafe = torch.clamp(n, min=1.0)
    cov = sxy - sx * sy / nsafe
    var = sxx - sx * sx / nsafe
    slope = cov / torch.where(var == 0, _scalar(1.0, vals), var)
    ok = (n >= 2) & (var > 0)
    nan = _scalar(float("nan"), vals)
    if q.op == "deriv":
        return torch.where(ok, slope, nan)
    intercept = sy / nsafe - slope * (sx / nsafe - shift)
    out = (intercept + slope * _scalar(q.farg, vals)) + c
    return torch.where(ok, out, nan)


def _timestamp_block(ts, vals, steps0: int, q: GridQuery):
    """timestamp() as seconds RELATIVE to each window's end: the
    magnitudes stay within the window span, exact in f32.  The store
    re-bases them to absolute seconds in f64."""
    hi = _window_end(steps0, q, vals)
    ms_per_s = _scalar(1000.0, vals)
    nan = _scalar(float("nan"), vals)
    if q.dense:
        live = torch.isfinite(_win(vals, 0, q))
        rel = _win(ts, q.kbuckets - 1, q) - hi
        return torch.where(live, rel.to(vals.dtype) / ms_per_s, nan)
    fin = torch.isfinite(vals)
    sel = torch.full((q.nsteps, vals.shape[1]), _IBIG, dtype=ts.dtype,
                     device=ts.device)
    for d in range(q.kbuckets):            # forward: last finite wins
        sel = torch.where(_win(fin, d, q), _win(ts, d, q), sel)
    return torch.where(sel != _IBIG, (sel - hi).to(vals.dtype) / ms_per_s,
                       nan)


def batcher_pairs(K: int) -> list:
    """Batcher odd-even mergesort compare-exchange pairs for K inputs: a
    sorting network fixed by K."""
    pairs = []
    p = 1
    while p < K:
        k = p
        while k >= 1:
            for j in range(k % p, K - k, 2 * k):
                for i in range(0, min(k, K - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _sort_tiles(tiles: list) -> list:
    out = list(tiles)
    for a, b in batcher_pairs(len(out)):
        out[a], out[b] = (torch.minimum(out[a], out[b]),
                          torch.maximum(out[a], out[b]))
    return out


def _interp_weights(phi: float, K: int) -> tuple:
    """Linear interpolation at quantile ``phi`` of K sorted values:
    ``(lo, hi, w_lo, w_hi, fill)``.  ``lo < 0`` means the answer is
    ``fill`` for every live lane: NaN for a NaN phi, +Inf above 1, -Inf
    below 0, as Prometheus answers (reference
    QuantileOverTimeFunction).  The weights are computed in double and
    rounded once to the values' type by the caller."""
    if math.isnan(phi):
        return -1, -1, 0.0, 0.0, float("nan")
    if phi > 1.0:
        return -1, -1, 0.0, 0.0, float("inf")
    if phi < 0.0:
        return -1, -1, 0.0, 0.0, float("-inf")
    r = phi * (K - 1)
    lo, hi = int(math.floor(r)), int(math.ceil(r))
    frac = r - lo
    return lo, hi, 1.0 - frac, frac, 0.0


def _interp_rank(sorted_tiles: list, phi: float):
    lo, hi, w_lo, w_hi, fill = _interp_weights(phi, len(sorted_tiles))
    s = sorted_tiles
    if lo < 0:
        return torch.full_like(s[0], fill)
    if lo == hi:
        return s[lo]
    return s[lo] * _scalar(w_lo, s[0]) + s[hi] * _scalar(w_hi, s[0])


def _sort_ops_block(vals, q: GridQuery):
    """quantile_over_time / mad_over_time under the dense contract:
    the K window rows through a sorting network, then interpolation at
    fixed ranks (reference: QuantileOverTimeChunkedFunction /
    MedianAbsoluteDeviationOverTime)."""
    _dense_required(q)
    tiles = [_win(vals, d, q) for d in range(q.kbuckets)]
    live = torch.isfinite(tiles[0])
    s = _sort_tiles(tiles)
    if q.op == "quantile":
        out = _interp_rank(s, q.farg)
    else:                                     # mad
        med = _interp_rank(s, 0.5)
        out = _interp_rank(_sort_tiles([torch.abs(t - med) for t in tiles]),
                           0.5)
    return torch.where(live, out, _scalar(float("nan"), vals))


def _holt_winters_block(vals, q: GridQuery):
    """Double exponential smoothing under the dense contract: the level
    starts at the window's first row and the trend at its first pair,
    then K-1 steps of the recurrence (reference HoltWintersFunction)."""
    _dense_required(q)
    if q.kbuckets < 2:
        return _nan_tile(vals, q)
    sf = _scalar(q.farg, vals)
    tf = _scalar(q.farg2, vals)
    one = _scalar(1.0, vals)
    s = _win(vals, 0, q)
    live = torch.isfinite(s)
    b = torch.zeros_like(s)
    for i in range(1, q.kbuckets):
        y = _win(vals, i, q)
        b_eff = (y - s) if i == 1 else b
        xn = sf * y + (one - sf) * (s + b_eff)
        b = tf * (xn - s) + (one - tf) * b_eff
        s = xn
    return torch.where(live, s, _scalar(float("nan"), vals))


def _agg_block(vals, q: GridQuery):
    """The *_over_time family on the aligned grid (reference:
    AggrOverTimeFunctions.scala sum/count/avg/min/max/last,
    stddev/stdvar, changes/resets)."""
    K = q.kbuckets
    dt = vals.dtype
    nan = float("nan")
    if q.dense and q.op not in ("stddev", "stdvar"):
        if q.op == "last":
            return _win(vals, K - 1, q)
        if q.op in ("changes", "resets"):
            return _changes_block(vals, q)
        live = torch.isfinite(_win(vals, 0, q))
        if q.op == "count":
            return torch.where(live, _scalar(K, vals), _scalar(nan, vals))
        acc = _win(vals, 0, q)
        for d in range(1, K):
            x = _win(vals, d, q)
            if q.op in ("sum", "avg"):
                acc = acc + x
            elif q.op == "min":
                acc = torch.minimum(acc, x)
            else:
                acc = torch.maximum(acc, x)
        if q.op == "avg":
            acc = acc / _scalar(K, vals)
        return torch.where(live, acc, _scalar(nan, vals))
    if q.op in DENSE_ONLY_OPS:
        _dense_required(q)
    fin = torch.isfinite(vals)
    shape = (q.nsteps, vals.shape[1])
    if q.op == "last":
        v2 = torch.full(shape, nan, dtype=dt, device=vals.device)
        for d in range(K):                  # forward: last finite wins
            v2 = torch.where(_win(fin, d, q), _win(vals, d, q), v2)
        return v2
    if q.op in ("stddev", "stdvar"):
        n, _c, _mean_x, var = _masked_moments(vals, fin, q)
        var = torch.where(n > 0, var, _scalar(nan, vals))
        return torch.sqrt(var) if q.op == "stddev" else var
    c = torch.zeros(shape, dtype=dt, device=vals.device)
    if q.op in ("sum", "avg", "count"):
        acc = torch.zeros(shape, dtype=dt, device=vals.device)
        ident = 0.0
    else:
        ident = float("inf") if q.op == "min" else float("-inf")
        acc = torch.full(shape, ident, dtype=dt, device=vals.device)
    for d in range(K):
        fd = _win(fin, d, q)
        vd = torch.where(fd, _win(vals, d, q), _scalar(ident, vals))
        c = c + fd.to(dt)
        if q.op in ("sum", "avg"):
            acc = acc + vd
        elif q.op == "min":
            acc = torch.minimum(acc, vd)
        elif q.op == "max":
            acc = torch.maximum(acc, vd)
    if q.op == "count":
        return torch.where(c > 0, c, _scalar(nan, vals))
    if q.op == "avg":
        return torch.where(c > 0, acc / torch.clamp(c, min=1.0),
                           _scalar(nan, vals))
    if q.op in ("min", "max"):
        return torch.where(torch.isfinite(acc), acc, _scalar(nan, vals))
    return torch.where(c > 0, acc, _scalar(nan, vals))


def _check_op(q: GridQuery) -> None:
    if q.op not in SERVED_OPS:
        raise ValueError(f"grid op {q.op!r} is not served by this kernel "
                         f"(have {sorted(SERVED_OPS)})")


def _free_block(vals, q: GridQuery):
    """The TS_FREE ops: values only."""
    if q.op in ("quantile", "mad"):
        return _sort_ops_block(vals, q)
    if q.op == "holt_winters":
        return _holt_winters_block(vals, q)
    if q.op == "zscore":
        return _zscore_block(vals, q)
    return _agg_block(vals, q)


def rate_grid_ref(ts, vals, steps0: int, q: GridQuery, phase=None):
    """Plain version of :func:`rate_grid`: ``vals [B, S]`` (and ``ts
    [B, S]`` int in ts mode, or ``phase [S]`` int in phase mode) ->
    ``[T, S]`` in the dtype of ``vals``."""
    _check_op(q)
    if _phase_mode(q, phase):
        ph = torch.as_tensor(phase).reshape(1, -1)
        return _phase_block(ph, vals, q)
    if q.op in ("irate", "idelta"):
        return _instant_pair_block(ts, vals, q)
    if q.op == "timestamp":
        return _timestamp_block(ts, vals, int(steps0), q)
    if q.op in ("deriv", "predict_linear"):
        return _linreg_block(ts, vals, int(steps0), q)
    if q.op in TS_FREE_OPS:
        return _free_block(vals, q)
    if q.op == "delta":
        vcorr = vals
    else:
        vcorr = _correct(vals, dense=q.dense)
    if q.dense:
        stats = _window_stats_dense(ts, vals, vcorr, q)
    else:
        stats = _window_stats(ts, torch.isfinite(vals), vcorr, q)
    return _extrapolate(*stats, int(steps0), q)


# ---------------------------------------------------------------------------
# Packed planes: plain decode + plain windowed function
# ---------------------------------------------------------------------------

# class planes in packed order: (plane key, meta key, kernel plane kind)
_PLANES = (("p8", "m8", 0), ("p16", "m16", 1), ("p32", "m32", 2),
           ("raw", "mraw", 3))
_MASK32 = 0xFFFFFFFF


def _packed_planes(packed: dict) -> list:
    """(plane, meta, kind) triples in packed (class) order, empty planes
    skipped."""
    out = []
    for key, mkey, kind in _PLANES:
        p = packed.get(key)
        if p is None or p.shape[1] == 0:
            continue
        m = packed.get(mkey)
        if m is None:
            raise ValueError(f"packed plane {key} has no meta tile {mkey} "
                             f"(f64 packs carry no meta; the packed "
                             f"kernel is f32-only)")
        out.append((p, m, kind))
    return out


def packed_width(packed: dict) -> int:
    """Total packed lane count (class-plane widths, pads included)."""
    return sum(p.shape[1] for p, _m, _k in _packed_planes(packed))


def widen_words(p: torch.Tensor) -> torch.Tensor:
    """A plane's words as int64 holding the unsigned word value.  16- and
    32-bit class planes are held as signed views of the same bits, raw
    and first-value planes as float32/float64 (64-bit words keep their
    bits as they are)."""
    if p.dtype == torch.float64:
        return p.view(torch.int64)
    if p.dtype == torch.float32:
        p = p.view(torch.int32)
    return p.to(torch.int64) & ((1 << (8 * p.element_size())) - 1)


def bits_to_f32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit word -> the float32 with those bits."""
    s = u - ((u >> 31) & 1) * (1 << 32)
    return s.to(torch.int32).view(torch.float32)


def prefix_xor(u: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-XOR down axis 0 (log-step shifted XOR: torch has
    no cumulative XOR)."""
    sh = 1
    while sh < u.shape[0]:
        u = torch.cat([u[:sh], u[sh:] ^ u[:-sh]])
        sh *= 2
    return u


def decode_packed_plane(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain decode of one f32 class plane ``[B, n]`` with its ``[8, n]``
    meta tile: widen -> per-lane shift -> prefix-XOR down rows -> XOR
    the first-value bits -> bitcast f32.  Bit-exact."""
    u = (widen_words(p) << m[0].to(torch.int64)[None, :]) & _MASK32
    u = prefix_xor(u)
    first = m[1].to(torch.int64) & _MASK32
    return bits_to_f32(u ^ first[None, :])


def _packed_check(packed: dict, q: GridQuery, row0: int,
                  use_phase: bool) -> None:
    _check_op(q)
    if use_phase:
        if not phase_eligible(q):
            raise ValueError(f"op {q.op} not phase-eligible (dense="
                             f"{q.dense}, K={q.kbuckets})")
    elif q.op not in TS_FREE_OPS:
        raise ValueError(f"packed kernel serves TS_FREE or phase-mode "
                         f"ops only; {q.op} needs a ts plane")
    for p, _m, _k in _packed_planes(packed):
        if row0 < 0 or p.shape[0] < row0 + _rows_needed(q):
            raise ValueError(
                f"packed block has {p.shape[0]} rows; query needs rows "
                f"[{row0}, {row0 + _rows_needed(q)})")


def _packed_plane_outputs(packed: dict, q: GridQuery, row0: int,
                         use_phase: bool):
    """Per class plane, in packed order: the decoded rows ``[row0, row0 +
    rows_needed)`` through the phase or free op chain -> ``(out [T, n],
    ok)``, where ``ok`` says which cells a group reduce takes: row 0's
    liveness ``[1, n]`` in phase mode, ``isfinite(out)`` otherwise."""
    need = _rows_needed(q)
    for p, m, _kind in _packed_planes(packed):
        vals = decode_packed_plane(p, m)[row0:row0 + need]
        if use_phase:
            yield _phase_block(m[2:3], vals, q), torch.isfinite(vals[0:1])
        else:
            out = _free_block(vals, q)
            yield out, torch.isfinite(out)


def rate_grid_packed_ref(packed: dict, steps0: int, q: GridQuery,
                         row0: int = 0, use_phase: bool = False):
    """Plain version of :func:`rate_grid_packed`: decode every class
    plane, take rows ``[row0, row0 + rows_needed)``, run the phase or
    free op chain -> ``[T, packed_width]`` f32 in packed lane order."""
    _packed_check(packed, q, row0, use_phase)
    outs = [out for out, _ok in
            _packed_plane_outputs(packed, q, row0, use_phase)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Grouped forms: the window op plus a per-group sum and count, fused
# ---------------------------------------------------------------------------

def _group_reduce(out: torch.Tensor, ok: torch.Tensor, group_lanes: int,
                  hb: int = 1):
    """``out [T, n]`` and its take-mask ``ok`` (``[T, n]`` or ``[1, n]``)
    -> ``(sum, count)`` ``[n // group_lanes * hb, T]``: group g is
    columns ``[g*group_lanes, (g+1)*group_lanes)``, and its column c
    reduces into slot ``g*hb + c % hb``.  A taken cell adds its value as
    it is (a live lane's NaN poisons its group's sum, as on the TPU).
    With buckets (hb > 1) each bucket's series are added left to right,
    in lane order, as the kernel adds them: the histogram quantile over
    these sums is ill-conditioned where two bucket sums nearly tie, and
    a sum in another order would move it there."""
    nsteps, n = out.shape
    ok = ok.expand(nsteps, n)
    shape = (nsteps, n // group_lanes, group_lanes // hb, hb)
    v = torch.where(ok, out, torch.zeros_like(out)).reshape(shape)
    c = ok.to(out.dtype).reshape(shape).sum(2)
    if hb == 1:
        s = v.sum(2)
    else:
        s = torch.zeros_like(v[:, :, 0])
        for i in range(shape[2]):
            s = s + v[:, :, i]
    return (s.permute(1, 2, 0).reshape(-1, nsteps),
            c.permute(1, 2, 0).reshape(-1, nsteps))


def _grouped_check(vals, q: GridQuery, group_lanes: int) -> None:
    _check_op(q)
    nb, ns = vals.shape
    if group_lanes < 1 or ns == 0 or ns % group_lanes != 0:
        raise ValueError(f"series count {ns} must be a non-zero multiple of "
                         f"group_lanes={group_lanes} (pad groups with NaN "
                         f"columns)")
    if nb < _rows_needed(q):
        raise ValueError(f"grid has {nb} rows; need (nsteps-1)*stride+K = "
                         f"{_rows_needed(q)}")


def rate_grid_grouped_ref(ts, vals, steps0: int, q: GridQuery,
                          group_lanes: int = 1024, phase=None):
    """Plain version of :func:`rate_grid_grouped`: :func:`rate_grid_ref`,
    then each group's sum and count over its contiguous lanes."""
    _grouped_check(vals, q, group_lanes)
    out = rate_grid_ref(ts, vals, steps0, q, phase=phase)
    ok = torch.isfinite(vals[0:1]) if _phase_mode(q, phase) \
        else torch.isfinite(out)
    return _group_reduce(out, ok, group_lanes)


def _grouped_packed_check(packed: dict, q: GridQuery, row0: int,
                          use_phase: bool, group_lanes: int,
                          hb: int = 1) -> list:
    """The group-aligned pack contract; returns the class planes."""
    if hb < 1 or group_lanes < 1 or group_lanes % hb != 0:
        raise ValueError(f"group_lanes {group_lanes} not a multiple of the "
                         f"bucket count {hb}")
    _packed_check(packed, q, row0, use_phase)
    inv = packed.get("inv")
    if inv is not None and packed_width(packed) != inv.shape[0]:
        # a zero pad lane decodes to a constant finite 0.0 series: with no
        # group map to drop it, it would count as a live series in its
        # group (+1 count, skewed avg) — reject rather than corrupt
        raise ValueError(
            f"pack carries {packed_width(packed) - inv.shape[0]} "
            f"alignment-pad lanes; the fused grouped kernels have no group "
            f"map to drop them — use rate_grid_packed + a segment reduce, "
            f"or a min_width single-class pack")
    planes = _packed_planes(packed)
    if not planes:
        raise ValueError("pack has no class planes")
    for p, _m, _kind in planes:
        if p.shape[1] % group_lanes != 0:
            raise ValueError(
                f"packed plane width {p.shape[1]} must be a whole number of "
                f"{group_lanes}-lane groups — use the group-aligned pack "
                f"layout")
    return planes


def _grouped_packed_ref(packed: dict, q: GridQuery, row0: int,
                        use_phase: bool, group_lanes: int, hb: int):
    _grouped_packed_check(packed, q, row0, use_phase, group_lanes, hb)
    sums, cnts = [], []
    for out, ok in _packed_plane_outputs(packed, q, row0, use_phase):
        s, c = _group_reduce(out, ok, group_lanes, hb)
        sums.append(s)
        cnts.append(c)
    if len(sums) == 1:
        return sums[0], cnts[0]
    return torch.cat(sums), torch.cat(cnts)


def rate_grid_grouped_packed_ref(packed: dict, steps0: int, q: GridQuery,
                                 group_lanes: int = 1024, row0: int = 0,
                                 use_phase: bool = True):
    """Plain version of :func:`rate_grid_grouped_packed`: each plane's
    decoded window op, then each group's sum and count."""
    return _grouped_packed_ref(packed, q, row0, use_phase, group_lanes, 1)


def hist_grid_grouped_packed_ref(packed: dict, steps0: int, q: GridQuery,
                                 hb: int, group_lanes: int = 1024,
                                 row0: int = 0, use_phase: bool = True):
    """Plain version of :func:`hist_grid_grouped_packed`: each plane's
    decoded window op per bucket column, then each group's per-bucket
    sum and count."""
    return _grouped_packed_ref(packed, q, row0, use_phase, group_lanes, hb)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_OP_CODE = {"sum": 0, "count": 1, "avg": 2, "min": 3, "max": 4, "last": 5,
            "rate": 6, "increase": 7, "delta": 8, "irate": 9, "idelta": 10,
            "changes": 11, "resets": 12, "stddev": 13, "stdvar": 14,
            "zscore": 15, "deriv": 16, "predict_linear": 17,
            "timestamp": 18, "quantile": 19, "mad": 20, "holt_winters": 21}
_MODE_CODE = {"free": 0, "phase": 1, "ts": 2}


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _int32_args(*vals: int) -> list:
    for v in vals:
        if not -2**31 <= int(v) < 2**31:
            raise ValueError(f"kernel argument {v} overflows int32")
    return [ctypes.c_int(int(v)) for v in vals]


def _fn_args(q: GridQuery) -> list:
    """The second op set's arguments for the kernel: farg, farg2 (f32, as
    the plain versions round them), then quantile/mad's interpolation
    ranks, weights and fill (:func:`_interp_weights`; mad's median is at
    phi 0.5).  Ops that need the dense contract or a short window are
    refused here, as the plain versions refuse them."""
    if q.op in DENSE_ONLY_OPS:
        _dense_required(q)
    rank = (-1, -1, 0.0, 0.0, 0.0)
    if q.op in ("quantile", "mad"):
        if not 1 <= q.kbuckets <= SORT_OPS_MAX_K:
            raise ValueError(f"{q.op} takes 1 to {SORT_OPS_MAX_K} buckets "
                             f"a window, not {q.kbuckets}")
        rank = _interp_weights(q.farg if q.op == "quantile" else 0.5,
                               q.kbuckets)
    lo, hi, w_lo, w_hi, fill = rank
    return [ctypes.c_float(q.farg), ctypes.c_float(q.farg2), ctypes.c_int(lo),
            ctypes.c_int(hi), ctypes.c_float(w_lo), ctypes.c_float(w_hi),
            ctypes.c_float(fill)]


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({kernels.error_string(rc)})")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return t.device


def _dense_pointers(ts, vals, q: GridQuery, phase) -> tuple:
    """Check a decoded-plane kernel's inputs on the card: (mode, ts
    pointer, phase pointer), the planes the mode does not read None."""
    nb, ns = vals.shape
    dev = vals.device
    _require(vals, "vals", torch.float32, (nb, ns), dev)
    mode = _mode_for(q, phase)
    ts_ptr = ph_ptr = None
    if mode == "ts":
        if ts is None:
            raise ValueError(f"op {q.op} needs the ts plane")
        _require(ts, "ts", torch.int32, (nb, ns), dev)
        ts_ptr = ts.data_ptr()
    elif mode == "phase":
        phase = phase.reshape(-1)
        _require(phase, "phase", torch.int32, (ns,), dev)
        ph_ptr = phase.data_ptr()
    return mode, ctypes.c_void_p(ts_ptr), ctypes.c_void_p(ph_ptr)


_PLANE_DTYPES = (torch.uint8, torch.int16, torch.int32, torch.float32)


def _plane_pointers(p, m, kind: int, dev) -> tuple:
    """Check one class plane and its meta tile on the card: their
    pointers."""
    nb, n = p.shape
    _require(p, f"plane {_PLANES[kind][0]}", _PLANE_DTYPES[kind], (nb, n),
             dev)
    _require(m, f"meta {_PLANES[kind][1]}", torch.int32, (8, n), dev)
    return ctypes.c_void_p(p.data_ptr()), ctypes.c_void_p(m.data_ptr())


@timed(program="grid.rate_grid")
def rate_grid(ts, vals, steps0: int, q: GridQuery, phase=None):
    """Per-series windowed function over an aligned grid:
    ``vals [B, S]`` -> ``[T, S]``.

    ``phase`` ([S] int32 within-bucket scrape offsets in (0, gstep])
    selects the uniform-phase mode for phase-eligible queries; then and
    for TS_FREE ops ``ts`` may be None.  CPU tensors run
    :func:`rate_grid_ref`; CUDA tensors (f32 values, int32 ts/phase)
    launch a CUDA kernel once or raise: the staged one at
    :func:`series_staged_plan`'s plan, or the direct one where the plan
    stages nothing (counted in ``.direct``)."""
    if vals.device.type == "cpu":
        return rate_grid_ref(ts, vals, steps0, q, phase=phase)
    _cuda_device(vals, "rate_grid")
    return _series_launch(ts, vals, steps0, q, phase)


def _series_launch(ts, vals, steps0: int, q: GridQuery, phase):
    """One launch of :func:`rate_grid`'s kernel on ``vals``' device
    (counted on the wrapper): the staged kernel (csrc/series_staged.cu)
    where :func:`series_staged_plan` stages the launch, else the direct
    one (``.direct``)."""
    _check_op(q)
    fn_args = _fn_args(q)
    dev = vals.device
    nb, ns = vals.shape
    if nb < _rows_needed(q):
        raise ValueError(f"grid has {nb} rows; need (nsteps-1)*stride+K = "
                         f"{_rows_needed(q)}")
    mode, ts_ptr, ph_ptr = _dense_pointers(ts, vals, q, phase)
    out = torch.empty((q.nsteps, ns), dtype=torch.float32, device=dev)
    if ns == 0:
        return out
    lib = kernels.library()
    plan = series_staged_plan(ns, q.nsteps, q.kbuckets, q.stride, mode, q.op)
    args = (ctypes.c_void_p(vals.data_ptr()), ts_ptr, ph_ptr,
            ctypes.c_void_p(out.data_ptr()),
            *_int32_args(nb, ns, q.nsteps, q.kbuckets, q.stride, q.gstep_ms,
                         steps0, _OP_CODE[q.op], _MODE_CODE[mode], q.dense,
                         q.is_rate))
    with torch.cuda.device(dev):
        if plan.staged:
            rc = lib.series_staged_launch(
                *args, *_int32_args(plan.ring_bytes),
                *fn_args, _stream())
        else:
            rc = lib.rate_grid_launch(*args, *fn_args, _stream())
            rate_grid.direct += 1
    rate_grid.launches += 1
    _launch_check(rc, "rate_grid")
    return out


rate_grid.launches = 0
rate_grid.direct = 0


def _member_ints(row0s, steps0s) -> tuple[list, list]:
    """A batch's member starts as host ints (from lists, arrays or
    tensors), one (row0, steps0) a member."""
    r0 = [int(r) for r in torch.as_tensor(row0s).reshape(-1).tolist()]
    s0 = [int(s) for s in torch.as_tensor(steps0s).reshape(-1).tolist()]
    if not r0 or len(r0) != len(s0):
        raise ValueError(f"a batch takes one row0 and one steps0 a member "
                         f"(at least one), not {len(r0)} and {len(s0)}")
    return r0, s0


def _member_rows(r0: list, nrows: int, nb: int) -> None:
    if any(r < 0 or r + nrows > nb for r in r0):
        raise ValueError(f"member rows {r0} + {nrows} leave the plane's "
                         f"{nb} rows")


def rate_grid_batch_ref(ts_all, vals_all, row0s, steps0s, q: GridQuery,
                        nrows: int, phase=None):
    """Plain version of :func:`rate_grid_batch`: each member's rows
    ``[row0, row0 + nrows)`` of the shared planes through
    :func:`rate_grid_ref` at its ``steps0`` -> ``[M, T, S]``."""
    r0, s0 = _member_ints(row0s, steps0s)
    _member_rows(r0, nrows, vals_all.shape[0])
    return torch.stack([
        rate_grid_ref(None if ts_all is None else ts_all[r:r + nrows],
                      vals_all[r:r + nrows], s, q, phase=phase)
        for r, s in zip(r0, s0)])


@timed(program="grid.rate_grid_batch")
def rate_grid_batch(ts_all, vals_all, row0s, steps0s, q: GridQuery,
                    nrows: int, phase=None):
    """B1 with a member axis: a co-arrival batch of M queries over ONE
    set of planes (``vals_all [nb, S]``, ``ts_all`` in ts mode, the
    shared ``phase`` row in phase mode) -> ``[M, T, S]``.  Member m reads
    rows ``[row0s[m], row0s[m] + nrows)`` and ends its first window at
    ``steps0s[m]``; its answer is bit for bit :func:`rate_grid` on those
    rows at that ``steps0``.

    CPU tensors run :func:`rate_grid_batch_ref`; CUDA tensors launch
    B1's kernel ONCE or raise, the member on the launch's second grid
    axis and no copied ``[M, nrows, S]`` input: the staged kernel at
    :func:`series_staged_plan`'s plan (the same for every member), or
    the direct one where it stages nothing (counted in ``.direct``)."""
    if vals_all.device.type == "cpu":
        return rate_grid_batch_ref(ts_all, vals_all, row0s, steps0s, q,
                                   nrows, phase=phase)
    _cuda_device(vals_all, "rate_grid_batch")
    return _series_batch_launch(ts_all, vals_all, row0s, steps0s, q, nrows,
                                phase)


def _series_batch_launch(ts_all, vals_all, row0s, steps0s, q: GridQuery,
                         nrows: int, phase):
    """One launch of :func:`rate_grid_batch`'s kernel on ``vals_all``'
    device (counted on the wrapper; the emulation calls it on CPU
    tensors)."""
    _check_op(q)
    fn_args = _fn_args(q)
    dev = vals_all.device
    nb, ns = vals_all.shape
    r0, s0 = _member_ints(row0s, steps0s)
    if nrows < _rows_needed(q):
        raise ValueError(f"members read {nrows} rows; need (nsteps-1)*"
                         f"stride+K = {_rows_needed(q)}")
    _member_rows(r0, nrows, nb)
    mode, ts_ptr, ph_ptr = _dense_pointers(ts_all, vals_all, q, phase)
    # each member's rows start where its solo launch's row slice would:
    # on a 16-byte boundary, as the producer's cp.async copies want
    for name, t in (("vals", vals_all), ("ts", ts_all if mode == "ts"
                                         else None)):
        if t is not None and any((t.data_ptr() + r * ns * 4) % 16
                                 for r in r0):
            raise ValueError(f"a member's first {name} row is not 16-byte "
                             f"aligned (rows {r0} of {ns} lanes)")
    _int32_args(*s0)
    M = len(r0)
    out = torch.empty((M, q.nsteps, ns), dtype=torch.float32, device=dev)
    if ns == 0:
        return out
    members = torch.tensor([r0, s0], dtype=torch.int32)
    if dev.type == "cuda":
        members = members.pin_memory().to(dev, non_blocking=True)
    lib = kernels.library()
    plan = series_staged_plan(ns, q.nsteps, q.kbuckets, q.stride, mode, q.op)
    ptrs = (ctypes.c_void_p(vals_all.data_ptr()), ts_ptr, ph_ptr,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(members[0].data_ptr()),
            ctypes.c_void_p(members[1].data_ptr()))
    with torch.cuda.device(dev):
        if plan.staged:
            rc = lib.series_staged_batch_launch(
                *ptrs, *_int32_args(M, nrows, ns, q.nsteps, q.kbuckets,
                                    q.stride, q.gstep_ms, _OP_CODE[q.op],
                                    _MODE_CODE[mode], q.dense, q.is_rate,
                                    plan.ring_bytes),
                *fn_args, _stream())
        else:
            rc = lib.rate_grid_batch_launch(
                *ptrs, *_int32_args(M, ns, q.nsteps, q.kbuckets, q.stride,
                                    q.gstep_ms, _OP_CODE[q.op],
                                    _MODE_CODE[mode], q.dense, q.is_rate),
                *fn_args, _stream())
            rate_grid_batch.direct += 1
    rate_grid_batch.launches += 1
    _launch_check(rc, "rate_grid_batch")
    return out


rate_grid_batch.launches = 0
rate_grid_batch.direct = 0


class PlaneEntry(NamedTuple):
    """One class plane of a pack, as the packed kernel's table gives it."""
    plane: torch.Tensor      # [B, n] words
    meta: torch.Tensor       # [8, n] int32
    n: int                   # lanes
    col: int                 # its first column of the [T, packed_width] out
    kind: int                # 0 uint8, 1 uint16, 2 uint32, 3 raw f32 bits


def packed_plane_table(packed: dict) -> list:
    """The table :func:`rate_grid_packed` hands its one kernel launch:
    every non-empty class plane in packed order, with its width, output
    column (the widths before it) and word kind."""
    table, col = [], 0
    for p, m, kind in _packed_planes(packed):
        table.append(PlaneEntry(p, m, p.shape[1], col, kind))
        col += p.shape[1]
    return table


@timed(program="grid.rate_grid_packed")
def rate_grid_packed(packed: dict, steps0: int, q: GridQuery,
                     row0: int = 0, use_phase: bool = False):
    """Per-series windowed function over XOR-class packed residents:
    class planes -> ``[T, packed_width]`` f32 in PACKED lane order (map
    back through the pack's ``inv``).  One kernel launch serves every
    class plane (:func:`packed_plane_table`); the decode starts at block
    row 0 and the query reads rows ``[row0, row0 + rows_needed)``.
    ``use_phase`` selects the uniform-phase mode reading meta row 2;
    otherwise only TS_FREE ops are legal.  CPU tensors run
    :func:`rate_grid_packed_ref`."""
    table = packed_plane_table(packed)
    if not table:
        raise ValueError("pack has no class planes")
    if table[0].plane.device.type == "cpu":
        return rate_grid_packed_ref(packed, steps0, q, row0, use_phase)
    dev = _cuda_device(table[0].plane, "rate_grid_packed")
    _packed_check(packed, q, row0, use_phase)
    fn_args = _fn_args(q)
    for e in table:
        _plane_pointers(e.plane, e.meta, e.kind, dev)
    width = packed_width(packed)
    out = torch.empty((q.nsteps, width), dtype=torch.float32, device=dev)
    k = len(table)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.rate_grid_packed_launch(
            (ctypes.c_void_p * k)(*[e.plane.data_ptr() for e in table]),
            (ctypes.c_void_p * k)(*[e.meta.data_ptr() for e in table]),
            (ctypes.c_int * k)(*_int32_args(*[e.n for e in table])),
            (ctypes.c_int * k)(*_int32_args(*[e.col for e in table])),
            (ctypes.c_int * k)(*[e.kind for e in table]), k,
            ctypes.c_void_p(out.data_ptr()),
            *_int32_args(width, row0, q.nsteps, q.kbuckets, q.stride,
                         q.gstep_ms, _OP_CODE[q.op], use_phase, q.dense,
                         q.is_rate),
            *fn_args, _stream())
    rate_grid_packed.launches += 1
    _launch_check(rc, "rate_grid_packed")
    return out


rate_grid_packed.launches = 0


@timed(program="grid.rate_grid_grouped")
def rate_grid_grouped(ts, vals, steps0: int, q: GridQuery,
                      group_lanes: int = 1024, phase=None):
    """Fused ``sum by (group)(fn(...))``: ``vals [B, S]`` -> ``(sum,
    count)`` ``[G, T]`` f32, ``G = S / group_lanes``.

    Every op of :func:`rate_grid`, in the same modes.  Series are
    pre-sorted by group and padded with NaN columns so that group g
    occupies columns ``[g*group_lanes, (g+1)*group_lanes)``; a group of
    padding comes back with count 0.  Free and ts modes sum and count the
    finite results; phase mode (``phase`` as in
    :func:`rate_grid`) sums every lane live at row 0 and counts the live
    lanes.  Any G >= 1: the TPU's rule that G be a multiple of 8 is its
    output tile's, and does not apply here.  CPU tensors run
    :func:`rate_grid_grouped_ref`; CUDA tensors launch a CUDA kernel once
    or raise: the staged one at :func:`dense_staged_plan`'s plan, or the
    direct one where no ring holds the step (counted in ``.direct``)."""
    if vals.device.type == "cpu":
        return rate_grid_grouped_ref(ts, vals, steps0, q, group_lanes,
                                     phase=phase)
    _cuda_device(vals, "rate_grid_grouped")
    return _grouped_dense_launch(ts, vals, steps0, q, group_lanes, phase)


def _grouped_dense_launch(ts, vals, steps0: int, q: GridQuery,
                          group_lanes: int, phase):
    """One launch of :func:`rate_grid_grouped`'s kernel on ``vals``'
    device (counted on the wrapper): the staged kernel
    (csrc/dense_staged.cu) where :func:`dense_staged_plan` stages the
    step, else the direct one (``.direct``)."""
    dev = vals.device
    _grouped_check(vals, q, group_lanes)
    fn_args = _fn_args(q)
    nb, ns = vals.shape
    mode, ts_ptr, ph_ptr = _dense_pointers(ts, vals, q, phase)
    shape = (ns // group_lanes, q.nsteps)
    s = torch.empty(shape, dtype=torch.float32, device=dev)
    c = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = kernels.library()
    plan = dense_staged_plan(group_lanes, q.nsteps, q.kbuckets, q.stride,
                             mode == "ts")
    args = (ctypes.c_void_p(vals.data_ptr()), ts_ptr, ph_ptr,
            ctypes.c_void_p(s.data_ptr()), ctypes.c_void_p(c.data_ptr()),
            *_int32_args(nb, ns, group_lanes, q.nsteps, q.kbuckets,
                         q.stride, q.gstep_ms, steps0, _OP_CODE[q.op],
                         _MODE_CODE[mode], q.dense, q.is_rate))
    with torch.cuda.device(dev):
        if plan.staged:
            rc = lib.dense_staged_launch(
                *args, *_int32_args(plan.tile, plan.ring_bytes, plan.linear),
                *fn_args, _stream())
        else:
            rc = lib.rate_grid_grouped_launch(*args, *fn_args, _stream())
            rate_grid_grouped.direct += 1
    rate_grid_grouped.launches += 1
    _launch_check(rc, "rate_grid_grouped")
    return s, c


rate_grid_grouped.launches = 0
rate_grid_grouped.direct = 0

# the direct bucket kernel's thread j sums bucket j: at most a CTA's
# threads
MAX_HIST_BUCKETS = 1024

# The staged grouped kernels' launch plans (csrc/hist_staged.cu for B5,
# csrc/grouped_staged.cu for B4, csrc/dense_staged.cu for B2): their lane
# tiles, the small one for a group that fits it (one pass) and the large
# one for any other (faster than the small one in passes at the
# north-star widths, PERF.md section 6), their ring sizes and four
# stages; B5's steps a bucket-sum chunk, and the most its running [hb, T]
# sums and counts may take in shared memory.
HIST_TILE_SMALL = 128
HIST_TILE = 256
HIST_CHUNK = 16
HIST_RING_BYTES = (16 * 1024, 32 * 1024, 64 * 1024)
_RING_STAGES = 4
HIST_ACC_SHARED_MAX = 48 * 1024
_WORD_BYTES = (1, 2, 4, 4)          # by plane kind


class HistPlan(NamedTuple):
    """One class plane's launch of :func:`hist_grid_grouped_packed` on
    the card."""
    tile: int            # consumer threads, and lanes a pass
    ring_bytes: int      # 0: the step fits no ring, the direct kernel
    chunk: int           # steps a bucket-sum chunk
    acc_shared: bool     # the running sums in shared memory
    shared: int          # dynamic shared bytes a CTA

    @property
    def staged(self) -> bool:
        return self.ring_bytes > 0


def ring_stage_rows(ring_bytes: int, word: int, tile: int) -> int:
    """Rows a ring stage holds: a power of two (the kernel's
    stage_shift)."""
    rows, shift = ring_bytes // (_RING_STAGES * tile * word), 0
    while (2 << shift) <= rows:
        shift += 1
    return 1 << shift


def staged_tile(group_lanes: int) -> int:
    """The staged grouped kernels' lane tile (B4 and B5): the small one
    for a group of at most that many lanes (one pass), else the large
    one."""
    return HIST_TILE_SMALL if group_lanes <= HIST_TILE_SMALL else HIST_TILE


def least_ring(stride: int, kbuckets: int, word: int, tile: int) -> int:
    """The least of :data:`HIST_RING_BYTES` in which a step's ``stride +
    K`` rows fit in three of its four stages (0: none does)."""
    return next((b for b in HIST_RING_BYTES
                 if stride + kbuckets
                 <= (_RING_STAGES - 1) * ring_stage_rows(b, word, tile)), 0)


def hist_staged_plan(hb: int, group_lanes: int, nsteps: int, kbuckets: int,
                     stride: int, word: int) -> HistPlan:
    """The staged kernel's plan for one class plane of ``word``-byte
    words: the lane tile of :func:`staged_tile`; the ring of
    :func:`least_ring` (none: the direct kernel), a chunk of at most
    :data:`HIST_CHUNK` steps, the running sums in shared memory when they
    take at most :data:`HIST_ACC_SHARED_MAX`."""
    tile = staged_tile(group_lanes)
    ring = least_ring(stride, kbuckets, word, tile)
    if not ring:
        return HistPlan(tile, 0, 0, False, 0)
    chunk = min(HIST_CHUNK, nsteps)
    acc = 8 * hb * nsteps
    acc_shared = acc <= HIST_ACC_SHARED_MAX
    return HistPlan(tile, ring, chunk, acc_shared,
                    ring + 8 * chunk * tile + (acc if acc_shared else 0))


# the dynamic shared memory a CTA may use beside the ring's 64 bytes of
# mbarriers (227 KB in all)
CTA_SHARED_BYTES = 232_448 - 64


class GroupPlan(NamedTuple):
    """One class plane's launch of :func:`rate_grid_grouped_packed` on
    the card (csrc/grouped_staged.cu), or one of
    :func:`rate_grid_grouped` (csrc/dense_staged.cu)."""
    tile: int            # consumer threads, and lanes a pass
    ring_bytes: int      # 0: the direct kernel
    linear: bool         # a pass's rows lie in the ring without wrapping
    shared: int          # dynamic shared bytes a CTA

    @property
    def staged(self) -> bool:
        return self.ring_bytes > 0


def grouped_staged_plan(group_lanes: int, nsteps: int, kbuckets: int,
                        stride: int, row0: int, word: int) -> GroupPlan:
    """The staged B4 kernel's plan for one class plane of ``word``-byte
    words: B5's tile (:func:`staged_tile`); the least ring that holds a
    step in three stages (:func:`least_ring`) and a pass's ``row0 + (T -
    1) * stride + K`` rows in its four (the linear layout, read without a
    mask), else the least that holds the step (a pass wraps the ring);
    then a row of T partial sums and T partial counts for each consumer
    warp.  A step that fits no ring, or a plan past
    :data:`CTA_SHARED_BYTES`, takes the direct kernel."""
    tile = staged_tile(group_lanes)
    ring = least_ring(stride, kbuckets, word, tile)
    part = 8 * (tile // 32) * nsteps
    if not ring or ring + part > CTA_SHARED_BYTES:
        return GroupPlan(tile, 0, False, 0)
    rows = row0 + (nsteps - 1) * stride + kbuckets
    linear = next((b for b in HIST_RING_BYTES
                   if b >= ring and b + part <= CTA_SHARED_BYTES
                   and rows <= _RING_STAGES * ring_stage_rows(b, word, tile)),
                  0)
    if linear:
        return GroupPlan(tile, linear, True, linear + part)
    return GroupPlan(tile, ring, False, ring + part)


def dense_staged_plan(group_lanes: int, nsteps: int, kbuckets: int,
                      stride: int, reads_ts: bool = False) -> GroupPlan:
    """The staged B2 kernel's plan (csrc/dense_staged.cu) for groups of
    ``group_lanes`` lanes of a decoded f32 plane: B4's
    (:func:`grouped_staged_plan`) for 4-byte words whose windows start at
    plane row 0.  At the north-star widths (1,024-lane groups, T = 55,
    K = 5) the 256-lane tile, and a pass's 59 rows linear in the 64 KB
    ring.  A launch that ``reads_ts`` stages the ts rows in a second ring
    of the same bytes, so it takes the least ring that holds a step
    (:func:`least_ring`), linear only where that ring holds a pass: the
    two 64 KB rings of the linear layout would leave one CTA an SM."""
    plan = grouped_staged_plan(group_lanes, nsteps, kbuckets, stride, 0, 4)
    if not reads_ts or not plan.staged:
        return plan
    tile = plan.tile
    ring = least_ring(stride, kbuckets, 4, tile)
    shared = 2 * ring + 8 * (tile // 32) * nsteps
    if shared > CTA_SHARED_BYTES:
        return GroupPlan(tile, 0, False, 0)
    rows = (nsteps - 1) * stride + kbuckets
    return GroupPlan(tile, ring,
                     rows <= _RING_STAGES * ring_stage_rows(ring, 4, tile),
                     shared)


# The staged B1 kernel's launch plans (csrc/series_staged.cu): its lane
# tile (a CTA's lanes), its ring a plane (8 KB: four stages of 4 rows of
# 128 lanes, up to 64 KB: 32 rows; the least holding a step, so that
# seven CTAs share an SM and the store's 800-864 tiles run in one wave),
# and the ops the direct kernel serves faster (PERF.md section 6).
SERIES_TILE = 128
SERIES_RING_BYTES = (8 * 1024, 16 * 1024, 32 * 1024, 64 * 1024)
SERIES_DIRECT_OPS = frozenset(("irate", "stddev", "stdvar", "zscore"))


class SeriesPlan(NamedTuple):
    """One launch of :func:`rate_grid` on the card."""
    ring_bytes: int      # a plane's ring; 0: the direct kernel
    shared: int          # dynamic shared bytes a CTA

    @property
    def staged(self) -> bool:
        return self.ring_bytes > 0


def series_ring_plan(kbuckets: int, stride: int, mode: str) -> SeriesPlan:
    """The staged B1 kernel's plan for a step of ``stride + K`` rows: a
    ring for the values and, in ts mode, one for the timestamps, each
    the least of :data:`SERIES_RING_BYTES` in whose four stages three
    hold the step.  Direct (``ring_bytes`` 0) where no ring holds it."""
    ring = next((b for b in SERIES_RING_BYTES
                 if stride + kbuckets
                 <= (_RING_STAGES - 1) * ring_stage_rows(b, 4, SERIES_TILE)),
                0)
    return SeriesPlan(ring, (2 if mode == "ts" else 1) * ring)


def series_staged_plan(ns: int, nsteps: int, kbuckets: int, stride: int,
                       mode: str, op: str) -> SeriesPlan:
    """The plan of one :func:`rate_grid` launch over ``ns`` lanes and
    ``nsteps`` steps on the card: the direct kernel for the ops of
    :data:`SERIES_DIRECT_OPS` and where the launch has no lanes, else
    :func:`series_ring_plan`'s ring.  The lane count and T do not
    choose yet: every launch the store makes has 102,400-110,592 lanes,
    the widths at which the direct ops were timed."""
    if ns < 1 or op in SERIES_DIRECT_OPS:
        return SeriesPlan(0, 0)
    return series_ring_plan(kbuckets, stride, mode)


def _grouped_packed_launch(wrapper, packed: dict, q: GridQuery, row0: int,
                           use_phase: bool, group_lanes: int, hb: int):
    """Launch the grouped packed kernel once per class plane (counted on
    ``wrapper``): ``(sum, count)`` ``[G*hb, T]``, groups in plane order.
    A plane whose step fits a ring takes the staged kernel at
    :func:`grouped_staged_plan`'s plan (hb = 1) or
    :func:`hist_staged_plan`'s (hb > 1), any other the direct one (counted
    on ``wrapper.direct``)."""
    planes = _grouped_packed_check(packed, q, row0, use_phase, group_lanes,
                                   hb)
    fn_args = _fn_args(q)
    dev = _cuda_device(planes[0][0], wrapper.__name__)
    if hb > MAX_HIST_BUCKETS:
        raise ValueError(f"{hb} buckets; the kernel takes at most "
                         f"{MAX_HIST_BUCKETS}")
    shape = (packed_width(packed) // group_lanes * hb, q.nsteps)
    # zeroed: the bucket kernels keep their running sums here when they do
    # not fit in shared memory
    s = torch.zeros(shape, dtype=torch.float32, device=dev)
    c = torch.zeros(shape, dtype=torch.float32, device=dev)
    lib = kernels.library()
    slot0 = 0
    for p, m, kind in planes:
        nb, n = p.shape
        pp, mp = _plane_pointers(p, m, kind, dev)
        args = (kind, nb, n, group_lanes, hb, slot0, row0, q.nsteps,
                q.kbuckets, q.stride, q.gstep_ms, _OP_CODE[q.op], use_phase,
                q.dense, q.is_rate)
        word = _WORD_BYTES[kind]
        if hb > 1:
            plan = hist_staged_plan(hb, group_lanes, q.nsteps, q.kbuckets,
                                    q.stride, word)
            staged, extra = lib.hist_staged_launch, (
                plan.tile, plan.ring_bytes, plan.chunk, plan.acc_shared)
        else:
            plan = grouped_staged_plan(group_lanes, q.nsteps, q.kbuckets,
                                       q.stride, row0, word)
            staged, extra = lib.grouped_staged_launch, (
                plan.tile, plan.ring_bytes, plan.linear)
        sc = (ctypes.c_void_p(s.data_ptr()), ctypes.c_void_p(c.data_ptr()))
        with torch.cuda.device(dev):
            if plan.staged:
                rc = staged(pp, mp, *sc, *_int32_args(*args, *extra),
                            *fn_args, _stream())
            else:
                rc = lib.grouped_packed_launch(pp, mp, *sc,
                                               *_int32_args(*args),
                                               *fn_args, _stream())
                wrapper.direct += 1
        wrapper.launches += 1
        _launch_check(rc, wrapper.__name__)
        slot0 += n // group_lanes
    return s, c


@timed(program="grid.rate_grid_grouped_packed")
def rate_grid_grouped_packed(packed: dict, steps0: int, q: GridQuery,
                             group_lanes: int = 1024, row0: int = 0,
                             use_phase: bool = True):
    """Fully fused ``sum by (group)(fn(...))`` over packed residents:
    class planes -> ``(sum, count)`` ``[G, T]``, decode + window + group
    reduce in one kernel launch per class plane.  Every op of
    :func:`rate_grid_packed`: the phase-mode ops and those that read no
    ts plane.

    Requires the GROUP-ALIGNED pack contract: every class plane's width
    is a whole number of ``group_lanes``-lane groups, and the pack
    carries no alignment-pad lanes (a ``min_width`` single-class pack
    keeps a uniform workload's lane, and so group, order).  Groups come
    back in packed-plane order.  Any group count: the TPU's rule that
    each plane hold a multiple of 8 groups is its output tile's.  On the
    card each class plane is one launch: the staged kernel, or the direct
    one where no ring holds the step (counted in ``.direct``).  CPU
    tensors run :func:`rate_grid_grouped_packed_ref`."""
    planes = _packed_planes(packed)
    if planes and planes[0][0].device.type == "cpu":
        return rate_grid_grouped_packed_ref(packed, steps0, q, group_lanes,
                                            row0, use_phase)
    return _grouped_packed_launch(rate_grid_grouped_packed, packed, q, row0,
                                  use_phase, group_lanes, 1)


rate_grid_grouped_packed.launches = 0
rate_grid_grouped_packed.direct = 0


@timed(program="grid.hist_grid_grouped_packed")
def hist_grid_grouped_packed(packed: dict, steps0: int, q: GridQuery,
                             hb: int, group_lanes: int = 1024,
                             row0: int = 0, use_phase: bool = True):
    """Fully fused ``sum by (g)(fn(latency_bucket[w]))`` over packed
    HISTOGRAM residents: bucket planes -> ``(sum, count)`` ``[G*hb, T]``;
    slot ``g*hb + j`` is group g's cumulative bucket j, reduced from the
    group's columns c with ``c % hb == j`` (the stride pack's layout:
    column ``s*hb + j`` is series s's bucket j).

    Requires the hist group-aligned contract: ``group_lanes % hb == 0``,
    no alignment-pad lanes, whole groups per class plane (a
    ``pack_vals(stride=hb, min_width=...)`` identity pack), and at most
    :data:`MAX_HIST_BUCKETS` buckets on the card.  On the card each class
    plane is one launch: the staged kernel, or the direct one where the
    step fits no ring (counted in ``.direct``).  CPU tensors run
    :func:`hist_grid_grouped_packed_ref`."""
    planes = _packed_planes(packed)
    if planes and planes[0][0].device.type == "cpu":
        return hist_grid_grouped_packed_ref(packed, steps0, q, hb,
                                            group_lanes, row0, use_phase)
    return _grouped_packed_launch(hist_grid_grouped_packed, packed, q, row0,
                                  use_phase, group_lanes, hb)


hist_grid_grouped_packed.launches = 0
hist_grid_grouped_packed.direct = 0


@timed(program="grid.hist_quantile_grid_packed")
def hist_quantile_grid_packed(packed: dict, steps0: int, tops, q: GridQuery,
                              phi: float, hb: int, group_lanes: int = 1024,
                              row0: int = 0, use_phase: bool = True):
    """Fused ``histogram_quantile(phi, sum by (g)(fn(...)))``:
    :func:`hist_grid_grouped_packed`, then the le-interpolation over the
    ``[G, T, hb]`` bucket sums (``tops``: the ``[hb]`` cumulative bucket
    upper bounds) -> ``[G, T]``; a step where no series of the group is
    counted in the top bucket is NaN."""
    s, c = hist_grid_grouped_packed(packed, steps0, q, hb, group_lanes,
                                    row0, use_phase)
    nsteps = s.shape[1]
    ngroups = s.shape[0] // hb
    hist_sum = s.reshape(ngroups, hb, nsteps).permute(0, 2, 1)
    out = histogram_ops.hist_quantile(tops, hist_sum, phi)
    nlive = c.reshape(ngroups, hb, nsteps)[:, hb - 1, :]
    return torch.where(nlive > 0, out, torch.full_like(out, float("nan")))


# ---------------------------------------------------------------------------
# Generic columnar event scan -> filter -> topK (the GDELT shape): the
# value column's window op (rate_grid_packed), an optional predicate on a
# second column scanned the same way, a group reduce and a ranking
# ---------------------------------------------------------------------------

_FILTER_OPS = {
    "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
    "eq": torch.eq, "ne": torch.ne,
}

# one-hot group reduce beyond this many groups costs too much memory (the
# [lanes, G] operand): index_add_ past it
TOPK_ONEHOT_MAX_G = 2048


@timed(program="grid.event_topk_grid_packed")
def event_topk_grid_packed(packed: dict, steps0: int, q: GridQuery, k: int,
                           garr, num_groups: int,
                           filt_packed: Optional[dict] = None,
                           filt_op: str = "gt", filt_thresh: float = 0.0,
                           filt_q: Optional[GridQuery] = None,
                           filt_pos=None, row0: int = 0,
                           largest: bool = True, group_width: int = 0):
    """``topk(k, sum by (g)(fn(value_col[w])))`` with an optional scan
    filter on a second column, over packed columnar residents.

    - ``packed``: the value column's class planes (packed order).
    - ``garr``: ``[packed_width]`` int lane -> group slot in PACKED order
      (``num_groups`` drops a lane).  Or ``group_width`` (and ``garr``
      None) when group g is the contiguous packed lanes ``[g*W, (g+1)*W)``:
      the reduce is then a reshape-sum.  A ``garr`` reduces by a one-hot
      f32 matmul up to :data:`TOPK_ONEHOT_MAX_G` groups and by the
      fixed-order ``aggregate.segment_sum`` past it.
    - ``filt_packed``/``filt_op``/``filt_thresh``: keep only lanes whose
      filter-column window value (``filt_q``, default ``q``) satisfies
      ``filt_op(v, thresh)`` (gt/ge/lt/le/eq/ne); ``filt_pos`` maps the
      value pack's lane order into the filter pack's when the two
      columns packed with different layouts.
    - returns ``(vals [T, k], idx [T, k] int32)``: per step the top-k
      group sums (``largest=False``: the smallest) and their group
      slots, ties to the lower slot; exhausted ranks are NaN / -1.

    The window ops run on :func:`rate_grid_packed` (its kernel on CUDA
    tensors); the rest is plain torch on the planes' device."""
    if filt_op not in _FILTER_OPS:
        raise ValueError(f"unknown filter op {filt_op!r} "
                         f"(have {sorted(_FILTER_OPS)})")
    if group_width and garr is not None:
        raise ValueError("pass garr OR group_width, not both")
    if not 1 <= k <= num_groups:
        raise ValueError(f"k={k} must be in [1, num_groups={num_groups}]")
    stepped = rate_grid_packed(packed, steps0, q, row0=row0)   # [T, n]
    if filt_packed is not None:
        fstep = rate_grid_packed(filt_packed, steps0,
                                 filt_q if filt_q is not None else q,
                                 row0=row0)
        if filt_pos is not None:
            fstep = fstep[:, torch.as_tensor(filt_pos, device=fstep.device)
                          .to(torch.int64)]
        thresh = torch.tensor(filt_thresh, dtype=fstep.dtype,
                              device=fstep.device)
        keep = _FILTER_OPS[filt_op](fstep, thresh)
        stepped = torch.where(keep, stepped, torch.full_like(stepped,
                                                             float("nan")))
    fin = torch.isfinite(stepped)
    vz = torch.where(fin, stepped, torch.zeros_like(stepped))
    finf = fin.to(stepped.dtype)
    nsteps, n = stepped.shape
    if group_width:
        if n != num_groups * group_width:
            raise ValueError(f"packed width {n} != num_groups {num_groups} "
                             f"x group_width {group_width}")
        sums = vz.reshape(nsteps, num_groups, group_width).sum(2).T
        cnts = finf.reshape(nsteps, num_groups, group_width).sum(2).T
    else:
        g = torch.as_tensor(garr, device=stepped.device).to(torch.int64)
        if num_groups + 1 <= TOPK_ONEHOT_MAX_G:
            onehot = (g[:, None] == torch.arange(
                num_groups, device=g.device)[None, :]).to(stepped.dtype)
            sums = aggregate.f32_matmul(onehot.T, vz.T)       # [G, T]
            cnts = aggregate.f32_matmul(onehot.T, finf.T)
        else:
            sums = aggregate.segment_sum(vz.T, g, num_groups + 1)[:num_groups]
            cnts = aggregate.segment_sum(finf.T, g,
                                         num_groups + 1)[:num_groups]
    sentinel = float("-inf") if largest else float("inf")
    ranked = torch.where(cnts > 0, sums,
                         torch.full_like(sums, sentinel)).T   # [T, G]
    if not largest:
        ranked = -ranked
    # a stable descending sort ranks ties to the lower slot, as
    # jax.lax.top_k does (torch.topk promises no order on ties)
    vals, idx = torch.sort(ranked, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    live = torch.isfinite(vals)
    if not largest:
        vals = -vals
    return (torch.where(live, vals, torch.full_like(vals, float("nan"))),
            torch.where(live, idx, -1).to(torch.int32))


# ---------------------------------------------------------------------------
# M4 visualization downsampling: per-pixel-bin min/max/first/last
# selection (the M4 aggregation of Jugel et al., arXiv:2307.05389).  A
# T-step series split into P pixel bins keeps <= 4 points per bin —
# everything a width-P panel can render.  Pure SELECTION, no arithmetic:
# the kernel and the plain version are bit-equal.
# ---------------------------------------------------------------------------

#: m4 plane order along output axis 1: values then LOCAL row indices
M4_PLANES = ("vmin", "vmax", "vfirst", "vlast",
             "imin", "imax", "ifirst", "ilast")


def m4_bin_width(nsteps: int, pixels: int) -> int:
    """Bin width W = ceil(T / P): bin p holds rows [p*W, (p+1)*W)."""
    return -(-nsteps // pixels)


def _m4_check(vals: torch.Tensor, pixels: int) -> None:
    if vals.ndim != 2 or vals.shape[0] == 0 or vals.shape[1] == 0:
        raise ValueError(f"m4_grid needs a non-empty [T, S] input, got "
                         f"{tuple(vals.shape)}")
    if pixels < 1:
        raise ValueError(f"pixels must be >= 1, got {pixels}")


def m4_grid_ref(vals: torch.Tensor, pixels: int) -> torch.Tensor:
    """Plain version of :func:`m4_grid`: the same selection over the
    batched ``[P, W, S]`` view (rows past T are NaN padding)."""
    _m4_check(vals, pixels)
    nsteps, ns = vals.shape
    w = m4_bin_width(nsteps, pixels)
    v = vals.to(torch.float32)
    pad = torch.full((pixels * w - nsteps, ns), float("nan"),
                     dtype=torch.float32, device=v.device)
    v = torch.cat([v, pad]).reshape(pixels, w, ns)
    idx = torch.arange(w, dtype=torch.int32,
                       device=v.device)[None, :, None].expand_as(v)
    fin = torch.isfinite(v)
    inf = torch.full_like(v, float("inf"))
    vmin = torch.where(fin, v, inf).amin(1)
    vmax = torch.where(fin, v, -inf).amax(1)
    big = torch.full_like(idx, _IBIG)
    ifirst = torch.where(fin, idx, big).amin(1)
    ilast = torch.where(fin, idx, -1).amax(1)
    imin = torch.where(fin & (v == vmin[:, None]), idx, big).amin(1)
    imax = torch.where(fin & (v == vmax[:, None]), idx, big).amin(1)
    empty = ifirst == _IBIG

    def at(i):
        return v.gather(1, i.clamp(0, w - 1).to(torch.int64)[:, None])[:, 0]

    nan = torch.tensor(float("nan"), device=v.device)
    neg1 = torch.tensor(-1.0, device=v.device)
    # values gathered at their indices: of tied +0.0 and -0.0 the first
    # one's bits, as the kernel keeps them
    planes = [torch.where(empty, nan, at(i))
              for i in (imin, imax, ifirst, ilast)]
    planes += [torch.where(empty, neg1, i.to(torch.float32))
               for i in (imin, imax, ifirst, ilast)]
    return torch.stack(planes, dim=1)


@timed(program="grid.m4_grid")
def m4_grid(vals: torch.Tensor, pixels: int) -> torch.Tensor:
    """M4 pixel-bin selection: time-major ``vals [T, S]`` f32 -> planes
    ``[P, 8, S]`` in :data:`M4_PLANES` order.  Index planes are LOCAL to
    the bin (global row = ``p * W + local``, ``W = ceil(T/P)``); NaN and
    infinite steps are absent samples; bins with no finite sample come
    back NaN / -1.  CPU tensors run :func:`m4_grid_ref`; CUDA tensors
    launch the CUDA kernel or raise."""
    if vals.device.type == "cpu":
        return m4_grid_ref(vals, pixels)
    if vals.device.type != "cuda":
        raise ValueError(f"m4_grid runs on cpu or cuda, not {vals.device}")
    _m4_check(vals, pixels)
    nsteps, ns = vals.shape
    dev = vals.device
    _require(vals, "vals", torch.float32, (nsteps, ns), dev)
    w = m4_bin_width(nsteps, pixels)
    out = torch.empty((pixels, 8, ns), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.m4_grid_launch(
            ctypes.c_void_p(vals.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            *_int32_args(nsteps, ns, pixels, w), _stream())
    m4_grid.launches += 1
    _launch_check(rc, "m4_grid")
    return out


m4_grid.launches = 0


# every kernel wrapper, each counting its launches in ``.launches``
# (B1's batched entry, rate_grid_batch, launches B1's kernels and counts
# its own)
KERNEL_WRAPPERS = (rate_grid, rate_grid_packed, rate_grid_grouped,
                   rate_grid_grouped_packed, hist_grid_grouped_packed,
                   m4_grid)


def launch_counts() -> dict:
    """{wrapper name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS + (rate_grid_batch,):
        fn.launches = 0
    rate_grid.direct = 0
    rate_grid_batch.direct = 0
    rate_grid_grouped.direct = 0
    rate_grid_grouped_packed.direct = 0
    hist_grid_grouped_packed.direct = 0
