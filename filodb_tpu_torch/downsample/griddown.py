"""Batched downsampling: the grid path.

Raw samples on a regular scrape cadence lay out as the same time-major
bucket grid the serving path uses (``ops/grid.py``'s layout: row c holds
the sample with ``ts in ((c-1)*g, c*g]``); a downsample period at
resolution ``res = K * g`` then covers exactly K consecutive rows, and
every per-period aggregate (dMin/dMax/dSum/dCount/dAvg/dLast) is a
reshape ``[B, S] -> [P, K, S]`` and one reduction over the K axis, for
all series and all aggregates at once (reference analog: spark-jobs
BatchDownsampler.downsampleBatch, BatchDownsampler.scala:36).

The period reduce (:func:`period_reduce`) runs in PyTorch on the store's
device, in the input's precision (f64): downsampled values are stored
chunks, and ``min``/``max``/``last``/``count`` equal the per-series host
path's bit for bit.  A CUDA store's reduce runs on its card.  Coarser
resolutions cascade on the host from a finer one's planes
(:func:`_cascade_planes`).

Series that break the one-sample-per-bucket invariant, counter series
with resets (the counter period marker splits periods inside a bucket),
histogram columns and the re-downsampling aggregates (dAvgSc/dAvgAc)
take the per-series host path in ``chunkdown.py``: the grid path is
never wrong, only absent.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch.downsample.chunkdown import (CounterPeriodMarker,
                                                   DAvg, DCount, DLast, DMax,
                                                   DMin, DSum, TTime)
from filodb_tpu_torch.memstore.devicestore import resolve_device
from filodb_tpu_torch.utils.devicewatch import timed

_STD_STEPS = (1_000, 2_000, 5_000, 10_000, 15_000, 30_000, 60_000,
              120_000, 300_000, 600_000, 900_000, 1_800_000, 3_600_000)

# downsampler classes the grid path serves (others -> host fallback)
_GRID_DOWNSAMPLERS = (TTime, DMin, DMax, DSum, DCount, DAvg, DLast)


def grid_supported(downsamplers: Sequence) -> bool:
    return all(isinstance(d, _GRID_DOWNSAMPLERS) for d in downsamplers)


def detect_gstep(ts_list: Sequence[np.ndarray]) -> Optional[int]:
    """Scrape cadence across a batch: median inter-sample delta snapped
    to the nearest standard interval (same policy as the serving grid,
    memstore/devicestore.py _detect_gstep).  Samples <=64 series — the
    median over a spread subset decides the same snap as the full batch,
    and the full np.diff+median over millions of samples was a
    measurable slice of the rollup budget; stage_grid still verifies the
    one-sample-per-bucket invariant on EVERY series."""
    if len(ts_list) > 64:
        stride = max(1, len(ts_list) // 64)
        ts_list = ts_list[::stride][:64]
    deltas = [np.diff(ts) for ts in ts_list if len(ts) >= 3]
    if not deltas:
        return None
    d = np.concatenate(deltas)
    d = d[d > 0]
    if len(d) == 0:
        return None
    med = float(np.median(d))
    best = min(_STD_STEPS, key=lambda c: abs(c - med))
    if abs(best - med) <= 0.5 * best:
        return best
    return int(med) if med >= 1 else None


class StagedGrid:
    """One [B, S] staging of a batch of series, shared by every
    resolution whose K divides the alignment."""

    def __init__(self, g: int, c_start: int, vals: list[np.ndarray],
                 present: np.ndarray, eligible: np.ndarray,
                 has_reset: np.ndarray):
        self.g = g
        self.c_start = c_start          # global bucket index of row 0
        self.vals = vals                # per data column, [B, S]
        self.present = present          # bool [B, S]: a sample occupies
        self.eligible = eligible        # bool [S]: one-per-bucket held
        self.has_reset = has_reset      # bool [S]: any value drop
        # (col, K) -> reduced planes: coarser resolutions CASCADE from a
        # finer one's planes instead of re-reducing the raw grid (the
        # 1m -> 15m -> 1h rollup ladder costs ~one reduce, not three)
        self.planes_cache: dict[tuple[int, int], dict] = {}

    @property
    def nrows(self) -> int:
        return self.vals[0].shape[0]


def stage_grid(ts_list: Sequence[np.ndarray], cols_list: Sequence[Sequence],
               g: int, k_align: int, dtype=np.float64,
               reset_col: Optional[int] = None) -> Optional[StagedGrid]:
    """Scatter a batch of series into the bucket grid.  ``k_align``
    aligns row 0 so every resolution's periods tile whole rows
    (c_start = lcm-of-K boundary + 1).  ``reset_col`` is the data-column
    index the counter period marker watches for drops (None for time
    markers).  Returns None when nothing can be staged (no scalar
    columns / empty batch)."""
    S = len(ts_list)
    if S == 0 or g <= 0:
        return None
    ncols = len(cols_list[0])
    for cols in cols_list:
        for c in cols:
            if not isinstance(c, np.ndarray):
                return None                    # histogram/string: host path
    c_min = None
    c_max = None
    buckets_list = []
    for ts in ts_list:
        if len(ts) == 0:
            buckets_list.append(np.empty(0, np.int64))
            continue
        b = (ts + g - 1) // g                  # bucket c: ts in ((c-1)g, cg]
        buckets_list.append(b)
        c_min = int(b[0]) if c_min is None else min(c_min, int(b[0]))
        c_max = int(b[-1]) if c_max is None else max(c_max, int(b[-1]))
    if c_min is None:
        return None
    # align row 0 to a period boundary for every resolution
    c_start = ((c_min - 1) // k_align) * k_align + 1
    B = (-(-(c_max - c_start + 1) // k_align)) * k_align
    if B <= 0 or B * S > 64_000_000:           # batch-size guard (~0.5 GB)
        return None
    present = np.zeros((B, S), bool)
    eligible = np.ones(S, bool)
    has_reset = np.zeros(S, bool)

    def _nan_grids():
        return [np.full((B, S), np.nan, dtype) for _ in range(ncols)]
    # FAST PATH: every series on the identical timestamp vector (the
    # scrape-aligned common case) — one row-slice assignment replaces
    # the flat 2-D scatter and the per-series eligibility walk runs once
    b0 = buckets_list[0]
    if len(b0) and all(b is b0 or np.array_equal(b, b0)
                       for b in buckets_list):
        rows0 = b0 - c_start
        if rows0[0] >= 0 and not (np.diff(b0) <= 0).any():
            if reset_col is not None:
                for s, cols in enumerate(cols_list):
                    if len(cols[reset_col]) > 1:
                        with np.errstate(invalid="ignore"):
                            if (np.diff(cols[reset_col]) < 0).any():
                                has_reset[s] = True
            n = len(b0)
            contiguous = n == int(rows0[-1]) - int(rows0[0]) + 1
            if contiguous:
                # dense row block: ONE slice assignment per column into
                # an uninitialized grid (NaN-fill only the two pad
                # slabs) — the fancy-index scatter + full-grid prefill
                # doubled the staging memory traffic
                r0 = int(rows0[0])
                present[r0:r0 + n, :] = True
                vals = []
                for ci in range(ncols):
                    grid = np.empty((B, S), dtype)
                    grid[:r0] = np.nan
                    grid[r0 + n:] = np.nan
                    np.stack([cols[ci] for cols in cols_list], axis=1,
                             out=grid[r0:r0 + n])
                    vals.append(grid)
            else:
                vals = _nan_grids()
                present[rows0, :] = True
                for ci in range(ncols):
                    stacked = np.stack([cols[ci] for cols in cols_list],
                                       axis=1)          # [n, S]
                    vals[ci][rows0, :] = stacked
            return StagedGrid(g, c_start, vals, present, eligible,
                              has_reset)
    # per-series eligibility walk, then ONE scatter across the batch
    vals = _nan_grids()
    rows_parts, scol_parts, col_parts = [], [], [[] for _ in range(ncols)]
    for s, (b, cols) in enumerate(zip(buckets_list, cols_list)):
        if len(b) == 0:
            continue
        rows = b - c_start
        if rows[0] < 0 or (np.diff(b) <= 0).any():
            eligible[s] = False                # >1 sample per bucket / OOO
            continue
        if reset_col is not None and len(cols[reset_col]) > 1:
            with np.errstate(invalid="ignore"):
                if (np.diff(cols[reset_col]) < 0).any():
                    has_reset[s] = True
        rows_parts.append(rows)
        scol_parts.append(np.full(len(rows), s, np.int64))
        for ci in range(ncols):
            col_parts[ci].append(cols[ci])
    if rows_parts:
        rows_cat = np.concatenate(rows_parts)
        scol_cat = np.concatenate(scol_parts)
        present[rows_cat, scol_cat] = True     # NaN-valued samples still
        for ci in range(ncols):                # open their period (host
            vals[ci][rows_cat, scol_cat] = \
                np.concatenate(col_parts[ci])  # semantics)
    return StagedGrid(g, c_start, vals, present, eligible, has_reset)


def _period_reduce_impl(v: torch.Tensor, P: int, K: int) -> torch.Tensor:
    """``[B, S]`` -> the six aggregate planes stacked ``[6, P, S]`` in
    :data:`PLANES` order, one reduction each over the ``[P, K, S]``
    view, on ``v``'s device and in its dtype."""
    S = v.shape[1]
    v = v.reshape(P, K, S)
    fin = torch.isfinite(v)
    cnt = fin.sum(dim=1).to(v.dtype)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    nan = torch.full((), float("nan"), dtype=v.dtype, device=v.device)
    vsum = torch.where(fin, v, zero).sum(dim=1)
    vmin = torch.where(fin, v, inf).amin(dim=1)
    vmax = torch.where(fin, v, -inf).amax(dim=1)
    live = cnt > 0
    # last finite row of each period: the highest finite k
    kidx = torch.arange(K, dtype=torch.int64, device=v.device)[None, :, None]
    last_k = torch.where(fin, kidx, -1).amax(dim=1)
    lastv = torch.gather(v, 1, last_k.clamp(min=0)[:, None, :])[:, 0, :]
    return torch.stack([
        cnt,
        torch.where(live, vsum, nan),
        torch.where(live, vmin, nan),
        torch.where(live, vmax, nan),
        torch.where(live, vsum / torch.clamp(cnt, min=1.0), nan),
        torch.where(live, lastv, nan)])


PLANES = ("cnt", "sum", "min", "max", "avg", "last")


@timed(program="griddown.period_reduce")
def _period_reduce_on(v: torch.Tensor, P: int, K: int) -> torch.Tensor:
    return _period_reduce_impl(v, P, K)


def period_reduce(vals: np.ndarray, P: int, K: int,
                  device="cuda") -> dict[str, np.ndarray]:
    """Host ``[B, S]`` planes -> host ``[P, S]`` aggregate planes, reduced
    on ``device`` in the input's precision: one upload, one program (on
    the kernel ledger as ``griddown.period_reduce``), one readback."""
    device = resolve_device(device)
    with torch.cuda.device(device) if device.type == "cuda" \
            else _NO_DEVICE:
        v = torch.as_tensor(np.ascontiguousarray(vals)).to(device)
        out = _period_reduce_on(v, P, K).cpu().numpy()
    return dict(zip(PLANES, out))


class _NoDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_DEVICE = _NoDevice()


def _cascade_planes(pl: dict[str, np.ndarray], Pc: int, Kr: int
                    ) -> dict[str, np.ndarray]:
    """Derive coarse-period planes from fine-period planes: Kr fine
    periods tile one coarse period.  min/max/count/last are EXACT
    (order-insensitive); sum (and avg, re-derived from sum/count —
    never avg-of-avgs) re-associates the floating-point summation tree,
    so it can differ from a direct reduce in the low bits — within the
    tolerance the downsample equivalence tests assert, not bit-identity."""
    import warnings

    def rs(a):
        return a.reshape(Pc, Kr, -1)

    cnt = rs(pl["cnt"]).sum(axis=1)
    live = cnt > 0
    nan = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        vsum = np.nansum(rs(pl["sum"]), axis=1)
        vmin = np.nanmin(rs(pl["min"]), axis=1)
        vmax = np.nanmax(rs(pl["max"]), axis=1)
    lf = rs(pl["last"])
    kidx = np.arange(Kr, dtype=np.int32)[None, :, None]
    last_k = np.where(np.isfinite(lf), kidx, -1).max(axis=1)
    lastv = np.take_along_axis(lf, np.maximum(last_k, 0)[:, None, :],
                               axis=1)[:, 0, :]
    return {
        "cnt": cnt,
        "sum": np.where(live, vsum, nan),
        "min": np.where(live, vmin, nan),
        "max": np.where(live, vmax, nan),
        "avg": np.where(live, vsum / np.maximum(cnt, 1.0), nan),
        "last": np.where(live & (last_k >= 0), lastv, nan),
    }


def grid_outputs(staged: StagedGrid, res: int, downsamplers: Sequence,
                 marker, device="cuda") -> Optional[tuple[np.ndarray, list,
                                                         np.ndarray,
                                                         np.ndarray]]:
    """Compute every requested downsampler over one resolution from the
    staged grid, reducing on ``device``.  Returns (serve_mask [S],
    per-downsampler [P, S] output planes, period_end stamps [P],
    period-live [P, S]) or None when this resolution doesn't tile the
    grid."""
    g = staged.g
    if res % g != 0:
        return None
    K = res // g
    B = staged.nrows
    if B % K != 0:
        return None
    P = B // K
    serve = staged.eligible.copy()
    if isinstance(marker, CounterPeriodMarker):
        # reset splits create mid-bucket periods: host path handles them
        serve &= ~staged.has_reset
    if not serve.any():
        return None
    # column -> reduced planes: cascade from the finest already-reduced
    # resolution whose K divides this one, else reduce the raw grid
    cache = staged.planes_cache

    def planes(ci: int) -> dict[str, np.ndarray]:
        got = cache.get((ci, K))
        if got is not None:
            return got
        fine = [kf for (cj, kf) in cache
                if cj == ci and kf < K and K % kf == 0]
        if fine:
            kf = max(fine)
            got = _cascade_planes(cache[(ci, kf)], P, K // kf)
        else:
            got = period_reduce(staged.vals[ci], P, K, device)
        cache[(ci, K)] = got
        return got

    period_ends = (staged.c_start - 1 + (np.arange(P) + 1) * K) * g
    plive = staged.present.reshape(P, K, -1).any(axis=1)    # [P, S]
    outs = []
    for d in downsamplers:
        if isinstance(d, TTime):
            outs.append(None)                 # stamps come from period_ends
            continue
        pl = planes(d.col_id - 1)
        if isinstance(d, DMin):
            outs.append(pl["min"])
        elif isinstance(d, DMax):
            outs.append(pl["max"])
        elif isinstance(d, DSum):
            outs.append(pl["sum"])
        elif isinstance(d, DCount):
            outs.append(pl["cnt"])
        elif isinstance(d, DAvg):
            outs.append(pl["avg"])
        elif isinstance(d, DLast):
            outs.append(pl["last"])
        else:
            return None
    return serve, outs, period_ends, plive
