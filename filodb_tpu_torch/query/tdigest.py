"""Vectorized mergeable t-digest for bounded-memory quantile aggregation.

The reference bounds quantile-aggregation memory with a t-digest per
group/step (reference: query/exec/aggregator/RowAggregator.scala
QuantileRowAggregator, which serializes TDigest sketches into the
partial rows).  A literal port would be a per-cell object graph; here a
digest is three dense arrays over every (group, step) cell at once —

    means   [G, T, C]   centroid means  (NaN = empty slot)
    weights [G, T, C]   centroid weights (0 = empty slot)

— and every operation (build, merge, quantile) is a batched numpy pass
over all G*T cells, which is the shape the rest of the aggregation
layer already works in (AggPartialBatch state dict).

Compression uses the k1 scale function ``k(q) = C/(2pi) * asin(2q-1)``:
sorted centroids are binned by floor(k-index) and bin-merged, which
bounds the centroid count at C per cell while keeping tail resolution —
the same invariant the MergingDigest maintains, computed in one
vectorized scatter-add instead of a sequential greedy loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TDigest:
    """Batched digests for a [G, T] grid of cells."""

    means: np.ndarray     # [G, T, C]
    weights: np.ndarray   # [G, T, C]

    @property
    def compression(self) -> int:
        return self.means.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.means.nbytes + self.weights.nbytes


def _k_scale(q: np.ndarray, compression: int) -> np.ndarray:
    """k1 scale spanning the FULL [0, compression] range: asin(2q-1)
    covers [-pi/2, pi/2], i.e. a span of pi, so the factor is C/pi."""
    q = np.clip(q, 0.0, 1.0)
    return compression / np.pi * (np.arcsin(2.0 * q - 1.0) + np.pi / 2.0)


def _compress(means: np.ndarray, weights: np.ndarray,
              compression: int) -> TDigest:
    """Compress [G, T, N] centroid sets down to C = compression slots.

    Cells are independent; NaN means / zero weights are ignored."""
    G, T, N = means.shape
    order = np.argsort(means, axis=-1)          # NaNs sort to the end
    m = np.take_along_axis(means, order, axis=-1)
    w = np.take_along_axis(weights, order, axis=-1)
    w = np.where(np.isfinite(m), w, 0.0)
    total = w.sum(axis=-1, keepdims=True)       # [G, T, 1]
    cumw = np.cumsum(w, axis=-1)
    qmid = np.where(total > 0, (cumw - w / 2.0) / np.maximum(total, 1e-300),
                    0.0)
    kidx = np.minimum(_k_scale(qmid, compression).astype(np.int64),
                      compression - 1)
    kidx = np.maximum(kidx, 0)
    # scatter-add centroids into their k-bins, all cells at once
    cell = np.arange(G * T).reshape(G, T, 1)
    flat = (cell * compression + kidx).ravel()
    wm_out = np.bincount(flat, weights=(w * np.where(np.isfinite(m), m, 0.0)
                                        ).ravel(),
                         minlength=G * T * compression)
    w_out = np.bincount(flat, weights=w.ravel(),
                        minlength=G * T * compression)
    w_out = w_out.reshape(G, T, compression)
    wm_out = wm_out.reshape(G, T, compression)
    with np.errstate(invalid="ignore"):
        m_out = np.where(w_out > 0, wm_out / np.maximum(w_out, 1e-300),
                         np.nan)
    return TDigest(m_out, w_out)


def from_values(values: np.ndarray, ids: np.ndarray, num_groups: int,
                compression: int = 128) -> TDigest:
    """Build per-(group, step) digests from raw series values.

    ``values`` [S, T] (NaN = no sample), ``ids`` [S] group of each series.
    Memory: O(G * T * C) regardless of S."""
    S, T = values.shape if values.size else (0, values.shape[-1]
                                             if values.ndim == 2 else 0)
    out = TDigest(np.full((num_groups, T, compression), np.nan),
                  np.zeros((num_groups, T, compression)))
    if S == 0 or num_groups == 0:
        return out
    # process series in slabs of <= compression so the intermediate
    # [G, T, N] stays bounded even at very high cardinality
    slab = max(compression, 16)
    for s0 in range(0, S, slab):
        sl_vals = values[s0:s0 + slab]
        sl_ids = ids[s0:s0 + slab]
        n = sl_vals.shape[0]
        # place each series' value into its group's member slot (series j
        # of the slab owns slot j; advanced indexing on axes 0 and 2)
        mem_m = np.full((num_groups, T, n), np.nan)
        mem_w = np.zeros((num_groups, T, n))
        jj = np.arange(n)
        mem_m[sl_ids[:n], :, jj] = sl_vals
        mem_w[sl_ids[:n], :, jj] = np.isfinite(sl_vals).astype(float)
        merged_m = np.concatenate([out.means, mem_m], axis=-1)
        merged_w = np.concatenate([out.weights, mem_w], axis=-1)
        out = _compress(merged_m, merged_w, compression)
    return out


def merge(a: TDigest, b: TDigest) -> TDigest:
    """Merge two digest grids cell-wise (the distributive reduce step)."""
    if a.means.shape[:2] != b.means.shape[:2]:
        raise ValueError(f"digest grids differ: {a.means.shape} vs "
                         f"{b.means.shape}")
    compression = max(a.compression, b.compression)
    return _compress(np.concatenate([a.means, b.means], axis=-1),
                     np.concatenate([a.weights, b.weights], axis=-1),
                     compression)


def quantile(d: TDigest, q: float) -> np.ndarray:
    """Per-cell quantile estimate [G, T]; NaN for empty cells.

    Linear interpolation between centroid mid-weights, matching the
    classic t-digest estimator."""
    m, w = d.means, d.weights
    C = d.compression
    # pack occupied centroids to the left (k-bins are sparse); bin means
    # are already ascending among occupied slots, so a stable sort on
    # the emptiness flag preserves value order
    occupied = w > 0
    order = np.argsort(~occupied, axis=-1, kind="stable")
    m = np.take_along_axis(m, order, axis=-1)
    w = np.take_along_axis(w, order, axis=-1)
    n_occ = occupied.sum(axis=-1)                 # [G, T]
    total = w.sum(axis=-1)
    cumw = np.cumsum(w, axis=-1)
    mid = cumw - w / 2.0                          # centroid mid positions
    target = q * total                            # [G, T]
    idx = ((mid < target[..., None]) & (w > 0)).sum(axis=-1)  # [G, T]
    i1 = np.clip(idx, 0, np.maximum(n_occ - 1, 0))[..., None]
    i0 = np.clip(idx - 1, 0, np.maximum(n_occ - 1, 0))[..., None]
    y1 = np.take_along_axis(m, i1, axis=-1)[..., 0]
    y0 = np.take_along_axis(m, i0, axis=-1)[..., 0]
    x1 = np.take_along_axis(mid, i1, axis=-1)[..., 0]
    x0 = np.take_along_axis(mid, i0, axis=-1)[..., 0]
    denom = x1 - x0
    with np.errstate(invalid="ignore"):
        frac = np.where(denom > 0,
                        (target - x0) / np.maximum(denom, 1e-300), 0.0)
    frac = np.clip(frac, 0.0, 1.0)
    out = y0 + frac * (y1 - y0)
    # edges: clamp to the extreme centroid means
    first = m[..., 0]
    last = np.take_along_axis(
        m, np.maximum(n_occ - 1, 0)[..., None], axis=-1)[..., 0]
    lastmid = np.take_along_axis(
        mid, np.maximum(n_occ - 1, 0)[..., None], axis=-1)[..., 0]
    out = np.where(idx <= 0, first, out)
    out = np.where(target >= lastmid, last, out)
    return np.where(total > 0, out, np.nan)


def from_members(members: np.ndarray, compression: int = 128) -> TDigest:
    """Convert a dense member matrix [G, M, T] (the exact-path partial
    state) into digests — used when reducing mixed exact/digest partials."""
    G, M, T = members.shape
    vals = np.transpose(members, (0, 2, 1))       # [G, T, M]
    weights = np.isfinite(vals).astype(float)
    means = np.where(np.isfinite(vals), vals, np.nan)
    return _compress(means, weights, compression)
