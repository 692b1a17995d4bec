"""Cross-series aggregation: segment reductions over group ids.

Replaces the reference's RowAggregator map/reduce family (reference:
query/exec/aggregator/RowAggregator.scala:29,114-141 — Sum/Min/Max/Count/
Avg/TopBottomK/Stdvar/Stddev) and the ``fastReduce`` fixed-window-array
path (exec/AggrOverRangeVectors.scala:151-277).  Grouping labels map to
segment ids on the host (:func:`group_ids`); the reductions run on the
device the values live on.

All functions take ``vals [S, T]`` (series x steps), ``ids [S]`` integer
group ids and a ``num_groups`` count and return ``[G, T]`` (``[G, k, T]``
for topk).  NaN entries do not contribute: min/max mask them to the
reduction's identity (±inf) BEFORE reducing, so a NaN never wins the way
it would under ``torch.minimum``; a group with no finite entry comes back
NaN.
"""

from __future__ import annotations

import math
import threading
from typing import Hashable, Sequence

import numpy as np
import torch

_MATMUL_FLAG_LOCK = threading.Lock()


def group_ids(keys: Sequence[Hashable]) -> tuple[np.ndarray, list]:
    """Host-side: map per-series grouping keys to dense segment ids.

    Returns (ids [S] int32, unique keys in id order): the unique keys
    become the result RangeVectorKeys (reference: by/without grouping in
    AggregateMapReduce, exec/AggrOverRangeVectors.scala:74-120)."""
    index: dict[Hashable, int] = {}
    ids = np.empty(len(keys), dtype=np.int32)
    for i, k in enumerate(keys):
        ids[i] = index.setdefault(k, len(index))
    return ids, list(index.keys())


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with full f32 products whatever the process's matmul
    setting: TF32 keeps 10 mantissa bits, and the fused group sums would
    drift from the per-series path by ~0.1% (the JAX package documents
    ~0.4% for bf16 inputs, filodb_tpu/memstore/devicestore.py:216-218).
    The switch is process-wide, so it is set for this call only, under a
    lock so that concurrent queries never restore each other's value,
    and the caller's value is put back."""
    flags = torch.backends.cuda.matmul
    with _MATMUL_FLAG_LOCK:
        prev = flags.allow_tf32
        flags.allow_tf32 = False
        try:
            return a @ b
        finally:
            flags.allow_tf32 = prev


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    """Per-group sum of the rows of ``vals`` (``[S, ...]``), ``ids`` in
    ``[0, num_groups)``, each group's rows added in ascending row order
    from 0.0, on every device: the same inputs give the same bits on
    every run (CUDA's ``index_add_`` adds with atomics in any order),
    and on the CPU the bits of ``index_add_``, which adds in row order
    too.  A stable sort groups the rows, then ``segment_reduce`` sums
    each segment serially (its CUDA kernel runs one thread an output
    cell over a 2-D operand, so the trailing dims are flattened)."""
    ids = ids.to(torch.int64)
    sids, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        sids, torch.arange(num_groups + 1, dtype=torch.int64,
                           device=ids.device))
    inner = tuple(vals.shape[1:])
    rows = vals.reshape(vals.shape[0], math.prod(inner))[order]
    out = torch.segment_reduce(rows, "sum", offsets=offsets, axis=0,
                               unsafe=True)
    return out.reshape((num_groups,) + inner)


def _seg_extreme(vals: torch.Tensor, ids: torch.Tensor, num_groups: int,
                 reduce: str, identity: float) -> torch.Tensor:
    v = torch.where(torch.isfinite(vals), vals,
                    torch.full_like(vals, identity))
    out = torch.full((num_groups, vals.shape[1]), identity,
                     dtype=vals.dtype, device=vals.device)
    idx = ids.to(torch.int64)[:, None].expand_as(v)
    out.scatter_reduce_(0, idx, v, reduce=reduce, include_self=True)
    return torch.where(torch.isfinite(out), out,
                       torch.full_like(out, float("nan")))


def seg_min(vals: torch.Tensor, ids: torch.Tensor,
            num_groups: int) -> torch.Tensor:
    return _seg_extreme(vals, ids, num_groups, "amin", float("inf"))


def seg_max(vals: torch.Tensor, ids: torch.Tensor,
            num_groups: int) -> torch.Tensor:
    return _seg_extreme(vals, ids, num_groups, "amax", float("-inf"))


def member_positions(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, pos): a stable sort of the series by group, and each sorted
    series' position within its group."""
    S = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    ar = torch.arange(S, dtype=torch.int64, device=ids.device)
    newg = torch.ones(S, dtype=torch.bool, device=ids.device)
    newg[1:] = sids[1:] != sids[:-1]
    gstart = torch.cummax(torch.where(newg, ar, 0), dim=0).values
    return order, ar - gstart


def seg_topk(vals: torch.Tensor, ids: torch.Tensor, num_groups: int,
             k: int, bottom: bool = False):
    """Per-group per-step top/bottom-k (reference TopBottomKAggregator).

    Returns (values [G,k,T], series_index [G,k,T] int32; index -1 / NaN
    value where the group has fewer than k live series at that step).
    Series scatter into a dense ``[G, M, T]`` cube by position within
    their group, then a stable descending sort over the member axis
    (ties keep the lower member, as ``lax.top_k`` does)."""
    S, T = vals.shape
    M = max(S, 1)
    ids = ids.to(torch.int64)
    order, pos = member_positions(ids)
    sids = ids[order]
    sign = -1.0 if bottom else 1.0
    ninf = float("-inf")
    dense = torch.full((num_groups, M, T), ninf, dtype=vals.dtype,
                       device=vals.device)
    svals = vals[order] * sign
    dense[sids, pos] = torch.where(torch.isfinite(vals[order]), svals,
                                   torch.full_like(svals, ninf))
    smap = torch.full((num_groups, M), -1, dtype=torch.int64,
                      device=vals.device)
    smap[sids, pos] = order
    work = dense.permute(0, 2, 1)                     # [G, T, M]
    keff = min(k, M)
    topv, topm = torch.sort(work, dim=-1, descending=True, stable=True)
    topv, topm = topv[..., :keff], topm[..., :keff]
    if keff < k:  # pad out to the requested k with empty slots
        pad = (0, k - keff)
        topv = torch.nn.functional.pad(topv, pad, value=ninf)
        topm = torch.nn.functional.pad(topm, pad, value=0)
    found = torch.isfinite(topv)
    topsi = torch.gather(smap[:, None, :].expand(-1, T, -1), 2, topm)
    values = torch.where(found, topv * sign, torch.full_like(topv,
                                                             float("nan")))
    indices = torch.where(found, topsi, -1).to(torch.int32)
    return values.permute(0, 2, 1), indices.permute(0, 2, 1)
