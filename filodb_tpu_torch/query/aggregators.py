"""Batched aggregators: map (shard-local) / reduce (cross-shard) / present.

Replaces the reference's RowAggregator family + fastReduce
(reference: query/exec/aggregator/RowAggregator.scala:29,114-141,
exec/AggrOverRangeVectors.scala:151-277).  The map phase runs segment
reductions over [S, T] batches on the query's device (each aggregator is
made for one, :func:`aggregator_for`); partial state is a dict of
[G, ...] tensors mergeable across shards (the analog of the reference's
transportable aggregate rows); present converts final state to a
PeriodicBatch on that device.  Only quantile's t-digest sketch and the
output-series picks of topk and count_values run on the host.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch.ops import aggregate as segops
from filodb_tpu_torch.ops.windows import StepRange, value_dtype
from filodb_tpu_torch.query.logical import AggregationOperator as Op
from filodb_tpu_torch.query.model import (PeriodicBatch, QueryError,
                                          to_numpy, to_tensor, unify)


@dataclasses.dataclass
class AggPartialBatch:
    """Mergeable aggregation state: per-group arrays keyed by name."""

    op: Op
    params: tuple
    group_keys: list[dict]
    steps: StepRange
    state: dict
    # series keys for ops whose reduce needs original series (topk)
    series_keys: Optional[list[dict]] = None
    # bucket tops when the state carries histogram sums ("hist_sum")
    bucket_tops: Optional[np.ndarray] = None

    @property
    def num_series(self) -> int:
        return len(self.group_keys)


def grouping_key(tags: dict, by: tuple, without: tuple,
                 metric_col: str = "_metric_"):
    """The output key of by/without grouping (reference: AggregateMapReduce
    grouping): plain aggregation collapses to one group; ``without`` keeps
    the complement (minus the metric name); ``by`` keeps exactly those."""
    if by:
        return {k: tags.get(k, "") for k in by if k in tags}
    if without:
        drop = set(without) | {metric_col}
        return {k: v for k, v in tags.items() if k not in drop}
    return {}


def _group(keys: Sequence[dict], by, without, limit: int):
    gk = [tuple(sorted(grouping_key(t, by, without).items())) for t in keys]
    ids, uniq = segops.group_ids(gk)
    if len(uniq) > limit:
        raise QueryError("", f"group-by cardinality {len(uniq)} exceeds "
                             f"limit {limit}")
    return ids, [dict(u) for u in uniq]


def _padded_ids(ids: np.ndarray, total_series: int, num_groups: int,
                device) -> torch.Tensor:
    """Pad ids to the padded series axis; padding rows land in a garbage
    group that is sliced off after the segment reduction."""
    out = np.full(total_series, num_groups, dtype=np.int64)
    out[:len(ids)] = ids
    return torch.as_tensor(out, device=device)


class Aggregator:
    """One aggregation operator on one device: ``map``, ``reduce`` and
    ``present`` compute there whatever device their inputs came from."""

    op: Op

    def __init__(self, device):
        self.device = torch.device(device)

    def _tensor(self, x) -> torch.Tensor:
        return to_tensor(x, self.device)

    def _from_host(self, arr: np.ndarray) -> torch.Tensor:
        """A host-built result row block, on the device in its dtype."""
        return torch.as_tensor(arr, device=self.device).to(
            value_dtype(self.device))

    def map(self, batch: PeriodicBatch, by, without, params,
            limit) -> AggPartialBatch:
        raise NotImplementedError

    def reduce(self, partials: list[AggPartialBatch]) -> AggPartialBatch:
        raise NotImplementedError

    def present(self, partial: AggPartialBatch) -> PeriodicBatch:
        raise NotImplementedError


def _key(k: dict) -> tuple:
    return tuple(sorted(k.items()))


def _align(partials: list[AggPartialBatch], fill: float, device):
    """Union group keys; each partial's arrays scatter into union rows.
    Returns (keys, {name: [aligned tensor per partial]}) with every
    state array on ``device`` in one dtype."""
    index: dict[tuple, int] = {}
    for p in partials:
        for k in p.group_keys:
            index.setdefault(_key(k), len(index))
    G = len(index)
    names = list(partials[0].state.keys())
    aligned = {}
    for n in names:
        arrs = unify([p.state[n] for p in partials], device)
        outs = []
        for p, arr in zip(partials, arrs):
            rows = torch.as_tensor([index[_key(k)] for k in p.group_keys],
                                   dtype=torch.int64, device=arr.device)
            f = -1 if not arr.is_floating_point() else fill
            out = torch.full((G,) + tuple(arr.shape[1:]), f, dtype=arr.dtype,
                             device=arr.device)
            if len(rows):
                out[rows] = arr
            outs.append(out)
        aligned[n] = outs
    return [dict(k) for k in index], aligned


def _nansum_stack(arrs: list[torch.Tensor]) -> torch.Tensor:
    stack = torch.stack(arrs)
    allnan = torch.isnan(stack).all(dim=0)
    s = torch.nansum(stack, dim=0)
    return torch.where(allnan, torch.full_like(s, float("nan")), s)


def _nan_extreme(arrs: list[torch.Tensor], reduce, identity: float):
    """np.nanmin / np.nanmax over the stack: NaN only where every entry
    is NaN."""
    stack = torch.stack(arrs)
    nan = torch.isnan(stack)
    out = reduce(torch.where(nan, torch.full_like(stack, identity), stack),
                 dim=0)
    return torch.where(nan.all(dim=0), torch.full_like(out, float("nan")),
                       out)


def _nan_where(cond, x):
    return torch.where(cond, x, torch.full_like(x, float("nan")))


class MomentAggregator(Aggregator):
    """sum/count/min/max/avg/stddev/stdvar/group via (sum, sumsq, count,
    min, max) moments — one implementation, different presenters."""

    def __init__(self, op: Op, device):
        super().__init__(device)
        self.op = op

    _NEEDS = {
        Op.SUM: ("sum", "count"), Op.COUNT: ("count",),
        Op.MIN: ("min",), Op.MAX: ("max",),
        Op.AVG: ("sum", "count"), Op.GROUP: ("count",),
        Op.STDDEV: ("sum", "sumsq", "count"),
        Op.STDVAR: ("sum", "sumsq", "count"),
    }

    def map(self, batch, by, without, params, limit):
        if batch.hist is not None:
            return self._map_hist(batch, by, without, params, limit)
        ids, keys = _group(batch.keys, by, without, limit)
        G = len(keys)
        vals = self._tensor(batch.values)
        pids = _padded_ids(ids, vals.shape[0], G, vals.device)
        state = {}
        needs = self._NEEDS[self.op]
        fin = torch.isfinite(vals)
        zero = torch.zeros_like(vals)
        if "sum" in needs:
            state["sum"] = segops.segment_sum(torch.where(fin, vals, zero),
                                              pids, G + 1)[:G]
        if "count" in needs:
            state["count"] = segops.segment_sum(fin.to(vals.dtype), pids,
                                                G + 1)[:G]
        if "sumsq" in needs:
            state["sumsq"] = segops.segment_sum(
                torch.where(fin, vals * vals, zero), pids, G + 1)[:G]
        if "min" in needs:
            state["min"] = segops.seg_min(vals, pids, G + 1)[:G]
        if "max" in needs:
            state["max"] = segops.seg_max(vals, pids, G + 1)[:G]
        return AggPartialBatch(self.op, params, keys, batch.steps, state)

    def _map_hist(self, batch, by, without, params, limit):
        """Bucket-wise histogram sum (reference: HistSumRowAggregator).
        Only sum is defined over first-class histogram series."""
        if self.op != Op.SUM:
            raise QueryError(
                "", f"{self.op.name.lower()}() over histogram series is not "
                    "supported (only sum; use hist_to_prom_vectors for "
                    "per-bucket series)")
        ids, keys = _group(batch.keys, by, without, limit)
        G = len(keys)
        h = self._tensor(batch.hist)[:len(batch.keys)]
        idsj = torch.as_tensor(ids, dtype=torch.int64, device=h.device)
        fin = torch.isfinite(h[..., -1])                   # [S, T]
        hs = segops.segment_sum(torch.where(fin[..., None], h,
                                            torch.zeros_like(h)), idsj, G)
        n = segops.segment_sum(fin.to(h.dtype), idsj, G)
        return AggPartialBatch(self.op, params, keys, batch.steps,
                               {"hist_sum": hs, "count": n},
                               bucket_tops=np.asarray(batch.bucket_tops))

    def _align_hist_widths(self, partials):
        """Edge-pad cumulative bucket matrices to the widest scheme: a
        narrower histogram's top bucket already holds the total count."""
        hists = [p for p in partials if "hist_sum" in p.state]
        if not hists:
            return None
        if len(hists) != len(partials):
            raise QueryError("", "cannot reduce histogram and scalar "
                                 "aggregates together (mixed schemas)")
        widest = max(hists, key=lambda p: p.state["hist_sum"].shape[-1])
        bmax = widest.state["hist_sum"].shape[-1]
        for i, p in enumerate(partials):
            h = self._tensor(p.state["hist_sum"])
            if h.shape[-1] < bmax:
                padded = torch.cat([h, h[..., -1:].expand(
                    *h.shape[:-1], bmax - h.shape[-1])], dim=-1)
                # copy-on-write: the input partial stays self-consistent
                partials[i] = dataclasses.replace(
                    p, state={**p.state, "hist_sum": padded})
        return widest.bucket_tops

    def reduce(self, partials):
        first = partials[0]
        tops = self._align_hist_widths(partials)
        keys, aligned = _align(partials, float("nan"), self.device)
        state = {}
        for n, arrs in aligned.items():
            if n in ("sum", "sumsq", "hist_sum"):
                state[n] = _nansum_stack(arrs)
            elif n == "count":
                state[n] = torch.stack([torch.nan_to_num(a, nan=0.0)
                                        for a in arrs]).sum(dim=0)
            elif n == "min":
                state[n] = _nan_extreme(arrs, torch.amin, float("inf"))
            elif n == "max":
                state[n] = _nan_extreme(arrs, torch.amax, float("-inf"))
        return AggPartialBatch(self.op, first.params, keys, first.steps,
                               state, bucket_tops=tops)

    def present(self, p):
        s = {k: self._tensor(v) for k, v in p.state.items()}
        if "hist_sum" in s:
            n = s["count"]
            hist = _nan_where(n[..., None] > 0, s["hist_sum"])
            return PeriodicBatch(p.group_keys, p.steps,
                                 torch.full_like(n, float("nan")), hist=hist,
                                 bucket_tops=p.bucket_tops)
        if self.op == Op.SUM:
            vals = _nan_where(s["count"] > 0, s["sum"])
        elif self.op == Op.COUNT:
            vals = _nan_where(s["count"] > 0, s["count"])
        elif self.op == Op.GROUP:
            vals = _nan_where(s["count"] > 0, torch.ones_like(s["count"]))
        elif self.op == Op.MIN:
            vals = s["min"]
        elif self.op == Op.MAX:
            vals = s["max"]
        elif self.op == Op.AVG:
            n = s["count"]
            vals = _nan_where(n > 0, s["sum"] / torch.clamp(n, min=1.0))
        else:  # stddev / stdvar
            n = s["count"]
            nsafe = torch.clamp(n, min=1.0)
            mean = s["sum"] / nsafe
            var = torch.clamp(s["sumsq"] / nsafe - mean * mean, min=0.0)
            if self.op == Op.STDDEV:
                var = torch.sqrt(var)
            vals = _nan_where(n > 0, var)
        return PeriodicBatch(p.group_keys, p.steps, vals)


class TopBottomKAggregator(Aggregator):
    """topk/bottomk: map keeps k candidate (value, series) slots per group per
    step; reduce concatenates candidate slots and re-selects; present emits
    the original contributing series with NaN at unselected steps
    (reference: TopBottomKRowAggregator)."""

    def __init__(self, op: Op, device):
        super().__init__(device)
        self.op = op

    def map(self, batch, by, without, params, limit):
        k = int(params[0])
        ids, keys = _group(batch.keys, by, without, limit)
        G = len(keys)
        vals = self._tensor(batch.values)
        pids = _padded_ids(ids, vals.shape[0], G, vals.device)
        values, sidx = segops.seg_topk(vals, pids, G + 1, k,
                                       bottom=self.op == Op.BOTTOMK)
        return AggPartialBatch(self.op, params, keys, batch.steps,
                               {"values": values[:G], "sidx": sidx[:G]},
                               series_keys=list(batch.keys))

    def reduce(self, partials):
        k = int(partials[0].params[0])
        # remap per-partial series indices into a combined series key list
        all_keys: list[dict] = []
        offsets = []
        for p in partials:
            offsets.append(len(all_keys))
            all_keys.extend(p.series_keys or [])
        keys, aligned = _align(partials, float("nan"), self.device)
        cands_v, cands_i = [], []
        for off, av, ai in zip(offsets, aligned["values"], aligned["sidx"]):
            sidx = ai.to(torch.int64)
            cands_v.append(av)
            cands_i.append(torch.where(sidx >= 0, sidx + off, -1))
        V = torch.cat(cands_v, dim=1)   # [G, sum_k, T]
        idx = torch.cat(cands_i, dim=1)
        sign = -1.0 if self.op == Op.BOTTOMK else 1.0
        work = torch.where(torch.isfinite(V), V * sign,
                           torch.full_like(V, float("-inf")))
        order = torch.argsort(-work, dim=1, stable=True)[:, :k]  # [G,k,T]
        top_v = torch.gather(V, 1, order)
        top_i = torch.gather(idx, 1, order)
        top_w = torch.gather(work, 1, order)
        top_v = _nan_where(torch.isfinite(top_w), top_v)
        top_i = torch.where(torch.isfinite(top_w), top_i, -1)
        return AggPartialBatch(self.op, partials[0].params, keys,
                               partials[0].steps,
                               {"values": top_v,
                                "sidx": top_i.to(torch.int32)},
                               series_keys=all_keys)

    def present(self, p):
        # the output series are picked on the host: which series made the
        # cut decides the result's keys
        V = to_numpy(p.state["values"])
        I = to_numpy(p.state["sidx"]).astype(np.int64)
        skeys = p.series_keys or []
        G, k, T = V.shape
        out_keys: list[dict] = []
        rows: list[np.ndarray] = []
        for g in range(G):
            for s in np.unique(I[g]):
                if s < 0:
                    continue
                mask = I[g] == s                     # [k, T]
                sel = np.where(mask, V[g], np.nan)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    row = np.nanmax(sel, axis=0)
                out_keys.append(skeys[int(s)])
                rows.append(row)
        vals = np.stack(rows) if rows else np.empty((0, T))
        return PeriodicBatch(out_keys, p.steps, self._from_host(vals))


def _dense_members(vals: torch.Tensor, ids: np.ndarray, G: int, M: int):
    """Per-group dense member tensor [G, M, T] (NaN where a group has
    fewer members), members in series order."""
    T = vals.shape[1]
    dense = torch.full((G, max(M, 1), T), float("nan"), dtype=vals.dtype,
                       device=vals.device)
    if len(ids):
        idt = torch.as_tensor(ids, dtype=torch.int64, device=vals.device)
        order, pos = segops.member_positions(idt)
        dense[idt[order], pos] = vals[order]
    return dense


class QuantileAggregator(Aggregator):
    """Quantile with bounded memory: small groups stay exact (dense member
    tensor + nanquantile); past ``exact_members`` members per group the
    partial switches to a mergeable t-digest sketch on the host,
    O(G*T*C) no matter the cardinality (reference: QuantileRowAggregator's
    TDigest partials).  Reduce handles mixed partials by sketching the
    exact side."""

    op = Op.QUANTILE
    exact_members = 128       # per-group member budget before sketching
    compression = 128

    def map(self, batch, by, without, params, limit):
        from filodb_tpu_torch.query import tdigest

        ids, keys = _group(batch.keys, by, without, limit)
        G = len(keys)
        vals = self._tensor(batch.values)[:len(batch.keys)]
        counts = np.bincount(ids, minlength=G) if len(ids) \
            else np.zeros(G, int)
        M = int(counts.max()) if G else 0
        if M <= self.exact_members:
            return AggPartialBatch(self.op, params, keys, batch.steps,
                                   {"members": _dense_members(vals, ids, G,
                                                              M)})
        d = tdigest.from_values(to_numpy(vals).astype(np.float64),
                                np.asarray(ids), G, self.compression)
        return AggPartialBatch(self.op, params, keys, batch.steps,
                               {"td_means": d.means, "td_weights": d.weights})

    @staticmethod
    def _is_digest(p) -> bool:
        return "td_means" in p.state

    def _to_digest_state(self, p) -> dict:
        from filodb_tpu_torch.query import tdigest

        if self._is_digest(p):
            return p.state
        d = tdigest.from_members(to_numpy(p.state["members"]).astype(
            np.float64), self.compression)
        return {"td_means": d.means, "td_weights": d.weights}

    def reduce(self, partials):
        from filodb_tpu_torch.query import tdigest

        if not any(self._is_digest(p) for p in partials):
            total = sum(p.state["members"].shape[1] for p in partials)
            if total <= self.exact_members:
                keys, aligned = _align(partials, float("nan"), self.device)
                members = torch.cat(aligned["members"], dim=1)
                return AggPartialBatch(self.op, partials[0].params, keys,
                                       partials[0].steps,
                                       {"members": members})
        # sketch path: convert any exact partials, then cell-wise merge
        norm = [AggPartialBatch(p.op, p.params, p.group_keys, p.steps,
                                self._to_digest_state(p))
                for p in partials]
        keys, aligned = _align(norm, float("nan"), self.device)
        means = [to_numpy(m) for m in aligned["td_means"]]
        weights = [np.nan_to_num(to_numpy(w)) for w in aligned["td_weights"]]
        acc = tdigest.TDigest(means[0], weights[0])
        for m, w in zip(means[1:], weights[1:]):
            acc = tdigest.merge(acc, tdigest.TDigest(m, w))
        return AggPartialBatch(self.op, partials[0].params, keys,
                               partials[0].steps,
                               {"td_means": acc.means,
                                "td_weights": acc.weights})

    def present(self, p):
        q = float(p.params[0])
        if self._is_digest(p):
            from filodb_tpu_torch.query import tdigest
            vals = tdigest.quantile(
                tdigest.TDigest(to_numpy(p.state["td_means"]),
                                to_numpy(p.state["td_weights"])), q)
            return PeriodicBatch(p.group_keys, p.steps, self._from_host(vals))
        return PeriodicBatch(p.group_keys, p.steps, torch.nanquantile(
            self._tensor(p.state["members"]), q, dim=1))


# count_values guards: the (group, value, step) count cube is bounded by
# the response itself (one output series per distinct (group, value)), so
# exceeding these is a cardinality error, not an out-of-memory
CV_MAX_DISTINCT = 65_536
CV_MAX_STATE_BYTES = 1 << 31


def count_values_state(vals2d: torch.Tensor, gids: torch.Tensor,
                       num_groups: int) -> dict:
    """count_values partial from stepped series values ``vals2d [S, T]``
    (NaN = no sample) and ``gids [S]``: one unique + one bincount over the
    whole matrix.  Returns {"cv_vals": [U] sorted distinct values,
    "cv_counts": [G, U, T]}."""
    G = max(int(num_groups), 1)
    T = vals2d.shape[1]
    fin = torch.isfinite(vals2d)
    uniq, inv = torch.unique(vals2d[fin], sorted=True, return_inverse=True)
    U = len(uniq)
    if U > CV_MAX_DISTINCT or G * U * T * 8 > CV_MAX_STATE_BYTES:
        raise QueryError("", f"count_values cardinality too large "
                             f"({U} distinct values x {G} groups)")
    s_idx, t_idx = torch.nonzero(fin, as_tuple=True)
    g_idx = gids.to(torch.int64)[s_idx]
    flat = (g_idx * U + inv.reshape(-1)) * T + t_idx
    counts = torch.bincount(flat, minlength=G * U * T).to(vals2d.dtype)
    return {"cv_vals": uniq, "cv_counts": counts.reshape(G, U, T)}


class CountValuesAggregator(Aggregator):
    """count_values("label", v): per-step count of each distinct value
    (reference: CountValuesRowAggregator), as the counted form
    {"cv_vals", "cv_counts"}."""

    op = Op.COUNT_VALUES

    def map(self, batch, by, without, params, limit):
        ids, keys = _group(batch.keys, by, without, limit)
        vals = self._tensor(batch.values)[:len(batch.keys)]
        state = count_values_state(
            vals, torch.as_tensor(ids, device=vals.device), len(keys))
        return AggPartialBatch(self.op, params, keys, batch.steps, state)

    def reduce(self, partials):
        index: dict[tuple, int] = {}
        for p in partials:
            for k in p.group_keys:
                index.setdefault(_key(k), len(index))
        G = len(index)
        all_vals = torch.unique(torch.cat(unify(
            [p.state["cv_vals"] for p in partials], self.device)),
            sorted=True)
        U = len(all_vals)
        T = partials[0].state["cv_counts"].shape[-1]
        if U > CV_MAX_DISTINCT or G * U * T * 8 > CV_MAX_STATE_BYTES:
            raise QueryError("", f"count_values cardinality too large "
                                 f"({U} distinct values x {G} groups)")
        counts = unify([p.state["cv_counts"] for p in partials], self.device)
        out = torch.zeros((G, U, T), dtype=counts[0].dtype,
                          device=counts[0].device)
        for p, c in zip(partials, counts):
            rows = torch.as_tensor([index[_key(k)] for k in p.group_keys],
                                   dtype=torch.int64, device=out.device)
            cols = torch.searchsorted(all_vals, to_tensor(
                p.state["cv_vals"], out.device).to(all_vals.dtype))
            if len(rows) and len(cols):
                out[rows[:, None], cols[None, :]] += c
        return AggPartialBatch(self.op, partials[0].params,
                               [dict(k) for k in index], partials[0].steps,
                               {"cv_vals": all_vals, "cv_counts": out})

    def present(self, p):
        label = str(p.params[0])
        uniq = to_numpy(p.state["cv_vals"])
        counts = to_numpy(p.state["cv_counts"])       # [G, U, T]
        T = counts.shape[-1]
        out_keys, rows = [], []
        present_mask = counts.sum(axis=2) > 0          # [G, U]
        for g, u in zip(*np.nonzero(present_mask)):
            key = dict(p.group_keys[g])
            key[label] = _fmt_value(float(uniq[u]))
            out_keys.append(key)
            cnt = counts[g, u]
            rows.append(np.where(cnt > 0, cnt, np.nan))
        vals = np.stack(rows) if rows else np.empty((0, T))
        return PeriodicBatch(out_keys, p.steps, self._from_host(vals))


def _fmt_value(v: float) -> str:
    return str(int(v)) if v == int(v) else repr(v)


_AGGREGATORS = {
    **{op: (lambda dev, op=op: MomentAggregator(op, dev)) for op in
       (Op.SUM, Op.COUNT, Op.MIN, Op.MAX, Op.AVG, Op.STDDEV, Op.STDVAR,
        Op.GROUP)},
    Op.TOPK: lambda dev: TopBottomKAggregator(Op.TOPK, dev),
    Op.BOTTOMK: lambda dev: TopBottomKAggregator(Op.BOTTOMK, dev),
    Op.QUANTILE: QuantileAggregator,
    Op.COUNT_VALUES: CountValuesAggregator,
}


def aggregator_for(op: Op, device) -> Aggregator:
    """The aggregator of ``op``, computing on ``device`` (the query's
    :func:`model.ctx_device`)."""
    try:
        return _AGGREGATORS[op](device)
    except KeyError:
        raise ValueError(f"unsupported aggregation operator {op}")
