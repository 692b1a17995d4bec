"""Cross-series segment reductions over group ids (the min/max half of
the reference's RowAggregator family, reference:
query/exec/aggregator/RowAggregator.scala:29,114-141).

``vals [S, T]`` (series x steps), ``ids [S]`` integer group ids, a
``num_groups`` count; returns ``[G, T]``.  NaN entries do not contribute:
they are masked to the reduction's identity (±inf) BEFORE reducing, so a
NaN never wins the way it would under ``torch.minimum``; a group with no
finite entry comes back NaN.
"""

from __future__ import annotations

import torch


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
