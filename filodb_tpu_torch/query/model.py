"""Query result model: batched range vectors.

The reference materializes per-series ``RangeVector`` cursors
(reference: core/src/main/scala/filodb.core/query/RangeVector.scala:271,305,
SerializedRangeVector).  Here results stay *batched*: one ``PeriodicBatch``
holds S series x T steps as one dense tensor, so every transformer is a
tensor->tensor function; ``to_series`` unpacks at the API edge only.

A batch's values are a torch tensor on the ExecContext's memstore device
(:func:`ctx_device`), where the grid seams and the general path compute
them; only the API edge (``np_values``, ``to_series``) and the
DownsampleMapper's host selection read them back.  :func:`unify` brings
several onto that device in one dtype where they meet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch.core.chunk import ChunkBatch
from filodb_tpu_torch.ops.windows import StepRange


def to_tensor(x, device=None) -> torch.Tensor:
    """A tensor view of ``x`` (tensor or array), moved to ``device`` when
    one is given."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


def to_numpy(x) -> np.ndarray:
    """Host copy of ``x`` for the API edge and host-side bookkeeping."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def unify(arrays: Sequence, device) -> list[torch.Tensor]:
    """Tensors of ``arrays`` on ``device`` in their promoted dtype."""
    ts = [to_tensor(a, device) for a in arrays]
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def ctx_device(ctx) -> torch.device:
    """The device a query computes on: its ExecContext's memstore's."""
    if ctx is None or getattr(ctx, "memstore", None) is None:
        raise QueryError("", "the query path needs an ExecContext with a "
                             "memstore (its device)")
    return ctx.memstore.device


@dataclasses.dataclass
class QueryContext:
    """Per-query knobs (reference: core/query/QueryContext.scala:22)."""

    query_id: str = ""
    sample_limit: int = 1_000_000
    group_by_cardinality_limit: int = 100_000
    spread: Optional[int] = None


@dataclasses.dataclass
class QueryStats:
    samples_scanned: int = 0
    series_scanned: int = 0
    bytes_scanned: int = 0
    # per-stage wall seconds (keys: scan, device_compute and the
    # DownsampleMapper's downsample_m4/_readback/_select), accumulated on
    # the shared ExecContext and folded into the root's result
    timings: dict = dataclasses.field(default_factory=dict)
    # DownsampleMapper: finite points entering the M4 selection vs
    # pixel-exact points kept (0/0 = not requested)
    downsample_points_in: int = 0
    downsample_points_out: int = 0


class QueryError(Exception):
    """Query failed (reference: filodb.query.QueryError)."""

    def __init__(self, query_id: str, message: str):
        super().__init__(message)
        self.query_id = query_id


@dataclasses.dataclass
class RawBatch:
    """Leaf-scan output: irregular samples as a padded ChunkBatch + keys."""

    keys: list[dict]
    batch: Optional[ChunkBatch]

    @property
    def num_series(self) -> int:
        return len(self.keys)


@dataclasses.dataclass
class PeriodicBatch:
    """S series sampled on a regular step grid: values [S, T] (NaN = no
    sample at that step) or hist [S, T, B].

    ``values`` may carry MORE rows than ``keys`` — the general path keeps
    the padded series axis of its input batch; padding rows are NaN.
    :meth:`values_t` slices to the real series as a tensor,
    :meth:`np_values` as a host array."""

    keys: list[dict]
    steps: StepRange
    values: object          # torch.Tensor | np.ndarray, [S(+pad), T]
    hist: object = None     # [S(+pad), T, B]
    bucket_tops: Optional[np.ndarray] = None

    @property
    def num_series(self) -> int:
        return len(self.keys)

    def values_t(self) -> torch.Tensor:
        return to_tensor(self.values)[:len(self.keys)]

    def np_values(self) -> np.ndarray:
        return to_numpy(self.values)[:len(self.keys)]

    def to_series(self) -> list[tuple[dict, np.ndarray, np.ndarray]]:
        """Unpack to [(tags, step_timestamps, values)] at the API edge."""
        ts = np.asarray(self.steps.timestamps())
        vals = self.np_values()
        return [(self.keys[i], ts, vals[i]) for i in range(len(self.keys))]


@dataclasses.dataclass
class ScalarResult:
    """A scalar-per-step result (scalar(), time(), fixed scalars)."""

    steps: StepRange
    values: object  # [T] tensor

    @property
    def num_series(self) -> int:
        return 1


@dataclasses.dataclass
class QueryResult:
    """Result of one ExecPlan (reference: filodb.query.QueryResult)."""

    query_id: str
    batches: list  # RawBatch | PeriodicBatch | ScalarResult | AggPartialBatch
    stats: QueryStats = dataclasses.field(default_factory=QueryStats)

    @property
    def num_series(self) -> int:
        return sum(b.num_series for b in self.batches)


def concat_periodic(batches: Sequence[PeriodicBatch], device
                    ) -> Optional[PeriodicBatch]:
    """Concatenate PeriodicBatches along the series axis (steps must
    match) on ``device``."""
    batches = [b for b in batches if b is not None and b.num_series > 0]
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    first = batches[0]
    for b in batches[1:]:
        if b.steps != first.steps:
            raise ValueError(f"step mismatch: {b.steps} vs {first.steps}")
    keys = [k for b in batches for k in b.keys]
    values = torch.cat(unify([b.values_t() for b in batches], device))
    hist = None
    tops = first.bucket_tops
    if first.hist is not None:
        bmax = max(b.hist.shape[2] for b in batches)
        hs = []
        for h, b in zip(unify([to_tensor(b.hist)[:len(b.keys)]
                               for b in batches], device), batches):
            if h.shape[2] < bmax:   # edge-pad narrower bucket schemes
                h = torch.cat([h, h[:, :, -1:].expand(
                    -1, -1, bmax - h.shape[2])], dim=2)
            hs.append(h)
            if b.bucket_tops is not None and (tops is None or
                                              len(b.bucket_tops) > len(tops)):
                tops = b.bucket_tops
        hist = torch.cat(hs)
    return PeriodicBatch(keys, first.steps, values, hist, tops)
