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
    submit_time_ms: int = 0
    sample_limit: int = 1_000_000
    group_by_cardinality_limit: int = 100_000
    timeout_ms: int = 30_000
    spread: Optional[int] = None
    # absolute epoch-ms deadline (``workload.deadline.mint``: submit time
    # plus timeout); 0 = no deadline.  ExecPlan.execute checks it at
    # every plan node, and the query batcher checks it before a query
    # waits in a co-arrival window
    deadline_ms: int = 0
    # the admission identity (a controller's tenant and class)
    tenant: str = ""
    priority: str = "default"
    # the co-arrival batcher (``batching``): the live admission permit
    # while the query runs inside its admission window (the batch leader
    # re-checks ``permit.released`` at stack time), and the insights
    # ledger's batch-compatibility key, under which realized group sizes
    # are noted
    admission_permit: object = None
    batch_key: str = ""
    # tiered-resolution serving (``rollup``):
    # - resolution_pref: the ?resolution= knob: "" or "auto" lets the
    #   router pick, "raw" pins the raw dataset, a duration ("1m",
    #   "15m", "1h") pins that tier
    # - rollup_resolution_ms: the tier the router chose, stamped at
    #   materialize time (0 = raw)
    # - rollup_routed: True once a RollupRouterPlanner decided for this
    #   query, "raw" included
    # - rollup_tiers: the storage tiers the router stitched, in the
    #   order their legs materialized ("rolled-cold", "rolled-local",
    #   "raw")
    resolution_pref: str = ""
    rollup_resolution_ms: int = 0
    rollup_routed: bool = False
    rollup_tiers: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class QueryStats:
    samples_scanned: int = 0
    series_scanned: int = 0
    bytes_scanned: int = 0
    # chunks and partitions a paging shard read back from the column
    # store for this query (page-ins and backfills)
    chunks_scanned: int = 0
    pages_in: int = 0
    # per-stage wall seconds (keys: scan, device_compute and the
    # DownsampleMapper's downsample_m4/_readback/_select), accumulated on
    # the shared ExecContext and folded into the root's result
    timings: dict = dataclasses.field(default_factory=dict)
    # DownsampleMapper: finite points entering the M4 selection vs
    # pixel-exact points kept (0/0 = not requested)
    downsample_points_in: int = 0
    downsample_points_out: int = 0
    # quarantined (corrupt) chunks overlapping the scanned series and
    # window: the result is PARTIAL (filodb_tpu_torch.integrity)
    corrupt_chunks_excluded: int = 0
    # device-grid bytes read serving the query, by resident format
    # (keys "dense", "compressed", "compressed-hist")
    hbm_read_bytes: dict = dataclasses.field(default_factory=dict)
    # measured device seconds a program (utils/devicewatch.KERNEL_TIMER),
    # from the launches SAMPLED while this query's ExecContext was
    # active: a slow query names its program.  A grid program's seconds
    # include its kernel's, which has a row of its own
    device_programs: dict = dataclasses.field(default_factory=dict)
    # net change of ledger-tracked device-resident bytes this query
    # caused: blocks committed minus blocks freed while its ExecContext
    # was active (utils/devicewatch.LEDGER); 0 for a fully warm query
    hbm_resident_delta_bytes: int = 0
    # storage tiers that served (part of) this query, "+"-joined in time
    # order ("rolled-cold+rolled-local+raw"); "" = not routed
    tiers: str = ""
    # query-frontend result cache (query/resultcache.py): result
    # samples served from memoized immutable-chunk partials vs samples
    # re-scanned fresh this evaluation
    resultcache_cached_samples: int = 0
    resultcache_recomputed_samples: int = 0
    # cold tier: chunks/bytes this query pulled from the object bucket
    # (0 on a bucket-miss-free query), so a slow cold panel is tellable
    # from a warm one
    cold_chunks_paged: int = 0
    cold_bytes_read: int = 0

    def merge(self, other: "QueryStats") -> None:
        self.samples_scanned += other.samples_scanned
        self.series_scanned += other.series_scanned
        self.bytes_scanned += other.bytes_scanned
        self.chunks_scanned += other.chunks_scanned
        self.pages_in += other.pages_in
        self.corrupt_chunks_excluded += other.corrupt_chunks_excluded
        for k, v in other.timings.items():
            self.timings[k] = self.timings.get(k, 0.0) + v
        for k, v in other.hbm_read_bytes.items():
            self.hbm_read_bytes[k] = self.hbm_read_bytes.get(k, 0) + v
        self.downsample_points_in += other.downsample_points_in
        self.downsample_points_out += other.downsample_points_out
        for k, v in other.device_programs.items():
            self.device_programs[k] = self.device_programs.get(k, 0.0) + v
        self.hbm_resident_delta_bytes += other.hbm_resident_delta_bytes
        self.resultcache_cached_samples += other.resultcache_cached_samples
        self.resultcache_recomputed_samples += \
            other.resultcache_recomputed_samples
        self.cold_chunks_paged += other.cold_chunks_paged
        self.cold_bytes_read += other.cold_bytes_read
        if other.tiers and other.tiers != self.tiers:
            mine = self.tiers.split("+") if self.tiers else []
            mine += [t for t in other.tiers.split("+") if t not in mine]
            self.tiers = "+".join(mine)


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
