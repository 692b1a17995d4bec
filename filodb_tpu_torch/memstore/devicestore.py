"""Device-resident chunk store: the device-memory arena the serving path
reads from.

The reference serves queries from off-heap block memory with reclaim-on-
demand eviction (reference: memory/src/main/scala/filodb.memory/
BlockManager.scala:142, Block.scala:90).  Here frozen chunk data lives
**on the card** as time-bucketed grids so queries read device memory
instead of re-uploading host arrays per query:

- Per (shard, schema, column) a :class:`DeviceGridCache` assigns each
  partition a fixed lane and materializes time **blocks** — tensors
  ``[BLOCK_BUCKETS, lanes]`` covering ``BLOCK_BUCKETS`` consecutive
  buckets of width ``gstep``.  Blocks stay compressed when it pays:
  uniform-phase blocks drop the ts plane (rebuilt from one phase row) and
  value planes pack into XOR-residual classes (``codecs/xorgrid.py``)
  that the packed kernel decodes in place.
- Blocks are built once from the partitions' frozen chunks (host decode,
  one upload) and serve every later query; a repeat query uploads
  nothing.
- Blocks are evicted oldest-first when the arena exceeds its byte budget
  (``StoreConfig.device_cache_bytes``).
- Chunk freezes invalidate overlapping blocks (the shard wires
  ``partition.on_freeze`` to :meth:`DeviceGridCache.note_freeze`); the
  mutable write-buffer tail is served through a tail block rebuilt only
  when new data arrived.
- A chunk quarantined after its block was staged must stop being
  served: a new quarantine epoch (``integrity.QUARANTINE.epoch()``)
  drops every block, and the next query re-stages through the
  partitions' read path, which skips quarantined chunks.

Grid layout: row ``c`` holds the single sample with ``ts in
(epoch0+(c-1)*gstep, epoch0+c*gstep]``.  Partitions that break the one-
sample-per-bucket invariant disable the grid for this cache generation,
and queries get None ("not served here"): the fast path is never wrong,
only absent.

Each query runs one of four programs, all plain functions on tensors:
``series``/``grouped`` over decoded planes (:func:`rate_grid` kernel)
and ``series_packed``/``grouped_packed`` over one packed block
(:func:`rate_grid_packed` kernel); the grouped ones reduce lanes to
``[G, T]`` partials on the device before the one readback.  Where the
shard has a ``query_batcher`` (``batching.QueryBatcher``), concurrent
queries over the same decoded planes that differ only in their start
meet there and run ``series_batch``/``grouped_batch`` once for the
whole group: the blocks concatenated once, one :func:`rate_grid_batch`
launch over every member, one reduce over every member's steps; each
member reads its slice.  Each program is a program of the kernel ledger
(``devicestore.series`` and so on, ``utils/devicewatch.timed``),
credited with its plan's resident bytes (a batched program once a
group).

Histogram columns (``hist=True`` caches) give each partition ``hb``
adjacent device columns, one a cumulative bucket, and run the same
kernels over them: column ``lane*hb + j`` is series ``lane``'s bucket
``j``, packed at series granularity (``xorgrid.pack_vals(stride=hb)``).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch import integrity
from filodb_tpu_torch.codecs import xorgrid
from filodb_tpu_torch.ops import aggregate as segops
from filodb_tpu_torch.ops.grid import (DENSE_ONLY_OPS, PHASE_OPS, TS_FREE_OPS,
                                       GridQuery, bits_to_f32, max_k_for,
                                       phase_eligible, prefix_xor,
                                       rate_grid, rate_grid_batch,
                                       rate_grid_packed, supports_grid,
                                       widen_words)
from filodb_tpu_torch.query.logical import RangeFunctionId as F
from filodb_tpu_torch.utils.devicewatch import KERNEL_TIMER, LEDGER, timed
from filodb_tpu_torch.utils.observability import query_metrics

BLOCK_BUCKETS = 128
_LANE_PAD = 128
_I32_SPAN = 2**31 - 2

# range functions the grid serves, mapped to the kernel op
# (ops/grid.py GridQuery.op); None = the bare instant selector's
# staleness lookback (last sample in the window).  Every other range
# function gets None from scan_rate / scan_rate_grouped.
_GRID_OPS = {
    F.RATE: "rate", F.INCREASE: "increase",
    F.SUM_OVER_TIME: "sum", F.COUNT_OVER_TIME: "count",
    F.AVG_OVER_TIME: "avg", F.MIN_OVER_TIME: "min",
    F.MAX_OVER_TIME: "max", F.LAST_OVER_TIME: "last",
    F.STDDEV_OVER_TIME: "stddev", F.STDVAR_OVER_TIME: "stdvar",
    F.CHANGES: "changes", F.RESETS: "resets",
    F.IRATE: "irate", F.IDELTA: "idelta",
    F.DERIV: "deriv", F.PREDICT_LINEAR: "predict_linear",
    F.Z_SCORE: "zscore",
    F.QUANTILE_OVER_TIME: "quantile", F.MAD_OVER_TIME: "mad",
    F.DELTA: "delta", F.TIMESTAMP: "timestamp",
    F.HOLT_WINTERS: "holt_winters",
    None: "last",
}

# timestamp() comes out of the kernel as seconds relative to each
# window's end; scan_rate re-bases it to absolute seconds in f64, and the
# grouped reduce does not take it (a sum of absolute timestamps would
# need a count-scaled re-base)
_REBASE_OPS = {"timestamp"}

# grid ops taking scalar function arguments: op -> arity
# (GridQuery.farg / farg2)
_ARG_OPS = {"predict_linear": 1, "quantile": 1, "holt_winters": 2}

# the range functions defined on histogram columns, bucket by bucket (the
# general path's histogram functions, query/rangefns.py); a hist cache
# declines every other one
_HIST_GRID_FNS = {F.RATE, F.INCREASE, F.SUM_OVER_TIME, None}

# cross-series aggregates the grouped programs reduce on the device;
# "moments" is stddev/stdvar's (sum, count, sum of squares)
GROUPED_OPS = frozenset(("sum", "avg", "count", "min", "max", "moments"))

_ONEHOT_MAX_G = 2048  # one-hot matmul reduce beyond this costs too much memory


def resolve_device(device) -> torch.device:
    """The device a store runs on.  CUDA is the default everywhere; when
    it is asked for and absent this raises — the store never moves to
    the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the store on the CPU")
    return dev


def _seg_vals_device(seg):
    """Materialize one value-plane segment: a tensor passes through, an
    XOR-class pack decodes on the device (widen -> shift -> prefix-XOR
    down rows -> XOR the first values -> bitcast -> lane order)."""
    if not isinstance(seg, dict):
        return seg
    raw = seg["raw"]
    is32 = raw.element_size() == 4
    parts = []
    for w in (8, 16, 32):
        p = seg.get(f"p{w}")
        if p is None:
            continue
        parts.append(widen_words(p) << seg[f"z{w}"].to(torch.int64)[None, :])
    parts.append(widen_words(raw))
    u = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    if is32:
        u = u & 0xFFFFFFFF
    u = prefix_xor(u) ^ widen_words(seg["first"])[None, :]
    vals = bits_to_f32(u) if is32 else u.view(torch.float64)
    return vals[:, seg["inv"].to(torch.int64)]


def _seg_ts_device(seg):
    """Materialize one ts-plane segment: an int32 tensor, or the uniform-
    phase reconstruction ``base + row*g + phase`` (the block proved every
    lane uniform-phase at build time, so this is exact on every cell the
    kernels read through the finite-value mask)."""
    if not isinstance(seg, dict):
        return seg
    rows = torch.arange(BLOCK_BUCKETS, dtype=torch.int32,
                        device=seg["phase"].device)[:, None]
    return rows * seg["g"] + seg["base"] + seg["phase"][None, :]


def hist_slot_garr(garr: np.ndarray, lane_idx: np.ndarray,
                   gid_arr: np.ndarray, hb: int) -> None:
    """Fill the host group map ``garr`` in place with the histogram
    slot layout: series lane ``s``, bucket ``j`` (column ``s*hb + j``)
    goes to group slot ``gid*hb + j``, so the plain group reduce sums
    each bucket on its own."""
    cols = lane_idx[:, None] * hb + np.arange(hb)[None, :]
    garr[cols] = gid_arr[:, None] * hb + np.arange(hb)


def hist_planes_split(both: torch.Tensor, num_groups: int, hb: int):
    """``[2, G*hb, T]`` sum and count planes -> ``(hist_sum [G, T, hb],
    count [G, T])``, the count taken from the top (total) bucket."""
    G, T = num_groups, both.shape[-1]
    hist_sum = both[0].reshape(G, hb, T).permute(0, 2, 1)
    count = both[1].reshape(G, hb, T)[:, -1, :]
    return hist_sum, count


def hist_state_from_planes(both: torch.Tensor, num_groups: int, hb: int,
                           tops) -> dict:
    """``[2, G*hb, T]`` sum and count planes -> the histogram sum's
    partial state: ``{"hist_sum": [G, T, hb], "count": [G, T],
    "bucket_tops": tops}``."""
    hist_sum, count = hist_planes_split(both, num_groups, hb)
    return {"hist_sum": hist_sum, "count": count, "bucket_tops": tops}


def _grouped_reduce_impl(stepped, garr, num_groups: int, op: str,
                         exact: bool = False):
    """Device-side segment reduce of a grid kernel's ``[T, lanes]`` output
    into ``[G, T]`` partials, on the device.  ``garr`` maps lane -> group
    (``num_groups`` = the drop bucket for unrequested and padding lanes).
    sum/avg/count at modest G are a one-hot matmul; beyond
    ``_ONEHOT_MAX_G`` the fixed-order ``segment_sum``.  ``exact``
    accumulates the sums in f64 and rounds them to the output's dtype once: a group's f32 values
    then sum exactly, or within f64's rounding, which the final f32
    rounding hides but for values within 1e-16 of an f32 tie, so the
    answer does not depend on the order the library sums in, and a
    co-arrival group's stacked reduce equals each member's own (a scalar
    cache's; a histogram cache's ``num_groups*hb``-slot one-hot would
    take twice its f32 bytes, and never batches)."""
    v = stepped.T                                # [lanes, T]
    G = num_groups
    if op in ("sum", "avg", "count", "moments"):
        fin = torch.isfinite(v)
        vz = torch.where(fin, v, torch.zeros_like(v))
        planes = [vz, fin.to(v.dtype)]
        if op == "moments":                      # stddev/stdvar partials
            planes.append(vz * vz)
        acc = torch.float64 if exact else v.dtype
        if G + 1 <= _ONEHOT_MAX_G:
            onehot = (garr[:, None] == torch.arange(
                G, dtype=garr.dtype, device=garr.device)[None, :]
                ).to(acc)                        # [lanes, G]
            # steps are the product's rows ([T, lanes] @ [lanes, G]), as
            # in a co-arrival group's stacked [M*T, lanes] product
            outs = [segops.f32_matmul(p.T.to(acc), onehot).T.to(v.dtype)
                    for p in planes]
        else:
            outs = [segops.segment_sum(p.to(acc), garr, G + 1)[:G]
                    .to(v.dtype) for p in planes]
        return torch.stack(outs)
    if op == "min":
        return segops.seg_min(v, garr, G + 1)[:G]
    if op == "max":
        return segops.seg_max(v, garr, G + 1)[:G]
    raise ValueError(f"unsupported grouped op {op}")


def _active_query_context():
    """The QueryContext of the query whose ExecContext is active on this
    thread (its deadline and permit gate the batcher), or None."""
    from filodb_tpu_torch.query.exec import active_exec_ctx
    ctx = active_exec_ctx()
    return ctx.query_context if ctx is not None else None


_HBM_METRIC = None


def _hbm_metric():
    global _HBM_METRIC
    if _HBM_METRIC is None:
        _HBM_METRIC = query_metrics()["hbm_read_bytes"]
    return _HBM_METRIC


def _note_hbm(plan: "_GridPlan") -> None:
    """Account the serving program's device-memory reads by resident
    format: the filodb_query_hbm_read_bytes_total counter (format label)
    and the active query's ``ExecContext`` counts, so the format
    actually serving traffic is observable."""
    if not (plan.hbm_dense or plan.hbm_comp or plan.hbm_comp_hist):
        return
    m = _hbm_metric()
    if plan.hbm_dense:
        m.inc(plan.hbm_dense, format="dense")
    if plan.hbm_comp:
        m.inc(plan.hbm_comp, format="compressed")
    if plan.hbm_comp_hist:
        m.inc(plan.hbm_comp_hist, format="compressed-hist")
    from filodb_tpu_torch.query.exec import active_exec_ctx
    ctx = active_exec_ctx()
    if ctx is not None:
        ctx.note_counts(hbm_dense=plan.hbm_dense,
                        hbm_compressed=plan.hbm_comp,
                        hbm_hist=plan.hbm_comp_hist)


class _GridPlan(NamedTuple):
    """Everything needed to run one query program."""

    ts_parts: tuple       # ts segments, one per covered block; () when
                          # the program needs no ts plane
    val_parts: tuple
    row0: int             # first slice row in the concatenated blocks
    steps0_rel: int       # first window end, epoch-relative ms
    q: GridQuery
    nrows: int
    ncols: int
    lane_idx: np.ndarray  # requested pid -> lane slot, in request order
    phase: object = None  # [ncols] int32 tensor (uniform-phase mode)
    segs: tuple = ()      # the covered _Block objects
    # packed dispatch: when set, the scan runs the packed kernel on this
    # single block's class planes, output in packed lane order
    packed: object = None
    packed_row0: int = 0
    packed_use_phase: bool = False
    packed_inv: object = None      # np [ncols] orig lane -> packed pos
    # logical device bytes the program reads, by resident format
    # (approximate: whole covered planes); a histogram cache accounts
    # its packed planes under "compressed-hist"
    hbm_dense: int = 0
    hbm_comp: int = 0
    hbm_comp_hist: int = 0


def _concat(parts, decode):
    if not parts:
        return None
    segs = [decode(s) for s in parts]
    return segs[0] if len(segs) == 1 else torch.cat(segs, dim=0)


def _sliced(parts, row0: int, nrows: int, decode):
    all_ = _concat(parts, decode)
    return None if all_ is None else all_[row0:row0 + nrows]


def series_inputs(plan: _GridPlan) -> tuple:
    """Block concat and row slice: the ``(ts, vals, steps0, q, phase)``
    a plan hands the :func:`rate_grid` kernel."""
    ts_sl = _sliced(plan.ts_parts, plan.row0, plan.nrows, _seg_ts_device)
    val_sl = _sliced(plan.val_parts, plan.row0, plan.nrows,
                     _seg_vals_device)
    return ts_sl, val_sl, plan.steps0_rel, plan.q, plan.phase


def _series_impl(plan: _GridPlan):
    ts_sl, val_sl, steps0, q, phase = series_inputs(plan)
    return rate_grid(ts_sl, val_sl, steps0, q, phase=phase)


def _series_packed_impl(plan: _GridPlan):
    return rate_grid_packed(plan.packed, plan.steps0_rel, plan.q,
                            row0=plan.packed_row0,
                            use_phase=plan.packed_use_phase)


@timed(program="devicestore.series")
def series_program(plan: _GridPlan):
    """Block concat, row slice and the grid kernel: ``[T, ncols]``."""
    return _series_impl(plan)


@timed(program="devicestore.grouped")
def grouped_program(plan: _GridPlan, garr, num_groups: int, op: str,
                    exact: bool = False):
    return _grouped_reduce_impl(_series_impl(plan), garr, num_groups, op,
                                exact)


@timed(program="devicestore.series_packed")
def series_packed_program(plan: _GridPlan):
    """The packed kernel on one block: ``[T, packed width]``."""
    return _series_packed_impl(plan)


@timed(program="devicestore.grouped_packed")
def grouped_packed_program(plan: _GridPlan, garr, num_groups: int, op: str,
                           exact: bool = False):
    return _grouped_reduce_impl(_series_packed_impl(plan), garr,
                                num_groups, op, exact)


def _series_batch_impl(plan: _GridPlan, row0s, steps0s):
    """The blocks concatenated once, then one :func:`rate_grid_batch`
    launch over the members' rows: ``[M, T, ncols]``."""
    ts_all = _concat(plan.ts_parts, _seg_ts_device)
    val_all = _concat(plan.val_parts, _seg_vals_device)
    return rate_grid_batch(ts_all, val_all, row0s, steps0s, plan.q,
                           plan.nrows, phase=plan.phase)


@timed(program="devicestore.series_batch")
def series_batch_program(plan: _GridPlan, row0s, steps0s):
    """A co-arrival group's ``series`` program: ``[M, T, ncols]``, member
    m's answer bit for bit its solo ``series_program``'s."""
    return _series_batch_impl(plan, row0s, steps0s)


@timed(program="devicestore.grouped_batch")
def grouped_batch_program(plan: _GridPlan, row0s, steps0s, garr,
                          num_groups: int, op: str):
    """A co-arrival group's ``grouped`` program: one launch, then ONE
    reduce over every member's steps with the members' shared group map
    (``[M*T]`` columns; the one-hot matmul once, not M times), its sums
    accumulated exactly as a scalar cache's solo reduce does.  Returns
    ``[M, ...]``, member m's partials laid out as its solo
    ``grouped_program``'s."""
    stacked = _series_batch_impl(plan, row0s, steps0s)
    M, T, n = stacked.shape
    both = _grouped_reduce_impl(stacked.reshape(M * T, n), garr,
                                num_groups, op, exact=True)
    # [..., G, M*T] -> [M, ..., G, T], each member's block contiguous
    both = both.reshape(*both.shape[:-1], M, T)
    return both.movedim(-2, 0).contiguous()


def _note_kernel_bytes(prog_fn, plan: _GridPlan) -> None:
    """Credit the plan's resident bytes to the program about to run: the
    numerator of the kernel ledger's achieved bytes/s.  The name comes
    off the callable (``timed`` stamps ``_program``), so a rename cannot
    decouple the bytes from the launches."""
    program = getattr(prog_fn, "_program", None)
    if program:
        KERNEL_TIMER.note_bytes(
            program, plan.hbm_dense + plan.hbm_comp + plan.hbm_comp_hist)


def _ids_fingerprint(part_ids) -> int:
    """Position-dependent content hash over every id: guards the
    id()-keyed prep cache against address reuse and keys the big-K deny
    set."""
    n = len(part_ids)
    ids = np.asarray(part_ids, dtype=np.uint64)
    with np.errstate(over="ignore"):
        mixed = (ids + np.arange(1, n + 1, dtype=np.uint64)) \
            * np.uint64(0x9E3779B97F4A7C15)
    return n * 1_000_003 + int(np.bitwise_xor.reduce(mixed))


class _Block:
    """One resident time block: tensors ``[BLOCK_BUCKETS, lanes]``.

    ``fmin/fmax/fcnt`` (host numpy, per lane) record the filled-bucket
    range so queries prove the dense-lane contract without touching the
    device: a lane is dense over local rows [a, b] iff contiguous and
    fmin <= a <= b <= fmax, and empty iff fcnt == 0 or the range misses.
    ``pmin/pmax`` record the within-bucket scrape offset range of the
    filled cells: ``pmin == pmax`` means the lane is uniform-phase."""

    __slots__ = ("ts", "vals", "lanes", "nbytes", "last_used",
                 "fmin", "fmax", "fcnt", "pmin", "pmax", "staged_hi",
                 "ts_desc", "width", "pack_inv", "floor_ms")

    def __init__(self, ts, vals, lanes: int, seq: int, fill_stats,
                 phase_stats, staged_hi: int, nbytes: int, width: int,
                 ts_desc=None, pack_inv=None):
        # ts: int32 tensor, or None when every lane proved uniform-phase
        # (ts_desc rebuilds it); vals: tensor, or the XOR-class dict
        self.ts = ts
        self.vals = vals
        self.lanes = lanes
        self.width = width
        self.nbytes = nbytes
        self.last_used = seq
        self.fmin, self.fmax, self.fcnt = fill_stats
        self.pmin, self.pmax = phase_stats
        self.ts_desc = ts_desc
        # host copy of the pack's original-lane -> packed-position map;
        # None for decoded-plane blocks
        self.pack_inv = pack_inv
        # lanes < staged_hi were populated at build time; a later lane
        # must rebuild the block, never serve NaN
        self.staged_hi = staged_hi
        # the paging shard's disk floor when this block was staged, if
        # the block reaches below it: its rows there were on disk only
        # and are missing here, so once the floor drops (the partitions
        # evicted and paged back whole) the block must be staged anew
        self.floor_ms = _NO_FLOOR

    @property
    def ts_seg(self):
        return self.ts if self.ts is not None else self.ts_desc

    def dense_or_empty(self, a: int, b: int):
        """Per-lane (dense, empty) masks over local rows [a, b]."""
        contiguous = self.fcnt == self.fmax - self.fmin + 1
        dense = contiguous & (self.fmin <= a) & (self.fmax >= b)
        empty = (self.fcnt == 0) | (self.fmax < a) | (self.fmin > b)
        return dense, empty


_NO_FLOOR = -(2**62)      # no partition's rows are on disk only


class DeviceGridCache:
    """Per-(shard, schema, value-column) device grid with eviction."""

    def __init__(self, shard, schema_hash: int, column_id: int,
                 budget_bytes: int, gstep_ms: Optional[int] = None,
                 hist: bool = False):
        self._shard = shard
        self.device: torch.device = shard.device
        self.schema_hash = schema_hash
        self.column_id = column_id
        self.budget = budget_bytes
        self.owner = (f"grid:{getattr(shard, 'dataset', '?')}/"
                      f"{getattr(shard, 'shard_num', '?')}:c{column_id}")
        self.gstep = gstep_ms          # None until detected
        # histogram columns: each partition's slot spans ``hb`` device
        # columns, one a cumulative bucket, and the scalar kernels compute
        # each bucket's window function
        self.hist = hist
        self.hb: Optional[int] = None          # bucket columns a slot
        self.bucket_tops: Optional[np.ndarray] = None
        self.epoch0: Optional[int] = None
        self.lane_of: dict[int, int] = {}
        self._next_lane = 0
        self.blocks: dict[int, _Block] = {}
        self._tails: dict[int, tuple[int, _Block]] = {}  # bi -> (ver, blk)
        self.version = 0               # bumped on invalidating freezes
        # quarantine epoch the resident blocks were staged under: a
        # chunk quarantined after staging must stop being served, so a
        # changed epoch drops every block for a re-stage through the
        # (exclusion-applying) partition read path
        self._quarantine_epoch = -1
        self.disabled_until_version = -1
        self._disable_count = 0        # exponential re-try backoff
        self._preps: dict[int, dict] = {}   # id(part_ids) -> prep
        # shapes that failed the dense proof: denied until data changes
        self._bigk_deny: dict[tuple, tuple] = {}
        # (bi_lo, bi_hi, version) -> (host phases, device phases)
        self._phase_memo: dict[tuple, tuple] = {}
        # full-plan memo, keyed on every invalidation axis
        self._plan_memo: dict[tuple, _GridPlan] = {}
        # (ingest epoch, removal epoch, ids fingerprint) -> the paging
        # shard's disk floor over those partitions
        self._disk_floor: dict[tuple, int] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self.builds = 0
        self.hits = 0
        self.dense_hits = 0
        self.evictions = 0

    # ------------------------------------------------------------ bookkeeping

    @property
    def bytes_resident(self) -> int:
        n = sum(b.nbytes for b in self.blocks.values())
        n += sum(blk.nbytes for _v, blk in self._tails.values())
        return n

    def note_freeze(self, cs) -> None:
        """A chunk froze: blocks overlapping it are stale and the tail
        moved."""
        with self._lock:
            self._tails.clear()
            self._plan_memo.clear()
            if self.gstep is None or self.epoch0 is None:
                return
            lo_block = (cs.info.start_time - self.epoch0) // (
                self.gstep * BLOCK_BUCKETS)
            stale = [bi for bi in self.blocks if bi >= lo_block]
            nbytes = sum(self.blocks[bi].nbytes for bi in stale)
            for bi in stale:
                del self.blocks[bi]
            if stale:
                LEDGER.note_eviction(self.owner, "epoch_purge",
                                     n=len(stale), nbytes=nbytes)
                self.version += 1

    _STD_STEPS = (1_000, 2_000, 5_000, 10_000, 15_000, 30_000, 60_000,
                  120_000, 300_000, 600_000, 900_000, 1_800_000, 3_600_000)

    def _detect_gstep(self, part) -> Optional[int]:
        """Median inter-sample delta snapped to the nearest standard
        scrape interval."""
        ts, _ = part.read_range(0, 2**62, self.column_id)
        if len(ts) < 3:
            return None
        deltas = np.diff(ts)
        deltas = deltas[deltas > 0]
        if len(deltas) == 0:
            return None
        med = float(np.median(deltas))
        best = min(self._STD_STEPS, key=lambda c: abs(c - med))
        if abs(best - med) <= 0.5 * best:
            return best
        return int(med)

    def _disable(self) -> None:  # holds-lock: _lock
        """Turn the fast path off; retries back off exponentially."""
        self._disable_count += 1
        backoff = 2 ** min(self._disable_count, 16)
        self.disabled_until_version = self._shard.ingest_epoch + backoff
        n = len(self.blocks) + len(self._tails)
        if n:
            LEDGER.note_eviction(self.owner, "epoch_purge", n=n,
                                 nbytes=self.bytes_resident)
        self.blocks.clear()
        self._tails.clear()
        self._plan_memo.clear()
        # re-probe the bucket scheme on the next attempt: a widened
        # histogram must not disable the cache for good once the narrow
        # chunks age out
        self.hb = None
        self.bucket_tops = None

    # ---------------------------------------------------------------- serving

    def scan_rate(self, part_ids: Sequence[int], func, steps0: int,
                  nsteps: int, step_ms: int, window_ms: int,
                  fargs: tuple = ()):
        """Serve a _GRID_OPS window function on the query step grid from
        device-resident blocks.  Returns ``(vals [S_req, T], None)`` —
        ``(vals [S_req, T, hb], bucket_tops)`` for a histogram column —
        with ``vals`` a tensor on the store's device (nothing is read
        back), or None when the fast path cannot serve the query.
        ``timestamp`` comes back as absolute seconds in f64."""
        if func not in _GRID_OPS:
            return None
        if self.hist and func not in _HIST_GRID_FNS:
            return None
        if len(fargs) != _ARG_OPS.get(_GRID_OPS[func], 0):
            return None        # unexpected / missing function argument
        with self._lock:
            plan = self._plan_locked(part_ids, func, steps0, nsteps,
                                     step_ms, window_ms, fargs)
            if plan is None:
                return None
            _note_hbm(plan)
            # snapshot under the lock: a concurrent _disable drops them
            hb, tops = self.hb, self.bucket_tops
        # dispatch + readback outside the lock: the plan holds live
        # references to its tensors
        return self._dispatch_series(plan, hb), tops

    def scan_rate_grouped(self, part_ids: Sequence[int], func,
                          steps0: int, nsteps: int, step_ms: int,
                          window_ms: int, group_ids: Sequence[int],
                          num_groups: int, op: str = "sum",
                          fargs: tuple = ()):
        """Fused ``agg by (g)(<grid window fn>(...))``: the kernel's
        ``[T, lanes]`` output is reduced to ``[G, T]`` on the device.
        Returns the mergeable partial state ({"sum","count"} /
        {"count"} / {"min"} / {"max"} / {"sum","count","sumsq"}; a
        histogram column's sum {"hist_sum" [G, T, hb], "count",
        "bucket_tops"}) as tensors on the store's device, or None."""
        if func not in _GRID_OPS or op not in GROUPED_OPS:
            return None
        if self.hist and (func not in _HIST_GRID_FNS or op != "sum"):
            return None        # only the bucket-wise sum is defined
        if _GRID_OPS[func] in _REBASE_OPS:
            return None        # re-based ops skip the fused reduce
        if len(fargs) != _ARG_OPS.get(_GRID_OPS[func], 0):
            return None        # unexpected / missing function argument
        with self._lock:
            plan = self._plan_locked(part_ids, func, steps0, nsteps,
                                     step_ms, window_ms, fargs)
            if plan is None:
                return None
            _note_hbm(plan)
            stride = self.hb if self.hist else 1
            tops = self.bucket_tops
            slots = num_groups * stride          # the drop slot's index
            garr = np.full(plan.ncols, slots, dtype=np.int32)
            gid_arr = np.asarray(group_ids, dtype=np.int32)
            if self.hist:
                hist_slot_garr(garr, plan.lane_idx, gid_arr, stride)
            else:
                garr[plan.lane_idx] = gid_arr
        if plan.packed is not None:
            # packed column order: scatter the group map through inv;
            # pack pad columns keep the drop slot
            n_pk = int(plan.packed["first"].shape[0])
            garr_pk = np.full(n_pk, slots, dtype=np.int32)
            garr_pk[plan.packed_inv] = garr
            _note_kernel_bytes(grouped_packed_program, plan)
            both = grouped_packed_program(
                plan, torch.as_tensor(garr_pk, device=self.device),
                slots, op, not self.hist)
        else:
            def grouped_solo():
                # the per-query program: also every batching fallback
                _note_kernel_bytes(grouped_program, plan)
                return grouped_program(
                    plan, torch.as_tensor(garr, device=self.device), slots,
                    op, not self.hist)

            both = None if self.hist else self._batched_grouped(
                plan, garr, slots, op, grouped_solo)
            if both is None:
                both = grouped_solo()
        if self.hist:
            return hist_state_from_planes(both, num_groups, stride, tops)
        if op == "count":
            return {"count": both[1]}
        if op in ("sum", "avg"):
            return {"sum": both[0], "count": both[1]}
        if op == "moments":
            return {"sum": both[0], "count": both[1], "sumsq": both[2]}
        return {op: both}

    def _batched_grouped(self, plan: _GridPlan, garr: np.ndarray,
                         num_groups: int, op: str, grouped_solo):
        """Offer a grouped program to the shard's query batcher.  Members
        must share the group map exactly (its bytes are part of the key):
        the stacked program reduces every member with the one map (the
        leader uploads it; a member that joins uploads nothing).
        Returns the member's partials (a view of the stacked output), or
        None for the solo program."""
        batcher = getattr(self._shard, "query_batcher", None)
        if batcher is None or not batcher.enabled:
            return None
        key = ("grouped", tuple(id(p) for p in plan.ts_parts),
               tuple(id(p) for p in plan.val_parts), id(plan.phase),
               plan.q, plan.ncols, plan.nrows, num_groups, op,
               garr.tobytes())

        def batch_launch(row0s, steps0s):
            _note_kernel_bytes(grouped_batch_program, plan)
            return grouped_batch_program(
                plan, row0s, steps0s,
                torch.as_tensor(garr, device=self.device), num_groups, op)

        return batcher.dispatch(key, plan.row0, plan.steps0_rel,
                                _active_query_context(), batch_launch,
                                grouped_solo)

    def _series_solo(self, plan: _GridPlan) -> torch.Tensor:
        """The per-query decoded-plane program: also every batching
        fallback (the same launch, so the same bits)."""
        _note_kernel_bytes(series_program, plan)
        return series_program(plan)

    def _batched_series(self, plan: _GridPlan):
        """Offer a decoded-plane series program to the shard's query
        batcher.  Members share the resident planes (their identity),
        the phase row, the query, the width and the rows they read, and
        differ only in ``(row0, steps0)``; the lanes each requests are
        taken from its own slice.  Returns the member's ``[T, ncols]``
        (a view of the stacked output on the store's device), or None
        when the batcher declined and the caller runs the solo
        program."""
        batcher = getattr(self._shard, "query_batcher", None)
        if batcher is None or not batcher.enabled or self.hist:
            return None
        key = ("series", tuple(id(p) for p in plan.ts_parts),
               tuple(id(p) for p in plan.val_parts), id(plan.phase),
               plan.q, plan.ncols, plan.nrows)

        def batch_launch(row0s, steps0s):
            _note_kernel_bytes(series_batch_program, plan)
            return series_batch_program(plan, row0s, steps0s)

        return batcher.dispatch(key, plan.row0, plan.steps0_rel,
                                _active_query_context(), batch_launch,
                                lambda: self._series_solo(plan))

    def _dispatch_series(self, plan: _GridPlan, hb) -> torch.Tensor:
        """The plan's program and the requested series out of its
        ``[T, columns]`` answer: ``[S_req, T]``, or ``[S_req, T, hb]``
        for a histogram cache (``hb`` its bucket columns a slot).  The
        packed program first; then, for a decoded-plane plan of a scalar
        column, the query batcher; then the solo program."""
        if plan.packed is not None:
            _note_kernel_bytes(series_packed_program, plan)
            stepped = series_packed_program(plan)
        else:
            stepped = self._batched_series(plan)
            if stepped is None:
                stepped = self._series_solo(plan)
        dev = stepped.device
        if self.hist:
            # column-granular indirection: a series' columns are
            # lane*hb + bucket, and the pack's inv maps columns, so it
            # composes with the expanded column map, not the lane map
            cols = plan.lane_idx[:, None] * hb + np.arange(hb)[None, :]
            if plan.packed is not None:
                cols = plan.packed_inv[cols]
            idx = torch.as_tensor(cols.ravel(), dtype=torch.int64,
                                  device=dev)
            return stepped.index_select(1, idx).reshape(
                stepped.shape[0], *cols.shape).permute(1, 0, 2)
        lanes_req = plan.lane_idx if plan.packed is None \
            else plan.packed_inv[plan.lane_idx]
        # the requested lanes, series-major: a transposed view of the
        # time-major [T, S_req] selection
        idx = torch.as_tensor(lanes_req, dtype=torch.int64, device=dev)
        out = stepped.index_select(1, idx).T
        if plan.q.op in _REBASE_OPS:
            # absolute window-end seconds, re-based in f64 on the
            # requested lanes only (the kernel emits window-relative
            # seconds so that f32 stays exact)
            q = plan.q
            steps = torch.arange(q.nsteps, dtype=torch.int64,
                                 device=out.device)
            abs_ms = self.epoch0 + plan.steps0_rel \
                + steps * (q.gstep_ms * q.stride)
            out = out.to(torch.float64)
            abs_s = abs_ms.to(torch.float64) / torch.tensor(
                1000.0, dtype=torch.float64, device=out.device)
            out = out + torch.where(torch.isfinite(out), abs_s[None, :],
                                    torch.zeros_like(out))
        return out

    def _prep_for(self, part_ids, fp=None):
        """Memoized resolution of one lookup result: validate every pid
        (present + matching schema), assign lanes, build the lane index.
        Keyed on the lookup result's identity and the shard's removal
        epoch."""
        shard = self._shard
        n = len(part_ids)
        if n == 0:
            return None
        key = id(part_ids)
        if fp is None:
            fp = _ids_fingerprint(part_ids)
        prep = self._preps.get(key)
        if (prep is not None and prep["epoch"] == shard.removal_epoch
                and prep["fp"] == fp and prep["obj"] is part_ids):
            return prep
        epoch = shard.removal_epoch
        ids = [int(p) for p in part_ids]
        for pid in ids:
            part = shard.grid_partition(pid)
            if part is None:
                return None
            if part.schema.schema_hash != self.schema_hash:
                return None                    # mixed-schema id list
            if pid not in self.lane_of:
                self.lane_of[pid] = self._next_lane
                self._next_lane += 1
        lane_idx = np.fromiter((self.lane_of[pid] for pid in ids),
                               dtype=np.int64, count=n)
        # "obj" holds a strong reference: id() stays unambiguous
        prep = {"epoch": epoch, "fp": fp, "obj": part_ids, "ids": ids,
                "lane_idx": lane_idx}
        if len(self._preps) > 16:
            self._preps.clear()
        self._preps[key] = prep
        return prep

    def _plan_locked(self, part_ids, func, steps0, nsteps, step_ms,
                     window_ms, fargs=()):
        """Eligibility checks, block assembly and the dense-contract and
        uniform-phase proofs.  Returns a :class:`_GridPlan` (no device
        dispatch happens here) or None."""
        shard = self._shard
        if self.disabled_until_version >= shard.ingest_epoch:
            return None
        if len(part_ids) == 0:
            return None
        qepoch = integrity.QUARANTINE.epoch()
        if qepoch != self._quarantine_epoch:
            # blocks staged before a quarantine still CONTAIN the
            # quarantined chunk's rows: serving them would defeat the
            # exclusion the partition read path applies.  Quarantine is
            # rare; a full re-stage is the correct price.
            if self._quarantine_epoch >= 0 and (self.blocks or self._tails):
                LEDGER.note_eviction(self.owner, "integrity_quarantine",
                                     n=len(self.blocks) + len(self._tails),
                                     nbytes=self.bytes_resident)
                self.blocks.clear()
                self._tails.clear()
                self._plan_memo.clear()
                self._phase_memo.clear()
                self.version += 1
            self._quarantine_epoch = qepoch
        # every eligibility check runs before _prep_for assigns lanes:
        # an ineligible query must not widen the lane count
        first = shard.grid_partition(int(part_ids[0]))
        if first is None or first.schema.schema_hash != self.schema_hash:
            return None
        if self.gstep is None:
            g = shard.config.grid_step_ms or self._detect_gstep(first)
            if not g or g <= 0:
                self._disable()
                return None
            self.gstep = g
        g = self.gstep
        op = _GRID_OPS[func]
        # optimistic K cap: K-free ops may take large windows if the
        # dense proof below succeeds (checked again once dense is known)
        if not supports_grid(window_ms, step_ms, g, nsteps,
                             max_k=max_k_for(op, dense=True)):
            return None
        ids_fp = _ids_fingerprint(part_ids)
        deny_key = (func, window_ms, step_ms, ids_fp)
        if self._bigk_deny.get(deny_key) == \
                (self.version, shard.ingest_epoch):
            return None
        pkey = (func, steps0, nsteps, step_ms, window_ms, fargs, ids_fp,
                self.version, shard.ingest_epoch, shard.removal_epoch)
        cached = self._plan_memo.get(pkey)
        if cached is not None:
            self._seq += 1
            for blk in cached.segs:
                blk.last_used = self._seq
            self.hits += 1
            return cached
        if self.hist and self.hb is None:
            # the bucket scheme, probed on a narrow leading slice: a read
            # of the whole history would decode every chunk under the lock
            e0 = first.earliest_timestamp
            _pts, pvals = first.read_range(e0, e0 + 64 * g, self.column_id)
            buckets = pvals[0] if isinstance(pvals, tuple) else None
            if buckets is None or buckets.num_buckets == 0:
                self._disable()
                return None
            self.hb = int(buckets.num_buckets)
            self.bucket_tops = np.asarray(buckets.bucket_tops(), np.float64)
        if self.epoch0 is None:
            parts0 = (shard.grid_partition(int(pid)) for pid in part_ids)
            earliest = [p.earliest_timestamp for p in parts0 if p is not None]
            first_ts = min((t for t in earliest if t >= 0), default=-1)
            if first_ts < 0:
                return None
            self.epoch0 = (first_ts // g) * g
        if (steps0 - self.epoch0) % g != 0:
            return None                        # windows don't land on edges
        K = window_ms // g
        stride_r = step_ms // g
        # first window ends at steps0 and covers buckets [c0, c0+K-1]
        c0 = (steps0 - self.epoch0) // g - K + 1
        c_last = c0 + (nsteps - 1) * stride_r + K - 1     # inclusive
        if c0 < 0:
            return None
        if (c_last + 1) * g > _I32_SPAN:
            return None                        # int32-relative overflow
        floor = _NO_FLOOR
        if hasattr(shard, "paged"):
            # paging shard: a resident may hold only its post-recovery
            # tail, its older chunks on disk, where the grid would serve
            # NaN.  Checked before _prep_for: a refused query must not
            # widen the lane count
            parts = [shard.grid_partition(int(pid)) for pid in part_ids]
            if any(p is None for p in parts):
                return None
            lo_ms = self.epoch0 + (c0 - 1) * g
            floor = self._disk_floor_ms(parts, ids_fp)
            if lo_ms < floor:
                return None
        prep = self._prep_for(part_ids, fp=ids_fp)
        if prep is None:
            return None
        lanes = max(_LANE_PAD,
                    -(-self._next_lane // _LANE_PAD) * _LANE_PAD)
        if any(b.lanes != lanes for b in self.blocks.values()):
            self.blocks.clear()                # widths must match to concat
            self._tails.clear()
            self._plan_memo.clear()
        frozen_hi = self._frozen_high()
        bi_lo = c0 // BLOCK_BUCKETS
        bi_hi = c_last // BLOCK_BUCKETS
        # a block built before some requested partition got its lane has
        # that lane unstaged: it must rebuild with the current roster
        need_hi = int(prep["lane_idx"].max()) + 1
        segments = []
        self._seq += 1
        for bi in range(bi_lo, bi_hi + 1):
            blk = self._block_for(bi, lanes, frozen_hi, need_hi, floor)
            if blk is None:
                return None                    # invariant violated
            blk.last_used = self._seq
            segments.append(blk)
        self._evict(keep=set(range(bi_lo, bi_hi + 1)))

        row0 = c0 - bi_lo * BLOCK_BUCKETS
        nrows = c_last - c0 + 1
        ncols = segments[0].width
        # dense-lane proof over the REQUESTED lanes: dense in every
        # covered block, or empty in every one
        req = prep["lane_idx"]
        if self.hist:
            req = (req[:, None] * self.hb
                   + np.arange(self.hb)[None, :]).ravel()
        # phase proof piggybacks on the dense walk: every requested lane
        # uniform-phase in each covered block with the SAME phase across
        # blocks; tail blocks are excluded
        want_phase = op in PHASE_OPS and K >= 2 and \
            bi_hi * BLOCK_BUCKETS + BLOCK_BUCKETS - 1 <= frozen_hi
        ph_req = np.full(len(req), -1, np.int64)
        ph_ok = want_phase
        all_dense = np.ones(len(req), bool)
        all_empty = np.ones(len(req), bool)
        for off, blk in zip(range(bi_lo, bi_hi + 1), segments):
            a = max(c0 - off * BLOCK_BUCKETS, 0)
            b = min(c_last - off * BLOCK_BUCKETS, BLOCK_BUCKETS - 1)
            d, e = blk.dense_or_empty(a, b)
            all_dense &= d[req]
            all_empty &= e[req]
            if ph_ok:
                nonempty = ~e[req]
                uniform = blk.pmin[req] == blk.pmax[req]
                bph = blk.pmin[req].astype(np.int64)
                conflict = nonempty & (ph_req >= 0) & (ph_req != bph)
                if (nonempty & ~uniform).any() or conflict.any():
                    ph_ok = False
                else:
                    ph_req = np.where(nonempty & (ph_req < 0), bph, ph_req)
        dense = bool((all_dense | all_empty).all())
        if (op in DENSE_ONLY_OPS and not dense) \
                or K > max_k_for(op, dense):
            # large windows need the proven-dense K-free path: memoize
            # the denial until the data changes
            self._bigk_deny.pop(deny_key, None)
            self._bigk_deny[deny_key] = (self.version, shard.ingest_epoch)
            if len(self._bigk_deny) > 64:
                self._bigk_deny.pop(next(iter(self._bigk_deny)))
            return None
        if dense:
            self.dense_hits += 1
        q = GridQuery(nsteps=nsteps, kbuckets=K, gstep_ms=g,
                      is_rate=(func == F.RATE), op=op, dense=dense,
                      stride=stride_r,
                      farg=float(fargs[0]) if fargs else 0.0,
                      farg2=float(fargs[1]) if len(fargs) > 1 else 0.0)
        phase_dev = None
        if ph_ok and phase_eligible(q):
            phase_dev = self._phase_device(ph_req, req, ncols,
                                           (bi_lo, bi_hi, self.version))
        self.hits += 1
        # phase mode and ts-free ops need no ts plane
        ts_parts = () if (phase_dev is not None or op in TS_FREE_OPS) \
            else tuple(b.ts_seg for b in segments)
        # packed dispatch: one compressed f32 block (meta tiles present)
        # covering the whole row span serves through the packed kernel;
        # multi-block spans, ts-streaming ops and f64 residents take the
        # decode + rate_grid path
        seg0 = segments[0]
        packed = packed_inv = None
        packed_phase = False
        if (len(segments) == 1 and isinstance(seg0.vals, dict)
                and seg0.pack_inv is not None
                and any(k.startswith("m") for k in seg0.vals)):
            if op in TS_FREE_OPS:
                packed, packed_inv = seg0.vals, seg0.pack_inv
            elif phase_dev is not None and op in PHASE_OPS:
                packed, packed_inv = seg0.vals, seg0.pack_inv
                packed_phase = True
        hbm_dense = hbm_comp = 0
        for part in [b.vals for b in segments] + list(ts_parts):
            if isinstance(part, dict):
                # a pack's planes, or a rebuilt ts plane's phase row
                hbm_comp += sum(t.numel() * t.element_size()
                                for t in part.values()
                                if isinstance(t, torch.Tensor))
            else:
                hbm_dense += part.numel() * part.element_size()
        hbm_hist = 0
        if self.hist:
            hbm_hist, hbm_comp = hbm_comp, 0
        plan = _GridPlan(ts_parts, tuple(b.vals for b in segments), row0,
                         steps0 - self.epoch0, q, nrows, ncols,
                         prep["lane_idx"], phase_dev, tuple(segments),
                         packed=packed, packed_row0=row0,
                         packed_use_phase=packed_phase,
                         packed_inv=packed_inv, hbm_dense=hbm_dense,
                         hbm_comp=hbm_comp, hbm_comp_hist=hbm_hist)
        if len(self._plan_memo) > 8:
            self._plan_memo.clear()
        self._plan_memo[pkey] = plan
        return plan

    def _phase_device(self, ph_req, req, ncols: int, key):  # holds-lock: _lock
        """Device ``[ncols]`` phase vector, memoized per (block range,
        cache version).  Unrequested lanes get phase 1; their outputs
        are dropped downstream."""
        phases = np.where(ph_req > 0, ph_req, 1).astype(np.int32)
        memo = self._phase_memo.get(key)
        if memo is not None and memo[0].shape[0] == ncols:
            host, dev = memo
            if np.array_equal(host[req], phases):
                return dev
            ph_cols = host.copy()
            ph_cols[req] = phases
        else:
            ph_cols = np.ones(ncols, np.int32)
            ph_cols[req] = phases
        dev = LEDGER.device_put(ph_cols, self.device, owner=self.owner,
                                fmt="scratch")
        self._phase_memo.clear()
        self._phase_memo[key] = (ph_cols, dev)
        return dev

    # ---------------------------------------------------------------- blocks

    def _disk_floor_ms(self, parts, ids_fp) -> int:
        """Highest timestamp below which some requested partition's data
        lives only in the column store (a recovery tail, or rows
        re-ingested after an eviction).  Memoized per shard ingest and
        removal epoch and per set of partitions: the floor is the
        requested partitions' own, and an eviction or a page-in changes
        it (the reference memoizes it per ingest epoch alone, and serves
        one subset's floor to another)."""
        shard = self._shard
        key = (shard.ingest_epoch, shard.removal_epoch, ids_fp)
        got = self._disk_floor.get(key)
        if got is not None:
            return got
        floor = _NO_FLOOR
        index = shard.index
        for part in parts:
            earliest = part.earliest_timestamp
            if earliest < 0:
                continue
            try:
                idx_start = index.start_time(part.part_id)
            except KeyError:
                continue
            if idx_start < earliest:
                floor = max(floor, earliest)
        if any(k[:2] != key[:2] for k in self._disk_floor):
            self._disk_floor.clear()
        self._disk_floor[key] = floor
        return floor

    def _frozen_high(self) -> int:
        """Highest bucket (exclusive) fully covered by frozen chunks: the
        earliest write-buffer row across this cache's lanes bounds it."""
        lo = None
        for pid in self.lane_of:
            part = self._shard.grid_partition(pid)
            if part is None:
                continue
            if part._buf_n:
                t = int(part._buf_ts[0])
                lo = t if lo is None or t < lo else lo
        if lo is None:
            return 2**62
        return (lo - self.epoch0 + self.gstep - 1) // self.gstep - 1

    def _block_for(self, bi: int, lanes: int,  # holds-lock: _lock
                   frozen_hi: int, need_hi: int,
                   floor: int = _NO_FLOOR):
        """Block ``bi``: the resident one if it is still whole, else
        staged anew.  ``floor`` is the paging shard's disk floor: a block
        staged while part of its span lay on disk only is whole again
        only if the floor has not dropped since."""
        b_lo = bi * BLOCK_BUCKETS
        b_hi = b_lo + BLOCK_BUCKETS - 1
        blk = self.blocks.get(bi)
        if blk is not None and blk.lanes == lanes \
                and blk.staged_hi >= need_hi and b_hi <= frozen_hi \
                and blk.floor_ms <= floor:
            return blk
        if b_hi > frozen_hi:
            # tail block: holds mutable write-buffer rows; cached under
            # the shard's ingest epoch, never compressed
            epoch = self._shard.ingest_epoch
            got = self._tails.get(bi)
            if got is not None and got[0] == epoch \
                    and got[1].lanes == lanes \
                    and got[1].staged_hi >= need_hi \
                    and got[1].floor_ms <= floor:
                return got[1]
            blk = self._build(bi, lanes, compress=False)
            if blk is not None:
                blk.floor_ms = self._staged_floor(bi, floor)
                self._tails[bi] = (epoch, blk)
                while len(self._tails) > 8:
                    self._tails.pop(next(iter(self._tails)))
            return blk
        blk = self._build(bi, lanes)
        if blk is not None:
            blk.floor_ms = self._staged_floor(bi, floor)
            self.blocks[bi] = blk
            self.version += 1
        return blk

    def _staged_floor(self, bi: int, floor: int) -> int:
        """The floor a block of ``bi`` records: ``floor`` if the block's
        span reaches below it, else none (the block is whole)."""
        b_lo_ms = self.epoch0 + (bi * BLOCK_BUCKETS - 1) * self.gstep
        return floor if floor > b_lo_ms else _NO_FLOOR

    def _val_dtype(self):
        """f32 on the card (the kernels' type); f64 on the CPU, where the
        plain versions keep full double precision."""
        return np.float32 if self.device.type == "cuda" else np.float64

    def _build(self, bi: int, lanes: int, compress: bool = True):
        """Host staging + one upload for block ``bi``."""
        g = self.gstep
        stride = self.hb if self.hist else 1
        # block bi holds buckets [bi*BB, bi*BB+BB-1]; bucket c covers
        # (epoch0+(c-1)*g, epoch0+c*g]
        b_lo_ms = self.epoch0 + (bi * BLOCK_BUCKETS - 1) * g
        b_hi_ms = b_lo_ms + BLOCK_BUCKETS * g
        ts_stage = np.zeros((BLOCK_BUCKETS, lanes * stride), np.int32)
        val_stage = np.full((BLOCK_BUCKETS, lanes * stride), np.nan,
                            self._val_dtype())
        dropped_lane = False
        for pid, lane in list(self.lane_of.items()):
            part = self._shard.grid_partition(pid)
            if part is None:
                # a laned partition with no data must not stay laned: a
                # re-materialized partition then gets a fresh lane that
                # forces a rebuild; this build fails so an in-flight
                # query falls back
                del self.lane_of[pid]
                dropped_lane = True
                continue
            ts, vals = part.read_range(b_lo_ms + 1, b_hi_ms, self.column_id)
            if len(ts) == 0:
                continue
            if self.hist:
                _buckets, rows = vals
                if rows.size == 0:
                    continue
                if rows.shape[1] > self.hb:
                    self._disable()             # bucket scheme widened
                    return None
                arr = rows.astype(self._val_dtype())
                if arr.shape[1] < self.hb:
                    # a narrower cumulative histogram: its top bucket is
                    # the total, so it edge-pads (as scan_batch does)
                    arr = np.pad(arr, ((0, 0), (0, self.hb - arr.shape[1])),
                                 mode="edge")
            elif not isinstance(vals, np.ndarray):
                self._disable()                 # string column
                return None
            else:
                arr = vals[:, None]
            buckets = (ts - self.epoch0 + g - 1) // g - bi * BLOCK_BUCKETS
            if len(np.unique(buckets)) != len(buckets):
                self._disable()                 # >1 sample per bucket
                return None
            col0 = lane * stride
            ts_stage[buckets, col0:col0 + stride] = \
                (ts - self.epoch0).astype(np.int32)[:, None]
            val_stage[buckets, col0:col0 + stride] = arr
        if dropped_lane:
            return None
        self.builds += 1
        fin = np.isfinite(val_stage)
        fcnt = fin.sum(axis=0).astype(np.int32)
        fmin = fin.argmax(axis=0).astype(np.int32)
        fmax = (BLOCK_BUCKETS - 1 - fin[::-1].argmax(axis=0)).astype(np.int32)
        fmax[fcnt == 0] = -1
        # within-bucket offset of each filled cell: local row r of block
        # bi is global bucket c = bi*BB + r, phase = ts_rel - (c-1)*g
        cstart = ((np.arange(BLOCK_BUCKETS, dtype=np.int64)
                   + bi * BLOCK_BUCKETS - 1) * g)[:, None]
        ph = ts_stage.astype(np.int64) - cstart
        pmin = np.where(fin, ph, 2**31).min(axis=0).astype(np.int32)
        pmax = np.where(fin, ph, -1).max(axis=0).astype(np.int32)
        dev = self.device
        # compressed residents honor the device-cache-compress switch
        # for both the ts-plane elision and the value packing
        do_compress = compress and self._shard.config.device_cache_compress
        uniform = do_compress \
            and bool(((pmin == pmax) | (fcnt == 0)).all())
        nbytes = 0
        ts_desc = None
        phase = None
        if uniform:
            ts_dev = None
            phase = np.where(fcnt > 0, pmin, 1).astype(np.int32)
            ts_desc = {"base": int((bi * BLOCK_BUCKETS - 1) * g),
                       "g": int(g),
                       "phase": LEDGER.device_put(phase, dev,
                                                  owner=self.owner,
                                                  fmt="compressed")}
            nbytes += phase.nbytes
        else:
            ts_dev = LEDGER.device_put(ts_stage, dev, owner=self.owner,
                                       fmt="dense")
            nbytes += ts_stage.nbytes
        # a histogram cache packs at series granularity (stride hb): a
        # series' bucket columns classify together and stay adjacent
        packed = xorgrid.pack_vals(val_stage, phase=phase, stride=stride) \
            if do_compress else None
        pack_inv = None
        if packed is not None:
            vals_dev = {k: LEDGER.device_put(xorgrid.signed_view(v), dev,
                                             owner=self.owner,
                                             fmt="compressed")
                        for k, v in packed.planes.items()}
            pack_inv = packed.inv
            nbytes += packed.nbytes
        else:
            vals_dev = LEDGER.device_put(val_stage, dev, owner=self.owner,
                                         fmt="dense")
            nbytes += val_stage.nbytes
        return _Block(ts_dev, vals_dev, lanes, self._seq, (fmin, fmax, fcnt),
                      (pmin, pmax), staged_hi=self._next_lane,
                      nbytes=nbytes, width=val_stage.shape[1],
                      ts_desc=ts_desc,
                      pack_inv=pack_inv)

    def _reclaim(self, target_bytes: int,  # holds-lock: _lock
                 keep: set) -> int:
        """Oldest-first reclaim down to ``target_bytes``.  Returns bytes
        freed."""
        freed = 0
        evicted = 0
        while self.bytes_resident > target_bytes and len(self.blocks) > 1:
            victims = [bi for bi in sorted(self.blocks) if bi not in keep]
            if not victims:
                break
            freed += self.blocks[victims[0]].nbytes
            del self.blocks[victims[0]]
            self.evictions += 1
            evicted += 1
        if evicted:
            LEDGER.note_eviction(self.owner, "budget_overflow", n=evicted,
                                 nbytes=freed)
        if freed:
            # memoized plans hold strong block refs: drop them so the
            # reclaim actually frees device memory
            self._plan_memo.clear()
        return freed

    def _evict(self, keep: set) -> None:
        self._reclaim(self.budget, keep)

    def ensure_headroom(self, frac: float) -> int:
        """Proactive reclaim down to ``(1-frac)`` of the budget, run off
        the query path (the shard calls it after flushes)."""
        with self._lock:
            return self._reclaim(int(self.budget * (1.0 - frac)), set())
