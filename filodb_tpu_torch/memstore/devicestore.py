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

Grid layout: row ``c`` holds the single sample with ``ts in
(epoch0+(c-1)*gstep, epoch0+c*gstep]``.  Partitions that break the one-
sample-per-bucket invariant disable the grid for this cache generation,
and queries get None ("not served here"): the fast path is never wrong,
only absent.

Each query runs one of four programs, all plain functions on tensors:
``series``/``grouped`` over decoded planes (:func:`rate_grid` kernel)
and ``series_packed``/``grouped_packed`` over one packed block
(:func:`rate_grid_packed` kernel); the grouped ones reduce lanes to
``[G, T]`` partials on the device before the one readback.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from filodb_tpu_torch.codecs import xorgrid
from filodb_tpu_torch.ops import aggregate as segops
from filodb_tpu_torch.ops.grid import (DENSE_ONLY_OPS, PHASE_OPS, TS_FREE_OPS,
                                       GridQuery, bits_to_f32, max_k_for,
                                       phase_eligible, prefix_xor,
                                       rate_grid, rate_grid_packed,
                                       supports_grid, widen_words)
from filodb_tpu_torch.query.logical import RangeFunctionId as F
from filodb_tpu_torch.utils.devicewatch import LEDGER

BLOCK_BUCKETS = 128
_LANE_PAD = 128
_I32_SPAN = 2**31 - 2

# range functions the grid serves here, mapped to the kernel op
# (ops/grid.py GridQuery.op); None = the bare instant selector's
# staleness lookback (last sample in the window).  Every other range
# function gets None from scan_rate / scan_rate_grouped.
_GRID_OPS = {
    F.RATE: "rate", F.INCREASE: "increase", F.DELTA: "delta",
    F.SUM_OVER_TIME: "sum", F.COUNT_OVER_TIME: "count",
    F.AVG_OVER_TIME: "avg", F.MIN_OVER_TIME: "min",
    F.MAX_OVER_TIME: "max", F.LAST_OVER_TIME: "last",
    None: "last",
}

# cross-series aggregates the grouped programs reduce on the device
GROUPED_OPS = frozenset(("sum", "avg", "count", "min", "max"))

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


def _grouped_reduce_impl(stepped, garr, num_groups: int, op: str):
    """Device-side segment reduce of a grid kernel's ``[T, lanes]``
    output into ``[G, T]`` partials, on the device.  ``garr`` maps
    lane -> group (``num_groups`` = the drop bucket for unrequested and
    padding lanes).  sum/avg/count at modest G are a one-hot matmul;
    beyond ``_ONEHOT_MAX_G`` an index_add."""
    v = stepped.T                                # [lanes, T]
    G = num_groups
    if op in ("sum", "avg", "count"):
        fin = torch.isfinite(v)
        planes = [torch.where(fin, v, torch.zeros_like(v)), fin.to(v.dtype)]
        if G + 1 <= _ONEHOT_MAX_G:
            onehot = (garr[:, None] == torch.arange(
                G, dtype=garr.dtype, device=garr.device)[None, :]
                ).to(v.dtype)                    # [lanes, G]
            outs = [segops.f32_matmul(onehot.T, p) for p in planes]
        else:
            idx = garr.to(torch.int64)
            outs = [torch.zeros((G + 1, v.shape[1]), dtype=v.dtype,
                                device=v.device).index_add_(0, idx, p)[:G]
                    for p in planes]
        return torch.stack(outs)
    if op == "min":
        return segops.seg_min(v, garr, G + 1)[:G]
    if op == "max":
        return segops.seg_max(v, garr, G + 1)[:G]
    raise ValueError(f"unsupported grouped op {op}")


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


def series_program(plan: _GridPlan):
    """Block concat, row slice and the grid kernel: ``[T, ncols]``."""
    ts_sl, val_sl, steps0, q, phase = series_inputs(plan)
    return rate_grid(ts_sl, val_sl, steps0, q, phase=phase)


def grouped_program(plan: _GridPlan, garr, num_groups: int, op: str):
    return _grouped_reduce_impl(series_program(plan), garr, num_groups, op)


def series_packed_program(plan: _GridPlan):
    """The packed kernel on one block: ``[T, packed width]``."""
    return rate_grid_packed(plan.packed, plan.steps0_rel, plan.q,
                            row0=plan.packed_row0,
                            use_phase=plan.packed_use_phase)


def grouped_packed_program(plan: _GridPlan, garr, num_groups: int, op: str):
    return _grouped_reduce_impl(series_packed_program(plan), garr,
                                num_groups, op)


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
                 "ts_desc", "width", "pack_inv")

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

    @property
    def ts_seg(self):
        return self.ts if self.ts is not None else self.ts_desc

    def dense_or_empty(self, a: int, b: int):
        """Per-lane (dense, empty) masks over local rows [a, b]."""
        contiguous = self.fcnt == self.fmax - self.fmin + 1
        dense = contiguous & (self.fmin <= a) & (self.fmax >= b)
        empty = (self.fcnt == 0) | (self.fmax < a) | (self.fmin > b)
        return dense, empty


class DeviceGridCache:
    """Per-(shard, schema, value-column) device grid with eviction."""

    def __init__(self, shard, schema_hash: int, column_id: int,
                 budget_bytes: int, gstep_ms: Optional[int] = None):
        self._shard = shard
        self.device: torch.device = shard.device
        self.schema_hash = schema_hash
        self.column_id = column_id
        self.budget = budget_bytes
        self.owner = (f"grid:{getattr(shard, 'dataset', '?')}/"
                      f"{getattr(shard, 'shard_num', '?')}:c{column_id}")
        self.gstep = gstep_ms          # None until detected
        self.epoch0: Optional[int] = None
        self.lane_of: dict[int, int] = {}
        self._next_lane = 0
        self.blocks: dict[int, _Block] = {}
        self._tails: dict[int, tuple[int, _Block]] = {}  # bi -> (ver, blk)
        self.version = 0               # bumped on invalidating freezes
        self.disabled_until_version = -1
        self._disable_count = 0        # exponential re-try backoff
        self._preps: dict[int, dict] = {}   # id(part_ids) -> prep
        # shapes that failed the dense proof: denied until data changes
        self._bigk_deny: dict[tuple, tuple] = {}
        # (bi_lo, bi_hi, version) -> (host phases, device phases)
        self._phase_memo: dict[tuple, tuple] = {}
        # full-plan memo, keyed on every invalidation axis
        self._plan_memo: dict[tuple, _GridPlan] = {}
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

    # ---------------------------------------------------------------- serving

    def scan_rate(self, part_ids: Sequence[int], func, steps0: int,
                  nsteps: int, step_ms: int, window_ms: int,
                  fargs: tuple = ()):
        """Serve a _GRID_OPS window function on the query step grid from
        device-resident blocks.  Returns ``(vals [S_req, T], None)`` with
        ``vals`` a tensor on the store's device (nothing is read back), or
        None when the fast path cannot serve the query."""
        if func not in _GRID_OPS or fargs:
            return None
        with self._lock:
            plan = self._plan_locked(part_ids, func, steps0, nsteps,
                                     step_ms, window_ms)
        if plan is None:
            return None
        # dispatch + readback outside the lock: the plan holds live
        # references to its tensors
        return self._dispatch_series(plan), None

    def scan_rate_grouped(self, part_ids: Sequence[int], func,
                          steps0: int, nsteps: int, step_ms: int,
                          window_ms: int, group_ids: Sequence[int],
                          num_groups: int, op: str = "sum",
                          fargs: tuple = ()):
        """Fused ``agg by (g)(<grid window fn>(...))``: the kernel's
        ``[T, lanes]`` output is reduced to ``[G, T]`` on the device.
        Returns the mergeable partial state ({"sum","count"} /
        {"count"} / {"min"} / {"max"}) as ``[G, T]`` tensors on the
        store's device, or None."""
        if func not in _GRID_OPS or fargs or op not in GROUPED_OPS:
            return None
        with self._lock:
            plan = self._plan_locked(part_ids, func, steps0, nsteps,
                                     step_ms, window_ms)
            if plan is None:
                return None
            garr = np.full(plan.ncols, num_groups, dtype=np.int32)
            garr[plan.lane_idx] = np.asarray(group_ids, dtype=np.int32)
        if plan.packed is not None:
            # packed lane order: scatter the group map through inv;
            # pack pad lanes keep the drop bucket
            n_pk = int(plan.packed["first"].shape[0])
            garr_pk = np.full(n_pk, num_groups, dtype=np.int32)
            garr_pk[plan.packed_inv] = garr
            out = grouped_packed_program(
                plan, torch.as_tensor(garr_pk, device=self.device),
                num_groups, op)
        else:
            out = grouped_program(
                plan, torch.as_tensor(garr, device=self.device),
                num_groups, op)
        both = out
        if op == "count":
            return {"count": both[1]}
        if op in ("sum", "avg"):
            return {"sum": both[0], "count": both[1]}
        return {op: both}

    def _dispatch_series(self, plan: _GridPlan) -> torch.Tensor:
        if plan.packed is not None:
            stepped = series_packed_program(plan)
            lanes_req = plan.packed_inv[plan.lane_idx]
        else:
            stepped = series_program(plan)
            lanes_req = plan.lane_idx
        # the requested lanes, series-major: a transposed view of the
        # time-major [T, S_req] selection
        idx = torch.as_tensor(lanes_req, dtype=torch.int64,
                              device=stepped.device)
        return stepped.index_select(1, idx).T

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
                     window_ms):
        """Eligibility checks, block assembly and the dense-contract and
        uniform-phase proofs.  Returns a :class:`_GridPlan` (no device
        dispatch happens here) or None."""
        shard = self._shard
        if self.disabled_until_version >= shard.ingest_epoch:
            return None
        if len(part_ids) == 0:
            return None
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
        pkey = (func, steps0, nsteps, step_ms, window_ms, ids_fp,
                self.version, shard.ingest_epoch, shard.removal_epoch)
        cached = self._plan_memo.get(pkey)
        if cached is not None:
            self._seq += 1
            for blk in cached.segs:
                blk.last_used = self._seq
            self.hits += 1
            return cached
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
            blk = self._block_for(bi, lanes, frozen_hi, need_hi)
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
                      stride=stride_r)
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
        plan = _GridPlan(ts_parts, tuple(b.vals for b in segments), row0,
                         steps0 - self.epoch0, q, nrows, ncols,
                         prep["lane_idx"], phase_dev, tuple(segments),
                         packed=packed, packed_row0=row0,
                         packed_use_phase=packed_phase,
                         packed_inv=packed_inv)
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
                   frozen_hi: int, need_hi: int):
        b_lo = bi * BLOCK_BUCKETS
        b_hi = b_lo + BLOCK_BUCKETS - 1
        blk = self.blocks.get(bi)
        if blk is not None and blk.lanes == lanes \
                and blk.staged_hi >= need_hi and b_hi <= frozen_hi:
            return blk
        if b_hi > frozen_hi:
            # tail block: holds mutable write-buffer rows; cached under
            # the shard's ingest epoch, never compressed
            epoch = self._shard.ingest_epoch
            got = self._tails.get(bi)
            if got is not None and got[0] == epoch \
                    and got[1].lanes == lanes \
                    and got[1].staged_hi >= need_hi:
                return got[1]
            blk = self._build(bi, lanes, compress=False)
            if blk is not None:
                self._tails[bi] = (epoch, blk)
                while len(self._tails) > 8:
                    self._tails.pop(next(iter(self._tails)))
            return blk
        blk = self._build(bi, lanes)
        if blk is not None:
            self.blocks[bi] = blk
            self.version += 1
        return blk

    def _val_dtype(self):
        """f32 on the card (the kernels' type); f64 on the CPU, where the
        plain versions keep full double precision."""
        return np.float32 if self.device.type == "cuda" else np.float64

    def _build(self, bi: int, lanes: int, compress: bool = True):
        """Host staging + one upload for block ``bi``."""
        g = self.gstep
        # block bi holds buckets [bi*BB, bi*BB+BB-1]; bucket c covers
        # (epoch0+(c-1)*g, epoch0+c*g]
        b_lo_ms = self.epoch0 + (bi * BLOCK_BUCKETS - 1) * g
        b_hi_ms = b_lo_ms + BLOCK_BUCKETS * g
        ts_stage = np.zeros((BLOCK_BUCKETS, lanes), np.int32)
        val_stage = np.full((BLOCK_BUCKETS, lanes), np.nan,
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
            if not isinstance(vals, np.ndarray):
                self._disable()                 # string column
                return None
            buckets = (ts - self.epoch0 + g - 1) // g - bi * BLOCK_BUCKETS
            if len(np.unique(buckets)) != len(buckets):
                self._disable()                 # >1 sample per bucket
                return None
            ts_stage[buckets, lane] = (ts - self.epoch0).astype(np.int32)
            val_stage[buckets, lane] = vals
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
        packed = xorgrid.pack_vals(val_stage, phase=phase) \
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
                      nbytes=nbytes, width=lanes, ts_desc=ts_desc,
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
