"""The fused north-star path: the port's counterpart of the four kernel
variants of the JAX package's benchmark (``bench.py``: ``dense``,
``compressed_resident``, ``histogram_quantile`` and ``gdelt_topk``).

Each variant has a ``setup_*`` function and a ``query_*`` function.  The
setup makes the variant's data on ``device`` from ``seed`` (an explicit
``torch.Generator``), packs it on the host where the variant serves
packed residents, and runs the variant's gates, each of which raises
:class:`GateError` when the data or a kernel breaks the variant's
contract.  The query is the one call a dashboard would repeat:

- ``dense``: ``sum by (group)(rate(m[5m]))`` over 1,000 groups of 1,000
  series, each group padded with NaN lanes to 1,024, one hour of
  one-minute buckets (55 steps), uniform-phase data ->
  :func:`~filodb_tpu_torch.ops.grid.rate_grid_grouped` in phase mode;
- ``packed`` (compressed_resident): the same query over integer
  counters packed as one 16-bit XOR class ->
  :func:`~filodb_tpu_torch.ops.grid.rate_grid_grouped_packed`;
- ``hist`` (histogram_quantile): ``histogram_quantile(0.99, sum by (g)
  (rate(latency_bucket[5m])))`` over 1,024 groups x 64 series x 16
  buckets -> :func:`~filodb_tpu_torch.ops.grid.
  hist_quantile_grid_packed`;
- ``topk`` (gdelt_topk): ``topk(10, sum by (actor)
  (sum_over_time(value[5m])))`` over 262,144 event lanes in 4,096
  contiguous actor groups, keeping lanes whose second column's last
  value is above its median -> :func:`~filodb_tpu_torch.ops.grid.
  event_topk_grid_packed`.

The benchmark's measurement protocol (its floors, its C++ baseline, its
JSON metric line) is not part of this module: ``chip_smoke.py`` times
the ``query_*`` functions on the card.  Every function takes a
:class:`Widths`; :data:`BENCH` is the benchmark's.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from filodb_tpu_torch.codecs import xorgrid
from filodb_tpu_torch.ops import grid
from filodb_tpu_torch.ops.grid import GridQuery
from filodb_tpu_torch.ops.histogram_ops import hist_quantile

STEP_MS = 60_000
WINDOW_MS = 300_000                 # rate(...[5m])
T0 = 600_000
K = WINDOW_MS // STEP_MS
PHI = 0.99
RTOL = 2e-5                         # the benchmark's equivalence bound


class Widths(NamedTuple):
    groups: int = 1_000             # sum by (group)
    per_group: int = 1_000          # live series per group
    group_lanes: int = 1_024        # lanes per group, NaN-padded
    rows: int = 60                  # one hour of one-minute buckets
    hist_groups: int = 1_024
    hist_per_group: int = 64
    hist_buckets: int = 16
    event_lanes: int = 262_144
    event_groups: int = 4_096
    event_k: int = 10


BENCH = Widths()


class GateError(AssertionError):
    """A north-star gate failed: the data or a kernel broke the variant's
    contract."""


def nsteps(w: Widths) -> int:
    """Steps of the one-hour range: windows ending T0 + 5 min ... with
    every window inside the ``rows`` buckets."""
    return w.rows - K


def rows_used(w: Widths) -> int:
    """Rows the windows cover (row 0 of the benchmark's grid is clipped
    to meet the kernels' row contract)."""
    return nsteps(w) + K - 1


def steps0() -> int:
    return T0 + WINDOW_MS


def query(w: Widths, op: str = "rate") -> GridQuery:
    return GridQuery(nsteps=nsteps(w), kbuckets=K, gstep_ms=STEP_MS,
                     is_rate=op == "rate", op=op, dense=True)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _randint(gen, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device,
                         dtype=torch.int32)


# ------------------------------------------------------------- generators

def c16(gen: torch.Generator, rows: int, cols: int) -> torch.Tensor:
    """Integer counters whose XOR residuals fit ONE 16-bit class: start =
    2^23 + 128*r0 (r0 < 2^15) pins the f32 exponent, increments 128*d
    (d in [1, 8)) leave >= 7 trailing zero bits and keep an hour's growth
    under 2^17, so the residual bits span [7, 22].  Every value is an
    exact f32 integer, whatever order the cumulative sum takes."""
    start = 2.0 ** 23 + 128.0 * _randint(gen, 0, 2 ** 15, (1, cols)).float()
    incr = 128.0 * _randint(gen, 1, 8, (rows, cols)).float()
    return start + torch.cumsum(incr, dim=0)


def _lane_grid(gen, w: Widths, phase):
    """(ts [R, S] int32, live-lane mask [S]) of the dense layouts: row r
    holds the sample at T0 + r*STEP + phase, in bucket (T0 + r*STEP,
    T0 + (r+1)*STEP]."""
    rows = torch.arange(rows_used(w), dtype=torch.int32,
                        device=gen.device)[:, None]
    ts = rows * STEP_MS + T0 + phase[None, :]
    lane = torch.arange(w.groups * w.group_lanes, device=gen.device)
    return ts, (lane % w.group_lanes) < w.per_group


def gen_dense(gen: torch.Generator, w: Widths):
    """(ts, vals, phase) of the dense variant: each series scraped at a
    constant phase within its bucket, increments uniform in [0, 10),
    padding lanes all-NaN.  vals [R, S] f32, phase [S] int32."""
    phase = _randint(gen, 1, STEP_MS - 1, (w.groups * w.group_lanes,))
    ts, live = _lane_grid(gen, w, phase)
    incr = torch.rand(ts.shape, generator=gen, device=gen.device) * 10.0
    vals = torch.cumsum(incr, dim=0)
    return ts, torch.where(live[None, :], vals, float("nan")), phase


def gen_packed(gen: torch.Generator, w: Widths):
    """(ts, vals, phase) of the compressed-resident variant: the dense
    layout over :func:`c16` counters."""
    phase = _randint(gen, 1, STEP_MS - 1, (w.groups * w.group_lanes,))
    ts, live = _lane_grid(gen, w, phase)
    vals = c16(gen, rows_used(w), w.groups * w.group_lanes)
    return ts, torch.where(live[None, :], vals, float("nan")), phase


def hist_phase_series(gen: torch.Generator, cols: int, hb: int, rows: int):
    """(vals [rows, cols], phase [cols]) of histogram bucket planes: one
    :func:`c16` counter per bucket column, one scrape phase per series
    (shared by its hb columns)."""
    phase = _randint(gen, 1, STEP_MS - 1, (cols // hb,))
    return c16(gen, rows, cols), phase.repeat_interleave(hb)


def gen_events(gen: torch.Generator, w: Widths):
    """(value column, filter column), each [R, event_lanes] of
    :func:`c16` counters."""
    rows = rows_used(w)
    return c16(gen, rows, w.event_lanes), c16(gen, rows, w.event_lanes)


# ------------------------------------------------------------- gates

def _max_rel(got, want, mask) -> float:
    """Largest |got - want| / max(|want|, 1e-6) over ``mask``; a NaN there
    counts as infinite."""
    rel = (got - want).abs() / want.abs().clamp_min(1e-6)
    rel = torch.where(mask, rel, torch.zeros_like(rel))
    return float(torch.nan_to_num(rel, nan=float("inf")).max())


def check_dense_contract(vals: torch.Tensor, rows: int) -> None:
    """Over the rows the query uses every lane is finite in ALL rows or in
    NONE (the dense-lane contract the phase mode relies on)."""
    fin = torch.isfinite(vals[:rows]).sum(dim=0)
    if not bool(((fin == 0) | (fin == rows)).all()):
        raise GateError("generated data violates the dense-lane contract")


def check_phase_vs_ts(ts, vals, phase, q: GridQuery,
                      group_lanes: int) -> float:
    """rate_grid_grouped in phase mode against ts mode on the same data:
    sums within RTOL where counted, counts equal."""
    s_ph, c_ph = grid.rate_grid_grouped(None, vals, steps0(), q,
                                        group_lanes, phase=phase)
    s_ts, c_ts = grid.rate_grid_grouped(ts, vals, steps0(), q, group_lanes)
    rel = _max_rel(s_ph, s_ts, c_ts > 0)
    if not (rel < RTOL and torch.equal(c_ph, c_ts)):
        raise GateError(f"phase kernel diverged from ts kernel (rel="
                        f"{rel:.2e}, counts equal: "
                        f"{torch.equal(c_ph, c_ts)})")
    return rel


def check_identity_pack(pack, width: int) -> None:
    """The pack is ONE p16 class plane in identity lane order: group lanes
    stay contiguous, the grouped kernels' contract."""
    if pack is None:
        raise GateError("workload did not pack (16-bit class guarantee "
                        "violated?)")
    others = [k for k in ("p8", "p32", "raw")
              if k in pack.planes and pack.planes[k].shape[1]]
    if not (pack.planes.get("p16") is not None
            and pack.planes["p16"].shape[1] == width and not others
            and np.array_equal(pack.inv, np.arange(width))):
        raise GateError(f"pack is not a single identity-order p16 plane of "
                        f"{width} lanes (other classes: {others})")


def check_unpack(pack, vals_np: np.ndarray) -> None:
    """The host decode of the pack gives the input's bits back."""
    got = xorgrid.unpack_vals(pack)
    if not np.array_equal(got.view(np.uint32), vals_np.view(np.uint32)):
        raise GateError("xorgrid CPU decode is not bit-identical to the "
                        "packed input")


def check_packed_vs_ts(planes: dict, ts, vals, q: GridQuery,
                       group_lanes: int) -> float:
    """rate_grid_grouped_packed against rate_grid_grouped in ts mode on
    the decoded data: sums within RTOL where counted, counts equal."""
    s_pk, c_pk = grid.rate_grid_grouped_packed(planes, steps0(), q,
                                               group_lanes)
    s_ts, c_ts = grid.rate_grid_grouped(ts, vals, steps0(), q, group_lanes)
    rel = _max_rel(s_pk, s_ts, c_ts > 0)
    if not (rel < RTOL and torch.equal(c_pk, c_ts)):
        raise GateError(f"compressed-resident kernel diverged from ts "
                        f"kernel (rel={rel:.2e}, counts equal: "
                        f"{torch.equal(c_pk, c_ts)})")
    return rel


def _check_ranked(name: str, got, want) -> float:
    """Same NaN pattern, finite cells within RTOL."""
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    mism = int((fg != fw).sum())
    rel = _max_rel(got, want, fg & fw)
    if not (rel < RTOL and mism == 0):
        raise GateError(f"{name} diverged from the decoded-plane path "
                        f"(rel={rel:.2e}, nan_mismatch={mism})")
    return rel


# ------------------------------------------------------------- dense

class DenseCase(NamedTuple):
    ts: torch.Tensor
    vals: torch.Tensor
    phase: torch.Tensor
    q: GridQuery
    group_lanes: int
    samples: int                    # samples one query scans


def setup_dense(seed: int = 0, device="cuda", w: Widths = BENCH):
    ts, vals, phase = gen_dense(generator(seed, device), w)
    q = query(w)
    check_dense_contract(vals, rows_used(w))
    check_phase_vs_ts(ts, vals, phase, q, w.group_lanes)
    return DenseCase(ts, vals, phase, q, w.group_lanes,
                     w.groups * w.per_group * rows_used(w))


def query_dense(case: DenseCase):
    """-> (sum, count) [G, T]: one rate_grid_grouped launch."""
    return grid.rate_grid_grouped(None, case.vals, steps0(), case.q,
                                  case.group_lanes, phase=case.phase)


# ------------------------------------------------------------- packed

class PackedCase(NamedTuple):
    pack: xorgrid.PackedVals        # host planes
    planes: dict                    # the same on the device
    ts: torch.Tensor
    vals: torch.Tensor
    q: GridQuery
    group_lanes: int
    samples: int
    pack_seconds: float


def _pack(vals: torch.Tensor, **kw):
    """(host values, pack, seconds of pack_vals) of a device plane."""
    vals_np = vals.cpu().numpy()
    t0 = time.perf_counter()
    pk = xorgrid.pack_vals(vals_np, min_width=16, **kw)
    return vals_np, pk, time.perf_counter() - t0


def setup_packed(seed: int = 0, device="cuda", w: Widths = BENCH):
    ts, vals, phase = gen_packed(generator(seed + 7, device), w)
    q = query(w)
    vals_np, pk, secs = _pack(vals, phase=phase.cpu().numpy())
    check_identity_pack(pk, vals.shape[1])
    check_unpack(pk, vals_np)
    planes = xorgrid.packed_to_torch(pk, device)
    check_packed_vs_ts(planes, ts, vals, q, w.group_lanes)
    return PackedCase(pk, planes, ts, vals, q, w.group_lanes,
                      w.groups * w.per_group * rows_used(w), secs)


def query_packed(case: PackedCase):
    """-> (sum, count) [G, T]: one rate_grid_grouped_packed launch per
    class plane, one here."""
    return grid.rate_grid_grouped_packed(case.planes, steps0(), case.q,
                                         case.group_lanes)


# ------------------------------------------------------------- hist

class HistCase(NamedTuple):
    pack: xorgrid.PackedVals
    planes: dict
    vals: torch.Tensor
    phase: torch.Tensor
    tops: torch.Tensor              # [hb] cumulative bucket upper bounds
    q: GridQuery
    hb: int
    group_lanes: int
    groups: int
    samples: int
    pack_seconds: float


def check_hist(case: HistCase) -> float:
    """The fused hist quantile against rate_grid over the decoded planes,
    a per-bucket series sum and the same hist_quantile: NaN pattern
    equal, finite cells within RTOL.

    The benchmark's bucket columns are independent counters, not
    cumulative ones, so the le-interpolation divides differences of
    nearly equal bucket sums and turns a last-bit difference of a sum
    into a large one of the quantile.  The reference therefore adds the
    series of each bucket left to right, in lane order, as the kernel
    does (the per-lane rates of the two kernels are the same bits)."""
    fused = query_hist(case)
    stepped = grid.rate_grid(None, case.vals, steps0(), case.q,
                             phase=case.phase)                 # [T, cols]
    per = case.group_lanes // case.hb
    st = stepped.reshape(stepped.shape[0], case.groups, per, case.hb)
    st = torch.where(torch.isnan(st), 0.0, st)
    hist_sum = torch.zeros_like(st[:, :, 0])
    for s in range(per):
        hist_sum = hist_sum + st[:, :, s]
    ref = hist_quantile(case.tops, hist_sum.permute(1, 0, 2), PHI)
    return _check_ranked("fused hist quantile", fused, ref)


def setup_hist(seed: int = 0, device="cuda", w: Widths = BENCH):
    hb = w.hist_buckets
    group_lanes = w.hist_per_group * hb
    cols = w.hist_groups * group_lanes
    vals, phase = hist_phase_series(generator(seed + 11, device), cols, hb,
                                    rows_used(w))
    vals_np, pk, secs = _pack(vals, phase=phase.cpu().numpy(), stride=hb)
    check_identity_pack(pk, cols)
    check_unpack(pk, vals_np)
    tops = torch.tensor(np.concatenate([2.0 ** np.arange(hb - 1), [np.inf]]),
                        dtype=torch.float32, device=device)
    case = HistCase(pk, xorgrid.packed_to_torch(pk, device), vals, phase,
                    tops, query(w), hb, group_lanes, w.hist_groups,
                    cols * rows_used(w), secs)
    check_hist(case)
    return case


def query_hist(case: HistCase):
    """-> [G, T] quantiles: one hist_grid_grouped_packed launch per class
    plane (one here), then the le-interpolation."""
    return grid.hist_quantile_grid_packed(case.planes, steps0(), case.tops,
                                          case.q, PHI, case.hb,
                                          case.group_lanes)


# ------------------------------------------------------------- topk

class TopkCase(NamedTuple):
    packs: tuple                    # host (value, filter) packs
    dv: dict                        # value column planes on the device
    df: dict                        # filter column planes
    vals: torch.Tensor
    fvals: torch.Tensor
    thresh: float
    qs: GridQuery                   # sum_over_time of the value column
    ql: GridQuery                   # last value of the filter column
    k: int
    groups: int
    group_width: int
    samples: int                    # both scanned columns count
    pack_seconds: float


def check_topk(case: TopkCase) -> float:
    """event_topk against rate_grid over the decoded columns, the filter,
    a reshape-sum and a ranking: NaN pattern equal, finite cells within
    RTOL."""
    got, _idx = query_topk(case)
    sv = grid.rate_grid(None, case.vals, steps0(), case.qs)
    sf = grid.rate_grid(None, case.fvals, steps0(), case.ql)
    thresh = torch.tensor(case.thresh, dtype=sf.dtype, device=sf.device)
    masked = torch.where(sf > thresh, sv, float("nan"))
    fin = torch.isfinite(masked)
    shape = (masked.shape[0], case.groups, case.group_width)
    gs = torch.where(fin, masked, 0.0).reshape(shape).sum(2)
    gc = fin.reshape(shape).sum(2)
    ranked = torch.where(gc > 0, gs, float("-inf"))
    want = torch.sort(ranked, dim=1, descending=True,
                      stable=True).values[:, :case.k]
    want = torch.where(torch.isfinite(want), want, float("nan"))
    return _check_ranked("fused event topk", got, want)


def setup_topk(seed: int = 0, device="cuda", w: Widths = BENCH):
    vals, fvals = gen_events(generator(seed + 23, device), w)
    _v, pk_v, s_v = _pack(vals)
    fvals_np, pk_f, s_f = _pack(fvals)
    for pk in (pk_v, pk_f):
        check_identity_pack(pk, w.event_lanes)
    case = TopkCase((pk_v, pk_f), xorgrid.packed_to_torch(pk_v, device),
                    xorgrid.packed_to_torch(pk_f, device), vals, fvals,
                    float(np.median(fvals_np[-1])), query(w, "sum"),
                    query(w, "last"), w.event_k, w.event_groups,
                    w.event_lanes // w.event_groups,
                    2 * w.event_lanes * rows_used(w), s_v + s_f)
    check_topk(case)
    return case


def query_topk(case: TopkCase):
    """-> (values, group slots) [T, k]: two rate_grid_packed launches (the
    value and filter columns, one class plane each), the filter, the
    reshape-sum group reduce and the ranking."""
    return grid.event_topk_grid_packed(
        case.dv, steps0(), case.qs, case.k, None, case.groups,
        filt_packed=case.df, filt_op="gt", filt_thresh=case.thresh,
        filt_q=case.ql, group_width=case.group_width)
