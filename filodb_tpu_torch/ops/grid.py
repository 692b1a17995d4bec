"""Aligned-grid window kernels: the memory-bound serving fast path.

The device chunk store lays frozen chunks out as a **time-major bucket
grid** ``vals [B, S]``: column *s* is a series (a lane), row *c* a time
bucket of width ``gstep``, and the sample in row ``c`` has ``ts in
(t0 + (c-1)*gstep, t0 + c*gstep]``; missing buckets hold NaN.  When the
query window is ``K * gstep`` and the query steps land on bucket edges,
window ``t`` covers exactly rows ``[t*stride, t*stride + K - 1]`` — no
search, no gather (reference: query/exec/rangefn/RangeFunction.scala
addChunks + the Prometheus extrapolated rate, RateFunctions.scala:37-80).

Two functions carry the path, each with a hand-written CUDA kernel
(``csrc/grid_kernels.cu``) and a plain PyTorch version beside it:

- :func:`rate_grid` — decoded planes (``vals`` plus, per mode, a ts
  plane or a per-lane phase row) -> ``[T, S]``;
  :func:`rate_grid_ref` is its plain version.
- :func:`rate_grid_packed` — XOR-class packed planes
  (``codecs/xorgrid.py``) decoded inside the kernel -> ``[T, width]`` in
  packed lane order; :func:`rate_grid_packed_ref` is its plain version.

A third, :func:`m4_grid` (plain version :func:`m4_grid_ref`), selects the
M4 points of ``?downsample=`` over a time-major ``[T, S]`` result.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each wrapper counts its kernel launches
in ``<wrapper>.launches``.

Layout contract (enforced by the caller / device store):

- ``ts`` int32 milliseconds relative to an epoch the caller also
  subtracts from ``steps0`` (absolute ms overflow int32);
- row 0 of the given planes is the first bucket of the first window;
- counter correction runs from row 0, i.e. from the start of the scanned
  range.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from filodb_tpu_torch.ops import kernels

_IBIG = 2**30


class GridQuery(NamedTuple):
    """Static configuration of one grid query.

    ``op`` selects the fused window function:
      "rate" / "increase" / "delta" — Prometheus extrapolation (rate and
                                       increase with counter correction)
      "sum" / "count" / "avg" / "min" / "max" — the *_over_time family
      "last"  — last_over_time and the instant selector's lookback

    ``dense`` asserts the dense-lane contract: over the used rows every
    lane is finite in ALL rows or in NONE.  The caller must prove it;
    setting it on data that breaks it gives wrong results, not an error.
    ``stride``: query step = stride * gstep, window t covers rows
    ``[t*stride, t*stride + K - 1]``.
    """

    nsteps: int       # T output steps
    kbuckets: int     # K = window // gstep buckets per window
    gstep_ms: int     # bucket width
    is_rate: bool = True
    op: str = "rate"
    dense: bool = False
    farg: float = 0.0
    farg2: float = 0.0
    stride: int = 1


# ops whose kernels never read the ts plane
TS_FREE_OPS = frozenset(("quantile", "mad", "holt_winters", "zscore",
                         "last", "sum", "count", "avg", "min", "max",
                         "changes", "resets", "stddev", "stdvar"))
# ops with a dense + uniform-phase mode: one phase row replaces ts
PHASE_OPS = frozenset(("rate", "increase", "delta"))
# ops whose dense computation is independent of K
K_FREE_DENSE_OPS = frozenset(("rate", "increase", "last", "count",
                              "irate", "idelta", "delta", "timestamp"))
# ops served only under the proven dense contract
DENSE_ONLY_OPS = frozenset(("changes", "resets", "irate", "idelta",
                            "quantile", "mad", "holt_winters"))

# the ops this package's kernels compute
SERVED_OPS = frozenset(("rate", "increase", "delta", "sum", "count",
                        "avg", "min", "max", "last"))

MAX_K_BUCKETS = 64       # K cap of the ops that walk every window row
MAX_DENSE_K = 1024       # K cap of the K-free ops under the dense contract
MAX_GRID_SPAN_ROWS = 16_384   # rows staged/assembled per query
SORT_OPS_MAX_K = 32


def _rows_needed(q: GridQuery) -> int:
    return (q.nsteps - 1) * q.stride + q.kbuckets


def max_k_for(op: str, dense: bool) -> int:
    if op in ("quantile", "mad"):
        return SORT_OPS_MAX_K
    return MAX_DENSE_K if dense and op in K_FREE_DENSE_OPS \
        else MAX_K_BUCKETS


def supports_grid(window_ms: int, step_ms: int, gstep_ms: int,
                  nsteps: int = 1, max_k: int = MAX_K_BUCKETS) -> bool:
    """Host-side check: can the aligned fast path serve this query?  The
    query step may be any multiple of the bucket width; ``max_k`` caps
    K = window/gstep (pass ``max_k_for(op, dense)``); total input rows
    are capped by the block-assembly bound."""
    if not (window_ms > 0 and gstep_ms > 0 and step_ms > 0
            and step_ms % gstep_ms == 0 and window_ms % gstep_ms == 0
            and window_ms // gstep_ms <= max_k):
        return False
    stride = step_ms // gstep_ms
    rows = (nsteps - 1) * stride + window_ms // gstep_ms
    return rows <= MAX_GRID_SPAN_ROWS


def phase_eligible(q: GridQuery) -> bool:
    """Can this query use the uniform-phase mode (given a proven phase
    vector)?  K >= 2: the collapsed extrapolation divides by K-1."""
    return q.dense and q.op in PHASE_OPS and q.kbuckets >= 2


def _phase_mode(q: GridQuery, phase) -> bool:
    return phase is not None and phase_eligible(q)


def _mode_for(q: GridQuery, phase) -> str:
    """Input-plane mode: 'free' ops read only values; 'phase' reads
    values + one phase row; 'ts' reads both planes."""
    if q.op in TS_FREE_OPS:
        return "free"
    if _phase_mode(q, phase):
        return "phase"
    return "ts"


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU serving path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _win(x: torch.Tensor, d: int, q: GridQuery) -> torch.Tensor:
    """Row d of every window: input rows d, d+stride, ... -> [T, L]."""
    return x[d:d + (q.nsteps - 1) * q.stride + 1:q.stride]


def _correct(vals: torch.Tensor, dense: bool) -> torch.Tensor:
    """Counter correction: add the running sum of counter drops.  A drop
    is measured against the previous FINITE sample (a missed scrape
    leaves a NaN bucket); before the first finite sample the previous
    value is row 0's, and row 0 has no drop.  Under the dense contract
    the previous sample is the previous row.  NaN compares false, so a
    NaN on either side drops nothing."""
    nb = vals.shape[0]
    if dense:
        prev = vals.roll(1, 0)
    else:
        fin = torch.isfinite(vals)
        row = torch.arange(nb, device=vals.device)[:, None]
        last = torch.where(fin, row, -1).cummax(0).values
        ffill = torch.where(last >= 0, vals.gather(0, last.clamp(min=0)),
                            vals[0:1].expand_as(vals))
        prev = ffill.roll(1, 0)
    prev[0] = vals[0]
    drop = torch.where(vals < prev, prev, torch.zeros_like(vals))
    return vals + drop.cumsum(0)


def _window_stats_dense(ts, vals, vcorr, q: GridQuery):
    """Dense lanes: first/last of window t are rows t*stride and
    t*stride+K-1, and the finite count is K (0 for empty lanes)."""
    K = q.kbuckets
    live = torch.isfinite(_win(vals, 0, q))
    nf = live.to(vcorr.dtype) * K
    return (nf, _win(ts, 0, q), _win(ts, K - 1, q), _win(vcorr, 0, q),
            _win(vcorr, K - 1, q))


def _window_stats(ts, fin, vcorr, q: GridQuery):
    """First/last finite sample (ts and value) and finite count of every
    window, by K select passes."""
    shape = (q.nsteps, vcorr.shape[1])
    dt = vcorr.dtype
    nf = torch.zeros(shape, dtype=dt, device=vcorr.device)
    t2 = torch.full(shape, _IBIG, dtype=ts.dtype, device=ts.device)
    v2 = torch.full(shape, float("nan"), dtype=dt, device=vcorr.device)
    for d in range(q.kbuckets):            # forward: last finite wins
        fd = _win(fin, d, q)
        nf = nf + fd.to(dt)
        t2 = torch.where(fd, _win(ts, d, q), t2)
        v2 = torch.where(fd, _win(vcorr, d, q), v2)
    t1 = torch.full(shape, _IBIG, dtype=ts.dtype, device=ts.device)
    v1 = torch.full(shape, float("nan"), dtype=dt, device=vcorr.device)
    for d in range(q.kbuckets - 1, -1, -1):  # reverse: first finite wins
        fd = _win(fin, d, q)
        t1 = torch.where(fd, _win(ts, d, q), t1)
        v1 = torch.where(fd, _win(vcorr, d, q), v1)
    return nf, t1, t2, v1, v2


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _extrapolate(nf, t1, t2, v1, v2, steps0: int, q: GridQuery):
    """Prometheus extrapolatedRate on [T, L] tiles (reference:
    RateFunctions.scala:37-80)."""
    dt = v1.dtype
    window = q.kbuckets * q.gstep_ms
    # divisors are tensors: torch divides by a Python scalar on CUDA as a
    # multiply by its reciprocal, one rounding away from the kernel's
    # IEEE division
    ms_per_s = _scalar(1000.0, v1)
    tcol = torch.arange(q.nsteps, dtype=torch.int32, device=v1.device)
    hi = (tcol * (q.gstep_ms * q.stride) + steps0).to(dt)[:, None]
    lo = hi - _scalar(window, v1)
    t1f = t1.to(dt)
    t2f = t2.to(dt)
    dur_start = (t1f - lo) / ms_per_s
    dur_end = (hi - t2f) / ms_per_s
    sampled = (t2f - t1f) / ms_per_s
    avg_dur = sampled / torch.clamp(nf - 1.0, min=1.0)
    delta = v2 - v1
    one = torch.ones_like(delta)
    if q.op != "delta":    # counter zero-point clamp (rate/increase only)
        dur_zero = sampled * v1 / torch.where(delta == 0, one, delta)
        clamp = (delta > 0) & (v1 >= 0) & (dur_zero < dur_start)
        dur_start = torch.where(clamp, dur_zero, dur_start)
    thresh = avg_dur * 1.1
    half = avg_dur / _scalar(2.0, v1)
    extrap = (sampled + torch.where(dur_start < thresh, dur_start, half)
              + torch.where(dur_end < thresh, dur_end, half))
    scaled = delta * extrap / torch.where(sampled == 0, one, sampled)
    if q.op == "rate" and q.is_rate:
        scaled = scaled / (_scalar(window, v1) / ms_per_s)
    return torch.where((nf >= 2) & (sampled > 0), scaled,
                       torch.full_like(scaled, float("nan")))


def _phase_block(phase_row, vals, q: GridQuery):
    """rate/increase/delta under dense + uniform phase: every live lane
    is scraped at a constant offset ``phase in (0, gstep]`` within its
    bucket, so the extrapolation geometry is a per-lane constant and the
    Prometheus formula collapses to a divide-free form.  Liveness is
    row 0's."""
    dt = vals.dtype
    K, g = q.kbuckets, q.gstep_ms
    live_row = torch.isfinite(vals[0:1])
    src = vals if q.op == "delta" else _correct(vals, dense=True)
    v1 = _win(src, 0, q)
    delta = _win(src, K - 1, q) - v1
    if q.op == "delta":
        out = delta * _scalar(K / (K - 1), vals)
    else:
        sampled = _scalar((K - 1) * g * 1e-3, vals)
        phase_s = phase_row.to(dt) * _scalar(1e-3, vals)
        g_s = _scalar(g * 1e-3, vals)
        is_rate = q.op == "rate" and q.is_rate
        scale = (_scalar(1e3 / (K * g), vals) if is_rate
                 else _scalar(1.0, vals)) / sampled
        end_sc = (sampled + g_s - phase_s) * scale
        sv1 = sampled * v1
        pd = phase_s * delta
        clamp = (sv1 < pd) & (v1 >= 0)
        start_num = torch.where(clamp, sv1, pd)
        out = delta * end_sc + start_num * scale
    return torch.where(live_row, out, torch.full_like(out, float("nan")))


def _agg_block(vals, q: GridQuery):
    """The *_over_time family on the aligned grid (reference:
    AggrOverTimeFunctions.scala sum/count/avg/min/max/last)."""
    K = q.kbuckets
    dt = vals.dtype
    nan = float("nan")
    if q.dense:
        if q.op == "last":
            return _win(vals, K - 1, q)
        live = torch.isfinite(_win(vals, 0, q))
        if q.op == "count":
            return torch.where(live, _scalar(K, vals), _scalar(nan, vals))
        acc = _win(vals, 0, q)
        for d in range(1, K):
            x = _win(vals, d, q)
            if q.op in ("sum", "avg"):
                acc = acc + x
            elif q.op == "min":
                acc = torch.minimum(acc, x)
            else:
                acc = torch.maximum(acc, x)
        if q.op == "avg":
            acc = acc / _scalar(K, vals)
        return torch.where(live, acc, _scalar(nan, vals))
    fin = torch.isfinite(vals)
    shape = (q.nsteps, vals.shape[1])
    if q.op == "last":
        v2 = torch.full(shape, nan, dtype=dt, device=vals.device)
        for d in range(K):                  # forward: last finite wins
            v2 = torch.where(_win(fin, d, q), _win(vals, d, q), v2)
        return v2
    c = torch.zeros(shape, dtype=dt, device=vals.device)
    if q.op in ("sum", "avg", "count"):
        acc = torch.zeros(shape, dtype=dt, device=vals.device)
        ident = 0.0
    else:
        ident = float("inf") if q.op == "min" else float("-inf")
        acc = torch.full(shape, ident, dtype=dt, device=vals.device)
    for d in range(K):
        fd = _win(fin, d, q)
        vd = torch.where(fd, _win(vals, d, q), _scalar(ident, vals))
        c = c + fd.to(dt)
        if q.op in ("sum", "avg"):
            acc = acc + vd
        elif q.op == "min":
            acc = torch.minimum(acc, vd)
        elif q.op == "max":
            acc = torch.maximum(acc, vd)
    if q.op == "count":
        return torch.where(c > 0, c, _scalar(nan, vals))
    if q.op == "avg":
        return torch.where(c > 0, acc / torch.clamp(c, min=1.0),
                           _scalar(nan, vals))
    if q.op in ("min", "max"):
        return torch.where(torch.isfinite(acc), acc, _scalar(nan, vals))
    return torch.where(c > 0, acc, _scalar(nan, vals))


def _check_op(q: GridQuery) -> None:
    if q.op not in SERVED_OPS:
        raise ValueError(f"grid op {q.op!r} is not served by this package "
                         f"(have {sorted(SERVED_OPS)})")


def rate_grid_ref(ts, vals, steps0: int, q: GridQuery, phase=None):
    """Plain version of :func:`rate_grid`: ``vals [B, S]`` (and ``ts
    [B, S]`` int in ts mode, or ``phase [S]`` int in phase mode) ->
    ``[T, S]`` in the dtype of ``vals``."""
    _check_op(q)
    if _phase_mode(q, phase):
        ph = torch.as_tensor(phase).reshape(1, -1)
        return _phase_block(ph, vals, q)
    if q.op in TS_FREE_OPS:
        return _agg_block(vals, q)
    if q.op == "delta":
        vcorr = vals
    else:
        vcorr = _correct(vals, dense=q.dense)
    if q.dense:
        stats = _window_stats_dense(ts, vals, vcorr, q)
    else:
        stats = _window_stats(ts, torch.isfinite(vals), vcorr, q)
    return _extrapolate(*stats, int(steps0), q)


# ---------------------------------------------------------------------------
# Packed planes: plain decode + plain windowed function
# ---------------------------------------------------------------------------

# class planes in packed order: (plane key, meta key, kernel plane kind)
_PLANES = (("p8", "m8", 0), ("p16", "m16", 1), ("p32", "m32", 2),
           ("raw", "mraw", 3))
_MASK32 = 0xFFFFFFFF


def _packed_planes(packed: dict) -> list:
    """(plane, meta, kind) triples in packed (class) order, empty planes
    skipped."""
    out = []
    for key, mkey, kind in _PLANES:
        p = packed.get(key)
        if p is None or p.shape[1] == 0:
            continue
        m = packed.get(mkey)
        if m is None:
            raise ValueError(f"packed plane {key} has no meta tile {mkey} "
                             f"(f64 packs carry no meta; the packed "
                             f"kernel is f32-only)")
        out.append((p, m, kind))
    return out


def packed_width(packed: dict) -> int:
    """Total packed lane count (class-plane widths, pads included)."""
    return sum(p.shape[1] for p, _m, _k in _packed_planes(packed))


def widen_words(p: torch.Tensor) -> torch.Tensor:
    """A plane's words as int64 holding the unsigned word value.  16- and
    32-bit class planes are held as signed views of the same bits, raw
    and first-value planes as float32/float64 (64-bit words keep their
    bits as they are)."""
    if p.dtype == torch.float64:
        return p.view(torch.int64)
    if p.dtype == torch.float32:
        p = p.view(torch.int32)
    return p.to(torch.int64) & ((1 << (8 * p.element_size())) - 1)


def bits_to_f32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit word -> the float32 with those bits."""
    s = u - ((u >> 31) & 1) * (1 << 32)
    return s.to(torch.int32).view(torch.float32)


def prefix_xor(u: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-XOR down axis 0 (log-step shifted XOR: torch has
    no cumulative XOR)."""
    sh = 1
    while sh < u.shape[0]:
        u = torch.cat([u[:sh], u[sh:] ^ u[:-sh]])
        sh *= 2
    return u


def decode_packed_plane(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain decode of one f32 class plane ``[B, n]`` with its ``[8, n]``
    meta tile: widen -> per-lane shift -> prefix-XOR down rows -> XOR
    the first-value bits -> bitcast f32.  Bit-exact."""
    u = (widen_words(p) << m[0].to(torch.int64)[None, :]) & _MASK32
    u = prefix_xor(u)
    first = m[1].to(torch.int64) & _MASK32
    return bits_to_f32(u ^ first[None, :])


def _packed_check(packed: dict, q: GridQuery, row0: int,
                  use_phase: bool) -> None:
    _check_op(q)
    if use_phase:
        if not phase_eligible(q):
            raise ValueError(f"op {q.op} not phase-eligible (dense="
                             f"{q.dense}, K={q.kbuckets})")
    elif q.op not in TS_FREE_OPS:
        raise ValueError(f"packed kernel serves TS_FREE or phase-mode "
                         f"ops only; {q.op} needs a ts plane")
    for p, _m, _k in _packed_planes(packed):
        if row0 < 0 or p.shape[0] < row0 + _rows_needed(q):
            raise ValueError(
                f"packed block has {p.shape[0]} rows; query needs rows "
                f"[{row0}, {row0 + _rows_needed(q)})")


def rate_grid_packed_ref(packed: dict, steps0: int, q: GridQuery,
                         row0: int = 0, use_phase: bool = False):
    """Plain version of :func:`rate_grid_packed`: decode every class
    plane, take rows ``[row0, row0 + rows_needed)``, run the phase or
    free op chain -> ``[T, packed_width]`` f32 in packed lane order."""
    _packed_check(packed, q, row0, use_phase)
    need = _rows_needed(q)
    outs = []
    for p, m, _kind in _packed_planes(packed):
        vals = decode_packed_plane(p, m)[row0:row0 + need]
        if use_phase:
            outs.append(_phase_block(m[2:3], vals, q))
        else:
            outs.append(_agg_block(vals, q))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_OP_CODE = {"sum": 0, "count": 1, "avg": 2, "min": 3, "max": 4, "last": 5,
            "rate": 6, "increase": 7, "delta": 8}
_MODE_CODE = {"free": 0, "phase": 1, "ts": 2}


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _int32_args(*vals: int) -> list:
    for v in vals:
        if not -2**31 <= int(v) < 2**31:
            raise ValueError(f"kernel argument {v} overflows int32")
    return [ctypes.c_int(int(v)) for v in vals]


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({kernels.error_string(rc)})")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def rate_grid(ts, vals, steps0: int, q: GridQuery, phase=None):
    """Per-series windowed function over an aligned grid:
    ``vals [B, S]`` -> ``[T, S]``.

    ``phase`` ([S] int32 within-bucket scrape offsets in (0, gstep])
    selects the uniform-phase mode for phase-eligible queries; then and
    for TS_FREE ops ``ts`` may be None.  CPU tensors run
    :func:`rate_grid_ref`; CUDA tensors launch the CUDA kernel
    (f32 values, int32 ts/phase) or raise."""
    if vals.device.type == "cpu":
        return rate_grid_ref(ts, vals, steps0, q, phase=phase)
    _check_op(q)
    if vals.device.type != "cuda":
        raise ValueError(f"rate_grid runs on cpu or cuda, not {vals.device}")
    nb, ns = vals.shape
    if nb < _rows_needed(q):
        raise ValueError(f"grid has {nb} rows; need (nsteps-1)*stride+K = "
                         f"{_rows_needed(q)}")
    dev = vals.device
    _require(vals, "vals", torch.float32, (nb, ns), dev)
    mode = _mode_for(q, phase)
    ts_ptr = ph_ptr = None
    if mode == "ts":
        if ts is None:
            raise ValueError(f"op {q.op} needs the ts plane")
        _require(ts, "ts", torch.int32, (nb, ns), dev)
        ts_ptr = ts.data_ptr()
    elif mode == "phase":
        phase = phase.reshape(-1)
        _require(phase, "phase", torch.int32, (ns,), dev)
        ph_ptr = phase.data_ptr()
    out = torch.empty((q.nsteps, ns), dtype=torch.float32, device=dev)
    if ns == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.rate_grid_launch(
            ctypes.c_void_p(vals.data_ptr()), ctypes.c_void_p(ts_ptr),
            ctypes.c_void_p(ph_ptr), ctypes.c_void_p(out.data_ptr()),
            *_int32_args(nb, ns, q.nsteps, q.kbuckets, q.stride,
                         q.gstep_ms, steps0, _OP_CODE[q.op],
                         _MODE_CODE[mode], q.dense, q.is_rate),
            _stream())
    rate_grid.launches += 1
    _launch_check(rc, "rate_grid")
    return out


rate_grid.launches = 0


def rate_grid_packed(packed: dict, steps0: int, q: GridQuery,
                     row0: int = 0, use_phase: bool = False):
    """Per-series windowed function over XOR-class packed residents:
    class planes -> ``[T, packed_width]`` f32 in PACKED lane order (map
    back through the pack's ``inv``).  One kernel launch per non-empty
    class plane; the decode starts at block row 0 and the query reads
    rows ``[row0, row0 + rows_needed)``.  ``use_phase`` selects the
    uniform-phase mode reading meta row 2; otherwise only TS_FREE ops
    are legal.  CPU tensors run :func:`rate_grid_packed_ref`."""
    planes = _packed_planes(packed)
    if not planes:
        raise ValueError("pack has no class planes")
    dev = planes[0][0].device
    if dev.type == "cpu":
        return rate_grid_packed_ref(packed, steps0, q, row0, use_phase)
    if dev.type != "cuda":
        raise ValueError(f"rate_grid_packed runs on cpu or cuda, not {dev}")
    _packed_check(packed, q, row0, use_phase)
    width = packed_width(packed)
    dtypes = (torch.uint8, torch.int16, torch.int32, torch.float32)
    out = torch.empty((q.nsteps, width), dtype=torch.float32, device=dev)
    lib = kernels.library()
    col = 0
    for p, m, kind in planes:
        nb, n = p.shape
        _require(p, f"plane {_PLANES[kind][0]}", dtypes[kind], (nb, n), dev)
        _require(m, f"meta {_PLANES[kind][1]}", torch.int32, (8, n), dev)
        with torch.cuda.device(dev):
            rc = lib.rate_grid_packed_launch(
                ctypes.c_void_p(p.data_ptr()), ctypes.c_void_p(m.data_ptr()),
                ctypes.c_void_p(out.data_ptr()),
                *_int32_args(kind, nb, n, width, col, row0, q.nsteps,
                             q.kbuckets, q.stride, q.gstep_ms,
                             _OP_CODE[q.op], use_phase, q.dense, q.is_rate),
                _stream())
        rate_grid_packed.launches += 1
        _launch_check(rc, "rate_grid_packed")
        col += n
    return out


rate_grid_packed.launches = 0


# ---------------------------------------------------------------------------
# M4 visualization downsampling: per-pixel-bin min/max/first/last
# selection (the M4 aggregation of Jugel et al., arXiv:2307.05389).  A
# T-step series split into P pixel bins keeps <= 4 points per bin —
# everything a width-P panel can render.  Pure SELECTION, no arithmetic:
# the kernel and the plain version are bit-equal.
# ---------------------------------------------------------------------------

#: m4 plane order along output axis 1: values then LOCAL row indices
M4_PLANES = ("vmin", "vmax", "vfirst", "vlast",
             "imin", "imax", "ifirst", "ilast")


def m4_bin_width(nsteps: int, pixels: int) -> int:
    """Bin width W = ceil(T / P): bin p holds rows [p*W, (p+1)*W)."""
    return -(-nsteps // pixels)


def _m4_check(vals: torch.Tensor, pixels: int) -> None:
    if vals.ndim != 2 or vals.shape[0] == 0 or vals.shape[1] == 0:
        raise ValueError(f"m4_grid needs a non-empty [T, S] input, got "
                         f"{tuple(vals.shape)}")
    if pixels < 1:
        raise ValueError(f"pixels must be >= 1, got {pixels}")


def m4_grid_ref(vals: torch.Tensor, pixels: int) -> torch.Tensor:
    """Plain version of :func:`m4_grid`: the same selection over the
    batched ``[P, W, S]`` view (rows past T are NaN padding)."""
    _m4_check(vals, pixels)
    nsteps, ns = vals.shape
    w = m4_bin_width(nsteps, pixels)
    v = vals.to(torch.float32)
    pad = torch.full((pixels * w - nsteps, ns), float("nan"),
                     dtype=torch.float32, device=v.device)
    v = torch.cat([v, pad]).reshape(pixels, w, ns)
    idx = torch.arange(w, dtype=torch.int32,
                       device=v.device)[None, :, None].expand_as(v)
    fin = torch.isfinite(v)
    inf = torch.full_like(v, float("inf"))
    vmin = torch.where(fin, v, inf).amin(1)
    vmax = torch.where(fin, v, -inf).amax(1)
    big = torch.full_like(idx, _IBIG)
    ifirst = torch.where(fin, idx, big).amin(1)
    ilast = torch.where(fin, idx, -1).amax(1)
    imin = torch.where(fin & (v == vmin[:, None]), idx, big).amin(1)
    imax = torch.where(fin & (v == vmax[:, None]), idx, big).amin(1)
    empty = ifirst == _IBIG

    def at(i):
        return v.gather(1, i.clamp(0, w - 1).to(torch.int64)[:, None])[:, 0]

    nan = torch.tensor(float("nan"), device=v.device)
    neg1 = torch.tensor(-1.0, device=v.device)
    # values gathered at their indices: of tied +0.0 and -0.0 the first
    # one's bits, as the kernel keeps them
    planes = [torch.where(empty, nan, at(i))
              for i in (imin, imax, ifirst, ilast)]
    planes += [torch.where(empty, neg1, i.to(torch.float32))
               for i in (imin, imax, ifirst, ilast)]
    return torch.stack(planes, dim=1)


def m4_grid(vals: torch.Tensor, pixels: int) -> torch.Tensor:
    """M4 pixel-bin selection: time-major ``vals [T, S]`` f32 -> planes
    ``[P, 8, S]`` in :data:`M4_PLANES` order.  Index planes are LOCAL to
    the bin (global row = ``p * W + local``, ``W = ceil(T/P)``); NaN and
    infinite steps are absent samples; bins with no finite sample come
    back NaN / -1.  CPU tensors run :func:`m4_grid_ref`; CUDA tensors
    launch the CUDA kernel or raise."""
    if vals.device.type == "cpu":
        return m4_grid_ref(vals, pixels)
    if vals.device.type != "cuda":
        raise ValueError(f"m4_grid runs on cpu or cuda, not {vals.device}")
    _m4_check(vals, pixels)
    nsteps, ns = vals.shape
    dev = vals.device
    _require(vals, "vals", torch.float32, (nsteps, ns), dev)
    w = m4_bin_width(nsteps, pixels)
    out = torch.empty((pixels, 8, ns), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.m4_grid_launch(
            ctypes.c_void_p(vals.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            *_int32_args(nsteps, ns, pixels, w), _stream())
    m4_grid.launches += 1
    _launch_check(rc, "m4_grid")
    return out


m4_grid.launches = 0


def reset_launch_counts() -> None:
    rate_grid.launches = 0
    rate_grid_packed.launches = 0
    m4_grid.launches = 0
