#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``filodb_tpu_torch``) on one NVIDIA card
and check it end to end.

    python3 chip_smoke.py [--seed N] [--out report.json]

Phases, each timed on a line of its own:

1. device  — the card's name, and its name and power limit from
   ``nvidia-smi``;
2. build   — ``nvcc`` builds the CUDA kernels from ``filodb_tpu_torch/
   csrc/grid_kernels.cu``;
3. kernels — every op/mode of ``rate_grid`` and every class plane of
   ``rate_grid_packed`` at a mid shape (B=128, S=16384, K=5): all 22 ops
   of the TPU kernels, each in every mode the TPU kernel serves it, at
   strides 1 and 2 (``rate_grid_packed`` over the 14 ops that read no
   timestamps), plus quantile at K=32 with phi 0.9, 0.5 and 1.5 and
   irate at K=1024 over a 1,100-row plane; ``m4_grid`` at
   [T=103, S=16,421] with P=10 and P=50 (gaps, ties, tied
   zeros of both signs, all-NaN bins, an all-NaN series); then the
   grouped kernels at the mid shape, in all 22 ops of their TPU kernels:
   ``rate_grid_grouped`` in every op/mode (gappy lanes, strides 1 and 2,
   512-lane groups, the last one all-NaN, quantile at K=32 and with phi
   1.5), ``rate_grid_grouped_packed`` over a p8 plane and a p16 plane of
   whole groups (the phase ops and the 14 that read no timestamps, row0
   = 3, stride 2), ``hist_grid_grouped_packed`` at hb = 4, 16, 20 (row0
   0 and 3, a dead series, the phase ops and every free op); each held
   against its plain PyTorch version run on the same CUDA tensors (m4
   bit for bit, grouped counts equal, sums rtol 2e-5), and the packed
   grouped kernels refusing the 5 ops that read timestamps;
4. main    — one shard of ``prom-counter`` data at high cardinality
   (``req_total``: 100 pods x 1,024 series, 260 one-minute samples,
   constant per-series phase, integer increments 0-9, a reset in 1% of
   series; ``jit_total``: 8,192 series with +-30 s per-sample jitter and
   5% missed scrapes), ingested through ``ingest_container``, then
   queries through ``scan_grid``/``scan_grid_grouped``:
     Q1 sum by (pod)(rate(req_total[5m])), 1 h inside block 1 (fully
        covered, packed) -> packed kernel, phase mode;
     Q2 the same over a span crossing blocks 0-1 -> XOR decode + rate_grid
        kernel, phase mode;
     Q3 sum_over_time, max_over_time and the instant selector over
        req_total -> packed kernel, free mode;
     Q4 sum by (pod)(rate(jit_total[5m])) -> rate_grid kernel, ts mode;
     Q5 the 13 functions of the second op set over Q1's span: the 8 that
        read no timestamps -> packed kernel, irate, idelta, deriv,
        predict_linear and timestamp -> rate_grid over the decoded planes
        and the rebuilt uniform-phase ts plane;
     Q6 stddev_over_time, deriv and timestamp over jit_total (gappy
        lanes) -> rate_grid; the 7 dense-only functions answer None there.
   Launch counters show each query went through its kernel; each query's
   rows for the first 8 pods are held against a CPU store that ingests
   only those pods (rtol 1e-5; deriv, idelta and zscore, which cross 0,
   of each series' largest answer); one warm run of Q1-Q4 is profiled
   (torch.profiler); each kernel is then held against its plain version
   on the inputs the main path gave it, and timed;
5. engine  — the same store through the query engine's entry point
   (PromQL -> query_range_to_logical_plan -> SingleClusterPlanner ->
   ExecPlan.execute), launch counters reset just before and read just
   after the six queries' first runs:
     E1 sum by (pod)(rate(req_total[5m])) over Q1's span -> the packed
        kernel, equal bit for bit to the direct scan_grid_grouped answer;
     E2 rate(req_total[5m]) over all 260 steps with DownsampleMapper(32)
        -> rate_grid, then one m4_grid launch;
     E3 sum by (pod)(irate(req_total[5m])) -> rate_grid (the grid's
        second op set), no general path;
     E4 stdvar by (pod)(rate(req_total[5m])) -> the packed kernel, then
        the fused "moments" group reduce on the card;
     E5 quantile_over_time(0.9, req_total[5m]) -> the packed kernel;
     E6 predict_linear(req_total[5m], 600) -> rate_grid;
   each against the CPU store's engine answer (rtol 1e-5, E4 2e-4; NaN
   and selected positions equal), cold and warm wall ms; every result but
   E2's downsampled one, and every aggregation, on the card; then m4_grid
   against its plain version at E2's own [260, 102,400] input, timed;
6. northstar — ``filodb_tpu_torch/northstar.py``'s four variants at the
   benchmark's widths (bench.py's dense, compressed_resident,
   histogram_quantile and gdelt_topk): data made on the card from the
   seed, host packs (timed), every gate; the four queries once with the
   launch counters reset just before and read just after (exactly one
   rate_grid_grouped, one rate_grid_grouped_packed, one
   hist_grid_grouped_packed and two rate_grid_packed launches); each new
   kernel against its plain version at those widths and timed; the
   grouped kernels in the second op set on the same data (13 ops on
   rate_grid_grouped, the 5 that read timestamps over the dense
   variant's ts plane; 8 each on rate_grid_grouped_packed and
   hist_grid_grouped_packed), each against its plain version, its
   launches counted, and timed; each query's device ms and samples/s.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
them; without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))

STEP = 60_000
T0 = 1_700_000_040_000          # step-aligned epoch ms
WINDOW = 300_000                # [5m]
K = WINDOW // STEP
# 4 h 20 min of one-minute samples: buckets 1..260, so block 1 (buckets
# 128..255) is fully covered.  Row 0 of the first block is always empty
# (the grid epoch is the first sample's bucket edge), and a NaN row next
# to a value is an incompressible XOR residual: only fully covered
# blocks pack, so the packed kernel needs one.
N_ROWS = 260
POD_SERIES = 1024
REQ_PODS = 100
JIT_PODS = 8
JIT_MISSED = 0.05               # jit_total's share of missed scrapes
CHECK_PODS = 8
MID_SERIES = 16384              # phase 3's mid shape: B=128 x S
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
REPS = 20                       # timed repetitions (median)
ENGINE_REPS = 5                 # warm repetitions of each engine query
RTOL_KERNEL = 2e-5              # sums / rate chain, kernel vs plain
RTOL_CPU = 1e-5                 # card (f32) vs CPU store (f64)
# E4's stdvar is sumsq/n - mean^2 over 1,024 f32 rates summed on the card
# in the one-hot matmul's order: the difference cancels ~12x here, and an
# f32 sum in the worst order is off by up to 7e-5 of the variance
RTOL_MOMENTS = 2e-4
SELECTION = ("last", "min", "max", "count", "m4", "changes", "resets")
M4_T = 103                      # phase 3's M4 shape: T % P != 0
M4_PIXELS = (10, 50)            # W = 11, and W = 3 with empty tail bins
E2_PIXELS = 32                  # the engine's ?downsample= (W = 9)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints a phase's wall seconds on a line of its own."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"phase {self.name} seconds "
                f"{time.perf_counter() - self.t0:.3f}")
        return False


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(build_log: str) -> list:
    """One line a kernel from ``nvcc -Xptxas -v``: its (mangled) name,
    registers, stack and spills."""
    out, name, frame = [], "?", ""
    for line in build_log.splitlines():
        line = line.strip()
        if "Function properties for " in line:
            name = line.split("Function properties for ", 1)[1]
        elif "spill" in line:
            frame = line
        elif "Used " in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {frame}")
    return out


# ------------------------------------------------------------- comparison

def compare(got, want, op: str, rtol: float, series_dim=None) -> float:
    """Raise unless ``got`` matches ``want``: the same NaN, +Inf and -Inf
    cells, selection ops bit-equal, the rest within ``rtol`` of each
    value, or with ``series_dim`` (the axis a series runs along) of the
    largest value of its series, for answers that cross 0.  Returns the
    largest absolute difference over finite cells."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    g = got.double().cpu()
    w = want.double().cpu()
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(g), fin):
        n = int((torch.isfinite(g) != fin).sum())
        raise AssertionError(f"{op}: finite masks differ in {n} cells")
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(mask(g), mask(w)):
            raise AssertionError(f"{op}: {mask.__name__} masks differ")
    if not fin.any():
        if torch.isnan(w).all():
            raise AssertionError(f"{op}: no finite output to compare")
        return 0.0                       # +-Inf everywhere, cells equal
    diff = (g[fin] - w[fin]).abs()
    err = float(diff.max())
    scale = w.abs()
    if series_dim is not None:
        scale = torch.where(fin, scale, torch.zeros_like(scale)).amax(
            dim=series_dim, keepdim=True).expand_as(w)
    if op in SELECTION:
        if err != 0.0:
            raise AssertionError(f"{op}: selection op differs by {err}")
    elif not bool((diff <= rtol * scale[fin]).all()):
        rel = float((diff / scale[fin].clamp_min(1e-30)).max())
        raise AssertionError(f"{op}: rel err {rel:.3e} > rtol {rtol}")
    return err


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Median device ms of ``fn`` by CUDA events, one event pair per
    call.  Each call is queued behind a spin kernel that outlasts the
    host's enqueue time, so the pair brackets device work only (the
    wrapper's Python and ctypes overhead is excluded); ``flush`` (run
    before the spin) evicts the L2 cache."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0          # enqueue time, no sync
    torch.cuda.synchronize()
    spin = int(max(host_s, 50e-6) * 4 * 2e9)    # cycles at <= 2 GHz, 4x
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_flush(device):
    import torch
    buf = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=device)
    return lambda: buf.zero_()


# ------------------------------------------------------------- bounds

def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _ops_per_output(q) -> int:
    """Scalar ops per output cell: the extrapolation (~25 in ts mode),
    the collapsed phase formula (~12), the instant pair (6), the
    timestamp (3), K steps of a regression (10 each), of the moments (6
    each), of Holt-Winters (10 each), the sorting network's
    compare-exchanges (2 ops each; mad sorts twice), or K
    accumulations."""
    from filodb_tpu_torch.ops import grid
    K = q.kbuckets
    if q.op in ("rate", "increase", "delta"):
        return 25
    if q.op in ("irate", "idelta"):
        return 6
    if q.op == "timestamp":
        return 3
    if q.op in ("deriv", "predict_linear"):
        return 10 * K + 15
    if q.op in ("stddev", "stdvar", "zscore"):
        return 6 * K + 10
    if q.op == "holt_winters":
        return 10 * K
    if q.op in ("quantile", "mad"):
        sorts = 2 if q.op == "mad" else 1
        return sorts * 2 * len(grid.batcher_pairs(K)) + 2 * K + 4
    return 2 * q.kbuckets


def _rows_read(q) -> tuple[int, int]:
    """(value rows, ts rows) of the covered span that the windows read:
    every row, but for the K-free dense ops (the instant pair reads each
    window's last two rows, timestamp one value row and one ts row)."""
    from filodb_tpu_torch.ops import grid
    rows = grid._rows_needed(q)
    if q.dense and q.op in ("irate", "idelta", "timestamp"):
        last = {t * q.stride + q.kbuckets - 1 for t in range(q.nsteps)}
        if q.op == "timestamp":
            first = {t * q.stride for t in range(q.nsteps)}
            return len(first), len(last)
        pair = last | {r - 1 for r in last}
        return len(pair), len(pair)
    return rows, rows


def grid_work(ts, vals, q, phase) -> tuple[int, int]:
    """(bytes, ops) one rate_grid call must move and do: the rows the
    query's windows read (:func:`_rows_read`), the ts plane's rows or
    the [S] phase row, and the [T, S] output."""
    from filodb_tpu_torch.ops import grid
    ns = vals.shape[1]
    vrows, trows = _rows_read(q)
    nbytes = vrows * ns * 4 + q.nsteps * ns * 4
    mode = grid._mode_for(q, phase)
    if mode == "ts":
        nbytes += trows * ns * 4
    elif mode == "phase":
        nbytes += ns * 4
    corr = 3 if q.op in ("rate", "increase") else 0
    ops = vrows * ns * corr + q.nsteps * ns * _ops_per_output(q)
    return nbytes, ops


def m4_work(nsteps: int, ns: int, pixels: int) -> tuple[int, int]:
    """(bytes, ops) of one m4_grid call: the [T, S] f32 input read once,
    the [P, 8, S] f32 planes written once, two compares per sample."""
    return nsteps * ns * 4 + pixels * 8 * ns * 4, 2 * nsteps * ns


def packed_work(packed, q, row0, use_phase) -> tuple[int, int]:
    """(bytes, ops) one rate_grid_packed call must move and do: the rows
    [0, row0 + (T-1)*stride + K) of each class plane (the XOR prefix
    starts at block row 0), meta rows 0-1 (shift, first bits) and row 2
    in phase mode, and the [T, n] output; the decode is three ops per
    word."""
    from filodb_tpu_torch.ops import grid
    need = grid._rows_needed(q)
    corr = 3 if q.op in ("rate", "increase") else 0
    nbytes = ops = 0
    for p, _m, _kind in grid._packed_planes(packed):
        n = p.shape[1]
        nbytes += (row0 + need) * n * p.element_size() \
            + (3 if use_phase else 2) * n * 4 + q.nsteps * n * 4
        ops += (row0 + need) * n * 3 + need * n * corr \
            + q.nsteps * n * _ops_per_output(q)
    return nbytes, ops


def grouped_work(vals, q, phase, nslots: int) -> tuple[int, int]:
    """(bytes, ops) of one rate_grid_grouped call: rate_grid's inputs,
    ``nslots`` (sum, count) rows of T f32 out instead of the [T, S]
    plane, and two adds per (step, lane) for the group reduce."""
    nbytes, ops = grid_work(None, vals, q, phase)
    cells = q.nsteps * vals.shape[1]
    return nbytes - cells * 4 + 2 * nslots * q.nsteps * 4, ops + 2 * cells


def grouped_packed_work(packed, q, row0, use_phase,
                        nslots: int) -> tuple[int, int]:
    """(bytes, ops) of one rate_grid_grouped_packed or
    hist_grid_grouped_packed call: rate_grid_packed's inputs, ``nslots``
    (sum, count) rows of T f32 out, two adds per (step, lane)."""
    from filodb_tpu_torch.ops import grid
    nbytes, ops = packed_work(packed, q, row0, use_phase)
    cells = q.nsteps * grid.packed_width(packed)
    return nbytes - cells * 4 + 2 * nslots * q.nsteps * 4, ops + 2 * cells


def compare_grouped(got, want, case: str, op: str = "") -> float:
    """(sum, count) against the plain version's: counts equal, sums with
    the same NaN cells and within RTOL_KERNEL (of the group's largest sum
    over its steps for answers that cross 0).  Returns the largest
    absolute difference of the sums."""
    import torch
    (gs, gc), (ws, wc) = got, want
    if not torch.equal(gc, wc):
        raise AssertionError(f"{case}: counts differ in "
                             f"{int((gc != wc).sum())} cells")
    try:
        return compare(gs, ws, "grouped sum", RTOL_KERNEL,
                       1 if op in CROSSING else None)
    except AssertionError as e:
        raise AssertionError(f"{case}: {e}") from None


# ------------------------------------------------------------- phase 3

def _mid_planes(rng, B, S, gappy: bool):
    """Counters on the grid layout: per-lane phase, resets, and (gappy)
    missed scrapes; the last 512 lanes are empty."""
    import numpy as np
    phase = rng.integers(1, STEP, S).astype(np.int32)
    ts = (np.arange(B, dtype=np.int64)[:, None] * STEP + phase[None, :])
    vals = np.cumsum(rng.integers(0, 10, (B, S)), axis=0).astype(
        np.float64) + rng.integers(0, 10**6, S)[None, :]
    resets = rng.random(S) < 0.01
    at = rng.integers(1, B, S)
    for s in np.flatnonzero(resets):
        vals[at[s]:, s] -= vals[at[s] - 1, s]
    if gappy:
        vals[rng.random((B, S)) < 0.1] = np.nan
    vals[:, -512:] = np.nan
    return ts.astype(np.int32), vals.astype(np.float32), phase


def _to_p32(pk: dict) -> dict:
    """Move a pack's raw lanes into a p32 class plane (per-lane shift by
    the common trailing zeros): an f32 pack never emits p32 on its own,
    and the kernel must decode every class."""
    import numpy as np
    raw = pk["raw"].view(np.uint32)
    orv = np.bitwise_or.reduce(raw, axis=0)
    low = orv & (~orv + np.uint32(1))
    ctz = np.zeros(raw.shape[1], np.int32)
    nz = orv != 0
    ctz[nz] = np.log2(low[nz].astype(np.float64)).astype(np.int32)
    out = dict(pk)
    out["p32"] = (raw >> ctz.astype(np.uint32)[None, :]).astype(np.uint32)
    m = pk["mraw"].copy()
    m[0] = ctz
    out["m32"] = m
    out["z32"] = ctz
    out["raw"] = np.zeros((raw.shape[0], 0), np.float32)
    out["mraw"] = np.zeros((8, 0), np.int32)
    return out


# the rate_grid sweep's (mode, dense, op) cases: the first nine ops, then
# the second op set in each mode the TPU kernel serves it
FIRST_OPS_CASES = (
    [("phase", True, o) for o in ("rate", "increase", "delta")]
    + [("ts", d, o) for d in (True, False)
       for o in ("rate", "increase", "delta")]
    + [("free", d, o) for d in (True, False)
       for o in ("sum", "count", "avg", "min", "max", "last")])
TS_SECOND_OPS = ("irate", "idelta", "deriv", "predict_linear", "timestamp")
FREE_SECOND_OPS = ("changes", "resets", "stddev", "stdvar", "zscore",
                   "quantile", "mad", "holt_winters")
MOMENT_OPS = ("stddev", "stdvar", "zscore")
SECOND_OPS_CASES = (
    [("ts", True, o) for o in TS_SECOND_OPS]
    + [("ts", False, o) for o in ("deriv", "predict_linear", "timestamp")]
    + [("free", True, o) for o in FREE_SECOND_OPS]
    + [("free", False, o) for o in MOMENT_OPS])
# the functions' scalar arguments in the sweeps (farg, farg2)
FARGS = {"predict_linear": (600.0, 0.0), "quantile": (0.9, 0.0),
         "holt_winters": (0.3, 0.6)}
# answers that cross 0 are held to their series' largest answer
CROSSING = ("deriv", "zscore", "idelta")


def sweep_query(op, dense, stride, nsteps, k=K):
    from filodb_tpu_torch.ops import grid
    farg, farg2 = FARGS.get(op, (0.0, 0.0))
    return grid.GridQuery(nsteps=nsteps, kbuckets=k, gstep_ms=STEP,
                          is_rate=(op == "rate"), op=op, dense=dense,
                          stride=stride, farg=farg, farg2=farg2)


def kernel_sweep(device, reps: int, seed: int, report: dict) -> float:
    import numpy as np
    import torch
    from filodb_tpu_torch.codecs import xorgrid
    from filodb_tpu_torch.ops import grid

    B, S = 128, MID_SERIES
    rng = np.random.default_rng([seed, 3])
    flush = make_flush(device)
    worst = 0.0
    rows = []
    planes = {g: _mid_planes(rng, B, S, g) for g in (False, True)}

    def run_grid(name, ts, vals, q, ph=None):
        nonlocal worst
        steps0 = q.kbuckets * STEP
        got = grid.rate_grid(ts, vals, steps0, q, phase=ph)
        want = grid.rate_grid_ref(ts, vals, steps0, q, phase=ph)
        torch.cuda.synchronize()
        err = compare(got, want, q.op, RTOL_KERNEL,
                      0 if q.op in CROSSING else None)
        worst = max(worst, err)
        ms = cuda_ms(lambda: grid.rate_grid(ts, vals, steps0, q, phase=ph),
                     reps, flush)
        pms = cuda_ms(lambda: grid.rate_grid_ref(ts, vals, steps0, q,
                                                 phase=ph), reps, flush)
        bms, by = bound_ms(*grid_work(ts, vals, q, ph))
        log(f"{name}: ms {ms:.4f} plain_ms {pms:.4f} bound_ms "
            f"{bms:.4f} ({by}) max_abs_err {err:.3e} ok")
        rows.append({"kernel": "rate_grid", "case": name, "op": q.op,
                     "ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "max_abs_err": err})

    for mode, dense, op in FIRST_OPS_CASES + SECOND_OPS_CASES:
        ts_np, v_np, ph_np = planes[not dense]
        ts = torch.as_tensor(ts_np, device=device)
        vals = torch.as_tensor(v_np, device=device)
        ph = torch.as_tensor(ph_np, device=device) \
            if mode == "phase" else None
        for stride in (1, 2):
            q = sweep_query(op, dense, stride, (B - K) // stride + 1)
            run_grid(f"rate_grid {mode}-{'dense' if dense else 'gappy'}-"
                     f"{op} stride={stride}", ts, vals, q, ph)
    # the sort ops at their largest window, with phi inside and outside
    # [0, 1]; the instant pair at the K-free cap over a tall plane
    ts = torch.as_tensor(planes[False][0], device=device)
    vals = torch.as_tensor(planes[False][1], device=device)
    for phi in (0.9, 0.5, 1.5):
        q = sweep_query("quantile", True, 1, B - grid.SORT_OPS_MAX_K + 1,
                        k=grid.SORT_OPS_MAX_K)._replace(farg=phi)
        run_grid(f"rate_grid free-dense-quantile K=32 phi={phi}", ts, vals,
                 q)
    tall = 1100
    ts_np, v_np, _ph = _mid_planes(rng, tall, S, False)
    ts = torch.as_tensor(ts_np, device=device)
    vals = torch.as_tensor(v_np, device=device)
    kmax = grid.MAX_DENSE_K
    run_grid(f"rate_grid ts-dense-irate K={kmax}", ts, vals,
             sweep_query("irate", True, 1, tall - kmax + 1, k=kmax))
    del ts, vals
    # packed: counters with an empty tail (p16), constants (p8),
    # incompressible noise (raw, or p32 after _to_p32)
    v = planes[False][1].copy()
    v[:, :S // 8] = 5.0
    v[:, S // 8:S // 4] = (rng.random((B, S // 8)) * 100).astype(np.float32)
    ph_np = planes[False][2]
    pk = xorgrid.pack_vals(v, phase=ph_np)
    if pk is None:
        raise AssertionError("mid-shape plane did not pack")
    for label, pdict in (("p8+p16+raw", pk.planes),
                         ("p8+p16+p32", _to_p32(pk.planes))):
        packed = xorgrid.packed_to_torch(pdict, device)
        classes = [k for k in ("p8", "p16", "p32", "raw")
                   if k in pdict and pdict[k].shape[1]]
        for use_phase, dense, op in (
                [(True, True, o) for o in ("rate", "increase", "delta")]
                + [(False, d, o) for d in (True, False)
                   for o in ("sum", "count", "avg", "min", "max",
                             "last")]
                + [(False, True, o) for o in FREE_SECOND_OPS]
                + [(False, False, o) for o in MOMENT_OPS]):
            row0 = 3
            q = sweep_query(op, dense, 2, (B - row0 - K) // 2 + 1)
            got = grid.rate_grid_packed(packed, 0, q, row0=row0,
                                        use_phase=use_phase)
            want = grid.rate_grid_packed_ref(packed, 0, q, row0=row0,
                                             use_phase=use_phase)
            torch.cuda.synchronize()
            err = compare(got, want, op, RTOL_KERNEL,
                          0 if op in CROSSING else None)
            worst = max(worst, err)
            ms = cuda_ms(lambda: grid.rate_grid_packed(
                packed, 0, q, row0=row0, use_phase=use_phase), reps, flush)
            pms = cuda_ms(lambda: grid.rate_grid_packed_ref(
                packed, 0, q, row0=row0, use_phase=use_phase), reps, flush)
            bms, by = bound_ms(*packed_work(packed, q, row0, use_phase))
            name = (f"rate_grid_packed {label} "
                    f"{'phase' if use_phase else 'free'}-"
                    f"{'dense' if dense else 'gappy'}-{op}")
            log(f"{name} classes={classes}: ms {ms:.4f} plain_ms "
                f"{pms:.4f} bound_ms {bms:.4f} ({by}) max_abs_err "
                f"{err:.3e} ok")
            rows.append({"kernel": "rate_grid_packed", "case": name,
                         "op": op, "ms": ms, "plain_ms": pms,
                         "bound_ms": bms, "max_abs_err": err})
    # m4_grid: gaps, constant runs (ties), tied zeros of both signs
    # (-0.0 first, then +0.0 first), all-NaN bins, an all-NaN series
    S = MID_SERIES + 37
    v = rng.normal(0, 10, (M4_T, S)).astype(np.float32)
    v[rng.random((M4_T, S)) < 0.3] = np.nan
    v[:, :S // 8] = 7.5
    z = np.zeros((M4_T, 64), np.float32)
    z[::2] = -0.0
    v[:, S // 8:S // 8 + 64] = z
    v[:, S // 8 + 64:S // 8 + 128] = -z
    v[40:80, S // 4:S // 2] = np.nan
    v[:, S // 2] = np.nan
    vals = torch.as_tensor(v, device=device)
    for pixels in M4_PIXELS:
        err = check_m4(vals, pixels)
        worst = max(worst, err)
        ms = cuda_ms(lambda: grid.m4_grid(vals, pixels), reps, flush)
        pms = cuda_ms(lambda: grid.m4_grid_ref(vals, pixels), reps, flush)
        bms, by = bound_ms(*m4_work(M4_T, S, pixels))
        name = f"m4_grid T={M4_T} S={S} P={pixels}"
        log(f"{name}: ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} "
            f"({by}) bit-equal ok")
        rows.append({"kernel": "m4_grid", "case": name, "ms": ms,
                     "plain_ms": pms, "bound_ms": bms, "max_abs_err": err})
    report["kernel_sweep"] = rows
    return worst


def _counters_np(rng, rows, cols, small=False):
    """Integer counters with a pinned f32 exponent: residuals in bits 7-14
    (one 8-bit class) when ``small``, else in bits 7-22 (16-bit)."""
    import numpy as np
    if small:
        start = 2 ** 23 + 2 ** 15 * rng.integers(0, 2 ** 7, cols)
        inc = 128 * rng.integers(0, 2, (rows, cols))
    else:
        start = 2 ** 23 + 128 * rng.integers(0, 2 ** 15, cols)
        inc = 128 * rng.integers(1, 8, (rows, cols))
    return (start[None, :] + np.cumsum(inc, axis=0)).astype(np.float32)


def two_plane_pack(rng, rows: int, width: int) -> dict:
    """A p8 pack and a p16 pack of ``width`` lanes each, merged into one
    dict: the grouped packed kernel runs one launch per plane and returns
    the groups in plane order.  The p16 plane's first 5 lanes are dead."""
    import numpy as np
    from filodb_tpu_torch.codecs import xorgrid
    v16 = _counters_np(rng, rows, width)
    v16[:, :5] = np.nan
    p8, p16 = (xorgrid.pack_vals(v, phase=rng.integers(1, STEP, width)
                                 .astype(np.int32), min_width=w)
               for v, w in ((_counters_np(rng, rows, width, True), 8),
                            (v16, 16)))
    for pk, key in ((p8, "p8"), (p16, "p16")):
        if [k for k in ("p8", "p16", "raw")
                if k in pk.planes and pk.planes[k].shape[1]] != [key]:
            raise AssertionError(f"the {key} half did not pack as one {key} "
                                 f"plane")
    return {"p8": p8.planes["p8"], "m8": p8.planes["m8"],
            "p16": p16.planes["p16"], "m16": p16.planes["m16"],
            "inv": np.concatenate([p8.inv, p16.inv + width])}


def grouped_sweep(device, reps: int, seed: int, report: dict) -> float:
    """The grouped kernels at the mid shape, each against its plain
    version on the same card tensors, in every op of their TPU kernels:
    rate_grid_grouped in every op/mode (gappy lanes, strides 1 and 2, a
    group of all-NaN lanes, quantile at K = 32 and with phi 1.5),
    rate_grid_grouped_packed over a two-plane pack (phase and free ops,
    row0 = 3, stride 2), hist_grid_grouped_packed at hb 4, 16 and 20
    (row0 0 and 3, a dead series, every free op); then the packed ones
    refusing the ops that read timestamps."""
    import numpy as np
    import torch
    from filodb_tpu_torch.codecs import xorgrid
    from filodb_tpu_torch.ops import grid

    B, S, GL = 128, MID_SERIES, 512
    rng = np.random.default_rng([seed, 5])
    flush = make_flush(device)
    worst = 0.0
    rows = []

    def run(kname, case, fn, ref, work, op):
        nonlocal worst
        got, want = fn(), ref()
        torch.cuda.synchronize()
        err = compare_grouped(got, want, case, op)
        worst = max(worst, err)
        ms = cuda_ms(fn, reps, flush)
        pms = cuda_ms(ref, reps, flush)
        bms, by = bound_ms(*work)
        log(f"{case}: ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} "
            f"({by}) max_abs_err {err:.3e} ok")
        rows.append({"kernel": kname, "case": case, "op": op, "ms": ms,
                     "plain_ms": pms, "bound_ms": bms, "max_abs_err": err})
        return got

    # B2: the last GL lanes of _mid_planes are empty, a group of padding
    planes = {g: _mid_planes(rng, B, S, g) for g in (False, True)}
    b2_cases = [(mode, dense, op, stride, sweep_query(
                    op, dense, stride, (B - K) // stride + 1))
                for mode, dense, op in FIRST_OPS_CASES + SECOND_OPS_CASES
                for stride in (1, 2)]
    b2_cases += [("free", True, "quantile", 1, sweep_query(
                     "quantile", True, 1, B - grid.SORT_OPS_MAX_K + 1,
                     k=grid.SORT_OPS_MAX_K)),
                 ("free", True, "quantile", 1, sweep_query(
                     "quantile", True, 1, B - K + 1)._replace(farg=1.5))]
    for mode, dense, op, stride, q in b2_cases:
        ts_np, v_np, ph_np = planes[not dense]
        ts = torch.as_tensor(ts_np, device=device)
        vals = torch.as_tensor(v_np, device=device)
        ph = torch.as_tensor(ph_np, device=device) \
            if mode == "phase" else None
        args = (ts, vals, q.kbuckets * STEP, q, GL)
        case = (f"rate_grid_grouped {mode}-{'dense' if dense else 'gappy'}-"
                f"{op} stride={stride} K={q.kbuckets}"
                + (f" phi={q.farg}" if op == "quantile" else ""))
        s, c = run("rate_grid_grouped", case,
                   partial(grid.rate_grid_grouped, *args, phase=ph),
                   partial(grid.rate_grid_grouped_ref, *args, phase=ph),
                   grouped_work(vals, q, ph, S // GL), op)
        if c[-1].any() or s[-1].any():
            raise AssertionError(f"{case}: the all-NaN group counted")
        if op == "quantile" and q.farg > 1.0 and (c.any() or s.any()):
            raise AssertionError(f"{case}: phi above 1 counted an answer")
    # B4 over a p8 plane and a p16 plane of 16 groups each
    pk = xorgrid.packed_to_torch(two_plane_pack(rng, B, S // 2), device)
    for use_phase, dense, op in (
            [(True, True, o) for o in ("rate", "increase", "delta")]
            + [(False, True, o) for o in ("sum", "count", "avg", "min",
                                          "max", "last")]
            + [(False, True, o) for o in FREE_SECOND_OPS]
            + [(False, False, o) for o in MOMENT_OPS]):
        row0 = 3
        q = sweep_query(op, dense, 2, (B - row0 - K) // 2 + 1)
        args = (pk, 0, q, GL, row0, use_phase)
        run("rate_grid_grouped_packed",
            f"rate_grid_grouped_packed p8+p16 "
            f"{'phase' if use_phase else 'free'}-"
            f"{'dense' if dense else 'gappy'}-{op}",
            partial(grid.rate_grid_grouped_packed, *args),
            partial(grid.rate_grid_grouped_packed_ref, *args),
            grouped_packed_work(pk, q, row0, use_phase, S // GL), op)
    # B5: 48 groups of 16 series x hb buckets, series 1 dead
    for hb in (4, 16, 20):
        per, ngroups = 16, 48
        cols = ngroups * per * hb
        v = _counters_np(rng, B, cols)
        v[:, hb:2 * hb] = np.nan
        phase = np.repeat(rng.integers(1, STEP, cols // hb), hb)
        hp = xorgrid.pack_vals(v, phase=phase.astype(np.int32), min_width=16,
                               stride=hb)
        if hp is None or not (hp.inv == np.arange(cols)).all():
            raise AssertionError(f"hb={hb}: not an identity stride pack")
        hpk = xorgrid.packed_to_torch(hp, device)
        for row0, use_phase, dense, op in (
                [(0, True, True, "rate"), (3, True, True, "rate"),
                 (3, False, True, "sum")]
                + [(3, False, True, o) for o in FREE_SECOND_OPS]
                + [(3, False, False, o) for o in MOMENT_OPS]):
            q = sweep_query(op, dense, 1, B - row0 - K + 1)
            args = (hpk, 0, q, hb, per * hb, row0, use_phase)
            run("hist_grid_grouped_packed",
                f"hist_grid_grouped_packed hb={hb} row0={row0} "
                f"{'phase' if use_phase else 'free'}-"
                f"{'dense' if dense else 'gappy'}-{op}",
                partial(grid.hist_grid_grouped_packed, *args),
                partial(grid.hist_grid_grouped_packed_ref, *args),
                grouped_packed_work(hpk, q, row0, use_phase, ngroups * hb),
                op)
    # a packed plane has no ts: the packed kernels refuse those ops
    for op in TS_SECOND_OPS:
        q = sweep_query(op, True, 1, B - K + 1)
        for call in (partial(grid.rate_grid_grouped_packed, pk, 0, q, GL,
                             0, False),
                     partial(grid.hist_grid_grouped_packed, hpk, 0, q, 20,
                             16 * 20, 0, False)):
            try:
                call()
            except ValueError:
                continue
            raise AssertionError(f"a packed grouped kernel accepted op {op}")
    log(f"packed grouped kernels refuse the {len(TS_SECOND_OPS)} ops that "
        f"read timestamps")
    report["grouped_sweep"] = rows
    return worst


def check_m4(vals, pixels: int) -> float:
    """m4_grid against its plain version on the same card tensor: the
    same NaN cells, and every other cell the same 32 bits (so +0.0 and
    -0.0 differ)."""
    import torch
    from filodb_tpu_torch.ops import grid
    got = grid.m4_grid(vals, pixels)
    want = grid.m4_grid_ref(vals, pixels)
    torch.cuda.synchronize()
    nan = got.isnan()
    if not torch.equal(nan, want.isnan()) or not torch.equal(
            got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]):
        raise AssertionError(f"m4_grid P={pixels}: planes differ from the "
                             f"plain version")
    return compare(got, want, "m4", 0.0)


# ------------------------------------------------------------- phase 4

def pod_containers(schema, metric: str, pod: int, seed: int,
                   jitter: bool) -> list:
    """One pod's 1,024 series as RecordContainer bytes."""
    import numpy as np
    from filodb_tpu_torch.core.record import RecordBuilder

    rng = np.random.default_rng([seed, int(jitter), pod])
    rows = np.arange(N_ROWS, dtype=np.int64)
    phase = rng.integers(1, STEP, POD_SERIES)
    vals = (rng.integers(0, 10**6, POD_SERIES)[:, None]
            + np.cumsum(rng.integers(0, 10, (POD_SERIES, N_ROWS)), axis=1))
    reset = np.flatnonzero(rng.random(POD_SERIES) < 0.01)
    at = rng.integers(1, N_ROWS, POD_SERIES)
    for s in reset:
        vals[s, at[s]:] -= vals[s, at[s] - 1]
    keep = np.ones((POD_SERIES, N_ROWS), bool)
    if jitter:
        ts = (T0 + rows[None, :] * STEP + 30_000
              + rng.integers(-29_999, 30_000, (POD_SERIES, N_ROWS)))
        keep[:, 1:] = rng.random((POD_SERIES, N_ROWS - 1)) >= JIT_MISSED
    else:
        ts = T0 + rows[None, :] * STEP + phase[:, None]
    b = RecordBuilder(schema)
    for s in range(POD_SERIES):
        k = keep[s]
        b.add_series(ts[s][k], [vals[s][k].astype(np.float64)],
                     {"__name__": metric, "pod": f"pod-{pod:03d}",
                      "instance": f"i-{s:04d}", "_ws_": "demo",
                      "_ns_": "app"})
    return b.containers()


def build_store(device, seed: int, req_pods: int, jit_pods: int):
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.core.storeconfig import StoreConfig
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore

    ms = TimeSeriesMemStore(device=device)
    shard = ms.setup("prom", DEFAULT_SCHEMAS, 0,
                     StoreConfig(device_cache_compress=True))
    schema = DEFAULT_SCHEMAS["prom-counter"]
    offset = 0
    samples = 0
    for metric, pods, jitter in (("req_total", req_pods, False),
                                 ("jit_total", jit_pods, True)):
        for pod in range(pods):
            for c in pod_containers(schema, metric, pod, seed, jitter):
                samples += shard.ingest_container(c, offset)
                offset += 1
    shard.flush_all()
    return ms, shard, samples


def lookup(shard, metric: str):
    """(part ids, group id per series by pod, pod names, tags)."""
    from filodb_tpu_torch.core.filters import ColumnFilter, Equals

    res = shard.lookup_partitions(
        [ColumnFilter("_metric_", Equals(metric))], 0, 2**62)
    tags = [shard.partitions[int(p)].tags for p in res.part_ids]
    pods = sorted({t["pod"] for t in tags})
    gix = {p: i for i, p in enumerate(pods)}
    return res.part_ids, [gix[t["pod"]] for t in tags], pods, tags


# the range functions of the grid's second op set: (function name,
# function arguments, reads timestamps)
SECOND_FUNCS = (
    ("IRATE", (), True), ("IDELTA", (), True), ("DERIV", (), True),
    ("PREDICT_LINEAR", (600.0,), True), ("TIMESTAMP", (), True),
    ("CHANGES", (), False), ("RESETS", (), False),
    ("STDDEV_OVER_TIME", (), False), ("STDVAR_OVER_TIME", (), False),
    ("Z_SCORE", (), False), ("QUANTILE_OVER_TIME", (0.9,), False),
    ("MAD_OVER_TIME", (), False), ("HOLT_WINTERS", (0.3, 0.6), False))
DENSE_ONLY_FUNCS = ("IRATE", "IDELTA", "CHANGES", "RESETS",
                    "QUANTILE_OVER_TIME", "MAD_OVER_TIME", "HOLT_WINTERS")
PROFILED = ("Q1", "Q2", "Q3", "Q4")


def queries():
    """(name, metric, kind, function, span, kernel, function args)."""
    from filodb_tpu_torch.query.logical import RangeFunctionId as F
    # Q1: 1 h inside block 1 (buckets 140..203); Q2: buckets 96..144,
    # across blocks 0-1
    q1 = (T0 + 144 * STEP, 60)
    q2 = (T0 + 100 * STEP, 45)
    out = [
        ("Q1", "req_total", "grouped", F.RATE, q1, "rate_grid_packed", ()),
        ("Q2", "req_total", "grouped", F.RATE, q2, "rate_grid", ()),
        ("Q3:sum_over_time", "req_total", "series", F.SUM_OVER_TIME, q1,
         "rate_grid_packed", ()),
        ("Q3:max_over_time", "req_total", "series", F.MAX_OVER_TIME, q1,
         "rate_grid_packed", ()),
        ("Q3:instant", "req_total", "series", None, q1,
         "rate_grid_packed", ()),
    ]
    # Q5: the second op set over Q1's span (a packed block; the uniform-
    # phase ts plane is rebuilt for the functions that read it).  It runs
    # before Q4 gives jit_total's series lanes (and rebuilds the blocks).
    for fname, fargs, reads_ts in SECOND_FUNCS:
        out.append((f"Q5:{fname.lower()}", "req_total", "series",
                    getattr(F, fname), q1,
                    "rate_grid" if reads_ts else "rate_grid_packed", fargs))
    out.append(("Q4", "jit_total", "grouped", F.RATE, q2, "rate_grid", ()))
    # Q6: the functions that need no dense contract over gappy lanes
    for fname in ("STDDEV_OVER_TIME", "DERIV", "TIMESTAMP"):
        out.append((f"Q6:{fname.lower()}", "jit_total", "series",
                    getattr(F, fname), q2, "rate_grid", ()))
    return out


def run_query(shard, kind, func, span, looked, fargs=(), served=True):
    """One query through the shard's grid seam; ``looked`` is the
    metric's :func:`lookup` (the part of planning that resolves series
    and groups, done once per metric)."""
    ids, gids, pods, tags = looked
    steps0, nsteps = span
    if kind == "grouped":
        out = shard.scan_grid_grouped(ids, func, steps0, nsteps, STEP,
                                      WINDOW, gids, len(pods), "sum",
                                      fargs=fargs)
    else:
        out = shard.scan_grid(ids, func, steps0, nsteps, STEP, WINDOW,
                              fargs=fargs)
    if (out is not None) != served:
        raise AssertionError(f"{func}: the grid "
                             f"{'did not serve' if served else 'served'}")
    return out


def check_query(name, kind, func, out, looked, ref_out, ref_looked,
                nsteps, device):
    """Finite values of the expected shape on the store's device, and
    the first CHECK_PODS pods' rows against the CPU store's answer."""
    import torch
    _ids, _gids, pods, tags = looked
    _rids, _rgids, ref_pods, ref_tags = ref_looked
    if kind == "grouped":
        for key in ("sum", "count"):
            if out[key].shape != (len(pods), nsteps):
                raise AssertionError(f"{name}: {key} shape "
                                     f"{out[key].shape}")
            if out[key].device != device:
                raise AssertionError(f"{name}: {key} on {out[key].device}")
        if not bool(torch.isfinite(out["sum"]).all()):
            raise AssertionError(f"{name}: non-finite group sums")
        n = min(CHECK_PODS, len(ref_pods))
        if pods[:n] != ref_pods[:n]:
            raise AssertionError(f"{name}: pod order differs")
        if not torch.equal(out["count"][:n].cpu().double(),
                           ref_out["count"][:n].double()):
            raise AssertionError(f"{name}: count differs from the CPU "
                                 f"store")
        return compare(out["sum"][:n], ref_out["sum"][:n], "sum", RTOL_CPU)
    _t, vals, _tops = out
    if vals.shape != (len(tags), nsteps) or vals.device != device:
        raise AssertionError(f"{name}: shape {vals.shape} on {vals.device}")
    keep = [i for i, t in enumerate(tags) if t["pod"] in ref_pods]
    key = [(tags[i]["pod"], tags[i]["instance"]) for i in keep]
    rkey = [(t["pod"], t["instance"]) for t in ref_tags]
    order = sorted(range(len(key)), key=lambda i: key[i])
    rorder = sorted(range(len(rkey)), key=lambda i: rkey[i])
    got = vals[torch.as_tensor([keep[i] for i in order], device=vals.device)]
    want = ref_out[1][torch.as_tensor(rorder)]
    from filodb_tpu_torch.memstore import devicestore
    op = devicestore._GRID_OPS[func]
    return compare(got, want, op, RTOL_CPU, 1 if op in CROSSING else None)


def profile_queries(shard, looked) -> None:
    """One warm run of each query under torch.profiler: host and device
    time by operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for name, metric, kind, func, span, _k, fargs in queries():
        if name.split(":")[0] not in PROFILED:
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_query(shard, kind, func, span, looked[metric], fargs)
            torch.cuda.synchronize()
        log(f"profile {name}:")
        log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=8, max_name_column_width=40))


def main_path(device, seed: int, reps: int, report: dict) -> dict:
    import torch
    from filodb_tpu_torch.memstore import devicestore
    from filodb_tpu_torch.ops import grid

    with Phase("main.ingest"):
        t0 = time.perf_counter()
        _ms, shard, samples = build_store(device, seed, REQ_PODS, JIT_PODS)
        ingest_s = time.perf_counter() - t0
        log(f"ingest: {samples} samples, {shard.num_partitions} series in "
            f"{ingest_s:.3f} s ({samples / ingest_s:.4g} samples/s)")
    with Phase("main.reference_cpu_store"):
        _rms, ref_shard, _n = build_store("cpu", seed, CHECK_PODS, JIT_PODS)

    with Phase("main.lookup"):
        looked, ref_looked = {}, {}
        for metric in ("req_total", "jit_total"):
            t0 = time.perf_counter()
            looked[metric] = lookup(shard, metric)
            log(f"lookup {metric}: {len(looked[metric][0])} series, "
                f"{len(looked[metric][2])} pods in "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
            ref_looked[metric] = lookup(ref_shard, metric)

    plans = {}
    qrows = []
    qlaunch = {}
    with Phase("main.queries"):
        grid.reset_launch_counts()            # the main path's run
        for name, metric, kind, func, span, kern, fargs in queries():
            before = (grid.rate_grid.launches,
                      grid.rate_grid_packed.launches)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = run_query(shard, kind, func, span, looked[metric], fargs)
            b.record()
            b.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            dev_ms = a.elapsed_time(b)
            launched = {
                "rate_grid": grid.rate_grid.launches - before[0],
                "rate_grid_packed":
                    grid.rate_grid_packed.launches - before[1]}
            other = "rate_grid" if kern == "rate_grid_packed" \
                else "rate_grid_packed"
            if launched[kern] < 1 or launched[other] != 0:
                raise AssertionError(f"{name}: expected {kern} only, "
                                     f"launched {launched}")
            cache = next(iter(shard.device_caches.values()))
            plans[name] = plan = list(cache._plan_memo.values())[-1]
            if name == "Q2" and not any(isinstance(v, dict)
                                        for v in plan.val_parts):
                raise AssertionError("Q2 read no packed block: the torch "
                                     "XOR decode did not run")
            ref = run_query(ref_shard, kind, func, span,
                            ref_looked[metric], fargs)
            err = check_query(name, kind, func, out, looked[metric], ref,
                              ref_looked[metric], span[1], device)
            log(f"{name}: first run (block builds included) wall_ms "
                f"{wall:.3f} events_ms {dev_ms:.3f} launches {launched} "
                f"cpu-store check ok (max_abs_err {err:.3e})")
            qrows.append({"query": name, "kernel": kern,
                          "cold_wall_ms": wall, "cold_events_ms": dev_ms,
                          "launches": launched, "cpu_check_err": err})
            qlaunch[name] = launched
        totals = {"rate_grid": grid.rate_grid.launches,
                  "rate_grid_packed": grid.rate_grid_packed.launches}
        for k, n in totals.items():
            if n < 1:
                raise AssertionError(f"{k} never launched on the main "
                                     f"path")
        log(f"main path launches {totals}")
    with Phase("main.dense_only_on_gappy_lanes"):
        from filodb_tpu_torch.query.logical import RangeFunctionId as F
        q2 = next(q for q in queries() if q[0] == "Q2")[4]
        for fname, fargs, _ts in SECOND_FUNCS:
            if fname in DENSE_ONLY_FUNCS:
                for sh, lk in ((shard, looked), (ref_shard, ref_looked)):
                    run_query(sh, "series", getattr(F, fname), q2,
                              lk["jit_total"], fargs, served=False)
        log(f"jit_total (gappy lanes): {len(DENSE_ONLY_FUNCS)} dense-only "
            f"functions not served by either store")
    with Phase("main.warm_queries"):
        for row, (name, metric, kind, func, span, _k, fargs) in zip(
                qrows, queries()):
            walls, evs = [], []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                a.record()
                run_query(shard, kind, func, span, looked[metric], fargs)
                b.record()
                b.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                evs.append(a.elapsed_time(b))
            row["warm_wall_ms"] = statistics.median(walls)
            row["warm_events_ms"] = statistics.median(evs)
            log(f"{name}: warm median of {reps}: wall_ms "
                f"{row['warm_wall_ms']:.3f} events_ms "
                f"{row['warm_events_ms']:.3f}")
    report["queries"] = qrows
    with Phase("main.profile"):
        profile_queries(shard, looked)
    report["ingest_seconds"] = ingest_s
    report["ingest_samples"] = samples

    # each kernel against its plain version on the main path's inputs
    flush = make_flush(device)
    kern_rows = {}
    with Phase("main.kernels_at_path_shapes"):
        for name, plan in plans.items():
            if plan.packed is not None:
                args = (plan.packed, plan.steps0_rel, plan.q,
                        plan.packed_row0, plan.packed_use_phase)
                kname = "rate_grid_packed"
                fn = partial(grid.rate_grid_packed, *args)
                ref = partial(grid.rate_grid_packed_ref, *args)
                work = packed_work(plan.packed, plan.q, plan.packed_row0,
                                   plan.packed_use_phase)
                shape = f"packed {grid.packed_width(plan.packed)} lanes"
            else:
                ts, vals, s0, q, ph = devicestore.series_inputs(plan)
                kname = "rate_grid"
                fn = partial(grid.rate_grid, ts, vals, s0, q, phase=ph)
                ref = partial(grid.rate_grid_ref, ts, vals, s0, q, phase=ph)
                work = grid_work(ts, vals, q, ph)
                shape = f"[{vals.shape[0]}, {vals.shape[1]}]"
            got = fn()
            want = ref()
            torch.cuda.synchronize()
            err = compare(got, want, plan.q.op, RTOL_KERNEL,
                          0 if plan.q.op in CROSSING else None)
            ms = cuda_ms(fn, reps, flush)
            pms = cuda_ms(ref, reps, flush)
            bms, by = bound_ms(*work)
            log(f"{name} {kname} {shape} op={plan.q.op} T={plan.q.nsteps}"
                f": ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} "
                f"({by}, {work[0]} bytes) max_abs_err {err:.3e} ok")
            row = {"query": name, "op": plan.q.op, "ms": ms,
                   "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                   "bytes": work[0], "max_abs_err": err,
                   "launches": qlaunch[name][kname]}
            kern_rows.setdefault(kname, []).append(row)
    report["kernels_at_path_shapes"] = kern_rows
    return {"launches": totals, "rows": kern_rows,
            "stores": (_ms, shard, _rms, looked)}


# ------------------------------------------------------------- phase 5

def engine_queries():
    """(name, PromQL, (first step, steps), ?downsample= pixels, the grid
    kernel it must reach or None for the general path)."""
    q1 = (T0 + 144 * STEP, 60)
    # every step whose window lies inside the grid: the first window
    # covers buckets 0..K-1
    full = (T0 + (K - 1) * STEP, N_ROWS)
    return [
        ("E1", "sum by (pod)(rate(req_total[5m]))", q1, None,
         "rate_grid_packed"),
        ("E2", "rate(req_total[5m])", full, E2_PIXELS, "rate_grid"),
        ("E3", "sum by (pod)(irate(req_total[5m]))", q1, None,
         "rate_grid"),
        ("E4", "stdvar by (pod)(rate(req_total[5m]))", q1, None,
         "rate_grid_packed"),
        ("E5", "quantile_over_time(0.9, req_total[5m])", q1, None,
         "rate_grid_packed"),
        ("E6", "predict_linear(req_total[5m], 600)", q1, None, "rate_grid"),
    ]


def run_engine(ms, query: str, span, pixels):
    """One PromQL range query through the port's entry point: parse ->
    plan -> (DownsampleMapper when ?downsample= is given) -> execute,
    then every batch's values on the host (the API edge).  Returns the
    result, the host values and the wall ms of all that."""
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.parallel.shardmap import ShardMapper
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    from filodb_tpu_torch.query.exec import ExecContext
    from filodb_tpu_torch.query.model import QueryContext
    from filodb_tpu_torch.query.transformers import DownsampleMapper

    t0 = time.perf_counter()
    start, nsteps = span
    qctx = QueryContext(sample_limit=2**40)
    plan = query_range_to_logical_plan(query, start, STEP,
                                       start + (nsteps - 1) * STEP)
    ep = SingleClusterPlanner("prom", ShardMapper(1)).materialize(plan, qctx)
    if pixels:
        ep.add_transformer(DownsampleMapper(pixels))
    res = ep.execute(ExecContext(ms, qctx))
    host = [b.np_values() for b in res.batches]
    return res, host, (time.perf_counter() - t0) * 1e3


def engine_rows(res, host) -> dict:
    """{(pod, instance): row} of a result (instance None for groups)."""
    return {(tags.get("pod"), tags.get("instance")): vals[i]
            for b, vals in zip(res.batches, host)
            for i, tags in enumerate(b.keys)}


def check_engine(name, rows, ref_rows, pixels, rtol) -> float:
    """The card's rows for the CPU store's series (first CHECK_PODS pods)
    against the CPU store's engine answer: the same NaN positions (the
    grouped counts' empty cells, M4's selected steps), finite values
    within ``rtol``."""
    import numpy as np
    import torch
    if not ref_rows or not set(ref_rows) <= set(rows):
        raise AssertionError(f"{name}: the CPU store's series are not all "
                             f"in the card's answer")
    keys = sorted(ref_rows)
    got = np.stack([rows[k] for k in keys]).astype(np.float64)
    want = np.stack([ref_rows[k] for k in keys]).astype(np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{name}: NaN / selected positions differ from "
                             f"the CPU store in "
                             f"{int((np.isnan(got) != np.isnan(want)).sum())}"
                             f" cells")
    if pixels and (np.isfinite(got).sum(axis=1) > 4 * pixels).any():
        raise AssertionError(f"{name}: more than 4 points per pixel bin")
    return compare(torch.as_tensor(got), torch.as_tensor(want), "engine",
                   rtol)


class GroupReduces:
    """Records the op of every on-device group reduce of the grid
    (``devicestore._grouped_reduce_impl``) while it is entered."""

    def __enter__(self):
        from filodb_tpu_torch.memstore import devicestore
        self.ops = []
        self._orig = orig = devicestore._grouped_reduce_impl

        def reduce(stepped, garr, num_groups, op):
            self.ops.append(op)
            return orig(stepped, garr, num_groups, op)

        devicestore._grouped_reduce_impl = reduce
        return self

    def __exit__(self, *exc):
        from filodb_tpu_torch.memstore import devicestore
        devicestore._grouped_reduce_impl = self._orig
        return False


class AggregatorDevices:
    """Records the device of every aggregator's input values, partial
    state and presented values while it is entered: where a query's
    aggregation ran."""

    def __enter__(self):
        from filodb_tpu_torch.query import aggregators
        from filodb_tpu_torch.query.model import to_tensor
        self.seen = set()
        self._saved = []
        for cls in (aggregators.MomentAggregator,
                    aggregators.TopBottomKAggregator):
            orig_map, orig_present = cls.map, cls.present

            def map_(agg, batch, *a, _orig=orig_map):
                self.seen.add(to_tensor(batch.values).device)
                part = _orig(agg, batch, *a)
                self.seen.update(v.device for v in part.state.values())
                return part

            def present(agg, part, _orig=orig_present):
                self.seen.update(to_tensor(v).device
                                 for v in part.state.values())
                out = _orig(agg, part)
                self.seen.add(out.values.device)
                return out

            self._saved.append((cls, orig_map, orig_present))
            cls.map, cls.present = map_, present
        return self

    def __exit__(self, *exc):
        for cls, orig_map, orig_present in self._saved:
            cls.map, cls.present = orig_map, orig_present
        return False


def warm_engine(ms, query: str, span, pixels, reps: int):
    """Median wall ms of ``reps`` warm runs, and the median of each
    ExecContext stage (scan: lookup + grid or scan_batch; device_compute:
    the grid seam's calls) in ms."""
    walls, stages = [], {}
    for _ in range(reps):
        res, _host, wall = run_engine(ms, query, span, pixels)
        walls.append(wall)
        for k, v in res.stats.timings.items():
            stages.setdefault(k, []).append(v * 1e3)
    return statistics.median(walls), {k: round(statistics.median(v), 3)
                                      for k, v in stages.items()}


def engine_phase(device, stores, reps: int, report: dict) -> dict:
    """E1-E6 through parse -> plan -> execute on the main-path store,
    each held against the CPU store's engine answer; E1 also against the
    direct scan_grid_grouped answer, bit for bit."""
    import numpy as np
    import torch
    from filodb_tpu_torch.ops import grid
    from filodb_tpu_torch.query.logical import RangeFunctionId as F

    ms, shard, rms, looked = stores
    kernels = ("rate_grid", "rate_grid_packed", "m4_grid")

    def counts():
        return {k: getattr(grid, k).launches for k in kernels}

    cold_runs = []
    grid.reset_launch_counts()              # the engine path's run
    for _name, query, span, pixels, _kern in engine_queries():
        before = counts()
        with AggregatorDevices() as agg_devices, GroupReduces() as reduces:
            res, host, cold = run_engine(ms, query, span, pixels)
        cold_runs.append((res, engine_rows(res, host), cold,
                          {k: v - before[k] for k, v in counts().items()},
                          agg_devices.seen, reduces.ops))
    totals = counts()
    log(f"engine path launches {totals}")

    rows_out = []
    for (name, query, span, pixels, kern), \
            (res, rows, cold, launched, agg_seen, reduce_ops) in zip(
                engine_queries(), cold_runs):
        want = {k: 0 for k in kernels}
        if kern is not None:
            want[kern] = launched[kern]
            if launched[kern] < 1:
                raise AssertionError(f"{name}: {kern} never launched "
                                     f"({launched})")
        if pixels:
            want["m4_grid"] = 1
        if launched != want:
            raise AssertionError(f"{name}: launches {launched}, expected "
                                 f"{want}")
        if query.startswith("stdvar") and reduce_ops != ["moments"]:
            raise AssertionError(f"{name}: group reduces {reduce_ops}, "
                                 f"expected the fused moments reduce")
        # every result but the downsampled one (a host array after the
        # host selection) stays on the card, and so does the aggregation
        where = {getattr(b.values, "device", "host") for b in res.batches}
        if not pixels and where != {device}:
            raise AssertionError(f"{name}: the result is on {where}, not "
                                 f"{device}")
        if agg_seen - {device}:
            raise AssertionError(f"{name}: aggregation ran on {agg_seen}")
        where = ", ".join(sorted(str(w) for w in where))
        for k, v in rows.items():
            if v.shape != (span[1],):
                raise AssertionError(f"{name}: row {k} shape {v.shape}")
        rtol = RTOL_MOMENTS if query.startswith("stdvar") else RTOL_CPU
        err = check_engine(name, rows,
                           engine_rows(*run_engine(rms, query, span,
                                                   pixels)[:2]), pixels, rtol)
        if name == "E1":
            direct = run_query(shard, "grouped", F.RATE, span,
                               looked["req_total"])
            dcount = direct["count"].cpu().numpy()
            dsum = direct["sum"].cpu().numpy()
            pods = looked["req_total"][2]
            for (pod, _i), row in rows.items():
                g = pods.index(pod)
                exp = np.where(dcount[g] > 0, dsum[g], np.nan)
                if not np.array_equal(row, exp, equal_nan=True):
                    raise AssertionError(f"E1: pod {pod} differs from the "
                                         f"direct scan_grid_grouped answer")
            log("E1: equals the direct scan_grid_grouped answer bit for bit "
                f"({len(rows)} pods)")
        warm, stages = warm_engine(ms, query, span, pixels, reps)
        log(f"{name} {query!r} steps={span[1]}"
            f"{f' downsample={pixels}' if pixels else ''}: {len(rows)} "
            f"series, result on {where}, aggregation on "
            f"{sorted(str(d) for d in agg_seen) or 'none'}, device group "
            f"reduces {reduce_ops or 'none'}, launches {launched}, cold "
            f"wall_ms "
            f"{cold:.3f} (stages {res.stats.timings}), warm wall_ms (median "
            f"of {reps}) {warm:.3f} (stage ms {stages}), cpu-store check "
            f"ok (max_abs_err {err:.3e})")
        row = {"query": name, "promql": query, "steps": span[1],
               "pixels": pixels, "launches": launched,
               "group_reduces": reduce_ops, "cold_wall_ms": cold,
               "cold_stage_seconds": res.stats.timings, "warm_wall_ms": warm,
               "warm_stage_ms": stages, "cpu_check_err": err}
        if pixels:
            # the same query without ?downsample=: the difference is the
            # DownsampleMapper (upload, m4_grid, readback, host selection)
            row["warm_wall_ms_without_downsample"], _ = warm_engine(
                ms, query, span, None, reps)
            log(f"{name} without downsample: warm wall_ms "
                f"{row['warm_wall_ms_without_downsample']:.3f}")
        rows_out.append(row)
    report["engine"] = rows_out

    # m4_grid against its plain version at E2's own input: the grid's
    # [S, T] rate answer, time-major on the card
    name, query, span, pixels, _k = engine_queries()[1]
    _tags, vals, _ = shard.scan_grid(looked["req_total"][0], F.RATE,
                                     span[0], span[1], STEP, WINDOW)
    x = vals.T.contiguous()
    err = check_m4(x, pixels)
    flush = make_flush(device)
    ms_k = cuda_ms(lambda: grid.m4_grid(x, pixels), REPS, flush)
    pms = cuda_ms(lambda: grid.m4_grid_ref(x, pixels), REPS, flush)
    work = m4_work(x.shape[0], x.shape[1], pixels)
    bms, by = bound_ms(*work)
    log(f"{name} m4_grid [{x.shape[0]}, {x.shape[1]}] P={pixels}: ms "
        f"{ms_k:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} ({by}, {work[0]} "
        f"bytes) bit-equal ok")
    m4_row = {"query": name, "ms": ms_k, "plain_ms": pms, "bound_ms": bms,
              "bound_by": by, "bytes": work[0], "max_abs_err": err}
    report["m4_at_path_shape"] = m4_row
    return {"launches": totals, "m4": m4_row}


# ------------------------------------------------------------- phase 6

# the launches of each north-star query: one per class plane, and each
# of these packs is one plane
NORTHSTAR_LAUNCHES = {
    "dense": {"rate_grid_grouped": 1},
    "packed": {"rate_grid_grouped_packed": 1},
    "hist": {"hist_grid_grouped_packed": 1},
    "topk": {"rate_grid_packed": 2},
}


def check_northstar_output(name: str, out, case) -> str:
    """Finite values of the expected shape on the card; returns a note."""
    import torch
    if name in ("dense", "packed"):
        s, c = out
        shape = (case.vals.shape[1] // case.group_lanes, case.q.nsteps)
        if s.shape != shape or c.shape != shape or s.device != c.device:
            raise AssertionError(f"{name}: shapes {s.shape} {c.shape}")
        if not bool(torch.isfinite(s).all()):
            raise AssertionError(f"{name}: non-finite group sums")
        per = int(torch.isfinite(case.vals[0]).sum()) // shape[0]
        if not bool((c == per).all()):
            raise AssertionError(f"{name}: counts {int(c.min())}.."
                                 f"{int(c.max())}, expected {per}")
        return f"[{shape[0]}, {shape[1]}] sums finite, {per} series a group"
    if name == "hist":
        if out.shape != (case.groups, case.q.nsteps):
            raise AssertionError(f"hist: shape {out.shape}")
        fin = int(torch.isfinite(out).sum())
        if fin == 0:
            raise AssertionError("hist: no finite quantile")
        return (f"[{out.shape[0]}, {out.shape[1]}] quantiles, {fin} finite "
                f"(the gate held the rest's NaN pattern)")
    vals, idx = out
    if vals.shape != (case.ql.nsteps, case.k) or idx.shape != vals.shape:
        raise AssertionError(f"topk: shapes {vals.shape} {idx.shape}")
    if not bool(torch.isfinite(vals).all()) or \
            not bool(((idx >= 0) & (idx < case.groups)).all()):
        raise AssertionError("topk: exhausted ranks or slots out of range")
    if not bool((vals[:, :-1] >= vals[:, 1:]).all()):
        raise AssertionError("topk: ranks not in descending order")
    return f"[{vals.shape[0]}, {vals.shape[1]}] ranks, slots in range"


def northstar_phase(device, seed: int, reps: int, report: dict,
                    widths=None) -> dict:
    """The fused north-star path at the benchmark's widths (``widths``,
    default ``northstar.BENCH``): the four variants' data, packs and
    gates; their queries once with the launch counters reset just before
    and read just after; each new kernel against its plain version and
    timed; each query timed."""
    import torch
    from filodb_tpu_torch import northstar as ns
    from filodb_tpu_torch.ops import grid

    widths = widths or ns.BENCH
    setups = {"dense": ns.setup_dense, "packed": ns.setup_packed,
              "hist": ns.setup_hist, "topk": ns.setup_topk}
    queries = {"dense": ns.query_dense, "packed": ns.query_packed,
               "hist": ns.query_hist, "topk": ns.query_topk}
    cases = {}
    for name, setup in setups.items():
        with Phase(f"northstar.setup_{name}"):
            t0 = time.perf_counter()
            cases[name] = case = setup(seed, device, widths)
            torch.cuda.synchronize()
            log(f"northstar {name}: data, packs and gates passed in "
                f"{time.perf_counter() - t0:.3f} s (host pack_vals "
                f"{getattr(case, 'pack_seconds', 0.0):.3f} s)")

    rows = {}
    with Phase("northstar.queries"):
        grid.reset_launch_counts()          # the north-star path's run
        for name, fn in queries.items():
            before = grid.launch_counts()
            out = fn(cases[name])
            torch.cuda.synchronize()
            launched = {k: v - before[k]
                        for k, v in grid.launch_counts().items()
                        if v != before[k]}
            if launched != NORTHSTAR_LAUNCHES[name]:
                raise AssertionError(f"northstar {name}: launches "
                                     f"{launched}, expected "
                                     f"{NORTHSTAR_LAUNCHES[name]}")
            note = check_northstar_output(name, out, cases[name])
            log(f"northstar {name}: launches {launched}, {note}")
            rows[name] = {"launches": launched}
        totals = grid.launch_counts()
        log(f"northstar path launches {totals}")

    flush = make_flush(device)
    kern_rows = {}
    with Phase("northstar.kernels"):
        d, p, h = (cases[k] for k in ("dense", "packed", "hist"))
        s0 = ns.steps0()
        dense = (None, d.vals, s0, d.q, d.group_lanes)
        packed = (p.planes, s0, p.q, p.group_lanes)
        hist = (h.planes, s0, h.q, h.hb, h.group_lanes)
        for kname, fn, ref, work in (
                ("rate_grid_grouped",
                 partial(grid.rate_grid_grouped, *dense, phase=d.phase),
                 partial(grid.rate_grid_grouped_ref, *dense, phase=d.phase),
                 grouped_work(d.vals, d.q, d.phase,
                              d.vals.shape[1] // d.group_lanes)),
                ("rate_grid_grouped_packed",
                 partial(grid.rate_grid_grouped_packed, *packed),
                 partial(grid.rate_grid_grouped_packed_ref, *packed),
                 grouped_packed_work(p.planes, p.q, 0, True,
                                     p.vals.shape[1] // p.group_lanes)),
                ("hist_grid_grouped_packed",
                 partial(grid.hist_grid_grouped_packed, *hist),
                 partial(grid.hist_grid_grouped_packed_ref, *hist),
                 grouped_packed_work(h.planes, h.q, 0, True,
                                     h.groups * h.hb))):
            err = compare_grouped(fn(), ref(), f"northstar {kname}")
            ms = cuda_ms(fn, reps, flush)
            pms = cuda_ms(ref, reps, flush)
            bms, by = bound_ms(*work)
            log(f"northstar {kname}: ms {ms:.4f} plain_ms {pms:.4f} bound_ms "
                f"{bms:.4f} ({by}, {work[0]} bytes) max_abs_err {err:.3e} "
                f"ok")
            kern_rows[kname] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                                "bound_by": by, "bytes": work[0],
                                "max_abs_err": err}
    with Phase("northstar.second_ops"):
        second = northstar_second_ops(cases, reps, flush)
    with Phase("northstar.query_times"):
        for name, fn in queries.items():
            case = cases[name]
            qms = cuda_ms(partial(fn, case), reps, flush)
            rate = case.samples / (qms * 1e-3)
            log(f"northstar {name} samples/s {rate:.6g} ({case.samples} "
                f"samples a query, device ms {qms:.4f})")
            rows[name].update(query_ms=qms, samples=case.samples,
                              samples_per_s=rate)
    report["northstar"] = {"queries": rows, "kernels": kern_rows,
                           "launches": totals, "second_ops": second}
    return {"launches": totals, "rows": kern_rows, "second_ops": second}


def northstar_second_ops(cases, reps: int, flush) -> list:
    """The grouped kernels in the second op set at the benchmark's widths,
    on the data the north-star variants hold: rate_grid_grouped in the 13
    ops (the five that read timestamps over the dense variant's ts plane),
    rate_grid_grouped_packed and hist_grid_grouped_packed in the 8 that
    read none; each once against its plain version (its launches counted
    on that call), then timed."""
    from filodb_tpu_torch import northstar as ns
    from filodb_tpu_torch.ops import grid

    d, p, h = (cases[k] for k in ("dense", "packed", "hist"))
    s0 = ns.steps0()

    def with_op(q, op):
        farg, farg2 = FARGS.get(op, (0.0, 0.0))
        return q._replace(op=op, is_rate=False, farg=farg, farg2=farg2)

    runs = []        # (wrapper, plain version, arguments, work)
    for op in TS_SECOND_OPS + FREE_SECOND_OPS:
        q = with_op(d.q, op)
        ts = d.ts if op in TS_SECOND_OPS else None
        runs.append((grid.rate_grid_grouped, grid.rate_grid_grouped_ref,
                     (ts, d.vals, s0, q, d.group_lanes),
                     grouped_work(d.vals, q, None,
                                  d.vals.shape[1] // d.group_lanes)))
    for op in FREE_SECOND_OPS:
        q = with_op(p.q, op)
        runs.append((grid.rate_grid_grouped_packed,
                     grid.rate_grid_grouped_packed_ref,
                     (p.planes, s0, q, p.group_lanes, 0, False),
                     grouped_packed_work(p.planes, q, 0, False,
                                         p.vals.shape[1] // p.group_lanes)))
        q = with_op(h.q, op)
        runs.append((grid.hist_grid_grouped_packed,
                     grid.hist_grid_grouped_packed_ref,
                     (h.planes, s0, q, h.hb, h.group_lanes, 0, False),
                     grouped_packed_work(h.planes, q, 0, False,
                                         h.groups * h.hb)))
    rows = []
    for fn, ref, args, work in runs:
        kname = fn.__name__
        op = next(a for a in args if isinstance(a, grid.GridQuery)).op
        before = fn.launches
        got = fn(*args)
        launched = fn.launches - before
        err = compare_grouped(got, ref(*args), f"northstar {kname} {op}", op)
        ms = cuda_ms(partial(fn, *args), reps, flush)
        pms = cuda_ms(partial(ref, *args), reps, flush)
        bms, by = bound_ms(*work)
        log(f"northstar {kname} {op}: launches {launched} ms {ms:.4f} "
            f"plain_ms {pms:.4f} bound_ms {bms:.4f} ({by}, {work[0]} bytes) "
            f"max_abs_err {err:.3e} ok")
        rows.append({"kernel": kname, "op": op, "launches": launched,
                     "ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by, "bytes": work[0], "max_abs_err": err})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the full report as JSON here")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "filodb_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "filodb_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 3
    from filodb_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    report: dict = {}
    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        log(f"device: {kind} (torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
        log(f"nvidia-smi: {smi}")
        report["device"] = {"name": kind, "nvidia_smi": smi}
    with Phase("build"):
        t0 = time.perf_counter()
        kernels.library()
        build_s = time.perf_counter() - t0
        log(f"build seconds {build_s:.3f}")
        for line in ptxas_summary(kernels.build_log):
            log(f"  grid_kernels.cu: {line}")
        report["build_seconds"] = build_s
        report["build_log"] = kernels.build_log
    with Phase("kernels"):
        sweep_err = kernel_sweep(device, REPS, args.seed, report)
        sweep_err = max(sweep_err, grouped_sweep(device, REPS, args.seed,
                                                 report))
        log(f"kernel sweep: every case within tolerance (max_abs_err "
            f"{sweep_err:.3e})")
    with Phase("main"):
        main = main_path(device, args.seed, REPS, report)
    with Phase("engine"):
        engine = engine_phase(device, main.pop("stores"), ENGINE_REPS,
                              report)
    with Phase("northstar"):
        northstar = northstar_phase(device, args.seed, REPS, report)
    entries = kernel_entries(main, engine, northstar, report)
    report["kernels"] = entries
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_entries(main: dict, engine: dict, northstar: dict,
                   report: dict) -> list:
    """The ``{"kernels": [...]}`` record: each kernel at the input of its
    primary query (rate_grid at Q2, rate_grid_packed at Q1, m4_grid at
    E2, the grouped kernels at the north-star widths), with its launches
    on the path that runs it."""
    primary = {"rate_grid": "Q2", "rate_grid_packed": "Q1"}
    replaces = {"rate_grid": "filodb_tpu/ops/grid.py:848",
                "rate_grid_packed": "filodb_tpu/ops/grid.py:1086",
                "m4_grid": "filodb_tpu/ops/grid.py:1694",
                "rate_grid_grouped": "filodb_tpu/ops/grid.py:906",
                "rate_grid_grouped_packed": "filodb_tpu/ops/grid.py:1134",
                "hist_grid_grouped_packed": "filodb_tpu/ops/grid.py:1270"}
    path_rows = {k: next(r for r in main["rows"][k]
                         if r["query"] == primary[k]) for k in primary}
    path_rows["m4_grid"] = engine["m4"]
    path_rows.update(northstar["rows"])
    launches = {**main["launches"],
                "m4_grid": engine["launches"]["m4_grid"],
                **{k: northstar["launches"][k] for k in northstar["rows"]}}
    sweep = (report["kernel_sweep"] + report["grouped_sweep"]
             + northstar["second_ops"])
    entries = []
    for kname in replaces:
        row = path_rows[kname]
        errs = [r["max_abs_err"] for r in main["rows"].get(kname, [row])]
        errs += [r["max_abs_err"] for r in sweep if r["kernel"] == kname]
        entries.append({
            "name": kname, "route": "cuda",
            "source": "filodb_tpu_torch/csrc/grid_kernels.cu",
            "replaces": replaces[kname],
            "launches": launches[kname],
            "max_abs_err": max(errs + [row["max_abs_err"]]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    return entries


if __name__ == "__main__":
    sys.exit(main())
