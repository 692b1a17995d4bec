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
   ``rate_grid_packed`` at a mid shape (B=128, S=16384, K=5), and
   ``m4_grid`` at [T=103, S=16,421] with P=10 and P=50 (gaps, ties, tied
   zeros of both signs, all-NaN bins, an all-NaN series), each held
   against its plain PyTorch version run on the same CUDA tensors (m4
   bit for bit);
4. main    — one shard of ``prom-counter`` data at high cardinality
   (``req_total``: 100 pods x 1,024 series, 260 one-minute samples,
   constant per-series phase, integer increments 0-9, a reset in 1% of
   series; ``jit_total``: 8,192 series with +-30 s per-sample jitter),
   ingested through ``ingest_container``, then four queries through
   ``scan_grid``/``scan_grid_grouped``:
     Q1 sum by (pod)(rate(req_total[5m])), 1 h inside block 1 (fully
        covered, packed) -> packed kernel, phase mode;
     Q2 the same over a span crossing blocks 0-1 -> XOR decode + rate_grid
        kernel, phase mode;
     Q3 sum_over_time, max_over_time and the instant selector over
        req_total -> packed kernel, free mode;
     Q4 sum by (pod)(rate(jit_total[5m])) -> rate_grid kernel, ts mode.
   Launch counters show each query went through its kernel; each query's
   rows for the first 8 pods are held against a CPU store that ingests
   only those pods; one warm run of each query is profiled
   (torch.profiler); each kernel is then held against its plain version
   on the inputs the main path gave it, and timed;
5. engine  — the same store through the query engine's entry point
   (PromQL -> query_range_to_logical_plan -> SingleClusterPlanner ->
   ExecPlan.execute), launch counters reset just before and read just
   after the four queries' first runs:
     E1 sum by (pod)(rate(req_total[5m])) over Q1's span -> the packed
        kernel, equal bit for bit to the direct scan_grid_grouped answer;
     E2 rate(req_total[5m]) over all 260 steps with DownsampleMapper(32)
        -> rate_grid, then one m4_grid launch;
     E3 sum by (pod)(irate(req_total[5m])) -> no grid kernel: the general
        path (scan_batch, ops/windows, aggregators) on the card;
     E4 stdvar by (pod)(rate(req_total[5m])) -> the packed kernel serves
        the rate leaf, the general path's aggregator (the grid does not
        reduce moments) reduces it;
   each against the CPU store's engine answer (rtol 1e-5, E4 2e-4; NaN
   and selected positions equal), cold and warm wall ms; every result but
   E2's downsampled one, and every aggregation, on the card; then m4_grid
   against its plain version at E2's own [260, 102,400] input, timed.

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
CHECK_PODS = 8
MID_SERIES = 16384              # phase 3's mid shape: B=128 x S
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
REPS = 20                       # timed repetitions (median)
ENGINE_REPS = 5                 # warm repetitions of each engine query
RTOL_KERNEL = 2e-5              # sums / rate chain, kernel vs plain
RTOL_CPU = 1e-5                 # card (f32) vs CPU store (f64)
# E4's stdvar is sumsq/n - mean^2 over 1,024 f32 rates summed in no fixed
# order (index_add_): the difference cancels ~12x here, and an f32 sum in
# the worst order is off by up to 7e-5 of the variance
RTOL_MOMENTS = 2e-4
SELECTION = ("last", "min", "max", "count", "m4")
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


# ------------------------------------------------------------- comparison

def compare(got, want, op: str, rtol: float) -> float:
    """Raise unless ``got`` matches ``want``: the same NaN/finite mask,
    selection ops bit-equal, the rest within ``rtol``.  Returns the
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
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"{op}: NaN masks differ")
    if not fin.any():
        raise AssertionError(f"{op}: no finite output to compare")
    diff = (g[fin] - w[fin]).abs()
    err = float(diff.max())
    if op in SELECTION:
        if err != 0.0:
            raise AssertionError(f"{op}: selection op differs by {err}")
    elif not bool((diff <= rtol * w[fin].abs()).all()):
        rel = float((diff / w[fin].abs().clamp_min(1e-30)).max())
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
    the collapsed phase formula (~12), or K accumulations."""
    if q.op in ("rate", "increase", "delta"):
        return 25
    return 2 * q.kbuckets


def grid_work(ts, vals, q, phase) -> tuple[int, int]:
    """(bytes, ops) one rate_grid call must move and do: the rows the
    query's windows cover ((T-1)*stride + K), the ts plane's same rows or
    the [S] phase row, and the [T, S] output."""
    from filodb_tpu_torch.ops import grid
    ns = vals.shape[1]
    rows = grid._rows_needed(q)
    nbytes = rows * ns * 4 + q.nsteps * ns * 4
    mode = grid._mode_for(q, phase)
    if mode == "ts":
        nbytes += rows * ns * 4
    elif mode == "phase":
        nbytes += ns * 4
    corr = 3 if q.op in ("rate", "increase") else 0
    ops = rows * ns * corr + q.nsteps * ns * _ops_per_output(q)
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
    for mode, dense, op in (
            [("phase", True, o) for o in ("rate", "increase", "delta")]
            + [("ts", d, o) for d in (True, False)
               for o in ("rate", "increase", "delta")]
            + [("free", d, o) for d in (True, False)
               for o in ("sum", "count", "avg", "min", "max", "last")]):
        ts_np, v_np, ph_np = planes[not dense]
        ts = torch.as_tensor(ts_np, device=device)
        vals = torch.as_tensor(v_np, device=device)
        ph = torch.as_tensor(ph_np, device=device) \
            if mode == "phase" else None
        for stride in (1, 2):
            q = grid.GridQuery(nsteps=(B - K) // stride + 1, kbuckets=K,
                               gstep_ms=STEP, is_rate=(op == "rate"),
                               op=op, dense=dense, stride=stride)
            steps0 = K * STEP
            got = grid.rate_grid(ts, vals, steps0, q, phase=ph)
            want = grid.rate_grid_ref(ts, vals, steps0, q, phase=ph)
            torch.cuda.synchronize()
            err = compare(got, want, op, RTOL_KERNEL)
            worst = max(worst, err)
            ms = cuda_ms(lambda: grid.rate_grid(ts, vals, steps0, q,
                                                phase=ph), reps, flush)
            pms = cuda_ms(lambda: grid.rate_grid_ref(ts, vals, steps0, q,
                                                     phase=ph), reps, flush)
            bms, by = bound_ms(*grid_work(ts, vals, q, ph))
            name = (f"rate_grid {mode}-{'dense' if dense else 'gappy'}-"
                    f"{op} stride={stride}")
            log(f"{name}: ms {ms:.4f} plain_ms {pms:.4f} bound_ms "
                f"{bms:.4f} ({by}) max_abs_err {err:.3e} ok")
            rows.append({"kernel": "rate_grid", "case": name, "ms": ms,
                         "plain_ms": pms, "bound_ms": bms,
                         "max_abs_err": err})
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
                             "last")]):
            row0 = 3
            q = grid.GridQuery(nsteps=(B - row0 - K) // 2 + 1, kbuckets=K,
                               gstep_ms=STEP, is_rate=(op == "rate"),
                               op=op, dense=dense, stride=2)
            got = grid.rate_grid_packed(packed, 0, q, row0=row0,
                                        use_phase=use_phase)
            want = grid.rate_grid_packed_ref(packed, 0, q, row0=row0,
                                             use_phase=use_phase)
            torch.cuda.synchronize()
            err = compare(got, want, op, RTOL_KERNEL)
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
                         "ms": ms, "plain_ms": pms, "bound_ms": bms,
                         "max_abs_err": err})
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
    if jitter:
        ts = (T0 + rows[None, :] * STEP + 30_000
              + rng.integers(-29_999, 30_000, (POD_SERIES, N_ROWS)))
    else:
        ts = T0 + rows[None, :] * STEP + phase[:, None]
    b = RecordBuilder(schema)
    for s in range(POD_SERIES):
        b.add_series(ts[s], [vals[s].astype(np.float64)],
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


def queries():
    from filodb_tpu_torch.query.logical import RangeFunctionId as F
    # Q1: 1 h inside block 1 (buckets 140..203); Q2: buckets 96..144,
    # across blocks 0-1
    q1 = (T0 + 144 * STEP, 60)
    q2 = (T0 + 100 * STEP, 45)
    return [
        ("Q1", "req_total", "grouped", F.RATE, q1, "rate_grid_packed"),
        ("Q2", "req_total", "grouped", F.RATE, q2, "rate_grid"),
        ("Q3:sum_over_time", "req_total", "series", F.SUM_OVER_TIME, q1,
         "rate_grid_packed"),
        ("Q3:max_over_time", "req_total", "series", F.MAX_OVER_TIME, q1,
         "rate_grid_packed"),
        ("Q3:instant", "req_total", "series", None, q1,
         "rate_grid_packed"),
        ("Q4", "jit_total", "grouped", F.RATE, q2, "rate_grid"),
    ]


def run_query(shard, kind, func, span, looked):
    """One query through the shard's grid seam; ``looked`` is the
    metric's :func:`lookup` (the part of planning that resolves series
    and groups, done once per metric)."""
    ids, gids, pods, tags = looked
    steps0, nsteps = span
    if kind == "grouped":
        out = shard.scan_grid_grouped(ids, func, steps0, nsteps, STEP,
                                      WINDOW, gids, len(pods), "sum")
    else:
        out = shard.scan_grid(ids, func, steps0, nsteps, STEP, WINDOW)
    if out is None:
        raise AssertionError(f"{func}: the grid did not serve")
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
    return compare(got, want, devicestore._GRID_OPS[func], RTOL_CPU)


def profile_queries(shard, looked) -> None:
    """One warm run of each query under torch.profiler: host and device
    time by operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for name, metric, kind, func, span, _k in queries():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_query(shard, kind, func, span, looked[metric])
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
    with Phase("main.queries"):
        grid.reset_launch_counts()            # the main path's run
        for name, metric, kind, func, span, kern in queries():
            before = (grid.rate_grid.launches,
                      grid.rate_grid_packed.launches)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = run_query(shard, kind, func, span, looked[metric])
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
                            ref_looked[metric])
            err = check_query(name, kind, func, out, looked[metric], ref,
                              ref_looked[metric], span[1], device)
            log(f"{name}: first run (block builds included) wall_ms "
                f"{wall:.3f} events_ms {dev_ms:.3f} launches {launched} "
                f"cpu-store check ok (max_abs_err {err:.3e})")
            qrows.append({"query": name, "kernel": kern,
                          "cold_wall_ms": wall, "cold_events_ms": dev_ms,
                          "launches": launched, "cpu_check_err": err})
        totals = {"rate_grid": grid.rate_grid.launches,
                  "rate_grid_packed": grid.rate_grid_packed.launches}
        for k, n in totals.items():
            if n < 1:
                raise AssertionError(f"{k} never launched on the main "
                                     f"path")
        log(f"main path launches {totals}")
    with Phase("main.warm_queries"):
        for row, (name, metric, kind, func, span, _k) in zip(qrows,
                                                             queries()):
            walls, evs = [], []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                a.record()
                run_query(shard, kind, func, span, looked[metric])
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
                fn = lambda a=args: grid.rate_grid_packed(*a)  # noqa: E731
                ref = lambda a=args: grid.rate_grid_packed_ref(*a)  # noqa: E731
                work = packed_work(plan.packed, plan.q, plan.packed_row0,
                                   plan.packed_use_phase)
                shape = f"packed {grid.packed_width(plan.packed)} lanes"
            else:
                ts, vals, s0, q, ph = devicestore.series_inputs(plan)
                kname = "rate_grid"
                fn = lambda a=(ts, vals, s0, q, ph): grid.rate_grid(  # noqa: E731
                    *a[:4], phase=a[4])
                ref = lambda a=(ts, vals, s0, q, ph): grid.rate_grid_ref(  # noqa: E731
                    *a[:4], phase=a[4])
                work = grid_work(ts, vals, q, ph)
                shape = f"[{vals.shape[0]}, {vals.shape[1]}]"
            got = fn()
            want = ref()
            torch.cuda.synchronize()
            err = compare(got, want, plan.q.op, RTOL_KERNEL)
            ms = cuda_ms(fn, reps, flush)
            pms = cuda_ms(ref, reps, flush)
            bms, by = bound_ms(*work)
            log(f"{name} {kname} {shape} op={plan.q.op} T={plan.q.nsteps}"
                f": ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} "
                f"({by}, {work[0]} bytes) max_abs_err {err:.3e} ok")
            row = {"query": name, "ms": ms, "plain_ms": pms,
                   "bound_ms": bms, "bound_by": by, "bytes": work[0],
                   "max_abs_err": err}
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
        ("E3", "sum by (pod)(irate(req_total[5m]))", q1, None, None),
        ("E4", "stdvar by (pod)(rate(req_total[5m]))", q1, None,
         "rate_grid_packed"),
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
    """E1-E4 through parse -> plan -> execute on the main-path store,
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
        with AggregatorDevices() as agg_devices:
            res, host, cold = run_engine(ms, query, span, pixels)
        cold_runs.append((res, engine_rows(res, host), cold,
                          {k: v - before[k] for k, v in counts().items()},
                          agg_devices.seen))
    totals = counts()
    log(f"engine path launches {totals}")

    rows_out = []
    for (name, query, span, pixels, kern), \
            (res, rows, cold, launched, agg_seen) in zip(engine_queries(),
                                                         cold_runs):
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
            f"{sorted(str(d) for d in agg_seen) or 'none'}, launches "
            f"{launched}, cold wall_ms "
            f"{cold:.3f} (stages {res.stats.timings}), warm wall_ms (median "
            f"of {reps}) {warm:.3f} (stage ms {stages}), cpu-store check "
            f"ok (max_abs_err {err:.3e})")
        row = {"query": name, "promql": query, "steps": span[1],
               "pixels": pixels, "launches": launched, "cold_wall_ms": cold,
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
        for line in kernels.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  grid_kernels.cu: {line.strip()}")
        report["build_seconds"] = build_s
    with Phase("kernels"):
        sweep_err = kernel_sweep(device, REPS, args.seed, report)
        log(f"kernel sweep: every case within tolerance (max_abs_err "
            f"{sweep_err:.3e})")
    with Phase("main"):
        main = main_path(device, args.seed, REPS, report)
    with Phase("engine"):
        engine = engine_phase(device, main.pop("stores"), ENGINE_REPS,
                              report)
    entries = kernel_entries(main, engine)
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


def kernel_entries(main: dict, engine: dict) -> list:
    """The ``{"kernels": [...]}`` record: each kernel at the input of its
    primary query (rate_grid at Q2, rate_grid_packed at Q1, m4_grid at
    E2), with its launches on the path that runs it."""
    primary = {"rate_grid": "Q2", "rate_grid_packed": "Q1"}
    replaces = {"rate_grid": "filodb_tpu/ops/grid.py:848",
                "rate_grid_packed": "filodb_tpu/ops/grid.py:1086",
                "m4_grid": "filodb_tpu/ops/grid.py:1694"}
    path_rows = {k: next(r for r in main["rows"][k]
                         if r["query"] == primary[k]) for k in primary}
    path_rows["m4_grid"] = engine["m4"]
    launches = {**main["launches"],
                "m4_grid": engine["launches"]["m4_grid"]}
    entries = []
    for kname in ("rate_grid", "rate_grid_packed", "m4_grid"):
        row = path_rows[kname]
        errs = [r["max_abs_err"] for r in main["rows"].get(kname, [row])]
        entries.append({
            "name": kname, "route": "cuda",
            "source": "filodb_tpu_torch/csrc/grid_kernels.cu",
            "replaces": replaces[kname],
            "launches": launches[kname],
            "max_abs_err": max(errs),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    return entries


if __name__ == "__main__":
    sys.exit(main())
