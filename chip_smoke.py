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
   ``rate_grid_packed`` at a mid shape (B=128, S=16384, K=5), each held
   against its plain PyTorch version run on the same CUDA tensors;
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
   on the inputs the main path gave it, and timed.

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
RTOL_KERNEL = 2e-5              # sums / rate chain, kernel vs plain
RTOL_CPU = 1e-5                 # card (f32) vs CPU store (f64)
SELECTION = ("last", "min", "max", "count")


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
    report["kernel_sweep"] = rows
    return worst


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
                nsteps):
    """Finite values of the expected shape, and the first CHECK_PODS
    pods' rows against the CPU store's answer."""
    import numpy as np
    import torch
    _ids, _gids, pods, tags = looked
    _rids, _rgids, ref_pods, ref_tags = ref_looked
    if kind == "grouped":
        for key in ("sum", "count"):
            if out[key].shape != (len(pods), nsteps):
                raise AssertionError(f"{name}: {key} shape "
                                     f"{out[key].shape}")
        if not np.isfinite(out["sum"]).all():
            raise AssertionError(f"{name}: non-finite group sums")
        n = min(CHECK_PODS, len(ref_pods))
        if pods[:n] != ref_pods[:n]:
            raise AssertionError(f"{name}: pod order differs")
        if not np.array_equal(out["count"][:n], ref_out["count"][:n]):
            raise AssertionError(f"{name}: count differs from the CPU "
                                 f"store")
        return compare(torch.as_tensor(out["sum"][:n]),
                       torch.as_tensor(ref_out["sum"][:n]), "sum",
                       RTOL_CPU)
    _t, vals, _tops = out
    if vals.shape != (len(tags), nsteps):
        raise AssertionError(f"{name}: shape {vals.shape}")
    keep = [i for i, t in enumerate(tags) if t["pod"] in ref_pods]
    key = [(tags[i]["pod"], tags[i]["instance"]) for i in keep]
    rkey = [(t["pod"], t["instance"]) for t in ref_tags]
    order = sorted(range(len(key)), key=lambda i: key[i])
    rorder = sorted(range(len(rkey)), key=lambda i: rkey[i])
    got = vals[np.asarray(keep)[order]]
    want = ref_out[1][np.asarray(rorder)]
    from filodb_tpu_torch.memstore import devicestore
    return compare(torch.as_tensor(got), torch.as_tensor(want),
                   devicestore._GRID_OPS[func], RTOL_CPU)


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
                              ref_looked[metric], span[1])
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
    return {"launches": totals, "rows": kern_rows}


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

    primary = {"rate_grid": "Q2", "rate_grid_packed": "Q1"}
    replaces = {"rate_grid": "filodb_tpu/ops/grid.py:848",
                "rate_grid_packed": "filodb_tpu/ops/grid.py:1086"}
    entries = []
    for kname in ("rate_grid", "rate_grid_packed"):
        rows = main["rows"][kname]
        row = next(r for r in rows if r["query"] == primary[kname])
        entries.append({
            "name": kname, "route": "cuda",
            "source": "filodb_tpu_torch/csrc/grid_kernels.cu",
            "replaces": replaces[kname],
            "launches": main["launches"][kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
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


if __name__ == "__main__":
    sys.exit(main())
