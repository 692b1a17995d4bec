#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``filodb_tpu_torch``) on one NVIDIA card
and check it end to end.

    python3 chip_smoke.py [--seed N] [--out report.json]

Phases, each timed on a line of its own:

1. device  — the card's name, and its name and power limit from
   ``nvidia-smi``;
2. build   — ``nvcc`` builds the CUDA kernels from ``filodb_tpu_torch/
   csrc/grid_kernels.cu``, ``csrc/hist_staged.cu``,
   ``csrc/grouped_staged.cu``, ``csrc/dense_staged.cu`` and
   ``csrc/series_staged.cu`` (one ``nvcc`` a source, in parallel), on a
   thread while the main path's stores ingest (phase ``stores``: phase
   4's ``main.ingest``, ``main.reference_cpu_store`` and
   ``main.hist_ingest``, which launch no kernel of the library);
3. kernels — every op/mode of ``rate_grid`` and every class plane of
   ``rate_grid_packed`` at a mid shape (B=128, S=16384, K=5): all 22 ops
   of the TPU kernels, each in every mode the TPU kernel serves it, at
   strides 1 and 2 (``rate_grid_packed`` over the 14 ops that read no
   timestamps), plus quantile at K=32 with phi 0.9, 0.5 and 1.5 and
   irate at K=1024 over a 1,100-row plane (the direct kernel: no ring
   holds its step); then kernels.b1_sweep: ``rate_grid`` case by case
   over planes of 4,196 and 1,030 lanes (last tiles of 100 and 6 lanes,
   rows 16-byte aligned and not), every op in every mode, dense and
   gappy, strides 1 and 2, T = 1 and 2, each case at the wrapper's plan,
   the staged kernel's for the ops the plan sends to the direct kernel,
   and the largest ring, bit for bit against the direct kernel on the
   same tensors, K = 120 windows on the direct kernel; then
   kernels.b1_batch: ``rate_grid_batch`` (B1 with a member axis) case by
   case over the same planes, batches of 8 and 3 members at even start
   rows, a staged op in each mode, dense and gappy, the direct kernel's
   irate and stddev and K = 100 windows that no ring holds: one launch a
   batch, each member bit for bit its own solo ``rate_grid`` launch, the
   batch within rtol 2e-5 of ``rate_grid_batch_ref``; ``m4_grid`` at
   [T=103, S=16,421] with P=10 and P=50 (gaps, ties, tied
   zeros of both signs, all-NaN bins, an all-NaN series); then
   kernels.b3_sweep: ``rate_grid_packed`` case by case over 256-row packs
   of 4,096 lanes (p8 + p16 + raw, p8 + p16 + p32, a gappy pack, and
   planes cut to rows that are not 16-byte multiples), row0 0, 1 and
   127, strides 1 and 3, K 2, 5, 32 and (free, gappy) 64, every op it
   serves, a K = 120 window (wider than a 32-bit plane's ring),
   quantile and mad over windows with a NaN inside (held to the card's
   insertion-sort semantics), one launch a call, bit for bit but rate and
   increase (rtol 2e-5); then the
   grouped kernels at the mid shape, in all 22 ops of their TPU kernels:
   ``rate_grid_grouped`` in every op/mode (gappy lanes, strides 1 and 2,
   512-lane groups, the last one all-NaN, quantile at K=32 and with phi
   1.5) and case by case (b2_sweep: groups of 64, 38, 512 and 1,024
   lanes, strides 1 and 2, both ring layouts of the staged kernel, every
   op in every mode, bit for bit against its direct kernel on the same
   tensors, T = 804 where the direct kernel runs fewer warps, K = 120
   windows on the direct kernel), ``rate_grid_grouped_packed`` over a p8
   plane and a p16 plane of
   whole groups (the phase ops and the 14 that read no timestamps, row0
   = 3, stride 2) and case by case (b4_sweep: p8, p16 and p32 planes,
   groups of 64, 512 and 1,024 lanes, row0 0, 3 and 40, strides 1 and
   2, every op it serves, bit for bit against its direct kernel on the
   same tensors, a K = 120 window on the direct kernel),
   ``hist_grid_grouped_packed`` case by case (b5_sweep:
   hb 4, 16, 20 and 160, row0 0, 3, 20 and 40 on p16 and p8 planes,
   strides 1 and 2, a dead series, every op it serves, groups of either
   lane tile of the staged kernel, a K = 120 window on the direct kernel,
   sums bit for bit but rate and increase); each held against its plain
   PyTorch version run on the same CUDA tensors (m4 bit for bit, grouped
   counts equal, sums rtol 2e-5), and the packed grouped kernels refusing
   the 5 ops that read timestamps;
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
        lanes) -> rate_grid; the 7 dense-only functions answer None there;
     Q7 rate(lat[5m]) per series over Q1's span, and increase,
        sum_over_time and the instant selector: the histogram metric
        ``lat`` (100 pods x 640 series x 16 cumulative buckets, 1,024,000
        bucket columns, 260 rows, a reset of every bucket in 1% of
        series; encoded in bulk by worker processes, its bytes checked
        against RecordBuilder's) served from the hist grid cache, block 1
        packed at stride 16 -> packed kernel, [S, T, 16];
     Q8 sum by (pod)(rate(lat[5m])) over Q2's span -> XOR decode +
        rate_grid over 1,024,000 columns, then the 1,600-slot bucket-wise
        group sum (one-hot matmul; timed alone with its peak memory).
   Launch counters show each query went through its kernel (exactly one
   rate_grid_packed launch a packed query, every class plane in it; a
   rate_grid launch on the direct kernel only where its plan stages
   nothing); each
   query's rows for the first 8 pods are held against a CPU store that ingests
   only those pods, of the counters and of ``lat`` (rtol 1e-5;
   deriv, idelta and zscore, which cross 0, of each series' largest
   answer); each hist query is served by the hist cache (its hits rise);
   warm runs build no block; one warm run of Q1-Q4, Q7 and Q8 is profiled
   (torch.profiler); each warm query's median of 10 is printed with its
   p10 and p90; each kernel is then held against its plain version
   on the inputs the main path gave it, and timed (rate_grid beside its
   direct kernel on the same inputs, with the route its plan takes);
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
     E7 histogram_quantile(0.99, sum(rate(lat[5m]))) -> the packed kernel
        over the hist cache, the 16-slot bucket-wise sum on the card; its
        bucket sums (all 64,000 series) within 1e-5 of the plain
        reference the encoding workers compute (the general path's rate
        over each pod's own counts, summed), each quantile within the
        bound that 1e-5 on the buckets gives it;
   E1-E6 each against the CPU store's engine answer (rtol 1e-5, E4 2e-4; NaN
   and selected positions equal), cold and warm wall ms; every result but
   E2's downsampled one, and every aggregation, on the card; then m4_grid
   against its plain version at E2's own [260, 102,400] input, timed;
5b. batch  — co-arrival batching over the same store: a
   ``QueryBatcher`` (groups of up to 8) on the shard, the members'
   queries released together from threads by one barrier: Q2's ``sum by
   (pod)(rate(req_total[5m]))`` over blocks 0-1 with eight starts a step
   apart, Q4 (``jit_total``, ts mode) with four, per-series rate with
   eight, then eight engine queries from PromQL text with deadlines
   minted; each at the reference's 3 ms window first (what forms there
   is recorded: the members' host work runs one at a time under the
   GIL), then at 1.5 times its members' solo calls in turn; a group
   takes a few rounds to form
   whole, and then ran ONE ``rate_grid_batch`` launch and no
   ``rate_grid`` launch; every member equals its solo answer bit for bit
   (a group-reduced answer within 1e-6 where the batched GEMM took other
   bits); the batch metrics count the groups and members, the kernel
   ledger the wrappers' launches; no fallback for an error, the breaker
   closed; the batched launch at M = 8 and 4 against M solo launches and
   its plain version, and each group's wall against its members' solo
   calls in turn;
6. northstar — ``filodb_tpu_torch/northstar.py``'s four variants at the
   benchmark's widths (bench.py's dense, compressed_resident,
   histogram_quantile and gdelt_topk): data made on the card from the
   seed, host packs (timed), every gate; the four queries once with the
   launch counters reset just before and read just after (exactly one
   rate_grid_grouped, one rate_grid_grouped_packed, one
   hist_grid_grouped_packed and two rate_grid_packed launches); each new
   kernel against its plain version at those widths and timed (the
   staged rate_grid_grouped, rate_grid_grouped_packed and
   hist_grid_grouped_packed with no launch of their direct kernels on the
   path); rate_grid_packed at the
   topk query's two launches, timed beside the query; the grouped
   kernels in the
   second op set on the same data (13 ops on
   rate_grid_grouped, the 5 that read timestamps over the dense
   variant's ts plane; 8 each on rate_grid_grouped_packed and
   hist_grid_grouped_packed), each against its plain version, its
   launches counted (none direct), and timed; each query's device ms and
   samples/s;
7. durable — persistence, integrity and flush, after every other phase
   (none of them may see its quarantine): ``req_total`` (100 pods x
   1,024 series, 260 rows, the main store's data) encoded as one
   container set a pod an hour of rows (60, 60, 60, 60, 20), in
   DURABLE_WORKERS processes started before the build (the encoding
   overlaps the ``nvcc`` runs), streamed time-major into store A
   (``DiskColumnStore``/``DiskMetaStore`` over sqlite files, StoreConfig
   at its defaults) through ``ingest_stream``'s FlushScheduler (1 h, 2
   threads); A crashes after hour 3 (the scheduler drains and closes
   without flushing what is buffered); ``read_raw_partitions`` over every part key must decode to
   exactly the samples each group's checkpoint covers, the checkpoints
   must be the offsets the flushes snapshotted, and ``verify_chunks``
   must pass every row; store B recovers (``recover_index``,
   ``prepare_recovery``, the stream from the resume offset through a new
   scheduler) and serves D1, ``sum by (pod)(rate(req_total[5m]))`` and
   per-series ``rate`` over the last hour on ``rate_grid`` (blocks 0-1
   of the recovered grid; its cold run through the engine, whose
   residency delta must be positive and equal the ledger's change, and
   0 on the warm repeat), against a CPU twin that runs the first
   CHECK_PODS pods through the same sequence (its chunk rows equal the
   card's); a byte of one of B's chunks is flipped on disk, the
   read-back drops and quarantines it, the next query (D2) evicts the
   grid's blocks and re-stages without it (``rate_grid`` again), pod 0
   loses that series' samples in the chunk's span, and the engine
   counts ``corrupt_chunks_excluded`` 1 inside the window and 0 outside;
   D3 and D4 serve B's history through backfill, then evict every
   partition and page it back (see ``history_queries`` and
   ``paged_grid_queries``); D5: A downsamples every flush at 1 min and
   1 h on the card (the period reduce in f64, every launch timed by the
   kernel ledger), a watermark ledger samples it (each group's flushed
   watermark its last snapshot, the checkpoint the meta store's, B's
   groups starting there), one traced series logs exactly its rows and
   freezes; D5b, the batch job over the first DS_BATCH_TASKS tasks of
   A's first flush round, equals what
   those flushes published, row for row; the ledger over D1 reconciles
   with the wrappers' counts; a DownsampledTimeSeriesStore on the card
   serves the 1 min dataset from the grid (B1) and the 1 h one on the
   general path, against the CPU over the same ds rows, and keeps each
   counter's increase;
8. rollup  — in a process of its own on the same card, beside the
   durable phase (the two share no store; neither one's kernel timings
   share the card with the other's work): the live rollup tiers: the
   durable phase's hourly
   container sets (the first ROLLUP_HOURS hours) fed hour by hour into
   a fresh store on the card (an
   in-memory column store), a ``RollupEngine`` at the default ladder (1
   min / 15 min / 1 h) on its flush listener, ``run_once`` after each
   hour's flush (tick seconds, the engine's stages, records emitted per
   tier, the ``griddown.period_reduce`` ledger row), then the 15 min
   and 1 h tier datasets' own flush; after each hour, and once more
   with no new data, a dashboard refreshed through the result cache
   below the router (``CacheDashboard``: RC1, ``sum by (pod)(rate(
   req_total[1h]))`` over the R queries' range under ``auto``, and RC2,
   ``sum by (pod)(rate(req_total[5m]))`` at the hour's last sample
   through an instant window), each answer held to the uncached
   router's at the same moment (RC1 bit for bit; RC2, whose window
   state sums on the general path where the uncached answer takes B1
   and the grid's f64 reduce, within rtol 2e-5 with the cells that
   differ shown), the last refresh hitting every closed
   whole segment of its cached legs and recomputing none, its samples
   scanned the cache's recomputed ones plus the legs it passed through,
   every cache's byte ledger reconciled, the uncached router run twice
   against itself bit for bit (RC1 and RC2), B1's launches in the
   refreshes equal to the kernel ledger's, the RC walls cached and
   uncached; the fixed-order group sum timed against ``index_add_`` on
   the 15 min tier leg's own inputs, repeating its bits and equal to the
   CPU's; no open period
   emitted, each series' newest record in its last closed period and
   ``rolled_through`` the oldest of them, the first CHECK_PODS pods'
   records equal to ``BatchDownsampler``'s over the same raw chunks bit
   for bit; then ``sum by (pod)(rate(req_total[1h]))`` at a 15 min
   step through the ``RollupRouterPlanner`` (R1 auto: the 15 min tier
   stitched to raw at the live edge; R2 pinned raw; R3 pinned raw under
   a 1 ms raw retention: the 1 min tier stitched to raw past its
   watermark), each leg's path (grid or general), the raw leg on
   B1 or B3, against a CPU twin over the first CHECK_PODS pods' rows
   (rtol 1e-5), the wrappers' launches equal to the kernel ledger's.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
them; without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
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
# the histogram metric ``lat`` (prom-histogram): 100 pods x 640 series x
# 16 cumulative buckets = 1,024,000 bucket columns, the JAX package's own
# device-histogram size (benches/bench_histogram_device.py:47)
HIST_PODS = 100
HIST_SERIES = 640
# Prometheus-style latency buckets in seconds, the last one +Inf
HIST_TOPS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             25.0, 50.0, 100.0, 250.0, float("inf"))
HIST_Q = 0.99                   # E7's quantile
HIST_WORKERS = 6                # processes that encode the hist pods
DURABLE_WORKERS = 3             # ... the durable stream, beside the build
MID_SERIES = 16384              # phase 3's mid shape: B=128 x S
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
REPS = 3                        # timed repetitions (median)
SWEEP_PLAIN_REPS = 1            # timed runs of a sweep case's plain version
ENGINE_REPS = 3                 # warm repetitions of each engine query
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
ENGINE_SPAN = (T0 + 144 * STEP, 60)  # E1, E3-E7: windows inside block 1


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
    from filodb_tpu_torch.utils import devicewatch
    # the kernel ledger off: a sampled launch waits for its events inside
    # the pair
    was = devicewatch.enabled()
    devicewatch.set_enabled(False)
    try:
        return _cuda_ms(fn, reps, flush)
    finally:
        devicewatch.set_enabled(was)


def _cuda_ms(fn, reps: int, flush) -> float:
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


def spread(xs) -> tuple[float, float]:
    """(p10, p90) of repeated timings, beside their median: how far a
    warm query moves within one run."""
    if len(xs) < 2:
        return xs[0], xs[0]
    q = statistics.quantiles(xs, n=10, method="inclusive")
    return q[0], q[-1]


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
    compare-exchanges (2 ops each; mad then merges its deviations, 3 ops
    a row), or K accumulations."""
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
        # mad: the deviations (2 ops each) and their merge (1)
        extra = 3 * K if q.op == "mad" else 0
        return 2 * len(grid.batcher_pairs(K)) + 2 * K + 4 + extra
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
                                                 phase=ph), SWEEP_PLAIN_REPS,
                      flush)
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
                packed, 0, q, row0=row0, use_phase=use_phase),
                SWEEP_PLAIN_REPS, flush)
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
        pms = cuda_ms(lambda: grid.m4_grid_ref(vals, pixels),
                      SWEEP_PLAIN_REPS, flush)
        bms, by = bound_ms(*m4_work(M4_T, S, pixels))
        name = f"m4_grid T={M4_T} S={S} P={pixels}"
        log(f"{name}: ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} "
            f"({by}) bit-equal ok")
        rows.append({"kernel": "m4_grid", "case": name, "ms": ms,
                     "plain_ms": pms, "bound_ms": bms, "max_abs_err": err})
    report["kernel_sweep"] = rows
    return worst


def compare_bits(got, want, case: str) -> float:
    """Raise unless ``got`` and ``want`` hold the same NaN cells and the
    same 32 bits in every other cell; returns 0.0."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{case}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    nan = torch.isnan(want)
    same = torch.isnan(got) == nan
    same &= (got.view(torch.int32) == want.view(torch.int32)) | nan
    if not bool(same.all()):
        raise AssertionError(f"{case}: {int((~same).sum())} cells differ "
                             f"from the reference's bits")
    return 0.0


def sort_ops_insertion(win, op: str, q):
    """quantile / mad over windows ``win [N, K]`` (f32 numpy) as the card
    computes them: an insertion sort that moves a value only past larger
    ones (so a NaN stops it where it stands), interpolation at the
    host's ranks in f32, and for mad the same over |x - median| in sorted
    order.  The plain version's sorting network spreads a NaN instead, so
    a NaN inside a window (not in its row 0) is held to this model."""
    import numpy as np
    from filodb_tpu_torch.ops import grid

    def isort(s):
        s = s.copy()
        idx = np.arange(s.shape[0])
        for i in range(1, s.shape[1]):
            v = s[:, i].copy()
            pos = np.full(s.shape[0], i)
            moving = np.ones(s.shape[0], bool)
            for j in range(i - 1, -1, -1):
                moving &= s[:, j] > v
                s[moving, j + 1] = s[moving, j]
                pos[moving] = j
            s[idx, pos] = v
        return s

    def interp(s, phi):
        lo, hi, w_lo, w_hi, fill = grid._interp_weights(phi, s.shape[1])
        if lo < 0:
            return np.full(s.shape[0], fill, np.float32)
        if lo == hi:
            return s[:, lo]
        return s[:, lo] * np.float32(w_lo) + s[:, hi] * np.float32(w_hi)

    with np.errstate(invalid="ignore", over="ignore"):
        s = isort(win)
        med = interp(s, q.farg if op == "quantile" else 0.5)
        if op == "mad":
            med = interp(isort(np.abs(s - med[:, None])), 0.5)
    return np.where(np.isfinite(win[:, 0]), med, np.float32(np.nan))


B3_ROWS = 256            # row0 127 + (T - 1) * 3 + 64 <= 256
B3_T = 20
B3_SERIES = 4096


def b3_packs(rng) -> dict:
    """The B3 sweep's packs of B3_ROWS x B3_SERIES counters: "dense" (no
    NaN: constants -> p8, counters -> p16, noise -> raw, three class
    planes), "dense-p32" (its raw lanes moved to a p32 plane), "gappy"
    (every eighth counter lane 10% missed samples, in a raw plane) and
    "unaligned" (dense's planes cut to 500, 300 and 100 lanes)."""
    import numpy as np
    from filodb_tpu_torch.codecs import xorgrid
    B, S = B3_ROWS, B3_SERIES
    phase = rng.integers(1, STEP, S).astype(np.int32)
    v = (np.cumsum(rng.integers(0, 10, (B, S)), axis=0)
         + rng.integers(0, 10**6, S)[None, :]).astype(np.float32)
    for s in np.flatnonzero(rng.random(S) < 0.01):     # one reset each
        at = rng.integers(1, B)
        v[at:, s] -= v[at - 1, s]
    v[:, :S // 8] = 7.0
    # counters with fractional increments: XOR residuals too wide to pack
    # (rate over a noisy gauge would pile up resets, whose corrections
    # the plain version sums in another order)
    v[:, S // 8:S // 4] = (1e6 + np.cumsum(rng.random((B, S // 8)) * 1e3,
                                           axis=0)).astype(np.float32)
    dense = xorgrid.pack_vals(v, phase=phase)
    g = v.copy()
    lanes = np.arange(S // 4, S, 8)
    g[:, lanes] = np.where(rng.random((B, len(lanes))) < 0.1, np.nan,
                           g[:, lanes])
    gappy = xorgrid.pack_vals(g, phase=phase)
    if dense is None or gappy is None:
        raise AssertionError("a B3 sweep plane did not pack")
    # the same planes cut to widths whose uint8 and uint16 rows are not
    # 16-byte multiples: the kernel stages those with plain loads
    cut = {"p8": 500, "p16": 300, "raw": 100}
    unaligned = {k: np.ascontiguousarray(dense.planes[k][:, :w])
                 for key, w in cut.items()
                 for k in (key, {"p8": "m8", "p16": "m16",
                                 "raw": "mraw"}[key])}
    packs = {"dense": dense.planes, "dense-p32": _to_p32(dense.planes),
             "gappy": gappy.planes, "unaligned": unaligned}
    for name, pd in packs.items():
        classes = [k for k in ("p8", "p16", "p32", "raw")
                   if k in pd and pd[k].shape[1]]
        if name != "gappy" and len(classes) != 3:
            raise AssertionError(f"B3 sweep pack {name}: classes {classes}")
    return packs


def b3_sweep(device, seed: int, report: dict) -> float:
    """rate_grid_packed (B3) against rate_grid_packed_ref, case by case:
    the three word types and a raw plane, in packs of three class planes;
    row0 0, 1 and 127; strides 1 and 3; K 2, 5, 32 and (free, gappy) 64;
    every op B3 serves (the phase ops in phase mode, the six first free
    ops dense and gappy, the eight free ops of the second op set dense,
    the moments gappy); planes whose rows are not 16-byte multiples; a
    window wider than a 32-bit plane's ring (K = 120: those CTAs read
    device memory); quantile and mad over windows with a NaN
    that is not in their row 0 (held to sort_ops_insertion); the five ops
    that read timestamps refused.  Bit for bit, but rate and increase
    (the correction prefix's order) at rtol 2e-5; each case one launch."""
    import numpy as np
    import torch
    from filodb_tpu_torch.codecs import xorgrid
    from filodb_tpu_torch.ops import grid

    rng = np.random.default_rng([seed, 7])
    packs = {k: xorgrid.packed_to_torch(v, device)
             for k, v in b3_packs(rng).items()}
    rows, worst = [], 0.0

    def run(pack_name, q, row0, use_phase):
        nonlocal worst
        packed = packs[pack_name]
        before = grid.rate_grid_packed.launches
        got = grid.rate_grid_packed(packed, 0, q, row0=row0,
                                    use_phase=use_phase)
        launched = grid.rate_grid_packed.launches - before
        want = grid.rate_grid_packed_ref(packed, 0, q, row0=row0,
                                         use_phase=use_phase)
        torch.cuda.synchronize()
        case = (f"b3 {pack_name} {'phase' if use_phase else 'free'}-"
                f"{'dense' if q.dense else 'gappy'}-{q.op} row0={row0} "
                f"stride={q.stride} K={q.kbuckets}")
        if launched != 1:
            raise AssertionError(f"{case}: {launched} launches, expected 1")
        if q.op in ("rate", "increase"):
            err = compare(got, want, q.op, RTOL_KERNEL)
        else:
            err = compare_bits(got, want, case)
        worst = max(worst, err)
        rows.append({"kernel": "rate_grid_packed", "case": case,
                     "op": q.op, "max_abs_err": err})

    first_free = ("sum", "count", "avg", "min", "max", "last")
    for row0 in (0, 1, 127):
        for stride in (1, 3):
            for k in (2, 5, 32, 64):
                q0 = partial(sweep_query, stride=stride, nsteps=B3_T, k=k)
                if k <= 32:
                    for name in ("dense", "dense-p32"):
                        for op in ("rate", "increase", "delta"):
                            run(name, q0(op, True), row0, True)
                        for op in first_free + FREE_SECOND_OPS:
                            run(name, q0(op, True), row0, False)
                for op in first_free + MOMENT_OPS:
                    run("gappy", q0(op, False), row0, False)
    # rows that are not 16-byte multiples
    for row0 in (0, 1, 127):
        for stride in (1, 3):
            q0 = partial(sweep_query, stride=stride, nsteps=B3_T, k=5)
            run("unaligned", q0("rate", True), row0, True)
            for op in ("sum", "mad"):
                run("unaligned", q0(op, True), row0, False)
    # a window wider than the ring of a 32-bit plane: its CTAs read device
    # memory, the uint8 and uint16 planes' stage as before
    for op, use_phase in (("rate", True), ("sum", False), ("last", False)):
        run("dense", sweep_query(op, True, 1, 100, k=120), 3, use_phase)
    # quantile and mad over windows with a NaN inside (the gappy pack
    # under the dense op), held to the insertion-sort model
    packed = packs["gappy"]
    vals = torch.cat([grid.decode_packed_plane(p, m) for p, m, _k
                      in grid._packed_planes(packed)], dim=1).cpu().numpy()
    nan_cells = 0
    for op, k, stride in (("quantile", 5, 1), ("mad", 5, 3),
                          ("quantile", 32, 1), ("mad", 32, 3)):
        q = sweep_query(op, True, stride, B3_T, k=k)
        row0 = 1
        got = grid.rate_grid_packed(packed, 0, q, row0=row0).cpu().numpy()
        win = np.stack([vals[row0 + t * stride:row0 + t * stride + k].T
                        for t in range(B3_T)])          # [T, lanes, K]
        inside = np.isnan(win[..., 1:]).any(-1) & ~np.isnan(win[..., 0])
        want = sort_ops_insertion(win.reshape(-1, k), op, q).reshape(
            B3_T, -1)
        case = f"b3 gappy free-dense-{op} NaN inside K={k} stride={stride}"
        compare_bits(torch.as_tensor(got), torch.as_tensor(want), case)
        nan_cells += int(inside.sum())
        rows.append({"kernel": "rate_grid_packed", "case": case, "op": op,
                     "max_abs_err": 0.0})
    if nan_cells == 0:
        raise AssertionError("b3: no window with a NaN inside")
    for op in TS_SECOND_OPS:
        try:
            grid.rate_grid_packed(packs["dense"], 0,
                                  sweep_query(op, True, 1, B3_T), row0=0)
        except ValueError:
            continue
        raise AssertionError(f"rate_grid_packed accepted op {op}")
    log(f"b3 sweep: {len(rows)} cases bit-equal (rate, increase within "
        f"rtol {RTOL_KERNEL}; max_abs_err {worst:.3e}), {nan_cells} "
        f"windows with a NaN inside, one launch a call, the "
        f"{len(TS_SECOND_OPS)} ops that read timestamps refused")
    report["b3_sweep"] = rows
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
    group of all-NaN lanes, quantile at K = 32 and with phi 1.5) and case
    by case (:func:`b2_sweep`), rate_grid_grouped_packed over a two-plane
    pack (phase and free ops, row0 = 3, stride 2) and case by case
    (:func:`b4_sweep`),
    hist_grid_grouped_packed case by case (:func:`b5_sweep`); the sweeps
    hold the packed ones refusing the ops that read timestamps."""
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
    # B2, B4 and B5, case by case (b2_sweep, b4_sweep, b5_sweep; the
    # packed ones also hold their kernel's refusal of the ops that read
    # timestamps: a packed plane has no ts)
    worst = max(worst, b2_sweep(device, reps, seed, rows, flush))
    worst = max(worst, b4_sweep(device, reps, seed, rows, flush))
    worst = max(worst, b5_sweep(device, reps, seed, rows, flush))
    report["grouped_sweep"] = rows
    return worst


# B5's op cases (use_phase, dense, op): the phase ops, the six first free
# ops, the free ops of the second op set dense, the moments gappy
B5_OPS = ([(True, True, o) for o in ("rate", "increase", "delta")]
          + [(False, True, o) for o in ("sum", "count", "avg", "min", "max",
                                        "last")]
          + [(False, True, o) for o in FREE_SECOND_OPS]
          + [(False, False, o) for o in MOMENT_OPS])
B5_ROWS = 128
B5_PER = 16                     # series a group


def b5_pack(rng, hb: int, groups: int, small: bool):
    """A stride pack of ``groups`` groups of B5_PER series x ``hb``
    buckets (B5_ROWS rows; a p8 plane when ``small``, else p16), series
    1 dead, one scrape phase a series."""
    import numpy as np
    from filodb_tpu_torch.codecs import xorgrid
    cols = groups * B5_PER * hb
    v = _counters_np(rng, B5_ROWS, cols, small)
    v[:, hb:2 * hb] = np.nan
    phase = np.repeat(rng.integers(1, STEP, cols // hb), hb)
    hp = xorgrid.pack_vals(v, phase=phase.astype(np.int32),
                           min_width=8 if small else 16, stride=hb)
    key = "p8" if small else "p16"
    if hp is None or not (hp.inv == np.arange(cols)).all() or [
            k for k in ("p8", "p16", "raw")
            if k in hp.planes and hp.planes[k].shape[1]] != [key]:
        raise AssertionError(f"hb={hb}: not an identity {key} stride pack")
    return hp


def compare_grouped_bits(got, want, case: str, op: str) -> float:
    """(sum, count) against a reference's (the plain version's, or the
    direct kernel's): counts equal, sums the same bits in every cell but
    NaN ones (same NaN cells), but rate and increase against the plain
    version (the correction prefix's order: :func:`compare_grouped`)."""
    import torch
    if op in ("rate", "increase"):
        return compare_grouped(got, want, case, op)
    (gs, gc), (ws, wc) = got, want
    if not torch.equal(gc, wc):
        raise AssertionError(f"{case}: counts differ in "
                             f"{int((gc != wc).sum())} cells")
    return compare_bits(gs, ws, case)


def b5_sweep(device, reps: int, seed: int, rows: list, flush) -> float:
    """hist_grid_grouped_packed (B5) against its plain version on the same
    card tensors, case by case (:data:`B5_OPS` in each): hb 4, 16 and 20
    over 48 groups of a p16 plane at row0 0 (rate) and 3, and hb 160 (more
    buckets than a lane tile) over 16 groups, each timed; then, checked
    only: hb 20 at row0 20 and stride 2 (rows beyond a ring stage, and
    T = 52, not a multiple of the bucket-sum chunk); p8 planes at hb 4
    (64-lane groups: the 128-lane tile), 16 and 160, row0 40, strides 1
    and 2; a K = 120 window, whose step fits no ring (the direct kernel:
    ``hist_grid_grouped_packed.direct`` counts it, and nothing else); the
    ops that read timestamps refused.  Sums bit for bit but rate and
    increase (rtol 2e-5), counts equal (:func:`compare_grouped_bits`).
    Raises naming every case that failed."""
    import numpy as np
    import torch
    from filodb_tpu_torch.codecs import xorgrid
    from filodb_tpu_torch.ops import grid

    fn = grid.hist_grid_grouped_packed
    rng = np.random.default_rng([seed, 8])
    packs = {}
    for name, hb, groups, small in (("p16 hb=4", 4, 48, False),
                                    ("p16 hb=16", 16, 48, False),
                                    ("p16 hb=20", 20, 48, False),
                                    ("p16 hb=160", 160, 16, False),
                                    ("p8 hb=4", 4, 48, True),
                                    ("p8 hb=16", 16, 48, True),
                                    ("p8 hb=160", 160, 16, True)):
        packs[name] = (hb, groups, xorgrid.packed_to_torch(
            b5_pack(rng, hb, groups, small), device))
    worst, failed, ncases = 0.0, [], 0

    def run(name, q, row0, use_phase, timed=False, direct=False):
        nonlocal worst, ncases
        hb, groups, pk = packs[name]
        args = (pk, 0, q, hb, B5_PER * hb, row0, use_phase)
        case = (f"hist_grid_grouped_packed {name} row0={row0} "
                f"stride={q.stride} K={q.kbuckets} T={q.nsteps} "
                f"{'phase' if use_phase else 'free'}-"
                f"{'dense' if q.dense else 'gappy'}-{q.op}")
        d0 = fn.direct
        before = fn.launches
        got = fn(*args)
        want = grid.hist_grid_grouped_packed_ref(*args)
        torch.cuda.synchronize()
        ncases += 1
        try:
            if fn.launches - before != 1:
                raise AssertionError(f"{case}: {fn.launches - before} "
                                     f"launches, expected 1")
            if fn.direct - d0 != int(direct):
                raise AssertionError(f"{case}: direct launches "
                                     f"{fn.direct - d0}, expected "
                                     f"{int(direct)}")
            err = compare_grouped_bits(got, want, case, q.op)
        except AssertionError as e:
            failed.append(str(e))
            return
        worst = max(worst, err)
        row = {"kernel": "hist_grid_grouped_packed", "case": case,
               "op": q.op, "max_abs_err": err}
        if timed:
            bms, by = bound_ms(*grouped_packed_work(
                pk, q, row0, use_phase, groups * hb))
            row.update(ms=cuda_ms(partial(fn, *args), reps, flush),
                       plain_ms=cuda_ms(
                           partial(grid.hist_grid_grouped_packed_ref, *args),
                           reps, flush), bound_ms=bms)
            log(f"{case}: ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                f"bound_ms {bms:.4f} ({by}) max_abs_err {err:.3e} ok")
        rows.append(row)

    for name in ("p16 hb=4", "p16 hb=16", "p16 hb=20", "p16 hb=160"):
        run(name, sweep_query("rate", True, 1, B5_ROWS - K + 1), 0, True,
            timed=True)
        for use_phase, dense, op in B5_OPS:
            run(name, sweep_query(op, dense, 1, B5_ROWS - 3 - K + 1), 3,
                use_phase, timed=(op in ("rate", "sum")
                                  or op in FREE_SECOND_OPS
                                  or not dense))
    for use_phase, dense, op in B5_OPS:
        run("p16 hb=20", sweep_query(op, dense, 2, (B5_ROWS - 20 - K) // 2
                                     + 1), 20, use_phase)
    for name in ("p8 hb=4", "p8 hb=16", "p8 hb=160"):
        for stride in (1, 2):
            q0 = partial(sweep_query, stride=stride,
                         nsteps=(B5_ROWS - 40 - K) // stride + 1)
            for use_phase, dense, op in B5_OPS:
                run(name, q0(op, dense), 40, use_phase)
    for op, use_phase in (("rate", True), ("last", False)):
        run("p16 hb=16", sweep_query(op, True, 1, 3, k=120), 3, use_phase,
            direct=True)
    hb, _g, pk = packs["p16 hb=20"]
    for op in TS_SECOND_OPS:
        try:
            fn(pk, 0, sweep_query(op, True, 1, B5_ROWS - K + 1), hb,
               B5_PER * hb, 0, False)
        except ValueError:
            continue
        failed.append(f"hist_grid_grouped_packed accepted op {op}")
    if failed:
        raise AssertionError(f"b5 sweep: {len(failed)} of {ncases} cases "
                             f"failed:\n" + "\n".join(failed))
    log(f"b5 sweep: {ncases} cases, sums bit-equal (rate, increase within "
        f"rtol {RTOL_KERNEL}; max_abs_err {worst:.3e}), counts equal, one "
        f"launch a call, the K = 120 cases on the direct kernel and no "
        f"other, the {len(TS_SECOND_OPS)} ops that read timestamps "
        f"refused")
    return worst


B4_ROWS = 128
B4_WIDTH = 4096                 # lanes a plane
# (group lanes, (row0, stride, T) spans, T 0 for as many steps as the rows
# hold): 64 lanes take the 128-lane tile in one pass, 512 and 1,024 the
# 256-lane tile in 2 and 4 passes; a pass of the full rows lies in the
# ring without wrapping (the linear layout) but on p32 planes at 512 and
# 1,024 lanes, where it wraps the ring; the short spans take 1, 2 and 3
# of a ring's four stages (the linear layout's pads)
B4_GROUPS = ((64, ((0, 1, 0), (3, 2, 0), (40, 1, 0))),
             (512, ((0, 1, 0), (3, 2, 0), (40, 1, 0))),
             (1024, ((0, 1, 0), (3, 1, 0), (3, 2, 0), (40, 1, 0), (40, 2, 0),
                     (0, 1, 20), (3, 1, 6))))


def b4_packs(rng, width: int, rows: int) -> dict:
    """Single-class identity packs of ``rows`` x ``width`` counters, one
    scrape phase a lane: "p8", "p16" (lanes 1-5 dead) and "p32" (the p16
    pack's words widened to 32 bits and shifted into place, so that they
    use bits 7-22 of their words and decode to the same values)."""
    import numpy as np
    from filodb_tpu_torch.codecs import xorgrid
    v16 = _counters_np(rng, rows, width)
    v16[:, 1:6] = np.nan
    packs = {}
    for key, v in (("p8", _counters_np(rng, rows, width, True)),
                   ("p16", v16)):
        pk = xorgrid.pack_vals(v, phase=rng.integers(1, STEP, width)
                               .astype(np.int32), min_width=int(key[1:]))
        if pk is None or not (pk.inv == np.arange(width)).all() or [
                k for k in ("p8", "p16", "raw")
                if k in pk.planes and pk.planes[k].shape[1]] != [key]:
            raise AssertionError(f"B4: not an identity {key} pack")
        packs[key] = {k: pk.planes[k] for k in (key, "m" + key[1:])}
    m = packs["p16"]["m16"].copy()
    words = packs["p16"]["p16"].astype(np.uint32) \
        << m[0].astype(np.uint32)[None, :]
    m[0] = 0
    packs["p32"] = {"p32": words, "m32": m}
    return packs


def grouped_packed_direct(packed: dict, q, group_lanes: int, row0: int,
                          use_phase: bool):
    """rate_grid_grouped_packed's (sum, count) from the direct kernel (the
    library's grouped_packed_launch), one launch a class plane, on the
    wrapper's inputs: what the staged kernel is held to bit for bit."""
    import ctypes
    import torch
    from filodb_tpu_torch.ops import grid, kernels
    planes = grid._grouped_packed_check(packed, q, row0, use_phase,
                                        group_lanes)
    dev = planes[0][0].device
    shape = (grid.packed_width(packed) // group_lanes, q.nsteps)
    s = torch.zeros(shape, dtype=torch.float32, device=dev)
    c = torch.zeros(shape, dtype=torch.float32, device=dev)
    lib, slot0 = kernels.library(), 0
    for p, m, kind in planes:
        nb, n = p.shape
        with torch.cuda.device(dev):
            rc = lib.grouped_packed_launch(
                *grid._plane_pointers(p, m, kind, dev),
                ctypes.c_void_p(s.data_ptr()), ctypes.c_void_p(c.data_ptr()),
                *grid._int32_args(kind, nb, n, group_lanes, 1, slot0, row0,
                                  q.nsteps, q.kbuckets, q.stride, q.gstep_ms,
                                  grid._OP_CODE[q.op], use_phase, q.dense,
                                  q.is_rate),
                *grid._fn_args(q), grid._stream())
        grid._launch_check(rc, "grouped_packed_launch")
        slot0 += n // group_lanes
    return s, c


def b4_sweep(device, reps: int, seed: int, rows: list, flush) -> float:
    """rate_grid_grouped_packed (B4) case by case (:data:`B5_OPS` in
    each) over the :func:`b4_packs` planes (p8, p16, p32) in groups of
    64, 512 and 1,024 lanes (:data:`B4_GROUPS`: both lane tiles of the
    staged kernel, 1, 2 and 4 passes, both ring layouts), row0 0, 3 and
    40, strides 1 and 2:
    one launch a call and none on the direct kernel, counts equal to the
    plain version's and sums within rtol 2e-5 of them
    (:func:`compare_grouped`), and sums and counts bit-equal to the direct
    kernel's on the same tensors (:func:`grouped_packed_direct`,
    :func:`compare_grouped_bits`); a few
    cases timed; then a K = 120 window, whose step fits no ring (the
    direct kernel: ``rate_grid_grouped_packed.direct`` counts it, and
    nothing else), and the ops that read timestamps refused.  Raises
    naming every case that failed."""
    import numpy as np
    import torch
    from filodb_tpu_torch.codecs import xorgrid
    from filodb_tpu_torch.ops import grid

    fn = grid.rate_grid_grouped_packed
    packs = {k: xorgrid.packed_to_torch(v, device)
             for k, v in b4_packs(np.random.default_rng([seed, 9]), B4_WIDTH,
                                  B4_ROWS).items()}
    worst, failed, ncases = 0.0, [], 0
    timed = {("p16", 1024, 0, "rate"), ("p16", 1024, 0, "sum"),
             ("p16", 1024, 0, "stddev"), ("p8", 64, 0, "rate"),
             ("p32", 512, 0, "rate")}

    def run(word, gl, q, row0, use_phase, direct=False):
        nonlocal worst, ncases
        pk = packs[word]
        args = (pk, 0, q, gl, row0, use_phase)
        case = (f"rate_grid_grouped_packed {word} group={gl} row0={row0} "
                f"stride={q.stride} K={q.kbuckets} T={q.nsteps} "
                f"{'phase' if use_phase else 'free'}-"
                f"{'dense' if q.dense else 'gappy'}-{q.op}")
        d0, before = fn.direct, fn.launches
        got = fn(*args)
        want = grid.rate_grid_grouped_packed_ref(*args)
        torch.cuda.synchronize()
        ncases += 1
        try:
            if fn.launches - before != 1:
                raise AssertionError(f"{case}: {fn.launches - before} "
                                     f"launches, expected 1")
            if fn.direct - d0 != int(direct):
                raise AssertionError(f"{case}: direct launches "
                                     f"{fn.direct - d0}, expected "
                                     f"{int(direct)}")
            err = compare_grouped(got, want, case, q.op)
            if not direct:
                compare_grouped_bits(got, grouped_packed_direct(
                    pk, q, gl, row0, use_phase), f"{case} (direct)", "")
        except AssertionError as e:
            failed.append(str(e))
            return
        worst = max(worst, err)
        row = {"kernel": "rate_grid_grouped_packed", "case": case,
               "op": q.op, "max_abs_err": err}
        if (word, gl, row0, q.op) in timed and q.stride == 1:
            bms, by = bound_ms(*grouped_packed_work(
                pk, q, row0, use_phase, grid.packed_width(pk) // gl))
            row.update(
                ms=cuda_ms(partial(fn, *args), reps, flush),
                direct_ms=cuda_ms(partial(grouped_packed_direct, pk, q, gl,
                                          row0, use_phase), reps, flush),
                plain_ms=cuda_ms(partial(grid.rate_grid_grouped_packed_ref,
                                         *args), reps, flush),
                bound_ms=bms)
            log(f"{case}: ms {row['ms']:.4f} direct_ms "
                f"{row['direct_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                f"bound_ms {bms:.4f} ({by}) max_abs_err {err:.3e} ok")
        rows.append(row)

    for word in packs:
        for gl, spans in B4_GROUPS:
            for row0, stride, nsteps in spans:
                nsteps = nsteps or (B4_ROWS - row0 - K) // stride + 1
                for use_phase, dense, op in B5_OPS:
                    run(word, gl, sweep_query(op, dense, stride, nsteps),
                        row0, use_phase)
    for op, use_phase in (("rate", True), ("last", False)):
        run("p16", 1024, sweep_query(op, True, 1, 6, k=120), 3, use_phase,
            direct=True)
    for op in TS_SECOND_OPS:
        try:
            fn(packs["p16"], 0, sweep_query(op, True, 1, B4_ROWS - K + 1),
               1024, 0, False)
        except ValueError:
            continue
        failed.append(f"rate_grid_grouped_packed accepted op {op}")
    if failed:
        raise AssertionError(f"b4 sweep: {len(failed)} of {ncases} cases "
                             f"failed:\n" + "\n".join(failed))
    log(f"b4 sweep: {ncases} cases, sums within rtol {RTOL_KERNEL} of the "
        f"plain version (max_abs_err {worst:.3e}) and bit-equal to the "
        f"direct kernel, counts equal, one launch a call, the K = 120 "
        f"cases on the direct kernel and no other, the "
        f"{len(TS_SECOND_OPS)} ops that read timestamps refused")
    return worst


B2_ROWS = 128
B2_WIDTH = 4096                 # lanes of the planes of 64- to 1,024-lane groups
B2_ODD = 38                     # a group whose rows are not 16-byte aligned
# (group lanes, spans (stride, T), T 0 for as many steps as the rows hold):
# 64 and 38 lanes take the 128-lane tile in one pass, 512 and 1,024 the
# 256-lane tile in 2 and 4 passes; the full rows lie in the ring without
# wrapping (the linear layout) on the 128-lane tile and wrap it on the
# 256-lane one, where the 20-step span is linear
B2_GROUPS = ((64, ((1, 0), (2, 0))), (B2_ODD, ((1, 0), (2, 0))),
             (512, ((1, 0), (2, 0), (1, 20))),
             (1024, ((1, 0), (2, 0), (1, 20))))
# rate_grid_grouped's (mode, dense, op) cases: every op in each mode the
# TPU kernel serves it
B2_OPS = FIRST_OPS_CASES + SECOND_OPS_CASES


def b2_planes(rng, width: int, rows: int = B2_ROWS) -> dict:
    """{gappy: (ts, vals, phase)} numpy planes of :func:`_mid_planes`
    (their last 512 lanes empty), dense and gappy."""
    return {g: _mid_planes(rng, rows, width, g) for g in (False, True)}


def wrapping_plan(group_lanes: int, nsteps: int, kbuckets: int,
                  stride: int, reads_ts: bool = False):
    """rate_grid_grouped's staged plan forced to the ring layout in which
    a pass wraps the ring (the least ring that holds a step; a ts ring
    of the same bytes beside it where the launch ``reads_ts``)."""
    from filodb_tpu_torch.ops import grid
    plan = grid.grouped_staged_plan(group_lanes, nsteps, kbuckets, stride,
                                    1 << 20, 4)
    return plan._replace(shared=plan.shared + plan.ring_bytes) \
        if reads_ts and plan.staged else plan


def grouped_dense_direct(ts, vals, steps0: int, q, group_lanes: int,
                         phase=None):
    """rate_grid_grouped's (sum, count) from the direct kernel (the
    library's rate_grid_grouped_launch) on the wrapper's inputs: what the
    staged kernel is held to bit for bit."""
    import ctypes
    import torch
    from filodb_tpu_torch.ops import grid, kernels
    grid._grouped_check(vals, q, group_lanes)
    nb, ns = vals.shape
    mode, ts_ptr, ph_ptr = grid._dense_pointers(ts, vals, q, phase)
    shape = (ns // group_lanes, q.nsteps)
    s = torch.empty(shape, dtype=torch.float32, device=vals.device)
    c = torch.empty(shape, dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        rc = kernels.library().rate_grid_grouped_launch(
            ctypes.c_void_p(vals.data_ptr()), ts_ptr, ph_ptr,
            ctypes.c_void_p(s.data_ptr()), ctypes.c_void_p(c.data_ptr()),
            *grid._int32_args(nb, ns, group_lanes, q.nsteps, q.kbuckets,
                              q.stride, q.gstep_ms, steps0,
                              grid._OP_CODE[q.op], grid._MODE_CODE[mode],
                              q.dense, q.is_rate),
            *grid._fn_args(q), grid._stream())
    grid._launch_check(rc, "rate_grid_grouped_launch")
    return s, c


def b2_sweep(device, reps: int, seed: int, rows: list, flush) -> float:
    """rate_grid_grouped (B2) case by case (:data:`B2_OPS`: every op in
    every mode it serves, dense and gappy lanes) in groups of 64, 38 (rows
    not 16-byte aligned: plain loads), 512 and 1,024 lanes
    (:data:`B2_GROUPS`: both lane tiles of the staged kernel, 1, 2 and 4
    passes, both ring layouts), strides 1 and 2, each case at its plan
    and, where that is linear, again forced to the wrapping layout: one
    launch a call and none on the direct kernel, counts equal to the
    plain version's and sums within rtol 2e-5 of them
    (:func:`compare_grouped`), sums and counts bit-equal to the direct
    kernel's on the same tensors (:func:`grouped_dense_direct`), the
    all-NaN padding group at count 0; a few cases timed.  Then quantile
    at K = 32 and with phi 1.5 (nothing counted); T = 804, where
    group_shape cuts the direct kernel to seven warps (named, and held to
    it within rtol 2e-5 only); and K = 120 windows, whose step fits no
    ring (the direct kernel: ``rate_grid_grouped.direct`` counts them,
    and nothing else).  Raises naming every case that failed."""
    import contextlib
    import numpy as np
    import torch
    from filodb_tpu_torch.ops import grid

    fn = grid.rate_grid_grouped
    rng = np.random.default_rng([seed, 10])
    on_card = {}
    for width in (B2_WIDTH, B2_ODD * 108):
        on_card[width] = {g: tuple(torch.as_tensor(a, device=device)
                                   for a in p)
                          for g, p in b2_planes(rng, width).items()}
    worst, failed, ncases = 0.0, [], 0
    # the cases timed, at the full span
    timed_cases = {(1024, 1, "phase", "rate"), (1024, 1, "free", "sum"),
                   (1024, 1, "free", "stddev"), (1024, 1, "ts", "deriv"),
                   (64, 1, "phase", "rate")}

    @contextlib.contextmanager
    def forced(plan):
        real = grid.dense_staged_plan
        if plan is not None:
            grid.dense_staged_plan = lambda *a: plan
        try:
            yield
        finally:
            grid.dense_staged_plan = real

    def run(gl, mode, dense, q, width=B2_WIDTH, planes=None, direct=False,
            cut=False, timed=False):
        nonlocal worst, ncases
        ts, vals, ph = planes or on_card[width][not dense]
        args = (ts, vals, q.kbuckets * STEP, q, gl)
        phase = ph if mode == "phase" else None
        reads_ts = grid._mode_for(q, phase) == "ts"
        plan = grid.dense_staged_plan(gl, q.nsteps, q.kbuckets, q.stride,
                                      reads_ts)
        layouts = [None] + ([wrapping_plan(gl, q.nsteps, q.kbuckets,
                                           q.stride, reads_ts)]
                            if plan.linear else [])
        want = grid.rate_grid_grouped_ref(*args, phase=phase)
        ref_direct = None if direct else grouped_dense_direct(
            *args, phase=phase)
        for force in layouts:
            layout = ("direct" if direct else
                      "wrapping" if force or not plan.linear else "linear")
            case = (f"rate_grid_grouped group={gl} stride={q.stride} "
                    f"K={q.kbuckets} T={q.nsteps} {mode}-"
                    f"{'dense' if dense else 'gappy'}-{q.op}"
                    + (f" phi={q.farg}" if q.op == "quantile" else "")
                    + f" {layout}")
            d0, before = fn.direct, fn.launches
            with forced(force):
                got = fn(*args, phase=phase)
            torch.cuda.synchronize()
            ncases += 1
            try:
                if fn.launches - before != 1:
                    raise AssertionError(f"{case}: {fn.launches - before} "
                                         f"launches, expected 1")
                if fn.direct - d0 != int(direct):
                    raise AssertionError(f"{case}: direct launches "
                                         f"{fn.direct - d0}, expected "
                                         f"{int(direct)}")
                err = compare_grouped(got, want, case, q.op)
                if cut:
                    compare_grouped(got, ref_direct, f"{case} (direct, "
                                    f"cut to fewer warps)", q.op)
                elif not direct:
                    compare_grouped_bits(got, ref_direct,
                                         f"{case} (direct)", "")
                if gl <= 512 and (got[1][-1].any() or got[0][-1].any()):
                    raise AssertionError(f"{case}: the all-NaN group "
                                         f"counted")
            except AssertionError as e:
                failed.append(str(e))
                continue
            worst = max(worst, err)
            row = {"kernel": "rate_grid_grouped", "case": case,
                   "op": q.op, "max_abs_err": err}
            if timed and force is None:
                call = partial(fn, *args, phase=phase)
                bms, by = bound_ms(*grouped_work(vals, q, phase,
                                                 vals.shape[1] // gl))
                row.update(
                    ms=cuda_ms(call, reps, flush),
                    direct_ms=cuda_ms(partial(grouped_dense_direct, *args,
                                              phase=phase), reps, flush),
                    plain_ms=cuda_ms(partial(grid.rate_grid_grouped_ref,
                                             *args, phase=phase), reps,
                                     flush),
                    bound_ms=bms)
                log(f"{case}: ms {row['ms']:.4f} direct_ms "
                    f"{row['direct_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                    f"bound_ms {bms:.4f} ({by}) max_abs_err {err:.3e} ok")
            rows.append(row)
        return got

    for gl, spans in B2_GROUPS:
        width = B2_WIDTH if B2_WIDTH % gl == 0 else B2_ODD * 108
        for stride, nsteps in spans:
            full = not nsteps
            nsteps = nsteps or (B2_ROWS - K) // stride + 1
            for mode, dense, op in B2_OPS:
                run(gl, mode, dense, sweep_query(op, dense, stride, nsteps),
                    width,
                    timed=full and (gl, stride, mode, op) in timed_cases)
    for gl in (64, 1024):
        run(gl, "free", True, sweep_query(
            "quantile", True, 1, B2_ROWS - grid.SORT_OPS_MAX_K + 1,
            k=grid.SORT_OPS_MAX_K))
        s, c = run(gl, "free", True, sweep_query(
            "quantile", True, 1, B2_ROWS - K + 1)._replace(farg=1.5))
        if c.any() or s.any():
            failed.append(f"group={gl} quantile phi=1.5 counted an answer")
    # T = 804: 804 * 8 bytes a warp's partials; group_shape runs 7 warps
    cut = {g: tuple(torch.as_tensor(a, device=device) for a in p)
           for g, p in b2_planes(rng, 2048, 808).items()}
    for mode, op in (("phase", "rate"), ("free", "sum")):
        run(1024, mode, True, sweep_query(op, True, 1, 804),
            planes=cut[False], cut=True)
    for mode, op in (("phase", "rate"), ("free", "last")):
        run(1024, mode, True, sweep_query(op, True, 1, 6, k=120),
            direct=True)
    if failed:
        raise AssertionError(f"b2 sweep: {len(failed)} of {ncases} cases "
                             f"failed:\n" + "\n".join(failed))
    log(f"b2 sweep: {ncases} cases, sums within rtol {RTOL_KERNEL} of the "
        f"plain version (max_abs_err {worst:.3e}) and bit-equal to the "
        f"direct kernel (T = 804, where the direct kernel runs fewer warps: "
        f"within rtol {RTOL_KERNEL}), counts equal, the all-NaN groups at "
        f"0, one launch a call, the K = 120 cases on the direct kernel and "
        f"no other")
    return worst


B1_ROWS = 128
# lanes of the sweep's planes: 4,196 (16-byte rows, a last tile of 100
# lanes) and 1,030 (rows that are not 16-byte multiples: the producer's
# plain loads, a last tile of 6 lanes); the last 512 lanes of each empty
B1_WIDTHS = (4196, 1030)
# rate_grid's (mode, dense, op) cases: every op in each mode the TPU
# kernel serves it
B1_OPS = FIRST_OPS_CASES + SECOND_OPS_CASES
# the ops also run at T = 1 and T = 2
B1_SHORT_OPS = (("phase", True, "rate"), ("ts", False, "rate"),
                ("ts", True, "irate"), ("ts", False, "deriv"),
                ("free", False, "sum"), ("free", True, "stddev"))


def b1_planes(rng, rows: int, width: int, gappy: bool):
    """(ts, vals, phase) numpy planes of :func:`_mid_planes` whose lane
    11 resets at row 1 and whose lane 12 misses row 0: the counter
    correction and the forward fill from a lane's first rows."""
    ts, vals, phase = _mid_planes(rng, rows, width, gappy)
    vals[1:, 11] -= vals[1, 11]
    vals[0, 12] = float("nan")
    return ts, vals, phase


def series_direct(ts, vals, steps0: int, q, phase=None):
    """rate_grid's [T, S] from the direct kernel (the library's
    rate_grid_launch) on the wrapper's inputs: what the staged kernel is
    held to bit for bit."""
    import ctypes
    import torch
    from filodb_tpu_torch.ops import grid, kernels
    nb, ns = vals.shape
    mode, ts_ptr, ph_ptr = grid._dense_pointers(ts, vals, q, phase)
    out = torch.empty((q.nsteps, ns), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        rc = kernels.library().rate_grid_launch(
            ctypes.c_void_p(vals.data_ptr()), ts_ptr, ph_ptr,
            ctypes.c_void_p(out.data_ptr()),
            *grid._int32_args(nb, ns, q.nsteps, q.kbuckets, q.stride,
                              q.gstep_ms, steps0, grid._OP_CODE[q.op],
                              grid._MODE_CODE[mode], q.dense, q.is_rate),
            *grid._fn_args(q), grid._stream())
    grid._launch_check(rc, "rate_grid_launch")
    return out


def b1_plans(ns: int, q, mode: str) -> list:
    """The (name, plan) pairs a B1 case runs: the wrapper's plan
    ("planned", or "direct" where it stages nothing); where a ring holds
    the step, the staged kernel at it ("staged", where the wrapper sends
    the op to the direct kernel) and at the largest ring ("ring64": four
    stages of 32 rows, where the plan's ring is smaller)."""
    from filodb_tpu_torch.ops import grid
    plan = grid.series_staged_plan(ns, q.nsteps, q.kbuckets, q.stride, mode,
                                   q.op)
    out = [("planned" if plan.staged else "direct", plan)]
    if not plan.staged:
        plan = grid.series_ring_plan(q.kbuckets, q.stride, mode)
        if not plan.staged:
            return out
        out.append(("staged", plan))
    top = max(grid.SERIES_RING_BYTES)
    if plan.ring_bytes < top:
        out.append(("ring64", grid.SeriesPlan(
            top, plan.shared // plan.ring_bytes * top)))
    return out


def b1_sweep(device, reps: int, seed: int, rows: list, flush) -> float:
    """rate_grid (B1) case by case (:data:`B1_OPS`: every op in every
    mode it serves, dense and gappy lanes) over planes of 4,196 and 1,030
    lanes (:data:`B1_WIDTHS`: last tiles of 100 and 6 lanes, rows 16-byte
    aligned and not; :func:`b1_planes`: a reset at row 1, a missed row
    0), strides 1 and 2 at the full span, and T = 1 and 2
    (:data:`B1_SHORT_OPS`); each case at every plan of :func:`b1_plans`
    (the wrapper's, the staged one for the direct ops, the largest ring;
    every plane of 128 rows wraps the plan's ring): one launch a
    call and none on the direct kernel, within rtol 2e-5 of the plain
    version with the same NaN cells (:func:`compare`), and bit-equal to
    the direct kernel on the same tensors (:func:`series_direct`); a few
    cases timed.  Then K = 120 windows, whose step fits no ring (the
    direct kernel: ``rate_grid.direct`` counts them, and nothing else).
    Raises naming every case that failed."""
    import contextlib
    import numpy as np
    import torch
    from filodb_tpu_torch.ops import grid

    fn = grid.rate_grid
    rng = np.random.default_rng([seed, 11])
    on_card = {w: {g: tuple(torch.as_tensor(a, device=device)
                            for a in b1_planes(rng, B1_ROWS, w, g))
                   for g in (False, True)}
               for w in B1_WIDTHS}
    worst, failed, ncases = 0.0, [], 0
    timed_cases = {("phase", "rate"), ("ts", "deriv"), ("free", "stddev")}

    @contextlib.contextmanager
    def forced(plan):
        real = grid.series_staged_plan
        grid.series_staged_plan = lambda *a, **k: plan
        try:
            yield
        finally:
            grid.series_staged_plan = real

    def run(width, mode, dense, q, timed=False):
        nonlocal worst, ncases
        ts, vals, ph = on_card[width][not dense]
        phase = ph if mode == "phase" else None
        args = (ts, vals, q.kbuckets * STEP, q)
        want = grid.rate_grid_ref(*args, phase=phase)
        ref_direct = series_direct(*args, phase=phase)
        for which, plan in b1_plans(width, q, grid._mode_for(q, phase)):
            case = (f"rate_grid S={width} stride={q.stride} K={q.kbuckets} "
                    f"T={q.nsteps} {mode}-{'dense' if dense else 'gappy'}-"
                    f"{q.op} {which}")
            d0, before = fn.direct, fn.launches
            with forced(plan):
                got = fn(*args, phase=phase)
            torch.cuda.synchronize()
            ncases += 1
            try:
                if fn.launches - before != 1:
                    raise AssertionError(f"{case}: {fn.launches - before} "
                                         f"launches, expected 1")
                direct = int(which == "direct")
                if fn.direct - d0 != direct:
                    raise AssertionError(f"{case}: direct launches "
                                         f"{fn.direct - d0}, expected "
                                         f"{direct}")
                err = compare(got, want, q.op, RTOL_KERNEL,
                              0 if q.op in CROSSING else None)
                compare_bits(got, ref_direct, f"{case} (direct)")
            except AssertionError as e:
                failed.append(str(e))
                continue
            worst = max(worst, err)
            row = {"kernel": "rate_grid", "case": case, "op": q.op,
                   "max_abs_err": err}
            if timed and which == "planned":
                call = partial(fn, *args, phase=phase)
                bms, by = bound_ms(*grid_work(ts, vals, q, phase))
                row.update(
                    ms=cuda_ms(call, reps, flush),
                    direct_ms=cuda_ms(partial(series_direct, *args,
                                              phase=phase), reps, flush),
                    plain_ms=cuda_ms(partial(grid.rate_grid_ref, *args,
                                             phase=phase), reps, flush),
                    bound_ms=bms)
                log(f"{case}: ms {row['ms']:.4f} direct_ms "
                    f"{row['direct_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                    f"bound_ms {bms:.4f} ({by}) max_abs_err {err:.3e} ok")
            rows.append(row)

    for width in B1_WIDTHS:
        for mode, dense, op in B1_OPS:
            for stride in (1, 2):
                q = sweep_query(op, dense, stride,
                                (B1_ROWS - K) // stride + 1)
                run(width, mode, dense, q, timed=width == B1_WIDTHS[0]
                    and stride == 1 and (mode, op) in timed_cases)
        for mode, dense, op in B1_SHORT_OPS:
            for nsteps in (1, 2):
                run(width, mode, dense, sweep_query(op, dense, 1, nsteps))
    for mode, dense, op in (("phase", True, "rate"), ("free", True, "last")):
        run(B1_WIDTHS[0], mode, dense, sweep_query(op, dense, 1, 6, k=120))
    if failed:
        raise AssertionError(f"b1 sweep: {len(failed)} of {ncases} cases "
                             f"failed:\n" + "\n".join(failed))
    log(f"b1 sweep: {ncases} cases, within rtol {RTOL_KERNEL} of the plain "
        f"version (max_abs_err {worst:.3e}) and bit-equal to the direct "
        f"kernel, one launch a call, the K = 120 cases on the direct kernel "
        f"and no other")
    return worst


# B1's member axis (kernels.b1_batch): a staged op in each mode, dense
# and gappy, the direct kernel's irate and stddev, and two ops whose
# step (K = 100) no ring holds; M members a launch, each starting at an
# even row (16-byte aligned at either width)
B1_BATCH_OPS = (("phase", True, "rate", K), ("ts", True, "increase", K),
                ("ts", False, "rate", K), ("free", True, "sum", K),
                ("free", False, "max", K), ("ts", False, "deriv", K),
                ("free", True, "quantile", K), ("ts", True, "irate", K),
                ("free", True, "stddev", K), ("phase", True, "rate", 100),
                ("free", True, "last", 100))
B1_BATCH_MEMBERS = (8, 3)
B1_BATCH_ROW0S = (0, 2, 4, 8, 10, 14, 16, 22)


def b1_batch_members(members: int, rows: int, q_of) -> tuple:
    """A batch of ``members`` over planes of ``rows`` rows: (row0s,
    steps0s, nrows, q), ``q_of(nsteps)`` the case's query at the steps
    the rows left to every member hold; each member's first window ends
    K rows after its first row, as its solo launch's would."""
    row0s = list(B1_BATCH_ROW0S[:members])
    nrows = rows - max(row0s)
    q = q_of(nrows)
    nrows = (q.nsteps - 1) * q.stride + q.kbuckets
    return row0s, [(r + q.kbuckets) * STEP for r in row0s], nrows, q


def b1_batch_cases() -> list:
    """(width, mode, dense, op, K, stride, members) of the b1_batch
    sweep."""
    return [(w, mode, dense, op, k, stride, m)
            for w in B1_WIDTHS for mode, dense, op, k in B1_BATCH_OPS
            for stride in ((1, 2) if k == K else (1,))
            for m in B1_BATCH_MEMBERS]


def b1_batch_sweep(device, seed: int, rows: list) -> float:
    """B1 with a member axis (``rate_grid_batch``) case by case
    (:func:`b1_batch_cases`) over :func:`b1_planes` of 4,196 and 1,030
    lanes: one launch a batch (``rate_grid_batch.launches`` +1, no
    ``rate_grid`` launch; ``.direct`` +1 exactly where the plan stages
    nothing), each member bit for bit its own solo ``rate_grid`` launch
    on its rows of the planes (a contiguous slice), and the batch within
    rtol 2e-5 of ``rate_grid_batch_ref`` with the same NaN cells.
    Raises naming every case that failed."""
    import numpy as np
    import torch
    from filodb_tpu_torch.ops import grid

    rng = np.random.default_rng([seed, 13])
    on_card = {w: {g: tuple(torch.as_tensor(a, device=device)
                            for a in b1_planes(rng, B1_ROWS, w, g))
                   for g in (False, True)}
               for w in B1_WIDTHS}
    bfn, sfn = grid.rate_grid_batch, grid.rate_grid
    worst, failed, ncases = 0.0, [], 0
    for width, mode, dense, op, k, stride, members in b1_batch_cases():
        ts, vals, ph = on_card[width][not dense]
        phase = ph if mode == "phase" else None
        row0s, steps0s, nrows, q = b1_batch_members(
            members, B1_ROWS, lambda n: sweep_query(
                op, dense, stride, (n - k) // stride + 1, k=k))
        plan = grid.series_staged_plan(width, q.nsteps, q.kbuckets,
                                       q.stride, grid._mode_for(q, phase),
                                       q.op)
        case = (f"rate_grid_batch S={width} M={members} stride={stride} "
                f"K={k} T={q.nsteps} {mode}-{'dense' if dense else 'gappy'}"
                f"-{op} {'staged' if plan.staged else 'direct'}")
        ncases += 1
        try:
            b0, d0, s0 = bfn.launches, bfn.direct, sfn.launches
            got = bfn(ts, vals, row0s, steps0s, q, nrows, phase=phase)
            torch.cuda.synchronize()
            if (bfn.launches - b0, sfn.launches - s0) != (1, 0) \
                    or bfn.direct - d0 != int(not plan.staged):
                raise AssertionError(
                    f"{case}: {bfn.launches - b0} batched launches "
                    f"({bfn.direct - d0} direct), {sfn.launches - s0} "
                    f"rate_grid launches")
            for m, (r, st) in enumerate(zip(row0s, steps0s)):
                solo = sfn(None if ts is None else ts[r:r + nrows],
                           vals[r:r + nrows], st, q, phase=phase)
                compare_bits(got[m], solo, f"{case} member {m} (solo)")
            want = grid.rate_grid_batch_ref(ts, vals, row0s, steps0s, q,
                                            nrows, phase=phase)
            err = compare(got, want, op, RTOL_KERNEL,
                          1 if op in CROSSING else None)
        except AssertionError as e:
            failed.append(str(e))
            continue
        worst = max(worst, err)
        rows.append({"kernel": "rate_grid", "case": case, "op": op,
                     "max_abs_err": err})
    if failed:
        raise AssertionError(f"b1_batch sweep: {len(failed)} of {ncases} "
                             f"cases failed:\n" + "\n".join(failed))
    log(f"b1_batch sweep: {ncases} batches, each one launch, every member "
        f"bit-equal to its solo launch, within rtol {RTOL_KERNEL} of the "
        f"plain version (max_abs_err {worst:.3e})")
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

    ts, vals, keep = pod_series(pod, seed, jitter)
    b = RecordBuilder(schema)
    for s in range(POD_SERIES):
        k = keep[s]
        b.add_series(ts[s][k], [vals[s][k].astype(np.float64)],
                     series_tags(metric, pod, s))
    return b.containers()


def series_tags(metric: str, pod: int, s: int) -> dict:
    return {"__name__": metric, "pod": f"pod-{pod:03d}",
            "instance": f"i-{s:04d}", "_ws_": "demo", "_ns_": "app"}


def pod_series(pod: int, seed: int, jitter: bool):
    """One pod's 1,024 series: timestamps and values ``[S, N_ROWS]`` and
    the mask of the rows that are scraped."""
    import numpy as np

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
    return ts, vals, keep


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


def hist_counts(rng, n_series: int):
    """``[n_series, N_ROWS, 16]`` cumulative bucket counts, cumulative in
    ``le`` and over time like Prometheus buckets: each minute a series
    observes Poisson(5-60) requests, spread over the buckets by a bell
    over the bucket index (its centre between the 10 ms and 250 ms
    buckets); a series starts from up to 50,000 earlier observations (so
    every count stays below 2**16: an f32 count that crosses 2**16 within
    a block would take the 32-bit class of the stride-16 pack); 1% of
    series reset every bucket once."""
    import numpy as np
    j = np.arange(len(HIST_TOPS))
    centre = rng.uniform(1.5, 5.0, n_series)[:, None]
    width = rng.uniform(1.0, 2.0, n_series)[:, None]
    p = np.exp(-0.5 * ((j[None, :] - centre) / width) ** 2)
    p /= p.sum(axis=1, keepdims=True)
    cdf = np.minimum(np.cumsum(p, axis=1), 1.0)
    lam = rng.uniform(5.0, 60.0, n_series)[:, None, None]
    inc = rng.poisson(lam * p[:, None, :], (n_series, N_ROWS, len(j)))
    base = np.floor(rng.integers(0, 50_000, n_series)[:, None] * cdf)
    vals = base.astype(np.int64)[:, None, :] \
        + np.cumsum(np.cumsum(inc, axis=2), axis=1)
    reset = np.flatnonzero(rng.random(n_series) < 0.01)
    at = rng.integers(1, N_ROWS, n_series)
    for s in reset:
        vals[s, at[s]:] -= vals[s, at[s] - 1]
    return vals


def _bit_length(v):
    """Bit lengths of non-negative integers below 2**52 (exact through
    f64's exponent)."""
    import numpy as np
    return np.frexp(v.astype(np.float64))[1].astype(np.int64)


def nibble_group_bytes(u):
    """The bytes ``codecs.nibblepack.pack`` writes for each group of 8
    u64 values in ``u`` ``[..., 8]``: a bitmask byte, and for a group
    with a nonzero value a header byte and its nibbles."""
    import numpy as np
    nz = u != 0
    nnz = nz.sum(axis=-1)
    low = u & (~u + np.uint64(1))
    tz = np.where(nz, _bit_length(low) - 1, 64).min(axis=-1)
    lz = np.where(nz, 64 - _bit_length(u), 64).min(axis=-1)
    nib = np.maximum(1, 16 - lz // 4 - tz // 4)
    return np.where(nnz == 0, 1, 2 + (nnz * nib + 1) // 2)


def hist_tags(pod: int, s: int) -> dict:
    return {"__name__": "lat", "pod": f"pod-{pod:03d}",
            "instance": f"i-{s:04d}", "_ws_": "demo", "_ns_": "app"}


def hist_pod_containers(seed: int, pod: int, n_series: int,
                        container_size: int = 1024 * 1024):
    """One pod's ``lat`` series as RecordContainer bytes, encoded in bulk:
    the same bytes as ``RecordBuilder.add`` with one
    ``histcodec.encode_hist_value`` blob a row (two Python calls a row,
    too slow for 16.6 M rows in this script's time limit), checked
    against it by :func:`check_hist_encoder`.
    Each row's 16 zigzag bucket deltas are two NibblePack groups, so one
    ``nibblepack.pack`` over all rows packs every row; each row's share
    of it comes from :func:`nibble_group_bytes`.  Returns (containers,
    counts, phases)."""
    import struct

    import numpy as np
    from filodb_tpu_torch.codecs import nibblepack
    from filodb_tpu_torch.codecs.wire import WireType
    from filodb_tpu_torch.core.histogram import CustomBuckets
    from filodb_tpu_torch.core.record import (canonical_partkey,
                                              partition_hash,
                                              shard_key_hash)
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetOptions

    rng = np.random.default_rng([seed, 2, pod])
    S, R, hb = n_series, N_ROWS, len(HIST_TOPS)
    vals = hist_counts(rng, S)
    phase = rng.integers(1, STEP, S)
    deltas = np.diff(vals, axis=2, prepend=0)
    zz = ((deltas << 1) ^ (deltas >> 63)).astype(np.uint64)
    if int(zz.max()) >= 2**52:
        raise AssertionError("hist deltas too wide for the bulk encoder")
    packed = np.frombuffer(nibblepack.pack(zz.ravel()), np.uint8)
    row_len = nibble_group_bytes(zz.reshape(S * R, hb // 8, 8)).sum(axis=1)
    if int(row_len.sum()) != len(packed):
        raise AssertionError("NibblePack row lengths do not add up")
    opts = DatasetOptions()
    blob_head = (bytes([WireType.HIST_BLOB]) + struct.pack("<H", hb)
                 + CustomBuckets(np.asarray(HIST_TOPS)).serialize())
    keys = []
    for s in range(S):
        tags = hist_tags(pod, s)
        tags[opts.metric_column] = tags.pop("__name__")
        pk = canonical_partkey(tags)
        keys.append((shard_key_hash(tags, opts), partition_hash(tags, opts),
                     struct.pack("<H", len(pk)) + pk))
    tail_len = len(keys[0][2])
    if any(len(k[2]) != tail_len for k in keys):
        raise AssertionError("hist part keys differ in length")
    # a record: this fixed head, the row's packed deltas, the part key
    head = np.dtype([("schema", "<u2"), ("shash", "<u4"), ("phash", "<u4"),
                     ("ts", "<i8"), ("sum", "<f8"), ("count", "<f8"),
                     ("blob_len", "<u2"), ("blob_head", f"V{len(blob_head)}")])
    pre = np.zeros((S, R), head)
    pre["schema"] = DEFAULT_SCHEMAS["prom-histogram"].schema_hash
    pre["shash"] = np.array([k[0] for k in keys])[:, None]
    pre["phash"] = np.array([k[1] for k in keys])[:, None]
    pre["ts"] = T0 + np.arange(R)[None, :] * STEP + phase[:, None]
    pre["sum"] = pre["count"] = vals[:, :, -1]
    pre["blob_len"] = (len(blob_head) + row_len).reshape(S, R)
    pre["blob_head"] = np.frombuffer(blob_head, f"V{len(blob_head)}")[0]
    tails = np.frombuffer(b"".join(k[2] for k in keys),
                          np.uint8).reshape(S, tail_len)
    P = head.itemsize
    rec_len = P + row_len + tail_len
    end = np.cumsum(rec_len)
    start = end - rec_len
    buf = np.empty(int(end[-1]), np.uint8)
    buf[start[:, None] + np.arange(P)] = \
        pre.reshape(-1).view(np.uint8).reshape(-1, P)
    buf[np.repeat(start + P - (np.cumsum(row_len) - row_len), row_len)
        + np.arange(len(packed))] = packed
    buf[(start + P + row_len)[:, None] + np.arange(tail_len)] = \
        np.repeat(tails, R, axis=0)
    # RecordBuilder's framing: as many whole records as fit a container
    out, lo = [], 0
    while lo < len(start):
        hi = max(int(np.searchsorted(end, start[lo] + container_size,
                                     "right")), lo + 1)
        body = buf[start[lo]:end[hi - 1]].tobytes()
        out.append(struct.pack("<I", len(body)) + body)
        lo = hi
    return out, vals, phase


def check_hist_encoder(seed: int) -> None:
    """The bulk encoder's bytes equal ``RecordBuilder.add``'s for the
    first 24 series of pod 0, container by container."""
    import numpy as np
    from filodb_tpu_torch.codecs import histcodec
    from filodb_tpu_torch.core.histogram import CustomBuckets
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS

    size = 64 * 1024
    got, vals, phase = hist_pod_containers(seed, 0, 24,
                                           container_size=size)
    b = RecordBuilder(DEFAULT_SCHEMAS["prom-histogram"], container_size=size)
    buckets = CustomBuckets(np.asarray(HIST_TOPS))
    for s in range(24):
        for t in range(N_ROWS):
            total = float(vals[s, t, -1])
            b.add(T0 + t * STEP + int(phase[s]),
                  (total, total, histcodec.encode_hist_value(buckets,
                                                             vals[s, t])),
                  hist_tags(0, s))
    want = b.containers()
    # the builder's last container is partial; every full one must match
    if len(want) < 2 or got[:len(want) - 1] != want[:-1] \
            or not got[len(want) - 1][4:].startswith(want[-1][4:]):
        raise AssertionError("the bulk hist encoder's bytes differ from "
                             "RecordBuilder's")


def hist_rate_sums(vals, phase, span):
    """E7's plain reference over one pod: ``rate(lat[5m])`` of every
    series and bucket by the general path's range function
    (``query/rangefns``, f64 on the CPU) over the pod's own counts,
    summed over its series: ``[T, B]`` float64."""
    import numpy as np
    import torch
    from filodb_tpu_torch.core.chunk import build_batch
    from filodb_tpu_torch.ops.windows import StepRange
    from filodb_tpu_torch.query import rangefns
    from filodb_tpu_torch.query.logical import RangeFunctionId as F

    S, R, _B = vals.shape
    ts = T0 + np.arange(R, dtype=np.int64)[None, :] * STEP + phase[:, None]
    batch = build_batch(list(ts), [v.astype(np.float64) for v in vals],
                        hist=True, bucket_tops=np.asarray(HIST_TOPS))
    start, n = span
    out = rangefns.apply_range_function(
        batch, StepRange(start, start + (n - 1) * STEP, STEP), WINDOW,
        F.RATE, device="cpu")[:S]
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("the plain E7 reference has a gap")
    return out.sum(dim=0).numpy()


def _hist_pod_task(seed: int, n_series: int, pod: int) -> tuple:
    """A pod's containers, and its share of E7's plain reference.  One
    torch thread a worker: HIST_WORKERS processes share the host's cores
    with the ingest thread, which torch's default of a thread a core
    would starve."""
    import torch
    torch.set_num_threads(1)
    conts, vals, phase = hist_pod_containers(seed, pod, n_series)
    return conts, hist_rate_sums(vals, phase, ENGINE_SPAN)


def _encoder_init() -> None:
    """An encoding worker runs at the lowest scheduling priority of this
    script's processes: it takes the host's cores the phases leave idle
    (the build's, the card's waits) and yields them to the phases'
    own host work."""
    os.nice(19)


class HistPods:
    """``pods`` pods of ``lat`` encoded in a pool of HIST_WORKERS
    processes (one pod a task, seeded by pod), started at once: the
    script starts it before the build, so the encoding runs beside the
    ``nvcc`` processes and the phases before the main path's, and
    :func:`ingest_hist` takes the pods in order as they are done.  Each
    worker also computes its pod's share of E7's plain reference
    (:func:`hist_rate_sums`)."""

    def __init__(self, seed: int, pods: int):
        import multiprocessing

        self.t0 = time.perf_counter()
        self.done_at = None         # seconds from the start to the last pod
        self._left = pods
        self._pool = multiprocessing.get_context("spawn").Pool(
            min(HIST_WORKERS, pods), initializer=_encoder_init)
        task = partial(_hist_pod_task, seed, HIST_SERIES)
        self._res = [self._pool.apply_async(task, (pod,),
                                            callback=self._note_done)
                     for pod in range(pods)]
        self._pool.close()

    def _note_done(self, _result) -> None:
        self._left -= 1             # the pool's one result thread
        if self._left == 0:
            self.done_at = time.perf_counter() - self.t0

    def __iter__(self):
        return (r.get() for r in self._res)

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()


def ingest_hist(shards, pods: HistPods, ref_pods: int):
    """Ingest each encoded pod's containers into ``shards[0]`` and, for
    the first ``ref_pods`` pods, into the rest of ``shards`` as it
    arrives; then flush.  Returns the samples the first shard ingested,
    the seconds each shard spent in ``ingest_container`` with the seconds
    of the flushes last, E7's reference (``[T, B]``, every pod) and the
    seconds spent waiting for the encoding."""
    samples = 0
    offset = 10**6                  # past the counter metrics' offsets
    seconds = [0.0] * (len(shards) + 1)
    ref = 0.0
    waited = 0.0
    it = iter(pods)
    pod = 0
    while True:
        t0 = time.perf_counter()
        try:
            conts, part = next(it)
        except StopIteration:
            break
        waited += time.perf_counter() - t0
        ref = ref + part
        for c in conts:
            n = []
            for i, sh in enumerate(shards[:1 if pod >= ref_pods
                                          else len(shards)]):
                t0 = time.perf_counter()
                n.append(sh.ingest_container(c, offset))
                seconds[i] += time.perf_counter() - t0
            if len(set(n)) != 1:
                raise AssertionError(f"stores ingested {n} samples")
            samples += n[0]
            offset += 1
        pod += 1
    t0 = time.perf_counter()
    for sh in shards:
        sh.flush_all()
    seconds[-1] = time.perf_counter() - t0
    return samples, seconds, ref, waited


def lookup(shard, metric: str, pods=None):
    """(part ids, group id per series by pod, pod names, tags); with
    ``pods``, only the series of the first ``pods`` pods."""
    import numpy as np
    from filodb_tpu_torch.core.filters import ColumnFilter, Equals

    res = shard.lookup_partitions(
        [ColumnFilter("_metric_", Equals(metric))], 0, 2**62)
    ids = res.part_ids
    tags = [shard.partitions[int(p)].tags for p in ids]
    names = sorted({t["pod"] for t in tags})
    if pods is not None:
        keep = [i for i, t in enumerate(tags) if t["pod"] in names[:pods]]
        ids = np.asarray(ids)[keep]
        tags = [tags[i] for i in keep]
        names = names[:pods]
    gix = {p: i for i, p in enumerate(names)}
    return ids, [gix[t["pod"]] for t in tags], names, tags


def grid_cache(shard, hist: bool):
    """The shard's grid cache of the counter metrics or of ``lat``."""
    return next(c for c in shard.device_caches.values() if c.hist == hist)


def hist_hits(shard) -> int:
    """The hits of the shard's histogram grid caches: how many queries
    they served."""
    return sum(c.hits for c in shard.device_caches.values() if c.hist)


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
PROFILED = ("Q1", "Q2", "Q3", "Q4", "Q7", "Q8")


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
    # Q7: the histogram metric per series over Q1's span (block 1 of the
    # hist cache, packed at stride 16), in each function a hist cache
    # serves; Q8: sum by (pod) of its bucket rates across blocks 0-1
    out += [("Q7", "lat", "series", F.RATE, q1, "rate_grid_packed", ()),
            ("Q7:increase", "lat", "series", F.INCREASE, q1,
             "rate_grid_packed", ()),
            ("Q7:sum_over_time", "lat", "series", F.SUM_OVER_TIME, q1,
             "rate_grid_packed", ()),
            ("Q7:instant", "lat", "series", None, q1, "rate_grid_packed",
             ()),
            ("Q8", "lat", "grouped", F.RATE, q2, "rate_grid", ())]
    return out


# rate_grid launches a query makes on the direct kernel: irate's and
# stddev_over_time's (grid.SERIES_DIRECT_OPS); every other launch of
# rate_grid on the main path and the engine's takes the staged kernel
MAIN_DIRECT = {"Q5:irate": 1, "Q6:stddev_over_time": 1}
ENGINE_DIRECT = {"E3": 1}


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
    if kind == "grouped" and "hist_sum" in out:
        return check_hist_grouped(name, out, pods, ref_out, ref_pods,
                                  nsteps, device)
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
    _t, vals, tops = out
    shape = (len(tags), nsteps)
    if tops is not None:
        check_tops(name, tops)
        shape += (len(HIST_TOPS),)
    if vals.shape != shape or vals.device != device:
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


def check_tops(name: str, tops) -> None:
    import numpy as np
    if not np.array_equal(np.asarray(tops), np.asarray(HIST_TOPS)):
        raise AssertionError(f"{name}: bucket tops {tops}")


def check_hist_grouped(name, out, pods, ref_out, ref_pods, nsteps,
                       device) -> float:
    """A hist cache's bucket-wise sum state: ``[G, T, 16]`` sums and
    ``[G, T]`` counts on the card, finite, and the first CHECK_PODS pods
    against the CPU store's (counts equal, sums rtol 1e-5)."""
    import torch
    check_tops(name, out["bucket_tops"])
    shapes = {"hist_sum": (len(pods), nsteps, len(HIST_TOPS)),
              "count": (len(pods), nsteps)}
    for key, shape in shapes.items():
        if out[key].shape != shape or out[key].device != device:
            raise AssertionError(f"{name}: {key} shape {out[key].shape} "
                                 f"on {out[key].device}")
    if not bool(torch.isfinite(out["hist_sum"]).all()):
        raise AssertionError(f"{name}: non-finite bucket sums")
    n = len(ref_pods)
    if pods[:n] != ref_pods:
        raise AssertionError(f"{name}: pod order differs")
    if not torch.equal(out["count"][:n].cpu().double(),
                       ref_out["count"].double()):
        raise AssertionError(f"{name}: count differs from the CPU store")
    return compare(out["hist_sum"][:n], ref_out["hist_sum"], "sum",
                   RTOL_CPU)


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


def main_stores(device, seed: int, report: dict, hist_pods: HistPods
                ) -> dict:
    """The main path's stores: the card's (``req_total``, ``jit_total``,
    ``lat``) and the CPU store of the first CHECK_PODS pods.  The
    ingest launches no kernel of the library, so it runs while ``nvcc``
    builds it (:class:`KernelBuild`)."""
    with Phase("main.ingest"):
        t0 = time.perf_counter()
        _ms, shard, samples = build_store(device, seed, REQ_PODS, JIT_PODS)
        ingest_s = time.perf_counter() - t0
        log(f"ingest: {samples} samples, {shard.num_partitions} series in "
            f"{ingest_s:.3f} s ({samples / ingest_s:.4g} samples/s)")
    with Phase("main.reference_cpu_store"):
        _rms, ref_shard, _n = build_store("cpu", seed, CHECK_PODS, JIT_PODS)
    with Phase("main.hist_ingest"):
        # the CPU store takes the first CHECK_PODS pods, the rows Q7 and
        # Q8 are checked on; E7's sum over every pod is checked against
        # the plain reference the encoding workers compute
        check_hist_encoder(seed)
        t0 = time.perf_counter()
        hist_samples, ingest_times, hist_ref, waited = ingest_hist(
            [shard, ref_shard], hist_pods, CHECK_PODS)
        hist_pods.close()           # every pod in
        log(f"hist ingest: {hist_samples} samples a store "
            f"({HIST_PODS} pods x {HIST_SERIES} series x {N_ROWS} rows x "
            f"{len(HIST_TOPS)} buckets) in {time.perf_counter() - t0:.3f} s "
            f"(encoded in {HIST_WORKERS} processes started with the build, "
            f"the last pod {hist_pods.done_at:.3f} s after they started; "
            f"{waited:.3f} s waited here); the card's store ingested them in "
            f"{ingest_times[0]:.3f} s "
            f"({hist_samples / ingest_times[0]:.4g} samples/s), flushed "
            f"in {ingest_times[2]:.3f} s")
        report["hist_ingest"] = {"samples": hist_samples,
                                 "card_store_seconds": ingest_times[0],
                                 "cpu_store_seconds": ingest_times[1],
                                 "flush_seconds": ingest_times[2],
                                 "encoding_waited_seconds": waited}
    report["ingest_seconds"] = ingest_s
    report["ingest_samples"] = samples
    return {"ms": _ms, "shard": shard, "ref_ms": _rms,
            "ref_shard": ref_shard, "hist_ref": hist_ref}


def main_path(device, seed: int, reps: int, report: dict,
              stores: dict) -> dict:
    import torch
    from filodb_tpu_torch.ops import grid

    shard, ref_shard = stores["shard"], stores["ref_shard"]
    with Phase("main.lookup"):
        looked, ref_looked = {}, {}
        for metric in ("req_total", "jit_total", "lat"):
            t0 = time.perf_counter()
            looked[metric] = lookup(shard, metric)
            log(f"lookup {metric}: {len(looked[metric][0])} series, "
                f"{len(looked[metric][2])} pods in "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
            # the CPU store's check rows: the first CHECK_PODS pods
            ref_looked[metric] = lookup(ref_shard, metric, pods=CHECK_PODS)

    plans = {}
    qrows = []
    qlaunch = {}
    with Phase("main.queries"):
        grid.reset_launch_counts()            # the main path's run
        for name, metric, kind, func, span, kern, fargs in queries():
            hist = metric == "lat"
            hits0 = hist_hits(shard)
            before = (grid.rate_grid.launches,
                      grid.rate_grid_packed.launches)
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            d0 = grid.rate_grid.direct
            out = run_query(shard, kind, func, span, looked[metric], fargs)
            direct = grid.rate_grid.direct - d0
            b.record()
            b.synchronize()
            peak = torch.cuda.max_memory_allocated() - mem0
            if direct != MAIN_DIRECT.get(name, 0):
                raise AssertionError(f"{name}: {direct} rate_grid launches "
                                     f"on the direct kernel, expected "
                                     f"{MAIN_DIRECT.get(name, 0)}")
            wall = (time.perf_counter() - t0) * 1e3
            dev_ms = a.elapsed_time(b)
            launched = {
                "rate_grid": grid.rate_grid.launches - before[0],
                "rate_grid_packed":
                    grid.rate_grid_packed.launches - before[1]}
            other = "rate_grid" if kern == "rate_grid_packed" \
                else "rate_grid_packed"
            # rate_grid_packed serves every class plane of the block's
            # pack in one launch
            if launched[kern] < 1 or launched[other] != 0 or (
                    kern == "rate_grid_packed" and launched[kern] != 1):
                raise AssertionError(f"{name}: expected {kern} only (one "
                                     f"rate_grid_packed launch), launched "
                                     f"{launched}")
            if hist and hist_hits(shard) <= hits0:
                raise AssertionError(f"{name}: the hist cache's hits did "
                                     f"not rise from {hits0}")
            cache = grid_cache(shard, hist)
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
                f"(rate_grid direct {direct}) peak device memory above "
                f"the resident {peak} bytes, cpu-store check ok "
                f"(max_abs_err {err:.3e})")
            qrows.append({"query": name, "kernel": kern,
                          "cold_wall_ms": wall, "cold_events_ms": dev_ms,
                          "launches": launched, "rate_grid_direct": direct,
                          "cold_peak_bytes": peak, "cpu_check_err": err})
            qlaunch[name] = launched
        totals = {"rate_grid": grid.rate_grid.launches,
                  "rate_grid_packed": grid.rate_grid_packed.launches}
        direct_total = grid.rate_grid.direct
        for k, n in totals.items():
            if n < 1:
                raise AssertionError(f"{k} never launched on the main "
                                     f"path")
        log(f"main path launches {totals}, rate_grid on its direct kernel "
            f"{direct_total}")
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
        builds = {c: c.builds for c in shard.device_caches.values()}
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
            row["warm_wall_p10_p90"] = spread(walls)
            row["warm_events_p10_p90"] = spread(evs)
            log(f"{name}: warm median of {reps}: wall_ms "
                f"{row['warm_wall_ms']:.3f} (p10 "
                f"{row['warm_wall_p10_p90'][0]:.3f}, p90 "
                f"{row['warm_wall_p10_p90'][1]:.3f}) events_ms "
                f"{row['warm_events_ms']:.3f} (p10 "
                f"{row['warm_events_p10_p90'][0]:.3f}, p90 "
                f"{row['warm_events_p10_p90'][1]:.3f})")
        for c, n in builds.items():
            if c.builds != n:
                raise AssertionError(f"{c.owner}: warm queries rebuilt "
                                     f"{c.builds - n} blocks")
        log(f"warm queries rebuilt no block ({sum(builds.values())} "
            f"builds in all)")
    report["queries"] = qrows
    with Phase("main.profile"):
        profile_queries(shard, looked)

    # each kernel against its plain version on the main path's inputs
    flush = make_flush(device)
    kern_rows = {}
    with Phase("main.kernels_at_path_shapes"):
        for name, plan in plans.items():
            kname, row = plan_kernel_times(name, plan, reps, flush)
            row["launches"] = qlaunch[name][kname]
            kern_rows.setdefault(kname, []).append(row)
    report["kernels_at_path_shapes"] = kern_rows
    with Phase("main.hist_reduce"):
        report["hist_reduce"] = hist_reduce(device, shard, plans["Q8"],
                                            looked["lat"], reps, flush)
    return {"launches": totals, "rate_grid_direct": direct_total,
            "rows": kern_rows,
            "stores": (stores["ms"], shard, stores["ref_ms"], looked,
                       stores["hist_ref"])}


def plan_kernel_times(name: str, plan, reps: int, flush) -> tuple:
    """The kernel a grid plan launches (rate_grid_packed for a packed
    plan, else rate_grid) against its plain version on the plan's own
    inputs, timed, with its bound; rate_grid also against its direct
    kernel, bit for bit, and timed.  Returns (kernel, row)."""
    import torch
    from filodb_tpu_torch.memstore import devicestore
    from filodb_tpu_torch.ops import grid

    q = plan.q
    extra = {}
    if plan.packed is not None:
        args = (plan.packed, plan.steps0_rel, q, plan.packed_row0,
                plan.packed_use_phase)
        kname = "rate_grid_packed"
        fn = partial(grid.rate_grid_packed, *args)
        ref = partial(grid.rate_grid_packed_ref, *args)
        work = packed_work(plan.packed, q, plan.packed_row0,
                           plan.packed_use_phase)
        shape = f"packed {grid.packed_width(plan.packed)} lanes"
    else:
        ts, vals, s0, q, ph = devicestore.series_inputs(plan)
        kname = "rate_grid"
        fn = partial(grid.rate_grid, ts, vals, s0, q, phase=ph)
        ref = partial(grid.rate_grid_ref, ts, vals, s0, q, phase=ph)
        direct = partial(series_direct, ts, vals, s0, q, phase=ph)
        work = grid_work(ts, vals, q, ph)
        mode = grid._mode_for(q, ph)
        splan = grid.series_staged_plan(vals.shape[1], q.nsteps, q.kbuckets,
                                        q.stride, mode, q.op)
        route = "staged" if splan.staged else "direct"
        shape = (f"[{vals.shape[0]}, {vals.shape[1]}] {mode} {route} "
                 f"{tuple(splan)} dense={q.dense}")
        extra = {"mode": mode, "dense": q.dense, "route": route,
                 "plan": list(splan)}
    got = fn()
    want = ref()
    torch.cuda.synchronize()
    err = compare(got, want, q.op, RTOL_KERNEL,
                  0 if q.op in CROSSING else None)
    if kname == "rate_grid":
        # the direct kernel on the same inputs: bit for bit, timed
        compare_bits(got, direct(), f"{name} rate_grid (direct)")
        extra["direct_ms"] = cuda_ms(direct, reps, flush)
    ms = cuda_ms(fn, reps, flush)
    pms = cuda_ms(ref, reps, flush)
    bms, by = bound_ms(*work)
    log(f"{name} {kname} {shape} op={q.op} T={q.nsteps}: ms {ms:.4f}"
        + (f" direct_ms {extra['direct_ms']:.4f}" if "direct_ms" in extra
           else "")
        + f" plain_ms {pms:.4f} bound_ms {bms:.4f} ({by}, {work[0]} bytes)"
        f" max_abs_err {err:.3e} ok")
    return kname, {"query": name, "kernel": kname, "op": q.op, "ms": ms,
                   "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                   "bytes": work[0], "max_abs_err": err, **extra}


def hist_reduce(device, shard, plan, looked, reps: int, flush) -> dict:
    """Q8's group reduce alone (``_grouped_reduce_impl`` over its B1
    output, 1,600 bucket slots: the one-hot f32 matmul), timed, with the
    device memory it takes above what was allocated before it; its
    state equals the query's, bit for bit."""
    import numpy as np
    import torch
    from filodb_tpu_torch.memstore import devicestore

    ids, gids, pods, _tags = looked
    hb = grid_cache(shard, True).hb
    slots = len(pods) * hb
    garr = np.full(plan.ncols, slots, np.int32)
    devicestore.hist_slot_garr(garr, plan.lane_idx,
                               np.asarray(gids, np.int32), hb)
    garr = torch.as_tensor(garr, device=device)
    stepped = devicestore.series_program(plan)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    both = devicestore._grouped_reduce_impl(stepped, garr, slots, "sum")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mem0
    state = devicestore.hist_state_from_planes(both, len(pods), hb, None)
    q8 = next(q for q in queries() if q[0] == "Q8")
    want = run_query(shard, "grouped", q8[3], q8[4], looked)
    for key in ("hist_sum", "count"):
        if not torch.equal(state[key], want[key]):
            raise AssertionError(f"Q8's reduce alone differs from the "
                                 f"query's {key}")
    ms = cuda_ms(lambda: devicestore._grouped_reduce_impl(
        stepped, garr, slots, "sum"), reps, flush)
    log(f"Q8 group reduce: [{stepped.shape[0]}, {stepped.shape[1]}] -> "
        f"{slots} slots (one-hot matmul: {slots + 1 <= 2048}) ms {ms:.4f}, "
        f"peak device memory above the resident {peak} bytes, equal to "
        f"the query's state")
    return {"columns": int(stepped.shape[1]), "steps": int(stepped.shape[0]),
            "slots": slots, "ms": ms, "peak_bytes": peak}


# ------------------------------------------------------------- phase 5

def engine_queries():
    """(name, PromQL, (first step, steps), ?downsample= pixels, the grid
    kernel it must reach or None for the general path)."""
    q1 = ENGINE_SPAN
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
        # BASELINE config 2's query over the 64,000 histogram series:
        # the packed kernel, then the 16-slot bucket-wise group sum
        ("E7", f"histogram_quantile({HIST_Q}, sum(rate(lat[5m])))", q1,
         None, "rate_grid_packed"),
    ]


def run_engine(ms, query: str, span, pixels, dataset: str = "prom",
               step: int = STEP, qctx=None):
    """One PromQL range query through the port's entry point: parse ->
    plan -> (DownsampleMapper when ?downsample= is given) -> execute,
    then every batch's values on the host (the API edge).  Returns the
    result, the host values and the wall ms of all that.  ``qctx`` (a
    QueryContext, say with a deadline minted) defaults to one without
    limits."""
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.parallel.shardmap import ShardMapper
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    from filodb_tpu_torch.query.exec import ExecContext
    from filodb_tpu_torch.query.model import QueryContext
    from filodb_tpu_torch.query.transformers import DownsampleMapper

    t0 = time.perf_counter()
    start, nsteps = span
    if qctx is None:
        qctx = QueryContext(sample_limit=2**40)
    plan = query_range_to_logical_plan(query, start, step,
                                       start + (nsteps - 1) * step)
    ep = SingleClusterPlanner(dataset, ShardMapper(1)).materialize(plan,
                                                                   qctx)
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


def quantile_bound(tops, hist, q: float):
    """The most each step's ``histogram_quantile(q)`` over the CPU
    store's bucket sums ``hist`` ``[T, B]`` (f64) may move when every
    bucket sum moves by up to RTOL_CPU of the total: the rank ``q*total``
    and the counts below and at the quantile's bucket then move by at
    most RTOL_CPU*total each, so the interpolated fraction of the bucket
    by at most 3*RTOL_CPU*total over the bucket's count; times the
    bucket's width.  A quantile in the +Inf bucket is its lower edge,
    exactly."""
    import numpy as np
    tops = np.asarray(tops, np.float64)
    total = hist[:, -1]
    idx = np.minimum((hist < (q * total)[:, None]).sum(axis=1),
                     len(tops) - 1)
    at = np.take_along_axis(hist, idx[:, None], axis=1)[:, 0]
    below = np.where(idx > 0, np.take_along_axis(
        hist, np.maximum(idx - 1, 0)[:, None], axis=1)[:, 0], 0.0)
    width = tops[idx] - np.where(idx > 0, tops[np.maximum(idx - 1, 0)], 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        bound = width * 3 * RTOL_CPU * total / (at - below)
    return np.where(np.isinf(width), 0.0, bound)


def check_hist_quantile(name, ms, hist_ref, query, span, rows) -> float:
    """E7 against its plain reference (``hist_ref``, ``[T, B]``: the
    general path's rate over every pod's own counts, summed): the card's
    bucket-wise sum (the query without ``histogram_quantile``) within
    RTOL_CPU bucket by bucket, and each step's quantile within
    :func:`quantile_bound` of the plain quantile of the reference."""
    import numpy as np
    import torch
    from filodb_tpu_torch.ops.histogram_ops import hist_quantile

    inner = query[query.index(",") + 1:query.rindex(")")].strip()
    res = run_engine(ms, inner, span, None)[0]
    (b,) = res.batches
    check_tops(name, b.bucket_tops)
    ref = torch.as_tensor(hist_ref, dtype=torch.float64)
    plane_err = compare(torch.as_tensor(b.hist)[0].double().cpu(), ref,
                        "sum", RTOL_CPU)
    ((_key, got),) = rows.items()
    want = hist_quantile(torch.as_tensor(HIST_TOPS, dtype=torch.float64),
                         ref, HIST_Q).numpy()
    bound = quantile_bound(HIST_TOPS, hist_ref, HIST_Q)
    if not np.array_equal(np.isnan(got), np.isnan(want)) \
            or not np.isfinite(want).any():
        raise AssertionError(f"{name}: NaN steps differ from the reference "
                             f"or none is finite")
    fin = np.isfinite(want)
    diff = np.abs(got[fin] - want[fin])
    if not (diff <= bound[fin]).all():
        raise AssertionError(f"{name}: quantile off by {diff.max():.3e}, "
                             f"beyond its bound")
    log(f"{name}: bucket sums within rtol {RTOL_CPU} of the plain reference "
        f"(max_abs_err {plane_err:.3e}); quantiles {want[fin].min():.4g}-"
        f"{want[fin].max():.4g} s, off by at most {diff.max():.3e} "
        f"against a bound of {bound[fin].min():.3e}-"
        f"{bound[fin].max():.3e} (relative "
        f"{(bound[fin] / want[fin]).max():.3e})")
    return float(diff.max())


class GroupReduces:
    """Records the op of every on-device group reduce of the grid
    (``devicestore._grouped_reduce_impl``) while it is entered."""

    def __enter__(self):
        from filodb_tpu_torch.memstore import devicestore
        self.ops = []
        self._orig = orig = devicestore._grouped_reduce_impl

        def reduce(stepped, garr, num_groups, op, *a, **kw):
            self.ops.append(op)
            return orig(stepped, garr, num_groups, op, *a, **kw)

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


def warm_engine(ms, query: str, span, pixels, reps: int, **kw):
    """Median wall ms of ``reps`` warm runs, their (p10, p90), and the
    median of each ExecContext stage (scan: lookup + grid or scan_batch;
    device_compute: the grid seam's calls) in ms."""
    walls, stages = [], {}
    for _ in range(reps):
        res, _host, wall = run_engine(ms, query, span, pixels, **kw)
        walls.append(wall)
        for k, v in res.stats.timings.items():
            stages.setdefault(k, []).append(v * 1e3)
    return statistics.median(walls), spread(walls), {
        k: round(statistics.median(v), 3) for k, v in stages.items()}


def engine_phase(device, stores, reps: int, report: dict) -> dict:
    """E1-E6 through parse -> plan -> execute on the main-path store,
    each held against the CPU store's engine answer; E1 also against the
    direct scan_grid_grouped answer, bit for bit."""
    import numpy as np
    import torch
    from filodb_tpu_torch.ops import grid
    from filodb_tpu_torch.query.logical import RangeFunctionId as F

    ms, shard, rms, looked, hist_ref = stores
    kernels = ("rate_grid", "rate_grid_packed", "m4_grid")

    def counts():
        return {k: getattr(grid, k).launches for k in kernels}

    cold_runs = []
    served = {}                 # histogram query -> hist cache hits
    hist_cache = grid_cache(shard, True)
    grid.reset_launch_counts()              # the engine path's run
    for name, query, span, pixels, _kern in engine_queries():
        before, d0 = counts(), grid.rate_grid.direct
        hits0 = hist_hits(shard)
        with AggregatorDevices() as agg_devices, GroupReduces() as reduces:
            res, host, cold = run_engine(ms, query, span, pixels)
        if "lat" in query:
            served[name] = hist_hits(shard) - hits0
        cold_runs.append((res, engine_rows(res, host), cold,
                          {k: v - before[k] for k, v in counts().items()},
                          agg_devices.seen, reduces.ops))
        direct = grid.rate_grid.direct - d0
        if direct != ENGINE_DIRECT.get(name, 0):
            raise AssertionError(f"{name}: {direct} rate_grid launches on "
                                 f"the direct kernel, expected "
                                 f"{ENGINE_DIRECT.get(name, 0)}")
    totals = counts()
    log(f"engine path launches {totals}, rate_grid on its direct kernel "
        f"{grid.rate_grid.direct}")

    rows_out = []
    for (name, query, span, pixels, kern), \
            (res, rows, cold, launched, agg_seen, reduce_ops) in zip(
                engine_queries(), cold_runs):
        want = {k: 0 for k in kernels}
        if kern is not None:
            # one rate_grid_packed launch serves every class plane
            want[kern] = 1 if kern == "rate_grid_packed" else launched[kern]
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
        if name in served:
            # the histogram query was served by the hist cache's grid
            if reduce_ops != ["sum"] or served[name] < 1:
                raise AssertionError(f"{name}: hist cache hits "
                                     f"{served[name]}, group reduces "
                                     f"{reduce_ops}")
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
        if name in served:
            err = check_hist_quantile(name, ms, hist_ref, query, span, rows)
        else:
            ref_rows = engine_rows(*run_engine(rms, query, span, pixels)[:2])
            err = check_engine(name, rows, ref_rows, pixels, rtol)
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
        builds = hist_cache.builds
        warm, warm_spread, stages = warm_engine(ms, query, span, pixels,
                                                reps)
        if hist_cache.builds != builds:
            raise AssertionError(f"{name}: warm runs rebuilt hist blocks")
        log(f"{name} {query!r} steps={span[1]}"
            f"{f' downsample={pixels}' if pixels else ''}: {len(rows)} "
            f"series, result on {where}, aggregation on "
            f"{sorted(str(d) for d in agg_seen) or 'none'}, device group "
            f"reduces {reduce_ops or 'none'}, launches {launched}, cold "
            f"wall_ms "
            f"{cold:.3f} (stages {res.stats.timings}), warm wall_ms (median "
            f"of {reps}) {warm:.3f} (p10 {warm_spread[0]:.3f}, p90 "
            f"{warm_spread[1]:.3f}; stage ms {stages}), cpu-store check "
            f"ok (max_abs_err {err:.3e})")
        row = {"query": name, "promql": query, "steps": span[1],
               "pixels": pixels, "launches": launched,
               "group_reduces": reduce_ops, "cold_wall_ms": cold,
               "cold_stage_seconds": res.stats.timings, "warm_wall_ms": warm,
               "warm_wall_p10_p90": warm_spread, "warm_stage_ms": stages,
               "cpu_check_err": err}
        if pixels:
            # the same query without ?downsample=: the difference is the
            # DownsampleMapper (upload, m4_grid, readback, host selection)
            row["warm_wall_ms_without_downsample"], _, _ = warm_engine(
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


# ------------------------------------------------------------- phase 5b

BATCH_WINDOW_MS = 3.0           # the reference's co-arrival window
BATCH_MAX = 8                   # and group size
# the window the checks run at: the members' solo calls in turn, times
# this.  Members do their host work before the dispatch (the plan's memo
# key over 102,400 ids, the group map, the batch key) one at a time
# under the GIL, so at the store's width their dispatches arrive over
# more than 3 ms; a group closes as soon as it is full
BATCH_WINDOW_FACTOR = 1.5
BATCH_ROUNDS = 5                # rounds a group may take to form whole
BATCH_AT_3MS_ROUNDS = 2         # rounds at the 3 ms window, recorded
RTOL_GROUPED_BATCH = 1e-6       # a batched grouped reduce against solo


def batch_groups():
    """(name, kind, metric, first span, members, kernel route) of the
    batch phase's seam groups: Q2 (phase mode, dense, the decoded
    blocks 0-1) with eight starts a step apart, Q4 (jit_total, ts mode)
    with four, and per-series rate over Q2's span with eight."""
    q2 = next(q for q in queries() if q[0] == "Q2")[4]
    q4 = next(q for q in queries() if q[0] == "Q4")[4]
    return [("Q2", "grouped", "req_total", q2, BATCH_MAX),
            ("Q4", "grouped", "jit_total", q4, 4),
            ("rate", "series", "req_total", q2, BATCH_MAX)]


def member_spans(span, members: int) -> list:
    """``members`` spans of ``span``'s length, starts a step apart."""
    start, nsteps = span
    return [(start + i * STEP, nsteps) for i in range(members)]


def member_plan(cache, span, n_series: int):
    """The plan the grid cache memoized for a query over ``n_series``
    series whose first window ends at ``span[0]``, of ``span[1]``
    steps."""
    return next(p for p in cache._plan_memo.values()
                if p.q.nsteps == span[1] and len(p.lane_idx) == n_series
                and p.steps0_rel == span[0] - cache.epoch0)


def concurrently(fn, args) -> tuple:
    """``fn(a)`` for every ``a`` from threads released by one barrier,
    synchronized: (results in order, wall ms from the release to the
    last result on the card)."""
    import torch
    barrier = threading.Barrier(len(args) + 1)
    outs: dict = {}
    errs: list = []

    def worker(i, a):
        try:
            barrier.wait()
            outs[i] = fn(a)
        except BaseException as e:           # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i, a), daemon=True)
          for i, a in enumerate(args)]
    for t in ts:
        t.start()
    try:
        torch.cuda.synchronize()
        barrier.wait()
    except BaseException:
        barrier.abort()                      # no thread waits forever
        raise
    t0 = time.perf_counter()
    for t in ts:
        t.join()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if errs:
        raise errs[0]
    return [outs[i] for i in range(len(args))], wall


def same_answer(name: str, got, want, reduced: bool, finding: dict) -> None:
    """A member against its solo answer (a tensor, or a dict of them): bit
    for bit; an answer that went through the group reduce and took other
    bits there (one GEMM over every member's steps, where the library may
    block the sum another way) within RTOL_GROUPED_BATCH of them, noted in
    ``finding``."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        pairs = [(f"{name} {k}", got[k], want[k]) for k in want]
    else:
        pairs = [(name, got, want)]
    for case, g, w in pairs:
        try:
            compare_bits(g, w, case)
        except AssertionError:
            if not reduced:
                raise
            finding["grouped_bits_differ"] = \
                finding.get("grouped_bits_differ", 0) + 1
            err = compare(g, w, "sum", RTOL_GROUPED_BATCH)
            finding["grouped_max_abs_err"] = max(
                finding.get("grouped_max_abs_err", 0.0), err)


def batch_work(vals_all, row0s, nrows: int, q, phase) -> tuple[int, int]:
    """(bytes, ops) of one batched B1 launch: the distinct plane rows the
    members read, counted once (the union of their row spans; ts rows too
    in ts mode, the phase row in phase mode), and every member's [T, S]
    output; the operations of every member's windows."""
    from filodb_tpu_torch.ops import grid
    ns = vals_all.shape[1]
    spans = sorted((r, r + nrows) for r in row0s)
    rows, hi = 0, -1
    for a, b in spans:
        rows += max(0, b - max(a, hi))
        hi = max(hi, b)
    mode = grid._mode_for(q, phase)
    planes = 2 if mode == "ts" else 1
    nbytes = planes * rows * ns * 4 + len(row0s) * q.nsteps * ns * 4
    if mode == "phase":
        nbytes += ns * 4
    one = grid_work(None, vals_all[:nrows], q, phase)[1]
    return nbytes, len(row0s) * one


def batch_launch_times(plan, row0s, steps0s, reps: int, flush) -> list:
    """The batched B1 launch over a plan's concatenated blocks at
    M = 8 and M = 4 members against M solo launches on the same inputs
    (CUDA events, L2 flushed), its plain version and its bound."""
    from filodb_tpu_torch.memstore import devicestore
    from filodb_tpu_torch.ops import grid
    ts_all = devicestore._concat(plan.ts_parts, devicestore._seg_ts_device)
    vals_all = devicestore._concat(plan.val_parts,
                                   devicestore._seg_vals_device)
    q, nrows, phase = plan.q, plan.nrows, plan.phase
    out = []
    for m in (8, 4):
        r0, s0 = row0s[:m], steps0s[:m]
        got = grid.rate_grid_batch(ts_all, vals_all, r0, s0, q, nrows,
                                   phase=phase)
        want = grid.rate_grid_batch_ref(ts_all, vals_all, r0, s0, q, nrows,
                                        phase=phase)
        err = compare(got, want, q.op, RTOL_KERNEL)

        def solos(r0=r0, s0=s0):
            for r, st in zip(r0, s0):
                grid.rate_grid(None if ts_all is None
                               else ts_all[r:r + nrows],
                               vals_all[r:r + nrows], st, q, phase=phase)

        work = batch_work(vals_all, r0, nrows, q, phase)
        bms, by = bound_ms(*work)
        row = {"members": m, "shape": [nrows, int(vals_all.shape[1])],
               "ms": cuda_ms(partial(grid.rate_grid_batch, ts_all, vals_all,
                                     r0, s0, q, nrows, phase=phase),
                             reps, flush),
               "solo_ms": cuda_ms(solos, reps, flush),
               "plain_ms": cuda_ms(partial(grid.rate_grid_batch_ref, ts_all,
                                           vals_all, r0, s0, q, nrows,
                                           phase=phase), reps, flush),
               "bound_ms": bms, "bound_by": by, "bytes": work[0],
               "max_abs_err": err}
        log(f"rate_grid_batch M={m} [{nrows}, {vals_all.shape[1]}] "
            f"{grid._mode_for(q, phase)}-{q.op}: ms {row['ms']:.4f} "
            f"against {m} solo launches {row['solo_ms']:.4f}, plain_ms "
            f"{row['plain_ms']:.4f} bound_ms {bms:.4f} ({by}, {work[0]} "
            f"bytes) max_abs_err {err:.3e} ok")
        out.append(row)
    return out


def batch_phase(device, stores, reps: int, report: dict) -> dict:
    """Co-arrival groups through the port's query batcher on the main
    path's store (groups of up to 8): Q2's ``sum by (pod)(rate)`` over
    blocks 0-1 with eight starts, Q4 (ts mode) with four, per-series rate
    with eight, each from threads released by one barrier; then one group
    of engine queries from PromQL text with deadlines minted.  Each at
    the reference's 3 ms window first (what forms is recorded), then at
    a window of BATCH_WINDOW_FACTOR times its members' solo calls in
    turn.  Each group, once whole (a group may take a few rounds to
    form), ran ONE batched B1 launch and no solo one; every
    member equals its solo answer (bit for bit; a grouped reduce within
    1e-6 where its bits differ); the batch metrics count the groups and
    members, the kernel ledger the launches; no fallback for an error,
    the breaker closed.  Timed: the batched launch at M = 8 and 4 against
    M solo launches, and each group's wall against its members' solo
    seam calls in turn."""
    import numpy as np
    import torch
    from filodb_tpu_torch.batching import QueryBatcher, batching_broken
    from filodb_tpu_torch.ops import grid
    from filodb_tpu_torch.query.logical import RangeFunctionId as F
    from filodb_tpu_torch.query.model import QueryContext
    from filodb_tpu_torch.utils import devicewatch as dw
    from filodb_tpu_torch.utils.observability import batch_metrics
    from filodb_tpu_torch.workload import deadline as wdl

    ms, shard, _rms, looked, _hist_ref = stores
    met = batch_metrics()
    flush = make_flush(device)
    bat = QueryBatcher(window_ms=BATCH_WINDOW_MS, max_batch=BATCH_MAX,
                       dataset="prom")
    finding: dict = {}
    path = {"rate_grid": 0, "rate_grid_batch": 0, "batch_direct": 0}

    def ledger_launches():
        return {r["program"]: r["launches"]
                for r in dw.KERNEL_TIMER.table()}

    def round_of(run, spans):
        """One concurrent round: (members, wall ms, its counts)."""
        led0 = ledger_launches()
        c0 = (grid.rate_grid.launches, grid.rate_grid_batch.launches,
              grid.rate_grid_batch.direct, met["groups"].value(
                  dataset="prom"), met["members"].value(dataset="prom"))
        outs, wall = concurrently(run, spans)
        led1 = ledger_launches()
        d = {"rate_grid": grid.rate_grid.launches - c0[0],
             "rate_grid_batch": grid.rate_grid_batch.launches - c0[1],
             "batch_direct": grid.rate_grid_batch.direct - c0[2],
             "groups": int(met["groups"].value(dataset="prom") - c0[3]),
             "members": int(met["members"].value(dataset="prom") - c0[4])}
        for k in ("rate_grid", "rate_grid_batch", "batch_direct"):
            path[k] += d[k]
        # the kernel ledger counts every launch its wrappers count
        for prog, n in (("grid.rate_grid_batch", d["rate_grid_batch"]),
                        ("grid.rate_grid", d["rate_grid"])):
            got = led1.get(prog, 0) - led0.get(prog, 0)
            if got != n:
                raise AssertionError(f"kernel ledger {prog}: {got} "
                                     f"launches, the wrapper counted {n}")
        return outs, wall, d

    def whole(name, run, spans, grouped, solos):
        """Rounds until one forms a single group of every member (at most
        BATCH_ROUNDS); every round's members equal their solo answers."""
        for i in range(BATCH_ROUNDS):
            outs, wall, d = round_of(run, spans)
            for m, (got, want) in enumerate(zip(outs, solos)):
                same_answer(f"{name} round {i} member {m}", got, want,
                            grouped, finding)
            if d == {"rate_grid": 0, "rate_grid_batch": 1,
                     "batch_direct": d["batch_direct"], "groups": 1,
                     "members": len(spans)}:
                return wall, d, i + 1
            log(f"{name} round {i}: {d} (not one whole group)")
        raise AssertionError(f"{name}: no round of {BATCH_ROUNDS} formed "
                             f"one group of {len(spans)}")

    def groups_of(name, run, spans, grouped, solos, seq_ms):
        """BATCH_AT_3MS_ROUNDS rounds at the 3 ms window (what co-arrives
        there, recorded), then at the members' solo calls in turn times
        BATCH_WINDOW_FACTOR: rounds until a group formed (the key hot),
        then ``reps`` whole groups.  (at3, warm rounds, walls, counts,
        rounds)."""
        at3 = []
        for i in range(BATCH_AT_3MS_ROUNDS):
            outs, _wall, d = round_of(run, spans)
            for m, (got, want) in enumerate(zip(outs, solos)):
                same_answer(f"{name} 3 ms round {i} member {m}", got, want,
                            grouped, finding)
            at3.append({k: d[k] for k in ("groups", "members",
                                          "rate_grid")})
        bat.configure(window_ms=max(BATCH_WINDOW_MS,
                                    BATCH_WINDOW_FACTOR * seq_ms))
        groups0 = met["groups"].value(dataset="prom")
        warm = 0
        while met["groups"].value(dataset="prom") == groups0:
            warm += 1                   # the key hot: a group formed
            if warm > BATCH_ROUNDS:
                raise AssertionError(f"{name}: no group formed in "
                                     f"{BATCH_ROUNDS} warm rounds")
            round_of(run, spans)
        walls, d, tries = [], None, 0
        for _ in range(reps):
            wall, d, n = whole(name, run, spans, grouped, solos)
            walls.append(wall)
            tries += n
        return at3, warm, walls, d, tries

    rows = []
    plans = {}
    err0 = met["fallbacks"].value(dataset="prom", reason="error")
    try:
        # the group maps as arrays once (a server holds its plans' maps)
        looked_np = {m: (v[0], np.asarray(v[1], np.int32)) + tuple(v[2:])
                     for m, v in looked.items()}
        for name, kind, metric, span, members in batch_groups():
            spans = member_spans(span, members)
            grouped = kind == "grouped"

            def run(sp, kind=kind, metric=metric):
                out = run_query(shard, kind, F.RATE, sp, looked_np[metric])
                return out if kind == "grouped" else out[1]

            shard.query_batcher = None
            for _ in range(2):      # the members' plans memoized, blocks built
                solos = [run(sp) for sp in spans]
            torch.cuda.synchronize()
            seq_walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                for sp in spans:
                    run(sp)
                torch.cuda.synchronize()
                seq_walls.append((time.perf_counter() - t0) * 1e3)
            cache = grid_cache(shard, False)
            plans[name] = [member_plan(cache, sp, len(looked[metric][0]))
                           for sp in spans]
            seq = statistics.median(seq_walls)
            shard.query_batcher = bat
            at3, warm, walls, d, tries = groups_of(
                name, run, spans, grouped, solos, seq)
            row = {"group": name, "kind": kind, "metric": metric,
                   "members": members, "steps": span[1],
                   "window_ms": bat.window_ms,
                   "group_wall_ms": statistics.median(walls),
                   "solo_seam_calls_ms": seq, "rounds": tries,
                   "warm_rounds": warm, "at_3ms_window": at3,
                   "batch_direct": d["batch_direct"]}
            bat.configure(window_ms=BATCH_WINDOW_MS)
            log(f"batch {name} ({kind} {metric}, {members} members, "
                f"{span[1]} steps): at the 3 ms window {at3}; at "
                f"{row['window_ms']:.1f} ms one batched B1 launch a whole "
                f"group ({'direct' if d['batch_direct'] else 'staged'}), "
                f"every member equal to its solo answer; group wall "
                f"median of {reps} {row['group_wall_ms']:.3f} ms against "
                f"{members} solo seam calls in turn {seq:.3f} ms ({tries} "
                f"rounds for {reps} whole groups, {warm} warm)")
            rows.append(row)

        # one group through the engine, from PromQL text, deadlines minted
        query = "sum by (pod)(rate(req_total[5m]))"
        q2 = batch_groups()[0][3]
        spans = member_spans(q2, BATCH_MAX)

        def engine_run(sp):
            qctx = wdl.mint(QueryContext(sample_limit=2**40,
                                         timeout_ms=60_000))
            res, host, _wall = run_engine(ms, query, sp, None, qctx=qctx)
            return torch.as_tensor(np.stack(host))

        shard.query_batcher = None
        esolos = [engine_run(sp) for sp in spans]
        seq = time.perf_counter()
        for sp in spans:
            engine_run(sp)
        seq = (time.perf_counter() - seq) * 1e3
        shard.query_batcher = bat
        at3, warm, walls, d, tries = groups_of("engine", engine_run, spans,
                                               True, esolos, seq)
        row = {"group": "engine", "promql": query, "members": BATCH_MAX,
               "window_ms": bat.window_ms,
               "group_wall_ms": statistics.median(walls),
               "solo_engine_calls_ms": seq, "rounds": tries,
               "warm_rounds": warm, "at_3ms_window": at3}
        bat.configure(window_ms=BATCH_WINDOW_MS)
        log(f"batch engine {query!r} x {BATCH_MAX} (deadlines minted): at "
            f"the 3 ms window {at3}; at {row['window_ms']:.1f} ms one group "
            f"of {BATCH_MAX}, one batched launch, every member's rows "
            f"equal to its solo engine answer (a reduced answer within "
            f"{RTOL_GROUPED_BATCH} where its bits differ); group wall "
            f"median of {reps} {row['group_wall_ms']:.3f} ms against "
            f"{BATCH_MAX} solo engine calls in turn {seq:.3f} ms")
        rows.append(row)
    finally:
        shard.query_batcher = None
    errors = met["fallbacks"].value(dataset="prom", reason="error") - err0
    if errors or batching_broken():
        raise AssertionError(f"batched launches failed: {errors} fallbacks "
                             f"for an error, breaker open "
                             f"{batching_broken()}")
    # the batched launch timed at M = 8 and 4 over Q2's members' plans
    q2p = plans["Q2"]
    if q2p[0].packed is not None or q2p[0].phase is None:
        raise AssertionError("Q2's members do not run B1 in phase mode")
    times = batch_launch_times(q2p[0], [p.row0 for p in q2p],
                               [p.steps0_rel for p in q2p], reps, flush)
    report["batch"] = {"groups": rows, "launch_times": times,
                       "finding": finding, "launches": path}
    log(f"batch path launches {path}; grouped reduce bits "
        f"{'differ from solo in ' + str(finding['grouped_bits_differ']) + ' planes' if finding else 'equal to solo'}")
    return {"launches": path, "times": times, "finding": finding}


# ------------------------------------------------------------- phase 6

# the launches of each north-star query: the grouped packed kernels launch
# once per class plane (each of these packs is one plane), rate_grid_packed
# once a call (topk calls it for the value and the filter column)
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
        for name, fn in (("dense", grid.rate_grid_grouped),
                         ("packed", grid.rate_grid_grouped_packed),
                         ("hist", grid.hist_grid_grouped_packed)):
            if fn.direct:
                raise AssertionError(f"northstar {name}: {fn.direct} "
                                     f"launches of the direct "
                                     f"{fn.__name__} kernel, expected the "
                                     f"staged one")

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
        topk_b3 = topk_b3_times(cases["topk"], s0, reps, flush)
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
    b3_ms = sum(r["ms"] for r in topk_b3)
    log(f"northstar topk: its two rate_grid_packed launches {b3_ms:.4f} ms "
        f"of the query's {rows['topk']['query_ms']:.4f}, the torch around "
        f"them {rows['topk']['query_ms'] - b3_ms:.4f}")
    report["northstar"] = {"queries": rows, "kernels": kern_rows,
                           "launches": totals, "second_ops": second,
                           "topk_b3": topk_b3}
    return {"launches": totals, "rows": kern_rows,
            "second_ops": second + topk_b3}


def topk_b3_times(case, s0: int, reps: int, flush) -> list:
    """rate_grid_packed (B3) at the topk query's two launches, the value
    column's sum_over_time and the filter column's last value over
    262,144 event lanes, each against its plain version and timed, with
    its bound."""
    from filodb_tpu_torch.ops import grid
    out = []
    for col, packed, q in (("value", case.dv, case.qs),
                           ("filter", case.df, case.ql)):
        fn = partial(grid.rate_grid_packed, packed, s0, q)
        ref = partial(grid.rate_grid_packed_ref, packed, s0, q)
        err = compare(fn(), ref(), q.op, RTOL_KERNEL)
        ms = cuda_ms(fn, reps, flush)
        pms = cuda_ms(ref, reps, flush)
        work = packed_work(packed, q, 0, False)
        bms, by = bound_ms(*work)
        log(f"northstar topk rate_grid_packed {col} column ({q.op}): ms "
            f"{ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} ({by}, "
            f"{work[0]} bytes) max_abs_err {err:.3e} ok")
        out.append({"kernel": "rate_grid_packed", "column": col, "op": q.op,
                    "ms": ms, "plain_ms": pms, "bound_ms": bms,
                    "bound_by": by, "bytes": work[0], "max_abs_err": err})
    return out


def northstar_second_ops(cases, reps: int, flush) -> list:
    """The grouped kernels in the second op set at the benchmark's widths,
    on the data the north-star variants hold: rate_grid_grouped in the 13
    ops (the five that read timestamps over the dense variant's ts plane),
    rate_grid_grouped_packed and hist_grid_grouped_packed in the 8 that
    read none; each once against its plain version (its launches counted
    on that call, none of them on a direct kernel), then timed."""
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
        before, d0 = fn.launches, fn.direct
        got = fn(*args)
        launched = fn.launches - before
        if fn.direct != d0:
            raise AssertionError(f"northstar {kname} {op}: the direct "
                                 f"kernel ran, expected the staged one")
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


# ------------------------------------------------------------- phase 7

DURABLE_HOURS = (60, 60, 60, 60, 20)   # rows of each hour's container set
DURABLE_CRASH = 3                      # hours store A ingests before its crash
DURABLE_SPAN = (T0 + 201 * STEP, 60)   # the last hour: windows end at rows 200-259
D1_QUERY = "sum by (pod)(rate(req_total[5m]))"
# the paging shard's page cache (``page-cache-size``): a deployment
# choice, sized to hold the node's series paged whole (481 MB at 261
# rows here), so that a dashboard's repeat hit over the history is served
# from the grid.  At the default 256 MB they do not fit, and neither
# the port nor the reference serves the repeat hit from the grid
# (tests/test_torch_odp_grid.py, the undersized page cache)
DURABLE_PAGE_CACHE = 1 << 30
HISTORY_REPS = 1                       # warm runs of D4's engine queries


def pod_hour_containers(schema, pod: int, seed: int) -> list:
    """``req_total``'s pod ``pod`` (``pod_series``' data, as
    ``pod_containers`` encodes it) cut into hours of rows: one
    RecordContainer set an hour of ``DURABLE_HOURS``, the order in which
    a Kafka partition delivers a shard's records."""
    import numpy as np
    from filodb_tpu_torch.core.record import RecordBuilder

    ts, vals, _keep = pod_series(pod, seed, False)
    out, r0 = [], 0
    for n in DURABLE_HOURS:
        b = RecordBuilder(schema)
        for s in range(POD_SERIES):
            b.add_series(ts[s, r0:r0 + n],
                         [vals[s, r0:r0 + n].astype(np.float64)],
                         series_tags("req_total", pod, s))
        out.append(b.containers())
        r0 += n
    return out


def _pod_hours_task(seed: int, pod: int) -> list:
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    return pod_hour_containers(DEFAULT_SCHEMAS["prom-counter"], pod, seed)


class PodHours:
    """{pod: [hour -> containers]} of ``pods`` pods, encoded in a pool of
    DURABLE_WORKERS processes (one pod a task) that starts at once: the
    script starts it before the build, so the encoding runs beside the
    ``nvcc`` processes, and the durable phase collects it."""

    def __init__(self, seed: int, pods: int):
        import multiprocessing

        self.t0 = time.perf_counter()
        self._pool = multiprocessing.get_context("spawn").Pool(
            DURABLE_WORKERS, initializer=_encoder_init)
        self._res = self._pool.map_async(partial(_pod_hours_task, seed),
                                         range(pods))
        self._pool.close()
        self._got = None

    def get(self) -> tuple:
        """(hours, seconds from the start until every pod was encoded,
        seconds waited here); the durable phase collects it, the rollup
        phase takes it again."""
        if self._got is None:
            t0 = time.perf_counter()
            hours = dict(enumerate(self._res.get()))
            waited = time.perf_counter() - t0
            self._pool.join()
            self._got = hours, time.perf_counter() - self.t0, waited
        return self._got

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()


def durable_stream(hours: dict, pods) -> tuple:
    """The time-major stream of ``pods``' hourly container sets: every
    pod's hour 0, then every pod's hour 1, ...; offsets 0, 1, 2, ...
    Returns ``[(offset, container)]`` and, for each (hour, pod), the
    first offset and the cumulative record counts of its containers
    (records are fixed-size, series-major within a set)."""
    import numpy as np

    stream, layout = [], {}
    for h, n in enumerate(DURABLE_HOURS):
        for pod in pods:
            conts = hours[pod][h]
            body = [len(c) - 4 for c in conts]
            rec, rem = divmod(sum(body), POD_SERIES * n)
            if rem or any(b % rec for b in body):
                raise AssertionError(f"pod {pod} hour {h}: records are not "
                                     f"of one size")
            layout[h, pod] = (len(stream), np.concatenate(
                ([0], np.cumsum([b // rec for b in body]))))
            stream += [(len(stream) + i, c) for i, c in enumerate(conts)]
    return stream, layout


def row_offsets(layout, hour: int, pod: int):
    """``[POD_SERIES, rows]``: the stream offset of each series' rows in
    ``hour``."""
    import numpy as np

    first, cum = layout[hour, pod]
    n = DURABLE_HOURS[hour]
    rec = np.arange(POD_SERIES * n).reshape(POD_SERIES, n)
    return first + np.searchsorted(cum, rec, side="right") - 1


def durable_store(device, root: str, trace=None):
    """A memstore over the sqlite files in ``root``, StoreConfig at its
    defaults (flush-interval 1 h, 60 groups, 400-row chunks, demand
    paging on: a paging shard) but the page cache, sized to the working
    set (DURABLE_PAGE_CACHE), and ``trace_filters`` (``trace``)."""
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.core.storeconfig import StoreConfig
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.store.persistence import (DiskColumnStore,
                                                    DiskMetaStore)

    ms = TimeSeriesMemStore(DiskColumnStore(os.path.join(root, "chunks.db")),
                            DiskMetaStore(os.path.join(root, "meta.db")),
                            device=device)
    shard = ms.setup("prom", DEFAULT_SCHEMAS, 0,
                     StoreConfig(page_cache_bytes=DURABLE_PAGE_CACHE,
                                 trace_filters=trace))
    return ms, shard


def drive(ms, shard, stream, flush_remaining: bool) -> dict:
    """Ingest ``stream`` through ``ingest_stream``'s scheduled mode, at
    the store's flush-interval and flush-task-parallelism, ending with
    or without a flush of what is buffered (without: a crash).  Records
    the offset each flush task snapshotted, by group, and each task's
    ingestion time, in submission order."""
    snapped: dict = {}
    tasks = []
    itimes = []
    prepare = shard.prepare_flush_group

    def recording(group, ingestion_time=None):
        task = prepare(group, ingestion_time)
        snapped[group] = task.offset
        tasks.append(group)
        itimes.append(task.ingestion_time)
        return task

    shard.prepare_flush_group = recording
    t0 = time.perf_counter()
    try:
        samples = ms.ingest_stream(
            shard.dataset, shard.shard_num, stream,
            flush_interval_ms=shard.config.flush_interval_ms,
            flush_parallelism=shard.config.flush_task_parallelism,
            flush_remaining=flush_remaining)
    finally:
        del shard.prepare_flush_group
    return {"samples": samples, "seconds": time.perf_counter() - t0,
            "flush_tasks": len(tasks), "snapped": snapped,
            "task_groups": tasks, "itimes": itimes}


def recover(device, root: str, stream, on_prepared=None) -> tuple:
    """Store B over store A's files, recovered the way the reference's
    node does (filodb_tpu/coordinator/node.py:173-215): the index from
    the persisted part keys, the group watermarks from the checkpoints
    (``on_prepared(ms)`` is called then), then the stream from the
    resume offset through a new scheduler, flushing what remains at its
    end."""
    ms, shard = durable_store(device, root)
    t0 = time.perf_counter()
    n_index = ms.recover_index("prom", 0)
    resume, highest = ms.prepare_recovery("prom", 0)
    if resume is None:
        raise AssertionError("recovery found no checkpoint")
    prepared = on_prepared(ms) if on_prepared is not None else None
    run = drive(ms, shard, stream[resume:], flush_remaining=True)
    run.update(index=n_index, resume=resume, highest=highest,
               skipped=shard.stats.rows_skipped,
               seconds=time.perf_counter() - t0, prepared=prepared)
    return ms, shard, run


def flush_quantiles(counts, buckets) -> tuple:
    """p50 and p99 of filodb_flush_seconds from its bucket counts (linear
    within a bucket, as Prometheus' histogram_quantile)."""
    total = sum(counts)
    out = []
    for q in (0.5, 0.99):
        rank, cum, lo = q * total, 0, 0.0
        for i, c in enumerate(counts):
            hi = buckets[i] if i < len(buckets) else float("inf")
            if c and cum + c >= rank:
                out.append(hi if hi == float("inf") else
                           lo + (hi - lo) * (rank - cum) / c)
                break
            cum += c
            lo = hi
    return tuple(out)


def check_readback(store, series: dict, layout, checkpoints: dict) -> dict:
    """``read_raw_partitions`` over every part key must decode to exactly
    the samples of the containers each series' group checkpointed: none
    lost, none twice, the values bit for bit."""
    import numpy as np
    from filodb_tpu_torch.core.chunk import decode_chunkset
    from filodb_tpu_torch.core.record import parse_partkey, partition_hash
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.core.storeconfig import StoreConfig

    schema = DEFAULT_SCHEMAS["prom-counter"]
    ngroups = StoreConfig().groups_per_shard
    pks = [r.partkey for r in store.scan_part_keys("prom", 0)]
    t0 = time.perf_counter()
    got = dict(store.read_raw_partitions("prom", 0, pks, 0, 2**62))
    read_s = time.perf_counter() - t0
    samples = chunks = 0
    seen = set()
    offsets = {}                # pod -> [POD_SERIES, rows before the crash]
    for pk in pks:
        tags = parse_partkey(pk)
        pod, s = int(tags["pod"][4:]), int(tags["instance"][2:])
        cp = checkpoints.get(partition_hash(tags) % ngroups, -1)
        ts, vals = series[pod]
        if pod not in offsets:
            offsets[pod] = np.concatenate(
                [row_offsets(layout, h, pod) for h in range(DURABLE_CRASH)],
                axis=1)
        rows = np.flatnonzero(offsets[pod][s] <= cp)
        css = got.get(pk, [])
        if not len(rows):
            if css:
                raise AssertionError(f"{tags}: chunks past the checkpoint")
            continue
        dec = [decode_chunkset(schema, cs) for cs in css]
        got_ts = np.concatenate([d[0] for d in dec])
        got_v = np.concatenate([d[1][0] for d in dec])
        if not (np.array_equal(got_ts, ts[s, rows])
                and np.array_equal(got_v.view(np.int64),
                                   vals[s, rows].astype(np.float64)
                                   .view(np.int64))):
            raise AssertionError(f"{tags}: {len(got_ts)} samples read back, "
                                 f"{len(rows)} checkpointed; they differ")
        samples += len(rows)
        chunks += len(css)
        seen.add(pk)
    if len(seen) != len(got):
        raise AssertionError("read back part keys that were not asked")
    return {"partkeys": len(pks), "samples": samples, "chunks": chunks,
            "read_seconds": read_s,
            "seconds": time.perf_counter() - t0}


def history_span(cache) -> tuple:
    """(first step, steps) of the history queries D3/D4: every step whose
    window lies on the recovered grid (its epoch is the earliest
    replayed row: the first window covers buckets 0..K-1) up to the
    stream's end.  Older windows are on disk only and no grid serves
    them (c0 < 0), paged or not."""
    steps0 = cache.epoch0 + (K - 1) * STEP
    return steps0, (T0 + N_ROWS * STEP - steps0) // STEP + 1


def extra_row_containers(series: dict, pods) -> list:
    """One more minute of ``req_total`` (row N_ROWS) for every series of
    ``pods``: a live node keeps ingesting, and the rows stay in the
    write buffers until a flush or an eviction persists them."""
    import numpy as np
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS

    b = RecordBuilder(DEFAULT_SCHEMAS["prom-counter"])
    for pod in pods:
        ts, vals = series[pod]
        for s in range(POD_SERIES):
            b.add_series(ts[s, -1:] + STEP,
                         [vals[s, -1:].astype(np.float64) + 1.0],
                         series_tags("req_total", pod, s))
    return b.containers()


def check_all_rows_on_disk(store, series: dict, victim) -> dict:
    """After the eviction every acknowledged row of every series must be
    in sqlite exactly once: the stream's N_ROWS rows and the extra one,
    in one read and one native decode pass, but the rows of the
    quarantined chunk (``victim``: (partkey, start, end)), which the
    read drops."""
    import numpy as np
    from filodb_tpu_torch import native
    from filodb_tpu_torch.core.record import parse_partkey

    nb = native.batch_decoder()
    if nb is None:
        raise AssertionError(f"the native batch decoder is missing: "
                             f"{native.build_error()}")
    t0 = time.perf_counter()
    rows = store.read_raw_rows("prom", 0, None, 0, 2**62)
    read_s = time.perf_counter() - t0
    counts = [r[2] for r in rows]
    ts, vals = nb.page_decode([r[6] for r in rows], counts,
                              [(0, False), (1, True)])
    offs = np.concatenate(([0], np.cumsum(counts)))
    seen, samples, i = 0, 0, 0
    while i < len(rows):
        j = i
        while j < len(rows) and rows[j][0] == rows[i][0]:
            j += 1
        pk = rows[i][0]
        tags = parse_partkey(pk)
        pod, s = int(tags["pod"][4:]), int(tags["instance"][2:])
        want_ts = np.append(series[pod][0][s], series[pod][0][s, -1] + STEP)
        want_v = np.append(series[pod][1][s].astype(np.float64),
                           float(series[pod][1][s, -1]) + 1.0)
        if pk == victim[0]:
            keep = (want_ts < victim[1]) | (want_ts > victim[2])
            want_ts, want_v = want_ts[keep], want_v[keep]
        got_ts = ts[offs[i]:offs[j]]
        got_v = vals[offs[i]:offs[j]]
        if not (np.array_equal(got_ts, want_ts)
                and np.array_equal(got_v.view(np.int64),
                                   want_v.view(np.int64))):
            raise AssertionError(f"{tags}: {len(got_ts)} rows on disk after "
                                 f"the eviction, {len(want_ts)} "
                                 f"acknowledged; they differ")
        seen += 1
        samples += len(got_ts)
        i = j
    if seen != REQ_PODS * POD_SERIES:
        raise AssertionError(f"{seen} series on disk after the eviction")
    return {"series": seen, "samples": samples, "chunks": len(rows),
            "read_seconds": read_s,
            "seconds": time.perf_counter() - t0}


def engine_on_card(name, res, host, span, device) -> dict:
    """An engine result's rows, after the shape and device checks, and
    the quarantined chunk counted where the window covers it."""
    rows = engine_rows(res, host)
    for k, v in rows.items():
        if v.shape != (span[1],):
            raise AssertionError(f"{name}: row {k} shape {v.shape}")
    where = {getattr(b.values, "device", "host") for b in res.batches}
    if where != {device}:
        raise AssertionError(f"{name}: the result is on {where}")
    if res.stats.corrupt_chunks_excluded != 1:
        raise AssertionError(f"{name}: corrupt_chunks_excluded "
                             f"{res.stats.corrupt_chunks_excluded}, the "
                             f"quarantined chunk lies in the window")
    return rows


def same_rows(name, rows, want, rtol) -> float:
    """Two answers of the card, row for row: the same keys, NaN cells,
    finite values within ``rtol``."""
    import numpy as np
    import torch
    if set(rows) != set(want):
        raise AssertionError(f"{name}: {len(rows)} rows, {len(want)} "
                             f"expected")
    keys = sorted(rows, key=str)
    return compare(torch.as_tensor(np.stack([rows[k] for k in keys])),
                   torch.as_tensor(np.stack([want[k] for k in keys])),
                   "sum", rtol)


def history_queries(ms, shard, tms, looked, span, cache, qg, qs, counts,
                    device) -> tuple:
    """D3: the history queries on the recovered store.  The residents
    hold their replayed tail, so the grid refuses (the disk floor), and
    the general path pages the older chunks from sqlite (backfill).
    Returns (report, {kind: rows})."""
    from filodb_tpu_torch.memstore.devicestore import _ids_fingerprint
    from filodb_tpu_torch.query.logical import RangeFunctionId as F

    run_query(shard, "grouped", F.RATE, span, looked, served=False)
    run_query(shard, "series", F.RATE, span, looked, served=False)
    # the floor the grid computed for these partitions in this epoch
    floor = cache._disk_floor.get((shard.ingest_epoch, shard.removal_epoch,
                                   _ids_fingerprint(looked[0])))
    lo = cache.epoch0 - STEP          # the first window's lower bucket edge
    if floor is None or not lo < floor:
        raise AssertionError(f"the grid refused D3, but not for its disk "
                             f"floor ({floor} against {lo})")
    before = counts()
    out, rows_by = {}, {}
    for kind, q in (("grouped", qg), ("series", qs)):
        res, host, cold = run_engine(ms, q, span, None)
        rows = engine_on_card(f"D3:{kind}", res, host, span, device)
        ref = engine_rows(*run_engine(tms, q, span, None)[:2])
        err = check_engine(f"D3:{kind}", rows, ref, None, RTOL_CPU)
        # no warm run: the general path's warm cost is D4's first hit's
        # and the cold one's but the backfill (a depth cut, PERF.md §4)
        out[kind] = {"cold_wall_ms": cold,
                     "cold_stage_seconds": res.stats.timings,
                     "chunks_paged": res.stats.chunks_scanned,
                     "cpu_check_err": err}
        rows_by[kind] = rows
        log(f"D3 {q!r} over rows {(span[0] - WINDOW - T0) // STEP + 1}-"
            f"{N_ROWS - 1} ({span[1]} steps), {len(rows)} rows: the grid "
            f"refused it (disk floor at row {(floor - T0) // STEP}), the "
            f"general path backfilled from sqlite; cold wall_ms "
            f"{cold:.3f} (stages {res.stats.timings}); cpu-twin check ok "
            f"(max_abs_err {err:.3e}); corrupt_chunks_excluded 1")
    if counts() != before:
        raise AssertionError("D3 launched a grid kernel")
    out["disk_floor_row"] = (floor - T0) // STEP
    return out, rows_by


def check_history_samples(shard, looked, series, span, victim) -> None:
    """The samples the general path reads for pod 0 over D3's range are
    the stream's own, bit for bit (the quarantined chunk's rows left
    out): the backfilled older chunks and the replayed tail joined."""
    import numpy as np

    ids, _g, pods, tags = looked
    sel = [i for i, t in enumerate(tags) if t["pod"] == pods[0]]
    lo, hi = span[0] - WINDOW, span[0] + (span[1] - 1) * STEP
    got_tags, batch = shard.scan_batch([int(ids[i]) for i in sel], lo, hi)
    counts = np.asarray(batch.row_counts)
    pod = int(pods[0][4:])
    for r, t in enumerate(got_tags):
        s = int(t["instance"][2:])
        ts, vals = series[pod][0][s], series[pod][1][s].astype(np.float64)
        keep = (ts >= lo) & (ts <= hi)
        pk = shard.index.partkey(int(ids[sel[r]]))
        if pk == victim[0]:
            keep &= (ts < victim[1]) | (ts > victim[2])
        n = int(counts[r])
        if not (np.array_equal(np.asarray(batch.timestamps)[r, :n], ts[keep])
                and np.array_equal(np.asarray(batch.values)[r, :n],
                                   vals[keep])):
            raise AssertionError(f"D3: {t} read back {n} samples, the "
                                 f"stream has {int(keep.sum())}")
    log(f"D3: the general path's samples for {pods[0]} ({len(got_tags)} "
        f"series) are the stream's own, bit for bit")


def page_in_query(ms, shard, tms, span, qg, d3, counts, device) -> dict:
    """D4's first hit after the eviction: nothing is resident, the grid
    cannot resolve the partitions, and the general path pages every one
    in through the bulk path (one sqlite read, the native decoder with
    its CRC pass, the query's batch decoded straight into place)."""
    from filodb_tpu_torch.utils.devicewatch import FLIGHT, LEDGER

    n = REQ_PODS * POD_SERIES
    paged0, chunks0 = shard.stats.partitions_paged, shard.stats.chunks_paged
    seq0 = max((e["seq"] for e in FLIGHT.events(kind="odp.pagein")),
               default=-1)
    before = counts()
    res, host, wall = run_engine(ms, qg, span, None)
    if counts() != before:
        raise AssertionError("D4's first hit launched a grid kernel")
    t0 = time.perf_counter()
    shard._join_materialize()
    publish_s = time.perf_counter() - t0
    paged = shard.stats.partitions_paged - paged0
    recs = [e for e in FLIGHT.events(kind="odp.pagein") if e["seq"] > seq0]
    if paged != n or res.stats.pages_in != n or len(recs) != 1 \
            or recs[0]["partitions"] != n:
        raise AssertionError(f"D4's first hit paged {paged} partitions "
                             f"({res.stats.pages_in} in its stats, page-in "
                             f"records {recs}), not {n} in one bulk read")
    if shard.stats.page_decode_corrupt or shard.stats.page_publish_errors \
            or len(shard.paged) != n:
        raise AssertionError(f"page cache {len(shard.paged)} partitions, "
                             f"{shard.stats}")
    rows = engine_on_card("D4:first", res, host, span, device)
    err_d3 = same_rows("D4 first hit against D3", rows, d3["grouped"],
                       RTOL_KERNEL)
    twin = engine_rows(*run_engine(tms, qg, span, None)[:2])
    err = check_engine("D4:first", rows, twin, None, RTOL_CPU)
    # the bytes and budget the shard's LEDGER pool samples, which must
    # be its own page cache's
    pool = LEDGER.pools().get(shard._ledger_owner)
    if pool != {"bytes": shard.paged._bytes,
                "budget": shard.paged.max_bytes}:
        raise AssertionError(f"the LEDGER pool {shard._ledger_owner} reads "
                             f"{pool}, the page cache holds "
                             f"{shard.paged._bytes} of "
                             f"{shard.paged.max_bytes} bytes")
    cap = shard.config.max_data_per_shard_query
    pks = [shard.index.partkey(int(p)) for p in shard.part_set.values()]
    scan = ms.store.scan_bytes("prom", 0, pks, span[0] - WINDOW,
                               span[0] + (span[1] - 1) * STEP)
    whole = ms.store.scan_bytes("prom", 0, pks, 0, 2**62)
    out = {"wall_ms": wall, "page_in_s": res.stats.timings.get("decode"),
           "stages": res.stats.timings, "partitions": paged,
           "chunks": shard.stats.chunks_paged - chunks0,
           "publish_wait_s": publish_s, "page_cache_bytes": pool["bytes"],
           "page_cache_budget": pool["budget"], "scan_bytes": scan,
           "history_bytes": whole, "cap_bytes": cap,
           "d3_err": err_d3, "cpu_check_err": err}
    log(f"D4 first hit {qg!r}: paged {paged} partitions, {out['chunks']} "
        f"chunks in one bulk read (page-in {out['page_in_s']:.3f} s of "
        f"{wall / 1e3:.3f} s wall; stages {res.stats.timings}; the "
        f"publish joined {publish_s:.3f} s later); page cache "
        f"{pool['bytes']} of {pool['budget']} bytes; scan "
        f"{scan} bytes of the {cap}-byte cap (the whole history "
        f"{whole}); against D3 max_abs_err {err_d3:.3e}, cpu-twin check "
        f"ok (max_abs_err {err:.3e})")
    return out


def paged_grid_queries(ms, shard, tms, looked, span, qg, qs, d3, counts,
                       reps, device) -> tuple:
    """D4's repeat hits over the paged partitions: the grid serves them
    (B1) in both forms, against D3 and the CPU twin; the seam's warm
    latency.  Returns (report, the grouped plan)."""
    import torch
    from filodb_tpu_torch.ops import grid
    from filodb_tpu_torch.query.logical import RangeFunctionId as F

    cache = grid_cache(shard, False)
    out = {}
    for kind, q in (("grouped", qg), ("series", qs)):
        builds0, before = cache.builds, counts()
        res, host, cold = run_engine(ms, q, span, None)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in counts().items()}
        if ran["rate_grid"] < 1:
            raise AssertionError(f"D4 {kind}: the repeat hit did not run "
                                 f"B1 over the paged grid ({ran})")
        rows = engine_on_card(f"D4:{kind}", res, host, span, device)
        err_d3 = same_rows(f"D4:{kind} against D3", rows, d3[kind],
                           RTOL_KERNEL)
        twin = engine_rows(*run_engine(tms, q, span, None)[:2])
        err = check_engine(f"D4:{kind}", rows, twin, None, RTOL_CPU)
        warm, wspread, stages = warm_engine(ms, q, span, None,
                                            HISTORY_REPS)
        out[kind] = {"cold_wall_ms": cold, "blocks_built":
                     cache.builds - builds0, "launches": ran,
                     "warm_engine_ms": warm,
                     "warm_engine_p10_p90": wspread,
                     "warm_stage_ms": stages, "d3_err": err_d3,
                     "cpu_check_err": err}
        log(f"D4 repeat hit {q!r}: the grid over paged partitions, "
            f"launches {ran}, {out[kind]['blocks_built']} blocks built, "
            f"cold wall_ms {cold:.3f}; warm engine median of "
            f"{HISTORY_REPS} {warm:.3f} (p10 {wspread[0]:.3f}, p90 "
            f"{wspread[1]:.3f}; stage ms {stages}); against D3 max_abs_err "
            f"{err_d3:.3e} (rtol {RTOL_KERNEL}), cpu-twin check ok "
            f"(max_abs_err {err:.3e})")
    run_query(shard, "grouped", F.RATE, span, looked)
    plan = list(cache._plan_memo.values())[-1]
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_query(shard, "grouped", F.RATE, span, looked)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    p10, p90 = spread(walls)
    out["warm_wall_ms"] = statistics.median(walls)
    out["warm_wall_p10_p90"] = (p10, p90)
    out["blocks"] = len(plan.segs)
    out["mode"] = grid._mode_for(plan.q, plan.phase)
    log(f"D4 seam sum by (pod)(rate) over paged partitions: warm median of "
        f"{reps} wall_ms {out['warm_wall_ms']:.3f} (p10 {p10:.3f}, p90 "
        f"{p90:.3f}), {len(plan.segs)} blocks, {out['mode']} mode")
    return out, plan


# ------------------------------------------------------------- D5

DS_RESOLUTIONS = (60_000, 3_600_000)   # the reference's DEFAULT_RESOLUTIONS_MS
HOUR = 3_600_000
# store A flushes rows 0-119 of every series before its crash (rows 0-179
# of the series in pod 0's first container of each hour): the 1 min
# dataset's windows end inside that span
DS_MIN_SPAN = (T0 + 66 * STEP, 54)
# T0 is 14 minutes past an hour: the 1 h periods end after rows 45, 105
# and 165; the 1 h dataset is asked at the last two, a step an hour
DS_HOUR_SPAN = (T0 + 106 * STEP, 2)
DS_QUERIES = (("1m", "grouped", "sum by (pod)(rate(req_total[5m]))"),
              ("1m", "series", "rate(req_total[5m])"),
              ("1h", "grouped", "sum by (pod)(increase(req_total[2h]))"))
TRACED = {"pod": "pod-007", "instance": "i-0042"}   # the traced series
DS_REPS = 1                            # warm runs of each D5a query
DS_BATCH_TASKS = 15                    # D5b: the first round's first tasks
LEDGER_REPS = 3                        # D1 engine runs a ledger setting
LEDGER_PROGRAMS = ("devicestore.grouped", "grid.rate_grid")


class TaskPublisher:
    """The in-process downsample publisher, which also files what each
    flush task published under the task's ingestion time (the flush
    task's thread names it in ``local.itime``)."""

    def __init__(self):
        from filodb_tpu_torch.downsample import MemoryDownsamplePublisher
        self.inner = MemoryDownsamplePublisher()
        self.local = threading.local()
        self.by_itime: dict = {}
        self._lock = threading.Lock()

    def publish(self, resolution_ms, shard, containers) -> None:
        self.inner.publish(resolution_ms, shard, containers)
        with self._lock:
            self.by_itime.setdefault(
                (getattr(self.local, "itime", None), resolution_ms),
                []).extend(containers)

    def drain(self, resolution_ms: int) -> list:
        return self.inner.drain(resolution_ms)


def downsample_into(shard, pub: TaskPublisher) -> None:
    """Store A downsamples every flushed chunk at DS_RESOLUTIONS into
    ``pub``, each flush task's output filed under its ingestion time."""
    shard.enable_downsampling(pub, DS_RESOLUTIONS)
    run = shard.run_flush_task

    def tagged(task):
        pub.local.itime = task.ingestion_time
        try:
            return run(task)
        finally:
            pub.local.itime = None

    shard.run_flush_task = tagged


class PathSplit:
    """Counts, a resolution, the series the downsampler's grid path
    served and those it emitted on the host path (flush-task threads
    add under a lock)."""

    def __enter__(self):
        from filodb_tpu_torch.downsample import griddown, sharddown
        self.grid: dict = {}
        self.host: dict = {}
        lock = threading.Lock()
        self._mods = (griddown, sharddown.ShardDownsampler)
        self._real = (griddown.grid_outputs,
                      sharddown.ShardDownsampler._emit)
        real_grid, real_emit = self._real

        def grid_outputs(staged, res, *a, **kw):
            got = real_grid(staged, res, *a, **kw)
            if got is not None:
                with lock:
                    self.grid[res] = self.grid.get(res, 0) + int(got[0].sum())
            return got

        def emit(sampler, builder, tags, ts, cols, res):
            with lock:
                self.host[res] = self.host.get(res, 0) + 1
            return real_emit(sampler, builder, tags, ts, cols, res)

        griddown.grid_outputs = grid_outputs
        sharddown.ShardDownsampler._emit = emit
        return self

    def __exit__(self, *exc):
        griddown, cls = self._mods
        griddown.grid_outputs, cls._emit = self._real
        return False


class TraceLines(logging.Handler):
    """Collects the ``filodb.trace`` log lines while installed."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list = []

    def __enter__(self):
        self._log = logging.getLogger("filodb.trace")
        self._saved = (self._log.level, self._log.propagate)
        self._log.setLevel(logging.INFO)
        self._log.propagate = False
        self._log.addHandler(self)
        return self

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())

    def __exit__(self, *exc):
        self._log.removeHandler(self)
        self._log.level, self._log.propagate = self._saved
        return False


def period_reduce_ms(device, shard, reps: int) -> float:
    """The grid path's period reduce alone, by CUDA events behind a spin
    kernel (host enqueue excluded), at a flush task's shape: one group's
    share of the series over the 120 rows a round's grid stages, f64,
    K = 1 (the 1 h planes cascade on the host)."""
    import torch
    from filodb_tpu_torch.downsample import griddown

    n = -(-shard.num_partitions // shard.num_groups)
    v = torch.rand((120, n), dtype=torch.float64, device=device) * 1e6
    return cuda_ms(partial(griddown._period_reduce_impl, v, 120, 1), reps)


def check_trace(shard, store, lines: list) -> dict:
    """The traced series (TRACED) logged exactly its ingested rows and
    its chunk freezes, and nothing was logged for any other series."""
    from filodb_tpu_torch.memstore.partition import \
        TracingTimeSeriesPartition

    traced = [p for p in shard.partitions.values()
              if isinstance(p, TracingTimeSeriesPartition)]
    if len(traced) != 1 or any(traced[0].tags.get(k) != v
                               for k, v in TRACED.items()):
        raise AssertionError(f"traced partitions: "
                             f"{[p.tags for p in traced]}")
    part = traced[0]
    rows = sum(DURABLE_HOURS[:DURABLE_CRASH])
    ingests = [ln for ln in lines if ln.startswith("TRACE ingest")]
    freezes = [ln for ln in lines if ln.startswith("TRACE freeze")]
    on_disk = [c for _pk, cs in store.read_raw_partitions(
        "prom", 0, [part.partkey], 0, 2**62) for c in cs]
    if len(ingests) != rows or len(freezes) != len(part.chunks) \
            or len(freezes) != len(on_disk) \
            or len(ingests) + len(freezes) != len(lines) \
            or not all(f"part={part.part_id} " in ln for ln in lines):
        raise AssertionError(f"trace: {len(ingests)} ingest lines for "
                             f"{rows} rows, {len(freezes)} freezes for "
                             f"{len(part.chunks)} chunks ({len(on_disk)} "
                             f"on disk), {len(lines)} lines in all")
    return {"part_id": part.part_id, "ingest_lines": len(ingests),
            "freeze_lines": len(freezes)}


def check_watermarks(ledger, snapped: dict, cps: dict, ingested: int,
                     name: str) -> dict:
    """A's watermark row after its drive: each group's flushed
    watermark the offset its last flush task snapshotted, the checkpoint
    the meta store's, no lag (no broker), no stall."""
    from filodb_tpu_torch.utils.devicewatch import FLIGHT

    row = ledger.sample()["datasets"]["prom"]["shards"][0]
    wm = row["watermarks"]
    groups = [snapped.get(g, -1) for g in range(len(wm["groups"]))]
    stalls = [e for e in FLIGHT.events(kind="ingest.stall")
              if e.get("node") == ledger.node]
    if wm["groups"] != groups or wm["flushed"] != min(groups) \
            or wm["checkpoint"] != min(cps.values()) \
            or wm["ingested"] != ingested or row["lag"]["rows"] != 0 \
            or row["stalled"] or stalls:
        raise AssertionError(f"{name} watermarks {row}; snapped {snapped}, "
                             f"checkpoints {cps}, stalls {stalls}")
    return {"ingested": wm["ingested"], "flushed": wm["flushed"],
            "checkpoint": wm["checkpoint"], "lag_rows": 0,
            "stalled": False}


def check_recovered_watermarks(node: str, ms, cps: dict) -> dict:
    """Store B's row just after ``prepare_recovery``: its groups start at
    A's checkpoints."""
    from filodb_tpu_torch.memstore.watermarks import WatermarkLedger

    ledger = WatermarkLedger(node=node)
    ledger.watch("prom", ms)
    try:
        wm = ledger.sample()["datasets"]["prom"]["shards"][0]["watermarks"]
    finally:
        ledger.close()
    want = [cps.get(g, -1) for g in range(len(wm["groups"]))]
    if wm["groups"] != want or wm["checkpoint"] != min(cps.values()):
        raise AssertionError(f"store B's watermarks {wm}, A's checkpoints "
                             f"{cps}")
    return {"groups_from_checkpoints": True, "checkpoint":
            wm["checkpoint"]}


def ds_rows_of_containers(containers, schemas, pk_ids: dict):
    """(pk id, ts, value bits) rows of published containers, by the
    native columnar decoder.  A container's part keys are the canonical
    bytes a chunk carries (``RecordBuilder.series_key``)."""
    import numpy as np
    from filodb_tpu_torch.native import ingestfast

    parts = []
    for c in containers:
        dec = ingestfast.decode(c, schemas)
        if dec is None:
            raise AssertionError("a published container is not columnar")
        ids = np.asarray([pk_ids.setdefault(bytes(pk), len(pk_ids))
                          for pk in dec.partkeys], dtype=np.int64)
        parts.append(np.stack([ids[dec.uniq_idx], dec.ts,
                               np.asarray(dec.cols[0], np.float64).view(
                                   np.int64)], axis=1))
    return np.concatenate(parts) if parts else np.zeros((0, 3), np.int64)


def ds_rows_of_chunks(store, dataset: str, schema, pk_ids: dict):
    """(pk id, ts, value bits) rows of a dataset's chunks, decoded in one
    native batch."""
    import numpy as np
    from filodb_tpu_torch.core.chunk import decode_partitions_batch

    css = list(store.chunksets_by_ingestion_time(dataset, 0, 0, 2**62))
    parts = []
    for cs, (ts, cols) in zip(css, decode_partitions_batch(
            schema, [[cs] for cs in css])):
        pid = pk_ids.setdefault(bytes(cs.partkey), len(pk_ids))
        parts.append(np.stack([np.full(len(ts), pid, np.int64), ts,
                               np.asarray(cols[0], np.float64).view(
                                   np.int64)], axis=1))
    return (np.concatenate(parts) if parts else np.zeros((0, 3), np.int64),
            len(css))


def sorted_rows(rows):
    """Rows by series, each series' rows in the order they came: both
    sources give one series' rows in time order (a flush task's
    records, one batch-built chunk)."""
    import numpy as np
    return rows[np.argsort(rows[:, 0], kind="stable")]


def batch_job(store, pub: TaskPublisher, itimes: list, device,
              series: int) -> dict:
    """D5b: ``BatchDownsampler.run_shard`` over store A's chunks of
    flush tasks of the first round (the ingestion window of ``itimes``,
    a share of hour 1's, one upstream job run's unit of work; ``series``
    the partitions those tasks flushed); its ds chunks decode row for
    row to what those flush tasks published, at both resolutions."""
    import numpy as np
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.downsample import BatchDownsampler, ds_dataset_name

    lo, hi = min(itimes), max(itimes)
    t0 = time.perf_counter()
    written = BatchDownsampler("prom", DEFAULT_SCHEMAS, store,
                               resolutions_ms=DS_RESOLUTIONS,
                               device=device).run_shard(0, lo, hi)
    secs = time.perf_counter() - t0
    out = {"window_ms": [lo, hi], "seconds": secs, "written": written}
    schema = DEFAULT_SCHEMAS["prom-counter"]
    for res in DS_RESOLUTIONS:
        pk_ids: dict = {}
        flushed = sorted_rows(ds_rows_of_containers(
            [c for it in set(itimes) for c in pub.by_itime.get((it, res), [])],
            DEFAULT_SCHEMAS, pk_ids))
        batch, nchunks = ds_rows_of_chunks(store, ds_dataset_name("prom", res),
                                           schema, pk_ids)
        batch = sorted_rows(batch)
        if nchunks != written[res] or len(batch) == 0 \
                or len(pk_ids) != series \
                or not np.array_equal(batch, flushed):
            raise AssertionError(f"D5b at {res} ms: {len(batch)} batch rows "
                                 f"in {nchunks} chunks, {len(flushed)} "
                                 f"flush-time rows; equal: "
                                 f"{np.array_equal(batch, flushed)}")
        out[str(res)] = {"chunks": nchunks, "rows": int(len(batch)),
                         "series": len(pk_ids)}
    log(f"D5b BatchDownsampler.run_shard over the first {len(itimes)} tasks "
        f"of store A's first flush round (ingestion times {lo}-{hi}): "
        f"{written} chunks written in "
        f"{secs:.3f} s; every row equals the flush-time output, bit for bit "
        f"(1 min: {out['60000']['rows']} rows, 1 h: "
        f"{out['3600000']['rows']} rows, {out['60000']['series']} series)")
    return out


def counter_increase(v) -> float:
    """Prometheus' counter increase over a run of samples: a drop counts
    as a reset from 0."""
    import numpy as np
    v = np.asarray(v, np.float64)
    d = np.diff(v)
    return float(np.where(d >= 0, d, v[1:]).sum())


def check_hour_increase(ds_shard, series: dict) -> dict:
    """A counter's downsample keeps its increase: every 1 h dataset value
    is a raw sample of its period, and each series' increase over its 1 h
    points equals the raw increase between the rows they carry, exactly
    (integer-valued f64).  A reset shows in the 1 h data as a point at
    its pre-reset row followed by a lower one.  Two things hide it, both
    the reference's design: the counter regrowing past the pre-reset
    value by the next point, and a split point older than a period end
    the previous flush already stamped (a partial period), which the
    dataset drops as out of order.  A series with a hidden reset is
    counted apart, not checked."""
    import numpy as np

    pods = sorted(series)
    ts_raw = np.concatenate([series[p][0] for p in pods])      # [S, rows]
    v_raw = np.concatenate([series[p][1] for p in pods]).astype(np.float64)
    phase = ts_raw[:, 0] - T0
    sidx, t_ds, v_ds = [], [], []
    for part in list(ds_shard.partitions.values()):
        t, v = part.read_range(0, 2**62)
        s = (pods.index(int(part.tags["pod"].split("-")[1])) * POD_SERIES
             + int(part.tags["instance"].split("-")[1]))
        sidx.append(np.full(len(t), s))
        t_ds.append(t)
        v_ds.append(v)
    sidx, t_ds, v_ds = (np.concatenate(x) for x in (sidx, t_ds, v_ds))
    # each point's row: the last raw row of its period holding its value
    # (samples sit at T0 + row * STEP + phase)
    hi = np.minimum((t_ds - T0 - phase[sidx]) // STEP, N_ROWS - 1)
    lo = (t_ds - HOUR - T0 - phase[sidx]) // STEP + 1
    row = np.full(len(t_ds), -1)
    for off in range(HOUR // STEP + 1):
        r = hi - off
        hit = (row < 0) & (r >= np.maximum(lo, 0)) \
            & (v_raw[sidx, np.clip(r, 0, N_ROWS - 1)] == v_ds)
        row[hit] = r[hit]
    if (row < 0).any():
        i = int(np.flatnonzero(row < 0)[0])
        raise AssertionError(f"1 h value {v_ds[i]} at {t_ds[i]} is no raw "
                             f"sample of its period")
    same = sidx[1:] == sidx[:-1]
    d = np.diff(v_ds)
    ds_inc = np.bincount(sidx[1:], np.where(same, np.where(
        d >= 0, d, v_ds[1:]), 0.0), minlength=len(v_raw))
    starts = np.flatnonzero(np.concatenate(([True], ~same)))
    ends = np.append(starts[1:], len(sidx)) - 1
    dr = np.diff(v_raw, axis=1)
    cum = np.concatenate((np.zeros((len(v_raw), 1)), np.cumsum(
        np.where(dr >= 0, dr, v_raw[:, 1:]), axis=1)), axis=1)
    s_of = sidx[starts]
    raw_inc = cum[s_of, row[ends]] - cum[s_of, row[starts]]
    hidden = resets = 0
    exact = np.ones(len(starts), bool)
    for k, (a, b) in enumerate(zip(starts, ends)):
        s = s_of[k]
        drops = np.flatnonzero(dr[s, row[a]:row[b]] < 0) + row[a] + 1
        if not len(drops):
            continue
        resets += 1
        rows = row[a:b + 1]
        if any(d - 1 not in rows
               or v_raw[s, rows[rows >= d][0]] >= v_raw[s, d - 1]
               for d in drops):
            hidden += 1
            exact[k] = False
    bad = exact & (ds_inc[s_of] != raw_inc)
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        raise AssertionError(f"series {s_of[k]}: 1 h increase "
                             f"{ds_inc[s_of[k]]}, raw {raw_inc[k]}")
    return {"series": len(starts), "exact": int(exact.sum()),
            "with_reset": resets, "reset_hidden": hidden}


def check_minute_values(ds_shard, series: dict) -> dict:
    """The 1 min dataset of one-minute scrapes holds every flushed raw
    sample: each series' values are its raw rows 0, 1, ..., stamped at
    the minute's end (a reset's split point at the pre-reset sample's
    own timestamp), bit for bit."""
    import numpy as np

    n_rows = 0
    for part in list(ds_shard.partitions.values()):
        tags = part.tags
        pod = int(tags["pod"].split("-")[1])
        s = int(tags["instance"].split("-")[1])
        t, v = part.read_range(0, 2**62)
        rows = (t - T0 - 1) // STEP
        if not np.array_equal(rows, np.arange(len(rows))) \
                or not np.array_equal(v.view(np.int64), series[pod][1][s][
                    rows].astype(np.float64).view(np.int64)):
            raise AssertionError(f"1 min dataset of {tags}: rows "
                                 f"{rows[:5]}..., values differ from the "
                                 f"raw samples")
        n_rows += len(rows)
    return {"series": len(ds_shard.partitions), "rows": n_rows}


def cpu_twin_ds(ds):
    """A DownsampledTimeSeriesStore on the CPU holding the card store's
    ds rows of the first CHECK_PODS pods: the CPU path over the same
    ds data.  (A second flush-time run would not give the same data:
    which rows a flush task finds frozen depends on how far its executor
    lags the ingest, and the 1 h periods split where the chunks do.)"""
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.downsample import (DownsampledTimeSeriesStore,
                                             ds_dataset_name)

    tds = DownsampledTimeSeriesStore("prom", resolutions_ms=DS_RESOLUTIONS,
                                     device="cpu")
    tds.setup(DEFAULT_SCHEMAS, 0)
    for res in DS_RESOLUTIONS:
        b = RecordBuilder(DEFAULT_SCHEMAS["prom-counter"])
        for part in ds.shard(res, 0).partitions.values():
            tags = part.tags
            if int(tags["pod"].split("-")[1]) < CHECK_PODS:
                t, v = part.read_range(0, 2**62)
                b.add_series(t, [v], tags)
        for off, c in enumerate(b.containers()):
            tds.memstore.ingest(ds_dataset_name("prom", res), 0, c, off)
    return tds


def ds_queries(ds, tds, device, counts, reps) -> dict:
    """D5a: the ds datasets through the engine, on the card's
    DownsampledTimeSeriesStore and the CPU twin's.  The 1 min dataset is
    served from the grid (B1; B3 where a block packs); the 1 h one is
    refused by the grid, as the JAX package's grid refuses it
    (tests/test_torch_downsample.py), and served by the general path."""
    import torch
    from filodb_tpu_torch.downsample import ds_dataset_name

    out = {}
    for label, kind, q in DS_QUERIES:
        res_ms = DS_RESOLUTIONS[0] if label == "1m" else DS_RESOLUTIONS[1]
        span, step = (DS_MIN_SPAN, STEP) if label == "1m" \
            else (DS_HOUR_SPAN, HOUR)
        name = ds_dataset_name("prom", res_ms)
        before = counts()
        res, host, cold = run_engine(ds.memstore, q, span, None,
                                     dataset=name, step=step)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in counts().items()}
        rows = engine_rows(res, host)
        for k, v in rows.items():
            if v.shape != (span[1],):
                raise AssertionError(f"D5a {q}: row {k} shape {v.shape}")
        if label == "1m" and ran["rate_grid"] + ran["rate_grid_packed"] < 1:
            raise AssertionError(f"D5a {q}: the grid did not serve the 1 min "
                                 f"dataset ({ran})")
        if label == "1h" and any(ran.values()):
            raise AssertionError(f"D5a {q}: the grid served the 1 h dataset "
                                 f"({ran}), which the JAX grid refuses")
        twin = engine_rows(*run_engine(tds.memstore, q, span, None,
                                       dataset=name, step=step)[:2])
        err = check_engine(f"D5a {label} {kind}", rows, twin, None, RTOL_CPU)
        warm, wspread, stages = warm_engine(ds.memstore, q, span, None, reps,
                                            dataset=name, step=step)
        served = [k for k, n in ran.items() if n] or ["general path"]
        out[f"{label}:{kind}"] = {
            "query": q, "served_by": served, "launches": ran,
            "cold_wall_ms": cold, "warm_wall_ms": warm,
            "warm_wall_p10_p90": wspread, "warm_stage_ms": stages,
            "rows": len(rows), "cpu_check_err": err}
        log(f"D5a {label} dataset {q!r}: served by {served} (launches "
            f"{ran}), {len(rows)} rows; cold wall_ms {cold:.3f}, warm "
            f"median of {reps} {warm:.3f} (p10 {wspread[0]:.3f}, p90 "
            f"{wspread[1]:.3f}; stage ms {stages}); cpu-twin check ok "
            f"(max_abs_err {err:.3e}, rtol {RTOL_CPU})")
    return out


def ledger_on_d1(ms, reps: int) -> dict:
    """D1 through the engine with every launch sampled: each program's
    ledger launches equal its wrapper's count (``devicestore.grouped``
    one a query), every sampled time finite and positive, each query's
    ``device_programs`` present and within its wall; then D1's warm wall
    at the default 1-in-64 against the ledger switched off."""
    import math
    from filodb_tpu_torch.ops import grid
    from filodb_tpu_torch.utils import devicewatch as dw

    q = D1_QUERY
    run_engine(ms, q, DURABLE_SPAN, None)             # warm
    rows0 = {r["program"]: r for r in dw.KERNEL_TIMER.table()}
    b1 = grid.rate_grid.launches
    dw.KERNEL_TIMER.configure(sample_1_in=1)
    try:
        shares = []
        for _ in range(reps):
            res, _host, wall = run_engine(ms, q, DURABLE_SPAN, None)
            progs = res.stats.device_programs
            if set(progs) != set(LEDGER_PROGRAMS) or not all(
                    math.isfinite(s) and s > 0 for s in progs.values()) \
                    or sum(progs.values()) * 1e3 > wall:
                raise AssertionError(f"device_programs {progs} of a "
                                     f"{wall:.3f} ms query")
            shares.append(sum(progs.values()) * 1e3 / wall)
    finally:
        dw.KERNEL_TIMER.configure(sample_1_in=64)
    rows1 = {r["program"]: r for r in dw.KERNEL_TIMER.table()}
    want = {"devicestore.grouped": reps,
            "grid.rate_grid": grid.rate_grid.launches - b1}
    out = {"queries": reps, "device_share_of_wall": shares}
    for p in LEDGER_PROGRAMS:
        a, b = rows0.get(p, {}), rows1[p]
        n = b["launches"] - a.get("launches", 0)
        sampled = b["sampled"] - a.get("sampled", 0)
        secs = b["device_seconds"] - a.get("device_seconds", 0.0)
        if n != want[p] or sampled != n or not (
                math.isfinite(secs) and secs > 0):
            raise AssertionError(f"ledger {p}: {n} launches ({want[p]} "
                                 f"counted), {sampled} sampled, {secs} s")
        out[p] = {"launches": n, "sampled_ms_mean": secs * 1e3 / sampled}
    # in turns, the ledger on (1 in 64) and off, so that drift between
    # runs falls on both
    walls: dict = {True: [], False: []}
    try:
        for i in range(2 * reps):
            dw.set_enabled(i % 2 == 0)
            walls[i % 2 == 0].append(run_engine(ms, q, DURABLE_SPAN,
                                                None)[2])
    finally:
        dw.set_enabled(True)
    on = (statistics.median(walls[True]),)
    off = (statistics.median(walls[False]),)
    out.update(warm_wall_ms_1_in_64=on[0], warm_wall_ms_off=off[0])
    log(f"ledger over D1's engine query, every launch sampled: "
        f"{reps} queries, ledger launches "
        f"{ {p: out[p]['launches'] for p in LEDGER_PROGRAMS} } equal the "
        f"wrappers' counts, sampled ms "
        f"{ {p: round(out[p]['sampled_ms_mean'], 4) for p in LEDGER_PROGRAMS} }"
        f", device_programs at most {max(shares):.3f} of each wall; warm "
        f"wall_ms in turns, median of {reps} each: at 1-in-64 {on[0]:.3f}, "
        f"ledger off {off[0]:.3f}")
    return out


def durable_phase(device, seed: int, reps: int, encoding: PodHours,
                  report: dict, before_timing=None) -> dict:
    """Persistence, integrity and flush: ``req_total`` (100 pods x 1,024
    series, 260 rows) streamed hour by hour into store A on the card
    over sqlite files, flushed by a FlushScheduler; A crashes after
    hour 3; the checkpointed rows are read back from disk and verified;
    store B recovers (index, watermarks, replay) and serves the last
    hour through B1; a flipped byte in one of B's chunks is caught on
    read-back, quarantined, and the grid re-stages without it.  A CPU
    twin runs the same sequence over the first CHECK_PODS pods."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from filodb_tpu_torch import integrity
    from filodb_tpu_torch.integrity.faultinject import FaultInjector
    from filodb_tpu_torch.integrity.scan import verify_chunks
    from filodb_tpu_torch.ops import grid
    from filodb_tpu_torch.query.logical import RangeFunctionId as F
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.downsample import (DownsampledTimeSeriesStore,
                                             ds_dataset_name)
    from filodb_tpu_torch.memstore.watermarks import (WatermarkLedger,
                                                      WatermarkSampler)
    from filodb_tpu_torch.utils import devicewatch
    from filodb_tpu_torch.utils.devicewatch import FLIGHT, LEDGER
    from filodb_tpu_torch.utils.observability import (flush_metrics,
                                                      integrity_metrics)

    out: dict = {}
    d5: dict = {}
    stores = []                 # every memstore opened, shut down at the end
    # the sqlite files live in the checkout's git-ignored build directory
    build = os.path.join(HERE, "filodb_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="durable-", dir=build)
    try:
        with Phase("durable.stream"):
            hours, encode_s, waited = encoding.get()
            series = {p: pod_series(p, seed, False)[:2]
                      for p in range(REQ_PODS)}
            stream, layout = durable_stream(hours, range(REQ_PODS))
            crash_at = layout[DURABLE_CRASH, 0][0]
            twin_stream, twin_layout = durable_stream(hours,
                                                      range(CHECK_PODS))
            twin_crash = twin_layout[DURABLE_CRASH, 0][0]
            del hours
            log(f"stream: {len(stream)} containers, {REQ_PODS} pods x "
                f"{len(DURABLE_HOURS)} hours of rows {DURABLE_HOURS}; the "
                f"crash after offset {crash_at - 1}; encoded in "
                f"{DURABLE_WORKERS} processes, {encode_s:.3f} s after they "
                f"started with the build ({waited:.3f} s waited here)")

        hist = flush_metrics()["flush_seconds"]
        with Phase("durable.ingest_persist"):
            h0 = hist.counts(dataset="prom")
            seq0 = max((e["seq"] for e in FLIGHT.events(kind="flush")),
                       default=-1)
            ms_a, shard_a = durable_store(device, os.path.join(root, "card"),
                                          trace=TRACED)
            stores.append(ms_a)
            # D5: A downsamples every flush at 1 min and 1 h, a watermark
            # ledger samples it each second, one series is traced, and
            # the kernel ledger times every period reduce
            pub_a = TaskPublisher()
            downsample_into(shard_a, pub_a)
            ledger = WatermarkLedger(node="chip-smoke-a")
            ledger.watch("prom", ms_a)
            sampler = WatermarkSampler(ledger, interval_s=1.0)
            reduce0 = {r["program"]: r for r in
                       devicewatch.KERNEL_TIMER.table()}.get(
                           "griddown.period_reduce", {})
            devicewatch.KERNEL_TIMER.configure(sample_1_in=1)
            sampler.start()
            try:
                with PathSplit() as split, TraceLines() as trace:
                    run_a = drive(ms_a, shard_a, stream[:crash_at],
                                  flush_remaining=False)
            finally:
                sampler.stop()
                devicewatch.KERNEL_TIMER.configure(sample_1_in=64)
            h1 = hist.counts(dataset="prom")
            secs = sorted(e["seconds"] for e in FLIGHT.events(kind="flush")
                          if e["seq"] > seq0)
            cps = ms_a.meta.read_checkpoints("prom", 0)
            if cps != run_a["snapped"]:
                raise AssertionError("checkpoints differ from the offsets "
                                     "the flushes snapshotted")
            db = os.path.join(root, "card", "chunks.db")
            mb, wal_mb = (os.path.getsize(db + x) / 2**20
                          if os.path.exists(db + x) else 0.0
                          for x in ("", "-wal"))
            p50, p99 = flush_quantiles([b - a for a, b in zip(h0, h1)],
                                       hist.buckets)
            ex50, ex99 = (np.quantile(secs, [0.5, 0.99]) if secs
                          else (float("nan"),) * 2)
            run_a.update(chunks=shard_a.stats.chunks_flushed,
                         sqlite_mb=mb, sqlite_wal_mb=wal_mb, flush_p50_s=p50, flush_p99_s=p99,
                         flush_task_p50_s=float(ex50),
                         flush_task_p99_s=float(ex99),
                         checkpoints=sorted(set(cps.values())))
            log(f"store A: {run_a['samples']} samples in "
                f"{run_a['seconds']:.3f} s ({run_a['samples'] / run_a['seconds']:.4g} "
                f"samples/s, ingest + persist), {run_a['flush_tasks']} flush "
                f"tasks, {run_a['chunks']} chunks written, filodb_flush_seconds "
                f"p50 {p50:.4g} s p99 {p99:.4g} s (bucket estimate; the tasks' "
                f"own p50 {ex50:.4g} s p99 {ex99:.4g} s), sqlite "
                f"{mb:.1f} MB and its write-ahead log {wal_mb:.1f} MB; "
                f"checkpoints {run_a['checkpoints']}")
            d5["watermarks_a"] = check_watermarks(
                ledger, run_a["snapped"], cps, crash_at - 1, "store A")
            ledger.close()
            d5["trace"] = check_trace(shard_a, ms_a.store, trace.lines)
            red = {r["program"]: r for r in
                   devicewatch.KERNEL_TIMER.table()}[
                       "griddown.period_reduce"]
            n_red = red["launches"] - reduce0.get("launches", 0)
            red_s = red["device_seconds"] - reduce0.get("device_seconds", 0)
            if n_red < 1 or red["sampled"] - reduce0.get("sampled", 0) \
                    != n_red or not red_s > 0:
                raise AssertionError(f"period reduce on the card: {red}")
            reduce_ms = period_reduce_ms(device, shard_a, reps)
            groups, itimes = run_a["task_groups"], run_a["itimes"]
            ngroups = shard_a.num_groups
            if sorted(groups[:ngroups]) != list(range(ngroups)) \
                    or max(itimes[:ngroups]) >= min(itimes[ngroups:]):
                raise AssertionError("the first flush round is not one "
                                     "task a group before the second")
            # D5b's window: the ingestion times of the round's first
            # DS_BATCH_TASKS tasks, and every task inside it
            first = itimes[:DS_BATCH_TASKS]
            window = [(g, it) for g, it in zip(groups, itimes)
                      if min(first) <= it <= max(first)]
            round1 = [it for _g, it in window]
            in_batch = {g for g, _it in window}
            batch_series = sum(1 for p in shard_a.partitions.values()
                               if p.group in in_batch)
            d5["ingest"] = {
                "flush_task_p50_s": float(ex50),
                "flush_task_p99_s": float(ex99),
                "period_reduce": {"launches": n_red, "event_span_s": red_s,
                                  "ewma_ms": red["ewma_device_s"] * 1e3,
                                  "device_ms_at_task_shape": reduce_ms},
                "grid_series": split.grid, "host_series": split.host,
                "published_containers": {
                    str(r): len(pub_a.inner.published[r])
                    for r in DS_RESOLUTIONS}}
            log(f"D5 store A downsampled as it flushed, at {DS_RESOLUTIONS} "
                f"ms: flush tasks p50 {ex50:.4g} s p99 {ex99:.4g} s; {n_red} "
                f"period reduces on the card, {red_s * 1e3:.3f} ms of event "
                f"span "
                f"(CUDA events, every launch sampled; EWMA "
                f"{red['ewma_device_s'] * 1e3:.4f} ms; the reduce alone at a "
                f"flush task's shape, behind a spin kernel: {reduce_ms:.4f} "
                f"ms); series on the grid "
                f"path {split.grid}, on the host path {split.host}; "
                f"watermarks {d5['watermarks_a']} (each group at its last "
                f"snapshot, the checkpoint the meta store's); the traced "
                f"series {TRACED}: {d5['trace']}")
            del run_a["snapped"], run_a["task_groups"], run_a["itimes"]
            out["store_a"] = run_a

        with Phase("durable.read_back"):
            rb = check_readback(ms_a.store, series, layout, cps)
            t0 = time.perf_counter()
            ver = verify_chunks(ms_a.store, "prom", [0])
            ver_s = time.perf_counter() - t0
            row = ver["shards"][0]
            nbytes = ms_a.store._conn().execute(
                "SELECT SUM(LENGTH(vectors)) FROM chunks").fetchone()[0]
            if row["chunks"] != rb["chunks"] or row["failed"] \
                    or row["unchecksummed"]:
                raise AssertionError(f"verify_chunks: {row}")
            rb.update(verify_seconds=ver_s, verify_gb_s=nbytes / ver_s / 1e9,
                      blob_bytes=nbytes)
            log(f"read back {rb['partkeys']} part keys, {rb['chunks']} chunks: "
                f"{rb['samples']} samples, exactly the checkpointed ones "
                f"({rb['read_seconds']:.3f} s to read, {rb['seconds']:.3f} s "
                f"with the decode and check); verify_chunks {row['chunks']} "
                f"chunks, none failed, {ver_s:.3f} s "
                f"({rb['verify_gb_s']:.3f} GB/s of {nbytes} blob bytes)")
            out["read_back"] = rb

        with Phase("durable.batch_downsample"):
            d5["batch"] = batch_job(ms_a.store, pub_a, round1, device,
                                    batch_series)

        with Phase("durable.recover"):
            ms_b, shard_b, run_b = recover(
                device, os.path.join(root, "card"), stream,
                on_prepared=partial(check_recovered_watermarks,
                                    "chip-smoke-b", cps=cps))
            d5["watermarks_b"] = run_b.pop("prepared")
            stores.append(ms_b)
            if run_b["index"] != REQ_PODS * POD_SERIES:
                raise AssertionError(f"recover_index: {run_b['index']} part "
                                     f"keys")
            if shard_b.num_partitions != REQ_PODS * POD_SERIES:
                raise AssertionError(f"{shard_b.num_partitions} partitions "
                                     f"after the replay")
            run_b["chunks"] = shard_b.stats.chunks_flushed
            log(f"store B: recover_index {run_b['index']} part keys, resume "
                f"at offset {run_b['resume']} (highest checkpoint "
                f"{run_b['highest']}), replayed {len(stream) - run_b['resume']} "
                f"containers ({run_b['samples']} samples, "
                f"{run_b['skipped']} records skipped below their group's "
                f"watermark), {run_b['flush_tasks']} flush tasks, "
                f"{run_b['chunks']} chunks; recovery {run_b['seconds']:.3f} s")
            del run_b["snapped"], run_b["task_groups"], run_b["itimes"]
            out["store_b"] = run_b

        with Phase("durable.cpu_twin"):
            twin_root = os.path.join(root, "twin")
            tms_a, tshard_a = durable_store("cpu", twin_root)
            stores.append(tms_a)
            drive(tms_a, tshard_a, twin_stream[:twin_crash],
                  flush_remaining=False)
            tms_b, tshard_b, _trun = recover("cpu", twin_root, twin_stream)
            stores.append(tms_b)
            # flush boundaries follow data time: the twin's chunks are the
            # card's, row for row
            twin_pks = [r.partkey for r in
                        tms_b.store.scan_part_keys("prom", 0)]
            mine = ms_b.store.read_raw_rows("prom", 0, twin_pks, 0, 2**62)
            theirs = tms_b.store.read_raw_rows("prom", 0, twin_pks, 0, 2**62)
            if [r[:7] for r in mine] != [r[:7] for r in theirs]:
                raise AssertionError("the CPU twin's chunks differ from the "
                                     "card's")
            log(f"CPU twin: {CHECK_PODS} pods through the same sequence; its "
                f"{len(theirs)} chunk rows equal the card's (ids, spans, "
                f"blobs)")

        flush = make_flush(device)
        looked = lookup(shard_b, "req_total")
        ref_looked = lookup(tshard_b, "req_total", pods=CHECK_PODS)
        steps0, nsteps = DURABLE_SPAN

        def counts():
            return {k: getattr(grid, k).launches
                    for k in ("rate_grid", "rate_grid_packed")}

        with Phase("durable.serve"):
            grid.reset_launch_counts()          # the durable path's run
            before = counts()
            # D1's cold run through the engine: the residency delta it
            # notes is the ledger's change over the run (its blocks
            # staged), positive; the warm repeat's is 0
            gc.collect()
            resident0 = LEDGER.total_bytes()
            t0 = time.perf_counter()
            res, _host, _wall = run_engine(ms_b, D1_QUERY, DURABLE_SPAN,
                                           None)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            delta = res.stats.hbm_resident_delta_bytes
            tracked = LEDGER.total_bytes() - resident0
            if not 0 < delta == tracked:
                raise AssertionError(f"D1 cold: residency delta {delta}, "
                                     f"the ledger tracked {tracked}")
            warm_delta = run_engine(ms_b, D1_QUERY, DURABLE_SPAN, None)[
                0].stats.hbm_resident_delta_bytes
            if warm_delta != 0:
                raise AssertionError(f"D1 warm: residency delta "
                                     f"{warm_delta}")
            log(f"D1 through the engine: cold residency delta {delta} "
                f"bytes, equal to the ledger's change; warm 0")
            got_g = run_query(shard_b, "grouped", F.RATE, DURABLE_SPAN,
                              looked)
            torch.cuda.synchronize()
            got_s = run_query(shard_b, "series", F.RATE, DURABLE_SPAN,
                              looked)
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in counts().items()}
            cache = grid_cache(shard_b, False)
            if ran["rate_grid"] < 2:
                raise AssertionError(f"the recovered grid did not run B1: "
                                     f"{ran}")
            plan = list(cache._plan_memo.values())[-1]
            err = max(check_query("D1", "grouped", F.RATE, got_g, looked,
                                  run_query(tshard_b, "grouped", F.RATE,
                                            DURABLE_SPAN, ref_looked),
                                  ref_looked, nsteps, device),
                      check_query("D1:series", "series", F.RATE, got_s,
                                  looked,
                                  run_query(tshard_b, "series", F.RATE,
                                            DURABLE_SPAN, ref_looked),
                                  ref_looked, nsteps, device))
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run_query(shard_b, "grouped", F.RATE, DURABLE_SPAN, looked)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            p10, p90 = spread(walls)
            serve = {"cold_s": cold, "launches": ran, "cpu_check_err": err,
                     "cold_resident_delta_bytes": delta,
                     "warm_wall_ms": statistics.median(walls),
                     "warm_wall_p10_p90": (p10, p90), "blocks": len(plan.segs)}
            log(f"D1 sum by (pod)(rate(req_total[5m])) over the last hour: "
                f"cold (engine) {cold:.3f} s ({len(plan.segs)} blocks "
                f"staged), "
                f"launches {ran}, cpu-twin check ok (max_abs_err "
                f"{err:.3e}); warm median of {reps} wall_ms "
                f"{serve['warm_wall_ms']:.3f} (p10 {p10:.3f}, p90 {p90:.3f})")
            out["serve"] = serve

        with Phase("durable.ledger"):
            d5["ledger"] = ledger_on_d1(ms_b, LEDGER_REPS)

        with Phase("durable.quarantine"):
            ids, _gids, pods, tags = looked
            win_lo = steps0 - WINDOW
            win_hi = steps0 + (nsteps - 1) * STEP
            victim_i = next(i for i, t in enumerate(tags)
                            if t["pod"] == pods[0] and t["instance"] == "i-0100")
            part = shard_b.partitions[int(ids[victim_i])]
            cs = max((c for c in part.chunks if c.info.end_time >= win_lo
                      and c.info.start_time <= win_hi),
                     key=lambda c: min(c.info.end_time, win_hi)
                     - max(c.info.start_time, win_lo))
            pod0 = [shard_b.index.partkey(int(ids[i]))
                    for i, t in enumerate(tags) if t["pod"] == pods[0]]
            rows0 = sum(len(c) for _pk, c in ms_b.store.read_raw_partitions(
                "prom", 0, pod0, 0, 2**62))
            victim = FaultInjector(seed).corrupt_stored_chunk(
                ms_b.store, "prom", 0, partkey=part.partkey,
                chunk_id=cs.info.chunk_id)
            if victim != (part.partkey, cs.info.chunk_id):
                raise AssertionError(f"corrupted {victim}")
            fails = integrity_metrics()["checksum_failures"]
            f0 = fails.value(dataset="prom", shard="0")
            got = dict(ms_b.store.read_raw_partitions("prom", 0, pod0, 0,
                                                      2**62))
            rows1 = sum(len(c) for c in got.values())
            if rows1 != rows0 - 1 or any(
                    c.info.chunk_id == cs.info.chunk_id
                    for c in got.get(part.partkey, ())):
                raise AssertionError(f"read-back kept {rows1} of {rows0} "
                                     f"rows, the corrupt one among them")
            detail = integrity.QUARANTINE.items()[-1]
            if (fails.value(dataset="prom", shard="0") - f0 != 1
                    or not integrity.QUARANTINE.is_quarantined(
                        part.partkey, cs.info.chunk_id)
                    or detail["partkey"] != part.partkey.hex()
                    or detail["chunk_id"] != cs.info.chunk_id
                    or "checksum" not in detail["reason"]):
                raise AssertionError(f"quarantine: {detail}")
            log(f"corrupted chunk {cs.info.chunk_id} of {tags[victim_i]} "
                f"(rows {(cs.info.start_time - T0) // STEP}-"
                f"{(cs.info.end_time - T0) // STEP}, {cs.info.num_rows} rows) "
                f"on disk: read_raw_partitions over {pods[0]} dropped it "
                f"({rows1} of {rows0} rows) and reported {detail['reason']!r}; "
                f"quarantined")

            ev_key = (cache.owner, "integrity_quarantine")
            ev0 = LEDGER.evictions.get(ev_key, 0)
            builds0 = cache.builds
            before = counts()
            t0 = time.perf_counter()
            after_g = run_query(shard_b, "grouped", F.RATE, DURABLE_SPAN,
                                looked)
            torch.cuda.synchronize()
            restage = time.perf_counter() - t0
            after_s = run_query(shard_b, "series", F.RATE, DURABLE_SPAN,
                                looked)
            torch.cuda.synchronize()
            ran2 = {k: v - before[k] for k, v in counts().items()}
            evicted = LEDGER.evictions.get(ev_key, 0) - ev0
            if evicted < 1 or cache.builds <= builds0 \
                    or ran2["rate_grid"] < 2:
                raise AssertionError(f"the quarantine did not re-stage the "
                                     f"grid: {evicted} blocks evicted, "
                                     f"{cache.builds - builds0} built, "
                                     f"launches {ran2}")
            plan2 = list(cache._plan_memo.values())[-1]
            # the victim's steps whose window lies inside the chunk answer
            # NaN; pod 0 loses it there; every other series and pod keeps
            # its answer (bit for bit when the plan's mode is unchanged;
            # the dense contract no longer holds on the victim's lane, so
            # a phase-mode plan becomes a ts-mode one)
            ends = steps0 + np.arange(nsteps) * STEP
            inside = torch.as_tensor((ends - WINDOW >= cs.info.start_time)
                                     & (ends <= cs.info.end_time))
            v_after = after_s[1][victim_i].cpu()
            if not inside.any() or not bool(v_after[inside].isnan().all()):
                raise AssertionError("the quarantined span is still served")
            same_mode = grid._mode_for(plan.q, plan.phase) == \
                grid._mode_for(plan2.q, plan2.phase)
            keep = torch.ones(len(ids), dtype=torch.bool)
            keep[victim_i] = False
            if same_mode:
                compare_bits(after_s[1][keep], got_s[1][keep],
                             "per-series rate after the quarantine")
                compare_bits(after_g["sum"][1:], got_g["sum"][1:],
                             "other pods' sums after the quarantine")
            else:
                compare(after_s[1][keep], got_s[1][keep], "rate",
                        RTOL_KERNEL)
                compare(after_g["sum"][1:], got_g["sum"][1:], "sum",
                        RTOL_KERNEL)
            dcount = (got_g["count"][0] - after_g["count"][0]).cpu()
            if not torch.equal(dcount[inside], torch.ones_like(
                    dcount[inside])):
                raise AssertionError("pod 0's count did not drop by the "
                                     "victim inside the chunk's span")
            compare(after_g["sum"][0][inside.to(device)],
                    (got_g["sum"][0] - got_s[1][victim_i])[inside.to(device)],
                    "sum", RTOL_KERNEL)
            err2 = max(check_query("D2", "grouped", F.RATE, after_g, looked,
                                   run_query(tshard_b, "grouped", F.RATE,
                                             DURABLE_SPAN, ref_looked),
                                   ref_looked, nsteps, device),
                       check_query("D2:series", "series", F.RATE, after_s,
                                   looked,
                                   run_query(tshard_b, "series", F.RATE,
                                             DURABLE_SPAN, ref_looked),
                                   ref_looked, nsteps, device))
            inside_q = run_engine(ms_b, "sum by (pod)(rate(req_total[5m]))",
                                  DURABLE_SPAN, None)[0]
            # outside: the windows after the chunk, which the replayed
            # residents serve (the backfill path is D3's)
            first = (cs.info.end_time - T0 + WINDOW) // STEP + 1
            outside = (T0 + first * STEP, N_ROWS - first) \
                if first < N_ROWS else (T0 + 130 * STEP, 20)
            outside_q = run_engine(ms_b, "sum by (pod)(rate(req_total[5m]))",
                                   outside, None)[0]
            n_in = inside_q.stats.corrupt_chunks_excluded
            n_out = outside_q.stats.corrupt_chunks_excluded
            if (n_in, n_out) != (1, 0):
                raise AssertionError(f"corrupt_chunks_excluded {n_in} inside "
                                     f"the window, {n_out} outside")
            quarantine = {
                "chunk_id": cs.info.chunk_id, "rows": cs.info.num_rows,
                "evicted_blocks": evicted, "restage_s": restage,
                "launches": ran2, "mode_before": grid._mode_for(plan.q,
                                                                plan.phase),
                "mode_after": grid._mode_for(plan2.q, plan2.phase),
                "cpu_check_err": err2,
                "corrupt_chunks_excluded": [n_in, n_out],
                "outside_span": list(outside)}
            log(f"D2: the next query saw the quarantine epoch: LEDGER "
                f"integrity_quarantine evicted {evicted} blocks, re-staged in "
                f"{restage:.3f} s, launches {ran2} ({quarantine['mode_before']}"
                f" mode -> {quarantine['mode_after']} mode); {pods[0]} leaves "
                f"the chunk's span out, every other pod "
                f"{'bit-equal' if same_mode else 'within rtol'}; cpu-twin check "
                f"ok (max_abs_err {err2:.3e}); engine corrupt_chunks_excluded "
                f"{n_in} inside the window, {n_out} outside (windows "
                f"ending at rows {(outside[0] - T0) // STEP}-"
                f"{(outside[0] - T0) // STEP + outside[1] - 1})")
            out["quarantine"] = quarantine

        victim = (part.partkey, cs.info.start_time, cs.info.end_time)
        hspan = history_span(cache)
        history = {"span": hspan}
        out["history"] = history
        qg = "sum by (pod)(rate(req_total[5m]))"
        qs = "rate(req_total[5m])"
        with Phase("durable.history"):
            history["d3"], d3 = history_queries(
                ms_b, shard_b, tms_b, looked, hspan, cache, qg, qs, counts,
                device)
            check_history_samples(shard_b, looked, series, hspan, victim)

        with Phase("durable.evict"):
            extra = extra_row_containers(series, range(REQ_PODS))
            for i, c in enumerate(extra):
                shard_b.ingest_container(c, len(stream) + i)
            for i, c in enumerate(extra_row_containers(series,
                                                       range(CHECK_PODS))):
                tshard_b.ingest_container(c, len(stream) + i)
            pending = sum(1 for p in shard_b.partitions.values() if p._buf_n)
            n_parts = shard_b.num_partitions
            t0 = time.perf_counter()
            evicted = shard_b.evict_partitions(n_parts)
            evict_s = time.perf_counter() - t0
            tshard_b.evict_partitions(tshard_b.num_partitions)
            if evicted != n_parts or shard_b.num_partitions != 0 \
                    or shard_b.stats.partitions_evicted != n_parts:
                raise AssertionError(f"evicted {evicted} of {n_parts} "
                                     f"partitions")
            disk = check_all_rows_on_disk(ms_b.store, series, victim)
            history["evict"] = {"partitions": evicted,
                                "with_buffered_rows": pending,
                                "seconds": evict_s, "read_back": disk}
            log(f"D4: evicted {evicted} partitions in {evict_s:.3f} s "
                f"({pending} held unflushed rows, persisted first in one "
                f"batched encode and write); every acknowledged row read "
                f"back: "
                f"{disk['samples']} samples of {disk['series']} series in "
                f"{disk['chunks']} chunks ({disk['read_seconds']:.3f} s to "
                f"read, {disk['seconds']:.3f} s with the native decode and "
                f"check), the quarantined chunk left out")

        with Phase("durable.page_in"):
            history["page_in"] = page_in_query(ms_b, shard_b, tms_b, hspan,
                                               qg, d3, counts, device)

        with Phase("durable.paged_grid"):
            d4, plan4 = paged_grid_queries(ms_b, shard_b, tms_b, looked,
                                           hspan, qg, qs, d3, counts, reps,
                                           device)
            history["d4"] = d4

        with Phase("durable.downsampled"):
            ds = DownsampledTimeSeriesStore("prom",
                                            resolutions_ms=DS_RESOLUTIONS,
                                            device=device)
            ds.setup(DEFAULT_SCHEMAS, 0)
            stores.append(ds.memstore)
            t0 = time.perf_counter()
            n_ds = ds.ingest_from_publisher(pub_a)
            ingest_s = time.perf_counter() - t0
            log(f"D5a: a DownsampledTimeSeriesStore on the card ingested "
                f"store A's flush-time output, {n_ds} samples at "
                f"{DS_RESOLUTIONS} ms, in {ingest_s:.3f} s "
                f"({n_ds / ingest_s:.4g} samples/s)")
            t0 = time.perf_counter()
            d5["minute_values"] = check_minute_values(
                ds.shard(DS_RESOLUTIONS[0], 0), series)
            log(f"D5a 1 min dataset: every value is its row's raw sample, "
                f"bit for bit: {d5['minute_values']}, "
                f"{time.perf_counter() - t0:.3f} s")
            tds = cpu_twin_ds(ds)
            stores.append(tds.memstore)
            d5["queries"] = ds_queries(ds, tds, device, counts, DS_REPS)
            plan_ds = list(grid_cache(ds.shard(DS_RESOLUTIONS[0], 0),
                                      False)._plan_memo.values())[-1]
            t0 = time.perf_counter()
            d5["hour_increase"] = check_hour_increase(
                ds.shard(DS_RESOLUTIONS[1], 0), series)
            log(f"D5a 1 h dataset keeps each counter's increase: "
                f"{d5['hour_increase']} (exact in f64), "
                f"{time.perf_counter() - t0:.3f} s")
            d5["ds_ingest"] = {"samples": n_ds, "seconds": ingest_s}
        launched = {k: v for k, v in counts().items()}
        direct = grid.rate_grid.direct
        if launched["rate_grid"] < 1:
            raise AssertionError("rate_grid never launched on the durable "
                                 "path")
        log(f"durable path launches {launched}, rate_grid on its direct "
            f"kernel {direct}")

        if before_timing is not None:
            before_timing()
        with Phase("durable.kernels_at_path_shapes"):
            rows = [plan_kernel_times("D1", plan, reps, flush)[1],
                    plan_kernel_times("D2", plan2, reps, flush)[1],
                    plan_kernel_times("D4", plan4, reps, flush)[1],
                    plan_kernel_times("D5a", plan_ds, reps, flush)[1]]
        led = d5["ledger"]
        log(f"the ledger's sampled ms over D1 (grid.rate_grid "
            f"{led['grid.rate_grid']['sampled_ms_mean']:.4f}, "
            f"devicestore.grouped "
            f"{led['devicestore.grouped']['sampled_ms_mean']:.4f}) beside "
            f"B1's CUDA-event time at D1's inputs, L2 flushed: "
            f"{rows[0]['ms']:.4f} ms")
        d5["d1_kernel_ms"] = rows[0]["ms"]
        out.update(launches=launched, rate_grid_direct=direct, rows=rows,
                   d5=d5)
    finally:
        integrity.QUARANTINE.clear()
        for ms in stores:
            ms.reset()
            ms.store.shutdown()
            ms.meta.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    report["durable"] = out
    return out


ROLLUP_STEP = 900_000                  # the dashboard's step, 15 min
ROLLUP_QUERY = "sum by (pod)(rate(req_total[1h]))"
# the rollup phase's range: the first step with a full hour's window to
# the step after the last sample (the live edge, past every tier's
# rolled watermark); R1 lets the router pick, R2 pins raw, R3 pins raw
# under a raw retention of 1 ms: raw may serve nothing the tiers hold,
# so the router serves the finest tier and raw only past its watermark
ROLLUP_REPS = 1                        # warm runs of each R query
# hours of the encoding fed: at 3 the R range holds one whole 1 h
# segment, the result cache's unit (at 2 it holds none)
ROLLUP_HOURS = 3


def rollup_rows() -> int:
    """Rows of each series the rollup phase feeds."""
    return sum(DURABLE_HOURS[:ROLLUP_HOURS])


def rollup_span() -> tuple:
    """(start, stop) of the rollup phase's queries, on the 15 min grid."""
    last = T0 + (rollup_rows() - 1) * STEP + STEP - 1  # any series' last
    start = ((T0 + HOUR) // ROLLUP_STEP + 1) * ROLLUP_STEP
    return start, (last // ROLLUP_STEP + 1) * ROLLUP_STEP


class StageClock:
    """Wall seconds and calls of functions while installed: each
    ``(owner, attribute, stage)`` is wrapped, and unwrapped on exit."""

    def __init__(self, targets):
        self.targets = targets
        self.seconds: dict = {}
        self.calls: dict = {}
        self._lock = threading.Lock()

    def __enter__(self):
        self._saved = []
        for owner, attr, stage in self.targets:
            real = getattr(owner, attr)
            self._saved.append((owner, attr, real))
            setattr(owner, attr, self._wrap(real, stage))
        return self

    def _wrap(self, real, stage):
        def timed_call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[stage] = self.seconds.get(stage, 0.0) + dt
                    self.calls[stage] = self.calls.get(stage, 0) + 1
        return timed_call

    def __exit__(self, *exc):
        for owner, attr, real in reversed(self._saved):
            setattr(owner, attr, real)
        return False


def check_tiers(store, published: dict, series: dict, engine,
                device) -> dict:
    """The tiers' emitted records (the published containers): no open
    period of any series; each series' newest record in its last closed
    period, each tier's ``rolled_through`` the oldest of those; and the
    first CHECK_PODS pods' records equal to ``BatchDownsampler`` over
    the same raw chunks (the offline pass, here on the card), bit for
    bit over closed periods."""
    import numpy as np
    from filodb_tpu_torch.core.record import canonical_partkey
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.downsample import BatchDownsampler, ds_dataset_name
    from filodb_tpu_torch.rollup.config import DEFAULT_RESOLUTIONS_MS
    from filodb_tpu_torch.store.columnstore import InMemoryColumnStore

    pk_ids: dict = {}
    last = []                 # pk id -> the series' newest sample
    for pod in range(REQ_PODS):
        ts = series[pod][0]
        for s in range(POD_SERIES):
            tags = dict(series_tags("req_total", pod, s))
            tags["_metric_"] = tags.pop("__name__")
            pk_ids[canonical_partkey(tags)] = len(pk_ids)
            last.append(int(ts[s, rollup_rows() - 1]))
    last_ts = np.asarray(last, np.int64)
    n_check = CHECK_PODS * POD_SERIES           # ids of the first pods
    # the batch job over the first pods' raw chunks, as they were flushed
    sub = InMemoryColumnStore()
    by_itime: dict = {}
    for itime, cs in store.chunksets_with_ingestion_time("prom", 0, 0,
                                                         2**62):
        if pk_ids[bytes(cs.partkey)] < n_check:
            by_itime.setdefault(itime, []).append(cs)
    for itime, css in by_itime.items():
        sub.write_chunks("prom", 0, css, itime)
    t0 = time.perf_counter()
    written = BatchDownsampler("prom", DEFAULT_SCHEMAS, sub,
                               resolutions_ms=DEFAULT_RESOLUTIONS_MS,
                               device=device).run_shard(0, 0, 2**62)
    batch_s = time.perf_counter() - t0
    schema = DEFAULT_SCHEMAS["prom-counter"]
    out = {"batch_seconds": batch_s, "batch_chunks": written,
           "batch_series": n_check}
    for res in DEFAULT_RESOLUTIONS_MS:
        t0 = time.perf_counter()
        got = ds_rows_of_containers(published[res], DEFAULT_SCHEMAS, pk_ids)
        decode_s = time.perf_counter() - t0
        if len(pk_ids) != len(last_ts):
            raise AssertionError(f"tier {res}: a record of an unknown series")
        closed = (last_ts - 1) // res * res            # per series
        opened = got[:, 1] > closed[got[:, 0]]
        if opened.any():
            raise AssertionError(f"tier {res}: {int(opened.sum())} records of "
                                 f"open periods emitted")
        # each series' newest record stamps its last closed period: the
        # period's end, or inside it the pre-reset sample's own time
        # where a reset split the period
        newest = np.full(len(last_ts), -1, np.int64)
        np.maximum.at(newest, got[:, 0], got[:, 1])
        if (newest <= closed - res).any():
            raise AssertionError(f"tier {res}: "
                                 f"{int((newest <= closed - res).sum())} "
                                 f"series short of their last closed period")
        through = engine.rolled_through("prom", res)
        if through != int(newest.min()):
            raise AssertionError(f"tier {res}: rolled_through {through}, the "
                                 f"last closed periods' oldest stamp "
                                 f"{int(newest.min())}")
        mine = got[got[:, 0] < n_check]
        mine = mine[np.lexsort((mine[:, 1], mine[:, 0]))]
        want, nchunks = ds_rows_of_chunks(sub, ds_dataset_name("prom", res),
                                          schema, pk_ids)
        want = want[np.lexsort((want[:, 1], want[:, 0]))]
        want_closed = want[want[:, 1] <= closed[want[:, 0]]]
        if len(mine) == 0 or not np.array_equal(mine, want_closed):
            raise AssertionError(f"tier {res}: {len(mine)} emitted records of "
                                 f"the first pods, {len(want_closed)} closed-"
                                 f"period rows of the batch job ({len(want)} "
                                 f"in all); equal: "
                                 f"{np.array_equal(mine, want_closed)}")
        out[str(res)] = {"records": int(len(got)),
                         "decode_seconds": decode_s,
                         "checked_records": int(len(mine)),
                         "batch_rows": int(len(want)),
                         "open_rows_left_out": int(len(want)
                                                   - len(want_closed)),
                         "rolled_through": through}
    return out


def rollup_router(ms, engine, **kw):
    """A RollupRouterPlanner over the raw dataset and its three tiers,
    its watermarks the engine's (and ``kw`` the retention and clock)."""
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.downsample import ds_dataset_name
    from filodb_tpu_torch.parallel.shardmap import ShardMapper
    from filodb_tpu_torch.rollup import RollupRouterPlanner
    from filodb_tpu_torch.rollup.config import DEFAULT_RESOLUTIONS_MS

    tiers = {r: SingleClusterPlanner(ds_dataset_name("prom", r),
                                     ShardMapper(1))
             for r in DEFAULT_RESOLUTIONS_MS}
    return RollupRouterPlanner(
        "prom", SingleClusterPlanner("prom", ShardMapper(1)), tiers,
        rolled_through_fn=lambda r: engine.rolled_through("prom", r), **kw)


RC_INSTANT_QUERY = "sum by (pod)(rate(req_total[5m]))"


def leaf_plan(leg):
    """The leaf under a plan: down its first children to the first plan
    that names a dataset."""
    while getattr(leg, "dataset", None) is None and leg.children:
        leg = leg.children[0]
    return leg


def columns(rows: dict, cols: list) -> dict:
    """``rows`` cut to the step columns ``cols``."""
    return {k: v[cols] for k, v in rows.items()}


class general_path:
    """Within it the engine refuses the device grid: every leaf scans its
    batch and runs its window function and group sum on the general
    path, as an instant window state does."""

    def __enter__(self):
        from filodb_tpu_torch.query.exec import MultiSchemaPartitionsExec
        self._real = MultiSchemaPartitionsExec._try_device_grid
        MultiSchemaPartitionsExec._try_device_grid = \
            lambda *_a, **_k: None
        return self

    def __exit__(self, *exc):
        from filodb_tpu_torch.query.exec import MultiSchemaPartitionsExec
        MultiSchemaPartitionsExec._try_device_grid = self._real
        return False


def values_gate(name: str, rows: dict, ref_rows: dict,
                exact: bool = True) -> dict:
    """A cached answer's rows against the uncached router's at the same
    moment: the same groups and NaN cells, and every value bit for bit.
    With ``exact`` off a differing cell passes within RTOL_KERNEL of the
    uncached value (the cells and their largest relative difference
    reported): for two computations that round otherwise, as RC2's
    instant window state on the general path against B1 and the grid's
    f64 reduce."""
    import numpy as np
    if set(rows) != set(ref_rows):
        odd = sorted(set(rows) ^ set(ref_rows))[:4]
        raise AssertionError(f"{name}: groups differ from the uncached "
                             f"answer: {odd}")
    keys = sorted(ref_rows)
    got = np.stack([rows[k] for k in keys]).astype(np.float64)
    want = np.stack([ref_rows[k] for k in keys]).astype(np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{name}: NaN cells differ from the uncached "
                             f"answer")
    fin = np.isfinite(want)
    if not fin.any():
        raise AssertionError(f"{name}: no finite value")
    diff = got[fin] != want[fin]
    rel = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]),
                                                     np.finfo(np.float64).tiny)
    out = {"cells": int(fin.sum()), "bit_equal": not diff.any(),
           "cells_differing": int(diff.sum()),
           "max_rel_diff": float(rel.max())}
    if not out["bit_equal"] and (exact or out["max_rel_diff"] > RTOL_KERNEL):
        raise AssertionError(f"{name}: {out['cells_differing']} cells differ "
                             f"from the uncached answer, up to "
                             f"{out['max_rel_diff']:.3e} relative ("
                             + ("bit for bit required" if exact else
                                f"> {RTOL_KERNEL}") + ")")
    return out


class CacheDashboard:
    """RC1 and RC2, a dashboard refreshed through the result cache below
    the rollup router: the router of ``rollup_router`` with each of its
    planners (raw and every tier) wrapped in a ``ResultCachingPlanner``
    over a ``ResultCache`` of its dataset at the reference's defaults
    (64 MiB, the doorkeeper on), ``segment_ms`` the store's flush
    interval, the routing token its dataset's ``ShardMapper``'s.  Each
    refresh runs RC1 (ROLLUP_QUERY over rollup_span() under ``auto``)
    and RC2 (RC_INSTANT_QUERY at a given time) through it and through
    the uncached router, and holds the cached answer to the uncached one
    (:func:`values_gate`)."""

    def __init__(self, ms, engine, segment_ms: int):
        from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
        from filodb_tpu_torch.downsample import ds_dataset_name
        from filodb_tpu_torch.parallel.shardmap import ShardMapper
        from filodb_tpu_torch.query.resultcache import (ResultCache,
                                                        ResultCachingPlanner)
        from filodb_tpu_torch.rollup import RollupRouterPlanner
        from filodb_tpu_torch.rollup.config import DEFAULT_RESOLUTIONS_MS

        self.ms, self.engine = ms, engine
        self.caches: dict = {}
        planners: dict = {}
        for res in (0,) + tuple(DEFAULT_RESOLUTIONS_MS):
            ds = "prom" if res == 0 else ds_dataset_name("prom", res)
            mapper = ShardMapper(1)
            self.caches[ds] = ResultCache(ds, enabled=True)
            planners[res] = ResultCachingPlanner(
                ds, SingleClusterPlanner(ds, mapper), ms, self.caches[ds],
                segment_ms=segment_ms, routing_token_fn=mapper.routing_token)
        self.router = RollupRouterPlanner(
            "prom", planners.pop(0), planners,
            rolled_through_fn=lambda r: engine.rolled_through("prom", r))
        self.refreshes: list = []

    def counters(self) -> dict:
        return {ds: {k: c.snapshot()[k] for k in
                     ("hits", "misses", "skips", "invalidations", "entries",
                      "bytes")}
                for ds, c in self.caches.items()}

    def _instant(self, router, t: int):
        from filodb_tpu_torch.promql.parser import query_to_logical_plan
        from filodb_tpu_torch.query.exec import ExecContext
        from filodb_tpu_torch.query.model import QueryContext

        t0 = time.perf_counter()
        qctx = QueryContext(sample_limit=2**40)
        ep = router.materialize(query_to_logical_plan(RC_INSTANT_QUERY, t),
                                qctx)
        res = ep.execute(ExecContext(self.ms, qctx))
        host = [b.np_values() for b in res.batches]
        return res, host, (time.perf_counter() - t0) * 1e3, ep

    def refresh(self, label: str, t_instant: int) -> dict:
        """One refresh of both panels: the uncached router first, then
        the cached one, each to host values, and the gates: a cell a
        cached range leg (or a leg the cache passed through) answers
        equals the uncached router's bit for bit; a cell an instant
        window state answers (RC2, and RC1's one-step raw leg at the
        live edge) equals the uncached router's run on the general path
        bit for bit, and the uncached router's (B1 and the grid's f64
        reduce) within RTOL_KERNEL, its differing cells reported."""
        import torch
        from filodb_tpu_torch.query.resultcache import InstantWindowExec

        before = self.counters()
        uncached = rollup_router(self.ms, self.engine)
        ures, uhost, uwall = run_routed(self.ms, uncached, "auto")[:3]
        res, host, wall, ep, qctx = run_routed(self.ms, self.router, "auto")
        torch.cuda.synchronize()
        rows, urows = engine_rows(res, host), engine_rows(ures, uhost)
        start = rollup_span()[0]
        window_cols = [(leg.eval_ms - start) // ROLLUP_STEP
                       for leg in self.leg_plans(ep)
                       if isinstance(leg, InstantWindowExec)]
        range_cols = [c for c in range(len(next(iter(urows.values()))))
                      if c not in window_cols]
        rc1 = values_gate(f"RC1 {label}", columns(rows, range_cols),
                          columns(urows, range_cols))
        if window_cols:
            with general_path():
                gres, ghost = run_routed(self.ms, uncached, "auto")[:2]
            values_gate(f"RC1 {label} window leg, general path",
                        columns(rows, window_cols),
                        columns(engine_rows(gres, ghost), window_cols))
            rc1["window_leg"] = values_gate(
                f"RC1 {label} window leg", columns(rows, window_cols),
                columns(urows, window_cols), exact=False)
        rc1.update(window_cols=window_cols)
        rc1.update(wall_ms=wall, uncached_wall_ms=uwall,
                   tiers=list(qctx.rollup_tiers),
                   samples_scanned=res.stats.samples_scanned,
                   cached_samples=res.stats.resultcache_cached_samples,
                   recomputed_samples=res.stats.resultcache_recomputed_samples,
                   legs=self.legs(ep))
        ires, ihost, iwall = self._instant(uncached, t_instant)[:3]
        cres, chost, cwall, cep = self._instant(self.router, t_instant)
        torch.cuda.synchronize()
        crows, irows = engine_rows(cres, chost), engine_rows(ires, ihost)
        if isinstance(cep, InstantWindowExec):
            with general_path():
                gres, ghost = self._instant(uncached, t_instant)[:2]
            values_gate(f"RC2 {label}, general path", crows,
                        engine_rows(gres, ghost))
        rc2 = values_gate(f"RC2 {label}", crows, irows,
                          exact=not isinstance(cep, InstantWindowExec))
        # the first sight of a fingerprint passes through (the doorkeeper)
        consumed = cep._entry.state.samples_consumed \
            if isinstance(cep, InstantWindowExec) else None
        prev = next((r["rc2"]["samples_consumed_total"]
                     for r in reversed(self.refreshes)
                     if r["rc2"]["samples_consumed_total"] is not None), 0)
        rc2.update(t=t_instant, wall_ms=cwall, uncached_wall_ms=iwall,
                   path=type(cep).__name__,
                   samples_consumed_total=consumed,
                   samples_consumed=None if consumed is None
                   else consumed - prev,
                   samples_scanned=cres.stats.samples_scanned,
                   cached_samples=cres.stats.resultcache_cached_samples,
                   recomputed_samples=(
                       cres.stats.resultcache_recomputed_samples))
        after = self.counters()
        row = {"label": label, "rc1": rc1, "rc2": rc2,
               "caches": {ds: {k: after[ds][k] - before[ds][k]
                               for k in ("hits", "misses", "skips",
                                         "invalidations")}
                          for ds in after}}
        self.refreshes.append(row)
        self._last = (res, ep)
        log(f"RC {label}: RC1 wall {wall:.3f} ms (uncached {uwall:.3f}), "
            f"tiers {qctx.rollup_tiers}, legs {rc1['legs']}, samples "
            f"scanned {rc1['samples_scanned']} (cached "
            f"{rc1['cached_samples']}, recomputed "
            f"{rc1['recomputed_samples']}), {rc1['cells']} cells of range "
            f"legs bit-equal to the uncached answer"
            + (f"; the window leg's columns {window_cols} bit-equal to the "
               f"general path, against the uncached answer "
               f"{rc1['window_leg']['cells_differing']} of "
               f"{rc1['window_leg']['cells']} cells differ, max rel "
               f"{rc1['window_leg']['max_rel_diff']:.3e}" if window_cols
               else "") +
            f"; RC2 at {t_instant} via "
            f"{rc2['path']} wall {cwall:.3f} ms (uncached {iwall:.3f}), "
            f"samples consumed {rc2['samples_consumed']}, bit-equal "
            f"{rc2['bit_equal']} ({rc2['cells_differing']} of {rc2['cells']}"
            f", max rel {rc2['max_rel_diff']:.3e}"
            + (", bit-equal to the general path"
               if rc2["path"] == "InstantWindowExec" else "")
            + f"); caches {row['caches']}; {nvidia_smi()}")
        return row

    @staticmethod
    def leg_plans(ep) -> list:
        from filodb_tpu_torch.query.exec import StitchRvsExec
        return list(ep.children) if isinstance(ep, StitchRvsExec) else [ep]

    @staticmethod
    def legs(ep) -> list:
        """Each leg of the routed plan: the dataset its cache wraps and
        what the cache made of it (a CachedRangeExec's hit, head and run
        items, the storable segments the runs recompute), or the plain
        plan it passed through."""
        from filodb_tpu_torch.query.resultcache import (CachedRangeExec,
                                                        InstantWindowExec)

        out = []
        for leg in CacheDashboard.leg_plans(ep):
            if isinstance(leg, InstantWindowExec):
                # a one-step leg: the cache's instant window state
                out.append({"dataset": leg._planner.dataset, "cached": True,
                            "instant": True, "storable_recomputed": 0,
                            "hits": 0})
            elif isinstance(leg, CachedRangeExec):
                items = leg._items
                out.append({
                    "dataset": leg._planner.dataset, "cached": True,
                    "hits": sum(1 for it in items if it[0] == "hit"),
                    "heads": sum(1 for it in items if it[0] == "head"),
                    "runs": sum(1 for it in items if it[0] == "run"),
                    "storable_recomputed": sum(
                        1 for it in items if it[0] == "run"
                        for seg in it[2] if seg.storable)})
            else:
                out.append({"dataset": getattr(leaf_plan(leg), "dataset",
                                               None),
                            "cached": False})
        return out

    def check_last(self) -> dict:
        """The last refresh, with no new data since the one before: every
        whole segment of its cached legs closed at that moment hit (each
        one stored, ``snapshot()``), none recomputed; the samples it
        scanned are the cache's recomputed ones plus those of the legs
        the cache passed through (each run again alone); every cache's
        byte ledger reconciles.  A stored segment the router no longer
        asks for (the boundary moved past it) stays unrequested."""
        from filodb_tpu_torch.query.exec import ExecContext
        from filodb_tpu_torch.query.model import QueryContext
        from filodb_tpu_torch.query.resultcache import (CachedRangeExec,
                                                        InstantWindowExec)

        res, ep = self._last
        row = self.refreshes[-1]
        legs = self.leg_plans(ep)
        hit_keys = [it[2].key for leg in legs
                    if isinstance(leg, CachedRangeExec)
                    for it in leg._items if it[0] == "hit"]
        recomputed = sum(g["storable_recomputed"]
                         for g in row["rc1"]["legs"] if g["cached"])
        stored = {ds: len(c.snapshot()["segments"])
                  for ds, c in self.caches.items()}
        unstored = [k for k in hit_keys
                    if not any(c.get(k) is not None
                               for c in self.caches.values())]
        if not hit_keys or recomputed or unstored:
            raise AssertionError(f"the last refresh hit {len(hit_keys)} "
                                 f"whole segments ({len(unstored)} not "
                                 f"stored), recomputed {recomputed} closed "
                                 f"whole ones; stored {stored}")
        hits = len(hit_keys)
        bypass = 0
        for leg in legs:
            if not isinstance(leg, (CachedRangeExec, InstantWindowExec)):
                q = QueryContext(sample_limit=2**40)
                bypass += leg.execute(ExecContext(self.ms, q)).stats \
                    .samples_scanned
        if res.stats.samples_scanned != \
                res.stats.resultcache_recomputed_samples + bypass:
            raise AssertionError(
                f"samples scanned {res.stats.samples_scanned}, recomputed "
                f"{res.stats.resultcache_recomputed_samples}, passed "
                f"through {bypass}")
        ledgers = {ds: c.reconcile() for ds, c in self.caches.items()}
        if any(a != w for a, w in ledgers.values()):
            raise AssertionError(f"byte ledgers {ledgers}")
        out = {"whole_segments_stored": stored, "whole_segments_hit": hits,
               "uncached_repeat": self.uncached_repeat(),
               "samples_scanned": res.stats.samples_scanned,
               "recomputed_samples":
                   res.stats.resultcache_recomputed_samples,
               "passed_through_samples": bypass,
               "reconcile": {ds: list(v) for ds, v in ledgers.items()},
               "snapshots": {ds: {k: v for k, v in c.snapshot().items()
                                  if k not in ("segments",)}
                             for ds, c in self.caches.items()}}
        log(f"RC last refresh: {hits} closed whole segments hit (stored "
            f"a cache: {stored}), none recomputed; samples scanned "
            f"{out['samples_scanned']} == recomputed "
            f"{out['recomputed_samples']} + passed through {bypass}; byte "
            f"ledgers reconcile {out['reconcile']}; the uncached router run "
            f"again against its own answer: {out['uncached_repeat']}")
        return out

    def uncached_repeat(self) -> dict:
        """The uncached router's RC1 and RC2 at the last refresh's moment,
        each run twice and held to itself bit for bit: the card's
        uncached path is reproducible (its group sums in a fixed
        order)."""
        import torch

        t = self.refreshes[-1]["rc2"]["t"]
        out = {}
        uncached = rollup_router(self.ms, self.engine)
        for name, run in (("rc1", lambda: run_routed(self.ms, uncached,
                                                     "auto")[:2]),
                          ("rc2", lambda: self._instant(uncached, t)[:2])):
            a, b = run(), run()
            torch.cuda.synchronize()
            gate = values_gate(f"{name} uncached twice",
                               engine_rows(*b), engine_rows(*a))
            out[name] = {k: gate[k] for k in ("bit_equal", "cells_differing",
                                              "max_rel_diff")}
        return out

    def tier_sum_inputs(self, res_ms: int) -> tuple:
        """The first group sum of the uncached RC1's leg over the
        ``res_ms`` tier, run alone at the last refresh's moment: clones
        of ``segment_sum``'s (vals, ids, num_groups) there."""
        from filodb_tpu_torch.downsample import ds_dataset_name
        from filodb_tpu_torch.ops import aggregate
        from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
        from filodb_tpu_torch.query.exec import ExecContext
        from filodb_tpu_torch.query.model import QueryContext

        start, stop = rollup_span()
        qctx = QueryContext(sample_limit=2**40, resolution_pref="auto")
        ep = rollup_router(self.ms, self.engine).materialize(
            query_range_to_logical_plan(ROLLUP_QUERY, start, ROLLUP_STEP,
                                        stop), qctx)
        want = ds_dataset_name("prom", res_ms)
        for leg in self.leg_plans(ep):
            if leaf_plan(leg).dataset == want:
                break
        else:
            raise AssertionError(f"RC1 has no leg over {want}")
        seen: list = []
        real = aggregate.segment_sum

        def recording(vals, ids, num_groups):
            if not seen:
                seen.append((vals.clone(), ids.clone(), num_groups))
            return real(vals, ids, num_groups)

        aggregate.segment_sum = recording
        try:
            leg.execute(ExecContext(self.ms, QueryContext(
                sample_limit=2**40)))
        finally:
            aggregate.segment_sum = real
        if not seen:
            raise AssertionError(f"RC1's {want} leg ran no group sum")
        return seen[0]


def segment_sum_times(inputs: tuple, reps: int, runs: int = 5) -> dict:
    """The fixed-order ``segment_sum`` beside the ``index_add_`` it
    replaced, on the inputs of ``CacheDashboard.tier_sum_inputs``: each
    one's median device ms (``cuda_ms``), and ``runs`` runs of each
    against its first: the fixed-order sum must repeat its bits and equal
    the CPU's on the same inputs; the cells where ``index_add_`` gave
    other bits are counted."""
    import torch
    from filodb_tpu_torch.ops import aggregate

    vals, ids, G = inputs

    def index_add():
        out = torch.zeros((G,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=vals.device)
        return out.index_add_(0, ids.to(torch.int64), vals)

    def fixed():
        return aggregate.segment_sum(vals, ids, G)

    def bits(t):
        t = t.cpu()
        t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
        return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                                   else torch.int64)

    first = bits(fixed())
    cpu = bits(aggregate.segment_sum(vals.cpu(), ids.cpu(), G))
    if not torch.equal(first, cpu):
        raise AssertionError("segment_sum on the card differs from the CPU's "
                             f"in {int((first != cpu).sum())} cells")
    for _ in range(runs - 1):
        again = bits(fixed())
        if not torch.equal(again, first):
            raise AssertionError(f"segment_sum repeated with other bits in "
                                 f"{int((again != first).sum())} cells")
    ref = bits(index_add())
    differ = max(int((bits(index_add()) != ref).sum())
                 for _ in range(runs - 1))
    out = {"shape": list(vals.shape), "dtype": str(vals.dtype).split(".")[-1],
           "groups": G, "cells": int(first.numel()),
           "segment_sum_ms": cuda_ms(fixed, reps),
           "index_add_ms": cuda_ms(index_add, reps),
           "index_add_cells_differing": differ}
    log(f"segment_sum at the 15 min tier leg's shape {out['shape']} "
        f"{out['dtype']} into {G} groups: fixed order {out['segment_sum_ms']:.4f}"
        f" ms against index_add_ {out['index_add_ms']:.4f} ms (CUDA events, "
        f"median of {reps}); {runs} runs bit-equal to each other and to the "
        f"CPU's; index_add_ run {runs} times differed from its first in up "
        f"to {differ} of {out['cells']} cells; {nvidia_smi()}")
    return out


def rollup_queries() -> list:
    """(name, resolution pin, router knobs) of R1-R3."""
    _start, stop = rollup_span()
    retention = dict(raw_retention_ms=1, now_ms_fn=lambda: stop)
    return [("R1", "auto", {}), ("R2", "raw", {}), ("R3", "raw", retention)]


def run_routed(ms, router, pin: str):
    """ROLLUP_QUERY through ``router`` over rollup_span(): (result, host
    values, wall ms, exec plan, QueryContext)."""
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    from filodb_tpu_torch.query.exec import ExecContext
    from filodb_tpu_torch.query.model import QueryContext

    start, stop = rollup_span()
    t0 = time.perf_counter()
    qctx = QueryContext(sample_limit=2**40, resolution_pref=pin)
    plan = query_range_to_logical_plan(ROLLUP_QUERY, start, ROLLUP_STEP, stop)
    ep = router.materialize(plan, qctx)
    res = ep.execute(ExecContext(ms, qctx))
    host = [b.np_values() for b in res.batches]
    return res, host, (time.perf_counter() - t0) * 1e3, ep, qctx


def grid_hits(ms, datasets) -> dict:
    """{dataset: its shard's grid cache hits}: a hit is one grid program
    run, the grid kernel's launch with it."""
    return {d: sum(c.hits for c in ms.get_shard(d, 0).device_caches.values())
            for d in datasets}


def leg_paths(ep, hits: dict) -> list:
    """Each leg of a stitched plan (or the plan, unstitched): its leaf
    dataset and time range, and its path: the grid where its dataset's
    grid caches were hit while the plan ran (``hits``), else the
    general path."""
    from filodb_tpu_torch.query.exec import StitchRvsExec

    legs = list(ep.children) if isinstance(ep, StitchRvsExec) else [ep]
    out = []
    for leg in legs:
        leaf = leaf_plan(leg)
        out.append({"dataset": leaf.dataset, "start": leaf.start_ms,
                    "end": leaf.end_ms, "grid_hits": hits[leaf.dataset],
                    "path": "grid" if hits[leaf.dataset] else "general"})
    return out


def rollup_phase(device, seed: int, reps: int, hours: dict, report: dict,
                 before_timing=None) -> dict:
    """The live rollup tiers: ``req_total``'s hourly container sets (the
    durable phase's encoding) fed hour by hour into a fresh store on the
    card over an in-memory column store, a ``RollupEngine`` at the
    default ladder on its flush listener, ``run_once`` after each hour's
    flush; the tiers against the offline batch job, then R1-R3 through
    the ``RollupRouterPlanner`` on the card against a CPU twin."""
    import numpy as np
    import torch
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.core.storeconfig import StoreConfig
    from filodb_tpu_torch.downsample import ShardDownsampler, ds_dataset_name
    from filodb_tpu_torch.downsample import sharddown
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ops import grid
    from filodb_tpu_torch.query.exec import StitchRvsExec
    from filodb_tpu_torch.rollup import RollupEngine
    from filodb_tpu_torch.rollup import engine as rollup_engine
    from filodb_tpu_torch.rollup.config import (DEFAULT_RESOLUTIONS_MS,
                                                RollupConfig)
    from filodb_tpu_torch.store.columnstore import InMemoryColumnStore
    from filodb_tpu_torch.utils import devicewatch

    out: dict = {}
    series = {p: pod_series(p, seed, False)[:2] for p in range(REQ_PODS)}
    cfg = RollupConfig()                     # the reference's defaults
    if cfg.resolutions_ms != DEFAULT_RESOLUTIONS_MS:
        raise AssertionError(f"the default ladder is {cfg.resolutions_ms}")
    ms = TimeSeriesMemStore(InMemoryColumnStore(), device=device)
    shard = ms.setup("prom", DEFAULT_SCHEMAS, 0,
                     StoreConfig(device_cache_compress=True))
    published: dict = {r: [] for r in cfg.resolutions_ms}
    offsets: dict = {}
    publish_s: dict = {r: 0.0 for r in cfg.resolutions_ms}

    def publisher(res):
        name = ds_dataset_name("prom", res)

        def publish(shard_num, container):
            t0 = time.perf_counter()
            off = offsets.get(name, -1) + 1
            offsets[name] = off
            published[res].append(container)
            ms.ingest(name, shard_num, container, off)
            publish_s[res] += time.perf_counter() - t0
        return publish

    publish_for = {}
    for res in cfg.resolutions_ms:
        ms.setup(ds_dataset_name("prom", res), DEFAULT_SCHEMAS, 0)
        publish_for[res] = publisher(res)
    engine = RollupEngine(node="chip-smoke")
    engine.watch("prom", ms, DEFAULT_SCHEMAS, cfg, publish_for,
                 column_store=ms.store, meta_store=ms.meta)
    dash = CacheDashboard(ms, engine, shard.config.flush_interval_ms)
    # the tiers the dashboard's step can route to flush each hour; the
    # 1 min tier (about 92% of the records) stays in its write buffers
    tier_shards = [ms.get_shard(ds_dataset_name("prom", r), 0)
                   for r in cfg.resolutions_ms if r >= ROLLUP_STEP]

    def rate_grid_launches() -> tuple:
        """(the wrapper's count, the kernel ledger's) of B1."""
        rows = {r["program"]: r["launches"]
                for r in devicewatch.KERNEL_TIMER.table()}
        return grid.rate_grid.launches, rows.get("grid.rate_grid", 0)

    rc_launches = [0, 0]

    def rc_refresh(label: str, rows_fed: int) -> None:
        t_last = max(int(series[p][0][:, rows_fed - 1].max())
                     for p in range(REQ_PODS))
        w0, l0 = rate_grid_launches()
        with Phase(f"rollup.rc.{label}"):
            dash.refresh(label, t_last)
        w1, l1 = rate_grid_launches()
        rc_launches[0] += w1 - w0
        rc_launches[1] += l1 - l0

    kernel_rows = {r["program"]: r for r in devicewatch.KERNEL_TIMER.table()}
    red0 = kernel_rows.get("griddown.period_reduce", {})
    hourly = []
    offset = 0
    targets = [(sharddown, "decode_concat_with_keys", "decode"),
               (ShardDownsampler, "prepare_decoded", "stage"),
               (ShardDownsampler, "downsample_arrays", "reduce"),
               (RollupEngine, "_emit_tier", "reduce+emit"),
               (RollupEngine, "_emit_shared", "emit.shared"),
               (RollupEngine, "_emit_series", "emit.series"),
               (rollup_engine._SeriesState, "append", "buffer"),
               (rollup_engine.RollupEngine, "_persist", "persist")]
    # every period reduce timed by the kernel ledger (one a tick)
    devicewatch.KERNEL_TIMER.configure(sample_1_in=1)
    clock = StageClock(targets)
    fed = 0
    for h, nrows in enumerate(DURABLE_HOURS[:ROLLUP_HOURS]):
        with Phase(f"rollup.feed.{h}"), clock:
            t0 = time.perf_counter()
            samples = 0
            for pod in range(REQ_PODS):
                for c in hours[pod][h]:
                    samples += shard.ingest_container(c, offset)
                    offset += 1
            t1 = time.perf_counter()
            shard.flush_all(ingestion_time=1000 + h)
            t2 = time.perf_counter()
            queued = sum(len(sr.queue) for sr in
                         engine._datasets["prom"].shards.values())
            engine.run_once("prom")
            t3 = time.perf_counter()
            # the tier datasets flush on their own schedule, as any
            # dataset does (the result cache memoizes encoded chunks)
            # right after the tick here
            for tsh in tier_shards:
                tsh.flush_all(ingestion_time=1000 + h)
            t4 = time.perf_counter()
            d = engine._datasets["prom"]
            states = [st for sr in d.shards.values()
                      for st in sr.series.values()]
            buffered = sum(st.buffered for st in states)
            state_bytes = sum(st.ts.nbytes + sum(c.nbytes for c in st.cols)
                              for st in states if st.ts is not None)
            if d.tier_errors:
                raise AssertionError(f"hour {h}: tier errors {d.tier_errors}")
            row = {"hour": h, "rows": nrows, "samples": samples,
                   "ingest_s": t1 - t0, "flush_s": t2 - t1,
                   "flush_batches": queued, "tick_s": t3 - t2,
                   "tier_flush_s": t4 - t3,
                   "series_states": len(states), "buffered_samples": buffered,
                   "state_bytes": state_bytes,
                   "written": dict(d.samples_written)}
            hourly.append(row)
            log(f"rollup hour {h}: {samples} samples ingested in "
                f"{row['ingest_s']:.3f} s, flushed in {row['flush_s']:.3f} s "
                f"({queued} flush batches queued), run_once "
                f"{row['tick_s']:.3f} s, tiers flushed in "
                f"{row['tier_flush_s']:.3f} s; {len(states)} series states "
                f"holding {buffered} samples ({state_bytes / 2**20:.1f} MiB); "
                f"records emitted so far {row['written']}")
        fed += nrows
        rc_refresh(f"hour{h}", fed)
    # the last refresh: no new data since the one before
    rc_refresh("last", fed)
    with Phase("rollup.rc.check"):
        last = dash.check_last()
        if rc_launches[0] < 1 or rc_launches[0] != rc_launches[1]:
            raise AssertionError(f"the refreshes' B1 launches: the wrapper's "
                                 f"{rc_launches[0]}, the kernel ledger's "
                                 f"{rc_launches[1]}")
        tier_sum = dash.tier_sum_inputs(ROLLUP_STEP)
        walls = {r["label"]: {k: round(r[p][w], 3) for p in ("rc1", "rc2")
                              for k, w in ((f"{p}_ms", "wall_ms"),
                                           (f"{p}_uncached_ms",
                                            "uncached_wall_ms"))}
                 for r in dash.refreshes}
        out["result_cache"] = {"refreshes": dash.refreshes, "last": last,
                               "walls_ms": walls,
                               "launches": {"rate_grid": rc_launches[0],
                                            "ledger": rc_launches[1]}}
        log(f"RC refreshes: B1 launched {rc_launches[0]} times, the kernel "
            f"ledger's count {rc_launches[1]}; walls (ms, cached and "
            f"uncached) {walls}; {nvidia_smi()}")
    devicewatch.KERNEL_TIMER.configure(sample_1_in=64)
    stages = {k: round(v, 3) for k, v in clock.seconds.items()}
    stages.update({f"publish.{r}": round(v, 3) for r, v in publish_s.items()})
    calls = dict(clock.calls)
    kernel_rows = {r["program"]: r for r in devicewatch.KERNEL_TIMER.table()}
    red = kernel_rows.get("griddown.period_reduce", {})
    reduce_row = {k: red.get(k, 0) - red0.get(k, 0)
                  for k in ("launches", "sampled", "device_seconds")}
    reduce_row["ewma_device_s"] = red.get("ewma_device_s")
    if reduce_row["launches"] < 1 \
            or reduce_row["sampled"] != reduce_row["launches"] \
            or not reduce_row["device_seconds"] > 0:
        raise AssertionError(f"the period reduce on the card: {reduce_row}")
    out.update(hourly=hourly, stages_s=stages, stage_calls=calls,
               period_reduce=reduce_row,
               records={str(r): n for r, n in
                        engine._datasets["prom"].samples_written.items()})
    log(f"rollup engine: tick seconds by hour "
        f"{[round(r['tick_s'], 3) for r in hourly]}; stage seconds {stages} "
        f"(calls {calls}); records emitted per tier {out['records']}; "
        f"griddown.period_reduce ledger row over the feed {reduce_row}")

    with Phase("rollup.check_tiers"):
        out["tiers"] = check_tiers(ms.store, published, series, engine,
                                   device)
        log(f"rollup tiers: no open period emitted, each series' newest "
            f"record in its last closed period, rolled_through the oldest of "
            f"them; the first {CHECK_PODS} pods' records equal "
            f"BatchDownsampler's over the same raw chunks, bit for bit, over "
            f"closed periods: {out['tiers']}")
    published.clear()

    with Phase("rollup.twin"):
        twin = TimeSeriesMemStore(device="cpu")
        twin.setup("prom", DEFAULT_SCHEMAS, 0)
        toff = 0
        for h in range(ROLLUP_HOURS):
            for pod in range(CHECK_PODS):
                for c in hours[pod][h]:
                    twin.ingest("prom", 0, c, toff)
                    toff += 1
        from filodb_tpu_torch.core.record import RecordBuilder
        for res in cfg.resolutions_ms:
            name = ds_dataset_name("prom", res)
            twin.setup(name, DEFAULT_SCHEMAS, 0)
            b = RecordBuilder(DEFAULT_SCHEMAS["prom-counter"])
            for part in list(ms.get_shard(name, 0).partitions.values()):
                if int(part.tags["pod"].split("-")[1]) < CHECK_PODS:
                    t, v = part.read_range(0, 2**62)
                    b.add_series(t, [v], part.tags)
            for off, c in enumerate(b.containers()):
                twin.ingest(name, 0, c, off)
    del hours

    def counts():
        return {k: getattr(grid, k).launches
                for k in ("rate_grid", "rate_grid_packed")}

    queries = {}
    ledger_progs = ("grid.rate_grid", "grid.rate_grid_packed")
    datasets = ["prom"] + [ds_dataset_name("prom", r)
                           for r in cfg.resolutions_ms]

    def ledger_launches():
        rows = {r["program"]: r["launches"]
                for r in devicewatch.KERNEL_TIMER.table()}
        return {p: rows.get(p, 0) for p in ledger_progs}

    # the card's runs only (the CPU twin's calls reach the ledger too)
    ledger = {p: 0 for p in ledger_progs}
    card = {"rate_grid": 0, "rate_grid_packed": 0}
    with Phase("rollup.queries"):
        grid.reset_launch_counts()          # the rollup path's run
        d0 = grid.rate_grid.direct
        plans = {}
        for name, pin, kw in rollup_queries():
            router = rollup_router(ms, engine, **kw)
            before = counts()
            led0 = ledger_launches()
            hits0 = grid_hits(ms, datasets)
            res, host, cold, ep, qctx = run_routed(ms, router, pin)
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in counts().items()}
            hits = {k: v - hits0[k] for k, v in grid_hits(ms,
                                                          datasets).items()}
            for p, v in ledger_launches().items():
                ledger[p] += v - led0[p]
            for k, v in ran.items():
                card[k] += v
            rows = engine_rows(res, host)
            start, stop = rollup_span()
            nsteps = (stop - start) // ROLLUP_STEP + 1
            for k, v in rows.items():
                if v.shape != (nsteps,) or not np.isfinite(v).any():
                    raise AssertionError(f"{name}: row {k} shape {v.shape}, "
                                         f"finite {np.isfinite(v).sum()}")
            if len(rows) != REQ_PODS:
                raise AssertionError(f"{name}: {len(rows)} groups")
            stitched = isinstance(ep, StitchRvsExec)
            if name != "R2" and not stitched:
                raise AssertionError(f"{name}: not a stitch: "
                                     f"{type(ep).__name__}")
            legs = leg_paths(ep, hits)
            raw_legs = [g for g in legs if g["dataset"] == "prom"]
            if not raw_legs or any(g["path"] != "grid" for g in raw_legs) \
                    or sum(ran.values()) < sum(hits.values()):
                raise AssertionError(f"{name}: the raw leg did not launch B1 "
                                     f"or B3: {legs}, launches {ran}")
            trouter = rollup_router(twin, engine, **kw)
            tres, thost, _tw, tep, tq = run_routed(twin, trouter, pin)
            if (tq.rollup_resolution_ms, tq.rollup_tiers) != \
                    (qctx.rollup_resolution_ms, qctx.rollup_tiers):
                raise AssertionError(f"{name}: the twin routed otherwise")
            err = check_engine(f"{name}", rows, engine_rows(tres, thost),
                               None, RTOL_CPU)
            walls = []
            led0 = ledger_launches()         # the twin's runs left out
            before = counts()
            for _ in range(ROLLUP_REPS):
                walls.append(run_routed(ms, router, pin)[2])
            torch.cuda.synchronize()
            warm = statistics.median(walls)
            for p, v in ledger_launches().items():
                ledger[p] += v - led0[p]
            for k, v in counts().items():
                card[k] += v - before[k]
            queries[name] = {
                "pin": pin, "knobs": sorted(kw),
                "resolution_ms": qctx.rollup_resolution_ms,
                "tiers": list(qctx.rollup_tiers), "stitched": stitched,
                "legs": legs, "launches": ran, "cold_wall_ms": cold,
                "warm_wall_ms": warm, "warm_wall_p10_p90": spread(walls),
                "samples_scanned": res.stats.samples_scanned,
                "cpu_check_err": err}
            log(f"{name} {ROLLUP_QUERY!r} resolution={pin} "
                f"{'+'.join(k for k in sorted(kw)) or ''}: tier "
                f"{qctx.rollup_resolution_ms} ms, tiers {qctx.rollup_tiers}, "
                f"{'StitchRvsExec' if stitched else type(ep).__name__}; legs "
                + "; ".join(f"{g['dataset']} [{(g['start'] - T0) // STEP}, "
                            f"{(g['end'] - T0) // STEP}] min: {g['path']} "
                            f"({g['grid_hits']} grid hits)" for g in legs)
                + f"; launches {ran}; cold wall_ms {cold:.3f}, warm median of "
                f"{ROLLUP_REPS} {warm:.3f}; samples scanned "
                f"{res.stats.samples_scanned}; cpu-twin check ok (max_abs_err "
                f"{err:.3e}, rtol {RTOL_CPU})")
            for g in legs:
                if g["path"] == "grid":
                    cache = grid_cache(ms.get_shard(g["dataset"], 0), False)
                    plans[name, g["dataset"]] = \
                        list(cache._plan_memo.values())[-1]
        torch.cuda.synchronize()
        launched = counts()
        direct = grid.rate_grid.direct - d0
        if ledger != {"grid.rate_grid": card["rate_grid"],
                      "grid.rate_grid_packed": card["rate_grid_packed"]} \
                or launched["rate_grid"] + launched["rate_grid_packed"] < 1:
            raise AssertionError(f"rollup path launches {launched} (the "
                                 f"card's runs {card}), the kernel ledger's "
                                 f"{ledger}")
        log(f"rollup path launches {launched} (rate_grid on its direct kernel "
            f"{direct}); the card's runs' {card}, equal to the kernel "
            f"ledger's {ledger}")
        # the path's launches: the R queries' and the refreshes'
        launched["rate_grid"] += rc_launches[0]
    if before_timing is not None:
        before_timing()
    with Phase("rollup.kernels_at_path_shapes"):
        flush = make_flush(device)
        # R2's raw plan (the whole range on the raw grid) and each grid
        # plan of a tier leg
        rows = [plan_kernel_times(f"rollup {q} {ds}", plan, reps, flush)[1]
                for (q, ds), plan in sorted(plans.items())
                if (q, ds) == ("R2", "prom") or ds != "prom"]
        out["segment_sum"] = segment_sum_times(tier_sum, reps)
    del tier_sum
    engine.stop()
    ms.reset()
    twin.reset()
    out.update(queries=queries, launches=launched, rate_grid_direct=direct,
               ledger_launches=ledger, rows=rows)
    report["rollup"] = out
    return out


class KernelBuild:
    """``kernels.library()``, the ``nvcc`` build, on a thread of its own,
    so that the main path's stores ingest while ``nvcc`` runs (the ingest
    launches no kernel of the library; a wrapper that did would wait at
    the library's lock)."""

    def __init__(self):
        from filodb_tpu_torch.ops import kernels

        self.t0 = time.perf_counter()
        self.seconds = None
        self._error = None
        self._thread = threading.Thread(target=self._run, args=(kernels,),
                                        name="nvcc-build", daemon=True)
        self._thread.start()

    def _run(self, kernels) -> None:
        try:
            kernels.library()
        except BaseException as e:          # re-raised by join
            self._error = e
        self.seconds = time.perf_counter() - self.t0

    def wait(self) -> None:
        """Until the build ends, whatever its outcome: no ``nvcc`` is
        left running."""
        self._thread.join()

    def join(self) -> float:
        """The build's seconds from its start; raises its error."""
        self.wait()
        if self._error is not None:
            raise self._error
        return self.seconds


class RollupBeside:
    """The rollup phase in a process of its own on the same card, run
    beside the durable phase: the two share no store, and each spends
    most of its time on the host.  The process takes the durable
    encoding's first ROLLUP_HOURS hours through a pipe (nothing is
    encoded again) and runs :func:`rollup_phase`.  No kernel timing
    shares the card with the other process's work: the rollup's
    (``rollup.kernels_at_path_shapes``) wait until the durable phase
    reaches its own, which wait until the rollup process is done.
    Where that process cannot open the card, the phase runs here after
    the durable phase."""

    def __init__(self, device, seed: int, reps: int, encoding: PodHours):
        import multiprocessing

        t0 = time.perf_counter()
        hours = encoding.get()[0]
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_rollup_beside, name="rollup",
                                 args=(child, str(device), seed, reps))
        self._proc.start()
        child.close()
        for pod in range(REQ_PODS):
            self._conn.send(hours[pod][:ROLLUP_HOURS])
        self._msg = None
        log(f"rollup: its process started beside the durable phase, the "
            f"encoding's first {ROLLUP_HOURS} hours handed over in "
            f"{time.perf_counter() - t0:.3f} s")

    def _recv(self) -> tuple:
        try:
            return self._conn.recv()
        except EOFError:
            self._proc.join(timeout=30)
            return ("error", f"the rollup process ended (exit code "
                             f"{self._proc.exitcode})", "phase")

    def time_alone(self) -> None:
        """Where the durable phase's kernel timings start: the rollup
        process times its kernels while this one waits, then sends its
        record."""
        t0 = time.perf_counter()
        msg = self._recv()
        if msg[0] == "ready":
            self._conn.send("go")
            msg = self._recv()
        self._msg = msg
        log(f"rollup: {time.perf_counter() - t0:.3f} s waited for its "
            f"process's kernel timings and record")

    def result(self, device, seed: int, reps: int, encoding: PodHours,
               report: dict) -> dict:
        if self._msg is None:
            self.time_alone()
        kind, payload = self._msg[:2]
        if kind == "done":
            report["rollup"] = payload
            return payload
        if self._msg[2] == "setup":
            log(f"rollup: its process could not open the card "
                f"({payload.strip().splitlines()[-1]}); the phase runs "
                f"here, after the durable phase")
            with Phase("rollup"):
                return rollup_phase(device, seed, reps, encoding.get()[0],
                                    report)
        raise AssertionError(f"the rollup phase failed in its process:\n"
                             f"{payload}")

    def close(self) -> None:
        self._conn.close()
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join()


def _rollup_beside(conn, device: str, seed: int, reps: int) -> None:
    """:class:`RollupBeside`'s process: the hours from the pipe, then
    the rollup phase; ``("done", its record)`` or ``("error", the
    traceback, "setup" or "phase")`` back."""
    import traceback

    stage = "setup"
    try:
        hours = {pod: conn.recv() for pod in range(REQ_PODS)}
        sys.path.insert(0, HERE)
        import torch
        dev = torch.device(device)
        if dev.type == "cuda":
            from filodb_tpu_torch.ops import kernels
            torch.cuda.set_device(dev)
            torch.empty(1, device=dev)
            kernels.library()               # the build the parent made
        stage = "phase"

        def time_alone():
            conn.send(("ready",))
            if conn.recv() != "go":
                raise AssertionError("the card was not handed over")

        with Phase("rollup"):
            out = rollup_phase(dev, seed, reps, hours, {}, time_alone)
        conn.send(("done", out))
    except BaseException:
        conn.send(("error", traceback.format_exc(), stage))
    finally:
        conn.close()


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

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # the main path's histogram pods and the durable phase's stream,
    # encoded beside the build
    hist_pods = HistPods(args.seed, HIST_PODS)
    encoding = PodHours(args.seed, REQ_PODS)
    try:
        return run_phases(args, device, hist_pods, encoding)
    finally:
        hist_pods.close()
        encoding.close()


def run_phases(args, device, hist_pods: HistPods, encoding: PodHours) -> int:
    """Every phase in order; the last two lines on success."""
    import torch
    from filodb_tpu_torch.ops import kernels

    report: dict = {}
    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        log(f"device: {kind} (torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
        log(f"nvidia-smi: {smi}")
        report["device"] = {"name": kind, "nvidia_smi": smi}
    # nvcc builds the kernels on a thread while the main path's stores
    # ingest
    build = KernelBuild()
    try:
        with Phase("stores"):
            stores = main_stores(device, args.seed, report, hist_pods)
    except BaseException:
        build.wait()
        raise
    with Phase("build"):
        t0 = time.perf_counter()
        build_s = build.join()
        log(f"build seconds {build_s:.3f} (beside the stores' ingest; "
            f"{time.perf_counter() - t0:.3f} s waited after it)")
        for line in ptxas_summary(kernels.build_log):
            log(f"  csrc: {line}")
        report["build_seconds"] = build_s
        report["build_log"] = kernels.build_log
    with Phase("kernels"):
        sweep_err = kernel_sweep(device, REPS, args.seed, report)
        with Phase("kernels.b1_sweep"):
            report["b1_sweep"] = []
            sweep_err = max(sweep_err, b1_sweep(
                device, REPS, args.seed, report["b1_sweep"],
                make_flush(device)))
        with Phase("kernels.b1_batch"):
            report["b1_batch"] = []
            sweep_err = max(sweep_err, b1_batch_sweep(
                device, args.seed, report["b1_batch"]))
        with Phase("kernels.b3_sweep"):
            sweep_err = max(sweep_err, b3_sweep(device, args.seed, report))
        sweep_err = max(sweep_err, grouped_sweep(device, REPS, args.seed,
                                                 report))
        log(f"kernel sweep: every case within tolerance (max_abs_err "
            f"{sweep_err:.3e})")
    with Phase("main"):
        main = main_path(device, args.seed, REPS, report, stores)
    del stores
    with Phase("engine"):
        engine = engine_phase(device, main["stores"], ENGINE_REPS, report)
    with Phase("batch"):
        batch = batch_phase(device, main.pop("stores"), REPS, report)
    with Phase("northstar"):
        northstar = northstar_phase(device, args.seed, REPS, report)
    # after every other phase: none of them may see its quarantine.  The
    # earlier stores are garbage by now; collect them first, so that the
    # durable stores' allocations do not pay for scanning them
    gc.collect()
    torch.cuda.empty_cache()
    beside = RollupBeside(device, args.seed, REPS, encoding)
    try:
        with Phase("durable"):
            durable = durable_phase(device, args.seed, REPS, encoding,
                                    report, beside.time_alone)
        gc.collect()
        torch.cuda.empty_cache()
        rollup = beside.result(device, args.seed, REPS, encoding, report)
    finally:
        beside.close()
    entries = kernel_entries(main, engine, batch, northstar, durable,
                             rollup, report)
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


def kernel_entries(main: dict, engine: dict, batch: dict, northstar: dict,
                   durable: dict, rollup: dict, report: dict) -> list:
    """The ``{"kernels": [...]}`` record: each kernel at the input of its
    primary query (rate_grid at Q2, rate_grid_packed at Q1, m4_grid at
    E2, the grouped kernels at the north-star widths), with its launches
    on the paths that run it (rate_grid's: the main path's, the batch
    phase's, solo and batched, the durable path's and the rollup path's;
    its batched launches also in ``launches_batched``, their times in
    ``batched``)."""
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
    for path in (durable, rollup):
        for k, n in path["launches"].items():
            launches[k] += n
    bl = batch["launches"]
    launches["rate_grid"] += bl["rate_grid"] + bl["rate_grid_batch"]
    direct = main["rate_grid_direct"] + durable["rate_grid_direct"] \
        + rollup["rate_grid_direct"] + bl["batch_direct"]
    sweep = (report["kernel_sweep"] + report["b1_sweep"] + report["b3_sweep"]
             + report["b1_batch"] + report["grouped_sweep"]
             + northstar["second_ops"])
    sources = {k: "filodb_tpu_torch/csrc/grid_kernels.cu" for k in replaces}
    sources["rate_grid"] = "filodb_tpu_torch/csrc/series_staged.cu"
    sources["hist_grid_grouped_packed"] = \
        "filodb_tpu_torch/csrc/hist_staged.cu"
    sources["rate_grid_grouped_packed"] = \
        "filodb_tpu_torch/csrc/grouped_staged.cu"
    sources["rate_grid_grouped"] = "filodb_tpu_torch/csrc/dense_staged.cu"
    entries = []
    # rate_grid's launches split by kernel: the staged kernel's, and the
    # direct kernel's (grid_kernels.cu) where its plan sends them
    split = {"rate_grid": {
        "launches_staged": launches["rate_grid"] - direct,
        "launches_direct": direct,
        "source_direct": "filodb_tpu_torch/csrc/grid_kernels.cu",
        "launches_batched": bl["rate_grid_batch"],
        "batched": [{k: r[k] for k in ("members", "ms", "solo_ms",
                                       "plain_ms", "bound_ms", "bound_by")}
                    for r in batch["times"]]}}
    for kname in replaces:
        row = path_rows[kname]
        errs = [r["max_abs_err"] for r in main["rows"].get(kname, [row])]
        errs += [r["max_abs_err"] for path in (durable, rollup)
                 for r in path["rows"] if r["kernel"] == kname]
        errs += [r["max_abs_err"] for r in sweep if r["kernel"] == kname]
        if kname == "rate_grid":
            errs += [r["max_abs_err"] for r in batch["times"]]
        entries.append({
            "name": kname, "route": "cuda",
            "source": sources[kname],
            "replaces": replaces[kname],
            "launches": launches[kname],
            "max_abs_err": max(errs + [row["max_abs_err"]]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, **split.get(kname, {})})
    return entries


if __name__ == "__main__":
    rc = main()
    # the pools are closed (main's finally); skip the interpreter's
    # teardown of the stores' millions of objects
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
