"""Histogram columns served from the device grid: the port's hist caches
(``DeviceGridCache(hist=True)``: ``hb`` bucket columns a series, the
scalar grid kernels run over each bucket column) against the JAX
package's, on the same ingested RecordContainer bytes.

- f64 residents on both sides (the CPU default), ``tests/data.py``
  ``histogram_containers``: ``scan_grid`` for each of the four range
  functions a hist cache serves, ``scan_grid_grouped``'s bucket-wise sum
  state, the declines, a bucket scheme widened mid-stream (the cache
  disables and re-probes), and a narrower series edge-padded.  Values
  and bucket tops agree to rtol 1e-9 (the rate chain's prefix sums
  associate differently), NaN positions equal, counts bit-equal.
- f32 residents packed at stride hb on both sides: the JAX store runs
  its packed kernel in Pallas interpret mode (as the JAX package's own
  ``f32_interpret`` fixture does), the port its packed wrapper's plain
  version.  The bare selector is bit-equal; sums and the rate chain
  agree to rtol 1e-6, the bound the JAX package holds its own packed
  hist path to (tests/test_devicestore.py:1284-1289).
- The engine: ``histogram_quantile`` over a grid-served bucket-wise sum
  and ``hist_to_prom_vectors`` over grid-served increases, at rtol 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

from filodb_tpu.codecs import histcodec as jhistcodec
from filodb_tpu.coordinator.planner import \
    SingleClusterPlanner as JSingleClusterPlanner
from filodb_tpu.core.filters import ColumnFilter as JColumnFilter
from filodb_tpu.core.filters import Equals as JEquals
from filodb_tpu.core.histogram import GeometricBuckets as JGeometricBuckets
from filodb_tpu.core.record import RecordBuilder as JRecordBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.storeconfig import StoreConfig as JStoreConfig
from filodb_tpu.memstore import devicestore as jdevicestore
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.parallel.shardmap import ShardMapper as JShardMapper
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jparse
from filodb_tpu.query.exec import ExecContext as JExecContext
from filodb_tpu.query.logical import RangeFunctionId as JF
from filodb_tpu.query.model import QueryContext as JQueryContext
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore import devicestore
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.parallel.shardmap import ShardMapper
from filodb_tpu_torch.promql.parser import \
    query_range_to_logical_plan as parse
from filodb_tpu_torch.query.exec import ExecContext
from filodb_tpu_torch.query.logical import RangeFunctionId as F
from filodb_tpu_torch.query.model import QueryContext
from tests.data import START_TS, histogram_containers
from tests.torch_slice_data import assert_close, fns

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)

HSTEP = 10_000                  # the data's scrape interval
K = 5
WINDOW = K * HSTEP
N_SERIES = 6
N_ROWS = 150                    # two 128-bucket blocks
STEPS0 = START_TS + (K + 1) * HSTEP
NSTEPS = N_ROWS - K - 2         # a span across blocks 0-1
HIST_FNS = ("RATE", "INCREASE", "SUM_OVER_TIME", None)
GIDS = [i % 2 for i in range(N_SERIES)]


def _memstores(containers, config=None):
    """(JAX memstore, port memstore) whose one shard ingested the same
    bytes, flushed."""
    jms, tms = JMemStore(), TimeSeriesMemStore(device="cpu")
    jshard = jms.setup("prom", J_SCHEMAS, 0, JStoreConfig(**(config or {})))
    tshard = tms.setup("prom", DEFAULT_SCHEMAS, 0,
                       StoreConfig(**(config or {})))
    for off, c in enumerate(containers):
        assert jshard.ingest_container(c, off) == \
            tshard.ingest_container(c, off)
    jshard.flush_all()
    tshard.flush_all()
    return jms, tms


def _stores(containers, config=None):
    """(JAX shard, port shard) of :func:`_memstores`."""
    return tuple(ms.get_shard("prom", 0)
                 for ms in _memstores(containers, config))


def _ids(jshard, tshard, metric):
    jres = jshard.lookup_partitions(
        [JColumnFilter("_metric_", JEquals(metric))], 0, 2**62)
    tres = tshard.lookup_partitions(
        [ColumnFilter("_metric_", Equals(metric))], 0, 2**62)
    np.testing.assert_array_equal(jres.part_ids, tres.part_ids)
    return jres.part_ids, tres.part_ids


def _cache(shard):
    return next(iter(shard.device_caches.values()))


def _close(got, want, exact: bool, rtol: float, what):
    """Equal NaN positions, some finite value, and the finite values
    equal (``exact``) or within ``rtol``."""
    assert np.isfinite(np.asarray(want, np.float64)).any(), what
    assert_close(got, want, exact, rtol, what)


def _served(got, want, what, exact=False, rtol=1e-9):
    """Both stores served a scan_grid: equal tags, tops and planes."""
    assert got is not None and want is not None, what
    assert got[0] == want[0], what
    vals = got[1]
    assert vals.ndim == 3 and vals.shape[2] == len(got[2]), what
    np.testing.assert_array_equal(got[2], want[2], err_msg=what)
    _close(vals, want[1], exact, rtol, what)


@pytest.fixture(scope="module")
def f64_stores():
    return _stores(histogram_containers(N_SERIES, N_ROWS))


# ------------------------------------------------------------ f64 residents

@pytest.mark.parametrize("name", HIST_FNS)
def test_scan_grid_matches_jax(f64_stores, name):
    jshard, tshard = f64_stores
    jids, tids = _ids(jshard, tshard, "req_latency")
    jf, tf = fns(name)
    with jax.disable_jit():
        want = jshard.scan_grid(jids, jf, STEPS0, NSTEPS, HSTEP, WINDOW)
    got = tshard.scan_grid(tids, tf, STEPS0, NSTEPS, HSTEP, WINDOW)
    _served(got, want, str(name), exact=name is None)
    assert got[1].shape == (N_SERIES, NSTEPS, 8)
    cache = _cache(tshard)
    assert cache.hist and cache.hb == 8 and cache.hits > 0
    assert _cache(jshard).hb == cache.hb


@pytest.mark.parametrize("name", ("RATE", "SUM_OVER_TIME"))
def test_scan_grid_grouped_sum_matches_jax(f64_stores, name):
    jshard, tshard = f64_stores
    jids, tids = _ids(jshard, tshard, "req_latency")
    jf, tf = fns(name)
    with jax.disable_jit():
        want = jshard.scan_grid_grouped(jids, jf, STEPS0, NSTEPS, HSTEP,
                                        WINDOW, GIDS, 2, "sum")
    got = tshard.scan_grid_grouped(tids, tf, STEPS0, NSTEPS, HSTEP,
                                   WINDOW, GIDS, 2, "sum")
    assert sorted(got) == sorted(want) == ["bucket_tops", "count",
                                           "hist_sum"]
    assert got["hist_sum"].shape == (2, NSTEPS, 8)
    np.testing.assert_array_equal(got["bucket_tops"], want["bucket_tops"])
    _close(got["hist_sum"], want["hist_sum"], False, 1e-9, name)
    _close(got["count"], want["count"], True, 0, name)


def test_unserved_functions_and_aggregates_decline(f64_stores):
    """No histogram meaning: min_over_time declines, and so does any
    grouped op but sum; the JAX package declines the same queries."""
    jshard, tshard = f64_stores
    jids, tids = _ids(jshard, tshard, "req_latency")
    for sh, ids, fn in ((jshard, jids, JF.MIN_OVER_TIME),
                        (tshard, tids, F.MIN_OVER_TIME)):
        assert sh.scan_grid(ids, fn, STEPS0, 10, HSTEP, WINDOW) is None
    for sh, ids, fn in ((jshard, jids, JF.RATE), (tshard, tids, F.RATE)):
        assert sh.scan_grid_grouped(ids, fn, STEPS0, 10, HSTEP, WINDOW,
                                    GIDS, 2, "max") is None


def _geometric_containers(nb_of, rows: int, t0: int, seed: int) -> list:
    """prom-histogram series ``lat`` with ``nb_of(s)`` geometric buckets
    for series s: cumulative in le and over time."""
    rng = np.random.default_rng(seed)
    b = JRecordBuilder(J_SCHEMAS["prom-histogram"])
    for s in range(3):
        nb = nb_of(s)
        buckets = JGeometricBuckets(2.0, 2.0, nb)
        cum = np.zeros(nb, np.int64)
        for t in range(rows):
            cum += np.sort(rng.integers(0, 5, nb))
            vals = np.cumsum(cum)
            b.add(t0 + t * HSTEP, (float(vals[-1]), float(vals[-1]),
                                   jhistcodec.encode_hist_value(buckets,
                                                                vals)),
                  {"__name__": "lat", "inst": f"i{s}", "_ws_": "w",
                   "_ns_": "n"})
    return b.containers()


def test_widened_scheme_disables_and_reprobes():
    """8-bucket rows, then 12-bucket rows: the first query over the
    widened span finds wider rows than its probe, disables the cache and
    drops the scheme; once the backoff clears it re-probes 12 buckets
    and serves, the 8-bucket rows edge-padded, as the JAX package does."""
    jshard, tshard = _stores(_geometric_containers(lambda s: 8, 48,
                                                   START_TS, 1))
    jids, tids = _ids(jshard, tshard, "lat")
    steps0 = START_TS + (K + 1) * HSTEP
    with jax.disable_jit():
        want = jshard.scan_grid(jids, JF.SUM_OVER_TIME, steps0, 20, HSTEP,
                                WINDOW)
    got = tshard.scan_grid(tids, F.SUM_OVER_TIME, steps0, 20, HSTEP,
                           WINDOW)
    _served(got, want, "8 buckets")
    assert _cache(tshard).hb == 8
    for off, c in enumerate(_geometric_containers(
            lambda s: 12, 48, START_TS + 48 * HSTEP, 2)):
        assert jshard.ingest_container(c, 100 + off) == \
            tshard.ingest_container(c, 100 + off)
    jshard.flush_all()
    tshard.flush_all()
    steps1 = START_TS + (48 - 10) * HSTEP     # a span over both schemes
    for sh, ids, fn in ((jshard, jids, JF.SUM_OVER_TIME),
                        (tshard, tids, F.SUM_OVER_TIME)):
        with jax.disable_jit():
            assert sh.scan_grid(ids, fn, steps1, 20, HSTEP, WINDOW) is None
        cache = _cache(sh)
        assert cache.hb is None and cache.bucket_tops is None
        assert not cache.blocks
        cache.disabled_until_version = -1      # the backoff clears
    with jax.disable_jit():
        want = jshard.scan_grid(jids, JF.SUM_OVER_TIME, steps1, 20, HSTEP,
                                WINDOW)
    got = tshard.scan_grid(tids, F.SUM_OVER_TIME, steps1, 20, HSTEP,
                           WINDOW)
    _served(got, want, "widened to 12 buckets")
    assert _cache(tshard).hb == 12 and got[1].shape[2] == 12


def test_narrower_series_edge_pads():
    """One store, two schemes: the first series (whose leading rows the
    probe reads) has 12 buckets, the others 8; their rows edge-pad to 12
    (the top bucket is the total), as the JAX package pads them."""
    jshard, tshard = _stores(_geometric_containers(
        lambda s: 12 if s == 0 else 8, 60, START_TS, 3))
    jids, tids = _ids(jshard, tshard, "lat")
    for name in ("RATE", None):
        jf, tf = fns(name)
        with jax.disable_jit():
            want = jshard.scan_grid(jids, jf, STEPS0, 40, HSTEP, WINDOW)
        got = tshard.scan_grid(tids, tf, STEPS0, 40, HSTEP, WINDOW)
        _served(got, want, f"edge-padded {name}", exact=name is None)
        vals = got[1]
        assert vals.shape[2] == 12
        # the padded buckets repeat each narrow series' top bucket
        assert torch.equal(torch.isnan(vals[1:, :, 8:]),
                           torch.isnan(vals[1:, :, 7:8].expand(-1, -1, 4)))
        fin = torch.isfinite(vals[1:, :, 7])
        assert torch.equal(vals[1:, :, 11][fin], vals[1:, :, 7][fin])


# ------------------------------------------------- f32, packed at stride hb

HB = 8


@pytest.fixture()
def f32_residents(monkeypatch):
    """f32 residents on both sides: the JAX store runs its packed kernel
    in Pallas interpret mode, the port its packed wrapper's plain
    version."""
    monkeypatch.setattr(jdevicestore, "_PACKED_INTERPRET", True)
    monkeypatch.setattr(jdevicestore, "_PACKED_BROKEN", False)
    monkeypatch.setattr(jdevicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)
    monkeypatch.setattr(devicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)


def _packing_containers(n_series=6, rows=96, seed=3) -> list:
    """Integer counts with a pinned f32 exponent and a constant phase, so
    that the block packs.  Even series step by multiples of 128 (their
    bucket columns take the 8-bit class), odd ones by odd counts (the
    16-bit class): the pack reorders series, and its ``inv`` is not the
    identity."""
    rng = np.random.default_rng(seed)
    buckets = JGeometricBuckets(2.0, 2.0, HB)
    b = JRecordBuilder(J_SCHEMAS["prom-histogram"])
    for s in range(n_series):
        ph = int(rng.integers(1, HSTEP))
        cum = np.zeros(HB, np.int64)
        for t in range(rows):
            if s % 2:
                cum += 2 * rng.integers(0, 512, HB) + 1
            else:
                cum += 128 * rng.integers(1, 8, HB)
            vals = 2 ** 23 + np.cumsum(cum)
            b.add(START_TS + t * HSTEP - HSTEP + ph,
                  (float(vals[-1]), float(vals[-1]),
                   jhistcodec.encode_hist_value(buckets, vals)),
                  {"__name__": "plat", "instance": f"i{s}", "_ws_": "w",
                   "_ns_": "n"})
    return b.containers()


def test_packed_stride_hb_matches_jax(f32_residents):
    jshard, tshard = _stores(_packing_containers(),
                             {"device_cache_compress": True})
    jids, tids = _ids(jshard, tshard, "plat")
    steps0, nsteps = START_TS + (K + 1) * HSTEP, 96 - K - 2
    # the first request lanes every series; the second skips lanes and
    # reverses the order, so a lane-granular map would pick wrong columns
    sub = (np.asarray(jids[1::2][::-1]), np.asarray(tids[1::2][::-1]))
    for req_j, req_t in ((jids, tids), sub):
        for name in HIST_FNS:
            jf, tf = fns(name)
            want = jshard.scan_grid(req_j, jf, steps0, nsteps, HSTEP,
                                    WINDOW)
            got = tshard.scan_grid(req_t, tf, steps0, nsteps, HSTEP,
                                   WINDOW)
            assert got[1].dtype == torch.float32
            _served(got, want, f"packed {name} {len(req_t)} series",
                    exact=name is None, rtol=1e-6)
            plan = next(reversed(_cache(tshard)._plan_memo.values()))
            assert plan.packed is not None, name
            inv = plan.packed_inv
            assert not np.array_equal(inv, np.arange(len(inv)))
            assert plan.ncols % HB == 0 and len(inv) == plan.ncols
    gids = [0, 1, 1, 0, 0, 1]
    want = jshard.scan_grid_grouped(jids, JF.RATE, steps0, nsteps, HSTEP,
                                    WINDOW, gids, 2, "sum")
    got = tshard.scan_grid_grouped(tids, F.RATE, steps0, nsteps, HSTEP,
                                   WINDOW, gids, 2, "sum")
    assert next(reversed(_cache(tshard)._plan_memo.values())).packed \
        is not None
    _close(got["hist_sum"], want["hist_sum"], False, 1e-6, "grouped sum")
    _close(got["count"], want["count"], True, 0, "grouped count")


# -------------------------------------------------------------- the engine

STEP = 10_000
START = START_TS + 120_000
END = START_TS + 550_000


@pytest.mark.parametrize("query", [
    'histogram_quantile(0.9, sum(rate(req_latency[1m])))',
    'histogram_quantile(0.5, sum by (host)(rate(req_latency[1m])))',
    'hist_to_prom_vectors(increase(req_latency[1m]))',
    'sum_over_time(req_latency[1m])',
])
def test_engine_serves_hist_from_the_grid(query):
    jms, ms = _memstores(histogram_containers(8, 60))
    want = JSingleClusterPlanner("prom", JShardMapper(1)).materialize(
        jparse(query, START, STEP, END)).execute(
            JExecContext(jms, JQueryContext()))
    got = SingleClusterPlanner("prom", ShardMapper(1)).materialize(
        parse(query, START, STEP, END)).execute(
            ExecContext(ms, QueryContext()))
    cache = _cache(ms.get_shard("prom", 0))
    assert cache.hist and cache.hits > 0 and cache.builds > 0, query
    rows = {}
    for res in (want, got):
        out = {}
        for b in res.batches:
            vals = b.np_values()
            hist = None if b.hist is None \
                else np.asarray(b.hist)[:len(b.keys)]
            for i, tags in enumerate(b.keys):
                out[tuple(sorted(tags.items()))] = (
                    vals[i], None if hist is None else hist[i])
        rows[res is got] = out
    assert rows[True].keys() == rows[False].keys() and rows[True], query
    for key, (w_vals, w_hist) in rows[False].items():
        g_vals, g_hist = rows[True][key]
        np.testing.assert_array_equal(np.isnan(g_vals), np.isnan(w_vals))
        if np.isfinite(w_vals).any():
            _close(g_vals, w_vals, False, 1e-9, f"{query} {key}")
        assert (g_hist is None) == (w_hist is None), query
        if w_hist is not None:
            _close(g_hist, w_hist, False, 1e-9, f"{query} {key} hist")
