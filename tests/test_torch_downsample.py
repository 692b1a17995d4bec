"""The port's downsampling (``filodb_tpu_torch.downsample``) against the
JAX package's, on the same numpy inputs:

- each chunk downsampler and period marker, bit for bit in f64;
- the grid path's period reduce and ``grid_outputs`` (the port's in
  torch on the CPU, the JAX package's jitted with x64 on): ``min``,
  ``max``, ``last``, ``count`` and the stamps bit for bit, ``sum`` and
  ``avg`` within rtol 1e-12, NaN samples and the cascade included;
- flush-time downsampling through a shard of each package, at 1 min and
  1 h, on the grid path and the host path (a reset series, an irregular
  cadence): the drained containers decode to equal rows;
- the five ``*_over_time`` rewrites over a ds-gauge dataset and the
  instant selector, through each package's planner and engine, against
  each other and against the raw oracle of tests/test_downsample.py;
- ``BatchDownsampler`` over a ``DiskColumnStore`` and
  ``DownsampledTimeSeriesStore.recover``; the paging shard's eviction
  hook (each victim downsampled once); ``best_resolution``;
- a counter's 1 h dataset on each package's grid: served or refused
  alike."""

import math

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import \
    SingleClusterPlanner as JSingleClusterPlanner
from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.record import decode_container as jdecode_container
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetOptions as JDatasetOptions
from filodb_tpu.downsample import chunkdown as jchunkdown
from filodb_tpu.downsample import griddown as jgriddown
from filodb_tpu.downsample import (BatchDownsampler as JBatchDownsampler,
                                   DownsampledTimeSeriesStore as JDsStore,
                                   MemoryDownsamplePublisher as JPublisher)
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.parallel.shardmap import ShardMapper as JShardMapper
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jquery_range_to_logical_plan
from filodb_tpu.query.exec import ExecContext as JExecContext
from filodb_tpu.query.model import QueryContext as JQueryContext
from filodb_tpu.store.persistence import DiskColumnStore as JDiskColumnStore
from filodb_tpu.store.persistence import DiskMetaStore as JDiskMetaStore
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.core.record import decode_container
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetOptions
from filodb_tpu_torch.downsample import chunkdown, griddown
from filodb_tpu_torch.downsample import (BatchDownsampler,
                                         DownsampledTimeSeriesStore,
                                         MemoryDownsamplePublisher,
                                         ds_dataset_name)
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.parallel.shardmap import ShardMapper
from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
from filodb_tpu_torch.query.exec import ExecContext
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.store.persistence import DiskColumnStore, DiskMetaStore

torch.set_num_threads(1)

BASE = 1_700_000_000_000
RES = 60_000
HOUR = 3_600_000
RTOL_SUM = 1e-12          # sum/avg: the reduction order may differ


def _equal_bits(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, msg
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.int64), b.view(np.int64)), msg
    else:
        assert np.array_equal(a, b), msg


def _close(a, b, msg=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b)), msg
    np.testing.assert_allclose(a, b, rtol=RTOL_SUM, err_msg=msg)


# ---------------------------------------------------------------------------
# downsamplers and period markers
# ---------------------------------------------------------------------------

SPECS = ["tTime(0)", "dMin(1)", "dMax(1)", "dSum(1)", "dCount(1)",
         "dAvg(1)", "dLast(1)", "dAvgSc(1,2)", "dAvgAc(1,2)"]


def _chunk(seed: int):
    rng = np.random.default_rng(seed)
    ts = BASE + np.unique(np.sort(rng.integers(1, 30 * RES, 400)))
    v = np.cumsum(rng.random(len(ts)) * 5)
    v[rng.random(len(ts)) < 0.05] = np.nan
    v[len(ts) // 3:] -= v[len(ts) // 3 - 1] * 0.9       # a reset
    cnt = rng.integers(0, 4, len(ts)).astype(np.float64)
    return ts.astype(np.int64), [v, cnt]


@pytest.mark.parametrize("marker", ["time(0)", "counter(1)"])
@pytest.mark.parametrize("res", [RES, 15 * RES])
def test_downsamplers_and_markers_bit_equal(marker, res):
    ts, cols = _chunk(res + len(marker))
    jm = jchunkdown.parse_period_marker(marker)
    tm = chunkdown.parse_period_marker(marker)
    jb, je = jm.periods(ts, cols, res)
    tb, te = tm.periods(ts, cols, res)
    _equal_bits(tb, jb, marker)
    _equal_bits(te, je, marker)
    for spec in SPECS:
        want = jchunkdown.parse_downsampler(spec).downsample(ts, cols, jb, je)
        got = chunkdown.parse_downsampler(spec).downsample(ts, cols, tb, te)
        _equal_bits(got, want, spec)
    with pytest.raises(ValueError):
        chunkdown.parse_downsampler("dBogus(1)")
    with pytest.raises(ValueError):
        chunkdown.parse_period_marker("weird(0)")


def test_histogram_downsamplers_bit_equal():
    from filodb_tpu.core.histogram import CustomBuckets as JBuckets
    from filodb_tpu_torch.core.histogram import CustomBuckets
    rng = np.random.default_rng(4)
    ts = BASE + np.arange(120, dtype=np.int64) * 10_000 + 7
    rows = np.cumsum(rng.integers(0, 5, (120, 8)), axis=0).cumsum(axis=1)
    tops = [2.0 ** i for i in range(7)] + [math.inf]
    bounds, ends = chunkdown.TimePeriodMarker(0).periods(ts, [], RES)
    for spec in ("hLast(1)", "hSum(1)"):
        jb, jr = jchunkdown.parse_downsampler(spec).downsample(
            ts, [(JBuckets(np.asarray(tops)), rows)], bounds, ends)
        tb, tr = chunkdown.parse_downsampler(spec).downsample(
            ts, [(CustomBuckets(np.asarray(tops)), rows)], bounds, ends)
        _equal_bits(tr, jr, spec)
        _equal_bits(tb.bucket_tops(), jb.bucket_tops())


# ---------------------------------------------------------------------------
# the grid path: period reduce, cascade, grid_outputs
# ---------------------------------------------------------------------------


def _planes_equal(got: dict, want: dict, msg: str):
    for k in ("cnt", "min", "max", "last"):
        _equal_bits(got[k], want[k], f"{msg} {k}")
    for k in ("sum", "avg"):
        _close(got[k], want[k], f"{msg} {k}")


@pytest.mark.parametrize("nan_share", [0.0, 0.3])
def test_period_reduce_matches_jax(nan_share):
    rng = np.random.default_rng(11)
    P, K, S = 12, 15, 37
    vals = rng.normal(1e6, 3e5, (P * K, S))
    vals[rng.random(vals.shape) < nan_share] = np.nan
    vals[:, 5] = np.nan                              # a dead lane
    want = jgriddown.period_reduce(vals, P, K)
    got = griddown.period_reduce(vals, P, K, "cpu")
    _planes_equal(got, want, f"nan {nan_share}")
    # the cascade: 15-row periods tiled 4 at a time
    _planes_equal(griddown._cascade_planes(got, P // 4, 4),
                  jgriddown._cascade_planes(want, P // 4, 4), "cascade")


def _regular(n_series=9, n_rows=600, step=5_000, seed=2, resets=(3,),
             nan_lane=4):
    rng = np.random.default_rng(seed)
    ts_list, cols_list = [], []
    for s in range(n_series):
        ts = BASE + np.arange(n_rows, dtype=np.int64) * step + 1 + s * 17
        v = np.cumsum(rng.random(n_rows) * 3)
        if s in resets:
            v[n_rows // 2:] -= v[n_rows // 2] * 0.9
        if s == nan_lane:
            v[rng.random(n_rows) < 0.2] = np.nan
        ts_list.append(ts)
        cols_list.append([v])
    return ts_list, cols_list


@pytest.mark.parametrize("marker", ["time(0)", "counter(1)"])
def test_grid_outputs_match_jax(marker):
    ts_list, cols_list = _regular()
    specs = ["tTime(0)", "dMin(1)", "dMax(1)", "dSum(1)", "dCount(1)",
             "dAvg(1)", "dLast(1)"]
    outs = {}
    for pkg, ds, gd in (("jax", jchunkdown, jgriddown),
                        ("torch", chunkdown, griddown)):
        dss = [ds.parse_downsampler(s) for s in specs]
        m = ds.parse_period_marker(marker)
        assert gd.grid_supported(dss)
        g = gd.detect_gstep(ts_list)
        staged = gd.stage_grid(ts_list, cols_list, g, 60,
                               reset_col=0 if marker.startswith("c")
                               else None)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        outs[pkg] = [gd.grid_outputs(staged, res, dss, m, **kw)
                     for res in (RES, 5 * RES)]      # the 2nd cascades
    for (js, jo, jp, jl), (ts_, to, tp, tl) in zip(outs["jax"],
                                                    outs["torch"]):
        _equal_bits(ts_, js)
        _equal_bits(tp, jp)
        _equal_bits(tl, jl)
        for spec, a, b in zip(specs, to, jo):
            if a is None:
                assert b is None
            elif spec.startswith(("dSum", "dAvg")):
                _close(a, b, spec)
            else:
                _equal_bits(a, b, spec)
    if marker.startswith("c"):
        assert not outs["torch"][0][0][3]        # the reset lane: host path


# ---------------------------------------------------------------------------
# flush-time downsampling through a shard of each package
# ---------------------------------------------------------------------------


def _containers(schema: str, seed: int = 5, n_series: int = 8,
                n_rows: int = 420, step: int = 10_000):
    """Series on a regular cadence (grid path) plus a reset series and
    one of irregular cadence (host path)."""
    rng = np.random.default_rng(seed)
    b = RecordBuilder(J_SCHEMAS[schema])
    for s in range(n_series):
        tags = {"__name__": "m", "inst": f"i{s}", "_ws_": "w", "_ns_": "n"}
        ts = BASE + np.arange(n_rows, dtype=np.int64) * step + 1 + s * 13
        if s == n_series - 1:                        # irregular cadence
            ts = np.unique(BASE + np.sort(rng.integers(1, n_rows * step,
                                                       n_rows)))
        v = np.cumsum(rng.random(len(ts)) * 3)
        if s == 2:                                   # a reset
            v[len(v) // 2:] -= v[len(v) // 2] * 0.9
        if s == 1 and schema == "gauge":
            v[rng.random(len(v)) < 0.1] = np.nan
        b.add_series(ts, [v], tags)
    return b.containers()


def _rows(containers, decode, schemas):
    out = []
    for _sh, c in containers:
        for r in decode(c, schemas):
            out.append((tuple(sorted(r.tags.items())), r.timestamp,
                        np.asarray(r.values, np.float64)))
    out.sort(key=lambda x: (x[0], x[1]))
    return out


def _rows_equal(got, want, sum_cols=()):
    assert len(got) == len(want) > 0
    for (tg, tsg, vg), (tw, tsw, vw) in zip(got, want):
        assert (tg, tsg) == (tw, tsw)
        for i in range(len(vw)):
            if i in sum_cols:
                _close(vg[i:i + 1], vw[i:i + 1])
            else:
                _equal_bits(vg[i:i + 1], vw[i:i + 1], f"col {i}")


def _flushed(schema: str, resolutions, containers, paging_evict=False,
             tmp_path=None):
    """Both packages' publishers after ingesting ``containers`` and
    flushing (or, with ``paging_evict``, evicting every partition of a
    paging shard over sqlite)."""
    pubs = []
    for JM, MS, pub_cls, dev in ((JMemStore, J_SCHEMAS, JPublisher, None),
                                 (TimeSeriesMemStore, DEFAULT_SCHEMAS,
                                  MemoryDownsamplePublisher, "cpu")):
        kw = {} if dev is None else {"device": dev}
        if paging_evict:
            tag = "j" if dev is None else "t"
            Disk, Meta = (JDiskColumnStore, JDiskMetaStore) if dev is None \
                else (DiskColumnStore, DiskMetaStore)
            ms = JM(Disk(str(tmp_path / f"{tag}c.db")),
                    Meta(str(tmp_path / f"{tag}m.db")), **kw)
        else:
            ms = JM(**kw)
        shard = ms.setup("prom", MS, 0)
        pub = pub_cls()
        shard.enable_downsampling(pub, resolutions)
        for off, c in enumerate(containers):
            ms.ingest("prom", 0, c, off)
        if paging_evict:
            assert shard.evict_partitions(shard.num_partitions) > 0
        else:
            shard.flush_all(ingestion_time=1000)
        pubs.append((pub, ms))
    return pubs


@pytest.mark.parametrize("schema", ["prom-counter", "gauge"])
def test_flush_time_downsample_matches_jax(schema):
    conts = _containers(schema)
    (jax_pub, _j), (port_pub, _t) = _flushed(schema, (RES, HOUR), conts)
    sum_cols = (2, 4) if schema == "gauge" else ()   # dSum, dAvg
    for res in (RES, HOUR):
        _rows_equal(_rows(port_pub.drain(res), decode_container,
                          DEFAULT_SCHEMAS),
                    _rows(jax_pub.drain(res), jdecode_container, J_SCHEMAS),
                    sum_cols)


def test_grid_and_host_paths_both_run(monkeypatch):
    """The counter data of the flush test runs the grid path for its
    regular series and the host path for the reset and irregular ones."""
    served = []
    real = griddown.grid_outputs

    def spy(*a, **kw):
        got = real(*a, **kw)
        if got is not None:
            served.append(got[0].copy())
        return got

    monkeypatch.setattr(griddown, "grid_outputs", spy)
    _flushed("prom-counter", (RES,), _containers("prom-counter"))
    # a flush task a group: the 6 regular series on the grid, the reset
    # and the irregular one on the host path
    assert sum(int(m.sum()) for m in served) == 6


def test_eviction_downsamples_each_victim_once(tmp_path):
    conts = _containers("prom-counter", n_series=6)
    (jax_pub, _j), (port_pub, _t) = _flushed("prom-counter", (RES,), conts,
                                      paging_evict=True, tmp_path=tmp_path)
    got = _rows(port_pub.drain(RES), decode_container, DEFAULT_SCHEMAS)
    want = _rows(jax_pub.drain(RES), jdecode_container, J_SCHEMAS)
    _rows_equal(got, want)
    keys = [(k, t) for k, t, _v in got]
    assert len(keys) == len(set(keys))           # no period twice
    assert len({k for k, _t in keys}) == 6       # every victim


# ---------------------------------------------------------------------------
# serving: ds-gauge rewrites, best_resolution, a counter's 1 h grid
# ---------------------------------------------------------------------------

W = 5                      # window periods


def _gauge_truth(n_series=3, n_rows=600, res_span=30):
    b = RecordBuilder(J_SCHEMAS["gauge"])
    rng = np.random.default_rng(7)
    truth = {}
    for s in range(n_series):
        tags = {"__name__": "disk_io", "job": "app", "instance": f"i{s}",
                "_ws_": "w", "_ns_": "n"}
        ts = np.unique(BASE + np.sort(rng.integers(1, res_span * RES,
                                                   n_rows)))
        vals = rng.normal(50, 10, len(ts))
        truth[f"i{s}"] = (ts.astype(np.int64), vals.copy())
        for t, v in zip(ts, vals):
            b.add(int(t), [float(v)], tags)
    return b.containers(), truth


@pytest.fixture(scope="module")
def served():
    conts, truth = _gauge_truth()
    (jax_pub, _j), (port_pub, _t) = _flushed("gauge", (RES,), conts)
    jds = JDsStore("prom", resolutions_ms=(RES,))
    jds.setup(J_SCHEMAS, 0)
    jds.ingest_from_publisher(jax_pub)
    tds = DownsampledTimeSeriesStore("prom", resolutions_ms=(RES,),
                                     device="cpu")
    tds.setup(DEFAULT_SCHEMAS, 0)
    tds.ingest_from_publisher(port_pub)
    return jds, tds, truth


def _engine(ds, promql, start, step, end, jax_side: bool):
    name = ds_dataset_name("prom", RES)
    if jax_side:
        planner = JSingleClusterPlanner(name, JShardMapper(1),
                                        JDatasetOptions(), spread_default=0)
        plan = jquery_range_to_logical_plan(promql, start, step, end)
        ep = planner.materialize(plan, JQueryContext(sample_limit=10**9))
        res = ep.execute(JExecContext(ds.memstore))
    else:
        planner = SingleClusterPlanner(name, ShardMapper(1),
                                       DatasetOptions(), spread_default=0)
        plan = query_range_to_logical_plan(promql, start, step, end)
        ep = planner.materialize(plan, QueryContext(sample_limit=10**9))
        res = ep.execute(ExecContext(ds.memstore))
    out = {}
    for b in res.batches:
        for tags, ts, vals in b.to_series():
            out[tags["instance"]] = (np.asarray(ts),
                                     np.asarray(vals, np.float64))
    return out


def _oracle(ts, vals, step_ts, fn):
    w = W * RES
    out = np.full(len(step_ts), np.nan)
    for j, t in enumerate(step_ts):
        m = (ts > t - w) & (ts <= t)
        if m.any():
            out[j] = fn(vals[m])
    return out


@pytest.mark.parametrize("func,orc", [
    ("min_over_time", np.min), ("max_over_time", np.max),
    ("sum_over_time", np.sum), ("count_over_time", len),
    ("avg_over_time", np.mean)])
def test_ds_gauge_rewrites_match_jax_and_oracle(func, orc, served):
    jds, tds, truth = served
    start = ((BASE // RES) + W + 1) * RES
    end = ((BASE // RES) + 25) * RES
    q = f'{func}(disk_io{{_ws_="w",_ns_="n"}}[{W}m])'
    want = _engine(jds, q, start, RES, end, True)
    got = _engine(tds, q, start, RES, end, False)
    assert set(got) == set(want) == set(truth)
    for inst, (ts, vals) in truth.items():
        g_ts, g = got[inst]
        _equal_bits(g_ts, want[inst][0])
        _close(g, want[inst][1], f"{func} {inst}")
        ref = _oracle(ts, vals, g_ts, orc)
        assert np.array_equal(np.isfinite(g), np.isfinite(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(g[fin], ref[fin], rtol=1e-10)


def test_ds_gauge_instant_selector_serves_avg(served):
    jds, tds, truth = served
    start = ((BASE // RES) + W + 1) * RES
    end = ((BASE // RES) + 25) * RES
    q = 'disk_io{_ws_="w",_ns_="n"}'
    want = _engine(jds, q, start, RES, end, True)
    got = _engine(tds, q, start, RES, end, False)
    for inst, (ts, vals) in truth.items():
        g_ts, g = got[inst]
        _close(g, want[inst][1], inst)
        pids = (ts - 1) // RES
        for j, t in enumerate(g_ts):
            elig = pids[(ts <= t) & (ts > t - 300_000)]
            if len(elig) == 0:
                assert np.isnan(g[j])
            else:
                np.testing.assert_allclose(g[j], vals[pids == elig[-1]]
                                           .mean(), rtol=1e-10)


def test_best_resolution():
    for r in (30_000, 60_000, 90_000, HOUR, 10**9):
        t = DownsampledTimeSeriesStore("prom", resolutions_ms=(HOUR, RES),
                                       device="cpu").best_resolution(r)
        j = JDsStore("prom", resolutions_ms=(HOUR, RES)).best_resolution(r)
        assert t == j
    assert t == HOUR


def _counter_hours(n_series=24, n_rows=300):
    """A counter at one-minute scrapes, 1% of them... one series with a
    reset: the durable store's data in small."""
    rng = np.random.default_rng(8)
    b = RecordBuilder(J_SCHEMAS["prom-counter"])
    t0 = 1_700_000_040_000
    for s in range(n_series):
        tags = {"__name__": "req_total", "pod": f"pod-{s % 3}",
                "instance": f"i{s}", "_ws_": "w", "_ns_": "n"}
        ts = t0 + np.arange(n_rows, dtype=np.int64) * RES \
            + int(rng.integers(1, RES))
        v = rng.integers(0, 10**6) + np.cumsum(
            rng.integers(0, 10, n_rows)).astype(np.float64)
        if s == 5:
            v[140:] -= v[139]
        b.add_series(ts, [v], tags)
    return b.containers(), t0


@pytest.fixture(scope="module")
def counter_ds():
    conts, t0 = _counter_hours()
    (jax_pub, _j), (port_pub, _t) = _flushed("prom-counter", (RES, HOUR), conts)
    jds = JDsStore("prom", resolutions_ms=(RES, HOUR))
    jds.setup(J_SCHEMAS, 0)
    jds.ingest_from_publisher(jax_pub)
    tds = DownsampledTimeSeriesStore("prom", resolutions_ms=(RES, HOUR),
                                     device="cpu")
    tds.setup(DEFAULT_SCHEMAS, 0)
    tds.ingest_from_publisher(port_pub)
    return jds, tds, t0


@pytest.mark.parametrize("res,query,step,on_grid", [
    (RES, "sum by (pod)(rate(req_total{_ws_=\"w\",_ns_=\"n\"}[5m]))",
     RES, True),
    (RES, "rate(req_total{_ws_=\"w\",_ns_=\"n\"}[5m])", RES, True),
    (HOUR, "sum by (pod)(increase(req_total{_ws_=\"w\",_ns_=\"n\"}[2h]))",
     HOUR, False)])
def test_counter_ds_datasets_on_the_grid_as_jax(counter_ds, res, query,
                                                step, on_grid):
    """A counter's ds datasets through each package's planner: the grid
    serves the 1 min dataset and refuses the 1 h one (partial periods at
    flush boundaries and reset splits put two stamps in one bucket), in
    both packages alike, and the answers agree."""
    jds, tds, t0 = counter_ds
    start = (t0 // HOUR + 2) * HOUR
    end = start + 2 * HOUR
    name = ds_dataset_name("prom", res)
    served = {}
    out = {}
    for pkg, ds, parse, Planner, Mapper, Opts, Ctx, QCtx in (
            ("jax", jds, jquery_range_to_logical_plan,
             JSingleClusterPlanner, JShardMapper, JDatasetOptions,
             JExecContext, JQueryContext),
            ("torch", tds, query_range_to_logical_plan,
             SingleClusterPlanner, ShardMapper, DatasetOptions,
             ExecContext, QueryContext)):
        shard = ds.memstore.get_shard(name, 0)
        before = sum(c.hits for c in shard.device_caches.values())
        ep = Planner(name, Mapper(1), Opts(), spread_default=0).materialize(
            parse(query, start, step, end), QCtx(sample_limit=10**9))
        res_ = ep.execute(Ctx(ds.memstore))
        served[pkg] = sum(c.hits for c in shard.device_caches.values()) \
            > before
        out[pkg] = {tuple(sorted(t.items())): np.asarray(v, np.float64)
                    for b in res_.batches for t, _ts, v in b.to_series()}
    assert served == {"jax": on_grid, "torch": on_grid}
    assert out["torch"].keys() == out["jax"].keys() and out["jax"]
    for k, v in out["jax"].items():
        np.testing.assert_allclose(out["torch"][k], v, rtol=1e-9,
                                   err_msg=str(k))


# ---------------------------------------------------------------------------
# the batch job and recovery over sqlite
# ---------------------------------------------------------------------------


def _batch(tmp_path, tag, schema, conts, jax_side):
    MS, Disk, Meta, Job, Ds, schemas, kw = (
        (JMemStore, JDiskColumnStore, JDiskMetaStore, JBatchDownsampler,
         JDsStore, J_SCHEMAS, {}) if jax_side else
        (TimeSeriesMemStore, DiskColumnStore, DiskMetaStore,
         BatchDownsampler, DownsampledTimeSeriesStore, DEFAULT_SCHEMAS,
         {"device": "cpu"}))
    disk = Disk(str(tmp_path / f"{tag}c.db"))
    meta = Meta(str(tmp_path / f"{tag}m.db"))
    ms = MS(disk, meta, **kw)
    ms.setup("prom", schemas, 0)
    for off, c in enumerate(conts):
        ms.ingest("prom", 0, c, off)
    ms.get_shard("prom", 0).flush_all(ingestion_time=1000)
    written = Job("prom", schemas, disk, resolutions_ms=(RES, HOUR),
                  **kw).run_shard(0, 0, 2**62)
    chunks = {}
    for res in (RES, HOUR):
        name = ds_dataset_name("prom", res)
        chunks[res] = sorted(
            (cs.partkey, cs.info.chunk_id, cs.info.num_rows,
             cs.info.start_time, cs.info.end_time,
             tuple(bytes(v) for v in cs.vectors))
            for cs in disk.chunksets_by_ingestion_time(name, 0, 0, 2**62))
    ds = Ds("prom", disk, meta, resolutions_ms=(RES, HOUR), **kw)
    ds.setup(schemas, 0)
    return written, chunks, ds.recover(0), ds


def _ds_rows(ds, res, schemas):
    """Every row of a ds dataset as (tags, ts, values), sorted."""
    from filodb_tpu_torch.core.filters import ColumnFilter, Equals
    shard = ds.shard(res, 0)
    ids = shard.lookup_partitions(
        [ColumnFilter("_ws_", Equals("w"))], 0, 2**62).part_ids
    tags, batch = shard.scan_batch(ids, 0, 2**62)
    out = []
    for i, t in enumerate(tags):
        n = int(np.asarray(batch.row_counts)[i])
        for ts, v in zip(np.asarray(batch.timestamps)[i][:n],
                         np.asarray(batch.values)[i][:n]):
            out.append((tuple(sorted(t.items())), int(ts), float(v)))
    return sorted(out)


def test_batch_job_and_recover_match_jax(tmp_path):
    """A gauge: the ds chunks byte-equal to the JAX package's, and the
    recovered ds store's rows those of the flush-time downsample."""
    conts = _containers("gauge", n_series=6, n_rows=600)
    jw, jchunks, jrec, _jds = _batch(tmp_path, "j", "gauge", conts, True)
    tw, tchunks, trec, tds = _batch(tmp_path, "t", "gauge", conts, False)
    assert tw == jw and tw[RES] > 0 and tw[HOUR] > 0
    from filodb_tpu_torch.codecs import doublecodec
    for res in (RES, HOUR):
        assert len(tchunks[res]) == len(jchunks[res])
        for got, want in zip(tchunks[res], jchunks[res]):
            assert got[:5] == want[:5]
            # the stamps, min, max and count encode to the same bytes;
            # dSum and dAvg (vectors 3 and 5) hold within RTOL_SUM
            for i, (g, w) in enumerate(zip(got[5], want[5])):
                if i in (3, 5):
                    _close(doublecodec.decode(g), doublecodec.decode(w))
                else:
                    assert g == w, (res, i)
    assert trec == jrec == 2 * 6


def test_batch_job_downsamples_a_counter_as_the_flush_does(tmp_path):
    """prom-counter downsamples into itself.  The JAX package's batch job
    skips such a schema (its ``downsample`` is None) and writes nothing;
    the port's writes the rows the flush-time downsample of the same
    chunks publishes, which equal the JAX package's."""
    conts = _containers("prom-counter", n_series=6, n_rows=600)
    jw, _jc, _jr, _jds = _batch(tmp_path, "j", "prom-counter", conts, True)
    tw, _tc, trec, tds = _batch(tmp_path, "t", "prom-counter", conts, False)
    assert jw == {RES: 0, HOUR: 0}
    assert tw[RES] > 0 and tw[HOUR] > 0 and trec == 2 * 6
    (jax_pub, _j), _t = _flushed("prom-counter", (RES, HOUR), conts)
    for res in (RES, HOUR):
        want = sorted((k, t, float(v[0])) for k, t, v in
                      _rows(jax_pub.drain(res), jdecode_container, J_SCHEMAS))
        got = _ds_rows(tds, res, DEFAULT_SCHEMAS)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            _equal_bits([g[2]], [w[2]], str(g[:2]))


def test_the_card_unless_the_cpu_is_asked_for():
    """A store, a batch job and a reduce asked for the card run there or
    raise: none of them carries on on the CPU."""
    vals = np.arange(8, dtype=np.float64).reshape(4, 2)
    if torch.cuda.is_available():
        got = griddown.period_reduce(vals, 2, 2)
        _planes_equal(got, griddown.period_reduce(vals, 2, 2, "cpu"), "card")
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        griddown.period_reduce(vals, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DownsampledTimeSeriesStore("prom")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchDownsampler("prom", DEFAULT_SCHEMAS, None)
