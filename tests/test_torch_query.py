"""The port's query engine end to end against the JAX package's: the same
containers ingested into a JAX memstore and a port memstore
(``device="cpu"``), two shards each behind a two-shard ShardMapper, and
the same PromQL strings run through parse -> plan -> execute on both.

Compared as tests/test_grid_differential.py compares: the same label
sets, NaN positions equal, finite values within rtol 1e-9 / atol 1e-12.
The port's grid must serve the queries it can serve (its
DeviceGridCache hits), so the comparison covers both the grid seams and
the general path."""

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import \
    SingleClusterPlanner as JSingleClusterPlanner
from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.record import decode_container as jdecode_container
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetOptions as JDatasetOptions
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.parallel.shardmap import ShardMapper as JShardMapper
from filodb_tpu.parallel.shardmap import ShardStatus as JShardStatus
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jquery_range_to_logical_plan
from filodb_tpu.query.exec import ExecContext as JExecContext
from filodb_tpu.query.model import QueryContext as JQueryContext
from filodb_tpu.query.transformers import DownsampleMapper as JDownsample
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.core.record import decode_container
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetOptions
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import grid
from filodb_tpu_torch.parallel.shardmap import ShardMapper, ShardStatus
from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
from filodb_tpu_torch.query.exec import ExecContext
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.query.transformers import DownsampleMapper
from filodb_tpu_torch.utils.observability import TRACER

BASE = 1_700_000_000_000
STEP = 10_000
N_ROWS = 120
SEL = '{_ws_="demo",_ns_="App-0"}'
NUM_SHARDS = 2

# the query set of tests/test_grid_differential.py, then general-path ones
QUERIES = [
    f'rate(m_diff{SEL}[2m])',
    f'sum(rate(m_diff{SEL}[2m]))',
    f'sum by (g) (increase(m_diff{SEL}[3m]))',
    f'avg_over_time(m_diff{SEL}[2m])',
    f'min by (g) (min_over_time(m_diff{SEL}[2m]))',
    f'max(max_over_time(m_diff{SEL}[90s]))',
    f'quantile(0.5, rate(m_diff{SEL}[2m]))',
    f'stdvar by (g) (rate(m_diff{SEL}[2m]))',
    f'count(m_diff{SEL})',
    f'sum_over_time(m_diff{SEL}[2m]) / count_over_time(m_diff{SEL}[2m])',
    f'topk(2, sum by (g)(rate(m_diff{SEL}[2m])))',
    f'last_over_time(m_diff{SEL}[1m]) * 2 + 1',
    f'sum by (g)(irate(m_diff{SEL}[1m]))',
    f'deriv(m_diff{SEL}[2m])',
]
DOWNSAMPLED = f'rate(m_diff{SEL}[2m])'


@pytest.fixture(scope="module")
def stores():
    jmapper = JShardMapper(NUM_SHARDS)
    jmapper.register_node(range(NUM_SHARDS), "local")
    mapper = ShardMapper(NUM_SHARDS)
    jms = JMemStore()
    ms = TimeSeriesMemStore(device="cpu")
    for s in range(NUM_SHARDS):
        jmapper.update_status(s, JShardStatus.ACTIVE)
        mapper.update_status(s, ShardStatus.ACTIVE)
        jms.setup("prom", J_SCHEMAS, s)
        ms.setup("prom", DEFAULT_SCHEMAS, s)
    rng = np.random.default_rng(9)
    b = RecordBuilder(J_SCHEMAS["gauge"])
    full_ts = BASE + np.arange(N_ROWS, dtype=np.int64) * STEP
    for i in range(16):
        tags = {"__name__": "m_diff", "instance": f"i{i}",
                "g": f"g{i % 3}", "_ws_": "demo", "_ns_": "App-0"}
        vals = np.cumsum(rng.random(N_ROWS)) + i
        if i % 2:                      # half the series are gappy
            keep = rng.random(N_ROWS) > 0.15
            keep[0] = True
            b.add_series(full_ts[keep], [vals[keep]], tags)
        else:
            b.add_series(full_ts, [vals], tags)
    for off, c in enumerate(b.containers()):
        for store, decode, route in (
                (jms, lambda c: jdecode_container(c, J_SCHEMAS), jmapper),
                (ms, lambda c: decode_container(c, DEFAULT_SCHEMAS), mapper)):
            per = {}
            for rec in decode(c):
                sh = route.ingestion_shard(rec.shard_hash, rec.part_hash,
                                           0) % NUM_SHARDS
                per.setdefault(sh, []).append(rec)
            for sh, recs in per.items():
                store.get_shard("prom", sh).ingest(recs, off)
    jplanner = JSingleClusterPlanner("prom", jmapper, JDatasetOptions(),
                                     spread_default=0)
    planner = SingleClusterPlanner("prom", mapper, DatasetOptions(),
                                   spread_default=0)
    return jms, jplanner, ms, planner


def _series(res):
    out = {}
    for batch in res.batches:
        if hasattr(batch, "to_series"):
            for tags, ts, vals in batch.to_series():
                key = tuple(sorted(tags.items()))
                out[key] = (np.asarray(ts), np.asarray(vals, np.float64))
    return out


def _execute(query, ms, planner, parse, ctx_cls, qctx_cls, downsample=None):
    start = BASE + 240_000
    end = BASE + (N_ROWS - 2) * STEP
    ep = planner.materialize(parse(query, start, STEP, end))
    if downsample is not None:
        ep.add_transformer(downsample)
    return ep.execute(ctx_cls(ms, qctx_cls()))


def _run(*args, **kw):
    return _series(_execute(*args, **kw))


def _hits(ms) -> int:
    return sum(c.hits for sh in ms.shards("prom")
               for c in sh.device_caches.values())


def _compare(got, want, query):
    assert got.keys() == want.keys(), query
    assert got, f"query produced no series: {query}"
    for key in want:
        ts_g, v_g = got[key]
        ts_w, v_w = want[key]
        np.testing.assert_array_equal(ts_g, ts_w, err_msg=query)
        np.testing.assert_array_equal(np.isnan(v_g), np.isnan(v_w),
                                      err_msg=f"NaN structure: {query} {key}")
        fin = ~np.isnan(v_w)
        np.testing.assert_allclose(v_g[fin], v_w[fin], rtol=1e-9, atol=1e-12,
                                   err_msg=f"{query} {key}")


@pytest.mark.parametrize("query", QUERIES)
def test_engine_matches_jax(stores, query):
    jms, jplanner, ms, planner = stores
    want = _run(query, jms, jplanner, jquery_range_to_logical_plan,
                JExecContext, JQueryContext)
    got = _run(query, ms, planner, query_range_to_logical_plan,
               ExecContext, QueryContext)
    _compare(got, want, query)


def test_downsampled_query_matches_jax(stores):
    jms, jplanner, ms, planner = stores
    want = _run(DOWNSAMPLED, jms, jplanner, jquery_range_to_logical_plan,
                JExecContext, JQueryContext, JDownsample(pixels=7))
    got = _run(DOWNSAMPLED, ms, planner, query_range_to_logical_plan,
               ExecContext, QueryContext, DownsampleMapper(pixels=7))
    _compare(got, want, DOWNSAMPLED)
    # M4 keeps at most 4 points per pixel bin
    assert all(np.isfinite(v).sum() <= 4 * 7 for _ts, v in got.values())
    assert grid.m4_grid.launches == 0      # the CPU runs the plain version


def test_grid_served_the_grid_queries(stores):
    """The comparison is not vacuous: the port's grid serves the queries
    its kernels cover, and answers None (general path) for irate."""
    _jms, _jp, ms, planner = stores
    for query, served in ((f'sum by (g)(rate(m_diff{SEL}[2m]))', True),
                          (f'avg_over_time(m_diff{SEL}[2m])', True),
                          (f'sum by (g)(irate(m_diff{SEL}[1m]))', False)):
        before = _hits(ms)
        _run(query, ms, planner, query_range_to_logical_plan, ExecContext,
             QueryContext)
        assert (_hits(ms) > before) == served, query


@pytest.mark.parametrize("query", QUERIES)
def test_results_stay_on_the_store_device(stores, query):
    """Grid-served or not, every batch of the answer is a tensor on the
    memstore's device: nothing moves to the host before the API edge."""
    _jms, _jp, ms, planner = stores
    res = _execute(query, ms, planner, query_range_to_logical_plan,
                   ExecContext, QueryContext)
    assert res.batches, query
    for b in res.batches:
        assert isinstance(b.values, torch.Tensor), (query, type(b.values))
        assert b.values.device == ms.device, query


def test_spans_parent_across_the_child_pool(stores):
    """With a reporter installed, a binary join reports one span per plan
    node, both leaves parented (through their dispatch spans) onto the
    join's span across the thread pool that runs them; without one,
    spans report nothing."""
    _jms, _jp, ms, planner = stores
    query = QUERIES[9]              # sum_over_time(...) / count_over_time(...)
    spans = []
    report = spans.append
    TRACER.add_reporter(report)
    try:
        _execute(query, ms, planner, query_range_to_logical_plan,
                 ExecContext, QueryContext)
    finally:
        TRACER.remove_reporter(report)
    plans = [s for s in spans if s.name == "execplan.execute"]
    [root] = [s for s in plans if s.parent_id is None]
    assert root.tags["plan"] == "BinaryJoinExec"
    leaves = [s for s in plans
              if s.tags["plan"] == "MultiSchemaPartitionsExec"]
    assert len(leaves) == 2
    by_id = {s.span_id: s for s in spans}
    for leaf in leaves:
        up = by_id[leaf.parent_id]
        assert up.name == "dispatch.inprocess"
        assert by_id[up.parent_id] is root
    n = len(spans)
    _execute(query, ms, planner, query_range_to_logical_plan, ExecContext,
             QueryContext)
    assert len(spans) == n
