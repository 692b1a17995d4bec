"""The port's query engine against the JAX package's on the schemas the
port's device grid does not serve: histogram columns (``prom-histogram``,
``prom-hist-max`` with its max-column rewrite) and counters with resets
through the functions the grid lacks.  One shard each, the same
containers; values compared at rtol 1e-9 / atol 1e-12 with NaN
positions equal, histogram planes included."""

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import \
    SingleClusterPlanner as JSingleClusterPlanner
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.memstore.memstore import \
    TimeSeriesMemStore as JMemStore
from filodb_tpu.parallel.shardmap import ShardMapper as JShardMapper
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jparse
from filodb_tpu.query.exec import ExecContext as JExecContext
from filodb_tpu.query.model import QueryContext as JQueryContext
from filodb_tpu_torch.coordinator.planner import \
    SingleClusterPlanner
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.parallel.shardmap import ShardMapper
from filodb_tpu_torch.promql.parser import \
    query_range_to_logical_plan as parse
from filodb_tpu_torch.query.exec import ExecContext
from filodb_tpu_torch.query.model import QueryContext
from tests.data import (START_TS, counter_containers, hist_max_containers,
                        histogram_containers)

STEP = 10_000
START = START_TS + 120_000
END = START_TS + 550_000

QUERIES = [
    'histogram_quantile(0.9, sum(rate(req_latency{_ws_="demo"}[1m])))',
    'histogram_quantile(0.5, rate(req_latency[1m]))',
    'sum(rate(req_latency[2m]))',
    'histogram_bucket(8, req_latency)',
    'hist_to_prom_vectors(increase(req_latency[1m]))',
    'histogram_max_quantile(0.9, lat_hmax)',
    'sum_over_time(lat_hmax[1m])',
    'resets(http_requests_total[2m])',
    'changes(http_requests_total[2m])',
    'sum by (host)(idelta(http_requests_total[1m]))',
    'stddev by (host)(rate(http_requests_total[1m]))',
    'timestamp(http_requests_total[1m])',
]


@pytest.fixture(scope="module")
def stores():
    containers = (histogram_containers(4, 60)
                  + hist_max_containers(3, 60)
                  + counter_containers(6, 60, reset_every=25))
    jms, ms = JMemStore(), TimeSeriesMemStore(device="cpu")
    jms.setup("prom", J_SCHEMAS, 0)
    ms.setup("prom", DEFAULT_SCHEMAS, 0)
    for off, c in enumerate(containers):
        assert jms.get_shard("prom", 0).ingest_container(c, off) == \
            ms.get_shard("prom", 0).ingest_container(c, off)
    return (jms, JSingleClusterPlanner("prom", JShardMapper(1)),
            ms, SingleClusterPlanner("prom", ShardMapper(1)))


def _series(res):
    out = {}
    for b in res.batches:
        vals = b.np_values()
        hist = None if getattr(b, "hist", None) is None \
            else np.asarray(b.hist)[:len(b.keys)]
        for i, tags in enumerate(b.keys):
            out[tuple(sorted(tags.items()))] = (
                vals[i], None if hist is None else hist[i])
    return out


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=1e-12,
                               err_msg=what)


@pytest.mark.parametrize("query", QUERIES)
def test_engine_matches_jax(stores, query):
    jms, jplanner, ms, planner = stores
    want = _series(jplanner.materialize(jparse(query, START, STEP, END))
                   .execute(JExecContext(jms, JQueryContext())))
    got = _series(planner.materialize(parse(query, START, STEP, END))
                  .execute(ExecContext(ms, QueryContext())))
    assert got.keys() == want.keys(), query
    assert want, query
    for key, (w_vals, w_hist) in want.items():
        g_vals, g_hist = got[key]
        _close(g_vals, w_vals, f"{query} {key}")
        assert (g_hist is None) == (w_hist is None), query
        if w_hist is not None:
            _close(g_hist, w_hist, f"{query} {key} hist")
