"""Query deadlines (``filodb_tpu_torch/workload/deadline.py`` and the
engine's tripwire) and the two leftovers of the shard's data plane:
``mark_stopped_series`` and the per-query residency delta
(``QueryStats.hbm_resident_delta_bytes``), each against the JAX package.

The deadline helpers mirror the JAX package's tests that need no HTTP
(``tests/test_workload.py`` TestDeadline): ``mint``, ``remaining_ms``,
``check``, ``budget_timeout_s``, and an expired plan refusing to run.
Through the engine, an expired query raises ``DeadlineExceeded`` in both
packages at the same plan node; a live deadline changes no answer.

The stores: ``tests/torch_slice_data.py``'s uniform-phase counters, the
same container bytes in both packages, on one shard (the engine's
single-leaf plans) or the same rows on each of two shards (a reduce over
two leaves, whose residency deltas the root folds together).
"""

import gc
import re
import time

import jax
import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import \
    SingleClusterPlanner as JSingleClusterPlanner
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.parallel.shardmap import ShardMapper as JShardMapper
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jquery_range_to_logical_plan
from filodb_tpu.query.exec import ExecContext as JExecContext
from filodb_tpu.query.model import QueryContext as JQueryContext
from filodb_tpu.utils.devicewatch import LEDGER as JLEDGER
from filodb_tpu.workload import deadline as jwdl
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.parallel.shardmap import ShardMapper
from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
from filodb_tpu_torch.query.exec import ExecContext
from filodb_tpu_torch.query.model import QueryContext, QueryError, QueryStats
from filodb_tpu_torch.utils.devicewatch import LEDGER
from filodb_tpu_torch.workload import deadline as wdl
from tests.torch_slice_data import K, N_ROWS, STEP, T0, containers

torch.set_num_threads(1)

START = T0 + (K + 1) * STEP
END = T0 + (N_ROWS - 10) * STEP
QUERIES = ("sum(rate(m[5m]))", "rate(m[5m])",
           "sum by (instance)(sum_over_time(m[5m])) * 2",
           "max_over_time(m[5m]) + rate(m[5m])")

_OPEN: list = []


@pytest.fixture(autouse=True)
def _closed_stores():
    yield
    for ms in _OPEN:
        ms.reset()
    _OPEN.clear()
    gc.collect()


def _memstores(nshards: int = 1):
    """Both packages' memstores, the uniform slice containers ingested
    into each of ``nshards`` shards and flushed."""
    jms, tms = JMemStore(), TimeSeriesMemStore(device="cpu")
    _OPEN.extend((jms, tms))
    for s in range(nshards):
        jshard = jms.setup("prom", J_SCHEMAS, s)
        tshard = tms.setup("prom", DEFAULT_SCHEMAS, s)
        for off, c in enumerate(containers("uniform")):
            jshard.ingest_container(c, off)
            tshard.ingest_container(c, off)
        jshard.flush_all()
        tshard.flush_all()
    return jms, tms


def _run(query, ms, qctx, nshards=1):
    ep = SingleClusterPlanner("prom", ShardMapper(nshards)).materialize(
        query_range_to_logical_plan(query, START, STEP, END), qctx)
    return ep.execute(ExecContext(ms, qctx))


def _jrun(query, ms, qctx, nshards=1):
    ep = JSingleClusterPlanner("prom", JShardMapper(nshards)).materialize(
        jquery_range_to_logical_plan(query, START, STEP, END), qctx)
    with jax.disable_jit():
        return ep.execute(JExecContext(ms, qctx))


def _expired(cls, ms=-5):
    q = cls(timeout_ms=1_000)
    q.deadline_ms = int(time.time() * 1000) + ms
    return q


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_mint_and_remaining(pkg):
    dl, cls = (wdl, QueryContext) if pkg == "port" else (jwdl,
                                                         JQueryContext)
    q = cls(submit_time_ms=int(time.time() * 1000), timeout_ms=5_000)
    assert dl.mint(q) is q
    rem = dl.remaining_ms(q)
    assert 0 < rem <= 5_000
    assert not dl.expired(q)
    deadline = q.deadline_ms
    dl.mint(q)                               # minted once
    assert q.deadline_ms == deadline
    assert dl.remaining_ms(cls()) is None
    assert not dl.expired(cls())


def test_mint_matches_jax_at_the_same_clock():
    now = 1_700_000_000_000
    for submit in (0, now - 250):
        q, jq = (QueryContext(submit_time_ms=submit, timeout_ms=7_000),
                 JQueryContext(submit_time_ms=submit, timeout_ms=7_000))
        wdl.mint(q, now_ms=now)
        jwdl.mint(jq, now_ms=now)
        assert q.deadline_ms == jq.deadline_ms
        for at in (now, now + 6_999, now + 7_000, now + 9_000):
            assert wdl.remaining_ms(q, at) == jwdl.remaining_ms(jq, at)
            assert wdl.expired(q, at) == jwdl.expired(jq, at)


def test_query_context_defaults_match_jax():
    q, jq = QueryContext(), JQueryContext()
    for name in ("submit_time_ms", "timeout_ms", "deadline_ms",
                 "admission_permit", "batch_key"):
        assert getattr(q, name) == getattr(jq, name), name


def test_budget_caps_timeout():
    q = QueryContext()
    q.deadline_ms = int(time.time() * 1000) + 200
    assert wdl.budget_timeout_s(q, 60.0) <= 0.2
    assert wdl.budget_timeout_s(QueryContext(), 60.0) == 60.0
    # expired: the fail-fast floor, not a timeout of 0 (none)
    assert 0 < wdl.budget_timeout_s(_expired(QueryContext, -50), 60.0) \
        <= 0.01


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_check_raises_when_expired(pkg):
    dl, cls = (wdl, QueryContext) if pkg == "port" else (jwdl,
                                                         JQueryContext)
    with pytest.raises(dl.DeadlineExceeded, match="at here"):
        dl.check(_expired(cls), where="here")
    q = cls()
    q.deadline_ms = int(time.time() * 1000) + 10_000
    dl.check(q)                              # plenty left: no raise
    dl.check(cls())                          # no deadline: no raise
    assert issubclass(wdl.DeadlineExceeded, QueryError)


# ---------------------------------------------------------------------------
# the engine's tripwire
# ---------------------------------------------------------------------------


def test_expired_plan_refuses_to_execute():
    from filodb_tpu_torch.query.exec import ScalarFixedDoubleExec
    qctx = _expired(QueryContext)
    plan = ScalarFixedDoubleExec(1.0, START, STEP, END, query_context=qctx)
    with pytest.raises(QueryError, match="deadline"):
        plan.execute(ExecContext(TimeSeriesMemStore(device="cpu"), qctx))


@pytest.mark.parametrize("query", QUERIES)
def test_expired_query_raises_at_the_same_plan_node(query):
    jms, tms = _memstores()
    with pytest.raises(wdl.DeadlineExceeded) as got:
        _run(query, tms, _expired(QueryContext))
    with pytest.raises(jwdl.DeadlineExceeded) as want:
        _jrun(query, jms, _expired(JQueryContext))
    at = re.compile(r" at (\w+)\)")
    assert at.search(str(got.value)).group(1) == \
        at.search(str(want.value)).group(1)


@pytest.mark.parametrize("query", QUERIES[:2])
def test_live_deadline_changes_no_answer(query):
    _jms, tms = _memstores()
    plain = _run(query, tms, QueryContext())
    q = wdl.mint(QueryContext(timeout_ms=60_000))
    timed = _run(query, tms, q)
    for a, b in zip(plain.batches, timed.batches):
        assert a.np_values().tobytes() == b.np_values().tobytes()


# ---------------------------------------------------------------------------
# mark_stopped_series
# ---------------------------------------------------------------------------


def test_mark_stopped_series_matches_jax():
    jms, tms = _memstores()
    jshard, tshard = jms.get_shard("prom", 0), tms.get_shard("prom", 0)
    last = T0 + N_ROWS * STEP
    # nothing is stale yet
    assert tshard.mark_stopped_series(last, 10 * STEP) == \
        jshard.mark_stopped_series(last, 10 * STEP) == 0
    n = tshard.mark_stopped_series(last + 10**9, 1000)
    assert n == jshard.mark_stopped_series(last + 10**9, 1000) == 8
    # marked once: a second pass marks nothing
    assert tshard.mark_stopped_series(last + 10**9, 1000) == \
        jshard.mark_stopped_series(last + 10**9, 1000) == 0
    # excluded from queries starting after their end, kept before it
    for start, want in ((last + 10**8, 0), (T0, 8)):
        got = tshard.index.part_ids_from_filters([], start_time=start)
        jgot = jshard.index.part_ids_from_filters([], start_time=start)
        assert len(got) == len(jgot) == want
        np.testing.assert_array_equal(got, jgot)
    for pid, part in tshard.partitions.items():
        assert tshard.index.end_time(pid) == part.latest_timestamp == \
            jshard.index.end_time(pid)


# ---------------------------------------------------------------------------
# the per-query residency delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nshards", [1, 2])
def test_residency_delta_cold_then_warm(nshards):
    """A cold grid query's delta is positive and equals the bytes the
    ledger tracked while it ran (over two shards, both leaves' blocks,
    folded into the root's stats); its warm repeat's is 0.  The JAX
    package agrees in sign."""
    jms, tms = _memstores(nshards)
    query = "sum(rate(m[5m]))"
    before = LEDGER.total_bytes()
    cold = _run(query, tms, QueryContext(), nshards)
    tracked = LEDGER.total_bytes() - before
    assert tracked > 0
    assert cold.stats.hbm_resident_delta_bytes == tracked
    caches = [c for s in range(nshards)
              for c in tms.get_shard("prom", s).device_caches.values()]
    assert len(caches) == nshards and all(c.blocks for c in caches)
    warm = _run(query, tms, QueryContext(), nshards)
    assert warm.stats.hbm_resident_delta_bytes == 0
    np.testing.assert_array_equal(cold.batches[0].np_values(),
                                  warm.batches[0].np_values())
    jbefore = JLEDGER.total_bytes() if hasattr(JLEDGER, "total_bytes") \
        else None
    jcold = _jrun(query, jms, JQueryContext(), nshards)
    jwarm = _jrun(query, jms, JQueryContext(), nshards)
    assert jcold.stats.hbm_resident_delta_bytes > 0
    assert jwarm.stats.hbm_resident_delta_bytes == 0
    if jbefore is not None:
        assert jcold.stats.hbm_resident_delta_bytes == \
            JLEDGER.total_bytes() - jbefore


def test_residency_delta_debits_frees_and_merges():
    """Frees while a query runs debit it; QueryStats.merge adds deltas
    up."""
    _jms, tms = _memstores()
    shard = tms.get_shard("prom", 0)
    _run("sum(rate(m[5m]))", tms, QueryContext())
    cache = next(iter(shard.device_caches.values()))
    resident = LEDGER.total_bytes(cache.owner)
    assert resident > 0
    # the cache over a budget of one byte: the next query's reclaim frees
    # every block it does not cover, and its own blocks stay
    from filodb_tpu_torch.query.exec import _ACTIVE
    ctx = ExecContext(tms, QueryContext())
    _ACTIVE.ctx = ctx
    try:
        cache.ensure_headroom(1.0)
        gc.collect()
    finally:
        _ACTIVE.ctx = None
    stats = QueryStats()
    ctx.fold_into(stats)
    freed = resident - LEDGER.total_bytes(cache.owner)
    assert freed > 0
    assert stats.hbm_resident_delta_bytes == -freed
    a, b = QueryStats(hbm_resident_delta_bytes=5), QueryStats(
        hbm_resident_delta_bytes=-2)
    a.merge(b)
    assert a.hbm_resident_delta_bytes == 3
