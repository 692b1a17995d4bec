"""The port's paging shard against the JAX package's: the same stream
through both, then eviction, page-in from sqlite, the page cache, its
deferred publish, an undersized cache, re-ingest after eviction, the
scanned-bytes cap and the integrity tripwires.  Every case holds the
same part ids, the same stats and the same samples bit for bit (the
cases of the JAX package's ``TestOnDemandPaging`` and its eviction
invariant tests)."""

import numpy as np
import pytest
import torch

from filodb_tpu.integrity import IntegrityInvariantError as JIntegrityError
from filodb_tpu.memstore.odp import OnDemandPagingShard as JPagingShard
from filodb_tpu.memstore.odp import QueryLimitExceeded as JQueryLimit
from filodb_tpu.memstore.odp import _PagedPartitions as JPaged
from filodb_tpu_torch import native
from filodb_tpu_torch.integrity import IntegrityInvariantError
from filodb_tpu_torch.memstore.odp import (OnDemandPagingShard,
                                           QueryLimitExceeded,
                                           _PagedPartitions)
from tests.torch_durable_data import clear_quarantines  # noqa: F401
from tests.torch_odp_data import (assert_same_batch, assert_same_stats,
                                  feed, filters, gauge_containers, scan_both,
                                  stores)

torch.set_num_threads(1)


def _setup(tmp_path, **cfg):
    (j, jshard), (t, tshard) = stores(tmp_path, **cfg)
    assert isinstance(jshard, JPagingShard)
    assert isinstance(tshard, OnDemandPagingShard)
    containers, truth = gauge_containers()
    feed(containers, jshard, tshard)
    assert tshard.flush_all() == jshard.flush_all() > 0
    return (j, jshard), (t, tshard), truth


def test_setup_builds_paging_shard_only_over_a_disk_store(tmp_path):
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.core.storeconfig import StoreConfig
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import TimeSeriesShard
    (_j, _js), (_t, tshard) = stores(tmp_path)
    assert isinstance(tshard, OnDemandPagingShard)
    plain = TimeSeriesMemStore(device="cpu").setup("prom", DEFAULT_SCHEMAS,
                                                   0, StoreConfig())
    assert type(plain) is TimeSeriesShard
    (_j, _js), (_t, off) = stores(tmp_path, "b",
                                  demand_paging_enabled=False)
    assert type(off) is TimeSeriesShard


def test_evict_then_query_pages_back(tmp_path):
    (_j, jshard), (_t, tshard), truth = _setup(tmp_path)
    assert tshard.evict_partitions(3) == jshard.evict_partitions(3) == 3
    assert tshard.num_partitions == jshard.num_partitions == len(truth) - 3
    assert sorted(tshard.partitions) == sorted(jshard.partitions)
    jgot, tgot = scan_both(jshard, tshard)
    assert len(tgot[0]) == len(truth)        # the index kept evicted ids
    assert_same_batch(jgot, tgot)
    assert tshard.stats.partitions_paged == 3
    assert_same_stats(jshard, tshard)
    by = {t["instance"]: i for i, t in enumerate(tgot[0])}
    for inst, (ts, vals) in truth.items():
        i = by[inst]
        np.testing.assert_array_equal(
            np.asarray(tgot[1].timestamps)[i][:len(ts)], ts)
        np.testing.assert_array_equal(
            np.asarray(tgot[1].values)[i][:len(ts)], vals)


def test_page_cache_reuse(tmp_path):
    (_j, jshard), (_t, tshard), _truth = _setup(tmp_path)
    jshard.evict_partitions(2)
    tshard.evict_partitions(2)
    first = scan_both(jshard, tshard)
    paged = tshard.stats.partitions_paged
    again = scan_both(jshard, tshard)
    assert tshard.stats.partitions_paged == paged == 2   # a cache hit
    assert_same_batch(*first)
    assert_same_batch(*again)
    assert_same_stats(jshard, tshard)


def test_deferred_publish_lands_in_page_cache(tmp_path):
    (_j, jshard), (_t, tshard), truth = _setup(tmp_path)
    jshard.evict_partitions(len(truth))
    tshard.evict_partitions(len(truth))
    assert_same_batch(*scan_both(jshard, tshard))
    # counted with the triggering query, before the publish lands
    assert tshard.stats.partitions_paged == len(truth)
    assert_same_batch(*scan_both(jshard, tshard))
    assert tshard.stats.partitions_paged == len(truth)   # a cache hit
    assert len(tshard.paged) == len(jshard.paged) == len(truth)
    assert_same_stats(jshard, tshard)


@pytest.mark.parametrize("paged_cls", [JPaged, _PagedPartitions],
                         ids=["jax", "port"])
def test_pop_cancels_deferred_publish(paged_cls):
    """A pop() and a gen-guarded put_many are safe in either order."""
    cache = paged_cls(1 << 20)
    g = cache.gen
    cache.pop(1)                 # invalidation after the guard capture
    cache.put_many([(1, "x", 10), (2, "z", 10)], gen_guard=g)
    assert cache.get(1) is None and cache.get(2) == "z"
    cache.put_many([(1, "y", 10)], gen_guard=cache.current_gen())
    assert cache.get(1) == "y"
    cache.pop(3)
    cache.put_many([(3, "w", 10)], gen_guard=cache.current_gen())
    assert cache.get(3) == "w"
    cache.check_invariants()
    cache._bytes += 7                      # accounting drift
    with pytest.raises((IntegrityInvariantError, JIntegrityError)):
        cache.check_invariants()


def test_failed_publish_is_counted(tmp_path, monkeypatch):
    (_j, jshard), (_t, tshard), truth = _setup(tmp_path)
    for shard in (jshard, tshard):
        shard.evict_partitions(len(truth))
        monkeypatch.setattr(
            shard, "_materialize_paged",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    jgot, tgot = scan_both(jshard, tshard)
    assert len(tgot[0]) == len(truth)      # the query itself succeeds
    assert_same_batch(jgot, tgot)
    jshard._join_materialize()
    tshard._join_materialize()
    assert tshard.stats.page_publish_errors == 1
    assert_same_stats(jshard, tshard)


def test_page_cache_bytes_config(tmp_path):
    (_j, jshard), (_t, tshard), _truth = _setup(tmp_path,
                                                page_cache_bytes=7 << 20)
    assert tshard.paged.max_bytes == jshard.paged.max_bytes == 7 << 20
    from filodb_tpu_torch.utils.devicewatch import LEDGER
    pool = LEDGER.pools()[tshard._ledger_owner]
    assert pool == {"bytes": 0, "budget": 7 << 20}
    # a second store over the same (dataset, shard) has a pool of its own
    (_j2, _js2), (_t2, tshard2) = stores(tmp_path, name="b",
                                         page_cache_bytes=5 << 20)
    assert tshard2._ledger_owner != tshard._ledger_owner
    assert LEDGER.pools()[tshard2._ledger_owner]["budget"] == 5 << 20
    tshard.close()
    assert tshard._ledger_owner not in LEDGER.pools()
    assert LEDGER.pools()[tshard2._ledger_owner]["budget"] == 5 << 20


def test_undersized_page_cache_still_scans(tmp_path):
    (_j, jshard), (_t, tshard), truth = _setup(tmp_path, page_cache_bytes=1)
    jshard.evict_partitions(len(truth))
    tshard.evict_partitions(len(truth))
    for _ in range(2):
        jgot, tgot = scan_both(jshard, tshard)
        assert len(tgot[0]) == len(truth)
        assert_same_batch(jgot, tgot)
    jshard._join_materialize()
    tshard._join_materialize()
    assert len(tshard.paged) == len(jshard.paged) <= 1
    assert_same_stats(jshard, tshard)


def test_reingest_after_evict_reuses_part_id(tmp_path):
    from filodb_tpu.core.record import RecordBuilder
    from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
    (_j, jshard), (_t, tshard), truth = _setup(tmp_path)
    before = {p.tags["instance"]: pid for pid, p in tshard.partitions.items()}
    jshard.evict_partitions(len(truth))
    tshard.evict_partitions(len(truth))
    b = RecordBuilder(J_SCHEMAS["gauge"])
    last = int(max(ts[-1] for ts, _ in truth.values()))
    b.add(last + 60_000, [1.5], {"__name__": "heap_usage", "job": "app",
                                 "instance": "i0", "_ws_": "demo",
                                 "_ns_": "ns"})
    feed(b.containers(), jshard, tshard, offset0=10_000)
    assert sorted(tshard.partitions) == sorted(jshard.partitions) \
        == [before["i0"]]
    assert tshard.part_set == jshard.part_set
    # the re-ingested series serves its whole history: the new row from
    # memory, the rest from disk
    assert_same_batch(*scan_both(jshard, tshard))
    assert_same_stats(jshard, tshard)


@pytest.mark.parametrize("cap", [16, 1 << 20])
def test_query_limit_at_the_same_cap(tmp_path, cap):
    (_j, jshard), (_t, tshard), truth = _setup(
        tmp_path, max_data_per_shard_query=cap)
    jf, tf = filters()
    for evict in (0, len(truth)):      # residents, then paged-in
        jshard.evict_partitions(evict)
        tshard.evict_partitions(evict)
        if cap == 16:
            jids = list(jshard.lookup_partitions(jf, 0, 2**62).part_ids)
            tids = list(tshard.lookup_partitions(tf, 0, 2**62).part_ids)
            assert tids == jids
            with pytest.raises(JQueryLimit):
                jshard.scan_batch(jids, 0, 2**62)
            with pytest.raises(QueryLimitExceeded):
                tshard.scan_batch(tids, 0, 2**62)
        else:
            assert_same_batch(*scan_both(jshard, tshard))
    assert_same_stats(jshard, tshard)


def test_query_limit_surfaces_as_query_error(tmp_path):
    """Through the engine both packages fail the query with a QueryError
    that names the cap."""
    from filodb_tpu.coordinator.planner import \
        SingleClusterPlanner as JPlanner
    from filodb_tpu.parallel.shardmap import ShardMapper as JShardMapper
    from filodb_tpu.query.exec import ExecContext as JExecContext
    from filodb_tpu.promql.parser import \
        query_range_to_logical_plan as jplan
    from filodb_tpu.query.model import QueryContext as JQueryContext
    from filodb_tpu.query.model import QueryError as JQueryError
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.parallel.shardmap import ShardMapper
    from filodb_tpu_torch.query.exec import ExecContext
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    from filodb_tpu_torch.query.model import QueryContext, QueryError
    from tests.torch_odp_data import T0
    (j, jshard), (t, tshard), truth = _setup(
        tmp_path, max_data_per_shard_query=16)
    jshard.evict_partitions(len(truth))
    tshard.evict_partitions(len(truth))
    q = "sum(rate(heap_usage[1m]))"
    start, step, end = T0 + 60_000, 30_000, T0 + 1_800_000
    with pytest.raises(JQueryError, match="max-data-per-shard-query"):
        ctx = JQueryContext()
        JPlanner("prom", JShardMapper(1)).materialize(
            jplan(q, start, step, end), ctx).execute(JExecContext(j, ctx))
    with pytest.raises(QueryError, match="max-data-per-shard-query"):
        ctx = QueryContext()
        SingleClusterPlanner("prom", ShardMapper(1)).materialize(
            query_range_to_logical_plan(q, start, step, end), ctx).execute(
            ExecContext(t, ctx))


def test_engine_counts_pages_in(tmp_path):
    """A query that pages partitions in reports them in its stats."""
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.parallel.shardmap import ShardMapper
    from filodb_tpu_torch.query.exec import ExecContext
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    from filodb_tpu_torch.query.model import QueryContext
    from tests.torch_odp_data import T0
    (_j, jshard), (t, tshard), truth = _setup(tmp_path)
    tshard.evict_partitions(len(truth))
    ctx = QueryContext()
    res = SingleClusterPlanner("prom", ShardMapper(1)).materialize(
        query_range_to_logical_plan("heap_usage", T0 + 60_000, 30_000,
                                    T0 + 1_800_000), ctx).execute(
        ExecContext(t, ctx))
    assert res.stats.pages_in == len(truth)
    assert res.stats.chunks_scanned == tshard.stats.chunks_paged > 0


def test_eviction_invariant_failures_fail_the_shard(tmp_path):
    """A page-cache entry resurrected past an eviction, and reclaim
    bookkeeping that drifted, each fail the shard in both packages:
    every later scan and lookup raises instead of serving."""
    (_j, jshard), (_t, tshard), truth = _setup(tmp_path)
    jf, tf = filters()
    for shard, flt, err in ((jshard, jf, JIntegrityError),
                            (tshard, tf, IntegrityInvariantError)):
        shard.evict_partitions(1)
        res = shard.lookup_partitions(flt, 0, 2**62)
        shard.scan_batch(list(res.part_ids) + res.missing_partkeys, 0,
                         2**62)
        shard._join_materialize()
        # stale copies of the live partitions, and a pop that leaves its
        # entry behind: a late publish resurrected what eviction dropped
        for pid in list(shard.partitions):
            shard.paged.put(pid, "stale", 8)
        pop = shard.paged.pop
        shard.paged.pop = lambda key: None if isinstance(key, int) \
            else pop(key)
        with pytest.raises(err, match="resurrected"):
            shard.evict_partitions(1)
        assert "resurrected" in shard.integrity_failed
        with pytest.raises(err):
            shard.scan_batch(list(res.part_ids), 0, 2**62)
        with pytest.raises(err):
            shard.lookup_partitions(flt, 0, 2**62)


def test_eviction_accounting_drift_fails_the_shard(tmp_path):
    (_j, jshard), (_t, tshard), truth = _setup(tmp_path)
    jf, tf = filters()
    for shard, flt, err in ((jshard, jf, JIntegrityError),
                            (tshard, tf, IntegrityInvariantError)):
        shard.evict_partitions(2)
        res = shard.lookup_partitions(flt, 0, 2**62)
        shard.scan_batch(list(res.part_ids) + res.missing_partkeys, 0,
                         2**62)
        shard._join_materialize()
        shard.paged._bytes += 13          # corrupt the bookkeeping
        with pytest.raises(err):
            shard.evict_partitions(1)
        assert shard.integrity_failed is not None
    assert tshard.stats.partitions_evicted == jshard.stats.partitions_evicted


@pytest.mark.parametrize("decoder", ["native", "disabled"])
def test_pages_in_with_and_without_the_batch_decoder(tmp_path, decoder):
    """With the native decoder disabled in both packages, page-in goes
    partition by partition, with the same answers; a decoder that failed
    to build raises instead."""
    from filodb_tpu import native as jnative
    (_j, jshard), (_t, tshard), truth = _setup(tmp_path)
    jshard.evict_partitions(len(truth))
    tshard.evict_partitions(len(truth))
    if decoder == "disabled":
        jnative.disable()
        native.disable()
    try:
        for _ in range(2):
            assert_same_batch(*scan_both(jshard, tshard))
        assert_same_stats(jshard, tshard)
    finally:
        jnative.enable()
        native.enable()


def test_failed_decoder_build_raises(tmp_path, monkeypatch):
    (_j, _js), (_t, tshard), truth = _setup(tmp_path)
    tshard.evict_partitions(len(truth))
    monkeypatch.setattr(native, "_batch_dec", None)
    monkeypatch.setattr(native, "_build_error", "g++: not found")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="did not build"):
        tshard.scan_batch(list(tshard.lookup_partitions(
            filters()[1], 0, 2**62).part_ids), 0, 2**62)
