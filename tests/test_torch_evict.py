"""Eviction, purge, cardinality tracking and series quotas, port against
the JAX package: the same stream into both packages' base shards (an
in-memory store) and paging shards (sqlite), then the same
``evict_partitions`` / ``purge_expired`` calls
must leave the same partitions, index entries, stats, bloom-filter
members, churn counts and quota occupancy (the JAX package's
test_memstore.py eviction cases as models)."""

import numpy as np
import pytest
import torch

from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.storeconfig import StoreConfig as JStoreConfig
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.workload.quota import SeriesQuota as JSeriesQuota
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.cardinality import Ewma
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.utils.bloom import BloomFilter
from filodb_tpu_torch.utils.observability import index_metrics
from filodb_tpu_torch.workload.quota import SeriesQuota, SeriesQuotaExceeded
from tests.torch_durable_data import clear_quarantines  # noqa: F401
from tests.torch_durable_data import opened
from tests.torch_odp_data import (T0, assert_same_batch, feed,
                                  gauge_containers, scan_both, stores)

torch.set_num_threads(1)

EVICT_STATS = ("partitions_created", "partitions_evicted",
               "partitions_purged", "rows_ingested", "series_quota_rejected",
               "rows_quota_dropped")


def _shards(tmp_path, kind: str, **cfg):
    if kind == "base":
        j, t = opened(JMemStore(), TimeSeriesMemStore(device="cpu"))
        return (j.setup("prom", J_SCHEMAS, 0,
                        JStoreConfig(groups_per_shard=2, **cfg)),
                t.setup("prom", DEFAULT_SCHEMAS, 0,
                        StoreConfig(groups_per_shard=2, **cfg)))
    (_j, jshard), (_t, tshard) = stores(tmp_path, **cfg)
    return jshard, tshard


def _assert_same(jshard, tshard) -> None:
    for name in EVICT_STATS:
        assert getattr(tshard.stats, name) == getattr(jshard.stats, name), \
            name
    assert sorted(tshard.partitions) == sorted(jshard.partitions)
    assert tshard.part_set == jshard.part_set
    assert len(tshard.index) == len(jshard.index)
    assert tshard.index.active_series_count() == \
        jshard.index.active_series_count()
    assert tshard.index.label_names() == jshard.index.label_names()
    assert tshard.index.value_counts("instance") == \
        jshard.index.value_counts("instance")
    for attr in ("created_total", "removed_total"):
        assert getattr(tshard.cardinality, attr) == \
            getattr(jshard.cardinality, attr), attr


@pytest.mark.parametrize("kind", ["base", "paging"])
def test_evict_longest_stopped_first(tmp_path, kind):
    jshard, tshard = _shards(tmp_path, kind)
    containers, _truth = gauge_containers(n_series=6, n_rows=20)
    feed(containers, jshard, tshard)
    jshard.flush_all()
    tshard.flush_all()
    pks = [tshard.index.partkey(0), tshard.index.partkey(1)]
    for shard in (jshard, tshard):
        shard.index.update_end_time(0, 100)
        shard.index.update_end_time(1, 200)
    assert tshard.index.part_ids_ordered_by_end_time(3) == \
        jshard.index.part_ids_ordered_by_end_time(3)
    assert tshard.evict_partitions(2) == jshard.evict_partitions(2) == 2
    assert tshard.num_partitions == 4 and 0 not in tshard.partitions
    assert all(pk in tshard.evicted_keys for pk in pks)
    assert [pk in tshard.evicted_keys for pk in tshard.part_set] == \
        [pk in jshard.evicted_keys for pk in jshard.part_set]
    _assert_same(jshard, tshard)
    if kind == "paging":
        # evicted ids stay indexed and page back with their history
        assert_same_batch(*scan_both(jshard, tshard))
        assert tshard.stats.partitions_paged == 2


@pytest.mark.parametrize("kind", ["base", "paging"])
def test_evict_more_than_stopped_takes_least_recent(tmp_path, kind):
    jshard, tshard = _shards(tmp_path, kind)
    containers, _truth = gauge_containers(n_series=5, n_rows=30)
    feed(containers, jshard, tshard)
    jshard.flush_all()
    tshard.flush_all()
    for shard in (jshard, tshard):
        shard.index.update_end_time(2, 100)
    assert tshard.evict_partitions(3) == jshard.evict_partitions(3)
    _assert_same(jshard, tshard)
    # and again: already-evicted ids must not count against the quota
    assert tshard.evict_partitions(2) == jshard.evict_partitions(2)
    _assert_same(jshard, tshard)


@pytest.mark.parametrize("kind", ["base", "paging"])
def test_purge_expired_and_stopped_series(tmp_path, kind):
    jshard, tshard = _shards(tmp_path, kind)
    containers, truth = gauge_containers(n_series=4, n_rows=10)
    feed(containers, jshard, tshard)
    last = int(max(ts[-1] for ts, _ in truth.values()))
    for shard in (jshard, tshard):
        for pid, part in shard.partitions.items():
            shard.index.update_end_time(pid, part.latest_timestamp)
    assert list(tshard.index.part_ids_from_filters([], last + 1)) == \
        list(jshard.index.part_ids_from_filters([], last + 1)) == []
    assert tshard.purge_expired(10**9, last) == \
        jshard.purge_expired(10**9, last) == 0
    assert tshard.purge_expired(1000, last + 10**6) == \
        jshard.purge_expired(1000, last + 10**6) == 4
    assert tshard.num_partitions == 0
    _assert_same(jshard, tshard)
    assert tshard.cardinality.removed_total == 4


def test_cardinality_gauges_and_churn(tmp_path):
    jshard, tshard = _shards(tmp_path, "base")
    m = index_metrics()
    labels = {"dataset": "prom", "shard": 0}
    created0 = m["created"].value(**labels)
    removed0 = m["removed"].value(reason="evict", **labels)
    containers, _truth = gauge_containers(n_series=7, n_rows=5)
    feed(containers, jshard, tshard)
    assert m["active_series"].value(**labels) == 7
    assert m["labels"].value(**labels) == len(tshard.index.label_names())
    assert m["created"].value(**labels) - created0 == 7
    for shard in (jshard, tshard):
        for pid in (1, 3, 5):
            shard.index.update_end_time(pid, 1000 + pid)
    assert tshard.evict_partitions(3) == jshard.evict_partitions(3) == 3
    assert m["active_series"].value(**labels) == 4
    assert m["removed"].value(reason="evict", **labels) - removed0 == 3
    assert tshard.cardinality.create_ewma.rate() > 0
    assert tshard.cardinality.remove_ewma.rate() > 0
    _assert_same(jshard, tshard)
    tshard.close()
    assert m["active_series"].value(**labels) == 0.0


def test_ewma_converges_to_a_steady_rate():
    import time
    e = Ewma(halflife_s=10.0)
    t0 = time.monotonic()
    for i in range(2000):
        e.note(5.0, now=t0 + i * 0.1)    # 50 events a second
    at200 = e.rate(now=t0 + 200.0)
    assert abs(at200 - 50.0) < 1.0
    # one half-life later, with no events, half the rate
    assert e.rate(now=t0 + 210.0) == pytest.approx(at200 / 2, rel=1e-6)


@pytest.mark.parametrize("kind", ["base", "paging"])
def test_series_quota_rejects_new_series(tmp_path, kind):
    jshard, tshard = _shards(tmp_path, kind)
    jshard.series_quota = JSeriesQuota("prom", default_limit=3)
    tshard.series_quota = SeriesQuota("prom", default_limit=3)
    containers, _truth = gauge_containers(n_series=5, n_rows=8)
    feed(containers, jshard, tshard)
    assert tshard.num_partitions == 3
    assert tshard.stats.series_quota_rejected == 2
    assert tshard.stats.rows_quota_dropped == 16
    assert tshard.series_quota.snapshot() == jshard.series_quota.snapshot()
    _assert_same(jshard, tshard)
    # existing series keep ingesting; an eviction frees quota
    more, _ = gauge_containers(n_series=5, n_rows=8, seed=2)
    feed(more, jshard, tshard, offset0=100)
    assert tshard.num_partitions == 3
    tshard.flush_all()
    jshard.flush_all()
    assert tshard.evict_partitions(1) == jshard.evict_partitions(1)
    assert tshard.series_quota.snapshot() == jshard.series_quota.snapshot()
    _assert_same(jshard, tshard)


def test_series_quota_per_record_path_and_refresh():
    """The per-record ingest path drops over-quota rows too, and a
    quota rebuilt from the index counts what the shard holds."""
    from filodb_tpu_torch.core.record import decode_container
    q = SeriesQuota("prom", default_limit=2, overrides={"other": 5})
    t = TimeSeriesMemStore(device="cpu")
    shard = t.setup("prom", DEFAULT_SCHEMAS, 0, StoreConfig())
    shard.series_quota = q
    containers, _truth = gauge_containers(n_series=4, n_rows=3)
    for off, c in enumerate(containers):
        shard.ingest(decode_container(c, DEFAULT_SCHEMAS), off)
    assert shard.num_partitions == 2
    assert shard.stats.rows_quota_dropped == 6
    assert q.over_limit({"_ns_": "ns"}) and not q.over_limit({"_ns_": "o"})
    with pytest.raises(SeriesQuotaExceeded):
        shard._get_or_add_partition_pk(b"new", DEFAULT_SCHEMAS["gauge"], 0,
                                       T0, tags={"_ns_": "ns"})
    q2 = SeriesQuota("prom", default_limit=2)
    q2.refresh_from_index(shard.index)
    assert q2.snapshot()["active"] == {"ns": 2}


def test_bloom_filter_members_against_jax():
    from filodb_tpu.utils.bloom import BloomFilter as JBloomFilter
    t, j = BloomFilter(1000), JBloomFilter(1000)
    keys = [f"k{i}".encode() for i in range(300)]
    for k in keys[:150]:
        t.add(k)
        j.add(k)
    assert all(k in t for k in keys[:150])
    assert [k in t for k in keys] == [k in j for k in keys]
    assert np.array_equal(t._bits, j._bits) and t.count == j.count == 150


def test_reingest_of_a_purged_series_gets_a_new_part_id(tmp_path):
    jshard, tshard = _shards(tmp_path, "base")
    containers, truth = gauge_containers(n_series=2, n_rows=4)
    feed(containers, jshard, tshard)
    last = int(max(ts[-1] for ts, _ in truth.values()))
    assert tshard.purge_expired(1, last + 10) == \
        jshard.purge_expired(1, last + 10) == 2
    b = RecordBuilder(J_SCHEMAS["gauge"])
    b.add(last + 60_000, [1.0], {"__name__": "heap_usage", "job": "app",
                                 "instance": "i0", "_ws_": "demo",
                                 "_ns_": "ns"})
    feed(b.containers(), jshard, tshard, offset0=50)
    assert sorted(tshard.partitions) == sorted(jshard.partitions) == [2]
    _assert_same(jshard, tshard)
