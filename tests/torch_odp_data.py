"""Stores shared by the paging and eviction tests
(``tests/test_torch_{odp,odp_grid,evict}.py``): the same containers,
built once with the JAX package's ``RecordBuilder``, driven into a
``filodb_tpu`` memstore and a ``filodb_tpu_torch`` memstore
(``device="cpu"``), each over sqlite files of its own, with the same
``StoreConfig``."""

import numpy as np

from filodb_tpu.core.filters import ColumnFilter as JColumnFilter
from filodb_tpu.core.filters import Equals as JEquals
from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.storeconfig import StoreConfig as JStoreConfig
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.store.persistence import DiskColumnStore as JDiskColumnStore
from filodb_tpu.store.persistence import DiskMetaStore as JDiskMetaStore
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.store.persistence import DiskColumnStore, DiskMetaStore
from tests.torch_durable_data import opened

T0 = 1_700_000_000_000
STEP = 10_000


def gauge_containers(metric: str = "heap_usage", n_series: int = 5,
                     n_rows: int = 250, seed: int = 1, jitter: bool = True,
                     container_size: int = 1 << 20, cuts=()):
    """Gauge series of ``n_rows`` rows (a jittered scrape interval, or
    exactly ``STEP``), as containers, with the truth ``{instance: (ts,
    vals)}``.  With ``cuts`` (row indices), the containers come as one
    list a span of rows, every series in each: a time-major stream."""
    rng = np.random.default_rng(seed)
    truth, tags = {}, []
    for s in range(n_series):
        tags.append({"__name__": metric, "job": "app", "instance": f"i{s}",
                     "_ws_": "demo", "_ns_": "ns"})
        if jitter:
            ts = T0 + np.cumsum(rng.integers(9_000, 11_000, n_rows))
        else:
            ts = T0 + np.arange(n_rows, dtype=np.int64) * STEP
        truth[f"i{s}"] = (ts.astype(np.int64), np.cumsum(rng.random(n_rows)))
    spans = []
    for lo, hi in zip((0, *cuts), (*cuts, n_rows)):
        b = RecordBuilder(J_SCHEMAS["gauge"], container_size=container_size)
        for s in range(n_series):
            ts, vals = truth[f"i{s}"]
            b.add_series(ts[lo:hi], [vals[lo:hi]], tags[s])
        spans.append(b.containers())
    return (spans if cuts else spans[0]), truth


def stores(tmp_path, name: str = "a", **cfg):
    """((JAX memstore, shard), (port memstore, shard)) over sqlite files
    of their own, both with ``StoreConfig(groups_per_shard=2, **cfg)``."""
    j = JMemStore(JDiskColumnStore(str(tmp_path / f"j{name}.db")),
                  JDiskMetaStore(str(tmp_path / f"j{name}m.db")))
    jshard = j.setup("prom", J_SCHEMAS, 0,
                     JStoreConfig(groups_per_shard=2, **cfg))
    t = TimeSeriesMemStore(DiskColumnStore(str(tmp_path / f"t{name}.db")),
                           DiskMetaStore(str(tmp_path / f"t{name}m.db")),
                           device="cpu")
    tshard = t.setup("prom", DEFAULT_SCHEMAS, 0,
                     StoreConfig(groups_per_shard=2, **cfg))
    opened(j, t)
    return (j, jshard), (t, tshard)


def feed(containers, *shards, offset0: int = 0) -> None:
    for shard in shards:
        for off, c in enumerate(containers):
            shard.ingest_container(c, offset0 + off)


def filters(metric: str = "heap_usage"):
    """(JAX filters, port filters) selecting ``metric``."""
    return ([JColumnFilter("_metric_", JEquals(metric))],
            [ColumnFilter("_metric_", Equals(metric))])


def scan_both(jshard, tshard, metric: str = "heap_usage",
              start: int = 0, end: int = 2**62):
    """Lookup and ``scan_batch`` through both shards; asserts the same
    part ids, and returns ((JAX tags, batch), (port tags, batch))."""
    jf, tf = filters(metric)
    jres = jshard.lookup_partitions(jf, start, end)
    tres = tshard.lookup_partitions(tf, start, end)
    assert list(tres.part_ids) == list(jres.part_ids)
    assert len(tres.missing_partkeys) == len(jres.missing_partkeys)
    jids = list(jres.part_ids) + jres.missing_partkeys
    tids = list(tres.part_ids) + tres.missing_partkeys
    return (jshard.scan_batch(jids, start, end),
            tshard.scan_batch(tids, start, end))


def assert_same_batch(jgot, tgot) -> None:
    """The same series in the same order, the same samples bit for
    bit."""
    jtags, jb = jgot
    ttags, tb = tgot
    assert ttags == jtags
    if jb is None:
        assert tb is None
        return
    n = len(jtags)
    jc = np.asarray(jb.row_counts)[:n]
    tc = np.asarray(tb.row_counts)[:n]
    np.testing.assert_array_equal(tc, jc)
    jts, tts = np.asarray(jb.timestamps), np.asarray(tb.timestamps)
    jv, tv = np.asarray(jb.values), np.asarray(tb.values)
    for i in range(n):
        np.testing.assert_array_equal(tts[i, :tc[i]], jts[i, :jc[i]])
        np.testing.assert_array_equal(
            tv[i, :tc[i]].view(np.int64), jv[i, :jc[i]].view(np.int64))


PAGING_STATS = ("partitions_paged", "chunks_paged", "partitions_evicted",
                "page_publish_errors", "page_decode_corrupt",
                "chunks_flushed", "flushes_done")


def assert_same_stats(jshard, tshard, names=PAGING_STATS) -> None:
    for name in names:
        assert getattr(tshard.stats, name) == getattr(jshard.stats, name), \
            name
