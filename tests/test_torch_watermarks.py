"""The port's ingest watermarks (``memstore/watermarks.py``) and traced
partition against the JAX package's, over the same ingest and flush
sequence:

- the ledger's rows (ingested, flushed, group and checkpoint watermarks,
  lag in rows) and its gauges; stall episodes (open, the level gauge,
  re-arm on progress); ``unwatch`` and ``close`` removing rows;
  ``TierWatermarks``; the sampler thread stopping cleanly;
- a ``trace_filters`` store's ``filodb.trace`` log lines, on the
  per-record ``ingest`` path and on the columnar ``ingest_block`` one,
  with the chunk freezes of a flush; nothing for any other series."""

import logging
import time

import numpy as np
import pytest
import torch

from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.record import decode_container as jdecode_container
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.storeconfig import StoreConfig as JStoreConfig
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.memstore.watermarks import TierWatermarks as JTier
from filodb_tpu.memstore.watermarks import WatermarkLedger as JLedger
from filodb_tpu.utils.observability import \
    watermark_metrics as jwatermark_metrics
from filodb_tpu_torch.core.record import decode_container
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.memstore.partition import TracingTimeSeriesPartition
from filodb_tpu_torch.memstore.watermarks import (TierWatermarks,
                                                  WatermarkLedger,
                                                  WatermarkSampler)
from filodb_tpu_torch.utils.devicewatch import FLIGHT
from filodb_tpu_torch.utils.observability import watermark_metrics

torch.set_num_threads(1)

BASE = 1_700_000_000_000
STEP = 10_000


def _containers(n_series=6, n_rows=90):
    """Three container sets of 30 rows each."""
    rng = np.random.default_rng(1)
    sets = [RecordBuilder(J_SCHEMAS["prom-counter"]) for _ in range(3)]
    for s in range(n_series):
        tags = {"__name__": "req_total", "pod": f"pod-{s % 2}",
                "instance": f"i{s}", "_ws_": "w", "_ns_": "n"}
        ts = BASE + np.arange(n_rows, dtype=np.int64) * STEP + 1 + s
        v = np.cumsum(rng.integers(0, 10, n_rows)).astype(np.float64)
        for i, b in enumerate(sets):
            b.add_series(ts[30 * i:30 * (i + 1)], [v[30 * i:30 * (i + 1)]],
                         tags)
    return [b.containers() for b in sets]


def _stores(jconfig=None, config=None):
    jms = JMemStore()
    jms.setup("prom", J_SCHEMAS, 0, jconfig)
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup("prom", DEFAULT_SCHEMAS, 0, config)
    return jms, ms


def _comparable(tree: dict) -> dict:
    """A sampled tree without its clocks (sample time, lag seconds)."""
    out = {}
    for ds, d in tree["datasets"].items():
        rows = []
        for r in d["shards"]:
            r = dict(r)
            r["lag"] = {"rows": r["lag"]["rows"]}
            r.pop("flush", None)
            rows.append(r)
        out[ds] = {"shards": rows, "totals": d["totals"]}
    return out


def _gauges(metrics, dataset, node=""):
    labels = {"dataset": dataset, "shard": 0, "node": node}
    return ([metrics["offset"].value(stage=s, **labels)
             for s in ("broker_end", "ingested", "flushed", "checkpoint")],
            metrics["lag_rows"].value(**labels),
            metrics["stalled"].value(**labels),
            metrics["stalls"].value(**labels))


def test_ledger_rows_and_gauges_match_jax():
    sets = _containers()
    jms, ms = _stores()
    head = {"off": 0}
    jl = JLedger(stall_window_s=0.0, node="n-wm")
    tl = WatermarkLedger(stall_window_s=0.0, node="n-wm")
    for led, store in ((jl, jms), (tl, ms)):
        led.watch("prom", store, end_offset_fn=lambda _s: head["off"])
    trees = []
    off = 0
    for i, conts in enumerate(sets):
        head["off"] = off + len(conts) + 5          # the broker is ahead
        for c in conts:
            jms.ingest("prom", 0, c, off)
            ms.ingest("prom", 0, c, off)
            off += 1
        if i == 1:
            jms.get_shard("prom", 0).flush_all(ingestion_time=1000)
            ms.get_shard("prom", 0).flush_all(ingestion_time=1000)
            flushed_at = off - 1
        trees.append((jl.sample(), tl.sample()))
        # unchanged offsets with lag: a stall opens (window 0 s) ...
        trees.append((jl.sample(), tl.sample()))
        assert _gauges(watermark_metrics(), "prom", "n-wm") == \
            _gauges(jwatermark_metrics(), "prom", "n-wm")
    for jt, tt in trees:
        assert _comparable(tt) == _comparable(jt)
    row = trees[-1][1]["datasets"]["prom"]["shards"][0]
    assert row["stalled"] and row["lag"]["rows"] == 5
    wm = row["watermarks"]
    assert wm["checkpoint"] == wm["flushed"] == flushed_at < wm["ingested"]
    # ... once an episode: three opened, each re-armed by progress
    assert watermark_metrics()["stalls"].value(
        dataset="prom", shard=0, node="n-wm") == 3
    assert len([e for e in FLIGHT.events(kind="ingest.stall")
                if e["node"] == "n-wm"]) >= 3
    # caught up: lag 0, the level clears
    head["off"] = off
    jt, tt = jl.sample(), tl.sample()
    assert _comparable(tt) == _comparable(jt)
    assert not tt["datasets"]["prom"]["shards"][0]["stalled"]
    assert watermark_metrics()["stalled"].value(
        dataset="prom", shard=0, node="n-wm") == 0.0
    # unwatch and close drop the rows
    tl.unwatch("prom")
    jl.unwatch("prom")
    assert _gauges(watermark_metrics(), "prom", "n-wm")[:3] == \
        ([0.0] * 4, 0.0, 0.0)
    tl.watch("prom", ms)
    tl.sample()
    assert watermark_metrics()["offset"].value(
        stage="ingested", dataset="prom", shard=0, node="n-wm") == off - 1
    tl.close()
    assert tl.watching() == []
    assert watermark_metrics()["offset"].value(
        stage="ingested", dataset="prom", shard=0, node="n-wm") == 0.0


def test_flushed_and_checkpoint_watermarks_after_every_group_flushes():
    sets = _containers()
    jms, ms = _stores(JStoreConfig(groups_per_shard=4),
                      StoreConfig(groups_per_shard=4))
    off = 0
    for conts in sets[:2]:
        for c in conts:
            jms.ingest("prom", 0, c, off)
            ms.ingest("prom", 0, c, off)
            off += 1
    for store in (jms, ms):
        store.get_shard("prom", 0).flush_all(ingestion_time=1000)
    jl, tl = JLedger(node="n-cp"), WatermarkLedger(node="n-cp")
    jl.watch("prom", jms)
    tl.watch("prom", ms)
    jt, tt = jl.sample(), tl.sample()
    assert _comparable(tt) == _comparable(jt)
    wm = tt["datasets"]["prom"]["shards"][0]["watermarks"]
    assert wm["flushed"] == wm["checkpoint"] == wm["ingested"] == off - 1
    assert "broker_end" not in wm
    assert tt["datasets"]["prom"]["totals"]["lag_rows"] == 0
    tl.close()
    jl.close()


def test_tier_watermarks_match_jax():
    j, t = JTier("n"), TierWatermarks("n")
    for w in (j, t):
        w.note("a", "prom", {60_000: 100, "3600000": 50})
        w.note("b", "prom", {60_000: 80})
        w.note("a", "prom", {60_000: 90})           # never moves back
    for peers in (["a", "b"], ["a"], ["a", "c"], []):
        assert t.cluster_min("prom", 60_000, peers) == \
            j.cluster_min("prom", 60_000, peers)
    assert t.cluster_min("prom", 60_000, ["a", "b"]) == 80
    assert t.snapshot() == j.snapshot()
    t.forget("b")
    j.forget("b")
    assert t.snapshot() == j.snapshot()
    assert t.peer_value("b", "prom", 60_000) is None


def test_sampler_thread_stops_cleanly():
    _jms, ms = _stores()
    led = WatermarkLedger(node="n-sampler")
    led.watch("prom", ms)
    calls = []
    real = led.sample
    led.sample = lambda: calls.append(real())
    sampler = WatermarkSampler(led, interval_s=0.01)
    sampler.fn = led.sample
    sampler.start()
    deadline = time.monotonic() + 5
    while len(calls) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    sampler.stop()
    n = len(calls)
    assert n >= 3
    assert sampler._thread is None
    time.sleep(0.05)
    assert len(calls) == n
    led.close()


# ---------------------------------------------------------------------------
# the traced partition
# ---------------------------------------------------------------------------

TRACED = {"instance": "i3"}


def _trace_lines(caplog, drive):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="filodb.trace"):
        drive()
    return [r.getMessage() for r in caplog.records
            if r.name == "filodb.trace"]


@pytest.mark.parametrize("path", ["ingest", "ingest_block"])
def test_traced_partition_logs_match_jax(caplog, path):
    sets = _containers()
    # 40-row chunks: the third container set freezes one while ingesting
    jms, ms = _stores(JStoreConfig(trace_filters=TRACED, max_chunks_size=40),
                      StoreConfig(trace_filters=TRACED, max_chunks_size=40))

    def drive(store, decode, schemas):
        def run():
            shard = store.get_shard("prom", 0)
            off = 0
            for conts in sets:
                for c in conts:
                    if path == "ingest":
                        shard.ingest(list(decode(c, schemas)), off)
                    else:
                        store.ingest("prom", 0, c, off)
                    off += 1
            shard.flush_all(ingestion_time=1000)
        return run

    want = _trace_lines(caplog, drive(jms, jdecode_container, J_SCHEMAS))
    got = _trace_lines(caplog, drive(ms, decode_container, DEFAULT_SCHEMAS))
    assert got == want
    shard = ms.get_shard("prom", 0)
    traced = [p for p in shard.partitions.values()
              if isinstance(p, TracingTimeSeriesPartition)]
    assert [p.tags["instance"] for p in traced] == ["i3"]
    pid = traced[0].part_id
    ingests = [ln for ln in got if ln.startswith("TRACE ingest")]
    freezes = [ln for ln in got if ln.startswith("TRACE freeze")]
    assert len(ingests) == 90                 # every row of the series
    assert len(freezes) == len(traced[0].chunks) >= 3
    assert all(f"part={pid} " in ln for ln in got)
