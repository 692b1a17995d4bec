"""The port's live rollup engine (``filodb_tpu_torch.rollup``) against the
JAX package's, on the same generated streams:

- the ladder's validation and ``from_config``'s durations, refusal for
  refusal and value for value;
- the engine fed the same stream through each package's flush listener
  (a gauge, a counter with resets, a histogram whose buckets widen
  mid-stream): the tier datasets hold the same records, the stamps and
  ``min``/``max``/``count``/``last`` bit for bit, ``sum``/``avg`` within
  rtol 1e-12 (tests/test_torch_downsample.py's bound), and each port
  tier equals the port's offline downsample pass bit for bit over
  closed periods (tests/test_rollup.py's oracle);
- idle close, and a series resuming inside a force-closed period that
  never re-emits it;
- a consume failure requeues its batches and the next tick heals;
- a flush-queue overflow recovers through the store replay;
- a restart from the persisted high-water marks over sqlite stores;
- ``Histogram.top_bucket_value`` and ``hist_max_quantile_bulk``."""

import unittest.mock as mock

import numpy as np
import pytest
import torch

from filodb_tpu.core import histogram as jhistogram
from filodb_tpu.rollup.config import RollupConfig as JRollupConfig
from filodb_tpu.rollup.config import RollupConfigError as JRollupConfigError
from filodb_tpu.store.persistence import DiskColumnStore as JDiskColumnStore
from filodb_tpu.store.persistence import DiskMetaStore as JDiskMetaStore
from filodb_tpu_torch.core import histogram
from filodb_tpu_torch.downsample import sharddown
from filodb_tpu_torch.rollup import engine as eng_mod
from filodb_tpu_torch.rollup.config import (DEFAULT_RESOLUTIONS_MS,
                                            RollupConfig, RollupConfigError,
                                            parse_duration_ms)
from filodb_tpu_torch.store.persistence import DiskColumnStore, DiskMetaStore
from tests.torch_rollup_data import (BASE, RES, Harness, both, last_by_pk,
                                     mk_rows, stop_engines)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _stop_engines():
    yield
    stop_engines()

RTOL_SUM = 1e-12          # sum/avg: the reduction order may differ

BAD_LADDERS = [dict(resolutions_ms=()),
               dict(resolutions_ms=(900_000, 60_000)),
               dict(resolutions_ms=(60_000, 100_000)),
               dict(resolutions_ms=(500,)),
               dict(tick_interval_s=0)]

CONFIGS = [{"resolutions": ["1m", "15m", "1h"], "tick-interval-s": 5,
            "raw-retention": "6h", "idle-close": "0"},
           {"resolutions": ["1m", "1h"], "idle-close": "2h"},
           {"enabled": True, "store": {}, "query": {"workers": 2}},
           {"tick-interval": 5},
           {"idle_close": "4h"},
           {"resolutions": ["1m", "1h"], "idle-close": "30m"},
           {"resolutions": ["bogus"]},
           {"resolutions": ["30s", "5m"], "raw-retention": "1d",
            "stall-after-s": 60}]


@pytest.mark.parametrize("kw", BAD_LADDERS)
def test_ladder_validation_as_jax(kw):
    assert RollupConfig().resolutions_ms == JRollupConfig().resolutions_ms \
        == DEFAULT_RESOLUTIONS_MS == (60_000, 900_000, 3_600_000)
    with pytest.raises(JRollupConfigError):
        JRollupConfig(**kw)
    with pytest.raises(RollupConfigError):
        RollupConfig(**kw)


@pytest.mark.parametrize("conf", CONFIGS)
def test_from_config_as_jax(conf):
    try:
        want = JRollupConfig.from_config(conf)
    except JRollupConfigError:
        with pytest.raises(RollupConfigError):
            RollupConfig.from_config(conf)
        return
    got = RollupConfig.from_config(conf)
    for f in ("resolutions_ms", "tick_interval_s", "raw_retention_ms",
              "idle_close_s", "stall_after_s"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("v", ["15s", "1m", "250ms", "2h", "1d", "1w",
                               "30", "1.5h"])
def test_parse_duration_as_jax(v):
    from filodb_tpu.http.model import parse_duration_ms as jparse
    assert parse_duration_ms(v) == jparse(v)


def _close(a, b, exact: bool, msg):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, msg
    if exact:
        assert np.array_equal(a.view(np.int64), b.view(np.int64)), msg
        return
    assert np.array_equal(np.isnan(a), np.isnan(b)), msg
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL_SUM, err_msg=msg)


def assert_tiers_as_jax(h: dict, resolutions=RES) -> int:
    """Both harnesses' tier datasets hold the same records."""
    n = 0
    for res in resolutions:
        want = h["jax"].tier_rows(res)
        got = h["torch"].tier_rows(res)
        assert set(got) == set(want), res
        cols = h["torch"].tier_shard(res)
        for pk, (ts, gcols) in got.items():
            wts, wcols = want[pk]
            assert ts.tobytes() == wts.tobytes(), (res, pk)
            part = cols.partitions[cols.part_set[pk]]
            names = [c.name for c in part.schema.data.columns[1:]]
            for name, g, w in zip(names, gcols, wcols):
                if isinstance(w, tuple):
                    assert g[0].tobytes() == w[0].tobytes(), (res, pk)
                    _close(g[1], w[1], True, (res, pk, name))
                else:
                    _close(g, w, name not in ("sum", "avg"), (res, pk, name))
            n += len(ts)
    assert n
    return n


@pytest.mark.parametrize("seed", [0, 1])
def test_gauge_stream_as_jax_and_the_oracle(seed):
    h = both()
    last: dict = {}
    rng = np.random.default_rng(seed)
    for _rnd in range(4):
        rows = mk_rows(rng, last, n_series=4, rows=150,
                       span_ms=20 * 60_000)
        extra = rng.random() < 0.3
        for hh in h.values():
            hh.ingest(rows)
            hh.flush_tick()
            if extra:
                hh.engine.run_once("prom")      # a no-op tick
    assert_tiers_as_jax(h)
    th = h["torch"]
    for res in RES:
        th.assert_tier_matches_oracle(res, last_by_pk("torch", last))
    # per-series closure: no period is ever emitted twice
    assert th.tier_shard(RES[0]).stats.out_of_order_dropped == 0
    rolled = {pkg: [hh.engine.rolled_through("prom", r) for r in RES]
              for pkg, hh in h.items()}
    assert rolled["torch"] == rolled["jax"]


def test_regular_cadence_on_the_grid_path_as_jax(monkeypatch):
    """Regular scrapes stage the grid path: the period reduce runs in
    torch on the memstore's device (the port's griddown), the tiers and
    the engine's views equal the JAX package's.  Against the offline
    pass the 15 min and 1 h tiers' ``sum`` and ``avg`` are within rtol
    1e-12, not bit-equal: they cascade from 1 min planes staged from
    the live buffers, which the JAX package's tiers do too."""
    from filodb_tpu_torch.downsample import griddown
    served = []
    real = griddown.grid_outputs

    def counting(staged, res, *a, **kw):
        got = real(staged, res, *a, **kw)
        served.append(0 if got is None else int(got[0].sum()))
        return got
    monkeypatch.setattr(griddown, "grid_outputs", counting)
    h = both(resolutions=(60_000, 900_000, 3_600_000))
    rng = np.random.default_rng(11)
    last: dict = {}
    for rnd in range(3):
        rows = []
        for i in range(4):
            ts = BASE + rnd * 2 * 3_600_000 + 1 + np.arange(
                0, 2 * 3_600_000, 30_000)
            rows.append(({"__name__": "m", "inst": f"i{i}", "_ws_": "w",
                          "_ns_": "n", "g": f"g{i % 2}"}, ts,
                         rng.normal(5, 1, len(ts))))
            last[i] = int(ts[-1])
        for hh in h.values():
            hh.ingest(rows)
            hh.flush_tick()
    assert served and min(served) == 4, served
    assert_tiers_as_jax(h, (60_000, 900_000, 3_600_000))
    th, jh = h["torch"], h["jax"]
    for res in (60_000, 900_000, 3_600_000):
        th.assert_tier_matches_oracle(res, last_by_pk("torch", last),
                                      sums_rtol=RTOL_SUM)
        for view in ("rolled_through", "owned_rolled_through",
                     "delivered_through"):
            assert getattr(th.engine, view)("prom", res) == \
                getattr(jh.engine, view)("prom", res), (view, res)
    assert th.engine.rolled_snapshot() == jh.engine.rolled_snapshot()
    got, want = th.engine.admin_state(), jh.engine.admin_state()
    for d in (got, want):
        d["datasets"][0].pop("last_pass_s")
    assert got == want


def test_counter_with_resets_as_jax_and_the_oracle():
    h = both(schema="prom-counter")
    last: dict = {}
    rng = np.random.default_rng(3)
    for _rnd in range(4):
        rows = mk_rows(rng, last, n_series=3, rows=120,
                       span_ms=15 * 60_000, counter=True)
        for hh in h.values():
            hh.ingest(rows)
            hh.flush_tick()
    assert_tiers_as_jax(h)
    for res in RES:
        h["torch"].assert_tier_matches_oracle(
            res, last_by_pk("torch", last, "c_total"))


def test_histogram_widening_as_jax_and_the_oracle():
    """prom-histogram series roll through their hLast/hSum period
    oracles on the host path, bucket schemes widening mid-stream (8 ->
    12 buckets): the narrow rows edge-pad under the wider scheme."""
    h = both(schema="prom-histogram")
    rng = np.random.default_rng(5)
    last: dict = {}
    t = BASE
    step = 10_000
    cums = {}
    for rnd in range(4):
        hb = 8 if rnd < 2 else 12
        tops = [2.0 * 2.0 ** i for i in range(hb)]
        rows_n = int(rng.integers(30, 90))
        batch = []
        for i in range(3):
            tags = {"_metric_": "lat", "inst": f"i{i}", "_ws_": "w",
                    "_ns_": "n", "g": f"g{i % 2}"}
            cum = cums.get(i, np.zeros(hb, np.int64))
            if len(cum) < hb:
                cum = np.pad(cum, (0, hb - len(cum)), mode="edge")
            rows = np.empty((rows_n, hb), np.int64)
            for r in range(rows_n):
                cum = cum + rng.integers(0, 5, hb)
                rows[r] = np.cumsum(cum)
            cums[i] = cum
            ts = t + np.arange(rows_n, dtype=np.int64) * step
            batch.append((tags, ts, (tops, rows)))
            last[i] = int(ts[-1])
        t += rows_n * step
        for hh in h.values():
            hh.ingest_hist(batch)
            hh.flush_tick()
    assert_tiers_as_jax(h)
    for res in RES:
        h["torch"].assert_tier_matches_oracle(
            res, last_by_pk("torch", last, "lat"))


def test_idle_close_emits_open_periods_as_jax():
    """A silent series' open periods force-close on the next tick, and
    its state drops."""
    h = both(idle_close_s=0.0)
    rng = np.random.default_rng(9)
    last: dict = {}
    rows = mk_rows(rng, last, n_series=2, rows=100, span_ms=10 * 60_000)
    for hh in h.values():
        hh.ingest(rows)
        hh.flush_tick()
        hh.engine.run_once("prom")          # the idle sweep
        st = hh.engine.admin_state()["datasets"][0]["shards"][0]
        assert st["buffered_series"] == 0
    assert_tiers_as_jax(h)
    for res in RES:
        h["torch"].assert_tier_matches_oracle(
            res, last_by_pk("torch", last), closed=False)


def test_resumed_series_never_recollides_as_jax():
    """A series resuming INSIDE a force-closed period never re-emits its
    stamp (the tier's first-copy dedupe would keep the partial record):
    the idle sweep keeps the emitted stamps as restart seeds."""
    h = both(idle_close_s=0.0)
    tags = {"__name__": "m", "inst": "i0", "_ws_": "w", "_ns_": "n",
            "g": "g0"}
    res = RES[0]
    p_start = ((BASE // res) + 1) * res
    first = p_start + np.arange(1, 20_000, 10_000, dtype=np.int64)
    later = p_start + np.arange(30_001, 3 * res, 10_000, dtype=np.int64)
    for hh in h.values():
        hh.ingest([(tags, first, np.ones(len(first)))])
        hh.flush_tick()
        hh.engine.run_once("prom")          # the period force-closes
        hh.ingest([(tags, later, np.full(len(later), 2.0))])
        hh.flush_tick()
    assert_tiers_as_jax(h)
    th = h["torch"]
    sh = th.tier_shard(res)
    pk = th.m.canonical_partkey({"_metric_": "m", "inst": "i0", "_ws_": "w",
                                 "_ns_": "n", "g": "g0"})
    part = sh.partitions[sh.part_set[pk]]
    got_ts, counts = part.read_range(0, 1 << 62, 4)
    assert (np.diff(np.asarray(got_ts)) > 0).all()
    assert sh.stats.out_of_order_dropped == 0
    # the force-closed period keeps its partial count of 2; the resumed
    # rows inside it are the documented idle-close loss
    assert int(np.asarray(counts)[0]) == 2


def test_consume_failure_requeues_and_heals():
    """A decode failure mid-consume must not lose the drained flush
    batches: they requeue, the error shows, nothing is emitted, and the
    next tick replays them losslessly."""
    th = Harness("torch")
    rng = np.random.default_rng(23)
    last: dict = {}
    th.ingest(mk_rows(rng, last, 2, 100, 10 * 60_000))
    with mock.patch.object(sharddown, "decode_concat_with_keys",
                           side_effect=RuntimeError("poisoned")):
        th.flush_tick()
    d = th.engine._datasets["prom"]
    assert d.shards[0].queue, "failed batches must requeue"
    assert d.tier_errors and d.shards[0].retry
    assert th.tier_shard(RES[0]).stats.rows_ingested == 0
    th.engine.run_once("prom")
    for res in RES:
        th.assert_tier_matches_oracle(res, last_by_pk("torch", last))
    assert not d.tier_errors


def test_queue_overflow_recovers_via_store_replay():
    """An overflowing flush queue drops the handoff but turns the shard
    to the store replay: nothing persisted is lost."""
    th = Harness("torch")
    rng = np.random.default_rng(33)
    last: dict = {}
    th.ingest(mk_rows(rng, last, 2, 100, 10 * 60_000))
    th.flush_tick()                      # persists the replay floor
    with mock.patch.object(eng_mod, "_QUEUE_CAP", 0):
        th.ingest(mk_rows(rng, last, 2, 100, 10 * 60_000))
        th.itime += 1
        th.shard.flush_all(ingestion_time=th.itime)   # overflows
    sr = th.engine._datasets["prom"].shards[0]
    assert sr.lost and not sr.active and not sr.queue
    assert th.engine._datasets["prom"].tier_errors
    th.engine.run_once("prom")           # the restore replays the store
    for res in RES:
        th.assert_tier_matches_oracle(res, last_by_pk("torch", last))


def _restart(pkg, tmp_path, disk):
    """Two rounds, the tier datasets flushed, a crash; a fresh node over
    the same files resumes from the persisted high-water marks and takes
    one more round.  Returns the second harness and the last stamps."""
    col, meta = disk
    store = col(str(tmp_path / f"{pkg}-c.db"))
    mstore = meta(str(tmp_path / f"{pkg}-m.db"))
    rng = np.random.default_rng(13)
    last: dict = {}
    h1 = Harness(pkg, store=store, meta=mstore)
    for _rnd in range(2):
        h1.ingest(mk_rows(rng, last, 3, 120, 15 * 60_000))
        h1.flush_tick()
    seeded = {}
    for r in RES:
        tsh = h1.tier_shard(r)
        tsh.flush_all(ingestion_time=5000)
        seeded[r] = {pk: tsh.partitions[pid].latest_timestamp
                     for pk, pid in tsh.part_set.items()}
    hwm = mstore.read_checkpoints("__rollup__:prom", 0)
    offset, itime = h1.offset, h1.itime
    h1.engine.stop()
    h1.ms.reset()
    h2 = Harness(pkg, store=store, meta=mstore)
    h2.offset, h2.itime = offset, itime
    h2.ingest(mk_rows(rng, last, 3, 120, 15 * 60_000))
    h2.flush_tick()
    return h2, last, seeded, hwm


def test_restart_from_persisted_hwm_as_jax(tmp_path):
    """The high-water marks persist under ``__rollup__:prom`` in the
    meta store; a restarted engine re-emits nothing the old one
    persisted, and old plus new rows equal the continuous oracle."""
    runs = {"jax": _restart("jax", tmp_path, (JDiskColumnStore,
                                              JDiskMetaStore)),
            "torch": _restart("torch", tmp_path, (DiskColumnStore,
                                                  DiskMetaStore))}
    h2, last, seeded, hwm = runs["torch"]
    assert hwm == runs["jax"][3] and set(hwm) == {0, 1}
    lbp = last_by_pk("torch", last)
    m = h2.m
    for res in RES:
        tier = h2.tier_rows(res)
        assert {pk: ts.tobytes() for pk, (ts, _c) in tier.items()} == \
            {pk: ts.tobytes() for pk, (ts, _c)
             in runs["jax"][0].tier_rows(res).items()}
        # the fresh node re-emitted NOTHING the old node persisted
        for pk, (ts, _cols) in tier.items():
            if len(ts) and pk in seeded[res]:
                assert int(ts[0]) > seeded[res][pk], (res, pk)
        # persisted (before the crash) + resident (after) rows together
        # equal the continuous-run oracle
        persisted: dict = {}
        for _it, cs in h2.store.chunksets_with_ingestion_time(
                m.ds_dataset_name("prom", res), 0, 0, 1 << 62):
            ts_c, cols_c = m.decode_chunkset(m.DEFAULT_SCHEMAS["ds-gauge"],
                                             cs)
            persisted.setdefault(bytes(cs.partkey), []).append(
                (np.asarray(ts_c), [np.asarray(c) for c in cols_c]))
        checked = 0
        for tags, pe, cols in h2.oracle_outputs(res):
            pk = m.canonical_partkey(tags)
            pe = np.asarray(pe, np.int64)
            keep = pe <= ((lbp[pk] - 1) // res) * res
            parts = list(persisted.get(pk, []))
            if pk in tier and len(tier[pk][0]):
                parts.append(tier[pk])
            all_ts = np.concatenate([p[0] for p in parts])
            order = np.argsort(all_ts, kind="stable")
            assert (np.diff(all_ts[order]) > 0).all(), (res, tags)
            assert all_ts[order].tobytes() == pe[keep].tobytes()
            for ci in range(len(cols)):
                v = np.concatenate([np.asarray(p[1][ci]) for p in parts])
                assert v[order].tobytes() == \
                    np.asarray(cols[ci])[keep].tobytes(), (res, tags)
            checked += 1
        assert checked == 3
    for h, *_ in runs.values():
        h.engine.stop()


def test_histogram_helpers_as_jax():
    rng = np.random.default_rng(4)
    tops = np.array([0.1, 0.5, 1.0, 5.0, np.inf])
    rows = np.cumsum(rng.integers(0, 9, (16, 5)), axis=1).astype(np.float64)
    rows[3] = np.nan
    maxes = rng.uniform(0.05, 6.0, 16)
    maxes[5] = np.nan
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        got = histogram.hist_max_quantile_bulk(tops, rows, maxes, q)
        want = jhistogram.hist_max_quantile_bulk(tops, rows, maxes, q)
        np.testing.assert_array_equal(got, want)
        base = histogram.quantile_bulk(tops, rows, q)
        fin = np.isfinite(maxes) & np.isfinite(base)
        assert (got[fin] <= np.maximum(maxes[fin], base[fin])).all()
    b = histogram.CustomBuckets(tops)
    jb = jhistogram.CustomBuckets(tops)
    for r in rows[:3]:
        assert histogram.Histogram(b, r).top_bucket_value() == \
            jhistogram.Histogram(jb, r).top_bucket_value() == r[-1]
