"""The slice end to end on the CPU: ingest, flush to sqlite, corrupt a
stored chunk, read it back (the checksum drops it and quarantines it),
then serve from the device grid, in the port against the JAX package
under the same quarantine.

- ``scan_grid`` / ``scan_grid_grouped`` with f64 residents (both
  stores' decoded-plane programs): selection ops and counts bit-equal,
  sums and the rate chain to rtol 1e-9 (prefix sums associate
  differently), the bound of tests/test_torch_devicestore.py.
- The packed path with f32 residents forced on both sides (the JAX
  store's packed kernel in Pallas interpret mode): selection ops
  bit-equal, sums and the rate chain to rtol 1e-6, the bound the JAX
  package holds its packed kernel to.
- The quarantine drops every staged block by the cache's quarantine
  epoch, also when the shard hook reaches another store's shard (the
  latest registration of a (dataset, shard) wins); a chunk corrupted
  in memory (``corrupt_staged_chunk``) is quarantined by the decode and
  left out the same way.
- The engine counts the quarantined chunk in
  ``QueryStats.corrupt_chunks_excluded`` inside its window only.
- The device-grid bytes a query reads, by resident format (dense,
  compressed, compressed-hist), in ``QueryStats.hbm_read_bytes`` and in
  the filodb_query_hbm_read_bytes_total counter, equal the JAX
  package's.
"""

import jax
import numpy as np
import pytest
import torch

from filodb_tpu import integrity as jintegrity
from filodb_tpu.coordinator.planner import \
    SingleClusterPlanner as JSingleClusterPlanner
from filodb_tpu.core.filters import ColumnFilter as JColumnFilter
from filodb_tpu.core.filters import Equals as JEquals
from filodb_tpu.core.schemas import DatasetOptions as JDatasetOptions
from filodb_tpu.integrity.faultinject import FaultInjector as JFaultInjector
from filodb_tpu.memstore import devicestore as jdevicestore
from filodb_tpu.parallel.shardmap import ShardMapper as JShardMapper
from filodb_tpu.parallel.shardmap import ShardStatus as JShardStatus
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jquery_range_to_logical_plan
from filodb_tpu.query.exec import ExecContext as JExecContext
from filodb_tpu.query.logical import RangeFunctionId as JF
from filodb_tpu.query.model import QueryContext as JQueryContext
from filodb_tpu_torch import integrity
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.schemas import DatasetOptions
from filodb_tpu_torch.integrity.faultinject import FaultInjector
from filodb_tpu_torch.memstore import devicestore
from filodb_tpu_torch.parallel.shardmap import ShardMapper, ShardStatus
from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
from filodb_tpu_torch.query.exec import ExecContext
from filodb_tpu_torch.query.logical import RangeFunctionId as F
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.utils.devicewatch import LEDGER
from tests.torch_durable_data import (STEP, T0, WINDOW,  # noqa: F401
                                      clear_quarantines, disk_stores,
                                      paging, stream)
from tests.torch_slice_data import assert_close

torch.set_num_threads(1)

K = WINDOW // STEP
GIDS = [0] * 6 + [1] * 6          # by pod
# inside block 0, and across blocks 0-1 (blocks of 128 buckets)
SPANS = {"one_block": (T0 + 40 * STEP, 60),
         "two_blocks": (T0 + 100 * STEP, 80)}
SERVED = ("RATE", "INCREASE", "SUM_OVER_TIME", "COUNT_OVER_TIME",
          "MAX_OVER_TIME", "LAST_OVER_TIME", None)
SELECTION = ("COUNT_OVER_TIME", "MAX_OVER_TIME", "LAST_OVER_TIME", None)
VICTIM = 4                        # the series whose chunk is corrupted


@pytest.fixture()
def f32_residents(monkeypatch):
    monkeypatch.setattr(jdevicestore, "_PACKED_INTERPRET", True)
    monkeypatch.setattr(jdevicestore, "_PACKED_BROKEN", False)
    monkeypatch.setattr(jdevicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)
    monkeypatch.setattr(devicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)


def _fns(name):
    return (getattr(JF, name) if name else None,
            getattr(F, name) if name else None)


def _flushed(tmp_path, name="a", paging=True):
    """Both stores, every container ingested, flushed twice (chunks of
    rows 0-99 and 100-199), with fixed ingestion times."""
    (j, jshard), (t, tshard) = disk_stores(tmp_path, name, paging=paging)
    recs = stream()
    half = len(recs) // 2
    for lo, hi in ((0, half), (half, len(recs))):
        for off, c in recs[lo:hi]:
            jshard.ingest_container(c, off)
            tshard.ingest_container(c, off)
        jshard.flush_all(ingestion_time=hi)
        tshard.flush_all(ingestion_time=hi)
    return (j, jshard), (t, tshard)


def _ids(jshard, tshard):
    jids = jshard.lookup_partitions(
        [JColumnFilter("_metric_", JEquals("m"))], 0, 2**62).part_ids
    tids = tshard.lookup_partitions(
        [ColumnFilter("_metric_", Equals("m"))], 0, 2**62).part_ids
    np.testing.assert_array_equal(jids, tids)
    return jids, tids


def _victim_chunk(tshard, tids, span):
    """The VICTIM series' chunk that overlaps the span's windows most."""
    steps0, nsteps = span
    lo, hi = steps0 - WINDOW, steps0 + (nsteps - 1) * STEP
    part = tshard.partitions[int(tids[VICTIM])]
    cs = max(part.chunks, key=lambda c: min(c.info.end_time, hi)
             - max(c.info.start_time, lo))
    return part.partkey, cs.info


def _quarantine_on_disk(j, t, pk, cid):
    """Flip a byte of one stored chunk in both stores' files and read
    every partition back: the checksum drops the row and quarantines
    it, in each package's registry."""
    assert JFaultInjector(9).corrupt_stored_chunk(
        j.store, "prom", 0, partkey=pk, chunk_id=cid) == (pk, cid)
    assert FaultInjector(9).corrupt_stored_chunk(
        t.store, "prom", 0, partkey=pk, chunk_id=cid) == (pk, cid)
    pks = [r.partkey for r in t.store.scan_part_keys("prom", 0)]
    got = dict(t.store.read_raw_partitions("prom", 0, pks, 0, 2**62))
    want = dict(j.store.read_raw_partitions("prom", 0, pks, 0, 2**62))
    assert {k: len(v) for k, v in got.items()} == \
        {k: len(v) for k, v in want.items()}
    assert cid not in [c.info.chunk_id for c in got[pk]]
    assert integrity.QUARANTINE.is_quarantined(pk, cid)
    assert jintegrity.QUARANTINE.is_quarantined(pk, cid)


def _inside(span, info):
    """Steps whose whole window lies in the chunk's span."""
    steps0, nsteps = span
    ends = steps0 + np.arange(nsteps) * STEP
    return (ends - WINDOW >= info.start_time) & (ends <= info.end_time)


@pytest.mark.parametrize("span", ["one_block", "two_blocks"])
def test_quarantined_chunk_left_out_f64(tmp_path, span, paging):
    (j, jshard), (t, tshard) = _flushed(tmp_path, paging=paging)
    jids, tids = _ids(jshard, tshard)
    steps0, nsteps = SPANS[span]
    before = tshard.scan_grid(tids, F.RATE, steps0, nsteps, STEP, WINDOW)[1]
    cache = next(iter(tshard.device_caches.values()))
    builds = cache.builds
    pk, info = _victim_chunk(tshard, tids, SPANS[span])
    _quarantine_on_disk(j, t, pk, info.chunk_id)
    for name in SERVED:
        jf, tf = _fns(name)
        with jax.disable_jit():
            want = jshard.scan_grid(jids, jf, steps0, nsteps, STEP, WINDOW)
        got = tshard.scan_grid(tids, tf, steps0, nsteps, STEP, WINDOW)
        assert got is not None and want is not None, name
        assert_close(got[1], want[1], name in SELECTION, 1e-9, name)
        with jax.disable_jit():
            jst = jshard.scan_grid_grouped(jids, jf, steps0, nsteps, STEP,
                                           WINDOW, GIDS, 2, "sum")
        tst = tshard.scan_grid_grouped(tids, tf, steps0, nsteps, STEP,
                                       WINDOW, GIDS, 2, "sum")
        np.testing.assert_array_equal(tst["count"], jst["count"])
        assert_close(tst["sum"], jst["sum"], name in SELECTION, 1e-9, name)
    # the blocks were dropped and re-staged without the chunk
    assert cache.builds > builds
    assert cache._quarantine_epoch == integrity.QUARANTINE.epoch()
    after = tshard.scan_grid(tids, F.RATE, steps0, nsteps, STEP, WINDOW)[1]
    inside = _inside(SPANS[span], info)
    assert inside.any()
    assert torch.isnan(after[VICTIM][inside]).all()
    assert torch.isfinite(before[VICTIM][inside]).all()
    keep = np.arange(len(tids)) != VICTIM
    assert_close(after[keep], before[keep], False, 1e-12, "others")


def test_quarantined_chunk_left_out_packed_f32(tmp_path, f32_residents,
                                               paging):
    (j, jshard), (t, tshard) = _flushed(tmp_path, paging=paging)
    jids, tids = _ids(jshard, tshard)
    steps0, nsteps = SPANS["one_block"]
    pk, info = _victim_chunk(tshard, tids, SPANS["one_block"])
    _quarantine_on_disk(j, t, pk, info.chunk_id)
    for name in ("SUM_OVER_TIME", "MAX_OVER_TIME", "LAST_OVER_TIME",
                 "RATE", None):
        jf, tf = _fns(name)
        want = jshard.scan_grid(jids, jf, steps0, nsteps, STEP, WINDOW)
        got = tshard.scan_grid(tids, tf, steps0, nsteps, STEP, WINDOW)
        assert got is not None and want is not None, name
        assert got[1].dtype == torch.float32
        assert_close(got[1], want[1], name in SELECTION, 1e-6, name)
        tplan = next(reversed(
            next(iter(tshard.device_caches.values()))._plan_memo.values()))
        jplan = next(reversed(
            next(iter(jshard.device_caches.values()))._plan_memo.values()))
        assert (tplan.packed is None) == (jplan.packed is None), name
    jst = jshard.scan_grid_grouped(jids, JF.SUM_OVER_TIME, steps0, nsteps,
                                   STEP, WINDOW, GIDS, 2, "sum")
    tst = tshard.scan_grid_grouped(tids, F.SUM_OVER_TIME, steps0, nsteps,
                                   STEP, WINDOW, GIDS, 2, "sum")
    assert tplan.packed is not None           # one block: packed
    np.testing.assert_array_equal(tst["count"], jst["count"])
    assert_close(tst["sum"], jst["sum"], False, 1e-6, "grouped sum")
    inside = _inside(SPANS["one_block"], info)
    got = tshard.scan_grid(tids, F.SUM_OVER_TIME, steps0, nsteps, STEP,
                           WINDOW)[1]
    assert torch.isnan(got[VICTIM][inside]).all()


def test_cache_epoch_drops_blocks_when_the_hook_goes_elsewhere(tmp_path,
                                                              paging):
    """Two port stores over ("prom", 0): the second registration wins the
    shard hook, yet the first store's cache drops its blocks on the
    quarantine epoch and re-stages without the chunk."""
    (j, jshard), (t, tshard) = _flushed(tmp_path, "a", paging=paging)
    (_j2, _jshard2), (_t2, tshard2) = _flushed(tmp_path, "b", paging=paging)
    jids, tids = _ids(jshard, tshard)
    steps0, nsteps = SPANS["two_blocks"]
    before = tshard.scan_grid(tids, F.RATE, steps0, nsteps, STEP, WINDOW)[1]
    cache = next(iter(tshard.device_caches.values()))
    ev_key = (cache.owner, "integrity_quarantine")
    ev0, builds, version = LEDGER.evictions.get(ev_key, 0), cache.builds, \
        cache.version
    pk, info = _victim_chunk(tshard, tids, SPANS["two_blocks"])
    _quarantine_on_disk(j, t, pk, info.chunk_id)
    # the store-level report reached the latest registered shard only
    assert tshard2.stats.chunks_quarantined == 1
    assert tshard.stats.chunks_quarantined == 0
    after = tshard.scan_grid(tids, F.RATE, steps0, nsteps, STEP, WINDOW)[1]
    assert LEDGER.evictions.get(ev_key, 0) > ev0
    assert cache.builds > builds and cache.version > version
    inside = _inside(SPANS["two_blocks"], info)
    assert torch.isnan(after[VICTIM][inside]).all()
    assert torch.isfinite(before[VICTIM][inside]).all()
    with jax.disable_jit():
        want = jshard.scan_grid(jids, JF.RATE, steps0, nsteps, STEP,
                                WINDOW)
    assert_close(after, want[1], False, 1e-9, "rate")
    # a query on the second store also re-stages: both caches saw it
    tids2 = _ids(jshard, tshard2)[1]
    got2 = tshard2.scan_grid(tids2, F.RATE, steps0, nsteps, STEP, WINDOW)
    assert_close(got2[1], want[1], False, 1e-9, "rate, store b")


@pytest.mark.parametrize("mode", ["wire", "truncate"])
def test_corrupt_staged_chunk_through_the_grid(tmp_path, mode, paging):
    (j, jshard), (t, tshard) = _flushed(tmp_path, paging=paging)
    jids, tids = _ids(jshard, tshard)
    steps0, nsteps = SPANS["two_blocks"]
    jpart = jshard.partitions[int(jids[VICTIM])]
    tpart = tshard.partitions[int(tids[VICTIM])]
    idx = len(tpart.chunks) - 1
    cid = FaultInjector(2).corrupt_staged_chunk(tpart, chunk_index=idx,
                                                vector=1, mode=mode)
    assert JFaultInjector(2).corrupt_staged_chunk(
        jpart, chunk_index=idx, vector=1, mode=mode) == cid
    for name in ("RATE", "SUM_OVER_TIME", None):
        jf, tf = _fns(name)
        with jax.disable_jit():
            want = jshard.scan_grid(jids, jf, steps0, nsteps, STEP, WINDOW)
        got = tshard.scan_grid(tids, tf, steps0, nsteps, STEP, WINDOW)
        assert_close(got[1], want[1], name in SELECTION, 1e-9, name)
    assert integrity.QUARANTINE.is_quarantined(tpart.partkey, cid)
    assert jintegrity.QUARANTINE.is_quarantined(jpart.partkey, cid)
    # the partition-level detection reached this shard through on_corrupt
    assert tshard.stats.chunks_corrupt >= 1
    assert tshard.stats.chunks_quarantined == 1
    info = tpart.chunks[idx].info
    inside = _inside(SPANS["two_blocks"], info)
    assert inside.any() and torch.isnan(got[1][VICTIM][inside]).all()


def _engines(jms, ms):
    jmapper = JShardMapper(1)
    jmapper.register_node([0], "local")
    jmapper.update_status(0, JShardStatus.ACTIVE)
    mapper = ShardMapper(1)
    mapper.update_status(0, ShardStatus.ACTIVE)
    return (JSingleClusterPlanner("prom", jmapper, JDatasetOptions(),
                                  spread_default=0),
            SingleClusterPlanner("prom", mapper, DatasetOptions(),
                                 spread_default=0))


def test_corrupt_chunks_excluded_through_the_engine(tmp_path, paging):
    (j, jshard), (t, tshard) = _flushed(tmp_path, paging=paging)
    jids, tids = _ids(jshard, tshard)
    pk, info = _victim_chunk(tshard, tids, SPANS["two_blocks"])
    jplanner, planner = _engines(j, t)
    q = "sum by (pod)(rate(m[5m]))"

    def run(start, nsteps):
        end = start + (nsteps - 1) * STEP
        got = planner.materialize(query_range_to_logical_plan(
            q, start, STEP, end)).execute(ExecContext(t, QueryContext()))
        with jax.disable_jit():
            want = jplanner.materialize(jquery_range_to_logical_plan(
                q, start, STEP, end)).execute(JExecContext(
                    j, JQueryContext()))
        return got, want

    got, want = run(*SPANS["two_blocks"])
    assert got.stats.corrupt_chunks_excluded == 0
    _quarantine_on_disk(j, t, pk, info.chunk_id)
    inside = run(*SPANS["two_blocks"])
    # a window that ends before the chunk starts excluded nothing
    outside = run(info.start_time - 40 * STEP, 20)
    assert info.start_time - 21 * STEP > T0
    for got, want in (inside, outside):
        assert got.stats.corrupt_chunks_excluded == \
            want.stats.corrupt_chunks_excluded
    assert inside[0].stats.corrupt_chunks_excluded == 1
    assert outside[0].stats.corrupt_chunks_excluded == 0
    # the answer itself: the grouped sums under the quarantine agree
    for b, jb in zip(inside[0].batches, inside[1].batches):
        assert_close(b.np_values()[:len(b.keys)],
                     np.asarray(jb.values)[:len(jb.keys)], False, 1e-9,
                     "engine sums")


# ------------------------------------------------- device-grid read bytes

def _hbm_counts(jplanner, planner, jms, ms, query, start, step, nsteps):
    """Run ``query`` through both engines: each result's
    ``QueryStats.hbm_read_bytes`` beside the increments of its package's
    filodb_query_hbm_read_bytes_total counter, by format."""
    from filodb_tpu.utils.observability import query_metrics as jmetrics
    from filodb_tpu_torch.utils.observability import query_metrics
    formats = ("dense", "compressed", "compressed-hist")
    end = start + (nsteps - 1) * step
    out = []
    for metrics, run in (
            (jmetrics, lambda: jplanner.materialize(
                jquery_range_to_logical_plan(query, start, step, end))
             .execute(JExecContext(jms, JQueryContext()))),
            (query_metrics, lambda: planner.materialize(
                query_range_to_logical_plan(query, start, step, end))
             .execute(ExecContext(ms, QueryContext())))):
        m = metrics()["hbm_read_bytes"]
        before = {f: m.value(format=f) for f in formats}
        res = run()
        counted = {f: m.value(format=f) - before[f] for f in formats}
        out.append((res.stats.hbm_read_bytes,
                    {f: n for f, n in counted.items() if n}))
    return out


def _same_hbm_counts(got, want, formats):
    (tstats, tcounter), (jstats, jcounter) = got, want
    assert tstats == jstats and tcounter == jcounter
    # the counter took what the result reports, in the plan's formats
    assert tstats == tcounter and sorted(tstats) == sorted(formats)
    assert all(n > 0 for n in tstats.values())


@pytest.mark.parametrize("compress", [False, True])
def test_hbm_read_bytes_f64_matches_jax(compress):
    """f64 residents: dense value and ts planes, or XOR value planes
    decoded in the serving program beside a uniform-phase ts row."""
    from tests.test_torch_hist_grid import _memstores
    jms, ms = _memstores([c for _off, c in stream()],
                         {"device_cache_compress": compress})
    jplanner, planner = _engines(jms, ms)
    want, got = _hbm_counts(jplanner, planner, jms, ms,
                            "sum by (pod)(rate(m[5m]))",
                            SPANS["two_blocks"][0], STEP,
                            SPANS["two_blocks"][1])
    _same_hbm_counts(got, want, ["compressed" if compress else "dense"])


def test_hbm_read_bytes_packed_matches_jax(tmp_path, f32_residents,
                                           paging):
    (j, _jshard), (t, tshard) = _flushed(tmp_path, paging=paging)
    jplanner, planner = _engines(j, t)
    want, got = _hbm_counts(jplanner, planner, j, t,
                            "sum_over_time(m[5m])", SPANS["one_block"][0],
                            STEP, SPANS["one_block"][1])
    plan = next(reversed(
        next(iter(tshard.device_caches.values()))._plan_memo.values()))
    assert plan.packed is not None
    _same_hbm_counts(got, want, ["compressed"])


def test_hbm_read_bytes_hist_matches_jax(f32_residents):
    from tests.data import START_TS
    from tests.test_torch_hist_grid import (HSTEP, _memstores,
                                            _packing_containers)
    jms, ms = _memstores(_packing_containers(),
                         {"device_cache_compress": True})
    jplanner, planner = _engines(jms, ms)
    want, got = _hbm_counts(jplanner, planner, jms, ms,
                            "sum(rate(plat[50s]))", START_TS + 6 * HSTEP,
                            HSTEP, 96 - 7)
    cache = next(iter(ms.get_shard("prom", 0).device_caches.values()))
    assert cache.hist
    assert next(reversed(cache._plan_memo.values())).packed is not None
    _same_hbm_counts(got, want, ["compressed-hist"])
