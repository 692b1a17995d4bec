"""The device grid over the paging shard, port against the JAX package
(f64 residents on both sides, the JAX grid under ``disable_jit``):

- paged partitions serve ``scan_grid`` / ``scan_grid_grouped`` in both
  packages, with the same answers (rtol 1e-9, the JAX package's own
  bound for this case, test_persistence.py:377);
- a recovered store whose residents hold only their replayed tail: the
  disk floor refuses the grid exactly where the JAX package's does, the
  general path backfills the older chunks from sqlite, and after an
  eviction that flushes the buffered rows the repeat hit over the paged
  partitions takes the same grid decision with the same answers;
- a page-cache eviction invalidates a grid plan;
- a lane whose partition was page-evicted is pruned from a block build,
  and the build after it succeeds;
- the disk floor is the requested partitions' own: a second subset in
  the same ingest epoch with a higher floor is refused by the port (the
  JAX package serves it with rows missing, against its own general
  path);
- a page cache smaller than the working set: neither package serves
  the repeat hit from the grid."""

import jax
import numpy as np
import pytest
import torch

from filodb_tpu.query.logical import RangeFunctionId as JF
from filodb_tpu_torch.query.logical import RangeFunctionId as F
from tests.torch_durable_data import clear_quarantines  # noqa: F401
from tests.torch_odp_data import (STEP, T0, assert_same_batch,
                                  assert_same_stats, feed, filters,
                                  gauge_containers, scan_both, stores)
from tests.torch_slice_data import assert_close

torch.set_num_threads(1)

WINDOW = 120_000
N_ROWS = 120


def _ids(jshard, tshard, metric):
    jf, tf = filters(metric)
    jids = jshard.lookup_partitions(jf, 0, 2**62).part_ids
    tids = tshard.lookup_partitions(tf, 0, 2**62).part_ids
    np.testing.assert_array_equal(jids, tids)
    return jids, tids


def _grid_both(jshard, tshard, jids, tids, steps0, nsteps, fn="RATE"):
    with jax.disable_jit():
        want = jshard.scan_grid(jids, getattr(JF, fn), steps0, nsteps, STEP,
                                WINDOW)
    got = tshard.scan_grid(tids, getattr(F, fn), steps0, nsteps, STEP,
                           WINDOW)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[0] == want[0]
        assert_close(got[1], want[1], fn == "MAX_OVER_TIME", 1e-9, fn)
    return got


def _settle(*shards):
    """Wait for the deferred page-cache publishes of the shards' bulk
    page-ins: a fused page-in answers its query first and fills the page
    cache on a side thread, so what the cache holds is read only after
    those threads are joined."""
    for shard in shards:
        shard._join_materialize()


def _paged(tmp_path, metric, n_series):
    """Both stores, every row flushed, every partition evicted, then one
    general scan that pages them all back in."""
    (j, jshard), (t, tshard) = stores(tmp_path)
    containers, _truth = gauge_containers(metric, n_series, N_ROWS,
                                          seed=5, jitter=False)
    feed(containers, jshard, tshard)
    jshard.flush_all()
    tshard.flush_all()
    assert jshard.evict_partitions(n_series) == \
        tshard.evict_partitions(n_series) == n_series
    assert tshard.num_partitions == 0
    assert_same_batch(*scan_both(jshard, tshard, metric))
    _settle(jshard, tshard)
    assert tshard.stats.partitions_paged == n_series
    assert_same_stats(jshard, tshard)
    return (j, jshard), (t, tshard)


def _recovered_tails(tmp_path, metric, seed):
    """A restart whose residents hold only their replayed tail: group
    0's from row 100, group 1's from row 60 (rows 0-59 flushed in both
    groups, rows 60-99 in group 0 only, the rest replayed and left in
    the write buffers).  Returns both shards, the stream's truth and
    the offset after its last container."""
    spans, truth = gauge_containers(metric, 6, 200, seed=seed,
                                    jitter=False, cuts=(60, 100))
    (j, jshard), (t, tshard) = stores(tmp_path)
    feed(spans[0], jshard, tshard)
    jshard.flush_all()
    tshard.flush_all()
    feed(spans[1], jshard, tshard, offset0=len(spans[0]))
    jshard.flush_group(0)
    tshard.flush_group(0)
    (j2, jshard), (t2, tshard) = stores(tmp_path)     # the same files
    assert t2.recover_index("prom", 0) == j2.recover_index("prom", 0) == 6
    recs = list(enumerate(spans[0] + spans[1] + spans[2]))
    assert t2.recover_stream("prom", 0, recs) == \
        j2.recover_stream("prom", 0, recs) > 0
    return jshard, tshard, truth, len(recs)


def test_paged_partitions_serve_the_grid(tmp_path):
    (_j, jshard), (_t, tshard) = _paged(tmp_path, "pg", 6)
    jids, tids = _ids(jshard, tshard, "pg")
    steps0, nsteps = T0 + 120_000, 40
    for fn in ("RATE", "SUM_OVER_TIME", "MAX_OVER_TIME"):
        got = _grid_both(jshard, tshard, jids, tids, steps0, nsteps, fn)
        assert got is not None, f"{fn}: the grid did not serve paged data"
    with jax.disable_jit():
        jst = jshard.scan_grid_grouped(jids, JF.RATE, steps0, nsteps, STEP,
                                       WINDOW, [0, 0, 0, 1, 1, 1], 2, "sum")
    tst = tshard.scan_grid_grouped(tids, F.RATE, steps0, nsteps, STEP,
                                   WINDOW, [0, 0, 0, 1, 1, 1], 2, "sum")
    np.testing.assert_array_equal(tst["count"], jst["count"])
    assert_close(tst["sum"], jst["sum"], False, 1e-9, "sum")


def test_disk_floor_backfill_then_paged_grid(tmp_path):
    """The durable path at a small size: rows 0-59 flushed in both
    groups, rows 60-99 in group 0 only, a restart, the stream replayed
    from the start (each group skips what it checkpointed) and its last
    rows left in the write buffers."""
    jshard, tshard, truth, _end = _recovered_tails(tmp_path, "rc", 7)
    jids, tids = _ids(jshard, tshard, "rc")
    tail = min(p.earliest_timestamp for p in tshard.partitions.values())
    floor = max(p.earliest_timestamp for p in tshard.partitions.values())
    # residents hold only their tail, group 0's shorter than group 1's
    assert (tail, floor) == (T0 + 60 * STEP, T0 + 100 * STEP)
    # the tail: the grid serves; its epoch comes from the tail
    t_steps0 = floor + WINDOW + STEP - floor % STEP
    assert _grid_both(jshard, tshard, jids, tids, t_steps0, 20) is not None
    # reaching below the floor: both refuse, and the general path
    # backfills the older chunks from sqlite
    h_steps0 = tail + WINDOW + STEP - tail % STEP
    h_n = (T0 + 199 * STEP - h_steps0) // STEP + 1
    assert h_steps0 < floor
    assert _grid_both(jshard, tshard, jids, tids, h_steps0, h_n) is None
    jgot, tgot = scan_both(jshard, tshard, "rc")
    assert_same_batch(jgot, tgot)
    by = {t["instance"]: i for i, t in enumerate(tgot[0])}
    for inst, (ts, vals) in truth.items():
        i = by[inst]
        np.testing.assert_array_equal(
            np.asarray(tgot[1].timestamps)[i][:len(ts)], ts)
    # evict: the buffered rows flush first, and bump the ingest epoch
    epoch = tshard.ingest_epoch
    assert tshard.evict_partitions(6) == jshard.evict_partitions(6) == 6
    assert tshard.ingest_epoch > epoch
    assert_same_stats(jshard, tshard)
    assert_same_batch(*scan_both(jshard, tshard, "rc"))   # pages in
    got = _grid_both(jshard, tshard, jids, tids, h_steps0, h_n)
    assert got is not None, "the repeat hit was not served over paged data"
    assert_same_batch(*scan_both(jshard, tshard, "rc"))
    assert_same_stats(jshard, tshard)


def test_page_evict_invalidates_grid_plan(tmp_path):
    (_j, jshard), (_t, tshard) = _paged(tmp_path, "pe", 4)
    jids, tids = _ids(jshard, tshard, "pe")
    first = _grid_both(jshard, tshard, jids, tids, T0 + 120_000, 20)
    assert first is not None
    for shard in (jshard, tshard):
        epoch = shard.removal_epoch
        shard.paged.max_bytes = 1
        shard.paged.put(999_999, object(), 10)      # LRU pressure
        assert shard.removal_epoch > epoch
    again = _grid_both(jshard, tshard, jids, tids, T0 + 120_000, 20)
    if again is not None:
        assert_close(again[1], first[1], False, 1e-12, "re-served")


def test_evicted_lane_pruned_from_block_build(tmp_path):
    (_j, jshard), (_t, tshard) = _paged(tmp_path, "nl", 4)
    jids, tids = _ids(jshard, tshard, "nl")
    assert _grid_both(jshard, tshard, jids, tids, T0 + 120_000, 20) \
        is not None
    victim = int(tids[-1])
    for shard in (jshard, tshard):
        cache = next(iter(shard.device_caches.values()))
        bi, blk = next(iter(cache.blocks.items()))
        assert victim in cache.lane_of
        shard.paged.pop(victim)                  # an LRU drop mid-flight
        shard.bump_removal_epoch()
        with jax.disable_jit():
            assert cache._build(bi, blk.lanes) is None
            assert victim not in cache.lane_of
            assert cache._build(bi, blk.lanes) is not None


@pytest.mark.parametrize("metric", ["qm"])
def test_grid_over_paged_partitions_after_restart(tmp_path, metric):
    """A restart with nothing left to replay: every partition is
    index-only, the first hit pages all in through the bulk path, and
    the grid serves the repeat hit in both packages."""
    (j, jshard), (t, tshard) = stores(tmp_path)
    containers, _ = gauge_containers(metric, 5, N_ROWS, seed=3,
                                     jitter=False)
    feed(containers, jshard, tshard)
    jshard.flush_all()
    tshard.flush_all()
    (j2, jshard), (t2, tshard) = stores(tmp_path)
    assert t2.recover_index("prom", 0) == j2.recover_index("prom", 0) == 5
    assert tshard.num_partitions == 0
    jids, tids = _ids(jshard, tshard, metric)
    # the first grid attempt cannot resolve an index-only partition
    assert _grid_both(jshard, tshard, jids, tids, T0 + 120_000, 30) is None
    assert_same_batch(*scan_both(jshard, tshard, metric))
    assert tshard.stats.partitions_paged == 5
    assert _grid_both(jshard, tshard, jids, tids, T0 + 120_000, 30) \
        is not None
    assert_same_stats(jshard, tshard)


def test_block_staged_below_the_floor_restages_once_paged(tmp_path):
    """A block staged while some residents held only their tail has no
    rows below the disk floor.  After every partition is evicted and
    paged back whole, the floor drops and the port stages that block
    anew, so the repeat hit equals the general path.  (The JAX package
    keeps the block, only the plans are invalidated, and serves the
    missing rows as absent: its grid answer differs from its own general
    path here.)"""
    from filodb_tpu.ops.windows import StepRange
    from filodb_tpu.query import rangefns
    from filodb_tpu.core.record import RecordBuilder
    from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
    jshard, tshard, truth, end = _recovered_tails(tmp_path, "sb", 9)
    jshard.flush_all()
    tshard.flush_all()
    jids, tids = _ids(jshard, tshard, "sb")
    floor = max(p.earliest_timestamp for p in tshard.partitions.values())
    tail = min(p.earliest_timestamp for p in tshard.partitions.values())
    # the tail above the floor: block 0 staged from the residents
    assert _grid_both(jshard, tshard, jids, tids,
                      floor + WINDOW + STEP, 20) is not None
    # one more row: the eviction freezes it (a block above block 0 goes
    # stale, and the ingest epoch moves so the floor is recomputed)
    b = RecordBuilder(J_SCHEMAS["gauge"])
    for inst, (ts, vals) in truth.items():
        b.add(int(ts[-1]) + STEP, [float(vals[-1]) + 1.0],
              {"__name__": "sb", "job": "app", "instance": inst,
               "_ws_": "demo", "_ns_": "ns"})
    feed(b.containers(), jshard, tshard, offset0=end)
    assert jshard.evict_partitions(6) == tshard.evict_partitions(6) == 6
    jgot, tgot = scan_both(jshard, tshard, "sb")        # pages in
    assert_same_batch(jgot, tgot)
    h_steps0 = tail + WINDOW + STEP
    h_n = (T0 + 199 * STEP - h_steps0) // STEP + 1
    with jax.disable_jit():
        want = jshard.scan_grid(jids, JF.RATE, h_steps0, h_n, STEP, WINDOW)
    got = tshard.scan_grid(tids, F.RATE, h_steps0, h_n, STEP, WINDOW)
    assert got is not None and want is not None
    sr = StepRange(h_steps0, h_steps0 + (h_n - 1) * STEP, STEP)
    general = np.asarray(rangefns.apply_range_function(
        jgot[1], sr, WINDOW, JF.RATE))[:len(jgot[0])]
    order = [jgot[0].index(tg) for tg in got[0]]
    assert_close(got[1], general[order], False, 1e-9, "rate")
    assert not np.allclose(np.asarray(want[1]), general[order],
                           rtol=1e-6, equal_nan=True)


def test_disk_floor_is_the_requested_partitions_own(tmp_path):
    """The disk floor over one set of partitions is not another set's.
    A query over the long tails (floor at row 60) is served by the grid;
    a query in the same ingest epoch over the short tails (floor at row
    100) reaching below row 100 must refuse it, and the general path
    backfills.  The port memoizes the floor per set of partitions and
    refuses; the JAX package memoizes it per ingest epoch alone, serves
    the second query from the grid with the rows below row 100 missing,
    and its grid answer differs from its own general path."""
    from filodb_tpu.ops.windows import StepRange
    from filodb_tpu.query import rangefns
    jshard, tshard, _truth, _end = _recovered_tails(tmp_path, "fs",
                                                    11)
    jids, tids = _ids(jshard, tshard, "fs")
    first = {pid: tshard.partitions[int(pid)].earliest_timestamp
             for pid in tids}
    long_t = T0 + 60 * STEP
    long_ids = np.array([p for p in tids if first[p] == long_t])
    short_ids = np.array([p for p in tids if first[p] > long_t])
    assert len(long_ids) and len(short_ids)
    steps0 = long_t + WINDOW + STEP
    n = (T0 + 199 * STEP - steps0) // STEP + 1
    assert _grid_both(jshard, tshard, long_ids, long_ids, steps0, n) \
        is not None
    epoch = (tshard.ingest_epoch, tshard.removal_epoch)
    got = tshard.scan_grid(short_ids, F.RATE, steps0, n, STEP, WINDOW)
    assert got is None, "the port served below the short tails' floor"
    with jax.disable_jit():
        want = jshard.scan_grid(short_ids, JF.RATE, steps0, n, STEP, WINDOW)
    assert want is not None
    assert (tshard.ingest_epoch, tshard.removal_epoch) == epoch
    jgot = jshard.scan_batch(list(short_ids), 0, 2**62)
    tgot = tshard.scan_batch(list(short_ids), 0, 2**62)
    assert_same_batch(jgot, tgot)
    sr = StepRange(steps0, steps0 + (n - 1) * STEP, STEP)
    general = np.asarray(rangefns.apply_range_function(
        jgot[1], sr, WINDOW, JF.RATE))[:len(jgot[0])]
    order = [jgot[0].index(tg) for tg in want[0]]
    assert not np.allclose(np.asarray(want[1]), general[order],
                           rtol=1e-6, equal_nan=True)


def test_page_cache_below_the_working_set_refuses_the_grid(tmp_path):
    """D4's sequence with a page cache at the default's share of the
    durable store's working set (256 MB of 481 MB): after an eviction
    the partitions no longer fit, the page cache drops some as it fills,
    and neither package serves the repeat hit from the grid; both
    answer through the general path, the same samples bit for bit."""
    (_j, jshard), (_t, tshard) = _paged(tmp_path, "uc", 6)
    work = tshard.paged._bytes
    assert work == jshard.paged._bytes and work > 0
    (j2, jshard), (t2, tshard) = stores(
        tmp_path, name="a", page_cache_bytes=work * 256 // 481)
    assert t2.recover_index("prom", 0) == j2.recover_index("prom", 0) == 6
    jids, tids = _ids(jshard, tshard, "uc")
    for _ in range(2):
        assert_same_batch(*scan_both(jshard, tshard, "uc"))
        _settle(jshard, tshard)
        assert len(tshard.paged) == len(jshard.paged) < 6
        assert _grid_both(jshard, tshard, jids, tids, T0 + 120_000, 30) \
            is None
    assert tshard.stats.partitions_paged == jshard.stats.partitions_paged
    assert tshard.stats.partitions_paged > 6
    assert_same_stats(jshard, tshard)
