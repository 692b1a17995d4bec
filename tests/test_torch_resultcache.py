"""The port's result cache (``filodb_tpu_torch.query.resultcache``) against
the JAX package's, one counterpart for each case of the JAX package's
tests/test_resultcache.py, both packages fed the same stream (the port's
memstore on the CPU):

- (the generative sweep is tests/test_torch_resultcache_sweep.py's);
- invalidation by the quarantine epoch, by a status transition (the
  routing token) and by a new chunk in an old segment;
- the open head segment's stable prefix, with its tail mutating and
  with late old timestamps;
- the rollup boundary moving under the cache (the cache below the
  router);
- the fingerprint allowlist and ``logical_plan_to_promql``, string for
  string against the JAX package's;
- LRU byte accounting with ``reconcile``, the doorkeeper, the disabled
  pass-through, and the metric family;
- the shard's ``chunk_span_table`` and ``mutable_floor`` equal to the
  JAX shard's on the same ingest, over paged partitions too.

The port's cached answers are BIT-equal (NaN masks included) to its
uncached ones, and within rtol 1e-9 / atol 1e-12 of the JAX package's
with the same label sets and NaN positions (tests/test_torch_query.py's
bound).  The cache's own counters (hits, misses, skips, invalidations,
entries) equal the JAX cache's on every case: the two take the same
decisions.
Not mirrored: ``test_tier_watermarks_store`` and the health-payload test
(the status poller, with the serving shell) and the admin/config route
test (the HTTP surface, with the serving shell)."""

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator import planners as jplanners
from filodb_tpu.promql.parser import ParseError as JParseError
from filodb_tpu.promql.parser import \
    query_range_to_logical_plan as jparse_range
from filodb_tpu_torch.coordinator import planners
from filodb_tpu_torch.promql.parser import ParseError
from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
from tests.torch_resultcache_data import (BASE, DS, Harness,
                                          assert_bit_equal,
                                          assert_close_across,
                                          clear_quarantines, close_all,
                                          assert_pairs_close, instant_pairs,
                                          series_map)

torch.set_num_threads(1)


def both(**kw) -> dict:
    return {pkg: Harness(pkg, **kw) for pkg in ("jax", "torch")}


@pytest.fixture(autouse=True)
def _close_harnesses():
    clear_quarantines()
    made: list = []
    yield made
    close_all(made)


def counters(h) -> tuple:
    c = h.cache
    return (c.hits, c.misses, c.skips, c.invalidations,
            c.snapshot()["entries"])


def assert_same_decisions(hs: dict) -> None:
    assert counters(hs["torch"]) == counters(hs["jax"])


# ---------------------------------------------------------------------------
# invalidation proofs (one per epoch source)
# ---------------------------------------------------------------------------


def _seeded(made, segment_ms=8_000, seconds=40, **kw) -> dict:
    hs = both(segment_ms=segment_ms, **kw)
    made.extend(hs.values())
    ts = BASE + np.arange(seconds, dtype=np.int64) * 1000
    for h in hs.values():
        h.ingest("m_total", [({"inst": "a", "_ws_": "w"},
                              np.cumsum(np.ones(seconds))),
                             ({"inst": "b", "_ws_": "w"},
                              np.cumsum(np.ones(seconds)) * 3)], ts)
        h.flush()
    return hs


Q = "sum(rate(m_total{_ws_=\"w\"}[5s]))"


def _range_both(hs, planner: str, q=Q, start=BASE + 6_000, step=1000,
                end=BASE + 36_000) -> dict:
    return {pkg: h.eval_range(getattr(h, planner), q, start, step, end)
            for pkg, h in hs.items()}


def _check_against_plain_and_jax(hs, got: dict, ctx="", **kw) -> None:
    """The port's cached answer bit-equal to its plain one, and within
    tolerance of the JAX package's cached answer."""
    th, jh = hs["torch"], hs["jax"]
    plain = _range_both({"torch": th}, "plain", **kw)["torch"]
    assert_bit_equal(th, plain, got["torch"], ctx)
    assert_close_across(got["jax"], jh, got["torch"], th, ctx)


def test_warm_range_hits_and_samples_scanned_reduction(_close_harnesses):
    hs = _seeded(_close_harnesses, segment_ms=5_000, seconds=120)
    # deliberately misaligned to the segment grid (the dashboard shape):
    # the partial first/last segments recompute, everything else hits
    kw = dict(start=BASE + 6_000, end=BASE + 116_000)
    cold = _range_both(hs, "cached", **kw)
    warm = _range_both(hs, "cached", **kw)
    t = hs["torch"]
    assert cold["torch"].stats.samples_scanned > 0
    assert t.cache.hits > 0
    # >= 10x fewer samples scanned on the second evaluation
    assert warm["torch"].stats.samples_scanned * 10 \
        <= cold["torch"].stats.samples_scanned
    assert warm["torch"].stats.resultcache_cached_samples > 0
    assert warm["torch"].stats.resultcache_recomputed_samples == \
        warm["torch"].stats.samples_scanned
    for key in ("resultcache_cached_samples",
                "resultcache_recomputed_samples"):
        assert getattr(warm["torch"].stats, key) == \
            getattr(warm["jax"].stats, key)
    _check_against_plain_and_jax(hs, warm, **kw)
    assert_same_decisions(hs)


def test_quarantine_epoch_invalidates(_close_harnesses):
    hs = _seeded(_close_harnesses)
    _range_both(hs, "cached")
    warm = _range_both(hs, "cached")
    assert hs["torch"].cache.hits > 0
    inv0 = hs["torch"].cache.invalidations
    for h in hs.values():
        sh = h.ms.shards(DS)[0]
        part = next(p for p in sh.partitions.values() if p.chunks)
        info = part.chunks[0].info
        assert h.m.integrity.QUARANTINE.quarantine(
            part.partkey, info.chunk_id, dataset=DS, shard=sh.shard_num,
            start_time=info.start_time, end_time=info.end_time,
            reason="test")
    after = _range_both(hs, "cached")
    th = hs["torch"]
    assert th.cache.invalidations > inv0
    _check_against_plain_and_jax(hs, after)
    plain = th.eval_range(th.plain, Q, BASE + 6_000, 1000, BASE + 36_000)
    # warning parity: both sides exclude the quarantined chunk
    assert after["torch"].stats.corrupt_chunks_excluded == \
        plain.stats.corrupt_chunks_excluded > 0
    # the invalidation changed the bytes served
    assert series_map(warm["torch"], th.m.PeriodicBatch) != \
        series_map(after["torch"], th.m.PeriodicBatch)
    assert_same_decisions(hs)


def test_replica_transition_invalidates(_close_harnesses):
    hs = _seeded(_close_harnesses)
    _range_both(hs, "cached")
    _range_both(hs, "cached")
    assert hs["torch"].cache.hits > 0
    inv0 = hs["torch"].cache.invalidations
    tok0 = hs["torch"].mapper.routing_token()
    for h in hs.values():
        h.mapper.update_status(1, h.m.ShardStatus.RECOVERY)
    assert hs["torch"].mapper.routing_token() != tok0
    after = _range_both(hs, "cached")
    assert hs["torch"].cache.invalidations > inv0
    _check_against_plain_and_jax(hs, after)
    assert_same_decisions(hs)


def test_new_chunk_in_old_segment_invalidates(_close_harnesses):
    hs = _seeded(_close_harnesses)
    _range_both(hs, "cached")
    hits0 = hs["torch"].cache.hits
    _range_both(hs, "cached")
    assert hs["torch"].cache.hits > hits0
    # a brand-new series lands with OLD timestamps inside cached
    # segments, then flushes: the chunk digest changes
    old = BASE + 10_000 + np.arange(10, dtype=np.int64) * 1000
    for h in hs.values():
        h.ingest("m_total", [({"inst": "late", "_ws_": "w"},
                              np.cumsum(np.ones(10)))], old)
        h.flush()
    after = _range_both(hs, "cached")
    _check_against_plain_and_jax(hs, after)
    assert hs["torch"].cache.invalidations > 0
    assert_same_decisions(hs)


def test_instant_window_incremental_and_series_reset(_close_harnesses):
    hs = _seeded(_close_harnesses)
    th, jh = hs["torch"], hs["jax"]
    t0 = BASE + 40_000
    q = "sum(rate(m_total{_ws_=\"w\"}[20s]))"
    cold = {p: h.eval_instant(h.cached, q, t0) for p, h in hs.items()}
    assert cold["torch"].stats.samples_scanned > 0
    # refresh with only a head sliver of new data
    ts = t0 + np.arange(3, dtype=np.int64) * 1000
    for h in hs.values():
        h.ingest("m_total", [({"inst": "a", "_ws_": "w"},
                              np.array([41.0, 42.0, 43.0])),
                             ({"inst": "b", "_ws_": "w"},
                              np.array([123.0, 126.0, 129.0]))], ts)
    t1 = int(ts[-1])
    warm = {p: h.eval_instant(h.cached, q, t1) for p, h in hs.items()}
    assert warm["torch"].stats.samples_scanned * 5 \
        <= cold["torch"].stats.samples_scanned
    assert warm["torch"].stats.resultcache_cached_samples > 0
    for key in ("samples_scanned", "resultcache_cached_samples",
                "resultcache_recomputed_samples"):
        assert getattr(warm["torch"].stats, key) == \
            getattr(warm["jax"].stats, key), key
    # the resident window's bytes are tracked through resize()
    accounted, walked = th.cache.reconcile()
    assert accounted == walked > 1024
    assert (accounted, walked) == jh.cache.reconcile()
    pb = th.m.PeriodicBatch
    assert instant_pairs(warm["torch"], t1, pb) == \
        instant_pairs(th.eval_instant(th.plain, q, t1), t1, pb)
    assert_pairs_close(instant_pairs(warm["jax"], t1, jh.m.PeriodicBatch),
                 instant_pairs(warm["torch"], t1, pb), "warm")
    # a new series appearing resets the window state (pid signature)
    for h in hs.values():
        h.ingest("m_total", [({"inst": "c", "_ws_": "w"},
                              np.cumsum(np.ones(15)))],
                 t1 - 14_000 + np.arange(15, dtype=np.int64) * 1000)
    inv0 = th.cache.invalidations
    t2 = t1 + 1000
    after = {p: h.eval_instant(h.cached, q, t2) for p, h in hs.items()}
    assert th.cache.invalidations > inv0
    assert instant_pairs(after["torch"], t2, pb) == \
        instant_pairs(th.eval_instant(th.plain, q, t2), t2, pb)
    assert_pairs_close(instant_pairs(after["jax"], t2, jh.m.PeriodicBatch),
                 instant_pairs(after["torch"], t2, pb), "after")
    assert_same_decisions(hs)


def test_instant_results_stay_on_the_query_device(_close_harnesses):
    """An instant window's answer is a tensor on the memstore's device,
    as every plan's is; the range cache's memoized batches too."""
    hs = _seeded(_close_harnesses)
    th = hs["torch"]
    for q in ("rate(m_total{_ws_=\"w\"}[20s])",
              "sum(rate(m_total{_ws_=\"w\"}[20s]))"):
        res = th.eval_instant(th.cached, q, BASE + 40_000)
        assert res.batches and all(
            isinstance(b.values, torch.Tensor)
            and b.values.device == th.ms.device for b in res.batches)
    _range_both(hs, "cached")
    entries = list(th.cache._entries.values())
    stored = [b for e in entries for b in getattr(e, "batches", [])]
    assert stored and all(isinstance(b.values, torch.Tensor)
                          and b.values.device == th.ms.device
                          for b in stored)


# ---------------------------------------------------------------------------
# fingerprint gating + LRU/byte accounting
# ---------------------------------------------------------------------------

FP_QUERIES = [
    "rate(m[5s])",
    "sum by (inst) (rate(m[5s]))",
    "histogram_quantile(0.99, sum by (le) (rate(m[1m])))",
    "sum(rate(m[5s])) * 2",
    "2 * sum(rate(m[5s]))",
    "avg without (inst) (rate(m{a=\"b\",c=~\"d.*\"}[90s]))",
    "clamp_max(rate(m[5s]), 3)",
    "topk(3, rate(m[5s]))",
    "rate(m[5s] offset 1m)",
    "a / b",
    "quantile(0.5, rate(m[5s]))",
    "m",
    "max_over_time(m[1m])",
    "stddev(m{x!=\"y\"})",
    "sum(rate(m[5s])) > bool 1",
    "time()",
]


def _fp(plan_fn, fp_fn, promql, start=BASE, step=1000, end=BASE + 60_000):
    plan = plan_fn(promql, start, step, end)
    return fp_fn(plan, step, start)


def test_fingerprint_allowlist_as_jax():
    from filodb_tpu.query.resultcache import plan_fingerprint as jfp
    from filodb_tpu_torch.query.resultcache import plan_fingerprint as tfp

    def fp(q, **kw):
        t = _fp(query_range_to_logical_plan, tfp, q, **kw)
        assert t == _fp(jparse_range, jfp, q, **kw), q
        return t

    for q in FP_QUERIES:
        fp(q)
    assert fp("rate(m[5s])") is not None
    assert fp("sum by (inst) (rate(m[5s]))") is not None
    assert fp("histogram_quantile(0.99, sum by (le) (rate(m[1m])))") \
        is not None
    assert fp("sum(rate(m[5s])) * 2") is not None
    # rank-based reduces, offsets, and joins are excluded
    assert fp("topk(3, rate(m[5s]))") is None
    assert fp("rate(m[5s] offset 1m)") is None
    assert fp("a / b") is None
    assert fp("quantile(0.5, rate(m[5s]))") is None
    # step/phase are part of the key: a shifted grid never collides
    assert fp("rate(m[5s])", step=1000) != fp("rate(m[5s])", step=2000)
    assert fp("rate(m[5s])", start=BASE) != \
        fp("rate(m[5s])", start=BASE + 500)


PROMQL_RENDER = FP_QUERIES + [
    'a + on (job) group_left (inst) b',
    'a / ignoring (code) b',
    'a > bool 3',
    '2 < a',
    'a and b',
    'a or on (g) b',
    'a unless ignoring (x) b',
    'sum without (instance) (rate(m[5m]))',
    'count_values("v", m)',
    'quantile_over_time(0.9, m[10m] offset 1h)',
    'holt_winters(m[10m], 0.3, 0.1)',
    'predict_linear(m{a=~"x.*",b!="y",c!~"z"}[5m], 600)',
    'label_replace(m, "dst", "$1", "src", "(.*)")',
    'scalar(sum(m)) * vector(2) - time()',
    'absent(up{job="x"})',
    'sort_desc(clamp_max(m, 10))',
    'hour() + minute(m)',
    'round(m, 0.5)',
    'm offset -5m',
    'rate(m[1500ms])',
    'z_score(m[2m])',
    'timestamp(m)',
]


@pytest.mark.parametrize("q", PROMQL_RENDER)
def test_logical_plan_to_promql_as_jax(q):
    """The canonical rendering the fingerprint rests on: string for
    string the JAX package's, or the same refusal."""
    def render(parse, mod, err):
        try:
            plan = parse(q, BASE, 10_000, BASE + 600_000)
        except err:
            return "parse error"
        try:
            return mod.logical_plan_to_promql(plan)
        except ValueError as e:
            return f"ValueError: {e}"
    assert render(query_range_to_logical_plan, planners, ParseError) == \
        render(jparse_range, jplanners, JParseError)


def test_lru_byte_accounting_reconciles_and_evicts(_close_harnesses):
    hs = _seeded(_close_harnesses, max_bytes=3_000, segment_ms=5_000,
                 seconds=60)
    kw = dict(start=BASE + 6_000, end=BASE + 56_000)
    for metric in ("a", "b"):
        q = f"rate(m_total{{_ws_=\"w\",inst=\"{metric}\"}}[5s])"
        _range_both(hs, "cached", q=q, **kw)
        _range_both(hs, "cached", **kw)
    th = hs["torch"]
    accounted, walked = th.cache.reconcile()
    assert accounted == walked
    assert accounted <= th.cache.max_bytes
    assert th.cache.evictions > 0
    assert th.cache.evictions == hs["jax"].cache.evictions
    assert th.cache.reconcile() == hs["jax"].cache.reconcile()
    assert_same_decisions(hs)
    th.cache.clear()
    assert th.cache.reconcile() == (0, 0)


def test_entry_bytes_count_tensor_bytes():
    """A memoized batch's values count whether they live on the host or
    on a device: a tensor's bytes as an array's."""
    from filodb_tpu_torch.ops.windows import StepRange
    from filodb_tpu_torch.query.model import PeriodicBatch
    from filodb_tpu_torch.query.resultcache import _entry_bytes
    steps = StepRange(0, 9_000, 1000)
    arr = np.zeros((3, 10))
    host = PeriodicBatch([{}] * 3, steps, arr)
    dev = PeriodicBatch([{}] * 3, steps, torch.zeros(3, 10,
                                                     dtype=torch.float32))
    assert _entry_bytes([host]) == (256 + arr.nbytes + 64 * 3, 30)
    assert _entry_bytes([dev]) == (256 + 3 * 10 * 4 + 64 * 3, 30)


def test_doorkeeper_admits_only_repeating_fingerprints(_close_harnesses):
    """First sight of a fingerprint passes through untouched; the second
    sighting populates, the third hits."""
    hs = _seeded(_close_harnesses, doorkeeper=True)
    th = hs["torch"]
    r1 = _range_both(hs, "cached")
    assert th.cache.snapshot()["entries"] == 0
    assert th.cache.misses == 0
    r2 = _range_both(hs, "cached")
    assert th.cache.snapshot()["entries"] > 0
    hits0 = th.cache.hits
    r3 = _range_both(hs, "cached")
    assert th.cache.hits > hits0
    for r in (r1, r2, r3):
        _check_against_plain_and_jax(hs, r)
    assert_same_decisions(hs)
    # a clear() flushes entries but keeps the admission evidence
    th.cache.clear()
    th.eval_range(th.cached, Q, BASE + 6_000, 1000, BASE + 36_000)
    assert th.cache.snapshot()["entries"] > 0


def test_disabled_cache_is_pass_through(_close_harnesses):
    hs = _seeded(_close_harnesses)
    th = hs["torch"]
    th.cache.configure(enabled=False)
    from filodb_tpu_torch.query.resultcache import _m
    bypass0 = _m()["bypass"].value(dataset=DS, reason="disabled")
    r1 = th.eval_range(th.cached, Q, BASE + 6_000, 1000, BASE + 36_000)
    r2 = th.eval_range(th.cached, Q, BASE + 6_000, 1000, BASE + 36_000)
    assert th.cache.hits == 0 and th.cache.misses == 0
    assert _m()["bypass"].value(dataset=DS, reason="disabled") == bypass0 + 2
    assert_bit_equal(th, r1, r2)
    plain = th.eval_range(th.plain, Q, BASE + 6_000, 1000, BASE + 36_000)
    assert_bit_equal(th, plain, r1)
    snap = th.cache.snapshot()
    assert snap["entries"] == 0 and not snap["enabled"]


# ---------------------------------------------------------------------------
# head-segment stable prefix: a warm dashboard's OPEN head segment
# replays its stable prefix and recomputes only the mutable sliver
# ---------------------------------------------------------------------------


def _seeded_open_head(made, segment_ms=8_000, flushed=35, buffered=8):
    """Flushed history + an UNFLUSHED (write-buffer) tail starting
    INSIDE the head segment (seg [32s, 40s), floor at 35s)."""
    hs = both(segment_ms=segment_ms)
    made.extend(hs.values())
    ts = BASE + np.arange(flushed, dtype=np.int64) * 1000
    ts2 = BASE + (flushed + np.arange(buffered, dtype=np.int64)) * 1000
    for h in hs.values():
        h.ingest("m_total", [({"inst": "a", "_ws_": "w"},
                              np.cumsum(np.ones(flushed))),
                             ({"inst": "b", "_ws_": "w"},
                              np.cumsum(np.ones(flushed)) * 3)], ts)
        h.flush()
        h.ingest("m_total", [({"inst": "a", "_ws_": "w"},
                              flushed + np.cumsum(np.ones(buffered))),
                             ({"inst": "b", "_ws_": "w"},
                              (flushed + np.cumsum(np.ones(buffered)))
                              * 3)], ts2)
    return hs


HEAD = dict(start=BASE + 2_000, end=BASE + 38_000)


def test_open_head_segment_serves_stable_prefix(_close_harnesses):
    hs = _seeded_open_head(_close_harnesses)
    th = hs["torch"]
    cold = _range_both(hs, "cached", **HEAD)
    snap = th.cache.snapshot()
    assert snap["head_windows"], \
        "cold evaluation should memoize the head segment's stable prefix"
    assert [(w["segment"], w["stable_hi"]) for w in snap["head_windows"]] \
        == [(w["segment"], w["stable_hi"])
            for w in hs["jax"].cache.snapshot()["head_windows"]]
    hits0 = th.cache.hits
    warm = _range_both(hs, "cached", **HEAD)
    assert th.cache.hits > hits0
    _check_against_plain_and_jax(hs, warm, **HEAD)
    # only the sliver above the stable prefix recomputes
    assert warm["torch"].stats.samples_scanned < \
        cold["torch"].stats.samples_scanned
    from filodb_tpu_torch.query.resultcache import _m
    assert _m()["hits"].total() > 0
    assert_same_decisions(hs)


def test_open_head_stays_equal_as_tail_mutates(_close_harnesses):
    hs = _seeded_open_head(_close_harnesses, buffered=2)
    th = hs["torch"]
    _range_both(hs, "cached", **HEAD)
    assert th.cache.snapshot()["head_windows"]
    ts3 = BASE + (37 + np.arange(4, dtype=np.int64)) * 1000
    for h in hs.values():
        h.ingest("m_total", [({"inst": "a", "_ws_": "w"},
                              37 + np.cumsum(np.ones(4))),
                             ({"inst": "b", "_ws_": "w"},
                              (37 + np.cumsum(np.ones(4))) * 3)], ts3)
    hits0 = th.cache.hits
    after = _range_both(hs, "cached", **HEAD)
    assert th.cache.hits > hits0, "the stable prefix should still replay"
    _check_against_plain_and_jax(hs, after, **HEAD)
    assert_same_decisions(hs)


def test_open_head_prefix_invalidates_on_old_timestamps(_close_harnesses):
    hs = _seeded_open_head(_close_harnesses)
    th = hs["torch"]
    _range_both(hs, "cached", **HEAD)
    warm = _range_both(hs, "cached", **HEAD)
    assert th.cache.snapshot()["head_windows"]
    # a late series flushes chunks with OLD timestamps reaching into
    # the prefix input range: the stale prefix must be discarded
    old = BASE + np.arange(43, dtype=np.int64) * 1000
    for h in hs.values():
        h.ingest("m_total", [({"inst": "late", "_ws_": "w"},
                              np.cumsum(np.ones(43)) * 11)], old)
        h.flush()
    after = _range_both(hs, "cached", **HEAD)
    _check_against_plain_and_jax(hs, after, **HEAD)
    assert series_map(warm["torch"], th.m.PeriodicBatch) != \
        series_map(after["torch"], th.m.PeriodicBatch)
    assert_same_decisions(hs)


# ---------------------------------------------------------------------------
# rollup boundary composition: the cache sits BELOW the router
# ---------------------------------------------------------------------------


def test_rollup_boundary_movement_stays_equal(_close_harnesses):
    hs = both(segment_ms=5_000)
    _close_harnesses.extend(hs.values())
    n = 120
    ts = BASE + np.arange(n, dtype=np.int64) * 1000
    tier_ds = "prom_ds_5000"
    dec = np.arange(0, n, 5)
    routers = {}
    for pkg, h in hs.items():
        m = h.m
        h.ingest("m_total", [({"inst": "a", "_ws_": "w"},
                              np.cumsum(np.ones(n)))], ts)
        h.flush()
        for s in range(h.mapper.num_shards):
            h.ms.setup(tier_ds, m.DEFAULT_SCHEMAS, s)
        tier_plain = m.SingleClusterPlanner(tier_ds, h.mapper,
                                            m.DatasetOptions())
        tier_cache = m.resultcache.ResultCache(tier_ds, enabled=True)
        tier_cached = m.resultcache.ResultCachingPlanner(
            tier_ds, m.SingleClusterPlanner(tier_ds, h.mapper,
                                            m.DatasetOptions()),
            h.ms, tier_cache, segment_ms=5_000,
            routing_token_fn=h.mapper.routing_token)
        h.ingest("m_total", [({"inst": "a", "_ws_": "w"},
                              np.cumsum(np.ones(n))[dec])], ts[dec],
                 dataset=tier_ds)
        boundary = [BASE + 30_000]

        def mk_router(raw, tier, _b=boundary, _m=m):
            return _m.RollupRouterPlanner(
                DS, raw, {5000: tier}, rolled_through_fn=lambda r: _b[0])
        routers[pkg] = (mk_router(h.plain, tier_plain),
                        mk_router(h.cached, tier_cached), boundary,
                        tier_cache)
    q = "sum(rate(m_total{_ws_=\"w\"}[10s]))"
    start, step, end = BASE + 10_000, 5000, BASE + 110_000
    for bnd in (BASE + 30_000, BASE + 60_000, BASE + 90_000):
        got = {}
        for pkg, h in hs.items():
            m = h.m
            r_plain, r_cached, boundary, _tc = routers[pkg]
            boundary[0] = bnd
            plan = m.query_range_to_logical_plan(q, start, step, end)

            def run(r):
                return r.materialize(plan, m.QueryContext()).execute(
                    m.ExecContext(h.ms, m.QueryContext()))
            res_p, res_c, res_c2 = run(r_plain), run(r_cached), \
                run(r_cached)
            if pkg == "torch":
                assert_bit_equal(h, res_p, res_c, f"boundary={bnd}")
                assert_bit_equal(h, res_p, res_c2, f"boundary={bnd} (2nd)")
            got[pkg] = res_c2
        assert_close_across(got["jax"], hs["jax"], got["torch"],
                            hs["torch"], f"boundary={bnd}")
    th = hs["torch"]
    assert th.cache.hits + routers["torch"][3].hits > 0
    assert (th.cache.hits, routers["torch"][3].hits) == \
        (hs["jax"].cache.hits, routers["jax"][3].hits)


def test_one_step_stitch_leg_through_the_cache(_close_harnesses):
    """A router cuts its raw leg to one step when the tier's watermark
    reaches the range's last step: the raw planner's cache then serves a
    one-step RANGE plan through its instant window state.  The port's
    window state answers on the plan's own step, so the leg stitches and
    the answer is bit-equal to the uncached router's; the JAX package's
    answers on a 1 s step, and its stitch refuses the legs."""
    hs = both(segment_ms=5_000)
    _close_harnesses.extend(hs.values())
    n = 120
    ts = BASE + np.arange(n, dtype=np.int64) * 1000
    tier_ds = "prom_ds_5000"
    dec = np.arange(0, n, 5)
    q = "sum(rate(m_total{_ws_=\"w\"}[10s]))"
    start, step, end = BASE + 10_000, 5000, BASE + 110_000
    got = {}
    for pkg, h in hs.items():
        m = h.m
        for tags in ({"inst": "a", "_ws_": "w"}, {"inst": "b", "_ws_": "w"}):
            h.ingest("m_total", [(tags, np.cumsum(np.ones(n)))], ts)
        h.flush()
        for s_ in range(h.mapper.num_shards):
            h.ms.setup(tier_ds, m.DEFAULT_SCHEMAS, s_)
        h.ingest("m_total", [({"inst": "a", "_ws_": "w"},
                              np.cumsum(np.ones(n))[dec]),
                             ({"inst": "b", "_ws_": "w"},
                              np.cumsum(np.ones(n))[dec])], ts[dec],
                 dataset=tier_ds)
        tier = m.SingleClusterPlanner(tier_ds, h.mapper, m.DatasetOptions())

        def router(raw, _m=m, _t=tier):
            # rolled through the step before the last: the raw leg is
            # the range's last step alone
            return _m.RollupRouterPlanner(DS, raw, {5000: _t},
                                          rolled_through_fn=lambda r: end - 1)
        plan = m.query_range_to_logical_plan(q, start, step, end)

        def run(r):
            qctx = m.QueryContext()
            return r.materialize(plan, qctx).execute(m.ExecContext(h.ms,
                                                                   qctx))
        if pkg == "jax":
            with pytest.raises(Exception, match="mismatched steps"):
                run(router(h.cached))
            got[pkg] = run(router(h.plain))
            continue
        plain = run(router(h.plain))
        cold, warm = run(router(h.cached)), run(router(h.cached))
        assert_bit_equal(h, plain, cold, "cold")
        assert_bit_equal(h, plain, warm, "warm")
        assert h.cache.snapshot()["instant_windows"]
        assert h.cache.hits == 1 and h.cache.misses == 1
        got[pkg] = warm
    assert_close_across(got["jax"], hs["jax"], got["torch"], hs["torch"])


# ---------------------------------------------------------------------------
# metrics, planner and mapper hooks
# ---------------------------------------------------------------------------


def test_metrics_family(_close_harnesses):
    from filodb_tpu_torch.utils.observability import (REGISTRY,
                                                      resultcache_metrics)
    hs = _seeded(_close_harnesses)
    _range_both(hs, "cached")
    _range_both(hs, "cached")
    fam = resultcache_metrics()
    assert fam["hits"] is REGISTRY.counter("filodb_resultcache_hits_total")
    assert fam["hits"].value(dataset=DS, kind="range") > 0
    accounted, _walked = hs["torch"].cache.reconcile()
    assert fam["bytes"].value(dataset=DS) == accounted > 0
    names = {m.name for m in fam.values()}
    assert names == {"filodb_resultcache_hits_total",
                     "filodb_resultcache_misses_total",
                     "filodb_resultcache_skipped_total",
                     "filodb_resultcache_bytes",
                     "filodb_resultcache_evictions_total",
                     "filodb_resultcache_invalidations_total",
                     "filodb_result_cache_bypass_total"}


def test_plan_is_local_and_routing_token(_close_harnesses):
    """Every plan of the port's planner is local (every shard dispatches
    in process, as the JAX planner answers for in-process shards); the
    routing token moves with each status transition and comes back with
    the status."""
    hs = _seeded(_close_harnesses)
    for h in hs.values():
        plan = h.m.query_range_to_logical_plan(Q, BASE, 1000, BASE + 9_000)
        assert h.plain.plan_is_local(plan, h.m.QueryContext())
    mapper = hs["torch"].mapper
    st = hs["torch"].m.ShardStatus
    tok0 = mapper.routing_token()
    assert mapper.routing_token() == tok0
    seen = {tok0}
    for s in (st.RECOVERY, st.DOWN, st.ERROR):
        mapper.update_status(0, s)
        seen.add(mapper.routing_token())
    assert len(seen) == 4
    mapper.update_status(0, st.ACTIVE)
    assert mapper.routing_token() == tok0


def _span_tables_equal(jshard, tshard) -> int:
    jt, tt = jshard.chunk_span_table(), tshard.chunk_span_table()
    for a, b in zip(jt, tt):
        assert b.dtype == np.int64
        np.testing.assert_array_equal(b, a)
    assert tshard.mutable_floor() == jshard.mutable_floor()
    return len(tt[0])


def test_chunk_span_table_and_mutable_floor_as_jax(tmp_path):
    from tests.torch_odp_data import (feed, gauge_containers, scan_both,
                                      stores)
    (_j, jshard), (_t, tshard) = stores(tmp_path)
    spans, _truth = gauge_containers(n_rows=300, cuts=(100, 200))
    assert _span_tables_equal(jshard, tshard) == 0
    assert tshard.mutable_floor() is None
    feed(spans[0], jshard, tshard)
    # rows in the write buffers: the floor is their first sample
    assert _span_tables_equal(jshard, tshard) == 0
    assert tshard.mutable_floor() is not None
    for p in tshard.partitions.values():
        ts, _v = p.read_range(0, 2**62)
        assert p.mutable_floor() == int(np.asarray(ts)[0])
    assert tshard.flush_all() == jshard.flush_all() > 0
    n1 = _span_tables_equal(jshard, tshard)
    assert n1 > 0 and tshard.mutable_floor() is None
    epoch = tshard.freeze_epoch
    # a cached table is handed back while nothing froze
    assert tshard.chunk_span_table() is tshard.chunk_span_table()
    feed(spans[1], jshard, tshard, offset0=len(spans[0]))
    assert tshard.freeze_epoch == epoch
    _span_tables_equal(jshard, tshard)
    assert tshard.flush_all() == jshard.flush_all() > 0
    assert tshard.freeze_epoch > epoch
    assert _span_tables_equal(jshard, tshard) > n1
    # over paged partitions: evicted series leave the table (their
    # persisted chunks are immutable), paged back they are served from
    # the page cache, and both shards answer alike throughout
    assert tshard.evict_partitions(2) == jshard.evict_partitions(2) == 2
    _span_tables_equal(jshard, tshard)
    scan_both(jshard, tshard)
    for shard in (jshard, tshard):
        shard._join_materialize()
    assert len(tshard.paged) == len(jshard.paged) == 2
    _span_tables_equal(jshard, tshard)
    feed(spans[2], jshard, tshard,
         offset0=len(spans[0]) + len(spans[1]))
    _span_tables_equal(jshard, tshard)
    assert tshard.flush_all() == jshard.flush_all() > 0
    _span_tables_equal(jshard, tshard)
