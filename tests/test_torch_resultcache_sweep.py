"""The port's result cache against the JAX package's: the generative
sweep of the JAX package's tests/test_resultcache.py (4 seeds), both
packages fed one stream (the port's memstore on the CPU) of ingest
between refreshes, flush boundaries, new series with OLD timestamps,
quarantine events and shard status transitions:

- in the port, cached answers BIT-equal (NaN masks included) to
  uncached ones, range and instant, every round;
- the port's answers against the JAX package's (uncached: its own sweep
  holds its cache to that) at each seed's last round, with the same
  label sets, NaN positions equal and finite values within rtol 1e-9 /
  atol 1e-12 (tests/test_torch_query.py's bound);
- the sweep sees hits and misses, and the byte ledger reconciles."""

import numpy as np
import pytest
import torch

from tests.torch_resultcache_data import (BASE, Harness, assert_bit_equal,
                                          assert_close_across,
                                          assert_pairs_close,
                                          clear_quarantines, close_all,
                                          instant_pairs)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _close_harnesses():
    clear_quarantines()
    made: list = []
    yield made
    close_all(made)


SWEEP_QUERIES = [
    "rate(m_total{_ws_=\"w\"}[5s])",
    "sum(rate(m_total{_ws_=\"w\"}[5s]))",
    "sum by (inst) (rate(m_total{_ws_=\"w\"}[5s]))",
    "avg(rate(m_total{_ws_=\"w\"}[5s]))",
    "max(increase(m_total{_ws_=\"w\"}[6s]))",
]

INSTANT_QUERIES = [
    "rate(m_total{_ws_=\"w\"}[10s])",
    "sum(rate(m_total{_ws_=\"w\"}[10s]))",
    "sum by (inst) (rate(m_total{_ws_=\"w\"}[10s]))",
]


# the round whose answers are also held to the JAX package's (its
# compiles of every new shape dominate the file's time)
JAX_ROUNDS = (5,)


@pytest.mark.parametrize("seed", range(4))
def test_generative_equivalence_sweep(seed, _close_harnesses):
    """The port's cached answers bit-equal to its uncached ones; the
    JAX package runs the same stream uncached (its own sweep holds its
    cache to that), and the port's answers hold to the JAX package's."""
    rng = np.random.default_rng(seed)
    hs = {pkg: Harness(pkg, num_shards=2, segment_ms=8_000,
                       doorkeeper=True) for pkg in ("jax", "torch")}
    _close_harnesses.extend(hs.values())
    series = [({"inst": f"i{i}", "_ws_": "w"}, i + 1) for i in range(4)]
    counters_ = {f"i{i}": 0.0 for i in range(4)}

    def ingest(*a):
        for h in hs.values():
            h.ingest(*a)

    def flush():
        for h in hs.values():
            h.flush()

    def grow(tags_rate, ts):
        rows = []
        for tags, r in tags_rate:
            inst = tags["inst"]
            vals = []
            for _t in ts:
                counters_[inst] = counters_.get(inst, 0.0) \
                    + r * (1 + rng.integers(0, 3))
                vals.append(counters_[inst])
            rows.append((tags, np.asarray(vals)))
        ingest("m_total", rows, ts)

    # 40s of history, flushed (immutable chunks to memoize)
    grow(series, BASE + np.arange(40, dtype=np.int64) * 1000)
    flush()
    th, jh = hs["torch"], hs["jax"]
    now = BASE + 40_000
    for rnd in range(6):
        ts = now + np.arange(5, dtype=np.int64) * 1000
        grow(series, ts)
        now = int(ts[-1]) + 1000
        roll = rng.random()
        if roll < 0.35:
            flush()                        # chunk flush boundary
        if roll < 0.2:
            # a NEW series materializing with OLD timestamps — the
            # late-arrival case warm state cannot see by delta alone
            tag = {"inst": f"late{rnd}", "_ws_": "w"}
            old = now - 20_000 + np.arange(8, dtype=np.int64) * 1000
            ingest("m_total", [(tag, np.cumsum(
                rng.integers(1, 4, size=8)).astype(np.float64))], old)
            series.append((tag, 1))
        if 0.2 <= roll < 0.3:
            # quarantine a flushed chunk mid-refresh
            assert th.quarantine_first_chunk() == jh.quarantine_first_chunk()
        if 0.3 <= roll < 0.4:
            # a status transition mid-refresh: the routing token changes
            for h in hs.values():
                h.mapper.update_status(0, h.m.ShardStatus.RECOVERY)
                h.mapper.update_status(0, h.m.ShardStatus.ACTIVE)
        start, step, end = now - 30_000, 1000, now
        for q in SWEEP_QUERIES:
            ctx = f"seed={seed} rnd={rnd} q={q}"
            cold = th.eval_range(th.plain, q, start, step, end)
            warm1 = th.eval_range(th.cached, q, start, step, end)
            assert_bit_equal(th, cold, warm1, ctx)
            warm2 = th.eval_range(th.cached, q, start, step, end)
            assert_bit_equal(th, cold, warm2, f"{ctx} (2nd)")
            if rnd in JAX_ROUNDS:
                assert_close_across(jh.eval_range(jh.plain, q, start, step,
                                                  end), jh, warm2, th, ctx)
        for q in INSTANT_QUERIES:
            ctx = f"seed={seed} rnd={rnd} q={q}"
            cold = instant_pairs(th.eval_instant(th.plain, q, now), now,
                                 th.m.PeriodicBatch)
            warm = instant_pairs(th.eval_instant(th.cached, q, now), now,
                                 th.m.PeriodicBatch)
            assert cold == warm, ctx
            if rnd in JAX_ROUNDS:
                jres = jh.eval_instant(jh.plain, q, now)
                assert_pairs_close(instant_pairs(jres, now,
                                                 jh.m.PeriodicBatch),
                                   warm, ctx)
    # the sweep must have exercised actual cache traffic
    assert th.cache.hits > 0 and th.cache.misses > 0
    accounted, walked = th.cache.reconcile()
    assert accounted == walked
