"""The port's incremental window states (``filodb_tpu_torch.query.
windowstate``) against the JAX package's: the same fetch (numpy rows
generated from a seed, series born and vanishing, a series that empties
and resumes) drives both packages' ``WindowState`` and ``AggWindowState``
tick by tick; each tick's values are held to the JAX package's, NaN
positions equal and finite values within rtol 1e-9 / atol 1e-12
(tests/test_torch_query.py's bound), and the residency counters equal.
In the port, every warm tick is BIT-equal to a cold evaluation at the
same time (the invariant the result cache rests on).  Plus the shape
recognizers and ``batches_to_buckets`` over both packages' scans."""

import numpy as np
import pytest
import torch

from filodb_tpu.promql.parser import query_to_logical_plan as jparse
from filodb_tpu.query import logical as jlp
from filodb_tpu.query import windowstate as jws
from filodb_tpu_torch.promql.parser import query_to_logical_plan
from filodb_tpu_torch.query import logical as tlp
from filodb_tpu_torch.query import windowstate as tws
from tests.torch_resultcache_data import (BASE, Harness, clear_quarantines,
                                          close_all)

torch.set_num_threads(1)


class Stream:
    """Per-shard series of samples every second, with per-series phases
    (0-999 ms), counters that reset now and then, series born at
    ``born`` and stopped at ``dies`` (None = never), and one series with
    a gap in the middle."""

    def __init__(self, seed: int, shards: int = 2, n: int = 6):
        rng = np.random.default_rng(seed)
        self.rows: list[list] = [[] for _ in range(shards)]
        for i in range(n):
            phase = int(rng.integers(0, 1000))
            born = int(rng.integers(0, 30)) if i % 3 == 1 else 0
            dies = int(rng.integers(50, 80)) if i % 3 == 2 else None
            ts = BASE + np.arange(born, 120, dtype=np.int64) * 1000 + phase
            if dies is not None:
                ts = ts[ts < BASE + dies * 1000]
            if i == 0:                          # a gap of 30 s
                ts = ts[(ts < BASE + 40_000) | (ts >= BASE + 70_000)]
            vals = np.cumsum(rng.random(len(ts)) * (i + 1))
            if i % 2:
                vals[len(vals) // 2:] -= vals[len(vals) // 2] * 0.9
            tags = {"__name__": "m", "inst": f"i{i}", "g": f"g{i % 2}"}
            self.rows[i % shards].append((tags, ts, vals))

    def fetch_buckets(self, _filters, start: int, end: int) -> list:
        out = []
        for shard in self.rows:
            bucket = []
            for tags, ts, vals in shard:
                m = (ts >= start) & (ts <= end)
                if m.any():
                    bucket.append((dict(tags), ts[m].copy(),
                                   vals[m].copy()))
            out.append(bucket)
        return out

    def fetch_flat(self, f, start: int, end: int) -> list:
        return [r for b in self.fetch_buckets(f, start, end) for r in b]


def _spec(mod, parse, q):
    plan = parse(q, BASE)
    return mod.window_spec(plan), mod.agg_window_spec(plan)


def _pairs_map(pairs) -> dict:
    return {tuple(sorted(t.items())): v for t, v in pairs}


def _batch_map(batch) -> dict:
    if batch is None:
        return {}
    vals = batch.np_values() if hasattr(batch, "np_values") \
        else np.asarray(batch.values)[:len(batch.keys)]
    return {tuple(sorted(k.items())): float(vals[i, 0])
            for i, k in enumerate(batch.keys)}


def _close(got: dict, want: dict, ctx: str) -> None:
    assert set(got) == set(want), ctx
    for k in want:
        g, w = got[k], want[k]
        assert np.isnan(g) == np.isnan(w), (ctx, k)
        if not np.isnan(w):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{ctx}: {k}")


TICKS = [25_000 + 6_000 * i for i in range(16)] + [118_500, 119_999]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fn", ["rate", "increase", "sum_over_time",
                                "max_over_time", "count_over_time"])
def test_window_state_ticks_as_jax(seed, fn):
    s = Stream(seed)
    q = f"{fn}(m[20s])"
    jspec, _ = _spec(jws, jparse, q)
    tspec, _ = _spec(tws, query_to_logical_plan, q)
    assert tspec is not None and jspec is not None
    assert (tspec.window_ms, tspec.function.name, tspec.args) == \
        (jspec.window_ms, jspec.function.name, jspec.args)
    jst, tst = jws.WindowState(jspec), tws.WindowState(tspec)
    for t in TICKS:
        now = BASE + t
        want = _pairs_map(jst.tick(now, s.fetch_flat))
        got = _pairs_map(tst.tick(now, s.fetch_flat, device="cpu"))
        _close(got, want, f"{q} at {t}")
        assert (tst.resident_series, tst.resident_samples,
                tst.samples_consumed, tst.fetched_through_ms) == \
            (jst.resident_series, jst.resident_samples,
             jst.samples_consumed, jst.fetched_through_ms)
        # a warm tick is a cold evaluation's bits
        cold = tws.WindowState(tspec)
        assert _pairs_map(cold.tick(now, s.fetch_flat, device="cpu")) == got


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("q", ["sum(rate(m[20s]))",
                               "sum by (g) (increase(m[20s]))",
                               "avg without (inst) (rate(m[20s]))",
                               "max by (g) (sum_over_time(m[20s]))",
                               "count(rate(m[20s]))",
                               "stddev by (g) (rate(m[20s]))"])
def test_agg_window_state_ticks_as_jax(seed, q):
    s = Stream(seed)
    _, jspec = _spec(jws, jparse, q)
    _, tspec = _spec(tws, query_to_logical_plan, q)
    assert tspec is not None and jspec is not None
    assert (tspec.operator.name, tspec.by, tspec.without) == \
        (jspec.operator.name, jspec.by, jspec.without)
    jst, tst = jws.AggWindowState(jspec), tws.AggWindowState(tspec)
    for t in TICKS:
        now = BASE + t
        want = _batch_map(jst.tick(now, s.fetch_buckets))
        got_b = tst.tick(now, s.fetch_buckets, device="cpu")
        if got_b is not None:
            assert isinstance(got_b.values, torch.Tensor)
        got = _batch_map(got_b)
        _close(got, want, f"{q} at {t}")
        assert (tst.resident_series, tst.resident_samples,
                tst.samples_consumed) == \
            (jst.resident_series, jst.resident_samples,
             jst.samples_consumed)
        # tombstones keep every slot: the same slots as the JAX state's
        assert [list(b.series) for b in tst.buckets] == \
            [list(b.series) for b in jst.buckets]
        cold = tws.AggWindowState(tspec)
        c = _batch_map(cold.tick(now, s.fetch_buckets, device="cpu"))
        assert {k: float(v).hex() for k, v in c.items()} == \
            {k: float(v).hex() for k, v in got.items()}


def test_agg_window_state_fan_out_limits():
    s = Stream(3, shards=4)
    _, spec = _spec(tws, query_to_logical_plan, "sum(rate(m[20s]))")
    st = tws.AggWindowState(spec, max_buckets=3)
    with pytest.raises(tws.WindowUnsupported):
        st.tick(BASE + 30_000, s.fetch_buckets, device="cpu")
    # a fan-out that changes shape between ticks goes cold, as the JAX
    # state does
    _, jspec = _spec(jws, jparse, "sum(rate(m[20s]))")
    jst, tst = jws.AggWindowState(jspec), tws.AggWindowState(spec)
    two = Stream(3, shards=2)
    for fetch in (two.fetch_buckets, s.fetch_buckets):
        want = _batch_map(jst.tick(BASE + 40_000, fetch))
        got = _batch_map(tst.tick(BASE + 40_000, fetch, device="cpu"))
        _close(got, want, "fan-out")
        assert len(tst.buckets) == len(jst.buckets)


SHAPES = ["rate(m[5m])", "sum(rate(m[5m]))", "sum by (g) (rate(m[5m]))",
          "rate(m[5m] offset 1m)", "topk(2, rate(m[5m]))",
          "quantile(0.5, rate(m[5m]))", "m", "sum(m)",
          "max_over_time(m{a=\"b\"}[1m])", "rate(m[5m]) * 2",
          "histogram_quantile(0.9, sum by (le) (rate(h[5m])))",
          "sum without (inst) (deriv(m[5m]))"]


@pytest.mark.parametrize("q", SHAPES)
def test_shape_recognizers_as_jax(q):
    def dump(spec):
        if spec is None:
            return None
        inner = getattr(spec, "window", spec)
        out = (repr(inner.filters), inner.window_ms,
               getattr(inner.function, "name", None), inner.args)
        if inner is not spec:
            out += (spec.operator.name, spec.by, spec.without)
        return out
    jw, ja = _spec(jws, jparse, q)
    tw, ta = _spec(tws, query_to_logical_plan, q)
    assert (dump(tw), dump(ta)) == (dump(jw), dump(ja))


def test_batches_to_buckets_as_jax():
    """A RawSeries fetch through each package's planner over the same
    two-shard stream unpacks into the same buckets, rows bit for bit."""
    clear_quarantines()
    hs = {pkg: Harness(pkg) for pkg in ("jax", "torch")}
    try:
        ts = BASE + np.arange(50, dtype=np.int64) * 1000
        for h in hs.values():
            h.ingest("m_total", [({"inst": f"i{i}", "_ws_": "w"},
                                  np.cumsum(np.ones(50)) * (i + 1))
                                 for i in range(5)], ts)
            h.flush()
            h.ingest("m_total", [({"inst": "i0", "_ws_": "w"},
                                  np.array([99.0, 100.0]))],
                     BASE + np.array([50_000, 51_000]))
        got = {}
        from_ms, to_ms = BASE + 10_000, BASE + 51_000
        for pkg, h in hs.items():
            m = h.m
            mod, lp_mod = (jws, jlp) if pkg == "jax" else (tws, tlp)
            filt = mod.window_spec(m.query_to_logical_plan(
                "rate(m_total{_ws_=\"w\"}[5s])", to_ms)).filters
            plan = lp_mod.RawSeries(lp_mod.IntervalSelector(from_ms, to_ms),
                                    filt)
            qctx = m.QueryContext()
            res = h.plain.materialize(plan, qctx).execute(
                m.ExecContext(h.ms, qctx))
            got[pkg] = mod.batches_to_buckets(res.batches)
        assert len(got["torch"]) == len(got["jax"]) == 2
        for tb, jb in zip(got["torch"], got["jax"]):
            assert [t for t, _ts, _v in tb] == [t for t, _ts, _v in jb]
            for (_t, tts, tv), (_j, jts, jv) in zip(tb, jb):
                assert tts.tobytes() == np.asarray(jts).tobytes()
                assert tv.view(np.int64).tobytes() == \
                    np.asarray(jv, np.float64).view(np.int64).tobytes()
        assert sum(len(b) for b in got["torch"]) == 5
    finally:
        close_all(list(hs.values()))
