"""The port's resolution router (``filodb_tpu_torch.rollup.planner``), its
``LongTimeRangePlanner`` and ``StitchRvsExec`` against the JAX package's:

- ``resolution_limit_ms`` and ``parse_resolution_pref`` on the same
  plans and knobs;
- the router's decision (tier, ``rollup_tiers``, ``rollup_routed``, the
  refusal of a pin outside the ladder) and the plan tree it builds
  (node types, leaf datasets and time ranges, stitch points) equal to
  the JAX router's for the same plans, clocks and watermarks: rolled
  tiers, raw, retention past the rolled watermark, retention forcing
  the finest tier, and the cold leg at a floor the test supplies;
- ``LongTimeRangePlanner``'s raw, downsample and stitched splits;
- ``StitchRvsMapper`` over batches of overlapping ranges and key sets;
- stitched answers equal to the JAX package's on the CPU, NaN positions
  equal and finite values within rtol 1e-9 / atol 1e-12
  (tests/test_torch_query.py's bound);
- count continuity across the stitch: ``count_over_time`` through the
  router equals the raw-pinned answer exactly, every step answered."""

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator import planners as jplanners
from filodb_tpu.query import exec as jexec
from filodb_tpu.query import model as jmodel
from filodb_tpu.query import transformers as jtransformers
from filodb_tpu.rollup import planner as jrouter
from filodb_tpu_torch.coordinator import planners
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.query import exec as texec
from filodb_tpu_torch.query import model as tmodel
from filodb_tpu_torch.query import transformers as ttransformers
from filodb_tpu_torch.rollup import planner as router
from tests.torch_rollup_data import (BASE, both, mk_rows, modules,
                                     stop_engines)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _stop_engines():
    yield
    stop_engines()

HOUR = 3_600_000
SEL = '{_ws_="w",_ns_="n"}'
LADDER = (60_000, 900_000)


@pytest.fixture(scope="module")
def served():
    """Both packages over the same ~6 h of 30 s scrapes, flushed once
    and rolled at 1 min and 15 min, then 40 more minutes left raw."""
    h = both(resolutions=LADDER)
    rng = np.random.default_rng(11)
    rows = []
    for i in range(4):
        ts = BASE + np.arange(0, 6 * HOUR, 30_000) + 1
        rows.append(({"__name__": "m", "inst": f"i{i}", "_ws_": "w",
                      "_ns_": "n", "g": f"g{i % 2}"}, ts,
                     rng.normal(5, 1, len(ts))))
    tail = [(t, ts[-1] + np.arange(1, 81) * 30_000, rng.normal(5, 1, 80))
            for t, ts, _v in rows]
    for hh in h.values():
        hh.ingest(rows)
        hh.flush_tick()
        hh.ingest(tail)
    end = int(rows[0][1][-1] + 80 * 30_000)
    return h, end


def shape(ep) -> tuple:
    """An exec plan tree as data: node type, a leaf's dataset and time
    range, the children's shapes."""
    kids = tuple(shape(c) for c in ep.children)
    if getattr(ep, "dataset", None) is not None:
        return (type(ep).__name__, ep.dataset, ep.start_ms, ep.end_ms, kids)
    return (type(ep).__name__, kids)


def materialize_both(h, q, start, step, end, resolution="", **kw):
    """Each package's router over the same plan: (tier, tiers, routed,
    plan shape), or the exception type when the router refuses."""
    out = {}
    for pkg, hh in h.items():
        m = hh.m
        r = hh.make_router(**kw) if kw else hh.router
        qctx = m.QueryContext(sample_limit=10 ** 9,
                              resolution_pref=resolution)
        plan = m.query_range_to_logical_plan(q, start, step, end)
        try:
            ep = r.materialize(plan, qctx)
        except ValueError:
            out[pkg] = ValueError
            continue
        out[pkg] = (qctx.rollup_resolution_ms, list(qctx.rollup_tiers),
                    qctx.rollup_routed, shape(ep))
    return out


LIMIT_CASES = [('sum_over_time(m[5m])', HOUR), ('m', HOUR),
               ('sum_over_time(m[30m])', 900_000),
               ('sum by (g)(rate(m[1h]))', 900_000),
               ('rate(m[2m]) / rate(m[10m] offset 1h)', HOUR),
               ('max_over_time(m[1d])', 15_000),
               ('sum(m)', 30_000),
               ('histogram_quantile(0.9, sum by (le)(rate(h[15m])))', HOUR)]


@pytest.mark.parametrize("q,step", LIMIT_CASES)
def test_resolution_limit_as_jax(q, step):
    from filodb_tpu.promql.parser import \
        query_range_to_logical_plan as jparse
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    got = router.resolution_limit_ms(
        query_range_to_logical_plan(q, BASE, step, BASE + 10 ** 7), step)
    want = jrouter.resolution_limit_ms(jparse(q, BASE, step, BASE + 10 ** 7),
                                       step)
    assert got == want
    assert planners.plan_lookback_ms(query_range_to_logical_plan(
        q, BASE, step, BASE + 10 ** 7)) == jplanners.plan_lookback_ms(
        jparse(q, BASE, step, BASE + 10 ** 7))


@pytest.mark.parametrize("pref", ["", "auto", "AUTO", "raw", " raw ", "1m",
                                  "15m", "1h", "90s"])
def test_parse_resolution_pref_as_jax(pref):
    assert router.parse_resolution_pref(pref) == \
        jrouter.parse_resolution_pref(pref)


def test_canonical_tiers_as_jax():
    for tiers in (["raw", "rolled-local"], ["rolled-local", "rolled-cold",
                                             "raw"], ["raw"], [], ["x"]):
        assert router.canonical_tiers(tiers) == \
            jrouter.canonical_tiers(tiers)


ROUTER_CASES = [
    # (query, step, resolution pin)
    (f'sum_over_time(m{SEL}[15s])', 15_000, ""),
    (f'sum_over_time(m{SEL}[5m])', HOUR, ""),
    (f'sum_over_time(m{SEL}[30m])', 1_800_000, ""),
    (f'sum_over_time(m{SEL}[30m])', 1_800_000, "raw"),
    (f'sum_over_time(m{SEL}[30m])', 1_800_000, "1m"),
    (f'sum_over_time(m{SEL}[30m])', 1_800_000, "5m"),
    (f'sum by (g)(rate(m{SEL}[1h]))', 900_000, ""),
    (f'count_over_time(m{SEL}[5m])', 300_000, ""),
    (f'm{SEL}', 300_000, ""),
    (f'avg by (g)(avg_over_time(m{SEL}[15m]))', 900_000, "15m"),
]


@pytest.mark.parametrize("q,step,pref", ROUTER_CASES)
def test_router_decision_and_plan_as_jax(served, q, step, pref):
    h, end = served
    start = (BASE // step + 1) * step
    stop = (end // step) * step
    out = materialize_both(h, q, start, step, stop, pref)
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("case", ["retention_past_watermark",
                                  "retention_forces_finest",
                                  "cold_leg", "cold_floor_below_start",
                                  "watermark_before_start"])
def test_router_clocks_and_watermarks_as_jax(served, case):
    """Routers built with fixed watermarks, clocks and (for the cold leg)
    a floor function the test supplies, as tests/test_rollup.py builds
    its own."""
    h, end = served
    step = 300_000
    stop = (end // step) * step
    start = stop - 4 * HOUR
    q = f'count_over_time(m{SEL}[5m])'
    kw = {}
    if case == "retention_past_watermark":
        kw = dict(rolled_through_fn=lambda r: start + 600_000,
                  raw_retention_ms=1, now_ms_fn=lambda: stop)
    elif case == "retention_forces_finest":
        q, step = f'sum_over_time(m{SEL}[15s])', 15_000
        start = (BASE // step + 1) * step
        kw = dict(rolled_through_fn=lambda r: end + 10 ** 9,
                  raw_retention_ms=1, now_ms_fn=lambda: stop)
    elif case == "cold_leg":
        kw = dict(rolled_through_fn=lambda r: stop - HOUR,
                  cold_floor_fn=lambda r: start + 2 * HOUR)
    elif case == "cold_floor_below_start":
        kw = dict(rolled_through_fn=lambda r: stop - HOUR,
                  cold_floor_fn=lambda r: start - HOUR)
    else:
        kw = dict(rolled_through_fn=lambda r: start - step)
    out = materialize_both(h, q, start, step, stop, **kw)
    assert out["torch"] == out["jax"]
    got = {pkg: hh.run_query(q, start, step, stop,
                             planner=hh.make_router(**kw))[0]
           for pkg, hh in h.items()}
    assert_answers(got["torch"], got["jax"])
    if case == "retention_past_watermark":
        # raw-retention routes, it deletes nothing: the raw side serves
        # the gap past the tier's watermark, no step comes back empty
        raw = h["torch"].run_query(q, start, step, stop,
                                   planner=h["torch"].raw_planner)[0]
        for k, (ts, v) in raw.items():
            np.testing.assert_array_equal(
                np.nan_to_num(got["torch"][k][1], nan=-1.0),
                np.nan_to_num(v, nan=-1.0))
    if case == "cold_leg":
        assert router.canonical_tiers(out["torch"][1]) == \
            "rolled-cold+rolled-local+raw"


class _Leaf:
    """A stub planner: one leaf plan a materialize, naming its side and
    the plan's time range."""

    def __init__(self, exec_mod, side):
        self.exec_mod, self.side = exec_mod, side

    def materialize(self, plan, qctx=None):
        from filodb_tpu.query import logical as jlp
        from filodb_tpu_torch.query import logical as tlp
        lp = jlp if self.exec_mod is jexec else tlp
        start, _step, end = lp.time_range(plan)
        ep = self.exec_mod.EmptyResultExec(qctx)
        ep.dataset, ep.start_ms, ep.end_ms = self.side, start, end
        return ep


@pytest.mark.parametrize("earliest,latest", [
    (BASE - HOUR, None),              # raw serves the whole range
    (BASE + 100 * HOUR, None),        # only the downsample side
    (BASE + 3 * HOUR, None),          # stitched at the boundary
    (BASE + 3 * HOUR, BASE + HOUR),   # downsample data ends early
    (BASE + 3 * HOUR + 1, BASE - HOUR),   # ds_end before start: raw only
    (BASE + 6 * HOUR - 1, None),      # the first raw step past the end
])
def test_long_time_range_splits_as_jax(earliest, latest):
    from filodb_tpu.promql.parser import \
        query_range_to_logical_plan as jparse
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    q = f'sum_over_time(m{SEL}[10m])'
    got = {}
    for name, pl, ex, mo, parse in (
            ("jax", jplanners, jexec, jmodel, jparse),
            ("torch", planners, texec, tmodel, query_range_to_logical_plan)):
        ltr = pl.LongTimeRangePlanner(
            _Leaf(ex, "raw"), _Leaf(ex, "ds"), lambda: earliest,
            (lambda: latest) if latest is not None else None)
        plan = parse(q, BASE, 300_000, BASE + 6 * HOUR)
        got[name] = shape(ltr.materialize(plan, mo.QueryContext()))
    assert got["torch"] == got["jax"]


def _batches(pkg, rng, spans, keys_of):
    mod = jmodel if pkg == "jax" else tmodel
    steps_mod = __import__("filodb_tpu.ops.windows" if pkg == "jax"
                           else "filodb_tpu_torch.ops.windows",
                           fromlist=["StepRange"])
    out = []
    for (start, n), keys, vals in zip(spans, keys_of, rng):
        steps = steps_mod.StepRange(start, start + (n - 1) * 60_000, 60_000)
        v = vals if pkg == "jax" else torch.as_tensor(vals)
        out.append(mod.PeriodicBatch([dict(k) for k in keys], steps, v))
    return out


def test_stitch_mapper_as_jax():
    """Children over overlapping sub-ranges, keys in some of them only,
    NaN slots filled from a later child, a key twice in one child."""
    rng = np.random.default_rng(2)
    spans = [(BASE, 30), (BASE + 20 * 60_000, 25), (BASE + 5 * 60_000, 10)]
    keys_of = [[{"i": "a"}, {"i": "b"}], [{"i": "b"}, {"i": "c"}],
               [{"i": "a"}, {"i": "d"}, {"i": "a"}]]
    vals = []
    for (_s, n), keys in zip(spans, keys_of):
        v = rng.normal(size=(len(keys), n))
        v[rng.random(v.shape) < 0.3] = np.nan
        vals.append(v)
    want = jtransformers.StitchRvsMapper().apply(
        _batches("jax", vals, spans, keys_of), None)
    ms = TimeSeriesMemStore(device="cpu")
    got = ttransformers.StitchRvsMapper().apply(
        _batches("torch", vals, spans, keys_of), texec.ExecContext(ms))
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert g.keys == w.keys and tuple(g.steps) == tuple(w.steps)
    assert isinstance(g.values, torch.Tensor) and \
        g.values.device == ms.device
    np.testing.assert_array_equal(g.np_values(), w.np_values())
    assert ttransformers.StitchRvsMapper().apply([], texec.ExecContext(ms)) \
        == []


STITCHED = [f'sum_over_time(m{SEL}[5m])', f'count_over_time(m{SEL}[5m])',
            f'sum by (g)(rate(m{SEL}[15m]))', f'max_over_time(m{SEL}[30m])',
            f'avg(avg_over_time(m{SEL}[15m]))']


@pytest.mark.parametrize("q", STITCHED)
@pytest.mark.parametrize("step", [300_000, 900_000])
def test_stitched_answers_as_jax(served, q, step):
    h, end = served
    start = (BASE // step + 2) * step
    stop = (end // step) * step
    ans = {}
    for pkg, hh in h.items():
        got, res, qctx = hh.run_query(q, start, step, stop)
        ans[pkg] = (got, qctx.rollup_resolution_ms, list(qctx.rollup_tiers))
    (g, gres, gtiers), (w, wres, wtiers) = ans["torch"], ans["jax"]
    assert (gres, gtiers) == (wres, wtiers)
    assert gres in LADDER and "raw" in gtiers, (gres, gtiers)
    assert_answers(g, w)


def assert_answers(got: dict, want: dict) -> None:
    """The same series and step grids, NaN positions equal, finite values
    within rtol 1e-9 / atol 1e-12."""
    assert set(got) == set(want) and want
    for k, (ts, v) in want.items():
        np.testing.assert_array_equal(got[k][0], ts)
        assert np.array_equal(np.isnan(got[k][1]), np.isnan(v)), k
        fin = np.isfinite(v)
        np.testing.assert_allclose(got[k][1][fin], v[fin], rtol=1e-9,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("trial", range(4))
def test_count_continuity_across_the_stitch(trial):
    """No gap and no double-counted boundary step: a rolled-region window
    sums whole periods' counts, so the router's count_over_time equals
    the raw-pinned answer exactly, at every step of the grid."""
    from tests.torch_rollup_data import Harness
    h = Harness("torch")
    rng = np.random.default_rng(7)
    last: dict = {}
    for _rnd in range(3):
        h.ingest(mk_rows(rng, last, n_series=3, rows=200,
                         span_ms=40 * 60_000))
        h.flush_tick()
    rng = np.random.default_rng(100 + trial)
    step = int(rng.choice([60_000, 120_000, 300_000]))
    lo = BASE + int(rng.integers(0, 20)) * 60_000
    hi = max(last.values()) + int(rng.integers(-10, 10)) * 60_000
    start, end = (lo // step + 1) * step, (hi // step) * step
    q = f'count_over_time(m{SEL}[{step // 1000}s])'
    got, _res, qctx = h.run_query(q, start, step, end)
    want, _res, _q = h.run_query(q, start, step, end,
                                 planner=h.raw_planner)
    assert qctx.rollup_routed and qctx.rollup_resolution_ms in (0,) + \
        h.resolutions
    assert set(got) == set(want) and got
    for k, (ts, v) in want.items():
        np.testing.assert_array_equal(got[k][0], ts)
        np.testing.assert_array_equal(np.nan_to_num(got[k][1], nan=-1.0),
                                      np.nan_to_num(v, nan=-1.0))


def test_stitch_returns_tensors_on_the_ctx_device(served):
    """StitchRvsExec composes on the ExecContext's device: its batches
    are tensors there (nothing read back to the host)."""
    h, end = served
    th = h["torch"]
    step = 300_000
    m = modules("torch")
    qctx = m.QueryContext(sample_limit=10 ** 9)
    plan = m.query_range_to_logical_plan(f'sum_over_time(m{SEL}[5m])',
                                         (BASE // step + 2) * step, step,
                                         (end // step) * step)
    ep = th.router.materialize(plan, qctx)
    assert isinstance(ep, texec.StitchRvsExec)
    res = ep.execute(m.ExecContext(th.ms, qctx))
    assert res.batches and all(isinstance(b.values, torch.Tensor)
                               and b.values.device == th.ms.device
                               for b in res.batches)


@pytest.fixture(scope="module")
def counters():
    """Both packages over a counter at one-minute scrapes (the durable
    store's data in small: 24 series of 3 pods, one reset), fed hour by
    hour and rolled at the default ladder, 1 min / 15 min / 1 h."""
    from filodb_tpu_torch.rollup.config import DEFAULT_RESOLUTIONS_MS
    h = both(resolutions=DEFAULT_RESOLUTIONS_MS, schema="prom-counter")
    rng = np.random.default_rng(8)
    t0 = BASE + 14 * 60_000
    n_rows = 300
    series = []
    for s in range(24):
        tags = {"__name__": "req_total", "pod": f"pod-{s % 3}",
                "instance": f"i{s}", "_ws_": "w", "_ns_": "n"}
        ts = t0 + np.arange(n_rows, dtype=np.int64) * 60_000 + 1
        v = rng.integers(0, 10**6) + np.cumsum(
            rng.integers(0, 10, n_rows)).astype(np.float64)
        if s == 5:
            v[140:] -= v[139]
        series.append((tags, ts, v))
    for r0 in range(0, n_rows, 60):
        hour = [(t, ts[r0:r0 + 60], v[r0:r0 + 60]) for t, ts, v in series]
        for hh in h.values():
            hh.ingest(hour)
            hh.flush_tick()
    return h, t0, t0 + (n_rows - 1) * 60_000 + 1


@pytest.mark.parametrize("case", ["auto", "raw", "retention"])
def test_counter_tiers_served_as_jax(counters, case):
    """``sum by (pod)(rate(req_total[1h]))`` at a 15 min step over the
    whole span, as the chip's rollup phase asks it: the same tier, the
    same plan, the same grid decision for each leg's dataset (a grid
    cache hit or none), and answers within the engine tests' bound."""
    h, t0, last = counters
    step = 900_000
    # the whole span: the first full window to the step after the last
    # sample, past the rolled watermark (the live edge raw serves)
    start = ((t0 + HOUR) // step + 1) * step
    stop = (last // step + 1) * step
    q = 'sum by (pod)(rate(req_total{_ws_="w",_ns_="n"}[1h]))'
    pref = "raw" if case == "raw" else ""
    kw = {}
    if case == "retention":
        # a retention floor inside the range, below the profit boundary
        kw = dict(raw_retention_ms=stop - (start + HOUR),
                  now_ms_fn=lambda: stop)
    out = materialize_both(h, q, start, step, stop, pref, **kw)
    assert out["torch"] == out["jax"]
    if case != "raw":
        assert out["torch"][3][0] == "StitchRvsExec", out["torch"][3][0]
    served = {}
    ans = {}
    for pkg, hh in h.items():
        names = ["prom"] + [hh.m.ds_dataset_name("prom", r)
                            for r in hh.resolutions]
        shards = {n: hh.ms.get_shard(n, 0) for n in names}
        before = {n: sum(c.hits for c in sh.device_caches.values())
                  for n, sh in shards.items()}
        ans[pkg] = hh.run_query(q, start, step, stop, resolution=pref,
                                planner=hh.make_router(**kw))[0]
        served[pkg] = {n: sum(c.hits for c in sh.device_caches.values())
                       > before[n] for n, sh in shards.items()}
    assert served["torch"] == served["jax"]
    assert served["torch"]["prom"], "the raw leg must run on the grid"
    assert_answers(ans["torch"], ans["jax"])
