"""Shared set-up of the rollup tests: one harness a package, wired the
way the JAX package's tests/test_rollup.py wires its own (the raw dataset
and the tier datasets in one memstore, the engine on the raw shard's
flush listener, each tier's publish function an in-process ingest), so
that the same generated stream goes through the JAX package's engine and
the port's, and their tier datasets, routers and answers compare."""

import types

import numpy as np

BASE = 1_700_000_000_000
RES = (60_000, 900_000)

# every harness built, so that a module's teardown stops its engines: an
# engine's lag and stall gauges live in its package's process-wide
# registry until ``stop`` removes them, and the JAX package's own tests
# (tests/test_rollup.py) may run next in the same worker
LIVE: list = []


def stop_engines() -> None:
    """Stop every harness's engine (its gauge rows go) and forget it."""
    while LIVE:
        LIVE.pop().engine.stop()


def _jax_modules():
    from filodb_tpu.codecs import histcodec
    from filodb_tpu.coordinator.planner import SingleClusterPlanner
    from filodb_tpu.core.chunk import decode_chunkset
    from filodb_tpu.core.record import (RecordBuilder, canonical_partkey,
                                        parse_partkey)
    from filodb_tpu.core.schemas import DEFAULT_SCHEMAS, DatasetOptions
    from filodb_tpu.downsample.dsstore import ds_dataset_name
    from filodb_tpu.downsample.sharddown import ShardDownsampler
    from filodb_tpu.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu.parallel.shardmap import ShardMapper
    from filodb_tpu.promql.parser import query_range_to_logical_plan
    from filodb_tpu.query.exec import ExecContext
    from filodb_tpu.query.model import QueryContext
    from filodb_tpu.rollup import engine, planner
    from filodb_tpu.rollup.config import RollupConfig
    from filodb_tpu.store.columnstore import InMemoryColumnStore
    return types.SimpleNamespace(**locals(), device=None)


def _torch_modules():
    from filodb_tpu_torch.codecs import histcodec
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.core.chunk import decode_chunkset
    from filodb_tpu_torch.core.record import (RecordBuilder,
                                              canonical_partkey,
                                              parse_partkey)
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetOptions
    from filodb_tpu_torch.downsample.dsstore import ds_dataset_name
    from filodb_tpu_torch.downsample.sharddown import ShardDownsampler
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.parallel.shardmap import ShardMapper
    from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
    from filodb_tpu_torch.query.exec import ExecContext
    from filodb_tpu_torch.query.model import QueryContext
    from filodb_tpu_torch.rollup import engine, planner
    from filodb_tpu_torch.rollup.config import RollupConfig
    from filodb_tpu_torch.store.columnstore import InMemoryColumnStore
    return types.SimpleNamespace(**locals(), device="cpu")


def modules(pkg: str):
    """The classes a harness needs, from the JAX package or the port."""
    return _jax_modules() if pkg == "jax" else _torch_modules()


class Harness:
    """Raw dataset + tier datasets in ONE memstore (the port's on the
    CPU), the engine wired with the flush listener and the tier publish
    functions."""

    def __init__(self, pkg: str, resolutions=RES, store=None, meta=None,
                 idle_close_s=None, schema="gauge"):
        self.pkg = pkg
        m = self.m = modules(pkg)
        self.resolutions = tuple(resolutions)
        self.store = store if store is not None else m.InMemoryColumnStore()
        kw = {} if m.device is None else {"device": m.device}
        self.ms = m.TimeSeriesMemStore(self.store, meta, **kw)
        self.shard = self.ms.setup("prom", m.DEFAULT_SCHEMAS, 0)
        self.schema = schema
        self.offsets: dict = {}
        for r in self.resolutions:
            self.ms.setup(m.ds_dataset_name("prom", r), m.DEFAULT_SCHEMAS, 0)
        self.publish_for = {r: self._pub(r) for r in self.resolutions}
        self.engine = m.engine.RollupEngine(node="test")
        LIVE.append(self)
        self.cfg = m.RollupConfig(resolutions_ms=self.resolutions,
                                  idle_close_s=idle_close_s)
        self.engine.watch("prom", self.ms, m.DEFAULT_SCHEMAS, self.cfg,
                          self.publish_for, column_store=self.store,
                          meta_store=self.ms.meta)
        self.offset = 0
        self.itime = 1000
        self.raw_planner = self.planner("prom")
        self.tier_planners = {r: self.planner(m.ds_dataset_name("prom", r))
                              for r in self.resolutions}
        self.router = self.make_router()

    def planner(self, dataset: str):
        m = self.m
        return m.SingleClusterPlanner(dataset, m.ShardMapper(1),
                                      m.DatasetOptions(), spread_default=0)

    def make_router(self, tiers=None, **kw):
        kw.setdefault("rolled_through_fn",
                      lambda r: self.engine.rolled_through("prom", r))
        return self.m.planner.RollupRouterPlanner(
            "prom", self.raw_planner,
            self.tier_planners if tiers is None else tiers, **kw)

    def _pub(self, r):
        name = self.m.ds_dataset_name("prom", r)

        def pub(shard, container):
            off = self.offsets.get((name, shard), -1) + 1
            self.offsets[(name, shard)] = off
            self.ms.ingest(name, shard, container, off)
        return pub

    def ingest(self, series_rows) -> None:
        """[(tags, ts, vals)] appended as one batch, in the harness's
        schema (a gauge or a counter)."""
        b = self.m.RecordBuilder(self.m.DEFAULT_SCHEMAS[self.schema])
        for tags, ts, vals in series_rows:
            for t, v in zip(ts, vals):
                b.add(int(t), [float(v)], tags)
        for c in b.containers():
            self.ms.ingest("prom", 0, c, self.offset)
            self.offset += 1

    def ingest_hist(self, series_rows) -> None:
        """[(tags, ts, (tops, rows [n, hb]))] prom-histogram batches (sum
        and count columns from the total bucket); ``tops`` become each
        package's custom bucket scheme."""
        m = self.m
        from_tops = _buckets(self.pkg)
        b = m.RecordBuilder(m.DEFAULT_SCHEMAS["prom-histogram"])
        for tags, ts, (tops, rows) in series_rows:
            buckets = from_tops(tops)
            for t, r in zip(ts, rows):
                blob = m.histcodec.encode_hist_value(buckets, r)
                b.add(int(t), (float(r[-1]), float(r[-1]), blob), tags)
        for c in b.containers():
            self.ms.ingest("prom", 0, c, self.offset)
            self.offset += 1

    def flush_tick(self) -> None:
        self.itime += 1
        self.shard.flush_all(ingestion_time=self.itime)
        self.engine.run_once("prom")

    def tier_shard(self, res):
        return self.ms.get_shard(self.m.ds_dataset_name("prom", res), 0)

    def tier_rows(self, res) -> dict:
        """{partkey: (ts, [column values...])} of one tier dataset, every
        data column read back (histograms as (tops, rows))."""
        out = {}
        sh = self.tier_shard(res)
        for pk, pid in sh.part_set.items():
            part = sh.partitions.get(pid)
            if part is None:
                continue
            ts, _ = part.read_range(0, 1 << 62, 1)
            cols = []
            for ci in range(1, len(part.schema.data.columns)):
                _, v = part.read_range(0, 1 << 62, ci)
                if isinstance(v, tuple):
                    v = (np.asarray(v[0].bucket_tops()), np.asarray(v[1]))
                cols.append(v)
            out[bytes(pk)] = (np.asarray(ts), cols)
        return out

    def oracle_outputs(self, res):
        """The offline full pass over every persisted raw chunk (the
        ``downsample/`` path the tiers must equal)."""
        m = self.m
        pairs = [(m.parse_partkey(cs.partkey), cs) for _it, cs in
                 self.store.chunksets_with_ingestion_time(
                     "prom", 0, 0, 1 << 62)]
        kw = {} if m.device is None else {"device": m.device}
        samp = m.ShardDownsampler("prom", 0, m.DEFAULT_SCHEMAS[self.schema],
                                  None, self.resolutions, **kw)
        return samp.downsample_arrays(samp.prepare_arrays(pairs), res)

    def assert_tier_matches_oracle(self, res, last_ts_by_pk, closed=True,
                                   sums_rtol=None) -> int:
        """Every tier series' rows equal the offline oracle's, bit for
        bit, over closed periods (tests/test_rollup.py's check).  With
        ``sums_rtol``, a ``sum`` or ``avg`` column within that instead:
        on the grid path a tier's periods cascade from planes staged
        from the live buffers, so their sums round otherwise than the
        full pass's (in the JAX package too)."""
        m = self.m
        got = self.tier_rows(res)
        names = [c.name for c in self.m.DEFAULT_SCHEMAS[
            self.schema].downsample.data.columns[1:]] \
            if self.m.DEFAULT_SCHEMAS[self.schema].downsample is not None \
            else None
        checked = 0
        for tags, pe, cols in self.oracle_outputs(res):
            pk = m.canonical_partkey(tags)
            pe = np.asarray(pe, dtype=np.int64)
            if closed:
                m_ = pe <= ((last_ts_by_pk[pk] - 1) // res) * res
            else:
                m_ = np.ones(len(pe), bool)
            assert pk in got, (res, tags)
            ts, gcols = got[pk]
            assert ts.tobytes() == pe[m_].tobytes(), (res, tags)
            for ci, (g, want) in enumerate(zip(gcols, cols)):
                if sums_rtol is not None and names is not None \
                        and names[ci] in ("sum", "avg"):
                    np.testing.assert_allclose(
                        np.asarray(g), np.asarray(want)[m_],
                        rtol=sums_rtol, err_msg=str((res, tags)))
                elif isinstance(want, tuple):
                    wb, wr = want
                    assert g[0].tobytes() == np.asarray(
                        wb.bucket_tops()).tobytes(), (res, tags)
                    assert np.asarray(g[1], np.float64).tobytes() == \
                        np.asarray(wr, np.float64)[m_].tobytes(), (res, tags)
                else:
                    assert np.asarray(g).tobytes() == \
                        np.asarray(want)[m_].tobytes(), (res, tags)
            checked += 1
        assert checked
        return checked

    def run_query(self, promql, start, step, end, planner=None,
                  resolution=""):
        """{inst: (step timestamps, values)} of one range query through a
        planner (the router by default), with its result and QueryContext."""
        m = self.m
        qctx = m.QueryContext(sample_limit=10 ** 9,
                              resolution_pref=resolution)
        plan = m.query_range_to_logical_plan(promql, start, step, end)
        ep = (planner or self.router).materialize(plan, qctx)
        res = ep.execute(m.ExecContext(self.ms, qctx))
        out = {}
        for b in res.batches:
            vals = b.np_values()
            for i, tags in enumerate(b.keys):
                key = tags.get("inst", "") or tags.get("g", "")
                out[key] = (np.asarray(b.steps.timestamps()), vals[i])
        return out, res, qctx


def _buckets(pkg: str):
    if pkg == "jax":
        from filodb_tpu.core.histogram import CustomBuckets
    else:
        from filodb_tpu_torch.core.histogram import CustomBuckets
    return lambda tops: CustomBuckets(np.asarray(tops, np.float64))


def mk_rows(rng, series_last, n_series, rows, span_ms, counter=False):
    """A batch of ``n_series`` series of up to ``rows`` irregular samples
    each, continuing where ``series_last`` says each series stopped
    (tests/test_rollup.py's generator); counters reset now and then."""
    batch = []
    for i in range(n_series):
        lo = series_last.get(i, BASE)
        ts = np.unique(lo + np.sort(rng.integers(1, span_ms, rows)))
        series_last[i] = int(ts[-1])
        if counter:
            vals = np.cumsum(rng.random(len(ts)) * 3)
            if rng.random() < 0.4:
                vals[len(vals) // 2:] -= vals[len(vals) // 2] * 0.95
        else:
            vals = rng.normal(10, 3, len(ts))
        name = "c_total" if counter else "m"
        tags = {"__name__": name, "inst": f"i{i}", "_ws_": "w",
                "_ns_": "n", "g": f"g{i % 2}"}
        batch.append((tags, ts, vals))
    return batch


def last_by_pk(pkg: str, last: dict, metric: str = "m") -> dict:
    """{partkey: newest sample ts} of mk_rows' series."""
    m = modules(pkg)
    return {m.canonical_partkey({"_metric_": metric, "inst": f"i{i}",
                                 "_ws_": "w", "_ns_": "n",
                                 "g": f"g{i % 2}"}): ts
            for i, ts in last.items()}


def both(**kw) -> dict:
    """A JAX harness and a port harness built alike."""
    return {pkg: Harness(pkg, **kw) for pkg in ("jax", "torch")}
