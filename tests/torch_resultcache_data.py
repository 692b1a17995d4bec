"""Shared set-up of the result-cache tests: one harness a package, wired
the way the JAX package's tests/test_resultcache.py wires its own (a
two-shard memstore behind a ShardMapper, a plain planner and a
``ResultCachingPlanner`` over a second planner of the same dataset), so
that the same stream goes through the JAX package and the port (its
memstore on the CPU), and their answers compare."""

import gc
import types

import numpy as np

BASE = 1_700_000_000_000
DS = "prom"


def clear_quarantines() -> None:
    """Both packages keep a process-wide quarantine: a test starts and
    ends with both empty."""
    from filodb_tpu import integrity as jintegrity
    from filodb_tpu_torch import integrity
    integrity.QUARANTINE.clear()
    jintegrity.QUARANTINE.clear()


def close_all(harnesses) -> None:
    """Close the harnesses a test made and the stores it registered with
    ``tests/torch_durable_data.opened``, and collect their garbage (the
    reason is ``torch_durable_data.clear_quarantines``'s); a test that
    opened nothing pays no collection."""
    from tests.torch_durable_data import _OPEN
    stores = list(_OPEN)
    _OPEN.clear()
    for h in harnesses:
        h.close()
    for ms in stores:
        ms.reset()
    if harnesses or stores:
        gc.collect()
    clear_quarantines()


def modules(pkg: str):
    """The classes a harness needs, from the JAX package or the port."""
    if pkg == "jax":
        from filodb_tpu import integrity
        from filodb_tpu.coordinator.planner import SingleClusterPlanner
        from filodb_tpu.core.record import RecordBuilder, decode_container
        from filodb_tpu.core.schemas import DEFAULT_SCHEMAS, DatasetOptions
        from filodb_tpu.memstore.memstore import TimeSeriesMemStore
        from filodb_tpu.parallel.shardmap import ShardMapper, ShardStatus
        from filodb_tpu.promql.parser import (query_range_to_logical_plan,
                                              query_to_logical_plan)
        from filodb_tpu.query import resultcache
        from filodb_tpu.query.exec import ExecContext
        from filodb_tpu.query.model import PeriodicBatch, QueryContext
        from filodb_tpu.rollup.planner import RollupRouterPlanner
        return types.SimpleNamespace(**locals(), device=None)
    from filodb_tpu_torch import integrity
    from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
    from filodb_tpu_torch.core.record import RecordBuilder, decode_container
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetOptions
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.parallel.shardmap import ShardMapper, ShardStatus
    from filodb_tpu_torch.promql.parser import (query_range_to_logical_plan,
                                                query_to_logical_plan)
    from filodb_tpu_torch.query import resultcache
    from filodb_tpu_torch.query.exec import ExecContext
    from filodb_tpu_torch.query.model import PeriodicBatch, QueryContext
    from filodb_tpu_torch.rollup.planner import RollupRouterPlanner
    return types.SimpleNamespace(**locals(), device="cpu")


class Harness:
    """tests/test_resultcache.py's harness, in one package: ``plain`` is
    the uncached planner, ``cached`` the same dataset's planner behind
    the result cache."""

    def __init__(self, pkg: str, num_shards=2, segment_ms=8_000,
                 max_bytes=None, instant=True, doorkeeper=False):
        self.pkg = pkg
        m = self.m = modules(pkg)
        self.mapper = m.ShardMapper(num_shards)
        if pkg == "jax":
            self.mapper.register_node(range(num_shards), "local")
        kw = {} if m.device is None else {"device": m.device}
        self.ms = m.TimeSeriesMemStore(**kw)
        for s in range(num_shards):
            self.mapper.update_status(s, m.ShardStatus.ACTIVE)
            self.ms.setup(DS, m.DEFAULT_SCHEMAS, s)
        self.plain = m.SingleClusterPlanner(DS, self.mapper,
                                            m.DatasetOptions())
        inner = m.SingleClusterPlanner(DS, self.mapper, m.DatasetOptions())
        self.cache = m.resultcache.ResultCache(
            DS, enabled=True, doorkeeper=doorkeeper,
            max_bytes=max_bytes if max_bytes is not None else 64 << 20)
        self.cached = m.resultcache.ResultCachingPlanner(
            DS, inner, self.ms, self.cache, segment_ms=segment_ms,
            routing_token_fn=self.mapper.routing_token, instant=instant)
        self._offset = 0

    def ingest(self, metric, series_vals, ts, dataset=DS):
        m = self.m
        b = m.RecordBuilder(m.DEFAULT_SCHEMAS["gauge"], m.DatasetOptions(),
                            container_size=1 << 20)
        for tags, vals in series_vals:
            full = dict(tags)
            full["__name__"] = metric
            b.add_series(np.asarray(ts, dtype=np.int64),
                         [np.asarray(vals, dtype=np.float64)], full)
        n = self.mapper.num_shards
        for c in b.containers():
            per = {}
            for rec in m.decode_container(c, m.DEFAULT_SCHEMAS):
                sh = self.mapper.ingestion_shard(rec.shard_hash,
                                                 rec.part_hash, 1) % n
                per.setdefault(sh, []).append(rec)
            for sh, recs in per.items():
                self.ms.get_shard(dataset, sh).ingest(recs, self._offset)
            self._offset += 1

    def flush(self):
        for sh in self.ms.shards(DS):
            sh.flush_all()

    def quarantine_first_chunk(self) -> bool:
        """Quarantine the first flushed chunk of shard 0's first
        partition that has one (the sweep's quarantine event)."""
        for sh in self.ms.shards(DS):
            for part in sh.partitions.values():
                if part.chunks:
                    info = part.chunks[0].info
                    return self.m.integrity.QUARANTINE.quarantine(
                        part.partkey, info.chunk_id, dataset=DS,
                        shard=sh.shard_num, start_time=info.start_time,
                        end_time=info.end_time, reason="sweep")
            return False
        return False

    def eval_range(self, planner, promql, start, step, end):
        m = self.m
        plan = m.query_range_to_logical_plan(promql, start, step, end)
        qctx = m.QueryContext()
        ep = planner.materialize(plan, qctx)
        return ep.execute(m.ExecContext(self.ms, qctx))

    def eval_instant(self, planner, promql, t):
        m = self.m
        plan = m.query_to_logical_plan(promql, t)
        qctx = m.QueryContext()
        ep = planner.materialize(plan, qctx)
        return ep.execute(m.ExecContext(self.ms, qctx))

    def close(self):
        self.m.integrity.QUARANTINE.clear()
        self.ms.reset()


def series_map(res, periodic_cls):
    """{sorted-tags: (nan mask bytes, finite values bytes)} — the
    bit-equality comparison surface (series/batch order is not part of
    the API contract; values are)."""
    out = {}
    for b in res.batches:
        if not isinstance(b, periodic_cls):
            continue
        for tags, ts, vals in b.to_series():
            key = tuple(sorted(tags.items()))
            vals = np.asarray(vals, dtype=np.float64)
            mask = np.isnan(vals)
            prev = out.get(key)
            if prev is not None:
                # same key split across batches: merge NaN slots
                pv = np.frombuffer(prev[2], dtype=np.float64).copy()
                pv[~mask] = vals[~mask]
                vals = pv
                mask = np.isnan(vals)
            out[key] = (mask.tobytes(), vals[~mask].tobytes(),
                        vals.tobytes())
    return {k: v[:2] for k, v in out.items()}


def assert_bit_equal(h, res_a, res_b, ctx=""):
    ma = series_map(res_a, h.m.PeriodicBatch)
    mb = series_map(res_b, h.m.PeriodicBatch)
    assert set(ma) == set(mb), \
        f"{ctx}: series sets differ: {set(ma) ^ set(mb)}"
    for k in ma:
        assert ma[k] == mb[k], f"{ctx}: series {k} differs"


def values_map(res, periodic_cls) -> dict:
    """{sorted-tags: float64 values on the step grid}."""
    out = {}
    for b in res.batches:
        if not isinstance(b, periodic_cls):
            continue
        for tags, _ts, vals in b.to_series():
            key = tuple(sorted(tags.items()))
            vals = np.asarray(vals, dtype=np.float64)
            prev = out.get(key)
            if prev is not None:
                vals = np.where(np.isnan(prev), vals, prev)
            out[key] = vals
    return out


def assert_close_across(jres, jh, tres, th, ctx="", rtol=1e-9, atol=1e-12):
    """The port's answer against the JAX package's: the same label sets,
    NaN positions equal, finite values within ``rtol``/``atol``."""
    a = values_map(jres, jh.m.PeriodicBatch)
    b = values_map(tres, th.m.PeriodicBatch)
    assert set(a) == set(b), f"{ctx}: series sets differ: {set(a) ^ set(b)}"
    for k in a:
        na, nb = np.isnan(a[k]), np.isnan(b[k])
        assert (na == nb).all(), f"{ctx}: NaN positions of {k} differ"
        np.testing.assert_allclose(b[k][~nb], a[k][~na], rtol=rtol,
                                   atol=atol, err_msg=f"{ctx}: {k}")


def instant_pairs(res, t, periodic_cls):
    """{sorted-tags: the value at ``t`` as float hex}."""
    out = {}
    for b in res.batches:
        if not isinstance(b, periodic_cls):
            continue
        for tags, ts, vals in b.to_series():
            fin = np.flatnonzero(~np.isnan(vals) & (ts <= t))
            if len(fin):
                out[tuple(sorted(tags.items()))] = \
                    float(vals[fin[-1]]).hex()
    return out


def assert_pairs_close(jp: dict, tp: dict, ctx: str) -> None:
    """:func:`instant_pairs` of the port (``tp``) against the JAX
    package's (``jp``): the same series, values within rtol 1e-9 / atol
    1e-12."""
    assert set(jp) == set(tp), ctx
    for k in jp:
        np.testing.assert_allclose(float.fromhex(tp[k]),
                                   float.fromhex(jp[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=f"{ctx}: {k}")
