"""Co-arrival groups over the slice stores (``tests/torch_slice_data.py``),
shared by ``tests/test_torch_batching.py`` (phase mode) and
``tests/test_torch_batching_ts.py`` (gappy ts mode): the port's members
against their solo answers and against the JAX package's batched program.

Groups form deterministically: :func:`hot_key` marks the query's batch
key hot (as a recent group would), and M threads released by one
barrier fill a group of M."""

import gc
import threading
import time

import jax
import numpy as np
import pytest

from filodb_tpu.memstore import devicestore as jdevicestore
from filodb_tpu_torch.batching import QueryBatcher, reset_batch_breaker
from filodb_tpu_torch.ops import grid
from filodb_tpu_torch.utils.observability import batch_metrics
from tests.torch_slice_data import (GIDS, K, N_GROUPS, STEP, T0, WINDOW,
                                    assert_close, fns, ids, stores)

# the members' spans: windows inside the two blocks' data, starts one
# step apart (a dashboard fleet's staggered refreshes)
NSTEPS = 130
FIRST = T0 + (K + 1) * STEP
SIZES = (2, 3, 8)
FUNCS = ("RATE", "INCREASE", "SUM_OVER_TIME", "MAX_OVER_TIME")

_OPEN: list = []


@pytest.fixture(autouse=True)
def closed_breaker_and_stores():
    """Every test starts and ends with the batch breaker closed; the
    shards it opened (:func:`opened`) are closed at its end and their
    garbage collected."""
    reset_batch_breaker()
    yield
    reset_batch_breaker()
    for shard in _OPEN:
        shard.close()
    _OPEN.clear()
    gc.collect()


def opened(kind: str):
    """``(jshard, tshard, jids, tids)``: both packages' slice stores of
    ``kind`` with XOR-packed residents, closed when the test ends."""
    jshard, tshard = stores(kind, compress=True)
    _OPEN.extend((jshard, tshard))
    return (jshard, tshard) + tuple(ids(jshard, tshard))


def hot_key(bat, call):
    """Run ``call`` once through the batcher (a cold key: passthrough) and
    mark its key hot, as a recent group would."""
    keys = []
    orig = bat.dispatch

    def recording(key, *a):
        keys.append(key)
        return orig(key, *a)

    bat.dispatch = recording
    try:
        call()
    finally:
        del bat.dispatch
    assert len(keys) == 1, "the query was not offered to the batcher"
    bat._hot[keys[0]] = time.monotonic() + 100.0


def together(fn, args):
    """``fn(a)`` for every ``a``, from threads released by one barrier."""
    barrier = threading.Barrier(len(args))
    outs: dict = {}
    errs: list = []

    def worker(i, a):
        try:
            barrier.wait()
            outs[i] = fn(a)
        except Exception as e:     # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i, a))
          for i, a in enumerate(args)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    return [outs[i] for i in range(len(args))]


def plan_of(shard, s0, nsteps=NSTEPS):
    """The plan the shard's grid cache memoized for the query of
    ``nsteps`` steps that ends its first window at ``s0`` (either
    package's)."""
    cache = next(iter(shard.device_caches.values()))
    return next(p for p in cache._plan_memo.values()
                if p.q.nsteps == nsteps
                and p.steps0_rel == s0 - cache.epoch0)


def group(tshard, run, starts, size):
    """Solo answers, then one batched group of ``size`` through the port's
    shard: ``(solos, members, the solo plans)``."""
    tshard.query_batcher = None
    solos, plans = [], []
    for s0 in starts:
        solos.append(run(s0))
        plans.append(plan_of(tshard, s0))
    bat = QueryBatcher(window_ms=30_000.0, max_batch=size, dataset="prom")
    tshard.query_batcher = bat
    hot_key(bat, lambda: run(starts[0]))
    launches = grid.rate_grid_batch.launches
    groups = batch_metrics()["groups"].value(dataset="prom")
    members = together(run, starts)
    tshard.query_batcher = None
    assert bat.snapshot()["realized_peak"] == size
    assert batch_metrics()["groups"].value(dataset="prom") == groups + 1
    assert grid.rate_grid_batch.launches == launches, \
        "a CPU tensor launches nothing"
    return solos, members, plans


def jax_batched(jshard, jids, jf, plans, grouped):
    """The JAX package's batched program (``series_batch`` /
    ``grouped_batch``) over its own plan of the first member (its first
    window ending at FIRST), at the port's members' ``(row0, steps0)``:
    ``[M, T, lanes]`` or the grouped ``[M, 2, G, T]``; and that plan."""
    with jax.disable_jit():
        jshard.scan_grid(jids, jf, FIRST, NSTEPS, STEP, WINDOW)
        p = plan_of(jshard, FIRST)
        row0s = np.asarray([q.row0 for q in plans], np.int32)
        steps0s = np.asarray([q.steps0_rel for q in plans], np.int32)
        progs = jdevicestore._fused_progs()
        if grouped:
            garr = np.full(p.ncols, N_GROUPS, np.int32)
            garr[p.lane_idx] = GIDS
            out = progs["grouped_batch"](
                p.ts_parts, p.val_parts, row0s, steps0s, garr, p.phase,
                q=p.q, lanes=p.lane_mult, nrows=p.nrows,
                num_groups=N_GROUPS, op="sum")
        else:
            out = progs["series_batch"](
                p.ts_parts, p.val_parts, row0s, steps0s, p.phase, q=p.q,
                lanes=p.lane_mult, nrows=p.nrows)
    return np.asarray(out), p


def check_groups(kind: str, shape: str, name: str) -> None:
    """Groups of every size in SIZES over ``kind``'s stores: each member
    bit for bit its solo answer, and against the JAX package's batched
    member at rtol 1e-9 (selection and counts exact)."""
    jshard, tshard, jids, tids = opened(kind)
    jf, tf = fns(name)
    exact = name == "MAX_OVER_TIME"
    grouped = shape == "grouped"

    def run(s0):
        if grouped:
            return tshard.scan_grid_grouped(tids, tf, s0, NSTEPS, STEP,
                                            WINDOW, GIDS, N_GROUPS, "sum")
        return tshard.scan_grid(tids, tf, s0, NSTEPS, STEP, WINDOW)

    for size in SIZES:
        starts = [FIRST + i * STEP for i in range(size)]
        solos, members, plans = group(tshard, run, starts, size)
        assert len({(tuple(id(x) for x in p.val_parts), p.nrows)
                    for p in plans}) == 1, \
            "the members share one set of planes"
        jout, jplan = jax_batched(jshard, jids, jf, plans, grouped)
        assert jplan.row0 == plans[0].row0
        for m in range(size):
            what = f"{kind} {shape} {name} size={size} member={m}"
            solo, got = solos[m], members[m]
            if grouped:
                assert sorted(got) == sorted(solo) == ["count", "sum"]
                for k in solo:
                    assert got[k].numpy().tobytes() == \
                        solo[k].numpy().tobytes(), f"{what} {k}: not solo"
                assert_close(got["count"], jout[m][1], True, 0, what)
                assert_close(got["sum"], jout[m][0], exact, 1e-9, what)
            else:
                assert got[1].numpy().tobytes() == \
                    solo[1].numpy().tobytes(), f"{what}: not solo"
                want = jout[m][:, jplan.lane_idx].T
                assert_close(got[1], want, exact, 1e-9, what)
