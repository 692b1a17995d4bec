"""The port's kernel ledger (``utils/devicewatch.py``: ``KernelTimer``,
``timed``, ``kernel_summary``) and flight recorder against the JAX
package's:

- both timers fed the same launches, bytes and sampled seconds come out
  with the same launches, sampled counts, EWMA, histogram, baselines
  (seeded, ratcheted down only, loaded from a store) and regression
  episodes (open once, recover, re-arm);
- a grid query on the CPU: the ledger's launches of ``grid.rate_grid``
  reconcile exactly with the wrapper's ``launches`` (a plain version that
  counts a launch stands in for the card's kernel), and the query's
  ``device_programs`` are present, finite, positive and under its wall;
- ``kernel_summary``'s keys, the card's roof; the kill switch and
  ``configure``; ``FlightRecorder.resize``; ``install_crash_hooks``
  dumping the recorder once."""

import logging
import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from filodb_tpu.utils import devicewatch as jdw
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetOptions
from filodb_tpu_torch.coordinator.planner import SingleClusterPlanner
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import grid
from filodb_tpu_torch.parallel.shardmap import ShardMapper, ShardStatus
from filodb_tpu_torch.promql.parser import query_range_to_logical_plan
from filodb_tpu_torch.query.exec import ExecContext
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.utils import devicewatch as dw

torch.set_num_threads(1)

BASE = 1_700_000_040_000
STEP = 60_000

# (program, sampled seconds or None for an unsampled launch, bytes): a
# baseline seeds at 1 ms, a slowdown to 2.5 ms opens an episode, recovery
# closes it, a second slowdown opens another; the other program ratchets
# its baseline down
FEED = ([("p.a", 1e-3, 4096)] * 4 + [("p.a", 2.5e-3, 0)] * 6
        + [("p.a", 0.9e-3, 0)] * 8 + [("p.a", 3e-3, 0)] * 6
        + [("p.b", s, 100) for s in (5e-4, 4e-4, 3e-4, 2e-4, 1e-4)]
        + [("p.b", None, 0)] * 3)

COMPARED = ("launches", "sampled", "device_seconds", "ewma_device_s",
            "bytes_total", "baseline_s", "regressed", "episodes",
            "seconds_histogram", "achieved_bytes_per_s",
            "roofline_fraction")


def _feed(timer, saved):
    timer.attach_baseline_store(lambda: {"p.c": 0.5},
                                lambda p, s: saved.append((p, s)))
    for program, dt, nbytes in FEED:
        timer.tick(program)
        timer.note_bytes(program, nbytes)
        if dt is not None:
            timer._fold(program, dt, "k")
    return {r["program"]: {k: r[k] for k in COMPARED}
            for r in timer.table()}


def test_timer_matches_jax_on_the_same_timings():
    kw = dict(sample_1_in=1, hbm_roof_bytes_per_s=3.35e12,
              regression_factor=1.5, regression_window_s=0.0,
              baseline_min_samples=3)
    jsaved, saved = [], []
    want = _feed(jdw.KernelTimer(**kw), jsaved)
    got = _feed(dw.KernelTimer(**kw), saved)
    assert got == want
    assert saved == jsaved
    assert got["p.a"]["episodes"] == 2 and got["p.a"]["regressed"]
    assert got["p.b"]["baseline_s"] < 4e-4           # ratcheted down only
    assert got["p.c"]["baseline_s"] == 0.5           # loaded from the store
    assert got["p.b"]["launches"] == 8 and got["p.b"]["sampled"] == 5


def test_sampling_one_in_n_and_fault_delay():
    t = dw.KernelTimer(sample_1_in=4)
    sampled = [t.tick("p") for _ in range(9)]
    assert sampled == [True, False, False, False, True, False, False, False,
                       True]
    t.configure(sample_1_in=0)
    assert not any(t.tick("p") for _ in range(5))
    # the fault hook adds its delay to a sampled launch's seconds
    t.configure(sample_1_in=1)
    t.set_fault_delay("slow", 0.02)
    out = t.timed_call("slow", lambda x: x + 1, (torch.zeros(3),), {})
    assert torch.equal(out, torch.ones(3))
    row = {r["program"]: r for r in t.table()}["slow"]
    assert row["sampled"] == 1 and row["device_seconds"] >= 0.02
    t.clear_fault_delay("slow")

    # a failed launch raises through
    def boom(_x):
        raise RuntimeError("launch failed")
    with pytest.raises(RuntimeError, match="launch failed"):
        t.timed_call("boom", boom, (torch.zeros(1),), {})


def _store(n_pods=3, n_series=8, n_rows=140):
    ms = TimeSeriesMemStore(device="cpu")
    shard = ms.setup("prom", DEFAULT_SCHEMAS, 0)
    rng = np.random.default_rng(0)
    b = RecordBuilder(DEFAULT_SCHEMAS["prom-counter"])
    for s in range(n_pods * n_series):
        tags = {"__name__": "req_total", "pod": f"pod-{s % n_pods}",
                "instance": f"i{s}", "_ws_": "w", "_ns_": "n"}
        ts = BASE + np.arange(n_rows, dtype=np.int64) * STEP \
            + int(rng.integers(1, STEP))
        v = np.cumsum(rng.integers(0, 10, n_rows)).astype(np.float64)
        b.add_series(ts, [v], tags)
    for off, c in enumerate(b.containers()):
        ms.ingest("prom", 0, c, off)
    shard.flush_all(ingestion_time=1000)
    return ms


def test_grid_query_reconciles_with_the_wrappers(monkeypatch):
    """On the CPU the wrapper runs its plain version and launches nothing;
    a plain version that counts one launch a call, as the card's launcher
    does, stands in for the kernel here."""
    ms = _store()
    real = grid.rate_grid_ref

    def launching(*a, **kw):
        grid.rate_grid.launches += 1
        return real(*a, **kw)

    monkeypatch.setattr(grid, "rate_grid_ref", launching)
    mapper = ShardMapper(1)
    mapper.update_status(0, ShardStatus.ACTIVE)
    planner = SingleClusterPlanner("prom", mapper, DatasetOptions(),
                                   spread_default=0)
    start = BASE + 30 * STEP
    q = 'sum by (pod)(rate(req_total{_ws_="w",_ns_="n"}[5m]))'
    dw.KERNEL_TIMER.configure(sample_1_in=1)
    try:
        for _ in range(2):              # cold, then warm
            b0 = grid.rate_grid.launches
            l0 = dw.KERNEL_TIMER.launches("grid.rate_grid")
            p0 = dw.KERNEL_TIMER.launches("devicestore.grouped")
            t0 = time.perf_counter()
            res = planner.materialize(query_range_to_logical_plan(
                q, start, STEP, start + 60 * STEP)).execute(
                    ExecContext(ms, QueryContext()))
            wall = time.perf_counter() - t0
            launched = grid.rate_grid.launches - b0
            assert launched == 1
            assert dw.KERNEL_TIMER.launches("grid.rate_grid") - l0 \
                == launched
            assert dw.KERNEL_TIMER.launches("devicestore.grouped") - p0 \
                == 1
            progs = res.stats.device_programs
            assert set(progs) == {"grid.rate_grid", "devicestore.grouped"}
            assert all(math.isfinite(v) and v > 0 for v in progs.values())
            assert sum(progs.values()) <= wall
    finally:
        dw.KERNEL_TIMER.configure(sample_1_in=64)
    row = {r["program"]: r for r in dw.kernel_summary()["programs"]}
    assert row["devicestore.grouped"]["bytes_total"] > 0


def test_kernel_summary_keys_and_roof():
    summary = dw.kernel_summary()
    jsummary = jdw.kernel_summary()
    assert set(summary) == set(jsummary)
    assert summary["hbm_roof_bytes_per_s"] == 3.35e12
    dw.KERNEL_TIMER.tick("keys.probe")
    jdw.KERNEL_TIMER.tick("keys.probe")
    row = {r["program"]: r for r in dw.kernel_summary()["programs"]}
    jrow = {r["program"]: r for r in jdw.kernel_summary()["programs"]}
    # the JAX rows add the compile table's columns, which have no meaning
    # for eagerly run programs
    assert set(jrow["keys.probe"]) - set(row["keys.probe"]) == \
        {"compiles", "compile_seconds", "storms"}
    assert set(dw.device_summary()) >= {"enabled", "ledger", "devices",
                                        "flight_recorder"}


def test_kill_switch_and_configure():
    calls = []

    @dw.timed(program="t.switch")
    def prog(x):
        calls.append(x)
        return x

    n0 = dw.KERNEL_TIMER.launches("t.switch")
    dw.set_enabled(False)
    try:
        assert prog(1) == 1
        assert dw.KERNEL_TIMER.launches("t.switch") == n0
    finally:
        dw.set_enabled(True)
    prog(2)
    assert dw.KERNEL_TIMER.launches("t.switch") == n0 + 1
    assert prog._program == "t.switch" and prog.__name__ == "prog"
    cap = dw.FLIGHT.capacity
    try:
        dw.configure({"enabled": "off", "kernel-sample-1-in": 8,
                      "flight-recorder-size": 64})
        assert not dw.enabled()
        assert dw.KERNEL_TIMER.sample_1_in == 8
        assert dw.FLIGHT.capacity == 64
    finally:
        dw.configure({"enabled": True, "kernel-sample-1-in": 64,
                      "flight-recorder-size": cap})
    assert dw.enabled() and dw.FLIGHT.capacity == cap


@pytest.mark.parametrize("n", [10, 40])
def test_flight_recorder_resize(n):
    """Shrunk to 20 slots, the ring keeps the newest 20 events and the
    next record replaces the oldest.  Where the old events fit, it equals
    the JAX package's; where they do not, the JAX recorder's next record
    lands on a kept event in the middle (its counter restarts at the old
    event count), and the port's replaces the oldest."""
    recs = (dw.FlightRecorder(32), jdw.FlightRecorder(32))
    for r in recs:
        for i in range(n):
            r.record("e", i=i)
        r.resize(20)
        assert r.capacity == 20
        r.record("after", i=-1)
    got, want = ([(e["kind"], e.get("i")) for e in r.events()]
                 for r in recs)
    kept = [("e", i) for i in range(n)][-20:]
    assert got == (kept + [("after", -1)])[-20:]
    if n <= 20:
        assert got == want


def test_crash_hooks_dump_the_recorder_once(caplog, monkeypatch):
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    monkeypatch.setattr(dw, "_CRASH_HOOKS_INSTALLED", False)
    dw.install_crash_hooks()
    dw.install_crash_hooks()                 # idempotent
    dw.FLIGHT.record("crash.probe", n=1)

    def die():
        raise ValueError("boom")

    with caplog.at_level(logging.ERROR, logger="filodb.devicewatch"):
        t = threading.Thread(target=die, name="dying")
        t.start()
        t.join()
    dumps = [r.getMessage() for r in caplog.records
             if "flight recorder dump" in r.getMessage()]
    assert len(dumps) == 1
    assert "unhandled ValueError in thread dying" in dumps[0]
    assert "crash.probe" in dumps[0]
