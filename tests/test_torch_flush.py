"""The port's FlushScheduler against the JAX package's: the same stream
through both must submit the same flushes, in the same order a group,
snapshot the same offsets and leave the same checkpoints; boundaries are
staggered across the interval (group g at phase g/G); close with and
without flushing what remains must agree; a closed scheduler refuses
work; the flush metrics, span and flight record come out of each task.

The schedulers run on threads, so nothing compares timings: only what
was flushed and checkpointed, which is deterministic."""

import numpy as np
import pytest
import torch

from filodb_tpu_torch.memstore.flush import FlushScheduler
from filodb_tpu_torch.utils.devicewatch import FLIGHT
from filodb_tpu_torch.utils.observability import TRACER, flush_metrics
from tests.torch_durable_data import (GROUPS, INTERVAL, STEP,  # noqa: F401
                                      chunk_rows, clear_quarantines,
                                      disk_stores, drive, paging, stream,
                                      table)

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["hours", "minutes"])
@pytest.mark.parametrize("flush_remaining", [False, True])
def test_same_flushes_and_checkpoints(tmp_path, kind, flush_remaining, paging):
    (j, jshard), (t, tshard) = disk_stores(tmp_path, paging=paging)
    records = stream(kind)
    jsched, jsnaps = drive(jshard, records, True, flush_remaining)
    tsched, tsnaps = drive(tshard, records, False, flush_remaining)
    assert tsched.flushes_submitted == jsched.flushes_submitted > 0
    # per group: the same offsets, in submission order
    assert tsnaps == jsnaps
    for g, offs in tsnaps.items():
        assert offs == sorted(offs), g
    q = "SELECT * FROM checkpoints ORDER BY grp"
    assert table(tmp_path / "tam.db", q) == table(tmp_path / "jam.db", q)
    assert t.meta.read_checkpoints("prom", 0) == \
        {g: offs[-1] for g, offs in tsnaps.items()}
    assert chunk_rows(tmp_path / "ta.db") == chunk_rows(tmp_path / "ja.db")
    assert tshard.group_watermarks == jshard.group_watermarks
    # the counters against exact facts: the JAX shard's own counters are
    # bumped unguarded from two executor threads and may lose an update
    assert_counters_exact(tmp_path, tsched, tshard)
    assert tsched.queue_depth() == 0
    snap = tsched.snapshot()
    assert snap["pending"] == 0 and len(snap["groups"]) == GROUPS
    if not flush_remaining:
        # a crash: what no flush took stays in memory only
        assert any(p._buf_n for p in tshard.partitions.values())


def assert_counters_exact(tmp_path, sched, shard) -> None:
    """Every chunk row on disk was counted once, every task once."""
    rows = table(tmp_path / "ta.db", "SELECT COUNT(*) FROM chunks")[0][0]
    assert shard.stats.chunks_flushed == rows
    assert shard.stats.flushes_done == sched.flushes_submitted


@pytest.mark.parametrize("flush_remaining", [False, True])
def test_flush_counters_exact_under_thread_switching(tmp_path,
                                                     flush_remaining):
    """The minutes stream with the interpreter switching threads every
    microsecond: the two flush executor threads finish tasks at once, and
    neither counter may lose an increment."""
    import sys
    (_j, _jshard), (_t, tshard) = disk_stores(tmp_path)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sched, _snaps = drive(tshard, stream("minutes"), False,
                              flush_remaining)
    finally:
        sys.setswitchinterval(old)
    assert sched.flushes_submitted > 0
    assert_counters_exact(tmp_path, sched, tshard)


def test_boundaries_are_staggered():
    """One container a minute: group g's boundaries sit at phase
    g * interval / G, so the groups flush at different containers, an
    interval apart each."""
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        (_j, _jshard), (_t, tshard) = disk_stores(Path(d))
        sched, snaps = drive(tshard, stream("minutes"), False, False)
        assert sched._phase == [g * INTERVAL // GROUPS
                                for g in range(GROUPS)]
        firsts = sorted(offs[0] for offs in snaps.values())
        assert len(set(firsts)) == GROUPS           # never all at once
        gaps = np.diff(firsts)
        assert set(gaps) == {INTERVAL // GROUPS // STEP}
        for offs in snaps.values():
            assert set(np.diff(offs)) <= {INTERVAL // STEP}


def test_closed_scheduler_refuses_and_metrics(tmp_path):
    (_j, _jshard), (_t, tshard) = disk_stores(tmp_path)
    m = flush_metrics()
    chunks0 = m["chunks"].value(dataset="prom")
    secs0 = sum(m["flush_seconds"].counts(dataset="prom"))
    seq0 = max((e["seq"] for e in FLIGHT.events(kind="flush")), default=-1)
    spans = []
    TRACER.add_reporter(spans.append)
    try:
        sched, _snaps = drive(tshard, stream()[:40], False, True)
    finally:
        TRACER.remove_reporter(spans.append)
    tasks = sched.flushes_submitted
    assert sum(m["flush_seconds"].counts(dataset="prom")) - secs0 == tasks
    assert m["chunks"].value(dataset="prom") - chunks0 == \
        tshard.stats.chunks_flushed > 0
    recs = [e for e in FLIGHT.events(kind="flush") if e["seq"] > seq0]
    assert len(recs) == tasks and sum(e["chunks"] for e in recs) == \
        tshard.stats.chunks_flushed
    assert sum(s.name == "memstore.flush" for s in spans) == tasks
    # the sampled gauges are deregistered on close
    assert m["queue_depth"].value(dataset="prom", shard=0) == 0.0
    with pytest.raises(RuntimeError):
        sched.flush_now(0)
    with pytest.raises(ValueError):
        FlushScheduler(tshard, -1)


def test_shard_close_closes_attached_scheduler(tmp_path):
    (_j, _jshard), (t, tshard) = disk_stores(tmp_path)
    sched = FlushScheduler(tshard, INTERVAL, 2)
    tshard.flush_scheduler = sched
    for off, c in stream()[:30]:
        tshard.ingest_container(c, off)
        sched.note_ingested()
    t.reset()
    assert tshard.flush_scheduler is None
    with pytest.raises(RuntimeError):
        sched.flush_now()
    assert t.shards("prom") == []


def test_concurrent_flushes_lose_no_row(tmp_path):
    """Ingest racing eight flush threads, the interpreter switching
    threads every 10 µs: after the final flush every row of the stream
    is on disk exactly once and memory holds nothing unflushed."""
    import sys
    from filodb_tpu_torch.core.chunk import decode_chunkset
    from tests.torch_durable_data import N_ROWS, N_SERIES
    (_j, _jshard), (t, tshard) = disk_stores(tmp_path, groups=8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        sched = FlushScheduler(tshard, 10 * STEP, 8)
        for off, c in stream("minutes"):
            tshard.ingest_container(c, off)
            sched.note_ingested()
        sched.close(flush_remaining=True)
    finally:
        sys.setswitchinterval(old)
    assert sched.flushes_submitted > 100
    pks = list(tshard.part_set)
    got = dict(t.store.read_raw_partitions("prom", 0, pks, 0, 2**62))
    assert len(got) == N_SERIES
    for pk, css in got.items():
        sch = tshard.partitions[tshard.part_set[pk]].schema
        ts = np.concatenate([decode_chunkset(sch, c)[0] for c in css])
        assert len(ts) == N_ROWS and (np.diff(ts) > 0).all()
    assert not any(p._buf_n or p._pending or p._unflushed
                   for p in tshard.partitions.values())
