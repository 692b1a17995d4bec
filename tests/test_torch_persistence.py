"""The port's sqlite column and meta stores against the JAX package's:
the same containers ingested and flushed into separate files must leave
the same rows (part key, chunk id, times, row count, schema hash, the
framed vectors byte for byte, the CRC32C) and the same part-key rows
and checkpoints; reads, reopens, scans, the in-memory double, index
recovery and a crash followed by a replay must agree too.

Everything compared here is exact."""

import numpy as np
import pytest
import torch

from filodb_tpu.store.columnstore import InMemoryColumnStore as JInMemory
from filodb_tpu.store.columnstore import PartKeyRecord as JPartKeyRecord
from filodb_tpu.store.metastore import InMemoryMetaStore as JInMemoryMeta
from filodb_tpu_torch.store.columnstore import (InMemoryColumnStore,
                                                PartKeyRecord,
                                                ScanBytesExceeded)
from filodb_tpu_torch.store.metastore import InMemoryMetaStore
from filodb_tpu_torch.store.persistence import (DiskColumnStore,
                                                DiskMetaStore, pack_vectors,
                                                unpack_vectors)
from tests.torch_durable_data import (INTERVAL, STEP, T0,  # noqa: F401
                                      chunk_rows, clear_quarantines,
                                      disk_stores, drive, paging, samples,
                                      stream, table)

torch.set_num_threads(1)


def _sync_flushed(tmp_path, cuts=(30, 60, 90), paging=True):
    """Both stores: ingest up to each cut, then flush every group with a
    fixed ingestion time (so even that column agrees)."""
    (j, jshard), (t, tshard) = disk_stores(tmp_path, paging=paging)
    lo = 0
    for i, hi in enumerate(cuts):
        for off, c in stream()[lo:hi]:
            assert jshard.ingest_container(c, off) == \
                tshard.ingest_container(c, off)
        assert jshard.flush_all(ingestion_time=1000 * (i + 1)) == \
            tshard.flush_all(ingestion_time=1000 * (i + 1))
        lo = hi
    return (j, jshard), (t, tshard)


def test_rows_byte_equal_after_sync_flushes(tmp_path, paging):
    _sync_flushed(tmp_path, paging=paging)
    q = "SELECT * FROM chunks ORDER BY partkey, chunk_id"
    got, want = table(tmp_path / "ta.db", q), table(tmp_path / "ja.db", q)
    assert len(got) > 30 and got == want
    assert all(r[-1] != 0 for r in got)           # every row checksummed
    q = "SELECT * FROM partkeys ORDER BY partkey"
    assert table(tmp_path / "ta.db", q) == table(tmp_path / "ja.db", q)
    q = "SELECT * FROM checkpoints ORDER BY grp"
    assert table(tmp_path / "tam.db", q) == table(tmp_path / "jam.db", q)


@pytest.mark.parametrize("flush_remaining", [False, True])
def test_rows_byte_equal_after_scheduled_flushes(tmp_path, flush_remaining,
                                                 paging):
    (j, jshard), (t, tshard) = disk_stores(tmp_path, paging=paging)
    records = stream()[:70]
    _, jsnaps = drive(jshard, records, True, flush_remaining)
    _, tsnaps = drive(tshard, records, False, flush_remaining)
    assert tsnaps == jsnaps
    got = chunk_rows(tmp_path / "ta.db")
    assert got and got == chunk_rows(tmp_path / "ja.db")
    q = "SELECT * FROM partkeys ORDER BY partkey"
    assert table(tmp_path / "ta.db", q) == table(tmp_path / "ja.db", q)
    q = "SELECT * FROM checkpoints ORDER BY grp"
    assert table(tmp_path / "tam.db", q) == table(tmp_path / "jam.db", q)


def test_read_back_reopen_and_scans(tmp_path, paging):
    (j, jshard), (t, tshard) = _sync_flushed(tmp_path, paging=paging)
    pks = sorted(p.partkey for p in tshard.partitions.values())
    mem = {p.partkey: p.chunks for p in tshard.partitions.values()}
    for store in (t.store, DiskColumnStore(str(tmp_path / "ta.db"))):
        got = dict(store.read_raw_partitions("prom", 0, pks[::-1], 0,
                                             2**62))
        assert sorted(got) == pks
        for pk, css in got.items():
            assert [(c.info, c.schema_hash) for c in css] == \
                [(c.info, c.schema_hash) for c in mem[pk]]
            assert [[bytes(v) for v in c.vectors] for c in css] == \
                [[bytes(v) for v in c.vectors] for c in mem[pk]]
    # a time range selects the overlapping chunks, on both sides
    lo, hi = T0 + 35 * STEP, T0 + 50 * STEP
    got = [(pk, [c.info.chunk_id for c in css]) for pk, css in
           t.store.read_raw_partitions("prom", 0, pks, lo, hi)]
    want = [(pk, [c.info.chunk_id for c in css]) for pk, css in
            j.store.read_raw_partitions("prom", 0, pks, lo, hi)]
    assert got == want and got
    assert t.store.read_raw_rows("prom", 0, pks, lo, hi) == \
        j.store.read_raw_rows("prom", 0, pks, lo, hi)
    assert t.store.read_raw_rows("prom", 0, None, lo, hi) == \
        j.store.read_raw_rows("prom", 0, None, lo, hi)
    assert t.store.scan_bytes("prom", 0, pks, lo, hi) == \
        j.store.scan_bytes("prom", 0, pks, lo, hi) > 0
    with pytest.raises(ScanBytesExceeded):
        t.store.read_raw_rows("prom", 0, pks, 0, 2**62, byte_cap=10)
    # scans by ingestion time: the second flush only
    got = [(i, c.partkey, c.info.chunk_id) for i, c in
           t.store.chunksets_with_ingestion_time("prom", 0, 1500, 2500)]
    want = [(i, c.partkey, c.info.chunk_id) for i, c in
            j.store.chunksets_with_ingestion_time("prom", 0, 1500, 2500)]
    assert got == want and {i for i, *_ in got} == {2000}
    assert [vars(c.info) for c in t.store.chunksets_by_ingestion_time(
        "prom", 0, 0, 10**6)] == [vars(c.info) for c in
                                  j.store.chunksets_by_ingestion_time(
                                      "prom", 0, 0, 10**6)]
    assert t.store.num_chunks("prom", 0) == j.store.num_chunks("prom", 0)
    assert t.store.list_shards("prom") == [0]


def test_part_key_admin_and_meta(tmp_path):
    (j, jshard), (t, tshard) = _sync_flushed(tmp_path, cuts=(40,))
    key = lambda r: r.partkey  # noqa: E731
    got = sorted(t.store.scan_part_keys("prom", 0), key=key)
    want = sorted(j.store.scan_part_keys("prom", 0), key=key)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    # merge widens lifetimes, write replaces them
    recs = [PartKeyRecord(got[0].partkey, 1, 2**40, 0, 7)]
    jrecs = [JPartKeyRecord(got[0].partkey, 1, 2**40, 0, 7)]
    t.store.merge_part_keys("prom", 0, recs)
    j.store.merge_part_keys("prom", 0, jrecs)
    q = "SELECT * FROM partkeys ORDER BY partkey"
    assert table(tmp_path / "ta.db", q) == table(tmp_path / "ja.db", q)
    assert t.store.delete_part_keys("prom", 0, [got[1].partkey]) == \
        j.store.delete_part_keys("prom", 0, [got[1].partkey]) == 1
    assert chunk_rows(tmp_path / "ta.db") == chunk_rows(tmp_path / "ja.db")
    # clone into shard 1, then drop it again
    keep = lambda pk: pk[-1] % 2 == 0  # noqa: E731
    assert t.store.clone_shard("prom", 0, 1, keep) == \
        j.store.clone_shard("prom", 0, 1, keep) > 0
    assert chunk_rows(tmp_path / "ta.db") == chunk_rows(tmp_path / "ja.db")
    assert t.store.delete_shard("prom", 1) == \
        j.store.delete_shard("prom", 1) > 0
    assert chunk_rows(tmp_path / "ta.db") == chunk_rows(tmp_path / "ja.db")
    # the meta store: checkpoints, earliest/highest, the kv table
    for m in (t.meta, DiskMetaStore(str(tmp_path / "tam.db"))):
        assert m.read_checkpoints("prom", 0) == \
            j.meta.read_checkpoints("prom", 0)
        assert m.read_earliest_checkpoint("prom", 0) == \
            j.meta.read_earliest_checkpoint("prom", 0) >= 0
        assert m.read_highest_checkpoint("prom", 0) == \
            j.meta.read_highest_checkpoint("prom", 0)
    for m in (t.meta, j.meta):
        m.write_kv("split/a_b", "1")
        m.write_kv("split/a%c", "2")
        m.write_kv("other", "3")
        m.write_dataset("prom", "{}")
    assert t.meta.list_kv("split/a_") == j.meta.list_kv("split/a_") == \
        {"split/a_b": "1"}
    assert t.meta.read_kv("other") == "3" and t.meta.read_dataset("prom")
    t.meta.delete_kv("other")
    assert t.meta.read_kv("other") is None
    assert t.meta.list_datasets() == j.meta.list_datasets() == ["prom"]
    t.meta.delete_checkpoints("prom", 0)
    assert t.meta.read_checkpoints("prom", 0) == {}
    assert t.meta.read_earliest_checkpoint("prom", 0) == -1


def test_pack_vectors_round_trip():
    rng = np.random.default_rng(1)
    vecs = [rng.bytes(int(n)) for n in (0, 1, 300, 70000)]
    blob = pack_vectors(vecs)
    assert [bytes(v) for v in unpack_vectors(blob)] == vecs
    from filodb_tpu.store.persistence import pack_vectors as jpack
    assert blob == jpack(vecs)


def test_in_memory_stores_match_jax(tmp_path):
    (j, jshard), (t, tshard) = _sync_flushed(tmp_path, cuts=(40,))
    mine, theirs = InMemoryColumnStore(), JInMemory()
    css = [c for p in tshard.partitions.values() for c in p.chunks]
    jcss = [c for p in jshard.partitions.values() for c in p.chunks]
    mine.write_chunks("prom", 0, css, 5)
    theirs.write_chunks("prom", 0, jcss, 5)
    pks = [c.partkey for c in css]
    got = [(pk, [c.info.chunk_id for c in v]) for pk, v in
           mine.read_raw_partitions("prom", 0, pks, 0, 2**62)]
    want = [(pk, [c.info.chunk_id for c in v]) for pk, v in
            theirs.read_raw_partitions("prom", 0, pks, 0, 2**62)]
    assert got == want and got
    assert mine.scan_bytes("prom", 0, pks, 0, 2**62) == \
        theirs.scan_bytes("prom", 0, pks, 0, 2**62)
    assert mine.read_raw_rows("prom", 0, pks, 0, 1) is None
    mine.write_part_keys("prom", 0, [PartKeyRecord(pks[0], 1, 2, 0)])
    assert mine.delete_part_keys("prom", 0, [pks[0]]) == 1
    meta, jmeta = InMemoryMetaStore(), JInMemoryMeta()
    for m in (meta, jmeta):
        m.write_checkpoint("prom", 0, 2, 9)
        m.write_checkpoint("prom", 0, 1, 4)
    assert meta.read_earliest_checkpoint("prom", 0) == 4 == \
        jmeta.read_earliest_checkpoint("prom", 0)
    assert meta.read_highest_checkpoint("prom", 0) == 9


def test_recover_index_and_crash_replay_match_jax(tmp_path, paging):
    (j, jshard), (t, tshard) = disk_stores(tmp_path, paging=paging)
    records = stream()
    crash = len(records) * 3 // 5
    drive(jshard, records[:crash], True, flush_remaining=False)
    drive(tshard, records[:crash], False, flush_remaining=False)
    # a new memstore over the same files: index, watermarks, replay
    (j2, jshard2), (t2, tshard2) = disk_stores(tmp_path, paging=paging)
    assert t2.recover_index("prom", 0) == j2.recover_index("prom", 0) > 0
    assert tshard2.part_schema_hash == jshard2.part_schema_hash
    assert tshard2.part_set == jshard2.part_set
    assert t2.prepare_recovery("prom", 0) == j2.prepare_recovery("prom", 0)
    resume = t2.prepare_recovery("prom", 0)[0]
    assert resume is not None and 0 < resume < crash
    assert tshard2.group_watermarks == jshard2.group_watermarks
    drive(jshard2, records[resume:], True, flush_remaining=True)
    drive(tshard2, records[resume:], False, flush_remaining=True)
    assert tshard2.stats.rows_skipped == jshard2.stats.rows_skipped
    assert tshard2.group_watermarks == jshard2.group_watermarks
    got, want = samples(tshard2), samples(jshard2)
    assert got.keys() == want.keys() and len(got) == 12
    for pk in got:
        np.testing.assert_array_equal(got[pk][0], want[pk][0])
        np.testing.assert_array_equal(got[pk][1], want[pk][1])
    assert chunk_rows(tmp_path / "ta.db") == chunk_rows(tmp_path / "ja.db")
    # nothing lost, nothing twice: disk + replayed memory = the stream
    pks = sorted(got)
    disk = dict(t2.store.read_raw_partitions("prom", 0, pks, 0, 2**62))
    from filodb_tpu_torch.core.chunk import decode_chunkset
    from tests.torch_durable_data import N_ROWS
    for pk in pks:
        sch = tshard2.partitions[tshard2.part_set[pk]].schema
        ts = np.concatenate([decode_chunkset(sch, c)[0] for c in disk[pk]])
        assert len(np.unique(ts)) == N_ROWS        # every row, once
        assert set(got[pk][0]) <= set(ts)


def test_recover_stream_watermark_skip_matches_jax(tmp_path, paging):
    (j, jshard), (t, tshard) = disk_stores(tmp_path, paging=paging)
    records = stream()
    for off, c in records[:50]:
        jshard.ingest_container(c, off)
        tshard.ingest_container(c, off)
    # two groups checkpoint early, two late: the replay skips per group
    for g, cut in ((0, 20), (1, 20), (2, 49), (3, 49)):
        for m in (j, t):
            m.meta.write_checkpoint("prom", 0, g, cut)
    (j2, jshard2), (t2, tshard2) = disk_stores(tmp_path, paging=paging)
    n = t2.recover_stream("prom", 0, records[21:60])
    assert n == j2.recover_stream("prom", 0, records[21:60]) > 0
    assert tshard2.stats.rows_skipped == jshard2.stats.rows_skipped > 0
    got, want = samples(tshard2), samples(jshard2)
    assert got.keys() == want.keys()
    for pk in got:
        np.testing.assert_array_equal(got[pk][0], want[pk][0])


def test_failed_write_requeues_like_jax(tmp_path, paging):
    (j, jshard), (t, tshard) = disk_stores(tmp_path, paging=paging)
    for off, c in stream()[:30]:
        jshard.ingest_container(c, off)
        tshard.ingest_container(c, off)
    for m in (j, t):
        real = m.store.write_chunks
        calls = []

        def flaky(*a, _real=real, _calls=calls, **k):
            _calls.append(1)
            if len(_calls) == 1:
                raise OSError("disk full")
            return _real(*a, **k)

        m.store.write_chunks = flaky
    for sh in (jshard, tshard):
        with pytest.raises(OSError):
            sh.flush_group(0, ingestion_time=7)
    assert t.meta.read_checkpoints("prom", 0) == {} == \
        j.meta.read_checkpoints("prom", 0)
    from filodb_tpu_torch.utils.observability import flush_metrics
    fails = flush_metrics()["failures"].value(dataset="prom")
    assert fails >= 1
    # the next flush persists what the failed one collected
    assert tshard.flush_all(ingestion_time=8) == \
        jshard.flush_all(ingestion_time=8)
    q = "SELECT * FROM chunks ORDER BY partkey, chunk_id"
    assert table(tmp_path / "ta.db", q) == table(tmp_path / "ja.db", q)
    assert tshard.stats.flushes_done == jshard.stats.flushes_done


def test_ingest_stream_modes_match_jax(tmp_path, paging):
    (j, jshard), (t, tshard) = disk_stores(tmp_path, "e", paging=paging)
    records = stream()[:45]
    assert t.ingest_stream("prom", 0, records, flush_each=10) == \
        j.ingest_stream("prom", 0, records, flush_each=10)
    q = "SELECT * FROM checkpoints ORDER BY grp"
    assert table(tmp_path / "tem.db", q) == table(tmp_path / "jem.db", q)
    (j, jshard), (t, tshard) = disk_stores(tmp_path, "f", paging=paging)
    assert t.ingest_stream("prom", 0, records, flush_interval_ms=1_800_000) \
        == j.ingest_stream("prom", 0, records, flush_interval_ms=1_800_000)
    assert tshard.flush_scheduler is None
    assert chunk_rows(tmp_path / "tf.db") == chunk_rows(tmp_path / "jf.db")
    assert table(tmp_path / "tfm.db", q) == table(tmp_path / "jfm.db", q)
    with pytest.raises(ValueError):
        t.ingest_stream("prom", 0, records, flush_each=1,
                        flush_interval_ms=1)
    assert t.has_shard("prom", 0) and t.drop_shard("prom", 0)
    assert not t.has_shard("prom", 0) and not t.drop_shard("prom", 0)


def test_ingest_stream_without_final_flush_matches_a_crash(tmp_path,
                                                          paging):
    """``ingest_stream(flush_remaining=False)`` drains the scheduled
    flushes and leaves the rest buffered: the same rows and checkpoints
    as the JAX package's scheduler closed without a final flush."""
    (j, jshard), (t, tshard) = disk_stores(tmp_path, "g", paging=paging)
    records = stream()[:70]
    drive(jshard, records, True, flush_remaining=False)
    assert t.ingest_stream("prom", 0, records, flush_interval_ms=INTERVAL,
                           flush_remaining=False) > 0
    assert tshard.flush_scheduler is None
    got = chunk_rows(tmp_path / "tg.db")
    assert got and got == chunk_rows(tmp_path / "jg.db")
    q = "SELECT * FROM checkpoints ORDER BY grp"
    assert table(tmp_path / "tgm.db", q) == table(tmp_path / "jgm.db", q)
    # what no flush took is still in memory, as in the JAX package's store
    assert tshard.flush_all(ingestion_time=9) == \
        jshard.flush_all(ingestion_time=9) > 0
