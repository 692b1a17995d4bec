"""The integrity package of the port against the JAX package's: CRC32C
(the C kernel and the Python table loop), the chunk checksum's never-0
rule, the quarantine registry, the seeded fault injector and the
structured errors it provokes, the offline chunk verifier, the
read-side verify switch, and the shard's integrity tripwire.

Everything here is host code and exact: checksums, victims, error
fields and verifier counts must be equal, not close."""

import numpy as np
import pytest
import torch

from filodb_tpu import integrity as jintegrity
from filodb_tpu import native as jnative
from filodb_tpu.integrity import faultinject as jfaultinject
from filodb_tpu.integrity import scan as jscan
from filodb_tpu.integrity.quarantine import \
    QuarantineRegistry as JQuarantineRegistry
from filodb_tpu_torch import integrity
from filodb_tpu_torch import native
from filodb_tpu_torch.integrity import faultinject, scan
from filodb_tpu_torch.integrity.quarantine import QuarantineRegistry
from tests.torch_durable_data import (clear_quarantines,  # noqa: F401
                                      disk_stores, paging, stream)

torch.set_num_threads(1)


# ------------------------------------------------------------------ CRC32C

def test_crc32c_check_value():
    # the standard CRC32C check value, through every implementation
    assert native.crc32c(b"123456789") == 0xE3069283
    assert integrity.crc32c_py(b"123456789") == 0xE3069283
    assert jnative.crc32c(b"123456789") == 0xE3069283
    assert integrity.chunk_crc(b"123456789") == 0xE3069283


@pytest.mark.parametrize("seed", range(4))
def test_chunk_crc_matches_jax(seed):
    rng = np.random.default_rng(seed)
    blobs = [rng.bytes(int(n)) for n in rng.integers(0, 3000, 40)]
    got = [integrity.chunk_crc(b) for b in blobs]
    assert got == [jintegrity.chunk_crc(b) for b in blobs]
    assert got == [integrity.crc32c_py(b) or 1 for b in blobs]
    # one batched native verify over the same blobs, one entry corrupted
    exp = list(got)
    exp[7] ^= 1
    bad, ok = native.crc32c_verify(blobs, exp)
    jbad, jok = jnative.crc32c_verify(blobs, exp)
    assert bad == jbad == 1 and ok.tolist() == jok.tolist()
    assert not ok[7] and ok.sum() == len(blobs) - 1


def _zero_crc_blob() -> bytes:
    """A message whose CRC32C is 0: CRC is affine in the message bits
    over GF(2), so a 4-byte suffix solving A x = c zeroes it."""
    msg = b"filodb chunk"
    base = integrity.crc32c_py(msg + b"\0\0\0\0")
    cols = [integrity.crc32c_py(msg + (1 << i).to_bytes(4, "little"))
            ^ base for i in range(32)]
    # Gaussian elimination on 32 columns, each a 32-bit int
    rows = [[(cols[j] >> r) & 1 for j in range(32)] + [(base >> r) & 1]
            for r in range(32)]
    piv = []
    r = 0
    for c in range(32):
        p = next((i for i in range(r, 32) if rows[i][c]), None)
        if p is None:
            continue
        rows[r], rows[p] = rows[p], rows[r]
        for i in range(32):
            if i != r and rows[i][c]:
                rows[i] = [a ^ b for a, b in zip(rows[i], rows[r])]
        piv.append(c)
        r += 1
    x = 0
    for i, c in enumerate(piv):
        x |= rows[i][32] << c
    return msg + x.to_bytes(4, "little")


def test_chunk_crc_never_zero():
    blob = _zero_crc_blob()
    assert integrity.crc32c_py(blob) == 0 == native.crc32c(blob)
    # 0 marks "no checksum": a real 0 maps to 1 on both sides
    assert integrity.chunk_crc(blob) == 1 == jintegrity.chunk_crc(blob)
    bad, ok = native.crc32c_verify([blob], [1])
    assert bad == 0 and ok.tolist() == [True]


# -------------------------------------------------------------- quarantine

def test_quarantine_registry_matches_jax():
    rng = np.random.default_rng(5)
    mine, theirs = QuarantineRegistry(max_details=8), \
        JQuarantineRegistry(max_details=8)
    pks = [bytes([i]) * 5 for i in range(6)]
    for step in range(60):
        pk = pks[int(rng.integers(len(pks)))]
        cid = int(rng.integers(10))
        span = {} if step % 7 == 0 else {
            "start_time": int(cid * 100), "end_time": int(cid * 100 + 50)}
        assert mine.quarantine(pk, cid, reason="r", **span) == \
            theirs.quarantine(pk, cid, reason="r", **span)
        if step == 40:
            mine.clear()
            theirs.clear()
        assert mine.epoch() == theirs.epoch()
        assert mine.total() == theirs.total()
        assert bool(mine) == bool(theirs)
        for p in pks:
            assert mine.chunk_ids(p) == theirs.chunk_ids(p)
            assert mine.is_quarantined(p, cid) == \
                theirs.is_quarantined(p, cid)
        lo, hi = sorted(int(v) for v in rng.integers(0, 1100, 2))
        assert mine.count_overlapping(pks[:4], lo, hi) == \
            theirs.count_overlapping(pks[:4], lo, hi)
    strip = ("at_ms",)
    assert [{k: v for k, v in d.items() if k not in strip}
            for d in mine.items()] == \
        [{k: v for k, v in d.items() if k not in strip}
         for d in theirs.items()]
    assert mine.summary() == theirs.summary()


# ---------------------------------------------------------- fault injector

@pytest.mark.parametrize("seed", range(3))
def test_byte_ops_match_jax(seed):
    mine, theirs = faultinject.FaultInjector(seed), \
        jfaultinject.FaultInjector(seed)
    data = np.random.default_rng(seed).bytes(300)
    for _ in range(5):
        assert mine.flip_byte(data) == theirs.flip_byte(data)
        assert mine.truncate(data) == theirs.truncate(data)


def _flushed(tmp_path, paging=True):
    """Both packages' stores after the same ingest and two flushes (two
    chunks a series)."""
    (j, jshard), (t, tshard) = disk_stores(tmp_path, paging=paging)
    for lo, hi in ((0, 20), (20, 40)):
        for off, c in stream()[lo:hi]:
            jshard.ingest_container(c, off)
            tshard.ingest_container(c, off)
        jshard.flush_all(ingestion_time=hi)
        tshard.flush_all(ingestion_time=hi)
    return (j, jshard), (t, tshard)


@pytest.mark.parametrize("mode", ["flip", "truncate", "crc"])
def test_corrupt_stored_chunk_same_victim_and_error(tmp_path, mode, paging):
    (j, jshard), (t, tshard) = _flushed(tmp_path, paging=paging)
    seed = 11
    jv = jfaultinject.FaultInjector(seed).corrupt_stored_chunk(
        j.store, "prom", 0, mode=mode)
    tv = faultinject.FaultInjector(seed).corrupt_stored_chunk(
        t.store, "prom", 0, mode=mode)
    assert jv == tv
    pks = [r.partkey for r in t.store.scan_part_keys("prom", 0)]
    got = dict(t.store.read_raw_partitions("prom", 0, pks, 0, 2**62))
    want = dict(j.store.read_raw_partitions("prom", 0, pks, 0, 2**62))
    assert {k: [c.info.chunk_id for c in v] for k, v in got.items()} == \
        {k: [c.info.chunk_id for c in v] for k, v in want.items()}
    assert tv[1] not in [c.info.chunk_id for c in got.get(tv[0], [])]
    # the same structured error, quarantined on both sides
    for reg in (integrity.QUARANTINE, jintegrity.QUARANTINE):
        assert reg.is_quarantined(*tv) and reg.total() == 1
    d, jd = integrity.QUARANTINE.items()[0], jintegrity.QUARANTINE.items()[0]
    for k in ("partkey", "chunk_id", "dataset", "shard", "reason",
              "start_time", "end_time", "detail"):
        assert d[k] == jd[k], k
    assert "checksum" in d["reason"]
    # the store-level detection reached the registered shard's tally
    assert tshard.stats.chunks_corrupt == 1
    assert tshard.stats.chunks_quarantined == 1


@pytest.mark.parametrize("mode", ["wire", "flip", "truncate"])
@pytest.mark.parametrize("seed", [0, 3])
def test_corrupt_staged_chunk_same_error_fields(tmp_path, mode, seed,
                                               paging):
    (j, jshard), (t, tshard) = _flushed(tmp_path, paging=paging)
    pid = 4
    jpart, tpart = jshard.partitions[pid], tshard.partitions[pid]
    assert jpart.partkey == tpart.partkey
    jcid = jfaultinject.FaultInjector(seed).corrupt_staged_chunk(
        jpart, mode=mode)
    tcid = faultinject.FaultInjector(seed).corrupt_staged_chunk(
        tpart, mode=mode)
    assert jcid == tcid
    errs, jerrs = [], []
    tpart.on_corrupt = lambda e, new: errs.append((e, new))
    jpart.on_corrupt = lambda e, new: jerrs.append((e, new))
    got_ts, got_v = tpart.read_range(0, 2**62)
    want_ts, want_v = jpart.read_range(0, 2**62)
    np.testing.assert_array_equal(got_ts, want_ts)
    np.testing.assert_array_equal(got_v, want_v)
    assert len(errs) == len(jerrs)
    for (e, new), (je, jnew) in zip(errs, jerrs):
        assert new == jnew
        for k in ("kind", "partkey", "chunk_id", "codec", "window",
                  "start_time", "end_time", "reason"):
            assert getattr(e, k) == getattr(je, k), k
        assert isinstance(e, ValueError)
    if mode == "wire":
        # an invalid wire-type byte always fails the decode: quarantined,
        # and the rest of the partition still served
        assert errs and errs[0][0].codec == 0xEE
        assert errs[0][0].chunk_id == tcid
        assert integrity.QUARANTINE.is_quarantined(tpart.partkey, tcid)
        assert len(got_ts) > 0


# ----------------------------------------------------------------- verifier

@pytest.mark.parametrize("deep", [False, True])
def test_verify_chunks_matches_jax(tmp_path, deep, paging):
    (j, jshard), (t, tshard) = _flushed(tmp_path, paging=paging)
    base = scan.verify_chunks(t.store, "prom", deep=deep)
    assert base["total_failed"] == 0
    assert base["shards"][0]["chunks"] == base["shards"][0]["passed"] > 0
    assert base == jscan.verify_chunks(j.store, "prom", deep=deep)
    # a checksum corruption, and one the stored crc was recomputed over
    # (only the deep decode can catch that one)
    for seed, kw in ((1, {"mode": "crc"}),
                     (2, {"mode": "flip", "fix_crc": True})):
        jfaultinject.FaultInjector(seed).corrupt_stored_chunk(
            j.store, "prom", 0, **kw)
        faultinject.FaultInjector(seed).corrupt_stored_chunk(
            t.store, "prom", 0, **kw)
    got = scan.verify_chunks(t.store, "prom", deep=deep)
    assert got == jscan.verify_chunks(j.store, "prom", deep=deep)
    assert got["total_failed"] >= 1
    if not deep:
        assert got["total_failed"] == 1


def test_verify_chunk_row_codec_error():
    # a framed blob whose one vector has an unknown wire type
    from filodb_tpu_torch.store.persistence import pack_vectors
    blob = pack_vectors([b"\xee\x00\x01"])
    crc = integrity.chunk_crc(blob)
    scan.verify_chunk_row(b"pk", 7, blob, crc)          # shallow passes
    with pytest.raises(integrity.CorruptVectorError) as e:
        scan.verify_chunk_row(b"pk", 7, blob, crc, deep=True)
    with pytest.raises(jintegrity.CorruptVectorError) as je:
        jscan.verify_chunk_row(b"pk", 7, blob, crc, deep=True)
    assert (e.value.codec, e.value.chunk_id, e.value.kind, str(e.value)) == \
        (je.value.codec, je.value.chunk_id, je.value.kind, str(je.value))


def test_invariant_failure_counts_and_logs(caplog):
    from filodb_tpu_torch.utils.observability import integrity_metrics
    m = integrity_metrics()["invariant_failures"]
    n0 = m.value(dataset="d", shard="3")
    integrity.note_invariant_failure("d", 3, "reclaim meta size")
    assert m.value(dataset="d", shard="3") == n0 + 1
    assert "integrity invariant failed" in caplog.text
    assert "flight recorder dump" in caplog.text


def test_verify_switch_off_serves_unchecked_rows(tmp_path, monkeypatch,
                                                paging):
    """FILODB_INTEGRITY_VERIFY=0 (``set_verify(False)``): read-back skips
    the checksum, so a flipped byte is served as stored and nothing is
    quarantined, in both packages; switched back on, the same read drops
    and quarantines the row."""
    monkeypatch.setattr(integrity, "_VERIFY", integrity.verify_enabled())
    monkeypatch.setattr(jintegrity, "_VERIFY", jintegrity.verify_enabled())
    (j, _jshard), (t, _tshard) = _flushed(tmp_path, paging=paging)
    victim = faultinject.FaultInjector(5).corrupt_stored_chunk(
        t.store, "prom", 0)
    assert jfaultinject.FaultInjector(5).corrupt_stored_chunk(
        j.store, "prom", 0) == victim
    pks = [r.partkey for r in t.store.scan_part_keys("prom", 0)]

    def blobs(store):
        return {(pk, c.info.chunk_id): [bytes(v) for v in c.vectors]
                for pk, css in store.read_raw_partitions("prom", 0, pks, 0,
                                                         2**62)
                for c in css}

    integrity.set_verify(False)
    jintegrity.set_verify(False)
    assert not integrity.verify_enabled()
    got, want = blobs(t.store), blobs(j.store)
    assert victim in got and got == want
    assert integrity.QUARANTINE.total() == 0
    assert jintegrity.QUARANTINE.total() == 0
    integrity.set_verify(True)
    jintegrity.set_verify(True)
    got, want = blobs(t.store), blobs(j.store)
    assert victim not in got and got == want
    assert integrity.QUARANTINE.is_quarantined(*victim)
    assert jintegrity.QUARANTINE.is_quarantined(*victim)


def test_failed_shard_refuses_scan_batch(tmp_path, paging):
    """Once ``integrity_failed`` is set, ``scan_batch`` refuses to serve
    with IntegrityInvariantError, as the JAX package's shard does."""
    (_j, jshard), (_t, tshard) = _flushed(tmp_path, paging=paging)
    ids = sorted(tshard.partitions)
    tags, batch = tshard.scan_batch(ids, 0, 2**62)
    assert len(tags) == len(ids) and batch is not None
    tshard.integrity_failed = jshard.integrity_failed = "reclaim meta size"
    with pytest.raises(jintegrity.IntegrityInvariantError) as je:
        jshard.scan_batch(ids, 0, 2**62)
    with pytest.raises(integrity.IntegrityInvariantError) as te:
        tshard.scan_batch(ids, 0, 2**62)
    assert str(te.value) == str(je.value)
    assert "reclaim meta size" in str(te.value)
