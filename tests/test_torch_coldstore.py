"""The port's cold tier's store layer (``filodb_tpu_torch.coldstore``)
against the JAX package's (``filodb_tpu.coldstore``): the bucket, the
object-key codec, ``ColdChunkStore`` beneath a ``TieredColumnStore`` and
the ``AgeOutManager`` with its watermarks.  Each comparison drives both
packages over the same gauge data (numpy, a seed), ingested and flushed
in rounds into sqlite files of their own (``test_torch_persistence.py``
holds those files' rows byte for byte), and asserts the same object keys
and bytes, the same ``plan``/``run`` summaries, the same watermarks after
a reload, the same tiered reads before and after the age-out, and the
same faults: a stalled bucket refuses, a damaged object is quarantined
and never served, a corrupt local row is never archived.

Everything compared here is exact."""

import os
import time

import numpy as np
import pytest
import torch

from filodb_tpu import coldstore as jcold
from filodb_tpu import integrity as jintegrity
from filodb_tpu.coldstore import store as jstore
from filodb_tpu.core.record import RecordBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetOptions
from filodb_tpu.core.storeconfig import StoreConfig as JStoreConfig
from filodb_tpu.integrity.faultinject import FaultInjector as JFaultInjector
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.store.columnstore import ScanBytesExceeded as JScanBytes
from filodb_tpu.store.persistence import DiskColumnStore as JDiskColumnStore
from filodb_tpu.store.persistence import DiskMetaStore as JDiskMetaStore
from filodb_tpu.utils import observability as jobs
from filodb_tpu_torch import coldstore
from filodb_tpu_torch import integrity
from filodb_tpu_torch.coldstore import store as tstore
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.integrity.faultinject import FaultInjector
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.store.columnstore import ScanBytesExceeded
from filodb_tpu_torch.store.persistence import DiskColumnStore, DiskMetaStore
from filodb_tpu_torch.utils import observability as tobs
from tests.torch_durable_data import clear_quarantines, opened  # noqa: F401

torch.set_num_threads(1)

T0 = 1_700_000_000_000
STEP = 10_000
N_SERIES = 5
ROUND_ROWS = 10          # rows a flush round: one chunk a series a round
ROUNDS = 4
ALL = (0, 2 ** 62)


class Pkg:
    """One package's store-layer names."""

    def __init__(self, jax: bool):
        self.jax = jax
        self.cold = jcold if jax else coldstore
        self.store = jstore if jax else tstore
        self.integrity = jintegrity if jax else integrity
        self.metrics = jobs.coldstore_metrics if jax \
            else tobs.coldstore_metrics
        self.scan_bytes_exceeded = JScanBytes if jax else ScanBytesExceeded
        self.fault = JFaultInjector if jax else FaultInjector

    def disk(self, path):
        return (JDiskColumnStore if self.jax else DiskColumnStore)(path)

    def meta(self, path):
        return (JDiskMetaStore if self.jax else DiskMetaStore)(path)

    def memstore(self, store, meta):
        if self.jax:
            return JMemStore(store, meta)
        return TimeSeriesMemStore(store, meta, device="cpu")

    def setup(self, ms):
        if self.jax:
            return ms.setup("prom", J_SCHEMAS, 0, JStoreConfig())
        return ms.setup("prom", DEFAULT_SCHEMAS, 0, StoreConfig())

    def counters(self) -> dict:
        """The family's counters, summed over their labels."""
        return {k: m.total() for k, m in self.metrics().items()
                if k != "watermark"}


JAX, PORT = Pkg(True), Pkg(False)


def round_containers(seed: int = 7) -> list:
    """Gauge rows of N_SERIES series, ROUNDS rounds of ROUND_ROWS rows
    each: the containers of each round, from the JAX package's
    ``RecordBuilder`` (both packages ingest the same bytes)."""
    rng = np.random.default_rng(seed)
    n = ROUNDS * ROUND_ROWS
    ts = T0 + np.arange(n, dtype=np.int64) * STEP
    vals = rng.random((N_SERIES, n)) + np.arange(N_SERIES)[:, None]
    out = []
    for r in range(ROUNDS):
        cut = slice(r * ROUND_ROWS, (r + 1) * ROUND_ROWS)
        b = RecordBuilder(J_SCHEMAS["gauge"], DatasetOptions())
        for i in range(N_SERIES):
            b.add_series(ts[cut], [vals[i, cut]],
                         {"_metric_": "cm", "inst": f"i{i}", "_ws_": "w",
                          "_ns_": "n"})
        out.append(b.containers())
    return out


class Side:
    """One package's stores under ``tmp_path/<tag>``: a sqlite local
    tier, a ``LocalFSBucket`` under a ``ColdChunkStore``, the
    ``TieredColumnStore`` over both and a meta store; ``ingest`` drives
    the gauge rounds through a memstore over the tiered store."""

    def __init__(self, pkg: Pkg, tmp_path, tag: str):
        root = tmp_path / tag
        root.mkdir()
        self.pkg = pkg
        self.local = pkg.disk(str(root / "chunks.db"))
        self.bucket = pkg.cold.LocalFSBucket(str(root / "bucket"))
        self.cold = pkg.cold.ColdChunkStore(self.bucket,
                                            fetch_timeout_s=10.0)
        self.tiered = pkg.cold.TieredColumnStore(self.local, self.cold)
        self.meta = pkg.meta(str(root / "meta.db"))
        self.meta.initialize()
        self._closers = [self.cold.shutdown]

    def ingest(self, rounds: list) -> None:
        ms = self.pkg.memstore(self.tiered, self.meta)
        opened(ms)
        shard = self.pkg.setup(ms)
        off = 0
        for r, containers in enumerate(rounds):
            for c in containers:
                shard.ingest_container(c, off)
                off += 1
            shard.flush_all(ingestion_time=1000 + r)

    def manager(self, now_ms: int):
        return self.pkg.cold.AgeOutManager(self.local, self.cold,
                                           metastore=self.meta,
                                           now_ms_fn=lambda: now_ms)

    def objects(self) -> dict:
        """{key: bytes} of every chunk object in the bucket."""
        return {k: open(os.path.join(self.bucket.root, *k.split("/")),
                        "rb").read()
                for k in self.bucket.object_keys()}

    def reads(self, partkeys) -> tuple:
        """(read_raw_rows tuples, read_raw_partitions as (partkey,
        [(chunk id, rows, start, end, vectors)])) through the tier."""
        rows = [tuple(bytes(x) if isinstance(x, memoryview) else x
                      for x in r)
                for r in self.tiered.read_raw_rows("prom", 0, partkeys,
                                                   *ALL)]
        parts = [(pk, [(cs.info.chunk_id, cs.info.num_rows,
                        cs.info.start_time, cs.info.end_time,
                        [bytes(v) for v in cs.vectors]) for cs in css])
                 for pk, css in self.tiered.read_raw_partitions(
                     "prom", 0, partkeys, *ALL)]
        return rows, parts

    def close(self) -> None:
        for fn in self._closers:
            fn()


@pytest.fixture
def sides(tmp_path):
    """(JAX side, port side), both fed the same gauge rounds."""
    rounds = round_containers()
    pair = (Side(JAX, tmp_path, "j"), Side(PORT, tmp_path, "t"))
    for s in pair:
        s.ingest(rounds)
    yield pair
    for s in pair:
        s.close()


def _partkeys(side) -> list:
    return sorted(r.partkey for r in side.local.scan_part_keys("prom", 0))


# ---------------------------------------------------------------------------
# Bucket + key codec
# ---------------------------------------------------------------------------


class TestBucket:
    @pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
    def test_roundtrip_list_delete(self, tmp_path, pkg):
        b = pkg.cold.LocalFSBucket(str(tmp_path / "b"))
        b.put_object("chunks/a/1", b"one")
        b.put_object("chunks/a/2", b"twotwo")
        assert b.get_object("chunks/a/1", timeout_s=5) == b"one"
        assert b.list_objects("chunks/a/") == [("chunks/a/1", 3),
                                               ("chunks/a/2", 6)]
        assert b.object_keys() == ["chunks/a/1", "chunks/a/2"]
        assert b.delete_object("chunks/a/1") is True
        assert b.delete_object("chunks/a/1") is False
        with pytest.raises(pkg.cold.ObjectMissing):
            b.get_object("chunks/a/1", timeout_s=5)

    @pytest.mark.parametrize("bad", ["", "/abs", "a/../b"])
    def test_bad_keys_rejected(self, tmp_path, bad):
        for pkg in (JAX, PORT):
            b = pkg.cold.LocalFSBucket(str(tmp_path / "b"))
            with pytest.raises(ValueError):
                b.put_object(bad, b"x")
            with pytest.raises(ValueError):
                pkg.cold.bucket._check_key(bad)

    @pytest.mark.parametrize("timeout_s", [0, -1, None])
    def test_exhausted_budget_refuses_without_io(self, tmp_path, timeout_s):
        for pkg in (JAX, PORT):
            b = pkg.cold.LocalFSBucket(str(tmp_path / f"b{pkg.jax}"))
            b.put_object("chunks/k", b"v")
            with pytest.raises(pkg.cold.BucketTimeout):
                b.get_object("chunks/k", timeout_s=timeout_s)

    def test_stall_bounded_by_timeout(self, tmp_path):
        """A stalled backend delays at most timeout_s, then refuses —
        the caller is late, never wedged; a stall under the budget
        serves."""
        for pkg in (JAX, PORT):
            b = pkg.cold.LocalFSBucket(str(tmp_path / f"b{pkg.jax}"))
            b.put_object("chunks/k", b"v")
            b.stall_s = 60.0
            t0 = time.monotonic()
            with pytest.raises(pkg.cold.BucketTimeout):
                b.get_object("chunks/k", timeout_s=0.05)
            assert time.monotonic() - t0 < 5.0
            b.stall_s = 0.01
            assert b.get_object("chunks/k", timeout_s=5) == b"v"

    @pytest.mark.parametrize("mode", ["flip", "truncate"])
    def test_corrupt_object_hook(self, tmp_path, mode):
        """The damage hook leaves the same bytes in both packages."""
        got = []
        for pkg in (JAX, PORT):
            b = pkg.cold.LocalFSBucket(str(tmp_path / f"b{pkg.jax}"))
            b.put_object("chunks/k", bytes(range(40)))
            b.corrupt_object("chunks/k", mode=mode)
            got.append(b.get_object("chunks/k", timeout_s=5))
        assert got[0] == got[1] != bytes(range(40))

    def test_object_key_roundtrip(self):
        args = ("prom", 3, b"\x01pk", 42, 100, T0, T0 + 9_000, 7, 1234,
                0xDEADBEEF)
        key = tstore.object_key(*args)
        assert key == jstore.object_key(*args)
        meta = tstore.parse_object_key(key, size=10)
        assert (meta.partkey, meta.chunk_id, meta.num_rows,
                meta.start_time, meta.end_time, meta.schema_hash,
                meta.ingestion_time, meta.crc, meta.size) == \
            (b"\x01pk", 42, 100, T0, T0 + 9_000, 7, 1234, 0xDEADBEEF, 10)
        assert tuple(dataclass_values(meta)) == \
            tuple(dataclass_values(jstore.parse_object_key(key, size=10)))
        for odd in ("chunks/x/not-a-chunk", "other/p/0/ab/1.2.3.4.5.6.7",
                    "chunks/p/0/zz/1.2.3.4.5.6.7", "chunks/p/0/ab/1.2"):
            assert tstore.parse_object_key(odd, 1) is None
            assert jstore.parse_object_key(odd, 1) is None


def dataclass_values(meta):
    return [getattr(meta, f) for f in meta.__dataclass_fields__]


# ---------------------------------------------------------------------------
# Age-out against the JAX package on the same ingested data
# ---------------------------------------------------------------------------


def _cutoff_now(rounds_aged: int) -> tuple:
    """(now, retention): a cutoff just past the end of the first
    ``rounds_aged`` rounds' chunks."""
    end = T0 + (rounds_aged * ROUND_ROWS - 1) * STEP
    return end + 10 ** 6, 10 ** 6 - 1


class TestAgeOut:
    def test_local_rows_equal_before_ageout(self, sides):
        j, t = sides
        assert _partkeys(j) == _partkeys(t) and len(_partkeys(t)) == N_SERIES
        assert j.local.num_chunks("prom", 0) == \
            t.local.num_chunks("prom", 0) == N_SERIES * ROUNDS
        assert j.reads(_partkeys(j)) == t.reads(_partkeys(t))

    @pytest.mark.parametrize("rounds_aged", [0, 1, 3, 4])
    def test_plan_then_run_same_summaries_keys_and_bytes(self, sides,
                                                         rounds_aged):
        j, t = sides
        now, retention = _cutoff_now(rounds_aged)
        pks = _partkeys(t)
        before = t.reads(pks)
        plans, runs = [], []
        for s in sides:
            mgr = s.manager(now)
            plans.append(mgr.plan("prom", retention))
            # the plan is dry: nothing moved, no watermark
            assert s.local.num_chunks("prom", 0) == N_SERIES * ROUNDS
            assert s.cold.num_chunks("prom", 0) == 0
            assert mgr.floor_ms("prom") == 0
            runs.append(mgr.run("prom", retention))
        assert plans[0] == plans[1]
        assert runs[0] == runs[1]
        moved = N_SERIES * rounds_aged
        assert plans[1]["total_chunks"] == runs[1]["total_chunks"] == moved
        assert plans[1]["total_bytes"] == runs[1]["total_bytes"]
        assert runs[1]["shards"][0]["watermark_ms"] == now - retention
        assert j.objects() == t.objects()
        assert len(t.objects()) == moved
        assert t.local.num_chunks("prom", 0) == N_SERIES * ROUNDS - moved
        assert t.cold.num_chunks("prom", 0) == moved
        # the tiered reads are the same before and after, in both
        assert t.reads(pks) == before == j.reads(pks)

    def test_keys_carry_the_local_rows(self, sides):
        """Each object key names its row's metadata and CRC, and its body
        is the local row's framed blob, byte for byte."""
        j, t = sides
        rows = {(r[0], r[1]): r for r in t.reads(_partkeys(t))[0]}
        now, retention = _cutoff_now(ROUNDS)
        t.manager(now).run("prom", retention)
        objs = t.objects()
        assert len(objs) == len(rows)
        for key, body in objs.items():
            m = tstore.parse_object_key(key, len(body))
            pk, cid, nr, st, et, sh, blob, crc = rows[m.partkey, m.chunk_id]
            assert (m.num_rows, m.start_time, m.end_time, m.schema_hash,
                    m.crc, m.ingestion_time) == (nr, st, et, sh, crc,
                                                 1000 + (st - T0) //
                                                 (ROUND_ROWS * STEP))
            assert body == blob and integrity.chunk_crc(body) == crc

    def test_watermark_persists_and_floors(self, sides):
        now = T0 + 10 ** 7
        marks = []
        for s in sides:
            mgr = s.manager(now)
            mgr.run("prom", 1_000, shards=[0])
            mgr.run("prom", 2_000, shards=[1])      # a shard with no rows
            assert mgr.watermark_ms("prom", 0) == now - 1_000
            assert mgr.watermark_ms("prom", 2) == 0  # never passed
            # a FRESH manager reloads the watermarks from the meta store
            fresh = s.manager(now)
            marks.append((fresh.watermark_ms("prom", 0),
                          fresh.watermark_ms("prom", 1),
                          fresh.floor_ms("prom"), fresh.floor_ms("other"),
                          s.meta.list_kv("coldstore_ageout:")))
        assert marks[0] == marks[1]
        assert marks[1][:4] == (now - 1_000, now - 2_000, now - 2_000, 0)

    def test_malformed_watermark_ignored(self, sides):
        got = []
        for s in sides:
            s.meta.write_kv("coldstore_ageout:prom:x", "12")
            s.meta.write_kv("coldstore_ageout:prom:0", "not-a-number")
            s.meta.write_kv("coldstore_ageout:prom:1", "77")
            mgr = s.manager(T0)
            got.append((mgr.floor_ms("prom"), mgr.watermark_ms("prom", 1),
                        mgr.watermark_ms("prom", 0)))
        assert got[0] == got[1] == (77, 77, 0)

    def test_idempotent_second_pass(self, sides):
        now, retention = _cutoff_now(2)
        for s in sides:
            mgr = s.manager(now)
            assert mgr.run("prom", retention)["total_chunks"] == 2 * N_SERIES
            assert mgr.run("prom", retention)["total_chunks"] == 0
            assert s.cold.num_chunks("prom", 0) == 2 * N_SERIES
        assert sides[0].objects() == sides[1].objects()

    def test_small_delete_batch(self, sides):
        """Deletes in batches of 3: the same rows leave the local tier."""
        now, retention = _cutoff_now(ROUNDS)
        left = []
        for s in sides:
            mgr = s.manager(now)
            mgr.delete_batch = 3
            assert mgr.run("prom", retention)["total_chunks"] == \
                N_SERIES * ROUNDS
            left.append(s.local.num_chunks("prom", 0))
        assert left == [0, 0]
        assert sides[0].objects() == sides[1].objects()

    def test_metrics_after_run(self, sides):
        now, retention = _cutoff_now(ROUNDS)
        deltas = []
        for s in sides:
            before = s.pkg.counters()
            rep = s.manager(now).run("prom", retention)
            after = s.pkg.counters()
            deltas.append({k: after[k] - before[k]
                           for k in ("aged_chunks", "aged_bytes")})
            assert deltas[-1] == {"aged_chunks": rep["total_chunks"],
                                  "aged_bytes": rep["total_bytes"]}
            assert s.pkg.metrics()["watermark"].value(
                dataset="prom", shard="0") == now - retention
        assert deltas[0] == deltas[1]

    def test_corrupt_local_row_never_archived(self, sides):
        """The verified scan quarantines and skips a corrupt local row —
        corruption is never uploaded as truth, and the pass still
        completes for the healthy rows."""
        now, retention = _cutoff_now(ROUNDS)
        out = []
        for s in sides:
            pk, cid = s.pkg.fault(3).corrupt_stored_chunk(
                s.local, "prom", 0, mode="flip")
            rep = s.manager(now).run("prom", retention)
            assert rep["total_chunks"] == N_SERIES * ROUNDS - 1
            assert s.pkg.integrity.QUARANTINE.is_quarantined(pk, cid)
            archived = {(m.partkey, m.chunk_id) for m in
                        s.cold._select("prom", 0, None, *ALL)}
            assert (pk, cid) not in archived
            assert s.local.num_chunks("prom", 0) == 1   # it stays local
            out.append((pk, cid, rep))
        assert out[0] == out[1]
        assert sides[0].objects() == sides[1].objects()


# ---------------------------------------------------------------------------
# The tiered merge
# ---------------------------------------------------------------------------


class TestTieredMerge:
    def test_local_wins_overlap_and_reupload_idempotent(self, sides):
        """Crash window: a row uploaded but not yet deleted locally is
        served once (the local copy) and re-aged without error."""
        out = []
        for s in sides:
            pks = _partkeys(s)
            row = s.local.read_raw_rows("prom", 0, pks[:1], *ALL)[0]
            pk, cid, nr, st, et, sch, blob, crc = row[:8]
            s.cold.put_chunk_row("prom", 0, pk, cid, nr, st, et, sch, 1000,
                                 bytes(blob), crc, verify=True)
            rows = s.reads(pks)[0]
            assert len(rows) == N_SERIES * ROUNDS     # deduped, not doubled
            rep = s.manager(et + 10).run("prom", 1)
            assert rep["total_chunks"] == N_SERIES    # the first round
            assert s.reads(pks)[0] == rows
            out.append((rows, rep))
        assert out[0] == out[1]
        assert sides[0].objects() == sides[1].objects()

    def test_partial_reads_and_window(self, sides):
        """A part-key subset and a time window read the same rows from
        both tiers after a partial age-out."""
        now, retention = _cutoff_now(2)
        got = []
        for s in sides:
            s.manager(now).run("prom", retention)
            pks = _partkeys(s)[1:4]
            lo, hi = T0 + 15 * STEP, T0 + 32 * STEP
            rows = s.tiered.read_raw_rows("prom", 0, pks, lo, hi)
            parts = [(pk, [c.info.chunk_id for c in css]) for pk, css in
                     s.tiered.read_raw_partitions("prom", 0, pks, lo, hi)]
            nbytes = s.tiered.scan_bytes("prom", 0, pks, lo, hi)
            assert len(rows) == 3 * 3 and nbytes == sum(len(r[6])
                                                        for r in rows)
            got.append(([tuple(bytes(x) if isinstance(x, memoryview) else x
                               for x in r) for r in rows], parts, nbytes))
        assert got[0] == got[1]

    def test_rows_read_counted_and_ingestion_scan(self, sides):
        now, retention = _cutoff_now(2)
        got = []
        for s in sides:
            s.manager(now).run("prom", retention)
            s.reads(_partkeys(s))
            scanned = sorted((it, cs.partkey, cs.info.chunk_id) for it, cs in
                             s.tiered.chunksets_with_ingestion_time(
                                 "prom", 0, 1000, 1001))
            got.append((dict(s.tiered.rows_read_by_dataset), scanned))
        assert got[0] == got[1]
        assert got[1][0] == {"prom": 2 * N_SERIES * ROUNDS}
        assert len(got[1][1]) == 2 * N_SERIES        # cold rounds 0 and 1

    def test_sqlite_admin_surface_delegates(self, sides):
        j, t = sides
        assert t.tiered._conn() is t.local._conn()
        assert t.tiered.list_shards("prom") == j.tiered.list_shards("prom") \
            == [0]
        assert list(t.tiered.scan_part_keys("prom", 0)) != []

    def test_delete_part_keys_both_tiers(self, sides):
        now, retention = _cutoff_now(2)
        got = []
        for s in sides:
            s.manager(now).run("prom", retention)
            pk = _partkeys(s)[0]
            n = s.tiered.delete_part_keys("prom", 0, [pk])
            got.append((n, s.reads([pk]), sorted(s.objects())))
        assert got[0] == got[1]
        assert got[1][0] == 1 and got[1][1] == ([], [])


# ---------------------------------------------------------------------------
# Faults on the cold hop
# ---------------------------------------------------------------------------


class TestColdFaults:
    def _aged(self, sides):
        now, retention = _cutoff_now(ROUNDS)
        for s in sides:
            s.manager(now).run("prom", retention)
            assert s.local.num_chunks("prom", 0) == 0

    @pytest.mark.parametrize("mode", ["flip", "truncate"])
    def test_corrupt_object_quarantined_not_served(self, sides, mode):
        """A damaged object is dropped at CRC-on-fetch, even with
        ``defer_verify``: the other rows are served, the chunk is
        quarantined and the corrupt-fetch counter bumps once; the next
        read skips it before any fetch."""
        self._aged(sides)
        out = []
        for s in sides:
            victim = s.bucket.object_keys()[3]
            s.bucket.corrupt_object(victim, mode=mode)
            m = s.pkg.store.parse_object_key(victim, 0)
            before = s.pkg.counters()
            pks = _partkeys(s)
            rows = s.tiered.read_raw_rows("prom", 0, pks, *ALL,
                                          defer_verify=True)
            after = s.pkg.counters()
            assert len(rows) == N_SERIES * ROUNDS - 1
            assert (m.partkey, m.chunk_id) not in {(r[0], r[1])
                                                   for r in rows}
            assert s.pkg.integrity.QUARANTINE.is_quarantined(m.partkey,
                                                             m.chunk_id)
            assert after["fetch_corrupt"] - before["fetch_corrupt"] == 1
            again = s.reads(pks)
            assert after["fetch_corrupt"] == s.pkg.counters()["fetch_corrupt"]
            out.append(([tuple(bytes(x) if isinstance(x, memoryview) else x
                               for x in r) for r in rows], again))
        assert out[0] == out[1]

    def test_stalled_bucket_refuses_without_quarantine(self, sides):
        """A stall past the fetch timeout raises BucketTimeout through the
        tiered read — an availability event, not corruption: nothing is
        quarantined, the timeout counter bumps."""
        self._aged(sides)
        for s in sides:
            s.bucket.stall_s = 60.0
            s.cold.fetch_timeout_s = 0.05
            before = s.pkg.counters()
            t0 = time.monotonic()
            with pytest.raises(s.pkg.cold.BucketTimeout):
                s.tiered.read_raw_rows("prom", 0, _partkeys(s), *ALL)
            assert time.monotonic() - t0 < 5.0
            after = s.pkg.counters()
            assert after["fetch_timeouts"] - before["fetch_timeouts"] == 1
            assert after["fetches"] == before["fetches"]
            assert s.pkg.integrity.QUARANTINE.total() == 0
            s.bucket.stall_s = 0.0
            assert len(s.reads(_partkeys(s))[0]) == N_SERIES * ROUNDS

    def test_missing_object_absent_not_error(self, sides):
        self._aged(sides)
        out = []
        for s in sides:
            s.cold._shard_index("prom", 0)           # listed before
            s.bucket.delete_object(s.bucket.object_keys()[0])
            before = s.pkg.counters()
            rows = s.tiered.read_raw_rows("prom", 0, _partkeys(s), *ALL)
            after = s.pkg.counters()
            assert after["fetch_missing"] - before["fetch_missing"] == 1
            out.append([tuple(bytes(x) if isinstance(x, memoryview) else x
                              for x in r) for r in rows])
        assert out[0] == out[1] and len(out[1]) == N_SERIES * ROUNDS - 1

    def test_byte_cap_enforced_before_any_fetch(self, sides):
        self._aged(sides)
        for s in sides:
            before = s.pkg.counters()
            with pytest.raises(s.pkg.scan_bytes_exceeded):
                s.cold.read_raw_rows("prom", 0, None, *ALL, byte_cap=1)
            with pytest.raises(s.pkg.scan_bytes_exceeded):
                s.tiered.read_raw_rows("prom", 0, _partkeys(s), *ALL,
                                       byte_cap=1)
            # the refusal came from key metadata alone — zero objects read
            assert s.pkg.counters()["fetches"] == before["fetches"]

    def test_prefetch_stages_then_serves_without_fetch(self, sides):
        """Objects staged on this thread are consumed by the next read
        with no second fetch, and the fetched bytes get their own
        fmt=cold-page ledger pool until shutdown."""
        from filodb_tpu.utils.devicewatch import LEDGER as JLEDGER
        from filodb_tpu_torch.utils.devicewatch import LEDGER
        self._aged(sides)
        for s, ledger in zip(sides, (JLEDGER, LEDGER)):
            pks = _partkeys(s)
            assert s.tiered.prefetch_cold("prom", 0, pks, *ALL) == \
                N_SERIES * ROUNDS
            mid = s.pkg.counters()
            assert len(s.tiered.read_raw_rows("prom", 0, pks, *ALL)) == \
                N_SERIES * ROUNDS
            assert s.pkg.counters()["fetches"] == mid["fetches"]
            nbytes = s.tiered.cold_page_bytes("prom", 0)
            assert nbytes > 0
            assert ledger.pools()["coldstore:prom/0"]["bytes"] == nbytes
            s.cold.shutdown()
            assert "coldstore:prom/0" not in ledger.pools()
        assert sides[0].tiered.cold_page_bytes("prom", 0) == \
            sides[1].tiered.cold_page_bytes("prom", 0)


def test_metric_family_matches():
    """The same names and help texts as the JAX package's family."""
    got = {k: (m.name, m.help) for k, m in tobs.coldstore_metrics().items()}
    want = {k: (m.name, m.help) for k, m in jobs.coldstore_metrics().items()}
    assert got == want and len(got) == 8


def test_store_config_disk_ttl():
    assert StoreConfig().disk_ttl_seconds == JStoreConfig().disk_ttl_seconds \
        == 3 * 24 * 3600


def test_exports_match():
    assert coldstore.__all__ == jcold.__all__
