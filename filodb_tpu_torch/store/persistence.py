"""Durable local-disk persistence: sqlite-backed ColumnStore + MetaStore.

Plays the role of the reference's Cassandra layer with the same table
model (reference: cassandra/src/main/scala/filodb.cassandra/columnstore/
TimeSeriesChunksTable.scala:22 — chunks by (partkey, chunkId),
IngestionTimeIndexTable.scala:22 — scan-by-ingestion-time for batch jobs,
PartitionKeysTable.scala:15 — partkeys with start/end per shard,
metastore/CheckpointTable.scala:17 — checkpoints per (dataset, shard,
group)).  sqlite3 is the embedded stand-in for CQL: one database file per
store, WAL mode so concurrent readers never block the single writer —
mirroring FiloDB's single-writer-per-shard discipline.  Host code only:
the flush executor's threads write here, and nothing touches the device.

Chunk vectors are stored as one blob per chunkset: u16 vector count, then
(u32 length, bytes) per encoded vector.  The encoded vectors themselves
are the wire-compatible codec outputs (filodb_tpu_torch/codecs), so a
chunk read back from disk decodes through the exact same native fast
paths, and the files are byte-compatible with the reference package's.

Integrity: every chunk row carries the CRC32C of its framed blob
(``crc`` column), computed at write (flush) time and re-verified on
every read-back.  A mismatching row is quarantined
(filodb_tpu_torch/integrity/) and DROPPED from the result — readers serve
partial data with a warning, never bytes that fail their checksum.
Rows with ``crc=0`` predate checksums and skip verification.
"""

from __future__ import annotations

import os
import sqlite3
import struct
import threading
import time
from typing import Iterator, Sequence

from filodb_tpu_torch import integrity
from filodb_tpu_torch.core.chunk import ChunkSet, ChunkSetInfo
from filodb_tpu_torch.integrity import CorruptVectorError
from filodb_tpu_torch.store.columnstore import ColumnStore, PartKeyRecord
from filodb_tpu_torch.store.metastore import MetaStore

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")


def pack_vectors(vectors: Sequence[bytes]) -> bytes:
    out = bytearray(_U16.pack(len(vectors)))
    for v in vectors:
        out += _U32.pack(len(v))
        out += v
    return bytes(out)


def unpack_vectors(blob: bytes) -> list:
    """Zero-copy split: memoryview slices over the row blob (a read-back
    unpacks thousands of rows; byte-slice copies of every vector would
    be a measurable share of it).  All decode paths accept any buffer
    object."""
    (n,) = _U16.unpack_from(blob, 0)
    pos = _U16.size
    mv = memoryview(blob)
    vectors = []
    for _ in range(n):
        (ln,) = _U32.unpack_from(blob, pos)
        pos += _U32.size
        vectors.append(mv[pos:pos + ln])
        pos += ln
    return vectors


class _EagerCursor:
    """Pre-fetched cursor: rows are materialized while the connection lock
    is held, so no live sqlite cursor ever escapes the serialized section."""

    def __init__(self, rows: list, lastrowid, rowcount: int):
        self._rows = rows
        self._pos = 0
        self.lastrowid = lastrowid
        self.rowcount = rowcount

    def fetchall(self) -> list:
        rows = self._rows[self._pos:]
        self._rows, self._pos = [], 0
        return rows

    def fetchone(self):
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: int = 1) -> list:
        rows = self._rows[self._pos:self._pos + size]
        self._pos += len(rows)
        return rows

    def __iter__(self):
        while self._pos < len(self._rows):
            row = self._rows[self._pos]
            self._pos += 1
            yield row


class _SerializedConn:
    """One sqlite connection shared by every thread, one operation at a
    time.  Used for ':memory:' stores, where per-thread connections would
    each get their own private empty database."""

    def __init__(self, conn: sqlite3.Connection):
        self._conn = conn
        self._lock = threading.RLock()

    def execute(self, sql: str, params: Sequence = ()) -> _EagerCursor:
        with self._lock:
            cur = self._conn.execute(sql, params)
            rows = cur.fetchall() if cur.description else []
            return _EagerCursor(rows, cur.lastrowid, cur.rowcount)

    def executemany(self, sql: str, seq) -> _EagerCursor:
        with self._lock:
            cur = self._conn.executemany(sql, list(seq))
            return _EagerCursor([], cur.lastrowid, cur.rowcount)

    def executescript(self, script: str) -> None:
        with self._lock:
            self._conn.executescript(script)

    def commit(self) -> None:
        with self._lock:
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def _when_unlocked(fn, *args, wait_s: float = 30.0):
    """``fn(*args)``, retried while sqlite answers "database is locked"
    (another store or process over the same file is switching its
    journal mode), for up to ``wait_s`` like the busy timeout."""
    deadline = time.monotonic() + wait_s
    while True:
        try:
            return fn(*args)
        except sqlite3.OperationalError as e:
            if "locked" not in str(e) or time.monotonic() > deadline:
                raise
            time.sleep(0.005)


class _SqliteBase:
    """Shared connection handling: one connection per thread, WAL mode."""

    def __init__(self, path: str):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._local = threading.local()
        self._ddl_done = False  # guarded-by: _ddl_lock
        self._ddl_lock = threading.Lock()
        self._in_batch_size = None  # resolved from the sqlite var limit

    def _conn(self):
        if self.path == ":memory:":
            # plain :memory: is a fresh empty database PER CONNECTION, so a
            # second thread would see "no such table".  Every thread shares
            # ONE connection instead, serialized op-by-op (shared-cache URIs
            # were rejected: their table locks raise SQLITE_LOCKED, which
            # the busy timeout does not retry).
            with self._ddl_lock:
                conn = getattr(self, "_mem_conn", None)
                if conn is None:
                    conn = _SerializedConn(sqlite3.connect(
                        ":memory:", check_same_thread=False))
                    self._mem_conn = conn
                if not self._ddl_done:
                    self._ddl(conn)
                    self._ddl_done = True
            return conn
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # one connection set up at a time: a journal-mode switch that
            # meets another thread's connection in the middle of its own
            # switch or DDL is refused ("database is locked") instead of
            # waiting out the busy timeout, which failed flush tasks when
            # two executor threads opened the meta store together
            with self._ddl_lock:
                conn = sqlite3.connect(self.path, timeout=30.0)
                _when_unlocked(conn.execute, "PRAGMA journal_mode=WAL")
                conn.execute("PRAGMA synchronous=NORMAL")
                # blob reads via mmap skip one kernel->user copy (a bulk
                # read-back pulls megabytes of chunk blobs)
                conn.execute("PRAGMA mmap_size=1073741824")
            self._local.conn = conn
        # double-checked locking: the racy read only skips the lock on
        # the hot path; the write side re-checks under _ddl_lock
        if not self._ddl_done:
            with self._ddl_lock:
                if not self._ddl_done:
                    self._ddl(conn)
                    self._ddl_done = True
        return conn

    def _ddl(self, conn: sqlite3.Connection) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        # teardown under _ddl_lock: an unlocked reset here could
        # interleave with a concurrent _conn()'s locked create path and
        # leave a fresh connection marked DDL-less
        with self._ddl_lock:
            mem = getattr(self, "_mem_conn", None)
            if mem is not None:
                mem.close()
                self._mem_conn = None
                self._ddl_done = False  # a later use gets a fresh empty db
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


class DiskColumnStore(_SqliteBase, ColumnStore):
    """ColumnStore over a local sqlite database file."""

    def _ddl(self, conn) -> None:
        conn.executescript("""
        CREATE TABLE IF NOT EXISTS chunks (
            dataset TEXT NOT NULL, shard INTEGER NOT NULL,
            partkey BLOB NOT NULL, chunk_id INTEGER NOT NULL,
            num_rows INTEGER NOT NULL,
            start_time INTEGER NOT NULL, end_time INTEGER NOT NULL,
            ingestion_time INTEGER NOT NULL DEFAULT 0,
            schema_hash INTEGER NOT NULL DEFAULT 0,
            vectors BLOB NOT NULL,
            crc INTEGER NOT NULL DEFAULT 0,
            PRIMARY KEY (dataset, shard, partkey, chunk_id)
        ) WITHOUT ROWID;
        CREATE INDEX IF NOT EXISTS chunks_by_itime
            ON chunks (dataset, shard, ingestion_time);
        CREATE TABLE IF NOT EXISTS partkeys (
            dataset TEXT NOT NULL, shard INTEGER NOT NULL,
            partkey BLOB NOT NULL,
            start_time INTEGER NOT NULL, end_time INTEGER NOT NULL,
            schema_hash INTEGER NOT NULL DEFAULT 0,
            PRIMARY KEY (dataset, shard, partkey)
        ) WITHOUT ROWID;
        """)
        try:  # migrate pre-checksum databases in place (crc=0 skips verify)
            conn.execute(
                "ALTER TABLE chunks ADD COLUMN crc INTEGER NOT NULL DEFAULT 0")
        except sqlite3.OperationalError:
            pass  # column already exists (fresh DDL above, or migrated)
        conn.commit()

    # ------------------------------------------------------------------ sink

    def write_chunks(self, dataset, shard, chunksets, ingestion_time=0) -> int:
        conn = self._conn()
        rows = []
        for cs in chunksets:
            # checksum at encode/flush time: the blob is in cache right
            # after packing, so the CRC pass is effectively free here
            # compared to recomputing it at read time forever after
            blob = pack_vectors(cs.vectors)
            rows.append((dataset, shard, cs.partkey, cs.info.chunk_id,
                         cs.info.num_rows, cs.info.start_time,
                         cs.info.end_time, ingestion_time, cs.schema_hash,
                         blob, integrity.chunk_crc(blob)))
        conn.executemany(
            "INSERT OR REPLACE INTO chunks VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            rows)
        self._commit(conn)
        return len(chunksets)

    def write_part_keys(self, dataset, shard, records) -> int:
        conn = self._conn()
        conn.executemany(
            "INSERT OR REPLACE INTO partkeys VALUES (?,?,?,?,?,?)",
            [(dataset, shard, r.partkey, r.start_time, r.end_time,
              r.schema_hash) for r in records])
        self._commit(conn)
        return len(records)

    def merge_part_keys(self, dataset, shard, records) -> int:
        conn = self._conn()
        conn.executemany(
            "INSERT INTO partkeys VALUES (?,?,?,?,?,?) "
            "ON CONFLICT(dataset, shard, partkey) DO UPDATE SET "
            "start_time=MIN(start_time, excluded.start_time), "
            "end_time=MAX(end_time, excluded.end_time), "
            "schema_hash=excluded.schema_hash",
            [(dataset, shard, r.partkey, r.start_time, r.end_time,
              r.schema_hash) for r in records])
        self._commit(conn)
        return len(records)

    def _commit(self, conn) -> None:
        if not getattr(self._local, "defer_commits", False):
            conn.commit()

    def deferred_commits(self):
        """One durability point for a batch of write calls (thread-local:
        the flag never leaks to other threads' connections)."""
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self._local.defer_commits = True
            try:
                yield
            except BaseException:
                # the batch failed mid-way: roll the partial writes
                # back — ONE durability point means all-or-nothing
                self._local.defer_commits = False
                self._conn().rollback()
                raise
            else:
                self._local.defer_commits = False
                self._conn().commit()
        return ctx()

    # ---------------------------------------------------------------- source

    def _in_batch(self, conn) -> int:
        """Largest usable IN-list size (sqlite's host-variable limit
        minus the fixed params).  One statement per ~32k keys instead of
        one per 500 — a read-back over thousands of partkeys pays the
        per-statement overhead once a batch."""
        got = self._in_batch_size
        if got is None:
            try:
                inner = conn._conn if isinstance(conn, _SerializedConn) \
                    else conn
                got = max(inner.getlimit(
                    sqlite3.SQLITE_LIMIT_VARIABLE_NUMBER) - 8, 500)
            except Exception:
                got = 500
            self._in_batch_size = got
        return got

    def _verify_rows(self, dataset, shard, rows: list) -> list[tuple]:
        """Checksum-verify 8-tuple rows (…, vectors BLOB, stored crc)
        from sqlite; returns the surviving rows UNSLICED (consumers
        read positionally and ignore the trailing crc).  A mismatch
        quarantines the chunk and DROPS the row (the reader serves
        partial data, never unverified bytes); already-quarantined
        chunks are excluded the same way on every re-read.

        Hot path: ONE batched native CRC pass over the row blobs (no
        join, three CRC streams interleaved in the C kernel)."""
        quarantine = integrity.QUARANTINE
        if quarantine:
            rows = [r for r in rows
                    if not quarantine.is_quarantined(r[0], r[1])]
        if not rows or not integrity.verify_enabled():
            return rows
        import operator

        from filodb_tpu_torch import native
        exps = list(map(operator.itemgetter(7), rows))   # C-speed map
        got = None
        if min(exps):                        # crc=0 legacy rows: slow path
            got = native.crc32c_verify(list(map(operator.itemgetter(6),
                                                rows)), exps)
        if got is None:
            return self._verify_rows_slow(dataset, shard, rows)
        bad, ok = got
        from filodb_tpu_torch.utils.observability import integrity_metrics
        integrity_metrics()["chunks_verified"].inc(len(rows))
        if not bad:
            return rows
        out = []
        for i, r in enumerate(rows):
            if ok[i]:
                out.append(r)
            else:
                integrity.report_corrupt(CorruptVectorError(
                    f"chunk checksum mismatch on read-back "
                    f"(stored={r[7]:#010x})", partkey=r[0], chunk_id=r[1],
                    dataset=dataset, shard=shard, blob=r[6],
                    kind="checksum", start_time=r[3], end_time=r[4]))
        return out

    def _verify_rows_slow(self, dataset, shard, rows: list) -> list[tuple]:
        """Per-row verify: the no-native fallback, and the path for row
        sets containing legacy crc=0 (unverifiable) rows."""
        out: list[tuple] = []
        crc_fn = integrity.chunk_crc
        verified = 0
        for r in rows:
            crc = r[7]
            if crc:
                verified += 1
                if crc_fn(r[6]) != crc:
                    integrity.report_corrupt(CorruptVectorError(
                        f"chunk checksum mismatch on read-back "
                        f"(stored={crc:#010x})", partkey=r[0],
                        chunk_id=r[1], dataset=dataset, shard=shard,
                        blob=r[6], kind="checksum", start_time=r[3],
                        end_time=r[4]))
                    continue
            out.append(r)
        if verified:
            from filodb_tpu_torch.utils.observability import integrity_metrics
            integrity_metrics()["chunks_verified"].inc(verified)
        return out

    def _filter_quarantined(self, rows: list) -> list:
        """Drop quarantined rows only (the deferred-verify path: a bulk
        decoder that checksums the blobs on its own join)."""
        quarantine = integrity.QUARANTINE
        if not quarantine:
            return rows
        return [r for r in rows
                if not quarantine.is_quarantined(r[0], r[1])]

    def read_raw_rows(self, dataset, shard, partkeys, start_time,
                      end_time, byte_cap: int | None = None,
                      defer_verify: bool = False) -> list[tuple]:
        """Raw chunk rows (partkey, chunk_id, num_rows, start_time,
        end_time, schema_hash, framed-vectors blob, stored crc) for a
        partkey set, ordered by (partkey, chunk_id), with NO blob
        unpacking — a bulk page-in hands the framed blobs straight to a
        page decoder (one C pass for the whole set).
        Every blob is checksum-verified against its stored CRC32C;
        corrupt and quarantined rows are dropped (see
        :meth:`_verify_rows`); consumers index positionally and may
        ignore the trailing crc.

        ``byte_cap``: stream-enforced blob-byte budget; crossing it
        raises :class:`ScanBytesExceeded` (bounded overshoot of one
        fetch batch).  Folding the cap into the read replaces a separate
        LENGTH() metadata pre-pass.

        ``partkeys=None`` scans the WHOLE (dataset, shard) in primary
        key order — no per-key binding or b-tree point lookups, for a
        caller paging in most of a shard (the cold-dashboard shape);
        callers skip rows they did not ask for.

        ``defer_verify=True``: skip the checksum pass (quarantined rows
        are still dropped) — ONLY for callers that verify the stored
        crc themselves before trusting a blob (a bulk page decoder that
        checksums every span on the join it already builds)."""
        from filodb_tpu_torch.store.columnstore import ScanBytesExceeded

        check = self._filter_quarantined if defer_verify else \
            (lambda rows: self._verify_rows(dataset, shard, rows))
        conn = self._conn()
        rows: list[tuple] = []
        seen = 0
        if partkeys is None:
            batches = [None]
        else:
            partkeys = list(partkeys)
            lim = self._in_batch(conn)
            batches = [partkeys[i:i + lim]
                       for i in range(0, len(partkeys), lim)]
        for batch in batches:
            if batch is None:
                cur = conn.execute(
                    "SELECT partkey, chunk_id, num_rows, start_time, "
                    "end_time, schema_hash, vectors, crc FROM chunks "
                    "WHERE dataset=? AND shard=? "
                    "AND end_time>=? AND start_time<=? "
                    "ORDER BY partkey, chunk_id",
                    (dataset, shard, start_time, end_time))
            else:
                ph = ",".join("?" * len(batch))
                cur = conn.execute(
                    "SELECT partkey, chunk_id, num_rows, start_time, "
                    "end_time, schema_hash, vectors, crc FROM chunks "
                    f"WHERE dataset=? AND shard=? AND partkey IN ({ph}) "
                    "AND end_time>=? AND start_time<=? "
                    "ORDER BY partkey, chunk_id",
                    (dataset, shard, *batch, start_time, end_time))
            if byte_cap is None:
                rows.extend(check(cur.fetchall()))
                continue
            while True:
                got = cur.fetchmany(512)
                if not got:
                    break
                seen += sum(len(r[6]) for r in got)
                if seen > byte_cap:
                    raise ScanBytesExceeded(
                        f"raw-row read exceeded {byte_cap} bytes")
                rows.extend(check(got))
        return rows

    def read_raw_partitions(self, dataset, shard, partkeys, start_time,
                            end_time) -> Iterator[tuple[bytes, list[ChunkSet]]]:
        """Yields (partkey, chunk-ordered chunksets) in the CALLER's key
        order.  Reads are batched with chunked IN lists — a read-back of
        thousands of partitions pays one sqlite round-trip a batch, not
        one a partkey."""
        conn = self._conn()
        partkeys = list(partkeys)
        by_pk: dict[bytes, list] = {}
        lim = self._in_batch(conn)
        for i in range(0, len(partkeys), lim):
            batch = partkeys[i:i + lim]
            ph = ",".join("?" * len(batch))
            rows = conn.execute(
                "SELECT partkey, chunk_id, num_rows, start_time, "
                "end_time, schema_hash, vectors, crc FROM chunks "
                f"WHERE dataset=? AND shard=? AND partkey IN ({ph}) "
                "AND end_time>=? AND start_time<=? "
                "ORDER BY partkey, chunk_id",
                (dataset, shard, *batch, start_time, end_time)).fetchall()
            for pk, cid, nr, st, et, sh, blob, _crc in \
                    self._verify_rows(dataset, shard, rows):
                try:
                    vectors = unpack_vectors(blob)
                except Exception as e:  # noqa: BLE001 — corrupt framing
                    # a checksum-evading corruption (e.g. bit rot after
                    # the CRC was recomputed) must quarantine, not crash
                    # the whole read
                    integrity.report_corrupt(CorruptVectorError(
                        f"bad chunk framing: {e}", partkey=pk,
                        chunk_id=cid, dataset=dataset, shard=shard,
                        blob=blob, kind="decode", start_time=st,
                        end_time=et))
                    continue
                by_pk.setdefault(pk, []).append(
                    ChunkSet(ChunkSetInfo(cid, nr, st, et), pk,
                             vectors, schema_hash=sh))
        for pk in partkeys:
            css = by_pk.get(pk)
            if css:
                yield pk, css

    def scan_part_keys(self, dataset, shard) -> Iterator[PartKeyRecord]:
        conn = self._conn()
        for pk, st, et, sh in conn.execute(
                "SELECT partkey, start_time, end_time, schema_hash "
                "FROM partkeys WHERE dataset=? AND shard=?", (dataset, shard)):
            yield PartKeyRecord(pk, st, et, shard, schema_hash=sh)

    def chunksets_with_ingestion_time(self, dataset, shard, start, end
                                      ) -> Iterator[tuple[int, ChunkSet]]:
        conn = self._conn()
        # columns arranged so blob/crc sit at the indexes _verify_rows
        # reads (6/7); itime rides behind at 8 — rows verify in
        # fetchmany-sized batches through the same batched native CRC
        # pass as every other read path, streaming the scan
        cur = conn.execute(
            "SELECT partkey, chunk_id, num_rows, start_time, end_time, "
            "schema_hash, vectors, crc, ingestion_time FROM chunks "
            "WHERE dataset=? AND shard=? "
            "AND ingestion_time BETWEEN ? AND ? ORDER BY partkey, chunk_id",
            (dataset, shard, start, end))
        while True:
            got = cur.fetchmany(512)
            if not got:
                return
            for pk, cid, nr, st, et, sh, blob, _crc, itime in \
                    self._verify_rows(dataset, shard, got):
                yield itime, ChunkSet(ChunkSetInfo(cid, nr, st, et), pk,
                                      unpack_vectors(blob), schema_hash=sh)

    def scan_bytes(self, dataset, shard, partkeys, start_time, end_time) -> int:
        """Metadata-only byte estimate: no vector blobs leave sqlite.
        LENGTH(vectors) is O(1) on a blob column; keys are batched with
        chunked IN lists (a cap check costs one pass, not one
        round-trip per partition)."""
        conn = self._conn()
        partkeys = list(partkeys)
        total = 0
        lim = self._in_batch(conn)
        for i in range(0, len(partkeys), lim):
            batch = partkeys[i:i + lim]
            ph = ",".join("?" * len(batch))
            row = conn.execute(
                "SELECT COALESCE(SUM(LENGTH(vectors)),0) FROM chunks "
                f"WHERE dataset=? AND shard=? AND partkey IN ({ph}) "
                "AND end_time>=? AND start_time<=?",
                (dataset, shard, *batch, start_time, end_time)).fetchone()
            total += row[0]
        return total

    # ----------------------------------------------------------------- admin

    def num_chunks(self, dataset: str, shard: int) -> int:
        return self._conn().execute(
            "SELECT COUNT(*) FROM chunks WHERE dataset=? AND shard=?",
            (dataset, shard)).fetchone()[0]

    def list_shards(self, dataset: str) -> list[int]:
        """Shards holding chunks for a dataset (offline verify scan)."""
        return [int(r[0]) for r in self._conn().execute(
            "SELECT DISTINCT shard FROM chunks WHERE dataset=? "
            "ORDER BY shard", (dataset,))]

    def scan_chunk_rows(self, dataset: str, shard: int
                        ) -> Iterator[tuple[bytes, int, bytes, int]]:
        """Every persisted (partkey, chunk_id, framed blob, stored crc)
        of one shard, UNVERIFIED — the raw feed for the offline chunk
        verifier (integrity/scan.py), which must see corrupt rows rather
        than have them dropped."""
        for pk, cid, blob, crc in self._conn().execute(
                "SELECT partkey, chunk_id, vectors, crc FROM chunks "
                "WHERE dataset=? AND shard=? ORDER BY partkey, chunk_id",
                (dataset, shard)):
            yield pk, int(cid), blob, int(crc)

    def delete_part_keys(self, dataset: str, shard: int,
                         partkeys: Sequence[bytes]) -> int:
        """Cardinality-buster path (reference: PerShardCardinalityBuster)."""
        conn = self._conn()
        cur = conn.executemany(
            "DELETE FROM partkeys WHERE dataset=? AND shard=? AND partkey=?",
            [(dataset, shard, pk) for pk in partkeys])
        conn.executemany(
            "DELETE FROM chunks WHERE dataset=? AND shard=? AND partkey=?",
            [(dataset, shard, pk) for pk in partkeys])
        conn.commit()
        return cur.rowcount

    # ------------------------------------------------------- cold-tier age-out

    def count_chunks_aged(self, dataset: str, shard: int,
                          end_before: int) -> tuple[int, int]:
        """(rows, blob bytes) wholly older than ``end_before`` — the
        age-out dry-run plan, metadata-only."""
        row = self._conn().execute(
            "SELECT COUNT(*), COALESCE(SUM(LENGTH(vectors)),0) "
            "FROM chunks WHERE dataset=? AND shard=? AND end_time<?",
            (dataset, shard, end_before)).fetchone()
        return int(row[0]), int(row[1])

    def scan_chunk_rows_aged(self, dataset: str, shard: int,
                             end_before: int) -> Iterator[tuple]:
        """Full VERIFIED rows (partkey, chunk_id, num_rows, start_time,
        end_time, schema_hash, blob, crc, ingestion_time) whose
        end_time < ``end_before`` — the age-out migration feed.  Rows
        failing their checksum are quarantined and SKIPPED: corruption
        stays local and loud instead of being archived as truth."""
        cur = self._conn().execute(
            "SELECT partkey, chunk_id, num_rows, start_time, end_time, "
            "schema_hash, vectors, crc, ingestion_time FROM chunks "
            "WHERE dataset=? AND shard=? AND end_time<? "
            "ORDER BY partkey, chunk_id", (dataset, shard, end_before))
        while True:
            got = cur.fetchmany(256)
            if not got:
                return
            yield from self._verify_rows(dataset, shard, got)

    def delete_chunk_rows(self, dataset: str, shard: int,
                          ids: Sequence[tuple[bytes, int]]) -> int:
        """Delete specific (partkey, chunk_id) rows — the local half of
        a verified tier migration.  Part keys are untouched: the series
        still exists; its old chunks just live in the cold tier now."""
        conn = self._conn()
        cur = conn.executemany(
            "DELETE FROM chunks WHERE dataset=? AND shard=? "
            "AND partkey=? AND chunk_id=?",
            [(dataset, shard, pk, cid) for pk, cid in ids])
        conn.commit()
        return cur.rowcount


class DiskMetaStore(_SqliteBase, MetaStore):
    """MetaStore (checkpoints + dataset metadata) over sqlite."""

    def _ddl(self, conn) -> None:
        conn.executescript("""
        CREATE TABLE IF NOT EXISTS checkpoints (
            dataset TEXT NOT NULL, shard INTEGER NOT NULL,
            grp INTEGER NOT NULL, offset INTEGER NOT NULL,
            PRIMARY KEY (dataset, shard, grp)
        ) WITHOUT ROWID;
        CREATE TABLE IF NOT EXISTS datasets (
            name TEXT PRIMARY KEY, config TEXT NOT NULL
        );
        CREATE TABLE IF NOT EXISTS kv (
            key TEXT PRIMARY KEY, value TEXT NOT NULL
        );
        """)
        conn.commit()

    def write_checkpoint(self, dataset, shard, group, offset) -> None:
        conn = self._conn()
        conn.execute("INSERT OR REPLACE INTO checkpoints VALUES (?,?,?,?)",
                     (dataset, shard, group, offset))
        conn.commit()

    def read_checkpoints(self, dataset, shard) -> dict[int, int]:
        return dict(self._conn().execute(
            "SELECT grp, offset FROM checkpoints WHERE dataset=? AND shard=?",
            (dataset, shard)))

    def delete_checkpoints(self, dataset, shard) -> None:
        conn = self._conn()
        conn.execute("DELETE FROM checkpoints WHERE dataset=? AND shard=?",
                     (dataset, shard))
        conn.commit()

    # durable KV (split phase records, clone/retire markers)

    def write_kv(self, key: str, value: str) -> None:
        conn = self._conn()
        conn.execute("INSERT OR REPLACE INTO kv VALUES (?,?)", (key, value))
        conn.commit()

    def read_kv(self, key: str) -> str | None:
        row = self._conn().execute(
            "SELECT value FROM kv WHERE key=?", (key,)).fetchone()
        return row[0] if row else None

    def delete_kv(self, key: str) -> None:
        conn = self._conn()
        conn.execute("DELETE FROM kv WHERE key=?", (key,))
        conn.commit()

    def list_kv(self, prefix: str) -> dict[str, str]:
        return dict(self._conn().execute(
            "SELECT key, value FROM kv WHERE key LIKE ? ESCAPE '\\'",
            (prefix.replace("\\", "\\\\").replace("%", "\\%")
             .replace("_", "\\_") + "%",)))

    def write_dataset(self, name: str, config: str) -> None:
        conn = self._conn()
        conn.execute("INSERT OR REPLACE INTO datasets VALUES (?,?)",
                     (name, config))
        conn.commit()

    def read_dataset(self, name: str) -> str | None:
        row = self._conn().execute(
            "SELECT config FROM datasets WHERE name=?", (name,)).fetchone()
        return row[0] if row else None

    def list_datasets(self) -> list[str]:
        return [r[0] for r in self._conn().execute(
            "SELECT name FROM datasets ORDER BY name")]
