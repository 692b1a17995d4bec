"""ColdChunkStore: a ColumnStore over an object bucket, and the
TieredColumnStore that merges it beneath the local disk tier.

Object layout — ALL chunk metadata lives in the key, so planning a read
costs one ``list_objects`` (metadata-only) and zero fetches::

    chunks/{dataset}/{shard}/{partkey hex}/
        {chunk_id}.{num_rows}.{start}.{end}.{schema_hash}.{itime}.{crc:08x}

The body is the same framed vectors blob sqlite stores (see
``persistence.pack_vectors``) and the CRC in the key is
``integrity.chunk_crc`` over that body — verified on EVERY fetch, even on
the defer-verify path (the bucket is the untrusted hop; a truncated or
bit-rotted object fails the check, is quarantined through the standard
``integrity.report_corrupt`` funnel, and is NEVER served).

Deadlines: every ``get_object`` carries a ``timeout_s`` derived from the
active query's remaining budget (``deadline.budget_timeout_s``), capped
by the store's ``fetch_timeout_s``.

Locks: the index lock guards METADATA ONLY — no bucket I/O ever runs
under it.  For a paging path that classifies partitions under its own
lock, :meth:`ColdChunkStore.prefetch_cold` fetches the needed objects
OUTSIDE any lock into a thread-local staging dict; the locked read then
consumes staged bytes without touching the bucket.  A stalled bucket
therefore stalls only the fetching thread up to its own deadline — never
a lock convoy.

Host code: the bytes fetched are attributed to a ``fmt="cold-page"`` pool
of the HBM ledger (``utils/devicewatch.LEDGER``), one a shard touched.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, Optional, Sequence

from filodb_tpu_torch import integrity
from filodb_tpu_torch.coldstore.bucket import (BucketTimeout, ObjectBucket,
                                               ObjectMissing)
from filodb_tpu_torch.core.chunk import ChunkSet, ChunkSetInfo
from filodb_tpu_torch.integrity import CorruptVectorError
from filodb_tpu_torch.store.columnstore import (ColumnStore, PartKeyRecord,
                                                ScanBytesExceeded)
from filodb_tpu_torch.store.persistence import pack_vectors, unpack_vectors
from filodb_tpu_torch.utils.observability import coldstore_metrics
from filodb_tpu_torch.workload import deadline as dl

_KEY_ROOT = "chunks"
_MAX_TIME = 1 << 62


class ColdWriteError(OSError):
    """An age-out upload failed its read-back verification — the local
    row must NOT be deleted."""


@dataclasses.dataclass(frozen=True)
class ColdChunkMeta:
    """One archived chunk, decoded entirely from its object key."""
    key: str
    partkey: bytes
    chunk_id: int
    num_rows: int
    start_time: int
    end_time: int
    schema_hash: int
    ingestion_time: int
    crc: int
    size: int


def object_key(dataset: str, shard: int, partkey: bytes, chunk_id: int,
               num_rows: int, start_time: int, end_time: int,
               schema_hash: int, ingestion_time: int, crc: int) -> str:
    return (f"{_KEY_ROOT}/{dataset}/{shard}/{partkey.hex()}/"
            f"{chunk_id}.{num_rows}.{start_time}.{end_time}."
            f"{schema_hash}.{ingestion_time}.{crc:08x}")


def parse_object_key(key: str, size: int) -> Optional[ColdChunkMeta]:
    """Decode a chunk object key; None for foreign/malformed keys (a
    stray file in the bucket must not break planning)."""
    parts = key.split("/")
    if len(parts) != 5 or parts[0] != _KEY_ROOT:
        return None
    try:
        pk = bytes.fromhex(parts[3])
        cid, nr, st, et, sh, it, crc_hex = parts[4].split(".")
        return ColdChunkMeta(key, pk, int(cid), int(nr), int(st), int(et),
                             int(sh), int(it), int(crc_hex, 16), size)
    except (ValueError, IndexError):
        return None


class ColdChunkStore(ColumnStore):
    """A read-mostly ColumnStore tier over an :class:`ObjectBucket`.

    Writes happen via the age-out path (:meth:`put_chunk_row`, with
    read-back verification) or :meth:`write_chunks` (direct archive
    loads).  Part keys are NOT archived — they stay in the local tier's
    sqlite, which remains the source of truth for series existence; the
    cold tier holds chunk bodies only."""

    #: per-thread staged-prefetch cap; crossing it drops the staging dict
    #: wholesale (leftovers only accumulate from aborted page-ins)
    max_staged_bytes = 256 << 20

    def __init__(self, bucket: ObjectBucket,
                 fetch_timeout_s: float = 30.0) -> None:
        self.bucket = bucket
        self.fetch_timeout_s = float(fetch_timeout_s)
        # (dataset, shard) -> partkey -> [ColdChunkMeta] sorted by chunk_id
        self._index: dict = {}
        # guards _index METADATA only — never held across bucket I/O
        self._index_lock = threading.Lock()
        self._staged = threading.local()
        # (dataset, shard) -> bytes fetched (the ledger's cold-page pool
        # reads this; a monotonic counter, not residency)
        self._fetched_bytes: dict = {}
        # ledger pool owners registered per touched shard
        self._ledger_owners: set = set()

    # ------------------------------------------------------------- index

    def _shard_index(self, dataset: str, shard: int) -> dict:
        key = (dataset, shard)
        got = self._index.get(key)
        if got is not None:
            return got
        # build OUTSIDE the lock (listing is metadata-only but can walk
        # many directories); losers of the install race discard
        metas: dict = {}
        prefix = f"{_KEY_ROOT}/{dataset}/{shard}/"
        for okey, size in self.bucket.list_objects(prefix):
            m = parse_object_key(okey, size)
            if m is not None:
                metas.setdefault(m.partkey, []).append(m)
        for lst in metas.values():
            lst.sort(key=lambda m: m.chunk_id)
        with self._index_lock:
            return self._index.setdefault(key, metas)

    def _select(self, dataset: str, shard: int,
                partkeys: Optional[Sequence[bytes]], start_time: int,
                end_time: int, itime_range: Optional[tuple] = None
                ) -> list:
        """Metas overlapping the query window, sorted (partkey,
        chunk_id); quarantined chunks are excluded BEFORE any fetch."""
        idx = self._shard_index(dataset, shard)
        quarantine = integrity.QUARANTINE
        with self._index_lock:
            pks = sorted(idx.keys()) if partkeys is None else \
                [pk for pk in sorted(set(partkeys)) if pk in idx]
            out = []
            for pk in pks:
                for m in idx.get(pk, ()):
                    if m.end_time < start_time or m.start_time > end_time:
                        continue
                    if itime_range is not None and not (
                            itime_range[0] <= m.ingestion_time
                            <= itime_range[1]):
                        continue
                    if quarantine.is_quarantined(m.partkey, m.chunk_id):
                        continue
                    out.append(m)
        return out

    def _index_add(self, dataset: str, shard: int,
                   meta: ColdChunkMeta) -> None:
        with self._index_lock:
            idx = self._index.get((dataset, shard))
            if idx is None:
                return  # not loaded yet; the eventual listing sees it
            lst = [m for m in idx.get(meta.partkey, ())
                   if m.chunk_id != meta.chunk_id]
            lst.append(meta)
            lst.sort(key=lambda m: m.chunk_id)
            idx[meta.partkey] = lst

    # ------------------------------------------------------------- fetch

    def _fetch_timeout_s(self) -> float:
        """Per-fetch timeout from the active query's REMAINING budget
        (capped by fetch_timeout_s); the full cap outside a query
        (age-out verification, offline sweeps)."""
        from filodb_tpu_torch.query.exec import active_exec_ctx
        ctx = active_exec_ctx()
        if ctx is not None:
            return dl.budget_timeout_s(ctx.query_context,
                                       self.fetch_timeout_s)
        return self.fetch_timeout_s

    def _staging(self) -> dict:
        blobs = getattr(self._staged, "blobs", None)
        if blobs is None:
            blobs = self._staged.blobs = {}
        return blobs

    def _fetch_one(self, meta: ColdChunkMeta) -> Optional[bytes]:
        """One object body: staged bytes if prefetched on this thread,
        else a live fetch under a deadline-derived timeout.  Returns None
        when the object vanished (aged past a second policy or deleted by
        an admin) — the row is simply absent.  BucketTimeout propagates:
        a stalled bucket is a LOUD refusal, never a silent gap."""
        staged = getattr(self._staged, "blobs", None)
        if staged is not None:
            blob = staged.pop(meta.key, None)
            if blob is not None:
                return blob
        m = coldstore_metrics()
        deadline_timeout_s = self._fetch_timeout_s()
        try:
            blob = self.bucket.get_object(meta.key,
                                          timeout_s=deadline_timeout_s)
        except ObjectMissing:
            m["fetch_missing"].inc()
            return None
        except BucketTimeout:
            m["fetch_timeouts"].inc()
            raise
        m["fetches"].inc()
        m["fetch_bytes"].inc(len(blob))
        return blob

    def _verify_blob(self, dataset: str, shard: int, meta: ColdChunkMeta,
                     blob: bytes) -> bool:
        """CRC the fetched body against the key's checksum.  Runs even
        when global verification is off — the bucket hop is untrusted by
        contract (truncation shows up as a length/CRC mismatch)."""
        got = integrity.chunk_crc(blob)
        if got == meta.crc:
            return True
        coldstore_metrics()["fetch_corrupt"].inc(dataset=dataset)
        integrity.report_corrupt(CorruptVectorError(
            f"cold object failed CRC on fetch (key={meta.key}, "
            f"expected={meta.crc:#010x}, got {got:#010x}, {len(blob)}B "
            f"body)", partkey=meta.partkey, chunk_id=meta.chunk_id,
            dataset=dataset, shard=shard, blob=blob, kind="checksum",
            start_time=meta.start_time, end_time=meta.end_time))
        return False

    def _fetch_rows(self, dataset: str, shard: int, metas: list
                    ) -> list[tuple]:
        """Fetch + verify a meta list into sqlite-shaped 8-tuples
        (partkey, chunk_id, num_rows, start_time, end_time, schema_hash,
        blob, crc).  Corrupt/missing objects are dropped (quarantine and
        the partial-results warning flow through the integrity
        funnel)."""
        rows: list[tuple] = []
        nbytes = 0
        for meta in metas:
            blob = self._fetch_one(meta)
            if blob is None or not self._verify_blob(dataset, shard,
                                                     meta, blob):
                continue
            nbytes += len(blob)
            rows.append((meta.partkey, meta.chunk_id, meta.num_rows,
                         meta.start_time, meta.end_time, meta.schema_hash,
                         blob, meta.crc))
        if rows:
            key = (dataset, shard)
            self._fetched_bytes[key] = \
                self._fetched_bytes.get(key, 0) + nbytes
            owner = f"coldstore:{dataset}/{shard}"
            if owner not in self._ledger_owners:
                # first cold bytes for this shard: their own
                # fmt=cold-page ledger row, so dashboards tell
                # bucket-sourced residency from local page-ins
                self._ledger_owners.add(owner)
                from filodb_tpu_torch.utils.devicewatch import LEDGER
                LEDGER.register_pool(
                    owner, lambda k=key: self._fetched_bytes.get(k, 0),
                    fmt="cold-page")
            from filodb_tpu_torch.query.exec import active_exec_ctx
            ctx = active_exec_ctx()
            if ctx is not None:
                ctx.note_cold(chunks=len(rows), bytes_=nbytes)
        return rows

    def prefetch_cold(self, dataset: str, shard: int,
                      partkeys: Optional[Sequence[bytes]],
                      start_time: int, end_time: int) -> int:
        """Stage the objects a subsequent same-thread read will need —
        for a paging path to call BEFORE taking its page-in lock, so
        bucket I/O (and bucket stalls) never happen under a held lock.
        Returns objects staged.  Raises BucketTimeout on a stalled
        backend — aborting the page-in before the lock, never wedging
        it."""
        staged = self._staging()
        # bound leftovers from aborted/raced page-ins (entries normally
        # pop on consume; re-prefetch of an already-staged key is free)
        if sum(len(b) for b in staged.values()) > self.max_staged_bytes:
            staged.clear()
        n = 0
        for meta in self._select(dataset, shard, partkeys, start_time,
                                 end_time):
            if meta.key in staged:
                n += 1
                continue
            blob = self._fetch_one(meta)
            if blob is not None:
                staged[meta.key] = blob
                n += 1
        return n

    def cold_page_bytes(self, dataset: str, shard: int) -> int:
        """Monotonic bytes fetched from the bucket for one shard (the
        ledger's fmt=cold-page attribution input)."""
        return self._fetched_bytes.get((dataset, shard), 0)

    # ------------------------------------------------------------- sink

    def put_chunk_row(self, dataset: str, shard: int, partkey: bytes,
                      chunk_id: int, num_rows: int, start_time: int,
                      end_time: int, schema_hash: int, ingestion_time: int,
                      blob: bytes, crc: int, verify: bool = True) -> str:
        """Archive one framed chunk row; with ``verify`` (the age-out
        default) the object is read back and CRC-checked before the
        caller may delete the local copy."""
        if not crc:
            crc = integrity.chunk_crc(blob)
        key = object_key(dataset, shard, partkey, chunk_id, num_rows,
                         start_time, end_time, schema_hash,
                         ingestion_time, crc)
        self.bucket.put_object(key, bytes(blob))
        if verify:
            admin_budget_s = self.fetch_timeout_s
            back = self.bucket.get_object(key, timeout_s=admin_budget_s)
            if integrity.chunk_crc(back) != crc:
                raise ColdWriteError(
                    f"read-back CRC mismatch archiving {key} "
                    f"({len(back)}B back vs {len(blob)}B up)")
        self._index_add(dataset, shard, ColdChunkMeta(
            key, bytes(partkey), chunk_id, num_rows, start_time, end_time,
            schema_hash, ingestion_time, crc, len(blob)))
        return key

    def write_chunks(self, dataset, shard, chunksets,
                     ingestion_time=0) -> int:
        for cs in chunksets:
            blob = pack_vectors(cs.vectors)
            self.put_chunk_row(dataset, shard, cs.partkey, cs.info.chunk_id,
                               cs.info.num_rows, cs.info.start_time,
                               cs.info.end_time, cs.schema_hash,
                               ingestion_time, blob,
                               integrity.chunk_crc(blob), verify=False)
        return len(chunksets)

    def write_part_keys(self, dataset, shard, records) -> int:
        return 0  # part keys live in the local tier only

    # ------------------------------------------------------------- source

    def read_raw_rows(self, dataset, shard, partkeys, start_time,
                      end_time, byte_cap: int | None = None,
                      defer_verify: bool = False) -> list[tuple]:
        # defer_verify is ignored on purpose: the bucket hop is always
        # verified (sizes are known from keys, so the cap check runs
        # BEFORE any fetch is paid)
        metas = self._select(dataset, shard, partkeys, start_time, end_time)
        if byte_cap is not None:
            total = 0
            for m in metas:
                total += m.size
                if total > byte_cap:
                    raise ScanBytesExceeded(
                        f"cold raw-row read exceeded {byte_cap} bytes")
        return self._fetch_rows(dataset, shard, metas)

    def read_raw_partitions(self, dataset, shard, partkeys, start_time,
                            end_time
                            ) -> Iterator[tuple[bytes, list[ChunkSet]]]:
        metas = self._select(dataset, shard, partkeys, start_time, end_time)
        by_pk: dict = {}
        for pk, cid, nr, st, et, sh, blob, _crc in \
                self._fetch_rows(dataset, shard, metas):
            try:
                vectors = unpack_vectors(blob)
            except Exception as e:  # noqa: BLE001 — corrupt framing
                integrity.report_corrupt(CorruptVectorError(
                    f"bad cold chunk framing: {e}", partkey=pk,
                    chunk_id=cid, dataset=dataset, shard=shard, blob=blob,
                    kind="decode", start_time=st, end_time=et))
                continue
            by_pk.setdefault(pk, []).append(
                ChunkSet(ChunkSetInfo(cid, nr, st, et), pk, vectors,
                         schema_hash=sh))
        order = sorted(by_pk.keys()) if partkeys is None else partkeys
        for pk in order:
            css = by_pk.get(pk)
            if css:
                yield pk, css

    def scan_part_keys(self, dataset, shard) -> Iterator[PartKeyRecord]:
        return iter(())  # series existence is the local tier's job

    def scan_bytes(self, dataset, shard, partkeys, start_time,
                   end_time) -> int:
        # metadata-only: sizes come from the listing, zero fetches
        return sum(m.size for m in self._select(dataset, shard, partkeys,
                                                start_time, end_time))

    def chunksets_with_ingestion_time(self, dataset, shard, start, end
                                      ) -> Iterator[tuple[int, ChunkSet]]:
        metas = self._select(dataset, shard, None, 0, _MAX_TIME,
                             itime_range=(start, end))
        for meta in metas:
            blob = self._fetch_one(meta)
            if blob is None or not self._verify_blob(dataset, shard,
                                                     meta, blob):
                continue
            yield meta.ingestion_time, ChunkSet(
                ChunkSetInfo(meta.chunk_id, meta.num_rows, meta.start_time,
                             meta.end_time), meta.partkey,
                unpack_vectors(blob), schema_hash=meta.schema_hash)

    def delete_part_keys(self, dataset, shard, partkeys) -> int:
        idx = self._shard_index(dataset, shard)
        n = 0
        doomed: list = []
        with self._index_lock:
            for pk in partkeys:
                metas = idx.pop(pk, None)
                if metas:
                    n += 1
                    doomed.extend(metas)
        for meta in doomed:  # bucket I/O outside the index lock
            self.bucket.delete_object(meta.key)
        return n

    # ------------------------------------------------------------- admin

    def num_chunks(self, dataset: str, shard: int) -> int:
        idx = self._shard_index(dataset, shard)
        with self._index_lock:
            return sum(len(v) for v in idx.values())

    def list_shards(self, dataset: str) -> list[int]:
        shards = set()
        for key, _size in self.bucket.list_objects(f"{_KEY_ROOT}/{dataset}/"):
            parts = key.split("/")
            if len(parts) >= 3:
                try:
                    shards.add(int(parts[2]))
                except ValueError:
                    continue
        return sorted(shards)

    def scan_chunk_rows(self, dataset: str, shard: int
                        ) -> Iterator[tuple[bytes, int, bytes, int]]:
        """UNVERIFIED (partkey, chunk_id, body, key-crc) sweep feeding an
        offline chunk verifier, which must see corrupt objects rather
        than have them dropped."""
        idx = self._shard_index(dataset, shard)
        with self._index_lock:
            metas = [m for lst in idx.values() for m in lst]
        metas.sort(key=lambda m: (m.partkey, m.chunk_id))
        for meta in metas:
            admin_budget_s = self.fetch_timeout_s
            try:
                blob = self.bucket.get_object(meta.key,
                                              timeout_s=admin_budget_s)
            except ObjectMissing:
                continue
            yield meta.partkey, meta.chunk_id, blob, meta.crc

    def shutdown(self) -> None:
        from filodb_tpu_torch.utils.devicewatch import LEDGER
        for owner in self._ledger_owners:
            LEDGER.deregister_pool(owner)
        self._ledger_owners.clear()

    def drop_index_cache(self) -> None:
        """Forget the in-memory listing (external bucket writes)."""
        with self._index_lock:
            self._index.clear()


class TieredColumnStore(ColumnStore):
    """local (sqlite warm tier) over cold (bucket archive), presented as
    ONE ColumnStore: writes land local; reads merge local + cold rows
    deduped by (partkey, chunk_id) with the LOCAL copy winning (age-out
    deletes local only after the upload verified, so during the overlap
    both tiers hold identical bytes).  Unknown attributes delegate to the
    local tier so sqlite-level admin helpers (fault injection, stats)
    keep working unwrapped."""

    def __init__(self, local: ColumnStore, cold: ColdChunkStore) -> None:
        self.local = local
        self.cold = cold
        # dataset -> raw rows served by read_raw_rows/partitions
        self.rows_read_by_dataset: dict = {}

    def __getattr__(self, name: str):
        # only fires for attributes Tiered itself lacks (the sqlite admin
        # surface: _conn, scan_chunk_rows, list_shards, num_chunks, ...)
        return getattr(self.local, name)

    def _note_rows(self, dataset: str, n: int) -> None:
        if n:
            self.rows_read_by_dataset[dataset] = \
                self.rows_read_by_dataset.get(dataset, 0) + n

    # -- sink: the local tier owns ingest -----------------------------------

    def initialize(self, dataset, num_shards) -> None:
        self.local.initialize(dataset, num_shards)

    def write_chunks(self, dataset, shard, chunksets,
                     ingestion_time=0) -> int:
        return self.local.write_chunks(dataset, shard, chunksets,
                                       ingestion_time)

    def write_part_keys(self, dataset, shard, records) -> int:
        return self.local.write_part_keys(dataset, shard, records)

    def merge_part_keys(self, dataset, shard, records) -> int:
        return self.local.merge_part_keys(dataset, shard, records)

    def deferred_commits(self):
        return self.local.deferred_commits()

    # -- source: merged -----------------------------------------------------

    def prefetch_cold(self, dataset, shard, partkeys, start_time,
                      end_time) -> int:
        return self.cold.prefetch_cold(dataset, shard, partkeys,
                                       start_time, end_time)

    def cold_page_bytes(self, dataset: str, shard: int) -> int:
        return self.cold.cold_page_bytes(dataset, shard)

    def read_raw_rows(self, dataset, shard, partkeys, start_time,
                      end_time, byte_cap: int | None = None,
                      defer_verify: bool = False) -> Optional[list[tuple]]:
        lrows = self.local.read_raw_rows(dataset, shard, partkeys,
                                         start_time, end_time,
                                         byte_cap=byte_cap,
                                         defer_verify=defer_verify)
        if lrows is None:
            return None  # local backend has no bulk path; keep contract
        cold_cap = None
        if byte_cap is not None:
            cold_cap = max(byte_cap - sum(len(r[6]) for r in lrows), 0)
        crows = self.cold.read_raw_rows(dataset, shard, partkeys,
                                        start_time, end_time,
                                        byte_cap=cold_cap,
                                        defer_verify=defer_verify)
        if crows:
            seen = {(r[0], r[1]) for r in lrows}
            lrows = lrows + [r for r in crows if (r[0], r[1]) not in seen]
            lrows.sort(key=lambda r: (r[0], r[1]))
        self._note_rows(dataset, len(lrows))
        return lrows

    def read_raw_partitions(self, dataset, shard, partkeys, start_time,
                            end_time
                            ) -> Iterator[tuple[bytes, list[ChunkSet]]]:
        local_by_pk = dict(self.local.read_raw_partitions(
            dataset, shard, partkeys, start_time, end_time))
        cold_by_pk = dict(self.cold.read_raw_partitions(
            dataset, shard, partkeys, start_time, end_time))
        n = 0
        for pk in partkeys:
            lcs = local_by_pk.get(pk)
            ccs = cold_by_pk.get(pk)
            if lcs and ccs:
                have = {cs.info.chunk_id for cs in lcs}
                css = sorted(lcs + [cs for cs in ccs
                                    if cs.info.chunk_id not in have],
                             key=lambda cs: cs.info.chunk_id)
            else:
                css = lcs or ccs
            if css:
                n += len(css)
                yield pk, css
        self._note_rows(dataset, n)

    def scan_part_keys(self, dataset, shard) -> Iterator[PartKeyRecord]:
        return self.local.scan_part_keys(dataset, shard)

    def scan_bytes(self, dataset, shard, partkeys, start_time,
                   end_time) -> int:
        return (self.local.scan_bytes(dataset, shard, partkeys, start_time,
                                      end_time)
                + self.cold.scan_bytes(dataset, shard, partkeys, start_time,
                                       end_time))

    def chunksets_with_ingestion_time(self, dataset, shard, start, end
                                      ) -> Iterator[tuple[int, ChunkSet]]:
        yield from self.local.chunksets_with_ingestion_time(dataset, shard,
                                                            start, end)
        yield from self.cold.chunksets_with_ingestion_time(dataset, shard,
                                                           start, end)

    def delete_part_keys(self, dataset, shard, partkeys) -> int:
        n = self.local.delete_part_keys(dataset, shard, partkeys)
        return max(n, self.cold.delete_part_keys(dataset, shard, partkeys))

    def shutdown(self) -> None:
        self.local.shutdown()
        self.cold.shutdown()
