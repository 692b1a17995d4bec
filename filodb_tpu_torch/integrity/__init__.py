"""Data-integrity subsystem: checksums, corruption tripwires, quarantine.

The reference ships a ``BlockDetective`` and a reclaim meta-size check
that halts the process rather than serve corrupt data (reference:
memory/src/main/scala/filodb.memory/BlockDetective.scala:41,
core/.../TimeSeriesShard.scala:279-301) because an in-memory columnar
store serving from raw buffers can return *wrong* data, not just slow
data.  This package makes corruption loud and contained instead of
silent:

- :func:`chunk_crc` — CRC32C per chunk blob, computed at flush time,
  persisted next to the chunk (store/persistence.py ``crc`` column) and
  re-verified on every read-back.
- :class:`CorruptVectorError` — the structured error raised from
  native/numpy decode ``-1`` sentinels, carrying part-key context, the
  chunk id, the codec (wire type) and a bounded hexdump window.
- :data:`QUARANTINE` — process-wide registry of corrupt chunks; a
  quarantined chunk is excluded from serving, on the host read path and
  on the device grid (queries count it as a partial-data exclusion,
  never wrong values or silence).
- :mod:`filodb_tpu_torch.integrity.faultinject` — deterministic data
  fault injection (byte flips, truncation, checksum corruption).
- :mod:`filodb_tpu_torch.integrity.scan` — the offline chunk verifier.

Counters surface through utils/observability.py (``integrity_metrics``).
"""

from __future__ import annotations

import logging
import os
import threading
import weakref
from typing import Optional

from filodb_tpu_torch.integrity.quarantine import QuarantineRegistry

_LOG = logging.getLogger("filodb.integrity")

#: Process-wide quarantine registry (keyed by (partkey, chunk_id)).
QUARANTINE = QuarantineRegistry()

# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

_CRC_TABLE: Optional[list] = None
_CRC_LOCK = threading.Lock()


def _crc_table() -> list:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        with _CRC_LOCK:
            if _CRC_TABLE is None:
                tab = []
                for i in range(256):
                    c = i
                    for _ in range(8):
                        c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
                    tab.append(c)
                _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c_py(data, seed: int = 0) -> int:
    """Pure-Python CRC32C (Castagnoli), bit-identical to the C kernel
    (``crc32c_buf`` in native/src/codecs.cpp).  Table-driven byte loop:
    slow, used only when the native library cannot be built."""
    tab = _crc_table()
    crc = ~seed & 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ tab[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def chunk_crc(data) -> int:
    """CRC32C of one framed chunk blob — THE chunk checksum.  Never 0
    for any input: 0 is the 'no checksum recorded' marker in the store,
    so a real 0 is mapped to 1 (one in 4e9 chunks pays a one-bit-weaker
    check instead of silently skipping verification forever)."""
    from filodb_tpu_torch import native
    got = native.crc32c(data)
    if got is None:
        got = crc32c_py(data)
    return got or 1


# ---------------------------------------------------------------------------
# Structured corruption errors
# ---------------------------------------------------------------------------


def hexdump_window(buf, offset: int = 0, width: int = 64) -> str:
    """Bounded hex window of ``buf`` around ``offset`` for forensics
    (the BlockDetective analog: enough bytes to diagnose, never the
    whole chunk in a log line)."""
    try:
        b = bytes(buf)
    except Exception:  # noqa: BLE001 — diagnostics must not throw
        return "<unreadable>"
    lo = max(0, min(offset, len(b)) - width // 2)
    hi = min(len(b), lo + width)
    body = b[lo:hi].hex()
    pre = "..." if lo > 0 else ""
    post = "..." if hi < len(b) else ""
    return f"[{lo}:{hi}/{len(b)}] {pre}{body}{post}"


class CorruptVectorError(ValueError):
    """A chunk vector failed its checksum or decode.

    Subclasses ValueError so pre-existing ``except ValueError`` decode
    guards keep working; carries the forensic context the reference's
    BlockDetective would print: part-key, chunk id, codec (wire type),
    and a bounded hexdump window of the offending bytes.  ``kind`` is
    the explicit counter class ("checksum" or "decode") — never
    inferred from free text.
    """

    def __init__(self, reason: str, *, partkey: Optional[bytes] = None,
                 chunk_id: Optional[int] = None,
                 codec: Optional[int] = None,
                 dataset: Optional[str] = None,
                 shard: Optional[int] = None,
                 blob=None, kind: str = "decode",
                 start_time: Optional[int] = None,
                 end_time: Optional[int] = None):
        self.reason = reason
        self.partkey = bytes(partkey) if partkey is not None else None
        self.chunk_id = chunk_id
        self.codec = codec
        self.dataset = dataset
        self.shard = shard
        self.kind = kind
        self.start_time = start_time
        self.end_time = end_time
        self.window = hexdump_window(blob) if blob is not None else None
        parts = [reason]
        if dataset is not None:
            parts.append(f"dataset={dataset}")
        if shard is not None:
            parts.append(f"shard={shard}")
        if self.partkey is not None:
            pk = self.partkey.hex()
            parts.append(f"partkey={pk[:64]}{'...' if len(pk) > 64 else ''}")
        if chunk_id is not None:
            parts.append(f"chunk_id={chunk_id}")
        if codec is not None:
            parts.append(f"codec={_codec_name(codec)}")
        if self.window is not None:
            parts.append(f"bytes={self.window}")
        super().__init__(" ".join(parts))


def corrupt_chunk_error(cs, cause, dataset: Optional[str] = None,
                        shard: Optional[int] = None) -> CorruptVectorError:
    """Build the structured error for a ChunkSet whose decode hit a -1
    sentinel: re-probe vector by vector to pin down the failing codec
    and grab its hexdump window (the slow path runs once per corrupt
    chunk, never on healthy data)."""
    from filodb_tpu_torch.integrity.scan import _decode_vector
    codec = None
    blob = None
    for vec in cs.vectors:
        try:
            _decode_vector(vec)
        except Exception:  # noqa: BLE001 — any decode failure pins the vector
            b = bytes(vec)
            codec = b[0] if b else None
            blob = b
            break
    return CorruptVectorError(f"chunk decode failed: {cause}",
                              partkey=cs.partkey, chunk_id=cs.info.chunk_id,
                              codec=codec, dataset=dataset, shard=shard,
                              blob=blob, kind="decode",
                              start_time=cs.info.start_time,
                              end_time=cs.info.end_time)


def _codec_name(codec: int) -> str:
    try:
        from filodb_tpu_torch.codecs.wire import WireType
        return f"{WireType(codec).name}({codec})"
    except ValueError:
        return str(codec)


# ---------------------------------------------------------------------------
# Verification switch + reporting
# ---------------------------------------------------------------------------

_VERIFY = os.environ.get("FILODB_INTEGRITY_VERIFY", "1") != "0"


def verify_enabled() -> bool:
    """Read-side checksum verification switch (on by default; set
    FILODB_INTEGRITY_VERIFY=0 to measure its overhead only)."""
    return _VERIFY


def set_verify(on: bool) -> None:
    global _VERIFY
    _VERIFY = bool(on)


#: live shards by (dataset, shard) so store-level detections (which
#: know only the ids, not the object) still reach per-shard stats and
#: grid-plan invalidation; weak values — a dropped shard unregisters
#: itself by garbage collection
_SHARD_HOOKS = weakref.WeakValueDictionary()


def register_shard(shard) -> None:
    """Called from TimeSeriesShard.__init__: routes corruption reports
    carrying this (dataset, shard) identity to shard.note_corrupt_chunk.
    Latest registration wins (a fresh memstore over the same data is
    the one actually serving)."""
    _SHARD_HOOKS[(shard.dataset, shard.shard_num)] = shard


def report_corrupt(err: CorruptVectorError) -> bool:
    """Funnel for every detected corruption: quarantine the chunk,
    bump the observability counters, notify the owning shard (when the
    error names one), and log — ONCE per chunk (repeat hits on a
    quarantined chunk count but do not re-log).  Returns True when the
    chunk is newly quarantined."""
    from filodb_tpu_torch.utils.observability import integrity_metrics
    m = integrity_metrics()
    labels = {}
    if err.dataset is not None:
        labels["dataset"] = err.dataset
    if err.shard is not None:
        labels["shard"] = str(err.shard)
    m["checksum_failures" if err.kind == "checksum"
      else "decode_failures"].inc(**labels)
    new = False
    if err.partkey is not None and err.chunk_id is not None:
        new = QUARANTINE.quarantine(err.partkey, err.chunk_id,
                                    reason=err.reason, detail=str(err),
                                    dataset=err.dataset, shard=err.shard,
                                    start_time=err.start_time,
                                    end_time=err.end_time)
        m["chunks_quarantined"].set(QUARANTINE.total())
    if err.dataset is not None and err.shard is not None:
        # store-level detection: reach the shard's stats + grid-plan
        # invalidation.  Partition-level detections carry NO
        # dataset/shard (the partition doesn't know them) and route via
        # their own on_corrupt hook instead — never both.  The device
        # grid caches drop their blocks on the quarantine epoch, not
        # here: the latest registration of a (dataset, shard) wins.
        sh = _SHARD_HOOKS.get((err.dataset, err.shard))
        if sh is not None:
            sh.note_corrupt_chunk(err, new)
    if new or err.partkey is None or err.chunk_id is None:
        _LOG.error("corrupt chunk detected: %s", err)
    return new


class IntegrityInvariantError(RuntimeError):
    """Eviction/reclaim bookkeeping broke a hard invariant.  The owning
    shard fails rather than serve stale buffers (the reference kills
    the process on the reclaim meta-size check; we fail the shard)."""


def note_invariant_failure(dataset: str, shard: int, detail: str) -> None:
    from filodb_tpu_torch.utils.observability import integrity_metrics
    integrity_metrics()["invariant_failures"].inc(dataset=dataset,
                                                  shard=str(shard))
    _LOG.critical("integrity invariant failed: dataset=%s shard=%s %s",
                  dataset, shard, detail)
    # the black box hits the ground: an integrity failure fails the
    # shard, so the events leading up to it are the postmortem
    from filodb_tpu_torch.utils.devicewatch import FLIGHT
    FLIGHT.record("integrity.fail", dataset=dataset, shard=shard,
                  detail=detail[:200])
    FLIGHT.dump_to_log(f"integrity failure {dataset}/{shard}")
