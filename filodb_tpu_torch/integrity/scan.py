"""Offline chunk verification.

Scans a dataset's persisted chunks shard by shard, recomputing the
CRC32C of every framed blob against the stored checksum and (with
``deep=True``) decoding every vector through the same codec paths the
query engine uses.  Reports per-shard pass/fail counts so an operator
can audit a store at rest without starting a server (the offline analog
of verify-on-read-back).
"""

from __future__ import annotations

from typing import Optional, Sequence

from filodb_tpu_torch.integrity import CorruptVectorError, chunk_crc


def _decode_vector(blob) -> None:
    """Decode one encoded vector by its wire-type byte, raising
    ValueError on corruption.  Covers every family the codecs emit."""
    from filodb_tpu_torch.codecs import (deltadelta, doublecodec, histcodec,
                                         strcodec)
    from filodb_tpu_torch.codecs.wire import WireType
    b = bytes(blob)
    if not b:
        raise ValueError("empty vector")
    wire = b[0]
    if wire < WireType.DELTA2_DOUBLE:
        deltadelta.decode(b)
    elif wire < WireType.HIST_2D_DELTA:
        doublecodec.decode(b)
    elif wire < WireType.UTF8_DENSE:
        histcodec.decode(b)
    elif wire < WireType.INT_NBIT:
        strcodec.decode_utf8(b)
    elif wire == WireType.INT_NBIT:
        strcodec.decode_nbit(b)
    else:
        raise ValueError(f"unknown wire type {wire}")


def verify_chunk_row(partkey: bytes, chunk_id: int, blob, crc: int,
                     deep: bool = False, dataset: Optional[str] = None,
                     shard: Optional[int] = None) -> None:
    """Verify one persisted chunk row; raises CorruptVectorError on any
    checksum or (deep) framing/decode failure."""
    if crc:
        got = chunk_crc(blob)
        if got != crc:
            raise CorruptVectorError(
                f"checksum mismatch (stored={crc:#010x} "
                f"computed={got:#010x})", partkey=partkey,
                chunk_id=chunk_id, dataset=dataset, shard=shard,
                blob=blob, kind="checksum")
    if not deep:
        return
    try:
        from filodb_tpu_torch.store.persistence import unpack_vectors
        vectors = unpack_vectors(bytes(blob))
    except Exception as e:  # noqa: BLE001 — framing corruption
        raise CorruptVectorError(f"bad chunk framing: {e}",
                                 partkey=partkey, chunk_id=chunk_id,
                                 dataset=dataset, shard=shard,
                                 blob=blob) from e
    for j, vec in enumerate(vectors):
        try:
            _decode_vector(vec)
        except ValueError as e:
            codec = bytes(vec)[0] if len(bytes(vec)) else None
            raise CorruptVectorError(
                f"vector {j} decode failed: {e}", partkey=partkey,
                chunk_id=chunk_id, codec=codec, dataset=dataset,
                shard=shard, blob=vec) from e


def verify_chunks(store, dataset: str,
                  shards: Optional[Sequence[int]] = None,
                  deep: bool = False, max_failures: int = 100) -> dict:
    """Scan a dataset's persisted chunks and report per-shard counts.

    Returns ``{"dataset", "shards": {shard: {"chunks", "passed",
    "failed", "unchecksummed", "failures": [...]}}, "total_failed"}``.
    ``failures`` is bounded at ``max_failures`` per shard."""
    if shards is None:
        shards = store.list_shards(dataset)
    out: dict = {"dataset": dataset, "deep": deep, "shards": {}}
    total_failed = 0
    for sh in shards:
        chunks = passed = failed = nocrc = 0
        failures: list[str] = []
        for pk, cid, blob, crc in store.scan_chunk_rows(dataset, sh):
            chunks += 1
            if not crc:
                nocrc += 1
            try:
                verify_chunk_row(pk, cid, blob, crc, deep=deep,
                                 dataset=dataset, shard=sh)
                passed += 1
            except CorruptVectorError as e:
                failed += 1
                if len(failures) < max_failures:
                    failures.append(str(e))
        total_failed += failed
        out["shards"][sh] = {"chunks": chunks, "passed": passed,
                             "failed": failed, "unchecksummed": nocrc,
                             "failures": failures}
    out["total_failed"] = total_failed
    return out
