"""Deterministic data fault injection for integrity testing.

The reference proves its corruption handling with unit-level byte
surgery; this harness does it end to end and deterministically from a
seed: flip bytes in chunks persisted in the sqlite ColumnStore, truncate
their frames, corrupt their stored checksums, or flip bytes in a live
partition's frozen (device-staging) chunk vectors.  Never point it at
data you care about.
"""

from __future__ import annotations

import random
from typing import Optional

from filodb_tpu_torch.integrity import chunk_crc


class FaultInjector:
    """Seeded corruption source.  Every choice (which chunk, which byte,
    which bit) comes from ``random.Random(seed)`` so a failing test
    reproduces exactly."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)

    # ------------------------------------------------------------ byte ops

    def flip_byte(self, data: bytes, index: Optional[int] = None,
                  ) -> tuple[bytes, int]:
        """One bit flipped in one byte.  Returns (corrupted, index)."""
        b = bytearray(data)
        if not b:
            raise ValueError("cannot flip a byte of an empty buffer")
        if index is None:
            index = self.rng.randrange(len(b))
        b[index] ^= 1 << self.rng.randrange(8)
        return bytes(b), index

    def truncate(self, data: bytes, keep: Optional[int] = None) -> bytes:
        """Drop the tail of a frame (keep >= 1 byte so the row still
        parses as a blob)."""
        if keep is None:
            keep = self.rng.randrange(1, max(len(data), 2))
        return bytes(data[:keep])

    # ------------------------------------------------------- disk chunks

    def corrupt_stored_chunk(self, store, dataset: str, shard: int,
                             partkey: Optional[bytes] = None,
                             chunk_id: Optional[int] = None,
                             mode: str = "flip",
                             fix_crc: bool = False) -> tuple[bytes, int]:
        """Corrupt one chunk row in a DiskColumnStore.

        ``mode``: ``"flip"`` (one bit of the framed blob), ``"truncate"``
        (drop the frame tail), or ``"crc"`` (corrupt only the stored
        checksum, leaving the data intact).  ``fix_crc=True`` recomputes
        the stored checksum over the corrupted blob so the checksum
        verify PASSES and the decode tripwire must catch it instead.
        Returns (partkey, chunk_id) of the victim."""
        conn = store._conn()
        where = "dataset=? AND shard=?"
        params: list = [dataset, shard]
        if partkey is not None:
            where += " AND partkey=?"
            params.append(partkey)
        if chunk_id is not None:
            where += " AND chunk_id=?"
            params.append(chunk_id)
        rows = conn.execute(
            f"SELECT partkey, chunk_id, vectors, crc FROM chunks "
            f"WHERE {where} ORDER BY partkey, chunk_id",
            params).fetchall()
        if not rows:
            raise LookupError(f"no chunks match {dataset}/{shard}")
        pk, cid, blob, crc = rows[self.rng.randrange(len(rows))]
        if mode == "flip":
            blob, _ = self.flip_byte(blob)
        elif mode == "truncate":
            blob = self.truncate(blob)
        elif mode == "crc":
            crc = (crc ^ 0xDEADBEEF) or 1
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "crc":
            crc = chunk_crc(blob) if fix_crc else crc
        conn.execute(
            "UPDATE chunks SET vectors=?, crc=? "
            "WHERE dataset=? AND shard=? AND partkey=? AND chunk_id=?",
            (blob, crc, dataset, shard, pk, cid))
        conn.commit()
        return bytes(pk), int(cid)

    # ------------------------------------------- staged (in-memory) chunks

    def corrupt_staged_chunk(self, partition, chunk_index: Optional[int] = None,
                             vector: Optional[int] = None,
                             mode: str = "flip") -> int:
        """Corrupt a frozen chunk's encoded vector ON the live partition
        object — the stand-in for corruption of staging buffers (encoded
        chunks awaiting device-grid staging or flush).

        ``mode``: ``"flip"`` (one random bit — may or may not break the
        decode, exactly like real bit rot), ``"wire"`` (invalid wire-type
        byte: decode MUST fail — deterministic tests), or ``"truncate"``.
        Returns the victim chunk_id."""
        if not partition.chunks:
            raise LookupError("partition has no frozen chunks")
        if chunk_index is None:
            chunk_index = self.rng.randrange(len(partition.chunks))
        cs = partition.chunks[chunk_index]
        vecs = list(cs.vectors)
        if vector is None:
            vector = self.rng.randrange(len(vecs))
        raw = bytes(vecs[vector])
        if mode == "flip":
            corrupted, _ = self.flip_byte(raw)
        elif mode == "wire":
            corrupted = bytes([0xEE]) + raw[1:]
        elif mode == "truncate":
            corrupted = self.truncate(raw)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        vecs[vector] = corrupted
        cs.vectors = vecs
        # the decoded cache may hold the clean decode: drop it so the
        # corruption is actually exercised on the next read
        partition._decoded.pop(cs.info.chunk_id, None)
        return int(cs.info.chunk_id)
