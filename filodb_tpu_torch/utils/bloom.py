"""Bloom filter over byte keys, numpy-bitmap backed.

Stands in for the reference's evicted-partkey bloom filter
(reference: core/.../TimeSeriesShard.scala:418-424 evictedPartKeys,
``bloomfilter.mutable.BloomFilter`` with configured capacity), used to
decide whether a newly seen part key might have been evicted (and so needs
an index/column-store lookup before re-creation).
"""

from __future__ import annotations

import hashlib

import numpy as np


class BloomFilter:
    def __init__(self, capacity: int, error_rate: float = 0.01) -> None:
        # standard sizing: m = -n ln(p) / (ln 2)^2, k = m/n ln 2
        n = max(capacity, 1)
        m = int(-n * np.log(error_rate) / (np.log(2) ** 2))
        self._bits = np.zeros((m + 63) // 64, dtype=np.uint64)
        self._m = max(m, 64)
        self._k = max(int(round(m / n * np.log(2))), 1)
        self.count = 0

    def _positions(self, key: bytes) -> np.ndarray:
        d = hashlib.blake2b(key, digest_size=16).digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:], "little") | 1
        return np.array([(h1 + i * h2) % self._m for i in range(self._k)],
                        dtype=np.uint64)

    def add(self, key: bytes) -> None:
        for p in self._positions(key):
            self._bits[int(p) >> 6] |= np.uint64(1) << np.uint64(int(p) & 63)
        self.count += 1

    def __contains__(self, key: bytes) -> bool:
        for p in self._positions(key):
            word = self._bits[int(p) >> 6]
            if not (word >> np.uint64(int(p) & 63)) & np.uint64(1):
                return False
        return True
