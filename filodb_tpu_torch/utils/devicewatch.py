"""Device-resource bookkeeping for the grid cache: an upload ledger and a
flight recorder.

- :data:`LEDGER` is the one sanctioned way to move host arrays onto the
  device from this package (``LEDGER.device_put``).  It keeps live
  resident bytes by ``(owner, format)``; a ``weakref.finalize`` on each
  tensor gives its bytes back when PyTorch frees it, so the totals always
  equal the bytes of the live tracked tensors.
- :data:`FLIGHT` is a bounded ring of recent structured events (evictions,
  flushes) for postmortems.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch


class HbmLedger:
    """Process-wide accounting of device-resident bytes by owner/format."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bytes: dict[tuple, int] = {}     # (owner, fmt) -> live bytes
        self._marks: dict[tuple, int] = {}     # high watermarks
        self._counts: dict[tuple, int] = {}    # live tensor counts
        self._fins: dict[int, object] = {}     # id(tensor) -> finalizer
        self.evictions: dict[tuple, int] = {}  # (owner, reason) -> count

    def device_put(self, x: np.ndarray, device, *, owner: str,
                   fmt: str = "dense") -> torch.Tensor:
        """Copy a host array to ``device`` and register its bytes."""
        out = torch.as_tensor(np.ascontiguousarray(x)).to(device)
        self.track(out, owner=owner, fmt=fmt)
        return out

    def track(self, t: torch.Tensor, *, owner: str,
              fmt: str = "dense") -> None:
        """Register a resident tensor.  Idempotent per tensor identity."""
        nbytes = t.numel() * t.element_size()
        key = id(t)
        lkey = (owner, fmt)
        with self._lock:
            if key in self._fins:
                return
            fin = weakref.finalize(t, self._untrack, key, lkey, nbytes)
            fin.atexit = False
            self._fins[key] = fin
            total = self._bytes.get(lkey, 0) + nbytes
            self._bytes[lkey] = total
            self._counts[lkey] = self._counts.get(lkey, 0) + 1
            self._marks[lkey] = max(self._marks.get(lkey, 0), total)

    def _untrack(self, key: int, lkey: tuple, nbytes: int) -> None:
        with self._lock:
            self._fins.pop(key, None)
            self._bytes[lkey] = self._bytes.get(lkey, 0) - nbytes
            self._counts[lkey] = self._counts.get(lkey, 0) - 1

    def note_eviction(self, owner: str, reason: str, n: int = 1,
                      nbytes: int = 0) -> None:
        """Attribute an eviction: ``budget_overflow`` (arena over its
        byte budget) or ``epoch_purge`` (data changed)."""
        with self._lock:
            self.evictions[(owner, reason)] = \
                self.evictions.get((owner, reason), 0) + n
        FLIGHT.record("evict", owner=owner, reason=reason, n=n, bytes=nbytes)

    def owners(self) -> dict:
        """{owner: {format: {bytes, high_watermark, arrays}}} snapshot."""
        with self._lock:
            out: dict = {}
            for owner, fmt in sorted(set(self._bytes) | set(self._marks)):
                out.setdefault(owner, {})[fmt] = {
                    "bytes": self._bytes.get((owner, fmt), 0),
                    "high_watermark": self._marks.get((owner, fmt), 0),
                    "arrays": self._counts.get((owner, fmt), 0),
                }
        return out

class FlightRecorder:
    """Bounded ring of recent structured events; ``record`` is a counter
    fetch plus one list-slot store, safe from any thread."""

    def __init__(self, capacity: int = 2048):
        self._cap = max(16, int(capacity))
        self._buf: list = [None] * self._cap
        self._ctr = itertools.count()

    def record(self, kind: str, **fields) -> None:
        i = next(self._ctr)
        self._buf[i % self._cap] = (time.time(), i, kind, fields)

    def events(self, limit: Optional[int] = None,
               kind: Optional[str] = None) -> list[dict]:
        """Oldest-first dump."""
        rows = sorted((e for e in list(self._buf) if e is not None),
                      key=lambda e: e[1])
        if kind is not None:
            rows = [e for e in rows if e[2] == kind]
        if limit is not None:
            rows = rows[-int(limit):]
        return [{"t_s": t, "seq": seq, "kind": k, **fields}
                for t, seq, k, fields in rows]


LEDGER = HbmLedger()
FLIGHT = FlightRecorder()
