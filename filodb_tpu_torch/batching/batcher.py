"""Query batcher: co-arrival rendezvous at the device-dispatch boundary.

The grid cache offers every eligible dispatch to its shard's
``QueryBatcher`` (``TimeSeriesShard.query_batcher``).  Queries whose
plans share a batch key (the same resident planes, the same
``GridQuery``, the same grid shape; they differ only in their
``(row0, steps0)`` start) are stacked and launched as ONE launch of the
grid kernel, the member on its second grid axis; each member receives
its own slice of the stacked output, bit-equal to what its solo launch
gives.

Gating adapts, so that a lone query never waits:

* an OPEN group for the key exists  -> join it (deadline permitting);
* the key is HOT (a real group formed recently) or another dispatch for
  the key is in flight right now -> lead a new group and hold the
  co-arrival window;
* otherwise -> passthrough: the solo closure runs at once, tracked only
  so that a concurrent twin sees the overlap and starts the first group.

Every member keeps its own admission permit and deadline: a query whose
remaining budget cannot afford the window joins no batch, and the leader
re-checks each member's permit and budget when it stacks the group;
expired or released members are dropped from the stack and fall back to
the ordinary per-query chain (where the deadline tripwire fires).  Any
error of the batched path opens a process breaker: the group demotes to
per-query launches and the batcher passes everything through until
``reset_batch_breaker``.

The batched launch takes exactly the live members.  (The JAX package
pads the stack to a power of two, to bound the compiles of its vmapped
program; a CUDA launch compiles nothing per member count, and a padded
member would cost a whole member of CTAs.)
"""

from __future__ import annotations

import logging
import threading
import time

from filodb_tpu_torch.utils.devicewatch import FLIGHT
from filodb_tpu_torch.utils.observability import batch_metrics
from filodb_tpu_torch.workload import deadline as wdl

_LOG = logging.getLogger(__name__)

_BATCH_BROKEN = False


def batching_broken() -> bool:
    return _BATCH_BROKEN


def reset_batch_breaker() -> None:
    """Close the batched path's breaker (an operator's verb; tests)."""
    global _BATCH_BROKEN
    _BATCH_BROKEN = False


class _Group:
    """One forming batch: members stack under the batcher's lock; the
    leader launches once the group is full or the window expires."""

    __slots__ = ("key", "members", "open", "full", "done", "results")

    def __init__(self, key):
        self.key = key
        self.members: list = []
        self.open = True
        self.full = threading.Event()
        self.done = threading.Event()
        # parallel to members (None: that member falls back solo), or
        # None when the whole group demoted
        self.results = None


class _Member:
    __slots__ = ("row0", "steps0", "qctx")

    def __init__(self, row0, steps0, qctx):
        self.row0, self.steps0, self.qctx = row0, steps0, qctx


class QueryBatcher:
    """A dataset's rendezvous for one batched launch of concurrent
    shape-compatible queries."""

    def __init__(self, *, enabled: bool = True, window_ms: float = 3.0,
                 max_batch: int = 8, hot_ttl_s: float = 10.0,
                 slack_ms: float = 25.0, dataset: str = "",
                 ledger=None):
        self.enabled = bool(enabled)
        self.window_ms = float(window_ms)
        self.max_batch = int(max_batch)
        self.hot_ttl_s = float(hot_ttl_s)
        # deadline budget a joiner must hold beyond the window (the
        # stacked launch and its members' reads)
        self.slack_ms = float(slack_ms)
        self.dataset = dataset
        # an object with note_batch(batch_key, size) for realized group
        # sizes, or a zero-argument callable returning one (or None)
        self.ledger = ledger
        self._lock = threading.Lock()
        self._groups: dict = {}       # key -> open _Group
        self._inflight: dict = {}     # key -> concurrent solo dispatches
        self._hot: dict = {}          # key -> monotonic expiry
        self._m = batch_metrics()
        self._peak = 0

    # ------------------------------------------------------------ config

    def configure(self, *, enabled=None, window_ms=None, max_batch=None,
                  hot_ttl_s=None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if window_ms is not None:
            self.window_ms = float(window_ms)
        if max_batch is not None:
            self.max_batch = max(1, int(max_batch))
        if hot_ttl_s is not None:
            self.hot_ttl_s = float(hot_ttl_s)

    def snapshot(self) -> dict:
        return {"enabled": self.enabled, "window_ms": self.window_ms,
                "max_batch": self.max_batch,
                "hot_ttl_s": self.hot_ttl_s,
                "breaker_open": _BATCH_BROKEN,
                "realized_peak": self._peak}

    # ---------------------------------------------------------- dispatch

    def dispatch(self, key, row0, steps0, qctx, batch_launch, solo):
        """Offer one device dispatch to the batching tier.

        Returns the member's result (its slice of the stacked launch, or
        the solo result when the batcher ran the passthrough), or None
        when the caller must run its own solo fallback: the per-query
        chain, bit-identical to a serve without a batcher.
        ``batch_launch(row0s, steps0s)`` returns the stacked output, the
        member axis leading."""
        if not self.enabled:
            return None
        if _BATCH_BROKEN:
            self._m["fallbacks"].inc(dataset=self.dataset,
                                     reason="breaker")
            return None
        window_ms = self.window_ms
        if qctx is not None and getattr(qctx, "deadline_ms", 0):
            if wdl.remaining_ms(qctx) < window_ms + self.slack_ms:
                # the remaining budget cannot afford the co-arrival
                # window: this query joins no batch
                self._m["fallbacks"].inc(dataset=self.dataset,
                                         reason="deadline")
                return None
        now = time.monotonic()
        lead = False
        with self._lock:
            g = self._groups.get(key)
            if g is not None and g.open:
                my = len(g.members)
                g.members.append(_Member(row0, steps0, qctx))
                if len(g.members) >= self.max_batch:
                    g.open = False
                    self._groups.pop(key, None)
                    g.full.set()
            elif (self._hot.get(key, 0.0) > now
                  or self._inflight.get(key, 0) > 0):
                g = _Group(key)
                g.members.append(_Member(row0, steps0, qctx))
                self._groups[key] = g
                my, lead = 0, True
            else:
                # cold, no concurrent twin: passthrough, tracked so that
                # an overlapping arrival starts the key's first group
                self._inflight[key] = self._inflight.get(key, 0) + 1
                g = None
        if g is None:
            try:
                return solo()
            finally:
                with self._lock:
                    n = self._inflight.get(key, 1) - 1
                    if n > 0:
                        self._inflight[key] = n
                    else:
                        self._inflight.pop(key, None)
        if lead:
            self._lead(g, window_ms, batch_launch)
        elif not g.done.wait(timeout=window_ms / 1000.0 + 60.0):
            self._m["fallbacks"].inc(dataset=self.dataset,
                                     reason="timeout")
            return None
        return g.results[my] if g.results is not None else None

    # ------------------------------------------------------------ leader

    def _lead(self, g, window_ms, batch_launch) -> None:
        end = time.monotonic() + window_ms / 1000.0
        while not g.full.is_set():
            left = end - time.monotonic()
            if left <= 0:
                break
            g.full.wait(left)
        with self._lock:
            g.open = False
            if self._groups.get(g.key) is g:
                self._groups.pop(g.key, None)
        try:
            self._launch_group(g, batch_launch)
        except Exception as e:     # demote the whole group
            global _BATCH_BROKEN
            _BATCH_BROKEN = True
            g.results = None
            FLIGHT.record("breaker.trip", breaker="query_batch",
                          error=repr(e)[:200])
            self._m["fallbacks"].inc(len(g.members),
                                     dataset=self.dataset,
                                     reason="error")
            _LOG.exception("batched query launch failed; demoting the "
                           "group to per-query launches and opening the "
                           "batch breaker")
        finally:
            g.done.set()

    def _launch_group(self, g, batch_launch) -> None:
        """Stack the group's live members and launch once.

        Every stacked member must still hold its admission permit and
        have deadline budget left: a member whose permit was released or
        whose budget expired while the window was open is dropped from
        the stack and demotes to the per-query chain, where the ordinary
        tripwires raise."""
        members = g.members
        if len(members) < 2:
            # the window expired with no co-arrival: the lone member (the
            # leader) runs its unchanged solo chain
            g.results = None
            self._m["fallbacks"].inc(dataset=self.dataset,
                                     reason="solo-window")
            return
        live = []
        for i, m in enumerate(members):
            qc = m.qctx
            permit = getattr(qc, "admission_permit", None)
            if permit is not None and getattr(permit, "released", False):
                continue           # its admission window closed
            if qc is not None and getattr(qc, "deadline_ms", 0) \
                    and wdl.remaining_ms(qc) <= 0:
                continue           # its budget died while the window held
            live.append(i)
        dropped = len(members) - len(live)
        if dropped:
            self._m["fallbacks"].inc(dropped, dataset=self.dataset,
                                     reason="member-expired")
        if len(live) < 2:
            g.results = None
            if live:
                self._m["fallbacks"].inc(dataset=self.dataset,
                                         reason="solo-window")
            return
        out = batch_launch([members[i].row0 for i in live],
                           [members[i].steps0 for i in live])
        results = [None] * len(members)
        for j, i in enumerate(live):
            results[i] = out[j]
        g.results = results
        self._note_realized(g.key, members, live)

    def _note_realized(self, key, members, live) -> None:
        size = len(live)
        self._m["groups"].inc(dataset=self.dataset)
        self._m["members"].inc(size, dataset=self.dataset)
        if size > self._peak:
            self._peak = size
            self._m["peak"].set(size, dataset=self.dataset)
        now = time.monotonic()
        with self._lock:
            self._hot[key] = now + self.hot_ttl_s
            if len(self._hot) > 256:
                self._hot = {k: t for k, t in self._hot.items()
                             if t > now}
        ledger = self.ledger() if callable(self.ledger) else self.ledger
        if ledger is not None:
            seen = set()
            for i in live:
                bk = getattr(members[i].qctx, "batch_key", "")
                if bk and bk not in seen:
                    seen.add(bk)
                    ledger.note_batch(bk, size)
