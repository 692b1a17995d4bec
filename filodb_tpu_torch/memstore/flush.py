"""Pipelined flush scheduling: time boundaries + a dedicated executor.

The reference never flushes on the ingest thread: ``createFlushTasks``
(ingest thread) detects per-group time-boundary crossings and snapshots
buffers; ``doFlushSteps`` encodes and writes on a separate flush
scheduler with ``flush-task-parallelism`` workers (reference:
core/src/main/scala/filodb.core/memstore/TimeSeriesShard.scala:804-846,
TimeSeriesMemStore.scala:106-129).  This module is that split: :class:`FlushScheduler` watches the shard's newest sample
timestamp, and when group *g*'s staggered boundary is crossed it runs
``shard.prepare_flush_group(g)`` inline (O(1) buffer detaches) and
submits ``shard.run_flush_task`` (encode + IO) to a thread pool.  Host
code: the only device work a task does is the grid caches' headroom
reclaim, which the shard runs under its own device.

Group boundaries are staggered across the flush interval — group g
flushes at phase ``g/G`` of each interval — so flush load spreads evenly
instead of spiking (reference :804-846).  Tasks for one group are
chained so they execute in submission order (checkpoint monotonicity);
different groups flush in parallel.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

_METRICS = None


def _m() -> dict:
    global _METRICS
    if _METRICS is None:
        from filodb_tpu_torch.utils.observability import flush_metrics
        _METRICS = flush_metrics()
    return _METRICS


class FlushScheduler:
    """Drives pipelined flushes for one shard.

    ``note_ingested()`` is called from the ingest thread after each
    container; it is O(1) when no boundary was crossed.  ``close()``
    drains all in-flight flush tasks.

    Observability: per-group pending-task depth and last-flush age are
    tracked here and exported as ``filodb_flush_queue_depth`` /
    ``filodb_flush_last_age_seconds`` (set_fn-sampled; deregistered on
    close so dead schedulers leave no rows) plus a per-group
    :meth:`snapshot`.
    """

    def __init__(self, shard, flush_interval_ms: Optional[int] = None,
                 parallelism: int = 2):
        self.shard = shard
        self.interval = flush_interval_ms or shard.config.flush_interval_ms
        if self.interval <= 0:
            raise ValueError("flush interval must be positive")
        self.parallelism = parallelism
        self._exec = ThreadPoolExecutor(
            max_workers=parallelism,
            thread_name_prefix=f"flush-{shard.dataset}-{shard.shard_num}")
        ngroups = shard.num_groups
        # group g's boundary phase within each interval
        self._phase = [g * self.interval // ngroups for g in range(ngroups)]
        self._next_boundary: list[Optional[int]] = [None] * ngroups
        self._chains: dict[int, Future] = {}
        self._lock = threading.Lock()
        self.flushes_submitted = 0
        self._closed = False
        # submitted-but-not-completed per group + completion stamps
        self._pending = [0] * ngroups
        self._last_done: list[Optional[float]] = [None] * ngroups
        self._started_s = time.monotonic()
        self._labels = {"dataset": shard.dataset, "shard": shard.shard_num}
        m = _m()
        m["queue_depth"].set_fn(lambda: float(self.queue_depth()),
                                **self._labels)
        m["last_age"].set_fn(self.last_flush_age_s, **self._labels)

    # ------------------------------------------------------- observability

    def queue_depth(self) -> int:
        """Flush tasks submitted but not yet completed, all groups."""
        with self._lock:
            return sum(self._pending)

    def last_flush_age_s(self) -> float:
        """Seconds since the most recent completed flush on ANY group
        (age since scheduler start when nothing completed yet)."""
        with self._lock:
            done = [t for t in self._last_done if t is not None]
            anchor = max(done) if done else self._started_s
        return max(0.0, time.monotonic() - anchor)

    def snapshot(self) -> dict:
        """Per-group pipeline state (pending tasks, last flush age)."""
        now = time.monotonic()
        with self._lock:
            groups = [
                {"group": g, "pending": self._pending[g],
                 "last_flush_age_s":
                     round(now - self._last_done[g], 3)
                     if self._last_done[g] is not None else None}
                for g in range(self.shard.num_groups)]
            submitted = self.flushes_submitted
            pending = sum(self._pending)
        return {"pending": pending, "flushes_submitted": submitted,
                "groups": groups}

    def _track(self, group: int, fut: Future) -> None:
        """Count a submitted task until its future resolves.  Caller
        must NOT hold ``_lock``: a fast (or inline) future runs the done
        callback synchronously from ``add_done_callback``, which takes
        the lock again."""
        with self._lock:
            self._pending[group] += 1

        def done(_f, _g=group):
            with self._lock:
                self._pending[_g] -= 1
                self._last_done[_g] = time.monotonic()

        fut.add_done_callback(done)

    def _boundary_after(self, t: int, group: int) -> int:
        ph = self._phase[group]
        return ((t - ph) // self.interval + 1) * self.interval + ph

    def note_ingested(self) -> int:
        """Check boundary crossings against the shard's newest sample
        timestamp; prepare + submit any due groups.  Returns the number
        of flush tasks submitted."""
        t = self.shard.latest_ingest_ts
        if t < 0:
            return 0
        submitted = 0
        for g in range(self.shard.num_groups):
            nb = self._next_boundary[g]
            if nb is None:
                # first sight of data: schedule the next boundary
                self._next_boundary[g] = self._boundary_after(t, g)
                continue
            if t >= nb:
                self._next_boundary[g] = self._boundary_after(t, g)
                self._submit(g)
                submitted += 1
        return submitted

    def flush_now(self, group: Optional[int] = None) -> None:
        """Force a flush of one group (or all) through the pipeline."""
        groups = range(self.shard.num_groups) if group is None else (group,)
        for g in groups:
            self._submit(g)

    def _submit(self, group: int) -> Future:
        # closed check BEFORE prepare: prepare irreversibly detaches
        # buffers and the dirty-partkey set, which would be dropped if we
        # prepared first and then refused the submit
        with self._lock:
            if self._closed:
                raise RuntimeError("FlushScheduler is closed")
        task = self.shard.prepare_flush_group(group)

        def run(_prev: Optional[Future]) -> int:
            return self.shard.run_flush_task(task)

        fut: Optional[Future] = None
        with self._lock:
            if not self._closed:
                try:
                    prev = self._chains.get(group)
                    if prev is None:
                        fut = self._exec.submit(run, None)
                    else:
                        # chain: group tasks run in submission order even
                        # when the pool has spare workers (checkpoint
                        # monotonicity)
                        fut = Future()

                        def after(p, _task=task, _fut=fut):
                            try:
                                _fut.set_result(
                                    self.shard.run_flush_task(_task))
                            except BaseException as e:  # via the future
                                _fut.set_exception(e)

                        prev.add_done_callback(
                            lambda p: self._exec.submit(after, p))
                    # keyed by flush group id: bounded by groups-per-shard
                    self._chains[group] = fut
                    self.flushes_submitted += 1
                except RuntimeError:
                    fut = None  # executor shut down between check and submit
        if fut is not None:
            self._track(group, fut)
            return fut
        # closed (or shut down) after prepare irreversibly detached the
        # buffers: run inline, outside the lock, so the snapshot is never
        # lost; the flush succeeded, so report it as such
        fut = Future()
        fut.set_result(self.shard.run_flush_task(task))
        with self._lock:
            self.flushes_submitted += 1
        self._track(group, fut)
        return fut

    def drain(self) -> None:
        """Block until all submitted flush tasks completed."""
        while True:
            with self._lock:
                futs = list(self._chains.values())
            for f in futs:
                f.result()
            with self._lock:
                if all(f.done() for f in self._chains.values()):
                    return

    def close(self, flush_remaining: bool = True) -> None:
        """Drain, optionally flush whatever is still buffered, shut down.
        The executor is shut down even when a flush task failed — the
        task's exception still propagates to the caller."""
        try:
            if flush_remaining:
                self.flush_now()
            self.drain()
        finally:
            with self._lock:
                self._closed = True
            self._exec.shutdown(wait=True)
            # deregister the sampled gauges: a retired scheduler must not
            # keep exporting rows (or keep the shard alive via set_fn)
            m = _m()
            m["queue_depth"].remove(**self._labels)
            m["last_age"].remove(**self._labels)
