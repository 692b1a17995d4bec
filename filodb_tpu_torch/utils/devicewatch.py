"""Device-resource bookkeeping: an upload ledger, a kernel ledger and a
flight recorder.

- :data:`LEDGER` is the one sanctioned way to move host arrays onto the
  device from this package (``LEDGER.device_put``).  It keeps live
  resident bytes by ``(owner, format)``; a ``weakref.finalize`` on each
  tensor gives its bytes back when PyTorch frees it, so the totals always
  equal the bytes of the live tracked tensors.  They are exported per
  owner as ``filodb_device_hbm_bytes{owner,format}`` and its high
  watermark.  Host-side byte pools (the paging shard's page cache)
  register with :meth:`HbmLedger.register_pool` and are sampled when read.
- :data:`KERNEL_TIMER` is the sampled device-time ledger of every
  program wrapped by :func:`timed` (the four grid programs and the
  kernel wrappers): every launch counts; every Nth launch a program is
  timed — by a pair of CUDA events on the card, by the wall clock
  around the plain version on the CPU — and folded into an EWMA, a
  log-histogram, the active query's ``device_programs`` split and a
  regression sentry with a baseline that only ratchets down.
- :data:`FLIGHT` is a bounded ring of recent structured events (evictions,
  flushes, integrity failures, kernel regressions, ingest stalls) for
  postmortems; ``dump_to_log`` writes its tail to the log when a shard
  fails its integrity check or (:func:`install_crash_hooks`) a thread
  dies of an unhandled exception.

The reference's JIT compile telemetry has no meaning here: PyTorch runs
these programs eagerly, so :func:`timed` is a plain decorator.
"""

from __future__ import annotations

import bisect
import functools
import itertools
import logging
import threading
import time
import weakref
from typing import Callable, Optional

import numpy as np
import torch

_LOG = logging.getLogger("filodb.devicewatch")

# kill switch: set_enabled(False) makes every timed program a plain call
# and stops flight events (the instrumentation's cost is measured
# against this)
_ENABLED = True

# the card's device-memory rate: H100 SXM, 3.35 TB/s
H100_HBM_BYTES_PER_S = 3.35e12


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def _metrics() -> dict:
    from filodb_tpu_torch.utils.observability import device_metrics
    return device_metrics()


class HbmLedger:
    """Process-wide accounting of device-resident bytes by owner/format."""

    def __init__(self) -> None:
        # reentrant: allocating under the lock (a finalizer, a gauge)
        # can run the cyclic GC, whose weakref finalizers call _untrack
        # on this same thread
        self._lock = threading.RLock()
        self._bytes: dict[tuple, int] = {}     # (owner, fmt) -> live bytes
        self._marks: dict[tuple, int] = {}     # high watermarks
        self._counts: dict[tuple, int] = {}    # live tensor counts
        self._fins: dict[int, object] = {}     # id(tensor) -> finalizer
        self.evictions: dict[tuple, int] = {}  # (owner, reason) -> count
        # name -> (bytes_fn, budget_fn, fmt): sampled host pools
        self._pools: dict[str, tuple] = {}

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
            fresh = lkey not in self._bytes
            self._bytes[lkey] = total
            self._counts[lkey] = self._counts.get(lkey, 0) + 1
            self._marks[lkey] = max(self._marks.get(lkey, 0), total)
        if fresh:
            # per-owner gauges, sampled when read: a gauge write under the
            # ledger lock could meet a finalizer of this same thread
            m = _metrics()
            m["hbm_bytes"].set_fn(
                lambda: float(self._bytes.get(lkey, 0)),
                owner=owner, format=fmt)
            m["hbm_watermark"].set_fn(
                lambda: float(self._marks.get(lkey, 0)),
                owner=owner, format=fmt)
        self._note_query_delta(nbytes)

    def _untrack(self, key: int, lkey: tuple, nbytes: int) -> None:
        with self._lock:
            self._fins.pop(key, None)
            self._bytes[lkey] = self._bytes.get(lkey, 0) - nbytes
            self._counts[lkey] = self._counts.get(lkey, 0) - 1
        self._note_query_delta(-nbytes)

    @staticmethod
    def _note_query_delta(nbytes: int) -> None:
        """Attribute a residency change to the query whose ExecContext is
        active on this thread (``QueryStats.hbm_resident_delta_bytes``):
        a commit credits it, a free debits it.  Called with the ledger's
        lock released: the finalizer runs on whichever thread drops the
        last reference, also inside a GC that ``track`` set off.
        Accounting never raises into the work it accounts."""
        try:
            from filodb_tpu_torch.query.exec import active_exec_ctx
            ctx = active_exec_ctx()
            if ctx is not None:
                ctx.note_counts(hbm_delta=nbytes)
        except Exception:  # noqa: BLE001 — interpreter teardown included
            pass

    def register_pool(self, name: str, bytes_fn: Callable[[], int],
                      budget_fn: Optional[Callable[[], int]] = None,
                      fmt: str = "odp-page-cache") -> None:
        """Register a host-side byte pool, sampled at read time; it shows
        in :meth:`pools` and as ``filodb_device_hbm_bytes{owner=<name>,
        format=<fmt>}``."""
        with self._lock:
            self._pools[name] = (bytes_fn, budget_fn, fmt)
        _metrics()["hbm_bytes"].set_fn(
            lambda: float(self._pool_bytes(name)), owner=name, format=fmt)

    def deregister_pool(self, name: str) -> None:
        with self._lock:
            pool = self._pools.pop(name, None)
        if pool is not None:
            _metrics()["hbm_bytes"].remove(owner=name, format=pool[2])

    def _pool_bytes(self, name: str) -> int:
        pool = self._pools.get(name)
        if pool is None:
            return 0
        try:
            return int(pool[0]())
        except Exception:  # noqa: BLE001 — pool owner shut down
            return 0

    def pools(self) -> dict:
        """{name: {bytes, budget}} of every registered pool."""
        with self._lock:
            names = list(self._pools.items())
        out = {}
        for name, (bytes_fn, budget_fn, _fmt) in names:
            row = {"bytes": 0}
            try:
                row["bytes"] = int(bytes_fn())
                if budget_fn is not None:
                    row["budget"] = int(budget_fn())
            except Exception:  # noqa: BLE001 — pool owner shut down
                pass
            out[name] = row
        return out

    def note_eviction(self, owner: str, reason: str, n: int = 1,
                      nbytes: int = 0) -> None:
        """Attribute an eviction: ``budget_overflow`` (arena over its
        byte budget), ``epoch_purge`` (data changed) or
        ``integrity_quarantine`` (a chunk was quarantined)."""
        with self._lock:
            self.evictions[(owner, reason)] = \
                self.evictions.get((owner, reason), 0) + n
        _metrics()["evictions"].inc(n, owner=owner, reason=reason)
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

    def total_bytes(self, owner: Optional[str] = None) -> int:
        with self._lock:
            return sum(v for (o, _f), v in self._bytes.items()
                       if owner is None or o == owner)

    def reconcile(self) -> dict:
        """Ledger bytes against ``torch.cuda.memory_allocated`` of each
        visible card (the gap is PyTorch's scratch and untracked
        tensors); empty without a card."""
        out = {}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            ledger = self.total_bytes()
            for i in range(torch.cuda.device_count()):
                used = int(torch.cuda.memory_allocated(i))
                out[f"cuda:{i}"] = {"ledger_bytes": ledger,
                                    "bytes_in_use": used,
                                    "untracked_bytes": used - ledger}
        return out


class FlightRecorder:
    """Bounded ring of recent structured events; ``record`` is a counter
    fetch plus one list-slot store, safe from any thread."""

    def __init__(self, capacity: int = 2048):
        self._cap = max(16, int(capacity))
        self._buf: list = [None] * self._cap
        self._ctr = itertools.count()

    def resize(self, capacity: int) -> None:
        """Replace the ring; old events are kept up to the new capacity.
        The new buffer is built before any shared state is swapped, and
        :meth:`record` indexes a local snapshot, so a record racing a
        resize lands at worst in the retiring buffer."""
        events = self.events()
        cap = max(16, int(capacity))
        buf = [None] * cap
        kept = events[-cap:]
        for i, ev in enumerate(kept):
            buf[i % cap] = (ev["t_s"], i, ev["kind"],
                            {k: v for k, v in ev.items()
                             if k not in ("t_s", "seq", "kind")})
        self._buf, self._ctr, self._cap = buf, itertools.count(len(kept)), cap

    @property
    def capacity(self) -> int:
        return self._cap

    def record(self, kind: str, **fields) -> None:
        if not _ENABLED:
            return
        i = next(self._ctr)
        buf = self._buf       # snapshot: a concurrent resize swaps the list
        buf[i % len(buf)] = (time.time(), i, kind, fields)

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

    def dump_to_log(self, reason: str, limit: int = 200) -> None:
        """Write the recent event tail to the log (an integrity failure
        fails the shard: the events before it are the postmortem)."""
        try:
            events = self.events(limit=limit)
            lines = [f"flight recorder dump ({reason}): "
                     f"{len(events)} recent events"]
            for ev in events:
                fields = " ".join(f"{k}={v}" for k, v in ev.items()
                                  if k not in ("t_s", "seq", "kind"))
                lines.append(f"  [{ev['t_s']:.3f}] #{ev['seq']} "
                             f"{ev['kind']} {fields}")
            _LOG.error("%s", "\n".join(lines))
        except Exception:  # noqa: BLE001 — the black box must never throw
            pass


LEDGER = HbmLedger()
FLIGHT = FlightRecorder()


# ---------------------------------------------------------------------------
# The kernel ledger: sampled device time a program, and a regression sentry
# ---------------------------------------------------------------------------

# streaming-histogram bucket edges (seconds): powers of two from 1 us to
# ~16 s
_KHIST_EDGES = tuple(2.0 ** i * 1e-6 for i in range(25))


class KernelTimer:
    """Per-program device-time ledger, sampled.

    Every launch of a :func:`timed` program counts (``launches``, and
    ``filodb_kernel_launches_total``); every ``sample_1_in``-th launch a
    program is timed: on the card by a pair of
    ``torch.cuda.Event(enable_timing=True)`` recorded on the current
    stream around the call and waited for, on the CPU by the wall clock
    around the plain version.  The seconds fold into an EWMA, a
    log-histogram, and the active query's ``device_programs`` split.

    The regression sentry: once a program has ``baseline_min_samples``
    sampled launches its baseline seeds from the EWMA, and after that
    only ratchets down.  An EWMA at or above ``regression_factor`` x the
    baseline for ``regression_window_s`` opens ONE episode (a
    ``kernel.regression`` flight event, ``filodb_kernel_regressions_total``
    and ``filodb_kernel_regressed`` at 1) until the EWMA recovers below
    the factor.  Baselines persist through an attached store, where a
    stored (healthy) floor wins over a relearned slower one.

    ``set_fault_delay(program, s)`` sleeps inside a sampled launch's
    timing and adds ``s`` to its seconds: the deterministic slowdown the
    sentry's tests inject.  The roof of the achieved-bytes join is the
    card's device-memory rate (:data:`H100_HBM_BYTES_PER_S`)."""

    def __init__(self, sample_1_in: int = 64,
                 hbm_roof_bytes_per_s: float = H100_HBM_BYTES_PER_S,
                 regression_factor: float = 1.5,
                 regression_window_s: float = 30.0,
                 baseline_min_samples: int = 8,
                 ewma_alpha: float = 0.25):
        self.sample_1_in = int(sample_1_in)
        self.hbm_roof_bytes_per_s = float(hbm_roof_bytes_per_s)
        self.regression_factor = float(regression_factor)
        self.regression_window_s = float(regression_window_s)
        self.baseline_min_samples = int(baseline_min_samples)
        self.ewma_alpha = float(ewma_alpha)
        self._lock = threading.Lock()
        self._rows: dict[str, dict] = {}
        self._fault: dict[str, float] = {}
        self._baseline_save: Optional[Callable[[str, float], None]] = None

    def configure(self, sample_1_in: Optional[int] = None,
                  hbm_roof_bytes_per_s: Optional[float] = None,
                  regression_factor: Optional[float] = None,
                  regression_window_s: Optional[float] = None,
                  baseline_min_samples: Optional[int] = None) -> None:
        with self._lock:
            if sample_1_in is not None:
                # 0 disables sampling; 1 times every launch
                self.sample_1_in = max(0, int(sample_1_in))
            if hbm_roof_bytes_per_s is not None:
                self.hbm_roof_bytes_per_s = max(1.0,
                                                float(hbm_roof_bytes_per_s))
            if regression_factor is not None:
                self.regression_factor = max(1.01, float(regression_factor))
            if regression_window_s is not None:
                self.regression_window_s = max(0.0,
                                               float(regression_window_s))
            if baseline_min_samples is not None:
                self.baseline_min_samples = max(1, int(baseline_min_samples))

    def attach_baseline_store(self, load_fn: Optional[Callable] = None,
                              save_fn: Optional[Callable] = None) -> None:
        """Baseline persistence: ``load_fn() -> {program: seconds}`` is
        merged in now (the lower wins), ``save_fn(program, seconds)`` is
        called when a baseline seeds or improves by 5% or more."""
        stored: dict = {}
        if load_fn is not None:
            try:
                stored = {str(k): float(v)
                          for k, v in (load_fn() or {}).items()}
            except Exception:  # noqa: BLE001 — a broken store loses
                stored = {}   # persistence, never serving
        with self._lock:
            self._baseline_save = save_fn
            for program, sec in stored.items():
                row = self._row_locked(program)
                if row["baseline"] is None or sec < row["baseline"]:
                    row["baseline"] = sec
                row["persisted_baseline"] = sec

    def set_fault_delay(self, program: str, seconds: float) -> None:
        with self._lock:
            self._fault[program] = float(seconds)

    def clear_fault_delay(self, program: str) -> None:
        with self._lock:
            self._fault.pop(program, None)

    def _row_locked(self, program: str) -> dict:
        row = self._rows.get(program)
        if row is None:
            row = self._rows[program] = {
                "launches": 0, "sampled": 0, "seconds": 0.0,
                "ewma": None, "hist": [0] * (len(_KHIST_EDGES) + 1),
                "last_key": "", "bytes": 0,
                "baseline": None, "persisted_baseline": None,
                "over_since": None, "regressed": False, "episodes": 0,
            }
        return row

    def tick(self, program: str) -> bool:
        """Count one launch; True when this launch is to be sampled."""
        n = self.sample_1_in
        with self._lock:
            row = self._row_locked(program)
            row["launches"] += 1
            launch = row["launches"]
        _metrics()["kernel_launches"].inc(program=program)
        return n > 0 and (launch - 1) % n == 0

    def note_bytes(self, program: str, nbytes: int) -> None:
        """Credit the device-memory bytes a program read (the grid
        plan's resident bytes): the numerator of the achieved-bytes/s
        join.  Off with the kill switch, like the launches it divides."""
        if not _ENABLED or nbytes <= 0:
            return
        with self._lock:
            self._row_locked(program)["bytes"] += int(nbytes)

    def timed_call(self, program: str, fn, args: tuple, kwargs: dict):
        """Run one sampled launch of ``fn`` and fold its seconds.  A
        failed launch raises through: nothing here swallows it."""
        with self._lock:
            delay = self._fault.get(program, 0.0)
        t = _first_tensor((args, kwargs))
        if t is not None and t.device.type == "cuda":
            with torch.cuda.device(t.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                if delay:
                    time.sleep(delay)
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 + delay
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if delay:
                time.sleep(delay)
            dt = time.perf_counter() - t0
        self._fold(program, dt, _sampled_key(args, kwargs))
        return out

    def _fold(self, program: str, dt: float, shape_key: str) -> None:
        now = time.monotonic()
        fired = recovered = False
        persist = None
        with self._lock:
            row = self._row_locked(program)
            row["sampled"] += 1
            row["seconds"] += dt
            prev = row["ewma"]
            ew = dt if prev is None else prev + self.ewma_alpha * (dt - prev)
            row["ewma"] = ew
            row["hist"][bisect.bisect_left(_KHIST_EDGES, dt)] += 1
            row["last_key"] = shape_key
            base = row["baseline"]
            if base is None:
                if row["sampled"] >= self.baseline_min_samples:
                    row["baseline"] = base = ew          # seed
            elif ew < base and row["sampled"] >= self.baseline_min_samples:
                # ratchet down, once the EWMA has warmed up: a restart's
                # first sample must not drag a loaded baseline down to
                # one small call's time
                row["baseline"] = base = ew
            last = row["persisted_baseline"]
            if base is not None and (last is None or base < last * 0.95):
                row["persisted_baseline"] = base
                persist = base
            if base is not None:
                if ew >= self.regression_factor * base:
                    if row["over_since"] is None:
                        row["over_since"] = now
                    elif not row["regressed"] and now - row["over_since"] \
                            >= self.regression_window_s:
                        row["regressed"] = True
                        row["episodes"] += 1
                        fired = True
                else:
                    row["over_since"] = None
                    if row["regressed"]:
                        row["regressed"] = False
                        recovered = True
            bytes_total = row["bytes"]
            launches = row["launches"]
            save = self._baseline_save
        m = _metrics()
        m["kernel_seconds"].inc(dt, program=program)
        if bytes_total and launches and ew > 0:
            m["kernel_roofline"].set(
                (bytes_total / launches) / ew / self.hbm_roof_bytes_per_s,
                program=program)
        if persist is not None:
            # a seed or a ratchet: never at once with a fire, since both
            # put the EWMA under the factor
            m["kernel_regressed"].set(0.0, program=program)
            if save is not None:
                try:
                    save(program, persist)
                except Exception:  # noqa: BLE001 — persistence is
                    pass           # best-effort, never serving-fatal
        if fired:
            m["kernel_regressions"].inc(program=program)
            m["kernel_regressed"].set(1.0, program=program)
            FLIGHT.record("kernel.regression", program=program,
                          ewma_s=round(ew, 6), baseline_s=round(base, 6),
                          factor=self.regression_factor)
            _LOG.warning(
                "kernel regression: program %r EWMA device time %.6fs is "
                ">= %.2fx its learned baseline %.6fs (sustained %.1fs)",
                program, ew, self.regression_factor, base,
                self.regression_window_s)
        if recovered:
            m["kernel_regressed"].set(0.0, program=program)
            FLIGHT.record("kernel.recovery", program=program,
                          ewma_s=round(ew, 6), baseline_s=round(base, 6))
        _note_query_program(program, dt)

    def launches(self, program: str) -> int:
        with self._lock:
            row = self._rows.get(program)
            return row["launches"] if row is not None else 0

    def table(self) -> list[dict]:
        """One row a program, most launched first."""
        roof = self.hbm_roof_bytes_per_s
        with self._lock:
            rows = []
            for program, r in self._rows.items():
                ew = r["ewma"]
                achieved = None
                if r["bytes"] and r["launches"] and ew:
                    achieved = (r["bytes"] / r["launches"]) / ew
                rows.append({
                    "program": program,
                    "launches": r["launches"],
                    "sampled": r["sampled"],
                    "device_seconds": round(r["seconds"], 6),
                    "ewma_device_s": round(ew, 6) if ew is not None
                    else None,
                    "bytes_total": r["bytes"],
                    "achieved_bytes_per_s": round(achieved, 1)
                    if achieved is not None else None,
                    "roofline_fraction": round(achieved / roof, 6)
                    if achieved is not None else None,
                    "baseline_s": round(r["baseline"], 6)
                    if r["baseline"] is not None else None,
                    "regressed": r["regressed"],
                    "episodes": r["episodes"],
                    "last_shape_key": r["last_key"],
                    "seconds_histogram": {
                        ("+Inf" if i == len(_KHIST_EDGES)
                         else repr(_KHIST_EDGES[i])): n
                        for i, n in enumerate(r["hist"]) if n},
                })
        rows.sort(key=lambda r: -r["launches"])
        return rows


KERNEL_TIMER = KernelTimer()


def _note_query_program(program: str, dt: float) -> None:
    """Attribute a sampled launch's seconds to the query running on this
    thread (``QueryStats.device_programs``)."""
    from filodb_tpu_torch.query.exec import active_exec_ctx
    ctx = active_exec_ctx()
    if ctx is not None:
        ctx.note_device_program(program, dt)


def _first_tensor(obj, depth: int = 4):
    """The first tensor inside nested tuples, lists and dicts: the one a
    sampled launch's device is read from."""
    if isinstance(obj, torch.Tensor):
        return obj
    if depth == 0:
        return None
    if isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (tuple, list)):
        return None
    for x in obj:
        t = _first_tensor(x, depth - 1)
        if t is not None:
            return t
    return None


def _sampled_key(args: tuple, kwargs: dict) -> str:
    """Cheap shape key of a sampled launch: top-level shapes and small
    scalars."""
    parts = []
    for x in list(args) + list(kwargs.values()):
        shape = getattr(x, "shape", None)
        if shape is not None:
            parts.append(str(tuple(shape)))
        elif isinstance(x, (int, float, str, np.integer, np.floating)):
            parts.append(str(x)[:16])
        else:
            parts.append(type(x).__name__)
    return ";".join(parts[:32])


def timed(fn=None, *, program: Optional[str] = None):
    """Put a program on the kernel ledger: every call ticks
    :data:`KERNEL_TIMER`, and a sampled call is timed
    (:meth:`KernelTimer.timed_call`).  The wrapper carries the ledger's
    key as ``_program``, so that code crediting bytes to a program reads
    the name off the callable."""
    if fn is None:
        return functools.partial(timed, program=program)
    name = program or fn.__name__

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if not _ENABLED or not KERNEL_TIMER.tick(name):
            return fn(*a, **kw)
        return KERNEL_TIMER.timed_call(name, fn, a, kw)

    wrapper._program = name
    return wrapper


def kernel_summary() -> dict:
    """The kernel ledger: one row a program (launches, sampled seconds,
    EWMA, achieved bytes/s against the roof, sentry state)."""
    return {
        "enabled": _ENABLED,
        "sample_1_in": KERNEL_TIMER.sample_1_in,
        "hbm_roof_bytes_per_s": KERNEL_TIMER.hbm_roof_bytes_per_s,
        "regression": {
            "factor": KERNEL_TIMER.regression_factor,
            "window_s": KERNEL_TIMER.regression_window_s,
            "baseline_min_samples": KERNEL_TIMER.baseline_min_samples,
        },
        "programs": KERNEL_TIMER.table(),
    }


_CRASH_HOOKS_INSTALLED = False


def install_crash_hooks() -> None:
    """Dump the flight recorder on an unhandled exception (main thread
    and worker threads) before the previous hook runs."""
    global _CRASH_HOOKS_INSTALLED
    if _CRASH_HOOKS_INSTALLED:
        return
    _CRASH_HOOKS_INSTALLED = True
    import sys

    prev_sys = sys.excepthook

    def _sys_hook(exc_type, exc, tb):
        FLIGHT.dump_to_log(f"unhandled {exc_type.__name__}")
        prev_sys(exc_type, exc, tb)

    sys.excepthook = _sys_hook
    prev_thread = threading.excepthook

    def _thread_hook(args):
        FLIGHT.dump_to_log(
            f"unhandled {args.exc_type.__name__} in thread "
            f"{getattr(args.thread, 'name', '?')}")
        prev_thread(args)

    threading.excepthook = _thread_hook


def configure(conf: Optional[dict] = None) -> None:
    """Apply a ``"devicewatch"`` config block: ``{"enabled": bool,
    "flight-recorder-size": int, "kernel-sample-1-in": int (0 disables
    sampling), "hbm-roof-bytes-per-s": float,
    "kernel-regression-factor": float, "kernel-regression-window-s":
    float, "kernel-baseline-min-samples": int}``."""
    conf = conf or {}
    if "enabled" in conf:
        from filodb_tpu_torch.core.storeconfig import parse_bool
        set_enabled(parse_bool(conf["enabled"]))
    if "flight-recorder-size" in conf:
        FLIGHT.resize(int(conf["flight-recorder-size"]))
    KERNEL_TIMER.configure(
        sample_1_in=conf.get("kernel-sample-1-in"),
        hbm_roof_bytes_per_s=conf.get("hbm-roof-bytes-per-s"),
        regression_factor=conf.get("kernel-regression-factor"),
        regression_window_s=conf.get("kernel-regression-window-s"),
        baseline_min_samples=conf.get("kernel-baseline-min-samples"))


def device_summary() -> dict:
    """The process-wide device-resource view: the ledger by owner, the
    pools, the ledger against each card's allocated bytes, the kernel
    ledger's settings and the flight recorder's size."""
    return {
        "enabled": _ENABLED,
        "ledger": {
            "owners": LEDGER.owners(),
            "total_bytes": LEDGER.total_bytes(),
            "pools": LEDGER.pools(),
        },
        "devices": LEDGER.reconcile(),
        "kernels": {"sample_1_in": KERNEL_TIMER.sample_1_in,
                    "hbm_roof_bytes_per_s":
                        KERNEL_TIMER.hbm_roof_bytes_per_s},
        "flight_recorder": {"capacity": FLIGHT.capacity},
    }
