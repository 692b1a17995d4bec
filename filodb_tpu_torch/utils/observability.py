"""Observability: the counters and the tracing spans the query engine
reports into.

Capability match for the reference's Kamon-based instrumentation
(reference: coordinator/.../KamonLogger.scala:146 metric/span log
reporters; Kamon.spanBuilder in ExecPlan.execute ExecPlan.scala:99-126).
This package keeps the part its query path calls: named counters in a
process-wide registry (``downsample_metrics``) and a thread-local span
stack with pluggable reporters (:data:`TRACER`).  Everything is stdlib.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
import threading
import time
import traceback
from typing import Callable, Optional

# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = collections.defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += amount

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)


class MetricsRegistry:
    """Process-wide named counters (replaces Kamon's metric registry)."""

    def __init__(self) -> None:
        self._metrics: dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help_)
            return m


REGISTRY = MetricsRegistry()


def downsample_metrics() -> dict:
    """Visualization downsampling (``DownsampleMapper``, ops/grid.py
    m4_grid): the point-volume reduction."""
    return {
        "points_in": REGISTRY.counter(
            "filodb_downsample_points_in_total",
            "finite samples entering the downsampler"),
        "points_out": REGISTRY.counter(
            "filodb_downsample_points_out_total",
            "pixel-exact samples kept (<= 4 per pixel bin per series)"),
    }


# ---------------------------------------------------------------------------
# Tracing spans
# ---------------------------------------------------------------------------


def _new_id() -> str:
    """64-bit random hex span id."""
    return f"{random.getrandbits(64):016x}"


@dataclasses.dataclass
class SpanRecord:
    name: str
    start_s: float
    duration_s: float
    tags: dict
    span_id: str
    parent_id: Optional[str]
    error: Optional[str] = None


class Tracer:
    """Thread-local span stack + pluggable reporters (replaces Kamon span
    propagation via Kamon.runWithSpan).  ``capture()`` / ``attach()``
    move the current span across the thread pool that runs an ExecPlan's
    children, so child spans parent onto the plan's span."""

    def __init__(self) -> None:
        self._local = threading.local()
        self._reporters: list[Callable[[SpanRecord], None]] = []
        self._lock = threading.Lock()

    def add_reporter(self, fn: Callable[[SpanRecord], None]) -> None:
        with self._lock:
            self._reporters.append(fn)

    def remove_reporter(self, fn: Callable[[SpanRecord], None]) -> None:
        with self._lock:
            self._reporters = [r for r in self._reporters if r is not fn]

    def current_span_id(self) -> Optional[str]:
        stack = getattr(self._local, "stack", None)
        if stack:
            return stack[-1]
        return getattr(self._local, "parent_hint", None)

    def capture(self) -> Optional[str]:
        """The current span's id, a token for cross-thread propagation."""
        return self.current_span_id()

    @contextlib.contextmanager
    def attach(self, token: Optional[str]):
        """Install a captured span on this thread: spans opened inside
        parent onto it, on a fresh span stack."""
        old_hint = getattr(self._local, "parent_hint", None)
        old_stack = getattr(self._local, "stack", None)
        self._local.parent_hint = token
        self._local.stack = []
        try:
            yield
        finally:
            self._local.parent_hint = old_hint
            self._local.stack = old_stack

    def span(self, name: str, **tags):
        return _Span(self, name, tags)

    def _report(self, rec: SpanRecord) -> None:
        with self._lock:
            reporters = list(self._reporters)
        for fn in reporters:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — reporters must not break work
                traceback.print_exc()


class _Span:
    """One span.  With no reporter installed when it opens it does
    nothing: no id, no clock, no record."""

    def __init__(self, tracer: Tracer, name: str, tags: dict):
        self.tracer = tracer
        self.name = name
        self.tags = tags
        self.live = False

    def __enter__(self):
        self.live = bool(self.tracer._reporters)
        if not self.live:
            return self
        self.span_id = _new_id()
        self.parent_id = self.tracer.current_span_id()
        local = self.tracer._local
        if getattr(local, "stack", None) is None:
            local.stack = []
        local.stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self.live:
            return False
        dur = time.perf_counter() - self._t0
        try:  # spans must NEVER raise into the instrumented path
            self.tracer._local.stack.pop()
        except (AttributeError, IndexError):
            pass
        self.tracer._report(SpanRecord(
            self.name, time.time() - dur, dur, dict(self.tags),
            self.span_id, self.parent_id,
            error=repr(exc) if exc is not None else None))
        return False


TRACER = Tracer()
