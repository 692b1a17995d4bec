"""End-to-end query deadlines: one wall-clock budget, decremented per hop.

The reference's query timeout (QueryContext.submitTime +
queryTimeoutMillis, checked in QueryActor's mailbox and again inside
ExecPlan execution) as an absolute deadline: the entry point mints
``QueryContext.deadline_ms`` (epoch millis) from the query's timeout once;
every layer that waits or ships work derives its own timeout from the
REMAINING budget instead of a fixed constant, and refuses work that can
no longer finish in time (``ExecPlan.execute`` checks it at every plan
node; the query batcher before a query waits in a co-arrival window).

Every helper degrades to "no deadline" (``None``) when the context never
minted one (``deadline_ms == 0``), so library callers keep their
unbounded behaviour.
"""

from __future__ import annotations

import time
from typing import Optional

from filodb_tpu_torch.query.model import QueryContext, QueryError

# a remote hop that has less budget than this cannot plausibly finish:
# the data node refuses it outright instead of starting dead work
MIN_REMOTE_BUDGET_MS = 5


class DeadlineExceeded(QueryError):
    """The query's end-to-end budget ran out before the work finished
    (or could even start)."""


def _now_ms() -> int:
    return int(time.time() * 1000)


def mint(qctx: QueryContext, now_ms: Optional[int] = None) -> QueryContext:
    """Stamp an absolute deadline onto a context that lacks one:
    ``submit_time_ms + timeout_ms``, the submit time defaulting to now.
    Called once where a query enters; everything downstream only reads
    it."""
    if not qctx.deadline_ms:
        base = qctx.submit_time_ms or (now_ms if now_ms is not None
                                       else _now_ms())
        qctx.deadline_ms = base + qctx.timeout_ms
    return qctx


def remaining_ms(qctx: QueryContext,
                 now_ms: Optional[int] = None) -> Optional[int]:
    """Milliseconds of budget left; ``None`` when no deadline was
    minted; negative once it has expired."""
    if not qctx.deadline_ms:
        return None
    return qctx.deadline_ms - (now_ms if now_ms is not None else _now_ms())


def expired(qctx: QueryContext, now_ms: Optional[int] = None) -> bool:
    rem = remaining_ms(qctx, now_ms)
    return rem is not None and rem <= 0


def check(qctx: QueryContext, where: str = "") -> None:
    """Raise :class:`DeadlineExceeded` when the budget ran out: the
    cheap per-hop tripwire (one clock read)."""
    rem = remaining_ms(qctx)
    if rem is not None and rem <= 0:
        raise DeadlineExceeded(
            qctx.query_id,
            f"query deadline exceeded ({-rem}ms past its "
            f"{qctx.timeout_ms}ms budget{f' at {where}' if where else ''})")


def budget_timeout_s(qctx: QueryContext, cap_s: float) -> float:
    """A wait or I/O timeout capped by the remaining budget: ``cap_s``
    when no deadline exists, else ``min(cap_s, remaining)`` floored at a
    millisecond, so that an expired budget fails fast instead of waiting
    forever (a timeout of 0 means none to urllib)."""
    rem = remaining_ms(qctx)
    if rem is None:
        return cap_s
    return min(cap_s, max(rem / 1000.0, 0.001))
