"""Co-arrival batching at the device-dispatch boundary.

Concurrent shape-compatible queries (the dashboard panels of a fleet
refreshing against the same hot dataset, with staggered starts) meet at
the grid cache's dispatch and run as ONE launch of the grid kernel over
the shared resident planes, the member on the launch's second grid axis,
instead of one launch a query whose plans differ only in their start.

:class:`QueryBatcher` is the rendezvous: the grid cache offers every
eligible dispatch (a batch key, the member's ``(row0, steps0)`` and a
batched launch); the batcher groups co-arrivals inside a short bounded
window, a leader launches the stacked program, and every member gets its
own slice of the stacked output.  Any failure demotes the whole group to
its members' solo launches (a process breaker and
``filodb_batch_fallbacks_total{reason=}``).
"""

from .batcher import QueryBatcher, batching_broken, reset_batch_breaker

__all__ = ["QueryBatcher", "batching_broken", "reset_batch_breaker"]
