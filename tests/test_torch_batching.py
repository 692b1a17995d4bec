"""Co-arrival batching in the port (``filodb_tpu_torch/batching``), held
against the JAX package's batching tier (``tests/test_batching.py``).

The batcher's gating, budget checks and breaker are exercised on the
port's ``QueryBatcher`` with a synthetic stacked launch: mixed deadlines,
a member expiring mid-batch, a group of expired members, a deadline too
short to wait, a cold key, a lone leader, concurrent twins, and the
breaker, on its own and end to end.  (The JAX package's
``test_pad_pow2`` has no counterpart: the port's batched launch takes
exactly the live members and pads nothing.)

The device store: groups of 2, 3 and 8 concurrent queries over the same
resident planes (``tests/torch_slice_data.py``'s stores, two blocks of
XOR-packed residents; here in phase mode, gappy ts mode in
``tests/test_torch_batching_ts.py``), per series and
under ``sum by``, for rate, increase, sum_over_time and max_over_time.
Each member is held (a) against its own solo answer in the port, bit for
bit, and (b) against the JAX package's batched program (``series_batch``
/ ``grouped_batch``, the vmap of its grid kernel over the members) on the
same rows, at ``tests/test_torch_grid.py``'s tolerances: rtol 1e-9 in
f64, selection and counts exact.  Groups form deterministically: the
test marks the key hot (as a recent group would), and M threads released
by one barrier fill a group of M (``tests/torch_batch_data.py``, which
this file shares with ``tests/test_torch_batching_ts.py``).
"""

import threading
import time

import numpy as np
import pytest
import torch

from filodb_tpu_torch.batching import (QueryBatcher, batching_broken,
                                       reset_batch_breaker)
from filodb_tpu_torch.batching.batcher import _Group, _Member
from filodb_tpu_torch.memstore import devicestore
from filodb_tpu_torch.ops import grid
from filodb_tpu_torch.query.model import QueryContext
from filodb_tpu_torch.utils.devicewatch import FLIGHT
from filodb_tpu_torch.utils.observability import batch_metrics
from tests.torch_batch_data import (FIRST, FUNCS, NSTEPS,  # noqa: F401
                                    check_groups, closed_breaker_and_stores,
                                    hot_key, opened, plan_of, together)
from tests.torch_slice_data import GIDS, K, N_GROUPS, STEP, WINDOW, fns

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the batcher alone
# ---------------------------------------------------------------------------


class _FakePermit:
    def __init__(self, released=False):
        self.released = released


def _stack_launch(row0s, steps0s):
    """A synthetic stacked launch: the member axis leading, each value
    encoding its (row0, steps0), so that a wrong fan-out shows."""
    return torch.tensor([[r * 1000 + s] for r, s in zip(row0s, steps0s)],
                        dtype=torch.float64)


def _qctx_with(deadline_in_ms=None, permit=None):
    qc = QueryContext()
    if deadline_in_ms is not None:
        qc.deadline_ms = int(time.time() * 1000) + deadline_in_ms
    if permit is not None:
        qc.admission_permit = permit
    return qc


def _fallbacks():
    return batch_metrics()["fallbacks"].total()


def test_mixed_deadline_group_stacks_all_live_members():
    bat = QueryBatcher(window_ms=50.0, max_batch=8, dataset="unit")
    g = _Group("k")
    g.members = [_Member(1, 10, _qctx_with(deadline_in_ms=60_000)),
                 _Member(2, 20, _qctx_with(deadline_in_ms=600_000)),
                 _Member(3, 30, _qctx_with())]       # no deadline at all
    bat._launch_group(g, _stack_launch)
    assert [float(r[0]) for r in g.results] == [1010.0, 2020.0, 3030.0]
    assert bat.snapshot()["realized_peak"] == 3


def test_mid_batch_expiry_drops_members_from_the_stack():
    bat = QueryBatcher(window_ms=50.0, max_batch=8, dataset="unit")
    fb0 = _fallbacks()
    stacked = []

    def launch(row0s, steps0s):
        stacked.append(list(row0s))
        return _stack_launch(row0s, steps0s)

    g = _Group("k")
    g.members = [
        _Member(1, 10, _qctx_with(deadline_in_ms=60_000)),
        # its permit released while the window was open
        _Member(2, 20, _qctx_with(permit=_FakePermit(released=True))),
        # its deadline died while the window was open
        _Member(3, 30, _qctx_with(deadline_in_ms=-5)),
        _Member(4, 40, _qctx_with(deadline_in_ms=60_000)),
    ]
    bat._launch_group(g, launch)
    assert g.results[1] is None and g.results[2] is None
    assert float(g.results[0][0]) == 1010.0
    assert float(g.results[3][0]) == 4040.0
    # exactly the live members are stacked: no padding
    assert stacked == [[1, 4]]
    assert _fallbacks() == fb0 + 2


def test_group_of_expired_members_demotes_without_launching():
    bat = QueryBatcher(window_ms=50.0, max_batch=8, dataset="unit")
    launched = []
    g = _Group("k")
    g.members = [_Member(1, 10, _qctx_with(deadline_in_ms=-5)),
                 _Member(2, 20, _qctx_with(deadline_in_ms=-5))]
    bat._launch_group(g, lambda r, s: launched.append(1))
    assert g.results is None and not launched
    g.members = [_Member(1, 10, _qctx_with(deadline_in_ms=-5)),
                 _Member(2, 20, _qctx_with(deadline_in_ms=60_000))]
    bat._launch_group(g, lambda r, s: launched.append(1))
    assert g.results is None and not launched, \
        "fewer than two live members: the group demotes"


def test_short_deadline_joins_no_batch():
    bat = QueryBatcher(window_ms=100.0, max_batch=8, dataset="unit")
    fb0 = _fallbacks()
    got = bat.dispatch("k", 1, 10, _qctx_with(deadline_in_ms=40),
                       _stack_launch, lambda: "solo")
    assert got is None, "the caller runs its own solo program"
    assert _fallbacks() == fb0 + 1
    assert batch_metrics()["fallbacks"].value(dataset="unit",
                                              reason="deadline") >= 1


def test_cold_key_is_passthrough_solo():
    bat = QueryBatcher(window_ms=200.0, max_batch=8, dataset="unit")
    t0 = time.monotonic()
    assert bat.dispatch("k", 1, 10, None, _stack_launch,
                        lambda: "solo") == "solo"
    assert time.monotonic() - t0 < 0.15, \
        "a cold key must not wait out the co-arrival window"
    assert not bat._groups and not bat._inflight


def test_solo_window_leader_falls_back():
    bat = QueryBatcher(window_ms=30.0, max_batch=8, dataset="unit")
    fb0 = _fallbacks()
    bat._hot["k"] = time.monotonic() + 100.0     # the key leads
    assert bat.dispatch("k", 1, 10, None, _stack_launch,
                        lambda: "solo") is None
    assert _fallbacks() == fb0 + 1


def _twins(bat, launch):
    outs: dict = {}
    barrier = threading.Barrier(2)

    def worker(i):
        barrier.wait()
        outs[i] = bat.dispatch("k", i + 1, (i + 1) * 10, None, launch,
                               lambda: "solo")

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return outs


def test_concurrent_twins_form_a_group():
    bat = QueryBatcher(window_ms=400.0, max_batch=2, dataset="unit")
    bat._hot["k"] = time.monotonic() + 100.0
    g0 = batch_metrics()["groups"].value(dataset="unit")
    outs = _twins(bat, _stack_launch)
    assert sorted(float(v[0]) for v in outs.values()) == [1010.0, 2020.0]
    assert bat.snapshot()["realized_peak"] == 2
    assert batch_metrics()["groups"].value(dataset="unit") == g0 + 1


def test_stress_every_dispatch_gets_its_own_answer():
    """More threads than cores over three keys, a short switch interval:
    every dispatch returns its own member's answer (batched or solo) or
    None (run solo), and nothing is left open, in flight or waiting."""
    import os
    import sys
    bat = QueryBatcher(window_ms=2.0, max_batch=4, dataset="stress")
    nthreads = 4 * (os.cpu_count() or 2) + 3
    outs: dict = {}
    barrier = threading.Barrier(nthreads)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(i):
        barrier.wait()
        for j in range(20):
            r0, s0 = i, j
            got = bat.dispatch(f"k{(i + j) % 3}", r0, s0, None,
                               _stack_launch, lambda r0=r0, s0=s0: (r0, s0))
            outs[(i, j)] = got

    ts = [threading.Thread(target=worker, args=(i,), daemon=True)
          for i in range(nthreads)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in ts)
    assert len(outs) == nthreads * 20
    for (i, j), got in outs.items():
        if got is None:
            continue
        if isinstance(got, tuple):
            assert got == (i, j)
        else:
            assert float(got[0]) == i * 1000 + j
    assert not bat._groups and not bat._inflight
    members = batch_metrics()["members"].value(dataset="stress")
    batched = sum(1 for v in outs.values() if isinstance(v, torch.Tensor))
    assert members == batched


def test_disabled_batcher_passes_through():
    bat = QueryBatcher(enabled=False, window_ms=400.0, dataset="unit")
    assert bat.dispatch("k", 1, 10, None, _stack_launch,
                        lambda: "solo") is None
    assert not bat._groups and not bat._hot and not bat._inflight


def test_breaker_trip_demotes_group_and_opens_breaker():
    bat = QueryBatcher(window_ms=400.0, max_batch=2, dataset="unit")
    bat._hot["k"] = time.monotonic() + 100.0
    fb0 = _fallbacks()
    trips0 = len(FLIGHT.events(kind="breaker.trip"))

    def boom(row0s, steps0s):
        raise RuntimeError("batched launch failed")

    outs = _twins(bat, boom)
    # the whole group demoted: each member's caller runs its solo
    assert list(outs.values()) == [None, None]
    assert batching_broken()
    assert bat.snapshot()["breaker_open"]
    assert _fallbacks() >= fb0 + 2
    assert batch_metrics()["fallbacks"].value(dataset="unit",
                                              reason="error") >= 2
    assert len(FLIGHT.events(kind="breaker.trip")) == trips0 + 1
    # while open, every dispatch falls back at once
    assert bat.dispatch("k", 9, 90, None, _stack_launch,
                        lambda: "solo") is None
    reset_batch_breaker()
    assert not batching_broken()
    assert bat.dispatch("k2", 1, 10, None, _stack_launch,
                        lambda: "solo") == "solo"


# ---------------------------------------------------------------------------
# the device store (phase mode; gappy ts mode in test_torch_batching_ts.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FUNCS)
@pytest.mark.parametrize("shape", ["series", "grouped"])
def test_store_groups_match_solo_and_jax(shape, name):
    check_groups("uniform", shape, name)


def test_breaker_trip_end_to_end_serves_solo(monkeypatch):
    """A failing batched program demotes its group to the per-query
    chain: every member's answer is the bytes of an unbatched serve."""
    _jshard, tshard, _jids, tids = opened("uniform")
    starts = [FIRST + i * STEP for i in range(4)]

    def boom(*a, **kw):
        raise RuntimeError("batched program failure injected")

    monkeypatch.setattr(devicestore, "series_batch_program", boom)
    tshard.query_batcher = None
    solos = [tshard.scan_grid(tids, fns("RATE")[1], s0, NSTEPS, STEP,
                              WINDOW) for s0 in starts]
    bat = QueryBatcher(window_ms=30_000.0, max_batch=4, dataset="prom")
    tshard.query_batcher = bat
    hot_key(bat, lambda: tshard.scan_grid(tids, fns("RATE")[1], starts[0],
                                           NSTEPS, STEP, WINDOW))
    members = together(lambda s0: tshard.scan_grid(
        tids, fns("RATE")[1], s0, NSTEPS, STEP, WINDOW), starts)
    tshard.query_batcher = None
    assert batching_broken()
    for solo, got in zip(solos, members):
        assert got[1].numpy().tobytes() == solo[1].numpy().tobytes()


def test_packed_plans_never_batch(monkeypatch):
    """A one-block span of an f32 packed resident runs the packed program
    (per series and grouped): the batcher is not asked; the two-block
    span of the same store is."""
    monkeypatch.setattr(devicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)
    _jshard, tshard, _jids, tids = opened("uniform")
    bat = QueryBatcher(window_ms=30_000.0, dataset="prom")
    asked = []
    bat.dispatch = lambda *a: asked.append(a)
    tshard.query_batcher = bat
    rate = fns("RATE")[1]
    got = tshard.scan_grid(tids, rate, FIRST, 60, STEP, WINDOW)
    got_g = tshard.scan_grid_grouped(tids, rate, FIRST, 60, STEP, WINDOW,
                                     GIDS, N_GROUPS, "sum")
    assert plan_of(tshard, FIRST, 60).packed is not None
    assert got is not None and got_g is not None and not asked
    tshard.scan_grid(tids, rate, FIRST, NSTEPS, STEP, WINDOW)
    tshard.query_batcher = None
    assert len(asked) == 1


# ---------------------------------------------------------------------------
# the wrapper's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["phase", "ts", "free"])
def test_rate_grid_batch_ref_is_members_of_rate_grid_ref(mode):
    rng = np.random.default_rng(5)
    rows, ns, nrows = 64, 40, 30
    g = STEP
    phase = rng.integers(1, g, ns).astype(np.int32)
    ts = ((np.arange(rows)[:, None] - 1) * g + phase[None, :]).astype(
        np.int32)
    vals = np.cumsum(rng.random((rows, ns)), axis=0)
    op = {"phase": "rate", "ts": "rate", "free": "sum"}[mode]
    q = grid.GridQuery(nsteps=nrows - K + 1, kbuckets=K, gstep_ms=g,
                       is_rate=op == "rate", op=op, dense=True, stride=1)
    row0s, steps0s = [0, 3, 17, 34], [(r + K) * g for r in (0, 3, 17, 34)]
    tt, vt = torch.as_tensor(ts), torch.as_tensor(vals)
    ph = torch.as_tensor(phase) if mode == "phase" else None
    got = grid.rate_grid_batch(tt if mode == "ts" else None, vt, row0s,
                               steps0s, q, nrows, phase=ph)
    assert got.shape == (4, q.nsteps, ns)
    for m, (r, s) in enumerate(zip(row0s, steps0s)):
        want = grid.rate_grid_ref(tt[r:r + nrows] if mode == "ts" else None,
                                  vt[r:r + nrows], s, q, phase=ph)
        assert got[m].numpy().tobytes() == want.numpy().tobytes()
    with pytest.raises(ValueError):
        grid.rate_grid_batch(None, vt, [35], [0], q, nrows, phase=ph)
    with pytest.raises(ValueError):
        grid.rate_grid_batch(None, vt, [0, 1], [0], q, nrows, phase=ph)
