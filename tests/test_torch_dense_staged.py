"""The staged B2 kernel's launch plan, routing and shapes, on the CPU.

* ``dense_staged_plan``, the plan the wrapper hands the staged
  ``rate_grid_grouped`` kernel (csrc/dense_staged.cu: tile, ring bytes,
  the linear layout, shared bytes a CTA): the north-star plan, the tile
  following the group, the direct kernel where no ring holds the step,
  the linear layout where a pass's rows fit a ring's four stages, and
  every staged plan for K 1-1,024 and T 1-4,096 within a CTA's 227 KB.
* The launcher's routing on a stand-in library: the staged entry at a
  staged plan with the plan's arguments, the direct entry (counted in
  ``rate_grid_grouped.direct``) where no ring holds the step, and a
  failed launch raising.
* ``rate_grid_grouped`` at group widths the staged kernel walks in one
  pass of either tile (64 and 256 lanes) and in four passes (1,024
  lanes), in phase and ts mode: the same numpy inputs go through
  ``filodb_tpu.ops.grid``'s Pallas kernel in interpret mode and through
  ``filodb_tpu_torch.ops.grid``'s wrapper on CPU tensors (the plain
  PyTorch version the CUDA kernels are held to on the card).  Tolerances
  as in tests/test_torch_grouped.py: sums rtol 2e-5, counts and NaN
  positions equal.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.ops import grid as tgrid

torch.set_num_threads(1)

STEP = 60_000
T0 = 600_000
CTA_BYTES = 232_448         # shared memory a CTA may use (227 KB)
MBARRIERS = 64              # the kernel's static RingBars
GROUPS = 8                  # the Pallas kernel's groups, at least
ROWS = 24
K = 5


def _grid_data(group_lanes: int, dense: bool, seed: int):
    """[ROWS, GROUPS * group_lanes] planes on the grid layout (a scrape
    phase a lane, counter resets); gappy data has NaN holes; the last
    group is all-NaN padding."""
    rng = np.random.default_rng(seed)
    S = GROUPS * group_lanes
    phase = rng.integers(1, STEP, S).astype(np.int64)
    ts = (np.arange(ROWS, dtype=np.int64) * STEP + T0)[:, None] + phase
    vals = np.cumsum(rng.random((ROWS, S)) * 10.0, axis=0)
    for s in np.flatnonzero(rng.random(S) < 0.05):
        c = int(rng.integers(1, ROWS))
        vals[c:, s] -= vals[c, s] * 0.9
    if not dense:
        vals[rng.random((ROWS, S)) < 0.15] = np.nan
    vals[:, -group_lanes:] = np.nan
    return ts.astype(np.int32), vals.astype(np.float32), phase.astype(
        np.int32)


@pytest.mark.parametrize("mode,dense,op", [
    ("phase", True, "rate"), ("ts", True, "increase"), ("ts", False, "rate"),
    ("ts", True, "deriv")])
@pytest.mark.parametrize("group_lanes", [64, 256, 1024])
def test_staged_widths_match_pallas_interpret(group_lanes, mode, dense, op):
    """One pass of the 128-lane tile (64 lanes), one of the 256-lane tile
    (256), four of it (1,024), in phase and ts mode."""
    ts, vals, phase = _grid_data(group_lanes, dense, seed=group_lanes)
    jq = jgrid.GridQuery(nsteps=ROWS - K + 1, kbuckets=K, gstep_ms=STEP,
                         is_rate=op == "rate", op=op, dense=dense)
    ph = phase if mode == "phase" else None
    steps0 = T0 + K * STEP
    ws, wc = jgrid.rate_grid_grouped(
        jnp.asarray(ts), jnp.asarray(vals), jnp.int32(steps0), jq,
        group_lanes=group_lanes, interpret=True,
        phase=None if ph is None else jnp.asarray(ph))
    gs, gc = tgrid.rate_grid_grouped(
        torch.as_tensor(ts), torch.as_tensor(vals), steps0,
        tgrid.GridQuery(*jq), group_lanes,
        phase=None if ph is None else torch.as_tensor(ph))
    gs, gc = gs.numpy(), gc.numpy()
    ws, wc = np.asarray(ws), np.asarray(wc)
    assert gs.shape == gc.shape == ws.shape == (GROUPS, jq.nsteps)
    np.testing.assert_array_equal(gc, wc)
    assert (np.isnan(gs) == np.isnan(ws)).all()
    fin = np.isfinite(ws)
    if op == "deriv":
        # slopes cross 0: each group's sum within 2e-5 of its largest
        scale = np.abs(np.where(fin, ws, 0)).max(axis=1, keepdims=True)
        assert (np.abs(gs - ws)[fin] <= 2e-5 * np.broadcast_to(
            scale, ws.shape)[fin]).all()
    else:
        np.testing.assert_allclose(gs[fin], ws[fin], rtol=2e-5)
    # the padded group: nothing counted, nothing summed
    assert not gc[-1].any() and not gs[-1].any()
    assert gc[0].min() > 0


@pytest.mark.parametrize("group_lanes", [40, 1024])
def test_cpu_wrapper_runs_the_plain_version(group_lanes):
    """On CPU tensors the wrapper returns the plain version's bits, at a
    group of either lane tile, and nothing counts as a launch."""
    ts, vals, phase = (torch.as_tensor(a)
                       for a in _grid_data(group_lanes, True, seed=5))
    q = tgrid.GridQuery(nsteps=9, kbuckets=K, gstep_ms=STEP, dense=True,
                        stride=2)
    tgrid.reset_launch_counts()
    want = tgrid.rate_grid_grouped_ref(ts, vals, 0, q, group_lanes,
                                       phase=phase)
    got = tgrid.rate_grid_grouped(ts, vals, 0, q, group_lanes, phase=phase)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert tgrid.rate_grid_grouped.launches == 0
    assert tgrid.rate_grid_grouped.direct == 0


def test_reset_launch_counts_resets_the_direct_count():
    tgrid.rate_grid_grouped.direct = 4
    tgrid.reset_launch_counts()
    assert tgrid.rate_grid_grouped.direct == 0


class _Library:
    """A stand-in for the kernel library: records each entry's call and
    returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture
def library(monkeypatch):
    """The launcher on CPU tensors against a stand-in library."""
    lib = _Library()
    monkeypatch.setattr(tgrid.kernels, "library", lambda: lib)
    monkeypatch.setattr(tgrid, "_stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    tgrid.reset_launch_counts()
    yield lib
    tgrid.reset_launch_counts()


def _ints(args) -> list:
    return [a.value for a in args if isinstance(a, ctypes.c_int)]


@pytest.mark.parametrize("mode", ["phase", "ts"])
@pytest.mark.parametrize("kbuckets,nsteps,staged", [(5, 30, True),
                                                    (120, 6, False)])
def test_launcher_takes_the_plan(library, kbuckets, nsteps, staged, mode):
    """The staged entry at a staged plan (a ts-mode launch's plan, with
    its second ring, in ts mode), with the plan's tile, ring bytes and
    layout after rate_grid_grouped_launch's arguments; the direct entry,
    counted in ``.direct``, where no ring holds the step.  One launch
    either way."""
    ts, vals, phase = (torch.as_tensor(a)
                       for a in _grid_data(1024, True, seed=6))
    ts, vals = torch.cat([ts] * 6), torch.cat([vals] * 6)   # K = 120
    q = tgrid.GridQuery(nsteps=nsteps, kbuckets=kbuckets, gstep_ms=STEP,
                        dense=True, is_rate=True)
    if mode == "phase":
        s, c = tgrid._grouped_dense_launch(None, vals, 0, q, 1024, phase)
    else:
        s, c = tgrid._grouped_dense_launch(ts, vals, 0, q, 1024, None)
    assert s.shape == c.shape == (GROUPS, nsteps)
    (name, args), = library.calls
    base = [vals.shape[0], vals.shape[1], 1024, nsteps, kbuckets, 1, STEP,
            0, 6, {"phase": 1, "ts": 2}[mode], 1, 1]    # op rate
    plan = tgrid.dense_staged_plan(1024, nsteps, kbuckets, 1, mode == "ts")
    assert plan.staged is staged
    if staged:
        # 34 rows: linear in the 64 KB ring, or two 16 KB rings that wrap
        assert (plan.ring_bytes, plan.linear) == (
            (64 * 1024, True) if mode == "phase" else (16 * 1024, False))
        assert name == "dense_staged_launch"
        assert _ints(args)[:15] == base + [plan.tile, plan.ring_bytes,
                                           int(plan.linear)]
    else:
        assert name == "rate_grid_grouped_launch"
        assert _ints(args)[:12] == base
    assert tgrid.rate_grid_grouped.launches == 1
    assert tgrid.rate_grid_grouped.direct == int(not staged)


def test_a_failed_launch_raises(library):
    library.rc = 1
    _ts, vals, phase = (torch.as_tensor(a)
                        for a in _grid_data(64, True, seed=7))
    q = tgrid.GridQuery(nsteps=6, kbuckets=K, gstep_ms=STEP, dense=True)
    with pytest.raises(RuntimeError, match="rate_grid_grouped kernel"):
        tgrid._grouped_dense_launch(None, vals, 0, q, 64, phase)


def test_plan_at_the_north_star():
    """bench.py's dense query: groups of 1,024 lanes, 59 rows of f32
    (T = 55, K = 5): the 256-lane tile in four passes; the 16 KB ring
    holds a step but a pass's 59 rows of 1 KB only in the 64 KB one's
    four stages of 16, which the linear layout takes; eight warps' rows
    of 55 partial sums and counts (3,520 bytes)."""
    plan = tgrid.dense_staged_plan(1024, 55, 5, 1)
    assert plan == tgrid.GroupPlan(256, 64 * 1024, True, 64 * 1024 + 3520)
    assert plan == tgrid.grouped_staged_plan(1024, 55, 5, 1, 0, 4)
    assert tgrid.CTA_SHARED_BYTES + MBARRIERS == CTA_BYTES


@pytest.mark.parametrize("nsteps,linear", [(55, False), (12, True)])
def test_plan_of_a_launch_that_reads_ts(nsteps, linear):
    """A launch that reads timestamps stages them in a second ring of the
    same bytes: the least ring that holds a step (16 KB at 1,024-lane
    groups, K = 5), linear only where it holds a pass (T + 4 <= 16 rows),
    and both rings in the shared bytes."""
    plan = tgrid.dense_staged_plan(1024, nsteps, 5, 1, reads_ts=True)
    assert plan == tgrid.GroupPlan(256, 16 * 1024, linear,
                                   2 * 16 * 1024 + 64 * nsteps)


@pytest.mark.parametrize("group_lanes,tile", [
    (1, 128), (38, 128), (64, 128), (128, 128), (129, 256), (224, 256),
    (512, 256), (1024, 256), (4096, 256)])
def test_tile_follows_the_group(group_lanes, tile):
    """The small tile for a group of at most 128 lanes (one pass), else
    the large one: B4's and B5's rule."""
    assert tgrid.dense_staged_plan(group_lanes, 10, 5, 1).tile == tile


@pytest.mark.parametrize("tile,kbuckets,staged", [
    (256, 46, True), (256, 47, False), (128, 94, True), (128, 95, False),
    (256, 120, False), (128, 1024, False)])
def test_direct_where_no_ring_holds_the_step(tile, kbuckets, staged):
    """A step of stride + K rows beyond three stages of the 64 KB ring
    (16 rows of 256 lanes, 32 of 128) takes the direct kernel (the K-free
    dense ops reach K = 1,024), whatever the pass's rows."""
    lanes = {128: 128, 256: 1024}[tile]
    for nsteps in (1, 3, 500):
        plan = tgrid.dense_staged_plan(lanes, nsteps, kbuckets, 2)
        assert plan.staged is staged
        if not staged:
            assert plan.ring_bytes == plan.shared == 0


@pytest.mark.parametrize("nsteps,linear,ring", [
    (12, True, 16 * 1024), (13, True, 32 * 1024), (28, True, 32 * 1024),
    (29, True, 64 * 1024), (60, True, 64 * 1024), (61, False, 16 * 1024),
    (500, False, 16 * 1024)])
def test_linear_where_a_pass_fits_four_stages(nsteps, linear, ring):
    """A 1,024-lane group, K = 5: a pass's T + 4 rows take the least ring
    whose four stages (4, 8, 16 rows of 256 lanes) hold them, read
    without wrapping; past 64 rows the least ring that holds a step, a
    pass wrapping it."""
    plan = tgrid.dense_staged_plan(1024, nsteps, 5, 1)
    assert (plan.linear, plan.ring_bytes) == (linear, ring)


@pytest.mark.parametrize("reads_ts", [False, True])
def test_every_staged_plan_fits_a_cta(reads_ts):
    """Over K 1-1,024, T 1-4,096, strides 1-3 and both tiles: a staged
    plan's ring holds a step in three stages (a pass's rows in four where
    it is linear), and its ring (two where the launch reads timestamps)
    and partial rows fit a CTA's shared memory; a plan is direct only
    where no ring holds the step or the partials and least ring(s) pass
    a CTA."""
    rings = 2 if reads_ts else 1
    ks = sorted({1, 2, 5, 8, 31, 32, 46, 47, 64, 94, 95, 120, 1024})
    ts = sorted({1, 2, 55, 100, 767, 768, 769, 804, 1000, 2000, 3000, 3500,
                 3600, 4096})
    for lanes in (64, 1024):
        for k in ks:
            for t in ts:
                for stride in (1, 2, 3):
                    plan = tgrid.dense_staged_plan(lanes, t, k, stride,
                                                   reads_ts)
                    tile = plan.tile
                    part = 8 * (tile // 32) * t
                    least = tgrid.least_ring(stride, k, 4, tile)
                    if not plan.staged:
                        assert not least or rings * least + part \
                            > tgrid.CTA_SHARED_BYTES
                        continue
                    stage = tgrid.ring_stage_rows(plan.ring_bytes, 4, tile)
                    assert stride + k <= 3 * stage
                    assert plan.shared == rings * plan.ring_bytes + part \
                        <= tgrid.CTA_SHARED_BYTES
                    if plan.linear:
                        assert (t - 1) * stride + k <= 4 * stage
