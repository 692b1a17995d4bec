"""The staged B4 kernel's launch plan and shapes, on the CPU.

* ``grouped_staged_plan``, the plan the wrapper hands the staged
  ``rate_grid_grouped_packed`` kernel (tile, ring bytes, the linear
  layout, shared bytes a CTA): the north-star plan, the tile following
  the group, the direct kernel where no ring holds the step, the linear
  layout where a pass's rows fit a ring's four stages, and every staged
  plan for K 1-1,024 and T 1-4,096 within a CTA's 227 KB.
* ``rate_grid_grouped_packed`` at group widths the staged kernel walks in
  one pass of either tile (64 and 256 lanes) and in four passes (1,024
  lanes): the same numpy pack goes through ``filodb_tpu.ops.grid``'s
  Pallas kernel in interpret mode and through ``filodb_tpu_torch.ops.
  grid``'s wrapper on CPU tensors (the plain PyTorch version the CUDA
  kernels are held to on the card).  Tolerances as in
  tests/test_torch_grouped_packed.py: sums rtol 2e-5, counts and NaN
  positions equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.codecs import xorgrid as jxorgrid
from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.codecs import xorgrid as txorgrid
from filodb_tpu_torch.ops import grid as tgrid

torch.set_num_threads(1)

STEP = 60_000
CTA_BYTES = 232_448         # shared memory a CTA may use (227 KB)
MBARRIERS = 64              # the kernel's static RingBars
WORDS = (1, 2, 4)
GROUPS = 8                  # the Pallas kernel's groups a plane, at least
ROWS = 64                   # a 16-bit pack pays (saves 25%) from ~60 rows


def _p16_pack(rng, rows, width):
    """A single-class p16 identity pack of integer counters with a
    pinned f32 exponent, one scrape phase a lane; lanes 1-5 dead."""
    start = 2 ** 23 + 128 * rng.integers(0, 2 ** 15, width)
    inc = 128 * rng.integers(1, 8, (rows, width))
    v = (start[None, :] + np.cumsum(inc, axis=0)).astype(np.float32)
    v[:, 1:6] = np.nan
    pk = jxorgrid.pack_vals(v, phase=rng.integers(1, STEP, width)
                            .astype(np.int32), min_width=16)
    assert pk is not None and (pk.inv == np.arange(width)).all()
    assert [k for k in ("p8", "p16", "raw")
            if k in pk.planes and pk.planes[k].shape[1]] == ["p16"]
    return pk


@pytest.mark.parametrize("use_phase,dense,op", [
    (True, True, "rate"), (False, True, "sum"), (False, False, "stddev")])
@pytest.mark.parametrize("group_lanes,row0,stride", [
    (64, 3, 2), (256, 0, 1), (1024, 11, 1)])
def test_staged_widths_match_pallas_interpret(group_lanes, row0, stride,
                                              use_phase, dense, op):
    """One pass of the 128-lane tile (64 lanes), one of the 256-lane tile
    (256), four of it (1,024)."""
    nsteps = 9
    pk = _p16_pack(np.random.default_rng(group_lanes + row0), ROWS,
                   GROUPS * group_lanes)
    q = jgrid.GridQuery(nsteps=nsteps, kbuckets=5, gstep_ms=STEP, op=op,
                        is_rate=op == "rate", dense=dense, stride=stride)
    ws, wc = jgrid.rate_grid_grouped_packed(
        {k: jnp.asarray(a) for k, a in pk.planes.items()}, 0, q,
        group_lanes=group_lanes, row0=row0, interpret=True,
        use_phase=use_phase)
    gs, gc = tgrid.rate_grid_grouped_packed(
        txorgrid.packed_to_torch(pk, "cpu"), 0, tgrid.GridQuery(*q),
        group_lanes, row0=row0, use_phase=use_phase)
    ws, wc = np.asarray(ws), np.asarray(wc)
    assert gs.shape == gc.shape == ws.shape == (GROUPS, nsteps)
    np.testing.assert_array_equal(gc.numpy(), wc)
    assert (np.isnan(gs.numpy()) == np.isnan(ws)).all()
    np.testing.assert_allclose(gs.numpy(), ws, rtol=2e-5)
    # group 0 holds the five dead lanes
    assert (gc[0] == group_lanes - 5).all() and (gc[1:] == group_lanes).all()


@pytest.mark.parametrize("group_lanes", [40, 1024])
def test_cpu_wrapper_runs_the_plain_version(group_lanes):
    """On CPU tensors the wrapper returns the plain version's bits, at a
    group of either lane tile (40 lanes: the small tile; 1,024: the large
    one, in four passes on the card), and nothing counts as a launch."""
    planes = txorgrid.packed_to_torch(
        _p16_pack(np.random.default_rng(5), ROWS, 2 * group_lanes), "cpu")
    q = tgrid.GridQuery(nsteps=9, kbuckets=5, gstep_ms=STEP, dense=True,
                        stride=2)
    tgrid.reset_launch_counts()
    want = tgrid.rate_grid_grouped_packed_ref(planes, 0, q, group_lanes, 3)
    got = tgrid.rate_grid_grouped_packed(planes, 0, q, group_lanes, 3)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert tgrid.rate_grid_grouped_packed.launches == 0
    assert tgrid.rate_grid_grouped_packed.direct == 0


def test_reset_launch_counts_resets_the_direct_count():
    tgrid.rate_grid_grouped_packed.direct = 3
    tgrid.hist_grid_grouped_packed.direct = 2
    tgrid.reset_launch_counts()
    assert tgrid.rate_grid_grouped_packed.direct == 0
    assert tgrid.hist_grid_grouped_packed.direct == 0


def test_plan_at_the_north_star():
    """bench.py's packed query: groups of 1,024 lanes of one p16 plane,
    59 rows (T = 55, K = 5): the 256-lane tile in four passes; the 16 KB
    ring holds a step but a pass's 59 rows only in the 32 KB one's four
    stages of 16, which the linear layout takes; eight warps' rows of 55
    partial sums and counts (3,520 bytes)."""
    plan = tgrid.grouped_staged_plan(1024, 55, 5, 1, 0, 2)
    assert plan == tgrid.GroupPlan(256, 32 * 1024, True, 32 * 1024 + 3520)
    assert plan.staged
    assert tgrid.CTA_SHARED_BYTES + MBARRIERS == CTA_BYTES


@pytest.mark.parametrize("group_lanes,tile", [
    (1, 128), (40, 128), (64, 128), (128, 128), (129, 256), (224, 256),
    (512, 256), (1024, 256), (4096, 256)])
def test_tile_follows_the_group(group_lanes, tile):
    """The small tile for a group of at most 128 lanes (one pass), else
    the large one: B5's rule."""
    assert tgrid.grouped_staged_plan(group_lanes, 10, 5, 1, 0, 2).tile \
        == tile
    assert tgrid.hist_staged_plan(2, 2 * group_lanes, 10, 5, 1, 2).tile \
        == tgrid.staged_tile(2 * group_lanes)


# a group of 128 lanes takes the small tile, one of 1,024 the large one
LANES = {128: 128, 256: 1024}


@pytest.mark.parametrize("word,tile,kbuckets,staged", [
    (2, 256, 120, False), (4, 256, 60, False), (4, 128, 60, True),
    (1, 128, 120, True), (1, 256, 1024, False), (1, 128, 1024, False),
    (2, 256, 94, True), (2, 256, 95, False), (4, 128, 94, True),
    (4, 128, 95, False)])
def test_direct_where_no_ring_holds_the_step(word, tile, kbuckets, staged):
    """A step of stride + K rows beyond three stages of the 64 KB ring
    takes the direct kernel (the K-free dense ops reach K = 1,024),
    whatever the pass's rows."""
    for nsteps in (1, 3, 500):
        plan = tgrid.grouped_staged_plan(LANES[tile], nsteps, kbuckets, 2,
                                         0, word)
        assert plan.staged is staged
        if not staged:
            assert plan == tgrid.GroupPlan(tile, 0, False, 0)


@pytest.mark.parametrize("tile", sorted(LANES))
@pytest.mark.parametrize("word", WORDS)
def test_every_staged_step_fits_three_stages(word, tile):
    """Every step of stride + K rows, K 1 to 1,024: a staged plan's ring
    holds the step in three of its four stages; where the pass's rows fit
    no ring's four stages, the ring is the least that holds the step (a
    pass wraps it), and B5's plan takes the same one."""
    for stride in (1, 2, 7):
        for k in range(1, 1025):
            for nsteps in (1, 55, 400):
                plan = tgrid.grouped_staged_plan(LANES[tile], nsteps, k,
                                                 stride, 0, word)
                assert plan.tile == tile
                span = stride + k
                fits = [b for b in tgrid.HIST_RING_BYTES
                        if span <= 3 * tgrid.ring_stage_rows(b, word, tile)]
                assert plan.staged == bool(fits)
                if not plan.staged:
                    continue
                assert plan.ring_bytes in fits
                rows = (nsteps - 1) * stride + k
                stage = tgrid.ring_stage_rows(plan.ring_bytes, word, tile)
                assert span <= 3 * stage
                assert plan.ring_bytes >= 4 * stage * tile * word
                if not plan.linear:
                    assert plan.ring_bytes == fits[0] \
                        == tgrid.hist_staged_plan(4, LANES[tile], nsteps, k,
                                                  stride, word).ring_bytes
                    assert all(rows > 4 * tgrid.ring_stage_rows(b, word, tile)
                               for b in fits)


@pytest.mark.parametrize("tile", sorted(LANES))
@pytest.mark.parametrize("word", WORDS)
def test_linear_where_a_pass_fits_four_stages(word, tile):
    """The linear layout takes the least ring that holds the step and
    whose four stages hold a pass's rows (row0 + (T - 1) * stride + K);
    a pass one row longer than the largest ring's four stages wraps."""
    for row0 in (0, 3, 40):
        for k in (1, 5, 32):
            for nsteps in range(1, 300, 7):
                plan = tgrid.grouped_staged_plan(LANES[tile], nsteps, k, 1,
                                                 row0, word)
                rows = row0 + nsteps - 1 + k
                holds = [b for b in tgrid.HIST_RING_BYTES
                         if 1 + k <= 3 * tgrid.ring_stage_rows(b, word, tile)
                         and rows <= 4 * tgrid.ring_stage_rows(b, word,
                                                               tile)]
                assert plan.linear == bool(holds)
                if holds:
                    assert plan.ring_bytes == holds[0]
    most = 4 * tgrid.ring_stage_rows(65536, word, tile)
    assert tgrid.grouped_staged_plan(LANES[tile], most - 5 + 1, 5, 1, 0,
                                     word).linear
    assert not tgrid.grouped_staged_plan(LANES[tile], most - 5 + 2, 5, 1, 0,
                                         word).linear


@pytest.mark.parametrize("tile", sorted(LANES))
@pytest.mark.parametrize("word", WORDS)
def test_every_plan_fits_a_cta(word, tile):
    """T 1-4,096 at the largest ring a staged step can take and the
    smallest: the ring and the consumer warps' partial rows (8 bytes a
    step a warp) fit in 227 KB beside the mbarriers, and a plan goes
    direct for its T only where they would not."""
    ts = sorted(set(range(1, 17)) | {55, 64, 127, 128, 129, 255, 256, 511,
                                     768, 769, 1024, 2047, 2048, 2600, 2607,
                                     2608, 3000, 4096})
    for k in (5, 3 * tgrid.ring_stage_rows(65536, word, tile) - 1):
        for t in ts:
            plan = tgrid.grouped_staged_plan(LANES[tile], t, k, 1, 0, word)
            ring = tgrid.least_ring(1, k, word, tile)
            part = 8 * (tile // 32) * t
            assert plan.tile == tile and ring
            if ring + part + MBARRIERS <= CTA_BYTES:
                assert plan.staged and plan.ring_bytes >= ring
                assert plan.shared == plan.ring_bytes + part
                assert plan.shared + MBARRIERS <= CTA_BYTES
            else:
                assert plan == tgrid.GroupPlan(tile, 0, False, 0)
    # the 64 KB ring with eight warps' rows holds T up to 2,607
    k = 3 * tgrid.ring_stage_rows(65536, word, 256) - 1
    assert tgrid.grouped_staged_plan(1024, 2607, k, 1, 0, word).staged
    assert not tgrid.grouped_staged_plan(1024, 2608, k, 1, 0, word).staged
