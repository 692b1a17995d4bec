"""The staged B5 kernel's shapes and launch plan, on the CPU.

* ``hist_grid_grouped_packed`` at the shapes the staged kernel adds to the
  card's sweep: more buckets than a lane tile (hb 160 in groups of 16
  series), row0 beyond a ring stage's rows (40, and 20), stride 2, and a
  T that is not a multiple of the bucket-sum chunk.  The same numpy stride
  pack (``pack_vals(stride=hb, min_width=16)``) goes through
  ``filodb_tpu.ops.grid``'s Pallas kernel in interpret mode and through
  ``filodb_tpu_torch.ops.grid``'s wrapper on CPU tensors (the plain
  PyTorch version the CUDA kernels are held to on the card).  Tolerances
  as in tests/test_torch_hist_grouped.py: sums rtol 2e-5, counts and NaN
  positions equal.
* ``hist_staged_plan``, the launch plan the wrapper hands the staged
  kernel (tile, ring bytes, chunk, where the running sums sit, shared
  bytes a CTA): every plan for hb 2-1,024, K 1-1,024 and T 1-2,048 fits
  in a CTA's 227 KB, a staged step always fits in three ring stages, and
  the ring is the least that holds it.
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
PER = 16                    # series a group
CTA_BYTES = 232_448         # shared memory a CTA may use (227 KB)
MBARRIERS = 64              # the kernel's static RingBars
WORDS = (1, 2, 4)


def _hist_plane(rng, rows, n_series, hb):
    """[rows, n_series*hb] cumulative integer bucket counters (pinned f32
    exponent, one 16-bit class), one scrape phase a series; series 2 is
    dead (all NaN)."""
    start = 2 ** 23 + 128 * rng.integers(0, 2 ** 14, n_series)
    inc = 128 * rng.integers(1, 8, (rows, n_series, hb))
    v = start[None, :, None] + np.cumsum(np.cumsum(inc, axis=2), axis=0)
    v = v.reshape(rows, n_series * hb).astype(np.float32)
    v[:, 2 * hb:3 * hb] = np.nan
    phase = np.repeat(rng.integers(1, STEP, n_series), hb).astype(np.int32)
    return v, phase


# (hb, groups, row0, stride, T): T is never a multiple of the chunk
SHAPES = [(160, 2, 40, 2, 13), (16, 4, 40, 1, 21), (20, 4, 20, 2, 13)]


@pytest.mark.parametrize("use_phase,op", [(True, "rate"), (False, "sum"),
                                          (False, "last")])
@pytest.mark.parametrize("hb,groups,row0,stride,nsteps", SHAPES)
def test_staged_shapes_match_pallas_interpret(hb, groups, row0, stride,
                                              nsteps, use_phase, op):
    assert nsteps % tgrid.HIST_CHUNK != 0
    rows = row0 + (nsteps - 1) * stride + 5 + 3
    v, phase = _hist_plane(np.random.default_rng(hb + row0), rows,
                           PER * groups, hb)
    pk = jxorgrid.pack_vals(v, phase=phase, min_width=16, stride=hb)
    assert pk is not None and (pk.inv == np.arange(v.shape[1])).all()
    q = jgrid.GridQuery(nsteps=nsteps, kbuckets=5, gstep_ms=STEP, op=op,
                        is_rate=op == "rate", dense=True, stride=stride)
    ws, wc = jgrid.hist_grid_grouped_packed(
        {k: jnp.asarray(a) for k, a in pk.planes.items()}, 0, q, hb,
        group_lanes=PER * hb, row0=row0, interpret=True,
        use_phase=use_phase)
    gs, gc = tgrid.hist_grid_grouped_packed(
        txorgrid.packed_to_torch(pk, "cpu"), 0, tgrid.GridQuery(*q), hb,
        PER * hb, row0=row0, use_phase=use_phase)
    ws, wc = np.asarray(ws), np.asarray(wc)
    assert gs.shape == gc.shape == ws.shape == (groups * hb, nsteps)
    np.testing.assert_array_equal(gc.numpy(), wc)
    assert (np.isnan(gs.numpy()) == np.isnan(ws)).all()
    np.testing.assert_allclose(gs.numpy(), ws, rtol=2e-5)
    # group 0 holds the dead series: one series short in every bucket
    assert (gc[:hb] == PER - 1).all() and (gc[hb:] == PER).all()


@pytest.mark.parametrize("group_series", [2, 16])
def test_cpu_wrapper_runs_the_plain_version(group_series):
    """On CPU tensors the wrapper returns the plain version's bits, at a
    group of either lane tile (40 lanes: the small tile; 320: the large
    one, in two passes on the card), and nothing counts as a launch."""
    hb = 20
    v, phase = _hist_plane(np.random.default_rng(5), 64, 32, hb)
    planes = txorgrid.packed_to_torch(
        txorgrid.pack_vals(v, phase=phase, min_width=16, stride=hb), "cpu")
    q = tgrid.GridQuery(nsteps=9, kbuckets=5, gstep_ms=STEP, dense=True,
                        stride=2)
    gl = group_series * hb
    tgrid.reset_launch_counts()
    want = tgrid.hist_grid_grouped_packed_ref(planes, 0, q, hb, gl, 3)
    got = tgrid.hist_grid_grouped_packed(planes, 0, q, hb, gl, 3)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert tgrid.hist_grid_grouped_packed.launches == 0
    assert tgrid.hist_grid_grouped_packed.direct == 0


def test_reset_launch_counts_resets_the_direct_count():
    tgrid.hist_grid_grouped_packed.direct = 3
    tgrid.reset_launch_counts()
    assert tgrid.hist_grid_grouped_packed.direct == 0


def test_plan_at_the_north_star():
    """bench.py's hist query: 64 series x 16 buckets a group, one p16
    plane, T = 55, K = 5: the 16 KB ring, a chunk of 16 steps (32 KB
    double-buffered at tile 256), the running sums (7 KB) in shared
    memory: 56,192 bytes, four CTAs an SM."""
    plan = tgrid.hist_staged_plan(16, 1024, 55, 5, 1, 2)
    assert plan == tgrid.HistPlan(256, 16 * 1024, 16, True, 56_192)
    assert tgrid.HIST_TILE == 256 and tgrid.HIST_CHUNK == 16
    assert plan.staged


@pytest.mark.parametrize("ring,word,tile,rows", [
    (16384, 1, 128, 32), (16384, 2, 128, 16), (16384, 4, 128, 8),
    (16384, 1, 256, 16), (16384, 2, 256, 8), (16384, 4, 256, 4),
    (65536, 4, 256, 16), (65536, 4, 128, 32), (32768, 2, 256, 16)])
def test_stage_rows(ring, word, tile, rows):
    """Rows a stage: ring / (4 stages * tile * word), a power of two."""
    assert tgrid.ring_stage_rows(ring, word, tile) == rows


@pytest.mark.parametrize("hb,group_lanes,tile", [
    (4, 64, 128), (16, 128, 128), (2, 2, 128), (20, 320, 256),
    (16, 1024, 256), (1024, 16384, 256), (2, 130, 256)])
def test_tile_follows_the_group(hb, group_lanes, tile):
    """The small tile for a group of at most 128 lanes (one pass), else
    the large one."""
    assert tgrid.hist_staged_plan(hb, group_lanes, 10, 5, 1, 2).tile == tile


# a group of 128 lanes takes the small tile, one of 1,024 the large one
LANES = {128: 128, 256: 1024}


@pytest.mark.parametrize("word,tile,kbuckets,staged", [
    (2, 256, 120, False), (4, 256, 60, False), (4, 128, 60, True),
    (1, 128, 120, True), (1, 256, 1024, False), (1, 128, 1024, False),
    (2, 256, 94, True), (2, 256, 95, False), (4, 128, 94, True),
    (4, 128, 95, False)])
def test_direct_where_no_ring_holds_the_step(word, tile, kbuckets, staged):
    """A step of stride + K rows beyond three stages of the 64 KB ring
    takes the direct kernel (the K-free dense ops reach K = 1,024)."""
    plan = tgrid.hist_staged_plan(16, LANES[tile], 3, kbuckets, 2, word)
    assert plan.staged is staged
    if not staged:
        assert plan == tgrid.HistPlan(tile, 0, 0, False, 0)


@pytest.mark.parametrize("tile", sorted(LANES))
@pytest.mark.parametrize("word", WORDS)
def test_every_staged_step_fits_three_stages_of_the_least_ring(word, tile):
    """Every step of stride + K rows, K 1 to 1,024: a staged plan's ring
    is the least of the three in which the step fits three of its four
    stages (so a stage is refilled while the consumers hold three)."""
    for stride in (1, 2, 7):
        for k in range(1, 1025):
            plan = tgrid.hist_staged_plan(16, LANES[tile], 55, k, stride,
                                          word)
            assert plan.tile == tile
            span = stride + k
            fits = [b for b in tgrid.HIST_RING_BYTES
                    if span <= 3 * tgrid.ring_stage_rows(b, word, tile)]
            assert plan.ring_bytes == (fits[0] if fits else 0)
            if plan.staged:
                rows = tgrid.ring_stage_rows(plan.ring_bytes, word, tile)
                assert span <= 3 * rows
                assert plan.ring_bytes >= 4 * rows * tile * word


@pytest.mark.parametrize("series", [1, PER])
@pytest.mark.parametrize("word", WORDS)
def test_every_plan_fits_a_cta(word, series):
    """hb 2-1,024 in groups of ``series`` series (so of either tile) and
    T 1-2,048, at the largest ring a staged step can take and the
    smallest: the ring, the double-buffered chunk and the running sums
    when shared fit in 227 KB beside the mbarriers."""
    ts = sorted(set(range(1, 17)) | {55, 64, 127, 128, 129, 255, 256, 511,
                                     1024, 1535, 2047, 2048})
    tiles = set()
    for hb in range(2, 1025):
        gl = hb * series
        tile = tgrid.hist_staged_plan(hb, gl, 1, 5, 1, word).tile
        tiles.add(tile)
        for k in (5, 3 * tgrid.ring_stage_rows(65536, word, tile) - 1):
            for t in ts:
                plan = tgrid.hist_staged_plan(hb, gl, t, k, 1, word)
                assert plan.staged and plan.tile == tile
                acc = 8 * hb * t
                assert plan.acc_shared == (acc
                                           <= tgrid.HIST_ACC_SHARED_MAX)
                assert plan.chunk == min(tgrid.HIST_CHUNK, t) >= 1
                assert plan.shared == (plan.ring_bytes
                                       + 8 * plan.chunk * tile
                                       + (acc if plan.acc_shared else 0))
                assert plan.shared + MBARRIERS <= CTA_BYTES
    assert tiles == {128, 256}
