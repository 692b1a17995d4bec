"""The port's fused histogram kernel (B5, ``hist_grid_grouped_packed``) and
``hist_quantile_grid_packed`` against the JAX package's.

The same numpy stride pack (``pack_vals(stride=hb, min_width=16)``,
column ``s*hb + j`` = series s's cumulative bucket j) goes through
``filodb_tpu.ops.grid``'s Pallas kernel in interpret mode and through
``filodb_tpu_torch.ops.grid``'s wrapper on CPU tensors (the plain PyTorch
version the CUDA kernel is held to on the card): ``hb`` 4, 8 and 20 (not a
power of two), ``row0`` 0 and 3, a dead series, phase mode and the free
``sum`` op.  Then the quantile over the bucket sums, and the contract's
``ValueError``s.

Tolerances: sums rtol 2e-5 (tests/test_packed_kernel.py:483), counts and
NaN positions equal; the quantile rtol 2e-5 with the NaN pattern equal.
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
PER, GH = 8, 8              # series per group, groups


def _hist_plane(rng, rows, n_series, hb):
    """[rows, n_series*hb] CUMULATIVE integer bucket counters (bucket j
    counts the observations of buckets 0..j; pinned f32 exponent, one
    16-bit class), one scrape phase per series; series 2 is dead (all
    NaN)."""
    start = 2 ** 23 + 128 * rng.integers(0, 2 ** 14, n_series)
    inc = 128 * rng.integers(1, 8, (rows, n_series, hb))
    v = start[None, :, None] + np.cumsum(np.cumsum(inc, axis=2), axis=0)
    v = v.reshape(rows, n_series * hb).astype(np.float32)
    v[:, 2 * hb:3 * hb] = np.nan
    phase = np.repeat(rng.integers(1, STEP, n_series), hb).astype(np.int32)
    return v, phase


def _pack(hb, seed=31):
    rng = np.random.default_rng(seed)
    v, phase = _hist_plane(rng, 64, PER * GH, hb)
    pk = jxorgrid.pack_vals(v, phase=phase, min_width=16, stride=hb)
    assert pk is not None and (pk.inv == np.arange(PER * GH * hb)).all()
    return pk, v, phase


def _query(op="rate"):
    return jgrid.GridQuery(nsteps=10, kbuckets=5, gstep_ms=STEP, op=op,
                           is_rate=op == "rate", dense=True)


@pytest.mark.parametrize("use_phase,op", [(True, "rate"), (False, "sum")])
@pytest.mark.parametrize("row0", [0, 3])
@pytest.mark.parametrize("hb", [4, 8, 20])
def test_hist_grouped_matches_pallas_interpret(hb, row0, use_phase, op):
    pk, _v, _ph = _pack(hb)
    q = _query(op)
    ws, wc = jgrid.hist_grid_grouped_packed(
        {k: jnp.asarray(a) for k, a in pk.planes.items()}, 0, q, hb,
        group_lanes=PER * hb, row0=row0, interpret=True,
        use_phase=use_phase)
    gs, gc = tgrid.hist_grid_grouped_packed(
        txorgrid.packed_to_torch(pk, "cpu"), 0, tgrid.GridQuery(*q), hb,
        PER * hb, row0=row0, use_phase=use_phase)
    ws, wc = np.asarray(ws), np.asarray(wc)
    assert gs.shape == gc.shape == ws.shape == (GH * hb, 10)
    np.testing.assert_array_equal(gc.numpy(), wc)
    assert (np.isnan(gs.numpy()) == np.isnan(ws)).all()
    np.testing.assert_allclose(gs.numpy(), ws, rtol=2e-5)
    # group 0 holds the dead series: one series short in every bucket
    assert (gc[:hb] == PER - 1).all() and (gc[hb:] == PER).all()


def test_hist_grouped_matches_decoded_rate_grid():
    """Slot g*hb + j sums bucket column j of every series of group g, as
    rate_grid over the decoded plane and a per-bucket sum give it."""
    hb = 20
    pk, v, phase = _pack(hb, seed=32)
    q = tgrid.GridQuery(nsteps=10, kbuckets=5, gstep_ms=STEP, dense=True)
    s, c = tgrid.hist_grid_grouped_packed(
        txorgrid.packed_to_torch(pk, "cpu"), 0, q, hb, PER * hb, row0=3)
    per = tgrid.rate_grid(None, torch.as_tensor(v[3:17]), 0, q,
                          phase=torch.as_tensor(phase))
    want = torch.nansum(per.reshape(10, GH, PER, hb), dim=2)
    torch.testing.assert_close(s.reshape(GH, hb, 10),
                               want.permute(1, 2, 0), rtol=2e-5, atol=0)


@pytest.mark.parametrize("hb,phi", [(4, 0.9), (8, 0.99), (20, 0.5)])
def test_hist_quantile_matches_jax(hb, phi):
    pk, _v, _ph = _pack(hb, seed=33)
    q = _query()
    tops = np.concatenate([2.0 ** np.arange(hb - 1), [np.inf]])
    # f32 bucket bounds on both sides: the interpolation runs in f32
    want = np.asarray(jgrid.hist_quantile_grid_packed(
        {k: jnp.asarray(a) for k, a in pk.planes.items()}, 0,
        jnp.asarray(tops, jnp.float32), q, phi, hb, group_lanes=PER * hb,
        interpret=True))
    got = tgrid.hist_quantile_grid_packed(
        txorgrid.packed_to_torch(pk, "cpu"), 0, torch.as_tensor(tops),
        tgrid.GridQuery(*q), phi, hb, PER * hb).numpy()
    assert got.shape == want.shape == (GH, 10)
    assert (np.isnan(got) == np.isnan(want)).all()
    fin = np.isfinite(want)
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5)


def test_hist_quantile_dead_group_is_nan():
    """A group with no live series at a step (the top bucket's count is
    0) answers NaN there."""
    hb = 4
    rng = np.random.default_rng(34)
    v, phase = _hist_plane(rng, 64, PER * GH, hb)
    v[:, :PER * hb] = np.nan                         # group 0 dead
    pk = txorgrid.pack_vals(v, phase=phase, min_width=16, stride=hb)
    tops = np.concatenate([2.0 ** np.arange(hb - 1), [np.inf]])
    got = tgrid.hist_quantile_grid_packed(
        txorgrid.packed_to_torch(pk, "cpu"), 0, tops, tgrid.GridQuery(
            *_query()), 0.99, hb, PER * hb)
    assert torch.isnan(got[0]).all() and torch.isfinite(got[1:]).all()


def test_hist_grouped_rejects():
    q = tgrid.GridQuery(*_query())
    pk, _v, _ph = _pack(4, seed=35)
    planes = txorgrid.packed_to_torch(pk, "cpu")
    with pytest.raises(ValueError, match="multiple of the bucket count"):
        tgrid.hist_grid_grouped_packed(planes, 0, q, 3, 32)
    with pytest.raises(ValueError, match="whole number"):
        tgrid.hist_grid_grouped_packed(planes, 0, q, 4, 24)
    padded = dict(planes)
    padded["inv"] = planes["inv"][:-4]
    with pytest.raises(ValueError, match="pad lanes"):
        tgrid.hist_grid_grouped_packed(padded, 0, q, 4, 32)
    with pytest.raises(ValueError, match="rows"):
        tgrid.hist_grid_grouped_packed(planes, 0, q, 4, 32, row0=60)
