"""The fused grouped kernels over packed planes, B4
(``rate_grid_grouped_packed``) and B5 (``hist_grid_grouped_packed``),
over the eight ops of the grid's second op set that read no timestamps:
changes, resets, stddev, stdvar, zscore, quantile, mad and holt_winters.

The same numpy packs go through ``filodb_tpu.ops.grid`` and through
``filodb_tpu_torch.ops.grid``'s wrappers on CPU tensors, which run the
plain PyTorch versions the CUDA kernels are held to on the card:

- B4 over a p8 plane and a p16 plane of whole groups merged into one pack
  (the p8 lanes step by 0 or 128, so windows repeat values; five p16
  lanes are dead), ``row0 = 3``;
- B5 over a stride pack at hb 4 (column ``s*hb + j`` is series s's
  cumulative bucket j), with a dead series;
- every op dense, the moments also without the dense contract, at
  strides 1 and 2, against the JAX reference ``rate_grid_ref`` in f64 over
  the unpacked values and a numpy per-group (per-bucket) sum and count of
  its finite answers; each case once against the JAX Pallas kernel in
  interpret mode;
- quantile with phi outside [0, 1], and the ``ValueError``s of both
  packages: the five ops that read timestamps on packed planes, the
  dense-only ops without the dense contract.

Tolerances: counts equal; sums within rtol of the slot's sum of absolute
answers at that step: 2e-5, 1e-4 for the moments and 1e-3 for zscore or
without the dense contract (``tests/test_torch_grid_ops.py`` states why).
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
ROWS = 48
K = 4
GL = 32                     # B4: lanes a group
NG = 8                      # groups a plane (the JAX kernels need 8k)
HB, PER, GH = 4, 8, 8       # B5: buckets, series a group, groups
ROW0 = 3
FARGS = {"quantile": (0.9, 0.0), "holt_winters": (0.3, 0.6)}
FREE_OPS = ("changes", "resets", "stddev", "stdvar", "zscore", "quantile",
            "mad", "holt_winters")
TS_OPS = ("irate", "idelta", "deriv", "predict_linear", "timestamp")
MOMENTS = ("stddev", "stdvar", "zscore")
DENSE_ONLY = ("changes", "resets", "quantile", "mad", "holt_winters")
CASES = [(op, True) for op in FREE_OPS] + [(op, False) for op in MOMENTS]


def _case_id(case):
    op, dense = case
    return f"{'dense' if dense else 'gappy'}-{op}"


def _counters(rng, rows, cols, small):
    """Integer counters with a pinned f32 exponent: residuals in bits 7-14
    (one 8-bit class; steps of 0 or 128) when ``small``, else bits 7-22
    (one 16-bit class; steps of 128 to 896)."""
    if small:
        start = 2 ** 23 + 2 ** 15 * rng.integers(0, 2 ** 7, cols)
        inc = 128 * rng.integers(0, 2, (rows, cols))
    else:
        start = 2 ** 23 + 128 * rng.integers(0, 2 ** 15, cols)
        inc = 128 * rng.integers(1, 8, (rows, cols))
    return (start[None, :] + np.cumsum(inc, axis=0)).astype(np.float32)


def _b4_pack():
    """(planes, [ROWS, 2*NG*GL] values in packed order): a p8 pack and a
    p16 pack of NG whole groups each, merged into one dict."""
    rng = np.random.default_rng(41)
    n = GL * NG
    v8, v16 = _counters(rng, ROWS, n, True), _counters(rng, ROWS, n, False)
    v16[:, GL:GL + 5] = np.nan
    p8 = jxorgrid.pack_vals(v8, min_width=8)
    p16 = jxorgrid.pack_vals(v16, min_width=16)
    for pk, key in ((p8, "p8"), (p16, "p16")):
        assert [k for k in ("p8", "p16", "raw")
                if k in pk.planes and pk.planes[k].shape[1]] == [key]
        assert (pk.inv == np.arange(n)).all()
    planes = {"p8": p8.planes["p8"], "m8": p8.planes["m8"],
              "z8": p8.planes["z8"], "p16": p16.planes["p16"],
              "m16": p16.planes["m16"], "z16": p16.planes["z16"],
              "raw": np.zeros((ROWS, 0), np.float32),
              "first": np.concatenate([p8.planes["first"],
                                       p16.planes["first"]]),
              "inv": np.arange(2 * n, dtype=np.int32)}
    return planes, np.concatenate([v8, v16], axis=1)


def _b5_pack():
    """(planes, [ROWS, GH*PER*HB] values): cumulative integer bucket
    counters (never flat), one 16-bit class, series 2 dead."""
    rng = np.random.default_rng(43)
    ns = GH * PER
    start = 2 ** 23 + 128 * rng.integers(0, 2 ** 14, ns)
    inc = 128 * rng.integers(1, 8, (ROWS, ns, HB))
    v = start[None, :, None] + np.cumsum(np.cumsum(inc, axis=2), axis=0)
    v = v.reshape(ROWS, ns * HB).astype(np.float32)
    v[:, 2 * HB:3 * HB] = np.nan
    pk = jxorgrid.pack_vals(v, min_width=16, stride=HB)
    assert pk is not None and (pk.inv == np.arange(ns * HB)).all()
    return pk.planes, v


def _query(op, dense, stride):
    farg, farg2 = FARGS.get(op, (0.0, 0.0))
    return jgrid.GridQuery(nsteps=(ROWS - ROW0 - K) // stride + 1,
                           kbuckets=K, gstep_ms=STEP, op=op, dense=dense,
                           stride=stride, farg=farg, farg2=farg2)


def _np_grouped(per_lane, group_lanes, hb):
    """A per-lane ``[T, n]`` answer -> (sum, count) ``[n/group_lanes*hb,
    T]`` of each slot's finite answers, and the slot's sum of their
    magnitudes (slot ``g*hb + j``: group g's columns c with c % hb == j)."""
    T, n = per_lane.shape
    fin = np.isfinite(per_lane)
    shape = (T, n // group_lanes, group_lanes // hb, hb)
    v = np.where(fin, per_lane, 0.0).reshape(shape)

    def slots(x):
        return x.sum(2).transpose(1, 2, 0).reshape(-1, T)
    return (slots(v), slots(fin.reshape(shape).astype(np.float64)),
            slots(np.abs(v)))


def _ref(vals, q, group_lanes, hb):
    rows = vals[ROW0:ROW0 + (q.nsteps - 1) * q.stride + K]
    per_lane = np.asarray(jgrid.rate_grid_ref(
        None, jnp.asarray(rows.astype(np.float64)), 0, q))
    return _np_grouped(per_lane, group_lanes, hb)


def _assert_grouped(got, want, rtol):
    (gs, gc), (ws, wc, scale) = got, want
    gs, gc = gs.double().numpy(), gc.double().numpy()
    assert gs.shape == ws.shape and gc.shape == wc.shape
    np.testing.assert_array_equal(gc, wc)
    assert np.isfinite(gs).all()
    bad = np.abs(gs - ws) > rtol * scale
    assert not bad.any(), (gs[bad][:4], ws[bad][:4])


def _rtol(op, dense):
    if op in MOMENTS:
        return 1e-3 if op == "zscore" or not dense else 1e-4
    return 2e-5


def _b4(planes, q):
    return tgrid.rate_grid_grouped_packed(
        txorgrid.packed_to_torch(planes, "cpu"), 0, tgrid.GridQuery(*q), GL,
        row0=ROW0, use_phase=False)


def _b5(planes, q):
    return tgrid.hist_grid_grouped_packed(
        txorgrid.packed_to_torch(planes, "cpu"), 0, tgrid.GridQuery(*q), HB,
        PER * HB, row0=ROW0, use_phase=False)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_grouped_packed_ops_match_jax_ref(case, stride):
    op, dense = case
    planes, v = _b4_pack()
    q = _query(op, dense, stride)
    got = _b4(planes, q)
    assert got[0].shape == (2 * NG, q.nsteps)
    _assert_grouped(got, _ref(v, q, GL, 1), _rtol(op, dense))
    # the p16 plane's second group holds the five dead lanes
    assert (got[1][NG + 1] <= GL - 5).all()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_hist_grouped_ops_match_jax_ref(case, stride):
    op, dense = case
    planes, v = _b5_pack()
    q = _query(op, dense, stride)
    got = _b5(planes, q)
    assert got[0].shape == (GH * HB, q.nsteps)
    _assert_grouped(got, _ref(v, q, PER * HB, HB), _rtol(op, dense))
    # group 0 holds the dead series: one series short in every bucket
    assert (got[1][:HB] <= PER - 1).all()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_grouped_packed_ops_match_pallas_interpret(case):
    op, dense = case
    planes, v = _b4_pack()
    q = _query(op, dense, 2)
    ws, wc = jgrid.rate_grid_grouped_packed(
        {k: jnp.asarray(a) for k, a in planes.items()}, 0, q, group_lanes=GL,
        row0=ROW0, interpret=True, use_phase=False)
    scale = _ref(v, q, GL, 1)[2]
    _assert_grouped(_b4(planes, q), (np.asarray(ws), np.asarray(wc), scale),
                    _rtol(op, dense))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_hist_grouped_ops_match_pallas_interpret(case):
    op, dense = case
    planes, v = _b5_pack()
    q = _query(op, dense, 1)
    ws, wc = jgrid.hist_grid_grouped_packed(
        {k: jnp.asarray(a) for k, a in planes.items()}, 0, q, HB,
        group_lanes=PER * HB, row0=ROW0, interpret=True, use_phase=False)
    scale = _ref(v, q, PER * HB, HB)[2]
    _assert_grouped(_b5(planes, q), (np.asarray(ws), np.asarray(wc), scale),
                    _rtol(op, dense))


@pytest.mark.parametrize("phi", [1.5, -0.5])
def test_quantile_outside_unit_interval_counts_nothing(phi):
    """Every live lane is +-Inf: no answer is finite, so both packages
    sum 0 and count 0 in every slot."""
    for run, (planes, v), gl, hb in ((_b4, _b4_pack(), GL, 1),
                                     (_b5, _b5_pack(), PER * HB, HB)):
        q = _query("quantile", True, 1)._replace(farg=phi)
        got = run(planes, q)
        _assert_grouped(got, _ref(v, q, gl, hb), 0.0)
        assert not got[1].any() and not got[0].any()


@pytest.mark.parametrize("op", TS_OPS)
def test_ts_ops_raise_on_packed_planes(op):
    """A packed plane has no ts plane: both packages refuse the five ops
    that read one, in both packed kernels."""
    q = _query(op, True, 1)
    for planes, jfn, tfn in (
            (_b4_pack()[0],
             lambda p: jgrid.rate_grid_grouped_packed(
                 p, 0, q, group_lanes=GL, row0=ROW0, interpret=True,
                 use_phase=False),
             _b4),
            (_b5_pack()[0],
             lambda p: jgrid.hist_grid_grouped_packed(
                 p, 0, q, HB, group_lanes=PER * HB, row0=ROW0,
                 interpret=True, use_phase=False),
             _b5)):
        with pytest.raises(ValueError, match="ts plane"):
            jfn({k: jnp.asarray(a) for k, a in planes.items()})
        with pytest.raises(ValueError, match="ts plane"):
            tfn(planes, q)


@pytest.mark.parametrize("op", DENSE_ONLY)
def test_dense_only_ops_raise_without_dense_contract(op):
    q = _query(op, False, 1)
    planes = _b4_pack()[0]
    with pytest.raises(ValueError, match="dense contract"):
        jgrid.rate_grid_grouped_packed(
            {k: jnp.asarray(a) for k, a in planes.items()}, 0, q,
            group_lanes=GL, row0=ROW0, interpret=True, use_phase=False)
    with pytest.raises(ValueError, match="dense contract"):
        _b4(planes, q)
    with pytest.raises(ValueError, match="dense contract"):
        _b5(_b5_pack()[0], q)
