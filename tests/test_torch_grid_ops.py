"""The grid kernels' second op set against the JAX package: irate,
idelta, changes, resets, stddev, stdvar, zscore, deriv, predict_linear,
timestamp, quantile, mad and holt_winters.

The same numpy inputs go through ``filodb_tpu.ops.grid`` (its portable
reference ``rate_grid_ref``, its Pallas kernels in interpret mode) and
through ``filodb_tpu_torch.ops.grid``'s plain versions, which the CUDA
kernels are held to on the card.  Every op runs in each mode the JAX
package allows it: ts dense and gappy, free dense and gappy (the
dense-only ops raise on gappy lanes in both), at strides 1 and 2.

Tolerances:

- f64, against ``rate_grid_ref``: changes, resets, timestamp and the
  quantiles at whole ranks bit-equal; the rest rtol 1e-9 (the moments
  and the regression are centred on different values in the two
  packages: the JAX one on each lane's mean, the port on each window's
  first value).
- f32, against the Pallas kernel: rtol 2e-5 of each lane's largest
  answer (moments 1e-4, over gappy lanes 1e-3: see the test).  The
  Pallas program rounds its divisions by 1000 otherwise than an IEEE
  division, and the slope, the forecast and the z-score cancel where a
  window is flat, so an ulp of an input moves an answer near 0 by more
  than an ulp of itself.
- f32 against f64, at the main path's magnitude (counters near 1e6):
  the port's answers hold to 1e-5 of each lane's largest answer, which
  the JAX kernel's lane-centred sums do not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.codecs import xorgrid as jxorgrid
from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.codecs import xorgrid as txorgrid
from filodb_tpu_torch.ops import grid as tgrid

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)

STEP = 60_000
T0 = 600_000
B = 40
K = 5
N_SERIES = 128
FARGS = {"predict_linear": (600.0, 0.0), "quantile": (0.9, 0.0),
         "holt_winters": (0.3, 0.6)}
TS_OPS = ("irate", "idelta", "deriv", "predict_linear", "timestamp")
FREE_OPS = ("changes", "resets", "stddev", "stdvar", "zscore", "quantile",
            "mad", "holt_winters")
DENSE_ONLY = ("irate", "idelta", "changes", "resets", "quantile", "mad",
              "holt_winters")
EXACT = ("changes", "resets", "timestamp")
MOMENTS = ("stddev", "stdvar", "zscore")
# (mode, dense, op): every op in each mode the JAX package allows
CASES = ([("ts", True, op) for op in TS_OPS]
         + [("ts", False, op) for op in TS_OPS if op not in DENSE_ONLY]
         + [("free", True, op) for op in FREE_OPS]
         + [("free", False, op) for op in FREE_OPS if op not in DENSE_ONLY])


def _case_id(case):
    mode, dense, op = case
    return f"{mode}-{'dense' if dense else 'gappy'}-{op}"


def _grid_data(dense: bool, seed: int = 0, level: float = 0.0,
               stationary: bool = False):
    """[B-1, S] planes on the grid layout: per-lane uniform phase,
    counters with resets starting at ``level`` (``stationary``: noise in
    [0, 10) instead); the first 16 lanes step by whole units so that
    windows repeat values (changes, ties in the sorts).  Gappy data gets
    NaN holes, dense data 16 all-NaN lanes."""
    rng = np.random.default_rng(seed)
    phase = rng.integers(1, STEP, N_SERIES).astype(np.int64)
    base = (np.arange(B, dtype=np.int64) * STEP + T0 - STEP)[:, None]
    ts = base + phase[None, :]
    vals = rng.random((B, N_SERIES)) * 10.0
    if not stationary:
        vals = np.cumsum(vals, axis=0)
    vals[:, :16] = np.cumsum(rng.integers(0, 2, (B, 16)), axis=0)
    resets = rng.random((B, N_SERIES)) < 0.06
    for s in range(N_SERIES):
        for c in np.where(resets[:, s])[0]:
            vals[c:, s] -= vals[c, s] * 0.9
    vals = vals + level
    if dense:
        vals[:, N_SERIES - 16:] = np.nan
    else:
        vals[rng.random((B, N_SERIES)) < 0.15] = np.nan
    return ts[1:].astype(np.int32), vals[1:]


def _query(dense, op, stride, **kw):
    farg, farg2 = FARGS.get(op, (0.0, 0.0))
    nsteps = (B - 1 - K) // stride + 1
    return jgrid.GridQuery(nsteps=nsteps, kbuckets=K, gstep_ms=STEP, op=op,
                           dense=dense, stride=stride, farg=farg,
                           farg2=farg2, **kw)


def _steps0():
    return T0 + K * STEP


def _lanes(op, got_like):
    """Where the JAX package's own answer is not defined to the bit: its
    moments and slopes over a flat window are rounding noise (its
    lane-wide centre leaves a variance of a few ulps where the window's
    values are equal), so the whole-unit lanes sit out those ops."""
    keep = np.ones(got_like.shape[1], bool)
    if op in MOMENTS + ("deriv", "predict_linear"):
        keep[:16] = False
    return keep


def _assert_match(got, want, op, rtol, lane_scaled=False, exact=EXACT):
    keep = _lanes(op, want)
    got, want = got[:, keep], want[:, keep]
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all(), op
    assert (np.isnan(got) == np.isnan(want)).all(), op
    if op in exact:
        np.testing.assert_array_equal(got[fin], want[fin], err_msg=op)
        return
    if lane_scaled:
        scale = np.where(fin, np.abs(want), 0.0).max(axis=0, keepdims=True)
        bad = fin & (np.abs(got - want) > rtol * scale)
        assert not bad.any(), (op, got[bad][:4], want[bad][:4])
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                   err_msg=op)


def _jax_ref(ts, vals, q):
    return np.asarray(jgrid.rate_grid_ref(jnp.asarray(ts), jnp.asarray(vals),
                                          _steps0(), q))


def _port_ref(ts, vals, q):
    return tgrid.rate_grid_ref(torch.as_tensor(ts), torch.as_tensor(vals),
                               _steps0(), tgrid.GridQuery(*q)).numpy()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ref_matches_jax_ref_f64(case, stride):
    _mode, dense, op = case
    ts, vals = _grid_data(dense)
    q = _query(dense, op, stride)
    got = _port_ref(ts, vals, q)
    assert got.dtype == np.float64
    _assert_match(got, _jax_ref(ts, vals, q), op, 1e-9)


@pytest.mark.parametrize("op,phi", [
    ("quantile", phi) for phi in (0.9, 0.5, 1.5, -0.5, float("nan"))]
    + [("mad", 0.5)])
def test_sort_ops_ranks_match_jax_f64(op, phi):
    """The interpolation ranks: whole ranks (phi 0.5 at K 5, and mad's
    medians) bit-equal, fractional ones to rtol 1e-9, out-of-range phi
    the same +-Inf / NaN."""
    ts, vals = _grid_data(True)
    q = _query(True, op, 1)._replace(farg=phi)
    got = _port_ref(ts, vals, q)
    want = _jax_ref(ts, vals, q)
    assert (np.isnan(got) == np.isnan(want)).all()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isinf(got)], want[np.isinf(want)])
    fin = np.isfinite(want)
    if phi == 0.5:
        np.testing.assert_array_equal(got[fin], want[fin])
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ref_matches_pallas_interpret_f32(case):
    """The moments run over stationary lanes: over a drifting counter
    the JAX kernel's lane-wide centre leaves f32 noise of its own (a
    window of two finite samples gets a zscore of -0.29, not -1).  Over
    gappy lanes they hold to 1e-3: the JAX kernel's variance of a window
    with one finite sample is rounding noise rather than 0, and its
    square root is far larger than the noise."""
    _mode, dense, op = case
    ts, vals = _grid_data(dense, seed=1, stationary=op in MOMENTS)
    vals = vals.astype(np.float32)
    q = _query(dense, op, 1)
    want = np.asarray(jgrid.rate_grid(
        jnp.asarray(ts), jnp.asarray(vals), jnp.int32(_steps0()), q,
        lanes=128, interpret=True))
    # the wrapper on CPU tensors runs the plain version
    got = tgrid.rate_grid(torch.as_tensor(ts), torch.as_tensor(vals),
                          _steps0(), tgrid.GridQuery(*q))
    assert got.dtype == torch.float32
    rtol = (1e-4 if dense else 1e-3) if op in MOMENTS else 2e-5
    _assert_match(got.numpy(), want, op, rtol, lane_scaled=True,
                  exact=("changes", "resets"))


@pytest.mark.parametrize("op", ["stddev", "stdvar", "zscore", "deriv",
                                "predict_linear"])
def test_f32_holds_to_f64_near_1e6(op):
    """The window-anchored sums at the main path's magnitude: counters
    near 1e6 in f32 against the same counters in f64 (the JAX kernel's
    lane-wide centre cancels to a few digits of a zscore or a slope
    here)."""
    ts, vals = _grid_data(True, seed=2, level=1e6)
    vals = vals.astype(np.float32).astype(np.float64)
    q = tgrid.GridQuery(*_query(True, op, 1))
    want = tgrid.rate_grid_ref(torch.as_tensor(ts), torch.as_tensor(vals),
                               _steps0(), q).numpy()
    got = tgrid.rate_grid_ref(torch.as_tensor(ts),
                              torch.as_tensor(vals.astype(np.float32)),
                              _steps0(), q).numpy()
    _assert_match(got, want, op, 1e-5, lane_scaled=True)


def _packed_planes(min_width=0):
    """Counters with a pinned f32 exponent (one 16-bit class) and 20
    empty lanes (``min_width=16``: one plane in lane order)."""
    rng = np.random.default_rng(12)
    L = 256
    start = (2 ** 23 + 128 * rng.integers(0, 2 ** 15, L)).astype(np.float32)
    v = (start[None, :] + np.cumsum(128 * rng.integers(0, 8, (64, L)),
                                    axis=0)).astype(np.float32)
    v[:, 40:60] = np.nan                          # empty lanes
    pk = jxorgrid.pack_vals(v, min_width=min_width)
    assert pk is not None
    return pk


@pytest.mark.parametrize("op,dense", [
    (op, dense) for op in FREE_OPS for dense in (True, False)
    if dense or op not in DENSE_ONLY])
def test_packed_matches_pallas_interpret(op, dense):
    """The eight ops that read no timestamps over packed planes: the
    port's decode + plain version against the JAX packed kernel (gappy:
    the masked path over the same planes; strides past 1 are the
    decoded-plane tests' and tests/test_torch_packed.py's)."""
    pk = _packed_planes()
    jdev = {k: jnp.asarray(a) for k, a in pk.planes.items()}
    farg, farg2 = FARGS.get(op, (0.0, 0.0))
    q = jgrid.GridQuery(nsteps=10, kbuckets=4, gstep_ms=STEP, op=op,
                        dense=dense, farg=farg, farg2=farg2)
    want = np.asarray(jgrid.rate_grid_packed(jdev, 0, q, row0=3,
                                             interpret=True))
    tdev = txorgrid.packed_to_torch(pk, "cpu")
    got = tgrid.rate_grid_packed(tdev, 0, tgrid.GridQuery(*q), row0=3)
    assert got.shape == want.shape
    _assert_match(got.numpy(), want, op, 1e-4 if op in MOMENTS else 2e-5,
                  lane_scaled=True, exact=("changes", "resets"))


@pytest.mark.parametrize("op", DENSE_ONLY)
def test_dense_only_ops_raise_on_gappy_lanes(op):
    """Both packages refuse a dense-only op without the dense contract."""
    ts, vals = _grid_data(False)
    q = _query(False, op, 1)
    with pytest.raises(ValueError, match="dense contract"):
        _jax_ref(ts, vals, q)
    with pytest.raises(ValueError, match="dense contract"):
        _port_ref(ts, vals, q)


@pytest.mark.parametrize("op", sorted(TS_OPS + FREE_OPS))
def test_grouped_wrappers_refuse_the_second_op_set(op):
    """The grouped kernels refuse an op of the second op set only where
    the JAX kernels do, on the CPU as on the card: the packed ones an op
    that reads timestamps, each of them a dense-only op without the dense
    contract.  Elsewhere they answer, one (sum, count) row a group."""
    q = tgrid.GridQuery(4, K, STEP, op=op, dense=True,
                        farg=FARGS.get(op, (0.0, 0.0))[0])
    gappy = q._replace(dense=False)
    ts = torch.zeros((8, 4), dtype=torch.int32)
    vals = torch.zeros((8, 4), dtype=torch.float32)
    s, c = tgrid.rate_grid_grouped(ts, vals, 0, q, group_lanes=2)
    assert s.shape == c.shape == (2, 4)
    if op in DENSE_ONLY:
        with pytest.raises(ValueError, match="dense contract"):
            tgrid.rate_grid_grouped(ts, vals, 0, gappy, group_lanes=2)
    pk = txorgrid.packed_to_torch(_packed_planes(16), "cpu")
    for fn in (tgrid.rate_grid_grouped_packed,
               lambda *a, **k: tgrid.hist_grid_grouped_packed(
                   a[0], a[1], a[2], 1, **k)):
        if op in TS_OPS:
            with pytest.raises(ValueError, match="ts plane"):
                fn(pk, 0, q, group_lanes=64, use_phase=False)
            continue
        s, c = fn(pk, 0, q, group_lanes=64, use_phase=False)
        assert s.shape == c.shape == (4, 4)
        if op in DENSE_ONLY:
            with pytest.raises(ValueError, match="dense contract"):
                fn(pk, 0, gappy, group_lanes=64, use_phase=False)


def test_served_ops_are_the_tpu_kernels():
    """rate_grid / rate_grid_packed serve every op of the TPU kernels'
    window dispatch, and the packed path every op that reads no ts."""
    assert tgrid.SERVED_OPS == jgrid.TS_FREE_OPS | jgrid.PHASE_OPS | {
        "irate", "idelta", "deriv", "predict_linear", "timestamp"}
    assert len(tgrid.SERVED_OPS) == 22
    assert tgrid.TS_FREE_OPS == jgrid.TS_FREE_OPS
    assert tgrid.DENSE_ONLY_OPS == jgrid.DENSE_ONLY_OPS
