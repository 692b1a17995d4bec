"""The fused grouped kernel B2 (``rate_grid_grouped``) over the grid's
second op set, against the JAX package: irate, idelta, deriv,
predict_linear and timestamp (ts mode), changes, resets, stddev, stdvar,
zscore, quantile, mad and holt_winters (free mode).

The same numpy inputs (8 groups of 16 lanes, the last group all-NaN
padding) go through ``filodb_tpu.ops.grid`` and through
``filodb_tpu_torch.ops.grid``'s wrapper on CPU tensors, which runs the
plain PyTorch version the CUDA kernel is held to on the card:

- every op in each mode the JAX package allows it (dense and gappy lanes,
  the dense-only ops dense only), at strides 1 and 2, in f64 against the
  JAX reference ``rate_grid_ref`` and a numpy group sum and count of its
  finite answers;
- each op once in f32 against the JAX Pallas kernel in interpret mode;
- quantile with phi outside [0, 1], and the ``ValueError``s of both
  packages.

Tolerances: counts equal; sums within rtol of the group's sum of
absolute answers at that step: 1e-9 in f64 (the moments and the
regression are centred on different values in the two packages: the JAX
one on each lane's mean, the port on each window's first value), 2e-5 in
f32 against the Pallas kernel, 1e-4 for the moments there and 1e-3 for
zscore and over gappy lanes (``tests/test_torch_grid_ops.py`` states
why).

Flat windows.  Over a window whose finite values are all equal the
port's variance is exactly 0 and its zscore NaN (a zero deviation),
which counts out of the group; the JAX kernel's lane-centred sums leave
rounding noise there, so its zscore counts in.  The first group's lanes
step by whole units and hold such windows: it sits out the comparisons
of the moments with the JAX package, and
:func:`test_flat_windows_f32_hold_to_f64` holds the port's f32 answer
there to its f64 one, the zscore counting exactly the windows whose
values are not all equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import grid as jgrid
from filodb_tpu_torch.ops import grid as tgrid

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)

STEP = 60_000
T0 = 600_000
B = 40
K = 5
G = 8                       # the JAX kernels need a multiple of 8 groups
GL = 16
S = G * GL
FARGS = {"predict_linear": (600.0, 0.0), "quantile": (0.9, 0.0),
         "holt_winters": (0.3, 0.6)}
TS_OPS = ("irate", "idelta", "deriv", "predict_linear", "timestamp")
FREE_OPS = ("changes", "resets", "stddev", "stdvar", "zscore", "quantile",
            "mad", "holt_winters")
DENSE_ONLY = ("irate", "idelta", "changes", "resets", "quantile", "mad",
              "holt_winters")
MOMENTS = ("stddev", "stdvar", "zscore")
CASES = ([("ts", True, op) for op in TS_OPS]
         + [("ts", False, op) for op in TS_OPS if op not in DENSE_ONLY]
         + [("free", True, op) for op in FREE_OPS]
         + [("free", False, op) for op in FREE_OPS if op not in DENSE_ONLY])


def _case_id(case):
    mode, dense, op = case
    return f"{mode}-{'dense' if dense else 'gappy'}-{op}"


def _grid_data(dense: bool, seed: int = 0, stationary: bool = False):
    """[B-1, S] planes on the grid layout: per-lane uniform phase,
    counters with resets (``stationary``: noise in [0, 10) instead); the
    first group's lanes step by whole units, so that windows repeat
    values (changes, ties in the sorts, flat windows).  Gappy data gets
    NaN holes; the last group is all-NaN padding."""
    rng = np.random.default_rng(seed)
    phase = rng.integers(1, STEP, S).astype(np.int64)
    ts = (np.arange(B, dtype=np.int64) * STEP + T0 - STEP)[:, None] + phase
    vals = rng.random((B, S)) * 10.0
    if not stationary:
        vals = np.cumsum(vals, axis=0)
    vals[:, :GL] = np.cumsum(rng.integers(0, 2, (B, GL)), axis=0)
    for s in np.flatnonzero(rng.random(S) < 0.06):
        c = int(rng.integers(1, B))
        vals[c:, s] -= vals[c, s] * 0.9
    if not dense:
        vals[rng.random((B, S)) < 0.15] = np.nan
    vals[:, -GL:] = np.nan
    return ts[1:].astype(np.int32), vals[1:]


def _query(dense, op, stride=1):
    farg, farg2 = FARGS.get(op, (0.0, 0.0))
    return jgrid.GridQuery(nsteps=(B - 1 - K) // stride + 1, kbuckets=K,
                           gstep_ms=STEP, op=op, dense=dense, stride=stride,
                           farg=farg, farg2=farg2)


def _steps0():
    return T0 + K * STEP


def _np_grouped(per_lane):
    """A per-lane ``[T, S]`` answer -> (sum, count) ``[G, T]`` of each
    group's finite answers, and the group's sum of their magnitudes."""
    fin = np.isfinite(per_lane)
    v = np.where(fin, per_lane, 0.0).reshape(per_lane.shape[0], G, GL)
    c = fin.reshape(per_lane.shape[0], G, GL).sum(2).T
    return v.sum(2).T, c.astype(np.float64), np.abs(v).sum(2).T


def _assert_grouped(got, want, op, rtol):
    """Counts equal, sums within ``rtol`` of the group's sum of absolute
    answers; the first group sits out the moments (flat windows)."""
    (gs, gc), (ws, wc, scale) = got, want
    gs, gc = np.asarray(gs, np.float64), np.asarray(gc, np.float64)
    keep = slice(1, None) if op in MOMENTS else slice(None)
    gs, gc, ws, wc, scale = (a[keep] for a in (gs, gc, ws, wc, scale))
    assert gs.shape == ws.shape and gc.shape == wc.shape
    np.testing.assert_array_equal(gc, wc, err_msg=op)
    assert np.isfinite(gs).all(), op
    bad = np.abs(gs - ws) > rtol * scale
    assert not bad.any(), (op, gs[bad][:4], ws[bad][:4])


def _port(ts, vals, q, **kw):
    return tgrid.rate_grid_grouped(torch.as_tensor(ts),
                                   torch.as_tensor(vals), _steps0(),
                                   tgrid.GridQuery(*q), GL, **kw)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_grouped_ops_match_jax_ref_f64(case, stride):
    _mode, dense, op = case
    ts, vals = _grid_data(dense)
    q = _query(dense, op, stride)
    want = _np_grouped(np.asarray(jgrid.rate_grid_ref(
        jnp.asarray(ts), jnp.asarray(vals), _steps0(), q)))
    got = _port(ts, vals, q)
    assert got[0].dtype == torch.float64
    _assert_grouped(got, want, op, 1e-9)
    # the padding group: nothing counted, nothing summed
    assert not got[1][-1].any() and not got[0][-1].any()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_grouped_ops_match_pallas_interpret_f32(case):
    """The moments run over stationary lanes, as in
    ``tests/test_torch_grid_ops.py``: over a drifting counter the JAX
    kernel's lane-wide centre leaves f32 noise of its own."""
    _mode, dense, op = case
    ts, vals = _grid_data(dense, seed=1, stationary=op in MOMENTS)
    vals = vals.astype(np.float32)
    q = _query(dense, op)
    ws, wc = jgrid.rate_grid_grouped(
        jnp.asarray(ts), jnp.asarray(vals), jnp.int32(_steps0()), q,
        group_lanes=GL, interpret=True)
    per_lane = tgrid.rate_grid_ref(torch.as_tensor(ts),
                                   torch.as_tensor(vals), _steps0(),
                                   tgrid.GridQuery(*q)).double().numpy()
    scale = _np_grouped(per_lane)[2]
    got = _port(ts, vals, q)
    assert got[0].dtype == torch.float32
    rtol = (1e-3 if op == "zscore" or not dense else 1e-4) \
        if op in MOMENTS else 2e-5
    _assert_grouped(got, (np.asarray(ws), np.asarray(wc), scale), op, rtol)


@pytest.mark.parametrize("phi", [1.5, -0.5, float("nan")])
def test_quantile_outside_unit_interval_counts_nothing(phi):
    """phi above 1 (below 0) makes every live lane +Inf (-Inf), NaN a
    NaN: no answer is finite, so both packages sum 0 and count 0."""
    ts, vals = _grid_data(True)
    q = _query(True, "quantile")._replace(farg=phi)
    want = _np_grouped(np.asarray(jgrid.rate_grid_ref(
        jnp.asarray(ts), jnp.asarray(vals), _steps0(), q)))
    got = _port(ts, vals, q)
    _assert_grouped(got, want, "quantile", 0.0)
    assert not got[1].any() and not got[0].any()


@pytest.mark.parametrize("op", DENSE_ONLY)
def test_dense_only_ops_raise_on_gappy_lanes(op):
    """Both packages refuse a dense-only op without the dense contract."""
    ts, vals = _grid_data(False)
    vals = vals.astype(np.float32)
    q = _query(False, op)
    with pytest.raises(ValueError, match="dense contract"):
        jgrid.rate_grid_grouped(jnp.asarray(ts), jnp.asarray(vals),
                                jnp.int32(_steps0()), q, group_lanes=GL,
                                interpret=True)
    with pytest.raises(ValueError, match="dense contract"):
        _port(ts, vals, q)


@pytest.mark.parametrize("op", ["zscore", "stddev", "deriv",
                                "predict_linear"])
def test_flat_windows_f32_hold_to_f64(op):
    """Over the whole-unit lanes (flat windows) the port's f32 answer
    against its f64 one: counts equal, sums rtol 1e-5 of the group's
    sum of magnitudes.  A flat window's zscore is NaN (a zero
    deviation), so the first group's zscore counts exactly the windows
    whose values are not all equal (every window of dense lanes holds K
    finite values)."""
    ts, vals = _grid_data(True, seed=2)
    q = _query(True, op)
    want64 = _port(ts, vals, q)
    scale = _np_grouped(tgrid.rate_grid_ref(
        torch.as_tensor(ts), torch.as_tensor(vals), _steps0(),
        tgrid.GridQuery(*q)).numpy())[2]
    got32 = _port(ts, vals.astype(np.float32), q)
    np.testing.assert_array_equal(got32[1].numpy(), want64[1].numpy())
    bad = np.abs(got32[0].double().numpy() - want64[0].numpy()) \
        > 1e-5 * scale
    assert not bad.any()
    if op == "zscore":
        wins = np.stack([vals[t:t + K, :GL] for t in range(q.nsteps)])
        varied = wins.max(axis=1) > wins.min(axis=1)          # [T, GL]
        np.testing.assert_array_equal(got32[1][0].numpy(),
                                      varied.sum(axis=1))
        assert varied.sum() < varied.size        # flat windows exist


def test_sort_ops_window_cap():
    """quantile/mad at K = 33: the plain version answers, as the JAX
    reference does; the card's kernel holds at most 32 rows a window,
    and its arguments are refused before a launch."""
    ts, vals = _grid_data(True)
    q = jgrid.GridQuery(nsteps=4, kbuckets=33, gstep_ms=STEP,
                        op="quantile", dense=True, farg=0.5)
    want = _np_grouped(np.asarray(jgrid.rate_grid_ref(
        jnp.asarray(ts), jnp.asarray(vals), T0 + 33 * STEP, q)))
    got = tgrid.rate_grid_grouped(torch.as_tensor(ts), torch.as_tensor(vals),
                                  T0 + 33 * STEP, tgrid.GridQuery(*q), GL)
    _assert_grouped(got, want, "quantile", 1e-9)
    with pytest.raises(ValueError, match="1 to 32 buckets"):
        tgrid._fn_args(tgrid.GridQuery(*q))
