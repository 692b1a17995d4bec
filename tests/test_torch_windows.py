"""The port's window functions (``filodb_tpu_torch.ops.windows``) and
``rangefns.apply_range_function`` against the JAX package's, on one gappy
float64 ChunkBatch with counter resets, NaN samples and ragged rows.

Selection functions (min, max, last, count, changes, resets, timestamp)
must be bit-equal; arithmetic functions hold rtol 1e-9, atol 1e-12 (the
two frameworks sum prefix and window tiles in different orders).  The
variance E[x^2] - E[x]^2 cancels: where a window's spread is ~0 both
sides carry a residual of the order of eps * E[x^2], so stdvar holds
atol 1e-12 * max(x^2) and stddev is compared squared.  The JAX side runs
jitted, as its engine runs it (rangefns compiles every function)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.core.chunk import build_batch as jbuild_batch
from filodb_tpu.ops import windows as jw
from filodb_tpu.ops.windows import StepRange as JStepRange
from filodb_tpu.query import rangefns as jrangefns
from filodb_tpu.query.logical import RangeFunctionId as JF
from filodb_tpu_torch.core.chunk import build_batch
from filodb_tpu_torch.ops import windows as tw
from filodb_tpu_torch.ops.windows import StepRange
from filodb_tpu_torch.query import rangefns
from filodb_tpu_torch.query.logical import RangeFunctionId as F

BASE = 1_700_000_000_000
STEP = 15_000
WINDOW = 60_000
SELECTION = {"min_over_time", "max_over_time", "last_over_time",
             "count_over_time", "changes", "resets", "timestamp", "last"}


def _series():
    """Ragged, jittered scrapes with missed samples, NaN values, counter
    resets and a series whose data ends early."""
    rng = np.random.default_rng(17)
    ts_list, val_list = [], []
    for i in range(7):
        n = 80 - 6 * i
        ts = BASE + np.cumsum(rng.integers(4_000, 16_000, n)).astype(np.int64)
        vals = np.cumsum(rng.integers(0, 20, n)).astype(np.float64) + 3 * i
        if i % 2:
            at = rng.integers(5, n - 5, 2)
            for a in at:
                vals[a:] -= vals[a] * 0.8          # counter resets
        vals[rng.random(n) < 0.1] = np.nan         # NaN samples
        if i == 3:
            vals[::4] = vals[0]                    # repeats: changes()
        ts_list.append(ts)
        val_list.append(vals)
    return ts_list, val_list


TS_LIST, VAL_LIST = _series()
SR = StepRange(BASE + 30_000, BASE + 30_000 + 44 * STEP, STEP)
JSR = JStepRange(*SR)


def _batches():
    jb = jbuild_batch(TS_LIST, VAL_LIST, pad_to=16, pad_series_to=8)
    tb = build_batch(TS_LIST, VAL_LIST, pad_to=16, pad_series_to=8)
    np.testing.assert_array_equal(jb.timestamps, tb.timestamps)
    np.testing.assert_array_equal(jb.values, tb.values)
    return jb, tb


# the second-moment scale of the batch: the variance's cancellation floor
X2 = 1e-12 * np.nanmax(np.concatenate(VAL_LIST) ** 2)


def _check(got, want, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if name in ("stdvar_over_time", "stddev_over_time"):
        if name == "stddev_over_time":
            got, want = got * got, want * want
        assert (np.isnan(got) == np.isnan(want)).all(), name
        fin = ~np.isnan(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=X2,
                                   err_msg=name)
        return
    assert got.shape == want.shape, name
    assert (np.isnan(got) == np.isnan(want)).all(), name
    fin = ~np.isnan(want)
    assert fin.any(), name
    if name in SELECTION:
        np.testing.assert_array_equal(got[fin], want[fin], err_msg=name)
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9,
                                   atol=1e-12, err_msg=name)


PREFIX = ["sum_over_time", "count_over_time", "avg_over_time",
          "stdvar_over_time", "stddev_over_time", "changes_over_time",
          "resets_over_time", "rate", "increase", "delta_fn", "irate",
          "idelta", "timestamp_fn", "z_score"]
GATHER = [("min_over_time", ()), ("max_over_time", ()),
          ("quantile_over_time", (0.3,)), ("quantile_over_time", (1.5,)),
          ("mad_over_time", ()), ("deriv", ()), ("predict_linear", (600.0,)),
          ("holt_winters", (0.3, 0.1))]


def _inputs():
    jb, tb = _batches()
    j = (jnp.asarray(jb.timestamps), jnp.asarray(jb.values),
         jnp.asarray(JSR.timestamps()), jnp.asarray(WINDOW, jnp.int64))
    t = (torch.as_tensor(tb.timestamps), torch.as_tensor(tb.values),
         torch.as_tensor(SR.timestamps()), WINDOW)
    return j, t


def _label(name):
    return {"changes_over_time": "changes", "resets_over_time": "resets",
            "timestamp_fn": "timestamp"}.get(name, name)


@pytest.mark.parametrize("name", PREFIX)
def test_prefix_functions(name):
    j, t = _inputs()
    _check(getattr(tw, name)(*t).numpy(), jax.jit(getattr(jw, name))(*j),
           _label(name))


@pytest.mark.parametrize("name,args", GATHER,
                         ids=[f"{n}{a}" for n, a in GATHER])
def test_gather_functions(name, args):
    j, t = _inputs()
    wmax = jw.max_window_rows(j[0], j[2], j[3])
    assert tw.max_window_rows(t[0], t[2], t[3]) == wmax
    wmax = max(int(np.ceil(wmax / 16)) * 16, 16)
    want = jax.jit(getattr(jw, name), static_argnums=tuple(
        range(4, 5 + len(args))))(*j, wmax, *args)
    _check(getattr(tw, name)(*t, wmax, *args).numpy(), want, name)


def test_last_sample_value_and_time():
    j, t = _inputs()
    gv, gt = tw.last_sample(*t)
    wv, wt = jw.last_sample(*j)
    _check(gv.numpy(), wv, "last")
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def test_window_bounds():
    j, t = _inputs()
    for g, w in zip(tw.window_bounds(t[0], t[2], t[3]),
                    jw.window_bounds(j[0], j[2], j[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_counter_correct():
    # a prefix sum: arithmetic (XLA scans in blocks of 16, torch serially)
    _, tb = _batches()
    got = tw.counter_correct(torch.as_tensor(tb.values)).numpy()
    want = np.asarray(jw.counter_correct(jnp.asarray(tb.values)))
    _check(got, want, "counter_correct")


RANGE_FNS = [(None, ())] + [(f.name, ()) for f in F
                            if f.name not in ("QUANTILE_OVER_TIME",
                                              "PREDICT_LINEAR",
                                              "HOLT_WINTERS")] \
    + [("QUANTILE_OVER_TIME", (0.75,)), ("PREDICT_LINEAR", (300.0,)),
       ("HOLT_WINTERS", (0.5, 0.5))]


@pytest.mark.parametrize("fname,args", RANGE_FNS,
                         ids=[str(n) for n, _ in RANGE_FNS])
def test_apply_range_function(fname, args):
    jb, tb = _batches()
    jf = getattr(JF, fname) if fname else None
    tf = getattr(F, fname) if fname else None
    want = np.asarray(jrangefns.apply_range_function(jb, JSR, WINDOW, jf,
                                                     args))
    got = rangefns.apply_range_function(tb, SR, WINDOW, tf, args,
                                        device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    label = {"last_over_time": "last"}.get((fname or "last").lower(),
                                           (fname or "last").lower())
    _check(got.numpy(), want, label)
