"""The range functions of the grid's second op set, through the whole
slice: ingest -> shard -> device grid -> window function, in the port
against the JAX package on the same ingested containers
(``tests/torch_slice_data.py``).

- ``scan_grid`` over dense lanes (``uniform``) serves all 13 functions
  in both stores, over gappy lanes (``jitter``) the six that need no
  dense contract, and both answer None for the dense-only seven; spans
  inside one block, across two, and at stride 2.
- With f32 residents the eight functions that read no timestamps reach
  the packed path (``rate_grid_packed``) in both stores, the JAX store's
  packed kernel in Pallas interpret mode.

Tolerances: on the CPU both stores keep f64 residents.  changes, resets
and timestamp (re-based to absolute seconds in f64) are bit-equal; the
rest agree to rtol 1e-9 (the two packages centre the moments and the
regression on different values).  With f32 residents (a gauge near 1e6)
changes and resets stay bit-equal and the rest hold to 2e-5 of each
lane's largest answer, stddev and stdvar to 1e-4, zscore to 1e-3: the
JAX kernel centres the moments on the lane's mean and so rounds the
window mean at the lane's magnitude (one f32 ulp is 0.0625 near 1e6), a
few 1e-4 of a deviation of a few hundred, which the port's
window-anchored sums do not (``tests/test_torch_grid_ops.py`` holds them
to f64).  The JAX store's decoded-plane programs run op by op
(``jax.disable_jit``).
"""

import jax
import numpy as np
import pytest
import torch

from filodb_tpu.memstore import devicestore as jdevicestore
from filodb_tpu_torch.memstore import devicestore
from tests.torch_slice_data import (DENSE_ONLY, EXACT, MORE_SERVED, SPANS,
                                    STEP, WINDOW, assert_close, fns, ids,
                                    stores)

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)

TS_FREE = ("STDDEV_OVER_TIME", "STDVAR_OVER_TIME", "CHANGES", "RESETS",
           "Z_SCORE", "QUANTILE_OVER_TIME", "MAD_OVER_TIME", "HOLT_WINTERS")


@pytest.mark.parametrize("kind", ["uniform", "jitter"])
@pytest.mark.parametrize("name", sorted(MORE_SERVED))
def test_scan_grid_matches_jax(name, kind):
    jshard, tshard = stores(kind, compress=True)
    jids, tids = ids(jshard, tshard)
    jf, tf = fns(name)
    fargs = MORE_SERVED[name]
    served = kind == "uniform" or name not in DENSE_ONLY
    for span in sorted(SPANS):
        steps0, nsteps, stride = SPANS[span]
        with jax.disable_jit():
            want = jshard.scan_grid(jids, jf, steps0, nsteps, STEP * stride,
                                    WINDOW, fargs=fargs)
        got = tshard.scan_grid(tids, tf, steps0, nsteps, STEP * stride,
                               WINDOW, fargs=fargs)
        if not served:
            assert want is None and got is None, span
            continue
        assert want is not None and got is not None, span
        assert_close(got[1], want[1], name in EXACT, 1e-9,
                     f"{kind} {span} {name}")
        if name == "TIMESTAMP":
            assert got[1].dtype == torch.float64


def assert_lane_close(got, want, rtol, what):
    """The same finite cells; each within ``rtol`` of its lane's largest
    answer."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all(), what
    scale = np.where(fin, np.abs(want), 0.0).max(axis=1, keepdims=True)
    bad = fin & (np.abs(got - want) > rtol * scale)
    assert not bad.any(), (what, got[bad][:4], want[bad][:4])


@pytest.fixture()
def f32_residents(monkeypatch):
    monkeypatch.setattr(jdevicestore, "_PACKED_INTERPRET", True)
    monkeypatch.setattr(jdevicestore, "_PACKED_BROKEN", False)
    monkeypatch.setattr(jdevicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)
    monkeypatch.setattr(devicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)


@pytest.mark.parametrize("name", TS_FREE)
def test_f32_packed_path_matches_jax(f32_residents, name):
    jshard, tshard = stores("gauge", compress=True)
    jids, tids = ids(jshard, tshard)
    jf, tf = fns(name)
    fargs = MORE_SERVED[name]
    for span in ("one_block", "stride2"):
        steps0, nsteps, stride = SPANS[span]
        want = jshard.scan_grid(jids, jf, steps0, nsteps, STEP * stride,
                                WINDOW, fargs=fargs)
        got = tshard.scan_grid(tids, tf, steps0, nsteps, STEP * stride,
                               WINDOW, fargs=fargs)
        assert got is not None and want is not None, span
        assert got[1].dtype == torch.float32
        if name in ("CHANGES", "RESETS"):
            assert_close(got[1], want[1], True, 0, f"{span} {name}")
        else:
            rtol = {"Z_SCORE": 1e-3, "STDDEV_OVER_TIME": 1e-4,
                    "STDVAR_OVER_TIME": 1e-4}.get(name, 2e-5)
            assert_lane_close(got[1], want[1], rtol, f"{span} {name}")
        jplan = next(reversed(
            next(iter(jshard.device_caches.values()))._plan_memo.values()))
        tplan = next(reversed(
            next(iter(tshard.device_caches.values()))._plan_memo.values()))
        assert tplan.packed is not None and jplan.packed is not None, span
