"""The slice with f32 residents: the packed path of the port against the
JAX package's (its packed kernel in Pallas interpret mode), on the same
ingested containers (``tests/torch_slice_data.py``).

Tolerances: free ops stay bit-equal, the phase-mode rate chain and the
group sums agree to rtol 1e-6, the bound the JAX package holds its
packed kernel to (tests/test_devicestore.py:1118); every ``count`` plane
is bit-equal.
"""

import numpy as np
import pytest
import torch

from filodb_tpu.memstore import devicestore as jdevicestore
from filodb_tpu_torch.memstore import devicestore
from tests.torch_slice_data import (GIDS, N_GROUPS, SELECTION, SERVED,
                                    SPANS, STEP, WINDOW, assert_close, fns,
                                    ids, stores)

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)


@pytest.fixture()
def f32_residents(monkeypatch):
    """f32 residents on both sides: the JAX store runs its packed kernel
    in Pallas interpret mode, the port its packed wrapper's plain
    version."""
    monkeypatch.setattr(jdevicestore, "_PACKED_INTERPRET", True)
    monkeypatch.setattr(jdevicestore, "_PACKED_BROKEN", False)
    monkeypatch.setattr(jdevicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)
    monkeypatch.setattr(devicestore.DeviceGridCache, "_val_dtype",
                        lambda self: np.float32)


# rate/increase over a gauge that falls every other sample add a counter-
# reset correction of ~1e6 per fall: in f32 the running correction
# reaches ~1e8, where one ulp is 8, and two association orders of the
# same prefix sum differ at the percent level.  The f32 sweep therefore
# runs the counter functions on counters only (the f64 sweep of
# tests/test_torch_devicestore.py covers them on every dataset).
F32_FUNCS = {"counter": SERVED,
             "gauge": tuple(n for n in SERVED
                            if n not in ("RATE", "INCREASE"))}


@pytest.mark.parametrize("kind,span", [
    ("counter", "one_block"), ("counter", "two_blocks"),
    ("counter", "stride2"), ("gauge", "one_block")])
def test_f32_packed_path_matches_jax(f32_residents, kind, span):
    jshard, tshard = stores(kind, compress=True)
    jids, tids = ids(jshard, tshard)
    steps0, nsteps, stride = SPANS[span]
    for name in F32_FUNCS[kind]:
        jf, tf = fns(name)
        want = jshard.scan_grid(jids, jf, steps0, nsteps, STEP * stride,
                                WINDOW)
        got = tshard.scan_grid(tids, tf, steps0, nsteps, STEP * stride,
                               WINDOW)
        assert got is not None and want is not None, name
        assert got[1].dtype == torch.float32 and want[1].dtype == np.float32
        # sums and the rate chain to rtol 1e-6; selection bit-equal
        assert_close(got[1], want[1], name in SELECTION, 1e-6,
                      f"{kind} {span} {name}")
        jplan = next(reversed(
            next(iter(jshard.device_caches.values()))._plan_memo.values()))
        tplan = next(reversed(
            next(iter(tshard.device_caches.values()))._plan_memo.values()))
        assert (tplan.packed is None) == (jplan.packed is None), name
        assert tplan.packed_use_phase == jplan.packed_use_phase, name
        if span != "two_blocks":
            assert tplan.packed is not None, name   # one block: packed
    jf, tf = fns(F32_FUNCS[kind][0])
    st_j = jshard.scan_grid_grouped(jids, jf, steps0, nsteps,
                                    STEP * stride, WINDOW, GIDS, N_GROUPS,
                                    "sum")
    st_t = tshard.scan_grid_grouped(tids, tf, steps0, nsteps,
                                    STEP * stride, WINDOW, GIDS, N_GROUPS,
                                    "sum")
    assert_close(st_t["sum"], st_j["sum"], False, 1e-6, "grouped sum")
    assert_close(st_t["count"], st_j["count"], True, 0, "grouped count")
