"""The slice as a whole: ingest -> shard -> device grid -> windowed range
function -> on-device group reduce, in the port against the JAX package.

The same RecordContainer bytes, built once with the JAX package's
``RecordBuilder``, are ingested into a ``filodb_tpu`` memstore and into a
``filodb_tpu_torch`` memstore (``device="cpu"``; see
``tests/torch_slice_data.py``).  Then ``scan_grid_grouped`` must agree
for every served range function and every group op, with the grid's
compressed residents on and off; both stores must plan alike and leave
the same range functions unserved.  The per-series sweep is
``tests/test_torch_scan_grid.py``, the f32 packed path
``tests/test_torch_devicestore_f32.py``.

Tolerances: on the CPU both stores keep f64 residents.  Selection ops
(last/min/max/count and the instant selector) and every ``count`` plane
are bit-equal; sums and the rate chain agree to rtol 1e-9 (the prefix
sums associate differently).

The JAX store's decoded-plane programs run op by op (``jax.disable_jit``)
where the sweep is wide: the same functions, without one XLA compile per
query shape.
"""

import jax
import numpy as np
import pytest
import torch

from filodb_tpu.query.logical import RangeFunctionId as JF
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.memstore import devicestore
from filodb_tpu_torch.query.logical import RangeFunctionId as F
from tests.torch_slice_data import (GIDS, N_GROUPS, SELECTION, SERVED,
                                    SPANS, STEP, WINDOW, assert_close, fns,
                                    ids, stores)

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)

UNSERVED = {"STDDEV_OVER_TIME": (), "STDVAR_OVER_TIME": (),
            "CHANGES": (), "RESETS": (), "IRATE": (), "IDELTA": (),
            "DERIV": (), "PREDICT_LINEAR": (600.0,), "TIMESTAMP": (),
            "Z_SCORE": (), "QUANTILE_OVER_TIME": (0.9,),
            "MAD_OVER_TIME": (), "HOLT_WINTERS": (0.5, 0.5)}



# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("agg", ["sum", "avg", "count", "min", "max"])
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("kind", ["jitter", "uniform"])
def test_scan_grid_grouped_matches_jax(kind, compress, agg):
    jshard, tshard = stores(kind, compress)
    jids, tids = ids(jshard, tshard)
    steps0, nsteps, _ = SPANS["two_blocks"]
    for name in SERVED:
        jf, tf = fns(name)
        with jax.disable_jit():
            want = jshard.scan_grid_grouped(jids, jf, steps0, nsteps, STEP,
                                            WINDOW, GIDS, N_GROUPS, agg)
        got = tshard.scan_grid_grouped(tids, tf, steps0, nsteps, STEP,
                                       WINDOW, GIDS, N_GROUPS, agg)
        assert want is not None and got is not None, name
        assert sorted(got) == sorted(want)
        for key in want:
            exact = key == "count" or (name in SELECTION and key != "sum")
            assert_close(got[key], want[key], exact, 1e-9,
                          f"{kind} {agg} {name} {key}")


def test_plan_modes_match_jax():
    """The dense and uniform-phase proofs decide alike: same GridQuery,
    phase mode on the same queries."""
    for kind in ("jitter", "uniform"):
        jshard, tshard = stores(kind, compress=True)
        jids, tids = ids(jshard, tshard)
        steps0, nsteps, _ = SPANS["two_blocks"]
        for name in ("RATE", "SUM_OVER_TIME"):
            jf, tf = fns(name)
            with jax.disable_jit():
                jshard.scan_grid(jids, jf, steps0, nsteps, STEP, WINDOW)
            tshard.scan_grid(tids, tf, steps0, nsteps, STEP, WINDOW)
        jcache = next(iter(jshard.device_caches.values()))
        tcache = next(iter(tshard.device_caches.values()))
        jplans = list(jcache._plan_memo.values())
        tplans = list(tcache._plan_memo.values())
        assert [tuple(p.q) for p in tplans] == [tuple(p.q) for p in jplans]
        assert [p.phase is None for p in tplans] == \
            [p.phase is None for p in jplans]
        assert len(tcache.blocks) == len(jcache.blocks) == 2


@pytest.mark.parametrize("name", sorted(UNSERVED))
def test_unported_ops_not_served(name):
    """The 13 range functions the slice does not port: the JAX grid
    serves them, the port answers None ("not served here")."""
    jshard, tshard = stores("uniform", compress=False)
    jids, tids = ids(jshard, tshard)
    steps0, nsteps, _ = SPANS["one_block"]
    fargs = UNSERVED[name]
    with jax.disable_jit():
        assert jshard.scan_grid(jids, getattr(JF, name), steps0, nsteps,
                                STEP, WINDOW, fargs=fargs) is not None
    assert tshard.scan_grid(tids, getattr(F, name), steps0, nsteps, STEP,
                            WINDOW, fargs=fargs) is None
    assert tshard.scan_grid_grouped(tids, getattr(F, name), steps0, nsteps,
                                    STEP, WINDOW, GIDS, N_GROUPS, "sum",
                                    fargs=fargs) is None



def test_repeat_query_reuses_blocks():
    _jshard, tshard = stores("counter", compress=True)
    res = tshard.lookup_partitions(
        [ColumnFilter("_metric_", Equals("m"))], 0, 2**62)
    steps0, nsteps, _ = SPANS["two_blocks"]
    first = tshard.scan_grid(res.part_ids, F.RATE, steps0, nsteps, STEP,
                             WINDOW)
    cache = next(iter(tshard.device_caches.values()))
    builds = cache.builds
    again = tshard.scan_grid(res.part_ids, F.RATE, steps0, nsteps, STEP,
                             WINDOW)
    assert cache.builds == builds, "repeat query rebuilt blocks"
    np.testing.assert_array_equal(first[1], again[1])
    assert all(isinstance(b.vals, dict) for b in cache.blocks.values())
    assert all(b.ts is None for b in cache.blocks.values())


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_group_matmul_leaves_tf32_setting(caller_tf32):
    """The one-hot reduce turns TF32 off for its own matmul only and
    puts the caller's setting back."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    try:
        flags.allow_tf32 = caller_tf32
        rng = np.random.default_rng(5)
        stepped = torch.as_tensor(rng.random((4, 6)), dtype=torch.float32)
        garr = torch.tensor([0, 1, 0, 2, 1, 2], dtype=torch.int32)
        got = devicestore._grouped_reduce_impl(stepped, garr, 2, "sum")
        assert flags.allow_tf32 is caller_tf32
        want = torch.zeros((2, 4))
        for lane, g in enumerate(garr.tolist()):
            if g < 2:
                want[g] += stepped[:, lane]
        torch.testing.assert_close(got[0], want, rtol=1e-6, atol=0)
        assert got[1].tolist() == [[2.0] * 4, [2.0] * 4]
    finally:
        flags.allow_tf32 = prev
